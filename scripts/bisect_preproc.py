"""Bisect preprocess_depth cost: which sub-op burns the time?"""
import time
import sys
sys.path.insert(0, __file__.rsplit('/', 2)[0])
from topfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax, jax.numpy as jnp
import numpy as np
from topfusion.ops.depth import (
    depth_to_meters, bilateral_filter, truncate_depth, downsample_depth,
    _shifted,
)

x = jnp.abs(jax.random.normal(jax.random.PRNGKey(0), (480, 640))) + 0.5
x = jax.block_until_ready(x)


def timeit(name, fn, *args, n=10):
    out = jax.block_until_ready(jax.jit(fn)(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = jax.block_until_ready(jax.jit(fn)(*args))
    print(f"{name:32s} {(time.perf_counter()-t0)/n*1e3:9.3f} ms")
    return out


timeit("depth_to_meters", depth_to_meters, x * 1000)
timeit("bilateral 7x7", bilateral_filter, x)
timeit("bilateral 5x5", lambda d: bilateral_filter(d, 5), x)
timeit("downsample", downsample_depth, x)

# raw stencil without exp: 49 shifted adds
def stencil_only(d):
    acc = jnp.zeros_like(d)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            acc = acc + _shifted(d, dy, dx)
    return acc

timeit("49-tap shifted sum (no exp)", stencil_only, x)

# same with exp weights
def stencil_exp(d):
    acc = jnp.zeros_like(d)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            nb = _shifted(d, dy, dx)
            acc = acc + jnp.exp(-(d - nb) ** 2) * nb
    return acc

timeit("49-tap shifted exp sum", stencil_exp, x)

# exp alone x49
def exp49(d):
    acc = jnp.zeros_like(d)
    for i in range(49):
        acc = acc + jnp.exp(-d * (1.0 + i))
    return acc

timeit("49 exps, no shifts", exp49, x)

# roll-based shift instead of pad+slice
def stencil_roll(d):
    acc = jnp.zeros_like(d)
    for dy in range(-3, 4):
        for dx in range(-3, 4):
            acc = acc + jnp.roll(d, (dy, dx), (0, 1))
    return acc

timeit("49-tap roll sum", stencil_roll, x)

# vertical-only and horizontal-only shifts
def stencil_v(d):
    acc = jnp.zeros_like(d)
    for dy in range(-3, 4):
        for _ in range(7):
            acc = acc + _shifted(d, dy, 0)
    return acc

def stencil_h(d):
    acc = jnp.zeros_like(d)
    for dx in range(-3, 4):
        for _ in range(7):
            acc = acc + _shifted(d, 0, dx)
    return acc

timeit("49-tap vertical-only shifts", stencil_v, x)
timeit("49-tap horizontal-only shifts", stencil_h, x)
