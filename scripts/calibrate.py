"""Calibrate per-call dispatch overhead on the current backend."""
import time
import sys
sys.path.insert(0, __file__.rsplit('/', 2)[0])
from topfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax, jax.numpy as jnp
import numpy as np

f = jax.jit(lambda x: x + 1.0)
x = jnp.zeros((480, 640), jnp.float32)
x = jax.block_until_ready(f(x))

# single-call latency (sync each call)
t0 = time.perf_counter()
for _ in range(20):
    x = jax.block_until_ready(f(x))
print(f"trivial op, sync each call : {(time.perf_counter()-t0)/20*1e3:8.3f} ms")

# chained calls, one sync
t0 = time.perf_counter()
for _ in range(100):
    x = f(x)
x = jax.block_until_ready(x)
print(f"trivial op, chained x100   : {(time.perf_counter()-t0)/100*1e3:8.3f} ms")

# a moderately heavy fused op, chained
g = jax.jit(lambda x: jnp.tanh(x @ x.T).sum())  # 480x640 matmul ~ 0.4 GFLOP
y = jax.block_until_ready(g(x))
t0 = time.perf_counter()
outs = [g(x) for _ in range(30)]
jax.block_until_ready(outs)
print(f"matmul 480x640 chained x30 : {(time.perf_counter()-t0)/30*1e3:8.3f} ms")
