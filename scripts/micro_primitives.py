"""Microbenchmarks of the scatter/sort/gather primitives that dominate the
block pipeline, on the current backend.  Guides kernel redesign decisions."""
import time
import sys
sys.path.insert(0, __file__.rsplit('/', 2)[0])
from topfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax, jax.numpy as jnp
import numpy as np

key = jax.random.PRNGKey(0)


def _fence(out):
    return jax.block_until_ready(out)


def timeit(name, fn, *args, n=10):
    f = jax.jit(fn)
    _fence(f(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(*args)
    _fence(out)
    thr = (time.perf_counter() - t0) / n
    print(f"{name:48s} {thr*1e3:9.3f} ms", flush=True)


H, W = 480, 640
HW = H * W

# --- scatter flavors
k1, k2, k3, k4 = jax.random.split(key, 4)
idx_524k = jax.random.randint(k1, (524288,), 0, HW)
val_524k = jax.random.randint(k2, (524288,), 0, 1 << 30)
idx_131k = idx_524k[:131072]
val3_2m = jax.random.normal(k3, (1 << 21, 3))
idx_2m = jax.random.randint(k4, (1 << 21,), 0, 131072)

timeit("scatter-min 524k -> 307k img", lambda i, v: jnp.full((HW,), 2**30, jnp.int32).at[i].min(v), idx_524k, val_524k)
timeit("scatter-min 131k -> 307k img", lambda i, v: jnp.full((HW,), 2**30, jnp.int32).at[i].min(v), idx_131k, val_524k[:131072])
timeit("scatter-set 2M -> 131k (compaction)", lambda i, v: jnp.zeros((131072, 3)).at[i].set(v, mode="drop"), idx_2m, val3_2m)
timeit("scatter-set 524k -> 131k", lambda i, v: jnp.zeros((131072, 3)).at[i].set(v, mode="drop"), idx_2m[:524288], val3_2m[:524288])
timeit("scatter-add 524k scalar -> 307k", lambda i, v: jnp.zeros((HW,)).at[i].add(v, mode="drop"), idx_524k, val_524k.astype(jnp.float32))

# --- sort flavors
keys600k = jax.random.randint(k1, (614400,), 0, 1 << 30)
keys150k = keys600k[:153600]
keys2m = jax.random.randint(k2, (1 << 21,), 0, 1 << 30)
timeit("sort 600k i32", jnp.sort, keys600k)
timeit("sort 150k i32", jnp.sort, keys150k)
timeit("sort 2M i32", jnp.sort, keys2m)
timeit("sort 600k i32 + argsort payload", lambda x: jnp.argsort(x), keys600k)
timeit("cumsum 2M i32", lambda x: jnp.cumsum(x), (keys2m > 0).astype(jnp.int32))
timeit("cumsum 600k i32", lambda x: jnp.cumsum(x), (keys600k > 0).astype(jnp.int32))

# --- gather flavors
pool = jax.random.normal(k3, (65537, 512))
slots4k = jax.random.randint(k4, (4096,), 0, 65536)
timeit("gather 4k x 512-rows from 128MB pool", lambda p, s: p[s], pool, slots4k)
tbl307k = jax.random.normal(k1, (HW, 8))
idxhw = jax.random.randint(k2, (HW,), 0, HW)
timeit("gather 307k x 8 from 9.8MB", lambda t, i: t[i], tbl307k, idxhw)
timeit("gather 307k scalar from 1.2MB img", lambda t, i: t.reshape(-1)[i], tbl307k[:, 0], idxhw)
b16 = jax.random.normal(k3, (HW // 64, 64, 8))
i16 = jax.random.randint(k4, (HW // 64, 64), 0, 64)
timeit("rowwise take_along 64-band 307k", lambda t, i: jnp.take_along_axis(t, i[..., None], axis=1), b16, i16)

# one-hot matmul gather: 307k from 64-band
oh = jax.nn.one_hot(i16, 64, dtype=jnp.float32)
timeit("one-hot band gather 307k (bmm 4800x64x64x8)", lambda o, t: jnp.einsum("bqk,bkc->bqc", o, t), oh, b16)
