"""Sub-stage timing: splat internals + preprocess internals on the backend."""
import time
import sys
sys.path.insert(0, __file__.rsplit('/', 2)[0])
from topfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()
import jax, jax.numpy as jnp
import numpy as np

from topfusion.config import (
    BlockMapConfig, CameraConfig, ICPConfig, PipelineConfig, RaycastConfig,
    TSDFConfig,
)
from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.ops.depth import (
    bilateral_filter, depth_to_meters, downsample_depth, preprocess_depth,
)
from topfusion.ops.splat import splat_model_maps
from topfusion.ops.tsdf_block import visible_blocks

cam = CameraConfig()
cfg = PipelineConfig(
    camera=cam,
    icp=ICPConfig(iters=(10, 5, 4)),
    tsdf=TSDFConfig(voxel_size=0.005, trunc_dist=0.02),
    blockmap=BlockMapConfig(max_visible_blocks=1 << 12),
    raycast=RaycastConfig(max_steps=192),
)

scene = SyntheticScene()
poses = orbit_trajectory(4, max_angle_deg=3.0, max_shift=0.03, seed=1)
frames = [scene.render_depth_mm(cam, jnp.asarray(T, jnp.float32)) for T in poses]
frames = jax.block_until_ready(frames)

pipe = BlockPipeline(cfg)
state = pipe.init()
state, _ = pipe.step(state, frames[0])
state, _ = pipe.step(state, frames[1])
np.asarray(state.T_wc[0, 0])

m = state.block_map()
T = state.T_wc
depth_mm = frames[2]


def _fence(out):
    return jax.block_until_ready(out)


def timeit(name, fn, *args, n=10):
    f = jax.jit(fn)
    out = _fence(f(*args))
    t0 = time.perf_counter()
    for _ in range(n):
        out = f(*args)
    _fence(out)
    thr = (time.perf_counter() - t0) / n
    print(f"{name:40s} {thr*1e3:9.3f} ms", flush=True)
    return out


d_m = timeit("depth_to_meters", depth_to_meters, depth_mm)
timeit("bilateral 7x7", bilateral_filter, d_m)
timeit("downsample L1", downsample_depth, d_m)
timeit("preprocess full", lambda d: preprocess_depth(d, cfg.preproc), depth_mm)

f_vis = jax.jit(lambda m, T: visible_blocks(m, cam, cfg.tsdf, cfg.blockmap, T))
vis = _fence(f_vis(m, T))
timeit("splat NEW", lambda m, T, vis: splat_model_maps(m, cam, cfg.tsdf, cfg.blockmap, T, vis), m, T, vis)
timeit("FULL step", pipe.step, state, depth_mm)
