"""Per-stage timing of the block pipeline on the current backend."""
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
from topfusion.ops.depth import preprocess_depth
from topfusion.ops.normals import build_maps_pyramid, resize_points_normals
from topfusion.ops.icp import icp_track
from topfusion.ops.tsdf_block import (
    allocate_from_depth, visible_blocks, integrate_blocks, raycast_blocks,
)
from topfusion.ops.splat import splat_model_maps

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

f_pre = jax.jit(lambda d: preprocess_depth(d, cfg.preproc))
raw_m, pyr = f_pre(depth_mm)
f_maps = jax.jit(lambda p: build_maps_pyramid(cam, p))
cur_pts, cur_nrm = f_maps(pyr)
f_icp = jax.jit(lambda T, cp, cn, mp, mn: icp_track(
    cam, cfg.icp, T, T, cp, cn, list(mp), list(mn)))
f_alloc = jax.jit(lambda m, T, d: allocate_from_depth(m, cam, cfg.tsdf, cfg.blockmap, T, d))
f_vis = jax.jit(lambda m, T: visible_blocks(m, cam, cfg.tsdf, cfg.blockmap, T))
vis = f_vis(m, T)
f_int = jax.jit(lambda m, T, d, vis: integrate_blocks(m, cam, cfg.tsdf, cfg.blockmap, T, d, vis))
f_splat = jax.jit(lambda m, T, vis: splat_model_maps(m, cam, cfg.tsdf, cfg.blockmap, T, vis))
margin = cfg.icp.dist_threshold + 3.0 * cfg.tsdf.trunc_dist
f_ray_g = jax.jit(lambda m, T, d: raycast_blocks(
    m, cam, cfg.tsdf, cfg.blockmap, cfg.raycast, T,
    expected_depth=d, depth_margin=margin, max_steps=cfg.raycast.guided_max_steps))
f_ray = jax.jit(lambda m, T: raycast_blocks(m, cam, cfg.tsdf, cfg.blockmap, cfg.raycast, T))
f_resize = jax.jit(resize_points_normals)


def _fence(out):
    return jax.block_until_ready(out)


def timeit(name, fn, *args, n=10):
    out = _fence(fn(*args))  # compile
    # Latency: fence every call (includes the dispatch round-trip).
    t0 = time.perf_counter()
    for _ in range(3):
        out = _fence(fn(*args))
    lat = (time.perf_counter() - t0) / 3
    # Throughput: queue n dispatches, fence once — per-call cost is
    # max(device time, dispatch submit cost), hiding the round-trip.
    t0 = time.perf_counter()
    for _ in range(n):
        out = fn(*args)
    _fence(out)
    thr = (time.perf_counter() - t0) / n
    print(f"{name:28s} lat {lat*1e3:8.2f} ms   pipelined {thr*1e3:8.2f} ms",
          flush=True)
    return out


timeit("preprocess_depth", f_pre, depth_mm)
timeit("build_maps_pyramid", f_maps, pyr)
timeit("icp_track(10,5,4)", f_icp, T, cur_pts, cur_nrm, state.model_points, state.model_normals)
timeit("allocate_from_depth", f_alloc, m, T, raw_m)
timeit("visible_blocks", f_vis, m, T)
timeit("integrate_blocks", f_int, m, T, raw_m, vis)
timeit("splat_model_maps", f_splat, m, T, vis)
timeit("raycast guided", f_ray_g, m, T, raw_m)
timeit("raycast full", f_ray, m, T)
rc = f_ray_g(m, T, raw_m)
timeit("resize_points_normals", f_resize, rc.points, rc.normals)
timeit("FULL step", pipe.step, state, depth_mm)
