"""Block-sparse pipeline: end-to-end tracking + parity with the dense path
(SURVEY.md section 7.2 M3: match dense trajectories on overlapping configs)."""

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import (
    BlockMapConfig,
    CameraConfig,
    DenseVolumeConfig,
    ICPConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion.io.trajectory import ate_rmse
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.models.pipeline import DensePipeline
from topfusion.ops.tsdf_block import raycast_blocks


def make_cfg():
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(6, 4, 3)),
        dense=DenseVolumeConfig(dims=(96, 96, 96), origin=(-0.48, -0.48, 0.4)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=1 << 13,
            max_new_blocks_per_frame=2048,
            max_visible_blocks=1 << 12,
            alloc_pixel_stride=1,
            alloc_steps=6,
        ),
        raycast=RaycastConfig(max_steps=160),
    )


@pytest.fixture(scope="module")
def run_sequence():
    cfg = make_cfg()
    scene = SyntheticScene()
    n = 8
    gt_poses = orbit_trajectory(n, max_angle_deg=4.0, max_shift=0.04, seed=3)
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    est_poses, auxes = [], []
    for T_gt in gt_poses:
        depth_mm = scene.render_depth_mm(cfg.camera, jnp.asarray(T_gt, jnp.float32))
        state, aux = pipe.step(state, depth_mm)
        est_poses.append(np.asarray(state.T_wc))
        auxes.append(aux)
    return cfg, gt_poses, est_poses, auxes, state, pipe


def test_block_tracking_succeeds(run_sequence):
    _, _, _, auxes, state, _ = run_sequence
    for i, aux in enumerate(auxes):
        assert bool(aux.ok), f"tracking failed at frame {i}"
    assert int(state.resets) == 0


def test_block_ate_near_zero(run_sequence):
    _, gt, est, _, _, _ = run_sequence
    ate = ate_rmse(est, gt, align=False)
    assert ate < 0.012, f"ATE {ate*1000:.2f} mm"


def test_block_allocation_grows_then_saturates(run_sequence):
    _, _, _, auxes, state, _ = run_sequence
    allocs = [int(a.blocks_allocated) for a in auxes]
    assert allocs[0] > 50  # first frame allocates the visible band
    # most of the map exists after a few frames of small motion
    assert allocs[-1] < allocs[0] * 0.2
    assert int(state.num_blocks) < state.tsdf.shape[0]  # under capacity
    for a in auxes:
        assert int(a.num_visible) > 0


def test_block_raycast_matches_exact_depth(run_sequence):
    cfg, gt, _, _, state, _ = run_sequence
    scene = SyntheticScene()
    T = jnp.asarray(gt[-1], jnp.float32)
    rc = raycast_blocks(
        state.block_map(), cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast, T
    )
    gt_depth = np.asarray(scene.render_depth(cfg.camera, T))
    hit = np.asarray(rc.hit)
    in_range = (gt_depth > 0) & (gt_depth < 1.5)
    got = np.asarray(rc.depth)
    mask = hit & in_range
    assert mask.mean() > 0.3
    err = np.abs(got[mask] - gt_depth[mask])
    assert np.median(err) < 0.02, f"median {np.median(err)}"  # ~1.5 voxels at 10mm


def test_block_matches_dense_trajectory():
    """Dense and block pipelines on the same sequence must agree closely
    (same fusion semantics, different indexing).  Model maps pinned to the
    marching raycast on both sides so only the map indexing differs."""
    import dataclasses

    cfg = make_cfg()
    cfg = dataclasses.replace(
        cfg, raycast=dataclasses.replace(cfg.raycast, model_maps="raycast")
    )
    scene = SyntheticScene()
    gt_poses = orbit_trajectory(6, max_angle_deg=3.0, max_shift=0.03, seed=11)
    dp = DensePipeline(cfg)
    bp = BlockPipeline(cfg)
    ds, bs = dp.init(), bp.init()
    dpos, bpos = [], []
    for T in gt_poses:
        depth = scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        ds, _ = dp.step(ds, depth)
        bs, _ = bp.step(bs, depth)
        dpos.append(np.asarray(ds.T_wc))
        bpos.append(np.asarray(bs.T_wc))
    for i, (a, b) in enumerate(zip(dpos, bpos)):
        t_diff = np.linalg.norm(a[:3, 3] - b[:3, 3])
        assert t_diff < 0.01, f"frame {i}: dense/block diverge {t_diff*1000:.1f} mm"


def test_block_reset_on_garbage():
    cfg = make_cfg()
    scene = SyntheticScene()
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    d0 = scene.render_depth_mm(cfg.camera, jnp.eye(4))
    state, aux0 = pipe.step(state, d0)
    assert bool(aux0.ok) and int(state.num_blocks) > 0
    state, aux1 = pipe.step(state, jnp.zeros(cfg.camera.shape, jnp.uint16))
    assert not bool(aux1.ok) and bool(aux1.was_reset)
    assert int(state.num_blocks) == 0  # map wiped
    assert int(state.frame) == 0
    state, aux2 = pipe.step(state, d0)
    assert bool(aux2.ok) and int(state.num_blocks) > 0
