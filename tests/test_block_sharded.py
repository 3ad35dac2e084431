"""Sharded block-sparse pipeline: agreement with the single-device path.

Runs on the virtual 8-device CPU mesh (tests/conftest.py).  The sharded
step differs from the single-device one only by float reduction order
(psum'd ICP Gram matrices, composited splats), so trajectories must agree
to well under a voxel, and the union of per-shard maps must cover the
same blocks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import (
    BlockMapConfig,
    CameraConfig,
    ICPConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.ops.blockmap import EMPTY_KEY
from topfusion.parallel.block_sharded import (
    ShardedBlockPipeline,
    dryrun_sharded_block_step,
    make_mesh,
)

N_DEV = 8


def make_cfg() -> PipelineConfig:
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(4, 3, 2), level0_stride=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=1 << 12,
            max_new_blocks_per_frame=1024,
            max_visible_blocks=1 << 11,
            alloc_pixel_stride=1,
        ),
        raycast=RaycastConfig(max_steps=96),
    )


@pytest.fixture(scope="module")
def runs():
    cfg = make_cfg()
    scene = SyntheticScene()
    gt = orbit_trajectory(6, max_angle_deg=3.0, max_shift=0.03, seed=3)
    frames = [
        scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        for T in gt
    ]

    single = BlockPipeline(cfg)
    s1 = single.init()
    traj1 = []
    for f in frames:
        s1, aux1 = single.step(s1, f)
        assert bool(aux1.ok)
        traj1.append(np.asarray(s1.T_wc))

    mesh = make_mesh(N_DEV)
    sharded = ShardedBlockPipeline(cfg, mesh)
    s8 = sharded.init()
    traj8 = []
    for f in frames:
        s8, aux8 = sharded.step(s8, f)
        assert bool(aux8.ok)
        traj8.append(np.asarray(s8.T_wc))

    return cfg, s1, s8, np.stack(traj1), np.stack(traj8), aux1, aux8


def test_trajectory_matches_single_device(runs):
    cfg, s1, s8, traj1, traj8, _, _ = runs
    # Only reduction order differs -> sub-millimeter agreement.
    t_err = np.abs(traj1[:, :3, 3] - traj8[:, :3, 3]).max()
    r_err = np.abs(traj1[:, :3, :3] - traj8[:, :3, :3]).max()
    assert t_err < 1e-3, f"translation diverged: {t_err}"
    assert r_err < 1e-2, f"rotation diverged: {r_err}"


def test_block_sets_agree(runs):
    cfg, s1, s8, _, _, aux1, aux8 = runs
    n1 = int(np.asarray(s1.num_blocks))
    n8 = int(np.asarray(aux8.num_blocks))
    # Same allocation pass modulo pose jitter and per-shard bucket
    # overflow: totals within a few percent.
    assert abs(n1 - n8) <= max(16, 0.05 * n1), (n1, n8)
    # The union of shard-owned keys has no duplicates (ownership routes
    # every block to exactly one shard).
    keys8 = np.asarray(s8.bucket_keys).reshape(-1)
    live = keys8[keys8 != EMPTY_KEY]
    assert len(np.unique(live)) == len(live)


def test_sharded_model_maps_replicated_and_close(runs):
    cfg, s1, s8, _, _, _, _ = runs
    # Model maps come out of a psum -> identical on every device, and
    # close to the single-device splat where both hit.
    mp8 = np.asarray(s8.model_points[0])
    mp1 = np.asarray(s1.model_points[0])
    hit8 = np.any(mp8 != 0.0, axis=-1)
    hit1 = np.any(mp1 != 0.0, axis=-1)
    both = hit8 & hit1
    assert both.mean() > 0.5 * hit1.mean()
    err = np.linalg.norm(mp8[both] - mp1[both], axis=-1)
    assert np.median(err) < cfg.tsdf.voxel_size


def test_sharded_render(runs):
    cfg, s1, s8, _, _, _, _ = runs
    img = np.asarray(ShardedRender(runs))
    assert img.std() > 1.0


def ShardedRender(runs):
    cfg, s1, s8, *_ = runs
    mesh = make_mesh(N_DEV)
    pipe = ShardedBlockPipeline(cfg, mesh)
    return pipe.render(s8)


def test_dryrun_hook():
    dryrun_sharded_block_step(N_DEV)


def test_sharded_reset_on_garbage():
    cfg = make_cfg()
    mesh = make_mesh(N_DEV)
    pipe = ShardedBlockPipeline(cfg, mesh)
    scene = SyntheticScene()
    state = pipe.init()
    d = scene.render_depth_mm(cfg.camera, jnp.eye(4))
    for _ in range(2):
        state, aux = pipe.step(state, d)
        assert bool(aux.ok)
    state, aux = pipe.step(state, jnp.zeros_like(d))
    assert not bool(aux.ok) and bool(aux.was_reset)
    assert int(state.frame) == 0
    assert int(aux.num_blocks) == 0
    state, aux = pipe.step(state, d)
    assert bool(aux.ok) and int(state.frame) == 1

