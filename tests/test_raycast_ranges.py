"""Expected-depth ranges for free-view raycast.

The reference rasterizes per-pixel zmin/zmax from the visible blocks
before every raycast (reference: CreateExpectedDepths,
VisualisationEngine_CUDA.cu:119-173, VisualisationHelper.cu:52-121) so
castRay only marches the occupied band.  These tests check the
re-design (ops/tsdf_block.expected_depth_ranges):

  * the band brackets the true surface depth wherever the full march hits;
  * a ranged raycast with far fewer lockstep steps reproduces the
    unranged full-frustum march, including from a NOVEL viewpoint (the
    case the per-frame depth-guided band cannot serve);
  * cells with no visible block produce an empty band and no hits.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import (
    BlockMapConfig,
    CameraConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
    ICPConfig,
)
from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.ops.tsdf_block import (
    expected_depth_ranges,
    raycast_blocks,
    visible_blocks,
)


def make_cfg():
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(4, 3, 2)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=1 << 13,
            max_new_blocks_per_frame=2048,
            max_visible_blocks=1 << 12,
            alloc_pixel_stride=1,
            alloc_steps=6,
        ),
        raycast=RaycastConfig(max_steps=160, range_subsample=8,
                              ranged_max_steps=48),
    )


@pytest.fixture(scope="module")
def fused_state():
    cfg = make_cfg()
    scene = SyntheticScene()
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    for T in orbit_trajectory(4, max_angle_deg=3.0, max_shift=0.03, seed=1):
        depth_mm = scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        state, aux = pipe.step(state, depth_mm)
        assert bool(aux.ok)
    return cfg, scene, pipe, state


def _novel_pose():
    # A viewpoint never integrated from: shifted + rotated off the orbit.
    c, s = np.cos(0.12), np.sin(0.12)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.asarray([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
    T[:3, 3] = [0.08, -0.05, -0.06]
    return jnp.asarray(T)


def test_ranges_bracket_surface(fused_state):
    cfg, _, _, state = fused_state
    m = state.block_map()
    T = _novel_pose()
    vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T)
    ranges = expected_depth_ranges(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, T, vis, subsample=8
    )
    rc = raycast_blocks(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast, T
    )
    sub = 8
    zlo = np.repeat(np.repeat(np.asarray(ranges[..., 0]), sub, 0), sub, 1)
    zhi = np.repeat(np.repeat(np.asarray(ranges[..., 1]), sub, 0), sub, 1)
    h, w = cfg.camera.height, cfg.camera.width
    zlo, zhi = zlo[:h, :w], zhi[:h, :w]
    hit = np.asarray(rc.hit)
    d = np.asarray(rc.depth)
    slack = cfg.tsdf.voxel_size
    assert hit.sum() > 500
    assert np.all(d[hit] >= zlo[hit] - slack)
    assert np.all(d[hit] <= zhi[hit] + slack)


def test_ranged_raycast_matches_full_march(fused_state):
    cfg, _, _, state = fused_state
    m = state.block_map()
    T = _novel_pose()
    full = raycast_blocks(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast, T
    )
    vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T)
    ranges = expected_depth_ranges(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, T, vis,
        subsample=cfg.raycast.range_subsample,
    )
    ranged = raycast_blocks(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast, T,
        range_image=ranges,
        max_steps=cfg.raycast.ranged_max_steps,  # 48 << 160
    )
    f_hit = np.asarray(full.hit)
    r_hit = np.asarray(ranged.hit)
    # Hit sets agree except at grazing block borders.
    assert (f_hit ^ r_hit).mean() < 0.02
    both = f_hit & r_hit
    dd = np.abs(np.asarray(full.depth) - np.asarray(ranged.depth))[both]
    # Entry points differ, so the linear crossing estimate differs at the
    # sub-voxel level; a tenth of a voxel is agreement.
    assert np.median(dd) < cfg.tsdf.voxel_size * 0.1
    assert (dd < cfg.tsdf.voxel_size).mean() > 0.99


def test_empty_cells_kill_rays(fused_state):
    cfg, _, _, state = fused_state
    m = state.block_map()
    # Look straight away from the scene: nothing visible.
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.diag([1.0, -1.0, -1.0]).astype(np.float32)  # 180deg about x
    T = jnp.asarray(T)
    vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T)
    ranges = expected_depth_ranges(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, T, vis, subsample=8
    )
    assert np.all(np.asarray(ranges[..., 0]) >= np.asarray(ranges[..., 1]))
    rc = raycast_blocks(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast, T,
        range_image=ranges, max_steps=cfg.raycast.ranged_max_steps,
    )
    assert not bool(np.asarray(rc.hit).any())
    assert np.all(np.isfinite(np.asarray(rc.points)))


def test_pipeline_render_uses_ranges(fused_state):
    cfg, _, pipe, state = fused_state
    img = pipe.render(state)
    assert img.shape == (cfg.camera.height, cfg.camera.width, 3)
    # Novel-view render overload.
    img2 = pipe.render(state, _novel_pose())
    assert np.asarray(img2).max() > 0
