"""Forward-projection splatting: coverage + accuracy vs exact geometry."""

import jax.numpy as jnp
import numpy as np
import pytest

from tests.test_pipeline_block import make_cfg
from topfusion.io.synthetic import SyntheticScene
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.ops.splat import splat_model_maps
from topfusion.ops.tsdf_block import visible_blocks, raycast_blocks


@pytest.fixture(scope="module")
def fused_state():
    cfg = make_cfg()
    scene = SyntheticScene()
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    d = scene.render_depth_mm(cfg.camera, jnp.eye(4))
    for _ in range(3):
        state, aux = pipe.step(state, d)
        assert bool(aux.ok)
    return cfg, scene, state


def test_splat_points_on_surface(fused_state):
    cfg, scene, state = fused_state
    m = state.block_map()
    vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, jnp.eye(4))
    rc = splat_model_maps(m, cfg.camera, cfg.tsdf, cfg.blockmap, jnp.eye(4), vis)
    hit = np.asarray(rc.hit)
    pts = np.asarray(rc.points)[hit]
    # Splatted points must lie on the true surface (analytic SDF ~ 0).
    sd = np.abs(np.asarray(scene.sdf(jnp.asarray(pts))))
    # Projective-TSDF bias on slanted surfaces puts the zero level set a
    # fraction of a voxel off the true surface; sub-voxel is the bar.
    assert np.median(sd) < cfg.tsdf.voxel_size * 0.8
    assert np.percentile(sd, 90) < cfg.tsdf.voxel_size * 3


def test_splat_coverage_vs_raycast(fused_state):
    cfg, scene, state = fused_state
    m = state.block_map()
    vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, jnp.eye(4))
    sp = splat_model_maps(m, cfg.camera, cfg.tsdf, cfg.blockmap, jnp.eye(4), vis)
    rc = raycast_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast, jnp.eye(4))
    cov_sp = np.asarray(sp.hit).mean()
    cov_rc = np.asarray(rc.hit).mean()
    # Splats must cover a comparable fraction of the raycast coverage.
    assert cov_sp > 0.7 * cov_rc, f"splat {cov_sp:.2f} vs raycast {cov_rc:.2f}"
    # And agree on depth where both hit.
    both = np.asarray(sp.hit) & np.asarray(rc.hit)
    err = np.abs(np.asarray(sp.depth)[both] - np.asarray(rc.depth)[both])
    assert np.median(err) < cfg.tsdf.voxel_size


def test_splat_normals_consistent(fused_state):
    cfg, scene, state = fused_state
    m = state.block_map()
    vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, jnp.eye(4))
    sp = splat_model_maps(m, cfg.camera, cfg.tsdf, cfg.blockmap, jnp.eye(4), vis)
    valid = np.any(np.asarray(sp.normals) != 0, axis=-1)
    n = np.asarray(sp.normals)[valid]
    np.testing.assert_allclose(np.linalg.norm(n, axis=1), 1.0, atol=1e-4)
    # normals face the camera (negative z-ish dot with view dir from origin)
    pts = np.asarray(sp.points)[valid]
    assert (np.sum(n * pts, axis=1) < 0).mean() > 0.95
