"""End-to-end dense pipeline: synthetic sequence with known trajectory ->
near-zero ATE (SURVEY.md section 4c integration-test strategy)."""

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import (
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
from topfusion.models.pipeline import DensePipeline


def make_cfg():
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        # Synthetic depth is noise-free and this camera is 8x coarser than
        # VGA, where the default 7x7 bilateral window would flatten curved
        # geometry; kernel 1 == pass-through.
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(6, 4, 3)),
        dense=DenseVolumeConfig(dims=(96, 96, 96), origin=(-0.48, -0.48, 0.4)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        raycast=RaycastConfig(max_steps=160),
    )


@pytest.fixture(scope="module")
def run_sequence():
    cfg = make_cfg()
    scene = SyntheticScene()
    n = 10
    gt_poses = orbit_trajectory(n, max_angle_deg=4.0, max_shift=0.04, seed=3)
    pipe = DensePipeline(cfg)
    state = pipe.init()
    est_poses, auxes = [], []
    for T_gt in gt_poses:
        depth_mm = scene.render_depth_mm(cfg.camera, jnp.asarray(T_gt, jnp.float32))
        state, aux = pipe.step(state, depth_mm)
        est_poses.append(np.asarray(state.T_wc))
        auxes.append(aux)
    return cfg, gt_poses, est_poses, auxes, state, pipe


def test_tracking_succeeds(run_sequence):
    _, _, _, auxes, state, _ = run_sequence
    for i, aux in enumerate(auxes):
        assert bool(aux.ok), f"tracking failed at frame {i}"
    assert int(state.resets) == 0
    assert int(state.frame) == 10


def test_ate_near_zero(run_sequence):
    _, gt, est, _, _, _ = run_sequence
    ate = ate_rmse(est, gt, align=False)
    assert ate < 0.01, f"ATE {ate*1000:.2f} mm"


def test_inlier_counts_reasonable(run_sequence):
    _, _, _, auxes, _, _ = run_sequence
    # After frame 0 the model raycast must supply plenty of correspondences
    # (level-0 rows are subsampled by icp.level0_stride^2).
    for aux in auxes[1:]:
        assert int(aux.num_inliers) > 150


def test_render_produces_image(run_sequence):
    cfg, _, _, _, state, pipe = run_sequence
    img = np.asarray(pipe.render(state))
    assert img.shape == (cfg.camera.height, cfg.camera.width, 3)
    assert img.dtype == np.uint8
    # Some foreground hit (not all background gradient).
    assert img.std() > 5


def test_reset_on_garbage_frame():
    """A frame with no valid depth must fail tracking and reset the map
    (reference behaviour: topfu.cpp:263-264)."""
    cfg = make_cfg()
    scene = SyntheticScene()
    pipe = DensePipeline(cfg)
    state = pipe.init()
    d0 = scene.render_depth_mm(cfg.camera, jnp.eye(4))
    state, aux0 = pipe.step(state, d0)
    assert bool(aux0.ok)
    garbage = jnp.zeros(cfg.camera.shape, jnp.uint16)
    state, aux1 = pipe.step(state, garbage)
    assert not bool(aux1.ok)
    assert bool(aux1.was_reset)
    assert int(state.resets) == 1
    # Pose restarted from identity; failed frame discarded; next frame
    # takes the frame-0 fast path (reference: topfu.cpp:200-209, 263-264).
    np.testing.assert_allclose(np.asarray(state.T_wc), np.eye(4), atol=1e-6)
    assert int(state.frame) == 0
    assert np.all(np.asarray(state.weight) == 0.0)
    state, aux2 = pipe.step(state, d0)
    assert bool(aux2.ok) and not bool(aux2.was_reset)
    # And the frame after that tracks normally against the rebuilt model.
    state, aux3 = pipe.step(state, d0)
    assert bool(aux3.ok) and int(aux3.num_inliers) > 150
