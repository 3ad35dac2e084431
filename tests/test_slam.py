"""SLAM system: odometry + keyframes + loop closure end-to-end."""

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import (
    BlockMapConfig,
    CameraConfig,
    ICPConfig,
    PipelineConfig,
    PoseGraphConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.geometry.se3 import se3_exp
from topfusion.io.synthetic import SyntheticScene
from topfusion.io.trajectory import ate_rmse
from topfusion.models.slam import SlamSystem


def make_cfg():
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(6, 4, 3)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=1 << 13,
            max_new_blocks_per_frame=2048,
            max_visible_blocks=1 << 12,
            alloc_pixel_stride=1,
        ),
        raycast=RaycastConfig(max_steps=160),
        posegraph=PoseGraphConfig(
            max_keyframes=16,
            max_edges=64,
            keyframe_every=3,
            loop_candidate_window=2,
            loop_max_dist=0.3,
            gn_iters=5,
        ),
    )


def out_and_back(n):
    poses = []
    for i in range(n):
        s = np.sin(np.pi * i / (n - 1))
        xi = np.array([0, 0.08 * s, 0, 0.10 * s, 0.02 * s, 0], np.float32)
        poses.append(np.asarray(se3_exp(jnp.asarray(xi))))
    return poses


def test_slam_closes_loop_and_improves():
    cfg = make_cfg()
    scene = SyntheticScene()
    gt = out_and_back(15)
    slam = SlamSystem(cfg)
    for T in gt:
        d = scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        info = slam.process_frame(d)
        assert info["ok"], f"tracking lost at {info}"
    assert int(slam.graph.num_kf) == 5
    assert slam.loops_closed >= 1, "out-and-back must close a loop"
    odom = ate_rmse(slam.odom_poses, gt, align=False)
    opt = ate_rmse(slam.optimized_trajectory(), gt, align=False)
    assert opt < 0.02
    # optimized must not be (much) worse than odometry
    assert opt < odom * 1.5 + 1e-3


def test_map_correction_after_loop():
    """Post-loop render must be consistent with the OPTIMIZED trajectory:
    after a closure, the map is re-fused at the optimized keyframe poses
    and the live pose re-anchors (PoseGraphConfig.map_correction)."""
    import dataclasses

    from topfusion.ops.tsdf_block import raycast_blocks

    cfg = make_cfg()
    cfg = dataclasses.replace(
        cfg,
        posegraph=dataclasses.replace(
            cfg.posegraph, min_map_correction=0.0  # any correction triggers
        ),
    )
    scene = SyntheticScene()
    gt = out_and_back(15)
    slam = SlamSystem(cfg)
    for T in gt:
        d = scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        info = slam.process_frame(d)
        assert info["ok"]
    assert slam.loops_closed >= 1
    assert slam.reintegrations >= 1, "loop closure must trigger re-fusion"

    # The rebuilt map, raycast from the corrected live pose, must
    # reproduce the scene depth rendered at the matching ground-truth
    # viewpoint (out-and-back ends where it started: identity).
    opt_traj = slam.optimized_trajectory()
    T_live = jnp.asarray(opt_traj[-1], jnp.float32)
    rc = raycast_blocks(
        slam.state.block_map(), cfg.camera, cfg.tsdf, cfg.blockmap,
        cfg.raycast, jnp.asarray(np.asarray(slam.state.T_wc)),
    )
    d_scene = (
        np.asarray(
            scene.render_depth_mm(cfg.camera, T_live), np.float32
        )
        / 1000.0
    )
    d_map = np.asarray(rc.depth)
    both = (d_map > 0) & (d_scene > 0) & np.asarray(rc.hit)
    assert both.mean() > 0.5
    dd = np.abs(d_map - d_scene)[both]
    assert np.median(dd) < 3 * cfg.tsdf.voxel_size, (
        f"post-loop map inconsistent with optimized trajectory: "
        f"median depth error {np.median(dd)*1000:.1f} mm"
    )

    # Tracking continues seamlessly in the corrected frame.
    for T in out_and_back(15)[-3:]:
        d = scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        info = slam.process_frame(d)
        assert info["ok"], "tracking lost after re-integration"


def test_slam_trajectory_lengths():
    cfg = make_cfg()
    scene = SyntheticScene()
    slam = SlamSystem(cfg)
    for T in out_and_back(7):
        slam.process_frame(scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32)))
    assert len(slam.odom_poses) == 7
    assert len(slam.optimized_trajectory()) == 7
