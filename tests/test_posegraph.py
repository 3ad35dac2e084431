"""Pose graph: insertion, loop detection, Gauss-Newton convergence."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import CameraConfig, ICPConfig, PoseGraphConfig
from topfusion.geometry.se3 import se3_exp, se3_log, se3_inverse
from topfusion.io.synthetic import SyntheticScene
from topfusion.models.posegraph import (
    PoseGraph,
    add_keyframe,
    detect_loop,
    edge_residuals,
    make_pose_graph,
    optimize,
)
from topfusion.ops.depth import build_depth_pyramid
from topfusion.ops.normals import compute_points_normals
from topfusion.config import PreprocConfig

CAM = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
CAM_L = CAM.at_level(1)
PG_CFG = PoseGraphConfig(max_keyframes=16, max_edges=64, gn_iters=8)
ICP_CFG = ICPConfig()
SCENE = SyntheticScene()


def kf_maps(T):
    depth = SCENE.render_depth(CAM_L, jnp.asarray(T, jnp.float32))
    return compute_points_normals(CAM_L, depth)


def test_add_keyframes_and_odometry_edges():
    pg = make_pose_graph(PG_CFG, CAM_L)
    p, n = kf_maps(jnp.eye(4))
    for i in range(4):
        T = se3_exp(jnp.asarray([0, 0, 0, 0.01 * i, 0, 0], jnp.float32))
        pg = add_keyframe(pg, T, p, n, jnp.asarray(i * 10), jnp.asarray(True))
    assert int(pg.num_kf) == 4
    assert int(pg.num_edges) == 3  # odometry chain
    # measured relative transforms = inv(T_i) T_j
    Tm = np.asarray(pg.edge_T[0])
    np.testing.assert_allclose(Tm[:3, 3], [0.01, 0, 0], atol=1e-6)


def test_add_keyframe_masked():
    pg = make_pose_graph(PG_CFG, CAM_L)
    p, n = kf_maps(jnp.eye(4))
    pg = add_keyframe(pg, jnp.eye(4), p, n, jnp.asarray(0), jnp.asarray(False))
    assert int(pg.num_kf) == 0 and int(pg.num_edges) == 0


def test_optimize_corrects_drift():
    """Chain of keyframes with perfect odometry measurements but drifted
    node estimates + one loop edge -> GN pulls nodes back."""
    pg = make_pose_graph(PG_CFG, CAM_L)
    p, n = kf_maps(jnp.eye(4))
    # True poses: walk along x then back (loop).
    true = [se3_exp(jnp.asarray([0, 0, 0, 0.05 * i, 0, 0], jnp.float32)) for i in range(6)]
    # Estimated poses drift in y.
    drift = [se3_exp(jnp.asarray([0, 0, 0, 0.05 * i, 0.01 * i, 0], jnp.float32)) for i in range(6)]
    for i in range(6):
        pg = add_keyframe(pg, drift[i], p, n, jnp.asarray(i), jnp.asarray(True))
    # Overwrite odometry measurements with the TRUE relatives.
    eT = pg.edge_T
    for e in range(5):
        eT = eT.at[e].set(se3_inverse(true[e]) @ true[e + 1])
    pg = pg._replace(edge_T=eT)
    # Loop edge 0 -> 5 with true relative.
    pg = pg._replace(
        edge_i=pg.edge_i.at[5].set(0),
        edge_j=pg.edge_j.at[5].set(5),
        edge_T=pg.edge_T.at[5].set(se3_inverse(true[0]) @ true[5]),
        edge_is_loop=pg.edge_is_loop.at[5].set(True),
        num_edges=jnp.asarray(6, jnp.int32),
    )
    r0 = np.linalg.norm(np.asarray(edge_residuals(jnp.zeros((16, 6)), pg)))
    pg2, chi2 = optimize(pg, PG_CFG)
    r1 = np.linalg.norm(np.asarray(edge_residuals(jnp.zeros((16, 6)), pg2)))
    assert r1 < r0 * 0.05, f"residual {r0} -> {r1}"
    # Node 0 is the gauge anchor.
    np.testing.assert_allclose(np.asarray(pg2.kf_poses[0]), np.asarray(drift[0]), atol=1e-5)
    # Optimized poses near the true ones (up to the anchored gauge).
    for i in range(6):
        err = np.asarray(pg2.kf_poses[i][:3, 3]) - np.asarray(true[i][:3, 3])
        assert np.linalg.norm(err) < 5e-3, f"node {i} err {err}"


def test_detect_loop_on_revisit():
    """Keyframes far apart in index but at the same pose must close a loop."""
    cfg = PoseGraphConfig(max_keyframes=16, max_edges=64, loop_candidate_window=3,
                          loop_max_dist=0.5, gn_iters=5)
    pg = make_pose_graph(cfg, CAM_L)
    poses = []
    for i in range(8):
        # Walk away then return to start.
        x = 0.05 * i if i < 4 else 0.05 * (7 - i)
        poses.append(se3_exp(jnp.asarray([0, 0, 0, x, 0, 0], jnp.float32)))
    for i, T in enumerate(poses):
        p, n = kf_maps(T)
        pg = add_keyframe(pg, T, p, n, jnp.asarray(i), jnp.asarray(True))
    pg, found, info = detect_loop(pg, CAM_L, cfg, ICP_CFG)
    assert bool(found), "revisit loop not detected"
    # A loop edge connects an early node to the last node (multi-query
    # detection may additionally close slightly older keyframes).
    n_e = int(pg.num_edges)
    loops = [
        e for e in range(n_e)
        if bool(pg.edge_is_loop[e]) and int(pg.edge_j[e]) == 7
    ]
    assert loops, "no loop edge for the newest keyframe"
    e = loops[0]
    assert int(pg.edge_i[e]) <= 2
    assert bool(pg.kf_loop_done[7])
    assert int(info.n_closed) >= 1 and int(info.inliers) > 0
    assert float(info.residual) < cfg.huber_delta
    # Measured transform close to the true relative.
    Ti = poses[int(pg.edge_i[e])]
    T_true = np.asarray(se3_inverse(Ti) @ poses[7])
    np.testing.assert_allclose(np.asarray(pg.edge_T[e]), T_true, atol=5e-3)


def test_no_loop_when_far():
    cfg = PoseGraphConfig(max_keyframes=16, max_edges=64, loop_candidate_window=2,
                          loop_max_dist=0.05)
    pg = make_pose_graph(cfg, CAM_L)
    for i in range(6):
        T = se3_exp(jnp.asarray([0, 0, 0, 0.2 * i, 0, 0], jnp.float32))
        p, n = kf_maps(T)
        pg = add_keyframe(pg, T, p, n, jnp.asarray(i), jnp.asarray(True))
    pg, found, _ = detect_loop(pg, CAM_L, cfg, ICP_CFG)
    assert not bool(found)
