"""Multi-device tests on the virtual 8-device CPU mesh: sharded pipeline
dryrun + distributed BA agreement with the single-device solver."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import CameraConfig, PoseGraphConfig
from topfusion.geometry.se3 import se3_exp, se3_inverse
from topfusion.models.posegraph import (
    add_keyframe,
    make_pose_graph,
    optimize,
)
from topfusion.parallel.dist_ba import optimize_distributed
from topfusion.parallel.sharded_pipeline import dryrun_sharded_step, make_mesh

CAM_L = CameraConfig(width=20, height=16, fx=15.0, fy=15.0, cx=10.0, cy=8.0)
PG_CFG = PoseGraphConfig(max_keyframes=16, max_edges=64, gn_iters=6)


def build_drifted_graph():
    pg = make_pose_graph(PG_CFG, CAM_L)
    p = jnp.ones((CAM_L.height, CAM_L.width, 3), jnp.float32)
    n = jnp.ones((CAM_L.height, CAM_L.width, 3), jnp.float32)
    true = [se3_exp(jnp.asarray([0, 0, 0.01 * i, 0.05 * i, 0, 0], jnp.float32)) for i in range(8)]
    drift = [se3_exp(jnp.asarray([0, 0, 0.01 * i, 0.05 * i, 0.012 * i, 0], jnp.float32)) for i in range(8)]
    for i in range(8):
        pg = add_keyframe(pg, drift[i], p, n, jnp.asarray(i), jnp.asarray(True))
    eT = pg.edge_T
    for e in range(7):
        eT = eT.at[e].set(se3_inverse(true[e]) @ true[e + 1])
    pg = pg._replace(edge_T=eT)
    pg = pg._replace(
        edge_i=pg.edge_i.at[7].set(0),
        edge_j=pg.edge_j.at[7].set(7),
        edge_T=pg.edge_T.at[7].set(se3_inverse(true[0]) @ true[7]),
        edge_is_loop=pg.edge_is_loop.at[7].set(True),
        num_edges=jnp.asarray(8, jnp.int32),
    )
    return pg, true


@pytest.mark.parametrize("n_dev", [2, 8])
def test_dryrun_sharded_pipeline(n_dev):
    dryrun_sharded_step(n_dev)


def test_distributed_ba_matches_single_device():
    pg, true = build_drifted_graph()
    pg_s, chi_s = optimize(pg, PG_CFG)
    mesh = make_mesh(8, axis="ba")
    pg_d, chi_d = optimize_distributed(pg, PG_CFG, mesh)
    np.testing.assert_allclose(
        np.asarray(pg_d.kf_poses[:8]), np.asarray(pg_s.kf_poses[:8]), atol=1e-4
    )
    # Both must pull nodes onto the true trajectory.
    for i in range(8):
        err = np.asarray(pg_d.kf_poses[i][:3, 3]) - np.asarray(true[i][:3, 3])
        assert np.linalg.norm(err) < 5e-3


def test_distributed_ba_jittable():
    pg, _ = build_drifted_graph()
    mesh = make_mesh(4, axis="ba")
    f = jax.jit(lambda g: optimize_distributed(g, PG_CFG, mesh))
    pg_d, chi = f(pg)
    assert np.isfinite(float(chi))
