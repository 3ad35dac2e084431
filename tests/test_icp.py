"""ICP tracking tests on synthetic analytic-SDF frames."""

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import CameraConfig, ICPConfig, PreprocConfig
from topfusion.geometry.se3 import se3_exp, se3_log, se3_inverse
from topfusion.io.synthetic import SyntheticScene
from topfusion.ops.depth import build_depth_pyramid
from topfusion.ops.normals import build_maps_pyramid
from topfusion.geometry.se3 import transform_points, rotate_vectors
from topfusion.ops.icp import icp_track, build_normal_equations

CAM = CameraConfig(width=160, height=120, fx=120.0, fy=120.0, cx=80.0, cy=60.0)
PRE = PreprocConfig()
SCENE = SyntheticScene()


def frame_maps(T_wc):
    depth = SCENE.render_depth(CAM, jnp.asarray(T_wc, jnp.float32))
    pyr = build_depth_pyramid(depth, PRE)
    return build_maps_pyramid(CAM, pyr)


def world_maps(T_wc, pts_pyr, nrm_pyr):
    """Camera-space maps -> world-space (as raycast model maps would be)."""
    T = jnp.asarray(T_wc, jnp.float32)
    out_p, out_n = [], []
    for p, n in zip(pts_pyr, nrm_pyr):
        valid = jnp.any(p != 0.0, axis=-1, keepdims=True)
        out_p.append(jnp.where(valid, transform_points(T, p), 0.0))
        out_n.append(jnp.where(valid, rotate_vectors(T, n), 0.0))
    return out_p, out_n


def test_icp_identity():
    """Same frame vs itself -> identity with ~zero residual."""
    T0 = jnp.eye(4)
    cp, cn = frame_maps(T0)
    mp, mn = world_maps(T0, cp, cn)
    res = icp_track(CAM, ICPConfig(iters=(3, 3, 3)), T0, T0, cp, cn, mp, mn)
    assert bool(res.ok)
    np.testing.assert_allclose(np.asarray(res.T_wc), np.eye(4), atol=1e-4)
    assert float(res.residual) < 1e-3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_icp_recovers_small_motion(seed):
    """Two rendered frames with known relative pose -> ICP recovers it."""
    rng = np.random.default_rng(seed)
    xi = np.concatenate(
        [np.deg2rad(1.5) * rng.normal(size=3), 0.01 * rng.normal(size=3)]
    ).astype(np.float32)
    T0 = jnp.eye(4)
    T1 = se3_exp(jnp.asarray(xi))  # ground-truth pose of frame 1

    # Model = frame 0 maps in world space (model pose = T0).
    p0, n0 = frame_maps(T0)
    mp, mn = world_maps(T0, p0, n0)
    # Current = frame 1 camera-space maps.
    p1, n1 = frame_maps(T1)

    res = icp_track(
        CAM, ICPConfig(iters=(10, 5, 4)), T0, T0, p1, n1, mp, mn
    )
    assert bool(res.ok)
    err_xi = np.asarray(se3_log(se3_inverse(res.T_wc) @ T1))
    assert np.linalg.norm(err_xi[3:]) < 2e-3, f"trans err {err_xi}"
    assert np.linalg.norm(err_xi[:3]) < 2e-3, f"rot err {err_xi}"


def test_icp_fails_on_empty_model():
    T0 = jnp.eye(4)
    cp, cn = frame_maps(T0)
    zp = [jnp.zeros_like(p) for p in cp]
    zn = [jnp.zeros_like(n) for n in cn]
    res = icp_track(CAM, ICPConfig(iters=(2, 2, 2)), T0, T0, cp, cn, zp, zn)
    assert not bool(res.ok)
    # Pose must be untouched on failure.
    np.testing.assert_allclose(np.asarray(res.T_wc), np.eye(4), atol=1e-6)


def test_normal_equations_structure():
    """G must be symmetric PSD with count>0 on a valid pair."""
    T0 = jnp.eye(4)
    cp, cn = frame_maps(T0)
    mp, mn = world_maps(T0, cp, cn)
    G, count = build_normal_equations(
        CAM.at_level(0), T0, T0, cp[0], cn[0], mp[0], mn[0], 0.1, 0.866
    )
    G = np.asarray(G)
    assert int(count) > 1000
    np.testing.assert_allclose(G, G.T, atol=1e-3)
    eigs = np.linalg.eigvalsh(G[:6, :6])
    assert eigs.min() > -1e-3
