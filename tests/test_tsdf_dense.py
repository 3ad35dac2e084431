"""Dense TSDF integrate/raycast unit tests (SURVEY.md section 4a:
fusion-rule semantics from SceneReconstructionEngine.hpp:23-71, castRay on
synthetic SDFs)."""

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import (
    CameraConfig,
    DenseVolumeConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.io.synthetic import SyntheticScene
from topfusion.ops.tsdf_dense import (
    DenseVolume,
    make_dense_volume,
    integrate_dense,
    raycast_dense,
    _sample_trilinear,
)

CAM = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
TSDF = TSDFConfig(voxel_size=0.01, trunc_dist=0.04)
DENSE = DenseVolumeConfig(dims=(96, 96, 96), origin=(-0.48, -0.48, 0.4))
RAY = RaycastConfig(max_steps=160)


def test_integrate_wall_sdf_profile():
    """Integrating a flat wall at z=1 must leave a signed-distance ramp
    along z: +1 in front (free), through 0 at the wall, clamped behind."""
    vol = make_dense_volume(DENSE)
    depth = jnp.full(CAM.shape, 1.0, jnp.float32)
    vol = integrate_dense(vol, CAM, TSDF, DENSE, jnp.eye(4), depth)
    t = np.asarray(vol.tsdf)
    w = np.asarray(vol.weight)

    # Voxel column through the image centre: x=y=0 -> ix=iy=48.
    zs = DENSE.origin[2] + (np.arange(96) + 0.5) * TSDF.voxel_size
    col_t = t[48, 48, :]
    col_w = w[48, 48, :]
    eta = 1.0 - zs
    expect = np.clip(np.minimum(1.0, eta / TSDF.trunc_dist), -1.0, 1.0)
    updated = eta >= -TSDF.trunc_dist
    np.testing.assert_allclose(col_t[updated], expect[updated], atol=0.02)
    # Behind the truncation band: untouched (init value 1, weight 0).
    assert np.all(col_t[~updated] == 1.0)
    assert np.all(col_w[~updated] == 0.0)
    assert np.all(col_w[updated] == 1.0)


def test_integrate_weight_average_and_clamp():
    cfg = TSDFConfig(voxel_size=0.01, trunc_dist=0.04, max_weight=3.0)
    vol = make_dense_volume(DENSE)
    d1 = jnp.full(CAM.shape, 1.0, jnp.float32)
    d2 = jnp.full(CAM.shape, 1.02, jnp.float32)
    vol = integrate_dense(vol, CAM, cfg, DENSE, jnp.eye(4), d1)
    t1 = np.asarray(vol.tsdf[48, 48, :]).copy()
    vol = integrate_dense(vol, CAM, cfg, DENSE, jnp.eye(4), d2)
    # weights: second obs averaged 50/50 where both updated
    zs = DENSE.origin[2] + (np.arange(96) + 0.5) * cfg.voxel_size
    eta1, eta2 = 1.0 - zs, 1.02 - zs
    both = (eta1 >= -cfg.trunc_dist) & (eta2 >= -cfg.trunc_dist)
    f1 = np.clip(np.minimum(1.0, eta1 / cfg.trunc_dist), -1, 1)
    f2 = np.clip(np.minimum(1.0, eta2 / cfg.trunc_dist), -1, 1)
    got = np.asarray(vol.tsdf[48, 48, :])
    np.testing.assert_allclose(got[both], (f1[both] + f2[both]) / 2, atol=0.02)
    # weight clamp
    for _ in range(5):
        vol = integrate_dense(vol, CAM, cfg, DENSE, jnp.eye(4), d1)
    assert np.asarray(vol.weight).max() <= cfg.max_weight + 1e-6


def test_integrate_respects_invalid_depth():
    vol = make_dense_volume(DENSE)
    depth = jnp.zeros(CAM.shape, jnp.float32)
    vol2 = integrate_dense(vol, CAM, TSDF, DENSE, jnp.eye(4), depth)
    assert np.all(np.asarray(vol2.weight) == 0.0)
    assert np.all(np.asarray(vol2.tsdf) == 1.0)


def test_raycast_recovers_wall_depth():
    vol = make_dense_volume(DENSE)
    depth = jnp.full(CAM.shape, 1.0, jnp.float32)
    vol = integrate_dense(vol, CAM, TSDF, DENSE, jnp.eye(4), depth)
    rc = raycast_dense(vol, CAM, TSDF, DENSE, RAY, jnp.eye(4))
    hit = np.asarray(rc.hit)
    d = np.asarray(rc.depth)
    # Central region must hit near z=1 (borders may exit the volume).
    c = hit[16:48, 20:60]
    assert c.mean() > 0.98
    np.testing.assert_allclose(d[16:48, 20:60][c], 1.0, atol=0.01)
    # Normals point back toward the camera (-z).
    n = np.asarray(rc.normals)[16:48, 20:60][c]
    np.testing.assert_allclose(n[:, 2], -1.0, atol=0.05)


def test_raycast_miss_outside_geometry():
    vol = make_dense_volume(DENSE)  # empty volume
    rc = raycast_dense(vol, CAM, TSDF, DENSE, RAY, jnp.eye(4))
    assert not bool(np.asarray(rc.hit).any())
    assert np.all(np.asarray(rc.points) == 0.0)


def test_raycast_synthetic_scene_roundtrip():
    """Integrate exact rendered depth of the analytic scene, raycast it
    back, compare to the exact depth."""
    scene = SyntheticScene()
    dense = DenseVolumeConfig(dims=(128, 128, 128), origin=(-0.64, -0.64, 0.3))
    tsdf = TSDFConfig(voxel_size=0.01, trunc_dist=0.04, view_frustum_max=2.0)
    T = jnp.eye(4)
    depth_gt = scene.render_depth(CAM, T)
    vol = make_dense_volume(dense)
    for _ in range(3):
        vol = integrate_dense(vol, CAM, tsdf, dense, T, depth_gt)
    rc = raycast_dense(vol, CAM, tsdf, dense, RAY, T)
    hit = np.asarray(rc.hit)
    gt = np.asarray(depth_gt)
    # The back wall at z=1.6 lies outside this test volume (z <= 1.58);
    # evaluate only geometry the volume actually contains.
    in_vol = (gt > 0) & (gt < 1.5)
    assert hit[in_vol].mean() > 0.9, f"coverage {hit[in_vol].mean()}"
    mask = hit & in_vol
    err = np.abs(np.asarray(rc.depth)[mask] - gt[mask])
    assert np.median(err) < 0.01, f"median depth err {np.median(err)}"


def test_trilinear_interpolation_linear_field():
    """Trilinear sampling of a linear field must be exact."""
    d0 = 16
    ix = np.arange(d0)
    f = (ix[:, None, None] * 0.1 + ix[None, :, None] * 0.05
         + ix[None, None, :] * 0.02).astype(np.float32)
    vol = DenseVolume(tsdf=jnp.asarray(f), weight=jnp.ones((d0, d0, d0)))
    pts = jnp.asarray([[3.7, 5.2, 8.9], [1.1, 2.9, 3.3]], jnp.float32)
    got, _ = _sample_trilinear(vol, pts, (d0, d0, d0))
    want = (pts[:, 0] - 0.5) * 0.1 + (pts[:, 1] - 0.5) * 0.05 + (pts[:, 2] - 0.5) * 0.02
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=1e-5)
