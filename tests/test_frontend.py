"""Golden tests of the image frontend vs straightforward NumPy references
(SURVEY.md section 4a: pure-function unit tests of each kernel)."""

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import CameraConfig, PreprocConfig
from topfusion.geometry.camera import backproject_grid
from topfusion.ops.depth import (
    depth_to_meters,
    bilateral_filter,
    truncate_depth,
    downsample_depth,
)
from topfusion.ops.normals import compute_points_normals, resize_points_normals

CAM = CameraConfig(width=32, height=24, fx=30.0, fy=30.0, cx=16.0, cy=12.0)


def make_depth(h=24, w=32, seed=0):
    rng = np.random.default_rng(seed)
    d = 1.0 + 0.05 * rng.normal(size=(h, w))
    d[2:5, 3:8] = 0.0  # invalid patch
    return d.astype(np.float32)


# ---------------------------------------------------------------- depth ops
def test_depth_to_meters():
    mm = np.array([[0, 500, 2046, 2047, 3000]], np.uint16)
    m = np.asarray(depth_to_meters(jnp.asarray(mm)))
    np.testing.assert_allclose(m, [[0.0, 0.5, 0.0, 0.0, 0.0]], atol=1e-6)
    mm2 = np.array([[1000, 2000]], np.uint16)
    np.testing.assert_allclose(
        np.asarray(depth_to_meters(jnp.asarray(mm2))), [[1.0, 2.0]], atol=1e-6
    )


def test_truncate_depth():
    d = jnp.asarray([[0.5, 1.9, 2.1, 0.0]], jnp.float32)
    np.testing.assert_allclose(
        np.asarray(truncate_depth(d, 2.0)), [[0.5, 1.9, 0.0, 0.0]]
    )


def numpy_bilateral(depth, ksz, ss, sd):
    h, w = depth.shape
    out = np.zeros_like(depth)
    r = ksz // 2
    for y in range(h):
        for x in range(w):
            if depth[y, x] <= 0:
                continue
            wsum = vsum = 0.0
            for dy in range(-r, r + 1):
                for dx in range(-r, r + 1):
                    yy, xx = y + dy, x + dx
                    if not (0 <= yy < h and 0 <= xx < w):
                        continue
                    nb = depth[yy, xx]
                    if nb <= 0:
                        continue
                    wgt = np.exp(
                        -((dy * dy + dx * dx) * 0.5 / ss**2
                          + (depth[y, x] - nb) ** 2 * 0.5 / sd**2)
                    )
                    wsum += wgt
                    vsum += wgt * nb
            out[y, x] = vsum / max(wsum, 1e-12)
    return out


def test_bilateral_matches_numpy():
    d = make_depth()
    got = np.asarray(bilateral_filter(jnp.asarray(d), 5, 2.0, 0.04))
    want = numpy_bilateral(d, 5, 2.0, 0.04)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_bilateral_preserves_validity():
    d = make_depth()
    out = np.asarray(bilateral_filter(jnp.asarray(d)))
    assert np.all((out > 0) == (d > 0))


def test_bilateral_smooths_noise_keeps_edges():
    d = np.full((16, 16), 1.0, np.float32)
    d[:, 8:] = 2.0  # step edge
    rng = np.random.default_rng(0)
    noisy = d + 0.005 * rng.normal(size=d.shape).astype(np.float32)
    out = np.asarray(bilateral_filter(jnp.asarray(noisy)))
    # noise reduced on flats
    assert np.std(out[4:12, 2:6] - 1.0) < np.std(noisy[4:12, 2:6] - 1.0)
    # edge preserved
    assert abs(out[8, 7] - 1.0) < 0.05 and abs(out[8, 8] - 2.0) < 0.05


def numpy_downsample(depth, sigma):
    h, w = depth.shape
    h2, w2 = h // 2, w // 2
    out = np.zeros((h2, w2), np.float32)
    for y in range(h2):
        for x in range(w2):
            c = depth[2 * y, 2 * x]
            if c <= 0:
                continue
            vals = []
            for dy in range(-2, 3):
                for dx in range(-2, 3):
                    yy, xx = 2 * y + dy, 2 * x + dx
                    if 0 <= yy < h and 0 <= xx < w:
                        v = depth[yy, xx]
                        if v > 0 and abs(v - c) < 3 * sigma:
                            vals.append(v)
            if vals:
                out[y, x] = np.mean(vals)
    return out


def test_downsample_matches_numpy():
    d = make_depth()
    got = np.asarray(downsample_depth(jnp.asarray(d), 0.04))
    want = numpy_downsample(d, 0.04)
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_downsample_rejects_discontinuity():
    d = np.full((8, 8), 1.0, np.float32)
    d[:, 4:] = 2.0
    out = np.asarray(downsample_depth(jnp.asarray(d), 0.04))
    # Values must stay on one side of the edge, never blend to ~1.5.
    assert np.all((np.abs(out - 1.0) < 0.01) | (np.abs(out - 2.0) < 0.01))


# ---------------------------------------------------------------- normals
def test_points_normals_flat_wall():
    # Constant-depth wall -> normals exactly (0, 0, -1) toward camera.
    d = jnp.full((24, 32), 1.5, jnp.float32)
    pts, nrm = compute_points_normals(CAM, d)
    pts, nrm = np.asarray(pts), np.asarray(nrm)
    assert np.allclose(pts[5, 7, 2], 1.5, atol=1e-6)
    valid = np.any(pts != 0, axis=-1)
    assert valid[:-1, :-1].all()
    # last row/col has no forward neighbours -> invalid
    assert not valid[-1].any() and not valid[:, -1].any()
    np.testing.assert_allclose(
        nrm[valid], np.broadcast_to([0.0, 0.0, -1.0], nrm[valid].shape), atol=1e-5
    )


def test_points_normals_backprojection():
    d = make_depth()
    pts, _ = compute_points_normals(CAM, jnp.asarray(d))
    want = np.asarray(backproject_grid(CAM, jnp.asarray(d)))
    got = np.asarray(pts)
    valid = np.any(got != 0, axis=-1)
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-6)


def test_points_normals_invalid_propagation():
    d = make_depth()
    pts, nrm = compute_points_normals(CAM, jnp.asarray(d))
    pts = np.asarray(pts)
    # invalid depth -> invalid vertex
    assert np.all(pts[2:5, 3:8] == 0)


def test_resize_points_normals():
    d = jnp.full((24, 32), 1.0, jnp.float32)
    pts, nrm = compute_points_normals(CAM, d)
    p2, n2 = resize_points_normals(pts, nrm)
    p2, n2 = np.asarray(p2), np.asarray(n2)
    assert p2.shape == (12, 16, 3)
    valid = np.any(p2 != 0, axis=-1)
    assert valid[:-1, :-1].all()
    np.testing.assert_allclose(p2[valid][:, 2], 1.0, atol=1e-6)
    np.testing.assert_allclose(
        n2[valid], np.broadcast_to([0.0, 0.0, -1.0], n2[valid].shape), atol=1e-5
    )
