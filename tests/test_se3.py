import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.geometry import (
    se3_exp,
    se3_log,
    so3_exp,
    so3_log,
    se3_inverse,
    transform_points,
)


def random_twists(n, scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(0, scale, size=(n, 6)), jnp.float32)


def test_so3_exp_orthonormal():
    w = random_twists(32)[:, :3]
    R = so3_exp(w)
    eye = jnp.broadcast_to(jnp.eye(3), R.shape)
    np.testing.assert_allclose(R @ jnp.swapaxes(R, -1, -2), eye, atol=1e-5)
    np.testing.assert_allclose(np.linalg.det(np.asarray(R)), 1.0, atol=1e-5)


def test_so3_log_roundtrip():
    w = random_twists(32, scale=0.8)[:, :3]
    np.testing.assert_allclose(so3_log(so3_exp(w)), w, atol=1e-5)


def test_se3_log_roundtrip():
    xi = random_twists(32, scale=0.5)
    np.testing.assert_allclose(se3_log(se3_exp(xi)), xi, atol=1e-4)


def test_se3_exp_identity_and_small():
    T = se3_exp(jnp.zeros(6))
    np.testing.assert_allclose(T, jnp.eye(4), atol=1e-7)
    # Tiny twist: exp(xi) ~ I + hat(xi)
    xi = jnp.asarray([1e-5, -2e-5, 1e-5, 3e-5, 0.0, -1e-5], jnp.float32)
    T = se3_exp(xi)
    np.testing.assert_allclose(T[:3, 3], xi[3:], atol=1e-9)


def test_se3_exp_pure_translation():
    xi = jnp.asarray([0.0, 0.0, 0.0, 0.1, -0.2, 0.3], jnp.float32)
    T = se3_exp(xi)
    np.testing.assert_allclose(T[:3, :3], jnp.eye(3), atol=1e-7)
    np.testing.assert_allclose(T[:3, 3], xi[3:], atol=1e-7)


def test_se3_inverse():
    xi = random_twists(16, scale=0.7)
    T = se3_exp(xi)
    prod = T @ se3_inverse(T)
    np.testing.assert_allclose(prod, jnp.broadcast_to(jnp.eye(4), prod.shape), atol=1e-5)


def test_transform_points_matches_matmul():
    xi = random_twists(1, scale=0.5)[0]
    T = se3_exp(xi)
    pts = jnp.asarray(np.random.default_rng(1).normal(size=(10, 3)), jnp.float32)
    got = transform_points(T, pts)
    hom = jnp.concatenate([pts, jnp.ones((10, 1))], axis=-1)
    want = (T @ hom.T).T[:, :3]
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_se3_exp_grad_at_identity():
    # Differentiating through exp at 0 must not produce NaNs (Taylor guard).
    g = jax.grad(lambda xi: jnp.sum(se3_exp(xi)))(jnp.zeros(6))
    assert np.all(np.isfinite(np.asarray(g)))
