"""SE(3) / SO(3) Lie-group utilities, pure jnp, jit/vmap/grad-safe.

The reference has no Lie algebra — its ICP composes incremental rigid
transforms built directly from the solved 6-vector as
``Translation * RotZ * RotY * RotX`` on the host with OpenCV
(reference: tfusion/src/projective_icp.cpp:205-209).  A proper exp map is
numerically cleaner, differentiates, and stays in-graph; for the small
angles ICP produces the two agree to first order.

Conventions:
  * Poses are 4x4 float matrices, row-vector-free: ``p_out = T @ [p; 1]``.
  * Twists are 6-vectors ``[omega(3), v(3)]`` (rotation first).
  * All formulas use Taylor fallbacks near theta=0 so they are safe under
    ``jax.grad`` at the identity.
  * Every float32 product states ``HIGHEST`` precision: on a GPU a float32
    dot may otherwise run in TF32 (about 3 significant digits), which is
    far too coarse for pose composition.  None of these products is large
    enough for the faster mode to matter.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import lax

HIGHEST = lax.Precision.HIGHEST

_EPS = 1e-8
# Switch to Taylor series below this theta^2: in float32, 1-cos(theta)
# cancels catastrophically for theta < ~1e-2, so the cutoff must be well
# above machine-eps scales (series error at theta=0.03 is ~1e-9).
_SMALL_THETA2 = 1e-3


def mat_mul(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """``a @ b`` at full float32 precision (batched like ``jnp.matmul``)."""
    return jnp.matmul(a, b, precision=HIGHEST)


def mat_vec(M: jnp.ndarray, x: jnp.ndarray) -> jnp.ndarray:
    """``M (...,i,j) x (...,j) -> (...,i)`` at full float32 precision."""
    return jnp.einsum("...ij,...j->...i", M, x, precision=HIGHEST)


def _hat(w: jnp.ndarray) -> jnp.ndarray:
    """3-vector -> skew-symmetric matrix, batched over leading dims."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = jnp.zeros_like(wx)
    return jnp.stack(
        [
            jnp.stack([zeros, -wz, wy], axis=-1),
            jnp.stack([wz, zeros, -wx], axis=-1),
            jnp.stack([-wy, wx, zeros], axis=-1),
        ],
        axis=-2,
    )


def so3_exp(omega: jnp.ndarray) -> jnp.ndarray:
    """Rodrigues formula with Taylor guard: omega (...,3) -> R (...,3,3)."""
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)[..., None]
    small = theta2 < _SMALL_THETA2
    # Double-where guard: the untaken branch must not divide by ~0, or
    # jax.grad propagates NaN through jnp.where.
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    # (1-cos t)/t^2 via half-angle: 0.5*(sin(t/2)/(t/2))^2 — stable in f32.
    sinc_half = jnp.sin(theta * 0.5) / (theta * 0.5)
    b = jnp.where(small, 0.5 - theta2 / 24.0, 0.5 * sinc_half * sinc_half)
    K = _hat(omega)
    eye = jnp.eye(3, dtype=omega.dtype)
    return eye + a * K + b * mat_mul(K, K)


def so3_log(R: jnp.ndarray) -> jnp.ndarray:
    """R (...,3,3) -> omega (...,3). Valid for theta < pi.

    Uses atan2(sin, cos) rather than arccos(trace): arccos has an
    unbounded derivative at the identity, which poisons Gauss-Newton
    Jacobians of near-zero residual edges (pose-graph optimization
    differentiates through this).
    """
    trace = jnp.trace(R, axis1=-2, axis2=-1)
    w = jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )  # = 2 sin(theta) * axis
    s2 = 0.25 * jnp.sum(w * w, axis=-1)[..., None]      # sin^2(theta)
    c = jnp.clip((trace[..., None] - 1.0) * 0.5, -1.0, 1.0)  # cos(theta)
    small = s2 < _SMALL_THETA2
    s_safe = jnp.sqrt(jnp.where(small, 1.0, s2))
    theta = jnp.arctan2(s_safe, c)
    # theta / (2 sin theta); series in sin^2 near 0: 1/2 + s2/12.
    factor = jnp.where(small, 0.5 + s2 / 12.0, theta / (2.0 * s_safe))
    return factor * w


def se3_exp(xi: jnp.ndarray) -> jnp.ndarray:
    """Twist [omega, v] (...,6) -> T (...,4,4)."""
    omega, v = xi[..., :3], xi[..., 3:]
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)[..., None]
    small = theta2 < _SMALL_THETA2
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    sinc_half = jnp.sin(theta * 0.5) / (theta * 0.5)
    b = jnp.where(small, 0.5 - theta2 / 24.0, 0.5 * sinc_half * sinc_half)
    # V = I + b K + c K^2 with c = (1 - a)/theta^2, series 1/6 - theta^2/120
    c = jnp.where(small, 1.0 / 6.0 - theta2 / 120.0, (1.0 - a) / theta2_safe)
    K = _hat(omega)
    eye = jnp.eye(3, dtype=xi.dtype)
    R = eye + a * K + b * mat_mul(K, K)
    V = eye + b * K + c * mat_mul(K, K)
    t = mat_vec(V, v)
    top = jnp.concatenate([R, t[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=xi.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def se3_log(T: jnp.ndarray) -> jnp.ndarray:
    """T (...,4,4) -> twist [omega, v] (...,6)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    theta2 = jnp.sum(omega * omega, axis=-1, keepdims=True)[..., None]
    small = theta2 < _SMALL_THETA2
    theta2_safe = jnp.where(small, 1.0, theta2)
    theta = jnp.sqrt(theta2_safe)
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    sinc_half = jnp.sin(theta * 0.5) / (theta * 0.5)
    b = jnp.where(small, 0.5, 0.5 * sinc_half * sinc_half)
    K = _hat(omega)
    eye = jnp.eye(3, dtype=T.dtype)
    # V^{-1} = I - K/2 + (1/theta^2)(1 - a/(2b)) K^2
    coef = jnp.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - a / (2.0 * b)) / theta2_safe,
    )
    Vinv = eye - 0.5 * K + coef * mat_mul(K, K)
    v = mat_vec(Vinv, t)
    return jnp.concatenate([omega, v], axis=-1)


def se3_inverse(T: jnp.ndarray) -> jnp.ndarray:
    """Closed-form rigid inverse (avoids the reference's generic 4x4
    cofactor inverse, reference: tfusion/include/Matrix.hpp:173-230)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = jnp.swapaxes(R, -1, -2)
    t_inv = -mat_vec(Rt, t)
    top = jnp.concatenate([Rt, t_inv[..., None]], axis=-1)
    bottom = jnp.broadcast_to(
        jnp.array([0.0, 0.0, 0.0, 1.0], dtype=T.dtype), top.shape[:-2] + (1, 4)
    )
    return jnp.concatenate([top, bottom], axis=-2)


def transform_points(T: jnp.ndarray, points: jnp.ndarray) -> jnp.ndarray:
    """Apply 4x4 T to points (...,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    return mat_vec(R, points) + jnp.broadcast_to(t, points.shape)


def rotate_vectors(T: jnp.ndarray, vectors: jnp.ndarray) -> jnp.ndarray:
    """Apply only the rotation of T to direction vectors (...,3)."""
    return mat_vec(T[..., :3, :3], vectors)
