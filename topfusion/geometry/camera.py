"""Pinhole camera projection / backprojection.

Mirrors the reference's ``Intr`` conventions
(reference: tfusion/include/tfusion/types.hpp:20-27; per-level scaling at
tfusion/src/precomp.cpp:10-14) but as pure functions over a
``CameraConfig`` closed over statically at trace time.
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
from jax import lax

from topfusion.config import CameraConfig


def intrinsics_matrix(cam: CameraConfig, dtype=jnp.float32) -> jnp.ndarray:
    return jnp.array(
        [[cam.fx, 0.0, cam.cx], [0.0, cam.fy, cam.cy], [0.0, 0.0, 1.0]],
        dtype=dtype,
    )


def project(cam: CameraConfig, points: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Camera-space points (...,3) -> pixel coords (...,2) [u, v] and depth z.

    No validity handling here — callers gate on z > 0 and bounds.
    """
    z = points[..., 2]
    safe_z = jnp.where(jnp.abs(z) > 1e-12, z, 1e-12)
    u = points[..., 0] / safe_z * cam.fx + cam.cx
    v = points[..., 1] / safe_z * cam.fy + cam.cy
    return jnp.stack([u, v], axis=-1), z


def backproject(cam: CameraConfig, uv: jnp.ndarray, depth: jnp.ndarray) -> jnp.ndarray:
    """Pixel coords (...,2) + depth (...) -> camera-space points (...,3)."""
    x = (uv[..., 0] - cam.cx) / cam.fx * depth
    y = (uv[..., 1] - cam.cy) / cam.fy * depth
    return jnp.stack([x, y, depth], axis=-1)


def pixel_grid(cam: CameraConfig, dtype=jnp.float32) -> jnp.ndarray:
    """[H, W, 2] grid of (u, v) pixel-centre coordinates."""
    u = lax.broadcasted_iota(dtype, (cam.height, cam.width), 1)
    v = lax.broadcasted_iota(dtype, (cam.height, cam.width), 0)
    return jnp.stack([u, v], axis=-1)


def backproject_grid(cam: CameraConfig, depth: jnp.ndarray) -> jnp.ndarray:
    """Depth image [H, W] (meters; 0 = invalid) -> vertex map [H, W, 3].

    Invalid depths produce the zero point, matching the 'invalid vertex'
    convention used throughout (the reference uses qnan,
    reference: tfusion/src/cuda/imgproc.cu:227-233; zeros are friendlier to
    masked arithmetic — validity == (z > 0)).
    """
    uv = pixel_grid(cam, dtype=depth.dtype)
    pts = backproject(cam, uv, depth)
    valid = depth > 0.0
    return jnp.where(valid[..., None], pts, 0.0)
