"""Vertex / normal map computation and pyramid resizing.

Re-designs ``points_normals_kernel`` and ``resize_points_normals_kernel``
(reference: tfusion/src/cuda/imgproc.cu:214-254, 355-401) as whole-image
tensor expressions.  Invalid entries are exact zeros (validity ==
``|v| > 0``), not qnan — see ops/depth.py module doc.
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp

from topfusion.config import CameraConfig
from topfusion.geometry.camera import backproject_grid
from topfusion.ops.depth import _shifted, _fence


def compute_points_normals(
    cam: CameraConfig, depth: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Depth [H, W] meters -> (points [H, W, 3], normals [H, W, 3]),
    camera space.

    Normal at (y, x) = normalize(cross(v(y, x+1) - v, v(y+1, x) - v))
    oriented toward the camera, valid iff all three depths valid
    (reference: imgproc.cu:229-242 hardcodes a negation — equivalent for
    the usual fy > 0, but the ICL-NUIM raw convention has fy < 0, which
    flips the image-space "down" direction in camera space; the explicit
    toward-origin orientation handles both, tests/test_negative_fy.py).
    """
    pts = backproject_grid(cam, depth)
    v00 = pts
    v01 = _shifted(pts, 0, 1)
    v10 = _shifted(pts, 1, 0)
    valid = (depth > 0.0) & (_shifted(depth, 0, 1) > 0.0) & (_shifted(depth, 1, 0) > 0.0)

    n = jnp.cross(v01 - v00, v10 - v00)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    valid = valid & (norm[..., 0] > 1e-12)
    # Orient toward the camera (points are in camera space; a visible
    # surface faces the origin).
    flip = jnp.sum(n * v00, axis=-1) > 0.0
    n = jnp.where(flip[..., None], -n, n)

    points = jnp.where(valid[..., None], v00, 0.0)
    normals = jnp.where(valid[..., None], n, 0.0)
    return points, normals


def normals_from_point_map(
    points: jnp.ndarray, view_pos: jnp.ndarray
) -> jnp.ndarray:
    """Normals from image-space finite differences of an arbitrary
    (e.g. world-space raycast) point map [H, W, 3], oriented toward
    ``view_pos``.

    This mirrors how the reference derives ICP-map normals — from the
    raycast POINT image, not the SDF gradient
    (reference: tfusion/include/tfusion/cuda/VisualisationEngine_Shared.hpp:205-270
    computeNormalAndAngle image variant): projective-TSDF gradients are
    badly skewed on grazing surfaces, while the raycast points themselves
    stay accurate.
    """
    valid0 = jnp.any(points != 0.0, axis=-1)
    v01 = _shifted(points, 0, 1)
    v10 = _shifted(points, 1, 0)
    valid = valid0 & (_shifted(valid0, 0, 1)) & (_shifted(valid0, 1, 0))
    n = jnp.cross(v01 - points, v10 - points)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(norm, 1e-12)
    valid = valid & (norm[..., 0] > 1e-12)
    # Orient toward the viewer.
    flip = jnp.sum(n * (points - view_pos), axis=-1) > 0.0
    n = jnp.where(flip[..., None], -n, n)
    return jnp.where(valid[..., None], n, 0.0)


def resize_points_normals(
    points: jnp.ndarray, normals: jnp.ndarray
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """2x downsample of point+normal maps: average each valid 2x2 quad
    (reference: imgproc.cu:355-401 — all four samples must be valid)."""
    h, w = points.shape[:2]
    h2, w2 = h // 2, w // 2

    def quads(img):
        q = img[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2, 3)
        return q.transpose(0, 2, 1, 3, 4).reshape(h2, w2, 4, 3)

    pq = quads(points)
    nq = quads(normals)
    valid = jnp.all(jnp.any(pq != 0.0, axis=-1), axis=-1)  # all 4 non-zero pts

    p = jnp.mean(pq, axis=2)
    n = jnp.mean(nq, axis=2)
    nnorm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    n = n / jnp.maximum(nnorm, 1e-12)

    p = jnp.where(valid[..., None], p, 0.0)
    n = jnp.where(valid[..., None], n, 0.0)
    return p, n


def build_maps_pyramid(
    cam: CameraConfig, depth_pyr: List[jnp.ndarray]
) -> Tuple[List[jnp.ndarray], List[jnp.ndarray]]:
    """Per-level vertex+normal maps from a depth pyramid
    (reference: topfu.cpp:196-197)."""
    points_pyr, normals_pyr = [], []
    for level, depth in enumerate(depth_pyr):
        p, n = _fence(compute_points_normals(cam.at_level(level), depth))
        points_pyr.append(p)
        normals_pyr.append(n)
    return points_pyr, normals_pyr
