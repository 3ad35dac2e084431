"""Depth-image preprocessing ops.

A re-design of the reference's depth frontend
(reference: tfusion/src/cuda/imgproc.cu:10-140, 263-290).  Each op is a
whole-image tensor expression: stencils are expressed as a static unrolled
sum of shifted images which XLA fuses into a single vectorized loop — no
per-pixel kernels, no scalar control flow.

Unit conventions (differ from the reference on purpose):
  * depth images are float32 METERS everywhere past the sensor boundary;
    ``0.0`` means invalid.  The reference mixes u16 millimeters and float
    meters per-stage (mm->m conversions at imgproc.cu:53, 133, 164).
  * invalid pixels/vertices/normals are exact zeros, not qnan
    (reference: imgproc.cu:157, 222) — zeros compose with masked
    arithmetic without NaN-propagation hazards under XLA fast-math.

Deliberate semantic deviations from the reference (quality fixes, flagged
for parity review):
  * bilateral / pyramid exclude INVALID neighbours from the support
    instead of letting zero-depths drag edge values toward the camera
    (reference includes them: imgproc.cu:31-45, 116-125);
    output validity still equals input validity.
"""

from __future__ import annotations

from typing import List, Tuple

import jax.numpy as jnp
from jax import lax

from topfusion.config import PreprocConfig

# Stage-boundary fences: XLA's fusion pass freely DUPLICATES a producer
# into every consumer it fuses with.  For chained stencils (bilateral ->
# pyramid -> vertex/normal maps) that turns an O(taps) pipeline into
# O(taps^depth) recomputation (measured 300x slower at VGA).  An
# optimization_barrier at each stage boundary forces the intermediate to
# materialize once.
_fence = lax.optimization_barrier


def depth_to_meters(
    depth_mm: jnp.ndarray, max_sensor_depth: float = 2.046
) -> jnp.ndarray:
    """u16/int millimeter depth -> float32 meters; invalid -> 0.

    Mirrors ``compute_dists`` validity (0 or >= 2047 mm invalid,
    reference: imgproc.cu:277) but returns 0 for invalid instead of -1 —
    all downstream gates are ``depth > 0``.
    """
    d = depth_mm.astype(jnp.float32) * 0.001
    valid = (d > 0.0) & (d < max_sensor_depth)
    return jnp.where(valid, d, 0.0)


def _shifted(img: jnp.ndarray, dy: int, dx: int, fill: float = 0.0) -> jnp.ndarray:
    """Image shifted so that out[y, x] = img[y+dy, x+dx]; out-of-bounds = fill.

    Static shifts compile to XLA pad+slice, which fuses into the consuming
    elementwise expression.
    """
    h, w = img.shape[:2]
    pad_width = [(max(-dy, 0), max(dy, 0)), (max(-dx, 0), max(dx, 0))]
    pad_width += [(0, 0)] * (img.ndim - 2)
    padded = jnp.pad(img, pad_width, constant_values=fill)
    return padded[max(dy, 0) : max(dy, 0) + h, max(dx, 0) : max(dx, 0) + w]


def _pos_mask(h: int, w: int, dy: int, dx: int) -> jnp.ndarray:
    """Mask of centre pixels whose (dy, dx) neighbour lies at a position
    the REFERENCE window includes: in-bounds AND not the last row/column
    (its clamped loop bound ``cy < min(y - k/2 + k, rows - 1)`` excludes
    index rows-1 as a neighbour everywhere, reference: imgproc.cu:25-33,
    111-121)."""
    ys = lax.broadcasted_iota(jnp.int32, (h, w), 0)
    xs = lax.broadcasted_iota(jnp.int32, (h, w), 1)
    return (
        (ys + dy >= 0) & (ys + dy <= h - 2)
        & (xs + dx >= 0) & (xs + dx <= w - 2)
    )


def bilateral_filter(
    depth: jnp.ndarray,
    kernel_size: int = 7,
    sigma_spatial: float = 4.5,
    sigma_depth: float = 0.04,
    reference_semantics: bool = False,
) -> jnp.ndarray:
    """Edge-preserving bilateral filter on a metric depth image [H, W].

    Same weighting as the reference (exp(-(dx^2+dy^2)/2*sigma_s^2
    - dd^2/2*sigma_d^2), reference: imgproc.cu:37-43) with sigma_depth in
    meters; invalid (0) pixels stay invalid and are excluded from every
    neighbourhood.

    ``reference_semantics=True`` reproduces the reference's support
    exactly for the parity A/B (scripts/parity_ab.py): invalid (zero)
    neighbours participate with their zero value (dragging edge pixels
    toward the camera, reference: imgproc.cu:28-45 — no validity test),
    and the window is positional (in-bounds, last row/column excluded)
    rather than validity-based.  Output validity stays equal to input
    validity in both modes (the reference re-masks invalid depth
    downstream in its vertex-map stage).
    """
    inv2_s = 0.5 / (sigma_spatial * sigma_spatial)
    inv2_d = 0.5 / (sigma_depth * sigma_depth)
    r = kernel_size // 2
    h, w = depth.shape
    valid = depth > 0.0

    wsum = jnp.zeros_like(depth)
    vsum = jnp.zeros_like(depth)
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            nb = _shifted(depth, dy, dx)
            if reference_semantics:
                nb_ok = _pos_mask(h, w, dy, dx)
            else:
                nb_ok = nb > 0.0
            diff = depth - nb
            weight = jnp.exp(
                -((dy * dy + dx * dx) * inv2_s + diff * diff * inv2_d)
            )
            weight = jnp.where(nb_ok, weight, 0.0)
            wsum = wsum + weight
            vsum = vsum + weight * nb
    out = vsum / jnp.maximum(wsum, 1e-12)
    return jnp.where(valid, out, 0.0)


def truncate_depth(depth: jnp.ndarray, max_dist: float) -> jnp.ndarray:
    """Zero out depths beyond ``max_dist`` meters
    (reference: imgproc.cu:70-89)."""
    return jnp.where(depth > max_dist, 0.0, depth)


def downsample_depth(
    depth: jnp.ndarray,
    sigma_depth: float = 0.04,
    reference_semantics: bool = False,
) -> jnp.ndarray:
    """2x depth downsample with discontinuity rejection.

    dst[y, x] = mean of the 5x5 neighbourhood of src[2y, 2x] restricted to
    valid samples within 3*sigma_depth of the centre
    (reference: imgproc.cu:98-140; centre validity added — see module doc).
    ``reference_semantics=True`` drops the validity tests and uses the
    reference's positional window instead (invalid zeros within 3 sigma of
    an invalid centre average to 0, matching pyramid_kernel exactly).

    Layout note: a stride-2 slice per tap was far slower than a static
    shift on the accelerator this was first tuned on (not yet re-measured
    on the GPU).  The source is split
    into its four parity planes ONCE (one reshape), after which every tap
    ``src[2y+dy, 2x+dx]`` is a cheap static shift of one half-res plane:
    ``dy = 2a + b`` -> plane row-parity ``b`` shifted by ``a``.
    """
    h, w = depth.shape
    h2, w2 = h // 2, w // 2
    # [h2, 2, w2, 2] parity view; planes[b_y][b_x][y, x] = src[2y+b_y, 2x+b_x].
    par = depth[: h2 * 2, : w2 * 2].reshape(h2, 2, w2, 2)
    planes = [[par[:, by, :, bx] for bx in (0, 1)] for by in (0, 1)]
    center = planes[0][0]
    thresh = 3.0 * sigma_depth

    ssum = jnp.zeros_like(center)
    scount = jnp.zeros_like(center)
    for dy in range(-2, 3):
        ay, by = dy >> 1, dy & 1
        for dx in range(-2, 3):
            ax, bx = dx >> 1, dx & 1
            nb = _shifted(planes[by][bx], ay, ax)
            ok = jnp.abs(nb - center) < thresh
            if reference_semantics:
                # Positional window on the FULL-RES source grid (the
                # reference clamps there, imgproc.cu:111-121): centre
                # (2y, 2x), neighbour (2y+dy, 2x+dx).
                ys = lax.broadcasted_iota(jnp.int32, center.shape, 0) * 2
                xs = lax.broadcasted_iota(jnp.int32, center.shape, 1) * 2
                ok = ok & (
                    (ys + dy >= 0) & (ys + dy <= h - 2)
                    & (xs + dx >= 0) & (xs + dx <= w - 2)
                )
            else:
                ok = ok & (nb > 0.0)
            ssum = ssum + jnp.where(ok, nb, 0.0)
            scount = scount + ok.astype(depth.dtype)
    out = ssum / jnp.maximum(scount, 1.0)
    if reference_semantics:
        return jnp.where(scount > 0.0, out, 0.0)
    return jnp.where((center > 0.0) & (scount > 0.0), out, 0.0)


def build_depth_pyramid(
    depth: jnp.ndarray, cfg: PreprocConfig
) -> List[jnp.ndarray]:
    """Level-0 filtered depth -> list of ``cfg.pyramid_levels`` depth images
    (reference: topfu.cpp:193-194 calls depthBuildPyramid per level)."""
    pyr = [depth]
    for _ in range(cfg.pyramid_levels - 1):
        pyr.append(
            _fence(
                downsample_depth(
                    pyr[-1],
                    cfg.pyramid_sigma_depth,
                    reference_semantics=cfg.reference_edge_semantics,
                )
            )
        )
    return pyr


def preprocess_depth(
    depth_mm: jnp.ndarray, cfg: PreprocConfig
) -> Tuple[jnp.ndarray, List[jnp.ndarray]]:
    """Full depth frontend: sensor units -> (integration depth, pyramid).

    Matches the per-frame order of TopFu::operator()
    (reference: topfu.cpp:166-194): the integration depth ("dists") comes
    from the RAW depth, while the ICP pyramid is bilateral-filtered then
    truncated.
    """
    raw_m = depth_to_meters(depth_mm, cfg.max_sensor_depth)
    filtered = bilateral_filter(
        raw_m,
        cfg.bilateral_kernel_size,
        cfg.bilateral_sigma_spatial,
        cfg.bilateral_sigma_depth,
        reference_semantics=cfg.reference_edge_semantics,
    )
    filtered = _fence(truncate_depth(filtered, cfg.depth_truncation))
    return raw_m, build_depth_pyramid(filtered, cfg)
