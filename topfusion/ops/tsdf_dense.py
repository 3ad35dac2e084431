"""Dense fixed-grid TSDF volume: integration + raycast.

This is the BASELINE.md config-1 path (a resurrection of the reference's
legacy dense kinfu volume, reference: tfusion/src/internal.hpp:31-51) and
the numerical model for the block-sparse path in ops/tsdf_block.py:
identical fusion rule and ray marching, minus the sparse indexing.

Fusion rule matches ``computeUpdatedVoxelDepthInfo``
(reference: tfusion/include/tfusion/cuda/SceneReconstructionEngine.hpp:23-71):
  eta = depth(project(voxel)) - voxel_camera_z
  skip when eta < -mu (one-sided truncation)
  newF = clamp(eta / mu, -1, 1) capped at 1      # min(1, eta/mu)
  F <- (F * W + newF) / (W + 1);  W <- min(W + 1, maxW)

Raycast is sphere tracing with step max(sdf * mu, min_step * voxel)
(reference: tfusion/include/tfusion/cuda/VisualisationEngine_Shared.hpp:99-172
castRay), expressed as a fixed-bound ``lax.fori_loop`` over all pixels at
once with per-pixel active masks — XLA vectorizes the whole march; there
is no divergent per-pixel while-loop.

The volume is a pair of arrays ``tsdf [D0, D1, D2]`` (float32 in [-1, 1])
and ``weight [D0, D1, D2]``; the short/uchar packing of the reference's
``Voxel_s`` (reference: tfusion/include/tfusion/cuda/VoxelTypes.hpp:69-92)
is an HBM-size optimization the block map's ``pool_dtype`` provides.
Indexing: tsdf[ix, iy, iz]; world = origin + (idx + 0.5) * voxel_size.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from topfusion.config import (
    CameraConfig,
    DenseVolumeConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.geometry.se3 import HIGHEST, se3_inverse, transform_points
from topfusion.geometry.camera import project, pixel_grid


class DenseVolume(NamedTuple):
    tsdf: jnp.ndarray     # [D0, D1, D2] float32
    weight: jnp.ndarray   # [D0, D1, D2] float32


def make_dense_volume(cfg: DenseVolumeConfig, dtype=jnp.float32) -> DenseVolume:
    dims = cfg.dims
    return DenseVolume(
        tsdf=jnp.ones(dims, dtype),      # SDF_initialValue = free space
        weight=jnp.zeros(dims, dtype),
    )


def integrate_dense(
    vol: DenseVolume,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    dense_cfg: DenseVolumeConfig,
    T_wc: jnp.ndarray,
    depth: jnp.ndarray,
) -> DenseVolume:
    """Fuse one metric depth image into the volume at pose ``T_wc``.

    One fully-fused XLA elementwise pass over all voxels plus a depth
    gather (the reference launches one CUDA block per visible 8^3 block,
    reference: SceneReconstructionEngine_host.cu:226-250; dense XLA needs
    no visibility list).
    """
    d0, d1, d2 = dense_cfg.dims
    h, w = depth.shape
    mu = tsdf_cfg.trunc_dist
    voxel = tsdf_cfg.voxel_size
    origin = jnp.asarray(dense_cfg.origin, vol.tsdf.dtype)

    ix = lax.broadcasted_iota(jnp.float32, (d0, d1, d2), 0)
    iy = lax.broadcasted_iota(jnp.float32, (d0, d1, d2), 1)
    iz = lax.broadcasted_iota(jnp.float32, (d0, d1, d2), 2)
    pw = jnp.stack([ix, iy, iz], axis=-1) * voxel + (origin + 0.5 * voxel)

    T_cw = se3_inverse(T_wc)
    pc = transform_points(T_cw, pw)
    uv, z = project(cam, pc)
    u = jnp.round(uv[..., 0]).astype(jnp.int32)
    v = jnp.round(uv[..., 1]).astype(jnp.int32)
    in_bounds = (
        (u >= 0) & (u < w) & (v >= 0) & (v < h)
        & (z >= tsdf_cfg.view_frustum_min) & (z <= tsdf_cfg.view_frustum_max)
    )
    uc = jnp.clip(u, 0, w - 1)
    vc = jnp.clip(v, 0, h - 1)
    d = depth[vc, uc]

    eta = d - z
    update = in_bounds & (d > 0.0) & (eta >= -mu)
    if tsdf_cfg.stop_integrating_at_max_weight:
        update = update & (vol.weight < tsdf_cfg.max_weight)

    new_f = jnp.minimum(1.0, eta / mu)
    new_f = jnp.maximum(new_f, -1.0)
    w_old = vol.weight
    fused = (vol.tsdf * w_old + new_f) / (w_old + 1.0)
    w_new = jnp.minimum(w_old + 1.0, tsdf_cfg.max_weight)

    return DenseVolume(
        tsdf=jnp.where(update, fused, vol.tsdf),
        weight=jnp.where(update, w_new, vol.weight),
    )


def make_color_volume(cfg: DenseVolumeConfig, use_color: bool, dtype=jnp.float32):
    """RGB color grid [D0, D1, D2, 3] (or a 1-voxel dummy when disabled, so
    pipeline state keeps a stable pytree structure)."""
    dims = cfg.dims if use_color else (1, 1, 1)
    return jnp.zeros(dims + (3,), dtype)


def integrate_color_dense(
    color_vol: jnp.ndarray,
    vol: DenseVolume,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    dense_cfg: DenseVolumeConfig,
    T_wc: jnp.ndarray,
    depth: jnp.ndarray,
    rgb: jnp.ndarray,
) -> jnp.ndarray:
    """Fuse an RGB image into the color grid (running average with the same
    weights as the depth fusion; only voxels within mu/4 of the surface
    take color, mirroring computeUpdatedVoxelColorInfo's tighter band —
    reference: SceneReconstructionEngine.hpp:161-176 eta > -mu*0.25 gate).
    """
    d0, d1, d2 = dense_cfg.dims
    h, w = depth.shape
    mu = tsdf_cfg.trunc_dist
    voxel = tsdf_cfg.voxel_size
    origin = jnp.asarray(dense_cfg.origin, jnp.float32)

    ix = lax.broadcasted_iota(jnp.float32, (d0, d1, d2), 0)
    iy = lax.broadcasted_iota(jnp.float32, (d0, d1, d2), 1)
    iz = lax.broadcasted_iota(jnp.float32, (d0, d1, d2), 2)
    pw = jnp.stack([ix, iy, iz], axis=-1) * voxel + (origin + 0.5 * voxel)
    T_cw = se3_inverse(T_wc)
    pc = transform_points(T_cw, pw)
    uv, z = project(cam, pc)
    u = jnp.round(uv[..., 0]).astype(jnp.int32)
    v = jnp.round(uv[..., 1]).astype(jnp.int32)
    in_bounds = (
        (u >= 0) & (u < w) & (v >= 0) & (v < h)
        & (z >= tsdf_cfg.view_frustum_min) & (z <= tsdf_cfg.view_frustum_max)
    )
    uc = jnp.clip(u, 0, w - 1)
    vc = jnp.clip(v, 0, h - 1)
    d = depth[vc, uc]
    c_obs = rgb[vc, uc].astype(jnp.float32)
    if rgb.dtype == jnp.uint8:
        c_obs = c_obs / 255.0

    eta = d - z
    update = in_bounds & (d > 0.0) & (jnp.abs(eta) < mu * 0.25)
    w_old = vol.weight
    fused = (color_vol * w_old[..., None] + c_obs) / (w_old[..., None] + 1.0)
    return jnp.where(update[..., None], fused, color_vol)


def sample_color_dense(
    color_vol: jnp.ndarray, pv: jnp.ndarray, dims: Tuple[int, int, int]
) -> jnp.ndarray:
    """Nearest-voxel color at fractional voxel coords (..., 3)."""
    idx = jnp.floor(pv).astype(jnp.int32)
    inb = jnp.all((idx >= 0) & (idx < jnp.asarray(dims)), axis=-1)
    ic = jnp.clip(idx, 0, jnp.asarray(dims) - 1)
    c = color_vol[ic[..., 0], ic[..., 1], ic[..., 2]]
    return jnp.where(inb[..., None], c, 0.0)


def _sample_nearest(
    vol: DenseVolume, pv: jnp.ndarray, dims: Tuple[int, int, int]
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Nearest-voxel (tsdf, weight) at fractional voxel coords pv (..., 3).

    Out-of-volume samples read as free space (tsdf=1, w=0).
    """
    idx = jnp.floor(pv).astype(jnp.int32)
    inb = jnp.all((idx >= 0) & (idx < jnp.asarray(dims)), axis=-1)
    ic = jnp.clip(idx, 0, jnp.asarray(dims) - 1)
    t = vol.tsdf[ic[..., 0], ic[..., 1], ic[..., 2]]
    wt = vol.weight[ic[..., 0], ic[..., 1], ic[..., 2]]
    return jnp.where(inb, t, 1.0), jnp.where(inb, wt, 0.0)


def _sample_trilinear(
    vol: DenseVolume, pv: jnp.ndarray, dims: Tuple[int, int, int]
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Trilinear (tsdf, min-corner-weight) at voxel-centre coords pv
    (reference: RepresentationAccess.hpp:137-162 readFromSDF_float_interpolated).
    """
    p = pv - 0.5  # voxel-centre grid
    base = jnp.floor(p).astype(jnp.int32)
    frac = p - base
    tsdf = jnp.zeros(pv.shape[:-1], vol.tsdf.dtype)
    wmin = jnp.full(pv.shape[:-1], jnp.inf, vol.weight.dtype)
    dims_a = jnp.asarray(dims)
    for cx in (0, 1):
        for cy in (0, 1):
            for cz in (0, 1):
                corner = base + jnp.asarray([cx, cy, cz])
                inb = jnp.all((corner >= 0) & (corner < dims_a), axis=-1)
                cc = jnp.clip(corner, 0, dims_a - 1)
                t = vol.tsdf[cc[..., 0], cc[..., 1], cc[..., 2]]
                wt = vol.weight[cc[..., 0], cc[..., 1], cc[..., 2]]
                t = jnp.where(inb, t, 1.0)
                wt = jnp.where(inb, wt, 0.0)
                wgt = (
                    (frac[..., 0] if cx else 1.0 - frac[..., 0])
                    * (frac[..., 1] if cy else 1.0 - frac[..., 1])
                    * (frac[..., 2] if cz else 1.0 - frac[..., 2])
                )
                tsdf = tsdf + wgt * t
                wmin = jnp.minimum(wmin, wt)
    return tsdf, wmin


def sdf_normals(
    vol: DenseVolume, pv: jnp.ndarray, dims: Tuple[int, int, int]
) -> jnp.ndarray:
    """World-space surface normal from SDF central differences at voxel
    coords pv (reference: RepresentationAccess.hpp:340-453
    computeSingleNormalFromSDF, simplified to +-0.5-voxel trilinear taps)."""
    def tap(offset):
        t, _ = _sample_trilinear(vol, pv + jnp.asarray(offset, pv.dtype), dims)
        return t

    gx = tap([0.5, 0.0, 0.0]) - tap([-0.5, 0.0, 0.0])
    gy = tap([0.0, 0.5, 0.0]) - tap([0.0, -0.5, 0.0])
    gz = tap([0.0, 0.0, 0.5]) - tap([0.0, 0.0, -0.5])
    n = jnp.stack([gx, gy, gz], axis=-1)
    norm = jnp.linalg.norm(n, axis=-1, keepdims=True)
    return n / jnp.maximum(norm, 1e-12)


class RaycastResult(NamedTuple):
    points: jnp.ndarray    # [H, W, 3] world-space hit points (0 = miss)
    normals: jnp.ndarray   # [H, W, 3] world-space normals (0 = miss)
    hit: jnp.ndarray       # [H, W] bool
    depth: jnp.ndarray     # [H, W] ray depth along camera z (0 = miss)
    # Fusion weight at the hit — the reference's confidence channel
    # (raycastResult w = confidence + 1, reference:
    # VisualisationEngine_Shared.hpp:355-397 processPixelICP).
    confidence: jnp.ndarray = None


def raycast_dense(
    vol: DenseVolume,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    dense_cfg: DenseVolumeConfig,
    ray_cfg: RaycastConfig,
    T_wc: jnp.ndarray,
    expected_depth: jnp.ndarray | None = None,
    depth_margin: float = 0.16,
    max_steps: int | None = None,
) -> RaycastResult:
    """Sphere-trace every pixel through the volume from pose ``T_wc``.

    All pixels march in lockstep inside one ``lax.fori_loop`` (bounded by
    ``ray_cfg.max_steps``); finished rays are masked out.  Marching
    samples are nearest-voxel; the zero crossing is then refined with
    trilinear reads (reference castRay does the same switch inside the
    truncation band, VisualisationEngine_Shared.hpp:134-166).
    """
    dims = dense_cfg.dims
    h, w = cam.height, cam.width
    mu = tsdf_cfg.trunc_dist
    voxel = tsdf_cfg.voxel_size
    origin = jnp.asarray(dense_cfg.origin, jnp.float32)

    # Ray setup: origin + unit direction in world space.
    uv = pixel_grid(cam)
    dirs_cam = jnp.stack(
        [
            (uv[..., 0] - cam.cx) / cam.fx,
            (uv[..., 1] - cam.cy) / cam.fy,
            jnp.ones((h, w), jnp.float32),
        ],
        axis=-1,
    )
    # Scale so that stepping t along the ray equals camera-z depth t.
    R = T_wc[:3, :3]
    o_w = T_wc[:3, 3]
    dirs_w = jnp.einsum("ij,hwj->hwi", R, dirs_cam, precision=HIGHEST)

    # AABB entry/exit in camera-z-depth units (dirs_w has z-depth scaling).
    vol_min = origin
    vol_max = origin + jnp.asarray(dims, jnp.float32) * voxel
    safe_d = jnp.where(jnp.abs(dirs_w) > 1e-12, dirs_w, 1e-12)
    t0 = (vol_min - o_w) / safe_d
    t1 = (vol_max - o_w) / safe_d
    t_near = jnp.max(jnp.minimum(t0, t1), axis=-1)
    t_far = jnp.min(jnp.maximum(t0, t1), axis=-1)
    t_min = jnp.maximum(t_near, tsdf_cfg.view_frustum_min)
    t_max = jnp.minimum(t_far, tsdf_cfg.view_frustum_max)
    if expected_depth is not None:
        # Depth-guided band (see ops/tsdf_block.raycast_blocks docstring).
        dvalid = expected_depth > 0.0
        t_min = jnp.where(
            dvalid, jnp.maximum(t_min, expected_depth - depth_margin), t_min
        )
        t_max = jnp.where(
            dvalid, jnp.minimum(t_max, expected_depth + depth_margin), t_max
        )
    n_steps = max_steps if max_steps is not None else ray_cfg.max_steps
    alive0 = t_min < t_max

    min_step = ray_cfg.min_step_voxels * voxel
    # t advances in camera-z units while the SDF gives euclidean metric
    # distance; dividing steps by |dir| keeps sphere tracing conservative
    # at the image periphery.
    dir_norm = jnp.linalg.norm(dirs_w, axis=-1)

    def to_voxel(t):
        p_w = o_w + t[..., None] * dirs_w
        return (p_w - origin) / voxel  # fractional voxel coords

    def body(_, carry):
        t, prev_sdf, prev_t, t_hit, alive, found = carry
        sdf, _ = _sample_nearest(vol, to_voxel(t), dims)
        sdf_m = sdf * mu
        crossing = alive & (prev_sdf > 0.0) & (sdf <= 0.0)
        # Linear interpolation of the zero crossing between samples.
        denom = jnp.where(
            jnp.abs(prev_sdf - sdf) > 1e-12, prev_sdf - sdf, 1.0
        )
        t_cross = prev_t + (t - prev_t) * (prev_sdf / denom)
        t_hit = jnp.where(crossing & ~found, t_cross, t_hit)
        found = found | crossing
        step = jnp.maximum(sdf_m, min_step) / dir_norm
        t_next = t + step
        alive = alive & ~found & (t_next < t_max)
        return t_next, sdf, t, t_hit, alive, found

    zeros = jnp.zeros((h, w), jnp.float32)
    init = (
        t_min,
        jnp.ones((h, w), jnp.float32),
        t_min,
        zeros,
        alive0,
        jnp.zeros((h, w), bool),
    )
    _, _, _, t_hit, _, found = lax.fori_loop(0, n_steps, body, init)

    # Refinement: a few trilinear Newton steps around the crossing
    # (reference: VisualisationEngine_Shared.hpp:155-166).
    def refine(_, t):
        sdf_tri, _ = _sample_trilinear(vol, to_voxel(t), dims)
        return t + sdf_tri * mu / dir_norm

    t_hit = lax.fori_loop(0, ray_cfg.refine_steps, refine, t_hit)

    # Require real data at the hit (weight > 0 on the trilinear support).
    _, w_hit = _sample_trilinear(vol, to_voxel(t_hit), dims)
    hit = found & (w_hit > 0.0) & (t_hit > 0.0)

    p_w = o_w + t_hit[..., None] * dirs_w
    # Fence: keeps XLA from duplicating the march into the normal stencil.
    points = lax.optimization_barrier(jnp.where(hit[..., None], p_w, 0.0))

    # Normals from image-space differences of the point map (reference:
    # VisualisationEngine_Shared.hpp:205-270) — projective-TSDF gradients
    # are unreliable on grazing surfaces; the hit points are not.
    from topfusion.ops.normals import normals_from_point_map

    normals = normals_from_point_map(points, o_w)
    depth = jnp.where(hit, t_hit, 0.0)
    conf = jnp.where(hit, w_hit, 0.0)
    return RaycastResult(
        points=points, normals=normals, hit=hit, depth=depth, confidence=conf
    )
