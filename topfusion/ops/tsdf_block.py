"""Block-sparse TSDF: on-demand allocation, visible-set maintenance,
gather/fuse/scatter integration, block-skipping raycast.

Re-designs the InfiniTAM-side engines
(reference: tfusion/src/cuda/SceneReconstructionEngine_host.cu,
tfusion/src/cuda/VisualisationEngine_CUDA.cu) on top of the bucketed
block map in ops/blockmap.py.  The fusion rule and gating semantics are
identical to the dense path (ops/tsdf_dense.py); only the indexing
differs:

  * allocation: per-pixel DDA over the depth+-mu segment emits candidate
    block coords (reference: SceneReconstructionEngine.hpp:206-298),
    deduped + inserted deterministically (no atomics, SURVEY.md 7.1);
  * integration: visible blocks are compacted into a [V, B, B, B] gather,
    fused in one vectorized pass, scattered back — the gather/fuse/scatter
    pattern replacing one-CUDA-block-per-visible-block
    (reference: SceneReconstructionEngine_host.cu:297-329);
  * raycast: lockstep sphere march that skips a whole block width through
    unallocated space (reference: castRay's SDF_BLOCK_SIZE skip,
    VisualisationEngine_Shared.hpp:134-153).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from topfusion.config import (
    BlockMapConfig,
    CameraConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.geometry.se3 import HIGHEST, se3_inverse, transform_points
from topfusion.geometry.camera import project, pixel_grid
from topfusion.ops.blockmap import (
    BlockMap,
    allocate,
    decode_tsdf,
    decode_weight,
    encode_tsdf,
    encode_weight,
    lookup,
    read_voxels_nearest,
    sample_trilinear,
)
from topfusion.ops.tsdf_dense import RaycastResult


# ----------------------------------------------------------------- alloc
def allocate_from_depth(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: jnp.ndarray,
    depth: jnp.ndarray,
    shard=None,
    return_touched: bool = False,
    row_shard: str | None = None,
) -> Tuple[BlockMap, jnp.ndarray]:
    """Mark-and-insert blocks intersecting the depth+-mu band.

    Vectorized DDA (reference: buildHashAllocAndVisibleTypePP,
    SceneReconstructionEngine.hpp:206-298): for each (strided) valid
    pixel, sample ``alloc_steps`` points along the camera ray between
    ``(1 - mu/|p|)`` and ``(1 + mu/|p|)`` of the backprojected point and
    emit their block coords as allocation candidates.

    ``row_shard`` (an axis name, under shard_map) shards the CANDIDATE
    GENERATION: each device runs the DDA over its 1/ns strip of pixel
    rows and the per-device candidate lists are ``all_gather``-ed before
    the (replicated, deterministic) insert — the ~2 ms projection math
    stops being an Amdahl term while every device still sees the full
    candidate set it needs for hash-ownership filtering (round-2 VERDICT
    weak #8).  Gather volume = one device's candidate list, ~77 KB at
    VGA/stride 4 — noise on ICI.
    """
    stride = bm_cfg.alloc_pixel_stride
    k = bm_cfg.alloc_steps
    mu = tsdf_cfg.trunc_dist
    bsz = bm_cfg.block_size
    block_metric = bsz * tsdf_cfg.voxel_size

    if stride > 1:
        # Parity-reshape decimation instead of a strided slice (see
        # ops/depth.py).
        h0, w0 = depth.shape
        hs, ws = h0 // stride, w0 // stride
        d = depth[: hs * stride, : ws * stride].reshape(
            hs, stride, ws, stride
        )[:, 0, :, 0]
    else:
        d = depth
    uv = pixel_grid(cam)[::stride, ::stride]
    if row_shard is not None:
        sid = lax.axis_index(row_shard)
        ns = lax.axis_size(row_shard)
        hl = d.shape[0] // ns
        d = lax.dynamic_slice_in_dim(d, sid * hl, hl, axis=0)
        uv = lax.dynamic_slice_in_dim(uv, sid * hl, hl, axis=0)
    valid = (d > 0.0) & (d >= tsdf_cfg.view_frustum_min) & (d <= tsdf_cfg.view_frustum_max)

    # Camera-space point and ray extent.
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    ray = jnp.stack([x, y, jnp.ones_like(x)], axis=-1)
    norm = jnp.linalg.norm(ray, axis=-1)
    # Fractions along the ray covering depth +- mu (euclidean).
    lam0 = d * (1.0 - mu / jnp.maximum(d * norm, 1e-6))
    lam1 = d * (1.0 + mu / jnp.maximum(d * norm, 1e-6))

    fracs = jnp.linspace(0.0, 1.0, k, dtype=depth.dtype)
    lam = lam0[..., None] + (lam1 - lam0)[..., None] * fracs  # [h, w, k]
    pts_cam = ray[..., None, :] * lam[..., None]              # [h, w, k, 3]
    pts_w = transform_points(T_wc, pts_cam)
    coords = jnp.floor(pts_w / block_metric).astype(jnp.int32)

    cand = coords.reshape(-1, 3)
    cand_valid = jnp.broadcast_to(valid[..., None], lam.shape).reshape(-1)
    if row_shard is not None:
        # Reassemble the full candidate set on every device (the insert
        # itself is replicated + ownership-filtered and must see all
        # candidates).  tiled=True concatenates along dim 0.
        cand = lax.all_gather(cand, row_shard, tiled=True)
        cand_valid = lax.all_gather(cand_valid, row_shard, tiled=True)
    return allocate(
        m, cand, cand_valid, bm_cfg, shard=shard,
        return_touched=return_touched,
    )


# ----------------------------------------------------------------- visibility
def _block_frustum_mask(
    coords: jnp.ndarray,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: jnp.ndarray,
) -> jnp.ndarray:
    """Conservative block-bounding-sphere frustum test over block coords
    [..., 3] (replacing the 8-corner test,
    reference: checkBlockVisibility SceneReconstructionEngine.hpp:325-375)."""
    block_metric = bm_cfg.block_size * tsdf_cfg.voxel_size
    radius = 0.5 * jnp.sqrt(3.0) * block_metric
    centers_w = (coords.astype(jnp.float32) + 0.5) * block_metric
    T_cw = se3_inverse(T_wc)
    centers_cam = transform_points(T_cw, centers_w)
    uv, z = project(cam, centers_cam)
    # Projected radius margin in pixels (guard small z).
    zs = jnp.maximum(z, tsdf_cfg.view_frustum_min * 0.5)
    # |f|: the margin is a pixel radius — sign-free (ICL-NUIM's raw
    # convention has fy < 0; a signed rv would flip the bound sense).
    ru = radius / zs * abs(cam.fx)
    rv = radius / zs * abs(cam.fy)
    return (
        (z > tsdf_cfg.view_frustum_min - radius)
        & (z < tsdf_cfg.view_frustum_max + radius)
        & (uv[..., 0] >= -ru)
        & (uv[..., 0] <= cam.width - 1 + ru)
        & (uv[..., 1] >= -rv)
        & (uv[..., 1] <= cam.height - 1 + rv)
    )


def _block_occlusion_mask(
    coords: jnp.ndarray,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: jnp.ndarray,
    depth: jnp.ndarray,
) -> jnp.ndarray:
    """True = the block is potentially OBSERVABLE from this frame: some
    voxel can satisfy the fusion-rule gate ``eta >= -mu`` against the
    observed depth.  A block whose whole extent lies beyond every valid
    depth sample in its image footprint receives ZERO voxel updates by
    construction of the fusion rule (``eta < -mu`` skips, reference:
    computeUpdatedVoxelDepthInfo SceneReconstructionEngine.hpp:23-71) and
    is occluded for model-map splatting — culling it from the per-frame
    visible set is integrate-exact and splat-conservative.

    The footprint depth bound is a 16x16 MAX-pool of the depth image
    (invalid = 0 excluded) dilated by a 3x3 tile neighborhood — an upper
    bound of any pixel depth a block's voxels can project onto for
    footprints up to ~48 px (a 4 cm block at >= 0.5 m covers < 48 px at
    VGA focal lengths).  This is the expected-depth-range idea
    (reference: CreateExpectedDepths VisualisationEngine_CUDA.cu:119-173)
    applied to visible-set maintenance: the working set shrinks from
    "frustum band" to "observable band", which is what lets the padded
    max_visible_blocks bound drop (every integrate/splat gather/sort/
    scatter scales with the PADDED bound; docs/PERFORMANCE.md round 5).
    """
    t = 16
    h, w = depth.shape
    block_metric = bm_cfg.block_size * tsdf_cfg.voxel_size
    radius = 0.5 * jnp.sqrt(3.0) * block_metric
    centers_w = (coords.astype(jnp.float32) + 0.5) * block_metric
    T_cw = se3_inverse(T_wc)
    centers_cam = transform_points(T_cw, centers_w)
    uv, z = project(cam, centers_cam)

    ht, wt = -(-h // t), -(-w // t)
    d_full = jnp.pad(depth, ((0, ht * t - h), (0, wt * t - w)))
    d_tile = jnp.max(d_full.reshape(ht, t, wt, t), axis=(1, 3))
    # 3x3 tile-neighborhood max (footprint slack), zero-padded: invalid
    # stays 0 and an all-invalid footprint culls (no voxel can update).
    d_pad = jnp.pad(d_tile, 1)
    d_max = d_tile
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            d_max = jnp.maximum(
                d_max, d_pad[1 + dy : 1 + dy + ht, 1 + dx : 1 + dx + wt]
            )

    zs = jnp.maximum(z, tsdf_cfg.view_frustum_min * 0.5)
    ut = jnp.clip(
        (uv[..., 0] / t).astype(jnp.int32), 0, wt - 1
    )
    vt = jnp.clip(
        (uv[..., 1] / t).astype(jnp.int32), 0, ht - 1
    )
    d_near = d_max[vt, ut]
    return z - radius <= d_near + tsdf_cfg.trunc_dist


def visible_blocks(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: jnp.ndarray,
    return_overflow: bool = False,
    depth: jnp.ndarray | None = None,
):
    """Compact the frustum-visible subset of live blocks (FULL scan over
    the pool — O(capacity); the per-frame pipeline uses
    :func:`visible_blocks_incremental` instead and falls back here after
    reset/teleport).

    Replaces the 8-corner test + warp prefix-sum compaction
    (reference: buildVisibleList_device _host.cu:434-479).  Returns
    (slots [V_max], coords [V_max, 3], mask [V_max]); with
    ``return_overflow`` additionally the count of frustum-visible LIVE
    blocks truncated by the ``max_visible_blocks`` bound — the silent
    under-integration signal on over-dense scenes (a truncated block is
    allocated but skipped by integrate/splat this frame).
    """
    v_max = bm_cfg.max_visible_blocks
    live = jnp.arange(m.capacity) < m.num_blocks
    vis = live & _block_frustum_mask(
        m.block_coords, cam, tsdf_cfg, bm_cfg, T_wc
    )
    if depth is not None:
        vis = vis & _block_occlusion_mask(
            m.block_coords, cam, tsdf_cfg, bm_cfg, T_wc, depth
        )

    rank = jnp.cumsum(vis.astype(jnp.int32)) - 1
    keep = vis & (rank < v_max)
    idx = jnp.where(keep, rank, v_max)
    slots = jnp.full((v_max,), -1, jnp.int32).at[idx].set(
        jnp.arange(m.capacity, dtype=jnp.int32), mode="drop"
    )
    mask = slots >= 0
    coords = m.block_coords[jnp.where(mask, slots, 0)]
    if return_overflow:
        overflow = jnp.maximum(jnp.sum(vis.astype(jnp.int32)) - v_max, 0)
        return slots, coords, mask, overflow
    return slots, coords, mask


def visible_blocks_incremental(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: jnp.ndarray,
    prev_slots: jnp.ndarray,     # [V_max] int32, -1 = empty
    touched_slots: jnp.ndarray,  # [t_max] int32, -1 = empty
    return_overflow: bool = False,
    depth: jnp.ndarray | None = None,
):
    """Visible set by AGING: frustum-check only last frame's visible
    blocks plus this frame's allocation-touched blocks, instead of
    projecting every pool slot.

    This is the reference's visible-list maintenance shape
    (setToType3 ages last frame's list, the allocation DDA marks
    found/created entries, buildVisibleList re-checks only those;
    reference: SceneReconstructionEngine_host.cu:343-348, 434-479): a
    block that leaves the frustum is forgotten and re-enters the set only
    when depth observes it again.  Work scales with
    |visible| + |touched|, not pool capacity (round-2 VERDICT missing #5).

    Returns the same (slots, coords, mask) triple as
    :func:`visible_blocks`; under the same v_max cap the sets are
    identical (asserted in tests/test_visible_aging.py).
    """
    v_max = bm_cfg.max_visible_blocks
    cand = jnp.concatenate([prev_slots, touched_slots])          # [V+T]
    imax = jnp.iinfo(jnp.int32).max
    key = jnp.where(cand >= 0, cand, imax)
    s = jnp.sort(key)                                            # dupes adjacent
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    uniq = first & (s != imax) & (s < m.num_blocks)
    coords_u = m.block_coords[jnp.where(uniq, s, 0)]
    vis = uniq & _block_frustum_mask(coords_u, cam, tsdf_cfg, bm_cfg, T_wc)
    if depth is not None:
        vis = vis & _block_occlusion_mask(
            coords_u, cam, tsdf_cfg, bm_cfg, T_wc, depth
        )

    rank = jnp.cumsum(vis.astype(jnp.int32)) - 1
    keep = vis & (rank < v_max)
    idx = jnp.where(keep, rank, v_max)
    slots = jnp.full((v_max,), -1, jnp.int32).at[idx].set(
        jnp.where(keep, s, -1), mode="drop"
    )
    mask = slots >= 0
    coords = m.block_coords[jnp.where(mask, slots, 0)]
    if return_overflow:
        overflow = jnp.maximum(jnp.sum(vis.astype(jnp.int32)) - v_max, 0)
        return slots, coords, mask, overflow
    return slots, coords, mask


# ----------------------------------------------------------------- integrate
def integrate_blocks(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: jnp.ndarray,
    depth: jnp.ndarray,
    vis: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray] | None = None,
) -> Tuple[BlockMap, jnp.ndarray]:
    """Fuse one depth image into the visible blocks.

    Gather visible blocks -> one fused elementwise pass over
    [V, B, B, B] voxels (same rule as computeUpdatedVoxelDepthInfo,
    reference: SceneReconstructionEngine.hpp:23-71) -> scatter back.
    Returns (map, num_visible).
    """
    if vis is None:
        vis = visible_blocks(m, cam, tsdf_cfg, bm_cfg, T_wc)
    slots, coords, mask = vis
    bsz = bm_cfg.block_size
    mu = tsdf_cfg.trunc_dist
    voxel = tsdf_cfg.voxel_size
    h, w = depth.shape

    # Padded vis entries gather (and later scatter back) the sacrificial
    # row, which is semantically dead: every live row outside the
    # visible set stays bit-identical (tests/test_integrate_reference.py).
    safe_slots = jnp.where(mask, slots, m.capacity)
    tsdf_blk = decode_tsdf(m.tsdf[safe_slots])          # [V, B, B, B]
    w_blk = decode_weight(m.weight[safe_slots])

    # World position of every voxel centre in the gathered blocks.
    lx = lax.broadcasted_iota(jnp.float32, (1, bsz, bsz, bsz), 1)
    ly = lax.broadcasted_iota(jnp.float32, (1, bsz, bsz, bsz), 2)
    lz = lax.broadcasted_iota(jnp.float32, (1, bsz, bsz, bsz), 3)
    local = jnp.stack([lx, ly, lz], axis=-1)                      # [1,B,B,B,3]
    base = coords.astype(jnp.float32)[:, None, None, None, :] * bsz
    pw = (base + local + 0.5) * voxel

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
    update = in_bounds & (d > 0.0) & (eta >= -mu) & mask[:, None, None, None]
    if tsdf_cfg.stop_integrating_at_max_weight:
        update = update & (w_blk < tsdf_cfg.max_weight)

    new_f = jnp.maximum(jnp.minimum(1.0, eta / mu), -1.0)
    fused = (tsdf_blk * w_blk + new_f) / (w_blk + 1.0)
    w_new = jnp.minimum(w_blk + 1.0, tsdf_cfg.max_weight)

    tsdf_out = jnp.where(update, fused, tsdf_blk)
    w_out = jnp.where(update, w_new, w_blk)

    scatter_slots = jnp.where(mask, slots, m.capacity)  # pad -> sacrificial row
    m = m._replace(
        tsdf=m.tsdf.at[scatter_slots].set(
            encode_tsdf(tsdf_out, m.tsdf.dtype), mode="drop"
        ),
        weight=m.weight.at[scatter_slots].set(
            encode_weight(w_out, m.weight.dtype), mode="drop"
        ),
    )
    return m, jnp.sum(mask.astype(jnp.int32))


# ----------------------------------------------------------------- color
def integrate_color_blocks(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: jnp.ndarray,
    depth: jnp.ndarray,
    rgb: jnp.ndarray,
    vis: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
) -> BlockMap:
    """Fuse an RGB image into the visible blocks' color pool.

    Running average with the fusion weights; only voxels within mu/4 of
    the observed surface take color (mirrors computeUpdatedVoxelColorInfo's
    tighter band, reference: SceneReconstructionEngine.hpp:116-148 and the
    eta > -mu*0.25 gate at :161-176; same rule as the dense path,
    ops/tsdf_dense.integrate_color_dense).  A separate gather/fuse/scatter
    pass so the depth integrator stays color-agnostic.
    """
    slots, coords, mask = vis
    bsz = bm_cfg.block_size
    mu = tsdf_cfg.trunc_dist
    voxel = tsdf_cfg.voxel_size
    h, w = depth.shape

    safe_slots = jnp.where(mask, slots, 0)
    w_blk = decode_weight(m.weight[safe_slots])
    c_blk = decode_tsdf(m.color[safe_slots])  # [V, B, B, B, 3]

    lx = lax.broadcasted_iota(jnp.float32, (1, bsz, bsz, bsz), 1)
    ly = lax.broadcasted_iota(jnp.float32, (1, bsz, bsz, bsz), 2)
    lz = lax.broadcasted_iota(jnp.float32, (1, bsz, bsz, bsz), 3)
    local = jnp.stack([lx, ly, lz], axis=-1)
    base = coords.astype(jnp.float32)[:, None, None, None, :] * bsz
    pw = (base + local + 0.5) * voxel

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
    update = (
        in_bounds & (d > 0.0) & (jnp.abs(eta) < mu * 0.25)
        & mask[:, None, None, None]
    )
    fused = (c_blk * w_blk[..., None] + c_obs) / (w_blk[..., None] + 1.0)
    c_out = jnp.where(update[..., None], fused, c_blk)

    scatter_slots = jnp.where(mask, slots, m.capacity)
    return m._replace(
        color=m.color.at[scatter_slots].set(
            encode_tsdf(c_out, m.color.dtype), mode="drop"
        )
    )


# ----------------------------------------------------------------- ranges
def expected_depth_ranges(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: jnp.ndarray,
    vis: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    subsample: int = 8,
    chunk: int = 1024,
) -> jnp.ndarray:
    """Per-pixel raycast depth bounds from the visible blocks.

    A re-design of CreateExpectedDepths (reference:
    VisualisationEngine_CUDA.cu:119-173, VisualisationHelper.cu:52-121):
    the reference splits each projected block bbox into 16x16
    RenderingBlocks and rasterizes zmin/zmax with float atomicMin/Max
    into a 1/8-subsampled minmax image.  Here the minmax image is built
    the gather way: every coarse cell reduces min/max depth over the
    visible blocks whose projected bbox covers it — a fused
    [cells, chunk] masked reduction per block chunk instead of
    data-dependent scatter volumes (scatter-shaped rasterization costs
    ~10 ns/row; the fused compare-reduce streams at vector-unit speed
    and its cost is occupancy-independent).

    Returns ``[ceil(h/sub), ceil(w/sub), 2]`` float32 (zmin, zmax) in
    camera-z meters.  Cells no block projects to carry
    (frustum_max, frustum_min) — an empty band that kills the ray
    immediately in :func:`raycast_blocks`.
    """
    slots, coords, mask = vis
    bsz = bm_cfg.block_size
    block_metric = bsz * tsdf_cfg.voxel_size
    h, w = cam.height, cam.width
    sub = subsample
    ch, cw = -(-h // sub), -(-w // sub)
    V = slots.shape[0]
    fmin, fmax = tsdf_cfg.view_frustum_min, tsdf_cfg.view_frustum_max

    # 8 corners of every visible block, in camera space.
    offs = jnp.asarray(
        [[x, y, z] for x in (0, 1) for y in (0, 1) for z in (0, 1)],
        jnp.float32,
    )  # [8, 3]
    corners_w = (coords.astype(jnp.float32)[:, None, :] + offs) * block_metric
    T_cw = se3_inverse(T_wc)
    pc = transform_points(T_cw, corners_w)                   # [V, 8, 3]
    zc = pc[..., 2]
    # A corner at/behind the image plane makes the projected bbox
    # unbounded; cover the full image for such blocks (conservative,
    # rare: only blocks the camera is inside of).
    near = 0.5 * fmin
    degenerate = jnp.any(zc < near, axis=1)
    uv, _ = project(cam, pc)
    u, v = uv[..., 0], uv[..., 1]
    cu0 = jnp.floor(jnp.min(u, axis=1) / sub).astype(jnp.int32)
    cu1 = jnp.floor(jnp.max(u, axis=1) / sub).astype(jnp.int32)
    cv0 = jnp.floor(jnp.min(v, axis=1) / sub).astype(jnp.int32)
    cv1 = jnp.floor(jnp.max(v, axis=1) / sub).astype(jnp.int32)
    cu0 = jnp.where(degenerate, 0, jnp.clip(cu0, 0, cw - 1))
    cu1 = jnp.where(degenerate, cw - 1, jnp.clip(cu1, 0, cw - 1))
    cv0 = jnp.where(degenerate, 0, jnp.clip(cv0, 0, ch - 1))
    cv1 = jnp.where(degenerate, ch - 1, jnp.clip(cv1, 0, ch - 1))
    bz0 = jnp.maximum(jnp.min(zc, axis=1), fmin)
    bz1 = jnp.minimum(jnp.max(zc, axis=1), fmax)

    ci = lax.broadcasted_iota(jnp.int32, (ch, cw, 1), 0)
    cj = lax.broadcasted_iota(jnp.int32, (ch, cw, 1), 1)

    n_chunks = -(-V // chunk)
    pad = n_chunks * chunk - V
    def pad_to(x, fill):
        return jnp.pad(x, (0, pad), constant_values=fill).reshape(
            n_chunks, chunk
        )
    xs = (
        pad_to(cu0, 0), pad_to(cu1, -1), pad_to(cv0, 0), pad_to(cv1, -1),
        pad_to(bz0, fmax), pad_to(bz1, fmin),
        pad_to(mask, False),
    )

    def body(carry, x):
        zlo, zhi = carry
        u0, u1, v0, v1, z0, z1, mk = x
        cover = (
            (ci >= v0) & (ci <= v1) & (cj >= u0) & (cj <= u1) & mk
        )  # [ch, cw, chunk]
        zlo = jnp.minimum(zlo, jnp.min(jnp.where(cover, z0, fmax), axis=-1))
        zhi = jnp.maximum(zhi, jnp.max(jnp.where(cover, z1, fmin), axis=-1))
        return (zlo, zhi), None

    init = (
        jnp.full((ch, cw), fmax, jnp.float32),
        jnp.full((ch, cw), fmin, jnp.float32),
    )
    (zlo, zhi), _ = lax.scan(body, init, xs)
    return jnp.stack([zlo, zhi], axis=-1)


# ----------------------------------------------------------------- raycast
def raycast_blocks(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    ray_cfg: RaycastConfig,
    T_wc: jnp.ndarray,
    expected_depth: jnp.ndarray | None = None,
    depth_margin: float = 0.16,
    max_steps: int | None = None,
    shard=None,
    weight_gate: str = "trilinear",
    range_image: jnp.ndarray | None = None,
    range_subsample: int | None = None,
) -> RaycastResult:
    """Sphere-trace every pixel through the sparse map.

    Identical lockstep structure to ops/tsdf_dense.raycast_dense, with
    per-step block lookups: a miss advances a full block width
    (reference: VisualisationEngine_Shared.hpp:134-153).

    ``expected_depth`` enables the analogue of the reference's
    expected-depth ranges (reference: CreateExpectedDepths,
    VisualisationEngine_CUDA.cu:119-173): each ray starts at
    ``expected_depth - depth_margin`` and stops at ``+ depth_margin``.
    When raycasting ICP model maps right after integrating a frame at the
    same pose, the just-fused depth image IS the expected depth, so a
    ~16-step band replaces a full 150+-step frustum march.  In lockstep
    XLA every pixel pays the worst-case step count, so the caller should
    pass a small ``max_steps`` with it; pixels without valid expected
    depth fall back to the full range and may not finish (they produce no
    ICP correspondences anyway — gates require current-frame validity).

    ``range_image`` is the free-view analogue: the ``[h/sub, w/sub, 2]``
    (zmin, zmax) minmax image from :func:`expected_depth_ranges`
    (reference: castRay reads the 1/8-subsampled
    renderingRangeImage, VisualisationEngine_Shared.hpp:99-113).  Rays
    start at their cell's zmin and die past zmax, so ``max_steps`` only
    has to cover the occupied band, not the whole frustum.
    """
    h, w = cam.height, cam.width
    mu = tsdf_cfg.trunc_dist
    voxel = tsdf_cfg.voxel_size
    bits = bm_cfg.coord_bits
    block_metric = bm_cfg.block_size * voxel

    uv = pixel_grid(cam)
    dirs_cam = jnp.stack(
        [
            (uv[..., 0] - cam.cx) / cam.fx,
            (uv[..., 1] - cam.cy) / cam.fy,
            jnp.ones((h, w), jnp.float32),
        ],
        axis=-1,
    )
    R = T_wc[:3, :3]
    o_w = T_wc[:3, 3]
    dirs_w = jnp.einsum("ij,hwj->hwi", R, dirs_cam, precision=HIGHEST)
    dir_norm = jnp.linalg.norm(dirs_w, axis=-1)

    t_min = jnp.full((h, w), tsdf_cfg.view_frustum_min, jnp.float32)
    t_max = jnp.full((h, w), tsdf_cfg.view_frustum_max, jnp.float32)
    if range_image is not None:
        sub = range_subsample or ray_cfg.range_subsample
        ch, cw = range_image.shape[:2]
        # Nearest upsample by broadcast-reshape (no strided lane ops).
        full = jnp.broadcast_to(
            range_image[:, None, :, None, :], (ch, sub, cw, sub, 2)
        ).reshape(ch * sub, cw * sub, 2)[:h, :w]
        zlo, zhi = full[..., 0], full[..., 1]
        # One-voxel slack: trilinear refinement may probe just outside
        # the corner-derived bounds.
        t_min = jnp.maximum(t_min, zlo - voxel)
        t_max = jnp.minimum(t_max, zhi + voxel)
        # Empty cells carry zlo > zhi; pin them to an immediately-dead
        # band with finite arithmetic.
        t_min = jnp.minimum(t_min, t_max)
    if expected_depth is not None:
        dvalid = expected_depth > 0.0
        t_min = jnp.where(
            dvalid,
            jnp.maximum(t_min, expected_depth - depth_margin),
            t_min,
        )
        t_max = jnp.where(
            dvalid, jnp.minimum(t_max, expected_depth + depth_margin), t_max
        )
    n_steps = max_steps if max_steps is not None else ray_cfg.max_steps
    min_step = ray_cfg.min_step_voxels * voxel

    def to_voxel(t):
        p_w = o_w + t[..., None] * dirs_w
        return p_w / voxel  # fractional global voxel coords

    def body(_, carry):
        t, prev_sdf, prev_t, t_hit, alive, found = carry
        pv = to_voxel(t)
        vox = jnp.floor(pv).astype(jnp.int32)
        sdf, _wt, blk_found = read_voxels_nearest(m, vox, bits, shard=shard)
        crossing = alive & blk_found & (prev_sdf > 0.0) & (sdf <= 0.0)
        denom = jnp.where(jnp.abs(prev_sdf - sdf) > 1e-12, prev_sdf - sdf, 1.0)
        t_cross = prev_t + (t - prev_t) * (prev_sdf / denom)
        t_hit = jnp.where(crossing & ~found, t_cross, t_hit)
        found = found | crossing
        # Miss -> skip a block width; hit -> sphere step on the sampled sdf.
        step = jnp.where(
            blk_found, jnp.maximum(sdf * mu, min_step), block_metric
        ) / dir_norm
        t_next = t + step
        alive = alive & ~found & (t_next < t_max)
        # prev_sdf only meaningful inside allocated space; entering a block
        # from unallocated space starts a fresh sign history.
        prev_sdf_next = jnp.where(blk_found, sdf, 1.0)
        return t_next, prev_sdf_next, t, t_hit, alive, found

    init = (
        t_min,
        jnp.ones((h, w), jnp.float32),
        t_min,
        jnp.zeros((h, w), jnp.float32),
        jnp.ones((h, w), bool),
        jnp.zeros((h, w), bool),
    )
    _, _, _, t_hit, _, found = lax.fori_loop(0, n_steps, body, init)

    def refine(_, t):
        sdf_tri, _ = sample_trilinear(m, to_voxel(t), bits, shard=shard)
        return t + sdf_tri * mu / dir_norm

    t_hit = lax.fori_loop(0, ray_cfg.refine_steps, refine, t_hit)

    if weight_gate == "nearest":
        # Sharded maps gate on the nearest voxel's weight: the trilinear
        # min-weight stencil straddles block borders, and a remote
        # neighbour block would read weight 0 and spuriously reject the
        # hit (parallel/block_sharded.py composites per-shard results).
        vox_hit = jnp.floor(to_voxel(t_hit)).astype(jnp.int32)
        _, w_hit, _ = read_voxels_nearest(m, vox_hit, bits, shard=shard)
    else:
        _, w_hit = sample_trilinear(m, to_voxel(t_hit), bits, shard=shard)
    hit = found & (w_hit > 0.0) & (t_hit > 0.0)

    p_w = o_w + t_hit[..., None] * dirs_w
    # Fence: t_hit is the product of the whole march; without a barrier
    # XLA may duplicate upstream work into each tap of the normal stencil.
    points = lax.optimization_barrier(jnp.where(hit[..., None], p_w, 0.0))

    from topfusion.ops.normals import normals_from_point_map

    normals = normals_from_point_map(points, o_w)
    depth_out = jnp.where(hit, t_hit, 0.0)
    conf = jnp.where(hit, w_hit, 0.0)
    return RaycastResult(
        points=points, normals=normals, hit=hit, depth=depth_out,
        confidence=conf,
    )
