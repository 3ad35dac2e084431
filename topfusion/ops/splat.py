"""Forward-projection model-map generation (surfel splatting).

The reference carries a dormant forward-projection path
(reference: tfusion/src/cuda/VisualisationHelper.cu:123-170
forwardProject_device, commented host side at
VisualisationEngine_CUDA.cu:362-414).  Here it becomes the PRIMARY way to
produce ICP model maps, because it inverts the memory-access pattern:
instead of every ray GATHERING hundreds of voxels, the surface voxels
SCATTER themselves into the image.

Pipeline:

  1. visible blocks -> per-voxel surface test (|tsdf|*mu < voxel, w > 0);
  2. per-block top-K compaction: one BATCHED sort of packed
     (non_surface | voxel_idx) keys along the 512-voxel axis — no global
     scatter-compaction (a 2M-row scatter costs ~20 ms; this costs ~2 ms);
  3. selected voxels project onto the zero level set along the local SDF
     gradient (intra-block central differences), then into pixels;
     z-buffering via ONE single-tap scatter-min of packed (depth | id)
     keys;
  4. hole closing in IMAGE space: a 3x3 min-stencil dilation of the packed
     z-buffer (equivalent to a radius-1 splat footprint at stencil cost,
     instead of 4x the scatter volume);
  5. winner attributes gathered back; confidence = the winner's fusion
     weight (matching processPixelICP's confidence channel, reference:
     VisualisationEngine_Shared.hpp:355-397); normals from image-space
     differences of the resulting point map (shared with raycast).

The marching raycast (ops/tsdf_block.raycast_blocks) remains for display
rendering and as the semantic reference in tests.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax

from topfusion.config import BlockMapConfig, CameraConfig, TSDFConfig
from topfusion.geometry.se3 import se3_inverse, transform_points
from topfusion.geometry.camera import project
from topfusion.ops.blockmap import BlockMap, decode_tsdf, decode_weight
from topfusion.ops.tsdf_dense import RaycastResult
from topfusion.ops.normals import normals_from_point_map

_MAX_DEPTH_BITS = 12   # z quantization of the packed z-buffer key
_MIN_DEPTH_BITS = 6    # floor; at 6 bits z-fighting ties resolve by id


def _min_dilate(img: jnp.ndarray, fill: int) -> jnp.ndarray:
    """3x3 min-stencil that only fills `fill` (hole) pixels.

    SEPARABLE form: row-min then column-min of the 3-window (4 shifted
    minimums instead of 8).  Exactly equivalent to the 8-neighbor
    variant on the pixels it writes: holes carry the `fill` sentinel
    (the dtype max of the packed keys), so including the center in the
    full 3x3 window changes nothing for them, and non-hole pixels keep
    their original value via the final select."""
    h, w = img.shape

    def axis_min3(a, axis):
        n = a.shape[axis]
        lo = jnp.concatenate(
            [lax.slice_in_dim(a, 0, 1, axis=axis),
             lax.slice_in_dim(a, 0, n - 1, axis=axis)], axis=axis,
        )
        hi = jnp.concatenate(
            [lax.slice_in_dim(a, 1, n, axis=axis),
             lax.slice_in_dim(a, n - 1, n, axis=axis)], axis=axis,
        )
        return jnp.minimum(a, jnp.minimum(lo, hi))

    out = axis_min3(axis_min3(img, 1), 0)
    return jnp.where(img != fill, img, out)


def splat_model_maps(
    m: BlockMap,
    cam: CameraConfig,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    T_wc: jnp.ndarray,
    vis: Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray],
    surfels_per_block: int = 128,
    dilate_passes: int = 1,
    axis_name: str | None = None,
    num_shards: int = 1,
) -> RaycastResult:
    """Render point/normal maps from the visible blocks by splatting.

    ``vis`` is the (slots, coords, mask) triple from
    ops/tsdf_block.visible_blocks (shared with integration).
    ``surfels_per_block`` caps surface voxels taken per 8^3 block (a plane
    crossing a block touches ~128 voxels at the default truncation band);
    ``dilate_passes`` 3x3 min-dilations close sub-pixel splat holes.

    With ``axis_name``/``num_shards`` set (inside a shard_map over a
    sharded block map, parallel/block_sharded.py), every device splats
    its OWN blocks into a local z-buffer and the per-pixel winner is
    composited across shards: one ``pmin`` of the packed keys (surfel
    ids are made globally unique by interleaving the shard id), then one
    masked ``psum`` of the winner attributes — sort-last compositing
    instead of ghost-block halo exchange.
    """
    slots, coords, mask = vis
    bsz = bm_cfg.block_size
    voxel = tsdf_cfg.voxel_size
    mu = tsdf_cfg.trunc_dist
    h, w = cam.height, cam.width
    V = slots.shape[0]
    nvox = bsz * bsz * bsz
    K = min(surfels_per_block, nvox)
    id_bits = max(1, (V * K * num_shards - 1).bit_length())
    # Depth quantization gets whatever the 31-bit key has left (ties
    # between equally-near surfels break deterministically by id).
    depth_bits = min(_MAX_DEPTH_BITS, 31 - id_bits)
    assert depth_bits >= _MIN_DEPTH_BITS, (
        f"surfel id needs {id_bits} bits; shrink max_visible_blocks or "
        f"surfels_per_block"
    )

    safe_slots = jnp.where(mask, slots, 0)
    raw_blocks = (m.tsdf[safe_slots], m.weight[safe_slots])
    # Fence the pool gathers: six roll taps consume tsdf_blk below, and
    # XLA would otherwise duplicate the gather into each tap.
    tsdf_blk, w_blk = lax.optimization_barrier(
        (
            decode_tsdf(raw_blocks[0].reshape(V, bsz, bsz, bsz)),
            decode_weight(raw_blocks[1].reshape(V, bsz, bsz, bsz)),
        )
    )  # [V, B, B, B]

    # --- surface voxels + gradient: intra-block central differences,
    # EDGE-CLAMPED to one-sided differences at block faces (a wrapped
    # roll would project ~49% of voxels — the border shell of an 8^3
    # block — along a gradient computed from the opposite face; measured
    # 5x ATE degradation vs reference raycast maps at 160x120 before
    # this fix).  Only the projection DIRECTION uses the gradient, so the
    # one-sided magnitude at faces is irrelevant after normalization;
    # image-space normals are refined later from the point map.
    def diff(axis):
        n = tsdf_blk.shape[axis]
        fwd = jnp.concatenate(
            [
                lax.slice_in_dim(tsdf_blk, 1, n, axis=axis),
                lax.slice_in_dim(tsdf_blk, n - 1, n, axis=axis),
            ],
            axis=axis,
        )
        bwd = jnp.concatenate(
            [
                lax.slice_in_dim(tsdf_blk, 0, 1, axis=axis),
                lax.slice_in_dim(tsdf_blk, 0, n - 1, axis=axis),
            ],
            axis=axis,
        )
        return (fwd - bwd) * 0.5

    g = jnp.stack([diff(1), diff(2), diff(3)], axis=-1)   # [V,B,B,B,3]
    gn2 = jnp.sum(g * g, axis=-1)
    surface = (
        (jnp.abs(tsdf_blk) * mu < voxel)
        & (w_blk > 0.0)
        & (gn2 > 1e-12)
        & mask[:, None, None, None]
    )

    # --- per-block top-K surface voxels: batched sort of packed keys
    # (non_surface flag in the high bit -> surface voxels sort first; the
    # voxel index rides in the low bits so no argsort payload is needed).
    surf_flat = surface.reshape(V, nvox)
    vox_iota = lax.broadcasted_iota(jnp.int32, (V, nvox), 1)
    keys = jnp.where(surf_flat, vox_iota, vox_iota + nvox)
    topk = jnp.sort(keys, axis=1)[:, :K]                  # [V, K]
    sel_valid = topk < nvox                                # surface & selected
    sel = jnp.where(sel_valid, topk, 0)

    # Selected-voxel attributes: tsdf, gradient dir, weight via ONE rowwise
    # take_along_axis of a channel-packed array, PADDED to 8 aligned
    # channels (5-wide rows were a slow gather width on the accelerator
    # this was first tuned on; not yet re-measured on the GPU).
    attr = jnp.concatenate(
        [tsdf_blk.reshape(V, nvox, 1), g.reshape(V, nvox, 3),
         w_blk.reshape(V, nvox, 1),
         jnp.zeros((V, nvox, 3), tsdf_blk.dtype)],
        axis=-1,
    )                                                      # [V, 512, 8]
    picked = jnp.take_along_axis(attr, sel[..., None], axis=1)  # [V, K, 8]
    t_sel = picked[..., 0]
    g_sel = picked[..., 1:4]
    w_sel = picked[..., 4]
    n_dir = g_sel / jnp.maximum(
        jnp.linalg.norm(g_sel, axis=-1, keepdims=True), 1e-12
    )

    # Voxel centre from the in-block index (pure index math, no gather),
    # projected onto the zero crossing along the gradient.
    lx = (sel // (bsz * bsz)).astype(jnp.float32)
    ly = ((sel // bsz) % bsz).astype(jnp.float32)
    lz = (sel % bsz).astype(jnp.float32)
    local = jnp.stack([lx, ly, lz], axis=-1)               # [V, K, 3]
    base = coords.astype(jnp.float32)[:, None, :] * bsz
    centers = (base + local + 0.5) * voxel
    pts = centers - n_dir * (t_sel * mu)[..., None]        # [V, K, 3]

    # --- project to the camera
    T_cw = se3_inverse(T_wc)
    pc = transform_points(T_cw, pts)
    uv, z = project(cam, pc)
    zmin, zmax = tsdf_cfg.view_frustum_min, tsdf_cfg.view_frustum_max
    u = jnp.round(uv[..., 0]).astype(jnp.int32)
    v = jnp.round(uv[..., 1]).astype(jnp.int32)
    ok = (
        sel_valid
        & (z > zmin) & (z < zmax)
        & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    )

    # Packed z-buffer key: depth-quantized in the high bits, surfel id in
    # the low bits -> ONE scatter-min picks the nearest surfel per pixel
    # and remembers who it was.  Ties break deterministically by id.
    zq = jnp.clip(
        ((z - zmin) / (zmax - zmin) * ((1 << depth_bits) - 1)),
        0,
        (1 << depth_bits) - 1,
    ).astype(jnp.int32)
    lids = lax.broadcasted_iota(jnp.int32, (V, K), 0) * K + lax.broadcasted_iota(
        jnp.int32, (V, K), 1
    )
    if axis_name is not None:
        # Globally unique surfel id: interleave the shard id so pmin ties
        # are impossible and ownership is decodable (gid % ns == shard).
        sid = lax.axis_index(axis_name)
        ids = lids * num_shards + sid
    else:
        ids = lids
    key = (zq << id_bits) | ids
    sentinel = jnp.iinfo(jnp.int32).max

    pix = jnp.where(ok, v * w + u, h * w).reshape(-1)
    zbuf = (
        jnp.full((h * w,), sentinel, jnp.int32)
        .at[pix]
        .min(jnp.where(ok, key, sentinel).reshape(-1), mode="drop")
    )

    if axis_name is not None:
        # Sort-last compositing: nearest surfel across all shards.
        zbuf = lax.pmin(zbuf, axis_name)

    # Hole closing: image-space min-dilation of the packed keys (borrows
    # the nearest neighbouring surfel, like a widened splat footprint).
    zimg = zbuf.reshape(h, w)
    for _ in range(dilate_passes):
        zimg = _min_dilate(zimg, sentinel)
    zbuf = zimg.reshape(-1)

    hit = zbuf != sentinel
    gid = jnp.where(hit, zbuf & ((1 << id_bits) - 1), 0)
    # One winner-attribute gather: xyz, z, fusion weight — PADDED to 8
    # aligned channels (power-of-two row widths; see the attr gather above).
    surfel_attr = jnp.concatenate(
        [
            pts.reshape(-1, 3), z.reshape(-1, 1), w_sel.reshape(-1, 1),
            jnp.zeros((pts.shape[0] * pts.shape[1], 3), pts.dtype),
        ],
        axis=-1,
    )
    if axis_name is not None:
        mine = hit & ((gid % num_shards) == sid)
        won = surfel_attr[jnp.where(mine, gid // num_shards, 0)]
        won = jnp.where(mine[:, None], won, 0.0)
        won = lax.psum(won, axis_name)
    else:
        won = surfel_attr[gid]
    points = jnp.where(hit[:, None], won[:, :3], 0.0).reshape(h, w, 3)
    depth = jnp.where(hit, won[:, 3], 0.0).reshape(h, w)
    conf = jnp.where(hit, won[:, 4], 0.0).reshape(h, w)

    # Fence: the point map is produced by a gather; without a barrier XLA
    # duplicates that gather into every tap of the normal stencil.
    points = lax.optimization_barrier(points)
    o_w = T_wc[:3, 3]
    normals = normals_from_point_map(points, o_w)
    return RaycastResult(
        points=points,
        normals=normals,
        hit=hit.reshape(h, w),
        depth=depth,
        confidence=conf,
    )
