"""Out-of-core voxel block pool: device-side evict/restore primitives.

The reference scaffolds (but never enables) a host-swap state machine —
``GlobalCache`` keeps a host copy of every block with per-entry swap
states and pinned staging buffers for <=4096-block transfers
(reference: tfusion/include/tfusion/GlobalCache.hpp:22-134; the
``useSwapping`` alloc branches at SceneReconstructionEngine_host.cu:
170-189).  This re-design keeps the POLICY on the host (like
the reference) but replaces the per-block state machine with three
batched, fully-vectorized device operations on the block map:

  * :func:`extract_blocks` — one row-gather of an explicit slot list
    (the host's cold set) for host fetch;
  * :func:`evict_blocks` — remove those slots and COMPACT the pool
    (rank/scatter compaction + a sort-based full bucket rebuild), so the
    bump allocator keeps working and freed rows are reusable — no
    free-list, no holes;
  * :func:`insert_blocks` — re-insert restored blocks (allocate + lookup
    + weighted TSDF merge), correct even when the area was re-observed
    and re-allocated while swapped out (running-average fusion of host
    and device data, the same rule as computeUpdatedVoxelDepthInfo,
    reference: SceneReconstructionEngine.hpp:23-71).

Host-side orchestration (LRU policy, the host store, pipeline wiring)
lives in models/host_cache.py.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
from jax import lax

from topfusion.config import BlockMapConfig
from topfusion.ops.blockmap import (
    EMPTY_KEY,
    BlockMap,
    _bucket_owner,
    allocate,
    decode_tsdf,
    decode_weight,
    encode_tsdf,
    encode_weight,
    lookup,
    pack_key,
    tsdf_init,
)


class ExtractedBlocks(NamedTuple):
    """Host-transfer package for a batch of evicted blocks."""

    coords: jnp.ndarray   # [K, 3] int32
    tsdf: jnp.ndarray     # [K, B, B, B]
    weight: jnp.ndarray   # [K, B, B, B]
    color: jnp.ndarray    # [K, B, B, B, 3] (or [K, 1, 1, 1, 3] dummy)
    valid: jnp.ndarray    # [K] bool


def extract_blocks(m: BlockMap, slots: jnp.ndarray) -> ExtractedBlocks:
    """Gather coords + voxel data for an explicit slot list [K]
    (pad = -1).  One row-gather per pool array."""
    cap = m.capacity
    valid = (slots >= 0) & (slots < m.num_blocks)
    safe = jnp.where(valid, slots, cap)  # sacrificial row
    has_color = m.color.shape[0] == cap + 1
    color = (
        m.color[safe]
        if has_color
        else jnp.zeros((slots.shape[0], 1, 1, 1, 3), m.tsdf.dtype)
    )
    return ExtractedBlocks(
        coords=m.block_coords[jnp.where(valid, slots, 0)],
        tsdf=m.tsdf[safe],
        weight=m.weight[safe],
        color=color,
        valid=valid,
    )


def evict_blocks(
    m: BlockMap, slots: jnp.ndarray, cfg: BlockMapConfig, shard=None
) -> Tuple[BlockMap, jnp.ndarray]:
    """Remove the given slots [K] (pad = -1) and compact the pool.

    Kept blocks are rank/scatter-compacted to the front (slot order is
    preserved, so the operation is deterministic) and the bucket table is
    rebuilt from the compacted coords with a sort-based way assignment —
    O(C log C), no O(C^2) compare.  Every key that fit before fits after
    (the kept keys are a subset per bucket).  Returns
    (new map, old->new slot remap [capacity] int32 with -1 for evicted) —
    the remap lets callers fix any slot-indexed side state (e.g. the aged
    visible list).  ``shard = (shard_id, num_shards)`` rebuilds the
    bucket table in the sharded GLOBAL bucket space (every block in a
    shard-local map is owned by that shard, so only the bucket index
    changes; parallel/block_sharded.py).
    """
    cap = m.capacity
    nb, ways = m.bucket_keys.shape
    bits = cfg.coord_bits
    row = jnp.arange(cap)

    ev_valid = (slots >= 0) & (slots < m.num_blocks)
    evict_mask = (
        jnp.zeros((cap,), bool)
        .at[jnp.where(ev_valid, slots, cap)]
        .set(True, mode="drop")
    )
    live = row < m.num_blocks
    keep = live & ~evict_mask

    # Compaction permutation: new row i <- old slot old_of_new[i].
    rank = jnp.cumsum(keep.astype(jnp.int32)) - 1
    n_new = jnp.sum(keep.astype(jnp.int32))
    old_of_new = (
        jnp.full((cap,), cap, jnp.int32)
        .at[jnp.where(keep, rank, cap)]
        .set(row.astype(jnp.int32), mode="drop")
    )
    new_of_old = jnp.where(keep, rank, -1)

    live_new = row < n_new
    gathered_t = m.tsdf[old_of_new]
    gathered_w = m.weight[old_of_new]
    pool_t = jnp.where(live_new[:, None, None, None], gathered_t,
                       tsdf_init(gathered_t.shape, gathered_t.dtype))
    pool_w = jnp.where(live_new[:, None, None, None], gathered_w,
                       jnp.zeros_like(gathered_w))
    coords_new = jnp.where(
        live_new[:, None],
        m.block_coords[jnp.minimum(old_of_new, cap - 1)],
        0,
    )
    has_color = m.color.shape[0] == cap + 1
    if has_color:
        gathered_c = m.color[old_of_new]
        pool_c = jnp.where(
            live_new[:, None, None, None, None], gathered_c,
            jnp.zeros_like(gathered_c),
        )
        color = jnp.concatenate([pool_c, m.color[-1:]], axis=0)
    else:
        color = m.color

    # Bucket rebuild: sort compacted keys by bucket, rank within bucket.
    keys = jnp.where(live_new, pack_key(coords_new, bits), EMPTY_KEY)
    local_b, _ = _bucket_owner(coords_new, nb, shard)
    bucket = jnp.where(live_new, local_b, nb)
    order = jnp.argsort(bucket, stable=True)
    b_sorted = bucket[order]
    first = jnp.concatenate(
        [jnp.ones((1,), bool), b_sorted[1:] != b_sorted[:-1]]
    )
    seg_start = lax.cummax(jnp.where(first, row, 0))
    way = (row - seg_start).astype(jnp.int32)
    fits = (b_sorted < nb) & (way < ways)  # subset property: always fits
    flat = jnp.where(fits, b_sorted * ways + way, nb * ways)
    bucket_keys = (
        jnp.full((nb * ways,), EMPTY_KEY, jnp.int32)
        .at[flat].set(jnp.where(fits, keys[order], EMPTY_KEY), mode="drop")
        .reshape(nb, ways)
    )
    bucket_slots = (
        jnp.zeros((nb * ways,), jnp.int32)
        .at[flat].set(jnp.where(fits, order.astype(jnp.int32), 0),
                      mode="drop")
        .reshape(nb, ways)
    )

    new_map = BlockMap(
        bucket_keys=bucket_keys,
        bucket_slots=bucket_slots,
        block_coords=coords_new,
        tsdf=jnp.concatenate([pool_t, m.tsdf[-1:]], axis=0),
        weight=jnp.concatenate([pool_w, m.weight[-1:]], axis=0),
        num_blocks=n_new,
        color=color,
    )
    return new_map, new_of_old


def insert_blocks(
    m: BlockMap,
    blocks: ExtractedBlocks,
    cfg: BlockMapConfig,
    max_weight: float,
    shard=None,
) -> Tuple[BlockMap, jnp.ndarray]:
    """Restore host-cached blocks into the map.

    Allocates any missing blocks (bounded by max_new_blocks_per_frame —
    restore batches must respect it), then MERGES host data into device
    data with the running weighted average — if the region was
    re-observed and re-allocated while swapped out, neither copy is
    discarded.  Returns (map, restored-mask [K]); callers drop exactly
    the restored entries from the host store (a batch overflowing the
    per-frame allocation bound keeps its overflow host-side).
    """
    cap = m.capacity
    bits = cfg.coord_bits
    m, _ = allocate(m, blocks.coords, blocks.valid, cfg, shard=shard)
    slots, found = lookup(m, blocks.coords, bits, shard=shard)
    ok = blocks.valid & found
    safe = jnp.where(ok, slots, cap)

    t_d = decode_tsdf(m.tsdf[safe])
    w_d = decode_weight(m.weight[safe])
    t_h = decode_tsdf(blocks.tsdf)
    w_h = decode_weight(blocks.weight)
    w_sum = w_d + w_h
    t_new = (t_d * w_d + t_h * w_h) / jnp.maximum(w_sum, 1.0)
    t_new = jnp.where(w_sum > 0, t_new, 1.0)
    w_new = jnp.minimum(w_sum, max_weight)
    okk = ok[:, None, None, None]
    scatter = jnp.where(ok, slots, cap)
    new_tsdf = m.tsdf.at[scatter].set(
        encode_tsdf(jnp.where(okk, t_new, t_d), m.tsdf.dtype), mode="drop"
    )
    new_weight = m.weight.at[scatter].set(
        encode_weight(jnp.where(okk, w_new, w_d), m.weight.dtype), mode="drop"
    )
    has_color = m.color.shape[0] == cap + 1
    color = m.color
    if has_color and blocks.color.shape[1] == m.color.shape[1]:
        c_d = decode_tsdf(m.color[safe])
        c_h = decode_tsdf(blocks.color)
        wde = w_d[..., None]
        whe = w_h[..., None]
        c_new = (c_d * wde + c_h * whe) / jnp.maximum(wde + whe, 1.0)
        color = m.color.at[scatter].set(
            encode_tsdf(
                jnp.where(ok[:, None, None, None, None], c_new, c_d),
                m.color.dtype,
            ),
            mode="drop",
        )
    return m._replace(tsdf=new_tsdf, weight=new_weight, color=color), ok
