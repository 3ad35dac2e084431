"""Gathers as one-hot matrix products.

A gather is exactly a one-hot matrix product: for queries with *bounded
row locality* (a pixel row's projective correspondences land near that
row), the map can be cut into static overlapping row bands and the gather
becomes two small contractions per band:

    out[q, c] = sum_u onehot_u[q, u] * sum_b onehot_v[q, b] * band[b, u, c]

The u-contraction is a batched matmul over bands; the v-selection is an
elementwise reduction over the band height.  One-hot products are EXACT in
f32 at full precision (each output is a single selected element; the
contraction states ``HIGHEST`` so a GPU does not round the selected value
to TF32), so this is a bit-exact replacement for the fancy-index gather.
It is an alternative to ``ICPConfig.gather_mode="flat"``, the default.

Used by the ICP association (ops/icp.py); the same pattern generalizes to
any image-space projective sampling.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
from jax import lax


def banded_projective_gather(
    model: jnp.ndarray,
    u_idx: jnp.ndarray,
    v_idx: jnp.ndarray,
    v_margin: int = 24,
    rows_per_tile: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Gather ``model[v_idx[i,j], u_idx[i,j]]`` for query grids organised by
    image row.

    Args:
      model: [H, W, C] float32 map.
      u_idx, v_idx: [h, w] int32 pixel indices into model (any value;
        out-of-range or out-of-band queries return zeros + valid=False).
        Queries at grid row i are assumed to target model rows near
        ``i * H / h`` within ``+-v_margin`` (projective locality).
      v_margin: half-height of the tolerated vertical displacement, pixels.

    Returns:
      (gathered [h, w, C], in_band [h, w] bool).
    """
    H, W, C = model.shape
    h, w = u_idx.shape
    stride = H // h  # query grid may be a strided subsampling of the map

    # Band geometry: each tile of TR query rows reads a band of B model
    # rows starting TR*stride//2 + margin above the tile's first row.
    if rows_per_tile is None:
        rows_per_tile = max(1, 32 // stride)
    tr = rows_per_tile
    while h % tr != 0:
        tr -= 1
    n_tiles = h // tr
    span = tr * stride
    b = span + 2 * v_margin
    # Round band height up to a multiple of 8 (a tile-aligned height); a band
    # taller than the map degenerates to whole-map bands (still exact).
    b = min(((b + 7) // 8) * 8, H)

    starts = jnp.clip(
        jnp.arange(n_tiles) * span + span // 2 - b // 2, 0, max(H - b, 0)
    )

    # [T, B, W, C] overlapping bands — static shapes, dynamic (but
    # data-independent) starts.
    bands = jax.vmap(
        lambda s: lax.dynamic_slice(model, (s, 0, 0), (b, W, C))
    )(starts)

    uq = u_idx.reshape(n_tiles, tr * w)
    vq = v_idx.reshape(n_tiles, tr * w)
    v_rel = vq - starts[:, None]

    u_ok = (uq >= 0) & (uq < W)
    v_ok = (v_rel >= 0) & (v_rel < b) & (vq >= 0) & (vq < H)
    ok = u_ok & v_ok

    uq_c = jnp.where(u_ok, uq, 0)
    v_rel_c = jnp.where(v_ok, v_rel, 0)

    # One-hot u-contraction: [T, Q, W] @ [T, W, B*C].
    onehot_u = (
        uq_c[:, :, None] == jnp.arange(W)[None, None, :]
    ).astype(model.dtype)
    bands_t = bands.transpose(0, 2, 1, 3).reshape(n_tiles, W, b * C)
    mid = jnp.einsum(
        "tqw,twx->tqx", onehot_u, bands_t,
        preferred_element_type=jnp.float32, precision=lax.Precision.HIGHEST,
    ).reshape(n_tiles, tr * w, b, C)

    # v-selection: elementwise multiply + reduce.
    onehot_v = (
        v_rel_c[:, :, None] == jnp.arange(b)[None, None, :]
    ).astype(model.dtype)
    out = jnp.sum(mid * onehot_v[..., None], axis=2)

    out = jnp.where(ok[..., None], out, 0.0)
    return out.reshape(h, w, C), ok.reshape(h, w)
