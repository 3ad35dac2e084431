"""Block integration against an independent NumPy per-voxel reference.

``ops/tsdf_block.integrate_blocks`` fuses a depth image into the visible
blocks with gathers, one elementwise pass and a scatter.  The reference
here computes every voxel on its own in float64 NumPy, with the fusion rule
of computeUpdatedVoxelDepthInfo (reference:
tfusion/include/tfusion/cuda/SceneReconstructionEngine.hpp:23-71):
project the voxel centre, take the nearest depth sample, skip
``eta < -mu`` and out-of-frustum voxels, and fold
``clamp(eta / mu, -1, 1)`` into the weighted running average with the
weight capped at ``max_weight``.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from topfusion.config import (
    BlockMapConfig,
    CameraConfig,
    PipelineConfig,
    PreprocConfig,
    TSDFConfig,
)
from topfusion.geometry.se3 import se3_exp
from topfusion.io.synthetic import SyntheticScene
from topfusion.ops.blockmap import (
    decode_tsdf,
    decode_weight,
    encode_tsdf,
    encode_weight,
    make_block_map,
)
from topfusion.ops.depth import preprocess_depth
from topfusion.ops.tsdf_block import (
    allocate_from_depth,
    integrate_blocks,
    visible_blocks,
)

# Largest difference of a decoded TSDF value from the float64 reference:
# float32 arithmetic error, or one storage quantum of the compact pools.
TSDF_TOL = {"float32": 1e-5, "int16": 1.0 / 32767 + 1e-6, "bfloat16": 2.0**-8}


def _cfg(pool_dtype):
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04, max_weight=50.0),
        blockmap=BlockMapConfig(
            capacity=1 << 12,
            max_new_blocks_per_frame=1024,
            max_visible_blocks=1 << 11,
            alloc_pixel_stride=1,
            pool_dtype=pool_dtype,
        ),
    )


def _prefilled_map(cfg, seed=0):
    """Allocate the blocks one synthetic frame touches, then overwrite
    every pool row with random prior TSDF values and integer weights so
    the running average has something to average with."""
    T = jnp.eye(4, dtype=jnp.float32)
    depth_mm = SyntheticScene().render_depth_mm(cfg.camera, T)
    raw, _ = preprocess_depth(depth_mm, cfg.preproc)
    m = make_block_map(cfg.blockmap)
    m, _ = allocate_from_depth(m, cfg.camera, cfg.tsdf, cfg.blockmap, T, raw)
    rng = np.random.default_rng(seed)
    shape = m.tsdf.shape
    tsdf0 = rng.uniform(-1.0, 1.0, shape).astype(np.float32)
    w_max = int(cfg.tsdf.max_weight)
    w0 = rng.integers(0, w_max + 1, shape).astype(np.float32)
    m = m._replace(
        tsdf=encode_tsdf(jnp.asarray(tsdf0), m.tsdf.dtype),
        weight=encode_weight(jnp.asarray(w0), m.weight.dtype),
    )
    return m, T, raw


def _reference_integrate(cfg, tsdf, weight, slots, coords, mask, T_wc, depth):
    """Fusion of ``depth`` into the listed blocks, every voxel on its own,
    in float64.

    Returns (tsdf, weight, ambiguous): the fused float pools and a
    per-voxel flag for voxels whose outcome hinges on a float32 rounding
    (a pixel coordinate within 1e-3 of a half-integer, or a gate within
    1e-5 m of its threshold)."""
    cam, tc = cfg.camera, cfg.tsdf
    bsz = cfg.blockmap.block_size
    mu = tc.trunc_dist
    h, w = depth.shape
    R = T_wc[:3, :3].astype(np.float64)
    t = T_wc[:3, 3].astype(np.float64)
    rows = slots[mask]
    # Voxel centres [N, B, B, B, 3] of the visible blocks, in metres.
    local = np.stack(
        np.meshgrid(*(np.arange(bsz),) * 3, indexing="ij"), axis=-1
    )
    centre = (
        coords[mask][:, None, None, None, :] * bsz + local + 0.5
    ) * tc.voxel_size
    pc = (centre - t) @ R                       # R^T (p - t), row vectors
    zc = pc[..., 2]
    uf = pc[..., 0] / zc * cam.fx + cam.cx
    vf = pc[..., 1] / zc * cam.fy + cam.cy
    near_half = np.minimum(
        np.abs(uf - np.floor(uf) - 0.5), np.abs(vf - np.floor(vf) - 0.5)
    ) < 1e-3
    u = np.floor(uf + 0.5).astype(np.int64)
    v = np.floor(vf + 0.5).astype(np.int64)
    in_image = (u >= 0) & (u < w) & (v >= 0) & (v < h)
    d = np.where(
        in_image, depth[np.clip(v, 0, h - 1), np.clip(u, 0, w - 1)], 0.0
    ).astype(np.float64)
    eta = d - zc
    near_gate = in_image & (
        np.minimum.reduce([
            np.abs(zc - tc.view_frustum_min),
            np.abs(zc - tc.view_frustum_max),
            np.abs(eta + mu),
        ]) < 1e-5
    )
    update = (
        in_image
        & (zc >= tc.view_frustum_min) & (zc <= tc.view_frustum_max)
        & (d > 0.0) & (eta >= -mu)
    )
    f = np.clip(eta / mu, -1.0, 1.0)
    t0 = tsdf[rows].astype(np.float64)
    w0 = weight[rows].astype(np.float64)
    tsdf = tsdf.astype(np.float64)
    weight = weight.astype(np.float64)
    tsdf[rows] = np.where(update, (t0 * w0 + f) / (w0 + 1.0), t0)
    weight[rows] = np.where(update, np.minimum(w0 + 1.0, tc.max_weight), w0)
    ambiguous = np.zeros(tsdf.shape, bool)
    ambiguous[rows] = near_half | near_gate
    return tsdf, weight, ambiguous


@pytest.mark.parametrize("pool_dtype", ["float32", "int16", "bfloat16"])
def test_integrate_blocks_matches_numpy_reference(pool_dtype):
    cfg = _cfg(pool_dtype)
    m, T, raw = _prefilled_map(cfg)
    vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T)
    # Fuse a frame seen from a slightly moved camera, so the voxels'
    # distances to the new surface differ from the allocation frame's.
    T1 = se3_exp(jnp.asarray([0.01, -0.02, 0.0, 0.01, 0.0, -0.015]))
    depth1_mm = SyntheticScene().render_depth_mm(cfg.camera, T1)
    raw1, _ = preprocess_depth(depth1_mm, cfg.preproc)
    m_out, n_vis = integrate_blocks(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, T1, raw1, vis
    )

    slots, coords, mask = (np.asarray(a) for a in vis)
    assert int(n_vis) == int(mask.sum()) > 50
    tsdf_in = np.asarray(decode_tsdf(m.tsdf))
    w_in = np.asarray(decode_weight(m.weight))
    ref_t, ref_w, amb = _reference_integrate(
        cfg, tsdf_in, w_in, slots, coords, mask,
        np.asarray(T1), np.asarray(raw1),
    )
    got_t = np.asarray(decode_tsdf(m_out.tsdf))
    got_w = np.asarray(decode_weight(m_out.weight))

    live = np.zeros(got_t.shape[0], bool)
    live[: cfg.blockmap.capacity] = True     # the last row is sacrificial
    vis_rows = np.zeros_like(live)
    vis_rows[slots[mask]] = True
    updated = (ref_w != w_in) & live[:, None, None, None]
    assert updated.sum() > 1000, "the frame must update many voxels"
    assert amb[vis_rows].mean() < 0.01

    cmp = live[:, None, None, None] & ~amb
    np.testing.assert_array_equal(got_w[cmp], ref_w[cmp])
    err = np.abs(got_t[cmp] - ref_t[cmp])
    assert err.max() <= TSDF_TOL[pool_dtype], err.max()
    # Rows outside the visible set are not touched at all.
    other = live & ~vis_rows
    np.testing.assert_array_equal(
        np.asarray(m_out.tsdf)[other], np.asarray(m.tsdf)[other]
    )
    np.testing.assert_array_equal(
        np.asarray(m_out.weight)[other], np.asarray(m.weight)[other]
    )


@pytest.mark.parametrize("pool_dtype", ["float32", "int16", "bfloat16"])
def test_integrate_blocks_out_of_view_pool_bit_identical(pool_dtype):
    """Blocks gathered for integration but out of the camera's view (it
    looks away from them) go back to the pool bit for bit: the decode ->
    no-update -> encode round trip is exact for every storage dtype."""
    cfg = _cfg(pool_dtype)
    m, T, raw = _prefilled_map(cfg, seed=1)
    vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T)
    assert int(np.asarray(vis[2]).sum()) > 50
    T_away = se3_exp(jnp.asarray([0.0, np.pi, 0.0, 0.0, 0.0, 0.0]))
    m_out, _ = integrate_blocks(
        m, cfg.camera, cfg.tsdf, cfg.blockmap, T_away, raw, vis
    )
    cap = cfg.blockmap.capacity
    np.testing.assert_array_equal(
        np.asarray(m_out.tsdf)[:cap], np.asarray(m.tsdf)[:cap]
    )
    np.testing.assert_array_equal(
        np.asarray(m_out.weight)[:cap], np.asarray(m.weight)[:cap]
    )
