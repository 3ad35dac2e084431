"""Compact voxel storage: bfloat16 pool end-to-end validation.

The reference packs sdf into int16 + uint8 weight (~3 bytes/voxel,
reference: VoxelTypes.hpp:69-92); one compact analogue is a bfloat16 pool
(4 bytes/voxel for tsdf+weight vs 8 at f32) — integrate/splat/raycast are
HBM-bound, so storage width is bandwidth.  These tests establish that the
``pool_dtype="bfloat16"`` flag is accuracy-safe:

  * tracking parity: a bf16-pool run tracks the same trajectory as the
    f32 run to sub-voxel agreement;
  * weight exactness: fusion weights are exact integers in bf16 up to 256
    (why ``max_weight <= 256`` is required with bf16);
  * raycast parity: surfaces extracted from the bf16 map agree with the
    f32 map to a fraction of a voxel.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import (
    BlockMapConfig,
    CameraConfig,
    ICPConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion.io.trajectory import ate_rmse
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.ops.tsdf_block import raycast_blocks


def make_cfg(pool_dtype="float32"):
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(4, 3, 2)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04, max_weight=100.0),
        blockmap=BlockMapConfig(
            capacity=1 << 13,
            max_new_blocks_per_frame=2048,
            max_visible_blocks=1 << 12,
            alloc_pixel_stride=1,
            alloc_steps=6,
            pool_dtype=pool_dtype,
        ),
        raycast=RaycastConfig(max_steps=160),
    )


def run(cfg, n=6):
    scene = SyntheticScene()
    gt = orbit_trajectory(n, max_angle_deg=4.0, max_shift=0.04, seed=3)
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    est = []
    for T in gt:
        depth = scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        state, aux = pipe.step(state, depth)
        assert bool(aux.ok)
        est.append(np.asarray(state.T_wc))
    return gt, est, state


@pytest.fixture(scope="module")
def both_runs():
    gt, est32, st32 = run(make_cfg("float32"))
    _, est16, st16 = run(make_cfg("bfloat16"))
    return gt, est32, st32, est16, st16


def test_bf16_pool_dtype(both_runs):
    _, _, st32, _, st16 = both_runs
    assert st16.tsdf.dtype == jnp.bfloat16
    assert st16.weight.dtype == jnp.bfloat16
    assert st32.tsdf.dtype == jnp.float32


def test_bf16_tracking_parity(both_runs):
    gt, est32, _, est16, _ = both_runs
    a32 = ate_rmse(est32, gt, align=False)
    a16 = ate_rmse(est16, gt, align=False)
    # Both track, and bf16 storage costs < 2 mm of ATE over the orbit.
    assert a32 < 0.012
    assert a16 < 0.012
    assert abs(a16 - a32) < 0.002
    # Per-frame translation agreement: sub-voxel.
    dt = [
        np.linalg.norm(e32[:3, 3] - e16[:3, 3])
        for e32, e16 in zip(est32, est16)
    ]
    assert max(dt) < 0.01


def test_bf16_weights_are_exact_integers(both_runs):
    _, _, _, _, st16 = both_runs
    w = np.asarray(st16.weight.astype(jnp.float32))
    live = w > 0
    assert live.any()
    # Fused at most 6 frames; every weight must be an exact small integer.
    assert np.all(w[live] == np.round(w[live]))
    assert w.max() <= 6.0


def test_bf16_raycast_parity(both_runs):
    _, _, st32, _, st16 = both_runs
    cfg32, cfg16 = make_cfg("float32"), make_cfg("bfloat16")
    T = st32.T_wc
    rc32 = raycast_blocks(
        st32.block_map(), cfg32.camera, cfg32.tsdf, cfg32.blockmap,
        cfg32.raycast, T,
    )
    rc16 = raycast_blocks(
        st16.block_map(), cfg16.camera, cfg16.tsdf, cfg16.blockmap,
        cfg16.raycast, jnp.asarray(np.asarray(st16.T_wc)),
    )
    h32 = np.asarray(rc32.hit)
    h16 = np.asarray(rc16.hit)
    assert (h32 ^ h16).mean() < 0.03
    both = h32 & h16
    dd = np.abs(np.asarray(rc32.depth) - np.asarray(rc16.depth))[both]
    # bf16 sdf values have ~3 decimal digits; depth error stays well under
    # a voxel (the maps were also built along slightly different
    # trajectories, so this bounds the whole-system divergence).
    assert np.median(dd) < cfg32.tsdf.voxel_size * 0.5


# --------------------------------------------------------------- int16
# Fixed-point pool: the reference's ACTUAL Voxel_s encoding (sdf scaled
# by 32767 into int16, valueToFloat/floatToValue, reference:
# VoxelTypes.hpp:69-92).  Same bandwidth as bfloat16 at ~4.5 significant
# digits — the bounds below are accordingly TIGHTER than the bf16 ones.


@pytest.fixture(scope="module")
def i16_runs():
    gt, est32, st32 = run(make_cfg("float32"))
    _, esti, sti = run(make_cfg("int16"))
    return gt, est32, st32, esti, sti


def test_i16_pool_dtype(i16_runs):
    _, _, _, _, sti = i16_runs
    assert sti.tsdf.dtype == jnp.int16
    assert sti.weight.dtype == jnp.int16


def test_i16_tracking_parity(i16_runs):
    gt, est32, _, esti, _ = i16_runs
    a32 = ate_rmse(est32, gt, align=False)
    ai = ate_rmse(esti, gt, align=False)
    # Fixed-point storage is accuracy-indistinguishable from f32
    # (measured 8.35 vs 8.85 mm on this orbit — the bf16 bound is 2 mm).
    assert ai < 0.012
    assert abs(ai - a32) < 0.001
    dt = [
        np.linalg.norm(e32[:3, 3] - ei[:3, 3])
        for e32, ei in zip(est32, esti)
    ]
    assert max(dt) < 0.005  # half a voxel on this config


def test_i16_weights_are_exact_integers(i16_runs):
    _, _, _, _, sti = i16_runs
    w = np.asarray(sti.weight.astype(jnp.float32))
    live = w > 0
    assert live.any()
    assert np.all(w[live] == np.round(w[live]))
    assert w.max() <= 6.0


def test_i16_unintegrated_space_reads_free():
    # A fresh int16 map must read semantic tsdf = 1.0 everywhere the
    # hash misses AND on allocated-but-unfused voxels (encoded 32767).
    from topfusion.ops.blockmap import (
        make_block_map, read_voxels_nearest,
    )

    cfg = make_cfg("int16")
    m = make_block_map(cfg.blockmap)
    t, w, found = read_voxels_nearest(
        m, jnp.asarray([[5, 5, 5]]), cfg.blockmap.coord_bits
    )
    assert float(t[0]) == 1.0 and float(w[0]) == 0.0 and not bool(found[0])
    assert int(np.asarray(m.tsdf)[0, 0, 0, 0]) == 32767


def test_i16_raycast_parity(i16_runs):
    _, _, st32, _, sti = i16_runs
    cfg32, cfgi = make_cfg("float32"), make_cfg("int16")
    T = st32.T_wc
    rc32 = raycast_blocks(
        st32.block_map(), cfg32.camera, cfg32.tsdf, cfg32.blockmap,
        cfg32.raycast, T,
    )
    rci = raycast_blocks(
        sti.block_map(), cfgi.camera, cfgi.tsdf, cfgi.blockmap,
        cfgi.raycast, jnp.asarray(np.asarray(sti.T_wc)),
    )
    h32 = np.asarray(rc32.hit)
    hi = np.asarray(rci.hit)
    assert (h32 ^ hi).mean() < 0.02
    both = h32 & hi
    dd = np.abs(np.asarray(rc32.depth) - np.asarray(rci.depth))[both]
    # int16 quantization is ~mu/32767 ~ microns of surface error; the
    # median divergence bounds the whole-system (trajectory) difference.
    assert np.median(dd) < cfg32.tsdf.voxel_size * 0.25


def test_compact_pool_max_weight_validated():
    """int16/bfloat16 pools bound the exactly-representable fusion
    weight; an incompatible max_weight must fail at config construction
    instead of silently wrapping weights (advisor round-3 finding)."""
    import dataclasses

    import pytest

    from topfusion.config import (
        BlockMapConfig,
        PipelineConfig,
        TSDFConfig,
    )

    with pytest.raises(ValueError, match="max_weight"):
        PipelineConfig(
            tsdf=TSDFConfig(max_weight=40000.0),
            blockmap=BlockMapConfig(pool_dtype="int16"),
        )
    with pytest.raises(ValueError, match="max_weight"):
        PipelineConfig(
            tsdf=TSDFConfig(max_weight=300.0),
            blockmap=BlockMapConfig(pool_dtype="bfloat16"),
        )
    # In-range combinations construct fine.
    PipelineConfig(
        tsdf=TSDFConfig(max_weight=100.0),
        blockmap=BlockMapConfig(pool_dtype="int16"),
    )
    PipelineConfig(
        tsdf=TSDFConfig(max_weight=256.0),
        blockmap=BlockMapConfig(pool_dtype="bfloat16"),
    )
    PipelineConfig(
        tsdf=TSDFConfig(max_weight=1e6),
        blockmap=BlockMapConfig(pool_dtype="float32"),
    )
