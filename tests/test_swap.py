"""Out-of-core block pool: evict/restore primitives + end-to-end sweep.

The GlobalCache analogue (round-2 VERDICT missing #4): a scene whose
live-block count exceeds HBM pool capacity must reconstruct at ATE
parity with an uncapped run, with cold blocks spilled to the host and
restored on revisit (reference scaffold: GlobalCache.hpp:22-134,
never enabled there).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from topfusion.config import tiny_test_config
from topfusion.io.synthetic import (
    SyntheticScene,
    corridor_scene,
    sweep_trajectory,
)
from topfusion.io.trajectory import ate_rmse
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.models.host_cache import HostBlockCache
from topfusion.ops.blockmap import lookup, make_block_map, allocate
from topfusion.ops.swap import evict_blocks, extract_blocks, insert_blocks


def _filled_map(cfg, n=300, seed=0):
    m = make_block_map(cfg)
    rng = np.random.default_rng(seed)
    coords = jnp.asarray(rng.integers(-10, 10, size=(n, 3)), jnp.int32)
    m, _ = allocate(m, coords, jnp.ones(n, bool), cfg)
    nb = int(m.num_blocks)
    # Distinguishable voxel payloads per slot.
    b = cfg.block_size
    t = jnp.tile(
        (jnp.arange(m.tsdf.shape[0]) % 97).astype(jnp.float32)[
            :, None, None, None
        ] / 97.0,
        (1, b, b, b),
    )
    w = jnp.tile(
        1.0 + (jnp.arange(m.weight.shape[0]) % 7).astype(jnp.float32)[
            :, None, None, None
        ],
        (1, b, b, b),
    )
    return m._replace(tsdf=t, weight=w), nb


def test_evict_restore_round_trip():
    cfg = tiny_test_config().blockmap
    m, nb = _filled_map(cfg)
    orig_t = np.asarray(m.tsdf).copy()
    orig_coords = np.asarray(m.block_coords).copy()

    # Evict a third of the slots.
    k = nb // 3
    slots = jnp.asarray(
        np.r_[np.arange(0, nb, 3)[:k], -np.ones(max(0, k - len(np.arange(0, nb, 3)[:k])))],
        jnp.int32,
    )
    ex = extract_blocks(m, slots)
    m2, remap = evict_blocks(m, slots, cfg)
    assert int(m2.num_blocks) == nb - int(np.asarray(ex.valid).sum())

    # Every kept block is still findable and its payload moved intact.
    remap_np = np.asarray(remap)
    kept_old = np.nonzero(remap_np >= 0)[0]
    coords_kept = orig_coords[kept_old]
    slot2, found2 = lookup(m2, jnp.asarray(coords_kept), cfg.coord_bits)
    assert bool(np.asarray(found2).all())
    np.testing.assert_array_equal(
        np.asarray(slot2), remap_np[kept_old]
    )
    np.testing.assert_allclose(
        np.asarray(m2.tsdf)[remap_np[kept_old]], orig_t[kept_old]
    )
    # Evicted blocks are gone from the table.
    gone = np.asarray(ex.coords)[np.asarray(ex.valid)]
    _, found_g = lookup(m2, jnp.asarray(gone), cfg.coord_bits)
    assert not bool(np.asarray(found_g).any())

    # Restore: payload returns (into empty slots -> exact content).
    m3, ok = insert_blocks(m2, ex, cfg, max_weight=100.0)
    assert int(np.asarray(ok).sum()) == int(np.asarray(ex.valid).sum())
    slot3, found3 = lookup(m3, jnp.asarray(gone), cfg.coord_bits)
    assert bool(np.asarray(found3).all())
    ev_idx = np.asarray(ex.valid)
    np.testing.assert_allclose(
        np.asarray(m3.tsdf)[np.asarray(slot3)],
        np.asarray(ex.tsdf)[ev_idx],
        atol=1e-6,
    )
    np.testing.assert_allclose(
        np.asarray(m3.weight)[np.asarray(slot3)],
        np.asarray(ex.weight)[ev_idx],
        atol=1e-6,
    )


def test_insert_merges_when_reallocated():
    """A block re-observed while swapped out: restore must FUSE host and
    device data (running weighted average), not overwrite."""
    cfg = tiny_test_config().blockmap
    m = make_block_map(cfg)
    c = jnp.asarray([[1, 2, 3]], jnp.int32)
    m, _ = allocate(m, c, jnp.ones(1, bool), cfg)
    b = cfg.block_size
    # Device copy: tsdf 0.2, weight 10.
    m = m._replace(
        tsdf=m.tsdf.at[0].set(0.2), weight=m.weight.at[0].set(10.0)
    )
    from topfusion.ops.swap import ExtractedBlocks

    host = ExtractedBlocks(
        coords=c,
        tsdf=jnp.full((1, b, b, b), 0.8, jnp.float32),
        weight=jnp.full((1, b, b, b), 30.0, jnp.float32),
        color=jnp.zeros((1, 1, 1, 1, 3), jnp.float32),
        valid=jnp.ones(1, bool),
    )
    m2, ok = insert_blocks(m, host, cfg, max_weight=100.0)
    assert bool(ok[0])
    expect_t = (0.2 * 10.0 + 0.8 * 30.0) / 40.0
    np.testing.assert_allclose(
        np.asarray(m2.tsdf)[0], expect_t, atol=1e-6
    )
    np.testing.assert_allclose(np.asarray(m2.weight)[0], 40.0, atol=1e-6)


def test_slam_system_out_of_core_smoke():
    """Product surface: SlamSystem with blockmap.out_of_core=True runs a
    chunked corridor sweep, spills under pressure, and keeps tracking."""
    from topfusion.models.slam import SlamSystem

    base = tiny_test_config()
    base = dataclasses.replace(
        base,
        tsdf=dataclasses.replace(base.tsdf, view_frustum_max=2.0),
        blockmap=dataclasses.replace(
            base.blockmap, capacity=1 << 11, max_visible_blocks=1 << 11,
            out_of_core=True,
        ),
    )
    from topfusion.geometry.se3 import se3_exp as _se3exp

    pitch = np.asarray(
        _se3exp(jnp.asarray([0.35, 0, 0, 0, 0, 0], jnp.float32))
    )
    scene = corridor_scene(length_m=6.5, box_every=0.35)
    gt = [T @ pitch for T in sweep_trajectory(24, step_m=0.06)]
    frames = np.stack(
        [
            np.asarray(
                scene.render_depth_mm(base.camera, jnp.asarray(T, jnp.float32))
            )
            for T in gt
        ]
    )

    slam = SlamSystem(base)
    assert slam.swap is not None
    ke = base.posegraph.keyframe_every
    infos = []
    for s in range(0, len(frames) - len(frames) % ke, ke):
        infos += slam.process_chunk(frames[s : s + ke])
    assert all(i["ok"] for i in infos[1:])
    assert slam.swap.n_host_blocks > 0, "never spilled despite pressure"


def test_corridor_sweep_beyond_capacity_matches_uncapped():
    """THE acceptance test: a corridor sweep whose cumulative block count
    exceeds the capped pool reconstructs (with host spill + restore) at
    ATE parity with an uncapped run, and the spilled blocks are
    retrievable — effective capacity is host RAM, not HBM."""
    base = tiny_test_config()
    # Frustum matches depth truncation (2.0 m): bounds the PER-FRAME
    # working set (out-of-core can spill cold blocks, not the
    # simultaneously-visible set).
    base = dataclasses.replace(
        base,
        tsdf=dataclasses.replace(base.tsdf, view_frustum_max=2.0),
    )
    # Dense box field + a ~20 deg downward pitch: the floor and box tops
    # stay inside the 2 m truncation range down the WHOLE corridor (a
    # level camera deep in the corridor sees only geometry beyond
    # truncation and legitimately starves the tracker).
    from topfusion.geometry.se3 import se3_exp as _se3exp

    pitch = np.asarray(
        _se3exp(jnp.asarray([0.35, 0, 0, 0, 0, 0], jnp.float32))
    )
    scene = corridor_scene(length_m=6.5, box_every=0.35)
    fwd = [T @ pitch for T in sweep_trajectory(36, step_m=0.06)]
    # Return leg at the same cadence: the camera comes back through
    # evicted territory, so the restore path (host -> device merge) runs
    # end-to-end.
    gt = fwd + fwd[::-1][1:]
    cam = base.camera

    def render(T):
        return scene.render_depth_mm(cam, jnp.asarray(T, jnp.float32))

    frames = [render(T) for T in gt]

    def run(cfg, cache=None):
        pipe = BlockPipeline(cfg)
        state = pipe.init()
        poses, dropped = [], 0
        for f in frames:
            if cache is not None:
                T_pred = (
                    poses[-1] if poses else np.eye(4, dtype=np.float32)
                )
                m = cache.before_step(state.block_map(), T_pred)
                state = pipe.write_map(state, m)
            state, aux = pipe.step(state, f)
            assert bool(aux.ok)
            dropped += int(aux.blocks_dropped)
            poses.append(np.asarray(state.T_wc))
            if cache is not None:
                m, remap = cache.after_step(
                    state.block_map(), np.asarray(state.vis_slots)
                )
                if remap is not None:
                    vs = np.asarray(state.vis_slots)
                    remap_np = np.asarray(remap)
                    vs = np.where(
                        vs >= 0, remap_np[np.clip(vs, 0, len(remap_np) - 1)], -1
                    )
                    state = pipe.write_map(state, m)._replace(
                        vis_slots=jnp.asarray(vs, jnp.int32)
                    )
                else:
                    state = pipe.write_map(state, m)
        ate = ate_rmse(poses, [np.asarray(g) for g in gt], align=False)
        return ate, state, dropped

    # Uncapped reference run.
    big = dataclasses.replace(
        base,
        blockmap=dataclasses.replace(base.blockmap, capacity=1 << 13),
    )
    ate_ref, s_ref, _ = run(big)
    total_blocks = int(s_ref.num_blocks)

    # Capped pool: capacity BELOW the scene's block count but above the
    # per-frame working set (out-of-core spills COLD blocks; the
    # simultaneously-visible set must still fit, as in any swap system).
    cap = 1 << 11
    assert total_blocks > 1.2 * cap, (
        f"premise violated: scene has {total_blocks} <= 1.2 * {cap} blocks"
    )
    small = dataclasses.replace(
        base,
        blockmap=dataclasses.replace(
            base.blockmap, capacity=cap, max_visible_blocks=cap,
        ),
    )
    cache = HostBlockCache(
        small.blockmap, small.tsdf, cam,
        evict_batch=512, restore_batch=256,
    )
    ate_swap, s_swap, dropped = run(small, cache)

    # Nothing silently dropped; the overflow lives host-side.
    assert dropped == 0, f"{dropped} blocks dropped despite swapping"
    assert cache.n_host_blocks > 0
    assert int(s_swap.num_blocks) + cache.n_host_blocks >= int(
        0.95 * total_blocks
    )
    # ATE parity with the uncapped run.
    assert ate_swap <= 1.2 * ate_ref + 2e-4, (
        f"swap ATE {ate_swap*1000:.2f} mm vs uncapped {ate_ref*1000:.2f} mm"
    )


def test_sharded_sweep_beyond_aggregate_capacity_matches_uncapped():
    """Round-3 VERDICT missing #1 acceptance: the SHARDED pipeline with
    per-shard host caches sweeps a corridor whose block count exceeds the
    AGGREGATE (all-shard) pool capacity at ATE parity with an uncapped
    sharded run, zero blocks dropped — scale-out and scale-beyond-HBM
    composed (BASELINE.md configs 4/5)."""
    from topfusion.models.host_cache import ShardedHostCache
    from topfusion.parallel.block_sharded import (
        ShardedBlockPipeline,
        make_mesh,
    )

    n_dev = 8
    base = tiny_test_config()
    base = dataclasses.replace(
        base,
        tsdf=dataclasses.replace(base.tsdf, view_frustum_max=2.0),
    )
    from topfusion.geometry.se3 import se3_exp as _se3exp

    pitch = np.asarray(
        _se3exp(jnp.asarray([0.35, 0, 0, 0, 0, 0], jnp.float32))
    )
    # Long dense corridor: the mapped block count must exceed the capped
    # AGGREGATE pool while the per-frame visible set (~2k blocks) still
    # fits it — the swap premise (spill COLD blocks, not the working set).
    scene = corridor_scene(length_m=10.0, box_every=0.3)
    fwd = [T @ pitch for T in sweep_trajectory(56, step_m=0.06)]
    gt = fwd + fwd[::-1][1:]  # return leg re-enters evicted territory
    cam = base.camera
    frames = [
        scene.render_depth_mm(cam, jnp.asarray(T, jnp.float32)) for T in gt
    ]
    mesh = make_mesh(n_dev)

    def run(cfg, with_cache):
        pipe = ShardedBlockPipeline(cfg, mesh)
        cache = (
            ShardedHostCache(pipe, evict_batch=128, restore_batch=64)
            if with_cache
            else None
        )
        state = pipe.init()
        poses, dropped = [], 0
        for f in frames:
            if cache is not None:
                T_pred = poses[-1] if poses else np.eye(4, dtype=np.float32)
                state = cache.before_step(state, T_pred)
            state, aux = pipe.step(state, f)
            assert bool(aux.ok)
            dropped += int(aux.blocks_dropped)
            poses.append(np.asarray(state.T_wc))
            if cache is not None:
                state = cache.after_step(state)
        ate = ate_rmse(poses, [np.asarray(g) for g in gt], align=False)
        return ate, state, dropped, cache

    # Uncapped sharded reference run.
    big = dataclasses.replace(
        base,
        blockmap=dataclasses.replace(
            base.blockmap, capacity=1 << 14, max_visible_blocks=1 << 12,
        ),
    )
    ate_ref, s_ref, _, _ = run(big, with_cache=False)
    total_blocks = int(np.asarray(s_ref.num_blocks).sum())

    # Aggregate capacity BELOW the scene's block count.
    cap = 1 << 12  # global; 512 slots per shard
    assert total_blocks > 1.2 * cap, (
        f"premise violated: scene has {total_blocks} <= 1.2 * {cap} blocks"
    )
    small = dataclasses.replace(
        base,
        blockmap=dataclasses.replace(
            base.blockmap, capacity=cap, max_visible_blocks=cap,
            max_new_blocks_per_frame=1024,
        ),
    )
    ate_swap, s_swap, dropped, cache = run(small, with_cache=True)

    assert dropped == 0, f"{dropped} blocks dropped despite swapping"
    assert cache.n_host_blocks > 0
    live = int(np.asarray(s_swap.num_blocks).sum())
    assert live + cache.n_host_blocks >= int(0.95 * total_blocks)
    assert ate_swap <= 1.2 * ate_ref + 2e-4, (
        f"sharded swap ATE {ate_swap*1000:.2f} mm "
        f"vs uncapped {ate_ref*1000:.2f} mm"
    )


def test_remap_store_rigid_rekey_and_merge():
    """remap_store carries spilled blocks through a map correction:
    translation by a whole block re-keys exactly; colliding keys merge
    by fusion weight (round-3 VERDICT missing #4, swap part)."""
    from topfusion.models.host_cache import HostBlockCache

    base = tiny_test_config()
    cache = HostBlockCache(base.blockmap, base.tsdf, base.camera)
    b = base.blockmap.block_size
    bm = b * base.tsdf.voxel_size
    t1 = np.full((b, b, b), 0.2, np.float32)
    w1 = np.full((b, b, b), 10.0, np.float32)
    t2 = np.full((b, b, b), 0.8, np.float32)
    w2 = np.full((b, b, b), 30.0, np.float32)
    cache.store[(0, 0, 5)] = (t1, w1, None)
    cache.store[(1, 0, 5)] = (t2, w2, None)
    cache.store[(4, 4, 9)] = (t1.copy(), w1.copy(), None)

    # Exact one-block +x translation: keys shift, payloads untouched.
    corr = np.eye(4)
    corr[0, 3] = bm
    cache.remap_store(corr)
    assert set(cache.store.keys()) == {(1, 0, 5), (2, 0, 5), (5, 4, 9)}
    np.testing.assert_allclose(cache.store[(1, 0, 5)][0], 0.2)
    np.testing.assert_allclose(cache.store[(2, 0, 5)][0], 0.8)

    # A correction that lands two blocks on one key merges by weight.
    cache.store = {
        (0, 0, 5): (t1, w1, None),
        (1, 0, 5): (t2, w2, None),
    }
    corr = np.eye(4)
    corr[0, 3] = -0.5 * bm  # both centers round into block x=0
    cache.remap_store(corr)
    assert set(cache.store.keys()) == {(0, 0, 5)}
    t, w, _ = cache.store[(0, 0, 5)]
    np.testing.assert_allclose(t, (0.2 * 10 + 0.8 * 30) / 40.0, atol=1e-6)
    np.testing.assert_allclose(w, 40.0)


def test_swap_store_survives_reintegration():
    """A loop-closure rebuild must NOT clear the host store: spilled
    geometry re-keys through the correction and remains restorable."""
    from topfusion.models.slam import SlamSystem

    base = tiny_test_config()
    base = dataclasses.replace(
        base,
        tsdf=dataclasses.replace(base.tsdf, view_frustum_max=2.0),
        blockmap=dataclasses.replace(
            base.blockmap, capacity=1 << 11, max_visible_blocks=1 << 11,
            out_of_core=True,
        ),
        posegraph=dataclasses.replace(
            base.posegraph, min_map_correction=0.0, keyframe_every=3,
            loop_max_dist=0.5,
        ),
    )
    from topfusion.geometry.se3 import se3_exp as _se3exp

    pitch = np.asarray(
        _se3exp(jnp.asarray([0.35, 0, 0, 0, 0, 0], jnp.float32))
    )
    scene = corridor_scene(length_m=6.5, box_every=0.35)
    fwd = [T @ pitch for T in sweep_trajectory(15, step_m=0.06)]
    gt = fwd + fwd[::-1][1:]  # return to start -> loop closure
    frames = np.stack(
        [
            np.asarray(
                scene.render_depth_mm(base.camera, jnp.asarray(T, jnp.float32))
            )
            for T in gt
        ]
    )
    slam = SlamSystem(base)
    ke = base.posegraph.keyframe_every
    for s in range(0, len(frames) - len(frames) % ke, ke):
        slam.process_chunk(frames[s : s + ke])
    assert slam.swap.n_host_blocks > 0 or slam.reintegrations == 0
    if slam.reintegrations:
        # The store survived at least one rebuild (old behavior cleared
        # it wholesale).
        assert slam.swap.n_host_blocks > 0
    else:
        import pytest

        pytest.skip("no loop closure fired on this trajectory")
