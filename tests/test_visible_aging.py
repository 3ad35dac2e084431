"""Visible-set aging: the incremental (aged) visible list must equal the
full O(capacity) scan along a normal tracked trajectory, and the
allocator's touched-set/drop-count outputs must be correct.

Reference shape: setToType3 ages last frame's visible list; the
allocation DDA marks found/created entries; buildVisibleList re-checks
only those (SceneReconstructionEngine_host.cu:343-348, 434-479).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from topfusion.config import tiny_test_config
from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.ops.blockmap import allocate, make_block_map
from topfusion.ops.tsdf_block import (
    allocate_from_depth,
    visible_blocks,
    visible_blocks_incremental,
)


def test_allocate_touched_and_dropped():
    cfg = tiny_test_config().blockmap
    m = make_block_map(cfg)
    rng = np.random.default_rng(0)
    coords = jnp.asarray(rng.integers(-10, 10, size=(300, 3)), jnp.int32)
    m, info = allocate(m, coords, jnp.ones(300, bool), cfg,
                       return_touched=True)
    n_uniq = len(set(map(tuple, np.asarray(coords).tolist())))
    assert int(info.n_inserted) == n_uniq
    assert int(info.n_dropped_capacity) == 0
    assert int(info.n_dropped_deferred) == 0
    # Touched = everything inserted (map was empty).
    t = np.asarray(info.touched_slots)
    assert (t >= 0).sum() == n_uniq
    assert set(t[t >= 0]) == set(range(n_uniq))

    # Re-allocating the same coords: nothing new, all touched as existing.
    m2, info2 = allocate(m, coords, jnp.ones(300, bool), cfg,
                         return_touched=True)
    assert int(info2.n_inserted) == 0
    t2 = np.asarray(info2.touched_slots)
    assert set(t2[t2 >= 0]) == set(range(n_uniq))

    # Capacity pressure: a tiny per-frame bound drops the overflow and
    # reports it.
    small = dataclasses.replace(cfg, max_new_blocks_per_frame=8)
    m3 = make_block_map(small)
    coords3 = jnp.asarray(
        np.stack(np.meshgrid(range(4), range(4), range(4)), -1).reshape(-1, 3),
        jnp.int32,
    )  # 64 unique blocks
    m3, info3 = allocate(m3, coords3, jnp.ones(64, bool), small,
                         return_touched=True)
    assert int(info3.n_inserted) == 8
    assert int(info3.n_dropped_deferred) == 64 - 8
    assert int(info3.n_dropped_capacity) == 0


def _dolly_trajectory(n):
    """Monotonic forward dolly: blocks leave the frustum and never
    re-enter, so aged and full-scan visible sets must stay IDENTICAL."""
    from topfusion.geometry.se3 import se3_exp

    return [
        np.asarray(
            se3_exp(jnp.asarray([0, 0, 0, 0, 0, 0.02 * i], jnp.float32))
        )
        for i in range(n)
    ]


def _run_sets(cfg, gt):
    scene = SyntheticScene()
    m = make_block_map(cfg.blockmap)
    prev = jnp.full((cfg.blockmap.max_visible_blocks,), -1, jnp.int32)
    for T in gt:
        T = jnp.asarray(T, jnp.float32)
        d = scene.render_depth_mm(cfg.camera, T)
        depth_m = d.astype(jnp.float32) / 1000.0
        m, info = allocate_from_depth(
            m, cfg.camera, cfg.tsdf, cfg.blockmap, T, depth_m,
            return_touched=True,
        )
        inc = visible_blocks_incremental(
            m, cfg.camera, cfg.tsdf, cfg.blockmap, T,
            prev, info.touched_slots,
        )
        full = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T)
        touched = set(
            np.asarray(info.touched_slots)[np.asarray(info.touched_mask)]
            .tolist()
        )
        yield inc, full, touched, T, m
        prev = inc[0]


def test_incremental_visible_equals_full_scan_on_dolly():
    """No-re-entry trajectory: the aged set == full scan, bitwise (same
    compaction order)."""
    cfg = tiny_test_config()
    for inc, full, _, _, _ in _run_sets(cfg, _dolly_trajectory(8)):
        np.testing.assert_array_equal(
            np.asarray(inc[0]), np.asarray(full[0]),
            err_msg="aged visible set != full scan on monotonic motion",
        )


def test_incremental_visible_contract_on_orbit():
    """Re-entry trajectory (orbit): the aged set is the REFERENCE
    semantics — a strict subset of the full scan is allowed, but it must
    (a) never contain a block the full scan rejects, and (b) always
    contain every allocation-touched in-frustum block (the set that
    receives depth updates this frame; reference:
    SceneReconstructionEngine_host.cu:343-348 forgets frustum-leavers the
    same way)."""
    cfg = tiny_test_config()
    gt = orbit_trajectory(8, max_angle_deg=6.0, max_shift=0.06, seed=4)
    for inc, full, touched, _, _ in _run_sets(cfg, gt):
        si = set(np.asarray(inc[0])[np.asarray(inc[2])].tolist())
        sf = set(np.asarray(full[0])[np.asarray(full[2])].tolist())
        assert si <= sf, "aged set contains a block the full scan rejects"
        # Every depth-touched block that the full scan deems visible must
        # be in the aged set.
        assert (touched & sf) <= si, (
            "aged set missed a depth-touched visible block"
        )


def test_pipeline_runs_with_aging_and_reports_drops():
    cfg = tiny_test_config()
    assert cfg.blockmap.visible_aging
    scene = SyntheticScene()
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    for T in orbit_trajectory(5, max_angle_deg=4.0, max_shift=0.04, seed=3):
        d = scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        state, aux = pipe.step(state, d)
        assert bool(aux.ok)
        assert int(aux.blocks_dropped) == 0
    # The carried visible set is the last frame's list.
    assert int((np.asarray(state.vis_slots) >= 0).sum()) == int(
        aux.num_visible
    )
