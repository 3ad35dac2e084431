"""Property tests of the block-sparse map (SURVEY.md section 4b:
alloc/dedupe/lookup round-trips)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import BlockMapConfig
from topfusion.ops.blockmap import (
    EMPTY_KEY,
    allocate,
    in_coord_range,
    lookup,
    make_block_map,
    pack_key,
    read_voxels_nearest,
    reset_block_map,
    sample_trilinear,
    unpack_key,
)

CFG = BlockMapConfig(capacity=1 << 12, max_new_blocks_per_frame=512)
BITS = CFG.coord_bits


def rand_coords(n, lim=100, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.integers(-lim, lim, size=(n, 3)), jnp.int32)


def test_pack_unpack_roundtrip():
    c = rand_coords(1000, lim=500)
    np.testing.assert_array_equal(np.asarray(unpack_key(pack_key(c, BITS), BITS)), np.asarray(c))


def test_pack_ordering_unique():
    c = rand_coords(4096, lim=64, seed=1)
    keys = np.asarray(pack_key(c, BITS))
    uc = np.unique(np.asarray(c), axis=0)
    assert len(np.unique(keys)) == len(uc)
    assert keys.min() >= 0


def test_allocate_and_lookup():
    m = make_block_map(CFG)
    coords = rand_coords(300, lim=50, seed=2)
    m, n_ins = allocate(m, coords, jnp.ones(300, bool), CFG)
    uniq = np.unique(np.asarray(coords), axis=0)
    assert int(n_ins) == len(uniq)
    assert int(m.num_blocks) == len(uniq)
    slot, found = lookup(m, coords, BITS)
    assert bool(jnp.all(found))
    # slots must map back to the right coords
    bc = np.asarray(m.block_coords)
    np.testing.assert_array_equal(bc[np.asarray(slot)], np.asarray(coords))


def test_lookup_missing():
    m = make_block_map(CFG)
    m, _ = allocate(m, rand_coords(100, lim=20, seed=3), jnp.ones(100, bool), CFG)
    q = rand_coords(50, lim=20, seed=4) + 1000  # outside coord range
    slot, found = lookup(m, q, BITS)
    assert not bool(jnp.any(found))
    assert bool(jnp.all(slot == -1))


def test_allocate_idempotent():
    m = make_block_map(CFG)
    coords = rand_coords(200, lim=30, seed=5)
    m, n1 = allocate(m, coords, jnp.ones(200, bool), CFG)
    m2, n2 = allocate(m, coords, jnp.ones(200, bool), CFG)
    assert int(n2) == 0
    assert int(m2.num_blocks) == int(m.num_blocks)
    np.testing.assert_array_equal(
        np.asarray(m2.bucket_keys), np.asarray(m.bucket_keys)
    )


def test_allocate_respects_valid_mask():
    m = make_block_map(CFG)
    coords = rand_coords(100, lim=30, seed=6)
    valid = jnp.asarray(np.arange(100) % 2 == 0)
    m, n = allocate(m, coords, valid, CFG)
    uniq_valid = np.unique(np.asarray(coords)[np.arange(100) % 2 == 0], axis=0)
    assert int(n) == len(uniq_valid)
    _, found = lookup(m, coords, BITS)
    found = np.asarray(found)
    # every valid coord findable
    assert found[np.arange(100) % 2 == 0].all()


def test_allocate_per_frame_bound():
    cfg = BlockMapConfig(capacity=1 << 12, max_new_blocks_per_frame=64)
    m = make_block_map(cfg)
    coords = rand_coords(1000, lim=100, seed=7)
    m, n = allocate(m, coords, jnp.ones(1000, bool), cfg)
    assert int(n) <= 64
    # a second pass picks up more of the remainder
    m, n2 = allocate(m, coords, jnp.ones(1000, bool), cfg)
    assert int(n2) <= 64 and int(n2) > 0


def test_allocate_capacity_bound():
    cfg = BlockMapConfig(capacity=128, max_new_blocks_per_frame=4096)
    m = make_block_map(cfg)
    coords = rand_coords(2000, lim=100, seed=8)
    m, n = allocate(m, coords, jnp.ones(2000, bool), cfg)
    assert int(n) <= 128
    assert int(m.num_blocks) <= 128


def test_allocate_deterministic():
    m0 = make_block_map(CFG)
    coords = rand_coords(500, lim=60, seed=9)
    perm = np.random.default_rng(0).permutation(500)
    m1, _ = allocate(m0, coords, jnp.ones(500, bool), CFG)
    m2, _ = allocate(m0, coords[perm], jnp.ones(500, bool), CFG)
    # Same candidate SET -> bit-identical table regardless of input order
    # (the determinism the reference's racy allocation cannot offer).
    np.testing.assert_array_equal(np.asarray(m1.bucket_keys), np.asarray(m2.bucket_keys))
    np.testing.assert_array_equal(np.asarray(m1.bucket_slots), np.asarray(m2.bucket_slots))


def test_voxel_read_write_roundtrip():
    m = make_block_map(CFG)
    coords = jnp.asarray([[0, 0, 0], [1, 0, 0], [-1, -1, -1]], jnp.int32)
    m, _ = allocate(m, coords, jnp.ones(3, bool), CFG)
    slot, found = lookup(m, coords, BITS)
    # write a recognizable pattern into block 0's voxel (2,3,4)
    s0 = int(slot[0])
    m = m._replace(
        tsdf=m.tsdf.at[s0, 2, 3, 4].set(-0.5),
        weight=m.weight.at[s0, 2, 3, 4].set(7.0),
    )
    # global voxel coords of that voxel: block (0,0,0) * 8 + (2,3,4)
    t, w, f = read_voxels_nearest(m, jnp.asarray([[2, 3, 4]]), BITS)
    assert bool(f[0])
    np.testing.assert_allclose(float(t[0]), -0.5)
    np.testing.assert_allclose(float(w[0]), 7.0)
    # negative-coord block: block (-1,-1,-1) spans voxels [-8..-1]^3
    t2, w2, f2 = read_voxels_nearest(m, jnp.asarray([[-8, -8, -8]]), BITS)
    assert bool(f2[0])
    np.testing.assert_allclose(float(t2[0]), 1.0)  # untouched init
    # unallocated space reads free
    t3, w3, f3 = read_voxels_nearest(m, jnp.asarray([[100, 100, 100]]), BITS)
    assert not bool(f3[0]) and float(t3[0]) == 1.0 and float(w3[0]) == 0.0


def test_trilinear_across_block_boundary():
    """Linear field written across two adjacent blocks must interpolate
    exactly through the boundary."""
    m = make_block_map(CFG)
    coords = jnp.asarray([[0, 0, 0], [1, 0, 0]], jnp.int32)
    m, _ = allocate(m, coords, jnp.ones(2, bool), CFG)
    slot, _ = lookup(m, coords, BITS)
    s0, s1 = int(slot[0]), int(slot[1])
    # f(x) = 0.05 * global_x over both blocks
    gx0 = np.arange(8)[:, None, None] * np.ones((8, 8, 8))
    gx1 = (np.arange(8) + 8)[:, None, None] * np.ones((8, 8, 8))
    m = m._replace(
        tsdf=m.tsdf.at[s0].set(jnp.asarray(0.05 * gx0, jnp.float32))
        .at[s1].set(jnp.asarray(0.05 * gx1, jnp.float32)),
        weight=m.weight.at[s0].set(1.0).at[s1].set(1.0),
    )
    # sample at voxel-centre coords straddling x=8 boundary
    pts = jnp.asarray([[7.9, 4.0, 4.0], [8.1, 4.0, 4.0], [8.5, 4.0, 4.0]], jnp.float32)
    t, w = sample_trilinear(m, pts, BITS)
    want = 0.05 * (np.asarray(pts)[:, 0] - 0.5)
    np.testing.assert_allclose(np.asarray(t), want, atol=1e-5)
    np.testing.assert_allclose(np.asarray(w), 1.0)


def test_reset():
    m = make_block_map(CFG)
    m, _ = allocate(m, rand_coords(100, lim=20, seed=10), jnp.ones(100, bool), CFG)
    m = reset_block_map(m)
    assert int(m.num_blocks) == 0
    assert bool(jnp.all(m.bucket_keys == EMPTY_KEY))
    assert bool(jnp.all(m.tsdf == 1.0))


def test_allocate_jittable():
    cfg = CFG
    allocate_j = jax.jit(lambda m, c, v: allocate(m, c, v, cfg))
    m = make_block_map(cfg)
    coords = rand_coords(256, lim=40, seed=11)
    m, n = allocate_j(m, coords, jnp.ones(256, bool))
    _, found = lookup(m, coords, BITS)
    assert bool(jnp.all(found))
