"""One-hot-matmul gather: bit-exactness vs fancy indexing."""

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.ops.gather_mm import banded_projective_gather


def make_map(H, W, C, seed=0):
    rng = np.random.default_rng(seed)
    return jnp.asarray(rng.normal(size=(H, W, C)).astype(np.float32))


def test_exact_in_band():
    H, W, C = 64, 80, 6
    model = make_map(H, W, C)
    h, w = 32, 40  # stride-2 query grid
    rng = np.random.default_rng(1)
    # queries near their nominal row (2*i) within +-10
    vi = (2 * np.arange(h))[:, None] + rng.integers(-10, 10, size=(h, w))
    ui = rng.integers(0, W, size=(h, w))
    vi = np.clip(vi, 0, H - 1)
    out, ok = banded_projective_gather(
        model, jnp.asarray(ui, jnp.int32), jnp.asarray(vi, jnp.int32),
        v_margin=16,
    )
    out, ok = np.asarray(out), np.asarray(ok)
    want = np.asarray(model)[vi, ui]
    assert ok.all()
    np.testing.assert_array_equal(out, want)  # EXACT


def test_out_of_band_flagged():
    H, W, C = 64, 80, 3
    model = make_map(H, W, C)
    h, w = 32, 40
    vi = np.full((h, w), 0)       # all queries at row 0 -> far from lower tiles
    ui = np.full((h, w), 5)
    out, ok = banded_projective_gather(
        model, jnp.asarray(ui, jnp.int32), jnp.asarray(vi, jnp.int32),
        v_margin=8,
    )
    ok = np.asarray(ok)
    # top tile in band, bottom tiles out of band
    assert ok[0].all()
    assert not ok[-1].any()
    assert np.all(np.asarray(out)[~ok] == 0.0)


def test_out_of_range_indices():
    H, W, C = 32, 48, 2
    model = make_map(H, W, C)
    h, w = 32, 48
    vi = np.arange(h)[:, None] + np.zeros((h, w), int)
    ui = np.tile(np.arange(w), (h, 1))
    vi[0, 0] = -3
    ui[1, 1] = 1000
    out, ok = banded_projective_gather(
        model, jnp.asarray(ui, jnp.int32), jnp.asarray(vi, jnp.int32),
        v_margin=8,
    )
    ok = np.asarray(ok)
    assert not ok[0, 0] and not ok[1, 1]
    good = np.asarray(model)[np.clip(vi, 0, H-1), np.clip(ui, 0, W-1)]
    np.testing.assert_array_equal(np.asarray(out)[ok], good[ok])


def test_full_res_query_grid():
    H, W, C = 48, 64, 6
    model = make_map(H, W, C, seed=3)
    rng = np.random.default_rng(4)
    vi = np.arange(H)[:, None] + rng.integers(-6, 6, size=(H, W))
    vi = np.clip(vi, 0, H - 1)
    ui = rng.integers(0, W, size=(H, W))
    out, ok = banded_projective_gather(
        model, jnp.asarray(ui, jnp.int32), jnp.asarray(vi, jnp.int32),
        v_margin=12,
    )
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), np.asarray(model)[vi, ui])
