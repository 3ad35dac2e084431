"""Visible-set truncation must be OBSERVABLE (round-4 VERDICT weak #4).

``max_visible_blocks`` bounds the per-frame gather/scatter working set;
an over-dense scene (desk-density clutter, small voxels) can allocate
more frustum-visible blocks than the bound, and integrate/splat then
silently skip the overflow.  ``BlockStepAux.visible_overflow`` counts
those truncated ALREADY-ALLOCATED blocks (``blocks_dropped`` only covers
alloc-time rejects — the reference's analogous silent spot is the
visible-list cap at SDF_LOCAL_BLOCK_NUM, reference:
SceneReconstructionEngine_host.cu:434-479).
"""

import dataclasses

import jax.numpy as jnp

from topfusion.config import tiny_test_config
from topfusion.io.synthetic import SyntheticScene
from topfusion.models.block_pipeline import BlockPipeline
from topfusion.ops.blockmap import decode_weight


def _cfg(v_max: int):
    cfg = tiny_test_config()
    # 5 mm voxels on the tiny frustum -> a dense block band; the frame's
    # visible set far exceeds a 64-block bound.
    return dataclasses.replace(
        cfg,
        tsdf=dataclasses.replace(cfg.tsdf, voxel_size=0.005,
                                 trunc_dist=0.02),
        blockmap=dataclasses.replace(
            cfg.blockmap,
            capacity=1 << 13,
            max_new_blocks_per_frame=4096,
            max_visible_blocks=v_max,
        ),
    )


def _run(v_max: int, n_frames: int = 3):
    cfg = _cfg(v_max)
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    scene = SyntheticScene()
    depth = scene.render_depth_mm(cfg.camera, jnp.eye(4))
    overflow = 0
    for _ in range(n_frames):
        state, aux = pipe.step(state, depth)
        overflow = max(overflow, int(aux.visible_overflow))
    return state, aux, overflow


def test_overflow_counter_fires_on_saturated_bound():
    state, aux, overflow = _run(v_max=64)
    assert int(aux.num_blocks) > 64, "scene not dense enough to saturate"
    # The bound is saturated AND the counter reports the truncation.
    assert int(aux.num_visible) == 64
    assert overflow > 0


def test_raising_bound_clears_overflow_and_restores_coverage():
    st_small, aux_small, _ = _run(v_max=64)
    st_big, aux_big, ovf_big = _run(v_max=1 << 12)
    assert ovf_big == 0, "generous bound must not truncate"
    # Every allocated block in the static frustum is visible again...
    assert int(aux_big.num_visible) > int(aux_small.num_visible)
    # ...and integration coverage is restored: the truncated run's fused
    # weight mass is capped by its 64-block working set.
    w_small = float(jnp.sum(decode_weight(st_small.weight)))
    w_big = float(jnp.sum(decode_weight(st_big.weight)))
    assert w_big > 2.0 * w_small
