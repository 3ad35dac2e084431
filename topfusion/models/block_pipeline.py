"""Block-sparse fusion pipeline: voxel-hashed map, one jitted step per frame.

Same per-frame structure as models/pipeline.py (the reference's
TopFu::operator(), tfusion/src/topfu.cpp:161-330), with the InfiniTAM-side
backend: on-demand block allocation, visible-set maintenance,
gather/fuse/scatter integration and block-skipping raycast
(BASELINE.md config 2).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from topfusion.config import PipelineConfig
from topfusion.ops.depth import preprocess_depth
from topfusion.ops.normals import build_maps_pyramid, resize_points_normals
from topfusion.ops.icp import icp_track
from topfusion.ops.rendering import phong_shade, render_normals_rgb
from topfusion.ops.blockmap import BlockMap, make_block_map, reset_block_map
from topfusion.ops.tsdf_block import (
    allocate_from_depth,
    visible_blocks,
    visible_blocks_incremental,
    integrate_blocks,
    integrate_color_blocks,
    raycast_blocks,
    expected_depth_ranges,
)
from topfusion.ops.splat import splat_model_maps


class BlockState(NamedTuple):
    bucket_keys: jnp.ndarray
    bucket_slots: jnp.ndarray
    block_coords: jnp.ndarray
    tsdf: jnp.ndarray
    weight: jnp.ndarray
    num_blocks: jnp.ndarray
    color: jnp.ndarray          # [C+1,B,B,B,3] or [1,1,1,1,3] dummy
    T_wc: jnp.ndarray
    model_points: Tuple[jnp.ndarray, ...]
    model_normals: Tuple[jnp.ndarray, ...]
    frame: jnp.ndarray
    resets: jnp.ndarray
    # Last frame's visible slots ([max_visible_blocks] int32, -1 = empty):
    # the aged set that visible_blocks_incremental re-checks instead of
    # scanning the whole pool (reference: setToType3 aging,
    # SceneReconstructionEngine_host.cu:343-348).
    vis_slots: jnp.ndarray

    def block_map(self) -> BlockMap:
        return BlockMap(
            bucket_keys=self.bucket_keys,
            bucket_slots=self.bucket_slots,
            block_coords=self.block_coords,
            tsdf=self.tsdf,
            weight=self.weight,
            num_blocks=self.num_blocks,
            color=self.color,
        )


class BlockStepAux(NamedTuple):
    ok: jnp.ndarray
    residual: jnp.ndarray
    num_inliers: jnp.ndarray
    was_reset: jnp.ndarray
    num_blocks: jnp.ndarray
    blocks_allocated: jnp.ndarray
    num_visible: jnp.ndarray
    # New unique blocks rejected by the per-frame bound or POOL
    # EXHAUSTION this frame — the capacity-pressure signal (reference
    # silently restores the free-list counter,
    # SceneReconstructionEngine_host.cu:374-381).  W-way bucket-overflow
    # drops are excluded: they self-heal next frame (AllocInfo separates
    # the two causes).
    blocks_dropped: jnp.ndarray
    # Frustum-visible ALREADY-ALLOCATED blocks truncated by the
    # max_visible_blocks bound this frame (they exist in the pool but are
    # skipped by integrate/splat) — the other silent-under-integration
    # signal: blocks_dropped covers alloc-time rejects, this covers
    # visibility-time truncation on over-dense scenes (round-4 VERDICT
    # weak #4; tests/test_visible_overflow.py).
    visible_overflow: jnp.ndarray


class BlockPipeline:
    """Stateless functional block-sparse pipeline (see DensePipeline)."""

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.step = jax.jit(self._step)
        self.step_rgb = jax.jit(self._step_rgb)

    def init(self) -> BlockState:
        cfg = self.cfg
        m = make_block_map(cfg.blockmap, use_color=cfg.tsdf.use_color)
        cam = cfg.camera
        mp, mn = [], []
        for level in range(cfg.preproc.pyramid_levels):
            cl = cam.at_level(level)
            mp.append(jnp.zeros((cl.height, cl.width, 3), jnp.float32))
            mn.append(jnp.zeros((cl.height, cl.width, 3), jnp.float32))
        return BlockState(
            *m,
            T_wc=jnp.eye(4, dtype=jnp.float32),
            model_points=tuple(mp),
            model_normals=tuple(mn),
            frame=jnp.asarray(0, jnp.int32),
            resets=jnp.asarray(0, jnp.int32),
            vis_slots=jnp.full(
                (cfg.blockmap.max_visible_blocks,), -1, jnp.int32
            ),
        )

    # ------------------------------------------------------------------
    @staticmethod
    def write_map(state: BlockState, m: BlockMap) -> BlockState:
        """Replace the map fields of a state (the out-of-core swap layer
        mutates the map between steps; models/host_cache.py)."""
        return state._replace(
            bucket_keys=m.bucket_keys,
            bucket_slots=m.bucket_slots,
            block_coords=m.block_coords,
            tsdf=m.tsdf,
            weight=m.weight,
            num_blocks=m.num_blocks,
            color=m.color,
        )

    # ------------------------------------------------------------------
    def _step_rgb(
        self, state: BlockState, depth_mm: jnp.ndarray, rgb: jnp.ndarray
    ) -> Tuple[BlockState, BlockStepAux]:
        # Fusion step that also fuses color into the hashed map
        # (cfg.tsdf.use_color must be on; the hashed-map analogue of the
        # Voxel_s_rgb trait, reference: VoxelTypes.hpp:8-67).
        return self._step(state, depth_mm, rgb)

    # ------------------------------------------------------------------
    def _step(
        self,
        state: BlockState,
        depth_mm: jnp.ndarray,
        rgb: jnp.ndarray | None = None,
    ) -> Tuple[BlockState, BlockStepAux]:
        cfg = self.cfg
        cam = cfg.camera

        with jax.named_scope("preprocess"):
            raw_m, depth_pyr = preprocess_depth(depth_mm, cfg.preproc)
            cur_pts, cur_nrm = build_maps_pyramid(cam, depth_pyr)

        is_first = state.frame == 0
        with jax.named_scope("icp"):
            icp = icp_track(
                cam,
                cfg.icp,
                state.T_wc,
                state.T_wc,
                cur_pts,
                cur_nrm,
                list(state.model_points),
                list(state.model_normals),
            )
        ok = icp.ok | is_first
        T_new = jnp.where(is_first, state.T_wc, icp.T_wc)

        do_reset = (~ok) & bool(cfg.reset_on_failure)
        T_int = jnp.where(do_reset, jnp.eye(4, dtype=jnp.float32), T_new)
        m = state.block_map()
        m_clean = reset_block_map(m)
        m = jax.tree.map(lambda a, b: jnp.where(do_reset, b, a), m, m_clean)

        # Discard the failed frame (reference: topfu.cpp:263-264 returns
        # after reset); an all-invalid depth allocates and fuses nothing.
        raw_eff = jnp.where(do_reset, 0.0, raw_m)

        # Allocation + visible set + integration
        # (reference: topfu.cpp:281-282).
        with jax.named_scope("allocate"):
            m, ainfo = allocate_from_depth(
                m, cam, cfg.tsdf, cfg.blockmap, T_int, raw_eff,
                return_touched=True,
            )
        n_alloc = ainfo.n_inserted
        d_cull = raw_eff if cfg.blockmap.visible_occlusion_cull else None
        with jax.named_scope("visible"):
            if cfg.blockmap.visible_aging:
                # Aged visible set: last frame's list (wiped on reset) +
                # this frame's allocation-touched blocks —
                # O(visible+touched) instead of O(capacity).  Every N-th
                # frame a full rescan refreshes it (lax.cond — one branch
                # executes), catching blocks that re-entered the frustum
                # unobserved.
                prev = jnp.where(do_reset, -1, state.vis_slots)
                n_rescan = max(cfg.blockmap.visible_rescan_every, 1)
                *vis, vis_overflow = lax.cond(
                    (state.frame % n_rescan == 0) | do_reset,
                    lambda: visible_blocks(
                        m, cam, cfg.tsdf, cfg.blockmap, T_int,
                        return_overflow=True, depth=d_cull,
                    ),
                    lambda: visible_blocks_incremental(
                        m, cam, cfg.tsdf, cfg.blockmap, T_int,
                        prev, ainfo.touched_slots, return_overflow=True,
                        depth=d_cull,
                    ),
                )
                vis = tuple(vis)
            else:
                *vis, vis_overflow = visible_blocks(
                    m, cam, cfg.tsdf, cfg.blockmap, T_int,
                    return_overflow=True, depth=d_cull,
                )
                vis = tuple(vis)
        with jax.named_scope("integrate"):
            m, n_vis = integrate_blocks(
                m, cam, cfg.tsdf, cfg.blockmap, T_int, raw_eff, vis
            )
            if cfg.tsdf.use_color and rgb is not None:
                m = integrate_color_blocks(
                    m, cam, cfg.tsdf, cfg.blockmap, T_int, raw_eff, rgb, vis
                )

        # Model maps for the next frame (reference: topfu.cpp:306-309
        # CreateICPMaps).  Default: forward-projection splatting of the
        # visible surface voxels (scatter-shaped; ops/splat.py).  The
        # guided sphere march remains as the gather-shaped alternative.
        with jax.named_scope("model_maps"):
            if cfg.raycast.model_maps == "splat":
                rc = splat_model_maps(
                    m, cam, cfg.tsdf, cfg.blockmap, T_int, vis,
                    surfels_per_block=cfg.raycast.surfels_per_block,
                    dilate_passes=cfg.raycast.dilate_passes,
                )
            elif cfg.raycast.guided:
                margin = cfg.icp.dist_threshold + 3.0 * cfg.tsdf.trunc_dist
                rc = raycast_blocks(
                    m, cam, cfg.tsdf, cfg.blockmap, cfg.raycast, T_int,
                    expected_depth=raw_eff,
                    depth_margin=margin,
                    max_steps=cfg.raycast.guided_max_steps,
                )
            else:
                rc = raycast_blocks(
                    m, cam, cfg.tsdf, cfg.blockmap, cfg.raycast, T_int
                )
        with jax.named_scope("pyramid"):
            mp = [rc.points]
            mn = [rc.normals]
            for _ in range(cfg.preproc.pyramid_levels - 1):
                # Fence each level: keeps XLA from re-deriving level L-1
                # inside every quad tap of level L (ops/depth.py module doc).
                p, n = jax.lax.optimization_barrier(
                    resize_points_normals(mp[-1], mn[-1])
                )
                mp.append(p)
                mn.append(n)

        new_state = BlockState(
            *m,
            T_wc=T_int,
            model_points=tuple(mp),
            model_normals=tuple(mn),
            frame=jnp.where(do_reset, 0, state.frame + 1),
            resets=state.resets + do_reset.astype(jnp.int32),
            vis_slots=vis[0],
        )
        aux = BlockStepAux(
            ok=ok,
            residual=icp.residual,
            num_inliers=icp.num_inliers,
            was_reset=do_reset,
            num_blocks=m.num_blocks,
            blocks_allocated=n_alloc,
            num_visible=n_vis,
            blocks_dropped=ainfo.n_dropped_capacity,
            visible_overflow=vis_overflow,
        )
        return new_state, aux

    # ------------------------------------------------------------------
    def _free_view_raycast(self, state: BlockState, T_wc: jnp.ndarray):
        """Raycast from an arbitrary pose, accelerated by expected-depth
        ranges (reference: CreateExpectedDepths before every RenderImage,
        topfu.cpp:306 + VisualisationEngine_CUDA.cu:119-173)."""
        cfg = self.cfg
        m = state.block_map()
        vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc)
        ranges = expected_depth_ranges(
            m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc, vis,
            subsample=cfg.raycast.range_subsample,
        )
        return raycast_blocks(
            m, cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast, T_wc,
            range_image=ranges,
            max_steps=cfg.raycast.ranged_max_steps,
        )

    # ------------------------------------------------------------------
    def _render_impl(self, state: BlockState, T_wc: jnp.ndarray) -> jnp.ndarray:
        """Unjitted display-render body (shared by the standalone jitted
        ``render`` and callers that fold it into a larger dispatch, e.g.
        the SLAM chunk)."""
        rc = self._free_view_raycast(state, T_wc)
        light = T_wc[:3, 3] + jnp.asarray([0.0, -1.0, -1.0])
        return phong_shade(rc.points, rc.normals, light, T_wc[:3, 3])

    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnums=0)
    def render(self, state: BlockState, T_wc: jnp.ndarray | None = None) -> jnp.ndarray:
        T = state.T_wc if T_wc is None else T_wc
        return self._render_impl(state, T)

    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnums=0)
    def render_normals(self, state: BlockState) -> jnp.ndarray:
        # RENDER_COLOUR_FROM_NORMAL analogue
        # (reference: VisualisationEngine.hpp render types).
        rc = self._free_view_raycast(state, state.T_wc)
        return render_normals_rgb(rc.normals)

    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnums=0)
    def render_confidence(self, state: BlockState) -> jnp.ndarray:
        # RENDER_COLOUR_FROM_CONFIDENCE analogue: fusion weight, green
        # (confident) -> red (fresh), reference pixel shader
        # VisualisationEngine_Shared.hpp:272-498 drawPixelConfidence.
        from topfusion.ops.rendering import render_confidence_rgb

        cfg = self.cfg
        rc = self._free_view_raycast(state, state.T_wc)
        return render_confidence_rgb(
            rc.confidence, rc.hit, cfg.tsdf.max_weight
        )

    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnums=0)
    def render_color(self, state: BlockState) -> jnp.ndarray:
        # RENDER_COLOUR_FROM_VOLUME analogue on the hashed map
        # (reference: VisualisationEngine.hpp render types +
        # VoxelColorReader, RepresentationAccess.hpp:455-474).
        from topfusion.ops.blockmap import read_color_nearest

        cfg = self.cfg
        rc = self._free_view_raycast(state, state.T_wc)
        vox = jnp.floor(rc.points / cfg.tsdf.voxel_size).astype(jnp.int32)
        c = read_color_nearest(
            state.block_map(), vox, cfg.blockmap.coord_bits
        )
        img = jnp.where(rc.hit[..., None], c, 0.0)
        return jnp.clip(img * 255.0, 0.0, 255.0).astype(jnp.uint8)
