"""Dense-volume fusion pipeline: the whole per-frame loop as ONE jitted step.

Re-designs ``TopFu::operator()`` (reference: tfusion/src/topfu.cpp:161-330).
The reference crosses the host/device boundary every ICP iteration (27-float
readback + OpenCV SVD, reference: projective_icp.cpp:43-62) and several times
per frame for debug downloads (reference: topfu.cpp:212-223, 284-288); here
preprocess -> ICP -> (conditional reset) -> integrate -> raycast compile into
a single XLA computation whose only host interaction is the returned state.

Frame-to-model structure matches the reference: the model maps fed to ICP are
the raycast of the TSDF from the previous estimated pose, not the previous
sensor frame (reference: topfu.cpp:307-309).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from topfusion.config import PipelineConfig
from topfusion.ops.depth import preprocess_depth
from topfusion.ops.normals import build_maps_pyramid, resize_points_normals
from topfusion.ops.icp import icp_track
from topfusion.ops.rendering import phong_shade
from topfusion.ops.tsdf_dense import (
    DenseVolume,
    make_dense_volume,
    make_color_volume,
    integrate_dense,
    integrate_color_dense,
    raycast_dense,
    sample_color_dense,
)


class DenseState(NamedTuple):
    """Carried fusion state (all device arrays; shapes static per config)."""

    tsdf: jnp.ndarray                 # [D0, D1, D2]
    weight: jnp.ndarray               # [D0, D1, D2]
    color: jnp.ndarray                # [D0, D1, D2, 3] (1-voxel dummy if off)
    T_wc: jnp.ndarray                 # (4, 4) current camera-to-world pose
    model_points: Tuple[jnp.ndarray, ...]   # world-space raycast pyramid
    model_normals: Tuple[jnp.ndarray, ...]
    frame: jnp.ndarray                # () int32
    resets: jnp.ndarray               # () int32 — tracking-failure resets


class StepAux(NamedTuple):
    ok: jnp.ndarray
    residual: jnp.ndarray
    num_inliers: jnp.ndarray
    was_reset: jnp.ndarray


class DensePipeline:
    """Stateless functional pipeline over a ``PipelineConfig``.

    Usage::

        pipe = DensePipeline(cfg)
        state = pipe.init()
        state, aux = pipe.step(state, depth_mm)   # jitted
    """

    def __init__(self, cfg: PipelineConfig):
        self.cfg = cfg
        self.step = jax.jit(self._step)
        self.step_rgb = jax.jit(self._step_rgb)

    def init(self) -> DenseState:
        cfg = self.cfg
        vol = make_dense_volume(cfg.dense)
        cam = cfg.camera
        levels = cfg.preproc.pyramid_levels
        mp, mn = [], []
        for level in range(levels):
            cl = cam.at_level(level)
            mp.append(jnp.zeros((cl.height, cl.width, 3), jnp.float32))
            mn.append(jnp.zeros((cl.height, cl.width, 3), jnp.float32))
        return DenseState(
            tsdf=vol.tsdf,
            weight=vol.weight,
            color=make_color_volume(cfg.dense, cfg.tsdf.use_color),
            T_wc=jnp.eye(4, dtype=jnp.float32),
            model_points=tuple(mp),
            model_normals=tuple(mn),
            frame=jnp.asarray(0, jnp.int32),
            resets=jnp.asarray(0, jnp.int32),
        )

    # ------------------------------------------------------------------
    def _step_rgb(
        self, state: DenseState, depth_mm: jnp.ndarray, rgb: jnp.ndarray
    ) -> Tuple[DenseState, StepAux]:
        # Fusion step that also fuses color (cfg.tsdf.use_color must be on;
        # the analogue of the Voxel_*_rgb trait variants, reference:
        # tfusion/include/tfusion/cuda/VoxelTypes.hpp:8-67).
        return self._step(state, depth_mm, rgb)

    def _step(
        self,
        state: DenseState,
        depth_mm: jnp.ndarray,
        rgb: jnp.ndarray | None = None,
    ) -> Tuple[DenseState, StepAux]:
        cfg = self.cfg
        cam = cfg.camera

        # Frontend (reference: topfu.cpp:166-198).
        raw_m, depth_pyr = preprocess_depth(depth_mm, cfg.preproc)
        cur_pts, cur_nrm = build_maps_pyramid(cam, depth_pyr)

        # Tracking (skipped on frame 0; reference: topfu.cpp:200-209).
        is_first = state.frame == 0
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

        # Tracking-failure reset (reference: topfu.cpp:263-264, reset at
        # :141-152): wipe the map, restart from identity, DISCARD the failed
        # frame (the reference returns without integrating), and make the
        # next frame take the frame-0 fast path — all selected in-graph so
        # the step stays one compiled computation.
        do_reset = (~ok) & bool(cfg.reset_on_failure)
        T_int = jnp.where(do_reset, jnp.eye(4, dtype=jnp.float32), T_new)
        vol = DenseVolume(
            tsdf=jnp.where(do_reset, 1.0, state.tsdf),
            weight=jnp.where(do_reset, 0.0, state.weight),
        )

        # Integration from the RAW metric depth (reference: topfu.cpp:281
        # passes dists_, which is raw depth in meters — see imgproc.cu:277).
        # An all-invalid depth image integrates nothing, which is how the
        # reset branch discards the failed frame.
        raw_eff = jnp.where(do_reset, 0.0, raw_m)
        vol = integrate_dense(vol, cam, cfg.tsdf, cfg.dense, T_int, raw_eff)

        color = state.color
        if cfg.tsdf.use_color and rgb is not None:
            color = jnp.where(do_reset, 0.0, color)
            color = integrate_color_dense(
                color, vol, cam, cfg.tsdf, cfg.dense, T_int, raw_eff, rgb
            )

        # Raycast for the next frame's model maps
        # (reference: topfu.cpp:306-309 CreateICPMaps + resize pyramid).
        # Depth-guided band around the just-fused depth when enabled.
        if cfg.raycast.guided:
            margin = cfg.icp.dist_threshold + 3.0 * cfg.tsdf.trunc_dist
            rc = raycast_dense(
                vol, cam, cfg.tsdf, cfg.dense, cfg.raycast, T_int,
                expected_depth=raw_eff,
                depth_margin=margin,
                max_steps=cfg.raycast.guided_max_steps,
            )
        else:
            rc = raycast_dense(vol, cam, cfg.tsdf, cfg.dense, cfg.raycast, T_int)
        mp = [rc.points]
        mn = [rc.normals]
        for _ in range(cfg.preproc.pyramid_levels - 1):
            # Fence each level (see ops/depth.py module doc on XLA
            # producer duplication across stencil fusions).
            p, n = jax.lax.optimization_barrier(
                resize_points_normals(mp[-1], mn[-1])
            )
            mp.append(p)
            mn.append(n)

        new_state = DenseState(
            tsdf=vol.tsdf,
            weight=vol.weight,
            color=color,
            T_wc=T_int,
            model_points=tuple(mp),
            model_normals=tuple(mn),
            frame=jnp.where(do_reset, 0, state.frame + 1),
            resets=state.resets + do_reset.astype(jnp.int32),
        )
        aux = StepAux(
            ok=ok,
            residual=icp.residual,
            num_inliers=icp.num_inliers,
            was_reset=do_reset,
        )
        return new_state, aux

    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnums=0)
    def render(self, state: DenseState) -> jnp.ndarray:
        """Shaded greyscale view from the current pose
        (reference: topfu.cpp:332-377 renderImage)."""
        cfg = self.cfg
        rc = raycast_dense(
            DenseVolume(state.tsdf, state.weight),
            cfg.camera,
            cfg.tsdf,
            cfg.dense,
            cfg.raycast,
            state.T_wc,
        )
        light = state.T_wc[:3, 3] + jnp.asarray([0.0, -1.0, -1.0])
        return phong_shade(rc.points, rc.normals, light, state.T_wc[:3, 3])

    # ------------------------------------------------------------------
    @functools.partial(jax.jit, static_argnums=0)
    def render_color(self, state: DenseState) -> jnp.ndarray:
        # Raycast color view (the RENDER_COLOUR_FROM_VOLUME mode of the
        # reference, VisualisationEngine.hpp:12-109).
        cfg = self.cfg
        rc = raycast_dense(
            DenseVolume(state.tsdf, state.weight),
            cfg.camera, cfg.tsdf, cfg.dense, cfg.raycast, state.T_wc,
        )
        origin = jnp.asarray(cfg.dense.origin, jnp.float32)
        pv = (rc.points - origin) / cfg.tsdf.voxel_size
        col = sample_color_dense(state.color, pv, state.color.shape[:3])
        col = jnp.where(rc.hit[..., None], col, 0.0)
        return (jnp.clip(col, 0.0, 1.0) * 255.0).astype(jnp.uint8)
