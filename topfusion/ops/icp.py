"""Projective point-to-plane ICP, frame-to-model, fully in-graph.

A re-design of the reference tracker
(reference: tfusion/src/projective_icp.cpp:169-213,
tfusion/src/cuda/proj_icp.cu:80-403):

* The reference builds the 6x6 normal equations with a hand-written
  two-stage warp/block tree reduction over 27 upper-triangular products
  and reads 27 floats back to the host EVERY iteration, solving with
  OpenCV SVD (reference: projective_icp.cpp:43-62, 205).  Here each
  gated correspondence contributes a row ``[J | r]`` (7 floats) and the
  full system is one Gram matmul ``G = rows^T rows``; the 6x6
  solve happens in-graph with ``jnp.linalg.solve`` plus Levenberg
  damping, so the entire coarse-to-fine schedule compiles into a single
  XLA computation with zero host syncs.
* Correspondence gates match the reference: valid maps, in-frustum
  projection, distance <= 0.1 m, normal angle <= 30 deg
  (reference: proj_icp.cu:80-117 find_coresp).
* Incremental update is a proper SE(3) exponential rather than the
  reference's Euler-angle compose (reference: projective_icp.cpp:205-209).

Conventions: ``T_wc`` maps camera -> world.  Model (previous raycast)
maps are in WORLD space together with the pose they were raycast from,
matching the reference's CreateICPMaps output
(reference: tfusion/src/cuda/VisualisationEngine_CUDA.cu:323-360).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax

from topfusion.config import CameraConfig, ICPConfig
from topfusion.geometry.se3 import (
    HIGHEST,
    mat_mul,
    se3_exp,
    se3_inverse,
    transform_points,
    rotate_vectors,
)
from topfusion.geometry.camera import project
from topfusion.ops.gather_mm import banded_projective_gather


class ICPResult(NamedTuple):
    T_wc: jnp.ndarray          # (4, 4) estimated camera-to-world pose
    ok: jnp.ndarray            # () bool — tracking success
    residual: jnp.ndarray      # () mean |r| over inliers at final iter
    num_inliers: jnp.ndarray   # () int32 at final iter
    # () f32 observability: lambda_min / lambda_max of the final
    # (undamped) 6x6 JtJ.  ~1e-7 on rank-deficient geometry (a bare
    # wall: translation along it unobserved), ~1e-3+ on well-constrained
    # scenes — loop-closure verification gates on it so degenerate
    # geometry cannot "verify" a false loop (models/posegraph.py).
    obs_ratio: jnp.ndarray


def build_normal_equations(
    cam: CameraConfig,
    T_est: jnp.ndarray,
    T_model: jnp.ndarray,
    curr_points: jnp.ndarray,
    curr_normals: jnp.ndarray,
    model_points: jnp.ndarray,
    model_normals: jnp.ndarray,
    dist_thresh: float,
    angle_cos_thresh: float,
    bilinear: bool = False,
    gather_mode: str = "take",
    onehot_v_margin: int = 32,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """One projective-association pass -> 7x7 Gram matrix + inlier count.

    Returns ``(G, count)`` where ``G[:6, :6] = JtJ``, ``G[:6, 6] = Jtr``,
    ``G[6, 6] = r^T r``.
    """
    h, w = model_points.shape[:2]
    curr_valid = jnp.any(curr_points != 0.0, axis=-1)

    # Current-frame points/normals into world via the pose estimate.
    p_w = transform_points(T_est, curr_points)
    n_w = rotate_vectors(T_est, curr_normals)

    # Project into the model (previous raycast) camera.
    T_cw_model = se3_inverse(T_model)
    p_model_cam = transform_points(T_cw_model, p_w)
    uv, z = project(cam, p_model_cam)
    uf, vf = uv[..., 0], uv[..., 1]
    in_bounds = (uf >= 0.0) & (uf <= w - 1.0) & (vf >= 0.0) & (vf <= h - 1.0) & (z > 0.0)

    if gather_mode == "flat" and bilinear:
        # Sub-pixel bilinear association on the flat row-gather path: the
        # quad is four 8-channel ROW gathers of the packed map (~10x
        # cheaper per value than element gathers; docs/PERFORMANCE.md) +
        # an in-register lerp.  Quad usable only if all four corners are
        # valid, else nearest corner — same semantics as the take-mode
        # bilinear branch below, measured ~6x faster at VGA.
        u0 = jnp.clip(jnp.floor(uf).astype(jnp.int32), 0, w - 2)
        v0 = jnp.clip(jnp.floor(vf).astype(jnp.int32), 0, h - 2)
        fu = jnp.clip(uf - u0.astype(uf.dtype), 0.0, 1.0)[..., None]
        fv = jnp.clip(vf - v0.astype(vf.dtype), 0.0, 1.0)[..., None]
        cat = jnp.concatenate(
            [
                model_points,
                model_normals,
                jnp.zeros(model_points.shape[:-1] + (2,), model_points.dtype),
            ],
            axis=-1,
        ).reshape(h * w, 8)
        base = v0 * w + u0
        # ONE gather of all four corners (stacked indices): four separate
        # gather ops each pay the per-op floor; one 4x-volume row gather
        # streams at row-gather speed.
        quad_idx = jnp.stack(
            [base, base + 1, base + w, base + w + 1], axis=-1
        )  # [..., 4]
        quad = cat[quad_idx]                      # [..., 4, 8]
        g00 = quad[..., 0, :]
        g01 = quad[..., 1, :]
        g10 = quad[..., 2, :]
        g11 = quad[..., 3, :]

        def pvalid(g):
            return jnp.any(g[..., :3] != 0.0, axis=-1)

        all_valid = pvalid(g00) & pvalid(g01) & pvalid(g10) & pvalid(g11)
        lerped = (
            g00 * (1 - fu) * (1 - fv)
            + g01 * fu * (1 - fv)
            + g10 * (1 - fu) * fv
            + g11 * fu * fv
        )
        # Nearest corner from the already-gathered quad (no extra gather).
        right = fu[..., 0] > 0.5
        down = fv[..., 0] > 0.5
        near = jnp.where(
            down[..., None],
            jnp.where(right[..., None], g11, g10),
            jnp.where(right[..., None], g01, g00),
        )
        gathered = jnp.where(all_valid[..., None], lerped, near)
        q_w = gathered[..., :3]
        nq_w = gathered[..., 3:6]
        nq_norm = jnp.linalg.norm(nq_w, axis=-1, keepdims=True)
        nq_w = nq_w / jnp.maximum(nq_norm, 1e-12)
        model_valid = jnp.any(q_w != 0.0, axis=-1) & (nq_norm[..., 0] > 1e-6)
    elif bilinear:
        # Sub-pixel bilinear gather of the model maps (the reference gathers
        # prev maps through CUDA textures at integer coords,
        # proj_icp.cu:409-412).  A quad is usable only if all four corners
        # are valid; otherwise fall back to the nearest corner.
        u0 = jnp.clip(jnp.floor(uf).astype(jnp.int32), 0, w - 2)
        v0 = jnp.clip(jnp.floor(vf).astype(jnp.int32), 0, h - 2)
        fu = jnp.clip(uf - u0.astype(uf.dtype), 0.0, 1.0)[..., None]
        fv = jnp.clip(vf - v0.astype(vf.dtype), 0.0, 1.0)[..., None]

        def corners(m):
            return (m[v0, u0], m[v0, u0 + 1], m[v0 + 1, u0], m[v0 + 1, u0 + 1])

        q00, q01, q10, q11 = corners(model_points)
        n00, n01, n10, n11 = corners(model_normals)
        all_valid = (
            jnp.any(q00 != 0.0, axis=-1)
            & jnp.any(q01 != 0.0, axis=-1)
            & jnp.any(q10 != 0.0, axis=-1)
            & jnp.any(q11 != 0.0, axis=-1)
        )

        def lerp(a00, a01, a10, a11):
            return (
                a00 * (1 - fu) * (1 - fv)
                + a01 * fu * (1 - fv)
                + a10 * (1 - fu) * fv
                + a11 * fu * fv
            )

        # Nearest-corner fallback.
        un = jnp.clip(jnp.round(uf).astype(jnp.int32), 0, w - 1)
        vn = jnp.clip(jnp.round(vf).astype(jnp.int32), 0, h - 1)
        q_near = model_points[vn, un]
        n_near = model_normals[vn, un]

        q_w = jnp.where(all_valid[..., None], lerp(q00, q01, q10, q11), q_near)
        nq_w = jnp.where(all_valid[..., None], lerp(n00, n01, n10, n11), n_near)
        nq_norm = jnp.linalg.norm(nq_w, axis=-1, keepdims=True)
        nq_w = nq_w / jnp.maximum(nq_norm, 1e-12)
        model_valid = jnp.any(q_w != 0.0, axis=-1) & (nq_norm[..., 0] > 1e-6)
    elif gather_mode == "flat":
        # Flattened 8-channel-aligned row gather: padding 6ch -> 8ch makes
        # each gathered row a power-of-two 32 B stride (chosen on the
        # accelerator this was first tuned on; not yet re-measured on the
        # GPU).  Exact (no band drop).
        un = jnp.clip(jnp.round(uf).astype(jnp.int32), 0, w - 1)
        vn = jnp.clip(jnp.round(vf).astype(jnp.int32), 0, h - 1)
        cat = jnp.concatenate(
            [
                model_points,
                model_normals,
                jnp.zeros(model_points.shape[:-1] + (2,), model_points.dtype),
            ],
            axis=-1,
        ).reshape(h * w, 8)
        gathered = cat[vn * w + un]
        q_w = gathered[..., :3]
        nq_w = gathered[..., 3:6]
        model_valid = jnp.any(q_w != 0.0, axis=-1)
    elif gather_mode == "onehot":
        # Banded one-hot matmul gather (see ops/gather_mm.py): both
        # maps in one pass via channel concatenation.  Correspondences
        # vertically displaced beyond the band margin are dropped — the
        # projective-locality bound that makes the gather matmul-shaped.
        un = jnp.round(uf).astype(jnp.int32)
        vn = jnp.round(vf).astype(jnp.int32)
        cat = jnp.concatenate([model_points, model_normals], axis=-1)
        gathered, band_ok = banded_projective_gather(
            cat, un, vn, v_margin=onehot_v_margin
        )
        q_w = gathered[..., :3]
        nq_w = gathered[..., 3:]
        model_valid = band_ok & jnp.any(q_w != 0.0, axis=-1)
    else:
        un = jnp.clip(jnp.round(uf).astype(jnp.int32), 0, w - 1)
        vn = jnp.clip(jnp.round(vf).astype(jnp.int32), 0, h - 1)
        q_w = model_points[vn, un]
        nq_w = model_normals[vn, un]
        model_valid = jnp.any(q_w != 0.0, axis=-1)

    diff = p_w - q_w
    dist2 = jnp.sum(diff * diff, axis=-1)
    angle_cos = jnp.sum(nq_w * n_w, axis=-1)

    mask = (
        curr_valid
        & in_bounds
        & model_valid
        & (dist2 <= dist_thresh * dist_thresh)
        & (angle_cos >= angle_cos_thresh)
    )

    r = jnp.sum(nq_w * diff, axis=-1)
    j_omega = jnp.cross(p_w, nq_w)
    rows = jnp.concatenate(
        [j_omega, nq_w, r[..., None]], axis=-1
    )  # [H, W, 7]
    rows = jnp.where(mask[..., None], rows, 0.0).reshape(-1, 7)

    # One matmul builds JtJ, Jtr and r^T r simultaneously.  HIGHEST: the
    # pose and the min_det gate read this Gram matrix, and a TF32 product
    # (about 3 digits) is far too coarse for them.
    G = jnp.dot(
        rows.T, rows, preferred_element_type=jnp.float32, precision=HIGHEST
    )
    count = jnp.sum(mask.astype(jnp.int32))
    return G, count


def _solve_increment(
    G: jnp.ndarray,
    count: jnp.ndarray,
    cfg: ICPConfig,
    min_corresp: int | None = None,
) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """6x6 damped solve -> (twist xi, ok flag).

    ``min_corresp`` overrides the config gate — coarse pyramid levels
    carry 4x fewer pixels per level, so the caller scales the count gate
    with level area (an absolute gate tuned for the finest level spuriously
    fails the coarsest one on scenes with sparse model coverage; the
    reference gates only on singularity, projective_icp.cpp:197-203).
    """
    A = G[:6, :6]
    b = -G[:6, 6]
    A_damped = A + cfg.damping * jnp.diag(jnp.diag(A)) + 1e-12 * jnp.eye(6)
    det = jnp.linalg.det(A_damped)
    xi = jnp.linalg.solve(A_damped, b)
    finite = jnp.all(jnp.isfinite(xi))
    ok = (
        (jnp.abs(det) > cfg.min_det)
        & (count >= (cfg.min_corresp if min_corresp is None else min_corresp))
        & finite
    )
    xi = jnp.where(ok & finite, xi, 0.0)
    return xi, ok


def icp_track(
    cam0: CameraConfig,
    cfg: ICPConfig,
    T_init: jnp.ndarray,
    T_model: jnp.ndarray,
    curr_points_pyr: List[jnp.ndarray],
    curr_normals_pyr: List[jnp.ndarray],
    model_points_pyr: List[jnp.ndarray],
    model_normals_pyr: List[jnp.ndarray],
    axis_name: str | None = None,
) -> ICPResult:
    """Coarse-to-fine frame-to-model tracking.

    Level schedule mirrors the reference (coarsest first, iteration counts
    from ``cfg.iters``; reference: projective_icp.cpp:177-186).  The level
    loop is a static Python loop (per-level shapes differ); iterations are
    a ``lax.fori_loop`` carrying the pose estimate.

    With ``axis_name`` set, each device contributes the normal equations
    of its own slice of current-frame rows and the 7x7 Gram matrix is
    ``psum``-reduced before the solve — the multi-device data-parallel
    analogue of the reference's single-GPU two-stage reduction
    (reference: proj_icp.cu:120-403).
    """
    T_est = T_init
    ok_all = jnp.asarray(True)
    residual = jnp.asarray(0.0, jnp.float32)
    inliers = jnp.asarray(0, jnp.int32)
    G_last = jnp.zeros((7, 7), jnp.float32)

    n_levels = len(curr_points_pyr)
    for level in range(n_levels - 1, -1, -1):
        iters = cfg.iters[level] if level < len(cfg.iters) else 0
        if iters == 0:
            continue
        cam_l = cam0.at_level(level)
        cp, cn = curr_points_pyr[level], curr_normals_pyr[level]
        mp, mn = model_points_pyr[level], model_normals_pyr[level]
        if level == 0 and cfg.level0_stride > 1:
            # Subsample the ROWS of the system (current-frame pixels); the
            # model maps stay full-res for association accuracy.
            st = cfg.level0_stride
            cp, cn = cp[::st, ::st], cn[::st, ::st]

        def make_body(bilinear_l):
            def body(_, carry):
                T, ok, _res, _cnt, _G = carry
                G, count = build_normal_equations(
                    cam_l, T, T_model, cp, cn, mp, mn,
                    cfg.dist_threshold, cfg.angle_threshold_cos,
                    bilinear=bilinear_l,
                    gather_mode=cfg.gather_mode,
                    onehot_v_margin=cfg.onehot_v_margin,
                )
                if axis_name is not None:
                    G = lax.psum(G, axis_name)
                    count = lax.psum(count, axis_name)
                xi, step_ok = _solve_increment(
                    G, count, cfg,
                    min_corresp=max(8, cfg.min_corresp // 4 ** level),
                )
                T_new = mat_mul(se3_exp(xi), T)
                T = jnp.where(step_ok, T_new, T)
                res = jnp.sqrt(
                    G[6, 6] / jnp.maximum(count, 1).astype(jnp.float32)
                )
                # Tracking health is the LAST iteration's gate, not an
                # AND over the schedule: a rejected step freezes the pose
                # (line above) and later iterations routinely recover —
                # e.g. first-iteration association starvation at a coarse
                # level under fast motion.  The reference aborts on the
                # first singular system (projective_icp.cpp:197-203);
                # judging the converged state is strictly more robust and
                # still fails garbage frames (their final count is 0).
                del ok
                return T, step_ok, res, count, G

            return body

        # Polish: the last N finest-level iterations associate bilinearly
        # (sub-pixel); everything else nearest (see ICPConfig).
        polish = (
            min(cfg.bilinear_polish_iters, iters)
            if (level == 0 and not cfg.bilinear)
            else 0
        )
        carry = (T_est, ok_all, residual, inliers, G_last)
        carry = lax.fori_loop(
            0, iters - polish, make_body(cfg.bilinear), carry
        )
        if polish:
            ps = cfg.polish_stride
            # Polish rows subsampled further: sub-pixel association
            # quality is per-row; the 6x6 system stays massively
            # over-determined at 1/16 of VGA rows.  Only worth it while
            # the subsampled system keeps plenty of rows — on small
            # frames (tests, coarse dryruns) the extra stride would
            # starve the min_corresp gate, so it is statically skipped.
            if ps > 1 and (cp.shape[0] // ps) * (cp.shape[1] // ps) >= 4096:
                cp, cn = cp[::ps, ::ps], cn[::ps, ::ps]
            else:
                ps = 1
            carry = lax.fori_loop(0, polish, make_body(True), carry)
            T, ok, res, cnt, G = carry
            # Report inliers at pre-polish row density: downstream gates
            # (keyframe/loop verification, posegraph.py) are calibrated
            # against level0_stride-density counts.
            carry = (T, ok, res, cnt * (ps * ps), G)
        T_est, ok_all, residual, inliers, G_last = carry

    eig = jnp.linalg.eigvalsh(G_last[:6, :6])
    obs_ratio = jnp.maximum(eig[0], 0.0) / jnp.maximum(eig[5], 1e-20)
    return ICPResult(
        T_wc=T_est, ok=ok_all, residual=residual, num_inliers=inliers,
        obs_ratio=obs_ratio,
    )
