"""Scalable BA: block-sparse PCG solver vs the dense reference, at scale.

The dense [6K, 6K] solve (models/posegraph.optimize, solver="dense") is
the exact-semantics reference but materializes H and runs a whole-graph
jacfwd — quadratic in K.  The PCG path (solver="pcg") linearizes per edge
and never materializes H; these tests establish (a) agreement with the
dense solve on a drifted loop, (b) convergence at K=512 — the scale the
round-1 dense design could not serve — with cost linear in E.
"""

import dataclasses
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import PoseGraphConfig
from topfusion.geometry.se3 import se3_exp, se3_inverse
from topfusion.models.posegraph import (
    DESC_DIM,
    PoseGraph,
    edge_residuals,
    optimize,
    optimize_pcg,
)


def make_ring_graph(K, E_cap, noise=0.01, seed=0, loops_every=16):
    """Synthetic drifted ring: K keyframes around a circle, odometry edges
    with noise, periodic loop edges with exact measurements."""
    rng = np.random.RandomState(seed)
    # Ground-truth poses on a circle.
    gt = []
    for k in range(K):
        a = 2 * np.pi * k / K
        T = np.eye(4, dtype=np.float32)
        c, s = np.cos(a), np.sin(a)
        T[:3, :3] = np.asarray([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
        T[:3, 3] = [np.cos(a), np.sin(a), 0.0]
        gt.append(T)
    gt = np.stack(gt)

    # Odometry chain: noisy relative measurements -> drifted initial poses.
    edges_i, edges_j, edges_T, edges_loop = [], [], [], []
    est = [gt[0]]
    for k in range(1, K):
        rel = np.linalg.inv(gt[k - 1]) @ gt[k]
        xi = rng.randn(6).astype(np.float32) * noise
        rel_noisy = np.asarray(se3_exp(jnp.asarray(xi))) @ rel
        est.append(est[-1] @ rel_noisy)
        edges_i.append(k - 1)
        edges_j.append(k)
        edges_T.append(rel_noisy)
    # Loop edges: exact relative pose to keyframe 0 every `loops_every`.
    for k in range(loops_every, K, loops_every):
        edges_i.append(0)
        edges_j.append(k)
        edges_T.append(np.linalg.inv(gt[0]) @ gt[k])
        edges_loop.append(len(edges_i) - 1)
    E = len(edges_i)
    assert E <= E_cap

    def padE(x, shape, fill):
        out = np.full((E_cap,) + shape, fill, np.float32 if shape else np.int32)
        out[: len(x)] = x
        return out

    eT = np.broadcast_to(np.eye(4, dtype=np.float32), (E_cap, 4, 4)).copy()
    eT[:E] = np.stack(edges_T)
    is_loop = np.zeros(E_cap, bool)
    is_loop[edges_loop] = True
    pg = PoseGraph(
        kf_poses=jnp.asarray(np.stack(est)),
        kf_points=jnp.zeros((K, 1, 1, 3), jnp.float32),
        kf_normals=jnp.zeros((K, 1, 1, 3), jnp.float32),
        kf_frame=jnp.arange(K, dtype=jnp.int32),
        kf_desc=jnp.zeros((K, DESC_DIM), jnp.float32),
        num_kf=jnp.asarray(K, jnp.int32),
        edge_i=jnp.asarray(padE(edges_i, (), 0)),
        edge_j=jnp.asarray(padE(edges_j, (), 0)),
        edge_T=jnp.asarray(eT),
        edge_is_loop=jnp.asarray(is_loop),
        edge_weight=jnp.ones((E_cap,), jnp.float32),
        num_edges=jnp.asarray(E, jnp.int32),
        kf_loop_done=jnp.zeros((K,), bool),
    )
    return pg, jnp.asarray(gt)


def pose_err(pg, gt):
    K = int(pg.num_kf)
    # Gauge: align to node 0 (fixed by both solvers).
    err = []
    for k in range(0, K, max(K // 32, 1)):
        d = np.asarray(pg.kf_poses[k][:3, 3] - gt[k][:3, 3])
        err.append(np.linalg.norm(d))
    return float(np.mean(err))


def test_pcg_matches_dense():
    cfg = PoseGraphConfig(gn_iters=8, cg_iters=64, damping=1e-5)
    pg, gt = make_ring_graph(K=48, E_cap=64, noise=0.02, seed=1)
    pg_d, chi_d = optimize(pg, dataclasses.replace(cfg, solver="dense"))
    pg_p, chi_p = optimize_pcg(pg, cfg)
    # Same optimum: per-node translation agreement well under the noise.
    dt = np.linalg.norm(
        np.asarray(pg_d.kf_poses[:48, :3, 3] - pg_p.kf_poses[:48, :3, 3]),
        axis=-1,
    )
    assert dt.max() < 2e-3, f"max node disagreement {dt.max():.4f} m"
    assert abs(float(chi_d) - float(chi_p)) < 1e-3


def test_pcg_corrects_drift_at_k512():
    # K=512 / E~543: the dense path would build and invert a [3072, 3072]
    # H via whole-graph jacfwd; PCG linearizes 543 edges and psums nothing
    # bigger than [512, 6].
    cfg = PoseGraphConfig(
        max_keyframes=512, max_edges=1024, gn_iters=8, cg_iters=96,
        damping=1e-6,
    )
    pg, gt = make_ring_graph(K=512, E_cap=1024, noise=0.01, seed=2)
    before = pose_err(pg, gt)
    chi_before = float(jnp.sum(edge_residuals(jnp.zeros((512, 6)), pg) ** 2))
    pg2, chi_after = optimize_pcg(pg, cfg)
    after = pose_err(pg2, gt)
    assert float(chi_after) < chi_before * 0.05
    assert after < before * 0.25, f"drift {before:.3f} -> {after:.3f}"


def test_pcg_cost_linear_in_edges():
    # Compile-time sanity: the jaxpr of the PCG optimizer contains no
    # [6K, 6K] intermediate (the dense path's signature operand).
    cfg = PoseGraphConfig(max_keyframes=256, max_edges=512, gn_iters=1,
                          cg_iters=4)
    pg, _ = make_ring_graph(K=256, E_cap=512, noise=0.01, seed=3)
    jaxpr = jax.make_jaxpr(lambda g: optimize_pcg(g, cfg))(pg)
    n = 6 * 256
    big = [
        v for eqn in jaxpr.jaxpr.eqns for v in eqn.outvars
        if hasattr(v, "aval") and getattr(v.aval, "shape", ()) == (n, n)
    ]
    assert not big, f"found {len(big)} [6K,6K] intermediates in PCG path"
