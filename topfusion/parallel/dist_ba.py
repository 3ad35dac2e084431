"""Distributed pose-graph bundle adjustment over a device mesh.

Schur-style scalable structure: edges (the "observations") are sharded
across the mesh's ``ba`` axis; each device linearizes only its edge shard
(per-edge 6x6 Jacobian blocks, models/posegraph.edge_jacobians) and the
normal equations are solved matrix-free with block-Jacobi preconditioned
CG (models/posegraph._pcg_solve).  The Hessian is NEVER materialized —
the only collectives are keyframe-sized:

  * one psum of a [K, 6] vector per CG iteration (the Hvp partial sums),
  * one psum of [K, 6, 6] diagonal blocks per GN iteration (the
    preconditioner) and one of [K, 6] (the gradient).

At K=512 that is 12 KB per CG step vs the 9.4 MB [6K, 6K] dense H the
round-1 design replicated; per-device compute is O(E / n_devices).  This
is the psum-reduction-over-keyframe-Hessian-blocks pattern BASELINE.json
mandates — the reference has no optimizer or communication at all
(SURVEY.md section 2.2).

Single-device semantics are identical to models/posegraph.optimize
(agreement-tested on the virtual CPU mesh, tests/test_parallel.py).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from topfusion.config import PoseGraphConfig
from topfusion.geometry.se3 import mat_mul, se3_exp, se3_inverse
from topfusion.models.posegraph import (
    PoseGraph,
    _huber_weights,
    _pcg_solve,
    edge_jacobians,
    edge_residuals,
)


def optimize_distributed(
    pg: PoseGraph, cfg: PoseGraphConfig, mesh: Mesh, axis: str = "ba"
) -> Tuple[PoseGraph, jnp.ndarray]:
    """Gauss-Newton over keyframe poses with edge-sharded linearization.

    Edges are padded to a multiple of the mesh size and distributed; the
    whole GN+PCG loop runs inside one ``shard_map``, so poses stay
    replicated (they advance identically everywhere — psums are
    deterministic) and per-iteration traffic is keyframe-sized.
    """
    n_dev = mesh.shape[axis]
    k_cap = pg.kf_poses.shape[0]
    e_cap = pg.edge_i.shape[0]

    e_pad = ((e_cap + n_dev - 1) // n_dev) * n_dev

    def pad(x, fill=0):
        pad_width = [(0, e_pad - e_cap)] + [(0, 0)] * (x.ndim - 1)
        return jnp.pad(x, pad_width, constant_values=fill)

    edge_i = pad(pg.edge_i)
    edge_j = pad(pg.edge_j)
    edge_T = jnp.concatenate(
        [pg.edge_T]
        + [jnp.broadcast_to(jnp.eye(4, dtype=pg.edge_T.dtype),
                            (e_pad - e_cap, 4, 4))],
        axis=0,
    )
    edge_valid = pad(jnp.arange(e_cap) < pg.num_edges)
    edge_weight = pad(pg.edge_weight)

    espec = P(axis)
    rspec = P()

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(espec, espec, P(axis, None, None), espec, espec, rspec),
        out_specs=rspec,
    )
    def run(ei, ej, eT, ev, ew, kf_poses):
        def gn_step(_, poses):
            r, A, B = edge_jacobians(poses, ei, ej, eT)
            we = (
                _huber_weights(r, cfg.huber_delta)
                * ew
                * ev.astype(jnp.float32)
            )
            dx = _pcg_solve(
                A, B, r, we, ei, ej, k_cap,
                cfg.damping, cfg.cg_iters, axis_name=axis,
            )
            return mat_mul(se3_exp(dx), poses)

        return lax.fori_loop(0, cfg.gn_iters, gn_step, kf_poses)

    new_poses = run(edge_i, edge_j, edge_T, edge_valid, edge_weight,
                    pg.kf_poses)

    live = (jnp.arange(k_cap) < pg.num_kf)[:, None, None]
    pg = pg._replace(kf_poses=jnp.where(live, new_poses, pg.kf_poses))
    chi2 = jnp.sum(edge_residuals(jnp.zeros((k_cap, 6)), pg) ** 2)
    return pg, chi2
