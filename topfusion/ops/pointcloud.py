"""Surface point-cloud extraction with normals.

The reference's cloud path is dormant (decls at
tfusion/src/internal.hpp:139-145, merge kernel at imgproc.cu:577-609,
demo hook stubbed at apps/demo.cpp:70-77); here it is a first-class op:
find voxels within one voxel of the zero crossing, project each onto the
surface along the SDF gradient, emit fixed-capacity (points, normals,
valid) arrays — jit-safe compaction via rank/scatter.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax.numpy as jnp
from jax import lax

from topfusion.config import BlockMapConfig, DenseVolumeConfig, TSDFConfig
from topfusion.ops.blockmap import BlockMap, decode_tsdf, decode_weight
from topfusion.ops.tsdf_dense import DenseVolume


class PointCloud(NamedTuple):
    points: jnp.ndarray    # [N, 3] world meters
    normals: jnp.ndarray   # [N, 3]
    valid: jnp.ndarray     # [N] bool
    count: jnp.ndarray     # () int32


def _emit(points, normals, mask, max_points) -> PointCloud:
    flat_p = points.reshape(-1, 3)
    flat_n = normals.reshape(-1, 3)
    flat_m = mask.reshape(-1)
    rank = jnp.cumsum(flat_m.astype(jnp.int32)) - 1
    keep = flat_m & (rank < max_points)
    idx = jnp.where(keep, rank, max_points)
    out_p = jnp.zeros((max_points, 3), points.dtype).at[idx].set(
        flat_p, mode="drop"
    )
    out_n = jnp.zeros((max_points, 3), normals.dtype).at[idx].set(
        flat_n, mode="drop"
    )
    valid = jnp.zeros((max_points,), bool).at[idx].set(keep, mode="drop")
    return PointCloud(
        points=out_p,
        normals=out_n,
        valid=valid,
        count=jnp.minimum(jnp.sum(flat_m.astype(jnp.int32)), max_points),
    )


def _surface_from_grid(tsdf, weight, world_pos, mu, voxel):
    """Shared logic: per-voxel surface test + gradient normal + projection.

    tsdf/weight: [..., X, Y, Z]; world_pos broadcastable [..., X, Y, Z, 3].
    Central differences inside the grid (forward/backward at borders).
    """
    def diff(axis):
        a = axis + tsdf.ndim - 3
        fwd = jnp.roll(tsdf, -1, axis=a)
        bwd = jnp.roll(tsdf, 1, axis=a)
        return (fwd - bwd) * 0.5

    g = jnp.stack([diff(0), diff(1), diff(2)], axis=-1)
    gn = jnp.linalg.norm(g, axis=-1, keepdims=True)
    normal = g / jnp.maximum(gn, 1e-12)
    near = (jnp.abs(tsdf) * mu < voxel) & (weight > 0.0) & (gn[..., 0] > 1e-6)
    # Project the voxel centre onto the zero level set.
    pts = world_pos - normal * (tsdf * mu)[..., None]
    return pts, normal, near


def extract_pointcloud_dense(
    vol: DenseVolume,
    tsdf_cfg: TSDFConfig,
    dense_cfg: DenseVolumeConfig,
    max_points: int = 1 << 20,
) -> PointCloud:
    d0, d1, d2 = dense_cfg.dims
    voxel = tsdf_cfg.voxel_size
    origin = jnp.asarray(dense_cfg.origin, vol.tsdf.dtype)
    ix = lax.broadcasted_iota(jnp.float32, (d0, d1, d2), 0)
    iy = lax.broadcasted_iota(jnp.float32, (d0, d1, d2), 1)
    iz = lax.broadcasted_iota(jnp.float32, (d0, d1, d2), 2)
    pw = jnp.stack([ix, iy, iz], axis=-1) * voxel + (origin + 0.5 * voxel)
    pts, nrm, near = _surface_from_grid(
        vol.tsdf, vol.weight, pw, tsdf_cfg.trunc_dist, voxel
    )
    return _emit(pts, nrm, near, max_points)


def extract_pointcloud_blocks(
    m: BlockMap,
    tsdf_cfg: TSDFConfig,
    bm_cfg: BlockMapConfig,
    max_points: int = 1 << 20,
) -> PointCloud:
    """Extract from every live block ([C, B, B, B] pool pass).

    Note: gradients use intra-block rolls; normals at block borders are
    approximate (one-voxel wrap) — fine for visualization/export.
    """
    bsz = bm_cfg.block_size
    voxel = tsdf_cfg.voxel_size
    c = m.block_coords.astype(jnp.float32)
    lx = lax.broadcasted_iota(jnp.float32, (1, bsz, bsz, bsz), 1)
    ly = lax.broadcasted_iota(jnp.float32, (1, bsz, bsz, bsz), 2)
    lz = lax.broadcasted_iota(jnp.float32, (1, bsz, bsz, bsz), 3)
    local = jnp.stack([lx, ly, lz], axis=-1)
    base = c[:, None, None, None, :] * bsz
    pw = (base + local + 0.5) * voxel
    pts, nrm, near = _surface_from_grid(
        decode_tsdf(m.tsdf[: m.capacity]),
        decode_weight(m.weight[: m.capacity]),
        pw,
        tsdf_cfg.trunc_dist,
        voxel,
    )
    live = (jnp.arange(m.capacity) < m.num_blocks)[:, None, None, None]
    return _emit(pts, nrm, near & live, max_points)


def save_ply(path: str, pc: PointCloud) -> int:
    """Write valid points+normals as ASCII PLY; returns point count."""
    import numpy as np

    p = np.asarray(pc.points)
    n = np.asarray(pc.normals)
    v = np.asarray(pc.valid)
    p, n = p[v], n[v]
    with open(path, "w") as f:
        f.write(
            "ply\nformat ascii 1.0\n"
            f"element vertex {len(p)}\n"
            "property float x\nproperty float y\nproperty float z\n"
            "property float nx\nproperty float ny\nproperty float nz\n"
            "end_header\n"
        )
        for (x, y, z), (nx, ny, nz) in zip(p, n):
            f.write(f"{x:.6f} {y:.6f} {z:.6f} {nx:.4f} {ny:.4f} {nz:.4f}\n")
    return len(p)
