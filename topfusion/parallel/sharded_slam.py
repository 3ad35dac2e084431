"""The composed flagship: full SLAM on the SHARDED block map.

One system = hash-ownership map sharding + pose graph + loop closure +
edge-sharded distributed BA + per-shard host swap + full-rate
re-integration ring (BASELINE.md configs 4/5 as ONE artifact; round-4
VERDICT missing #1).  The reference caps at one GPU with none of these
subsystems (SURVEY.md section 0).

Composition strategy — everything that exists is reused, nothing is
re-derived:

  * The per-frame map work (ICP psum, ownership-filtered alloc, local
    integrate, sort-last-composited splat) is
    ``ShardedBlockPipeline._step_local`` verbatim.
  * The CHUNK program (scan over frames + masked keyframe insertion +
    in-graph loop detection + ring recording) is
    ``models/slam.SlamSystem._chunk_impl`` — inherited, unchanged, and
    wrapped in ONE ``shard_map`` over the mesh: map state shards, the
    pose graph / keyframe buffers / ring replicate (they are image- and
    keyframe-sized; replicated compute is deterministic, so all devices
    advance them identically).
  * Loop OPTIMIZATION routes through ``parallel/dist_ba.
    optimize_distributed``: edges shard over the SAME mesh axis, the
    collectives are keyframe-sized psums.
  * RE-INTEGRATION is the inherited ``_reint_impl`` while-loop with the
    two map-touching primitives (fuse-at-fixed-pose, model-map refresh)
    overridden to their shard-aware forms — wipe + replay runs on every
    shard in one dispatch.
  * Out-of-core swap is ``models/host_cache.ShardedHostCache`` (each
    shard evicts/restores its own blocks; ownership is static by hash).

An 8-device CPU-mesh orbit-with-loop run matches the single-device
``SlamSystem`` trajectory and closure count (tests/test_sharded_slam.py);
``__graft_entry__.dryrun_multichip`` compiles + executes this composed
step (chunk, distributed BA, sharded re-integration) on the virtual mesh.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from topfusion.config import PipelineConfig
from topfusion.models.slam import SlamSystem
from topfusion.ops.depth import preprocess_depth
from topfusion.parallel.block_sharded import (
    AXIS,
    ShardedBlockPipeline,
    make_mesh,
)
from topfusion.parallel.dist_ba import optimize_distributed


class ShardedSlamSystem(SlamSystem):
    """SlamSystem with the map sharded over ``mesh``'s ``map`` axis.

    Host surface is identical to :class:`SlamSystem` (``process_chunk``,
    ``optimized_trajectory``, ``warmup`` ...); only the device programs
    differ.  Color fusion is not sharded yet (depth-only flagship).
    """

    def __init__(
        self,
        cfg: PipelineConfig,
        mesh: Mesh | None = None,
        axis: str = AXIS,
        render_in_chunk: bool = False,
    ):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axis = axis
        super().__init__(cfg, render_in_chunk=render_in_chunk)

    # ------------------------------------------------------------- build
    def _build_pipe(self) -> None:
        self.pipe = ShardedBlockPipeline(self.cfg, self.mesh, self.axis)
        self.state = self.pipe.init()

    def _build_dispatches(self) -> None:
        pgc = self.cfg.posegraph
        mesh, axis = self.mesh, self.axis
        sspec = self.pipe._state_specs
        rep = P()

        # ONE shard_map around the whole inherited chunk program: map
        # state sharded, everything else replicated.  Argument order
        # mirrors _chunk_impl(state, graph, kf_buf, kf_odom_buf, ring,
        # depths, rgbs, frame0, do_kf).
        self._chunk = jax.jit(
            jax.shard_map(
                self._chunk_impl,
                mesh=mesh,
                in_specs=(sspec, rep, rep, rep, rep, rep, rep, rep, rep),
                out_specs=(sspec, rep, rep, rep, rep, rep, rep, rep, rep,
                           rep, rep),
                check_vma=False,
            )
        )
        self._optimize = jax.jit(
            lambda pg: optimize_distributed(pg, pgc, mesh, axis)
        )
        self._optimize_ex = jax.jit(self._optimize_ex_impl)
        # _reint_impl(state, graph, kf_buf, kf_odom_last, kf_odom_buf,
        # ring, frame_now) -> (state, corr)
        self._reint = jax.jit(
            jax.shard_map(
                self._reint_impl,
                mesh=mesh,
                in_specs=(sspec, rep, rep, rep, rep, rep, rep),
                out_specs=(sspec, rep),
                check_vma=False,
            )
        )

    def _attach_swap(self) -> None:
        from topfusion.models.host_cache import ShardedHostCache

        self.swap = ShardedHostCache(self.pipe)

    # ---------------------------------------------------------- optimize
    def _optimize_ex_impl(self, graph, kf_odom_last):
        """Pose-graph solve via the EDGE-SHARDED distributed BA (same
        semantics as models/posegraph.optimize; keyframe-sized psums,
        parallel/dist_ba.py) + the re-anchor decision inputs, one
        dispatch."""
        graph, _chi2 = optimize_distributed(
            graph, self.cfg.posegraph, self.mesh, self.axis
        )
        kf_opt_last = graph.kf_poses[jnp.maximum(graph.num_kf - 1, 0)]
        moved = jnp.linalg.norm(kf_opt_last[:3, 3] - kf_odom_last[:3, 3])
        return graph, kf_opt_last, moved

    # ------------------------------------------------------------- reint
    def _fuse_at_impl(self, state, depth_mm, T_wc):
        """Shard-aware fuse-at-fixed-pose (runs under the _reint
        shard_map): candidate DDA row-sharded + all_gathered, insert
        ownership-filtered, integrate shard-local — the same comm
        pattern as the live step (block_sharded._step_local)."""
        from topfusion.ops.tsdf_block import (
            allocate_from_depth,
            integrate_blocks,
            visible_blocks,
        )

        cfg = self.pipe.local_cfg
        sid = lax.axis_index(self.axis)
        shard = (sid, self.pipe.ns)
        raw, _ = preprocess_depth(depth_mm, cfg.preproc)
        m = self.pipe._local_map(state)
        m, _ = allocate_from_depth(
            m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc, raw,
            shard=shard, row_shard=self.axis,
        )
        vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc)
        m, _ = integrate_blocks(
            m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc, raw, vis
        )
        return self.pipe._write_local_map(state, m)

    def _refresh_maps_impl(self, state, T_wc):
        """Shard-aware model-map refresh after the rebuild: per-shard
        splat + sort-last compositing, replicated pyramid."""
        from topfusion.ops.normals import resize_points_normals
        from topfusion.ops.splat import splat_model_maps
        from topfusion.ops.tsdf_block import visible_blocks

        cfg = self.pipe.local_cfg
        m = self.pipe._local_map(state)
        vis = visible_blocks(m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc)
        rc = splat_model_maps(
            m, cfg.camera, cfg.tsdf, cfg.blockmap, T_wc, vis,
            surfels_per_block=cfg.raycast.surfels_per_block,
            dilate_passes=cfg.raycast.dilate_passes,
            axis_name=self.axis, num_shards=self.pipe.ns,
        )
        mp = [rc.points]
        mn = [rc.normals]
        for _ in range(cfg.preproc.pyramid_levels - 1):
            p, n = lax.optimization_barrier(
                resize_points_normals(mp[-1], mn[-1])
            )
            mp.append(p)
            mn.append(n)
        return state._replace(
            T_wc=T_wc, model_points=tuple(mp), model_normals=tuple(mn),
            vis_slots=vis[0],
        )

    # -------------------------------------------------------------- swap
    def _swap_before(self, T_pred) -> None:
        self.state = self.swap.before_step(self.state, T_pred)

    def _swap_after(self) -> None:
        self.state = self.swap.after_step(self.state)

    # -------------------------------------------------------- checkpoint
    def save_checkpoint(self, path: str) -> None:
        """Periodic checkpoint of the COMPOSED system: each process
        writes the map shards it addresses (multihost.
        save_sharded_checkpoint); process 0 writes the replicated device
        state (pose graph, keyframe depth/odometry buffers, reint ring)
        and the host bookkeeping.  A restarted cluster calls
        :meth:`restore_checkpoint` on a freshly-constructed system —
        the elastic-recovery story for the flagship (SURVEY.md
        section 5.3-5.4 rebuild lines; paths must be on a filesystem
        all processes share)."""
        import json

        from topfusion.parallel.multihost import save_sharded_checkpoint
        from topfusion.utils.checkpoint import save_state

        save_sharded_checkpoint(
            f"{path}.map.proc{jax.process_index()}.npz",
            self.state, self.frame_idx, self.odom_poses,
        )
        if jax.process_index() == 0:
            rep = (self.graph, self.kf_depth_buf, self.kf_odom_buf,
                   self._ring() or ())
            save_state(f"{path}.rep.npz", rep)
            host = {
                "kf_for_frame": self.kf_for_frame,
                "kf_odom_poses": [p.tolist() for p in self.kf_odom_poses],
                "loops_closed": self.loops_closed,
                "reintegrations": self.reintegrations,
            }
            tmp = f"{path}.host.json.tmp"
            with open(tmp, "w") as f:
                json.dump(host, f)
            import os

            os.replace(tmp, f"{path}.host.json")

    def restore_checkpoint(self, path: str) -> None:
        """Restore a :meth:`save_checkpoint` into this (freshly built,
        same-config, same-mesh) system; every process loads only the map
        shards it addresses."""
        import json

        from topfusion.parallel.multihost import (
            restore_sharded_checkpoint,
        )
        from topfusion.utils.checkpoint import load_state

        self.state, self.frame_idx, self.odom_poses = (
            restore_sharded_checkpoint(
                f"{path}.map.proc{jax.process_index()}.npz", self.state
            )
        )
        rep = (self.graph, self.kf_depth_buf, self.kf_odom_buf,
               self._ring() or ())
        rep = load_state(f"{path}.rep.npz", rep)
        self.graph, self.kf_depth_buf, self.kf_odom_buf = rep[:3]
        if self.R > 0:
            self.ring_depths, self.ring_poses, self.ring_kf = rep[3]
        with open(f"{path}.host.json") as f:
            host = json.load(f)
        self.kf_for_frame = list(host["kf_for_frame"])
        self.kf_odom_poses = [
            np.asarray(p, np.float32) for p in host["kf_odom_poses"]
        ]
        self.loops_closed = int(host["loops_closed"])
        self.reintegrations = int(host["reintegrations"])


# ----------------------------------------------------------------------
def dryrun_sharded_slam(n_devices: int) -> None:
    """Driver hook: compile + execute the COMPOSED flagship over an
    n-device mesh — chunked fusion with in-graph keyframes/loop
    detection on the sharded map, the edge-sharded distributed BA
    dispatch, and the sharded wipe-and-replay re-integration — on tiny
    shapes (round-4 VERDICT next #1c: one system, one dryrun)."""
    import dataclasses

    from topfusion.config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PipelineConfig,
        PoseGraphConfig,
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
        posegraph=PoseGraphConfig(
            keyframe_every=2, max_keyframes=8, max_edges=16,
            loop_candidates=2, reint_ring=4,
        ),
    )

    slam = ShardedSlamSystem(cfg, mesh)
    scene = SyntheticScene()
    depth = scene.render_depth_mm(cam, jnp.eye(4))
    depths = jnp.stack([depth, depth])

    # Two chunks through the composed chunk program (keyframe inserted,
    # loop detection in-graph), then force the rare dispatches: the
    # distributed pose-graph solve and the sharded re-integration.
    infos = slam.process_chunk(depths, do_kf=True)
    infos = slam.process_chunk(depths, do_kf=True)
    assert all(i["ok"] for i in infos), "sharded SLAM lost tracking"
    g, _, mv = slam._optimize_ex(
        slam.graph, jnp.eye(4, dtype=jnp.float32)
    )
    st, corr = slam._reint(
        slam.state, g, slam.kf_depth_buf,
        jnp.eye(4, dtype=jnp.float32), slam.kf_odom_buf, slam._ring(),
        jnp.asarray(slam.frame_idx, jnp.int32),
    )
    jax.block_until_ready((st.tsdf, corr, mv))
    assert int(np.asarray(st.num_blocks).sum()) > 0
