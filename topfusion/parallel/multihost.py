"""Multi-host runtime: initialization + scaling measurement harness.

The reference is a single process on a single GPU with zero inter-process
communication (SURVEY.md section 5.8).  Here the runtime story is
``jax.distributed.initialize`` + a global mesh: on a GPU host the
collectives ride NVLink between the cards (NCCL), and across hosts the
network; XLA inserts them from sharding annotations — there is no
hand-written transport to port.

This module wraps the bring-up and provides the scaling-efficiency
measurement used by BASELINE.md config 5 (fused frames/s at 1 chip vs. a
multi-chip mesh).  Multi-host execution is validated in CI via
``--xla_force_host_platform_device_count`` single-process simulation
(tests/test_parallel.py) and the driver's ``dryrun_multichip`` hook.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Bring up the JAX distributed runtime (no-op when single-process).

    Nothing on a GPU host announces a cluster, so pass all three
    arguments explicitly (e.g. ``localhost:<port>`` for processes on one
    host, and for loopback/multi-process CPU testing).
    """
    if num_processes is not None and num_processes > 1 or coordinator_address:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )


def save_sharded_checkpoint(path: str, state, frame_idx: int,
                            poses) -> None:
    """Per-process checkpoint of a SHARDED pytree: each process writes
    the shards it addresses (keyed by device id) plus replicated scalars,
    atomically (tmp + rename).  The reference's only failure model is
    ``exit(0)`` (reference: tfusion/src/device_memory.cpp:7-11); this is
    the multi-host elastic-recovery primitive the rebuild promised
    (SURVEY.md section 5.3-5.4)."""
    leaves, _ = jax.tree.flatten(state)
    out = {
        "__frame__": np.asarray(frame_idx),
        "__poses__": np.stack(poses) if poses else np.zeros((0, 4, 4)),
    }
    for i, lf in enumerate(leaves):
        for sh in lf.addressable_shards:
            out[f"leaf{i}_dev{sh.device.id}"] = np.asarray(sh.data)
    tmp = f"{path}.tmp{jax.process_index()}.npz"  # np.savez appends .npz
    np.savez(tmp, **out)
    os.replace(tmp, path)


def restore_sharded_checkpoint(path: str, like):
    """Restore this process's shards from ``path`` into a pytree shaped
    and SHARDED like ``like`` (each process loads only the shards it
    addresses; ``jax.make_array_from_single_device_arrays`` reassembles
    the global arrays).  Returns (state, frame_idx, poses list)."""
    data = np.load(path)
    leaves, treedef = jax.tree.flatten(like)
    out = []
    for i, lf in enumerate(leaves):
        shards = []
        for sh in lf.addressable_shards:
            arr = data[f"leaf{i}_dev{sh.device.id}"]
            shards.append(jax.device_put(arr, sh.device))
        out.append(
            jax.make_array_from_single_device_arrays(
                lf.shape, lf.sharding, shards
            )
        )
    state = jax.tree.unflatten(treedef, out)
    poses = [p for p in data["__poses__"]]
    return state, int(data["__frame__"]), poses


def run_block_pipeline_demo(
    n_devices: Optional[int] = None,
    n_frames: int = 4,
    ckpt_path: Optional[str] = None,
    ckpt_every: int = 0,
    on_frame=None,
) -> dict:
    """Run the SHARDED BLOCK pipeline on a fixed tiny synthetic
    trajectory over an ``n_devices`` global mesh and return its results.

    Process-count agnostic by construction: the same function body runs
    in a single process over a virtual mesh AND under a 2-process
    ``jax.distributed`` cluster (tests/test_multihost.py compares the two
    trajectories — BASELINE.md config 5's multi-host execution of the
    flagship pipeline, not a toy psum).  All host<->device traffic is
    multi-process-safe: state is created on-device by the jitted init,
    depth frames enter as uncommitted (replicated) numpy arrays, and only
    fully-replicated outputs (pose, aux counters) are fetched.
    """
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
    from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
    from topfusion.parallel.block_sharded import (
        ShardedBlockPipeline,
        make_mesh,
    )

    nd = n_devices or len(jax.devices())
    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    cfg = PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3, pyramid_levels=2),
        icp=ICPConfig(iters=(3, 2), level0_stride=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=512 * nd,
            max_new_blocks_per_frame=256 * nd,
            max_visible_blocks=256 * nd,
            alloc_pixel_stride=1,
        ),
        raycast=RaycastConfig(max_steps=48),
    )

    scene = SyntheticScene()
    gt = orbit_trajectory(n_frames, max_angle_deg=2.0, max_shift=0.02, seed=7)
    # Render on the local default device, fetch to host: frames enter the
    # global computation as replicated numpy inputs.
    frames = [
        np.asarray(scene.render_depth_mm(cam, jnp.asarray(T, jnp.float32)))
        for T in gt
    ]

    mesh = make_mesh(nd)
    pipe = ShardedBlockPipeline(cfg, mesh)
    state = pipe.init()
    poses = []
    start = 0
    my_ckpt = (
        f"{ckpt_path}.proc{jax.process_index()}.npz" if ckpt_path else None
    )
    if my_ckpt is not None and os.path.exists(my_ckpt):
        # Elastic restart: resume from the last periodic checkpoint (the
        # whole cluster re-forms — jax.distributed coordination restarts
        # with the processes — and every process restores its own
        # shards; SURVEY.md section 5.3 rebuild line).
        state, start, poses = restore_sharded_checkpoint(my_ckpt, state)
    aux = None
    for k in range(start, len(frames)):
        state, aux = pipe.step(state, frames[k])
        assert bool(np.asarray(aux.ok)), "sharded demo lost tracking"
        poses.append(np.asarray(state.T_wc))
        if my_ckpt is not None and ckpt_every and (k + 1) % ckpt_every == 0:
            save_sharded_checkpoint(my_ckpt, state, k + 1, poses)
        if on_frame is not None:
            on_frame(k, state)
    return {
        "poses": np.stack(poses),
        "num_blocks": int(np.asarray(aux.num_blocks)),
        "num_visible": int(np.asarray(aux.num_visible)),
        "resumed_at": start,
    }


def measure_scaling(cfg, n_frames: int = 8, device_counts=(1, None)) -> dict:
    """Fused frames/s of the sharded dense pipeline at different mesh sizes.

    Returns {n_devices: fps, ..., "efficiency": fps_N / (N * fps_1)}.
    """
    from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
    from topfusion.parallel.sharded_pipeline import (
        make_mesh,
        make_sharded_pipeline,
    )

    scene = SyntheticScene()
    poses = orbit_trajectory(n_frames, max_angle_deg=3.0, max_shift=0.03)
    frames = [
        scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        for T in poses
    ]

    results: dict = {}
    counts = [
        c if c is not None else len(jax.devices()) for c in device_counts
    ]
    for n_dev in counts:
        mesh = make_mesh(n_dev)
        init, step = make_sharded_pipeline(cfg, mesh)
        state = init()
        state, _ = step(state, frames[0])
        state, _ = step(state, frames[1])
        np.asarray(state.T_wc[0, 0])  # completion fence
        t0 = time.perf_counter()
        n = 0
        for _ in range(2):
            for f in frames:
                state, _ = step(state, f)
                n += 1
        np.asarray(state.T_wc[0, 0])
        results[n_dev] = n / (time.perf_counter() - t0)

    if len(counts) >= 2 and counts[0] == 1:
        n_max = max(counts)
        results["efficiency"] = results[n_max] / (n_max * results[1])
    return results


def measure_scaling_block(
    cfg,
    n_frames: int = 6,
    device_counts=(1, 2, 4, 8),
    mode: str = "weak",
) -> dict:
    """Fused frames/s of the SHARDED BLOCK pipeline at different mesh sizes
    (BASELINE.md configs 4-5; the >=0.8 efficiency north star).

    ``mode="weak"`` holds the per-device working set constant (the global
    map capacity and visible budget grow with the mesh — the multi-room
    sweep story): efficiency = fps_N / fps_1.
    ``mode="strong"`` holds the global problem fixed:
    efficiency = fps_N / (N * fps_1).

    Returns {n_devices: fps, ..., "efficiency": float, "mode": mode}.
    """
    import dataclasses

    from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
    from topfusion.parallel.block_sharded import (
        ShardedBlockPipeline,
        make_mesh,
    )

    scene = SyntheticScene()
    poses = orbit_trajectory(n_frames, max_angle_deg=3.0, max_shift=0.03)
    frames = [
        scene.render_depth_mm(cfg.camera, jnp.asarray(T, jnp.float32))
        for T in poses
    ]

    results: dict = {"mode": mode}
    counts = [
        c if c is not None else len(jax.devices()) for c in device_counts
    ]
    counts = [c for c in counts if c <= len(jax.devices())]
    for n_dev in counts:
        if mode == "weak":
            bm = cfg.blockmap
            run_cfg = dataclasses.replace(
                cfg,
                blockmap=dataclasses.replace(
                    bm,
                    capacity=bm.capacity * n_dev,
                    max_visible_blocks=bm.max_visible_blocks * n_dev,
                    max_new_blocks_per_frame=bm.max_new_blocks_per_frame
                    * n_dev,
                ),
            )
        else:
            run_cfg = cfg
        mesh = make_mesh(n_dev)
        pipe = ShardedBlockPipeline(run_cfg, mesh)
        state = pipe.init()
        state, _ = pipe.step(state, frames[0])
        state, _ = pipe.step(state, frames[1])
        np.asarray(state.T_wc[0, 0])  # completion fence
        t0 = time.perf_counter()
        n = 0
        for _ in range(2):
            for f in frames:
                state, _ = pipe.step(state, f)
                n += 1
        np.asarray(state.T_wc[0, 0])
        results[n_dev] = n / (time.perf_counter() - t0)

    if len(counts) >= 2 and counts[0] == 1:
        n_max = max(counts)
        if mode == "weak":
            results["efficiency"] = results[n_max] / results[1]
        else:
            results["efficiency"] = results[n_max] / (n_max * results[1])
    return results
