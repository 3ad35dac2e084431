"""Multi-host runtime: scaling harness + 2-process jax.distributed loopback.

SURVEY.md section 4(d): multi-host behaviour is testable without
accelerators via the single-process virtual mesh (the other tests) AND a
real 2-process ``jax.distributed`` bring-up over loopback, exercised here
by spawning two Python subprocesses that form one 2-process CPU cluster,
build a global mesh, and psum across process boundaries.
"""

import os
import socket
import subprocess
import sys
import textwrap

import numpy as np
import pytest

from topfusion.parallel.multihost import (
    measure_scaling_block,
    run_block_pipeline_demo,
)


def test_measure_scaling_block_runs():
    """The scaling harness runs 1/2/4/8 virtual devices and reports an
    efficiency number (CPU-mesh timings are not device numbers; this
    guards the harness itself)."""
    from tests.test_block_sharded import make_cfg

    res = measure_scaling_block(
        make_cfg(), n_frames=3, device_counts=(1, 2, 8), mode="weak"
    )
    assert res[1] > 0 and res[8] > 0
    assert "efficiency" in res and res["efficiency"] > 0


_WORKER = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); coord = sys.argv[2]

    from topfusion.parallel.multihost import initialize_multihost
    initialize_multihost(
        coordinator_address=coord, num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2, jax.process_count()
    assert len(jax.devices()) == 4  # 2 local per process

    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    mesh = Mesh(np.asarray(jax.devices()).reshape(4), ("map",))

    # Each device contributes its index; psum must see all 4 devices
    # across BOTH processes (collective rides the loopback DCN).
    @jax.jit
    def total():
        zeros = jax.device_put(
            jnp.zeros((4,), jnp.float32), NamedSharding(mesh, P("map"))
        )
        def body(z):
            import jax.lax as lax
            return z + lax.psum(lax.axis_index("map").astype(jnp.float32), "map")
        return jax.shard_map(
            body, mesh=mesh, in_specs=P("map"), out_specs=P("map"),
        )(zeros)

    out = jax.jit(total)()
    # A global array spanning both processes is not host-fetchable as a
    # whole; check this process's addressable shards.
    shards = [np.asarray(s.data) for s in out.addressable_shards]
    assert len(shards) == 2, len(shards)
    for s in shards:
        assert np.allclose(s, 6.0), s  # 0+1+2+3 psum'd across processes
    print(f"proc{pid} OK")
    """
)


def _spawn_two_process_cluster(tmp_path, worker_src, timeout=180,
                               extra_args=()):
    """Spawn 2 worker processes forming one JAX cluster over loopback;
    return their outputs (asserting both exited 0)."""
    worker = tmp_path / "worker.py"
    worker.write_text(worker_src)

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    coord = f"127.0.0.1:{port}"

    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    env.pop("JAX_PLATFORMS", None)

    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid), coord,
             *map(str, extra_args)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    outs = []
    for p in procs:
        try:
            out, _ = p.communicate(timeout=timeout)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc{pid} failed:\n{out}"
    return outs


def test_two_process_loopback(tmp_path):
    """Spawn 2 processes, form one JAX cluster over 127.0.0.1, and run a
    cross-process psum over a 4-device global mesh."""
    outs = _spawn_two_process_cluster(tmp_path, _WORKER)
    for pid, out in enumerate(outs):
        assert f"proc{pid} OK" in out


_PIPELINE_WORKER = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); coord = sys.argv[2]

    from topfusion.parallel.multihost import (
        initialize_multihost, run_block_pipeline_demo,
    )
    initialize_multihost(
        coordinator_address=coord, num_processes=2, process_id=pid
    )
    assert jax.process_count() == 2
    assert len(jax.devices()) == 4  # 2 local per process

    res = run_block_pipeline_demo(n_devices=4, n_frames=4)
    print("RESULT", json.dumps({
        "pose": res["poses"][-1].tolist(),
        "num_blocks": res["num_blocks"],
        "num_visible": res["num_visible"],
    }))
    print(f"proc{pid} PIPELINE-OK")
    """
)


_RESUME_WORKER = textwrap.dedent(
    """
    import os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    pid = int(sys.argv[1]); coord = sys.argv[2]
    ckpt = sys.argv[3]; crash_at = int(sys.argv[4])

    from topfusion.parallel.multihost import (
        initialize_multihost, run_block_pipeline_demo,
    )
    initialize_multihost(
        coordinator_address=coord, num_processes=2, process_id=pid
    )

    def on_frame(k, state):
        # Simulated hard failure: process 1 dies mid-run, AFTER the
        # frame-4 checkpoint was written.
        if crash_at >= 0 and pid == 1 and k + 1 == crash_at:
            os._exit(17)

    res = run_block_pipeline_demo(
        n_devices=4, n_frames=8, ckpt_path=ckpt, ckpt_every=2,
        on_frame=on_frame,
    )
    print("RESULT", json.dumps({
        "pose": res["poses"][-1].tolist(),
        "num_blocks": res["num_blocks"],
        "resumed_at": res["resumed_at"],
        "n_poses": len(res["poses"]),
    }))
    print(f"proc{pid} RESUME-OK")
    """
)


def test_kill_one_process_and_resume(tmp_path):
    """Multi-host failure semantics (SURVEY.md section 5.3 rebuild line;
    round-4 VERDICT missing #3): a 2-process sharded run is killed
    mid-flight (process 1 hard-exits after the frame-4 checkpoint), the
    CLUSTER restarts, every process restores its own shards from the
    periodic checkpoint, and the finished run matches an uninterrupted
    one exactly — checkpoint restore is bit-exact, and the pipeline is
    deterministic by construction (SURVEY.md section 5.2)."""
    import json

    ckpt = str(tmp_path / "ckpt")

    # Uninterrupted 2-PROCESS reference (same collective transport as
    # the resumed run, so the comparison below can be exact; a
    # single-process mesh differs at float-reduction-order scale).
    ref_outs = _spawn_two_process_cluster(
        tmp_path, _RESUME_WORKER, timeout=420,
        extra_args=(str(tmp_path / "ckpt_ref"), -1),
    )
    import json as _json

    ref = _json.loads(
        ref_outs[0].splitlines()[-2].split("RESULT ", 1)[1]
    )

    # Attempt 1: process 1 dies at frame 5 (after the frame-4 ckpt).
    worker = tmp_path / "worker.py"
    worker.write_text(_RESUME_WORKER)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = (
        os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        + os.pathsep
        + env.get("PYTHONPATH", "")
    )
    env.pop("JAX_PLATFORMS", None)
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(pid),
             f"127.0.0.1:{port}", ckpt, "5"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in (0, 1)
    ]
    # Process 1 self-kills; the survivor blocks on a dead collective and
    # is torn down by the harness (the real-cluster analogue: the job
    # scheduler restarts the whole slice).
    out1, _ = procs[1].communicate(timeout=240)
    assert procs[1].returncode == 17, out1
    try:
        procs[0].communicate(timeout=20)
    except subprocess.TimeoutExpired:
        procs[0].kill()
        procs[0].communicate()

    assert os.path.exists(ckpt + ".proc0.npz"), "no checkpoint written"
    assert os.path.exists(ckpt + ".proc1.npz")

    # Attempt 2: full cluster restart, resume from the checkpoint.
    outs = _spawn_two_process_cluster(
        tmp_path, _RESUME_WORKER, timeout=420, extra_args=(ckpt, -1),
    )
    for pid, out in enumerate(outs):
        assert f"proc{pid} RESUME-OK" in out, out
    got = json.loads(outs[0].splitlines()[-2].split("RESULT ", 1)[1])
    assert got["resumed_at"] == 4, got
    assert got["n_poses"] == 8
    pose2p = np.asarray(got["pose"])
    pose_ref = np.asarray(ref["pose"])
    # Checkpoint restore is bit-exact and the pipeline deterministic:
    # kill-at-5 + restart must land exactly where the uninterrupted
    # cluster landed.
    assert np.abs(pose2p - pose_ref).max() < 1e-6, (pose2p, pose_ref)
    assert got["num_blocks"] == ref["num_blocks"]


def test_two_process_sharded_block_pipeline(tmp_path):
    """THE flagship pipeline across 2 real processes (BASELINE.md
    config 5): a 2-process x 2-local-device cluster runs 4 sharded
    block-fusion steps (hash-ownership alloc, psum'd ICP, composited
    splat); the trajectory must match the same 4-device mesh run inside
    ONE process (only collective transport differs — the program and its
    partitioning are identical)."""
    import json

    # Single-process 4-device reference on the virtual CPU mesh.
    ref = run_block_pipeline_demo(n_devices=4, n_frames=4)

    outs = _spawn_two_process_cluster(
        tmp_path, _PIPELINE_WORKER, timeout=420
    )
    for pid, out in enumerate(outs):
        assert f"proc{pid} PIPELINE-OK" in out, out

    got = json.loads(
        outs[0].splitlines()[-2].split("RESULT ", 1)[1]
    )
    pose2p = np.asarray(got["pose"])
    pose1p = ref["poses"][-1]
    assert np.abs(pose2p[:3, 3] - pose1p[:3, 3]).max() < 1e-4, (
        pose2p, pose1p,
    )
    assert np.abs(pose2p[:3, :3] - pose1p[:3, :3]).max() < 1e-3
    assert got["num_blocks"] == ref["num_blocks"]
    assert got["num_visible"] == ref["num_visible"]
