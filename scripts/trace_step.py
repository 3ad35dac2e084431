#!/usr/bin/env python
"""Time and trace the VGA fusion step at the app's operating point.

Runs ``BlockPipeline`` on the synthetic VGA orbit of
``apps/run_fusion.py --synthetic-vga`` (2^16-block int16 pool, 2^12
visible blocks, K=96, occlusion culling), then:

* times the steady-state step on the host clock, ending in
  ``jax.block_until_ready`` (chained steps, one fence);
* traces a few steps with ``jax.profiler`` and sums device time per
  stage, using the ``jax.named_scope`` names of ``BlockPipeline._step``
  (preprocess, icp, allocate, visible, integrate, model_maps, pyramid);
* compares the integrate stage with its byte floor: the visible pool
  rows gathered and scattered back (2 x V x 512 voxels x 2 B x 2 arrays
  at int16) plus one read of the depth image.

Prints one JSON line; the per-scope table and a sample of raw trace
events go to ``<out>/trace_step.json`` (``--out``, default
``trace_out/`` in the checkout).  Needs an accelerator: device time has
no meaning on the CPU backend.

With ``--no-command-buffers`` XLA launches every kernel on its own
instead of replaying CUDA graphs, so each kernel in the trace names its
HLO op and the per-stage split covers library kernels (cuBLAS, cuSOLVER)
too; launch overhead then inflates the step time.

Usage:
  python scripts/trace_step.py [--steps 30] [--trace-steps 5]
  python scripts/trace_step.py --no-command-buffers
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
if "--no-command-buffers" in sys.argv:    # must precede JAX's start-up
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_gpu_enable_command_buffer="
    ).strip()
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "apps"))
from topfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

SCOPES = ("preprocess", "icp", "allocate", "visible", "integrate",
          "model_maps", "pyramid")
# Published H100 SXM device-memory bandwidth (NVIDIA data sheet); the
# card's power limit is printed beside every number.
PEAK_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def _hlo_scopes(hlo_text: str) -> dict:
    """HLO instruction name -> first matching stage scope, from the
    ``op_name`` metadata of the compiled module."""
    out = {}
    pat = re.compile(r"%?([\w.\-]+) = .*?op_name=\"([^\"]*)\"")
    for m in pat.finditer(hlo_text):
        name, op_name = m.group(1), m.group(2)
        for s in SCOPES:
            if f"/{s}/" in op_name or op_name.endswith(f"/{s}"):
                # GPU kernels carry the instruction's name with '.' -> '_'.
                out[name] = out[name.replace(".", "_")] = s
                break
    return out


def _scope_of(event, hlo_map) -> str:
    stats = {k: v for k, v in event.stats}
    for v in stats.values():
        if isinstance(v, str):
            for s in SCOPES:
                if f"/{s}/" in v:
                    return s
    for key in ("hlo_op", "name"):
        v = stats.get(key)
        if isinstance(v, str) and v in hlo_map:
            return hlo_map[v]
    base = event.name.split(":")[0]
    return hlo_map.get(base, hlo_map.get(event.name, "other"))


def _reduce_trace(trace_dir: str, hlo_map: dict, n_steps: int) -> dict:
    from jax.profiler import ProfileData

    path = sorted(glob.glob(os.path.join(
        trace_dir, "**", "*.xplane.pb"), recursive=True))[-1]
    pd = ProfileData.from_file(path)
    planes = [p for p in pd.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit(
            "no GPU device plane in the trace: "
            + ", ".join(p.name for p in pd.planes)
        )
    plane = planes[0]
    lines = list(plane.lines)
    sample = []
    per_scope = {s: 0.0 for s in SCOPES + ("other",)}
    intervals = []
    kernel_lines = [ln for ln in lines if ln.name.startswith("Stream")]
    if not kernel_lines:
        kernel_lines = [ln for ln in lines if ln.name == "XLA Ops"]
    for ln in kernel_lines:
        for ev in ln.events:
            dur = float(ev.duration_ns)
            start = float(ev.start_ns)
            intervals.append((start, start + dur))
            per_scope[_scope_of(ev, hlo_map)] += dur
            if len(sample) < 40:
                sample.append({
                    "line": ln.name, "name": ev.name, "dur_ns": dur,
                    "stats": {k: str(v)[:200] for k, v in ev.stats},
                })
    intervals.sort()
    busy, end = 0.0, -1.0
    for a, b in intervals:
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    window = intervals[-1][1] - intervals[0][0] if intervals else 0.0
    return {
        "plane": plane.name,
        "lines": [ln.name for ln in lines],
        "events": len(intervals),
        "device_busy_ms_per_step": busy / n_steps / 1e6,
        "window_ms_per_step": window / n_steps / 1e6,
        "idle_share_in_window": 1.0 - busy / window if window else None,
        "scope_ms_per_step": {
            k: v / n_steps / 1e6 for k, v in per_scope.items()
        },
        "sample_events": sample,
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--trace-steps", type=int, default=5)
    ap.add_argument("--out", default=os.path.join(ROOT, "trace_out"),
                    help="directory for the detailed JSON")
    ap.add_argument("--no-command-buffers", action="store_true",
                    help="launch kernels one by one (full attribution)")
    args = ap.parse_args()

    import run_fusion
    from topfusion.io.synthetic import SyntheticScene
    from topfusion.models.block_pipeline import BlockPipeline

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, JAX's first device is {dev.platform}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip().splitlines()[0]

    cfg = dataclasses.replace(
        run_fusion.app_config(), camera=run_fusion.SYNTHETIC_VGA_CAMERA
    )
    scene = SyntheticScene()
    render = jax.jit(lambda T: scene.render_depth_mm(cfg.camera, T))
    poses = run_fusion.synthetic_trajectory(60)
    frames = [render(jnp.asarray(T, jnp.float32)) for T in poses]
    pipe = BlockPipeline(cfg)
    state = pipe.init()

    t0 = time.perf_counter()
    state, aux = pipe.step(state, frames[0])
    jax.block_until_ready(state)
    compile_s = time.perf_counter() - t0
    for f in frames[1:20]:                  # fill the map
        state, aux = pipe.step(state, f)
    jax.block_until_ready(state)

    # Steady state: chained steps, one fence.
    n = args.steps
    t0 = time.perf_counter()
    vis = []
    for i in range(n):
        state, aux = pipe.step(state, frames[20 + i % 40])
        vis.append(aux.num_visible)
    jax.block_until_ready(state)
    step_ms = (time.perf_counter() - t0) / n * 1e3
    n_visible = float(np.mean([int(v) for v in vis]))

    hlo = pipe.step.lower(state, frames[0]).compile().as_text()
    hlo_map = _hlo_scopes(hlo)
    with tempfile.TemporaryDirectory() as tdir:
        with jax.profiler.trace(tdir):
            for i in range(args.trace_steps):
                state, aux = pipe.step(state, frames[20 + i])
            jax.block_until_ready(state)
        tr = _reduce_trace(tdir, hlo_map, args.trace_steps)

    V = cfg.blockmap.max_visible_blocks
    nvox = cfg.blockmap.block_size ** 3
    depth_bytes = cfg.camera.width * cfg.camera.height * 4
    floor_bytes = 2 * V * nvox * 2 * 2 + depth_bytes
    peak = PEAK_BYTES_PER_S.get(dev.device_kind)
    integ_ms = tr["scope_ms_per_step"]["integrate"]
    floor_ms = floor_bytes / peak * 1e3 if peak else None
    result = {
        "card": card,
        "device_kind": dev.device_kind,
        "compile_s": compile_s,
        "step_ms": step_ms,
        "mean_visible_blocks": n_visible,
        "device_busy_ms_per_step": tr["device_busy_ms_per_step"],
        "idle_share_in_window": tr["idle_share_in_window"],
        "scope_ms_per_step": tr["scope_ms_per_step"],
        "integrate_floor_bytes": floor_bytes,
        "integrate_floor_ms": floor_ms,
        "integrate_floor_share": (
            floor_ms / integ_ms if floor_ms and integ_ms else None
        ),
        "hlo_ops_mapped": len(hlo_map),
    }
    out_dir = args.out
    os.makedirs(out_dir, exist_ok=True)
    name = "trace_step_nocb.json" if args.no_command_buffers else (
        "trace_step.json")
    result["command_buffers"] = not args.no_command_buffers
    with open(os.path.join(out_dir, name), "w") as f:
        json.dump({**result, "trace": tr}, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
