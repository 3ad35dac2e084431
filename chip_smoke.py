#!/usr/bin/env python
"""GPU smoke test: the system's main path, once, on one CUDA card.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python chip_smoke.py               # phases 1-4 on one card
    python chip_smoke.py --four-cards  # the sharded system on 4 cards only

Phases (any failure exits non-zero before the last line is printed):

1. Device: JAX's first device must be a GPU (no CPU fallback).  Prints the
   card's name and power limit, the JAX version and the device count.
2. Card-only tests: ``pytest -m gpu`` in a child process, before this
   process opens the card (a JAX process reserves most of the card's
   memory, so only one may hold it at a time).
3. Main path: ``apps/run_fusion.py``'s ``main()`` on 60 synthetic VGA
   frames at the app's operating point (5 mm voxels, 8^3 blocks, a 2^16
   block int16 pool, 2^12 visible blocks, K=96 surfels, occlusion
   culling, pose graph with loop closure on).  Every frame must track,
   nothing may reset, the map and the final render must be non-trivial,
   and the odometry ATE must stay under ``ATE_BOUND_M``.
4. Agreement: the first 10 frames through ``BlockPipeline`` on the GPU
   and on the CPU backend, compared per frame and over the fused pool.
5. ``--four-cards``: ``ShardedSlamSystem`` on a 4-card mesh against the
   single-card ``SlamSystem`` on the phase-3 sequence.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
import xml.etree.ElementTree as ET

ROOT = os.path.dirname(os.path.abspath(__file__))

N_FRAMES = 60          # phase-3 sequence length (two 30-frame chunks)
N_AGREE = 10           # phase-4 frames
# Phase-3 odometry ATE bound: the same 60 frames through the app on the
# CPU backend gave 0.327 mm; the bound adds 1 mm for the GPU's other
# summation order (PERF.md, "Bring-up on the H100").
ATE_BOUND_M = 0.000327 + 0.001
# Phase-4 tolerances, GPU against the CPU backend on identical frames.
# The GPU sums in another order and its transcendentals round
# differently; every discrete decision downstream (pixel rounding in
# projection, truncation-band and frustum gates, splat z-buffer ties,
# block allocation) can flip on a last-bit difference, and frame-to-model
# ICP feeds each flip into the next frame's model maps.  So the two runs
# agree to the tracker's own noise level, not bit for bit:
AGREE_T_M = 1e-3       # per-frame camera translation, metres
# Per-frame camera rotation, degrees.  Looser than translation: over a
# scene a metre or two away, ICP trades a small rotation about the
# vertical axis against a sideways translation, so rotation is the
# weakly held part of the pose.  Measured on an H100 against two CPU
# references: 0.056 deg (AVX-512 code) and 0.163 deg (AVX2 code); the
# two CPU references alone differ by up to 0.019 deg.
AGREE_R_DEG = 0.5
# Allocated blocks per frame: each block is a discrete decision on the
# pose, and a sub-millimetre pose difference flips the few whose
# truncation band edge falls inside it.
AGREE_BLOCKS_REL = 0.005
# Voxels of the blocks both runs allocated: the share whose fusion
# weight agrees (the update decision flips at band edges and pixel
# boundaries, as above) ...
AGREE_WEIGHT_SHARE = 0.95
# ... and among voxels observed equally often by both runs, the 99th
# percentile of the difference of their signed distances (tsdf * mu):
# the two maps put the surface within less than half a 5 mm voxel of
# each other (measured 1.0 and 1.3 mm).  The fusion arithmetic itself
# is held to one int16 quantum on the card by tests/test_gpu.py (phase
# 2), where both sides fuse at the same pose.
AGREE_SDF_P99_M = 2e-3
# --four-cards: sharded-vs-single odometry cross-ATE, the bound
# tests/test_sharded_slam.py uses on the CPU mesh.
CROSS_ATE_M = 2e-3


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ------------------------------------------------------------- phase 1
_PROBE = (
    "import json, jax; d = jax.devices(); "
    "print(json.dumps({'platform': d[0].platform, 'kind': d[0].device_kind,"
    " 'count': len(d), 'jax': jax.__version__}))"
)


def phase_device(need: int) -> dict:
    """Probe the devices in a child process (it exits and frees the card
    before the tests' process opens it)."""
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        timeout=300,
    )
    check(r.returncode == 0, f"JAX device probe failed:\n{r.stderr[-2000:]}")
    dev = json.loads(r.stdout.strip().splitlines()[-1])
    check(
        dev["platform"] == "gpu",
        f"JAX's first device is {dev['platform']!r}, not a GPU",
    )
    check(dev["count"] >= need, f"need {need} GPUs, JAX sees {dev['count']}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr[-500:]}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"card: {card}")
    log(f"jax {dev['jax']}, {dev['count']} {dev['kind']} device(s)")
    dev["card"] = card
    return dev


# ------------------------------------------------------------- phase 2
def phase_gpu_tests() -> None:
    with tempfile.TemporaryDirectory() as tmp:
        xml = os.path.join(tmp, "gpu.xml")
        env = dict(os.environ, TOPFUSION_TEST_PLATFORM="cuda,cpu")
        r = subprocess.run(
            [sys.executable, "-m", "pytest", "tests", "-m", "gpu", "-q",
             "-p", "no:cacheprovider", f"--junitxml={xml}"],
            cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
        )
        tail = (r.stdout + r.stderr)[-3000:]
        check(os.path.exists(xml), f"pytest wrote no report:\n{tail}")
        suite = ET.parse(xml).getroot()
        if suite.tag == "testsuites":
            suite = suite[0]
        counts = {k: int(suite.get(k, 0))
                  for k in ("tests", "failures", "errors", "skipped")}
    check(
        r.returncode == 0 and counts["tests"] > 0
        and counts["failures"] == counts["errors"] == counts["skipped"] == 0,
        f"card-only tests: {counts}, rc {r.returncode}\n{tail}",
    )
    log(f"gpu tests: {counts['tests']} passed")


# ------------------------------------------------------------- phase 3
def phase_main_path(out: str, card: str) -> None:
    sys.path.insert(0, os.path.join(ROOT, "apps"))
    import run_fusion
    from topfusion.utils.png import read_png

    # A fresh directory per run: the app appends to its metrics log.
    os.makedirs(out, exist_ok=True)
    out = tempfile.mkdtemp(prefix="run_", dir=out)
    rc = run_fusion.main([
        "--synthetic", str(N_FRAMES), "--synthetic-vga",
        "--render-every", "30", "--out", out,
    ])
    check(rc == 0, f"run_fusion.main returned {rc}")
    with open(os.path.join(out, "metrics.jsonl")) as f:
        frames = [json.loads(line) for line in f]
    with open(os.path.join(out, "metrics.json")) as f:
        summary = json.load(f)
    check(len(frames) == N_FRAMES, f"{len(frames)} frames logged")
    lost = [i for i, fr in enumerate(frames) if not fr["ok"]]
    check(not lost, f"tracking lost at frames {lost}")
    check(summary["resets"] == 0, f"{summary['resets']} resets")
    check(frames[-1]["blocks"] > 0, "the map is empty")
    img = read_png(os.path.join(out, "render_final.png"))
    check(img.std() > 1.0, "render_final.png is a constant image")
    ate = summary["ate_odom_m"]
    check(
        ate < ATE_BOUND_M,
        f"odometry ATE {ate * 1e3:.3f} mm >= bound {ATE_BOUND_M * 1e3} mm",
    )
    log(
        f"main path on {card}: {summary['app_fps_steady']:.2f} frames/s "
        f"steady, warm-up {summary['warmup_s']:.1f} s, odometry ATE "
        f"{ate * 1e3:.3f} mm (bound {ATE_BOUND_M * 1e3} mm), "
        f"{frames[-1]['blocks']} blocks, loops closed "
        f"{summary['loops_closed']}"
    )


# ------------------------------------------------------------- phase 4
def _vga_config():
    sys.path.insert(0, os.path.join(ROOT, "apps"))
    import run_fusion

    return dataclasses.replace(
        run_fusion.app_config(), camera=run_fusion.SYNTHETIC_VGA_CAMERA
    ), run_fusion.synthetic_trajectory


def _vga_frames(cfg, trajectory, n: int):
    """Depth frames of the phase-3 sequence, rendered once and held on
    the host so both backends fuse identical input."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from topfusion.io.synthetic import SyntheticScene

    scene = SyntheticScene()
    render = jax.jit(lambda T: scene.render_depth_mm(cfg.camera, T))
    poses = trajectory(N_FRAMES)[:n]
    return [np.asarray(render(jnp.asarray(T, jnp.float32))) for T in poses]


def _run_block_pipeline(cfg, frames, device):
    import jax
    import numpy as np

    from topfusion.models.block_pipeline import BlockPipeline

    with jax.default_device(device):
        pipe = BlockPipeline(cfg)
        state = pipe.init()
        poses, blocks = [], []
        for f in frames:
            state, aux = pipe.step(state, jax.device_put(f, device))
            check(bool(aux.ok), f"tracking lost on {device.platform}")
            poses.append(np.asarray(state.T_wc, np.float64))
            blocks.append(int(aux.num_blocks))
        return poses, blocks, jax.device_get(state)


def _pool_by_coord(state):
    import numpy as np

    n = int(state.num_blocks)
    coords = np.asarray(state.block_coords[:n])
    return {tuple(c): i for i, c in enumerate(coords)}


def phase_agreement() -> None:
    import jax
    import numpy as np

    from topfusion.ops.blockmap import decode_tsdf

    cfg, trajectory = _vga_config()
    frames = _vga_frames(cfg, trajectory, N_AGREE)
    gpu, cpu = jax.devices()[0], jax.devices("cpu")[0]
    t0 = time.perf_counter()
    p_g, b_g, s_g = _run_block_pipeline(cfg, frames, gpu)
    t1 = time.perf_counter()
    p_c, b_c, s_c = _run_block_pipeline(cfg, frames, cpu)
    t2 = time.perf_counter()

    dt = [np.linalg.norm(a[:3, 3] - b[:3, 3]) for a, b in zip(p_g, p_c)]
    dr = []
    for a, b in zip(p_g, p_c):
        # Angle of the relative rotation from its skew part (atan2 stays
        # accurate near zero, where arccos of the trace does not).
        rel = a[:3, :3].T @ b[:3, :3]
        skew = np.array([rel[2, 1] - rel[1, 2], rel[0, 2] - rel[2, 0],
                         rel[1, 0] - rel[0, 1]])
        dr.append(np.degrees(np.arctan2(
            np.linalg.norm(skew) / 2.0, (np.trace(rel) - 1.0) / 2.0
        )))
    by_g, by_c = _pool_by_coord(s_g), _pool_by_coord(s_c)
    common = sorted(set(by_g) & set(by_c))
    check(common, "the two runs allocated no common block")
    rows_g = np.asarray([by_g[k] for k in common])
    rows_c = np.asarray([by_c[k] for k in common])
    mu = cfg.tsdf.trunc_dist
    sdf_g = np.asarray(decode_tsdf(s_g.tsdf[rows_g])) * mu
    sdf_c = np.asarray(decode_tsdf(s_c.tsdf[rows_c])) * mu
    w_g = np.asarray(s_g.weight[rows_g])
    w_c = np.asarray(s_c.weight[rows_c])
    same_w = w_g == w_c
    seen = same_w & (w_g > 0)
    d_sdf = np.abs(sdf_g - sdf_c)[seen]
    w_share = float(same_w.mean())
    quantum = float((d_sdf <= mu / 32767.0 * 1.0001).mean())
    blocks_rel = max(abs(g - c) / c for g, c in zip(b_g, b_c))
    q50, q99, q999 = np.quantile(d_sdf, [0.5, 0.99, 0.999])
    log(
        f"agreement over {N_AGREE} VGA frames (gpu {t1 - t0:.1f} s, cpu "
        f"{t2 - t1:.1f} s incl. compile): max translation "
        f"{max(dt) * 1e3:.4f} mm (bound {AGREE_T_M * 1e3} mm), max rotation "
        f"{max(dr):.5f} deg (bound {AGREE_R_DEG}); num_blocks gpu {b_g} "
        f"cpu {b_c}, max relative difference {blocks_rel:.5f} (bound "
        f"{AGREE_BLOCKS_REL}); {len(common)} common blocks, weights equal "
        f"on {w_share:.6f} of voxels (bound {AGREE_WEIGHT_SHARE}); where "
        f"observed equally often, |d sdf| p50 {q50 * 1e3:.4f} p99 "
        f"{q99 * 1e3:.4f} (bound {AGREE_SDF_P99_M * 1e3}) p99.9 "
        f"{q999 * 1e3:.4f} mm, within one int16 quantum on {quantum:.6f}"
    )
    check(max(dt) <= AGREE_T_M, f"translation differs by {max(dt)} m")
    check(max(dr) <= AGREE_R_DEG, f"rotation differs by {max(dr)} deg")
    check(blocks_rel <= AGREE_BLOCKS_REL, f"num_blocks: {b_g} vs {b_c}")
    check(w_share >= AGREE_WEIGHT_SHARE, f"weights agree on {w_share}")
    check(q99 <= AGREE_SDF_P99_M, f"|d sdf| p99 is {q99} m")


# ------------------------------------------------------------- phase 5
def _run_slam(slam, frames, chunk: int):
    import numpy as np

    for c0 in range(0, len(frames), chunk):
        infos = slam.process_chunk(
            np.stack(frames[c0:c0 + chunk]), do_kf=True
        )
        check(all(i["ok"] for i in infos), "tracking lost")
    return slam


def phase_four_cards(card: str) -> None:
    import jax

    from topfusion.io.trajectory import ate_rmse
    from topfusion.models.slam import SlamSystem
    from topfusion.parallel.block_sharded import make_mesh
    from topfusion.parallel.sharded_slam import ShardedSlamSystem

    cfg, trajectory = _vga_config()
    frames = _vga_frames(cfg, trajectory, N_FRAMES)
    ke = cfg.posegraph.keyframe_every
    chunk = ke * max(1, 30 // ke)          # the app's default chunk
    t0 = time.perf_counter()
    single = _run_slam(SlamSystem(cfg), frames, chunk)
    t1 = time.perf_counter()
    sharded = _run_slam(ShardedSlamSystem(cfg, make_mesh(4)), frames, chunk)
    t2 = time.perf_counter()
    cross = ate_rmse(sharded.odom_poses, single.odom_poses, align=False)
    log(
        f"four cards ({card} x4): sharded-vs-single odometry cross-ATE "
        f"{cross * 1e3:.4f} mm (bound {CROSS_ATE_M * 1e3} mm), keyframes "
        f"{int(sharded.graph.num_kf)}/{int(single.graph.num_kf)}, loops "
        f"{sharded.loops_closed}/{single.loops_closed}, single {t1 - t0:.1f} s"
        f", sharded {t2 - t1:.1f} s (incl. compile)"
    )
    check(cross < CROSS_ATE_M, f"cross-ATE {cross} m")


# ---------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded system on a 4-card mesh")
    ap.add_argument("--out", default=os.path.join(ROOT, "smoke_out"),
                    help="directory for the app's outputs (phase 3)")
    args = ap.parse_args(argv)
    if not os.path.isdir(os.path.join(ROOT, "topfusion")):
        print("chip_smoke.py must run from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # Phase 4 compiles for the CPU backend too, and a shared persistent
    # compile cache may hand those executables to another host next
    # time; capping the CPU code at AVX2 keeps them runnable on any
    # x86-64 host a card sits in.  Set before any process starts JAX.
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "") + " --xla_cpu_max_isa=AVX2"
    ).strip()
    try:
        dev = phase_device(4 if args.four_cards else 1)
        if not args.four_cards:
            phase_gpu_tests()
        from topfusion.utils.compile_cache import enable_compile_cache

        log(f"compile cache: {enable_compile_cache()}")
        import jax

        if args.four_cards:
            phase_four_cards(dev["card"])
        else:
            phase_main_path(args.out, dev["card"])
            phase_agreement()
        devs = jax.devices()
        check(devs[0].platform == "gpu", "JAX left the GPU")
    except SmokeFailure as e:
        print(f"FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": devs[0].platform,
            "kind": devs[0].device_kind,
            "count": len(devs),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
