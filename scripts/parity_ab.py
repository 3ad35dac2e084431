#!/usr/bin/env python
"""Reference-semantics parity A/B: exact mode vs fast mode ATE.

BASELINE.md's accuracy protocol: the bar is set by running the reference
*algorithm semantics* in this framework (exact mode =
``reference_exact_config``: positional bilateral/pyramid windows with
invalid neighbours, per-pixel "take" gathers + bilinear association,
level-0 stride 1, full-march raycast model maps, no occlusion culling)
and checking that the production fast mode (flat row-gather ICP, nearest
association, stride 2, splat model maps) tracks the same trajectory.

Runs the 90-frame VGA synthetic orbit at two sensor-noise levels and
prints a markdown table of ATEs + the fast/exact ratio (docs/RESULTS.md
records the committed numbers).

Usage:  python scripts/parity_ab.py [--frames 90] [--cpu] [--small]
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from topfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def run_mode(cfg, depths, gt):
    import jax
    import jax.numpy as jnp

    from topfusion.io.trajectory import ate_rmse
    from topfusion.models.block_pipeline import BlockPipeline

    pipe = BlockPipeline(cfg)
    state = pipe.init()
    poses = []
    t0 = time.perf_counter()
    for d in depths:
        state, aux = pipe.step(state, jnp.asarray(d))
        poses.append(np.asarray(state.T_wc))
        assert bool(aux.ok), "tracking lost"
    dt = time.perf_counter() - t0
    return ate_rmse(poses, [np.asarray(g) for g in gt], align=False), dt


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=90)
    ap.add_argument("--cpu", action="store_true", help="force CPU backend")
    ap.add_argument("--small", action="store_true",
                    help="160x120 camera (fast CI-scale run)")
    ap.add_argument("--noise", type=float, nargs="*", default=[0.0, 1.0],
                    help="sensor noise sigmas in mm")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    import dataclasses

    import jax
    import jax.numpy as jnp

    from topfusion.config import (
        BlockMapConfig,
        CameraConfig,
        PipelineConfig,
        RaycastConfig,
        reference_exact_config,
    )
    from topfusion.io.synthetic import (
        SyntheticScene,
        add_depth_noise,
        orbit_trajectory,
    )

    if args.small:
        cam = CameraConfig(width=160, height=120, fx=125.0, fy=125.0,
                           cx=80.0, cy=60.0)
    else:
        cam = CameraConfig(width=640, height=480, fx=500.0, fy=500.0,
                           cx=320.0, cy=240.0)
    fast_cfg = PipelineConfig(
        camera=cam,
        blockmap=BlockMapConfig(max_visible_blocks=4096),
        raycast=RaycastConfig(max_steps=192),
    )
    exact_cfg = reference_exact_config(fast_cfg)

    scene = SyntheticScene()
    gt = orbit_trajectory(args.frames, max_angle_deg=5.0, max_shift=0.05,
                          seed=2)
    render = jax.jit(lambda T: scene.render_depth_mm(cam, T))
    clean = [np.asarray(render(jnp.asarray(T, jnp.float32))) for T in gt]

    rows = []
    for sigma in args.noise:
        depths = [
            add_depth_noise(d, sigma, seed=1000 + i)
            for i, d in enumerate(clean)
        ]
        ate_exact, t_exact = run_mode(exact_cfg, depths, gt)
        ate_fast, t_fast = run_mode(fast_cfg, depths, gt)
        ratio = ate_fast / max(ate_exact, 1e-9)
        rows.append((sigma, ate_exact, ate_fast, ratio, t_exact, t_fast))
        print(
            f"noise {sigma:.1f} mm: exact ATE {ate_exact*1000:.2f} mm "
            f"({args.frames/t_exact:.1f} fps), fast ATE "
            f"{ate_fast*1000:.2f} mm ({args.frames/t_fast:.1f} fps), "
            f"fast/exact = {ratio:.3f}"
        )

    print("\n| noise (mm) | exact ATE (mm) | fast ATE (mm) | fast/exact |"
          " exact fps | fast fps |")
    print("|---|---|---|---|---|---|")
    for sigma, ae, af, r, te, tf in rows:
        print(f"| {sigma:.1f} | {ae*1000:.2f} | {af*1000:.2f} | {r:.3f} |"
              f" {args.frames/te:.1f} | {args.frames/tf:.1f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
