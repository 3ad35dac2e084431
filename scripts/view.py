#!/usr/bin/env python
"""Interactive free-view map viewer: step a saved reconstruction with
keyboard moves and re-render through the ranged free-view raycast.

The offline analogue of the reference demo's interactive cv::viz mode
(reference: apps/demo.cpp:48-68 take_cloud/interactive keys, :106-115
camera-follow viewer): load a run directory written by apps/run_fusion.py
(config.json + state.npz), then drive the camera with keys — each move
re-renders the map from the new pose and writes ``view.png`` in the run
directory (watch it with any auto-reloading image viewer).

Keys: w/s forward/back, a/d strafe, r/f up/down, j/l yaw, i/k pitch,
o = jump to an orbit vantage of the map centroid, p = print pose,
q = quit.  Non-interactive: ``--script wwjjq`` replays a key string.

Usage:
  python scripts/view.py /tmp/run
  python scripts/view.py /tmp/run --script "wwjjsskk" --step 0.05
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from topfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("run_dir", help="output directory of apps/run_fusion.py")
    ap.add_argument("--script", default=None,
                    help="key string to replay non-interactively")
    ap.add_argument("--step", type=float, default=0.1, help="move step (m)")
    ap.add_argument("--deg", type=float, default=10.0, help="turn step (deg)")
    args = ap.parse_args()

    import jax.numpy as jnp

    from topfusion.geometry.viewpath import (
        map_centroid,
        move_pose,
        orbit_path,
    )
    from topfusion.models.block_pipeline import BlockPipeline
    from topfusion.utils.checkpoint import load_state
    from topfusion.utils.config_io import load_config
    from topfusion.utils.png import write_png

    cfg_path = os.path.join(args.run_dir, "config.json")
    if not os.path.exists(cfg_path):  # run directories from older versions
        cfg_path = os.path.join(args.run_dir, "config.yaml")
    cfg = load_config(cfg_path)
    pipe = BlockPipeline(cfg)
    state = load_state(
        os.path.join(args.run_dir, "state.npz"), pipe.init()
    )
    T = np.asarray(state.T_wc)
    bm = cfg.blockmap.block_size * cfg.tsdf.voxel_size
    center = map_centroid(
        np.asarray(state.block_coords),
        int(np.asarray(state.num_blocks)),
        bm,
    )
    out_png = os.path.join(args.run_dir, "view.png")

    def render(T_np):
        img = np.asarray(pipe.render(state, jnp.asarray(T_np, jnp.float32)))
        write_png(out_png, img)
        cov = img.any(axis=-1).mean()
        print(
            f"pose t=({T_np[0,3]:+.2f},{T_np[1,3]:+.2f},{T_np[2,3]:+.2f})  "
            f"coverage {cov:.0%}  -> {out_png}"
        )

    print(
        f"map: {int(np.asarray(state.num_blocks))} blocks, "
        f"centroid {np.round(center, 2)}"
    )
    render(T)

    def keys():
        if args.script is not None:
            yield from args.script
            return
        print("keys: w/s a/d r/f j/l i/k move, o orbit view, p pose, q quit")
        while True:
            line = input("> ")
            if not line:
                continue
            yield from line.strip()

    for k in keys():
        if k == "q":
            break
        if k == "p":
            print(T)
            continue
        if k == "o":
            T = orbit_path(center, T, 8)[1]
        else:
            T = move_pose(T, k, step_m=args.step, step_deg=args.deg)
        render(T)
    return 0


if __name__ == "__main__":
    sys.exit(main())
