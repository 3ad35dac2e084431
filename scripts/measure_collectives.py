#!/usr/bin/env python
"""Measure the sharded pipeline's per-step COLLECTIVE volume from the
compiled HLO (CPU mesh; no hardware needed).

The weak-scaling argument (docs/SCALING.md) rests on the claim that the
sharded step's inter-chip traffic is IMAGE-sized (composited splat keys +
attributes + the ICP Gram psums + the all-gathered allocation
candidates), independent of map size.  This script verifies it by
compiling `ShardedBlockPipeline.step` at several image sizes, device
counts, and map capacities and summing the bytes of every collective
operation (all-reduce / all-gather / collective-permute / all-to-all) in
the optimized HLO.

Usage:
  python scripts/measure_collectives.py [--devices 2 4 8]
"""

from __future__ import annotations

import argparse
import os
import re
import sys

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8"
).strip()
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

jax.config.update("jax_platforms", "cpu")

import dataclasses

import jax.numpy as jnp
import numpy as np

_DTYPE_BYTES = {
    "f64": 8, "f32": 4, "bf16": 2, "f16": 2,
    "s64": 8, "u64": 8, "s32": 4, "u32": 4,
    "s16": 2, "u16": 2, "s8": 1, "u8": 1, "pred": 1,
}
_COLLECTIVES = (
    "all-reduce", "all-gather", "collective-permute", "all-to-all",
    "reduce-scatter",
)
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")


def _shape_bytes(sig: str) -> int:
    """Total bytes of all array shapes in an HLO result signature."""
    total = 0
    for dt, dims in _SHAPE_RE.findall(sig):
        if dt not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dt]
    return total


def collective_bytes(compiled) -> dict:
    """Sum collective-op bytes in optimized HLO, by op kind."""
    out = {k: 0 for k in _COLLECTIVES}
    for mod in compiled.runtime_executable().hlo_modules():
        for line in mod.to_string().splitlines():
            line = line.strip()
            m = re.match(r"(?:ROOT )?[%\w.-]+ = (.*?) (" +
                         "|".join(_COLLECTIVES) + r")\(", line)
            if m:
                out[m.group(2)] += _shape_bytes(m.group(1))
    return out


def measure(n_dev: int, w: int, h: int, capacity: int) -> dict:
    from topfusion.config import (
        BlockMapConfig,
        CameraConfig,
        ICPConfig,
        PipelineConfig,
        PreprocConfig,
        RaycastConfig,
        TSDFConfig,
    )
    from topfusion.parallel.block_sharded import (
        ShardedBlockPipeline,
        make_mesh,
    )

    cam = CameraConfig(width=w, height=h, fx=0.75 * w, fy=0.75 * w,
                       cx=w / 2, cy=h / 2)
    cfg = PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3),
        icp=ICPConfig(iters=(4, 3, 2), level0_stride=1),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04),
        blockmap=BlockMapConfig(
            capacity=capacity,
            max_new_blocks_per_frame=min(1024, capacity),
            max_visible_blocks=min(2048, capacity),
            alloc_pixel_stride=2,
        ),
        raycast=RaycastConfig(max_steps=64),
    )
    mesh = make_mesh(n_dev)
    pipe = ShardedBlockPipeline(cfg, mesh)
    state = pipe.init()
    depth = jnp.zeros((h, w), jnp.uint16)
    compiled = pipe.step.lower(state, depth).compile()
    per_kind = collective_bytes(compiled)
    return {
        "devices": n_dev, "image": f"{w}x{h}", "pixels": w * h,
        "capacity": capacity,
        "total_bytes": sum(per_kind.values()),
        **{k: v for k, v in per_kind.items() if v},
    }


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--devices", type=int, nargs="+", default=[2, 4, 8])
    args = ap.parse_args()

    rows = []
    # Image scaling at fixed capacity (weak scaling: image grows with
    # the workload) and capacity scaling at fixed image (the claim:
    # collectives do NOT grow with the map).
    for nd in args.devices:
        for (w, h) in ((80, 64), (160, 128), (320, 256)):
            rows.append(measure(nd, w, h, 1 << 12))
    for cap in (1 << 12, 1 << 14):
        rows.append(measure(args.devices[0], 160, 128, cap))

    print(f"{'dev':>4} {'image':>9} {'capacity':>9} {'coll. KB/step':>14}")
    for r in rows:
        print(f"{r['devices']:>4} {r['image']:>9} {r['capacity']:>9} "
              f"{r['total_bytes']/1024:>14.1f}")
    # The claims, asserted:
    base = [r for r in rows if r["devices"] == args.devices[0]
            and r["capacity"] == 1 << 12]
    big = [r for r in rows if r["capacity"] == 1 << 14][0]
    small = [r for r in rows if r["devices"] == args.devices[0]
             and r["image"] == "160x128" and r["capacity"] == 1 << 12][0]
    growth = (base[-1]["total_bytes"] / base[0]["total_bytes"]) / (
        base[-1]["pixels"] / base[0]["pixels"]
    )
    cap_growth = big["total_bytes"] / small["total_bytes"]
    print(f"\nimage-scaling exponent vs area: {growth:.2f} "
          f"(1.0 = proportional)")
    print(f"capacity x4 -> collective volume x{cap_growth:.2f} "
          f"(claim: ~1.0, map-independent)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
