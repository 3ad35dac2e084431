"""Scaling-efficiency measurement of the sharded block pipeline.

Runs the weak- and strong-scaling harness (BASELINE.md configs 4-5) over
however many devices the backend exposes.  On the CPU CI mesh, run with:

    python scripts/measure_scaling.py --cpu

On a host with several GPUs, run it without ``--cpu``.  Prints one JSON
line per mode.
"""
import json
import os
import sys

if "--cpu" in sys.argv:
    os.environ["XLA_FLAGS"] = (
        os.environ.get("XLA_FLAGS", "")
        + " --xla_force_host_platform_device_count=8"
    ).strip()
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

if "--cpu" in sys.argv:
    jax.config.update("jax_platforms", "cpu")

from topfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

from topfusion.config import (
    BlockMapConfig,
    CameraConfig,
    ICPConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.parallel.multihost import measure_scaling_block


def main() -> None:
    n = len(jax.devices())
    cam = CameraConfig(width=320, height=240, fx=250.0, fy=250.0, cx=160.0, cy=120.0)
    cfg = PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=5),
        icp=ICPConfig(iters=(8, 4, 2)),
        tsdf=TSDFConfig(voxel_size=0.005, trunc_dist=0.02),
        blockmap=BlockMapConfig(
            capacity=1 << 13,
            max_new_blocks_per_frame=2048,
            max_visible_blocks=1 << 12,
        ),
        raycast=RaycastConfig(max_steps=96),
    )
    counts = [c for c in (1, 2, 4, 8) if c <= n]
    for mode in ("weak", "strong"):
        res = measure_scaling_block(cfg, device_counts=counts, mode=mode)
        print(json.dumps({str(k): (round(v, 3) if isinstance(v, float) else v)
                          for k, v in res.items()}))


if __name__ == "__main__":
    main()
