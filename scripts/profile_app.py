#!/usr/bin/env python
"""Profile the chunked SLAM app's per-chunk host timeline on the device.

Splits each process_chunk call into: chunk dispatch+execute (fenced),
host fetch, keyframe bookkeeping, loop-closure dispatches, and render —
to attribute any gap between the device pipeline fps (bench.py) and the
app-loop fps (apps/run_fusion.py).
"""

from __future__ import annotations

import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
from topfusion.utils.compile_cache import enable_compile_cache  # noqa: E402

enable_compile_cache()

import numpy as np


def main() -> int:
    import jax
    import jax.numpy as jnp

    from topfusion.io.synthetic import SyntheticScene, orbit_trajectory
    from topfusion.models.slam import SlamSystem
    from bench import make_cfg

    cfg = make_cfg()
    cam = cfg.camera
    scene = SyntheticScene()
    n, chunk = 60, 10
    gt = orbit_trajectory(n, max_angle_deg=5.0, max_shift=0.05, seed=2)
    render_chunk = jax.jit(
        lambda Ts: jax.vmap(lambda T: scene.render_depth_mm(cam, T))(Ts)
    )
    chunks = [
        render_chunk(
            jnp.asarray(np.stack(gt[i : i + chunk]), jnp.float32)
        )
        for i in range(0, n, chunk)
    ]
    np.asarray(chunks[-1][0, 0, 0])

    slam = SlamSystem(cfg)
    t0 = time.perf_counter()
    slam.warmup(chunk)
    print(f"warmup {time.perf_counter()-t0:.1f} s", flush=True)

    # Instrument: pure chunk dispatch+fence vs the full process_chunk.
    for it, dc in enumerate(chunks):
        t0 = time.perf_counter()
        out = slam._chunk(
            slam.state, slam.graph, slam.kf_depth_buf, dc, None,
            jnp.asarray(slam.frame_idx, jnp.int32), jnp.asarray(True),
        )
        t_dispatch = time.perf_counter() - t0

        t0 = time.perf_counter()
        jax.block_until_ready(out)
        t_exec = time.perf_counter() - t0

        t0 = time.perf_counter()
        fetched = jax.device_get(out[3:])
        t_fetch = time.perf_counter() - t0

        t0 = time.perf_counter()
        infos = slam.process_chunk(dc, do_kf=True)
        t_full = time.perf_counter() - t0
        print(
            f"chunk {it}: dispatch {t_dispatch*1e3:7.1f} ms, "
            f"exec-fence {t_exec*1e3:7.1f} ms, fetch {t_fetch*1e3:7.1f} ms, "
            f"full process_chunk {t_full*1e3:7.1f} ms "
            f"(loop={infos[0]['loop']})",
            flush=True,
        )

    t0 = time.perf_counter()
    img = np.asarray(slam.render())
    print(f"render: {time.perf_counter()-t0:.2f} s, std {img.std():.1f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
