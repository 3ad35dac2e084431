#!/usr/bin/env python
"""Offline reconstruction demo: sequence in, trajectory + mesh + video out.

The replacement for the reference's interactive demo app
(reference: apps/demo.cpp — OpenCV windows, hard-coded Windows frame paths
at demo.cpp:91-97).  Runs a TUM/ICL sequence directory or a synthetic
analytic scene through the SLAM system and writes:

  out_dir/trajectory_odom.txt     TUM-format odometry trajectory
  out_dir/trajectory_opt.txt      pose-graph-optimized trajectory
  out_dir/state.npz               map + pose checkpoint
  out_dir/cloud.ply               extracted surface point cloud
  out_dir/metrics.json{l}         per-frame + summary metrics
  out_dir/render_*.png            rendered raycast views (every N frames)
  out_dir/config.json             the resolved configuration

The SLAM loop is CHUNKED (models/slam.py): one jitted dispatch per
``keyframe_every`` frames, so the app loop runs at device-pipeline speed
instead of paying a host sync + dispatch per frame — the real-time
product surface matching the reference's interactive loop
(reference: apps/demo.cpp:86-129).

Usage:
  python apps/run_fusion.py --synthetic 90 --out /tmp/run
  python apps/run_fusion.py --sequence /data/rgbd_dataset_freiburg1_desk \
      --out /tmp/fr1desk --set tsdf.voxel_size=0.005 --render-every 30
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from topfusion.config import CameraConfig, PipelineConfig

# Cameras of the --synthetic sequences (--synthetic-vga picks the first).
SYNTHETIC_VGA_CAMERA = CameraConfig(
    width=640, height=480, fx=500.0, fy=500.0, cx=320.0, cy=240.0
)
SYNTHETIC_QVGA_CAMERA = CameraConfig(
    width=320, height=240, fx=250.0, fy=250.0, cx=160.0, cy=120.0
)


def synthetic_trajectory(n: int):
    """Ground-truth poses of the ``--synthetic N`` sequence."""
    from topfusion.io.synthetic import orbit_trajectory

    return orbit_trajectory(n, max_angle_deg=5.0, max_shift=0.05, seed=2)


def app_config(
    config_path: str | None = None, overrides=(), rgb: bool = False
) -> PipelineConfig:
    """The app's configuration: a config file (or the library defaults),
    the app's VGA operating point for every value ``overrides`` leaves
    alone, then the dotted ``overrides``."""
    from topfusion.utils.config_io import apply_overrides, load_config

    cfg = load_config(config_path) if config_path else PipelineConfig()
    cfg = apply_overrides(cfg, overrides)

    def unset(key):
        return not any(key in o for o in overrides)

    # The library default max_visible_blocks (2^14) is a conservative
    # bound for large scenes; every per-frame gather/sort/scatter in
    # integrate+splat scales with it (PADDED, not actual occupancy).
    # The app sizes it to the actual VGA frustum band (~3-4k blocks at
    # 5 mm voxels) and uses the reference's own int16 Voxel_s pool
    # encoding.  VGA operating point (config.RaycastConfig/BlockMapConfig
    # notes): 96 surfels/block + observed-depth occlusion culling.  The
    # bench runs K=80; the SLAM app keeps 96 — K=80 costs 7.6 -> 11.2 mm
    # odometry ATE on the loop-closure trajectory.
    bm = cfg.blockmap
    if unset("max_visible_blocks"):
        bm = dataclasses.replace(bm, max_visible_blocks=1 << 12)
    if unset("pool_dtype"):
        bm = dataclasses.replace(bm, pool_dtype="int16")
    if unset("visible_occlusion_cull"):
        bm = dataclasses.replace(bm, visible_occlusion_cull=True)
    cfg = dataclasses.replace(cfg, blockmap=bm)
    if unset("surfels_per_block"):
        cfg = dataclasses.replace(
            cfg, raycast=dataclasses.replace(cfg.raycast, surfels_per_block=96)
        )
    if rgb:
        cfg = dataclasses.replace(
            cfg, tsdf=dataclasses.replace(cfg.tsdf, use_color=True)
        )
    return cfg


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--sequence", help="TUM/ICL sequence directory")
    ap.add_argument("--synthetic", type=int, metavar="N",
                    help="run N synthetic frames instead of a dataset")
    ap.add_argument("--synthetic-vga", action="store_true",
                    help="synthetic frames at 640x480 (default 320x240)")
    ap.add_argument("--out", required=True, help="output directory")
    ap.add_argument("--config", help="YAML/JSON config file")
    ap.add_argument("--set", dest="overrides", action="append", default=[],
                    help="dotted config override, e.g. tsdf.voxel_size=0.01")
    ap.add_argument("--max-frames", type=int, default=0)
    ap.add_argument("--chunk", type=int, default=0,
                    help="frames per device dispatch (default: ~1 second "
                    "of frames, rounded to the keyframe cadence — per-"
                    "chunk dispatch/fetch overheads amortize over enough "
                    "frames to hold sensor rate; keyframes still insert "
                    "at every cadence WITHIN the chunk)")
    ap.add_argument("--rgb", action="store_true",
                    help="fuse color and write a color render "
                    "(synthetic scenes render RGB; TUM sequences load it)")
    ap.add_argument("--render-every", type=int, default=0,
                    help="save a rendered view every N frames")
    ap.add_argument("--no-posegraph", action="store_true",
                    help="odometry only (no keyframes/loop closure)")
    ap.add_argument("--video", action="store_true",
                    help="write out/video.gif from per-chunk raycast "
                    "renders (the reference's live display analogue, "
                    "reference: apps/demo.cpp:106-115)")
    ap.add_argument("--render-mode", default="grey",
                    choices=("grey", "normals", "confidence", "color"),
                    help="shading of the final render_final.png: phong "
                    "grey, normal colors, fusion-confidence heatmap, or "
                    "fused voxel color (the reference's render-type enum, "
                    "reference: VisualisationEngine.hpp:12-109 + pixel "
                    "shaders VisualisationEngine_Shared.hpp:272-498)")
    ap.add_argument("--orbit-video", type=int, default=0, metavar="N",
                    help="after the run, re-render the final map from an "
                    "N-pose auto-orbit around the reconstructed geometry "
                    "via the ranged free-view raycast -> out/orbit.gif "
                    "(the cv::viz free-view analogue, reference: "
                    "apps/demo.cpp:48-68,106-115)")
    args = ap.parse_args(argv)

    from topfusion.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    import jax.numpy as jnp

    from topfusion.utils.config_io import save_config
    from topfusion.utils.metrics import MetricsLogger
    from topfusion.utils.checkpoint import save_run
    from topfusion.utils.png import write_png
    from topfusion.io.trajectory import ate_rmse

    os.makedirs(args.out, exist_ok=True)

    cfg = app_config(args.config, args.overrides, rgb=args.rgb)
    camera_overridden = any(
        o.split("=")[0].strip().startswith("camera.") for o in args.overrides
    )

    # Frame source: a generator of (depth_chunk [N,H,W], rgb_chunk|None).
    gt_poses = None
    timestamps = None
    if args.synthetic:
        import jax

        from topfusion.io.synthetic import SyntheticScene

        if camera_overridden:
            cam = cfg.camera
        elif args.synthetic_vga:
            cam = SYNTHETIC_VGA_CAMERA
        else:
            cam = SYNTHETIC_QVGA_CAMERA
        cfg = dataclasses.replace(cfg, camera=cam)
        scene = SyntheticScene()
        n_total = args.synthetic
        gt_poses = synthetic_trajectory(n_total)
        ke = cfg.posegraph.keyframe_every
        chunk = args.chunk or ke * max(1, 30 // ke)

        # Per-FRAME jitted renders: rendering is test-data generation,
        # not framework work (a real sensor or the native prefetch
        # loader delivers frames concurrently with fusion).
        render_one = jax.jit(lambda T: scene.render_depth_mm(cam, T))
        render_rgb_one = (
            jax.jit(lambda T: scene.render_rgb(cam, T)) if args.rgb else None
        )

        def _all_chunks():
            # Pre-render the synthetic sequence to device memory UP FRONT.
            frames = [
                render_one(jnp.asarray(T, jnp.float32)) for T in gt_poses
            ]
            rgbs = (
                [render_rgb_one(jnp.asarray(T, jnp.float32)) for T in gt_poses]
                if args.rgb
                else None
            )
            out = []
            for c0 in range(0, n_total - n_total % chunk, chunk):
                out.append(
                    (
                        jnp.stack(frames[c0:c0 + chunk]),
                        jnp.stack(rgbs[c0:c0 + chunk]) if rgbs else None,
                    )
                )
            for k in range(n_total - n_total % chunk, n_total):
                out.append(
                    (
                        frames[k][None],
                        rgbs[k][None] if rgbs else None,
                    )
                )
            jax.block_until_ready(out)
            return out

        _prerendered = _all_chunks()

        def chunks():
            yield from _prerendered
    elif args.sequence:
        from topfusion.io.datasets import open_sequence

        seq = open_sequence(args.sequence, with_rgb=args.rgb)
        cfg = dataclasses.replace(cfg, camera=seq.camera)
        timestamps = []
        if seq.groundtruth is not None:
            gt_poses = []
        n_total = len(seq)
        if args.max_frames:
            n_total = min(n_total, args.max_frames)
        ke = cfg.posegraph.keyframe_every
        chunk = args.chunk or ke * max(1, 30 // ke)

        def chunks():
            buf, rgb_buf = [], []
            for k, fr in enumerate(seq):
                if k >= n_total:
                    break
                timestamps.append(fr.timestamp)
                if gt_poses is not None:
                    gt_poses.append(seq.gt_pose_at(fr.timestamp))
                buf.append(np.asarray(fr.depth_mm))
                if args.rgb and fr.rgb is not None:
                    rgb_buf.append(np.asarray(fr.rgb))
                if len(buf) == chunk:
                    yield np.stack(buf), (
                        np.stack(rgb_buf) if rgb_buf else None
                    )
                    buf, rgb_buf = [], []
            for i, d in enumerate(buf):  # remainder, frame at a time
                yield d[None], (rgb_buf[i][None] if rgb_buf else None)
    else:
        ap.error("need --sequence or --synthetic")

    save_config(os.path.join(args.out, "config.json"), cfg)

    from topfusion.models.slam import SlamSystem

    # Display rendering rides INSIDE the chunk dispatch (one more output
    # of the compiled step) whenever the run wants imagery — no separate
    # render dispatch per chunk (reference renders in-loop too,
    # reference: tfusion/src/topfu.cpp:284-285).
    want_renders = bool(args.video or args.render_every)
    slam = SlamSystem(cfg, render_in_chunk=want_renders)
    metrics = MetricsLogger(os.path.join(args.out, "metrics.jsonl"))

    # Only the GIF outputs need imageio (PNGs go through
    # topfusion.utils.png).  Import it up front: a missing package fails
    # before the run, and a first import inside the timed loop would
    # cost the first chunk's budget.
    if args.video or args.orbit_video:
        try:
            import imageio.v3 as iio
        except ImportError as e:
            raise SystemExit(
                "--video/--orbit-video write GIFs through imageio, which "
                "is not installed"
            ) from e

    print("warmup (compiling the chunk/optimize/reintegrate dispatches)...")
    t_w = time.perf_counter()
    slam.warmup(chunk, with_rgb=args.rgb)
    warmup_s = time.perf_counter() - t_w
    print(f"warmup done in {warmup_s:.1f} s")

    print(f"running {n_total} frames (chunk={chunk})...")
    metrics.reset_timer()
    t_start = time.perf_counter()
    t_after_first = None
    frames_after_first = 0
    done = 0
    next_render = 0
    video_frames = []
    # Display previews ride one chunk behind: the half-res preview's
    # device-to-host copy is ISSUED right after its chunk and CONSUMED
    # after the next chunk's dispatch has the device busy, so the copy
    # and the host's PNG/GIF work overlap device compute instead of
    # adding to the loop.
    pending_preview = None
    pending_done = 0

    # In-run keyboard control on a TTY (the reference demo's Space=pause
    # / Esc=quit loop, reference: apps/demo.cpp:106-129; line-buffered
    # here: press the key then Enter).  'p' pauses until Enter, 'q'
    # stops the run cleanly (all outputs still written).
    def _poll_key():
        import select

        if not sys.stdin.isatty():
            return None
        r, _, _ = select.select([sys.stdin], [], [], 0)
        if not r:
            return None
        return (sys.stdin.readline().strip()[:1] or " ").lower()

    def _consume_preview():
        nonlocal next_render
        if pending_preview is None:
            return
        img = np.asarray(pending_preview)
        if args.video:
            video_frames.append(img)
        if args.render_every and pending_done > next_render:
            next_render = pending_done + args.render_every - 1
            write_png(
                os.path.join(args.out, f"render_{pending_done:05d}.png"),
                img,
            )

    for depth_chunk, rgb_chunk in chunks():
        if args.max_frames and done >= args.max_frames:
            break
        key = _poll_key()
        if key in ("p", " "):
            print("paused at frame", done, "- press Enter to resume")
            sys.stdin.readline()
        elif key == "q":
            print(f"stopped by user at frame {done}")
            break
        n = depth_chunk.shape[0]
        # Keyframe cadence: the chunk generator is aligned so full chunks
        # start on multiples of keyframe_every (chunk defaults to it).
        do_kf = (
            not args.no_posegraph
            and done % cfg.posegraph.keyframe_every == 0
        )
        infos = slam.process_chunk(depth_chunk, do_kf=do_kf, rgb=rgb_chunk)
        _consume_preview()  # previous chunk's preview, transfer overlapped
        for info in infos:
            metrics.log_frame(info)
        ovf = max(i.get("visible_overflow", 0) for i in infos)
        if ovf > 0:
            print(
                f"WARNING: visible-set overflow — {ovf} allocated blocks "
                f"truncated by blockmap.max_visible_blocks="
                f"{cfg.blockmap.max_visible_blocks} this chunk (silent "
                f"under-integration); raise the bound for this scene "
                f"density",
                file=sys.stderr,
            )
        done += n
        if t_after_first is None:
            t_after_first = time.perf_counter()
        else:
            frames_after_first += n
        if want_renders:
            # Half-res preview (the GIF/periodic PNGs are previews —
            # render_final.png and --orbit-video stay full quality);
            # start its copy now.
            pending_preview = slam.last_render[::2, ::2]
            pending_done = done
            try:
                pending_preview.copy_to_host_async()
            except (AttributeError, NotImplementedError):
                pass
    _consume_preview()  # flush the final chunk's preview
    t_end = time.perf_counter()

    summary = metrics.summary()
    summary["warmup_s"] = warmup_s
    summary["app_fps_total"] = done / max(t_end - t_start, 1e-9)
    if t_after_first is not None and frames_after_first > 0:
        summary["app_fps_steady"] = frames_after_first / max(
            t_end - t_after_first, 1e-9
        )
    opt = slam.optimized_trajectory()
    if gt_poses is not None and all(g is not None for g in gt_poses or []):
        gt_list = [np.asarray(g) for g in gt_poses[: len(slam.odom_poses)]]
        summary["ate_odom_m"] = ate_rmse(slam.odom_poses, gt_list)
        summary["ate_opt_m"] = ate_rmse(opt, gt_list)
        print(f"ATE odometry: {summary['ate_odom_m']*1000:.1f} mm, "
              f"optimized: {summary['ate_opt_m']*1000:.1f} mm")
    summary["loops_closed"] = slam.loops_closed
    print(f"summary: {summary}")

    # Surface cloud export.
    from topfusion.ops.pointcloud import extract_pointcloud_blocks, save_ply

    pc = extract_pointcloud_blocks(
        slam.state.block_map(), cfg.tsdf, cfg.blockmap
    )
    n_pts = save_ply(os.path.join(args.out, "cloud.ply"), pc)
    print(f"extracted {n_pts} surface points -> cloud.ply")

    if args.video and video_frames:
        # One raycast view per chunk; GIF (no ffmpeg in this image).
        iio.imwrite(
            os.path.join(args.out, "video.gif"),
            np.stack(video_frames),
            fps=5,
        )
        print(f"{len(video_frames)}-frame render video -> video.gif")

    if args.orbit_video:
        import jax.numpy as _jnp

        from topfusion.geometry.viewpath import map_centroid, orbit_path

        bm = cfg.blockmap.block_size * cfg.tsdf.voxel_size
        center = map_centroid(
            np.asarray(slam.state.block_coords),
            int(np.asarray(slam.state.num_blocks)),
            bm,
        )
        path = orbit_path(
            center, np.asarray(slam.state.T_wc), args.orbit_video
        )
        orbit_frames = [
            np.asarray(slam.pipe.render(slam.state, _jnp.asarray(T)))
            for T in path
        ]
        iio.imwrite(
            os.path.join(args.out, "orbit.gif"),
            np.stack(orbit_frames),
            fps=10,
        )
        hit = np.stack(orbit_frames).any(axis=-1).mean()
        print(
            f"{len(orbit_frames)}-pose free-view orbit -> orbit.gif "
            f"(mean coverage {hit:.0%})"
        )

    if args.rgb:
        img = np.asarray(slam.pipe.render_color(slam.state))
        write_png(os.path.join(args.out, "render_color.png"), img)
        print("color render -> render_color.png")

    # Final still in the requested shading mode (the reference's render-
    # type switch; confidence = fusion-weight heatmap).
    render_fns = {
        "grey": lambda: slam.pipe.render(slam.state),
        "normals": lambda: slam.pipe.render_normals(slam.state),
        "confidence": lambda: slam.pipe.render_confidence(slam.state),
        "color": lambda: slam.pipe.render_color(slam.state),
    }
    final = np.asarray(render_fns[args.render_mode]())
    write_png(os.path.join(args.out, "render_final.png"), final)
    print(f"final {args.render_mode} render -> render_final.png")

    save_run(
        args.out,
        slam.state,
        slam.odom_poses,
        opt,
        timestamps,
        metrics=summary,
    )
    metrics.close()
    print(f"outputs in {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
