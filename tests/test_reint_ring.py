"""Post-loop re-integration WITHOUT keyframe thinning (reint ring).

Round-3 VERDICT missing #4: keyframe-only rebuild re-fuses 1/keyframe_every
of the data.  With ``posegraph.reint_ring`` the rebuild re-fuses every
ring frame at its per-frame corrected pose.  The acceptance metric is
SURFACE quality (cloud-to-GT-SDF RMS against the analytic scene), not
just ATE: the ring rebuild must land within 1.2x of a full re-fusion
from ALL frames at the same poses, and beat the keyframe-thinned rebuild
on fused-data volume.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from tests.test_slam import make_cfg, out_and_back
from topfusion.io.synthetic import SyntheticScene
from topfusion.models.slam import SlamSystem
from topfusion.ops.pointcloud import extract_pointcloud_blocks


def _surface_rms(scene: SyntheticScene, state, cfg) -> float:
    pc = extract_pointcloud_blocks(state.block_map(), cfg.tsdf, cfg.blockmap)
    pts = np.asarray(pc.points)[np.asarray(pc.valid)]
    assert len(pts) > 100
    d = np.asarray(scene.sdf(jnp.asarray(pts, jnp.float32)))
    return float(np.sqrt(np.mean(np.square(d))))


def _run(cfg, frames):
    slam = SlamSystem(cfg)
    ke = cfg.posegraph.keyframe_every
    for s in range(0, len(frames) - len(frames) % ke, ke):
        slam.process_chunk(frames[s : s + ke])
    return slam


def test_ring_reintegration_full_rate_surface_quality():
    scene = SyntheticScene()
    base = make_cfg()
    gt = out_and_back(30)
    frames = np.stack(
        [
            np.asarray(
                scene.render_depth_mm(base.camera, jnp.asarray(T, jnp.float32))
            )
            for T in gt
        ]
    )

    # Force a map correction on every closure so the rebuild runs.
    base = dataclasses.replace(
        base,
        posegraph=dataclasses.replace(base.posegraph, min_map_correction=0.0),
    )
    cfg_kf = base                                   # keyframe-only rebuild
    cfg_ring = dataclasses.replace(
        base,
        posegraph=dataclasses.replace(base.posegraph, reint_ring=32),
    )

    slam_kf = _run(cfg_kf, frames)
    slam_ring = _run(cfg_ring, frames)
    assert slam_ring.reintegrations >= 1, "no loop closure fired"
    assert slam_kf.reintegrations >= 1

    # Full-rate offline reference: fresh map, every frame fused at the
    # ring system's corrected trajectory (the best any rebuild could do
    # with these poses).
    import jax

    ref = SlamSystem(cfg_ring)
    fuse = jax.jit(ref._fuse_at_impl)
    st = ref.pipe.init()
    for f, T in zip(frames, slam_ring.optimized_trajectory()):
        st = fuse(st, jnp.asarray(f), jnp.asarray(T, jnp.float32))

    rms_full = _surface_rms(scene, st, cfg_ring)
    rms_ring = _surface_rms(scene, slam_ring.state, cfg_ring)
    rms_kf = _surface_rms(scene, slam_kf.state, cfg_kf)

    # Ring rebuild reaches full-refusion surface quality.
    assert rms_ring <= 1.2 * rms_full + 1e-4, (
        f"ring {rms_ring*1000:.2f} mm vs full {rms_full*1000:.2f} mm "
        f"(kf-only {rms_kf*1000:.2f} mm)"
    )
    # And the rebuilt map is not data-starved: the ring map carries at
    # least as much fused weight as the keyframe-thinned one.
    w_ring = float(np.asarray(slam_ring.state.weight, np.float32).sum())
    w_kf = float(np.asarray(slam_kf.state.weight, np.float32).sum())
    assert w_ring > 1.5 * w_kf, (w_ring, w_kf)


def test_ring_records_and_survives_double_closure():
    """Two successive corrections must not double-apply (the device
    anchors re-anchor after each rebuild)."""
    scene = SyntheticScene()
    base = make_cfg()
    base = dataclasses.replace(
        base,
        posegraph=dataclasses.replace(
            base.posegraph, min_map_correction=0.0, reint_ring=32,
            max_keyframes=32, max_edges=128,
        ),
    )
    gt = out_and_back(30) + out_and_back(30)[1:]
    frames = np.stack(
        [
            np.asarray(
                scene.render_depth_mm(base.camera, jnp.asarray(T, jnp.float32))
            )
            for T in gt
        ]
    )
    slam = _run(base, frames)
    assert slam.reintegrations >= 2, "needs two closures to test re-anchor"
    from topfusion.io.trajectory import ate_rmse

    gt_np = [np.asarray(g) for g in gt[: len(slam.odom_poses)]]
    ate = ate_rmse(slam.optimized_trajectory(), gt_np)
    assert ate < 5 * base.tsdf.voxel_size, f"ATE {ate*1000:.1f} mm"
    rms = _surface_rms(scene, slam.state, base)
    assert np.isfinite(rms) and rms < 10 * base.tsdf.voxel_size
    # THE re-anchor invariant (what double-correction would break): after
    # the final rebuild, the newest keyframe's device odometry anchor
    # equals its optimized pose (correction = identity for frames
    # anchored to it), and the ring poses of the final chunk agree with
    # the host-corrected exported odometry — device and host views of
    # the correction are the same.
    kidx = len(slam.kf_odom_poses) - 1
    np.testing.assert_allclose(
        np.asarray(slam.kf_odom_buf)[kidx],
        np.asarray(slam.graph.kf_poses)[kidx],
        atol=1e-5,
    )
    R = base.posegraph.reint_ring
    f_last = slam.frame_idx - 1
    np.testing.assert_allclose(
        np.asarray(slam.ring_poses)[f_last % R],
        slam.odom_poses[f_last],
        atol=1e-4,
    )
