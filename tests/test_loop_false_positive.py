"""Loop-closure robustness: false positives must NOT close.

Round-3 VERDICT weak #7: appearance descriptors are 28-D histograms —
two similar-looking but DISTINCT places can rank as candidates; the
verification stack (ICP gates + observability + two-hypothesis
consistency) must reject them.  Two constructions:

  * translation-degenerate geometry (a bare corridor wall): ICP
    "verifies" from any start along the unobservable direction — the
    JtJ observability gate rejects it;
  * two geometrically similar but offset rooms: descriptor similarity
    nominates the other room, ICP converges poorly — rejected.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np

from topfusion.config import tiny_test_config
from topfusion.geometry.se3 import se3_exp
from topfusion.io.synthetic import SyntheticScene
from topfusion.models.posegraph import (
    add_keyframe,
    detect_loop,
    make_pose_graph,
)
from topfusion.ops.normals import compute_points_normals


def _kf_maps(scene, cam, T_true):
    d = scene.render_depth_mm(cam, jnp.asarray(T_true, jnp.float32))
    return compute_points_normals(cam, d.astype(jnp.float32) / 1000.0)


def test_degenerate_wall_does_not_close():
    """Keyframes sliding along an infinite wall + floor (the default
    scene's planes, spheres/boxes out of view): every pair of keyframes
    LOOKS alike and ICP aligns them perfectly along the unobservable
    axis — the observability gate must refuse all of them."""
    cfg = tiny_test_config()
    pgc = dataclasses.replace(
        cfg.posegraph, loop_candidate_window=2, loop_max_dist=2.0
    )
    cam = cfg.camera
    # Strip the scene to the translation-invariant planes only.
    scene = SyntheticScene(spheres=(), boxes=())
    pg = make_pose_graph(pgc, cam)
    for i in range(7):
        T = se3_exp(jnp.asarray([0, 0, 0, 0.25 * i, 0, 0], jnp.float32))
        p, n = _kf_maps(scene, cam, T)
        pg = add_keyframe(pg, T, p, n, jnp.asarray(i), jnp.asarray(True))
    pg, found, info = detect_loop(pg, cam, pgc, cfg.icp)
    assert not bool(found), (
        f"degenerate wall closed a false loop (inl={int(info.inliers)})"
    )
    assert int(pg.num_edges) == 6  # odometry chain only


def test_similar_but_distinct_rooms_do_not_close():
    """Room A and room B share the same furniture layout but with a
    DIFFERENT spacing — appearance histograms rank them as revisit
    candidates, verification must reject (and the true revisit of room A
    must still close, proving the gates are not just 'reject all')."""
    cfg = tiny_test_config()
    pgc = dataclasses.replace(
        cfg.posegraph, loop_candidate_window=2, loop_max_dist=0.5,
        loop_appearance_dist_factor=8.0,
    )
    cam = cfg.camera

    # Room A at origin; room B = same primitives shifted 1.5 m in x with
    # perturbed internal layout (box/sphere shifted differently).
    room_a = SyntheticScene()
    room_b = SyntheticScene(
        spheres=(
            (1.5 + 0.09, 0.1, 1.18, 0.25),
            (1.5 - 0.29, -0.15, 0.82, 0.15),
        ),
        boxes=((1.5 + 0.18, 0.01, 0.95, 0.12, 0.18, 0.12),),
    )
    both = SyntheticScene(
        spheres=room_a.spheres + room_b.spheres,
        boxes=room_a.boxes + room_b.boxes,
        planes=room_a.planes,
    )

    T_a = jnp.eye(4)
    T_b = se3_exp(jnp.asarray([0, 0, 0, 1.5, 0, 0], jnp.float32))

    pg = make_pose_graph(pgc, cam)
    p, n = _kf_maps(both, cam, T_a)
    pg = add_keyframe(pg, T_a, p, n, jnp.asarray(0), jnp.asarray(True))
    # Spacers fill the recency window, far away.
    for k in range(3):
        T = se3_exp(jnp.asarray([0, 0, 0, 30.0 + k, 0, 0], jnp.float32))
        p, n = _kf_maps(both, cam, T)
        pg = add_keyframe(
            pg, T, p, n, jnp.asarray(10 * (k + 1)), jnp.asarray(True)
        )

    # Camera in room B: similar view, different place.  No loop.
    p, n = _kf_maps(both, cam, T_b)
    pg_b = add_keyframe(pg, T_b, p, n, jnp.asarray(50), jnp.asarray(True))
    pg_b, found_b, _ = detect_loop(pg_b, cam, pgc, cfg.icp)
    assert not bool(found_b), "similar-but-distinct room closed a loop"

    # Control: a genuine revisit of room A (with 10 cm of drift) DOES
    # close against keyframe 0.
    T_re = jnp.eye(4).at[0, 3].set(0.10)
    p, n = _kf_maps(both, cam, T_a)
    pg_a = add_keyframe(pg, T_re, p, n, jnp.asarray(50), jnp.asarray(True))
    pg_a, found_a, info = detect_loop(pg_a, cam, pgc, cfg.icp)
    assert bool(found_a), "true revisit rejected — gates too strict"
    ne = int(pg_a.num_edges)
    loops = [
        e for e in range(ne)
        if bool(pg_a.edge_is_loop[e])
        and int(pg_a.edge_j[e]) == int(pg_a.num_kf) - 1
    ]
    assert loops and int(pg_a.edge_i[loops[0]]) == 0
    assert int(info.inliers) > 0 and float(info.residual) < pgc.huber_delta
