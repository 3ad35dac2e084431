"""Synthetic RGB-D sequence generation from analytic SDF scenes.

The reference validated by substituting known ground-truth trajectories
(commented loader at reference: tfusion/src/topfu.cpp:225-240); it ships no
test data.  This module renders depth images of an analytic scene (spheres +
planes + boxes) by sphere tracing the exact SDF, giving sequences with exact
ground-truth trajectories for unit/integration tests and benchmarks without
any dataset on disk.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from topfusion.config import CameraConfig
from topfusion.geometry.se3 import HIGHEST, se3_exp, se3_inverse
from topfusion.geometry.camera import pixel_grid


@dataclasses.dataclass(frozen=True)
class SyntheticScene:
    """Analytic SDF scene: union of spheres, axis-aligned boxes and planes.

    All geometry in world meters.  Default scene: a room-like setup with a
    back wall, floor, one sphere and one box in front of the origin —
    enough structure for 6-DoF ICP to lock onto.
    """

    spheres: Tuple[Tuple[float, float, float, float], ...] = (
        (0.0, 0.1, 1.1, 0.25),      # (cx, cy, cz, r)
        (-0.35, -0.15, 0.9, 0.15),
    )
    boxes: Tuple[Tuple[float, float, float, float, float, float], ...] = (
        (0.25, 0.05, 0.85, 0.12, 0.18, 0.12),  # (cx, cy, cz, hx, hy, hz)
    )
    # Planes as (nx, ny, nz, d): sdf = dot(n, p) + d, n unit, inside positive.
    planes: Tuple[Tuple[float, float, float, float], ...] = (
        (0.0, 0.0, -1.0, 1.6),      # back wall at z = 1.6
        (0.0, -1.0, 0.0, 0.45),     # floor at y = 0.45 (y points down)
    )

    def sdf(self, p: jnp.ndarray) -> jnp.ndarray:
        """Exact signed distance at world points p (..., 3)."""
        d = jnp.full(p.shape[:-1], jnp.inf, p.dtype)
        for cx, cy, cz, r in self.spheres:
            c = jnp.asarray([cx, cy, cz], p.dtype)
            d = jnp.minimum(d, jnp.linalg.norm(p - c, axis=-1) - r)
        for cx, cy, cz, hx, hy, hz in self.boxes:
            c = jnp.asarray([cx, cy, cz], p.dtype)
            h = jnp.asarray([hx, hy, hz], p.dtype)
            q = jnp.abs(p - c) - h
            outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
            inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
            d = jnp.minimum(d, outside + inside)
        for nx, ny, nz, off in self.planes:
            n = jnp.asarray([nx, ny, nz], p.dtype)
            d = jnp.minimum(d, jnp.sum(p * n, axis=-1) + off)
        return d

    def render_depth(
        self,
        cam: CameraConfig,
        T_wc: jnp.ndarray,
        max_depth: float = 5.0,
        n_steps: int = 128,
    ) -> jnp.ndarray:
        """Sphere-trace exact depth [H, W] in meters (0 = no hit)."""
        h, w = cam.height, cam.width
        uv = pixel_grid(cam)
        dirs_cam = jnp.stack(
            [
                (uv[..., 0] - cam.cx) / cam.fx,
                (uv[..., 1] - cam.cy) / cam.fy,
                jnp.ones((h, w), jnp.float32),
            ],
            axis=-1,
        )
        R = T_wc[:3, :3]
        o = T_wc[:3, 3]
        dirs_w = jnp.einsum("ij,hwj->hwi", R, dirs_cam, precision=HIGHEST)
        dir_norm = jnp.linalg.norm(dirs_w, axis=-1)

        def body(_, t):
            p = o + t[..., None] * dirs_w
            d = self.sdf(p)
            return t + d / dir_norm

        t = lax.fori_loop(0, n_steps, body, jnp.full((h, w), 0.05, jnp.float32))
        p = o + t[..., None] * dirs_w
        hit = (jnp.abs(self.sdf(p)) < 1e-3) & (t > 0.0) & (t < max_depth)
        return jnp.where(hit, t, 0.0)

    def render_depth_mm(self, cam, T_wc, **kw) -> jnp.ndarray:
        """Depth as u16 millimeters (the sensor format,
        reference: tfusion/include/tfusion/types.hpp:56 Depth = u16)."""
        d = self.render_depth(cam, T_wc, **kw)
        return jnp.round(d * 1000.0).astype(jnp.uint16)

    # ------------------------------------------------------------- color
    def primitive_colors(self) -> jnp.ndarray:
        """One palette RGB (in [0, 1]) per primitive, in sdf() order
        (spheres, boxes, planes)."""
        n = len(self.spheres) + len(self.boxes) + len(self.planes)
        palette = jnp.asarray(
            [
                [0.9, 0.2, 0.2],
                [0.2, 0.8, 0.3],
                [0.25, 0.35, 0.9],
                [0.9, 0.8, 0.2],
                [0.8, 0.3, 0.8],
                [0.3, 0.8, 0.8],
                [0.9, 0.55, 0.2],
                [0.6, 0.6, 0.6],
            ],
            jnp.float32,
        )
        return palette[jnp.arange(n) % palette.shape[0]]

    def color_at(self, p: jnp.ndarray) -> jnp.ndarray:
        """Albedo at world points p (..., 3): the palette color of the
        nearest primitive (flat shading — exactly recoverable from the
        fused color volume, which is what the color tests assert)."""
        dists = []
        for cx, cy, cz, r in self.spheres:
            c = jnp.asarray([cx, cy, cz], p.dtype)
            dists.append(jnp.linalg.norm(p - c, axis=-1) - r)
        for cx, cy, cz, hx, hy, hz in self.boxes:
            c = jnp.asarray([cx, cy, cz], p.dtype)
            h = jnp.asarray([hx, hy, hz], p.dtype)
            q = jnp.abs(p - c) - h
            outside = jnp.linalg.norm(jnp.maximum(q, 0.0), axis=-1)
            inside = jnp.minimum(jnp.max(q, axis=-1), 0.0)
            dists.append(outside + inside)
        for nx, ny, nz, off in self.planes:
            n = jnp.asarray([nx, ny, nz], p.dtype)
            dists.append(jnp.sum(p * n, axis=-1) + off)
        which = jnp.argmin(jnp.stack(dists, axis=-1), axis=-1)
        return self.primitive_colors()[which]

    def render_rgb(
        self, cam: CameraConfig, T_wc: jnp.ndarray, **kw
    ) -> jnp.ndarray:
        """Flat-albedo RGB image [H, W, 3] uint8 registered to the depth
        image (black where depth is invalid) — the synthetic stand-in for
        the reference's registered OpenNI RGB stream
        (reference: tfusion/src/capture.cpp:228-240)."""
        d = self.render_depth(cam, T_wc, **kw)
        h, w = cam.height, cam.width
        uv = pixel_grid(cam)
        dirs_cam = jnp.stack(
            [
                (uv[..., 0] - cam.cx) / cam.fx,
                (uv[..., 1] - cam.cy) / cam.fy,
                jnp.ones((h, w), jnp.float32),
            ],
            axis=-1,
        )
        R = T_wc[:3, :3]
        o = T_wc[:3, 3]
        dirs_w = jnp.einsum("ij,hwj->hwi", R, dirs_cam, precision=HIGHEST)
        p = o + d[..., None] * dirs_w
        rgb = jnp.where(d[..., None] > 0.0, self.color_at(p), 0.0)
        return jnp.round(rgb * 255.0).astype(jnp.uint8)


def corridor_scene(length_m: float = 12.0, box_every: float = 0.6) -> SyntheticScene:
    """A long corridor: side walls + floor + ceiling planes and a row of
    boxes marching down +z.  Forward motion through it allocates FRESH
    blocks every frame — the allocation-stress benchmark scenario
    (bench.py --scenario sweep), unlike the orbit whose working set
    saturates after the first pass."""
    boxes = []
    z = 0.8
    k = 0
    while z < length_m:
        side = -0.45 if k % 2 == 0 else 0.45
        boxes.append((side, 0.25 - 0.15 * (k % 3), z, 0.12, 0.15, 0.12))
        z += box_every
        k += 1
    return SyntheticScene(
        spheres=(),
        boxes=tuple(boxes),
        planes=(
            (1.0, 0.0, 0.0, 0.8),     # left wall  x = -0.8
            (-1.0, 0.0, 0.0, 0.8),    # right wall x = +0.8
            (0.0, -1.0, 0.0, 0.45),   # floor      y = +0.45 (y down)
            (0.0, 1.0, 0.0, 0.8),     # ceiling    y = -0.8
        ),
    )


def sweep_trajectory(
    n_frames: int, step_m: float = 0.03, sway: float = 0.04
) -> List[np.ndarray]:
    """Forward dolly down the corridor with gentle lateral/angular sway
    (keeps ICP 6-DoF constrained without revisiting geometry)."""
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        xi = np.array(
            [
                0.03 * np.sin(4 * np.pi * s),
                0.05 * np.sin(2 * np.pi * s),
                0.0,
                sway * np.sin(6 * np.pi * s),
                0.5 * sway * np.cos(6 * np.pi * s),
                step_m * i,
            ],
            np.float32,
        )
        poses.append(np.asarray(se3_exp(jnp.asarray(xi))))
    return poses


def add_depth_noise(
    depth_mm: np.ndarray, sigma_mm: float, seed: int = 0
) -> np.ndarray:
    """Additive Gaussian sensor noise (sigma in millimeters) on a u16
    depth image; invalid (0) pixels stay invalid.  Sensor-model stand-in
    for the accuracy protocol's noise levels (BASELINE.md)."""
    if sigma_mm <= 0.0:
        return depth_mm
    rng = np.random.default_rng(seed)
    d = depth_mm.astype(np.float32)
    noisy = d + rng.normal(0.0, sigma_mm, size=d.shape).astype(np.float32)
    noisy = np.where(d > 0, np.clip(np.round(noisy), 1, 65535), 0)
    return noisy.astype(np.uint16)


def orbit_trajectory(
    n_frames: int,
    max_angle_deg: float = 8.0,
    max_shift: float = 0.08,
    seed: int = 0,
    smooth: bool = True,
) -> List[np.ndarray]:
    """Ground-truth camera-to-world poses: smooth sinusoidal 6-DoF wander
    around identity (keeps the default scene in view)."""
    rng = np.random.default_rng(seed)
    phases = rng.uniform(0.0, 2 * np.pi, size=6)
    freqs = rng.uniform(0.7, 1.3, size=6)
    poses = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        amp = np.sin(2 * np.pi * freqs * s + phases) * np.sin(np.pi * s) \
            if smooth else np.sin(2 * np.pi * freqs * s + phases)
        ang = np.deg2rad(max_angle_deg) * amp[:3]
        shift = max_shift * amp[3:]
        xi = jnp.asarray(
            np.concatenate([ang, shift]), jnp.float32
        )
        poses.append(np.asarray(se3_exp(xi)))
    return poses


def make_sequence(
    cam: CameraConfig,
    n_frames: int,
    scene: SyntheticScene | None = None,
    seed: int = 0,
    **orbit_kw,
) -> Tuple[List[np.ndarray], List[np.ndarray], SyntheticScene]:
    """Convenience: (depth_mm frames, ground-truth poses, scene)."""
    scene = scene or SyntheticScene()
    poses = orbit_trajectory(n_frames, seed=seed, **orbit_kw)
    render = jax.jit(lambda T: scene.render_depth_mm(cam, T))
    depths = [np.asarray(render(jnp.asarray(T))) for T in poses]
    return depths, poses, scene
