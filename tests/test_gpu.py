"""Numerics that only a GPU can get wrong (tests marked ``gpu``).

They skip on the CPU.  ``chip_smoke.py`` runs them on the card with
``TOPFUSION_TEST_PLATFORM=cuda,cpu``, so the GPU is the default device and
the CPU backend stays available as the reference.  What they guard: a
float32 matrix product at default precision may run in TF32 on the card
(about 3 significant digits), so every product the package states as
``HIGHEST`` must come out at float32 accuracy there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import CameraConfig
from topfusion.geometry.camera import backproject_grid
from topfusion.geometry.se3 import mat_mul, se3_exp
from topfusion.io.synthetic import SyntheticScene
from topfusion.ops.gather_mm import banded_projective_gather
from topfusion.ops.icp import build_normal_equations
from topfusion.ops.normals import normals_from_point_map

pytestmark = pytest.mark.gpu

VGA = CameraConfig(
    width=640, height=480, fx=500.0, fy=500.0, cx=320.0, cy=240.0
)


@jax.jit
def _gram(points, normals, T_est):
    return build_normal_equations(
        VGA, T_est, jnp.eye(4), points, normals, points, normals,
        dist_thresh=0.1, angle_cos_thresh=0.866, gather_mode="flat",
    )


def test_icp_normal_equations_full_precision_on_gpu(gpu_device):
    depth = SyntheticScene().render_depth_mm(VGA, jnp.eye(4))
    pts = backproject_grid(VGA, depth.astype(jnp.float32) * 1e-3)
    nrm = normals_from_point_map(pts, jnp.zeros(3))
    T_est = se3_exp(jnp.asarray([0.004, -0.003, 0.002, 0.005, 0.003, -0.004]))
    G_gpu, n_gpu = _gram(pts, nrm, T_est)
    cpu = jax.devices("cpu")[0]
    G_cpu, n_cpu = _gram(*jax.device_put((pts, nrm, T_est), cpu))
    assert int(n_gpu) == int(n_cpu) > 50_000
    G_gpu = np.asarray(G_gpu, np.float64)
    G_cpu = np.asarray(G_cpu, np.float64)
    # Entry-wise against the Cauchy-Schwarz scale sqrt(G_ii G_jj): float32
    # sums in another order stay near 1e-6 of it, TF32 lands near 1e-3.
    d = np.sqrt(np.diag(G_cpu))
    rel = np.abs(G_gpu - G_cpu) / np.maximum(np.outer(d, d), 1e-30)
    assert rel.max() < 1e-4, rel.max()


def test_onehot_gather_exact_on_gpu(gpu_device):
    rng = np.random.default_rng(0)
    model = rng.normal(size=(480, 640, 6)).astype(np.float32)
    jitter = rng.integers(-12, 12, (240, 320))
    vi = np.clip((2 * np.arange(240))[:, None] + jitter, 0, 479)
    ui = rng.integers(0, 640, (240, 320))
    out, ok = jax.jit(banded_projective_gather, static_argnames="v_margin")(
        jnp.asarray(model), jnp.asarray(ui, jnp.int32),
        jnp.asarray(vi, jnp.int32), v_margin=16,
    )
    assert np.asarray(ok).all()
    np.testing.assert_array_equal(np.asarray(out), model[vi, ui])


def test_pose_composition_full_precision_on_gpu(gpu_device):
    rng = np.random.default_rng(2)
    xi = rng.normal(scale=0.3, size=(512, 6)).astype(np.float32)
    T = np.asarray(se3_exp(jnp.asarray(xi)), np.float64)
    got = np.asarray(jax.jit(mat_mul)(jnp.asarray(T, jnp.float32),
                                      jnp.asarray(T[::-1], jnp.float32)))
    want = T @ T[::-1]
    assert np.abs(got - want).max() < 1e-5


def test_integrate_blocks_on_gpu_matches_numpy_reference(gpu_device):
    from tests.test_integrate_reference import (
        test_integrate_blocks_matches_numpy_reference as check,
    )

    check("int16")
