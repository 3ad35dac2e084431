"""IO tests: trajectory round-trip, checkpoints, dataset parsing, native
PNG loader vs imageio, point-cloud export."""

import os

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import tiny_test_config
from topfusion.geometry.se3 import se3_exp
from topfusion.io.trajectory import (
    ate_rmse,
    load_tum_trajectory,
    save_tum_trajectory,
)
from topfusion.utils.checkpoint import load_state, save_state


def random_poses(n, seed=0):
    rng = np.random.default_rng(seed)
    return [
        np.asarray(se3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)))
        for _ in range(n)
    ]


def test_tum_trajectory_roundtrip(tmp_path):
    poses = random_poses(10)
    path = str(tmp_path / "traj.txt")
    save_tum_trajectory(path, poses, timestamps=np.arange(10) * 0.1)
    stamps, loaded = load_tum_trajectory(path)
    np.testing.assert_allclose(stamps, np.arange(10) * 0.1, atol=1e-6)
    for a, b in zip(poses, loaded):
        np.testing.assert_allclose(a, b, atol=1e-4)


def test_ate_zero_for_identical():
    poses = random_poses(8)
    assert ate_rmse(poses, poses, align=False) < 1e-9


def test_ate_alignment_invariance():
    poses = random_poses(12, seed=1)
    offset = np.asarray(se3_exp(jnp.asarray([0.2, -0.1, 0.3, 1.0, 2.0, -0.5])))
    moved = [offset @ p for p in poses]
    assert ate_rmse(moved, poses, align=True) < 1e-5
    assert ate_rmse(moved, poses, align=False) > 0.1


def test_checkpoint_roundtrip(tmp_path):
    from topfusion.models.block_pipeline import BlockPipeline

    cfg = tiny_test_config()
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    state = state._replace(frame=jnp.asarray(7, jnp.int32))
    path = str(tmp_path / "ckpt.npz")
    save_state(path, state)
    restored = load_state(path, pipe.init())
    assert int(restored.frame) == 7
    for a, b in zip(state, restored):
        if isinstance(a, tuple):
            continue
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoint_shape_mismatch(tmp_path):
    from topfusion.models.block_pipeline import BlockPipeline
    import dataclasses

    cfg = tiny_test_config()
    pipe = BlockPipeline(cfg)
    path = str(tmp_path / "ckpt.npz")
    save_state(path, pipe.init())
    cfg2 = dataclasses.replace(
        cfg, blockmap=dataclasses.replace(cfg.blockmap, capacity=1 << 10)
    )
    pipe2 = BlockPipeline(cfg2)
    with pytest.raises(ValueError, match="config mismatch"):
        load_state(path, pipe2.init())


def _write_depth_png(path, arr):
    import imageio.v3 as iio

    iio.imwrite(path, arr.astype(np.uint16))


def test_native_png_decode_matches_imageio(tmp_path):
    from topfusion.io.native_loader import decode_png_native, native_available

    if not native_available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(0)
    arr = rng.integers(0, 60000, size=(48, 64)).astype(np.uint16)
    path = str(tmp_path / "d.png")
    _write_depth_png(path, arr)
    got = decode_png_native(path)
    assert got is not None
    np.testing.assert_array_equal(got, arr)


def test_native_loader_sequence(tmp_path):
    from topfusion.io.native_loader import NativeFrameLoader, native_available

    if not native_available():
        pytest.skip("native lib not built")
    rng = np.random.default_rng(1)
    frames = []
    paths = []
    for i in range(12):
        # stored at 5000 units/m like TUM
        arr = rng.integers(0, 30000, size=(32, 40)).astype(np.uint16)
        p = str(tmp_path / f"{i:04d}.png")
        _write_depth_png(p, arr)
        frames.append(arr)
        paths.append(p)
    loader = NativeFrameLoader(paths, units_per_meter=5000.0, n_threads=3)
    got = list(loader)
    loader.close()
    assert len(got) == 12
    for a, b in zip(got, frames):
        want = np.clip(np.round(b * (1000.0 / 5000.0)), 0, 65535).astype(np.uint16)
        np.testing.assert_array_equal(a, want)


def test_tum_sequence_parsing(tmp_path):
    from topfusion.io.datasets import TUMSequence

    root = tmp_path / "seq"
    os.makedirs(root / "depth")
    rng = np.random.default_rng(2)
    lines = []
    for i in range(3):
        arr = rng.integers(0, 20000, size=(24, 32)).astype(np.uint16)
        rel = f"depth/{i}.png"
        _write_depth_png(str(root / rel), arr)
        lines.append(f"{i*0.1:.4f} {rel}")
    (root / "depth.txt").write_text("# header\n" + "\n".join(lines) + "\n")
    save_poses = random_poses(3)
    from topfusion.io.trajectory import save_tum_trajectory

    save_tum_trajectory(str(root / "groundtruth.txt"), save_poses, [0.0, 0.1, 0.2])
    seq = TUMSequence(str(root))
    assert len(seq) == 3
    frames = list(seq)
    assert frames[0].depth_mm.shape == (24, 32)
    gt = seq.gt_pose_at(0.1)
    np.testing.assert_allclose(gt, save_poses[1], atol=1e-4)


def test_pointcloud_extraction():
    from topfusion.config import DenseVolumeConfig, TSDFConfig, CameraConfig
    from topfusion.ops.tsdf_dense import make_dense_volume, integrate_dense
    from topfusion.ops.pointcloud import extract_pointcloud_dense, save_ply

    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    tsdf = TSDFConfig(voxel_size=0.01, trunc_dist=0.04)
    dense = DenseVolumeConfig(dims=(64, 64, 64), origin=(-0.32, -0.32, 0.5))
    vol = make_dense_volume(dense)
    depth = jnp.full(cam.shape, 0.8, jnp.float32)  # wall at z=0.8
    vol = integrate_dense(vol, cam, tsdf, dense, jnp.eye(4), depth)
    pc = extract_pointcloud_dense(vol, tsdf, dense, max_points=1 << 16)
    count = int(pc.count)
    assert count > 500
    pts = np.asarray(pc.points)[np.asarray(pc.valid)]
    nrm = np.asarray(pc.normals)[np.asarray(pc.valid)]
    # all extracted points on the wall plane z=0.8
    assert np.abs(pts[:, 2] - 0.8).max() < 0.01
    # normals along +-z
    assert np.abs(nrm[:, 2]).min() > 0.9


def test_save_ply(tmp_path):
    from topfusion.ops.pointcloud import PointCloud, save_ply

    pc = PointCloud(
        points=jnp.asarray([[0.0, 0, 0], [1, 2, 3], [0, 0, 0]]),
        normals=jnp.asarray([[0.0, 0, 1], [0, 1, 0], [0, 0, 0]]),
        valid=jnp.asarray([True, True, False]),
        count=jnp.asarray(2),
    )
    path = str(tmp_path / "cloud.ply")
    n = save_ply(path, pc)
    assert n == 2
    text = open(path).read()
    assert "element vertex 2" in text
