"""Color voxel variant: fusion + color raycast rendering."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from topfusion.config import (
    CameraConfig,
    DenseVolumeConfig,
    ICPConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.io.synthetic import SyntheticScene
from topfusion.models.pipeline import DensePipeline


def make_cfg():
    cam = CameraConfig(width=80, height=64, fx=60.0, fy=60.0, cx=40.0, cy=32.0)
    return PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=1),
        icp=ICPConfig(iters=(4, 3, 2)),
        dense=DenseVolumeConfig(dims=(96, 96, 96), origin=(-0.48, -0.48, 0.4)),
        tsdf=TSDFConfig(voxel_size=0.01, trunc_dist=0.04, use_color=True),
        raycast=RaycastConfig(max_steps=160),
    )


def test_color_fusion_and_render():
    cfg = make_cfg()
    scene = SyntheticScene()
    pipe = DensePipeline(cfg)
    state = pipe.init()
    assert state.color.shape == (96, 96, 96, 3)

    depth = scene.render_depth_mm(cfg.camera, jnp.eye(4))
    # Vertical color gradient image: top red, bottom green.
    h, w = cfg.camera.shape
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[: h // 2, :, 0] = 220
    rgb[h // 2 :, :, 1] = 220
    rgb = jnp.asarray(rgb)

    for _ in range(3):
        state, aux = pipe.step_rgb(state, depth, rgb)
        assert bool(aux.ok)

    assert float(jnp.abs(state.color).max()) > 0.5  # color was fused

    img = np.asarray(pipe.render_color(state))
    assert img.shape == (h, w, 3) and img.dtype == np.uint8
    lit = img.sum(axis=-1) > 30  # pixels where the raycast hit colored surface
    top = img[: h // 2][lit[: h // 2]]
    bot = img[h // 2 :][lit[h // 2 :]]
    assert len(top) > 50 and len(bot) > 50
    # Top half red-dominant, bottom half green-dominant.
    assert top[:, 0].mean() > top[:, 1].mean() + 30
    assert bot[:, 1].mean() > bot[:, 0].mean() + 30


def make_block_cfg():
    import dataclasses
    from topfusion.config import BlockMapConfig

    cfg = make_cfg()
    return dataclasses.replace(
        cfg,
        blockmap=BlockMapConfig(
            capacity=1 << 13,
            max_new_blocks_per_frame=2048,
            max_visible_blocks=1 << 12,
            alloc_pixel_stride=1,
            alloc_steps=6,
        ),
    )


def test_block_color_fusion_and_render():
    # Hashed-map color variant (reference: Voxel_s_rgb applies to the live
    # hashed scene, VoxelTypes.hpp:8-67) — mirrors the dense test above.
    from topfusion.models.block_pipeline import BlockPipeline

    cfg = make_block_cfg()
    scene = SyntheticScene()
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    assert state.color.shape[0] == cfg.blockmap.capacity + 1

    depth = scene.render_depth_mm(cfg.camera, jnp.eye(4))
    h, w = cfg.camera.shape
    rgb = np.zeros((h, w, 3), np.uint8)
    rgb[: h // 2, :, 0] = 220
    rgb[h // 2 :, :, 1] = 220
    rgb = jnp.asarray(rgb)

    for _ in range(3):
        state, aux = pipe.step_rgb(state, depth, rgb)
        assert bool(aux.ok)

    assert float(jnp.abs(state.color).max()) > 0.5

    img = np.asarray(pipe.render_color(state))
    assert img.shape == (h, w, 3) and img.dtype == np.uint8
    lit = img.sum(axis=-1) > 30
    top = img[: h // 2][lit[: h // 2]]
    bot = img[h // 2 :][lit[h // 2 :]]
    assert len(top) > 50 and len(bot) > 50
    assert top[:, 0].mean() > top[:, 1].mean() + 30
    assert bot[:, 1].mean() > bot[:, 0].mean() + 30


def test_block_color_disabled_dummy():
    import dataclasses
    from topfusion.models.block_pipeline import BlockPipeline

    cfg = make_block_cfg()
    cfg = dataclasses.replace(
        cfg, tsdf=dataclasses.replace(cfg.tsdf, use_color=False)
    )
    pipe = BlockPipeline(cfg)
    state = pipe.init()
    assert state.color.shape == (1, 1, 1, 1, 3)
    depth = SyntheticScene().render_depth_mm(cfg.camera, jnp.eye(4))
    state, aux = pipe.step(state, depth)
    assert bool(aux.ok)


def test_color_disabled_dummy():
    cfg = make_cfg()
    cfg = dataclasses.replace(
        cfg, tsdf=dataclasses.replace(cfg.tsdf, use_color=False)
    )
    pipe = DensePipeline(cfg)
    state = pipe.init()
    assert state.color.shape == (1, 1, 1, 3)
    depth = SyntheticScene().render_depth_mm(cfg.camera, jnp.eye(4))
    state, aux = pipe.step(state, depth)
    assert bool(aux.ok)
