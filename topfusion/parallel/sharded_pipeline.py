"""Multi-device sharded execution of the fusion pipeline.

The reference is strictly single-GPU (SURVEY.md section 2.2).  Here the
TSDF map is the model state and "model parallelism" for this workload is
SPATIAL MAP SHARDING: the volume is partitioned over the mesh's ``map``
axis; depth images and poses are replicated.  The per-frame step is the
same global program as the single-chip path — ``jax.jit`` with sharding
annotations lets GSPMD partition integration (voxel updates are local to
each shard) and insert the collectives for cross-shard reads in the
raycast and the ``psum`` reduction of the ICP normal equations.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from topfusion.config import (
    CameraConfig,
    DenseVolumeConfig,
    ICPConfig,
    PipelineConfig,
    PreprocConfig,
    RaycastConfig,
    TSDFConfig,
)
from topfusion.models.pipeline import DensePipeline, DenseState


def make_mesh(n_devices: Optional[int] = None, axis: str = "map") -> Mesh:
    devs = jax.devices()[: n_devices or len(jax.devices())]
    return Mesh(np.asarray(devs), (axis,))


def state_shardings(mesh: Mesh, state: DenseState) -> DenseState:
    """Sharding tree for DenseState: volume split on dim 0 of the grid,
    everything else replicated."""
    vol = NamedSharding(mesh, P("map", None, None))
    rep = NamedSharding(mesh, P())
    # Color grid shards like the volume when enabled; the 1-voxel dummy
    # must stay replicated.
    color = (
        NamedSharding(mesh, P("map", None, None, None))
        if state.color.shape[0] > 1
        else NamedSharding(mesh, P())
    )
    return DenseState(
        tsdf=vol,
        weight=vol,
        color=color,
        T_wc=rep,
        model_points=tuple(rep for _ in state.model_points),
        model_normals=tuple(rep for _ in state.model_normals),
        frame=rep,
        resets=rep,
    )


def make_sharded_pipeline(cfg: PipelineConfig, mesh: Mesh):
    """Returns (init_fn, step_fn) where step_fn runs sharded over ``mesh``."""
    pipe = DensePipeline(cfg)
    state0 = pipe.init()
    sh = state_shardings(mesh, state0)
    rep = NamedSharding(mesh, P())

    step = jax.jit(
        pipe._step,
        in_shardings=(sh, rep),
        out_shardings=(sh, rep),
    )

    def init():
        return jax.device_put(state0, sh)

    return init, step


def dryrun_sharded_step(n_devices: int) -> None:
    """Driver hook: build an n-device mesh, jit the FULL fusion step with
    map sharding, execute one step on tiny shapes, verify it ran."""
    assert len(jax.devices()) >= n_devices, (
        f"need {n_devices} devices, have {len(jax.devices())}"
    )
    mesh = make_mesh(n_devices)

    d = 8 * n_devices  # volume dim divisible by the mesh
    cam = CameraConfig(width=64, height=48, fx=48.0, fy=48.0, cx=32.0, cy=24.0)
    cfg = PipelineConfig(
        camera=cam,
        preproc=PreprocConfig(bilateral_kernel_size=3, pyramid_levels=2),
        icp=ICPConfig(iters=(2, 2)),
        dense=DenseVolumeConfig(
            dims=(d, 64, 64), origin=(-0.32, -0.32, 0.4)
        ),
        tsdf=TSDFConfig(voxel_size=0.64 / d, trunc_dist=0.04),
        raycast=RaycastConfig(max_steps=48),
    )

    from topfusion.io.synthetic import SyntheticScene

    init, step = make_sharded_pipeline(cfg, mesh)
    state = init()
    depth = SyntheticScene().render_depth_mm(cam, jnp.eye(4))

    # Two steps: frame-0 bootstrap, then a full ICP+integrate+raycast step.
    state, aux = step(state, depth)
    state, aux = step(state, depth)
    jax.block_until_ready(state.tsdf)
    assert int(state.frame) == 2
    assert bool(aux.ok), "sharded step lost tracking on a static frame"
