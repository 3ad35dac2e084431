"""topfusion — a dense RGB-D 3D reconstruction framework in JAX.

A from-scratch JAX/XLA re-design of the capability surface of the
reference CUDA engine ``3d-scan/topfusion`` (KinectFusion-style frontend +
InfiniTAM-style voxel-block-hashed TSDF backend; see ``SURVEY.md``):

- depth preprocessing (bilateral filter, pyramids, vertex/normal maps)
- projective point-to-plane multiscale ICP frame-to-model tracking
- TSDF fusion into a dense volume or a block-sparse voxel map
  (the reference's pointer-chasing GPU hash is re-designed as a sorted
  key table + slot indirection amenable to vectorized gather/scatter)
- raycast surface extraction and shaded rendering
- keyframe pose graph with loop closure and bundle adjustment (new
  capability, absent in the reference)
- multi-device sharding over a ``jax.sharding.Mesh`` (new capability)

Everything on the compute path is jittable with static shapes; the whole
per-frame fusion step compiles to a single XLA computation with one
device->host sync per frame (the reference syncs every ICP iteration,
reference: tfusion/src/projective_icp.cpp:43-62).
"""

from topfusion.config import (
    CameraConfig,
    ICPConfig,
    PreprocConfig,
    TSDFConfig,
    BlockMapConfig,
    RaycastConfig,
    PipelineConfig,
    PoseGraphConfig,
)
from topfusion.models.pipeline import DensePipeline
from topfusion.models.block_pipeline import BlockPipeline

__version__ = "0.1.0"

__all__ = [
    "CameraConfig",
    "ICPConfig",
    "PreprocConfig",
    "TSDFConfig",
    "BlockMapConfig",
    "RaycastConfig",
    "PipelineConfig",
    "PoseGraphConfig",
    "DensePipeline",
    "BlockPipeline",
]
