from topfusion.parallel.sharded_pipeline import (
    make_mesh,
    make_sharded_pipeline,
    dryrun_sharded_step,
)
from topfusion.parallel.block_sharded import ShardedBlockPipeline
from topfusion.parallel.sharded_slam import ShardedSlamSystem
from topfusion.parallel.dist_ba import optimize_distributed
from topfusion.parallel.multihost import initialize_multihost, measure_scaling

__all__ = [
    "make_mesh",
    "make_sharded_pipeline",
    "dryrun_sharded_step",
    "ShardedBlockPipeline",
    "ShardedSlamSystem",
    "optimize_distributed",
    "initialize_multihost",
    "measure_scaling",
]
