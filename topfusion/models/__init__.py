from topfusion.models.pipeline import DensePipeline, DenseState
from topfusion.models.block_pipeline import BlockPipeline, BlockState

__all__ = ["DensePipeline", "DenseState", "BlockPipeline", "BlockState"]
