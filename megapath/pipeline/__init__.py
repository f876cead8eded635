from megapath.pipeline.megapath import (  # noqa: F401
    MegaPathPipeline,
    PipelineConfig,
    PipelineResult,
)
