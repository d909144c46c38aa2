"""Data pipelines (counterpart of ``repro.data``): deterministic,
restart-safe synthetic sources.  Batch ``i`` is a pure function of
(seed, i), so a job restarted from step ``i`` regenerates the same stream
and a checkpoint stores only the step counter.
"""

from repro_torch.data.pipeline import (ImagePipeline, LatentPipeline,
                                       TokenPipeline)

__all__ = ["ImagePipeline", "LatentPipeline", "TokenPipeline"]
