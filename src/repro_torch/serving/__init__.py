"""Serving (counterpart of ``repro.serving``): the engine, the batch
scheduler, the InferenceServer, executable artifacts and the multi-tenant
multiplexer."""

from repro_torch.serving.artifact import (ARTIFACT_SCHEMA, ArtifactError,
                                          export_artifact, load_artifact,
                                          read_meta)
from repro_torch.serving.engine import PhoneBitEngine
from repro_torch.serving.multiplex import MultiTenantServer, TenantLane
from repro_torch.serving.scheduler import BatchScheduler, Request, buckets_for
from repro_torch.serving.server import InferenceServer

__all__ = ["ARTIFACT_SCHEMA", "ArtifactError", "BatchScheduler",
           "InferenceServer", "MultiTenantServer", "PhoneBitEngine",
           "Request", "TenantLane", "buckets_for", "export_artifact",
           "load_artifact", "read_meta"]
