"""Serving (counterpart of ``repro.serving``): the engine, the batch
scheduler, the InferenceServer and the ``Server`` protocol, the fault
plans, retry policy and degradation ladders, the KV cache manager and the
recovery primitives, executable artifacts and the multi-tenant
multiplexer.  The package-level names are the reference's; the fault
plans live in ``obs.inject`` and are re-exported here through
``serving.faults``."""

from repro_torch.serving import faults
from repro_torch.serving.artifact import (ARTIFACT_SCHEMA, ArtifactError,
                                          export_artifact, load_artifact,
                                          read_meta)
from repro_torch.serving.engine import PhoneBitEngine
from repro_torch.serving.faults import (DEGRADE_LADDER, BackendHealth,
                                        BucketHealth, FaultError, FaultPlan,
                                        FaultSpec, RetryPolicy,
                                        WatchdogTimeout)
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.multiplex import MultiTenantServer, TenantLane
from repro_torch.serving.recovery import (KVCheckpointer, RequestJournal,
                                          replay_journal)
from repro_torch.serving.scheduler import (OUTCOMES, BatchScheduler,
                                           Request, buckets_for)
from repro_torch.serving.server import InferenceServer, Server

__all__ = ["PhoneBitEngine", "BatchScheduler", "Request", "KVCacheManager",
           "InferenceServer", "Server", "buckets_for", "faults",
           "FaultPlan", "FaultSpec", "FaultError", "RetryPolicy",
           "BackendHealth", "BucketHealth", "WatchdogTimeout",
           "DEGRADE_LADDER", "OUTCOMES", "ARTIFACT_SCHEMA",
           "ArtifactError", "export_artifact", "load_artifact",
           "read_meta", "MultiTenantServer", "TenantLane",
           "KVCheckpointer", "RequestJournal", "replay_journal"]
