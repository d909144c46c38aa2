"""Multi-device serving (counterpart of ``repro.distributed``, DESIGN.md
§13).

pipeline      ``Pipelined``: the graph cut into per-device stages at its
              device-memory touch points (the cut planner and the staged
              executor live in :mod:`repro_torch.runtime.placement`)
sharding      mesh-axis rules (``Rules``: DP / FSDP / TP / EP and the
              sequence-sharded KV cache of the LM stack), their specs and
              collectives, plus ``DataParallel``: each bucket split into
              row shards, one a device
replicas      ``ReplicaGroup`` — N device-pinned ``InferenceServer``
              replicas (each optionally a pipeline) behind one front end,
              with per-replica ladders and straggler-aware routing;
              ``LMReplicaGroup`` — LM decode lanes with checkpoint-backed
              sequence migration
straggler     step-time outlier detection (wired into replica routing)
"""

from repro_torch.distributed import pipeline, replicas, sharding, straggler
from repro_torch.distributed.pipeline import Pipelined
from repro_torch.distributed.replicas import (LMLane, LMReplicaGroup,
                                              Replica, ReplicaGroup)
from repro_torch.distributed.sharding import (DataParallel, Rules,
                                              rules_for_mesh)
from repro_torch.distributed.straggler import StragglerMonitor

__all__ = [
    "pipeline", "replicas", "sharding", "straggler",
    "Pipelined", "DataParallel", "Replica", "ReplicaGroup",
    "LMLane", "LMReplicaGroup", "Rules", "rules_for_mesh",
    "StragglerMonitor",
]
