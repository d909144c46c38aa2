"""Graph runtime (counterpart of ``repro.runtime``): operator IR and its two
lowerings, the rewrite passes, the memory planner, chain-fusion regions,
the per-node backend executor and its autotuner, and the placement pass
(pipeline cuts, the staged and sharded executors)."""

from repro_torch.runtime.autotune import Autotuner, default_candidates
from repro_torch.runtime.executor import (ALL_MODES, BACKENDS, CHAIN_BACKEND,
                                          CapturedExecutor, GraphExecutor,
                                          eval_node, resolve_backend,
                                          valid_backends)
from repro_torch.runtime.graph import (DISPATCHABLE_OPS, PACKED_OPS, Graph,
                                       Node, TensorType, infer_types,
                                       lower_packed, lower_trained)
from repro_torch.runtime.memory import (MemoryPlan, VmemPlan, plan_memory,
                                        vmem_plan)
from repro_torch.runtime.passes import (absorb_pools, assign_layouts,
                                        default_pipeline, fuse_epilogues,
                                        fuse_pool_epilogue, integrate_bn)
from repro_torch.runtime.placement import (ShardedExecutor, StagedExecutor,
                                           StagePlan, cut_candidates,
                                           plan_pipeline, stage_subgraph,
                                           staged_executor)
from repro_torch.runtime.regions import (DEFAULT_SMEM_BUDGET, Chain,
                                         build_chain, chain_executor,
                                         chain_report, partition_chains,
                                         plan_chain_vmem)

__all__ = [
    "ALL_MODES", "Autotuner", "BACKENDS", "CHAIN_BACKEND", "CapturedExecutor",
    "DEFAULT_SMEM_BUDGET", "DISPATCHABLE_OPS", "PACKED_OPS", "Chain",
    "Graph", "GraphExecutor", "MemoryPlan", "Node", "ShardedExecutor",
    "StagePlan", "StagedExecutor", "TensorType", "VmemPlan",
    "absorb_pools", "assign_layouts", "build_chain", "chain_executor",
    "chain_report", "cut_candidates", "default_candidates",
    "default_pipeline", "eval_node", "fuse_epilogues", "fuse_pool_epilogue",
    "infer_types", "integrate_bn", "lower_packed", "lower_trained",
    "partition_chains", "plan_chain_vmem", "plan_memory", "plan_pipeline",
    "resolve_backend", "stage_subgraph", "staged_executor",
    "valid_backends", "vmem_plan",
]
