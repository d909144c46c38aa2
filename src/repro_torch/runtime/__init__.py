"""Graph runtime (counterpart of ``repro.runtime``): operator IR, the
pool-epilogue fusion pass, the memory planner, chain-fusion regions and
the per-node backend executor."""

from repro_torch.runtime.executor import (ALL_MODES, BACKENDS, CHAIN_BACKEND,
                                          GraphExecutor, eval_node,
                                          resolve_backend, valid_backends)
from repro_torch.runtime.graph import (DISPATCHABLE_OPS, PACKED_OPS, Graph,
                                       Node, TensorType, infer_types,
                                       lower_packed)
from repro_torch.runtime.memory import (MemoryPlan, VmemPlan, plan_memory,
                                        vmem_plan)
from repro_torch.runtime.passes import fuse_pool_epilogue
from repro_torch.runtime.regions import (DEFAULT_SMEM_BUDGET, Chain,
                                         build_chain, chain_executor,
                                         chain_report, partition_chains,
                                         plan_chain_vmem)

__all__ = [
    "ALL_MODES", "BACKENDS", "CHAIN_BACKEND", "DEFAULT_SMEM_BUDGET",
    "DISPATCHABLE_OPS", "PACKED_OPS", "Chain", "Graph", "GraphExecutor",
    "MemoryPlan", "Node", "TensorType", "VmemPlan", "build_chain",
    "chain_executor", "chain_report", "eval_node", "fuse_pool_epilogue",
    "infer_types", "lower_packed", "partition_chains", "plan_chain_vmem",
    "plan_memory", "resolve_backend", "valid_backends", "vmem_plan",
]
