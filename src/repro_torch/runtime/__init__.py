"""Graph runtime (counterpart of ``repro.runtime``): operator IR, the
pool-epilogue fusion pass, and the per-node backend executor."""

from repro_torch.runtime.executor import (BACKENDS, GraphExecutor,
                                          eval_node, resolve_backend,
                                          valid_backends)
from repro_torch.runtime.graph import (DISPATCHABLE_OPS, Graph, Node,
                                       TensorType, infer_types, lower_packed)
from repro_torch.runtime.passes import fuse_pool_epilogue

__all__ = [
    "BACKENDS", "DISPATCHABLE_OPS", "Graph", "GraphExecutor", "Node",
    "TensorType", "eval_node", "fuse_pool_epilogue", "infer_types",
    "lower_packed", "resolve_backend", "valid_backends",
]
