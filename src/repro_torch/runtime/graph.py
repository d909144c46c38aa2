"""Operator IR for the PhoneBit graph runtime (DESIGN.md §4.1).

Counterpart of ``repro.runtime.graph`` for the serving path: a model is a
DAG of :class:`Node` objects with explicit edges, built from a converter
artifact by :func:`lower_packed`.  The ops this lowering (plus
``passes.fuse_pool_epilogue``) emits:

===============  ============================================================
op               semantics
===============  ============================================================
input            graph input placeholder; uint8 NHWC image
bitplane_expand  uint8 (N,H,W,C) → (N,H,W,8·Cw) int32 bit-plane words
packed_conv      fused conv+BN+binarize on packed words → packed words
packed_conv_pool packed_conv with an OR-pool epilogue fused in
packed_dense     fused dense+BN+binarize, flattens input → (N, Ow)
or_pool          max-pool in the packed domain = windowed bitwise OR
unpack_pm1       packed words → float ±1 (c_per_pos valid channels)
float_dense      full-precision head: flatten, x@w+b
float_conv       full-precision conv (paper's conv9)
===============  ============================================================

Every node carries ``attrs["channels"]``, the number of valid binary
channels per spatial position of its output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import torch

from repro_torch.core import bitplanes, packing
from repro_torch.core.binary_conv import conv_out_size
from repro_torch.core.bnn_model import (BConv, BDense, FloatConv, FloatDense,
                                        LayerSpec, Pool)

# Ops whose output is packed words (the reference's set, including ops the
# port does not lower yet); a chain's ``maxpool_pm1`` needs a packed input.
PACKED_OPS = frozenset({
    "packed_conv", "packed_conv_pool", "packed_dense", "or_pool",
    "bn_binarize", "threshold_pack", "maxpool_pm1", "concat_packed",
})
# Ops the executor can dispatch to more than one backend.
DISPATCHABLE_OPS = frozenset({"packed_conv", "packed_conv_pool",
                              "packed_dense"})


@dataclasses.dataclass
class Node:
    """One operator instance: ``inputs`` are producer node ids, ``attrs``
    static python values, ``params`` tensors."""
    id: int
    op: str
    inputs: tuple[int, ...]
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    params: dict[str, Any] = dataclasses.field(default_factory=dict)

    def with_(self, **kw) -> "Node":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass
class Graph:
    nodes: dict[int, Node] = dataclasses.field(default_factory=dict)
    input_id: int = -1
    output_id: int = -1
    input_hw: tuple[int, int] | None = None

    def new_id(self) -> int:
        return max(self.nodes, default=-1) + 1

    def add(self, op: str, inputs: Sequence[int] = (), attrs=None,
            params=None) -> int:
        nid = self.new_id()
        self.nodes[nid] = Node(nid, op, tuple(inputs), dict(attrs or {}),
                               dict(params or {}))
        return nid

    def consumers(self) -> dict[int, list[int]]:
        out: dict[int, list[int]] = {nid: [] for nid in self.nodes}
        for node in self.nodes.values():
            for src in node.inputs:
                out[src].append(node.id)
        return out

    def topo_order(self) -> list[int]:
        """Deterministic topological order (Kahn, smallest-id first)."""
        indeg = {nid: len(set(n.inputs)) for nid, n in self.nodes.items()}
        cons = self.consumers()
        ready = sorted(nid for nid, d in indeg.items() if d == 0)
        order: list[int] = []
        while ready:
            nid = ready.pop(0)
            order.append(nid)
            for c in cons[nid]:
                indeg[c] -= 1 if nid in set(self.nodes[c].inputs) else 0
                if indeg[c] == 0:
                    ready.append(c)
            ready.sort()
        if len(order) != len(self.nodes):
            raise ValueError("graph has a cycle")
        return order

    def copy(self) -> "Graph":
        return Graph(
            nodes={nid: Node(n.id, n.op, n.inputs, dict(n.attrs),
                             dict(n.params))
                   for nid, n in self.nodes.items()},
            input_id=self.input_id, output_id=self.output_id,
            input_hw=self.input_hw)

    def validate(self) -> None:
        for node in self.nodes.values():
            for src in node.inputs:
                if src not in self.nodes:
                    raise ValueError(f"node {node.id} ({node.op}) references "
                                     f"missing input {src}")
        if self.input_id not in self.nodes:
            raise ValueError("missing input node")
        if self.output_id not in self.nodes:
            raise ValueError("missing output node")
        self.topo_order()  # raises on cycles


@dataclasses.dataclass(frozen=True)
class TensorType:
    shape: tuple[int, ...]
    dtype: torch.dtype

    @property
    def nbytes(self) -> int:
        n = 1
        for d in self.shape:
            n *= d
        return n * torch.empty((), dtype=self.dtype).element_size()


def _conv_hw(shape, k, stride, pad):
    return (conv_out_size(shape[1], k, stride, pad),
            conv_out_size(shape[2], k, stride, pad))


def infer_types(graph: Graph,
                input_shape: tuple[int, ...]) -> dict[int, TensorType]:
    """Output TensorType of every node given the graph-input shape."""
    types: dict[int, TensorType] = {}
    for nid in graph.topo_order():
        node = graph.nodes[nid]
        ins = [types[i] for i in node.inputs]
        a = node.attrs
        if node.op == "input":
            t = TensorType(tuple(input_shape), torch.uint8)
        elif node.op == "bitplane_expand":
            n, h, w, c = ins[0].shape
            t = TensorType(
                (n, h, w, bitplanes.NUM_PLANES * packing.num_words(c)),
                torch.int32)
        elif node.op in ("packed_conv", "packed_conv_pool"):
            oh, ow = _conv_hw(ins[0].shape, a["kernel"], a["stride"],
                              a["pad"])
            if node.op == "packed_conv_pool":
                pp = sum(a.get("pool_pad", (0, 0)))
                oh = (oh + pp - a["pool_window"]) // a["pool_stride"] + 1
                ow = (ow + pp - a["pool_window"]) // a["pool_stride"] + 1
            t = TensorType((ins[0].shape[0], oh, ow,
                            packing.num_words(a["channels"])), torch.int32)
        elif node.op == "or_pool":
            n, h, w, cw = ins[0].shape
            ph, pw = a.get("pad", (0, 0))
            oh = (h + ph + pw - a["window"]) // a["stride"] + 1
            ow = (w + ph + pw - a["window"]) // a["stride"] + 1
            t = TensorType((n, oh, ow, cw), torch.int32)
        elif node.op == "packed_dense":
            t = TensorType(
                (ins[0].shape[0], packing.num_words(a["channels"])),
                torch.int32)
        elif node.op == "unpack_pm1":
            s = ins[0].shape
            t = TensorType(s[:-1] + (a["channels"],), torch.float32)
        elif node.op == "float_dense":
            t = TensorType((ins[0].shape[0], a["channels"]), torch.float32)
        elif node.op == "float_conv":
            oh, ow = _conv_hw(ins[0].shape, a["kernel"], a["stride"],
                              a["pad"])
            t = TensorType((ins[0].shape[0], oh, ow, a["channels"]),
                           torch.float32)
        else:
            raise ValueError(f"no shape rule for op {node.op!r}")
        types[nid] = t
    return types


def _input_channels(spec: Sequence[LayerSpec]) -> int | None:
    for layer in spec:
        if isinstance(layer, (BConv, FloatConv)):
            return layer.c_in
    return None


def lower_packed(spec: Sequence[LayerSpec], packed: Sequence[dict],
                 input_hw: tuple[int, int]) -> Graph:
    """Lower a flat spec + ``converter.convert`` artifact to a fused graph
    (the serving-path lowering; works on ``load_artifact`` output too)."""
    g = Graph(input_hw=input_hw)
    cur = g.add("input", attrs=dict(channels=_input_channels(spec)))
    g.input_id = cur
    channels: int | None = None

    for layer, p in zip(spec, packed):
        if isinstance(layer, BConv):
            if layer.first:
                cur = g.add("bitplane_expand", [cur],
                            attrs=dict(c_in=layer.c_in, channels=layer.c_in))
            cur = g.add(
                "packed_conv", [cur],
                attrs=dict(kernel=layer.kernel, stride=layer.stride,
                           pad=layer.pad, channels=layer.c_out,
                           first=layer.first),
                params=dict(w_packed=p["w_packed"], thresh=p["thresh"],
                            **({"word_weights": p["word_weights"]}
                               if "word_weights" in p else {})))
            channels = layer.c_out
        elif isinstance(layer, Pool):
            cur = g.add("or_pool", [cur],
                        attrs=dict(window=layer.window, stride=layer.stride,
                                   pad=tuple(layer.pad), channels=channels))
        elif isinstance(layer, BDense):
            cur = g.add("packed_dense", [cur],
                        attrs=dict(channels=layer.d_out),
                        params=dict(w_packed=p["w_packed"],
                                    thresh=p["thresh"]))
            channels = layer.d_out
        elif isinstance(layer, FloatDense):
            cur = g.add("unpack_pm1", [cur],
                        attrs=dict(channels=int(p["c_per_pos"])))
            cur = g.add("float_dense", [cur],
                        attrs=dict(channels=layer.d_out),
                        params=dict(w=p["w"], b=p["b"]))
            channels = layer.d_out
        elif isinstance(layer, FloatConv):
            cur = g.add("unpack_pm1", [cur],
                        attrs=dict(channels=int(p["c_per_pos"])))
            cur = g.add("float_conv", [cur],
                        attrs=dict(kernel=layer.kernel, stride=layer.stride,
                                   pad=layer.pad, channels=layer.c_out),
                        params=dict(w=p["w"], b=p["b"]))
            channels = layer.c_out
        else:
            raise ValueError(f"cannot lower layer {layer!r}")
    g.output_id = cur
    g.validate()
    return g
