"""Operator IR for the PhoneBit graph runtime (DESIGN.md §4.1).

Counterpart of ``repro.runtime.graph``: a model is a DAG of :class:`Node`
objects with explicit edges.  Two lowerings build one:

* :func:`lower_packed` — from a converter artifact (the serving path):
  the fused ops directly;
* :func:`lower_trained` — from trained latent-float params: the unfused
  ops (``conv_counts`` → ``bn_binarize``, ``maxpool_pm1``), which the
  passes of :mod:`repro_torch.runtime.passes` rewrite into the fused
  graph.

The op vocabulary:

===============  ============================================================
op               semantics
===============  ============================================================
input            graph input placeholder; uint8 NHWC image
bitplane_expand  uint8 (N,H,W,C) → (N,H,W,8·Cw) int32 bit-plane words
packed_conv      fused conv+BN+binarize on packed words → packed words
packed_conv_pool packed_conv with an OR-pool epilogue fused in
packed_dense     fused dense+BN+binarize, flattens input → (N, Ow)
or_pool          max-pool in the packed domain = windowed bitwise OR
conv_counts      unfused conv: weighted xor-popcounts (N,OH,OW,O) int32
dense_counts     unfused dense counts (N, O) int32
bn_binarize      float-BN epilogue on counts → packed bits (oracle form)
threshold_pack   integer-threshold epilogue on counts → packed bits
maxpool_pm1      semantic max-pool: unpack ±1 → reduce-max → repack
unpack_pm1       packed words → float ±1 (c_per_pos valid channels)
float_dense      full-precision head: flatten, x@w+b
float_conv       full-precision conv (paper's conv9)
concat_packed    channel-concat of packed words (each input C ≡ 0 mod 32)
===============  ============================================================

Every node carries ``attrs["channels"]``, the number of valid binary
channels per spatial position of its output.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Sequence

import numpy as np
import torch

from repro_torch.core import bitplanes, layer_integration, packing
from repro_torch.core.binary_conv import conv_out_size, pack_conv_weights
from repro_torch.core.bnn_model import (BConv, BDense, FloatConv, FloatDense,
                                        LayerSpec, Pool)

# Ops whose output is packed words.
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

    def to(self, device) -> "Graph":
        """A copy with every param tensor on ``device`` (contiguous)."""
        def move(v):
            if isinstance(v, layer_integration.IntegratedParams):
                return layer_integration.IntegratedParams(
                    *(move(f) for f in v))
            return v.to(device).contiguous() if torch.is_tensor(v) else v

        g = self.copy()
        for node in g.nodes.values():
            node.params = {k: move(v) for k, v in node.params.items()}
        return g

    def upto(self, output_id: int) -> "Graph":
        """A copy cut at ``output_id``: that node and its ancestors, with
        it as the output."""
        keep, todo = set(), [output_id]
        while todo:
            nid = todo.pop()
            if nid not in keep:
                keep.add(nid)
                todo.extend(self.nodes[nid].inputs)
        g = self.copy()
        g.nodes = {nid: n for nid, n in g.nodes.items() if nid in keep}
        g.output_id = output_id
        g.validate()
        return g

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
            # A pipeline stage's placeholder carries its boundary's dtype.
            t = TensorType(tuple(input_shape), a.get("dtype", torch.uint8))
        elif node.op == "bitplane_expand":
            n, h, w, c = ins[0].shape
            t = TensorType(
                (n, h, w, bitplanes.NUM_PLANES * packing.num_words(c)),
                torch.int32)
        elif node.op in ("packed_conv", "packed_conv_pool", "conv_counts"):
            oh, ow = _conv_hw(ins[0].shape, a["kernel"], a["stride"],
                              a["pad"])
            if node.op == "packed_conv_pool":
                pp = sum(a.get("pool_pad", (0, 0)))
                oh = (oh + pp - a["pool_window"]) // a["pool_stride"] + 1
                ow = (ow + pp - a["pool_window"]) // a["pool_stride"] + 1
            last = (a["channels"] if node.op == "conv_counts"
                    else packing.num_words(a["channels"]))
            t = TensorType((ins[0].shape[0], oh, ow, last), torch.int32)
        elif node.op in ("or_pool", "maxpool_pm1"):
            n, h, w, cw = ins[0].shape
            ph, pw = a.get("pad", (0, 0))
            oh = (h + ph + pw - a["window"]) // a["stride"] + 1
            ow = (w + ph + pw - a["window"]) // a["stride"] + 1
            t = TensorType((n, oh, ow, cw), torch.int32)
        elif node.op == "packed_dense":
            t = TensorType(
                (ins[0].shape[0], packing.num_words(a["channels"])),
                torch.int32)
        elif node.op == "dense_counts":
            t = TensorType((ins[0].shape[0], a["channels"]), torch.int32)
        elif node.op in ("bn_binarize", "threshold_pack"):
            s = ins[0].shape
            t = TensorType(s[:-1] + (packing.num_words(s[-1]),), torch.int32)
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
        elif node.op == "concat_packed":
            base = ins[0].shape
            t = TensorType(base[:-1] + (sum(i.shape[-1] for i in ins),),
                           torch.int32)
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


# --------------------------------------------------------------------------
# Lowering: trained float params -> unfused graph (pass-pipeline input)
# --------------------------------------------------------------------------

def _f32(v) -> torch.Tensor:
    t = v if torch.is_tensor(v) else torch.as_tensor(np.asarray(v))
    return t.to(torch.float32)


def _first_layer_packed_weights(layer: BConv, w: torch.Tensor
                                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Bit-plane filters (O, KH·KW·8·Cw), each plane a copy of the sign
    words, and their word weights 2^(n-1) per plane word."""
    cw = packing.num_words(layer.c_in)
    wp = packing.pack_signs(w, axis=2)                        # KH,KW,Cw,O
    wp = wp[:, :, None].expand(-1, -1, bitplanes.NUM_PLANES, -1, -1)
    wp = wp.permute(4, 0, 1, 2, 3).reshape(layer.c_out, -1).contiguous()
    ww = bitplanes.plane_word_weights(cw).repeat(layer.kernel * layer.kernel)
    return wp, ww


def lower_trained(spec: Sequence[LayerSpec], params: Sequence[dict],
                  input_hw: tuple[int, int]) -> Graph:
    """Lower trained latent-float params (torch tensors or numpy arrays) to
    the *unfused* graph, on the CPU.

    Weight bit-packing happens here (packing is layout, not fusion), but BN
    stays a float epilogue (``bn_binarize``), pools stay semantic max-pools
    (``maxpool_pm1``), and no layout adapters (``bitplane_expand`` /
    ``unpack_pm1``) are emitted: those are the work of
    :func:`repro_torch.runtime.passes.default_pipeline`.
    """
    g = Graph(input_hw=input_hw)
    cur = g.add("input", attrs=dict(channels=_input_channels(spec)))
    g.input_id = cur
    h, w = input_hw
    channels: int | None = None
    flat = False

    for layer, p in zip(spec, params):
        p = {k: _f32(v) for k, v in p.items()}
        bn = {k: p[k] for k in ("gamma", "beta", "mu", "var") if k in p}
        if isinstance(layer, BConv):
            if layer.first:
                wp, ww = _first_layer_packed_weights(layer, p["w"])
                w_sum = torch.where(p["w"] >= 0, 1.0, -1.0).sum(dim=(0, 1, 2))
                conv_params = dict(w_packed=wp, word_weights=ww)
                bn_extra = dict(w_sum=w_sum)
            else:
                conv_params = dict(w_packed=pack_conv_weights(p["w"]))
                bn_extra = {}
            cur = g.add("conv_counts", [cur],
                        attrs=dict(kernel=layer.kernel, stride=layer.stride,
                                   pad=layer.pad, channels=layer.c_out,
                                   first=layer.first, k_valid=layer.k_valid),
                        params=conv_params)
            cur = g.add("bn_binarize", [cur],
                        attrs=dict(k_valid=layer.k_valid, first=layer.first,
                                   channels=layer.c_out),
                        params=dict(bn, **bn_extra))
            h = conv_out_size(h, layer.kernel, layer.stride, layer.pad)
            w = conv_out_size(w, layer.kernel, layer.stride, layer.pad)
            channels = layer.c_out
        elif isinstance(layer, Pool):
            cur = g.add("maxpool_pm1", [cur],
                        attrs=dict(window=layer.window, stride=layer.stride,
                                   pad=tuple(layer.pad), channels=channels))
            h = (h + sum(layer.pad) - layer.window) // layer.stride + 1
            w = (w + sum(layer.pad) - layer.window) // layer.stride + 1
        elif isinstance(layer, BDense):
            if not flat:
                if h * w * channels != layer.d_in:
                    raise ValueError(f"BDense d_in={layer.d_in} != "
                                     f"{h}x{w}x{channels}")
                wp = pack_conv_weights(
                    p["w"].reshape(h, w, channels, layer.d_out))
            else:
                wp = packing.pack_signs(p["w"], axis=0).T.contiguous()
            cur = g.add("dense_counts", [cur],
                        attrs=dict(channels=layer.d_out, k_valid=layer.d_in),
                        params=dict(w_packed=wp))
            cur = g.add("bn_binarize", [cur],
                        attrs=dict(k_valid=layer.d_in, first=False,
                                   channels=layer.d_out),
                        params=bn)
            channels = layer.d_out
            flat = True
        elif isinstance(layer, FloatDense):
            cur = g.add("float_dense", [cur],
                        attrs=dict(channels=layer.d_out),
                        params=dict(w=p["w"], b=p["b"]))
            channels = layer.d_out
            flat = True
        elif isinstance(layer, FloatConv):
            cur = g.add("float_conv", [cur],
                        attrs=dict(kernel=layer.kernel, stride=layer.stride,
                                   pad=layer.pad, channels=layer.c_out),
                        params=dict(w=p["w"], b=p["b"]))
            h = conv_out_size(h, layer.kernel, layer.stride, layer.pad)
            w = conv_out_size(w, layer.kernel, layer.stride, layer.pad)
            channels = layer.c_out
        else:
            raise ValueError(f"cannot lower layer {layer!r}")
    g.output_id = cur
    g.validate()
    return g
