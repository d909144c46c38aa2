"""Graph rewrite passes (DESIGN.md §4.3).

Counterpart of ``repro.runtime.passes``: what ``converter.convert`` and
``packed_forward`` hard-code, as explicit rewrites over the operator IR.

* :func:`assign_layouts` — label every edge with its data layout (u8 /
  bitplane / counts / packed / float) and insert the adapters
  (``bitplane_expand``, ``unpack_pm1``) where producer and consumer
  disagree.
* :func:`integrate_bn` — rewrite the float ``bn_binarize`` epilogue into
  the integer ``threshold_pack`` form (Eqns 5-9) via
  ``layer_integration.fold_bn`` / ``fold_bn_first_layer``.
* :func:`fuse_epilogues` — merge ``conv_counts → threshold_pack`` into
  ``packed_conv`` (and ``dense_counts`` into ``packed_dense``), so no count
  tensor is materialized.
* :func:`absorb_pools` — rewrite ``maxpool_pm1`` over packed input into
  ``or_pool`` (sign is monotone: binarize-then-OR == max-then-binarize).
* :func:`fuse_pool_epilogue` — merge ``packed_conv → or_pool`` into
  ``packed_conv_pool``.  Not part of :func:`default_pipeline`, whose
  contract is convergence to ``lower_packed``; the serving engine applies
  it on top.

:func:`default_pipeline` runs the first four in dependency order; on
:func:`~repro_torch.runtime.graph.lower_trained` output it converges to
the graph :func:`~repro_torch.runtime.graph.lower_packed` builds from a
converter artifact.
"""

from __future__ import annotations

from repro_torch.core import bnn_model, layer_integration
from repro_torch.runtime.graph import PACKED_OPS, Graph

# Output layout per op.
_OUT_LAYOUT = {
    "input": "u8",
    "bitplane_expand": "bitplane",
    "conv_counts": "counts",
    "dense_counts": "counts",
    "packed_conv": "packed",
    "packed_conv_pool": "packed",
    "packed_dense": "packed",
    "bn_binarize": "packed",
    "threshold_pack": "packed",
    "or_pool": "packed",
    "maxpool_pm1": "packed",
    "concat_packed": "packed",
    "unpack_pm1": "float",
    "float_dense": "float",
    "float_conv": "float",
}

# Layout each op requires of its inputs (None = anything; the convs want
# bitplane input when first, else packed: see _expected_in_layout).
_IN_LAYOUT = {
    "bitplane_expand": "u8",
    "packed_dense": "packed",
    "dense_counts": "packed",
    "bn_binarize": "counts",
    "threshold_pack": "counts",
    "or_pool": "packed",
    "maxpool_pm1": "packed",
    "concat_packed": "packed",
    "unpack_pm1": "packed",
    "float_dense": "float",
    "float_conv": "float",
}


def _expected_in_layout(op: str, attrs: dict) -> str | None:
    if op in ("packed_conv", "packed_conv_pool", "conv_counts"):
        return "bitplane" if attrs.get("first") else "packed"
    return _IN_LAYOUT.get(op)


def assign_layouts(graph: Graph) -> Graph:
    """Label nodes with their output layout; insert adapters on mismatched
    edges.  Returns a new graph; raises on un-adaptable mismatches."""
    g = graph.copy()
    # Topological order, so inserted adapters are final before their
    # consumers are visited.
    for nid in g.topo_order():
        node = g.nodes[nid]
        want = _expected_in_layout(node.op, node.attrs)
        if want is None:
            continue
        new_inputs = []
        for src in node.inputs:
            prod = g.nodes[src]
            have = prod.attrs.get("layout", _OUT_LAYOUT[prod.op])
            if have == want:
                new_inputs.append(src)
            elif have == "u8" and want == "bitplane":
                c_in = prod.attrs.get("channels")
                new_inputs.append(g.add(
                    "bitplane_expand", [src],
                    attrs=dict(c_in=c_in, channels=c_in, layout="bitplane")))
            elif have == "packed" and want == "float":
                new_inputs.append(g.add(
                    "unpack_pm1", [src],
                    attrs=dict(channels=prod.attrs["channels"],
                               layout="float")))
            else:
                raise ValueError(
                    f"no layout adapter {have!r} -> {want!r} on edge "
                    f"{src}({prod.op}) -> {nid}({node.op})")
        node.inputs = tuple(new_inputs)
    for node in g.nodes.values():
        node.attrs["layout"] = node.attrs.get("layout",
                                              _OUT_LAYOUT[node.op])
    g.validate()
    return g


def integrate_bn(graph: Graph) -> Graph:
    """Fold each float ``bn_binarize`` epilogue into the integer-threshold
    form (Eqns 5-9), in float32 as the converter folds."""
    g = graph.copy()
    for nid, node in list(g.nodes.items()):
        if node.op != "bn_binarize":
            continue
        p = node.params
        sigma = bnn_model.bn_sigma(p["var"])
        bias = p.get("bias", 0.0)
        if node.attrs.get("first"):
            thresh = layer_integration.fold_bn_first_layer(
                node.attrs["k_valid"], p["w_sum"], p["gamma"], p["beta"],
                p["mu"], sigma, bias=bias)
        else:
            thresh = layer_integration.fold_bn(
                node.attrs["k_valid"], p["gamma"], p["beta"], p["mu"],
                sigma, bias=bias)
        attrs = {k: v for k, v in node.attrs.items() if k != "k_valid"}
        g.nodes[nid] = node.with_(op="threshold_pack", attrs=attrs,
                                  params=dict(thresh=thresh))
    return g


def fuse_epilogues(graph: Graph) -> Graph:
    """Merge ``conv_counts → threshold_pack`` into fused ``packed_conv``
    (and ``dense_counts`` → ``packed_dense``): the epilogue happens in the
    producer's registers and the count tensor is never materialized."""
    g = graph.copy()
    cons = g.consumers()
    for nid, node in list(g.nodes.items()):
        if node.op != "threshold_pack" or nid not in g.nodes:
            continue
        (src,) = node.inputs
        prod = g.nodes[src]
        if prod.op not in ("conv_counts", "dense_counts"):
            continue
        if len(cons[src]) != 1:
            continue  # counts fan out elsewhere: keep them materialized
        fused_op = ("packed_conv" if prod.op == "conv_counts"
                    else "packed_dense")
        attrs = {k: v for k, v in prod.attrs.items() if k != "k_valid"}
        attrs["layout"] = node.attrs.get("layout", "packed")
        params = dict(prod.params)
        params["thresh"] = node.params["thresh"]
        # Keep the epilogue node's id so its consumers stay wired.
        g.nodes[nid] = node.with_(op=fused_op, inputs=prod.inputs,
                                  attrs=attrs, params=params)
        del g.nodes[src]
    g.validate()
    return g


def absorb_pools(graph: Graph) -> Graph:
    """Rewrite semantic max-pools over packed-binary inputs into OR-pools
    that never leave the packed domain (paper §VI-B)."""
    g = graph.copy()
    for node in g.nodes.values():
        if node.op == "maxpool_pm1" and \
                g.nodes[node.inputs[0]].op in PACKED_OPS:
            node.op = "or_pool"
    return g


def fuse_pool_epilogue(graph: Graph) -> Graph:
    """Merge ``packed_conv → or_pool`` into fused ``packed_conv_pool``.

    Max-pool on packed binary maps is a windowed OR, so the pool can ride
    the conv kernel's epilogue: on the ``cuda_direct_pool`` backend the
    pre-pool conv output is never written to device memory.  Fusion
    requires the conv output to feed only the pool.
    """
    g = graph.copy()
    cons = g.consumers()
    for nid, node in list(g.nodes.items()):
        if node.op != "or_pool" or nid not in g.nodes:
            continue
        (src,) = node.inputs
        prod = g.nodes[src]
        if prod.op != "packed_conv" or len(cons[src]) != 1:
            continue
        attrs = dict(prod.attrs)
        attrs["pool_window"] = node.attrs["window"]
        attrs["pool_stride"] = node.attrs["stride"]
        attrs["pool_pad"] = tuple(node.attrs.get("pad", (0, 0)))
        attrs["layout"] = node.attrs.get("layout", "packed")
        # Keep the pool node's id so its consumers stay wired.
        g.nodes[nid] = node.with_(op="packed_conv_pool", inputs=prod.inputs,
                                  attrs=attrs, params=dict(prod.params))
        del g.nodes[src]
    g.validate()
    return g


def default_pipeline(graph: Graph) -> Graph:
    """The standard lowering pipeline: layouts → BN integration → epilogue
    fusion → pool absorption."""
    return absorb_pools(fuse_epilogues(integrate_bn(assign_layouts(graph))))
