"""Graph rewrite passes (DESIGN.md §4.3) — the serving engine's one pass.

Counterpart of ``repro.runtime.passes.fuse_pool_epilogue``.  The passes
that turn a trained-params graph into the fused one (layout assignment,
BN integration, epilogue fusion, pool absorption) are not ported.
"""

from __future__ import annotations

from repro_torch.runtime.graph import Graph


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
