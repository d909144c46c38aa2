"""Port parity: the trained-params graph path and the float oracles.

``lower_trained`` (via ``bnn_model.to_graph``) and each pass of
``runtime.passes`` against the JAX package on the same numpy params: node
for node (op, inputs, attrs, params) after every pass, and the packed
words exact.  Then, on the port alone and against JAX:

* ``default_pipeline(lower_trained(...))`` converges to the
  ``lower_packed(convert(...))`` op sequence, thresholds included;
* the unfused graph (``conv_counts`` through K1's plain version,
  ``bn_binarize`` in float32) equals the fused one bit for bit;
* ``float_forward`` matches the JAX float oracle, and the unfused graph's
  head matches it, at 1e-3 (the reference's own tolerance for that
  comparison); ``cnn_float_forward`` (no binarization: its floats grow
  layer by layer) matches at 1e-4 relative, 1e-5 of the output's scale;
* ``float_model_bytes`` equals the reference's.

Params are drawn with numpy and handed to both sides.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import runtime as j_rt
from repro.core import bnn_model as j_bnn
from repro.core import converter as j_conv
from repro.models import paper_nets as j_nets
from repro_torch import runtime as t_rt
from repro_torch import workloads as t_workloads
from repro_torch.core import bnn_model as t_bnn
from repro_torch.core import converter as t_conv
from repro_torch.models import paper_nets as t_nets


def tiny_net(m):
    return [
        m.BConv(c_in=3, c_out=16, kernel=3, stride=1, pad=1, first=True),
        m.Pool(window=2, stride=2),
        m.BConv(c_in=16, c_out=40, kernel=3, stride=1, pad=1),
        m.Pool(window=2, stride=2),
        m.BDense(d_in=4 * 4 * 40, d_out=64),
        m.BDense(d_in=64, d_out=48),
        m.FloatDense(d_in=48, d_out=10),
    ]


def conv_net(m):
    """An all-conv net with a stride-1 padded pool and a float-conv head."""
    return [
        m.BConv(c_in=3, c_out=16, kernel=3, stride=1, pad=1, first=True),
        m.Pool(window=2, stride=2),
        m.BConv(c_in=16, c_out=32, kernel=3, stride=1, pad=1),
        m.BConv(c_in=32, c_out=32, kernel=3, stride=1, pad=1),
        m.Pool(window=2, stride=1, pad=(0, 1)),
        m.BConv(c_in=32, c_out=48, kernel=3, stride=1, pad=1),
        m.FloatConv(c_in=48, c_out=8, kernel=1, stride=1, pad=0),
    ]


def workload_net(name):
    def spec(m):
        port = t_workloads.get(name, variant="tiny", device="cpu").spec
        return [getattr(m, type(l).__name__)(**vars(l)) for l in port]
    return spec


def workload_hw(name):
    return t_workloads.get(name, variant="tiny", device="cpu").input_hw


# name -> (spec builder over a bnn_model module, input hw, batch)
NETS = {
    "tiny": (tiny_net, (16, 16), 3),
    "convy": (conv_net, (16, 16), 2),
    "alexnet_tiny": (workload_net("alexnet_imagenet"),
                     workload_hw("alexnet_imagenet"), 2),
    "yolov2_tiny": (workload_net("yolov2_tiny_voc"),
                    workload_hw("yolov2_tiny_voc"), 2),
}


@functools.lru_cache(maxsize=None)
def case(name: str):
    """(port spec, JAX spec, numpy params with random BN, hw, x)."""
    build, hw, batch = NETS[name]
    t_spec, j_spec = build(t_bnn), build(j_bnn)
    params = t_workloads.checkpoint_params(t_spec, seed=3)
    params = [{k: v.numpy() for k, v in p.items()} for p in params]
    rng = np.random.default_rng(9)
    x = rng.integers(0, 256, (batch, *hw, 3), dtype=np.uint8)
    return t_spec, j_spec, params, hw, x


def jax_params(params):
    return [{k: jnp.asarray(v) for k, v in p.items()} for p in params]


def cut_to_packed(g):
    """``g`` cut at the last packed node before the float head (its first
    ``unpack_pm1``'s input).  The port's ``Graph.upto`` uses only what both
    packages' graphs have, so it cuts either."""
    unpack = next(n for n in g.nodes.values() if n.op == "unpack_pm1")
    return t_rt.Graph.upto(g, unpack.inputs[0])


def assert_same_graph(tg, jg):
    assert [tg.nodes[i].op for i in tg.topo_order()] == \
        [jg.nodes[i].op for i in jg.topo_order()]
    assert sorted(tg.nodes) == sorted(jg.nodes)
    assert (tg.input_id, tg.output_id) == (jg.input_id, jg.output_id)
    for nid, jn in jg.nodes.items():
        tn = tg.nodes[nid]
        assert (tn.op, tn.inputs, tn.attrs) == (jn.op, jn.inputs, jn.attrs)
        assert set(tn.params) == set(jn.params), nid
        for k, jv in jn.params.items():
            tv = tn.params[k]
            pairs = zip(tv, jv) if isinstance(jv, tuple) else [(tv, jv)]
            for a, b in pairs:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                              err_msg=f"node {nid} {k}")


PASSES = ("assign_layouts", "integrate_bn", "fuse_epilogues", "absorb_pools")


@pytest.mark.parametrize("net", sorted(NETS))
def test_each_pass_matches_reference(net):
    t_spec, j_spec, params, hw, x = case(net)
    tg = t_bnn.to_graph(params, t_spec, hw)
    jg = j_bnn.to_graph(jax_params(params), j_spec, hw)
    assert_same_graph(tg, jg)
    for name in PASSES:
        tg, jg = getattr(t_rt, name)(tg), getattr(j_rt, name)(jg)
        assert_same_graph(tg, jg)
        got = t_rt.GraphExecutor(cut_to_packed(tg), "torch")(
            torch.from_numpy(x))
        want = j_rt.GraphExecutor(cut_to_packed(jg), "xla")(x)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"after {name}")
    assert_same_graph(tg, j_rt.default_pipeline(
        j_bnn.to_graph(jax_params(params), j_spec, hw)))


@pytest.mark.parametrize("net", sorted(NETS))
def test_unfused_graph_types_match_reference(net):
    t_spec, j_spec, params, hw, x = case(net)
    tg = t_rt.assign_layouts(t_rt.lower_trained(t_spec, params, hw))
    jg = j_rt.assign_layouts(j_rt.lower_trained(j_spec, jax_params(params),
                                                hw))
    tt, jt = t_rt.infer_types(tg, x.shape), j_rt.infer_types(jg, x.shape)
    got = t_rt.GraphExecutor(tg, "torch")
    env = {}
    for nid in tg.topo_order():
        node = tg.nodes[nid]
        assert tt[nid].shape == jt[nid].shape, (nid, node.op)
        assert tt[nid].nbytes == jt[nid].nbytes
        env[nid] = (torch.from_numpy(x) if node.op == "input" else
                    t_rt.eval_node(node.op, node.attrs, node.params,
                                   [env[i] for i in node.inputs]))
        assert tuple(env[nid].shape) == tt[nid].shape, (nid, node.op)
        assert env[nid].dtype == tt[nid].dtype
    torch.testing.assert_close(got(torch.from_numpy(x)), env[tg.output_id],
                               rtol=0, atol=0)


@pytest.mark.parametrize("net", sorted(NETS))
def test_pipeline_converges_to_artifact_lowering(net):
    t_spec, _, params, hw, x = case(net)
    g_pass = t_rt.default_pipeline(t_rt.lower_trained(t_spec, params, hw))
    packed = t_conv.convert(params, t_spec, hw)
    g_art = t_rt.lower_packed(t_spec, packed, hw)
    assert [g_pass.nodes[i].op for i in g_pass.topo_order()] == \
        [g_art.nodes[i].op for i in g_art.topo_order()]
    for i_pass, i_art in zip(g_pass.topo_order(), g_art.topo_order()):
        a, b = g_pass.nodes[i_pass].params, g_art.nodes[i_art].params
        assert set(a) == set(b)
        for k in a:
            pairs = zip(a[k], b[k]) if isinstance(b[k], tuple) else \
                [(a[k], b[k])]
            for u, v in pairs:
                assert torch.equal(torch.as_tensor(u), torch.as_tensor(v))
    xt = torch.from_numpy(x)
    torch.testing.assert_close(t_rt.GraphExecutor(g_pass, "torch")(xt),
                               t_bnn.packed_forward(packed, t_spec, xt),
                               rtol=0, atol=0)


@pytest.mark.parametrize("backend", ["torch", "cuda_pm1", "cuda_direct_pool"])
@pytest.mark.parametrize("net", sorted(NETS))
def test_unfused_graph_equals_fused_and_float_oracle(net, backend):
    """The trained path's unfused graph (K1 counts + float BN) equals its
    default-pipeline graph bit for bit in the packed tail, under each
    backend of the fused graph; both heads agree with ``float_forward``
    at 1e-3."""
    t_spec, j_spec, params, hw, x = case(net)
    xt = torch.from_numpy(x)
    unfused = t_rt.assign_layouts(t_bnn.to_graph(params, t_spec, hw))
    fused = t_rt.default_pipeline(t_bnn.to_graph(params, t_spec, hw))
    tail_u = t_rt.GraphExecutor(cut_to_packed(unfused), "torch")(xt)
    tail_f = t_rt.GraphExecutor(cut_to_packed(fused), backend)(xt)
    assert tail_u.dtype == torch.int32
    torch.testing.assert_close(tail_u, tail_f, rtol=0, atol=0)
    oracle = t_bnn.float_forward(params, t_spec, xt)
    for g in (unfused, fused):
        head = t_rt.GraphExecutor(g, backend)(xt)
        torch.testing.assert_close(head, oracle, rtol=0, atol=1e-3)


@pytest.mark.parametrize("net", sorted(NETS))
def test_float_forward_matches_reference(net):
    t_spec, j_spec, params, hw, x = case(net)
    got = t_bnn.float_forward(params, t_spec, torch.from_numpy(x))
    want = j_bnn.float_forward(jax_params(params), j_spec, jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-3)


@pytest.mark.parametrize("net", sorted(NETS))
def test_float_baselines_and_bytes_match_reference(net):
    t_spec, j_spec, params, hw, x = case(net)
    got = t_nets.cnn_float_forward(params, t_spec, torch.from_numpy(x))
    want = j_nets.cnn_float_forward(jax_params(params), j_spec,
                                    jnp.asarray(x))
    # No binarization bounds this net's floats (YOLO's reach ~5e2) and the
    # two frameworks sum its convs in different orders: hold it at 1e-5 of
    # the output's scale.
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
    assert t_conv.float_model_bytes(params) == \
        j_conv.float_model_bytes(jax_params(params))


def test_layout_pass_inserts_adapters():
    t_spec, _, params, hw, _ = case("tiny")
    g = t_rt.lower_trained(t_spec, params, hw)
    assert not {"bitplane_expand", "unpack_pm1"} & {
        n.op for n in g.nodes.values()}
    g2 = t_rt.assign_layouts(g)
    for node in g2.nodes.values():
        if node.op == "conv_counts" and node.attrs["first"]:
            assert g2.nodes[node.inputs[0]].op == "bitplane_expand"
        if node.op == "float_dense":
            assert g2.nodes[node.inputs[0]].op == "unpack_pm1"


def test_graph_to_moves_params():
    t_spec, _, params, hw, _ = case("tiny")
    g = t_rt.default_pipeline(t_rt.lower_trained(t_spec, params, hw))
    moved = g.to("cpu")
    assert moved is not g and sorted(moved.nodes) == sorted(g.nodes)
    thresh = next(n.params["thresh"] for n in moved.nodes.values()
                  if "thresh" in n.params)
    assert thresh.threshold.device.type == "cpu"


def test_concat_packed_evaluates_and_types():
    g = t_rt.Graph(input_hw=(2, 2))
    a = g.add("input", attrs=dict(channels=3))
    g.input_id = a
    e = g.add("bitplane_expand", [a], attrs=dict(c_in=3, channels=3))
    c = g.add("concat_packed", [e, e], attrs=dict(channels=512))
    g.output_id = c
    x = torch.randint(0, 256, (1, 2, 2, 3), dtype=torch.uint8)
    out = t_rt.GraphExecutor(g)(x)
    assert tuple(out.shape) == t_rt.infer_types(g, (1, 2, 2, 3))[c].shape
    assert torch.equal(out[..., :8], out[..., 8:])
