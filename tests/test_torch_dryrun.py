"""The dry-run tools of the port (``launch/cells.py``, ``analysis.py``,
``dryrun.py``, ``mesh.make_production_mesh``) against the reference's.

* Cells: every one of the 40 (arch × shape) cells has the reference's
  kind or skip; at FULL on a (1, 1) mesh the step's inputs have the
  reference's shapes and dtypes (the port's conv kernels in its (O, I, KH,
  KW) layout), and at (16, 16) and (2, 16, 16) the global inputs and every
  input's spec are the reference's (meshes stood in by
  ``SimpleNamespace``, as ``tests/test_torch_sharded_zoo.py`` does).
* Analysis: ``model_flops_cell`` / ``model_flops_for`` and ``wire_bytes``
  / ``extrapolate`` equal the reference's.
* Traces of a SMOKE LM train cell under ``FakeTensorMode`` over a fake
  process group (each trace inside ``mesh.fake_group``, which destroys its
  group): a depth-4 trace against the L=1/L=2 probes' extrapolation, the
  FLOPs of a (2, 2) mesh's four ranks against one device's, and each
  rank's FLOPs and collectives against a real 4-rank gloo run of the same
  step (one ``spawn``).
* The custom ops (K7, K7b, ``row_parallel``) under ``torch.library.opcheck``
  and ``FlopCounterMode``.
"""

import re
import types

import jax
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from repro import configs as j_configs
from repro.distributed import sharding as j_sharding
from repro.launch import analysis as j_analysis
from repro.launch import cells as j_cells
from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.distributed import sharding
from repro_torch.kernels import flash_attention as k7
from repro_torch.launch import analysis, cells
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import convnext, efficientnet, layers, vit

CELLS = [(a, s.name) for a, s in t_configs.all_cells()]
TRACED = [c for c in CELLS if not c[1].startswith("long_")]
CONV = {"vit-l16": vit.CONV_LEAVES, "vit-h14": vit.CONV_LEAVES,
        "convnext-b": convnext.CONV_LEAVES,
        "efficientnet-b7": efficientnet.CONV_LEAVES}
JOIN_S = 240


def stand_in(shape):
    names = (("data", "model") if len(shape) == 2
             else ("pod", "data", "model"))
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def ref_rules(shape):
    """The reference's rules on a stand-in mesh, their ``named`` the spec
    itself (a ``NamedSharding`` needs a real mesh)."""
    rules = j_sharding.rules_for_mesh(stand_in(shape))
    object.__setattr__(rules, "named", lambda spec: spec)
    return rules


def _name(path: str) -> str:
    keys = re.findall(r"\['([^']*)'\]", path)
    return keys[-1] if keys else ""


def _hwio(arch, path, shape):
    """A port leaf's shape in the reference's layout."""
    if _name(path) not in CONV.get(arch, ()):
        return tuple(shape)
    if len(shape) == 4:
        o, i, kh, kw = shape
        return (kh, kw, i, o)
    l, o, i, kh, kw = shape
    return (l, kh, kw, i, o)


def port_leaves(arch, args):
    """(path, shape in the reference's layout, dtype name) of every leaf."""
    return [(p, _hwio(arch, p, t.shape), str(t.dtype).split(".")[-1])
            for p, t in tree.flatten_with_paths(args)]


def ref_leaves(args):
    flat = jax.tree_util.tree_flatten_with_path(args)[0]
    return [(jax.tree_util.keystr(p), tuple(x.shape), str(x.dtype))
            for p, x in flat]


def port_specs(arch, specs):
    def one(path, s):
        s = tuple(s)
        if _name(path) in CONV.get(arch, ()):
            e = list(s)
            s = ((e[2], e[3], e[1], e[0]) if len(e) == 4
                 else (e[0], e[3], e[4], e[2], e[1]))
        return s
    return [one(p, s) for p, s in tree.flatten_with_paths(specs)]


def ref_specs(specs):
    flat = jax.tree_util.tree_leaves(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    return [tuple(s) for s in flat]


# --------------------------------------------------------------------------
# (a) Cells
# --------------------------------------------------------------------------

def test_every_cell_has_the_reference_kind_and_skips():
    ours = {(a, s.name): (s.kind, s.note) for a, s in t_configs.all_cells()}
    theirs = {(a, s.name): (s.kind, s.note)
              for a, s in j_configs.all_cells()}
    assert ours == theirs and len(ours) == 40
    rules = sharding.rules_for_mesh(stand_in((16, 16)))
    skipped = 0
    for arch, shape in CELLS:
        try:
            b = cells.build_cell(arch, shape, rules)
        except cells.SkippedCell as e:
            with pytest.raises(j_cells.SkippedCell) as want:
                j_cells.build_cell(arch, shape, ref_rules((16, 16)))
            assert str(e) == str(want.value)
            skipped += 1
            continue
        assert b.kind == ours[arch, shape][0]
    assert skipped == 4


@pytest.mark.parametrize("arch", t_configs.ARCH_IDS)
def test_full_inputs_as_reference_on_one_device(arch):
    """FULL on a (1, 1) mesh: the rank's inputs are the global ones, each
    leaf of the reference's shape and dtype, params, optimiser state and
    batch, cache or tokens alike."""
    mesh = mesh_lib.make_host_mesh(1, 1, device="cpu")
    rules = sharding.rules_for_mesh(mesh)
    for a, shape in TRACED:
        if a != arch:
            continue
        got = cells.build_cell(arch, shape, rules)
        want = j_cells.build_cell(arch, shape, ref_rules((1, 1)))
        assert port_leaves(arch, got.abstract_args) == ref_leaves(
            want.abstract_args), shape
        assert port_leaves(arch, got.global_args) == ref_leaves(
            want.abstract_args), shape


@pytest.mark.parametrize("shape", [(16, 16), (2, 16, 16)], ids=str)
def test_specs_and_global_inputs_as_reference(shape):
    rules = sharding.rules_for_mesh(stand_in(shape))
    jr = ref_rules(shape)
    for arch, name in TRACED:
        got = cells.build_cell(arch, name, rules)
        want = j_cells.build_cell(arch, name, jr)
        assert port_specs(arch, got.in_specs) == ref_specs(
            want.in_shardings), (arch, name)
        assert port_leaves(arch, got.global_args) == ref_leaves(
            want.abstract_args), (arch, name)
        # the rank's inputs: the global ones cut by the specs the port's
        # step takes them by (every cut divides)
        for loc, glob in zip(tree.leaves(got.abstract_args),
                             tree.leaves(got.global_args)):
            assert loc.dtype == glob.dtype and loc.dim() == glob.dim()
            assert all(g % n == 0 for g, n in zip(glob.shape, loc.shape))


# --------------------------------------------------------------------------
# (b) Analysis
# --------------------------------------------------------------------------

def test_model_flops_as_reference():
    """The port's ``model_flops_cell`` and ``model_flops_for`` equal the
    reference's ``model_flops_for`` of its build, and its
    ``model_flops_cell`` where that runs: on the ViT cells it passes the
    convnets' argument tuples to ViT's branch, which reads None (caveat
    (k))."""
    rules = sharding.rules_for_mesh(stand_in((16, 16)))
    jr = ref_rules((16, 16))
    refused = set()
    for arch, name in TRACED:
        want = j_analysis.model_flops_for(j_cells.build_cell(arch, name, jr))
        assert want > 0
        try:
            assert j_analysis.model_flops_cell(arch, name) == want
        except (TypeError, AttributeError):
            refused.add(arch)
        got = analysis.model_flops_cell(arch, name)
        built = analysis.model_flops_for(cells.build_cell(arch, name, rules))
        assert got == pytest.approx(want, rel=1e-12), (arch, name)
        assert built == pytest.approx(want, rel=1e-12), (arch, name)
    assert refused == {"vit-l16", "vit-h14"}


RECORDS = [dict(kind=k, operand_bytes=o, out_bytes=u, group=g,
                ranks=tuple(range(g)))
           for k, o, u, g in [("all-reduce", 4096, 4096, 16),
                              ("all-gather", 1024, 16384, 16),
                              ("reduce-scatter", 8192, 512, 16),
                              ("all-to-all", 2048, 2048, 4),
                              ("collective-permute", 100, 100, 2),
                              ("all-reduce", 64, 64, 1)]]


def test_wire_bytes_and_extrapolate_as_reference():
    for rec in RECORDS:
        assert analysis.wire_bytes(rec) == j_analysis.wire_bytes(rec)
    m1 = dict(flops=10.0, bytes=20.0, wire=3.0, operand=4.0,
              counts={"all-reduce": 2})
    m2 = dict(flops=15.0, bytes=29.0, wire=5.0, operand=7.0,
              counts={"all-reduce": 3, "all-gather": 1})
    assert analysis.extrapolate(m1, m2, 32) == j_analysis.extrapolate(
        m1, m2, 32)
    # the between-node class: one run of 8 consecutive ranks stays in
    assert not analysis.between_nodes(dict(ranks=tuple(range(8, 16))))
    assert analysis.between_nodes(dict(ranks=(0, 16, 32)))


# --------------------------------------------------------------------------
# (c) Traces
# --------------------------------------------------------------------------

ARCH = "minitron-8b"


def trace_cell(shape, rank, n_layers=None):
    """A SMOKE train cell of ARCH traced as ``rank`` of ``shape`` (a fake
    process group, destroyed after)."""
    over = {"n_layers": n_layers} if n_layers else None
    world = int(np.prod(shape))

    def one():
        mesh = mesh_lib.make_host_mesh(*shape, device="cpu")
        build = cells.build_cell(ARCH, "train_4k",
                                 sharding.rules_for_mesh(mesh), smoke=True,
                                 overrides=over)
        return cells.trace_step(build.step_fn, build.abstract_args, "cpu",
                                memory=False)

    if world == 1:
        return one()
    with mesh_lib.fake_group(world, rank):
        return one()


@pytest.fixture(scope="module")
def ranks22():
    """Each rank's trace of the (2, 2) cell at its SMOKE depth (2)."""
    return [trace_cell((2, 2), r) for r in range(4)]


def test_full_depth_trace_against_extrapolated_probes(ranks22):
    """FLOPs, wire and operand bytes and the collective counts of a depth-4
    trace equal the L=1/L=2 probes' extrapolation.  The HBM bytes are
    quadratic in depth, exactly: each layer's ``t[i]`` of a stacked leaf
    backs into a full-size zero-padded gradient, summed over the layers
    (ROADMAP, "Host-bound train steps"), which the probes cannot see."""
    m = [analysis.collect(trace_cell((2, 2), 0, l)) for l in (1, 3, 4)]
    m.insert(1, analysis.collect(ranks22[0]))
    probe = analysis.extrapolate(m[0], m[1], 4)
    for k in ("flops", "wire", "operand", "inter"):
        assert m[3][k] == probe[k], k
    assert m[3]["counts"] == probe["counts"]
    assert m[3]["wire"] > 0 and m[3]["flops"] > 0
    second = m[2]["bytes"] - 2 * m[1]["bytes"] + m[0]["bytes"]
    assert second > 0
    assert m[3]["bytes"] - probe["bytes"] == 3 * second
    assert m[3]["bytes"] - 3 * m[2]["bytes"] + 3 * m[1]["bytes"] \
        - m[0]["bytes"] == 0


def test_mesh_flops_sum_to_one_device(ranks22):
    """At the same global batch the four ranks of (2, 2) do one device's
    FLOPs between them (heads, d_ff and vocab cut over ``model``, the rows
    over ``data``; SMOKE minitron replicates no product), and one product
    more a layer: the remat's recompute of a layer stops once it has
    remade every tensor the backward saved, which on one device is before
    the layer's last product (``w_down``: an aten product saves its
    inputs before it runs), while the op ``row_parallel`` saves its
    inputs after, so on a mesh the recompute runs it, and its sum, again."""
    one = trace_cell((1, 1), 0)["flops"]
    ranks = [t["flops"] for t in ranks22]
    cfg = t_configs.get(ARCH).smoke
    b, s = 2, 64
    assert sum(ranks) == one + cfg.n_layers * 2 * b * s * cfg.d_ff \
        * cfg.d_model
    assert len(set(ranks)) == 1


def _records(recs):
    return [(r["kind"], r["operand_bytes"], r["out_bytes"], r["group"],
             r["ranks"]) for r in recs]


def real_step_rank(rank, device):
    """One rank of a real (2, 2) gloo run of the SMOKE train step: its
    FLOPs and collectives."""
    torch.manual_seed(rank)
    mesh = mesh_lib.make_host_mesh(2, 2, device=device)
    build = cells.build_cell(ARCH, "train_4k", sharding.rules_for_mesh(mesh),
                             smoke=True)
    vocab = build.cfg.vocab

    def real(x):
        if x.dtype.is_floating_point:
            return torch.randn(x.shape, dtype=x.dtype)
        return torch.randint(0, vocab, x.shape, dtype=x.dtype)

    args = tree.tree_map(real, build.abstract_args)
    with sharding.Collective.recording() as recs, \
            FlopCounterMode(display=False) as flops:
        build.step_fn(*args)
    return dict(flops=flops.get_total_flops(), records=_records(recs))


def test_fake_trace_equals_a_real_gloo_run(ranks22, tmp_path):
    real = mesh_lib.spawn(real_step_rank, 4, device="cpu", threads=1,
                          timeout_s=JOIN_S, workdir=str(tmp_path))
    for fake, got in zip(ranks22, real):
        assert fake["flops"] == got["flops"]
        assert _records(fake["collectives"]) == got["records"]
        assert got["records"]


def test_production_mesh_traces_a_cell():
    """A FULL cell at one layer on the 16×16 production mesh (a fake group
    of 256 ranks): collectives over groups of 16, all between nodes."""
    with mesh_lib.fake_group(256, 37):
        mesh = mesh_lib.make_production_mesh(rank=37, device="cpu")
        assert mesh.describe().startswith("mesh data 16 x model 16")
        build = cells.build_cell("vit-l16", "serve_b128",
                                 sharding.rules_for_mesh(mesh),
                                 overrides=dict(n_layers=1))
        got = build.trace()
    assert got["attention"] == "plain versions" and got["flops"] > 0
    assert {r["group"] for r in got["collectives"]} == {16}
    assert all(analysis.between_nodes(r) for r in got["collectives"])
    rep = analysis.analyze("vit-l16", "serve_b128", build.kind, mesh, got,
                           analysis.model_flops_for(build))
    assert rep.n_devices == 256 and rep.mesh == "16x16"
    assert rep.t_collective == rep.collective_wire_bytes / \
        analysis.NETWORK_BW


# --------------------------------------------------------------------------
# (d) The custom ops
# --------------------------------------------------------------------------

def _qkv(seed, b=2, s=64, h=4, kv=2, hd=16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(b, s, h, hd, generator=g),
            torch.randn(b, s, kv, hd, generator=g),
            torch.randn(b, s, kv, hd, generator=g))


@pytest.mark.parametrize("causal,with_lse", [(True, True), (False, False)])
def test_k7_op(causal, with_lse):
    q, k, v = _qkv(0)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_fwd,
                          (q, k, v, causal, 32, 32, with_lse))
    out, lse = torch.ops.repro_torch.flash_attention_fwd(
        q, k, v, causal, 32, 32, with_lse)
    want = k7.flash_attention_plain(q, k, v, causal, 32, 32)
    assert torch.equal(out, want)
    assert lse.shape == ((2, 4, 64) if with_lse else (0,))
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_attention_fwd(q, k, v, causal, 32, 32,
                                                  with_lse)
    pairs = 64 * 65 // 2 if causal else 64 * 64
    assert fc.get_total_flops() == 4 * 2 * 4 * 16 * pairs


def test_k7b_op():
    q, k, v = _qkv(1)
    out, lse = k7.flash_attention_fwd(q, k, v, True, 32, 32)
    do = torch.randn_like(out)
    args = (q, k, v, out, lse, do, True, 32, 32)
    torch.library.opcheck(torch.ops.repro_torch.flash_attention_bwd, args)
    got = torch.ops.repro_torch.flash_attention_bwd(*args)
    want = k7.flash_attention_bwd_plain(*args)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with FlopCounterMode(display=False) as fc:
        torch.ops.repro_torch.flash_attention_bwd(*args)
    assert fc.get_total_flops() == 10 * 2 * 4 * 16 * (64 * 65 // 2)


def test_row_parallel_op():
    comm = sharding.Collective(None, 1, 0)
    layers._ROW_COMMS[id(comm)] = comm
    g = torch.Generator().manual_seed(2)
    a = torch.randn(6, 8, generator=g, dtype=torch.bfloat16,
                    requires_grad=True)
    w = torch.randn(8, 5, generator=g, requires_grad=True)
    torch.library.opcheck(torch.ops.repro_torch.row_parallel,
                          (a, w, id(comm), 0))
    with FlopCounterMode(display=False) as fc:
        layers.row_parallel(a.detach(), w.detach(), comm)
    assert fc.get_total_flops() == 2 * 6 * 8 * 5


def test_a_cuda_trace_never_reaches_the_library(monkeypatch):
    """K7's and K7b's fakes give their outputs' shapes without the
    library (a ``FakeTensorMode`` trace; no card here, so the fakes claim
    the CPU and the ops are called directly)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    def refuse(*a, **k):
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(k7.build, "library", refuse)
    before = (k7.flash_attention.launches, k7.flash_attention_bwd.launches)
    with FakeTensorMode():
        q, k, v = (torch.empty(2, 256, 8, 80, dtype=torch.bfloat16),
                   torch.empty(2, 256, 2, 80, dtype=torch.bfloat16),
                   torch.empty(2, 256, 2, 80, dtype=torch.bfloat16))
        out, lse = k7._fwd_fake(q, k, v, True, 512, 512, True)
        dq, dk, dv = k7._bwd_fake(q, k, v, out, lse, out, True, 512, 512)
    assert out.shape == q.shape and lse.shape == (2, 8, 256)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    assert (k7.flash_attention.launches,
            k7.flash_attention_bwd.launches) == before
