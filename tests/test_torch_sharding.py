"""Port parity, in one process: the sharding rules and the per-shard
bodies of the sharded LM path.

* ``Rules``' arithmetic (``axis_size``, ``dp``, ``tp``, ``n_devices``,
  ``shard_if``, ``batch_spec``, ``tokens_spec``) against the reference's
  ``Rules`` on a stand-in mesh, an object with ``.shape`` and
  ``.axis_names`` (all the reference's ``Rules`` reads: no forced JAX
  devices), on the meshes (1,1), (1,4), (4,1), (2,4), (16,16) and
  (2,16,16);
* ``param_specs`` and ``cache_specs`` equal to the reference's, entry for
  entry, for the four LM configs (SMOKE and FULL) and the serving demo
  LM on those meshes;
* ``local_shard``'s blocks, and ``spec_tree_like``;
* ``flash_decode_local`` against the reference's (float32, 1e-5 of the
  output's scale);
* the per-shard bodies on stacked shards: the port's ``_moe_local`` (one
  thread a shard, collectives through a barrier) against the reference's
  ``_moe_local`` under ``jax.vmap(axis_name="model")`` with its two
  ``lax.all_to_all`` (float32 tokens; the expert FFN rounds to bf16 in
  both, so 1e-2 of the output's scale, with aux to 1e-5), and
  ``combine_decode_partials`` against the reference's under the same
  vmap (float32, 1e-5).
"""

import threading
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.distributed import sharding as j_sharding
from repro.models import layers as j_layers
from repro.models import moe as j_moe
from repro.models import transformer as j_tf
from repro_torch import configs as t_configs
from repro_torch.distributed import sharding as t_sharding
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf

MESHES = [(1, 1), (1, 4), (4, 1), (2, 4), (16, 16), (2, 16, 16)]
LM_ARCHS = ("minitron-8b", "qwen3-moe-30b-a3b", "granite-moe-3b-a800m",
            "command-r-35b")
DEMO = dict(name="lm-serve-demo", n_layers=4, d_model=256, n_heads=8,
            n_kv_heads=4, d_head=32, d_ff=512, vocab=1024,
            tie_embeddings=True)
DECODE_TOL = 1e-5
MOE_TOL = 1e-2


def stand_in(shape):
    names = ("pod", "data", "model") if len(shape) == 3 else ("data",
                                                               "model")
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def both_rules(shape):
    mesh = stand_in(shape)
    return j_sharding.rules_for_mesh(mesh), t_sharding.rules_for_mesh(mesh)


def configs_pair(which):
    if which == "demo":
        return (j_tf.LMConfig(**DEMO), t_tf.LMConfig(**DEMO))
    arch, size = which
    return (getattr(j_configs.get(arch), size),
            getattr(t_configs.get(arch), size))


def as_tuples(spec_tree):
    if isinstance(spec_tree, dict):
        return {k: as_tuples(v) for k, v in spec_tree.items()}
    return tuple(spec_tree)


# --------------------------------------------------------------------------
# Rules and specs
# --------------------------------------------------------------------------

@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_rules_arithmetic_as_reference(shape):
    jr, tr = both_rules(shape)
    assert type(tr).__name__ == type(jr).__name__ == "Rules"
    assert (tr.batch, tr.model, tr.fsdp) == (jr.batch, jr.model, jr.fsdp)
    for name in (None, "data", "model", ("data", "model"), tr.batch):
        assert tr.axis_size(name) == jr.axis_size(name)
    assert (tr.dp, tr.tp, tr.n_devices) == (jr.dp, jr.tp, jr.n_devices)
    for dim in (1, 2, 3, 4, 6, 8, 16, 24, 48, 49155, 49156, 256000, 2304):
        for axes in (None, "model", "data", tr.batch, (*tr.batch,
                                                       tr.model)):
            assert tr.shard_if(dim, axes) == jr.shard_if(dim, axes)
        assert tr.batch_spec(dim) == jr.batch_spec(dim)
        assert tr.tokens_spec(dim) == jr.tokens_spec(dim)


@pytest.mark.parametrize("shape", MESHES, ids=str)
@pytest.mark.parametrize("which", [(a, s) for a in LM_ARCHS
                                   for s in ("smoke", "full")] + ["demo"],
                         ids=str)
def test_param_and_cache_specs_as_reference(which, shape):
    jcfg, tcfg = configs_pair(which)
    jr, tr = both_rules(shape)
    assert as_tuples(t_tf.param_specs(tcfg, tr)) \
        == as_tuples(j_tf.param_specs(jcfg, jr))
    for batch, max_seq in ((1, 48), (4, 48), (128, 32768), (2, 2304),
                           (6, 50)):
        assert as_tuples(t_tf.cache_specs(tcfg, tr, batch, max_seq)) \
            == as_tuples(j_tf.cache_specs(jcfg, jr, batch, max_seq))


def test_specs_match_init_params_tree():
    """Every leaf of ``init_params`` has its spec, of its rank."""
    cfg = t_configs.get("qwen3-moe-30b-a3b").smoke
    _, tr = both_rules((2, 4))
    params = t_tf.abstract_params(cfg, ep=4, vocab_pad_to=4)
    specs = t_tf.param_specs(cfg, tr)
    flat = dict(t_sharding.tree.flatten_with_paths(params))
    sflat = dict(t_sharding.tree.flatten_with_paths(specs))
    assert flat.keys() == sflat.keys()
    assert all(len(sflat[k]) == flat[k].dim() for k in flat)
    like = t_sharding.spec_tree_like(params, lambda path, leaf: path)
    assert like["layers"]["wq"] == "['layers']['wq']"


def test_local_shard_blocks_tile_the_tensor():
    """Each rank's slice of a (2,4) mesh, put back together by
    concatenation in rank order, is the full tensor."""
    full = torch.arange(8 * 12 * 8).reshape(8, 12, 8)
    spec = t_sharding.P("data", None, "model")
    blocks = {}
    for rank in range(8):
        mesh = types.SimpleNamespace(
            shape={"data": 2, "model": 4}, axis_names=("data", "model"),
            coordinate=lambda axes, r=rank: (
                (r // 4 if "data" in axes else 0) * (4 if "model" in axes
                                                     else 1)
                + (r % 4 if "model" in axes else 0)))
        rules = t_sharding.Rules(mesh)
        blocks[rank] = t_sharding.local_shard(full, spec, rules)
        assert blocks[rank].shape == (4, 12, 2)
    rows = [torch.cat([blocks[d * 4 + m] for m in range(4)], dim=2)
            for d in range(2)]
    assert torch.equal(torch.cat(rows, dim=0), full)
    with pytest.raises(ValueError, match="does not split"):
        t_sharding.local_shard(torch.zeros(6, 5), t_sharding.P(None,
                                                               "model"),
                               rules)


# --------------------------------------------------------------------------
# Flash decode
# --------------------------------------------------------------------------

@pytest.mark.parametrize("valid,start", [(40, 0), (40, 32), (7, 16),
                                         (64, 48)])
def test_flash_decode_local_as_reference(valid, start):
    rng = np.random.default_rng(11)
    b, c, kv, g, hd = 2, 16, 2, 4, 8
    q = rng.standard_normal((b, kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((b, c, kv, hd)).astype(np.float32)
    v = rng.standard_normal((b, c, kv, hd)).astype(np.float32)
    got = t_layers.flash_decode_local(*map(torch.from_numpy, (q, k, v)),
                                      valid, start)
    want = j_layers.flash_decode_local(*map(jnp.asarray, (q, k, v)),
                                       valid, start)
    for a, w in zip(got, want):
        w = np.asarray(w)
        assert a.dtype == torch.float32 and a.shape == w.shape
        assert np.abs(a.numpy() - w).max() <= DECODE_TOL * max(
            1.0, np.abs(w).max())


# --------------------------------------------------------------------------
# Per-shard bodies on stacked shards
# --------------------------------------------------------------------------

class ThreadGroup:
    """n shards run as n threads of one process; each collective is an
    exchange through shared slots between two barriers."""

    def __init__(self, n: int):
        self.n = n
        self.barrier = threading.Barrier(n)
        self.slots = [None] * n

    def run(self, body, n_args):
        out, errors = [None] * self.n, []

        def work(i):
            try:
                out[i] = body(i, ThreadCollective(self, i), *n_args[i])
            except BaseException as e:       # surfaced below
                errors.append(e)
                self.barrier.abort()

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(self.n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        if errors:
            raise errors[0]
        return out


class ThreadCollective:
    """The port's ``Collective`` interface over a :class:`ThreadGroup`."""

    def __init__(self, group: ThreadGroup, index: int):
        self.group, self.index, self.size = group, index, group.n

    def _exchange(self, x):
        self.group.slots[self.index] = x
        self.group.barrier.wait()
        parts = list(self.group.slots)
        self.group.barrier.wait()
        return parts

    def psum(self, x):
        return torch.stack(self._exchange(x)).sum(0)

    def pmax(self, x):
        return torch.stack(self._exchange(x)).amax(0)

    def pmean(self, x):
        return self.psum(x) / self.size

    def all_gather(self, x, axis=0):
        return torch.cat(self._exchange(x), dim=axis)

    def all_to_all(self, x, split_axis, concat_axis):
        parts = self._exchange(x)
        return torch.cat([p.chunk(self.size, split_axis)[self.index]
                          for p in parts], dim=concat_axis)


@pytest.mark.parametrize("act,factor", [("swiglu", 8.0), ("swiglu", 1.25),
                                        ("relu2", 8.0)])
def test_moe_local_on_stacked_shards_as_reference(act, factor):
    """4 shards of 16 tokens, 8 experts (2 a shard), top-2: the port's
    per-shard EP body against the reference's under vmap, drops (factor
    1.25) included."""
    ep, t_l, d, e, k, fe = 4, 16, 16, 8, 2, 32
    rng = np.random.default_rng(7)
    x = rng.standard_normal((ep, t_l, d)).astype(np.float32)
    router = (rng.standard_normal((d, e)) * 0.1).astype(np.float32)
    wg, wu = ((rng.standard_normal((e, d, fe)) / np.sqrt(d))
              .astype(np.float32) for _ in range(2))
    wd = (rng.standard_normal((e, fe, d)) / np.sqrt(fe)).astype(np.float32)
    cap = t_moe.capacity(t_l, k, e, factor)
    assert cap == j_moe.capacity(t_l, k, e, factor)

    def j_body(xs, wg_s, wu_s, wd_s):
        return j_moe._moe_local(xs, jnp.asarray(router), wg_s, wu_s, wd_s,
                                n_real=e, top_k=k, cap=cap,
                                ep_axis="model", all_axes=("model",),
                                act=act)

    stack = lambda w: w.reshape(ep, e // ep, *w.shape[1:])  # noqa: E731
    want, jaux = jax.vmap(j_body, axis_name="model")(
        jnp.asarray(x), *(jnp.asarray(stack(w)) for w in (wg, wu, wd)))

    def body(i, comm, xs, wg_s, wu_s, wd_s):
        return t_moe._moe_local(xs, torch.from_numpy(router), wg_s, wu_s,
                                wd_s, n_real=e, top_k=k, cap=cap, ep=comm,
                                all_axes=comm, act=act)

    shards = [tuple(torch.from_numpy(a) for a in
                    (x[i], stack(wg)[i], stack(wu)[i], stack(wd)[i]))
              for i in range(ep)]
    got = ThreadGroup(ep).run(body, shards)
    scale = np.abs(np.asarray(want)).max()
    for i, (out, aux) in enumerate(got):
        assert out.dtype == torch.float32
        assert np.abs(out.numpy() - np.asarray(want[i])).max() \
            <= MOE_TOL * scale
        np.testing.assert_allclose(float(aux), float(jaux[i]), rtol=1e-5)


def test_combine_decode_partials_on_stacked_shards_as_reference():
    """4 shards' partials over chunks of a 64-position cache with 40
    valid (the last shard's chunk entirely masked)."""
    n, b, c, kv, g, hd = 4, 2, 16, 2, 3, 8
    rng = np.random.default_rng(13)
    q = rng.standard_normal((b, kv * g, hd)).astype(np.float32)
    k = rng.standard_normal((n, b, c, kv, hd)).astype(np.float32)
    v = rng.standard_normal((n, b, c, kv, hd)).astype(np.float32)
    valid = 40

    def j_body(ks, vs, start):
        o, m, l = j_layers.flash_decode_local(jnp.asarray(q), ks, vs,
                                              valid, start)
        return j_layers.combine_decode_partials(o, m, l, "model")

    want = jax.vmap(j_body, axis_name="model")(
        jnp.asarray(k), jnp.asarray(v), jnp.arange(n) * c)

    def body(i, comm, ks, vs):
        o, m, l = t_layers.flash_decode_local(torch.from_numpy(q), ks, vs,
                                              valid, i * c)
        return t_layers.combine_decode_partials(o, m, l, comm)

    got = ThreadGroup(n).run(body, [(torch.from_numpy(k[i]),
                                     torch.from_numpy(v[i]))
                                    for i in range(n)])
    for i in range(n):
        w = np.asarray(want[i])
        assert np.abs(got[i].numpy() - w).max() <= DECODE_TOL * max(
            1.0, np.abs(w).max())
    # Against the whole cache's plain softmax too.
    whole = t_layers.flash_decode_local(
        torch.from_numpy(q), torch.from_numpy(np.concatenate(k, 1)),
        torch.from_numpy(np.concatenate(v, 1)), valid, 0)
    torch.testing.assert_close(got[0], whole[0] / whole[2][..., None],
                               rtol=1e-5, atol=1e-5)
