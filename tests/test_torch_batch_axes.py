"""Port parity on the batch axes: meshes whose data ranks hold LM slots,
and batches the batch axes do not divide.

The reference takes any ``Rules``: its ``LMServer`` cuts the slots over
``rules.batch_spec(n_slots)`` and its cache likewise, and its train
entry point and models place a batch with ``batch_spec(B)``, which falls
back to fewer batch axes, then to none, where B does not divide them.  The
port does the same through ``Rules.batch_cut``.  One module-scoped spawn
of 4 gloo ranks (one thread a rank, ``file://`` rendezvous, a join
timeout ``JOIN_S``) runs every rank-side case; this process computes the
JAX side and the one-device port path and hands the ranks numpy arrays
(the ranks import no JAX).  Compared:

* ``LMServer`` on (2, 2) ``("data", "model")`` over minitron-8b SMOKE
  weights, ``n_slots`` 4 (two slots a data rank) and 3 (every slot on
  every data rank): the same outcomes and tokens on every rank as the
  one-device port server; again through decode faults that spend the
  retries (``checkpoint_every=3``): one restore from each rank's cache
  rows and chunk, the same tokens; and in float32 compute (weights,
  cache and products; the reference's ``layers.COMPUTE_DTYPE`` patched
  in this process) the same tokens as the one-device port server and the
  reference's ``LMServer`` on a (1, 1) mesh.  In bf16 the port and the
  reference part at a near-tie (3 slots: a top-2 logit gap of 2e-3, where
  the two packages' bf16 logits differ by 8e-3 relative), which float32
  compute does not reach;
* ``LMReplicaGroup(cfg, rules, params)`` on (2, 2): lane lm0 evacuates to
  lm1 with the one-device group's tokens and migrations;
* the LM train step at B 6 (lm-100m's layout at SMOKE width, and
  granite-moe-3b-a800m SMOKE at capacity factor 8, nothing dropped) on
  (4, 1), where ``batch_spec(6)`` keeps no axis and every rank holds the
  6 rows, and the dense arch on (2, 2, 1) ``("pod", "data", "model")``,
  where the rows are cut over ``data`` alone: ``TokenPipeline(rules=)``
  places the rows, ``loss_fn(..., batch_size=6)`` and every gradient
  leaf, summed over the batch axes (``sync_grads``) and gathered, in
  float32 compute, against the port's one-device path and the
  reference's ``loss_fn`` and gradient on a (1, 1) mesh in float32
  compute (the reference's ``layers.COMPUTE_DTYPE`` patched in this
  process; no JAX file changes): the loss within ``LOSS_TOL`` relative,
  each leaf within ``LEAF_TOL`` relative L2.  The MoE's tokens are cut
  over ``data`` while its rows are not (``tokens_spec(192)``), so its
  balance loss is the mean of the 4 token shards': the one-device side
  takes it over the same 4 contiguous shards (``patched_moe``);
* ``launch.train.main`` in the ranks on (4, 1) at ``--batch 6`` against
  the same entry point on one device: step 0's loss within
  ``SINGLE_LOSS_TOL`` (bf16 compute, ``tests/test_torch_sharded_train.py``'s
  bound), the next within its ``STEP_LOSS_TOL``;
* ViT, ConvNeXt and EfficientNet SMOKE train steps at a batch of 3 on
  (2, 2), and DiT at a batch of 2 on (2, 2, 1), all in float32 compute
  against one device, the loss within ``LOSS_TOL`` and each leaf within
  ``LEAF_TOL`` of its own norm or of ``GRAD_FLOOR`` of the tree's
  (``tests/test_torch_sharded_zoo.py``'s rule for a leaf whose gradient
  is ~0, as a bias under a batch norm); EfficientNet's BN running
  statistics bit for bit equal on every rank and, gathered over
  ``model``, within ``LEAF_TOL`` of one device's;
* ``InferenceServer(validate=False)`` and ``(degrade=False)`` against the
  reference's on one fault plan and one fake clock: the same outcomes,
  attempts, counters, mode, fault log and flight records; a
  ``MultiTenantServer``'s lanes take the switches from its defaults or
  their own keywords.
"""

import concurrent.futures
import dataclasses
from unittest import mock

import numpy as np
import pytest
import torch

from repro_torch import configs as t_configs
from repro_torch import tree
from repro_torch.data import TokenPipeline
from repro_torch.distributed import LMReplicaGroup, rules_for_mesh
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import gather
from repro_torch.kernels.ops import JAX_MODE
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import train as t_train
from repro_torch.models import convnext as t_cn
from repro_torch.models import dit as t_dit
from repro_torch.models import efficientnet as t_eff
from repro_torch.models import layers as t_layers
from repro_torch.models import moe as t_moe
from repro_torch.models import transformer as t_tf
from repro_torch.models import vit as t_vit
from repro_torch.serving import faults
from repro_torch.serving.faults import FaultPlan, FaultSpec
from repro_torch.serving.lm_server import LMServer

JOIN_S = 240
LOSS_TOL = 1e-5
LEAF_TOL = 1e-3
GRAD_FLOOR = 0.05        # tests/test_torch_sharded_zoo.py's
SINGLE_LOSS_TOL = 1e-5   # tests/test_torch_sharded_train.py's
STEP_LOSS_TOL = 2e-4
LM_BATCH, SEQ = 6, 32
ZOO_BATCH = 3
MAX_SEQ = 64
SERVER_REQUESTS = [(8, 6), (5, 4), (12, 8), (3, 5)]
SLOTS = (4, 3)
# lm-100m's layout (launch/train.py LM_100M) at SMOKE width
LM_SMOKE = dict(name="lm-100m-smoke", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, d_head=16, d_ff=128, vocab=256,
                tie_embeddings=True, rope_theta=10_000.0, mlp_act="swiglu")
LANE_CFG = dict(name="t", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                d_head=16, d_ff=64, vocab=64, tie_embeddings=True)
TRAIN_MESHES = {"4x1": dict(data=4, model=1),
                "pod": dict(pod=2, data=2, model=1)}
LM_CASES = [("lm", "4x1"), ("lm", "pod"), ("moe", "4x1")]
ZOO = {"vit-h14": t_vit, "convnext-b": t_cn, "efficientnet-b7": t_eff,
       "dit-xl2": t_dit}
ZOO_MESH = {"vit-h14": "2x2", "convnext-b": "2x2", "efficientnet-b7": "2x2",
            "dit-xl2": "pod"}
RES = {"efficientnet-b7": 128}    # caveat (i)'s conditioned size
TRAIN_ARGS = ["--device", "cpu", "--arch", "minitron-8b", "--smoke",
          "--steps", "2", "--batch", str(LM_BATCH), "--seq-len", "16",
          "--log-every", "100"]


def lm_cfg(kind):
    if kind == "lm":
        return t_tf.LMConfig(**LM_SMOKE)
    return dataclasses.replace(t_configs.get("granite-moe-3b-a800m").smoke,
                               capacity_factor=8.0)


def rel_l2(got, want) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def check_leaves(got, want, tol, floor=0.0):
    total = np.sqrt(sum(float(np.square(np.asarray(w, np.float64)).sum())
                        for w in want))
    assert len(got) == len(want)
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.shape == b.shape, (i, a.shape, b.shape)
        gap = float(np.linalg.norm(np.asarray(a, np.float64) - b))
        assert gap <= tol * max(float(np.linalg.norm(b)), floor * total), \
            (i, gap, float(np.linalg.norm(b)))


def float32_compute():
    return mock.patch.object(t_layers, "COMPUTE_DTYPE", torch.float32)


def patched_moe(n):
    """``moe_apply``'s balance loss as the mean of ``n`` contiguous token
    shards' losses (a mesh's: the reference's ``_moe_local`` pmean)."""
    real = t_moe.moe_apply

    def moe_apply(x, router, wg, wu, wd, **kw):
        out, _ = real(x, router, wg, wu, wd, **kw)
        auxs = []
        for xs in x.reshape(n, -1, x.shape[-1]):
            _, ids, probs = t_moe._route(xs, router, n_real=kw["n_experts"],
                                         top_k=kw["top_k"])
            onehot = (ids[..., None]
                      == torch.arange(router.shape[1])).float()
            auxs.append(kw["n_experts"] * (onehot.sum(1).mean(0)
                                           * probs.mean(0)).sum())
        return out, torch.stack(auxs).mean()
    return mock.patch.object(t_moe, "moe_apply", moe_apply)


def numpy_lm_params(cfg, seed: int) -> dict:
    """The reference's ``init_params`` tree for ``cfg`` (its shapes and
    scales), drawn from a numpy seed, float32."""
    rng = np.random.default_rng(seed)
    lay = {}
    for name, shape, fan_in in t_tf._layer_shapes(cfg):
        full = (cfg.n_layers, *shape)
        lay[name] = ((rng.standard_normal(full) / np.sqrt(fan_in))
                     if fan_in else np.ones(full)).astype(np.float32)
    out = {"embed": (rng.standard_normal((cfg.vocab, cfg.d_model))
                     * 0.02).astype(np.float32),
           "layers": lay, "final_norm": np.ones(cfg.d_model, np.float32)}
    if not cfg.tie_embeddings:
        out["lm_head"] = (rng.standard_normal((cfg.d_model, cfg.vocab))
                          * 0.02).astype(np.float32)
    return out


def pipeline(cfg, rules=None):
    return TokenPipeline(seed=5, batch=LM_BATCH, seq_len=SEQ,
                         vocab=cfg.vocab, device="cpu", rules=rules,
                         prefetch=0)


def map_named(fn, t, name=""):
    if isinstance(t, dict):
        return {k: map_named(fn, v, k) for k, v in t.items()}
    if isinstance(t, (list, tuple)):
        return type(t)(map_named(fn, v, name) for v in t)
    return fn(name, t)


def zoo_cfg(arch):
    return t_configs.get(arch).smoke


def numpy_zoo_params(arch, seed: int):
    """The port's init for the SMOKE config, every leaf drawn anew at O(1)
    scale around it (BN variances exp(N(0, 0.3²))), in the reference's
    layouts (``tests/test_torch_sharded_zoo.py``'s draw)."""
    mod, cfg = ZOO[arch], zoo_cfg(arch)
    rng = np.random.default_rng(seed)
    full = mod.init_params(cfg, torch.Generator().manual_seed(seed), "cpu")

    def leaf(name, t):
        if name in getattr(mod, "CONV_LEAVES", ()):
            t = t_layers.oihw_to_hwio(t)
        a = t.float().numpy()
        if name == "var":
            return np.exp(0.3 * rng.standard_normal(a.shape)).astype(
                np.float32)
        sd = float(a.std()) if a.size > 1 else 0.0
        s = 0.5 * sd if sd > 0 else 0.2
        return (a + s * rng.standard_normal(a.shape)).astype(np.float32)

    return map_named(leaf, full)


def zoo_batch(arch, seed: int):
    cfg = zoo_cfg(arch)
    rng = np.random.default_rng(seed)
    if arch == "dit-xl2":
        n, hl = 2, cfg.latent_res()
        return {"latents": rng.standard_normal((n, hl, hl, 4)).astype(
                    np.float32),
                "noise": rng.standard_normal((n, hl, hl, 4)).astype(
                    np.float32),
                "t": rng.integers(0, 1000, n).astype(np.int32),
                "labels": rng.integers(0, cfg.n_classes, n).astype(
                    np.int32)}
    r = RES.get(arch, cfg.img_res)
    return {"images": rng.random((ZOO_BATCH, r, r, 3), dtype=np.float32),
            "labels": rng.integers(0, cfg.n_classes,
                                   ZOO_BATCH).astype(np.int32)}


# --------------------------------------------------------------------------
# Both sides (the port's): loss, gathered leaves
# --------------------------------------------------------------------------

def lm_loss_grads(kind, params_np, rules=None):
    """(loss, gradient leaves whole) of the port's LM ``loss_fn`` in
    float32 compute on the pipeline's batch: the rank's rows on
    ``rules``, the whole batch on one device."""
    cfg = lm_cfg(kind)
    with float32_compute():
        params = t_tf.params_from_numpy(params_np, cfg, "cpu",
                                        dtype=torch.float32, rules=rules)
        batch = pipeline(cfg, rules).batch_at(0)
        (loss, _), grads = tree.value_and_grad(
            t_tf.loss_fn, params, batch, cfg, rules, batch_size=LM_BATCH)
        if rules is None:
            return float(loss), [g.numpy() for g in tree.leaves(grads)]
        specs = t_tf.param_specs(cfg, rules)
        grads = sharding.sync_grads(grads, specs, rules)
        return float(loss), [gather(g, s, rules).numpy() for g, s in
                             zip(tree.leaves(grads), tree.leaves(specs))]


def zoo_loss_grads(arch, params_np, batch_np, rules=None):
    """(loss, leaves whole, BN state (the rank's blocks, whole over
    ``model``)) of one float32 train step's gradient."""
    mod, cfg = ZOO[arch], zoo_cfg(arch)
    with float32_compute():
        got = mod.params_from_numpy(params_np, cfg, "cpu", rules=rules)
        params, state = got if arch == "efficientnet-b7" else (got, None)
        batch = {k: torch.from_numpy(np.ascontiguousarray(v))
                 for k, v in batch_np.items()}
        if arch == "dit-xl2":       # every rank the whole batch
            (loss, _), grads = tree.value_and_grad(mod.train_loss, params,
                                                   batch, cfg, rules)
        else:
            cut = (rules.batch_cut(len(batch["labels"])) if rules
                   else None)
            rows = {k: cut.take(v) for k, v in batch.items()} if cut \
                else batch
            args = (params, state) if state is not None else (params,)
            (loss, new_state), grads = tree.value_and_grad(
                mod.loss_fn, *args, rows, cfg, rules)
        specs = mod.param_specs(cfg, rules) if rules else None
        if arch == "efficientnet-b7" and specs is not None:
            specs, state_specs = specs
        if rules is not None:
            grads = sharding.sync_grads(grads, specs, rules)
            leaves = [gather(g, s, rules).numpy() for g, s in
                      zip(tree.leaves(grads), tree.leaves(specs))]
        else:
            leaves = [g.numpy() for g in tree.leaves(grads)]
    stats = None
    if arch == "efficientnet-b7":
        mine = [t.detach() for t in tree.leaves(new_state)]
        whole = mine if rules is None else [
            gather(t, s, rules, axes=("model",))
            for t, s in zip(mine, tree.leaves(state_specs))]
        stats = ([t.numpy() for t in mine], [t.numpy() for t in whole])
    return float(loss), leaves, stats


# --------------------------------------------------------------------------
# The ranks (no JAX)
# --------------------------------------------------------------------------

def serve(cfg, params_np, rules, n_slots, requests, device, faulted=False,
          f32=False):
    if f32:
        with float32_compute():
            return serve(cfg, params_np, rules, n_slots, requests, device,
                         faulted)
    params = t_tf.params_from_numpy(params_np, cfg, "cpu", rules=rules,
                                    dtype=t_layers.COMPUTE_DTYPE)
    kw = dict(checkpoint_every=3) if faulted else {}
    server = LMServer(cfg, params, n_slots=n_slots, max_seq=MAX_SEQ,
                      device=device, rules=rules, **kw)
    reqs = [server.submit(p, max_new=m) for p, m in requests]
    if faulted:
        with faults.inject(FaultPlan([FaultSpec("lm.step", "device_fault",
                                                times=4, after=2)])):
            server.drain()
    else:
        server.drain()
    out = ([r.outcome for r in reqs], [r.result for r in reqs], server.pos)
    if faulted:
        out += (server.restores, server.checkpointer.last_bytes)
    return out, tuple(server.cache["k"].shape)


def evacuation(grp) -> dict:
    """lm0 serves one request 3 ticks, then its decode faults past its
    restore: the flight migrates to lm1 and is served
    (``tests/test_torch_replicas.py``'s)."""
    r = grp.submit([1, 2, 3], max_new=8, lane="lm0")
    for _ in range(3):
        grp.serve_tick()
    prefix = list(next(iter(
        grp.lanes["lm0"].server.manager.active.values())).tokens)
    with faults.inject([FaultSpec("lm.step", "device_fault", times=1000,
                                  match={"tenant": "lm0"})]):
        grp.drain()
    return dict(outcome=r.outcome, tokens=[int(t) for t in r.result],
                prefix=prefix, migrations=grp.migrations)


class FakeClock:
    """Monotonic fake clock; ``sleep`` advances it."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def sleep(self, s: float) -> None:
        self.t += max(s, 0.0)


def lanes(cfg, params_np, rules, device):
    params = t_tf.params_from_numpy(params_np, cfg, "cpu", rules=rules)
    grp = LMReplicaGroup(cfg, rules, params, n_slots=2, max_seq=32,
                         n_lanes=2, clock=FakeClock(), device=device,
                         checkpoint_every=1, max_restore_attempts=1)
    return evacuation(grp)


def rank_main(rank, device, inp):
    out = {}
    rules = rules_for_mesh(mesh_lib.make_host_mesh(data=2, model=2,
                                                   device=device))
    cfg = t_configs.get("minitron-8b").smoke
    for n in SLOTS:
        for faulted in (False, True):
            out["server", n, faulted] = serve(cfg, inp["minitron"], rules, n,
                                              inp["requests"], device,
                                              faulted)
        out["server32", n] = serve(cfg, inp["minitron"], rules, n,
                                   inp["requests"], device, f32=True)
    out["lanes"] = lanes(t_tf.LMConfig(**LANE_CFG), inp["lane_params"],
                         rules, device)
    meshes = {"2x2": rules}
    for name, shape in TRAIN_MESHES.items():
        meshes[name] = rules_for_mesh(mesh_lib.make_host_mesh(
            device=device, **shape))
    for kind, mesh in LM_CASES:
        r = meshes[mesh]
        out["rows", kind, mesh] = (r.batch_cut(LM_BATCH),
                                   pipeline(lm_cfg(kind), r).batch_at(0))
        out["lm", kind, mesh] = lm_loss_grads(kind, inp["lm", kind], r)
    for arch in ZOO:
        out["zoo", arch] = zoo_loss_grads(arch, inp["zoo", arch],
                                          inp["zoo_batch", arch],
                                          meshes[ZOO_MESH[arch]])
    res = t_train.main(TRAIN_ARGS + ["--data", "4", "--model", "1"])
    out["train_main"] = (res["losses"], res["steps_run"])
    if rank:           # gradient leaves of rank 0 alone go back
        for key, val in out.items():
            if key[0] in ("lm", "zoo"):
                out[key] = (val[0], None, *val[2:])
    return out


# --------------------------------------------------------------------------
# This process: inputs, the JAX side, one device, the spawn
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(29)
    cfg = t_configs.get("minitron-8b").smoke
    inp = {"minitron": numpy_lm_params(cfg, 3),
           "lane_params": numpy_lm_params(t_tf.LMConfig(**LANE_CFG), 4),
           "requests": [([int(t) for t in rng.integers(1, cfg.vocab, n)], m)
                        for n, m in SERVER_REQUESTS]}
    for i, kind in enumerate(("lm", "moe")):
        inp["lm", kind] = numpy_lm_params(lm_cfg(kind), 10 + i)
    for i, arch in enumerate(ZOO):
        inp["zoo", arch] = numpy_zoo_params(arch, 30 + i)
        inp["zoo_batch", arch] = zoo_batch(arch, 40 + i)
    return inp


@pytest.fixture(scope="module")
def spawned(inputs, tmp_path_factory):
    """The ranks' spawn, started on a thread of this process so that the
    JAX side and the one-device path run while they do."""
    pool = concurrent.futures.ThreadPoolExecutor(1)
    yield pool.submit(mesh_lib.spawn, rank_main, 4, inputs, device="cpu",
                      threads=1, timeout_s=JOIN_S,
                      workdir=str(tmp_path_factory.mktemp("batch-axes")))
    pool.shutdown()


@pytest.fixture(scope="module")
def jax_side(inputs, spawned):
    """The reference on a (1, 1) mesh: ``LMServer`` tokens at each slot
    count (float32 compute), the one-device lane group's evacuation, and
    the dense LM's loss and gradient in float32 compute."""
    import jax
    import jax.numpy as jnp

    from repro.distributed.replicas import LMReplicaGroup as JLMGroup
    from repro.distributed.sharding import rules_for_mesh as j_rules
    from repro.launch.mesh import make_host_mesh as j_mesh
    from repro.models import layers as j_layers
    from repro.models import transformer as j_tf
    from repro.serving import faults as j_faults
    from repro.serving.lm_server import LMServer as JLMServer

    del spawned                # the ranks run meanwhile
    cfg = t_configs.get("minitron-8b").smoke
    jcfg = j_tf.LMConfig(**dataclasses.asdict(cfg))
    mesh = j_mesh(data=1, model=1)
    rules = j_rules(mesh)
    out = {}
    with mesh:
        jp = jax.tree.map(jnp.asarray, inputs["minitron"])
        for n in SLOTS:
            with mock.patch.object(j_layers, "COMPUTE_DTYPE", jnp.float32):
                server = JLMServer(cfg=jcfg, rules=rules, params=jp,
                                   n_slots=n, max_seq=MAX_SEQ)
                reqs = [server.submit(p, max_new=m)
                        for p, m in inputs["requests"]]
                server.drain()
            out["server32", n] = ([r.outcome for r in reqs],
                                  [[int(t) for t in r.result]
                                   for r in reqs])
        lcfg = j_tf.LMConfig(**LANE_CFG)
        grp = JLMGroup(lcfg, rules, jax.tree.map(jnp.asarray,
                                                 inputs["lane_params"]),
                       n_slots=2, max_seq=32, n_lanes=2, clock=FakeClock(),
                       checkpoint_every=1, max_restore_attempts=1)
        r = grp.submit([1, 2, 3], max_new=8, lane="lm0")
        for _ in range(3):
            grp.serve_tick()
        prefix = list(next(iter(
            grp.lanes["lm0"].server.manager.active.values())).tokens)
        with j_faults.inject([j_faults.FaultSpec(
                "lm.step", "device_fault", times=1000,
                match={"tenant": "lm0"})]):
            grp.drain()
        out["lanes"] = dict(outcome=r.outcome,
                            tokens=[int(t) for t in r.result],
                            prefix=[int(t) for t in prefix],
                            migrations=grp.migrations)
        lcfg = j_tf.LMConfig(**LM_SMOKE)
        batch = {k: jnp.asarray(v.numpy())
                 for k, v in pipeline(lm_cfg("lm")).batch_at(0).items()}
        with mock.patch.object(j_layers, "COMPUTE_DTYPE", jnp.float32):
            (loss, _), grads = jax.jit(jax.value_and_grad(
                lambda p, b: j_tf.loss_fn(p, b, lcfg, rules),
                has_aux=True))(jax.tree.map(jnp.asarray,
                                            inputs["lm", "lm"]), batch)
        out["lm"] = (float(loss),
                     [np.asarray(g) for g in jax.tree.leaves(grads)])
    return out


@pytest.fixture(scope="module")
def single(inputs, spawned):
    """The port's one-device path on the same inputs."""
    del spawned
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        out = {}
        cfg = t_configs.get("minitron-8b").smoke
        for n_slots in SLOTS:
            for f32 in (False, True):
                out["server32" if f32 else "server", n_slots] = serve(
                    cfg, inputs["minitron"], None, n_slots,
                    inputs["requests"], "cpu", f32=f32)[0]
        out["lanes"] = lanes(t_tf.LMConfig(**LANE_CFG),
                             inputs["lane_params"], None, "cpu")
        out["lm", "lm"] = lm_loss_grads("lm", inputs["lm", "lm"])
        with patched_moe(4):
            out["lm", "moe"] = lm_loss_grads("moe", inputs["lm", "moe"])
        for arch in ZOO:
            out["zoo", arch] = zoo_loss_grads(arch, inputs["zoo", arch],
                                              inputs["zoo_batch", arch])
        res = t_train.main(TRAIN_ARGS)
        out["train_main"] = (res["losses"], res["steps_run"])
        return out
    finally:
        torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ranks(spawned, jax_side, single):
    del jax_side, single       # computed while the ranks run
    return spawned.result()


# --------------------------------------------------------------------------
# Tests: the LM server and lanes over data ranks
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_slots", SLOTS)
def test_lm_server_on_data_ranks_as_one_device(ranks, single, n_slots):
    """(2, 2): 4 slots are 2 a data rank, 3 stay whole on each; every rank
    decodes its rows and reads every slot's token."""
    cfg = t_configs.get("minitron-8b").smoke
    want = single["server", n_slots]
    assert want[0] == ["served"] * len(SERVER_REQUESTS)
    rows = n_slots // 2 if n_slots % 2 == 0 else n_slots
    for out in ranks:
        got, shape = out["server", n_slots, False]
        assert got == want
        assert shape == (cfg.n_layers, rows, cfg.n_kv_heads, MAX_SEQ // 2,
                         cfg.d_head)


@pytest.mark.parametrize("n_slots", SLOTS)
def test_lm_server_on_data_ranks_as_reference(ranks, single, jax_side,
                                              n_slots):
    """Float32 compute: the sharded server, the one-device server and the
    reference's serve the same tokens."""
    want = jax_side["server32", n_slots]
    assert want[0] == ["served"] * len(SERVER_REQUESTS)
    assert single["server32", n_slots][:2] == want
    for out in ranks:
        assert out["server32", n_slots][0][:2] == want


@pytest.mark.parametrize("n_slots", SLOTS)
def test_lm_server_on_data_ranks_restores_through_a_fault(ranks, n_slots):
    """``checkpoint_every=3`` and the same decode-fault plan on every rank:
    one restore from each rank's rows and chunk of the cut, the unfaulted
    run's tokens.  A cut of 4 slots holds 2 of them on a rank: the last
    snapshot's bytes differ by rank."""
    nbytes = []
    for out in ranks:
        clean, _ = out["server", n_slots, False]
        (outcomes, tokens, pos, restores, last), _ = \
            out["server", n_slots, True]
        assert outcomes == ["served"] * len(SERVER_REQUESTS)
        assert tokens == clean[1] and restores == 1
        nbytes.append(last)
    assert sum(nbytes) > 0


def test_lm_lanes_on_data_ranks_evacuate_as_one_device(ranks, single,
                                                       jax_side):
    one = single["lanes"]
    assert one == jax_side["lanes"]
    assert one["outcome"] == "served" and one["migrations"] == 1
    for out in ranks:
        assert out["lanes"] == one


# --------------------------------------------------------------------------
# Tests: train steps on a batch the batch axes do not divide
# --------------------------------------------------------------------------

@pytest.mark.parametrize("kind,mesh", LM_CASES, ids=["-".join(c)
                                                     for c in LM_CASES])
def test_pipeline_places_the_fallback_rows(ranks, kind, mesh):
    """B 6 on (4, 1): no batch axis divides it, every rank the 6 rows
    (copies 4); on (2, 2, 1) the rows cut over ``data`` alone, whole over
    ``pod`` (copies 2)."""
    whole = pipeline(lm_cfg(kind)).batch_at(0)
    for r, out in enumerate(ranks):
        cut, rows = out["rows", kind, mesh]
        if mesh == "4x1":
            assert (cut.axes, cut.parts, cut.copies) == ((), 1, 4)
            lo, hi = 0, LM_BATCH
        else:
            assert (cut.axes, cut.parts, cut.copies) == (("data",), 2, 2)
            lo = (r % 2) * 3            # rank = 2 * pod + data
            hi = lo + 3
        for k, v in whole.items():
            assert torch.equal(rows[k], v[lo:hi])


@pytest.mark.parametrize("kind,mesh", LM_CASES, ids=["-".join(c)
                                                     for c in LM_CASES])
def test_uneven_lm_batch_as_one_device(ranks, single, kind, mesh):
    loss, leaves = single["lm", kind]
    for out in ranks:
        assert abs(out["lm", kind, mesh][0] - loss) <= LOSS_TOL * abs(loss)
    check_leaves(ranks[0]["lm", kind, mesh][1], leaves, LEAF_TOL)


@pytest.mark.parametrize("mesh", ["4x1", "pod"])
def test_uneven_lm_batch_as_reference(ranks, jax_side, mesh):
    loss, leaves = jax_side["lm"]
    assert abs(ranks[0]["lm", "lm", mesh][0] - loss) <= LOSS_TOL * abs(loss)
    check_leaves(ranks[0]["lm", "lm", mesh][1], leaves, LEAF_TOL)


def test_train_main_takes_an_uneven_batch(ranks, single):
    """``launch.train.main`` with ``--batch 6 --data 4 --model 1`` in the
    ranks against the same entry point on one device."""
    want, steps = single["train_main"]
    assert steps == 2
    for out in ranks:
        got, n = out["train_main"]
        assert n == 2
        assert abs(got[0] - want[0]) <= SINGLE_LOSS_TOL * abs(want[0])
        assert abs(got[1] - want[1]) <= STEP_LOSS_TOL * abs(want[1])


@pytest.mark.parametrize("arch", list(ZOO))
def test_uneven_zoo_batch_as_one_device(ranks, single, arch):
    """ViT, ConvNeXt and EfficientNet at a batch of 3 on (2, 2) (every
    rank the 3 rows); DiT at 2 on (2, 2, 1) (rows over ``data``, whole
    over ``pod``); float32."""
    loss, leaves, _ = single["zoo", arch]
    for out in ranks:
        assert abs(out["zoo", arch][0] - loss) <= LOSS_TOL * abs(loss)
    check_leaves(ranks[0]["zoo", arch][1], leaves, LEAF_TOL, GRAD_FLOOR)


def test_uneven_batch_bn_statistics(ranks, single):
    """EfficientNet's synced BN over the 3 rows every rank holds: the
    running statistics bit for bit equal on every rank of a model
    coordinate, and whole within ``LEAF_TOL`` of one device's."""
    _, _, (want, _) = single["zoo", "efficientnet-b7"]
    stats = [out["zoo", "efficientnet-b7"][2] for out in ranks]
    for r, (mine, whole) in enumerate(stats):
        peer = stats[r ^ 2][0]              # the other data rank, same m
        assert all(np.array_equal(a, b) for a, b in zip(mine, peer))
        check_leaves(whole, want, LEAF_TOL)


# --------------------------------------------------------------------------
# Tests: the image server's switches against the reference
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """(the port's torch_pm1 engine, the reference's xla_pm1 engine) on
    the same params, crossed as numpy."""
    import jax

    from repro.core import bnn_model as j_bnn
    from repro.serving import PhoneBitEngine as JEngine
    from repro_torch.core.bnn_model import BConv, FloatDense, Pool
    from repro_torch.serving import PhoneBitEngine

    def spec(m):
        return [m.BConv(3, 32, kernel=3, stride=1, pad=1, first=True),
                m.Pool(2, 2), m.FloatDense(8 * 8 * 32, 10)]

    port_mod = type("M", (), dict(BConv=BConv, Pool=Pool,
                                  FloatDense=FloatDense))
    jp = j_bnn.init_params(jax.random.key(0), spec(j_bnn))
    port = PhoneBitEngine.from_trained(
        [{k: np.asarray(v) for k, v in p.items()} for p in jp],
        spec(port_mod), (16, 16), matmul_mode="torch_pm1", device="cpu")
    ref = JEngine.from_trained(jp, spec(j_bnn), (16, 16))
    return port, JEngine(spec=ref.spec, packed=ref.packed,
                         input_hw=ref.input_hw, matmul_mode="xla_pm1")


SWITCH_CASES = {
    # A bad payload passes submit and fails when it is served (the port
    # fails its row at staging, the reference its batch at dispatch: a
    # batch failure the reference's ladder would count, so the ladder is
    # off here too); a device fault spends one attempt of a good one.
    "validate_off": (dict(validate=False, degrade=False), [
        dict(site="server.device", kind="device_fault", times=1)]),
    # Every readback faults: each request retried, then error, with no
    # demotion (the default ladder would demote after two).
    "degrade_off": (dict(degrade=False), [
        dict(site="server.device", kind="device_fault", times=1000)]),
}


def _serve_switched(side, engines, case):
    from repro.serving import InferenceServer as JServer
    from repro.serving import faults as j_faults
    from repro_torch.serving import InferenceServer

    kw, specs = SWITCH_CASES[case]
    mod = faults if side == "port" else j_faults
    eng, cls = ((engines[0], InferenceServer) if side == "port"
                else (engines[1], JServer))
    clock = FakeClock()
    server = cls(eng, clock=clock, sleep=clock.sleep, buckets=(1,),
                 max_batch=1, max_wait_s=0.0,
                 retry=mod.RetryPolicy(max_attempts=3, backoff_base_s=0.01,
                                       jitter=0.0), **kw)
    rng = np.random.default_rng(0)
    payloads = [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
                for _ in range(4)]
    if case == "validate_off":
        payloads.insert(1, np.zeros((4, 4, 3), np.uint8))
    plan = mod.FaultPlan([mod.FaultSpec(**s) for s in specs], seed=0,
                         sleep=clock.sleep)
    mod.install(plan)
    try:
        rs = [server.submit(p) for p in payloads]
        server.drain()
    finally:
        mod.uninstall()
    index = {r.id: i for i, r in enumerate(rs)}
    log = [{k: (JAX_MODE.get(v, v) if k == "mode" else
                index[v] if k == "req" else v) for k, v in f.items()}
           for f in plan.log]
    m = server.metrics()
    keep = ("kind", "outcome", "attempts", "from_mode", "to_mode")
    flight = [{k: (JAX_MODE.get(v, v) if k.endswith("mode") else v)
               for k, v in f.items() if k in keep}
              for f in server.flight.dump()]
    return dict(outcomes=[r.outcome for r in rs],
                attempts=[r.attempts for r in rs],
                counters={k: m[k] for k in ("served", "retries", "errors",
                                            "rejected", "degraded")},
                mode=JAX_MODE.get(m["mode"], m["mode"]), log=log,
                clock=clock.t, flight=flight,
                health=server.health is None)


@pytest.mark.parametrize("case", list(SWITCH_CASES))
def test_server_switches_as_reference(engines, case):
    got = _serve_switched("port", engines, case)
    assert got == _serve_switched("jax", engines, case)
    assert got["counters"]["degraded"] == 0
    assert got["health"]
    if case == "validate_off":
        assert got["outcomes"][1] == "error"
        assert got["counters"]["rejected"] == 0
    else:
        assert got["outcomes"] == ["error"] * 4
        assert got["attempts"] == [3] * 4 and got["mode"] == "xla_pm1"
        assert not any(f.get("kind") == "demotion" for f in got["flight"])


def test_multiplexer_lanes_take_the_switches(engines):
    """``MultiTenantServer`` passes the switches to its lanes, as the
    reference's: a lane without a ladder or validation serves beside one
    with both, and its bad payload resolves ``error`` when served."""
    from repro_torch.serving import MultiTenantServer

    clock = FakeClock()
    mux = MultiTenantServer(clock=clock, sleep=clock.sleep, buckets=(1,),
                            max_batch=1, degrade=False, validate=False)
    bare = mux.add_tenant("bare", engines[0])
    full = mux.add_tenant("full", engines[0], degrade=True, validate=True)
    assert bare.health is None and not bare.validate
    assert full.health is not None and full.validate
    bad = np.zeros((4, 4, 3), np.uint8)
    good = np.random.default_rng(1).integers(0, 256, (16, 16, 3),
                                             dtype=np.uint8)
    rs = [mux.submit("bare", bad), mux.submit("bare", good),
          mux.submit("full", bad), mux.submit("full", good)]
    mux.drain()
    assert [r.outcome for r in rs] == ["error", "served", "rejected",
                                      "served"]
    m = mux.metrics()["tenants"]
    assert m["bare"]["mode"] == m["full"]["mode"] == "torch_pm1"
    assert "bucket_health" not in m["bare"] and "bucket_health" in m["full"]
