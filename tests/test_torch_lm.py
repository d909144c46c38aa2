"""Port parity: the dense LM serving path (minitron SMOKE).

The JAX package's ``init_params`` pytree crosses as numpy arrays through
``transformer.params_from_numpy``, so both packages compute with the same
weights; tokens are drawn with numpy.  Compared:

* ``rms_norm`` / ``apply_rope`` (float32 and bf16 inputs);
* ``forward`` logits, ``make_prefill_step``'s last logits and cache, and a
  few ``make_decode_step`` ticks.  Tolerance: a relative max error
  (max |port - jax| / max |jax|) of 2e-2.  Both compute in bf16 but round
  at different points (XLA fuses a bf16 matmul's output rounding and the
  norm's cast differently from PyTorch's eager ops), which the reference's
  own prefill-vs-decode agreement puts at about 1.5% of the logit scale at
  this size; 2e-2 is a few bf16 steps (2^-8 relative each) above that;
* ``KVCacheManager`` against the reference's on one script of admits,
  tokens and releases;
* ``LMServer``'s protocol as ``tests/test_serving.py``'s
  ``test_lm_server_protocol``: served count, ``rejected`` reasons,
  mid-queue deadline shedding under a fake clock, metrics keys;
* the entry points' device rule and the package's import boundary.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as j_configs
from repro.configs import minitron_8b as j_minitron
from repro.distributed.sharding import rules_for_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import layers as j_layers
from repro.models import transformer as j_tf
from repro.serving.kv_cache import KVCacheManager as JKVCacheManager
from repro.serving.lm_server import LMServer as JLMServer
from repro_torch import configs as t_configs
from repro_torch.configs import minitron_8b as t_minitron
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.models import layers as t_layers
from repro_torch.models import transformer as t_tf
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.lm_server import LMServer
from repro_torch.workloads import preprocess as t_pre

RNG = np.random.default_rng(5)
REL_TOL = 2e-2
PROMPT = 32
MAX_SEQ = 48


def rel_err(got: torch.Tensor, want) -> float:
    want = np.asarray(want, np.float32)
    return float(np.abs(got.float().numpy() - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def mesh_rules():
    mesh = make_host_mesh(data=1, model=1)
    return mesh, rules_for_mesh(mesh)


@pytest.fixture(scope="module")
def smoke(mesh_rules):
    """(JAX params, the port's params on the CPU) of minitron SMOKE."""
    mesh, _ = mesh_rules
    with mesh:
        jp = j_tf.init_params(jax.random.key(0), j_minitron.SMOKE)
    tree = jax.tree.map(np.asarray, jp)
    return jp, t_tf.params_from_numpy(tree, t_minitron.SMOKE, "cpu")


# --------------------------------------------------------------------------
# Layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_rms_norm_and_rope(dtype):
    x = RNG.standard_normal((2, 16, 4, 32)).astype(np.float32)
    scale = RNG.uniform(0.5, 1.5, 32).astype(np.float32)
    jx = jnp.asarray(x).astype(dtype)
    tx = torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.float32 if dtype is np.float32 else torch.bfloat16)
    tol = 1e-5 if dtype is np.float32 else 1e-2
    got = t_layers.rms_norm(tx, torch.from_numpy(scale), 1e-5)
    want = j_layers.rms_norm(jx, jnp.asarray(scale), 1e-5)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)
    pos = RNG.integers(0, 4096, (2, 16)).astype(np.int32)
    got = t_layers.apply_rope(tx, torch.from_numpy(pos), 10_000.0)
    want = j_layers.apply_rope(jx, jnp.asarray(pos), 10_000.0)
    assert got.dtype == tx.dtype
    # angles up to 4096 rad: float32 cos/sin of large arguments differ
    # between XLA and PyTorch by a few ulps of the angle
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=max(tol, 1e-3), atol=max(tol, 1e-3))


# --------------------------------------------------------------------------
# Forward, prefill, decode
# --------------------------------------------------------------------------

def test_forward_logits(smoke, mesh_rules):
    jp, tp = smoke
    mesh, rules = mesh_rules
    cfg = j_minitron.SMOKE
    toks = RNG.integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    with mesh:
        want, _ = jax.jit(lambda p, t: j_tf.forward(p, t, cfg, rules))(
            jp, jnp.asarray(toks))
    launches = flash_attention.launches
    got, aux = t_tf.forward(tp, torch.from_numpy(toks), t_minitron.SMOKE)
    assert flash_attention.launches == launches      # CPU: plain version
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    assert float(aux) == 0.0
    assert rel_err(got, want) <= REL_TOL


def test_prefill_then_decode(smoke, mesh_rules):
    jp, tp = smoke
    mesh, rules = mesh_rules
    cfg = j_minitron.SMOKE
    toks = RNG.integers(0, cfg.vocab, (2, PROMPT)).astype(np.int32)
    with mesh:
        j_logits, j_cache = jax.jit(j_tf.make_prefill_step(
            cfg, rules, MAX_SEQ))(jp, jnp.asarray(toks))
        j_decode = jax.jit(j_tf.make_decode_step(cfg, rules, MAX_SEQ))
    logits, cache = t_tf.make_prefill_step(t_minitron.SMOKE, MAX_SEQ)(
        tp, torch.from_numpy(toks))
    assert tuple(cache["k"].shape) == j_cache["k"].shape
    assert rel_err(logits, j_logits) <= REL_TOL
    for name in ("k", "v"):
        assert rel_err(cache[name], j_cache[name]) <= REL_TOL
        assert not cache[name][:, :, :, PROMPT:].any()
    decode = t_tf.make_decode_step(t_minitron.SMOKE, MAX_SEQ)
    for pos in range(PROMPT, PROMPT + 3):
        tok = RNG.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        with mesh:
            j_logits, j_cache = j_decode(jp, j_cache, jnp.asarray(tok),
                                         jnp.int32(pos))
        logits, cache = decode(tp, cache, torch.from_numpy(tok), pos)
        assert rel_err(logits, j_logits) <= REL_TOL
        for name in ("k", "v"):
            assert rel_err(cache[name], j_cache[name]) <= REL_TOL
    with pytest.raises(ValueError, match="outside"):
        decode(tp, cache, torch.from_numpy(tok), MAX_SEQ)


@pytest.mark.parametrize("positions", [(0, 1, 2), (PROMPT, PROMPT + 5,
                                                MAX_SEQ - 1)])
def test_decode_step_with_a_device_position(smoke, mesh_rules, positions):
    """``pos`` as a 0-dim int64 tensor (the captured step's form, its K/V
    row written by ``index_copy_``) gives the int form's logits and cache
    bit for bit, and the reference's within ``REL_TOL``, at positions from
    the cache's start to its last row."""
    jp, tp = smoke
    mesh, rules = mesh_rules
    cfg = j_minitron.SMOKE
    with mesh:
        j_decode = jax.jit(j_tf.make_decode_step(cfg, rules, MAX_SEQ))
    decode = t_tf.make_decode_step(t_minitron.SMOKE, MAX_SEQ)
    j_cache = j_tf.init_cache(cfg, 2, MAX_SEQ)
    by_int = t_tf.init_cache(t_minitron.SMOKE, 2, MAX_SEQ, "cpu")
    by_tensor = t_tf.init_cache(t_minitron.SMOKE, 2, MAX_SEQ, "cpu")
    for pos in positions:
        tok = RNG.integers(0, cfg.vocab, (2, 1)).astype(np.int32)
        want, _ = decode(tp, by_int, torch.from_numpy(tok), pos)
        got, _ = decode(tp, by_tensor, torch.from_numpy(tok),
                        torch.tensor(pos, dtype=torch.int64))
        assert torch.equal(got, want)
        for name in ("k", "v"):
            assert torch.equal(by_tensor[name], by_int[name])
        with mesh:
            j_logits, j_cache = j_decode(jp, j_cache, jnp.asarray(tok),
                                         jnp.int32(pos))
        assert rel_err(got, j_logits) <= REL_TOL
        for name in ("k", "v"):
            assert rel_err(by_tensor[name], j_cache[name]) <= REL_TOL


# --------------------------------------------------------------------------
# KV cache manager and the server
# --------------------------------------------------------------------------

def test_kv_cache_manager_as_reference():
    port, ref = KVCacheManager(3, 16), JKVCacheManager(3, 16)
    script = [("admit", 4, 3), ("admit", 2, 2), ("token", 0, 7),
              ("token", 1, 9), ("admit", 5, 1), ("token", 1, 2),
              ("admit", 3, 13), ("token", 2, 0), ("release", 3, None),
              ("admit", 8, 8)]
    for op, a, b in script:
        if op == "admit":
            s, r = port.admit(a, b), ref.admit(a, b)
            assert (s.seq_id, s.slot) == (r.seq_id, r.slot)
        elif op == "token":
            assert port.record_token(a, b, eos_id=0) == \
                ref.record_token(a, b, eos_id=0)
        else:
            port.release(a)
            ref.release(a)
        assert sorted(port.active) == sorted(ref.active)
        assert port.active_slots() == ref.active_slots()
        assert port.utilization == ref.utilization
        assert port.can_admit() == ref.can_admit()
    with pytest.raises(ValueError, match="too long"):
        port.admit(10, 7)


PROTO_CFG = dict(name="proto-demo", n_layers=1, d_model=64, n_heads=2,
                 n_kv_heads=1, d_head=32, d_ff=128, vocab=128,
                 tie_embeddings=True)


@pytest.fixture(scope="module")
def proto(mesh_rules):
    mesh, rules = mesh_rules
    jcfg = j_tf.LMConfig(**PROTO_CFG)
    with mesh:
        jp = j_tf.init_params(jax.random.key(0), jcfg, ep=1)
    tcfg = t_tf.LMConfig(**PROTO_CFG)
    tp = t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    return jcfg, jp, tcfg, tp


def serve_both(proto, mesh_rules, requests, n_slots, max_seq):
    """Serve ``requests`` ((prompt, max_new) pairs, all submitted before
    the first tick) through the port's and the reference's LMServer on the
    same weights.  Returns (port server, port requests, reference server,
    reference requests), after checking every decode call's logits
    against the reference's: the same positions, and the logits within
    ``REL_TOL`` (relative max error)."""
    jcfg, jp, cfg, params = proto
    mesh, rules = mesh_rules
    server = LMServer(cfg, params, n_slots=n_slots, max_seq=max_seq,
                      device="cpu")
    with mesh:
        ref = JLMServer(cfg=jcfg, rules=rules, params=jp, n_slots=n_slots,
                        max_seq=max_seq)
    calls = {"port": [], "ref": []}

    def recorder(decode, log):
        def call(params, cache, toks, pos):
            logits, cache = decode(params, cache, toks, pos)
            if torch.is_tensor(logits):
                logits = logits.float()
            log.append((int(pos), np.asarray(toks).ravel().tolist(),
                        np.asarray(logits, np.float32)))
            return logits, cache
        return call

    server._decode = recorder(server._decode, calls["port"])
    ref._decode = recorder(ref._decode, calls["ref"])
    reqs = [server.submit(p, max_new=m) for p, m in requests]
    server.drain()
    with mesh:
        ref_reqs = [ref.submit(p, max_new=m) for p, m in requests]
        ref.drain()
    assert len(calls["port"]) == len(calls["ref"]) > 0
    for (pos, toks, got), (rpos, rtoks, want) in zip(calls["port"],
                                                    calls["ref"]):
        assert (pos, toks) == (rpos, rtoks)
        assert np.abs(got - want).max() <= REL_TOL * np.abs(want).max()
    return server, reqs, ref, ref_reqs


def test_lm_server_protocol(proto, mesh_rules):
    _, _, cfg, params = proto
    rng = np.random.default_rng(0)
    prompts = [list(rng.integers(1, cfg.vocab, 4)) for _ in range(3)]
    server, reqs, ref, ref_reqs = serve_both(
        proto, mesh_rules, [(p, 3) for p in prompts], n_slots=2,
        max_seq=32)
    assert all(r.done for r in reqs)
    assert all(r.outcome == "served" and 1 <= len(r.result) <= 3
               for r in reqs)
    m = server.metrics()
    assert m["served"] == 3 and m["dropped"] == 0
    assert m["queue_depth"] == 0 and m["p50_ms"] is not None
    # the reference serves the same requests to the same tokens
    assert [r.outcome for r in ref_reqs] == ["served"] * 3
    assert [r.result for r in reqs] == [r.result for r in ref_reqs]
    ref_m = ref.metrics()
    assert set(ref_m) == set(m)
    # invalid requests resolve ``rejected`` at the protocol edge
    bad = server.submit(list(range(1, 31)), max_new=8)
    assert bad.done and bad.outcome == "rejected" and "max_seq" in bad.error
    bad = server.submit([])
    assert bad.done and bad.outcome == "rejected" and "empty" in bad.error
    bad = server.submit([1, 2.5])
    assert bad.outcome == "rejected" and "ints" in bad.error
    assert server.metrics()["rejected"] == 3
    assert server.queue_depth == 0       # rejects never enqueue
    full = LMServer(cfg, params, n_slots=1, max_seq=32, max_queue=1,
                    device="cpu")
    assert full.submit([1]).outcome is None
    bad = full.submit([2])
    assert bad.outcome == "rejected" and "queue full" in bad.error

    # deadline shedding at admission, mid-queue behind a patient request
    # while the one KV slot is busy
    server = LMServer(cfg, params, n_slots=1, max_seq=32,
                      clock=lambda: 100.0, device="cpu")
    patient1 = server.submit([1, 2], max_new=1, now=0.0)    # admitted
    patient2 = server.submit([3, 4], max_new=1, now=0.0)    # queued
    hasty = server.submit([5], max_new=1, deadline_s=1.0, now=0.0)
    server.drain()
    assert hasty.done and hasty.outcome == "shed" and hasty.result is None
    assert patient1.result and patient2.result
    m = server.metrics()
    assert m["dropped"] == 1 and m["served"] == 2


@pytest.mark.parametrize("n_slots,requests", [
    # two slots, four requests: the third and fourth join while the
    # first or second is still decoding
    (2, [(4, 2), (5, 5), (3, 4), (6, 3)]),
    # three slots, five requests of one to six new tokens
    (3, [(2, 1), (4, 6), (3, 2), (5, 3), (2, 4)]),
])
def test_lm_server_tokens_as_reference(proto, mesh_rules, n_slots,
                                       requests):
    """Continuous batching with requests joining mid-batch: every decode
    call and every generated token as the reference's."""
    _, _, cfg, _ = proto
    rng = np.random.default_rng(n_slots)
    reqs = [(list(rng.integers(1, cfg.vocab, n)), m) for n, m in requests]
    server, got, ref, want = serve_both(proto, mesh_rules, reqs, n_slots,
                                        max_seq=64)
    assert [r.outcome for r in got] == ["served"] * len(reqs)
    assert [r.result for r in got] == [r.result for r in want]
    assert [len(r.result) for r in got] == [m for _, m in requests]
    assert server.pos == ref.pos
    assert server.metrics()["served"] == len(reqs)


def test_lm_server_generate_and_bounded_drain(proto):
    _, _, cfg, params = proto
    server = LMServer(cfg, params, n_slots=2, max_seq=32, device="cpu")
    out = server.generate([3, 1, 4], max_new=5)
    assert len(out) == 5 and all(0 <= t < cfg.vocab for t in out)
    assert server.pos == 3 + 5 and not server.manager.active
    wedged = LMServer(cfg, params, n_slots=1, max_seq=32, device="cpu")
    reqs = [wedged.submit([1, 2], max_new=4) for _ in range(2)]
    done = wedged.drain(max_steps=1)
    assert len(done) == 2 and all(r.outcome == "error" for r in reqs)
    assert wedged.metrics()["errors"] == 2 and wedged.queue_depth == 0


def test_lm_server_outlives_max_seq(smoke):
    """Four requests of 4 + 4 tokens through 2 slots of max_seq 16: the
    one global position would pass max_seq, so the later requests wait
    for the slots to empty and start again at position 0.  All are served,
    no slot stays taken, every decode position stays below max_seq, and
    the requests admitted after the reset get the tokens a fresh server
    gives the same prompts."""
    _, params = smoke
    server = LMServer(t_minitron.SMOKE, params, n_slots=2, max_seq=16,
                      device="cpu")
    positions = []
    decode = server._decode

    def record(params, cache, toks, pos):
        positions.append(pos)
        return decode(params, cache, toks, pos)
    server._decode = record
    rng = np.random.default_rng(16)
    reqs = [server.submit(list(rng.integers(1, t_minitron.SMOKE.vocab, 4)),
                          max_new=4) for _ in range(4)]
    server.drain()
    assert [r.outcome for r in reqs] == ["served"] * 4
    assert [len(r.result) for r in reqs] == [4] * 4
    assert not server.manager.active and server.manager.utilization == 0
    assert server.queue_depth == 0 and server.metrics()["served"] == 4
    assert max(positions) < 16 and positions.count(0) == 2
    fresh = LMServer(t_minitron.SMOKE, params, n_slots=2, max_seq=16,
                     device="cpu")
    again = [fresh.submit(r.payload[0], max_new=4) for r in reqs[2:]]
    fresh.drain()
    assert [r.result for r in reqs[2:]] == [r.result for r in again]
    assert [r.outcome for r in again] == ["served"] * 2


def test_lm_server_fault_frees_slots(smoke):
    """With no retry and no checkpoints, a decode fault resolves the
    in-flight requests ``error`` and frees their slots; the server goes on
    and serves the queue."""
    _, params = smoke
    server = LMServer(t_minitron.SMOKE, params, n_slots=2, max_seq=32,
                      device="cpu", retry=None)
    decode, calls = server._decode, []

    def faulty(params, cache, toks, pos):
        calls.append(pos)
        if len(calls) == 5:
            raise RuntimeError("injected device fault")
        return decode(params, cache, toks, pos)
    server._decode = faulty
    reqs = [server.submit([1, 2], max_new=3) for _ in range(3)]
    done = server.drain()
    assert sorted(r.id for r in done) == sorted(r.id for r in reqs)
    assert [r.outcome for r in reqs] == ["error", "error", "served"]
    assert "injected device fault" in reqs[0].error
    assert len(reqs[2].result) == 3
    assert not server.manager.active and server.queue_depth == 0
    m = server.metrics()
    assert m["errors"] == 2 and m["served"] == 1


# --------------------------------------------------------------------------
# Configs, entry points and the import boundary
# --------------------------------------------------------------------------

def test_configs_as_reference():
    """The four LM archs' FULL and SMOKE equal the reference's field by
    field, with the same parameter counts (total, padded for 16-way
    expert parallelism, active); the registry holds the reference's ten
    archs (the zoo's are held in ``tests/test_torch_vision.py``) and
    refuses others."""
    rec = t_configs.get("minitron-8b")
    assert rec.full is t_minitron.FULL and rec.family == "lm"
    assert t_configs.ARCH_IDS == j_configs.ARCH_IDS
    lm_archs = [a for a in t_configs.ARCH_IDS
                if t_configs.get(a).family == "lm"]
    assert lm_archs == [a for a in j_configs.ARCH_IDS
                        if j_configs.get(a).family == "lm"]
    assert len(lm_archs) == 4
    for arch in lm_archs:
        port, ref = t_configs.get(arch), j_configs.get(arch)
        assert port.family == ref.family == "lm"
        for p, r in ((port.full, ref.full), (port.smoke, ref.smoke)):
            assert vars(p) == vars(r)
            assert p.param_count() == r.param_count()
            assert p.param_count(ep=16) == r.param_count(ep=16)
            assert p.active_param_count() == r.active_param_count()
            assert p.padded_experts(16) == r.padded_experts(16)
    assert t_minitron.FULL.param_count() == 7_734_562_816
    full = {a: t_configs.get(a).full for a in lm_archs}
    assert full["granite-moe-3b-a800m"].padded_experts(16) == 48
    assert round(full["qwen3-moe-30b-a3b"].param_count() / 1e9, 2) == 30.53
    assert round(full["qwen3-moe-30b-a3b"].active_param_count() / 1e9,
                 2) == 3.35
    assert round(full["command-r-35b"].param_count() / 1e9, 2) == 30.28
    with pytest.raises(KeyError, match="unknown arch"):
        t_configs.get("vit-b16")
    assert t_tf.padded_vocab(49155, 16) == j_tf.padded_vocab(49155, 16)


def test_init_params_shapes_and_pad_mask(mesh_rules):
    cfg = t_minitron.SMOKE
    mesh, rules = mesh_rules
    got = t_tf.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    with mesh:
        ref = j_tf.init_params(jax.random.key(1), j_minitron.SMOKE)
    shapes = jax.tree.map(lambda a: tuple(a.shape), ref)
    assert jax.tree.map(lambda t: tuple(t.shape), got) == shapes
    assert got["layers"]["wq"].dtype == torch.bfloat16
    assert got["layers"]["ln1"].dtype == torch.float32
    # matrices N(0, 1/fan_in), embedding N(0, 0.02^2)
    assert abs(got["layers"]["w_up"].float().std().item()
               - cfg.d_model ** -0.5) < 0.01
    assert abs(got["embed"].float().std().item() - 0.02) < 0.002
    # a vocab padded on the reference's side is masked in the port's logits
    with mesh:
        padded = j_tf.init_params(jax.random.key(1), j_minitron.SMOKE,
                                  vocab_pad_to=96)
        want, _ = j_tf.forward(padded, jnp.zeros((1, 4), jnp.int32),
                               j_minitron.SMOKE, rules)
    port = t_tf.params_from_numpy(jax.tree.map(np.asarray, padded), cfg,
                                  "cpu")
    logits, _ = t_tf.forward(port, torch.zeros((1, 4), dtype=torch.int64),
                             cfg)
    assert logits.shape[-1] == 288 == want.shape[-1]
    assert (logits[..., cfg.vocab:] == -1e30).all()
    assert rel_err(logits[..., :cfg.vocab], want[..., :cfg.vocab]) \
        <= REL_TOL


def test_entry_points_need_a_card(monkeypatch, proto):
    """Entry points default to the card and raise without one."""
    _, jp, cfg, params = proto
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = jax.tree.map(np.asarray, jp)
    for call in (lambda: t_tf.init_params(cfg, torch.Generator()),
                 lambda: t_tf.params_from_numpy(tree, cfg),
                 lambda: t_tf.init_cache(cfg, 1, 8),
                 lambda: LMServer(cfg, params, n_slots=1, max_seq=8),
                 lambda: t_pre.as_server_hook(lambda x: x)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    assert LMServer(cfg, params, n_slots=1, max_seq=8,
                    device="cpu").device.type == "cpu"


def test_capture_needs_a_card(smoke):
    """``capture=None`` is off on the CPU; ``capture=True`` there is a
    ValueError (a CUDA graph needs the card)."""
    _, params = smoke
    server = LMServer(t_minitron.SMOKE, params, n_slots=1, max_seq=8,
                      device="cpu")
    assert server.capture is False and server.capture_count == 0
    with pytest.raises(ValueError, match="capture=True needs a CUDA"):
        LMServer(t_minitron.SMOKE, params, n_slots=1, max_seq=8,
                 device="cpu", capture=True)


def test_lm_modules_import_no_jax():
    """A fresh interpreter that imports the LM path loads neither jax nor
    the reference package."""
    code = ("import sys\n"
            "import repro_torch.configs, repro_torch.serving.lm_server\n"
            "import repro_torch.kernels.flash_attention\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.')]\n"
            "assert not bad, bad\n")
    env_path = [p for p in sys.path if p]
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env={"PYTHONPATH": ":".join(env_path),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
