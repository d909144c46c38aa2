"""Port parity: crash safety (``repro_torch.serving.recovery``) against the
reference's (``tests/test_recovery.py``, ``tests/test_resilience.py``).

* **Request journal** — submit / resolve / scan, ``jid`` continuing across
  reopens, a torn tail, the payload codecs, and lines written by either
  package read by the other's scan and codecs; on a server the journal
  closes every record, a rejected submit is not journaled, and
  ``replay_journal`` resubmits what is open (closing the original record,
  skipping the other kind).
* **kill -9** — a subprocess that imports ``repro_torch`` alone serves
  tiny AlexNet from an artifact with a journal on the CPU and is sent
  SIGKILL mid-stream; a fresh process replays every unresolved request
  and serves it, building nothing.
* **KV checkpoint and restore** on minitron SMOKE weights (the JAX
  package's ``init_params`` carried as numpy): a decode fault that spends
  the retries restores the last cut, and the tokens equal an unfaulted
  run's, with ``checkpoint_every`` in {1, 3, 8} and with two sequences; a
  cut is a copy (the cache the step writes in place moves on, the cut
  does not); a cadence snapshot fault keeps the cut, an admission one
  drops it, a restore fault burns one attempt; spent attempts or
  recovery off end ``error``; an ``evacuate`` hook written here hands the
  sequence to a second ``LMServer`` with its prefix kept, and one that
  does not fit is refused (``error``); a restart drops the cut.
* **LM parity** — the port's and the reference's ``LMServer`` under one
  ``lm.step`` plan (a tick that retries then errors, a transient fault, a
  restore) give the same outcomes, counters and tokens.
"""

import json
import os
import pathlib
import signal
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from repro.configs import minitron_8b as j_minitron
from repro.distributed.sharding import rules_for_mesh
from repro.launch.mesh import make_host_mesh
from repro.models import transformer as j_tf
from repro.serving import faults as j_faults
from repro.serving import recovery as j_recovery
from repro.serving.kv_cache import KVCacheManager as JKVCacheManager
from repro.serving.lm_server import LMServer as JLMServer
from repro_torch import workloads
from repro_torch.configs import minitron_8b as t_minitron
from repro_torch.models import transformer as t_tf
from repro_torch.serving import faults
from repro_torch.serving.faults import FaultPlan, FaultSpec
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.lm_server import LMServer
from repro_torch.serving.recovery import (RequestJournal, decode_payload,
                                          encode_payload, replay_journal)

REPO = pathlib.Path(__file__).resolve().parent.parent
CFG = t_minitron.SMOKE


@pytest.fixture(autouse=True)
def _no_leftover_plan():
    yield
    faults.uninstall()
    j_faults.uninstall()

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """The tiny shapes here run several times faster on one intra-op
    thread than on a pool the suite's parallel workers all share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
    return jp, t_tf.params_from_numpy(jax.tree.map(np.asarray, jp), CFG,
                                      "cpu")


@pytest.fixture(scope="module")
def tiny():
    return workloads.get("alexnet_imagenet", variant="tiny", device="cpu",
                         matmul_mode="torch")


def _images(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (16, 16, 3), dtype=np.uint8)
            for _ in range(n)]


# --------------------------------------------------------------------------
# Request journal
# --------------------------------------------------------------------------

def test_journal_submit_resolve_scan_and_reopen(tmp_path):
    path = tmp_path / "j.jsonl"
    j = RequestJournal(path)
    a = j.submit("lm", ([1, 2, 3], 4))
    b = j.submit("lm", ([5], 2))
    j.resolve(a, "served")
    j.close()
    state = RequestJournal.scan(path)
    assert list(state.unresolved) == [b] and state.max_jid == b == 1
    assert not state.torn_tail and len(state.records) == 3
    j = RequestJournal(path)                  # ids go on past the disk's
    assert j.submit("lm", ([7], 1)) == 2
    j.close()
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"op":"resolve","jid":')      # a kill mid-append
    state = RequestJournal.scan(path)
    assert state.torn_tail and sorted(state.unresolved) == [1, 2]
    assert RequestJournal.scan(tmp_path / "none.jsonl").records == []
    img = _images(1)[0]
    np.testing.assert_array_equal(
        decode_payload("bnn", encode_payload("bnn", img)), img)
    assert decode_payload("lm", encode_payload("lm", ([1, 2], 3))) \
        == ([1, 2], 3)
    with pytest.raises(ValueError, match="kind"):
        encode_payload("nope", img)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_journal_lines_read_across_packages(tmp_path, writer):
    """A journal written by one package is read by the other's scan and
    codecs: the same records, unresolved set and payloads."""
    mods = {"port": (RequestJournal, encode_payload, decode_payload),
            "jax": (j_recovery.RequestJournal, j_recovery.encode_payload,
                    j_recovery.decode_payload)}
    reader = "jax" if writer == "port" else "port"
    w_cls, w_enc, _ = mods[writer]
    r_cls, r_enc, r_dec = mods[reader]
    path = tmp_path / "j.jsonl"
    img = _images(1, seed=4)[0]
    j = w_cls(path)
    ids = [j.submit("bnn", img), j.submit("lm", ([3, 1, 4], 5)),
           j.submit("bnn", img[:8])]
    j.resolve(ids[0], "served")
    j.resolve(ids[2], "error", error="DeviceFault: injected")
    j.close()
    got, want = r_cls.scan(path), mods[writer][0].scan(path)
    assert got.records == want.records and got.max_jid == want.max_jid
    assert list(got.unresolved) == [ids[1]]
    rec = got.unresolved[ids[1]]
    assert r_dec(rec["kind"], rec["payload"]) == ([3, 1, 4], 5)
    first = got.records[0]
    np.testing.assert_array_equal(r_dec("bnn", first["payload"]), img)
    assert r_enc("bnn", img) == w_enc("bnn", img)
    # the reader appends to the writer's file and continues its ids
    j = r_cls(path)
    assert j.submit("lm", ([9], 1)) == ids[-1] + 1
    j.close()


def test_journal_on_the_server(tiny, tmp_path):
    """WAL order on an InferenceServer: every served request closes its
    record, a rejected submit leaves none, a replay resubmits only the
    open ``bnn`` records and closes the originals."""
    path = tmp_path / "j.jsonl"
    j = RequestJournal(path)
    server = tiny.server(preprocess=None, buckets=(1, 2), max_batch=2,
                         journal=j)
    rs = [server.submit(p) for p in _images(3)]
    bad = server.submit(np.zeros((4, 4, 3), np.uint8))
    server.drain()
    assert [r.outcome for r in rs] == ["served"] * 3
    assert bad.outcome == "rejected" and bad.jid is None
    state = RequestJournal.scan(path)
    assert not state.unresolved
    assert sum(r["op"] == "submit" for r in state.records) == 3
    # open records from a "crashed" process: one of each kind
    img = _images(1, seed=9)[0]
    lm_jid = j.submit("lm", ([1, 2], 4))
    bnn_jid = j.submit("bnn", img)
    j.close()
    server = tiny.server(preprocess=None, buckets=(1, 2), max_batch=2,
                         journal=RequestJournal(path))
    replayed = replay_journal(server, path)
    server.drain()
    server.journal.close()
    assert len(replayed) == 1 and replayed[0].jid == bnn_jid
    assert replayed[0].outcome == "served"
    np.testing.assert_array_equal(replayed[0].payload, img)
    state = RequestJournal.scan(path)
    assert list(state.unresolved) == [lm_jid]
    assert sum(r["op"] == "submit" for r in state.records) == 5


def test_kill9_journal_replay_recovers_all(tiny, tmp_path):
    """A serving process is SIGKILLed mid-stream; a fresh process boots
    from the same artifact and journal, replays every journaled but
    unresolved request and serves each (rows equal to the exporter's),
    building nothing; neither process imports jax or the reference."""
    art, jpath = tmp_path / "art", tmp_path / "j.jsonl"
    tiny.engine.export_artifact(art, buckets=(1, 2), workload=tiny.name)
    prelude = textwrap.dedent("""
        import json, os, sys
        os.environ["REPRO_AUTOTUNE_CACHE"] = "0"
        sys.path.insert(0, {src!r})
        import numpy as np
        from repro_torch import workloads
        from repro_torch.serving.recovery import (RequestJournal,
                                                  replay_journal)
        wl = workloads.get("alexnet_imagenet", variant="tiny",
                           device="cpu", matmul_mode="torch")
        server = wl.server(preprocess=None, artifact={art!r},
                           buckets=(1, 2), max_batch=2,
                           journal=RequestJournal({jpath!r}))
        foreign = [m for m in sys.modules
                   if m.split(".")[0] in ("jax", "repro")]
    """).format(src=str(REPO / "src"), art=str(art), jpath=str(jpath))
    kill = prelude + textwrap.dedent("""
        import signal
        assert not foreign, foreign
        rng = np.random.default_rng(3)
        for _ in range(8):
            server.submit(rng.integers(0, 256, (16, 16, 3),
                                       dtype=np.uint8))
        for _ in range(2):             # resolve a prefix, not the tail
            server.step(force=True)
        os.kill(os.getpid(), signal.SIGKILL)
    """)
    env = dict(os.environ, OMP_NUM_THREADS="1")
    p1 = subprocess.run([sys.executable, "-c", kill], capture_output=True,
                        text=True, timeout=300, env=env)
    assert p1.returncode == -signal.SIGKILL, p1.stderr[-3000:]
    pre = RequestJournal.scan(jpath)
    assert 0 < len(pre.unresolved) < 8
    recover = prelude + textwrap.dedent("""
        builds = wl.engine.build_count
        rs = replay_journal(server, {jpath!r})
        server.drain()
        post = RequestJournal.scan({jpath!r})
        np.save({out!r}, np.stack([r.result for r in rs]))
        print(json.dumps({{
            "jids": [r.jid for r in rs],
            "served": sum(r.outcome == "served" for r in rs),
            "unresolved_after": len(post.unresolved),
            "built": wl.engine.build_count - builds,
            "loaded": server.artifact_report["loaded"],
            "foreign": foreign}}))
    """).format(jpath=str(jpath), out=str(tmp_path / "rows.npy"))
    p2 = subprocess.run([sys.executable, "-c", recover],
                        capture_output=True, text=True, timeout=300,
                        env=env)
    assert p2.returncode == 0, p2.stderr[-3000:]
    rec = json.loads(p2.stdout.strip().splitlines()[-1])
    assert rec["jids"] == sorted(pre.unresolved)
    assert rec["served"] == len(pre.unresolved)
    assert rec["unresolved_after"] == 0 and rec["built"] == 0
    assert rec["loaded"] == [1, 2] and rec["foreign"] == []
    imgs = np.stack([decode_payload("bnn", pre.unresolved[j]["payload"])
                     for j in rec["jids"]])
    want = np.concatenate([tiny.engine(torch.from_numpy(imgs[i:i + 1]))
                           .numpy() for i in range(len(imgs))])
    np.testing.assert_array_equal(np.load(tmp_path / "rows.npy"), want)


def test_lm_journal_replay(smoke, tmp_path):
    """An LMServer journals its submits and outcomes; a replay resubmits
    an open ``lm`` record under its original ``jid`` and closes it."""
    path = tmp_path / "j.jsonl"
    j = RequestJournal(path)
    s = _lm(smoke, journal=j)
    r = s.submit([1, 2, 3], max_new=3)
    bad = s.submit([])
    s.drain()
    assert r.outcome == "served" and bad.outcome == "rejected"
    jid = j.submit("lm", ([4, 5], 2))                   # left open
    j.close()
    s = _lm(smoke, journal=RequestJournal(path))
    (again,) = replay_journal(s, path)
    s.drain()
    s.journal.close()
    assert again.jid == jid and again.outcome == "served"
    assert len(again.result) == 2
    state = RequestJournal.scan(path)
    assert not state.unresolved
    assert sum(rec["op"] == "submit" for rec in state.records) == 2


def test_kv_adopt_as_reference():
    """``KVCacheManager.adopt`` on one script of admits, adoptions and
    releases: the same sequence ids, slots and bookkeeping as the
    reference's, and the same refusals."""
    port, ref = KVCacheManager(3, 16), JKVCacheManager(3, 16)
    script = [("admit", (4, 3)), ("adopt", (6, 8, 2, [7, 9])),
              ("release", 0), ("adopt", (5, 4, 1, [3])),
              ("admit", (2, 2))]
    for op, args in script:
        if op == "release":
            port.release(args)
            ref.release(args)
            continue
        a = getattr(port, op)(*args, prompt=[1, 2])
        b = getattr(ref, op)(*args, prompt=[1, 2])
        assert vars(a) == vars(b)
        assert port.active_slots() == ref.active_slots()
    with pytest.raises(RuntimeError, match="no free"):
        port.adopt(2, 4, 1, [1])
    port.release(1)
    with pytest.raises(ValueError, match="too long"):
        port.adopt(15, 8, 2, [1, 2])
    with pytest.raises(ValueError, match="tokens"):
        port.adopt(4, 8, 2, [1])


# --------------------------------------------------------------------------
# KV checkpoint / restore
# --------------------------------------------------------------------------

def _lm(smoke, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_seq", 48)
    return LMServer(CFG, smoke[1], device="cpu", **kw)


def _served(server, prompts, plan=None):
    reqs = [server.submit(p, max_new=m) for p, m in prompts]
    if plan is None:
        server.drain()
    else:
        with faults.inject(plan):
            server.drain()
    return reqs


ONE = [([1, 2, 3], 12)]
TWO = [([1, 2, 3], 10), ([4, 5], 10)]


@pytest.mark.parametrize("every,after,prompts", [
    (1, 2, ONE), (3, 4, ONE), (8, 6, ONE), (2, 1, TWO), (3, 5, TWO)])
def test_restore_is_bit_exact(smoke, every, after, prompts):
    """A decode fault that spends the retry budget restores the last cut
    and replays the ticks since it (``after`` clean ticks past the
    admission cut, cut again every ``every``): the tokens equal an
    unfaulted run's."""
    base = _served(_lm(smoke), prompts)
    s = _lm(smoke, checkpoint_every=every)
    plan = FaultPlan([FaultSpec("lm.step", "device_fault", times=4,
                                after=after)])
    reqs = _served(s, prompts, plan)
    assert [r.outcome for r in reqs] == ["served"] * len(prompts)
    assert [r.result for r in reqs] == [r.result for r in base]
    rec = s.metrics()["recovery"]
    assert rec["restores"] == s.restores == 1
    assert rec["checkpoint_every"] == every and rec["taken"] >= 2
    restored = [f for f in s.flight.dump()
                if f.get("outcome") == "restored"]
    assert len(restored) == 1
    assert restored[0]["replayed"] == after % every
    assert s.metrics()["retries"] == 3      # 2 before the restore, 1 after


def test_a_cut_is_a_copy(smoke):
    """The step writes K/V in place: the live slot moves on with every
    tick, the cut taken before those ticks does not."""
    s = _lm(smoke, checkpoint_every=100)
    s.submit([1, 2, 3], max_new=10)
    s.serve_tick()                            # admission cut + 1 tick
    ck = s.checkpointer.set
    (seq_id, c), = ck.seqs.items()
    k0, v0 = (t.clone() for t in c.materialize())
    for _ in range(4):
        s.serve_tick()
    k1, v1 = c.materialize()
    assert torch.equal(k1, k0) and torch.equal(v1, v0)
    assert not torch.equal(s.cache["k"][:, c.slot], k0)
    assert s.checkpointer.last_bytes == 2 * k0.numel() * k0.element_size()


def test_snapshot_fault_policy(smoke):
    # a cadence snapshot fault keeps the previous cut
    s = _lm(smoke, checkpoint_every=1)
    r = s.submit([1, 2, 3], max_new=6)
    s.serve_tick()
    good = s.checkpointer.set
    with faults.inject([FaultSpec("kv.snapshot", "device_fault", times=1,
                                  match={"reason": "cadence"})]):
        s.serve_tick()
    assert s.checkpointer.set is good and s.checkpointer.failed == 1
    s.drain()
    assert r.outcome == "served"
    # an admission snapshot fault drops it
    s = _lm(smoke, checkpoint_every=4)
    with faults.inject([FaultSpec("kv.snapshot", "device_fault", times=1,
                                  match={"reason": "admission"})]):
        r = s.submit([1, 2, 3], max_new=6)
        s.serve_tick()
    assert s.checkpointer.set is None and s.checkpointer.failed == 1
    s.drain()
    assert r.outcome == "served"


def test_restore_attempts(smoke):
    base = _served(_lm(smoke), [([1, 2, 3], 8)])[0]
    # a restore fault burns one attempt, the second restores
    s = _lm(smoke, checkpoint_every=2, max_restore_attempts=2)
    r, = _served(s, [([1, 2, 3], 8)], FaultPlan([
        FaultSpec("lm.step", "device_fault", times=3, after=1),
        FaultSpec("kv.restore", "device_fault", times=1)]))
    assert r.outcome == "served" and r.result == base.result
    assert s.restores == 1
    fails = [f for f in s.flight.dump() if f.get("outcome") ==
             "restore_failed"]
    assert len(fails) == 1 and fails[0]["attempt"] == 1
    # every restore faults: the one attempt burns, then error (bounded)
    s = _lm(smoke, checkpoint_every=2, max_restore_attempts=1)
    r, = _served(s, [([1, 2, 3], 8)], FaultPlan([
        FaultSpec("lm.step", "device_fault", times=32, after=1),
        FaultSpec("kv.restore", "device_fault", times=32)]))
    assert r.outcome == "error" and s.restores == 0
    assert not s.manager.active and s.checkpointer.set is None
    # recovery off: the in-flight request errors, with its token count
    s = _lm(smoke)
    r, = _served(s, [([1, 2, 3], 8)], FaultPlan([
        FaultSpec("lm.step", "device_fault", times=8, after=1)]))
    assert r.outcome == "error"
    errs = [f for f in s.flight.dump() if f.get("outcome") == "error"]
    assert errs and errs[-1]["n_tokens"] == 2
    nxt, = _served(s, [([4, 5], 2)])          # and it serves on
    assert nxt.outcome == "served"


def test_restart_drops_the_cut(smoke):
    s = _lm(smoke, checkpoint_every=1, max_seq=16)
    first = _served(s, [([1, 2, 3, 4], 8)])[0]
    assert first.outcome == "served" and s.checkpointer.set is not None
    s._restart()
    assert s.checkpointer.set is None and s.pos == 0
    # a request that needs the restart is cut again at its admission
    s = _lm(smoke, checkpoint_every=1, max_seq=16)
    _served(s, [([1, 2, 3, 4], 8)])
    held = s.checkpointer.set
    s.submit([5, 6, 7, 8], max_new=8)
    s.serve_tick()                            # restart, admit, cut, tick
    assert s.checkpointer.set is not held
    assert s.checkpointer.set.pos <= 5


# Fault C's probe: minitron SMOKE drawn by the port from seed 0, one
# request of prompt [1, 2, 3] and 6 new tokens through 2 slots.
READBACK_PROMPT, READBACK_MAX_NEW = [1, 2, 3], 6
READBACK_TOKENS = [238, 238, 219, 219, 167, 62]


def _faulty_readback(server, fail_at: int) -> None:
    """Make the ``fail_at``-th host readback of a tick's tokens raise once:
    the fault comes after the step ran, where the ``lm.step`` site (which
    fires before it) never reaches."""
    real, seen = server._next_tokens, [0]

    class Readback:
        def __init__(self, t):
            self.t = t

        def __getitem__(self, i):
            return self.t[i]

        def cpu(self):
            seen[0] += 1
            if seen[0] == fail_at:
                raise RuntimeError("injected readback fault")
            return self.t.cpu()

    server._next_tokens = lambda logits: Readback(real(logits))


@pytest.mark.parametrize("every", [None, 4])
def test_a_readback_fault_repeats_the_tick(every):
    """Fault C: the third tick's readback raises once.  The retried tick
    repeats from the same position and tokens, so the request gets the
    unfaulted tokens; with ``checkpoint_every=4`` three later step faults
    then restore the admission cut bit for bit (the position still counts
    exactly the tokens past the cut)."""
    params = t_tf.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    base = LMServer(CFG, params, n_slots=2, max_seq=32, device="cpu")
    want, = _served(base, [(READBACK_PROMPT, READBACK_MAX_NEW)])
    assert want.result == READBACK_TOKENS
    s = LMServer(CFG, params, n_slots=2, max_seq=32, device="cpu",
                 checkpoint_every=every)
    _faulty_readback(s, 3)
    plan = None if every is None else FaultPlan(
        [FaultSpec("lm.step", "device_fault", times=3, after=4)])
    r, = _served(s, [(READBACK_PROMPT, READBACK_MAX_NEW)], plan)
    assert r.outcome == "served" and r.result == READBACK_TOKENS
    assert s.pos == base.pos == len(READBACK_PROMPT) + READBACK_MAX_NEW - 1
    if every is None:
        assert s.metrics()["retries"] == 1 and s.restores == 0
    else:
        assert s.restores == 1 and s.metrics()["retries"] == 3
        restored, = [f for f in s.flight.dump()
                     if f.get("outcome") == "restored"]
        assert restored["replayed"] == 3


def _evacuate_to(target):
    def hook(items):
        for r, seq in items:
            target.adopt_sequence(r, seq.prompt, seq.tokens, seq.max_new)
        return True
    return hook


def test_evacuate_hands_sequences_to_another_server(smoke):
    """Restores spent on server a (its decode faults on every tick): the
    hook hands the sequence to server b, which replay-prefills it and
    finishes it with the emitted prefix kept."""
    b = _lm(smoke, tenant="b", checkpoint_every=2)
    a = _lm(smoke, tenant="a", checkpoint_every=1, max_restore_attempts=1,
            evacuate=_evacuate_to(b))
    r = a.submit([1, 2, 3], max_new=8)
    for _ in range(3):
        a.serve_tick()
    prefix = list(next(iter(a.manager.active.values())).tokens)
    assert len(prefix) == 4
    with faults.inject([FaultSpec("lm.step", "device_fault", times=1000,
                                  match={"tenant": "a"})]):
        a.drain()
        assert not r.done and a.evacuations == 1 and not a.manager.active
        b.drain()
    assert r.outcome == "served" and len(r.result) == 8
    assert r.result[:4] == prefix
    kinds = [f.get("kind") for f in a.flight.dump()]
    assert "evacuation" in kinds and kinds.count("restore") == 1
    assert a.queue_depth == 0 and b.metrics()["served"] == 1


def test_evacuation_that_does_not_fit_is_refused(smoke):
    """The adopter's max_seq cannot take the replay prefill and the
    remaining ticks: ``adopt_sequence`` refuses, the hook fails, and the
    request resolves ``error``."""
    b = _lm(smoke, max_seq=8)
    with pytest.raises(ValueError, match="does not fit"):
        b.adopt_sequence(None, [1, 2, 3, 4], [5, 6], 8)
    assert not b.manager.active and b.pos == 0
    a = _lm(smoke, checkpoint_every=1, max_restore_attempts=1,
            evacuate=_evacuate_to(b))
    r = a.submit([1, 2, 3, 4], max_new=8)
    a.serve_tick()
    with faults.inject([FaultSpec("lm.step", "device_fault", times=1000)]):
        a.drain()
    assert r.outcome == "error" and a.evacuations == 0
    assert not b.manager.active


# --------------------------------------------------------------------------
# LM parity with the reference
# --------------------------------------------------------------------------

PLANS = {
    "retries-then-error": (dict(max_attempts=2, jitter=0.0), None,
                           [dict(site="lm.step", kind="device_fault")]),
    "transient": (dict(max_attempts=3, jitter=0.0), None,
                  [dict(site="lm.step", kind="device_fault", times=1)]),
    "restore": (dict(max_attempts=3, jitter=0.0), 2,
                [dict(site="lm.step", kind="device_fault", times=4,
                      after=3)]),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_lm_faults_as_reference(smoke, mesh_rules, name):
    """The same requests and ``lm.step`` plan through the port's and the
    reference's LMServer: the same outcomes, counters and tokens."""
    retry, every, specs = PLANS[name]
    mesh, rules = mesh_rules
    prompts = [([1, 2, 3], 6), ([4, 5], 6)]
    out = {}
    for side in ("port", "jax"):
        mod = faults if side == "port" else j_faults
        kw = dict(n_slots=2, max_seq=32, retry=mod.RetryPolicy(**retry),
                  checkpoint_every=every)
        if side == "port":
            s = LMServer(CFG, smoke[1], device="cpu", **kw)
        else:
            s = JLMServer(cfg=j_minitron.SMOKE, rules=rules, params=smoke[0],
                          **kw)
        with mesh:
            reqs = [s.submit(p, max_new=m) for p, m in prompts]
            with mod.inject([mod.FaultSpec(**sp) for sp in specs]) as plan:
                s.drain()
            nxt = s.submit([6, 7], max_new=2)
            s.drain()
        m = s.metrics()
        out[side] = dict(outcomes=[r.outcome for r in reqs + [nxt]],
                         results=[r.result for r in reqs + [nxt]],
                         counters={k: m[k] for k in ("served", "retries",
                                                     "errors")},
                         restores=s.restores, fired=len(plan.log))
    assert out["port"] == out["jax"]
    assert out["port"]["outcomes"][-1] == "served"
