"""Continuous-batching LM decode server.

Counterpart of ``repro.serving.lm_server.LMServer``: submitted prompts
queue as :class:`Request` objects, the :class:`KVCacheManager` assigns
cache slots, a prompt is prefilled token by token into its slot through
the decode step, and one decode step advances *all* active slots each tick
(continuous batching: new sequences join between ticks, finished ones free
their slot without stalling the rest).

It speaks the servers' protocol: ``submit(prompt)`` -> Request, ``poll``,
``step``, ``serve_tick``, ``drain`` (bounded) and ``metrics()`` with the
same p50/p95/served/dropped/rejected/queue-depth definitions (latency is
submit -> last token).  Invalid prompts and queue-full submits resolve
``rejected`` at the protocol edge; requests whose deadline passes while
they wait for a slot are shed anywhere in the queue.

As in the reference: one global position per tick (every slot writes its
K/V at ``pos``; attention masks cache positions <= pos), greedy sampling,
one host loop.  Every prompt token and every tick advance that position.
Unlike the reference, whose cache write clamps to the last row once
``pos`` passes ``max_seq``, a waiting request is admitted only while its
prefill, its own ticks and every active sequence's remaining ticks stay
inside ``max_seq``; otherwise it waits.  With no slot active, ``pos``
and every slot's token return to 0, a fresh server's state, before such a
request is admitted: every tick rewrites every slot's row at ``pos``, so
no row a new sequence attends to predates the reset, and it decodes as in
a fresh server.  A server therefore outlives ``max_seq``.
Token state lives on the card; each tick reads back one argmax vector.

On the card the decode step is captured once, at construction, as one
CUDA graph at ``(n_slots, 1)`` tokens (``capture=None``; ``capture=False``
keeps the eager step, for debugging): it reads the static ``tokens``
buffer and a 0-dim position buffer on the card, writes the K/V rows at
that position in place, and leaves the logits and their argmax in static
outputs.  A prefill, a tick and :meth:`LMServer.generate` write the token
they feed into ``tokens``, set the position and replay; the list of
active slots stays outside the graph.  Prefill runs through the same
step, token by token.
``flight`` keeps the last requests' records (served, shed, rejected,
error) and the recovery events, and the ``serve.*`` trace instants mark
the same sites as the reference's.

Resilience, as the reference's: every request ends ``served``, ``shed``,
``rejected`` or ``error``.  A faulted decode tick (the ``lm.step`` fault
site, or any exception the step raises) is retried up to
``retry.max_attempts`` consecutive times.  With ``checkpoint_every=N``
the server keeps consistent-cut KV checkpoints
(:class:`~repro_torch.serving.recovery.KVCheckpointer`) every N ticks and
after each admission; when the retries are spent it restores the last cut
and force-feeds the <= N ticks since (bit for bit the unfaulted run's
tokens), at most ``max_restore_attempts`` times in a row; then an
``evacuate`` hook may hand the sequences to another server
(:meth:`LMServer.adopt_sequence`, a replay prefill that keeps the emitted
prefix), and only then do they resolve ``error``.  A restore writes into
the buffers the captured step reads: the cache is zeroed and each
restored slot copied in place, the tokens set in place, and the replay
goes through the same graph (rebinding them would leave the graph on the
old buffers).  Each sequence keeps its slot.  A ``_restart`` drops the
held cut; a restore lands ``pos`` where it was.  A fault that escapes a
prefill resolves every in-flight request ``error`` and frees its slot.
``journal=`` journals accepted submits and their outcomes
(:class:`~repro_torch.serving.recovery.RequestJournal`).

With ``rules`` (a :class:`~repro_torch.distributed.sharding.Rules` over
any mesh) the server is sharded, one process a rank: ``params`` are the
rank's shards (``param_specs``), the cache is the rank's shard
(``cache_specs``: its sequence chunk over ``model`` of the slots its
data coordinate holds, ``rules.batch_cut(n_slots)``; every slot on every
data rank when ``n_slots`` does not divide over the batch axes), and the
decode step is the sharded one, run eager (a step of host-side
collectives is not captured): each rank decodes its slots' rows and the
logits are all-gathered over ``model`` and the batch axes, so every
rank reads every slot's next token.  Every rank runs the same loop on
the same calls — the same submits, ticks and drains, and the same fault
plan — so its manager, admissions, ticks, sheds and journal see the same
tokens.  Every decision that reads the clock reads rank 0's (``clock``
is replaced by one that broadcasts it), so the ranks shed, admit and
time alike, and rank 0's metrics are the server's.  Faults, restores and
journals behave as on one device; a snapshot holds each rank's cache
shard, and a restore copies back the slots the rank holds.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer
from repro_torch.obs import inject as _inject
from repro_torch.obs import trace as _trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import ServingMetrics
from repro_torch.runtime import executor as _executor
from repro_torch.serving.faults import RetryPolicy
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.recovery import CheckpointSet, KVCheckpointer
from repro_torch.serving.scheduler import Request, shed_expired_requests


class _RankZeroClock:
    """Rank 0's reading of ``clock`` on every rank: one small sum over
    every mesh axis a call (each rank calls it at the same points)."""

    def __init__(self, clock: Callable[[], float], comm, device):
        self.clock, self.comm, self.device = clock, comm, device

    def __call__(self) -> float:
        now = self.clock() if self.comm.index == 0 else 0.0
        t = torch.tensor([now], dtype=torch.float64, device=self.device)
        return float(self.comm.psum(t)[0])


@dataclasses.dataclass
class LMServer:
    cfg: transformer.LMConfig
    params: Any
    n_slots: int
    max_seq: int
    eos_id: int | None = None
    clock: Callable[[], float] = time.monotonic
    max_queue: int | None = None
    device: str | torch.device = "cuda"
    capture: bool | None = None
    retry: RetryPolicy | None = dataclasses.field(
        default_factory=RetryPolicy)
    tenant: str | None = None
    # Consistent-cut checkpoint cadence in decode ticks; None turns
    # checkpoint and restore off (spent retries error the in-flight
    # sequences).  The replay after a fault is at most N ticks.
    checkpoint_every: int | None = None
    max_restore_attempts: int = 2
    journal: Any = None               # recovery.RequestJournal | None
    # Migration hook: called with the in-flight [(Request, Sequence)] when
    # restores are spent; True means another server adopted them all.
    evacuate: Callable[[list], bool] | None = None
    # Sharding over a mesh (one process a rank); None: one device.
    rules: Any = None

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.rules is not None:
            if self.capture:
                raise ValueError("the sharded decode step runs eager: "
                                 "capture=True needs rules=None")
            self.capture = False
            if self.rules.n_devices > 1:
                self.clock = _RankZeroClock(
                    self.clock, self.rules.comm(
                        tuple(self.rules.mesh.axis_names)), self.device)
        if self.capture is None:
            self.capture = self.device.type == "cuda"
        elif self.capture and self.device.type != "cuda":
            raise ValueError(f"capture=True needs a CUDA device; this "
                             f"server is on {self.device}")
        where = self.params["embed"].device
        if where.type != self.device.type:
            raise ValueError(f"params on {where}, server on {self.device}")
        self.cache = transformer.init_cache(self.cfg, self.n_slots,
                                            self.max_seq, self.device,
                                            rules=self.rules)
        # The slots this rank's cache rows hold (every one off a mesh).
        self._slots = (self.rules.batch_cut(self.n_slots)
                       if self.rules is not None else None)
        self.manager = KVCacheManager(self.n_slots, self.max_seq)
        with torch.inference_mode():
            self.tokens = torch.zeros((self.n_slots, 1), dtype=torch.int64,
                                      device=self.device)
        self.pos = 0
        self._decode = transformer.make_decode_step(self.cfg, self.max_seq,
                                                    rules=self.rules)
        self._waiting: deque[Request] = deque()
        self.dropped = 0          # deadline-shed requests (overload stat)
        self._by_seq: dict[int, tuple[Request, Any]] = {}
        self._metrics = ServingMetrics(self.clock)
        self.flight = FlightRecorder(
            tags={"tenant": self.tenant} if self.tenant is not None
            else None)
        self._tick_failures = 0   # consecutive faulted decode ticks
        self.checkpointer = KVCheckpointer()
        self._ticks_since_ckpt = 0
        # Consecutive restores without a clean tick between them.
        self._restore_attempts = 0
        self.restores = 0
        self.evacuations = 0
        self._graph = None
        if self.capture:
            self._capture_decode()
    # ---- the decode step ---------------------------------------------------
    @property
    def capture_count(self) -> int:
        """CUDA graphs captured: 1 with a captured decode step, else 0."""
        return int(self._graph is not None)

    @torch.inference_mode()
    def _capture_decode(self) -> None:
        self._pos_buf = torch.zeros((), dtype=torch.int64,
                                    device=self.device)

        def step():
            logits, _ = self._decode(self.params, self.cache, self.tokens,
                                     self._pos_buf)
            return logits, logits.argmax(-1)
        self._graph, (self._logits, self._argmax) = _executor.capture(
            step, (), self.device)
        # The warm-up wrote token 0's K/V at position 0 of every slot: the
        # cache is zeroed again, as a fresh server's.
        for t in self.cache.values():
            t.zero_()

    def _run_decode(self, pos: int) -> torch.Tensor:
        """One decode step of every slot's token in ``tokens`` at ``pos``;
        returns the logits (a captured step's static output, valid until
        the next step)."""
        if self._graph is None:
            logits, self.cache = self._decode(self.params, self.cache,
                                              self.tokens, pos)
            return logits
        if not 0 <= pos < self.max_seq:
            raise ValueError(f"decode position {pos} outside [0, "
                             f"{self.max_seq})")
        self._pos_buf.fill_(pos)
        self._graph.replay()
        return self._logits

    def _row(self, slot: int) -> int | None:
        """``slot``'s row of this rank's cache, None where another data
        rank holds it."""
        if self._slots is None:
            return slot
        return self._slots.local(slot, self.n_slots)

    def _next_tokens(self, logits: torch.Tensor) -> torch.Tensor:
        """Each slot's greedy next token (computed inside the captured
        step)."""
        return logits.argmax(-1) if self._graph is None else self._argmax

    # ---- admission ---------------------------------------------------------
    @torch.inference_mode()
    def add_prompt(self, prompt: list[int], max_new: int = 32):
        """Prefill a prompt token by token into a slot through the decode
        step (every slot steps; the others rewrite their own token's K/V
        at the new positions, as in the reference)."""
        seq = self.manager.admit(len(prompt), max_new, prompt=prompt)
        self._prefill(seq, prompt)
        return seq

    @torch.inference_mode()
    def _prefill(self, seq, prompt: list[int]) -> None:
        for i, tok in enumerate(prompt):
            self.tokens[seq.slot, 0] = tok
            logits = self._run_decode(self.pos + i)
        self.pos += len(prompt)
        nxt = int(self._next_tokens(logits)[seq.slot])
        # The first generated token goes through the manager, so a
        # max_new=1 sequence finishes right here.
        self.manager.record_token(seq.seq_id, nxt, self.eos_id)
        self.tokens[seq.slot, 0] = nxt

    # ---- decode tick -------------------------------------------------------
    @torch.inference_mode()
    def step(self) -> dict[int, int]:
        """One decode tick for all active sequences.  Returns
        {seq_id: new_token} for the sequences that were active."""
        if not self.manager.active:
            return {}
        if _inject._PLAN is not None:
            _inject.maybe_fault("lm.step", active=len(self.manager.active),
                                pos=self.pos, tenant=self.tenant)
        nxt = self._next_tokens(self._run_decode(self.pos))
        host = nxt.cpu().numpy()                 # the one readback a tick
        # The tick's state moves only once the step and its readback are
        # through: a retry after a fault in either repeats the tick from
        # the same position and tokens (it rewrites row ``pos`` with the
        # same K/V), so no token is lost and a held cut stays consistent.
        self.pos += 1
        slots = torch.tensor(self.manager.active_slots(), device=self.device)
        self.tokens[slots, 0] = nxt[slots]
        out: dict[int, int] = {}
        for seq_id, seq in list(self.manager.active.items()):
            out[seq_id] = int(host[seq.slot])
            self.manager.record_token(seq_id, out[seq_id], self.eos_id)
        return out

    # ---- server protocol ---------------------------------------------------
    def _journal_resolve(self, r: Request) -> None:
        if self.journal is not None and r.jid is not None:
            self.journal.resolve(r.jid, r.outcome, error=r.error)

    def submit(self, prompt: list[int], max_new: int = 16,
               deadline_s: float | None = None,
               now: float | None = None, jid: int | None = None) -> Request:
        """Queue a prompt; it joins the continuous batch when a KV slot
        frees, and ``request.result`` becomes the generated token list.
        Invalid requests resolve ``rejected`` here, at the protocol edge,
        instead of raising (raising inside ``drain`` would strand every
        other queued request).  ``jid`` is the journal-replay path: the
        submit record is on disk already, so its identity is attached
        instead of journaled again."""
        now = self.clock() if now is None else now
        prompt = list(prompt)
        err = None
        if not prompt:
            err = "empty prompt"
        elif any(not isinstance(t, (int, np.integer)) for t in prompt):
            err = "prompt tokens must be ints"
        elif len(prompt) + max_new > self.max_seq:
            err = (f"prompt ({len(prompt)}) + max_new ({max_new}) exceeds "
                   f"max_seq ({self.max_seq})")
        elif self.max_queue is not None \
                and len(self._waiting) >= self.max_queue:
            err = (f"queue full ({len(self._waiting)} >= "
                   f"max_queue={self.max_queue})")
        r = Request((prompt, max_new), deadline_s=deadline_s)
        r.jid = jid
        r.arrival_s = now        # one clock domain for arrival and done
        if err is not None:
            r.resolve("rejected", error=err)
            self._journal_resolve(r)
            self._metrics.record_rejected()
            self.flight.record(id=r.id, outcome="rejected", error=err,
                               arrival_s=now, deadline_s=deadline_s,
                               done_s=now, latency_s=0.0)
            _trace.instant("serve.reject", "serve", req=r.id, reason=err)
            return r
        if self.journal is not None and jid is None:
            # Write-ahead: the submit record is on disk before the request
            # joins the queue, so a crash in between replays it.
            r.jid = self.journal.submit("lm", (prompt, max_new))
        self._waiting.append(r)
        _trace.instant("serve.submit", "serve", req=r.id)
        return r

    def poll(self, request: Request) -> bool:
        return request.done

    def _admit_waiting(self, now: float | None = None) -> None:
        now = self.clock() if now is None else now
        # Shed expired requests anywhere in the queue: a full KV cache
        # must not protect queued requests from their deadlines.
        self._waiting, shed = shed_expired_requests(self._waiting, now)
        self.dropped += len(shed)
        self._metrics.record_dropped(len(shed))
        for r in shed:
            self._journal_resolve(r)
            self.flight.record(id=r.id, outcome="shed",
                               arrival_s=r.arrival_s,
                               deadline_s=r.deadline_s, done_s=now,
                               latency_s=now - r.arrival_s)
        admitted = 0
        while self._waiting and self.manager.can_admit():
            prompt, max_new = self._waiting[0].payload
            if not self._fits(len(prompt), max_new):
                if self.manager.active:
                    break                 # waits for the active to finish
                self._restart()
            r = self._waiting.popleft()
            self._metrics.mark_dispatch()
            seq = self.manager.admit(len(prompt), max_new, prompt=prompt)
            self._by_seq[seq.seq_id] = (r, seq)
            self._prefill(seq, prompt)
            admitted += 1
        if admitted and self.checkpoint_every is not None:
            # A prefill advances ``pos`` outside the pure-decode window the
            # replay needs: cut again (or just drop the old cut when every
            # admitted sequence finished in its prefill).
            if self.manager.active:
                self._take_checkpoint("admission")
            else:
                self.checkpointer.invalidate()

    @torch.inference_mode()
    def _restart(self) -> None:
        """Return an idle server to a fresh one's state: position 0 and
        token 0 in every slot, and no held cut (it belongs to positions
        that no longer exist).  The cache needs no reset: every tick and
        prompt token rewrites every slot's row at the position it reads up
        to, so no row written before the restart is read after it."""
        self.pos = 0
        self.tokens.zero_()
        self.checkpointer.invalidate()

    def _fits(self, prompt_len: int, max_new: int) -> bool:
        """Whether a sequence admitted now, and every active one, can run
        to its end with every decode position below ``max_seq``: the
        prefill takes ``prompt_len`` positions, then each tick one, and a
        sequence needs a tick for each token after its first."""
        ticks = max([max_new - 1] + [s.max_new - s.generated
                                     for s in self.manager.active.values()])
        return self.pos + prompt_len + ticks <= self.max_seq

    def _fail_inflight(self, exc: Exception, now: float) -> list[Request]:
        """Recovery spent (or off): resolve every in-flight sequence still
        decoding ``error`` and free its slot, so the queue can still be
        served.  A sequence that finished in this tick's prefill keeps its
        tokens: the tick's own loop serves it."""
        failed: list[Request] = []
        for seq_id, (r, seq) in list(self._by_seq.items()):
            if seq_id not in self.manager.active:
                continue
            r.resolve("error", error=f"{type(exc).__name__}: {exc}")
            self._journal_resolve(r)
            self._metrics.record_error()
            self._record_error(r, now, n_tokens=len(seq.tokens))
            self.manager.release(seq_id)
            del self._by_seq[seq_id]
            failed.append(r)
        self.checkpointer.invalidate()
        _trace.instant("serve.error", "serve", n=len(failed))
        return failed

    def _record_error(self, r: Request, now: float, **fields) -> None:
        self.flight.record(id=r.id, outcome="error", error=r.error,
                           arrival_s=r.arrival_s, deadline_s=r.deadline_s,
                           done_s=now, latency_s=now - r.arrival_s,
                           **fields)

    # ---- checkpoint / restore ----------------------------------------------
    def _take_checkpoint(self, reason: str) -> None:
        """Snapshot a consistent cut.  A faulted *cadence* snapshot keeps
        the previous cut (still consistent: the replay bound grows and the
        next tick tries again); a faulted *admission* or *restore*
        snapshot drops it (the old cut predates a prefill or a restore)."""
        try:
            self.checkpointer.take(self.cache, self.manager, self.pos,
                                   reason=reason, row=self._row)
        except Exception as e:          # noqa: BLE001 — the kv.snapshot site
            if reason != "cadence":
                self.checkpointer.invalidate()
            _trace.instant("serve.ckpt_failed", "serve", reason=reason,
                           error=f"{type(e).__name__}: {e}")
            return
        self._ticks_since_ckpt = 0
        _trace.instant("serve.ckpt", "serve", pos=self.pos,
                       seqs=len(self.manager.active), reason=reason)

    @torch.inference_mode()
    def _restore(self, ck: CheckpointSet) -> int:
        """Rebuild the decode state from the cut ``ck`` and force-feed the
        ticks since: bit for bit the state the unfaulted ticks left,
        because between cuts only pure decode ticks ran and every decoding
        sequence has exactly ``m = pos - ck.pos`` known tokens past the
        cut.  Writes into the buffers the captured step reads: the cache
        zeroed and each slot's pages copied back in place, the registers
        set in place, the replay through the same step.  Returns ``m``.
        Raises, with the state untouched, if the ``kv.restore`` site fires
        or the cut does not cover the decoding sequences."""
        if _inject._PLAN is not None:
            _inject.maybe_fault("kv.restore", pos=ck.pos,
                                active=len(self._by_seq),
                                tenant=self.tenant)
        m = self.pos - ck.pos
        replay = []
        for seq_id, (_, seq) in self._by_seq.items():
            if seq_id not in self.manager.active:
                continue                  # finished in this tick's prefill
            c = ck.seqs.get(seq_id)
            if c is None or len(seq.tokens) - c.generated != m:
                # Admission cuts make this impossible; an unusable cut
                # burns a restore attempt, not the batch.
                raise RuntimeError(f"sequence {seq_id} is not covered by "
                                   f"the cut at pos {ck.pos}")
            replay.append((seq, c, seq.tokens[c.generated:]))
        for t in self.cache.values():
            t.zero_()
        for seq, c, _ in replay:
            row = self._row(seq.slot)
            if row is not None:
                k, v = c.materialize()
                self.cache["k"][:, row].copy_(k, non_blocking=True)
                self.cache["v"][:, row].copy_(v, non_blocking=True)
            self.tokens[seq.slot, 0] = c.register
        self.pos = ck.pos
        # Tick i writes the register's K/V at pos and loads the token the
        # original tick generated; the logits are not read (the outcome
        # is known and must not be sampled again).
        for i in range(m):
            self._run_decode(self.pos)
            self.pos += 1
            for seq, _, extra in replay:
                self.tokens[seq.slot, 0] = extra[i]
        if self.device.type == "cuda":
            # Done before it returns: the restore's time is its own, and a
            # fault in its replay surfaces here, not in the next tick.
            torch.cuda.synchronize(self.device)
        # The restored state is a consistent cut itself: a repeated fault
        # replays from here.
        self._take_checkpoint("restore")
        return m

    def _evacuate_inflight(self, now: float) -> bool:
        """Hand the in-flight sequences to the ``evacuate`` hook, all or
        nothing: True means the adopter owns the requests now and this
        server forgets them unresolved; False (or a hook that raises)
        leaves the ``error`` outcome."""
        items = [(r, seq) for sid, (r, seq) in self._by_seq.items()
                 if sid in self.manager.active]
        try:
            ok = bool(self.evacuate(items))
        except Exception:               # noqa: BLE001 — the hook must not kill
            ok = False
        if not ok:
            return False
        for r, seq in items:
            self.manager.release(seq.seq_id)
            del self._by_seq[seq.seq_id]
        self.checkpointer.invalidate()
        self.evacuations += 1
        self.flight.record(kind="evacuation", outcome="evacuated",
                           seqs=len(items), done_s=now)
        _trace.instant("serve.evacuate", "serve", n=len(items))
        return True

    def _recover(self, exc: Exception, now: float) -> list[Request]:
        """The decode retries are spent: restore from the last cut (a
        bounded number of attempts), else hand the sequences to
        ``evacuate``, else resolve them ``error``."""
        while self.checkpoint_every is not None and self.manager.active \
                and self.checkpointer.set is not None \
                and self._restore_attempts < self.max_restore_attempts:
            self._restore_attempts += 1
            t0 = time.perf_counter()
            try:
                replayed = self._restore(self.checkpointer.set)
            except Exception as re:     # noqa: BLE001 — the kv.restore site
                self.flight.record(kind="restore", outcome="restore_failed",
                                   error=f"{type(re).__name__}: {re}",
                                   attempt=self._restore_attempts,
                                   done_s=now)
                _trace.instant("serve.restore_failed", "serve",
                               attempt=self._restore_attempts)
                continue
            self.restores += 1
            self.flight.record(kind="restore", outcome="restored",
                               pos=self.pos, replayed=replayed,
                               seqs=len(self.manager.active),
                               attempt=self._restore_attempts,
                               restore_s=time.perf_counter() - t0,
                               done_s=now)
            _trace.instant("serve.restore", "serve", pos=self.pos,
                           replayed=replayed)
            return []
        if self.evacuate is not None and self.manager.active \
                and self._evacuate_inflight(now):
            return []
        return self._fail_inflight(exc, now)

    def serve_tick(self, now: float | None = None) -> list[Request]:
        """One serving tick: admit waiting prompts into free slots, run a
        decode step, complete the sequences that finished.  Nothing
        escapes: a faulted tick is retried (``retry.max_attempts``
        consecutive faults), then recovered (restore, evacuation) or its
        sequences resolve ``error``; a fault in a prefill resolves the
        in-flight requests ``error``."""
        done: list[Request] = []
        try:
            self._admit_waiting(now)
        except Exception as e:           # noqa: BLE001 — nothing escapes
            return self._fail_inflight(e, self.clock() if now is None
                                       else now)
        try:
            self.step()
            self._tick_failures = 0
            self._restore_attempts = 0
            if self.checkpoint_every is not None and self.manager.active:
                self._ticks_since_ckpt += 1
                if self._ticks_since_ckpt >= self.checkpoint_every:
                    self._take_checkpoint("cadence")
        except Exception as e:           # noqa: BLE001 — nothing escapes
            self._tick_failures += 1
            budget = self.retry.max_attempts if self.retry else 1
            t = self.clock() if now is None else now
            if self._tick_failures >= budget:
                self._tick_failures = 0
                done += self._recover(e, t)
            else:
                self._metrics.record_retry()
                _trace.instant("serve.retry", "serve",
                               attempt=self._tick_failures)
        now = self.clock() if now is None else now
        for seq_id, (r, seq) in list(self._by_seq.items()):
            if seq_id not in self.manager.active:    # finished + released
                r.resolve("served", list(seq.tokens))
                self._journal_resolve(r)
                self._metrics.record([now - r.arrival_s])
                self.flight.record(
                    id=r.id, outcome="served", arrival_s=r.arrival_s,
                    deadline_s=r.deadline_s, done_s=now,
                    latency_s=now - r.arrival_s, n_tokens=len(seq.tokens))
                del self._by_seq[seq_id]
                done.append(r)
        return done

    # ---- migration -----------------------------------------------------------
    @torch.inference_mode()
    def adopt_sequence(self, request: Request, prompt: list[int],
                       tokens: list[int], max_new: int):
        """Adopt a sequence evacuated from another server: replay-prefill
        its prompt and all but its last generated token into a free slot
        here, load the last one as the register and go on decoding.  The
        emitted prefix is kept verbatim (the positions and cache history
        differ between servers, so this is prefix-preserving, not bit for
        bit).  Raises, with nothing changed, when no slot is free or the
        replay prefill and the remaining ticks do not fit below
        ``max_seq`` (an idle server starts again at position 0 first)."""
        if not tokens:
            raise ValueError("an adopted sequence has generated tokens")
        if not self.manager.can_admit():
            raise RuntimeError("no free KV slot to adopt into")
        feed = list(prompt) + list(tokens[:-1])
        remaining = max_new - len(tokens)
        if not self._fits(len(feed), remaining + 1):
            if self.manager.active or len(feed) + remaining > self.max_seq:
                raise ValueError(f"adopted sequence of {len(feed)} replay "
                                 f"tokens and {remaining} ticks does not fit "
                                 f"at pos {self.pos} below max_seq "
                                 f"{self.max_seq}")
            self._restart()
        seq = self.manager.adopt(len(prompt) + len(tokens), max_new,
                                 len(tokens), list(tokens),
                                 prompt=list(prompt))
        for i, tok in enumerate(feed):
            self.tokens[seq.slot, 0] = tok
            self._run_decode(self.pos + i)
        self.pos += len(feed)
        self.tokens[seq.slot, 0] = tokens[-1]
        self._by_seq[seq.seq_id] = (request, seq)
        self._metrics.mark_dispatch()
        # An adoption advances ``pos`` through a prefill: cut again.
        if self.checkpoint_every is not None:
            self._take_checkpoint("admission")
        return seq

    def drain(self, now: float | None = None,
              max_steps: int | None = None) -> list[Request]:
        """Serve until every submitted prompt has completed or been shed.
        Bounded: after ``max_steps`` ticks (default generous: each
        sequence needs at most ``max_seq`` ticks, plus the retry budget)
        whatever is still outstanding resolves ``error`` instead of
        hanging the caller."""
        if max_steps is None:
            budget = self.retry.max_attempts if self.retry else 1
            outstanding = len(self._waiting) + len(self._by_seq) + 1
            max_steps = outstanding * (self.max_seq + budget) * 2 + 16
        done: list[Request] = []
        steps = 0
        while self._waiting or self._by_seq:
            if steps >= max_steps:
                reason = "drain wedged: step budget exhausted"
                wedged = list(self._waiting)
                self._waiting.clear()
                t = self.clock() if now is None else now
                for r in wedged:
                    r.resolve("error", error=reason)
                    self._journal_resolve(r)
                    self._metrics.record_error()
                    self._record_error(r, t)
                _trace.instant("serve.drain_wedged", "serve",
                               n=len(wedged) + len(self._by_seq))
                done += wedged + self._fail_inflight(RuntimeError(reason), t)
                break
            steps += 1
            done += self.serve_tick(now)
        return done

    @property
    def metrics_registry(self):
        """This server's series (the same names as InferenceServer's)."""
        return self._metrics.registry

    @property
    def queue_depth(self) -> int:
        return len(self._waiting) + len(self._by_seq)

    def metrics(self) -> dict:
        """The servers' definitions; latency is submit -> last token."""
        extra: dict = {}
        if self.tenant is not None:
            extra["tenant"] = self.tenant
        if self.checkpoint_every is not None:
            extra["recovery"] = {
                "checkpoint_every": self.checkpoint_every,
                "restores": self.restores,
                "evacuations": self.evacuations,
                **self.checkpointer.snapshot(),
            }
        return self._metrics.snapshot(
            dropped=self.dropped, queue_depth=self.queue_depth,
            kv_utilization=self.manager.utilization, **extra)

    @torch.inference_mode()
    def generate(self, prompt: list[int], max_new: int = 16) -> list[int]:
        """Convenience: run one sequence to completion.  The slot's token
        in ``tokens`` is restored afterwards, as the reference leaves it."""
        seq = self.manager.admit(len(prompt), max_new)
        sid = seq.slot
        before = self.tokens[sid, 0].clone()
        out: list[int] = []
        for tok in prompt:
            self.tokens[sid, 0] = tok
            logits = self._run_decode(self.pos)
            self.pos += 1
        for _ in range(max_new):
            nxt = int(self._next_tokens(logits)[sid])
            out.append(nxt)
            self.tokens[sid, 0] = nxt
            logits = self._run_decode(self.pos)
            self.pos += 1
            if self.eos_id is not None and nxt == self.eos_id:
                break
        self.tokens[sid, 0] = before
        if seq.seq_id in self.manager.active:
            self.manager.release(seq.seq_id)
        return out
