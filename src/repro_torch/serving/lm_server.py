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
error), and the ``serve.submit`` / ``serve.reject`` / ``serve.error``
trace instants mark the same sites as the reference's.  The reference's
resilience — decode retry, KV checkpoints and restore, the request
journal, evacuation to another lane, and their instants — is not ported:
a fault that still escapes a prefill or a decode tick resolves every
in-flight request ``error`` and frees its slot, and the server goes on
with the queue.
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
from repro_torch.obs import trace as _trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import ServingMetrics
from repro_torch.runtime import executor as _executor
from repro_torch.serving.kv_cache import KVCacheManager
from repro_torch.serving.scheduler import Request, shed_expired_requests


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

    def __post_init__(self):
        self.device = resolve_device(self.device)
        if self.capture is None:
            self.capture = self.device.type == "cuda"
        elif self.capture and self.device.type != "cuda":
            raise ValueError(f"capture=True needs a CUDA device; this "
                             f"server is on {self.device}")
        where = self.params["embed"].device
        if where.type != self.device.type:
            raise ValueError(f"params on {where}, server on {self.device}")
        self.cache = transformer.init_cache(self.cfg, self.n_slots,
                                            self.max_seq, self.device)
        self.manager = KVCacheManager(self.n_slots, self.max_seq)
        with torch.inference_mode():
            self.tokens = torch.zeros((self.n_slots, 1), dtype=torch.int64,
                                      device=self.device)
        self.pos = 0
        self._decode = transformer.make_decode_step(self.cfg, self.max_seq)
        self._waiting: deque[Request] = deque()
        self.dropped = 0          # deadline-shed requests (overload stat)
        self._by_seq: dict[int, tuple[Request, Any]] = {}
        self._metrics = ServingMetrics(self.clock)
        self.flight = FlightRecorder()
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
        seq = self.manager.admit(len(prompt), max_new)
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
        nxt = self._next_tokens(self._run_decode(self.pos))
        self.pos += 1
        slots = torch.tensor(self.manager.active_slots(), device=self.device)
        self.tokens[slots, 0] = nxt[slots]
        host = nxt.cpu().numpy()                 # the one readback a tick
        out: dict[int, int] = {}
        for seq_id, seq in list(self.manager.active.items()):
            out[seq_id] = int(host[seq.slot])
            self.manager.record_token(seq_id, out[seq_id], self.eos_id)
        return out

    # ---- server protocol ---------------------------------------------------
    def submit(self, prompt: list[int], max_new: int = 16,
               deadline_s: float | None = None,
               now: float | None = None) -> Request:
        """Queue a prompt; it joins the continuous batch when a KV slot
        frees, and ``request.result`` becomes the generated token list.
        Invalid requests resolve ``rejected`` here, at the protocol edge,
        instead of raising (raising inside ``drain`` would strand every
        other queued request)."""
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
        r.arrival_s = now        # one clock domain for arrival and done
        if err is not None:
            r.resolve("rejected", error=err)
            self._metrics.record_rejected()
            self.flight.record(id=r.id, outcome="rejected", error=err,
                               arrival_s=now, deadline_s=deadline_s,
                               done_s=now, latency_s=0.0)
            _trace.instant("serve.reject", "serve", req=r.id, reason=err)
            return r
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
            self.flight.record(id=r.id, outcome="shed",
                               arrival_s=r.arrival_s,
                               deadline_s=r.deadline_s, done_s=now,
                               latency_s=now - r.arrival_s)
        while self._waiting and self.manager.can_admit():
            prompt, max_new = self._waiting[0].payload
            if not self._fits(len(prompt), max_new):
                if self.manager.active:
                    break                 # waits for the active to finish
                self._restart()
            r = self._waiting.popleft()
            self._metrics.mark_dispatch()
            seq = self.manager.admit(len(prompt), max_new)
            self._by_seq[seq.seq_id] = (r, seq)
            self._prefill(seq, prompt)

    @torch.inference_mode()
    def _restart(self) -> None:
        """Return an idle server to a fresh one's state: position 0 and
        token 0 in every slot.  The cache needs no reset: every tick and
        prompt token rewrites every slot's row at the position it reads up
        to, so no row written before the restart is read after it."""
        self.pos = 0
        self.tokens.zero_()

    def _fits(self, prompt_len: int, max_new: int) -> bool:
        """Whether a sequence admitted now, and every active one, can run
        to its end with every decode position below ``max_seq``: the
        prefill takes ``prompt_len`` positions, then each tick one, and a
        sequence needs a tick for each token after its first."""
        ticks = max([max_new - 1] + [s.max_new - s.generated
                                     for s in self.manager.active.values()])
        return self.pos + prompt_len + ticks <= self.max_seq

    def _fail_inflight(self, reason: str) -> list[Request]:
        """Resolve every in-flight sequence ``error`` and free its slot."""
        now = self.clock()
        failed: list[Request] = []
        for seq_id, (r, seq) in list(self._by_seq.items()):
            r.resolve("error", error=reason)
            self._metrics.record_error()
            self._record_error(r, now, n_tokens=len(seq.tokens))
            if seq_id in self.manager.active:
                self.manager.release(seq_id)
            del self._by_seq[seq_id]
            failed.append(r)
        _trace.instant("serve.error", "serve", n=len(failed))
        return failed

    def _record_error(self, r: Request, now: float, **fields) -> None:
        self.flight.record(id=r.id, outcome="error", error=r.error,
                           arrival_s=r.arrival_s, deadline_s=r.deadline_s,
                           done_s=now, latency_s=now - r.arrival_s,
                           **fields)

    def serve_tick(self, now: float | None = None) -> list[Request]:
        """One serving tick: admit waiting prompts into free slots, run a
        decode step, complete the sequences that finished.  A fault in a
        prefill or the decode step (no retry in the port yet) resolves the
        in-flight requests ``error`` and frees their slots."""
        try:
            self._admit_waiting(now)
            self.step()
        except Exception as e:           # noqa: BLE001 — nothing escapes
            return self._fail_inflight(f"decode step failed: {e!r}")
        now = self.clock() if now is None else now
        done: list[Request] = []
        for seq_id, (r, seq) in list(self._by_seq.items()):
            if seq_id not in self.manager.active:    # finished + released
                r.resolve("served", list(seq.tokens))
                self._metrics.record([now - r.arrival_s])
                self.flight.record(
                    id=r.id, outcome="served", arrival_s=r.arrival_s,
                    deadline_s=r.deadline_s, done_s=now,
                    latency_s=now - r.arrival_s, n_tokens=len(seq.tokens))
                del self._by_seq[seq_id]
                done.append(r)
        return done

    def drain(self, now: float | None = None,
              max_steps: int | None = None) -> list[Request]:
        """Serve until every submitted prompt has completed or been shed.
        Bounded: after ``max_steps`` ticks (default generous: each
        sequence needs at most ``max_seq`` ticks) whatever is still
        outstanding resolves ``error`` instead of hanging the caller."""
        if max_steps is None:
            outstanding = len(self._waiting) + len(self._by_seq) + 1
            max_steps = outstanding * (self.max_seq + 1) * 2 + 16
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
                    self._metrics.record_error()
                    self._record_error(r, t)
                done += wedged + self._fail_inflight(reason)
                break
            steps += 1
            done += self.serve_tick(now)
        return done

    @property
    def queue_depth(self) -> int:
        return len(self._waiting) + len(self._by_seq)

    def metrics(self) -> dict:
        """The servers' definitions; latency is submit -> last token."""
        return self._metrics.snapshot(
            dropped=self.dropped, queue_depth=self.queue_depth,
            kv_utilization=self.manager.utilization)

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
