"""Crash-safe serving primitives (DESIGN.md §14).

Counterpart of ``repro.serving.recovery``: three mechanisms the servers
compose.

**KV checkpointing** (:class:`KVCheckpointer`) — consistent-cut snapshots
of the LM decode state.  A cut holds *every* active sequence at one
global position ``P``: its slot's KV pages, its ``Sequence`` bookkeeping
and its register (the last generated token, whose K/V the next tick
writes).  ``LMServer`` cuts again after every admission, so between cuts
only pure decode ticks run, every surviving sequence has exactly
``m = pos_now - P`` tokens past the cut, and force-feeding those ``m``
ticks rebuilds the cache — and every later token — bit for bit.

The port's decode step writes K/V *in place* (``index_copy_`` into the
cache the captured graph reads), where the reference's arrays are
immutable and a snapshot may keep references.  So a port snapshot is a
copy: on the card each slot's pages go into pinned host buffers by
``non_blocking`` copies queued on the decode stream, ahead of the next
tick's writes, and an event marks them done; taking a cut blocks nothing,
and :meth:`SequenceCheckpoint.materialize` waits on the event only when
the pages are needed (at restore).  On the CPU the pages are cloned.

**Durable request journal** (:class:`RequestJournal`) — an append-only
JSONL write-ahead log of submit and resolve records, each append flushed
and fsynced.  Accepted submits are journaled *before* they enter a queue
and terminal outcomes as they happen, so after a hard crash (``kill
-9``) :func:`replay_journal` finds every submit without a resolve and
resubmits it to a fresh server.  The scan tolerates a torn tail, and
journal ids continue across reopens.  The line format is the
reference's: either package's scan reads the other's journal.

**Payload codecs** — ``bnn`` image batches as base64 of (dtype, shape,
bytes), ``lm`` prompts as token lists.  Deadlines are not replayed: they
were promises of a process that no longer exists.
"""

from __future__ import annotations

import base64
import dataclasses
import json
import os
import time
from pathlib import Path
from typing import Any

import numpy as np
import torch

from repro_torch.obs import inject as _inject

__all__ = ["SequenceCheckpoint", "CheckpointSet", "KVCheckpointer",
           "RequestJournal", "JournalState", "replay_journal",
           "encode_payload", "decode_payload"]


# ---------------------------------------------------------------------------
# KV checkpointing
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SequenceCheckpoint:
    """One sequence's share of a consistent cut: its bookkeeping and its
    slot's full KV pages, copies of shape (L, KV, S, hd) (pinned host
    tensors on the card, their copies marked done by ``event``).  On a
    mesh, the pages of this rank's cache shard: its sequence chunk, and
    None where another data rank holds the slot."""

    seq_id: int
    slot: int
    length: int
    max_new: int
    generated: int
    tokens: list
    prompt: list
    register: int           # last generated token, K/V not yet written
    k_pages: torch.Tensor | None
    v_pages: torch.Tensor | None
    event: Any = None       # torch.cuda.Event, None on the CPU

    def materialize(self) -> tuple[torch.Tensor, torch.Tensor]:
        """The pages, once their copies have landed (the one wait)."""
        if self.event is not None:
            self.event.synchronize()
        return self.k_pages, self.v_pages


@dataclasses.dataclass
class CheckpointSet:
    """A consistent cut: every active sequence at one global position.
    Restoring any subset of them (those still active at the fault) is
    valid: attention reads only the owning slot's pages."""

    pos: int
    seqs: dict[int, SequenceCheckpoint]
    reason: str             # "cadence" | "admission" | "restore"


class KVCheckpointer:
    """Takes consistent-cut snapshots of an LM decode state.

    Holds at most one :class:`CheckpointSet` (the latest); the replay
    bound is the distance back to it.  ``kv.snapshot`` is a fault site:
    an injected fault raises out of :meth:`take` with the held set
    untouched, and the caller applies the policy — a *cadence* snapshot
    fault keeps the previous cut (still consistent; the replay bound
    grows), an *admission* one drops it (it predates a prefill).

    Each successful take records ``last_bytes`` (the pages copied),
    ``last_enqueue_s`` (host time to queue the copies) and, on the card,
    timing events for :meth:`last_copy_ms` (the copies' device time)."""

    def __init__(self):
        self.set: CheckpointSet | None = None
        self.taken = 0          # successful snapshots
        self.failed = 0         # faulted snapshot attempts
        self.last_bytes = 0
        self.last_enqueue_s = 0.0
        self._timing: tuple | None = None

    def take(self, cache: dict, manager, pos: int,
             reason: str = "cadence", row=None) -> CheckpointSet:
        """Snapshot every active sequence at global position ``pos``.
        ``row(slot)``: the slot's row of ``cache`` (this rank's shard on
        a mesh), None where another rank holds it (its bookkeeping is
        kept, its pages are not); default the slot itself.  Raises (the
        held set untouched) if the ``kv.snapshot`` site fires; the caller
        decides keep or drop."""
        if _inject._PLAN is not None:
            try:
                _inject.maybe_fault("kv.snapshot", pos=pos,
                                    active=len(manager.active),
                                    reason=reason)
            except Exception:
                self.failed += 1
                raise
        t0 = time.perf_counter()
        timing = None
        if cache["k"].is_cuda:
            # (queued, done): ``done`` also marks the pages landed.
            timing = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            timing[0].record()
        seqs: dict[int, SequenceCheckpoint] = {}
        nbytes = 0
        for seq_id, seq in manager.active.items():
            r = seq.slot if row is None else row(seq.slot)
            pages = []
            for name in ("k", "v"):
                if r is None:
                    pages.append(None)
                    continue
                src = cache[name][:, r]
                if timing is None:
                    dst = src.clone()
                else:
                    dst = torch.empty(src.shape, dtype=src.dtype,
                                      pin_memory=True)
                    dst.copy_(src, non_blocking=True)
                pages.append(dst)
                nbytes += dst.numel() * dst.element_size()
            seqs[seq_id] = SequenceCheckpoint(
                seq_id=seq_id, slot=seq.slot, length=seq.length,
                max_new=seq.max_new, generated=seq.generated,
                tokens=list(seq.tokens), prompt=list(seq.prompt),
                register=int(seq.tokens[-1]), k_pages=pages[0],
                v_pages=pages[1],
                event=timing[1] if timing is not None else None)
        if timing is not None:
            timing[1].record()
        self.set = CheckpointSet(pos=int(pos), seqs=seqs, reason=reason)
        self.taken += 1
        self.last_bytes = nbytes
        self.last_enqueue_s = time.perf_counter() - t0
        self._timing = timing
        return self.set

    def last_copy_ms(self) -> float | None:
        """Device time of the last snapshot's copies (waits for them);
        None on the CPU or before any snapshot."""
        if self._timing is None:
            return None
        self._timing[1].synchronize()
        return self._timing[0].elapsed_time(self._timing[1])

    def invalidate(self) -> None:
        self.set = None

    def snapshot(self) -> dict:
        return {
            "taken": self.taken,
            "failed": self.failed,
            "pos": self.set.pos if self.set is not None else None,
            "seqs": len(self.set.seqs) if self.set is not None else 0,
        }


# ---------------------------------------------------------------------------
# Payload codecs
# ---------------------------------------------------------------------------

def encode_payload(kind: str, payload: Any) -> dict:
    """JSON-safe encoding of a request payload: ``bnn`` payloads are
    image arrays, ``lm`` payloads ``(prompt, max_new)``."""
    if kind == "lm":
        prompt, max_new = payload
        return {"prompt": [int(t) for t in prompt], "max_new": int(max_new)}
    if kind == "bnn":
        arr = np.asarray(payload)
        return {"dtype": str(arr.dtype), "shape": list(arr.shape),
                "data": base64.b64encode(arr.tobytes()).decode("ascii")}
    raise ValueError(f"unknown journal payload kind: {kind!r}")


def decode_payload(kind: str, enc: dict) -> Any:
    if kind == "lm":
        return list(enc["prompt"]), int(enc["max_new"])
    if kind == "bnn":
        raw = base64.b64decode(enc["data"])
        return np.frombuffer(raw, dtype=np.dtype(enc["dtype"])) \
            .reshape(enc["shape"]).copy()
    raise ValueError(f"unknown journal payload kind: {kind!r}")


# ---------------------------------------------------------------------------
# Durable request journal
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class JournalState:
    """What a scan of a journal file found."""

    records: list
    unresolved: dict[int, dict]     # jid -> submit record
    max_jid: int
    torn_tail: bool = False


class RequestJournal:
    """Append-only JSONL write-ahead log of request lifecycles::

        {"op": "submit",  "jid": N, "kind": "bnn"|"lm", "payload": {...}}
        {"op": "resolve", "jid": N, "outcome": "served"|...}

    Every append is flushed and fsynced before it returns, so a crash at
    any instant leaves either no trace (the caller never got a request
    back) or a journaled submit that :func:`replay_journal` resubmits.
    Reopening a journal continues ``jid`` past the highest on disk."""

    def __init__(self, path: str | os.PathLike):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        state = self.scan(self.path)
        self._next_jid = state.max_jid + 1
        self._f = open(self.path, "a", encoding="utf-8")

    # ---- appends ----------------------------------------------------------
    def _append(self, rec: dict) -> None:
        self._f.write(json.dumps(rec, separators=(",", ":")) + "\n")
        self._f.flush()
        os.fsync(self._f.fileno())

    def submit(self, kind: str, payload: Any) -> int:
        """Journal one accepted submission; returns its ``jid``."""
        jid = self._next_jid
        self._next_jid += 1
        self._append({"op": "submit", "jid": jid, "kind": kind,
                      "payload": encode_payload(kind, payload)})
        return jid

    def resolve(self, jid: int, outcome: str,
                error: str | None = None) -> None:
        rec = {"op": "resolve", "jid": jid, "outcome": outcome}
        if error is not None:
            rec["error"] = str(error)
        self._append(rec)

    def close(self) -> None:
        self._f.close()

    # ---- recovery scan ----------------------------------------------------
    @staticmethod
    def scan(path: str | os.PathLike) -> JournalState:
        """Parse a journal, tolerating a torn tail: a kill mid-append
        leaves at most one half-written last line, which is dropped.  A
        corrupt line earlier stops the scan there too (every record past
        it is unordered with respect to it)."""
        path = Path(path)
        records: list[dict] = []
        torn = False
        if path.exists():
            with open(path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        records.append(json.loads(line))
                    except json.JSONDecodeError:
                        torn = True
                        break
        unresolved: dict[int, dict] = {}
        max_jid = -1
        for rec in records:
            jid = int(rec.get("jid", -1))
            max_jid = max(max_jid, jid)
            if rec.get("op") == "submit":
                unresolved[jid] = rec
            elif rec.get("op") == "resolve":
                unresolved.pop(jid, None)
        return JournalState(records=records, unresolved=unresolved,
                            max_jid=max_jid, torn_tail=torn)


def replay_journal(server, journal: RequestJournal | str | os.PathLike,
                   kind: str | None = None) -> list:
    """Resubmit every journaled but unresolved request to ``server``.

    ``server`` is an :class:`~repro_torch.serving.server.InferenceServer`
    (``bnn`` records) or an :class:`~repro_torch.serving.lm_server.
    LMServer` (``lm`` records); records of the other kind are skipped.
    Each resubmit passes the original ``jid``, so the server attaches the
    journaled identity instead of journaling a second submit, and the
    resolve closes the original record.  Deadlines are not replayed."""
    path = journal.path if isinstance(journal, RequestJournal) else journal
    state = RequestJournal.scan(path)
    if kind is None:
        kind = "lm" if hasattr(server, "manager") else "bnn"
    replayed = []
    for jid in sorted(state.unresolved):
        rec = state.unresolved[jid]
        if rec.get("kind") != kind:
            continue
        payload = decode_payload(kind, rec["payload"])
        if kind == "lm":
            prompt, max_new = payload
            r = server.submit(prompt, max_new=max_new, jid=jid)
        else:
            r = server.submit(payload, jid=jid)
        replayed.append(r)
    return replayed
