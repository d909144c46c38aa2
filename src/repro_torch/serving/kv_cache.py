"""KV-cache slot manager for continuous-batching LM decode.

Counterpart of ``repro.serving.kv_cache`` (plain Python): the decode step
runs on a fixed (n_slots, max_seq) cache on the card; this host-side
object owns the slot lifecycle — admit a sequence into a free slot, track
its length, release it on EOS, ``max_new`` or a full slot.  Slots are
whole sequences (page granularity 1).  Each sequence keeps its prompt, so
a sequence evacuated from one server can be replay-prefilled on another
(``LMServer.adopt_sequence``), and :meth:`KVCacheManager.adopt` admits a
sequence that has generated tokens already.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Sequence:
    seq_id: int
    slot: int
    length: int
    max_new: int
    generated: int = 0
    tokens: list = dataclasses.field(default_factory=list)
    # Kept for a replay prefill on another server (migration); an
    # in-place restore needs no prompt: the KV pages carry it.
    prompt: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class KVCacheManager:
    n_slots: int
    max_seq: int

    def __post_init__(self):
        self._free = list(range(self.n_slots - 1, -1, -1))
        self.active: dict[int, Sequence] = {}
        self._next_id = 0

    def can_admit(self) -> bool:
        return bool(self._free)

    def admit(self, prompt_len: int, max_new: int,
              prompt: list | None = None) -> Sequence:
        if not self._free:
            raise RuntimeError("no free KV slots")
        if prompt_len + max_new > self.max_seq:
            raise ValueError(f"sequence too long: {prompt_len} + {max_new} "
                             f"> max_seq {self.max_seq}")
        slot = self._free.pop()
        seq = Sequence(self._next_id, slot, prompt_len, max_new,
                       prompt=list(prompt) if prompt is not None else [])
        self._next_id += 1
        self.active[seq.seq_id] = seq
        return seq

    def adopt(self, length: int, max_new: int, generated: int,
              tokens: list, prompt: list | None = None) -> Sequence:
        """Admit a sequence that has generated tokens already (on this
        server or another) into a free slot; the caller rebuilds the
        slot's KV pages (a replay prefill for a migration)."""
        if not self._free:
            raise RuntimeError("no free KV slots")
        if length + (max_new - generated) > self.max_seq:
            raise ValueError(f"sequence too long: {length} + "
                             f"{max_new - generated} > max_seq "
                             f"{self.max_seq}")
        if not (0 < generated <= max_new and len(tokens) == generated):
            raise ValueError(f"adopted sequence has {len(tokens)} tokens, "
                             f"generated {generated} of {max_new}")
        slot = self._free.pop()
        seq = Sequence(self._next_id, slot, length, max_new,
                       generated=generated, tokens=list(tokens),
                       prompt=list(prompt) if prompt is not None else [])
        self._next_id += 1
        self.active[seq.seq_id] = seq
        return seq

    def record_token(self, seq_id: int, token: int,
                     eos_id: int | None = None) -> bool:
        """Append one generated token; returns True if the seq finished."""
        seq = self.active[seq_id]
        seq.tokens.append(token)
        seq.length += 1
        seq.generated += 1
        done = (seq.generated >= seq.max_new
                or (eos_id is not None and token == eos_id)
                or seq.length >= self.max_seq)
        if done:
            self.release(seq_id)
        return done

    def release(self, seq_id: int) -> None:
        seq = self.active.pop(seq_id)
        self._free.append(seq.slot)

    @property
    def utilization(self) -> float:
        return 1.0 - len(self._free) / self.n_slots

    def active_slots(self) -> list[int]:
        return [s.slot for s in self.active.values()]
