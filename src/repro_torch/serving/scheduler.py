"""Admission and slot lifecycle for the serving engine (port of
``repro.serving.scheduler``).

The scheduler owns everything about requests that is not model math: the
queue, the slot -> request map, per-slot un-ingested prompt remainders
(chunked prefill) and submit-time validation.  A prompt longer than
``prefill_chunk`` is admitted in pieces: the first chunk goes through the
wave prefill, the rest streams through the decode loop's ingest buffer.
Preempted requests (lazy page reservation ran the pool dry) wait in
``parked`` until the engine re-seats them with ``place``.  The overlapped
engine stages admissions: ``take_staged`` pops queued requests for an
off-path prefill, ``place_wave`` binds them to free slots later, in the
order they were staged.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Callable

import numpy as np

from repro_torch.serving.policy import AdmissionPolicy, get_policy
from repro_torch.serving.sampler import SamplingParams


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                    # (P,) int
    max_new_tokens: int = 32
    eos_id: int | None = None
    sampling: SamplingParams | None = None  # None -> engine default
    truncate: bool = False                # allow prompt truncation at submit
    truncated: bool = False               # set when truncation happened
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    on_token: Callable | None = None      # called once per token as (req, tok)
    submitted_at: float | None = None     # perf_counter stamps for ttft
    first_token_at: float | None = None

    @property
    def done(self) -> bool:
        if len(self.out_tokens) >= self.max_new_tokens:
            return True
        return bool(self.out_tokens) and self.out_tokens[-1] == self.eos_id


class Scheduler:
    """Policy-driven admission, slot lifecycle, chunked-prefill state."""

    def __init__(self, max_slots: int, max_len: int,
                 prefill_chunk: int | None = None,
                 policy: str | AdmissionPolicy | None = None, slot_shards: int = 1):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if slot_shards < 1 or max_slots % slot_shards:
            raise ValueError(
                f"slot_shards={slot_shards} must divide max_slots="
                f"{max_slots} (each addressable shard owns whole slots)")
        self.max_slots = max_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        # On a mesh the slots [k * max_slots / slot_shards, (k + 1) * ...)
        # live on "data" rank k: a wave is packed into as few of these
        # groups as it can be (``_wave_slot_order``).
        self.slot_shards = slot_shards
        self.policy = get_policy(policy)
        self.queue: deque[Request] = deque()
        self.slot_req: list[Request | None] = [None] * max_slots
        self._pending: list[np.ndarray | None] = [None] * max_slots
        self.admitted_uids: list[int] = []    # admission order
        # preempted requests awaiting re-admission: waiting work that the
        # engine re-seats through ``place``, not through the queue
        self.parked: list[Request] = []
        # popped off the queue for a staged prefill, not yet in a slot;
        # ``place`` consumes them strictly in this order (with slot groups,
        # in this order within each group: a continuous engine on a mesh
        # stages into groups and each group installs its own)
        self.staged: deque[Request] = deque()

    def submit(self, req: Request) -> Request:
        """Validate and enqueue.  Prompts are capped at ``max_len - 1`` (the
        ring needs one free position to generate): longer ones raise, or
        keep their last max_len - 1 tokens when ``req.truncate`` is set."""
        if req.max_new_tokens < 1:
            raise ValueError(
                f"request uid={req.uid}: max_new_tokens={req.max_new_tokens} "
                f"must be >= 1 (admission emits the first generated token "
                f"unconditionally)")
        prompt = np.asarray(req.prompt, np.int64).reshape(-1)
        cap = self.max_len - 1
        if prompt.shape[0] > cap:
            if not req.truncate:
                raise ValueError(
                    f"request uid={req.uid}: prompt length {prompt.shape[0]} "
                    f"exceeds the engine's max_len - 1 = {cap}; shorten the "
                    f"prompt, raise max_len, or set Request.truncate=True to "
                    f"keep the last {cap} tokens")
            prompt = prompt[-cap:]
            req.truncated = True
        if prompt.shape[0] == 0:
            raise ValueError(f"request uid={req.uid}: empty prompt")
        req.prompt = prompt
        if req.submitted_at is None:
            req.submitted_at = time.perf_counter()
        self.queue.append(req)
        return req

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _wave_slot_order(self, want: int) -> list[int]:
        """Free slots ordered for a wave of ``want`` requests, slot-group
        aware: the tightest single group that fits the whole wave (best
        fit, so emptier groups stay whole for bigger waves), else fullest
        first so the wave spans the fewest groups."""
        free = self.free_slots()
        if self.slot_shards == 1 or not free:
            return free
        per = self.max_slots // self.slot_shards
        groups: dict[int, list[int]] = {}
        for s in free:
            groups.setdefault(s // per, []).append(s)
        by_size = sorted(groups.values(), key=lambda g: (len(g), g[0]))
        fit = next((g for g in by_size if len(g) >= want), None)
        if fit is not None:
            rest = [g for g in by_size if g is not fit]
            return fit + [s for g in rest for s in g]
        by_size.sort(key=lambda g: (-len(g), g[0]))
        return [s for g in by_size for s in g]

    def take_wave(self, fits=None) -> list[tuple[int, Request]]:
        """Admit queued requests into free slots in policy order (slot
        choice by ``_wave_slot_order``)."""
        wave = []
        free = self._wave_slot_order(min(len(self.free_slots()), len(self.queue)))
        for req in self.policy.select(self.queue, len(free), fits):
            slot = free.pop(0)
            self.slot_req[slot] = req
            self.admitted_uids.append(req.uid)
            wave.append((slot, req))
        return wave

    def take_staged(self, max_n: int, fits=None) -> list[Request]:
        """Pop up to ``max_n`` queued requests (policy order) into
        ``staged``, the overlapped engine's prefill-ahead set."""
        out = self.policy.select(self.queue, max_n, fits)
        self.staged.extend(out)
        return out

    def place(self, slot: int, req: Request):
        """Bind a staged request (the head of ``staged``; with slot groups
        any staged one, since each group installs its own) or a parked
        (preempted) one to a free slot."""
        if self.slot_req[slot] is not None:
            raise RuntimeError(f"slot {slot} is occupied by uid="
                               f"{self.slot_req[slot].uid}; release it first")
        for i, p in enumerate(self.parked):
            if p is req:                  # identity, not __eq__ (arrays)
                self.parked.pop(i)
                break
        else:
            at = next((i for i, p in enumerate(self.staged) if p is req), None)
            if at is None or (at > 0 and self.slot_shards == 1):
                raise RuntimeError(
                    f"place(uid={req.uid}): neither parked nor the head of the "
                    f"staged queue (head uid="
                    f"{self.staged[0].uid if self.staged else None})")
            del self.staged[at]
        self.slot_req[slot] = req
        self.admitted_uids.append(req.uid)

    def place_wave(self, reqs: list[Request]) -> list[tuple[int, Request]]:
        """Bind a run of staged requests to the lowest free slots."""
        free = self.free_slots()
        placed = []
        for req in reqs:
            slot = free.pop(0)
            self.place(slot, req)
            placed.append((slot, req))
        return placed

    def first_chunk_len(self, req: Request) -> int:
        """Prompt tokens the admission wave prefill covers for ``req``."""
        if self.prefill_chunk is None:
            return len(req.prompt)
        return min(len(req.prompt), self.prefill_chunk)

    def set_pending(self, slot: int, rest: np.ndarray):
        self._pending[slot] = rest if rest.size else None

    def pending_len(self, slot: int) -> int:
        p = self._pending[slot]
        return 0 if p is None else int(p.shape[0])

    def next_chunk(self, slot: int) -> np.ndarray:
        """Pop the next <= prefill_chunk pending prompt tokens of a slot."""
        p = self._pending[slot]
        if p is None:
            return np.zeros((0,), np.int64)
        chunk, rest = self.split_chunk(p)
        self._pending[slot] = rest if rest.size else None
        return chunk

    def split_chunk(self, p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(the next <= prefill_chunk tokens of ``p``, the rest)."""
        width = self.prefill_chunk or 1
        return p[:width], p[width:]

    def release(self, slot: int):
        self.slot_req[slot] = None
        self._pending[slot] = None

    def preempt(self, slot: int) -> tuple[Request, np.ndarray]:
        """Evict a running slot's request into ``parked``.  Returns the
        request and its un-ingested prompt tail, for the engine's
        re-admission record."""
        req = self.slot_req[slot]
        if req is None:
            raise RuntimeError(f"preempt({slot}): slot is empty")
        pending = self._pending[slot]
        self.release(slot)
        self.parked.append(req)
        return req, (pending if pending is not None
                     else np.zeros((0,), np.int64))

    @property
    def queue_depth(self) -> int:
        """Requests waiting for a slot: queued, staged or parked."""
        return len(self.queue) + len(self.staged) + len(self.parked)

    @property
    def occupancy(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @property
    def has_work(self) -> bool:
        return (bool(self.queue) or bool(self.staged) or bool(self.parked)
                or any(r is not None for r in self.slot_req))
