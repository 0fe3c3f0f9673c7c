"""Admission and slot lifecycle for the serving engine (port of the ring
path of ``repro.serving.scheduler``).

The scheduler owns everything about requests that is not model math: the
queue, the slot -> request map, per-slot un-ingested prompt remainders
(chunked prefill) and submit-time validation.  A prompt longer than
``prefill_chunk`` is admitted in pieces: the first chunk goes through the
wave prefill, the rest streams through the decode loop's ingest buffer.
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
                 policy: str | AdmissionPolicy | None = None):
        if prefill_chunk is not None and prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.max_slots = max_slots
        self.max_len = max_len
        self.prefill_chunk = prefill_chunk
        self.policy = get_policy(policy)
        self.queue: deque[Request] = deque()
        self.slot_req: list[Request | None] = [None] * max_slots
        self._pending: list[np.ndarray | None] = [None] * max_slots
        self.admitted_uids: list[int] = []

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

    def take_wave(self, fits=None) -> list[tuple[int, Request]]:
        """Admit queued requests into free slots in policy order."""
        wave = []
        free = self.free_slots()
        for req in self.policy.select(self.queue, len(free), fits):
            slot = free.pop(0)
            self.slot_req[slot] = req
            self.admitted_uids.append(req.uid)
            wave.append((slot, req))
        return wave

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
        width = self.prefill_chunk or 1
        chunk, rest = p[:width], p[width:]
        self._pending[slot] = rest if rest.size else None
        return chunk

    def release(self, slot: int):
        self.slot_req[slot] = None
        self._pending[slot] = None

    @property
    def queue_depth(self) -> int:
        return len(self.queue)

    @property
    def occupancy(self) -> int:
        return sum(r is not None for r in self.slot_req)

    @property
    def has_work(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.slot_req)
