"""Executor: slot-based batching over the latent ring with a multi-token
decode window (port of the synchronous ring path of
``repro.serving.engine``).

One window runs ``sync_every`` decode steps with the loop state
(last token, cur, active mask, ingest buffer, budgets) held as device
tensors: feed -> ``decode_step`` -> sample -> termination, with no host
round trip inside.  The host is touched once per window: harvest emitted
tokens, retire finished slots, refill prompt-ingest buffers, and run
admission (one shape-bucketed wave prefill).

Chunked prefill rides the same loop: a long prompt's first
``prefill_chunk`` tokens go through the wave prefill; the rest is fed
through decode steps (ring writes at the token's true position, sampled
outputs discarded until the final prompt token).

Not ported yet (see ROADMAP.md): overlapped / continuous serving, the
paged pool, speculative decoding, meshes.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.serving import sampler as S
from repro_torch.serving.policy import AdmissionPolicy
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["Engine", "Request", "SamplingParams"]


def _merge_slot(pool_cache: list, new_cache: list, slots: torch.Tensor) -> list:
    """Copy the leading ``len(slots)`` batch rows of ``new_cache`` into
    ``pool_cache`` at ``slots``, in place (the prefill wave may be padded
    past that for shape bucketing; the pad rows are dropped here)."""
    n = slots.shape[0]
    for pool, new in zip(pool_cache, new_cache):
        for name, leaf in pool["self"].items():
            leaf[slots] = new["self"][name][:n].to(leaf.dtype)
    return pool_cache


def _bucket(n: int, cap: int) -> int:
    """Round up to a power of two, capped: the (wave, prompt-len) shapes a
    long-running engine sees collapse to O(log) values."""
    return min(max(1, 1 << (n - 1).bit_length()), max(cap, n))


class Engine:
    """Slot-based batching executor over the float latent ring.

    ``sync_every`` sets the decode window (tokens per host round trip);
    ``prefill_chunk`` bounds how much prompt one admission wave prefills
    at once.  ``device`` defaults to ``cuda``; ``params`` must already
    live there (see ``models.weights``)."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int,
                 max_len: int, backend: str | None = None,
                 sampling: SamplingParams | None = None,
                 sync_every: int = 8, prefill_chunk: int | None = None,
                 policy: str | AdmissionPolicy | None = None, device=None):
        if backend is not None:
            cfg = dataclasses.replace(cfg, attn_backend=backend)
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.cfg = cfg
        self.params = params
        self.B, self.max_len = max_slots, max_len
        self.sampling = sampling or S.GREEDY
        self.sync_every = sync_every
        self.scheduler = Scheduler(max_slots, max_len,
                                   prefill_chunk=prefill_chunk, policy=policy)
        self.policy = self.scheduler.policy
        self.cache = T.init_decode_cache(cfg, max_slots, max_len, self.device)
        self.finished: list[Request] = []
        # per-slot host mirror of the window's loop state (synced once per
        # window); the cache itself never leaves the device
        W = prefill_chunk or 1
        self._st: dict[str, np.ndarray] = {
            "tok": np.zeros(max_slots, np.int64),
            "cur": np.zeros(max_slots, np.int64),
            "act": np.zeros(max_slots, bool),
            "eos": np.full(max_slots, -1, np.int64),
            "left": np.zeros(max_slots, np.int64),
            "buf": np.zeros((max_slots, W), np.int64),
            "avail": np.zeros(max_slots, np.int64),
            "bpos": np.zeros(max_slots, np.int64),
            "more": np.zeros(max_slots, bool),
        }
        # per-slot sampling policy and generator (host objects)
        self._slot_sp: list[SamplingParams | None] = [None] * max_slots
        self._slot_gen: list[torch.Generator | None] = [None] * max_slots
        self.host_syncs = 0          # device->host sync points
        self.admission_syncs = 0     # host_syncs spent on wave prefills
        self.windows = 0             # completed (harvested) windows
        self.tokens_emitted = 0      # emitted by decode windows
        self._admit_tokens = 0       # first tokens emitted at admission
        self._occupancy_sum = 0
        self._queue_depth_sum = 0
        self._act_iters = 0          # sum of per-step stepping slots
        self._run_seconds = 0.0
        self._ttft_sum = 0.0
        self._ttft_n = 0
        self.prefill_calls = 0

    @classmethod
    def from_artifact(cls, path: str, *, max_slots: int, max_len: int,
                      device=None, **kw) -> "Engine":
        """Boot an engine from a compression artifact the JAX package
        saved (other keywords as on the constructor)."""
        from repro_torch.api import load_artifact

        art = load_artifact(path, device=device)
        return cls(art.cfg, art.params, max_slots=max_slots, max_len=max_len,
                   device=device, **kw)

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> Request:
        return self.scheduler.submit(req)

    def _record_token(self, req: Request, tok: int):
        req.out_tokens.append(tok)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
            if req.submitted_at is not None:
                self._ttft_sum += req.first_token_at - req.submitted_at
                self._ttft_n += 1
        if req.on_token is not None:
            req.on_token(req, tok)

    def _finish(self, slot: int):
        self.finished.append(self.scheduler.slot_req[slot])
        self.scheduler.release(slot)
        st = self._st
        st["act"][slot] = False
        st["avail"][slot] = 0
        st["bpos"][slot] = 0
        st["more"][slot] = False
        st["left"][slot] = 0
        self._slot_sp[slot] = self._slot_gen[slot] = None

    def _bucket_prompts(self, reqs, first_lens):
        """Pack a wave's first chunks into one power-of-two (rows,
        prompt-len) bucket (the JAX engine's row cap, twice the slots)."""
        W = _bucket(len(reqs), 2 * self.B)
        P = _bucket(max(first_lens), self.max_len)
        toks = np.zeros((W, P), np.int64)
        lens = np.zeros((W,), np.int64)
        for i, r in enumerate(reqs):
            toks[i, : first_lens[i]] = r.prompt[: first_lens[i]]
            lens[i] = first_lens[i]
        return toks, lens

    def _admit(self):
        """Synchronous admission: one wave prefill, the first token of every
        fully prefilled prompt sampled and emitted (one host sync), then
        the slots' mirror state."""
        wave = self.scheduler.take_wave()
        if not wave:
            return
        reqs = [r for _, r in wave]
        first_lens = [self.scheduler.first_chunk_len(r) for r in reqs]
        toks, lens = self._bucket_prompts(reqs, first_lens)
        dev = self.device
        self.prefill_calls += 1
        logits, new_cache = T.prefill(self.cfg, self.params,
                                      torch.as_tensor(toks, device=dev),
                                      torch.as_tensor(lens, device=dev),
                                      self.max_len)
        slots = torch.as_tensor([s for s, _ in wave], device=dev)
        _merge_slot(self.cache, new_cache, slots)
        specs, gens, full = [], [], []
        for (slot, r), fl in zip(wave, first_lens):
            sp = r.sampling or self.sampling
            gen = sp.slot_generator(r.uid, dev)
            self._slot_sp[slot], self._slot_gen[slot] = sp, gen
            full.append(fl == len(r.prompt))
            specs.append(sp if full[-1] else None)   # chunked: no draw yet
            gens.append(gen)
        first = S.sample_tokens(logits[: len(wave)], specs, gens).cpu().numpy()
        self.host_syncs += 1
        self.admission_syncs += 1
        st = self._st
        for i, (slot, r) in enumerate(wave):
            self._admit_bookkeep(slot, r, first_lens[i])
            if full[i]:
                st["tok"][slot] = first[i]
                self._admit_tokens += 1
                self._record_token(r, int(first[i]))
                if r.done:
                    self._finish(slot)

    def _admit_bookkeep(self, slot: int, r: Request, first_len: int):
        st = self._st
        st["cur"][slot] = first_len
        st["eos"][slot] = -1 if r.eos_id is None else r.eos_id
        st["bpos"][slot] = 0
        st["act"][slot] = True
        rest = r.prompt[first_len:]
        st["tok"][slot] = 0
        if rest.size == 0:
            st["left"][slot] = r.max_new_tokens - 1
            st["avail"][slot] = 0
            st["more"][slot] = False
        else:
            # chunked prefill: stream the remainder through the ingest buffer
            self.scheduler.set_pending(slot, rest)
            self._load_chunk(slot)
            st["left"][slot] = r.max_new_tokens

    def _load_chunk(self, slot: int):
        chunk = self.scheduler.next_chunk(slot)
        st = self._st
        w = chunk.shape[0]
        st["buf"][slot, :w] = chunk
        st["avail"][slot] = w
        st["bpos"][slot] = 0
        st["more"][slot] = self.scheduler.pending_len(slot) > 0

    def _refill(self):
        st = self._st
        for slot, r in enumerate(self.scheduler.slot_req):
            if (r is not None and st["act"][slot]
                    and st["bpos"][slot] >= st["avail"][slot]
                    and self.scheduler.pending_len(slot) > 0):
                self._load_chunk(slot)

    # -- decode window -------------------------------------------------------

    def _window(self, st: dict[str, torch.Tensor]):
        """``sync_every`` decode steps on device state.  Per step and slot:
        pick the fed token (ingest buffer while prompt remains, else the
        last sampled one), one batched decode_step (inactive and stalled
        rows write nothing), sample, update emit / termination flags.
        Sampled slots draw from their generators every step of the window;
        greedy slots never draw."""
        cfg, W = self.cfg, st["buf"].shape[1]
        specs = [sp if (a and sp is not None and not sp.greedy) else None
                 for sp, a in zip(self._slot_sp, self._st["act"])]
        toks, emits, n_act = [], [], []
        for _ in range(self.sync_every):
            feeding = st["bpos"] < st["avail"]
            buf_tok = st["buf"].gather(1, st["bpos"].clamp(max=W - 1)[:, None])[:, 0]
            tok_in = torch.where(feeding, buf_tok, st["tok"])
            # a slot whose ingest buffer drained but has prompt left on the
            # host stalls (no step) until the next refill
            stalled = st["more"] & ~feeding
            stepping = st["act"] & ~stalled
            logits, self.cache = T.decode_step(cfg, self.params, self.cache,
                                               tok_in, st["cur"], stepping)
            sampled = S.sample_tokens(logits, specs, self._slot_gen)
            last_prompt = feeding & ~st["more"] & (st["bpos"] + 1 >= st["avail"])
            emit = stepping & (~feeding | last_prompt)
            cur2 = st["cur"] + stepping.to(st["cur"].dtype)
            left2 = st["left"] - emit.to(st["left"].dtype)
            # ring-cap stop: cur2 == max_len means this step wrote the last
            # ring position — the NEXT write would wrap and evict position
            # 0.  (Not max_len - 1: that fired one step early on the ingest
            # path, costing cap-length chunked prompts their final token.)
            done = ((emit & ((sampled == st["eos"]) | (left2 <= 0)))
                    | (stepping & (cur2 >= self.max_len)))
            st = {**st,
                  "tok": torch.where(emit, sampled, st["tok"]),
                  "cur": cur2,
                  "act": st["act"] & ~done,
                  "bpos": st["bpos"] + feeding.to(st["bpos"].dtype),
                  "left": left2}
            toks.append(sampled)
            emits.append(emit)
            n_act.append(stepping.sum())
        return st, torch.stack(toks), torch.stack(emits), torch.stack(n_act)

    def step(self):
        """Admit + refill, then run one ``sync_every``-token decode window
        and harvest it (the step's single host sync).  Idle calls (nothing
        active, nothing admitted) accrue no wall-clock."""
        t0 = time.perf_counter()
        self._admit()
        self._refill()
        if not self._st["act"].any():
            return
        occ, qd = self.scheduler.occupancy, self.scheduler.queue_depth
        state = {k: torch.as_tensor(v, device=self.device)
                 for k, v in self._st.items()}
        state, toks, emits, n_act = self._window(state)
        self._harvest(state, toks, emits, occ, qd, n_act)
        self._run_seconds += time.perf_counter() - t0

    def _harvest(self, state, toks, emits, occ: int, qd: int, n_act):
        toks = toks.cpu().numpy()                   # (K, B)
        emits = emits.cpu().numpy()
        self._st = {k: v.cpu().numpy() for k, v in state.items()}
        self.host_syncs += 1
        self.windows += 1
        self.tokens_emitted += int(emits.sum())
        self._occupancy_sum += occ
        self._queue_depth_sum += qd
        self._act_iters += int(n_act.sum())
        slot_req = self.scheduler.slot_req
        for k in range(toks.shape[0]):
            for i in np.nonzero(emits[k])[0]:
                self._record_token(slot_req[i], int(toks[k, i]))
        for slot, r in enumerate(slot_req):
            if r is not None and not self._st["act"][slot]:
                self._finish(slot)

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until drained or ``max_steps`` completed windows.  A stuck
        load (a request that can never admit) exits via the idle guard."""
        idle = 0
        while self.scheduler.has_work:
            if self.windows >= max_steps:
                break
            before = (self.windows, self.host_syncs)
            self.step()
            idle = 0 if (self.windows, self.host_syncs) != before else idle + 1
            if idle > self.B + 2:
                break
        if self.scheduler.has_work:
            warnings.warn(
                f"Engine.run stopped after {self.windows} completed windows "
                f"(max_steps={max_steps}) with {self.scheduler.queue_depth} "
                f"queued and {self.scheduler.occupancy} in-flight requests "
                f"unfinished (not a drain)", RuntimeWarning, stacklevel=2)
        return self.finished

    # -- metrics -------------------------------------------------------------

    def metrics(self) -> dict[str, Any]:
        """Serving counters since construction (host_syncs counts one per
        window harvest plus one per admission wave)."""
        tokens = self.tokens_emitted + self._admit_tokens
        w = max(self.windows, 1)
        return {
            "tokens": tokens,
            "windows": self.windows,
            "sync_every": self.sync_every,
            "cache_layout": "ring",
            "backend": self.cfg.attn_backend,
            "device": str(self.device),
            "host_syncs": self.host_syncs,
            "admission_syncs": self.admission_syncs,
            "host_syncs_per_token": self.host_syncs / max(tokens, 1),
            "decode_syncs_per_token":
                self.windows / max(tokens - self._admit_tokens, 1),
            "occupancy": self.scheduler.occupancy,
            "queue_depth": self.scheduler.queue_depth,
            "occupancy_mean": self._occupancy_sum / w,
            "queue_depth_mean": self._queue_depth_sum / w,
            "occupancy_device_mean": self._act_iters / (w * self.sync_every),
            "policy": self.policy.name,
            "prefill_calls": self.prefill_calls,
            "ttft_s": self._ttft_sum / self._ttft_n if self._ttft_n else 0.0,
            "run_seconds": self._run_seconds,
            "tokens_per_s": (tokens / self._run_seconds
                             if self._run_seconds else 0.0),
        }
