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

Sampling keys: each slot carries a (2,) threefry key, split once per step
and advanced only where the slot emitted (admission samples the first
token with the same split), so a request's sampled stream is the JAX
engine's and does not depend on ``sync_every`` or ``prefill_chunk``.

Speculative decoding (``spec_depth > 0``): each window iteration proposes
``spec_depth`` tokens (prompt lookup over the fed-token history, or greedy
steps of the target's first K layers with their own ring), scores them in
ONE ``verify_step``, and walks the positions in order: a proposal is
accepted iff it equals the token the slot's sampler draws there with its
next key split; the first mismatch emits that draw.  Only the accepted
prefix is committed to the ring, so streams are invariant to
``spec_depth``.  The ring may be float or int8 (``cache_quant_bits``).

Not ported yet (see ROADMAP.md): overlapped / continuous serving, the
paged pool, adaptive speculation depth, meshes.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models import kv_cache as KC
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.serving import draft as D
from repro_torch.serving import sampler as S
from repro_torch.serving.draft import DraftSpec
from repro_torch.serving.policy import AdmissionPolicy
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler

__all__ = ["DraftSpec", "Engine", "Request", "SamplingParams"]


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
    """Slot-based batching executor over the latent ring (float or int8).

    ``sync_every`` sets the decode window (iterations per host round
    trip); ``prefill_chunk`` bounds how much prompt one admission wave
    prefills at once.  ``spec_depth`` turns on speculative decoding, up to
    that many draft tokens verified per iteration; ``draft`` picks the
    proposer, "ngram" (default) or "layers:K".  ``device`` defaults to
    ``cuda``; ``params`` must already live there (see ``models.weights``)."""

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int,
                 max_len: int, backend: str | None = None,
                 sampling: SamplingParams | None = None,
                 sync_every: int = 8, prefill_chunk: int | None = None,
                 policy: str | AdmissionPolicy | None = None,
                 spec_depth: int = 0, draft: str | DraftSpec | None = None,
                 device=None):
        if backend is not None:
            cfg = dataclasses.replace(cfg, attn_backend=backend)
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if spec_depth < 0:
            raise ValueError("spec_depth must be >= 0")
        parsed_draft = DraftSpec.parse(draft)
        if parsed_draft is not None and spec_depth == 0:
            raise ValueError(
                f"draft={draft!r} requires spec_depth > 0 — a draft with "
                f"no speculation depth would be silently ignored")
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
        self.spec_depth = spec_depth
        self.draft = (parsed_draft or DraftSpec("ngram")) if spec_depth else None
        # Layer draft: a view over the target's first K layers (no new
        # weights) with its own, much smaller, ring cache.
        self.draft_cfg = self.draft_params = self.draft_cache = None
        if self.draft is not None and self.draft.kind == "layers":
            self.draft_cfg, self.draft_params = D.make_layer_draft(
                cfg, params, self.draft.layers)
            self.draft_cache = T.init_decode_cache(self.draft_cfg, max_slots,
                                                   max_len, self.device)
        self.finished: list[Request] = []
        # per-slot host mirror of the window's loop state (synced once per
        # window); the cache itself never leaves the device
        W = prefill_chunk or 1
        self._st: dict[str, np.ndarray] = {
            "tok": np.zeros(max_slots, np.int64),
            "cur": np.zeros(max_slots, np.int64),
            "act": np.zeros(max_slots, bool),
            "keys": np.zeros((max_slots, 2), np.int64),
            "temp": np.zeros(max_slots, np.float32),
            "top_k": np.zeros(max_slots, np.int64),
            "top_p": np.ones(max_slots, np.float32),
            "eos": np.full(max_slots, -1, np.int64),
            "left": np.zeros(max_slots, np.int64),
            "buf": np.zeros((max_slots, W), np.int64),
            "avail": np.zeros(max_slots, np.int64),
            "bpos": np.zeros(max_slots, np.int64),
            "more": np.zeros(max_slots, bool),
        }
        if spec_depth:
            # fed-token history: the n-gram draft's corpus, seeded with the
            # whole prompt at admission and extended as tokens are fed
            self._st["hist"] = np.zeros((max_slots, max_len), np.int64)
        self.draft_proposed = 0      # draft tokens fed to verification
        self.draft_accepted = 0      # ... accepted (free extra tokens)
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
        """Synchronous admission: one wave prefill (and the layer draft's,
        so its ring tracks the target's), then the first token of every
        fully prefilled prompt sampled with the slot's first key split
        and emitted (one host sync), then the slots' mirror state."""
        wave = self.scheduler.take_wave()
        if not wave:
            return
        reqs = [r for _, r in wave]
        first_lens = [self.scheduler.first_chunk_len(r) for r in reqs]
        toks, lens = self._bucket_prompts(reqs, first_lens)
        dev = self.device
        self.prefill_calls += 1
        toks_t = torch.as_tensor(toks, device=dev)
        lens_t = torch.as_tensor(lens, device=dev)
        logits, new_cache = T.prefill(self.cfg, self.params, toks_t, lens_t,
                                      self.max_len)
        slots = torch.as_tensor([s for s, _ in wave], device=dev)
        _merge_slot(self.cache, new_cache, slots)
        if self.draft_cache is not None:
            _, dnew = T.prefill(self.draft_cfg, self.draft_params, toks_t,
                                lens_t, self.max_len)
            _merge_slot(self.draft_cache, dnew, slots)
        specs = [r.sampling or self.sampling for r in reqs]
        keys0 = np.stack([sp.slot_key(r.uid) for sp, r in zip(specs, reqs)])
        keys0 = keys0.astype(np.int64)
        ks = S.split_keys(torch.as_tensor(keys0, device=dev))
        first = S.sample_tokens(
            logits[:len(wave)],
            torch.tensor([sp.temperature for sp in specs], dtype=torch.float32,
                         device=dev),
            torch.tensor([sp.top_k for sp in specs], device=dev),
            torch.tensor([sp.top_p for sp in specs], dtype=torch.float32,
                         device=dev),
            ks[:, 1], any_sampled=not all(sp.greedy for sp in specs))
        first, ks = first.cpu().numpy(), ks.cpu().numpy()
        self.host_syncs += 1
        self.admission_syncs += 1
        st = self._st
        for i, (slot, r) in enumerate(wave):
            self._admit_bookkeep(slot, r, specs[i], first_lens[i])
            st["keys"][slot] = keys0[i]
            if first_lens[i] == len(r.prompt):
                # whole prompt prefilled: emit the first generated token
                # and advance the key, as the decode window would
                st["keys"][slot] = ks[i, 0]
                st["tok"][slot] = first[i]
                self._admit_tokens += 1
                self._record_token(r, int(first[i]))
                if r.done:
                    self._finish(slot)

    def _admit_bookkeep(self, slot: int, r: Request, sp: SamplingParams,
                        first_len: int):
        st = self._st
        st["cur"][slot] = first_len
        st["eos"][slot] = -1 if r.eos_id is None else r.eos_id
        st["temp"][slot] = sp.temperature
        st["top_k"][slot] = sp.top_k
        st["top_p"][slot] = sp.top_p
        st["bpos"][slot] = 0
        st["act"][slot] = True
        st["tok"][slot] = 0
        if "hist" in st:
            # the whole prompt is known at admission, even the part not
            # ingested yet: seed the n-gram corpus with it up front
            st["hist"][slot] = 0
            st["hist"][slot, : len(r.prompt)] = r.prompt
        rest = r.prompt[first_len:]
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

    def _sample(self, st, keys, logits, any_sampled: bool):
        """This step's token per row, with ``keys`` split once for the draw
        (greedy-only windows neither draw nor split: their keys are never
        read).  Returns (tokens, advanced keys)."""
        if not any_sampled:
            return logits.argmax(dim=-1), keys
        ks = S.split_keys(keys)
        tok = S.sample_tokens(logits, st["temp"], st["top_k"], st["top_p"],
                              ks[:, 1], any_sampled=True)
        return tok, ks[:, 0]

    def _feed(self, st):
        """(feeding, tok_in, stepping, last_prompt) for one iteration: the
        ingest buffer feeds while prompt remains, else the last sampled
        token; a slot whose buffer drained with prompt left on the host
        stalls (no step) until the next refill; ``last_prompt`` marks the
        final prompt token, whose sample is the first one emitted."""
        W = st["buf"].shape[1]
        feeding = st["bpos"] < st["avail"]
        buf_tok = st["buf"].gather(1, st["bpos"].clamp(max=W - 1)[:, None])[:, 0]
        tok_in = torch.where(feeding, buf_tok, st["tok"])
        stepping = st["act"] & ~(st["more"] & ~feeding)
        last_prompt = feeding & ~st["more"] & (st["bpos"] + 1 >= st["avail"])
        return feeding, tok_in, stepping, last_prompt

    def _window(self, st: dict[str, torch.Tensor], any_sampled: bool):
        """``sync_every`` decode steps on device state.  Per step and slot:
        pick the fed token, one batched decode_step (inactive and stalled
        rows write nothing), sample, update emit / termination flags; the
        key advances only where the slot emitted."""
        cfg = self.cfg
        toks, emits, n_act = [], [], []
        for _ in range(self.sync_every):
            feeding, tok_in, stepping, last_prompt = self._feed(st)
            logits, self.cache = T.decode_step(cfg, self.params, self.cache,
                                               tok_in, st["cur"], stepping)
            sampled, keys2 = self._sample(st, st["keys"], logits, any_sampled)
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
                  "keys": torch.where(emit[:, None], keys2, st["keys"]),
                  "bpos": st["bpos"] + feeding.to(st["bpos"].dtype),
                  "left": left2}
            toks.append(sampled[:, None])
            emits.append(emit[:, None])
            n_act.append(stepping.sum())
        return st, torch.stack(toks), torch.stack(emits), torch.stack(n_act), None

    def _propose(self, st, cur, tok_in, stepping, speculating, cap_ok):
        """(B, spec_depth) draft proposals.  The layer draft takes depth + 1
        greedy steps of its own stack (fed [tok_in, d1..d_depth]) so its
        ring also covers the bonus position on full acceptance."""
        depth = self.spec_depth
        if self.draft_cache is None:
            return D.ngram_propose(st["hist"], cur, tok_in, depth)
        props, d_tok, d_cur = [], tok_in, cur
        for j in range(depth + 1):
            act_j = stepping if j == 0 else speculating & cap_ok[:, j]
            dlogits, self.draft_cache = T.decode_step(
                self.draft_cfg, self.draft_params, self.draft_cache, d_tok,
                d_cur, act_j)
            d_cur = d_cur + act_j.to(d_cur.dtype)
            if j < depth:
                d_tok = dlogits.argmax(dim=-1)
                props.append(d_tok)
        return torch.stack(props, dim=1)

    def _spec_window(self, st: dict[str, torch.Tensor], any_sampled: bool):
        """``sync_every`` speculative rounds.  Per round and slot: propose,
        one S = spec_depth + 1 token verify_step, then walk the S positions
        in order — position j's draw (the slot's policy with its next key
        split) is the token sequential decoding would emit there, so a
        proposal is accepted iff it matches, and the first mismatch emits
        the draw and ends the round.  Only the accepted prefix is written
        to the ring and keys advance once per emitted token.  Ingesting
        slots keep one token per round: their columns >= 1 are never
        candidates."""
        cfg, S_pos = self.cfg, self.spec_depth + 1
        out = {"toks": [], "emits": [], "acc": [], "prop": [], "n_act": []}
        for _ in range(self.sync_every):
            feeding, tok_in, stepping, last_prompt = self._feed(st)
            speculating = stepping & ~feeding
            cur = st["cur"]
            js = torch.arange(S_pos, dtype=cur.dtype, device=cur.device)
            cap_ok = (cur[:, None] + js[None, :]) < self.max_len      # (B, S)
            props = self._propose(st, cur, tok_in, stepping, speculating, cap_ok)
            fed = torch.cat([tok_in[:, None], props], dim=1)
            cand = torch.cat([stepping[:, None],
                              speculating[:, None] & cap_ok[:, 1:]], dim=1)
            logits, updates = T.verify_step(cfg, self.params, self.cache, fed,
                                            cur, cand)
            keys, tok2 = st["keys"], st["tok"]
            done_any = torch.zeros_like(st["act"])
            nemit = torch.zeros_like(cur)
            valid, emits, toks = [], [], []
            for j in range(S_pos):
                if j == 0:
                    valid_j = stepping
                    emit_j = stepping & (~feeding | last_prompt)
                else:
                    valid_j = (emits[-1] & ~done_any & cand[:, j]
                               & (fed[:, j] == toks[-1]))
                    emit_j = valid_j
                s_j, keys2 = self._sample(st, keys, logits[:, j], any_sampled)
                nemit = nemit + emit_j.to(cur.dtype)
                done_j = ((emit_j & ((s_j == st["eos"]) | (st["left"] - nemit <= 0)))
                          | (valid_j & (cur + j + 1 >= self.max_len)))
                done_any = done_any | done_j
                keys = torch.where(emit_j[:, None], keys2, keys)
                tok2 = torch.where(emit_j, s_j, tok2)
                valid.append(valid_j)
                emits.append(emit_j)
                toks.append(s_j)
            valid = torch.stack(valid, dim=1)                          # (B, S)
            # commit the accepted prefix (rejected tokens never wrote)
            T.commit_verify_writes(self.cache, updates, cur, valid)
            if self.draft_cache is not None:
                # the draft wrote as it proposed: strike rejected columns
                # from its position index so they cannot shadow the slot
                for j in range(1, S_pos):
                    KC.invalidate_positions(self.draft_cache, cur + j,
                                            cand[:, j] & ~valid[:, j])
            hist = st["hist"]
            rows = torch.arange(hist.shape[0], device=hist.device)
            for j in range(S_pos):
                pos = (cur + j).clamp(max=hist.shape[1] - 1)
                hist[rows, pos] = torch.where(valid[:, j], fed[:, j],
                                              hist[rows, pos])
            st = {**st,
                  "tok": tok2,
                  "cur": cur + valid.to(cur.dtype).sum(dim=1),
                  "act": st["act"] & ~done_any,
                  "keys": keys,
                  "bpos": st["bpos"] + feeding.to(st["bpos"].dtype),
                  "left": st["left"] - nemit}
            out["toks"].append(torch.stack(toks, dim=1))
            out["emits"].append(torch.stack(emits, dim=1))
            out["acc"].append(valid[:, 1:].sum())
            # count only real proposals: the n-gram draft pads unknown
            # positions with -1 (certain rejects)
            out["prop"].append((cand[:, 1:] & (fed[:, 1:] >= 0)).sum())
            out["n_act"].append(stepping.sum())
        return (st, torch.stack(out["toks"]), torch.stack(out["emits"]),
                torch.stack(out["n_act"]),
                torch.stack([torch.stack(out["acc"]), torch.stack(out["prop"])]))

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
        any_sampled = bool((self._st["act"]
                            & (self._st["temp"] >= S._TEMP_EPS)).any())
        state = {k: torch.as_tensor(v, device=self.device)
                 for k, v in self._st.items()}
        window = self._spec_window if self.spec_depth else self._window
        self._harvest(*window(state, any_sampled), occ, qd)
        self._run_seconds += time.perf_counter() - t0

    def _harvest(self, state, toks, emits, n_act, spec, occ: int, qd: int):
        """The window's one host sync: mirror state, counters, emitted
        tokens (toks / emits are (K, B, S) with S = spec_depth + 1; spec
        holds the window's accepted / proposed draft counts, or None)."""
        toks = toks.cpu().numpy()
        emits = emits.cpu().numpy()
        self._st = {k: v.cpu().numpy() for k, v in state.items()}
        self.host_syncs += 1
        self.windows += 1
        self.tokens_emitted += int(emits.sum())
        self._occupancy_sum += occ
        self._queue_depth_sum += qd
        self._act_iters += int(n_act.sum())
        if spec is not None:
            acc, prop = spec.sum(dim=1).tolist()
            self.draft_accepted += acc
            self.draft_proposed += prop
        slot_req = self.scheduler.slot_req
        for k in range(toks.shape[0]):
            for j in range(toks.shape[2]):
                for i in np.nonzero(emits[k, :, j])[0]:
                    self._record_token(slot_req[i], int(toks[k, i, j]))
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
            "spec_depth": self.spec_depth,
            "draft": None if self.draft is None else str(self.draft),
            "draft_proposed": self.draft_proposed,
            "draft_accepted": self.draft_accepted,
            "accept_rate": (self.draft_accepted / self.draft_proposed
                            if self.draft_proposed else 0.0),
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
