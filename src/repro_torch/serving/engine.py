"""Executor: slot-based batching over the KV cache (dense or latent) — a
ring per slot or a paged pool shared by all slots — with a multi-token decode window
(port of ``repro.serving.engine``).

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

Paged pool (``cache_layout="paged"``): every layer's latents live in one
page-major pool and a per-slot page table (``ptab``, int32 on the device,
riding the window state) maps slot pages to physical pages.  Admission
maps each request's pages: the longest prompt prefix whose pages are
registered (``PrefixRegistry``) is shared (retained, or resurrected from
the free list), the first divergent page is a copy-on-write fork whose
content comes from the request's own prefill, and only non-shared pages
are scattered from the wave prefill.  Under ``prefix-affinity`` a request
whose prompt is covered by resident pages but for one page skips the
prefill (``prefill_calls_saved``).  With ``lazy_pages`` admission maps
only the admitted prompt plus one window's headroom; the mapping grows at
window boundaries, and when the pool runs dry the policy's victim is
preempted (its state parked, its pages freed) and re-admitted later:
surviving pages are resurrected, recycled ones rebuilt by prefilling the
tokens the victim had fed, so streams are those of an unpreempted run.

The dense cache (``cfg.recalkv is None``) runs every path above: its
leaves {"k", "v", "pos"} move through the same leaf-generic ring and page
code (admission scatters, copy-on-write forks, wipes, preemption).

Overlapped serving (``overlap=True``): up to ``pipeline_depth`` windows
are in flight on the device; the loop state (the "carry") stays on the
device from window to window, and admissions, refills, page top-ups and
degradations reach it as row scatters queued behind the in-flight
windows.  The host waits only for the trailing window's packed status
(one small host copy), token crediting runs on a backlog thread
(``pipeline.TokenBacklog``), and with ``admission_thread`` the wave prefill
and first-token sample run on a worker thread and, on a card, on its own
CUDA stream (``pipeline.AdmissionWorker``); the merge on the main stream
waits on that stream's event.  Streams equal the sync engine's token for
token.

``aot=True`` is the port's counterpart of compiling the window ahead of
time: on a card, construction builds every kernel the window runs, warms
one window iteration on a side stream and captures it as a CUDA graph
over static state buffers, once for greedy and once for sampled windows
(a verify iteration holds the draft's steps).  A window is then
``sync_every`` replays of the captured iteration instead of thousands of
kernel launches from Python; prefill stays eager (its shapes are
bucketed).  A capture or replay that fails raises: no path falls back to
the eager window.  On the CPU ``aot`` captures nothing.

``adaptive_spec=True`` degrades a slot to plain decode at a window
boundary once its draft has proposed ``ADAPTIVE_MIN_PROPOSED`` tokens with
an accept rate under ``ADAPTIVE_ACCEPT_FLOOR``; streams do not change.

Continuous batching (``continuous=True``, overlapped only): admission
stages prefilled requests into a device staging queue of ``max_slots``
rows (a ``seq`` key per row, ``STAGE_FREE`` when empty, one carry row per
request and, on the ring, a stage cache of ``max_slots`` rows; on the pool
a staged request's pages are scattered into the pool at stage time).  Each
window iteration first installs the queue's FIFO head into the lowest free
slot, on the device and without a branch: the carry row by ``torch.where``
on the selected row, the ring's cache row by a copy predicated on the
device (``csrc/stage_install.cu``), a ``gen`` bump that drops host
scatters aimed at the slot's old occupant.  The iteration emits the
installed ``seq`` and slot, and the harvest confirms the install into the
mirror and the scheduler after the fact.  ``seq`` lives in a static
buffer that every later window reads, so each install happens once at any
``pipeline_depth``, inside the captured graphs too.  ``staging_depth``
bounds the prefilled look-ahead (default ``2 * max_slots``).

An MLA model (DeepSeek) caches ``{"ckv", "krope", "pos"}`` and runs
every path above; its absorbed readers take no kernel, so under
``backend="kernel"`` construction warns once (``RuntimeWarning``) and
``metrics()["verify_backend"]`` reads "einsum", as in the JAX package.

A model with cross-attention layers (``cross``, ``attn_cross``; an
encoder-decoder's decoder) takes ``source`` (rows, S_src, d), the stub
frontend's embeddings: every prefill (an admission wave, a staged wave,
the layer draft's, a rebuild) reads ``source[:W]`` for its W rows, so
row i of a wave reads source row i, whichever request it holds — the JAX
engine's behaviour, kept so that streams match it.  Each slot's cross
cache is written by its prefill and static after it; the ring merge,
continuous batching's install and the captured graphs carry it beside
the self ring.  Its readers are einsum, so under ``backend="kernel"``
construction warns once, as for MLA (the self layers still launch their
kernels).  The paged pool refuses such a model (``ValueError``), as in
the JAX package.

A model with recurrent layers (``mamba``, ``rglru``: falcon-mamba,
recurrentgemma) keeps each slot's state ``{"h", "conv"}`` beside its
rings; the merge, continuous batching's install and the captured graphs
carry it, and a decode step replaces it where the slot steps.  Its
mixers are plain PyTorch, as in the JAX package.  Prefill runs them over
the whole right-padded bucket (the JAX engine's behaviour, kept so that
streams match it), so a request's state, and its stream, depend on the
power-of-two prompt length of its wave.  Speculation (``spec_depth >
0``) and the paged pool raise ``ValueError`` for such a model, as in the
JAX package.

Mesh serving (``mesh``, a ``launch.mesh.Mesh`` of ("data", "model")
ranks; one process a rank, every rank running this engine on the same
submitted requests).  The params rest as each rank's shards by
``sharding.rules.param_specs`` (head-grained) and each layer's leaves are
gathered where the model reads them (``sharding.place.MeshParams``; a
top-level leaf once a step, ``_step_scope``); the
cache is each rank's shard by ``cache_specs``: ring slots over "data" and
ring positions over "model", a pool's page offsets over "model" (every
data rank keeps every page: the page table holds global page ids), a
cross cache's source positions and a recurrent state's channels over
"model".  What the rules do not split stays whole, as in JAX: slots that
do not split over "data" are held and stepped by every data rank (one
slot group, ``slot_shards == 1``, and no step gathers over "data"), and a
layer whose ring length or page size "model" does not divide is read by
the bare kernels on every "model" rank, with no merge
(``sharding.place.step_mesh``, decided per layer).  Data rank k steps the
slots of group k (the scheduler packs a wave into one group,
``slot_shards``); the model ranks of a data rank run the same rows, each
scoring its sequence slice, merged by log-sum-exp: the kernels'
(``kernels.ops``) and the einsum readers' (MLA, cross-attention, the
einsum backend; ``models.kv_cache``) alike, while a recurrent block reads
its state gathered over "model".  The wave prefill runs on every rank
over replicated operands and each rank keeps its slots' rows and its
"model" slice of every leaf.  The layer draft's params are a view over
the target's shards and its ring is sharded as the target's.  One
all-gather over "data" a window brings the window's tokens and final
state to every rank's host mirror (the overlapped engine's at its
harvest, on the main thread), so every rank's scheduler takes the same
decisions and ``host_syncs == windows + admission_syncs`` still holds.
The overlapped engine writes its carry rows on the rank that holds them;
its admission worker gathers params on a process group of its own (the
mesh's "admission" lane) and runs in lockstep: each boundary collects
the waves submitted at earlier boundaries (waiting for them) and submits
the next one, formed on the main thread, so no decision depends on a
thread's timing.  Continuous batching keeps each data rank's staging
rows and stage cache to its own slot group: the host stages a request
into a group, and that rank installs it into one of its slots.  A
preempted slot's carry row is gathered from the rank holding it.
Refused on a mesh of more than one rank: ``aot`` (ROADMAP.md Queue 1
item 5e: CUDA graphs cannot capture gloo's host collectives, and NCCL
will not run two ranks on one card).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
import warnings
from collections import deque
from typing import Any

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import single_device_mesh
from repro_torch.models import kv_cache as KC
from repro_torch.models import transformer as T
from repro_torch.models.config import RECURRENT_KINDS, ModelConfig, check_supported
from repro_torch.serving import draft as D
from repro_torch.serving import sampler as S
from repro_torch.serving.draft import DraftSpec
from repro_torch.serving.pages import PagePool, PrefixRegistry, prefix_key
from repro_torch.serving.pipeline import (AdmissionWorker, InflightWindow,
                                          PreemptedRecord, StagedEntry,
                                          StagedWave, TokenBacklog)
from repro_torch.serving.policy import AdmissionPolicy, get_policy
from repro_torch.serving.sampler import SamplingParams
from repro_torch.serving.scheduler import Request, Scheduler
from repro_torch.sharding import place as SP
from repro_torch.sharding import rules as SR

__all__ = ["DraftSpec", "Engine", "Request", "SamplingParams"]

# The key of an empty device staging row: the install's argmin over the
# keys finds the lowest (first staged) sequence number ahead of every free
# row.
STAGE_FREE = np.iinfo(np.int32).max


def _merge_slot(pool_cache: list, new_cache: list, slots: torch.Tensor,
                rows: torch.Tensor | None = None, mesh=None) -> list:
    """Copy batch rows of ``new_cache`` into ``pool_cache`` at ``slots``, in
    place: the leading ``len(slots)`` rows (the prefill wave may be padded
    past that for shape bucketing; the pad rows are dropped here), or the
    wave rows ``rows`` when given.  On a ``mesh`` ``slots`` are this
    rank's local slot rows and each leaf takes its "model" slice by the
    rules (``kv_cache.model_slice``: ring columns, cross source
    positions, state channels)."""
    n = slots.shape[0]
    for pool, new in zip(pool_cache, new_cache):
        for part, leaves in pool.items():
            for name, leaf in leaves.items():
                src = new[part][name]
                src = src[:n] if rows is None else src[rows]
                leaf[slots] = KC.model_slice(src, name, mesh).to(leaf.dtype)
    return pool_cache


def _merge_slot_paged(pool_cache: list, new_cache: list, rows, cols, phys,
                      page_size: int, mesh=None) -> list:
    """Scatter prefill rows into the paged pool, in place: ``new_cache`` is
    slot-major (W, L, ...); its page (rows[t], cols[t]) — wave row, slot
    page index — lands in physical page ``phys[t]``.  Shared prefix pages
    are absent from the lists: their content is already resident, so
    admission never rewrites them.  On a ``mesh`` each page takes this
    rank's slice of its offsets."""
    for pool, new in zip(pool_cache, new_cache):
        for name, leaf in pool["self"].items():
            src = new["self"][name]
            tiles = src.reshape((src.shape[0], src.shape[1] // page_size,
                                 page_size) + tuple(src.shape[2:]))
            leaf[phys] = KC.model_slice(tiles[rows, cols], name, mesh).to(leaf.dtype)
    return pool_cache


@dataclasses.dataclass
class CapturedWindow:
    """One captured window iteration (``aot`` on a card): the graph, the
    kernel launches recorded into it (by wrapper name; the wrappers count
    at capture, a replay runs them all again), its replays and its capture
    seconds."""

    graph: Any                 # torch.cuda.CUDAGraph
    launches: dict             # wrapper name -> launches per replay
    replays: int = 0
    seconds: float = 0.0


def _bucket(n: int, cap: int) -> int:
    """Round up to a power of two, capped: the (wave, prompt-len) shapes a
    long-running engine sees collapse to O(log) values."""
    return min(max(1, 1 << (n - 1).bit_length()), max(cap, n))


class Engine:
    """Slot-based batching executor over the dense or latent cache (float
    or int8 latents; ring or paged pool).

    ``sync_every`` sets the decode window (iterations per host round
    trip); ``prefill_chunk`` bounds how much prompt one admission wave
    prefills at once.  ``spec_depth`` turns on speculative decoding, up to
    that many draft tokens verified per iteration; ``draft`` picks the
    proposer, "ngram" (default) or "layers:K".  ``cache_layout="paged"``
    keeps the cache in a pool of ``n_pages`` pages of ``page_size`` tokens
    (defaults: the first of 16, 8, 4, 2, 1 that divides ``max_len``, and
    the ring's capacity plus the null page); ``policy`` picks the
    admission order ("fifo", "prefix-affinity", "reach-packing");
    ``pin_prefixes`` keeps the K most-hit prefix pages out of recycling;
    ``lazy_pages`` reserves pages as decoding reaches them and preempts
    when the pool runs dry.  ``overlap`` keeps ``pipeline_depth`` windows
    in flight (token handling on a backlog thread, admission prefill on a
    worker thread with ``admission_thread``, on by default under overlap);
    ``continuous`` installs staged requests into freed slots inside the
    window, and ``staging_depth`` bounds how many requests may sit
    prefilled ahead of a slot (default ``2 * max_slots``); ``aot``
    captures the window iteration as CUDA graphs at construction (a card
    only); ``adaptive_spec`` degrades cold-draft slots to plain decode;
    ``profile`` records a timeline of the host boundary's stages.
    ``source`` (rows, S_src, d) feeds a model's cross-attention layers
    (see the module docstring).  ``device`` defaults to ``cuda``;
    ``params`` must already live there (see ``models.weights``)."""

    # adaptive speculation: degrade a slot once it has proposed at least
    # MIN_PROPOSED draft tokens with an accept rate below ACCEPT_FLOOR
    ADAPTIVE_MIN_PROPOSED = 8
    ADAPTIVE_ACCEPT_FLOOR = 0.25

    def __init__(self, cfg: ModelConfig, params, *, max_slots: int,
                 max_len: int, source=None, backend: str | None = None,
                 sampling: SamplingParams | None = None,
                 sync_every: int = 8, prefill_chunk: int | None = None,
                 policy: str | AdmissionPolicy | None = None,
                 spec_depth: int = 0, draft: str | DraftSpec | None = None,
                 cache_layout: str = "ring", page_size: int | None = None,
                 n_pages: int | None = None, pin_prefixes: int = 0,
                 lazy_pages: bool = False, overlap: bool = False,
                 aot: bool = False, pipeline_depth: int = 2,
                 continuous: bool = False, staging_depth: int | None = None,
                 admission_thread: bool | None = None,
                 adaptive_spec: bool = False, profile: bool = False,
                 device=None, mesh=None):
        if backend is not None:
            cfg = dataclasses.replace(cfg, attn_backend=backend)
        if sync_every < 1:
            raise ValueError("sync_every must be >= 1")
        if spec_depth < 0:
            raise ValueError("spec_depth must be >= 0")
        if spec_depth > 0:
            bad = [k for k in cfg.expanded_layers() if k in RECURRENT_KINDS]
            if bad:
                raise ValueError(
                    f"spec_depth > 0 needs position-addressed caches; "
                    f"{cfg.name} has recurrent {sorted(set(bad))} blocks "
                    f"whose state cannot roll back a rejected token")
        parsed_draft = DraftSpec.parse(draft)
        if parsed_draft is not None and spec_depth == 0:
            raise ValueError(
                f"draft={draft!r} requires spec_depth > 0 — a draft with "
                f"no speculation depth would be silently ignored")
        if pipeline_depth < 1:
            raise ValueError("pipeline_depth must be >= 1")
        if pipeline_depth != 2 and not overlap:
            raise ValueError("pipeline_depth is the overlapped engine's "
                             "in-flight window budget; set overlap=True")
        if continuous and not overlap:
            raise ValueError("continuous batching (in-window slot swap) "
                             "requires overlap=True")
        if continuous and parsed_draft is not None and parsed_draft.kind == "layers":
            raise ValueError(
                "continuous batching is incompatible with the layer-"
                "fraction draft: its slot-major ring has no staged "
                "twin for the in-scan install")
        if staging_depth is not None and staging_depth < 1:
            raise ValueError("staging_depth must be >= 1")
        if admission_thread and not overlap:
            raise ValueError("admission_thread requires overlap=True (the "
                             "sync engine admits inline by definition)")
        if adaptive_spec and spec_depth == 0:
            raise ValueError("adaptive_spec degrades speculative depth "
                             "per slot; it needs spec_depth > 0")
        self.device = resolve_device(device)
        check_supported(cfg, self.device)
        page_size, n_pages = self._check_layout(
            cfg, max_slots, max_len, cache_layout, page_size, n_pages)
        self.mesh = mesh if mesh is not None else single_device_mesh()
        self.mesh_str = str(self.mesh)
        # the mesh the steps see: None on one rank (no collective at all)
        self._mesh = self.mesh if self.mesh.size > 1 else None
        if self._mesh is not None and aot:
            raise ValueError(
                "aot=True is not ported to a mesh yet (ROADMAP.md Queue 1 item 5e): "
                "CUDA graphs cannot capture gloo's host collectives, and NCCL will "
                "not run two ranks on one card")
        # slot groups: the data ranks when max_slots splits over them, else
        # one group that every data rank holds and steps whole
        n_data = self.mesh.shape["data"]
        self._slot_groups = n_data if max_slots % n_data == 0 else 1
        resolved_policy = get_policy(policy)
        if pin_prefixes < 0:
            raise ValueError("pin_prefixes must be >= 0")
        if pin_prefixes > 0 and cache_layout != "paged":
            raise ValueError("pin_prefixes pins page-pool prefixes; it "
                             "needs cache_layout='paged'")
        if resolved_policy.groups_by_prefix and cache_layout != "paged":
            raise ValueError(
                f"policy={resolved_policy.name!r} groups admissions by "
                f"shared prompt prefix; it needs cache_layout='paged' "
                f"(the prefix registry lives in the page pool)")
        if lazy_pages:
            if cache_layout != "paged":
                raise ValueError("lazy_pages defers page reservation; it "
                                 "needs cache_layout='paged'")
            if continuous:
                raise ValueError(
                    "lazy_pages is incompatible with continuous batching: "
                    "the in-scan installer hands slots over mid-window, so "
                    "boundary-granular page top-up/preemption cannot tell "
                    "whose reach it is covering")
            if parsed_draft is not None and parsed_draft.kind == "layers":
                raise ValueError(
                    "lazy_pages is incompatible with the layer-fraction "
                    "draft: the draft's slot-major ring is not paged, so "
                    "a preempted slot's draft state cannot be rebuilt")
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params live on {params['embed'].device}, "
                             f"engine device is {self.device}")
        self.source = self._check_source(cfg, source)
        self.cfg = cfg
        self.params = params
        self.B, self.max_len = max_slots, max_len
        self.sampling = sampling or S.GREEDY
        self.sync_every = sync_every
        self.scheduler = Scheduler(max_slots, max_len,
                                   prefill_chunk=prefill_chunk,
                                   policy=resolved_policy,
                                   slot_shards=self._slot_groups)
        self.policy = self.scheduler.policy
        self.cache_layout = cache_layout
        self.page_size, self.n_pages = page_size, n_pages
        self.pin_prefixes = pin_prefixes
        self.lazy_pages = bool(lazy_pages)
        self._pages: PagePool | None = None
        self._prefixes: PrefixRegistry | None = None
        if cache_layout == "paged":
            self._pages = PagePool(n_pages)
            self._prefixes = PrefixRegistry()
            self._slot_pages: list[list[int]] = [[] for _ in range(max_slots)]
        self.policy.configure(page_size=page_size, registry=self._prefixes)
        pages_shape = None if self._pages is None else (n_pages, page_size)
        if self._mesh is not None:
            self.params = SP.MeshParams(cfg, params, self._mesh,
                                        grains=SR.head_grains(cfg))
            # the steps' view: without "data" when the slots do not split,
            # each layer's self cache read whole where the rules keep it so
            self._mesh = SP.step_mesh(self._mesh, T.init_decode_cache(
                cfg, max_slots, max_len, "meta", pages=pages_shape), max_slots)
        self.cache = self._init_cache(cfg, pages_shape)
        # this rank's slot rows: [lo, lo + B / groups)
        self._slot_n = max_slots // self._slot_groups
        self._slot_lo = (self.mesh.axis_index("data") * self._slot_n
                         if self._slot_groups > 1 else 0)
        self.spec_depth = spec_depth
        self.draft = (parsed_draft or DraftSpec("ngram")) if spec_depth else None
        # A requested kernel backend that still routes layer kinds through
        # einsum (absorbed-MLA attention has no kernel) warns once, so that
        # backend="kernel" is never silently a no-op; metrics() reports
        # what the verify steps run.
        if cfg.attn_backend == "kernel":
            fallback = KC.kernel_fallback_kinds(cfg)
            if fallback:
                warnings.warn(
                    f"backend='kernel': layer kinds {fallback} have no "
                    f"CUDA decode kernel and fall back to einsum",
                    RuntimeWarning, stacklevel=2)
        self._verify_backend = (
            None if spec_depth == 0
            else "kernel" if cfg.attn_backend == "kernel" and cfg.mla is None
            else "einsum")
        # Layer draft: a view over the target's first K layers (no new
        # weights; on a mesh over their shards) with its own, much
        # smaller, ring cache (on a mesh, this rank's shard of it).
        self.draft_cfg = self.draft_params = self.draft_cache = None
        if self.draft is not None and self.draft.kind == "layers":
            self.draft_cfg, self.draft_params = D.make_layer_draft(
                cfg, self.params, self.draft.layers)
            self.draft_cache = self._init_cache(self.draft_cfg, None)
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
        if adaptive_spec:
            # per-slot speculation gate: a degraded slot proposes nothing
            # and rides the window as plain decode
            self._st["spec_on"] = np.ones(max_slots, bool)
        if self._pages is not None:
            # slot page -> physical page; unmapped entries point at the
            # null page 0, whose pos -1 masks them.  int32 on the device,
            # as the paged kernels take it.
            self._st["ptab"] = np.zeros((max_slots, max_len // page_size),
                                        np.int32)
        if continuous:
            # per-slot generation count, bumped by every in-window install:
            # host scatters onto the live carry (refills, degradations)
            # carry the host's count and drop where the device's moved on,
            # so a write aimed at a slot's old occupant never lands on the
            # request installed since
            self._st["gen"] = np.zeros(max_slots, np.int32)
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
        self.prefill_calls = 0       # admission and rebuild prefill calls
        self.prefill_calls_saved = 0  # admissions served without a prefill
        self.preemptions = 0         # slots evicted by lazy reservation
        self._preempted: deque[PreemptedRecord] = deque()
        self._prefix_hits: dict[int, int] = {}   # page -> registry hits
        self.windows_idle = 0        # harvested windows that emitted nothing
        self.spec_degraded = 0       # slots degraded to plain decode
        self._spec_acc = np.zeros(max_slots, np.int64)
        self._spec_prop = np.zeros(max_slots, np.int64)
        # the backlog worker shares the token and ttft counters
        self._mlock = threading.Lock()

        # -- overlapped pipeline (inert when overlap=False) ---------------
        self.overlap = bool(overlap)
        self.aot = bool(aot)
        self.pipeline_depth = pipeline_depth
        self.adaptive_spec = bool(adaptive_spec)
        self.admission_thread = (self.overlap if admission_thread is None
                                 else bool(admission_thread))
        self.profile = bool(profile)
        self.continuous = bool(continuous)
        # prefilled-but-unmerged look-ahead
        self.staging_depth = (int(staging_depth) if staging_depth is not None
                              else 2 * max_slots)
        self._inflight: deque[InflightWindow] = deque()
        self._st_dev: dict[str, torch.Tensor] | None = None   # device carry
        self._dispatch_index = 0             # windows dispatched so far
        self._overlapped_windows = 0         # dispatched before prior done
        # per-slot dispatch-index watermarks: a harvested status is stale
        # for a slot (re)admitted or refilled at a later boundary
        self._slot_epoch = np.zeros(max_slots, np.int64)
        self._buf_epoch = np.zeros(max_slots, np.int64)
        self._backlog = TokenBacklog() if self.overlap else None
        self._sched_lock = threading.Lock()
        self._staged_waves: deque[StagedWave] = deque()
        # continuous batching: the host's view of the device staging rows
        # (an entry stays until a harvest reports its install)
        self._stage_tab: list[StagedEntry | None] = [None] * max_slots
        self._stage_by_seq: dict[int, tuple[int, StagedEntry]] = {}
        self._stage_seq_next = 0
        self.slot_swaps = 0          # in-window installs confirmed
        self._stage: dict | None = None
        if self.continuous:
            self._stage = self._init_stage()
        self._prof = {k: 0.0 for k in ("dispatch", "harvest", "bookkeep",
                                       "admission_stage", "backlog_drain")}
        self._prof_events: list[dict] = []
        self._prof_t0 = time.perf_counter()
        self._admission: AdmissionWorker | None = None
        self._adm_stream = None
        if self.overlap and self.admission_thread:
            if self.device.type == "cuda":
                self._adm_stream = torch.cuda.Stream(self.device)
                # the worker's first prefill reads weights made on this stream
                self._adm_stream.wait_stream(torch.cuda.current_stream(self.device))
            # on a mesh the worker's collectives run on a lane of their own
            # and its waves are formed and adopted in lockstep (every rank
            # takes the same decisions at the same boundaries)
            def prepare(reqs):
                with (self.mesh.lane("admission") if self._mesh is not None
                      else contextlib.nullcontext()):
                    return self._prepare_wave(reqs, self._adm_stream)
            self._admission = AdmissionWorker(
                self._take_staged_locked, prepare, lockstep=self._mesh is not None)
        # aot: the window iteration captured as CUDA graphs over static
        # state buffers (``_gst``) and window outputs (``_gout``)
        self.captures = 0
        self.capture_seconds = 0.0
        self._graphs: dict[str, CapturedWindow] = {}
        self._gst = self._gout = self._gk = None
        if self.aot and self.device.type == "cuda":
            self._capture()

    def _init_cache(self, cfg, pages_shape):
        """Empty decode caches for ``cfg``: whole, or on a mesh this rank's
        shards of them (``sharding.place.local_cache``; a pool keeps every
        page on every data rank)."""
        if self._mesh is None:
            return T.init_decode_cache(cfg, self.B, self.max_len, self.device,
                                       pages=pages_shape)
        return SP.local_cache(
            T.init_decode_cache(cfg, self.B, self.max_len, "meta", pages=pages_shape),
            self._mesh, self.device, pool=pages_shape is not None)

    def _check_source(self, cfg, source):
        """``source`` on the engine's device in ``cfg.dtype`` (None for a
        model without cross-attention layers); a model with them needs one
        of shape (rows, cross_source_len, d_model)."""
        if not any(k in ("cross", "attn_cross") for k in cfg.expanded_layers()):
            return None
        want = (cfg.cross_source_len, cfg.d_model)
        if source is None or tuple(source.shape[1:]) != want:
            raise ValueError(
                f"{cfg.name} has cross-attention layers: pass source=(rows, "
                f"{want[0]}, {want[1]}) (got "
                f"{None if source is None else tuple(source.shape)})")
        return torch.as_tensor(source).to(self.device, cfg.dtype)

    @staticmethod
    def _check_layout(cfg, max_slots, max_len, cache_layout, page_size,
                      n_pages):
        """Validate the cache layout; returns (page_size, n_pages) with the
        paged defaults filled in (None, None for the ring)."""
        if cache_layout not in ("ring", "paged"):
            raise ValueError(f"cache_layout={cache_layout!r}: expected "
                             f"'ring' or 'paged'")
        if cache_layout == "ring":
            if page_size is not None or n_pages is not None:
                raise ValueError(
                    "page_size/n_pages only apply to cache_layout='paged'")
            return None, None
        bad = sorted(k for k in set(cfg.expanded_layers())
                     if k in RECURRENT_KINDS + ("cross", "attn_cross"))
        if bad:
            raise ValueError(
                f"cache_layout='paged' needs position-addressed "
                f"self-attention rings; {cfg.name} has {bad} blocks")
        short = sorted(k for k in set(cfg.expanded_layers())
                       if cfg.cache_len(k, max_len) != max_len)
        if short:
            raise ValueError(f"cache_layout='paged' needs full-length rings; "
                             f"{short} blocks keep ring length < "
                             f"max_len={max_len}")
        if page_size is None:
            page_size = next(p for p in (16, 8, 4, 2, 1) if max_len % p == 0)
        if page_size < 1 or max_len % page_size:
            raise ValueError(f"page_size={page_size} must be >= 1 and divide "
                             f"max_len={max_len}")
        n_sp = max_len // page_size
        if n_pages is None:
            # the ring's capacity plus the reserved null page
            n_pages = max_slots * n_sp + 1
        if n_pages < n_sp + 1:
            raise ValueError(f"n_pages={n_pages} cannot hold one full-length "
                             f"request ({n_sp} pages + the reserved null page)")
        return page_size, n_pages

    @classmethod
    def from_artifact(cls, path: str, *, max_slots: int, max_len: int,
                      device=None, **kw) -> "Engine":
        """Boot an engine from a compression artifact either package
        saved (other keywords, the paged pool's, the overlapped engine's
        and continuous batching's included, as on the constructor)."""
        from repro_torch.api import load_artifact

        art = load_artifact(path, device=device)
        return cls(art.cfg, art.params, max_slots=max_slots, max_len=max_len,
                   device=device, **kw)

    @property
    def unfinished(self) -> dict[str, int]:
        """Requests not finished yet: queued (staged and parked included)
        and in a slot."""
        return {"queued": self.scheduler.queue_depth,
                "in_flight": self.scheduler.occupancy}

    # -- admission ----------------------------------------------------------

    def submit(self, req: Request) -> Request:
        with self._sched_lock:
            self.scheduler.submit(req)
        if self._admission is not None and not self._admission.lockstep:
            self._admission.kick(self._staging_capacity())
        return req

    def _record_token(self, req: Request, tok: int):
        """Credit one token: append, stamp the first token's time, fire the
        stream callback.  Runs on the main thread (sync engine) or the
        backlog worker (overlapped engine), never both."""
        req.out_tokens.append(tok)
        if req.first_token_at is None:
            req.first_token_at = time.perf_counter()
            if req.submitted_at is not None:
                with self._mlock:
                    self._ttft_sum += req.first_token_at - req.submitted_at
                    self._ttft_n += 1
        if req.on_token is not None:
            req.on_token(req, tok)

    # -- host <-> device ------------------------------------------------------

    def _dev(self, x) -> torch.Tensor:
        """A host array (or list) as a tensor on the engine's device: a
        copy on the CPU; on a card an asynchronous copy from pinned memory
        on the current stream, so the host never waits for the windows in
        flight."""
        t = torch.from_numpy(np.array(x))
        if self.device.type != "cuda":
            return t
        return t.pin_memory().to(self.device, non_blocking=True)

    @staticmethod
    def _host(t: torch.Tensor) -> torch.Tensor:
        """A device tensor's host copy: on a card an asynchronous copy into
        pinned memory, valid once an event recorded after it has passed;
        on the CPU a copy."""
        if t.device.type == "cuda":
            return t.to("cpu", non_blocking=True)
        return t.clone()

    def _event(self, stream=None):
        """An event recorded on ``stream`` (default: the current one), or
        None on the CPU, where work is done when it returns."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(stream or torch.cuda.current_stream(self.device))
        return ev

    def _finish(self, slot: int):
        self.finished.append(self.scheduler.slot_req[slot])
        self.scheduler.release(slot)
        st = self._st
        st["act"][slot] = False
        st["avail"][slot] = 0
        st["bpos"][slot] = 0
        st["more"][slot] = False
        st["left"][slot] = 0
        if self._pages is not None:
            for pg in self._slot_pages[slot]:
                # a refcount-0 page keeps its prefix key: its content stays
                # resident until the free list recycles it
                self._pages.free(pg)
            self._slot_pages[slot] = []
            st["ptab"][slot] = 0

    def _prefill(self, cfg, params, toks: np.ndarray, lens: np.ndarray):
        """A prefill of W rows; a cross-attention model's reads
        ``source[:W]`` (row i of the wave reads source row i, as in the JAX
        engine)."""
        src = None
        if self.source is not None:
            if self.source.shape[0] < toks.shape[0]:
                raise ValueError(
                    f"a prefill of {toks.shape[0]} rows reads source rows "
                    f"0..{toks.shape[0] - 1}; source has {self.source.shape[0]} "
                    f"(give it max(max_slots, staging_depth) rows under overlap)")
            src = self.source[: toks.shape[0]]
        with self._step_scope():
            return T.prefill(cfg, params, self._dev(toks), self._dev(lens), self.max_len,
                             source=src)

    def _step_scope(self):
        """One step's reads of the params: on a mesh each top-level leaf
        is gathered once in it (``MeshParams.step``)."""
        return self.params.step() if self._mesh is not None else contextlib.nullcontext()

    def _count_prefill(self):
        """One admission or rebuild prefill (any thread)."""
        with self._mlock:
            self.prefill_calls += 1

    def _wipe(self, pages: list[int]):
        T.wipe_pages(self.cache, self._dev(np.asarray(pages, np.int64)))

    # -- paged admission -----------------------------------------------------

    def _reach(self, req: Request) -> int:
        return min(len(req.prompt) + req.max_new_tokens, self.max_len)

    def _pages_needed(self, req: Request) -> int:
        """Worst-case pages for ``req``: its write reach (prompt plus
        generation budget, capped by max_len) is known at admission."""
        return -(-self._reach(req) // self.page_size)

    @property
    def _headroom(self) -> int:
        """How far past its last boundary-visible ``cur`` a slot can advance
        before the next top-up: one fed or sampled token plus up to
        ``spec_depth`` accepted drafts per iteration, over every window that
        can be in flight when one is dispatched (the trailing harvest lags
        by up to ``pipeline_depth`` windows, plus the new one)."""
        per_window = self.sync_every * (self.spec_depth + 1)
        return per_window * ((self.pipeline_depth + 1) if self.overlap else 1)

    def _admit_need(self, req: Request, first_len: int) -> int:
        """Pages admission maps up front: the whole reach (eager), or the
        admitted coverage plus one window's headroom (lazy)."""
        if not self.lazy_pages:
            return self._pages_needed(req)
        return -(-min(first_len + self._headroom, self._reach(req))
                 // self.page_size)

    def _registered_prefix(self, req: Request, n: int) -> list[int]:
        """Physical pages of the longest registered prefix of ``req``'s
        prompt, over at most its first ``n`` slot pages."""
        ps = self.page_size
        pages = []
        for j in range(n):
            pg = self._prefixes.lookup(prefix_key(req.prompt, j, ps))
            if pg is None:
                break
            pages.append(pg)
        return pages

    def _skip_prefill(self, req: Request) -> bool:
        """Prefill-skip gate (prefix-affinity): admit with no prefill row
        when resident pages cover all but at most one page of the prompt;
        the rest streams through the ingest buffer.  The probe stops one
        page short of the whole prompt: at least one prompt token must go
        through the decode loop to sample the first generated token."""
        if self._pages is None or not self.policy.groups_by_prefix:
            return False
        ps = self.page_size
        hit = len(self._registered_prefix(req, (len(req.prompt) - 1) // ps)) * ps
        return hit > 0 and len(req.prompt) - hit <= ps

    def _hold_shared(self, shared: list[int]):
        for pg in shared:
            self._note_prefix_hit(pg)
            if self._pages.refcount(pg) == 0:
                # every holder retired but nothing recycled the page: its
                # content is resident, so the prefix skips the prefill
                self._pages.resurrect(pg)
            else:
                self._pages.retain(pg)

    def _alloc_fresh(self, n: int) -> list[int]:
        own = self._pages.alloc(n)
        for pg in own:
            # a recycled page's old prefix key is dead: the registry must
            # never map a prefix to rewritten content
            self._prefixes.drop_page(pg)
            self._prefix_hits.pop(pg, None)
        return own

    def _bind_pages(self, slot: int, mapping: list[int]):
        self._slot_pages[slot] = list(mapping)
        row = self._st["ptab"][slot]
        row[:] = 0
        row[: len(mapping)] = mapping

    def _map_shared_pages(self, req: Request) -> tuple[list[int], int]:
        """Skip-path mapping (no prefill row): the resident prefix is held,
        the rest freshly allocated and position-wiped (no prefill covers
        it, and a recycled page's old positions would read as valid).
        Returns (the mapping, the shared coverage: the admitted ``cur``)."""
        ps = self.page_size
        shared = self._registered_prefix(req, (len(req.prompt) - 1) // ps)
        self._hold_shared(shared)
        hit_len = len(shared) * ps
        own = self._alloc_fresh(max(self._admit_need(req, hit_len),
                                    len(shared)) - len(shared))
        if own:
            self._wipe(own)
        self._update_pins()
        self.prefill_calls_saved += 1
        return shared + own, hit_len

    def _assign_shared_pages(self, slot: int, req: Request) -> int:
        """``_map_shared_pages`` bound to ``slot``; returns the coverage."""
        mapping, hit_len = self._map_shared_pages(req)
        self._bind_pages(slot, mapping)
        return hit_len

    def _assign_pages(self, slot: int, req: Request, first_len: int):
        """``_map_pages`` bound to ``slot``."""
        mapping, scat = self._map_pages(req, first_len)
        self._bind_pages(slot, mapping)
        return mapping, scat

    def _map_pages(self, req: Request, first_len: int):
        """Map ``req``'s slot pages: the longest registered prefix fully
        covered by this wave's prefill is shared, the rest allocated.
        Copy-on-write resolves here: the first page past the shared run
        diverges, and its content comes from the request's own prefill
        scatter, so the fork needs no copy.  Returns (mapping, the slot
        pages the prefill must scatter)."""
        ps = self.page_size
        n_need = self._admit_need(req, first_len)
        shared = self._registered_prefix(req, min(n_need, first_len // ps))
        self._hold_shared(shared)
        if shared and n_need > len(shared):
            self._pages.cow_forks += 1
        mapping = shared + self._alloc_fresh(n_need - len(shared))
        for j in range(len(shared), n_need):
            # register pages whose content this prefill fully determines
            if (j + 1) * ps <= first_len:
                self._prefixes.register(prefix_key(req.prompt, j, ps),
                                        mapping[j])
        self._update_pins()
        return mapping, list(range(len(shared), n_need))

    def _note_prefix_hit(self, page: int):
        if self.pin_prefixes:
            self._prefix_hits[page] = self._prefix_hits.get(page, 0) + 1

    def _update_pins(self):
        """Keep the ``pin_prefixes`` most-hit registered prefix pages pinned
        (exempt from recycling, parked at refcount 0)."""
        if not self.pin_prefixes:
            return
        registered = self._prefixes.pages()
        alive = {pg: h for pg, h in self._prefix_hits.items() if pg in registered}
        want = set(sorted(alive, key=lambda p: (-alive[p], p))[: self.pin_prefixes])
        for pg in range(1, self.n_pages):
            if pg in want:
                self._pages.pin(pg)
            elif self._pages.is_pinned(pg):
                self._pages.unpin(pg)

    def _page_fits(self):
        """Page-budget gate for ``take_wave``: each admitted request debits
        its admission need from the free pages (ignoring sharing, so a
        fitting wave has real pages even if every lookup misses).  Under
        lazy reservation a request whose whole reach exceeds the pool never
        fits: it must be able to finish once the pool is all its own."""
        budget = self._pages.free_count

        def fits(req: Request) -> bool:
            nonlocal budget
            if self.lazy_pages and self._pages_needed(req) > self.n_pages - 1:
                return False
            need = self._admit_need(req, self.scheduler.first_chunk_len(req))
            if need > budget:
                return False
            budget -= need
            return True

        return fits

    def _bucket_prompts(self, reqs, first_lens, rows, w):
        """Pack the wave's prefill rows (``rows[i]`` >= 0) into one
        power-of-two (rows, prompt-len) bucket (row cap: the slots or the
        staging depth, whichever is larger)."""
        W = _bucket(w, max(self.B, self.staging_depth))
        P = _bucket(max(fl for fl, ri in zip(first_lens, rows) if ri >= 0),
                    self.max_len)
        toks = np.zeros((W, P), np.int64)
        lens = np.zeros((W,), np.int64)
        for i, r in enumerate(reqs):
            if rows[i] >= 0:
                toks[rows[i], : first_lens[i]] = r.prompt[: first_lens[i]]
                lens[rows[i]] = first_lens[i]
        return toks, lens

    def _admit_prefill(self, wave, first_lens, rows, w):
        """The wave prefill (when any row needs one) merged into the cache:
        slot rows of the ring, or the non-shared pages of the pool.  Skip
        members (rows[i] == -1) bind resident pages instead and get their
        ``first_lens`` entry set to the shared coverage.  Returns the (W, V)
        logits, or None for a wave with no prefill row."""
        reqs = [r for _, r in wave]
        logits = new_cache = dnew = None
        if w:
            toks, lens = self._bucket_prompts(reqs, first_lens, rows, w)
            self._count_prefill()
            logits, new_cache = self._prefill(self.cfg, self.params, toks, lens)
            if self.draft_cache is not None:
                _, dnew = self._prefill(self.draft_cfg, self.draft_params, toks, lens)
        first_lens[:] = self._merge_prefill(
            [(s, r, ri, fl) for (s, r), ri, fl in zip(wave, rows, first_lens)],
            new_cache, dnew)
        return logits

    def _merge_prefill(self, entries, new_cache, draft_new_cache) -> list[int]:
        """Merge prefill rows into the cache, in place.  ``entries`` are
        (slot, request, prefill row or -1, first_len): ring slots take their
        rows; the pool maps each request's pages and takes the non-shared
        ones, and a skip member (row -1) binds resident pages instead.  The
        layer draft's ring takes the same rows (a skip member's draft ring
        keeps stale content, which costs acceptance, never correctness).
        Returns the first_lens, a skip member's set to its shared coverage."""
        t = self._dev
        lens = [fl for *_, fl in entries]
        # a ring never skips; on a mesh this rank keeps its own slots
        lo, n = self._slot_lo, self._slot_n
        mine = [(s - lo, ri) for s, _, ri, _ in entries if lo <= s < lo + n and ri >= 0]
        if self._pages is None:
            if mine:
                _merge_slot(self.cache, new_cache, t([s for s, _ in mine]),
                            rows=t([ri for _, ri in mine]), mesh=self._mesh)
        else:
            rws, cols, phys = [], [], []
            for i, (slot, r, ri, fl) in enumerate(entries):
                if ri < 0:
                    lens[i] = self._assign_shared_pages(slot, r)
                    continue
                mapping, scat = self._assign_pages(slot, r, fl)
                rws += [ri] * len(scat)
                cols += scat
                phys += [mapping[j] for j in scat]
            if phys:
                _merge_slot_paged(self.cache, new_cache, t(rws), t(cols), t(phys),
                                  self.page_size, mesh=self._mesh)
        if draft_new_cache is not None and mine:
            _merge_slot(self.draft_cache, draft_new_cache, t([s for s, _ in mine]),
                        rows=t([ri for _, ri in mine]), mesh=self._mesh)
        return lens

    def _admit(self):
        """Synchronous admission: take a wave (page-budget gated on the
        pool), one wave prefill for the rows that need it, then the first
        token of every fully prefilled prompt sampled with the slot's first
        key split and emitted (one host sync), then the mirror state.  A
        wave whose members all skip the prefill costs no device sync: their
        first tokens come from the decode loop's ingest steps."""
        wave = self.scheduler.take_wave(
            None if self._pages is None else self._page_fits())
        if not wave:
            return
        reqs = [r for _, r in wave]
        first_lens = [self.scheduler.first_chunk_len(r) for r in reqs]
        rows, w = self._skip_rows(reqs)
        logits = self._admit_prefill(wave, first_lens, rows, w)
        specs = [r.sampling or self.sampling for r in reqs]
        keys0 = np.stack([sp.slot_key(r.uid) for sp, r in zip(specs, reqs)])
        keys0 = keys0.astype(np.int64)
        if logits is not None:
            ks, first = self._sample_first(logits, keys0, specs, rows)
            first, ks = first.cpu().numpy(), ks.cpu().numpy()
            self.host_syncs += 1
            self.admission_syncs += 1
        st = self._st
        for i, (slot, r) in enumerate(wave):
            self._admit_bookkeep(slot, r, specs[i], first_lens[i])
            st["keys"][slot] = keys0[i]
            ri = rows[i]
            if ri >= 0 and first_lens[i] == len(r.prompt):
                # whole prompt prefilled: emit the first generated token
                # and advance the key, as the decode window would
                st["keys"][slot] = ks[ri, 0]
                st["tok"][slot] = first[ri]
                self._admit_tokens += 1
                self._record_token(r, int(first[ri]))
                if r.done:
                    self._finish(slot)

    def _sample_first(self, logits, keys0, specs, rows):
        """The first token of every prefill row, drawn with the slot's first
        key split as the decode window would draw it.  Returns the (W, 2, 2)
        split keys and the (W,) tokens, on the device."""
        pre = [i for i, ri in enumerate(rows) if ri >= 0]
        ks = S.split_keys(self._dev(keys0[pre]))
        first = S.sample_tokens(
            logits[:len(pre)],
            self._dev(np.array([specs[i].temperature for i in pre], np.float32)),
            self._dev(np.array([specs[i].top_k for i in pre], np.int64)),
            self._dev(np.array([specs[i].top_p for i in pre], np.float32)),
            ks[:, 1], any_sampled=not all(specs[i].greedy for i in pre))
        return ks, first

    def _carry_fields(self, r: Request, sp: SamplingParams, first_len: int):
        """The host-known carry fields of a request admitted with
        ``first_len`` prompt tokens prefilled, one row value per field,
        whichever slot takes it: a direct admission writes them into the
        mirror, continuous batching into a staging row.  Returns (fields,
        the prompt tail left pending after the first ingest chunk)."""
        st = self._st
        row = {"cur": first_len, "eos": -1 if r.eos_id is None else r.eos_id,
               "temp": sp.temperature, "top_k": sp.top_k, "top_p": sp.top_p,
               "bpos": 0, "act": True, "tok": 0}
        if "spec_on" in st:
            # degradation is per request: a fresh admission gets the draft
            # back, with clean accept / propose counts
            row["spec_on"] = True
        if "hist" in st:
            # the whole prompt is known at admission, even the part not
            # ingested yet: seed the n-gram corpus with it up front
            row["hist"] = np.zeros(st["hist"].shape[1:], st["hist"].dtype)
            row["hist"][: len(r.prompt)] = r.prompt
        rest = r.prompt[first_len:]
        if rest.size == 0:
            row.update(left=r.max_new_tokens - 1, avail=0, more=False)
            return row, rest
        # chunked prefill: stream the remainder through the ingest buffer
        chunk, pending = self.scheduler.split_chunk(rest)
        row["buf"] = np.zeros(st["buf"].shape[1:], st["buf"].dtype)
        row["buf"][: chunk.shape[0]] = chunk
        row.update(left=r.max_new_tokens, avail=chunk.shape[0], more=pending.size > 0)
        return row, pending

    def _admit_bookkeep(self, slot: int, r: Request, sp: SamplingParams,
                        first_len: int):
        row, pending = self._carry_fields(r, sp, first_len)
        for k, v in row.items():
            self._st[k][slot] = v
        self.scheduler.set_pending(slot, pending)
        self._spec_acc[slot] = 0
        self._spec_prop[slot] = 0

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

    # -- lazy page reservation and preemption ---------------------------------
    #
    # With lazy_pages admission maps the admitted coverage plus one window's
    # headroom; at every window boundary _lazy_topup extends each active
    # slot's mapping ahead of its cur.  When the pool runs dry the policy
    # names a victim: its state row, pages and alloc stamps are recorded,
    # its fully written prompt pages registered (so it, or a sharer, can
    # find them), its pages freed and the request parked.  Re-admission
    # (ahead of fresh admissions) resurrects pages whose stamp is unchanged
    # and rebuilds recycled ones by prefilling the tokens the slot had fed,
    # then restores the state row verbatim, so the stream is unchanged.

    def _lazy_topup(self):
        """Extend every active slot's mapping to cover ``cur + headroom``
        (capped at its reach); fresh pages are position-wiped, since no
        prefill covers them."""
        if not self.lazy_pages:
            return
        st = self._st
        ps = self.page_size
        for slot, r in enumerate(list(self.scheduler.slot_req)):
            if r is None or not st["act"][slot]:
                continue
            tgt = -(-min(int(st["cur"][slot]) + self._headroom, self._reach(r))
                    // ps)
            have = len(self._slot_pages[slot])
            if tgt <= have:
                continue
            if not self._make_room(slot, tgt - have):
                continue                  # the slot itself was parked
            own = self._alloc_fresh(tgt - have)
            self._slot_pages[slot].extend(own)
            st["ptab"][slot, have: have + len(own)] = own
            self._wipe(own)
            if self.overlap:
                self._ensure_dev_state()
                self._scatter_rows([slot], {"ptab": st["ptab"][slot][None]})
        self._update_pins()

    def _make_room(self, slot: int, need: int) -> bool:
        """Preempt policy-chosen victims until ``need`` pages are free for
        running ``slot``.  False when the slot itself had to be parked (no
        other victim could cover it; admission's whole-reach check means it
        can be re-seated once the pool drains)."""
        tried = {slot}
        while not self._pages.can_alloc(need):
            cands = self._victim_candidates(tried)
            if not cands:
                self._preempt_slot(slot)
                return False
            victim = self.policy.pick_victim(cands)
            tried.add(victim)
            self._preempt_slot(victim)
        return True

    def _victim_candidates(self, exclude) -> list:
        """Active slots in admission order, oldest first."""
        order = {uid: i for i, uid in enumerate(self.scheduler.admitted_uids)}
        cands = sorted((order.get(r.uid, -1), slot)
                       for slot, r in enumerate(self.scheduler.slot_req)
                       if r is not None and slot not in exclude
                       and self._st["act"][slot])
        return [(slot, self.scheduler.slot_req[slot]) for _, slot in cands]

    def _preempt_slot(self, slot: int) -> bool:
        """Evict a running slot: record its state row and pages, register
        its fully written prompt pages, free its pages, park the request.
        Under overlap the row comes from the device carry, which waits for
        every dispatched window (the pipeline's one deliberate full sync),
        so it holds all their effects; their tokens still reach the stream
        in dispatch order through the backlog.  False when the slot had
        already finished on the device (it retires at its harvest)."""
        if self.overlap:
            self._ensure_dev_state()
            row = self._carry_row(slot)
        else:
            row = {k: np.array(v[slot]) for k, v in self._st.items()}
        if not bool(row["act"]):
            return False
        if self.overlap:
            # windows dispatched from here on skip the slot; in-flight
            # statuses are stale for it
            self._put_rows(self._st_dev, [slot], {"act": np.zeros(1, bool)})
            self._slot_epoch[slot] = self._dispatch_index
            self._buf_epoch[slot] = self._dispatch_index
        st = self._st
        st["act"][slot] = False
        st["avail"][slot] = 0
        st["bpos"][slot] = 0
        st["more"][slot] = False
        st["left"][slot] = 0
        with self._sched_lock:
            req, pending = self.scheduler.preempt(slot)
        ps = self.page_size
        cur = int(row["cur"])
        pages = list(self._slot_pages[slot])
        stamps = [self._pages.alloc_stamp(pg) for pg in pages]
        for j, pg in enumerate(pages):
            if (j + 1) * ps <= min(cur, len(req.prompt)):
                self._prefixes.register(prefix_key(req.prompt, j, ps), pg)
        for pg in pages:
            self._pages.free(pg)
        self._slot_pages[slot] = []
        st["ptab"][slot] = 0
        self._preempted.append(PreemptedRecord(
            req=req, host_row=row, pending=pending, pages=pages, stamps=stamps,
            cur=cur, at=self._dispatch_index))
        self.preemptions += 1
        return True

    def _readmit_preempted(self):
        """Re-seat parked requests, oldest first, while a slot and the pages
        to replace their lost ones are free.  Survivors (alloc stamp
        unchanged) are resurrected or retained; lost pages below ``cur``
        are rebuilt by one prefill of the fed tokens, lost pages ahead of
        it wiped.  A re-admission that rebuilds nothing saves a prefill."""
        pool = self._pages
        while self._preempted:
            rec = self._preempted[0]
            free = self.scheduler.free_slots()
            if not free:
                return
            surv = [pool.alloc_stamp(pg) == stp
                    for pg, stp in zip(rec.pages, rec.stamps)]
            lost = [j for j, ok in enumerate(surv) if not ok]
            # survivors on the free list leave it on resurrect, so the lost
            # pages' replacements must fit after them
            surv_free = sum(1 for pg, ok in zip(rec.pages, surv)
                            if ok and pool.refcount(pg) == 0
                            and not pool.is_pinned(pg))
            if pool.free_count - surv_free < len(lost):
                return
            slot = free[0]
            with self._sched_lock:
                self.scheduler.place(slot, rec.req)
            # claim every survivor first: allocating a replacement earlier
            # could recycle a survivor out from under its flag
            mapping = list(rec.pages)
            for pg, ok in zip(rec.pages, surv):
                if ok and pool.refcount(pg) == 0:
                    pool.resurrect(pg)
                elif ok:
                    pool.retain(pg)          # a prefix sharer holds it too
            wipe, rebuild = [], []
            for j in lost:
                mapping[j] = self._alloc_fresh(1)[0]
                if j * self.page_size < rec.cur:
                    rebuild.append(j)
                else:
                    wipe.append(mapping[j])
            if wipe:
                self._wipe(wipe)
            if rebuild:
                self._rebuild_pages(rec, mapping, rebuild)
            else:
                self.prefill_calls_saved += 1
            st = self._st
            for k, v in rec.host_row.items():
                st[k][slot] = v
            self._bind_pages(slot, mapping)
            self.scheduler.set_pending(slot, np.asarray(rec.pending, np.int64))
            if self.overlap:
                self._ensure_dev_state()
                self._scatter_rows([slot], {k: v[slot][None] for k, v in st.items()})
                self._slot_epoch[slot] = self._dispatch_index
                self._buf_epoch[slot] = self._dispatch_index
            self._update_pins()
            self._preempted.popleft()

    def _carry_row(self, slot: int) -> dict:
        """Slot ``slot``'s row of the device carry, on the host (it waits
        for every dispatched window).  On a mesh whose slots split over
        "data" the carry is gathered from the data ranks: every rank
        preempts at the same boundary, so every rank calls this."""
        if self._slot_groups > 1:
            return {k: v[slot].numpy().copy()
                    for k, v in self._gather_rows(self._st_dev).items()}
        return {k: v[slot].cpu().numpy().copy() for k, v in self._st_dev.items()}

    def _rebuild_pages(self, rec: PreemptedRecord, mapping, rebuild):
        """Recompute recycled pages: prefill the tokens the slot had fed
        (cache content at position t is a function of the tokens fed up to
        t) and scatter just the lost pages.  The fed tokens are the
        speculative window's ``hist``, or the prompt plus the emitted
        tokens: under overlap the windows dispatched before the eviction
        are harvested and the backlog drained first, since they emitted
        some of those tokens."""
        cur = rec.cur
        if "hist" in rec.host_row:
            fed = np.asarray(rec.host_row["hist"][:cur], np.int64)
        else:
            while self._inflight and self._inflight[0].index < rec.at:
                self._harvest_trailing()
            if self._backlog is not None and self._backlog.started:
                self._backlog.flush()
            prompt = np.asarray(rec.req.prompt, np.int64)
            P = len(prompt)
            gen = np.asarray(rec.req.out_tokens[: max(cur - P, 0)], np.int64)
            fed = np.concatenate([prompt[: min(cur, P)], gen])
        toks = np.zeros((1, _bucket(cur, self.max_len)), np.int64)
        toks[0, :cur] = fed
        self._count_prefill()
        _, new_cache = self._prefill(self.cfg, self.params, toks,
                                     np.array([cur], np.int64))
        t = self._dev
        _merge_slot_paged(self.cache, new_cache, t([0] * len(rebuild)),
                          t(rebuild), t([mapping[j] for j in rebuild]),
                          self.page_size, mesh=self._mesh)

    # -- decode window -------------------------------------------------------

    def _pages_of(self, st):
        """``pages`` for the step functions: (ptab, page_size) of the window
        state, or None for the ring."""
        return None if self._pages is None else (st["ptab"], self.page_size)

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

    def _init_stage(self) -> dict:
        """The device staging area (static buffers: the captured graphs
        read them by pointer): ``seq`` keys (``STAGE_FREE`` = empty row),
        one carry row per staged request and, on the ring, a stage cache
        of ``max_slots`` rows with the ring's layout.  On a mesh whose
        slots split over "data" each rank holds its slot group's staging
        rows, sharded like the carry and the ring: the host stages a
        request into a group (``_free_stage_row``) and the group's rank
        installs it into one of its own slots."""
        n = self._slot_n
        stage = {"seq": self._dev(np.full(n, STAGE_FREE, np.int32)),
                 "rows": {k: torch.zeros_like(self._dev(v[:n])) for k, v in self._st.items()}}
        if self._pages is None:
            stage["cache"] = self._init_cache(self.cfg, None)
            stage["table"] = T.install_table(self.cache, stage["cache"])
        return stage

    @staticmethod
    def _stage_install(st: dict[str, torch.Tensor], cache: list, stage: dict):
        """Continuous batching's device half, before an iteration's step:
        install the staging queue's FIFO head (``argmin`` of the keys)
        into the lowest free slot (``argmax`` of the free flags), when both
        exist.  Branchless: the carry rows by ``torch.where`` on the
        selected row, the ring's cache row by a copy the device predicates
        (``T.swap_cache_slot`` over ``stage["table"]``, which the stage
        holds beside its cache; ``stage["cache"]`` absent on the pool),
        ``gen`` bumped rather than copied.  The head's key is cleared in
        ``stage["seq"]``, in place, so every later window sees the install
        and it happens once.  Returns (state, outputs: the installed
        ``sw_seq`` and ``sw_slot``, -1 where nothing installed)."""
        act, seq = st["act"], stage["seq"]
        q = torch.argmin(seq).reshape(1)
        head = seq.index_select(0, q)
        # argmax over an int tensor: the first free slot on ties
        slot = torch.argmax((~act).to(torch.int32)).reshape(1)
        do = (head != STAGE_FREE) & ~act.index_select(0, slot)
        st2 = {}
        for k, v in st.items():
            old = v.index_select(0, slot)
            if k == "gen":
                row = old + do.to(v.dtype)
            else:
                sel = do.reshape((1,) + (1,) * (v.dim() - 1))
                row = torch.where(sel, stage["rows"][k].index_select(0, q), old)
            st2[k] = v.index_copy(0, slot, row)
        if "cache" in stage:
            T.swap_cache_slot(cache, stage["cache"], slot.masked_fill(~do, act.shape[0]), q,
                              stage.get("table"))
        seq.index_copy_(0, q, head.masked_fill(do, STAGE_FREE))
        return st2, {"sw_seq": head.masked_fill(~do, -1)[0],
                     "sw_slot": slot.to(torch.int32).masked_fill(~do, -1)[0]}

    def _decode_iter(self, st: dict[str, torch.Tensor], any_sampled: bool):
        """One decode iteration on device state.  Per slot: pick the fed
        token, one batched decode_step (inactive and stalled rows write
        nothing), sample, update emit / termination flags; the key advances
        only where the slot emitted.  A continuous engine installs a staged
        request first.  Returns (state, outputs)."""
        sw = {}
        if self.continuous:
            st, sw = self._stage_install(st, self.cache, self._stage)
        feeding, tok_in, stepping, last_prompt = self._feed(st)
        logits, self.cache = T.decode_step(self.cfg, self.params, self.cache,
                                           tok_in, st["cur"], stepping,
                                           pages=self._pages_of(st), mesh=self._mesh)
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
        return st, {"toks": sampled, "emits": emit, "n_act": stepping.sum(), **sw}

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
                d_cur, act_j, mesh=self._mesh)
            d_cur = d_cur + act_j.to(d_cur.dtype)
            if j < depth:
                d_tok = dlogits.argmax(dim=-1)
                props.append(d_tok)
        return torch.stack(props, dim=1)

    def _spec_iter(self, st: dict[str, torch.Tensor], any_sampled: bool):
        """One speculative round.  Per slot: propose, one S = spec_depth +
        1 token verify_step, then walk the S positions in order — position
        j's draw (the slot's policy with its next key split) is the token
        sequential decoding would emit there, so a proposal is accepted iff
        it matches, and the first mismatch emits the draw and ends the
        round.  Only the accepted prefix is written to the ring and keys
        advance once per emitted token.  Ingesting slots keep one token per
        round (their columns >= 1 are never candidates), and so do slots
        ``adaptive_spec`` degraded.  A continuous engine installs a staged
        request first.  Returns (state, outputs); the outputs hold the
        per-slot accepted and proposed draft counts."""
        cfg, S_pos = self.cfg, self.spec_depth + 1
        sw = {}
        if self.continuous:
            st, sw = self._stage_install(st, self.cache, self._stage)
        feeding, tok_in, stepping, last_prompt = self._feed(st)
        speculating = stepping & ~feeding
        if "spec_on" in st:
            speculating = speculating & st["spec_on"]
        cur = st["cur"]
        js = torch.arange(S_pos, dtype=cur.dtype, device=cur.device)
        cap_ok = (cur[:, None] + js[None, :]) < self.max_len      # (B, S)
        props = self._propose(st, cur, tok_in, stepping, speculating, cap_ok)
        fed = torch.cat([tok_in[:, None], props], dim=1)
        cand = torch.cat([stepping[:, None],
                          speculating[:, None] & cap_ok[:, 1:]], dim=1)
        pages = self._pages_of(st)
        logits, updates = T.verify_step(cfg, self.params, self.cache, fed,
                                        cur, cand, pages=pages, mesh=self._mesh)
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
        valid = torch.stack(valid, dim=1)                              # (B, S)
        # commit the accepted prefix (rejected tokens never wrote)
        T.commit_verify_writes(self.cache, updates, cur, valid, pages=pages,
                               mesh=self._mesh)
        if self.draft_cache is not None:
            # the draft wrote as it proposed: strike rejected columns from
            # its position index so they cannot shadow the slot
            for j in range(1, S_pos):
                KC.invalidate_positions(self.draft_cache, cur + j,
                                        cand[:, j] & ~valid[:, j], mesh=self._mesh)
        hist = st["hist"]
        rows = torch.arange(hist.shape[0], device=hist.device)
        for j in range(S_pos):
            pos = (cur + j).clamp(max=hist.shape[1] - 1)
            hist[rows, pos] = torch.where(valid[:, j], fed[:, j], hist[rows, pos])
        st = {**st,
              "tok": tok2,
              "cur": cur + valid.to(cur.dtype).sum(dim=1),
              "act": st["act"] & ~done_any,
              "keys": keys,
              "bpos": st["bpos"] + feeding.to(st["bpos"].dtype),
              "left": st["left"] - nemit}
        # count only real proposals: the n-gram draft pads unknown
        # positions with -1 (certain rejects)
        return st, {"toks": torch.stack(toks, dim=1),
                    "emits": torch.stack(emits, dim=1),
                    "acc": valid[:, 1:].sum(dim=1),
                    "prop": (cand[:, 1:] & (fed[:, 1:] >= 0)).sum(dim=1),
                    "n_act": stepping.sum(), **sw}

    def _window(self, st: dict[str, torch.Tensor], any_sampled: bool):
        """``sync_every`` iterations on device state: replays of the
        captured iteration (``aot`` on a card: ``st`` must be the static
        state), else the eager loop.  Returns (state, outputs stacked over
        the iterations: toks / emits (K, B[, S]), n_act (K,), and for
        speculation acc / prop (K, B))."""
        if self._graphs:
            if st is not self._gst:
                raise RuntimeError("a captured window runs on the static state")
            cw = self._graphs["sampled" if any_sampled else "greedy"]
            self._gk.zero_()
            for _ in range(self.sync_every):
                cw.graph.replay()
            cw.replays += self.sync_every
            return self._gst, self._gout
        it = self._spec_iter if self.spec_depth else self._decode_iter
        ys = []
        for _ in range(self.sync_every):
            with self._step_scope():
                st, y = it(st, any_sampled)
            ys.append(y)
        return st, {k: torch.stack([y[k] for y in ys]) for k in ys[0]}

    def _any_sampled(self) -> bool:
        """Whether a slot the host believes active samples, or a staged
        request the window may install does (a stale active flag only
        picks the sampled window, which is exact for greedy rows too)."""
        if bool((self._st["act"] & (self._st["temp"] >= S._TEMP_EPS)).any()):
            return True
        return any(e is not None and e.host_row["temp"] >= S._TEMP_EPS
                   for e in self._stage_tab)

    def _load_state(self) -> dict[str, torch.Tensor]:
        """The host mirror on the device for one sync window: copied into
        the static state of the captured window, or fresh tensors."""
        if not self._graphs:
            rows = slice(self._slot_lo, self._slot_lo + self._slot_n)
            return {k: self._dev(v[rows]) for k, v in self._st.items()}
        for k, v in self._st.items():
            self._gst[k].copy_(torch.from_numpy(np.array(v)).pin_memory(),
                               non_blocking=True)
        return self._gst

    # -- aot: the window iteration as CUDA graphs ---------------------------

    def _cache_ptrs(self) -> list[int]:
        return [leaf.data_ptr()
                for leaf in T.cache_leaves(self.cache + (self.draft_cache or []))]

    def _capture(self):
        """Capture one window iteration as a CUDA graph per variant the
        engine dispatches (greedy and sampled; a speculative engine's
        iteration holds the draft's steps and the verify pass) over static
        state buffers: the iteration reads them, writes its new state back
        into them and its outputs into row ``_gk`` of the window buffers.
        The iteration runs eagerly first on a side stream with no slot
        active (it writes nothing then), which builds every kernel and
        library handle it needs.  Counts each graph's kernel launches at
        capture.  Any failure raises."""
        dev = self.device
        t_start = time.perf_counter()
        ptrs = self._cache_ptrs()
        it = self._spec_iter if self.spec_depth else self._decode_iter
        self._gst = {k: self._dev(v) for k, v in self._st.items()}
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for any_sampled in (False, True):
                _, y = it(dict(self._gst), any_sampled)
        torch.cuda.current_stream(dev).wait_stream(side)
        torch.cuda.synchronize(dev)
        self._gout = {k: torch.zeros((self.sync_every,) + tuple(v.shape), dtype=v.dtype,
                                     device=dev) for k, v in y.items()}
        self._gk = torch.zeros(1, dtype=torch.int64, device=dev)
        pool = torch.cuda.graph_pool_handle()
        for variant, any_sampled in (("greedy", False), ("sampled", True)):
            before = {k.__name__: k.launches for k in kernels.KERNELS}
            t0 = time.perf_counter()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, pool=pool):
                st2, y = it(dict(self._gst), any_sampled)
                for k, v in st2.items():
                    if v is not self._gst[k]:
                        self._gst[k].copy_(v)
                for k, v in y.items():
                    self._gout[k].index_copy_(0, self._gk, v.unsqueeze(0))
                self._gk.add_(1)
            launches = {k.__name__: k.launches - before[k.__name__]
                        for k in kernels.KERNELS if k.launches != before[k.__name__]}
            self._graphs[variant] = CapturedWindow(graph, launches,
                                                   seconds=time.perf_counter() - t0)
            self.captures += 1
        torch.cuda.synchronize(dev)
        if self._cache_ptrs() != ptrs:
            raise RuntimeError("a cache leaf moved during capture: the graphs "
                               "would write a stale buffer")
        self.capture_seconds = time.perf_counter() - t_start

    # -- the synchronous engine ------------------------------------------------

    def step(self):
        """Admit + refill, then run one ``sync_every``-token decode window.
        The sync engine harvests it at once (the step's single host sync);
        the overlapped engine harvests the trailing window and leaves this
        one in flight.  Idle calls (nothing active, nothing admitted)
        accrue no wall-clock."""
        if self.overlap:
            return self._step_async()
        t0 = time.perf_counter()
        if self._pages is not None:
            self._readmit_preempted()
        self._admit()
        self._refill()
        if self._pages is not None:
            self._lazy_topup()
        if not self._st["act"].any():
            return
        occ, qd = self.scheduler.occupancy, self.scheduler.queue_depth
        any_sampled = self._any_sampled()
        self._harvest(*self._window(self._load_state(), any_sampled), occ, qd)
        self._run_seconds += time.perf_counter() - t0

    def _harvest(self, state, ys, occ: int, qd: int):
        """The sync window's one host sync: mirror state, counters, emitted
        tokens (toks / emits are (K, B[, S]) with S = spec_depth + 1).  On
        a mesh whose slots split over "data" the window ran this rank's
        slot rows: one all-gather over "data" brings every rank's
        (``_gather_window``)."""
        if self._slot_groups > 1:
            state, ys = self._gather_window(state, ys)
        toks = ys["toks"].cpu().numpy()
        emits = ys["emits"].cpu().numpy()
        if toks.ndim == 2:
            toks, emits = toks[:, :, None], emits[:, :, None]
        self._st = {k: v.cpu().numpy() for k, v in state.items()}
        self.host_syncs += 1
        self.windows += 1
        self.tokens_emitted += int(emits.sum())
        self._occupancy_sum += occ
        self._queue_depth_sum += qd
        self._act_iters += int(ys["n_act"].sum())
        if "acc" in ys:
            acc = ys["acc"].sum(dim=0).cpu().numpy()
            prop = ys["prop"].sum(dim=0).cpu().numpy()
            self.draft_accepted += int(acc.sum())
            self.draft_proposed += int(prop.sum())
            if self.adaptive_spec:
                self._adaptive_update(np.ones(self.B, bool), self._st["act"], acc, prop)
        slot_req = self.scheduler.slot_req
        for k in range(toks.shape[0]):
            for j in range(toks.shape[2]):
                for i in np.nonzero(emits[k, :, j])[0]:
                    self._record_token(slot_req[i], int(toks[k, i, j]))
        for slot, r in enumerate(slot_req):
            if r is not None and not self._st["act"][slot]:
                self._finish(slot)

    def _gather_rows(self, rows: dict) -> dict:
        """Every data rank's slot rows of ``rows`` (key -> (n, ...) tensor,
        this rank's n slot rows) in one all-gather over "data": each leaf
        is carried as int64 words (floats by their bits), packed per slot
        row.  Returns key -> (B, ...), on the host."""
        n = self._slot_n
        parts, layout = [], []
        for key, t in rows.items():
            flat = t.reshape(n, -1)
            if flat.dtype == torch.float32:
                flat = flat.view(torch.int32)
            parts.append(flat.to(torch.int64))
            layout.append((key, t.dtype, tuple(t.shape[1:]), flat.shape[1]))
        full = self._mesh.all_gather(torch.cat(parts, dim=1), "data").cpu()
        out, col = {}, 0
        for key, dt, shape, w in layout:
            x = full[:, col:col + w]
            col += w
            x = (x.to(torch.int32).view(torch.float32) if dt == torch.float32
                 else x.to(dt))
            out[key] = x.reshape((self.B,) + shape)
        return out

    def _gather_window(self, state: dict, ys: dict):
        """Every data rank's slot rows of a window's final state and
        outputs (``_gather_rows``); the (K,) active counts ride every row
        and sum over the data ranks.  Returns (state, ys) over all B
        slots, on the host."""
        n = self._slot_n
        K = ys["n_act"].shape[0]
        rows = {("st", k): v for k, v in state.items()}
        for k, v in ys.items():
            rows[("ys", k)] = (v.reshape(1, K).expand(n, K) if k == "n_act"
                               else v.movedim(1, 0))    # (K, n[, S]) -> (n, K[, S])
        full = self._gather_rows(rows)
        out = {"st": {}, "ys": {}}
        for (kind, k), x in full.items():
            if kind == "ys":
                x = x[::n].sum(dim=0) if k == "n_act" else x.movedim(0, 1)
            out[kind][k] = x
        return out["st"], out["ys"]

    def _adaptive_update(self, ok, act, accs, props, installed=()):
        """Fold a window's per-slot accepted / proposed counts into the
        running ones and degrade cold-draft slots to plain decode.  Sticky
        per request: ``spec_on`` resets at the next admission.  A slot a
        continuous window installed into is skipped (its counts mix two
        requests)."""
        st = self._st
        degrade = []
        for s in range(self.B):
            if not ok[s] or s in installed:
                continue
            self._spec_acc[s] += int(accs[s])
            self._spec_prop[s] += int(props[s])
            if (st["spec_on"][s] and act[s]
                    and self._spec_prop[s] >= self.ADAPTIVE_MIN_PROPOSED
                    and self._spec_acc[s]
                        < self.ADAPTIVE_ACCEPT_FLOOR * self._spec_prop[s]):
                st["spec_on"][s] = False
                degrade.append(s)
        self.spec_degraded += len(degrade)
        if degrade and self._st_dev is not None:
            # overlapped engine: the carry lives on the device
            self._scatter_rows(degrade, {"spec_on": np.zeros(len(degrade), bool)})

    def run(self, max_steps: int = 10_000) -> list[Request]:
        """Drive until drained or ``max_steps`` completed (harvested)
        windows, then flush the pipeline and the backlog, so ``finished``
        streams are whole and ``metrics()`` settled.  A stuck load (a
        request that can never admit) exits via the idle guard."""
        idle = 0
        while self.scheduler.has_work or self._inflight:
            if self.windows >= max_steps:
                break
            before = (self.windows, self.host_syncs, self._dispatch_index)
            self.step()
            moved = (self.windows, self.host_syncs, self._dispatch_index) != before
            # a wave still being prepared (a first prefill may build its
            # kernels) is progress too: the step waited for it
            moved |= self._admission is not None and self._admission.busy
            idle = 0 if moved else idle + 1
            if idle > self.B + 2:
                break
        self.flush()
        if self.scheduler.has_work:
            warnings.warn(
                f"Engine.run stopped after {self.windows} completed windows "
                f"(max_steps={max_steps}) with {self.scheduler.queue_depth} "
                f"queued and {self.scheduler.occupancy} in-flight requests "
                f"unfinished (not a drain)", RuntimeWarning, stacklevel=2)
        return self.finished

    # -- the overlapped pipeline ------------------------------------------------
    #
    # The carry stays on the device (``_st_dev``: the static state under
    # aot) with up to ``pipeline_depth`` windows in flight.  At a boundary
    # the host (1) waits for the trailing window's packed status, retires
    # finished slots and hands its tokens to the backlog; (2) queues its
    # admission / refill / top-up decisions onto the carry as row scatters
    # behind the in-flight windows; (3) dispatches the next window.  The
    # numpy mirror ``_st`` stays authoritative for host-owned leaves and is
    # refreshed for act / cur / bpos at harvests, gated by per-slot epochs
    # (a harvested status is stale for slots touched at later boundaries).

    def _ensure_dev_state(self):
        if self._st_dev is None:
            self._st_dev = self._load_state()

    def _scatter_rows(self, slots, host_rows: dict, dev_rows: dict | None = None):
        """Write per-slot rows into the device carry, in place, behind the
        windows in flight (host rows through pinned asynchronous copies).
        Under continuous batching each row carries the host's ``gen`` of
        its slot and lands only where the device's still equals it: an
        install in a window in flight may have handed the slot to another
        request since the host decided."""
        guard = self._st["gen"][list(slots)] if self.continuous else None
        self._put_rows(self._st_dev, slots, host_rows, dev_rows, guard)

    def _put_rows(self, st, slots, host_rows: dict, dev_rows: dict | None = None,
                  guard=None):
        """Write rows ``slots`` of the device leaves ``st``, in place, from
        host rows and device rows; with ``guard`` (host ``gen`` values)
        only where ``st["gen"]`` equals it.  ``slots`` index all B slots
        (or staging rows); on a mesh whose slots split over "data" ``st``
        holds this rank's group, which takes its own rows only."""
        lo, n = self._slot_lo, self._slot_n
        mine = [i for i, s in enumerate(slots) if lo <= s < lo + n]
        if not mine:
            return
        if len(mine) < len(slots):
            host_rows = {k: np.asarray(v)[mine] for k, v in host_rows.items()}
            pick = self._dev(np.asarray(mine, np.int64))
            dev_rows = {k: v.index_select(0, pick) for k, v in (dev_rows or {}).items()}
            guard = None if guard is None else np.asarray(guard)[mine]
        idx = self._dev(np.asarray([slots[i] - lo for i in mine], np.int64))
        ok = None
        if guard is not None:
            ok = st["gen"].index_select(0, idx) == self._dev(np.asarray(guard, np.int32))
        rows = {k: self._dev(v) for k, v in host_rows.items()}
        rows.update(dev_rows or {})
        for k, v in rows.items():
            v = v.to(st[k].dtype)
            if ok is not None:
                v = torch.where(ok.reshape((-1,) + (1,) * (v.dim() - 1)), v,
                                st[k].index_select(0, idx))
            st[k][idx] = v

    def _staging_capacity(self) -> int:
        """How many more requests admission may pull off the queue: the
        prefilled-but-unmerged look-ahead (staged on the device included)
        is bounded by ``staging_depth``."""
        with self._sched_lock:
            return max(0, self.staging_depth - len(self.scheduler.staged))

    def _take_staged_locked(self, max_n: int) -> list[Request]:
        with self._sched_lock:
            return self.scheduler.take_staged(max_n)

    def _skip_rows(self, reqs) -> tuple[list[int], int]:
        """Prefill row per request (-1: prefill skipped on resident prefix
        pages) and the number of prefill rows."""
        rows, w = [], 0
        for r in reqs:
            skip = self._skip_prefill(r)
            rows.append(-1 if skip else w)
            w += not skip
        return rows, w

    def _prepare_wave(self, reqs, stream=None) -> StagedWave:
        """Stage a wave off the dispatch path: bucket the prompts, prefill
        them into a fresh cache and sample each row's first token; mutates
        no scheduler, pool or mirror state, so the admission worker runs it
        beside the boundary work (on ``stream``, its own, on a card).  The
        skip decision is a read-only registry probe; the merge re-resolves
        pages, and drift either way is correct (the rest of the prompt
        streams through the ingest buffer from wherever coverage ends)."""
        first_lens = [self.scheduler.first_chunk_len(r) for r in reqs]
        rows, w = self._skip_rows(reqs)
        specs = [r.sampling or self.sampling for r in reqs]
        keys0 = np.stack([sp.slot_key(r.uid) for sp, r in zip(specs, reqs)])
        keys0 = keys0.astype(np.int64)
        eos = np.array([-1 if r.eos_id is None else r.eos_id for r in reqs], np.int64)
        full = np.array([ri >= 0 and fl == len(r.prompt)
                         for r, fl, ri in zip(reqs, first_lens, rows)], bool)
        wave = StagedWave(reqs=list(reqs), first_lens=first_lens, specs=specs,
                          keys0=keys0, eos=eos, full=full, rows=rows)
        if not w:
            return wave
        ctx = (torch.cuda.stream(stream) if stream is not None
               else contextlib.nullcontext())
        with ctx:
            toks, lens = self._bucket_prompts(reqs, first_lens, rows, w)
            self._count_prefill()
            logits, wave.new_cache = self._prefill(self.cfg, self.params, toks, lens)
            if self.draft_cache is not None:
                _, wave.draft_new_cache = self._prefill(self.draft_cfg,
                                                        self.draft_params, toks, lens)
            wave.ks, wave.first = self._sample_first(logits, keys0, specs, rows)
            wave.first_host = self._host(wave.first)
            wave.ready = self._event(stream)
        return wave

    def _admit_overlap(self):
        """Boundary admission: collect prepared waves (from the worker, or
        prepared inline) and merge them into free slots, or under
        continuous batching into the device staging queue.
        ``host_syncs`` / ``admission_syncs`` tick once per wave at its
        first merge, keeping host_syncs == windows + admission_syncs.
        In lockstep (a mesh) the waves submitted at earlier boundaries are
        collected here, waited for if need be, and this boundary submits
        the next one: what a boundary merges never depends on the worker's
        timing, so every rank merges the same waves at the same boundary."""
        if self._admission is not None and self._admission.lockstep:
            self._staged_waves.extend(self._admission.collect())
        elif self._admission is not None:
            self._staged_waves.extend(self._admission.poll())
        else:
            cap = self._staging_capacity()
            if cap > 0:
                reqs = self._take_staged_locked(cap)
                if reqs:
                    self._staged_waves.append(self._prepare_wave(reqs))
        if self.continuous:
            self._stage_from_waves()
        else:
            self._place_from_waves()
        if self._admission is not None and self._admission.lockstep:
            cap = self._staging_capacity()
            reqs = self._take_staged_locked(cap) if cap > 0 else []
            if reqs:
                self._admission.submit(reqs)
        elif self._admission is not None:
            self._admission.kick(self._staging_capacity())

    def _place_from_waves(self):
        """Merge prepared waves into free slots, head of line first: a wave
        that does not fully fit (slots or pages) blocks the ones behind it
        and resumes at the next boundary."""
        while self._staged_waves:
            wv = self._staged_waves[0]
            todo = wv.reqs[wv.merged:]
            if not todo:
                self._staged_waves.popleft()
                continue
            with self._sched_lock:
                n = min(len(todo), len(self.scheduler.free_slots()))
            if self._pages is not None:
                fits = self._page_fits()
                fit = 0
                for r in todo[:n]:
                    if not fits(r):
                        break
                    fit += 1
                n = fit
            if n == 0:
                return
            if wv.merged == 0:
                self.host_syncs += 1
                self.admission_syncs += 1
                if wv.ready is not None:
                    self._adopt_wave(wv)
            with self._sched_lock:
                placed = self.scheduler.place_wave(todo[:n])
            self._merge_wave_rows(wv, placed, list(range(wv.merged, wv.merged + n)))
            wv.merged += n
            if wv.merged < len(wv.reqs):
                return
            self._staged_waves.popleft()

    def _adopt_wave(self, wv: StagedWave):
        """Hand a wave made on the admission stream to the main stream: the
        main stream waits for the wave's event, and its tensors are marked
        as used there, so their memory is not reused before the main
        stream's merges have read them."""
        main = torch.cuda.current_stream(self.device)
        main.wait_event(wv.ready)
        leaves = [wv.ks, wv.first]
        for cache in (wv.new_cache, wv.draft_new_cache):
            leaves += T.cache_leaves(cache or [])
        for t in leaves:
            t.record_stream(main)

    def _merge_wave_rows(self, wv: StagedWave, placed, idx):
        """Merge wave requests ``idx`` into their placed slots: cache
        scatter, mirror bookkeeping, carry-row scatter and the deferred
        first-token emission — the device half of what ``_admit`` does
        synchronously, queued behind the windows in flight."""
        st = self._st
        # the merge's page walk is authoritative: a skip member's coverage
        # resident now replaces the worker's probe
        lens = self._merge_prefill(
            [(s, r, wv.rows[i], wv.first_lens[i]) for i, (s, r) in zip(idx, placed)],
            wv.new_cache, wv.draft_new_cache)
        for i, fl in zip(idx, lens):
            wv.first_lens[i] = fl
        for i, (slot, r) in zip(idx, placed):
            self._admit_bookkeep(slot, r, wv.specs[i], wv.first_lens[i])
            st["keys"][slot] = wv.keys0[i]    # placeholder: the device holds the truth
            if wv.full[i]:
                self._admit_tokens += 1
            self._slot_epoch[slot] = self._dispatch_index
            self._buf_epoch[slot] = self._dispatch_index
        # host-known rows from the mirror the bookkeeping just wrote; tok,
        # keys and act depend on the sampled first token and stay on device
        slots = [s for s, _ in placed]
        host_rows = {k: v[slots] for k, v in st.items() if k not in ("tok", "keys", "act")}
        self._scatter_rows(slots, host_rows, self._first_rows(wv, idx))
        entries = [(r, wv.rows[i]) for i, (_, r) in zip(idx, placed) if wv.full[i]]
        if entries:
            self._backlog.put(self._timed(self._admit_item(wv, entries), "backlog_drain"))

    def _first_rows(self, wv: StagedWave, idx) -> dict:
        """The (tok, act, keys) rows of wave requests ``idx``, on the
        device: they depend on the sampled first token."""
        t = self._dev
        keys0 = t(wv.keys0[idx])
        if wv.first is None:
            # all-skip wave: no first tokens; every row starts active with
            # its base key, feeding from the ingest buffer
            return {"tok": torch.zeros_like(keys0[:, 0]),
                    "act": torch.ones_like(keys0[:, 0], dtype=torch.bool),
                    "keys": keys0}
        prow = t([max(wv.rows[i], 0) for i in idx])
        # a skip member (row -1) of a mixed wave is not "full": it feeds
        full = t(wv.full[idx])
        first = wv.first[prow]
        left = t(np.array([wv.reqs[i].max_new_tokens - 1 for i in idx], np.int64))
        return {
            "tok": torch.where(full, first, 0),
            # a whole-prompt row can end at its first token (eos, or a
            # spent budget), as the window would check
            "act": torch.where(full, (first != t(wv.eos[idx])) & (left > 0), True),
            "keys": torch.where(full[:, None], wv.ks[prow][:, 0], keys0)}

    def _admit_item(self, wv: StagedWave, entries):
        def item():
            if wv.ready is not None:
                wv.ready.synchronize()
            first = wv.first_host.numpy()
            for r, i in entries:
                self._record_token(r, int(first[i]))
        return item

    # -- continuous batching: the host half ---------------------------------

    def _stage_bookkeep(self, r: Request, sp: SamplingParams, first_len: int):
        """The host-known carry row of a staged request: ``_carry_fields``
        over a zero row, whole, so the install can land it on whichever
        slot the device picks.  Returns (row per state leaf, pending
        prompt tail)."""
        row = {k: np.zeros(v.shape[1:], v.dtype) for k, v in self._st.items()}
        fields, pending = self._carry_fields(r, sp, first_len)
        for k, v in fields.items():
            row[k][...] = v
        return row, pending

    def _stage_from_waves(self):
        """Continuous batching: move prepared wave requests into free
        device staging rows, head of line first; on the pool a request
        stages only once its whole reach fits the free pages.  Requests
        stay in ``scheduler.staged`` until a harvest reports their
        install; the window picks the slot."""
        while self._staged_waves:
            wv = self._staged_waves[0]
            if wv.merged >= len(wv.reqs):
                self._staged_waves.popleft()
                continue
            if self._stage_run(wv) == 0:
                return

    def _free_stage_row(self) -> int | None:
        """The staging row for the next staged request, None when every row
        is taken: the lowest free one; on a mesh whose slots split over
        "data", in the slot group whose slots are least spoken for (its
        staged requests less its free slots, by the host's view), lowest
        group first, so a request waits where a slot frees soonest."""
        n, best = self._slot_n, None
        for g in range(self._slot_groups):
            rows = range(g * n, (g + 1) * n)
            free = [q for q in rows if self._stage_tab[q] is None]
            if not free:
                continue
            load = (n - len(free)) - sum(self.scheduler.slot_req[s] is None for s in rows)
            if best is None or load < best[0]:
                best = (load, free[0])
        return None if best is None else best[1]

    def _stage_run(self, wv: StagedWave) -> int:
        """Stage wave requests from ``wv.merged`` on into free staging rows
        (``_free_stage_row``), in order, while rows (and pages) last.  Per
        request, on the host: its pages (mapped now; the pool's content is
        scattered now, onto pages no window reads until the install copies
        their table row), its carry row, its ``seq`` key.  Then one
        batched device write per leaf on the main stream, the keys last,
        so a window that sees a key sees its row.  Returns the number
        staged."""
        idx, qs, ents = [], [], []
        rws, cols, phys = [], [], []
        while wv.merged + len(idx) < len(wv.reqs):
            i = wv.merged + len(idx)
            r, ri = wv.reqs[i], wv.rows[i]
            if (self._pages is not None
                    and self._pages_needed(r) > self._pages.free_count):
                break
            q = self._free_stage_row()
            if q is None:
                break
            if not idx and wv.merged == 0:
                self.host_syncs += 1
                self.admission_syncs += 1
                if wv.ready is not None:
                    self._adopt_wave(wv)
            mapping = None
            if self._pages is not None:
                if ri < 0:
                    mapping, wv.first_lens[i] = self._map_shared_pages(r)
                else:
                    mapping, scat = self._map_pages(r, wv.first_lens[i])
                    rws += [ri] * len(scat)
                    cols += scat
                    phys += [mapping[j] for j in scat]
            row, pending = self._stage_bookkeep(r, wv.specs[i], wv.first_lens[i])
            if mapping is not None:
                row["ptab"][: len(mapping)] = mapping
            ent = StagedEntry(req=r, host_row=row, pending=pending, pages=mapping,
                              seq=self._stage_seq_next, keys0=wv.keys0[i],
                              full=bool(wv.full[i]))
            self._stage_seq_next += 1
            self._stage_tab[q] = ent
            self._stage_by_seq[ent.seq] = (q, ent)
            idx.append(i)
            qs.append(q)
            ents.append(ent)
        if not idx:
            return 0
        t = self._dev
        stage = self._stage
        if phys:
            _merge_slot_paged(self.cache, wv.new_cache, t(rws), t(cols), t(phys),
                              self.page_size, mesh=self._mesh)
        # the stage cache takes this rank's rows (its slot group's)
        lo, n = self._slot_lo, self._slot_n
        pre = [(q - lo, wv.rows[i]) for q, i in zip(qs, idx)
               if wv.rows[i] >= 0 and lo <= q < lo + n]
        if "cache" in stage and pre:
            _merge_slot(stage["cache"], wv.new_cache, t([q for q, _ in pre]),
                        rows=t([ri for _, ri in pre]), mesh=self._mesh)
        host_rows = {k: np.stack([e.host_row[k] for e in ents])
                     for k in self._st if k not in ("tok", "keys", "act")}
        self._put_rows(stage["rows"], qs, host_rows, self._first_rows(wv, idx))
        self._put_rows(stage, qs, {"seq": np.array([e.seq for e in ents], np.int32)})
        entries = [(e.req, wv.rows[i]) for i, e in zip(idx, ents) if e.full]
        if entries:
            # the first token is emitted at stage time, as a direct admission
            # emits it; the backlog's order puts it before the request's
            # window tokens
            self._admit_tokens += len(entries)
            self._backlog.put(self._timed(self._admit_item(wv, entries), "backlog_drain"))
        wv.merged += len(idx)
        return len(idx)

    def _install_entry(self, w: InflightWindow, s: int, q: int, ent: StagedEntry):
        """Confirm an install a harvested window reports: the device already
        holds slot ``s``'s carry row; the scheduler, the mirror, the pages
        and the epochs catch up here."""
        if self.scheduler.slot_req[s] is not None:
            # the previous occupant ended in this window before the install;
            # its last tokens ride this window's backlog item
            self._finish(s)
        with self._sched_lock:
            self.scheduler.place(s, ent.req)
        st = self._st
        for k, v in ent.host_row.items():
            if k != "gen":
                st[k][s] = v
        st["gen"][s] += 1                 # the install's bump, mirrored
        self.scheduler.set_pending(s, np.asarray(ent.pending, np.int64))
        if self._pages is not None:
            self._slot_pages[s] = list(ent.pages)
        self._slot_epoch[s] = w.index
        self._buf_epoch[s] = w.index
        self._spec_acc[s] = 0
        self._spec_prop[s] = 0
        # windows dispatched before the harvest snapshot the old occupant:
        # they credit the new one from their first iteration on
        w.slot_reqs[s] = ent.req
        for wf in self._inflight:
            wf.slot_reqs[s] = ent.req
        self._stage_tab[q] = None

    def _refill_async(self):
        """Refill drained ingest buffers and scatter them into the carry.
        The mirror's (bpos, avail) pair is epoch-gated at harvest, so a
        chunk loaded at boundary d is not loaded again off a pre-d status."""
        st = self._st
        slots = [slot for slot, r in enumerate(self.scheduler.slot_req)
                 if (r is not None and st["act"][slot]
                     and st["bpos"][slot] >= st["avail"][slot]
                     and self.scheduler.pending_len(slot) > 0)]
        if not slots:
            return
        for slot in slots:
            self._load_chunk(slot)
            self._buf_epoch[slot] = self._dispatch_index
        self._scatter_rows(slots, {k: st[k][slots] for k in ("buf", "avail", "bpos", "more")})

    def _dispatch_window(self) -> bool:
        """Launch the next window on the carry and queue the host copies
        of its packed status and outputs behind it.  False when nothing is
        active by the host's view and (under continuous batching) nothing
        is staged for an install."""
        staged = self.continuous and any(e is not None for e in self._stage_tab)
        if not (self._st["act"].any() or staged):
            return False
        occ, qd = self.scheduler.occupancy, self.scheduler.queue_depth
        prior = self._inflight[-1] if self._inflight else None
        overlapped = (prior is not None and prior.ready is not None
                      and not prior.ready.query())
        st2, ys = self._window(self._st_dev, self._any_sampled())
        self._st_dev = st2
        parts = [st2["act"], st2["bpos"], st2["cur"]]
        if self.continuous:
            parts.append(st2["gen"])
        if self.adaptive_spec:
            parts += [ys["acc"].sum(dim=0), ys["prop"].sum(dim=0)]
        if self.continuous:
            parts += [ys["sw_seq"], ys["sw_slot"]]
        parts.append(ys["n_act"].sum().reshape(1))
        status = torch.cat([p.to(torch.int32) for p in parts])
        spec = "acc" in ys
        w = InflightWindow(
            index=self._dispatch_index, status=self._host(status),
            toks=self._host(ys["toks"]), emits=self._host(ys["emits"]),
            slot_reqs=list(self.scheduler.slot_req), occ=occ, qd=qd,
            overlapped=overlapped,
            acc=self._host(ys["acc"].sum()) if spec else None,
            prop=self._host(ys["prop"].sum()) if spec else None)
        w.ready = self._event()
        self._inflight.append(w)
        self._dispatch_index += 1
        if overlapped:
            self._overlapped_windows += 1
        return True

    def _harvest_trailing(self):
        """Wait for the trailing window's status (the pipeline's one device
        sync), confirm the window's installs, refresh the epoch-eligible
        mirror slots, retire finished requests and hand the window's tokens
        to the backlog."""
        w = self._inflight.popleft()
        t0 = time.perf_counter()
        if w.ready is not None:
            w.ready.synchronize()
        if self._slot_groups > 1:
            self._gather_inflight(w)
        status = w.status.numpy()
        t1 = time.perf_counter()
        self._prof_add("harvest", t0, t1 - t0)
        self.host_syncs += 1
        self.windows += 1
        self._occupancy_sum += w.occ
        self._queue_depth_sum += w.qd
        B = self.B
        act = status[:B].astype(bool)
        bpos, cur = status[B: 2 * B], status[2 * B: 3 * B]
        off = 3 * B + (B if self.continuous else 0)    # gen: mirrored per install
        accs = props = None
        if self.adaptive_spec:
            accs, props = status[off: off + B], status[off + B: off + 2 * B]
            off += 2 * B
        installs = []
        if self.continuous:
            # K installs a slot group's window iteration can make, per group
            K = self.sync_every
            nsw = K * self._slot_groups
            sw_seq, sw_slot = status[off: off + nsw], status[off + nsw: off + 2 * nsw]
            off += 2 * nsw
            for j in range(nsw):
                if sw_seq[j] >= 0:
                    q, ent = self._stage_by_seq.pop(int(sw_seq[j]))
                    installs.append((j % K, int(sw_slot[j]), q, ent))
            installs.sort(key=lambda x: x[0])
        self._act_iters += int(status[off])
        # the item credits each iteration's tokens to whoever held the slot
        # then: the map at dispatch, changed at each install's iteration
        item = self._window_item(w, list(w.slot_reqs),
                                 [(k, s, ent.req) for k, s, _, ent in installs])
        for _, s, q, ent in installs:
            self._install_entry(w, s, q, ent)
        ok = self._slot_epoch <= w.index
        if accs is not None:
            self._adaptive_update(ok, act, accs, props, {s for _, s, _, _ in installs})
        self._st["act"][ok] = act[ok]
        self._st["cur"][ok] = cur[ok]
        bok = ok & (self._buf_epoch <= w.index)
        self._st["bpos"][bok] = bpos[bok]
        self._backlog.put(self._timed(item, "backlog_drain"))
        for slot, r in enumerate(w.slot_reqs):
            if (r is not None and ok[slot] and not act[slot]
                    and self.scheduler.slot_req[slot] is r):
                self._finish(slot)
        self.slot_swaps += len(installs)
        self._prof_add("bookkeep", t1, time.perf_counter() - t1)

    def _gather_inflight(self, w: InflightWindow):
        """A window's host copies over every slot group, in place, in one
        all-gather over "data" (``_gather_rows``): the per-slot status
        fields and the tokens concatenate in group order, an install's
        slot becomes global, the stepping counts and the draft totals sum
        (the per-group values ride every row, as in ``_gather_window``):
        one device's window layout, but for the installs, K per group."""
        n, G, K = self._slot_n, self._slot_groups, self.sync_every
        nf = 3 + self.continuous + 2 * self.adaptive_spec     # per-slot fields
        rows = {"slot": w.status[:nf * n].reshape(nf, n).T,
                "group": w.status[nf * n:].reshape(1, -1).expand(n, -1),
                "toks": w.toks.movedim(1, 0), "emits": w.emits.movedim(1, 0)}
        if w.acc is not None:
            rows["draft"] = torch.stack([w.acc, w.prop]).reshape(1, 2).expand(n, 2)
        full = self._gather_rows(rows)
        group = full["group"][::n]                 # (G, [2K sw +] 1 n_act)
        out = [full["slot"].T.reshape(-1)]
        if self.continuous:
            sw_slot = group[:, K:2 * K]
            base = n * torch.arange(G, dtype=sw_slot.dtype)[:, None]
            out += [group[:, :K].reshape(-1),
                    torch.where(sw_slot >= 0, sw_slot + base, sw_slot).reshape(-1)]
        out.append(group[:, -1].sum().reshape(1))
        w.status = torch.cat(out)
        w.toks, w.emits = full["toks"].movedim(0, 1), full["emits"].movedim(0, 1)
        if w.acc is not None:
            w.acc, w.prop = full["draft"][::n].sum(dim=0)

    def _window_item(self, w: InflightWindow, slot_reqs: list, swaps=()):
        """The backlog item crediting ``w``'s tokens: ``slot_reqs`` is the
        slot map at the window's start, ``swaps`` the (iteration, slot,
        request) of its installs."""
        at: dict[int, list] = {}
        for k, s, r in swaps:
            at.setdefault(k, []).append((s, r))

        def item():
            toks, emits = w.toks.numpy(), w.emits.numpy()
            if toks.ndim == 2:
                toks, emits = toks[:, :, None], emits[:, :, None]
            nemit = int(emits.sum())
            with self._mlock:
                self.tokens_emitted += nemit
                if nemit == 0:
                    # a pipeline bubble: every slot the host believed active
                    # died in the window in flight when this one launched
                    self.windows_idle += 1
                if w.acc is not None:
                    self.draft_accepted += int(w.acc)
                    self.draft_proposed += int(w.prop)
            reqs = slot_reqs
            for k in range(toks.shape[0]):
                for s, r in at.get(k, ()):
                    reqs[s] = r
                for j in range(toks.shape[2]):
                    for i in np.nonzero(emits[k, :, j])[0]:
                        self._record_token(reqs[i], int(toks[k, i, j]))
        return item

    def _step_async(self):
        """One overlapped boundary: harvest the trailing window once
        ``pipeline_depth`` windows are in flight, merge staged admissions
        and refills into the carry, dispatch the next window."""
        t0 = time.perf_counter()
        if len(self._inflight) >= self.pipeline_depth:
            self._harvest_trailing()
        self._ensure_dev_state()
        t1 = time.perf_counter()
        if self._pages is not None:
            self._readmit_preempted()
        self._admit_overlap()
        self._refill_async()
        if self._pages is not None:
            self._lazy_topup()
        t2 = time.perf_counter()
        self._prof_add("admission_stage", t1, t2 - t1)
        dispatched = self._dispatch_window()
        self._prof_add("dispatch", t2, time.perf_counter() - t2)
        if not dispatched:
            if self._inflight:
                # nothing to decode by the host's (possibly stale) view:
                # drain a window, whose harvest may retire slots and
                # unblock the queue
                self._harvest_trailing()
            elif (self._admission is not None and not self._admission.lockstep
                  and (self._admission.busy or self.scheduler.queue_depth > 0)):
                # nothing on the device, but a wave is being prepared: wait
                # (bounded) for it instead of spinning the idle guard down
                self._admission.wait(timeout=1.0)
        self._run_seconds += time.perf_counter() - t0

    def _prof_add(self, stage: str, t0: float, dur: float):
        with self._mlock:
            self._prof[stage] += dur
            if self.profile and len(self._prof_events) < 100_000:
                self._prof_events.append({"stage": stage, "t": t0 - self._prof_t0,
                                          "dur": dur})

    def _timed(self, fn, stage: str):
        """Wrap a backlog item so its wall-clock accrues to ``stage`` on
        whichever thread runs it."""
        def run():
            t0 = time.perf_counter()
            try:
                fn()
            finally:
                self._prof_add(stage, t0, time.perf_counter() - t0)
        return run

    def flush(self):
        """Drain the pipeline: harvest every window in flight and wait for
        the backlog.  A no-op on the sync engine."""
        t0 = time.perf_counter()
        while self._inflight:
            self._harvest_trailing()
        if self._backlog is not None and self._backlog.started:
            self._backlog.flush()
        self._run_seconds += time.perf_counter() - t0

    def close(self):
        """Flush and join the worker threads.  Idempotent; ``metrics`` and
        ``finished`` stay readable after."""
        if self._admission is not None:
            self._admission.close()
        self.flush()
        if self._backlog is not None:
            self._backlog.close()

    def __enter__(self) -> "Engine":
        return self

    def __exit__(self, *exc):
        self.close()

    # -- metrics -------------------------------------------------------------

    def metrics(self) -> dict[str, Any]:
        """Serving counters since construction (host_syncs counts one per
        window harvest plus one per admission wave).  ``pages_free`` counts
        the allocatable free list only; pinned pages at refcount 0 are
        parked (resident, not allocatable) and counted apart, and
        ``pages_shared`` counts share events (retains) since construction.
        Under overlap the token counts settle on the backlog worker (flush
        or close first for exact totals); ``window_overlap`` is the share of
        windows dispatched before the one ahead of them had finished on the
        device, ``windows_idle`` counts harvested windows that emitted
        nothing, ``slot_swaps`` the installs continuous batching made inside
        windows.  ``captures`` counts the CUDA graphs ``aot`` captured at
        construction (it never moves after); ``graphs`` gives each one's
        kernel launches per replay, replays and capture seconds."""
        with self._mlock:
            tokens = self.tokens_emitted + self._admit_tokens
            windows_idle = self.windows_idle
            ttft = self._ttft_sum / self._ttft_n if self._ttft_n else 0.0
            draft_proposed, draft_accepted = self.draft_proposed, self.draft_accepted
            prefill_calls = self.prefill_calls
            prof = dict(self._prof)
        if self._admission is not None:
            prof["admission_worker"] = self._admission.prepare_seconds
        ptotal = sum(prof.values())
        w = max(self.windows, 1)
        pool = self._pages
        paged = {"page_size": 0, "pages_total": 0, "pages_free": 0,
                 "pages_parked": 0, "pages_shared": 0, "pages_peak": 0,
                 "cow_forks": 0, "pages_pinned": 0, "prefix_resurrections": 0}
        if pool is not None:
            paged = {"page_size": self.page_size, "pages_total": self.n_pages,
                     "pages_free": pool.free_count, "pages_parked": pool.parked,
                     "pages_shared": pool.share_events,
                     "pages_peak": pool.peak_used, "cow_forks": pool.cow_forks,
                     "pages_pinned": pool.pinned,
                     "prefix_resurrections": pool.prefix_resurrections}
        return {
            "tokens": tokens,
            "mesh": self.mesh_str,
            "mesh_stats": dict(self.mesh.stats, gathered_weight_bytes=getattr(
                self.params, "gathered_bytes", 0)),
            "windows": self.windows,
            "sync_every": self.sync_every,
            "cache_layout": self.cache_layout,
            **paged,
            "pin_prefixes": self.pin_prefixes,
            "lazy_pages": self.lazy_pages,
            "preemptions": self.preemptions,
            "prefill_calls_saved": self.prefill_calls_saved,
            "backend": self.cfg.attn_backend,
            "verify_backend": self._verify_backend,
            "spec_depth": self.spec_depth,
            "draft": None if self.draft is None else str(self.draft),
            "draft_proposed": draft_proposed,
            "draft_accepted": draft_accepted,
            "accept_rate": draft_accepted / draft_proposed if draft_proposed else 0.0,
            "adaptive_spec": self.adaptive_spec,
            "spec_degraded": self.spec_degraded,
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
            "overlap": self.overlap,
            "aot": self.aot,
            "pipeline_depth": self.pipeline_depth if self.overlap else 0,
            "continuous": self.continuous,
            "slot_swaps": self.slot_swaps,
            "staging_depth": self.staging_depth,
            "admission_thread": self.admission_thread,
            "window_overlap": (self._overlapped_windows / max(self._dispatch_index, 1)
                               if self.overlap else 0.0),
            "windows_idle": windows_idle,
            "captures": self.captures,
            "capture_s": self.capture_seconds,
            "graphs": {k: {"launches": dict(g.launches), "replays": g.replays,
                           "capture_s": g.seconds} for k, g in self._graphs.items()},
            "policy": self.policy.name,
            "prefill_calls": prefill_calls,
            "profile": {"seconds": prof,
                        "shares": {k: (v / ptotal if ptotal else 0.0)
                                   for k, v in prof.items()}},
            "ttft_s": ttft,
            "run_seconds": self._run_seconds,
            "tokens_per_s": tokens / self._run_seconds if self._run_seconds else 0.0,
        }
