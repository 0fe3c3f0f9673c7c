#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; none is caught):

1. versions, and the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
   all at once) and print each nvcc's build time and each kernel's ptxas
   registers and spills; no kernel of ``latent_decode_tc.cu`` (the bf16
   tensor-core bodies of K1 and K3-K7, every block plan down to 64-column
   chunks) or of ``dense_verify.cu`` may spill;
3. each kernel — K1, K2, K3 (int8 decode), K5 (multi-query verify), K6
   (int8 multi-query verify), K4 and K7 (K1 and K5 over the paged pool,
   through a ragged page table) — at the main path's shapes against its
   plain PyTorch version, in float32 (TF32 off) and bf16, and timed
   beside the plain version, a PyTorch library call where one computes
   the same function, and the least time the card could take (its bound);
   K2, K4 and K7 are timed over 50 launches.  K4 and K7 must equal K1 and
   K5 on the table-gathered ring bit for bit in both types (same tiles,
   same order; in bf16 K4 / K7 and K1 / K5 are one tensor-core body with
   two row maps), and in bf16 each must also equal itself on an in-order
   placement of the same pages; both are timed beside K1 / K5 on that
   ring.  Then the bf16 bodies at widths off the main path within the
   bf16 limit: K1 at ranks 152, 384 and 512, K6 at 5 and 8 verify queries
   and rank 512, K5 at 2 verify queries and rank 624; all six at
   group_size 8 (G = 1, s = 8, Hg = 32 query rows per group) at ranks
   512, 768 and 1024, K4 equal to K1 and K7 to K5 bit for bit; K1 and K5
   at group_size 8 on full 4096-token rings at ranks 544-1024, timed
   beside their bounds (what the 64-column plan costs); and K2 at value
   widths 128, 152, 384, 512 and 1024 in float32 and bf16; then the dense
   cores at qwen3-4b's heads (Hkv = 8, q_per_kv 4, dh 128): K1's and K4's
   dense cores, the dense decode kernel (``csrc/dense_decode.cu``), and
   K5's and K7's (nq = 4: 16 query rows a kv head, one m16 tile; nq = 16:
   64 rows, one row group on ``wgmma``; and on the ring nq = 9: 36 rows,
   one partial group), the dense verify kernel
   (``csrc/dense_verify.cu``), each on the ring and on the ragged pool,
   the pool equal to the ring kernel on the gathered view bit for bit (and
   in bf16 to itself on an in-order page placement), each timed beside the
   route it replaces (K1 / K4 / K5 / K7 at an identity R_k and identity
   rotation tables, G = Hkv = 8 groups of one kv head, r = dh = 128) in
   the same call; all in f32 and bf16, each timed beside its bound and one
   ``scaled_dot_product_attention`` call (GQA, additive mask) on the same
   ring plus the self columns, with the SDPA backend PyTorch picks; the
   dense decode at 8 rows a kv head on both of its bodies (the CUDA-core
   body of ``dense_decode.cu`` and the m16 tensor-core body of
   ``dense_verify.cu``, which the wrapper runs from 8 rows), each against
   its plain version and timed (``decode_bodies`` in the JSON line); and
   the float32 template at the widths its row-block plans open (K1 and K5
   at group_size 8, ranks 768 / 1024, nq 1 / 4); then the families'
   widths: every body on gemma3-12b's path at dh 256 (K1, K3, K5, K6 at
   B 8, a 4,096-token ring, G 2, Hg 8, r 512, nq 1 / 4; K2 at B 8, T 2,048,
   H 16, Hkv 8 with Hv 2, dv 512 causal and within a 1,024 window, and
   dense, dv 256; the dense decode and verify kernels at Hkv 8, q_per_kv
   2) and minicpm-2b's pools at q_per_kv 1 (K4 at G 9, Hg 4, r 128, dh 64;
   the dense verify kernel's pool at Hkv 36, nq 4), rows tagged "(dh 256)"
   / "(q_per_kv 1)"; then h2o-danube-1.8b's d_head 80 in every body on
   its path (K1, K3, K5, K6 at G 2, Hg 16, r 160; K2 at H 32, Hkv 8, Hv 2,
   dv 160, causal and within a 1,024 window, and dense, dv 80; the dense
   decode and verify kernels at Hkv 8, q_per_kv 4) and qwen3-moe-235b-a22b's
   q_per_kv 16 in every body (K1, K3, K5, K6, K4, K7 at G 1, Hg 64, r 256;
   K2 at H 64 over Hkv 4, Hv 1, dv 256, and dense, dv 128; the dense decode
   at 16 rows on the verify kernel's m16 body and the verify, ring and pool,
   at Hkv 4, nq 4: 64 rows a kv head, and on the ring nq 16: 256 rows,
   four row groups),
   rows tagged "(dh 80)" / "(q_per_kv 16)"; then whisper-small's widths
   (K1 at G 3, Hg 4, dh 64, r 128; K2 at H 12 over Hkv 12, Hv 3, dv 128;
   the dense decode at Hkv 12, q_per_kv 1, dh 64), rows tagged
   "(whisper, dh 64)" (llama-3.2-vision-11b's self layers have qwen3-4b's
   widths).  Every kernel time is
   device time: ``cuda_ms`` queues the launches behind a device sleep;
4. full-width qwen3-4b with a ReCalKV latent cache (recalkv_ratio 0.5,
   r = 256), bf16, random weights from a seeded torch.Generator; first
   continuous batching's row copy (``csrc/stage_install.cu``) on a ring and
   a stage cache of that model (8 rows x 4,096 positions), bit for bit
   against its plain version installing and idle, each timed; then prefill
   and decode steps, and prefill and one 4-token verify step on float and
   int8 rings, through the einsum reference and the kernel backend; then
   a decode step and a 4-token verify step at the next position on paged
   float and int8 pools holding the ring's content: every logit must equal
   the ring's bit for bit (on the float pool also before any write);
5. the same model served through ``Engine`` (8 slots, max_len 4096) in
   ten runs, each with the kernel launch counts of that run:
   A, float ring, no speculation, one chunked prompt (K1, K2);
   B, int8 ring, spec_depth 3, draft "layers:4", one chunked prompt (K2,
   K3 in the draft's decode steps, K6 in verify);
   C, float ring, spec_depth 3, "ngram" draft on prompts that repeat a
   motif (K2, K5);
   D, the paged float pool (page_size 16) with prefix-affinity admission,
   lazy pages and one pinned prefix, 12 requests sharing a 1024-token
   system prompt in a pool small enough to preempt (K2, K4); it must share
   pages and preempt at least once;
   E, the paged pool with spec_depth 3, "ngram" and reach-packing on C's
   prompts (K2, K7); its streams must equal C's token for token;
   F, the float ring of the model at group_size 8 (one latent group of 8
   kv heads and 32 query heads, r = 512; its own random weights), one
   512-token prompt (K2 at dv = 512, K1 at 32 query rows per group), after
   its kernel backend's decode logits are held to the einsum reference's;
   G, the model at group_size 8 and r = 768 (keep ratio 0.75; its own
   random weights, F's freed first), float ring, spec_depth 3, "ngram" on
   C's prompts (K2 at dv = 768, K5 at 32 query rows per group and rank
   768: 64-column chunks), after its kernel backend's decode and verify
   logits are held to the einsum reference's;
   A+, B+ and D+: runs A, B (with ``adaptive_spec``) and D served again by
   the overlapped engine with its window captured as CUDA graphs
   (``overlap=True, aot=True``); each run's streams must equal its sync
   run's token for token, two graphs must be captured at construction and
   ``captures`` may not move while serving, and a run's launches are the
   eager prefill's plus each graph's captured launches times its replays;
   D+s8: D+ at ``staging_depth=8`` (peak memory beside D+'s at 16);
   S, continuous batching on the float ring: 24 prompts of 512-2048
   tokens with budgets of 16-96 cycled, served sync, overlapped + graphs
   at pipeline depth 3 and the same with ``continuous=True`` (streams
   equal, installs inside the windows through the row copy);
6. the dense qwen3-4b (``recalkv=None``; its own random weights, G's
   freed first): prefill, decode and a 4-token verify step through both
   backends (logits within 5e-2 relative), decode and verify on a paged
   pool equal to the ring's bit for bit (these steps' launches count as
   the run "steps": the dense decode and verify kernels on the ring and
   the pool); then
   H, float ring, no speculation, 4 prompts of 512-1024 tokens (one
   streams 256 tokens through the decode loop) (K2 at Hv = 8, dv = 128,
   the dense decode kernel); K1, K4, K5 and K7, the dense cache's old
   route, must count 0 launches over the steps, H and I;
   I, the paged pool with spec_depth 3, "ngram" and reach-packing on C's
   prompts (the dense verify kernel's pool);
   I9, I at spec_depth 8 (9 verify queries: 36 query rows a kv head, one
   row group of the dense verify kernel);
   H+ and I+: H and I overlapped with CUDA graphs, as A+;
   T, continuous batching on the dense pool with ``spec_depth=3``,
   "ngram": 16 motif prompts of 320-512 tokens, served three ways as S;
   J, compress then serve: ``api.calibrate`` on 8 synthetic sequences of
   512 tokens, ``api.compress`` ("recalkv", keep ratio 0.5, backend
   "pallas": G = 2, r = 256), ``save_artifact`` under ``build/``, the
   dense model freed, ``Engine.from_artifact`` serving C's prompts + 16
   new on the float ring (K1, K2 at dv = 256).  It prints the seconds of
   each step, each layer's value error before and after ALS (a rise past
   1e-3 relative fails), the HSR groups and their within-group CKA
   against the identity grouping's, and peak memory; each run's cache
   must hold 4,096 B per token and layer dense and 2,048 B compressed,
   read from the allocated tensors; then the serving CLI
   (``repro_torch.launch.serve.main``) at full width with ``--continuous
   --aot``: 16 requests must finish;
7. the families at full width (``phase_families``, bf16, random weights
   from seed 0, 8 slots, max_len 4096, each model freed before the next;
   gemma3-12b at full depth, minicpm-2b and h2o-danube-1.8b at half
   theirs, ``MINICPM_LAYERS`` / ``DANUBE_LAYERS``): gemma3-12b dense, its logits through both backends (prompts
   of 1,536 and 700 tokens in 2,048-token rings: the 1,024-token local
   rings wrap), then V (A's prompts, float ring, sync), V+ (V overlapped
   with graphs: V's streams) and V3 (C's prompts, spec_depth 3, "ngram");
   ``calibrate`` + ``compress`` of that model (G 2, r 512, not saved), the
   compressed model's logits through both backends, then U (A's prompts),
   U+ (overlapped + graphs + continuous: U's streams), U3 (C's, "ngram")
   and UB (B's prompts, int8 ring, spec_depth 3, "layers:4"); then
   minicpm-2b at ratio 0.5, M (D's pool and traffic), and dense, M3 (the
   dense pool, C's prompts, "ngram"); cache bytes per token and layer
   8,192 (V), 4,096 (U), 4,608 (M), 9,216 (M3); then h2o-danube-1.8b
   (12 of its 24 local layers of window 4,096, d_head 80) dense, its logits through
   both backends, N (A's prompts) and N3 (C's, "ngram"), compressed in
   the run (G 2, r 160, not saved), both backends' logits again, NU, NU3
   and NUB (B's: int8 ring, "layers:4"); then qwen3-moe-235b-a22b at full
   width and 4 of its 94 layers (MOE_LAYERS: 22.4 GB of weights; the
   card's 80 GB hold about 14 layers), first both backends' logits in
   float32 on 2 layers, dense and compressed (bf16 rounding flips top-8
   expert choices between the backends), then the bf16 model: decode and
   verify on a dense pool equal to the ring's, Q (A's prompts), Q+ (Q
   overlapped with graphs and inline admission: Q's streams, the MoE
   dispatch captured), Q3 (C's, "ngram": verify MoE at N 32, 64-row
   dense verify), compressed in the run (G 1, r 256, the expert tensors
   shared), paged steps equal to the ring's (float and int8 pools), QU
   (D's pool and traffic: K4 at q_per_kv 16) and QU3 (C's prompts, K5);
   the peak memory of every step; cache bytes per token and layer 2,560
   (N), 1,280 (NU), 2,048 (Q), 1,024 (QU); then deepseek-v3-671b
   (``phase_deepseek``: MLA, r_kv 512 + dr 64; 256 experts top-8 + 1
   shared; the kernel backend's MLA readers are einsum, so no kernel may
   launch on its path), first in float32 on 2 layers (both
   ``attn_dense``): the prefill of T + 1 tokens against the prefill of T
   and one absorbed decode step, a 4-token verify step against 4 decode
   steps (each within 1e-4 relative), and decode and verify on a page-16
   pool equal to the ring bit for bit; then bf16 at DS_LAYERS = 4 layers
   (the 3 ``attn_dense`` and 1 MoE layer, 30.2 GB): paged steps equal to
   the ring's, DS (A's prompts), DS+ (DS overlapped with graphs and
   inline admission: DS's streams), DS3 (C's, "ngram") and DSP (D's pool
   and traffic: it must share and preempt); cache bytes per token and
   layer 1,152; the peak memory of every step, the init's included;
8. the cross-attention models (``phase_cross``; full width and depth,
   bf16, random weights from seed 0, seeded sources of 8 rows):
   llama-3.2-vision-11b (40 layers, 8 ``cross`` over 1,600 patches), X
   (dense, A's prompts), ``calibrate`` with the source + ``compress`` (G
   2, r 256; cross layers on identity statistics), both backends'
   logits, XU (A's; 32 K1 a decode step, none from the cross layers),
   XU+ (graphs, inline admission: XU's streams), XU3 (C's, "ngram"),
   XUs and XU+c (S's traffic on one source row repeated, sync and
   continuous: equal streams); whisper-small (12 encoder + 12
   ``attn_cross`` layers over 1,500 frames) W (dense), compressed in the
   run (G 3, r 128), both backends' logits, WU and WU+; each run prints
   its source and its self and cross cache bytes per slot (cross: 52.4 /
   26.2 MB for llama-vision, 55.3 / 27.6 MB for whisper);
9. the mesh (``phase_lse``, ``phase_mesh_runs``; run after the kernel
   phases, while this process holds no model): (a) every decode kernel
   (K1, K3, K4, K5, K6, K7 and the dense decode / verify kernels) with
   ``return_lse`` at the main path's shapes against its plain version's
   (o, m, l) in f32 and bf16, its output bit for bit that of the launch
   without the state, timed with and without; (b) the same kernels on
   the same operands split into 2 and 4 sequence shards (ring columns, or
   each page's offsets), each shard's state merged by the port's merge
   with the collectives replaced by reductions over the stacked parts,
   against the unsharded kernel; (c) qwen3-4b at full width on a (1, 2)
   mesh of two spawned ranks that share the card over gloo, each run
   first on the single-device engine in this process: MA32 (f32) and MA
   (bf16), A's prompts prefilled whole, MA32's streams equal to the
   single device's and MA's first decode step's merged attention within
   the bf16 limit of the unsharded kernel on the gathered ring (the
   streams' agreement, and where they part the top-2 logit margin, are
   reported), MD (D's pool and prompts; must share pages), and short
   runs that launch the other kernels' ``return_lse`` variants (MB, MB2,
   MC2, MD2, MH, MH2); then the paths the einsum readers' merge serves:
   MM32 / MM2 deepseek-v3-671b at 1 layer (f32 streams equal;
   bf16 n-gram verify, its first merged ``verify_attn_mla`` held to the
   unsharded one), MW / MWU whisper-small dense / latent (f32, streams
   equal; the sharded cross caches), MF falcon-mamba-7b at 2 layers on a
   (2, 1) mesh (f32, streams equal), MR recurrentgemma-9b at 3 layers
   (bf16: the state gathered over "model", the window ring's first
   merged K1 checked), ML qwen3-4b with the layer draft (bf16: the
   draft's sharded ring, K1 and K5 with the state) and ME qwen3-4b on the
   einsum backend (f32, streams equal, no kernel); depth, tokens and
   windows cut as ``MESH_RUNS`` says (every weight is gathered across the
   host at every step).  The
   tok/s of (c) are two ranks time-slicing one card over a host
   transport, not a mesh's speed; rows ``<kernel>+lse`` of the kernels
   line count the return_lse launches of (c);
10. a ``{"kernels": [...]}`` line (per kernel: ``ms`` is the kernel's
   bf16 time, ``max_abs_err`` its bf16 error, ``max_err_f32`` its float32
   error, ``launches`` its launches over the runs, ``launches_by_run`` by
   run; the four dense cores are entries of their own, counted on their
   own wrappers, the dense verify kernel's at nq 4, 9 and 16 (and qwen3-moe's
   at nq 4 and 16); the
   row copy ``stage_install_rows`` with its idle time too), the card line, and
   the final ``{"ok": true, "device": {...}}`` line.

It needs a CUDA card and the repository's ``src``; it imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import shutil
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SEED = 0
# Published H100 SXM peaks (NVIDIA data sheet, dense, 700 W): the bound of
# a call is max(bytes / HBM rate, FLOPs / bf16 tensor-core rate).
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
F32_TOL = 1e-4      # max |kernel - plain| in float32, TF32 off
# bf16, per element: |kernel - plain| <= BF16_REL * |plain| + BF16_RMS * rms(plain).
# Both sides round the same f32 result to bf16, so they may differ by one
# bf16 step (at most 2^-7 of the value); the rms floor covers elements near 0.
BF16_REL, BF16_RMS = 2e-2, 1e-2
PAGE = 16           # the paged pool's page size (the engine's default at 4096)
NO_SPILL = ("latent_decode_tc", "dense_verify")   # sources whose kernels may not spill


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Device ms per call of ``fn``: the launches are queued behind a ~25 ms
    device sleep, so the events time the card's work and not the host's
    enqueue (a wrapper's host time can exceed a short kernel's)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int) -> float:
    """Device ms per replay of ``fn`` captured as a CUDA graph (after one
    warm-up call on a side stream): what a captured window iteration pays
    for it.  For calls whose host work outlasts ``cuda_ms``'s device sleep
    (a wrapper that checks a hundred leaves), ``cuda_ms`` on the eager
    call would time the host's enqueue."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return cuda_ms(graph.replay, iters=iters)


def nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` (other arguments are skipped)."""
    return sum(t.numel() * t.element_size() for t in ts if hasattr(t, "numel"))


def count_params(params) -> int:
    """Parameters of a model: its layers' leaves (nested dicts too: an MoE
    layer's shared expert) and the embedding."""
    def leaves(tree):
        return sum(leaves(v) if isinstance(v, dict) else v.numel() for v in tree.values())
    return sum(leaves(layer) for layer in params["layers"]) + params["embed"].numel()


def bound(bytes_: int, flops: float) -> tuple[float, str]:
    tb, tf = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def worst_ratio(got, want, dtype, scale=1.0, mag=None):
    """(|got - want|, rms of want, the worst |got - want| over the
    tolerance above times ``scale``) for :func:`compare`."""
    import torch
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    rms = want.square().mean().sqrt().item()
    if dtype == torch.float32:
        limit = torch.full_like(want, F32_TOL)
    else:
        size = want.abs() if mag is None else torch.maximum(want.abs(), mag.float())
        limit = scale * (BF16_REL * size + BF16_RMS * rms)
    return diff, rms, (diff / limit).max().item()


def compare(name, got, want, dtype, scale=1.0, mag=None) -> float:
    """Max |got - want|, after checking it against the tolerance above
    (times ``scale``: 2 where both sides carry their own bf16 rounding of
    one function, each within the limit of it).  ``mag`` (a merge of bf16
    parts: their weighted magnitude sum w |o_i| / sum w) takes the place of
    |want| in the bf16 limit where it is larger: each part's rounding
    carries into the merge at its own size, whatever the parts cancel to."""
    import torch
    if not torch.isfinite(got.float()).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    diff, rms, worst = worst_ratio(got, want, dtype, scale, mag)
    want = want.float()
    log(f"{name} {dtype}: max abs err {diff.max().item():.3e}, output rms {rms:.3e} "
        f"max {want.abs().max().item():.3e}, worst err / limit {worst:.3f}")
    if worst > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain version in "
                             f"{dtype} (worst err / limit {worst:.3f})")
    return diff.max().item()


# Each served family's widths at the kernel phases' shapes: head dim dh,
# Hkv kv heads of q_per_kv query heads each, and its latent cache at
# recalkv_ratio 0.5 (G groups of s kv heads, rank r).
WIDTHS = {"qwen3-4b": dict(dh=128, Hkv=8, qpk=4, G=2, s=4, r=256),
          "gemma3-12b": dict(dh=256, Hkv=8, qpk=2, G=2, s=4, r=512),
          "minicpm-2b": dict(dh=64, Hkv=36, qpk=1, G=9, s=4, r=128),
          "h2o-danube-1.8b": dict(dh=80, Hkv=8, qpk=4, G=2, s=4, r=160),
          "qwen3-moe-235b-a22b": dict(dh=128, Hkv=4, qpk=16, G=1, s=4, r=256),
          "whisper-small": dict(dh=64, Hkv=12, qpk=1, G=3, s=4, r=128),
          # MQA: one kv head, so ReCalKV's group is s 1; its local layers'
          # rings hold the 2,048-token window
          "recurrentgemma-9b": dict(dh=256, Hkv=1, qpk=16, G=1, s=1, r=128, ring=2048)}
# the kernels-line tag of another family's rows, and the runs whose
# launches they count (the qwen3-4b rows count every other run)
FAMILY_TAG = {"gemma3-12b": "dh 256", "minicpm-2b": "q_per_kv 1", "h2o-danube-1.8b": "dh 80",
              "qwen3-moe-235b-a22b": "q_per_kv 16", "whisper-small": "whisper, dh 64",
              "recurrentgemma-9b": "recurrentgemma, Hkv 1, q_per_kv 16, dh 256"}
FAMILY_RUNS = {"gemma3-12b": ("gemma3 steps", "V", "V+", "V3", "gemma3 latent steps", "U",
                              "U+", "U3", "UB"),
               "minicpm-2b": ("M", "M3"),
               "h2o-danube-1.8b": ("danube steps", "N", "N3", "danube latent steps", "NU",
                                   "NU3", "NUB"),
               "qwen3-moe-235b-a22b": ("qwen3-moe steps", "Q", "Q+", "Q3",
                                       "qwen3-moe latent steps", "QU", "QU3"),
               "deepseek-v3-671b": ("deepseek steps", "DS", "DS+", "DS3", "DSP"),
               # llama-3.2-vision-11b's self layers have qwen3-4b's heads and
               # latent widths, so its runs count in qwen3-4b's rows
               "whisper-small": ("W", "whisper latent steps", "WU", "WU+"),
               # the recurrent models (``phase_recurrent``): falcon-mamba's
               # mixers launch no kernel (its continuous run the install's
               # row copy), recurrentgemma's local layers K1 / K3 / K2 and
               # the dense decode at their widths
               "falcon-mamba-7b": ("FM", "FM+", "FMs", "FM+c"),
               "recurrentgemma-9b": ("recurrentgemma steps", "RG", "recurrentgemma latent "
                                     "steps", "RGU", "RGU+", "RGU8", "RGUs", "RGU+c"),
               # the trained qwen3-4b's Fisher artifact (``phase_train``): its
               # K1 / K2 rows at the artifact's smallest and largest ranks
               "fisher": ("FI", "FI+")}
# qwen3-moe-235b-a22b serves 4 of its 94 layers: a layer is 4.97 GB of bf16
# (attention 71 M, experts 2,416 M, router 0.5 M parameters), so the card's
# 80 GB hold about 14 beside the 2.49 GB embedding and head; 4 keep the
# script inside its time limit.
MOE_LAYERS = 4
# Two families' depth, cut to keep the script inside its time limit (their
# layers are all of one kind, so every kernel shape stays): minicpm-2b 20
# of 40 layers, h2o-danube-1.8b 12 of 24 (PERF.md: the seconds each saves).
MINICPM_LAYERS, DANUBE_LAYERS = 20, 12
# deepseek-v3-671b serves 4 of its 61 layers: its 3 attn_dense layers (0.58 B
# parameters each) and 1 MoE layer (256 experts of 3 x 7,168 x 2,048, one
# shared: 11.5 B), beside the 1.85 B embedding and head: 15.1 B, 30.2 GB of
# bf16.  A second MoE layer would add 23 GB.
DS_LAYERS = 4
MLA_REL = 1e-4      # float32: absorbed decode / verify vs the non-absorbed forms


def family_row(entry, arch, what=""):
    """``entry`` as a row of ``arch``'s widths: named apart from the
    qwen3-4b row of the same wrapper, its launches that wrapper's on the
    family's runs."""
    if arch == "qwen3-4b":
        return entry
    entry["launch_key"] = entry.get("launch_key", entry["name"])
    entry["name"] = f"{entry['name']} ({FAMILY_TAG[arch]}{what})"
    entry["runs"] = FAMILY_RUNS[arch]
    return entry


def ring_inputs(torch, gen, nq=1, dense=False, arch="qwen3-4b"):
    """Main-path operands: B=8, a full 4096-token ring (or ``arch``'s
    window ring), and ``arch``'s latent widths (qwen3-4b: G=2, Hg=16, dh=128, r=256, s=4), with nq
    queries and their nq self columns (float32).  With ``dense``, the dense
    cores' operands at ``arch``'s heads (qwen3-4b: G = Hkv = 8 groups of s =
    1, Hg = q_per_kv 4), the keys and values as r = dh latents behind an
    identity R_k, no k-norm, identity rotation tables (cos 1, sin 0, the
    self columns' too: dense keys are stored after RoPE)."""
    from repro_torch.kernels import ops
    w = WIDTHS[arch]
    B, S, dh = 8, w.get("ring", 4096), w["dh"]
    G, s, r = (w["Hkv"], 1, dh) if dense else (w["G"], w["s"], w["r"])
    rv = r if dense else w.get("rv", r)     # a Fisher layer's value rank
    Hg = s * w["qpk"]
    theta = None if dense else 1e6
    dev = "cuda"
    rn = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    pos = torch.arange(S, device=dev).expand(B, S).contiguous()
    cur = torch.full((B,), S, device=dev)
    pos_q = cur[:, None] + torch.arange(nq, device=dev)
    feed = torch.ones((B, nq), dtype=torch.bool, device=dev)
    cos, sin = ops.rotation_tables(pos, dh, theta)
    cs, ss = ops.rotation_tables(pos_q, dh, theta)
    bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
    return dict(q=rn(B, G, nq * Hg, dh), zk=rn(B, S, G, r), zv=rn(B, S, G, rv),
                r_k=(torch.eye(dh, device=dev).expand(G, dh, dh).contiguous() if dense
                     else rn(G, r, s * dh) * r ** -0.5),
                self_zk=rn(B, nq, G, r),
                self_zv=rn(B, nq, G, rv), cos=cos, sin=sin, self_cos=cs, self_sin=ss,
                bias=bias, k_norm=None if dense else 0.1 * rn(dh),
                shape=(B, S, G, Hg, dh, r, s, nq), rv=rv)


def kernel_phase(torch, name, kernel, plain, make, flops, meta):
    """Check ``kernel`` against ``plain`` in f32 and bf16 on the operands
    ``make(dtype)`` returns as (args, kwargs); time both (bf16) and return
    the kernels-line entry with the bound from this call's bytes."""
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        args, kw = make(dt)
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        res[dt] = compare(name, got, plain(*args, **kw), dt)
    ms = cuda_ms(lambda: kernel(*args, **kw))
    plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=3)
    b_ms, by = bound(nbytes(*args, *kw.values(), got), flops)
    log(f"{name} {meta['shape']}: max err f32 {res[torch.float32]:.3e} bf16 "
        f"{res[torch.bfloat16]:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({by})")
    return {**meta, "route": "cuda", "max_abs_err": res[torch.bfloat16],
            "max_err_f32": res[torch.float32], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": None}


def decode_flops(B, S_ext, G, Hg, dh, r, s, nq, rv=None):
    """Key reconstruction once per column (rank ``r``), then nq*Hg rows of
    scores and latent values (rank ``rv``, default ``r``) per column."""
    return 2.0 * B * G * S_ext * (r * s * dh + nq * Hg * (dh + (rv or r)))


def dense_flops(B, S_ext, G, Hg, dh, nq):
    """The dense function's operations: q . k and p . v for nq * Hg rows
    per column (the identity rebuild is the port's, not the function's)."""
    return 2.0 * B * G * S_ext * nq * Hg * 2 * dh


# The dense cores, kernels of their own: K1's and K4's the dense decode
# kernel (``csrc/dense_decode.cu``), K5's and K7's the dense verify kernel
# (``csrc/dense_verify.cu``); the JAX package's ops cores run those latent
# kernels at an identity R_k.  ``replaces`` is the Pallas kernel's
# pallas_call and ``jax_core`` the JAX core that sets it up.
DENSE_CORES = {
    "latent_decode_attention": dict(
        name="dense_decode_attention", source="src/repro_torch/csrc/dense_decode.cu",
        jax_core="src/repro/kernels/ops.py:238 (_dense_ring_core)"),
    "latent_decode_attention_mq": dict(
        name="dense_decode_attention_mq", source="src/repro_torch/csrc/dense_verify.cu",
        jax_core="src/repro/kernels/ops.py:272 (_dense_ring_core_mq)"),
    "latent_decode_attention_paged": dict(
        name="dense_decode_attention_paged", source="src/repro_torch/csrc/dense_decode.cu",
        jax_core="src/repro/kernels/ops.py:533 (_dense_paged_core)"),
    "latent_decode_attention_mq_paged": dict(
        name="dense_decode_attention_mq_paged", source="src/repro_torch/csrc/dense_verify.cu",
        jax_core="src/repro/kernels/ops.py:565 (_dense_paged_core_mq)"),
}


def sdpa_time(torch, qg, k, v, self_k, self_v, bias, nq):
    """The library yardstick of a dense core: one
    ``scaled_dot_product_attention`` call (GQA, additive mask) over the
    same ring plus the self columns, laid out outside the timed region;
    the port never calls it.  Returns (ms, the backend PyTorch picks)."""
    from torch.nn.attention import SDPBackend
    B, G, QH, dh = qg.shape
    Hg = QH // nq
    q = qg.reshape(B, G, nq, Hg, dh).permute(0, 1, 3, 2, 4).reshape(B, G * Hg, nq, dh)
    if self_k.dim() == 3:
        self_k, self_v = self_k[:, None], self_v[:, None]
        bias = torch.cat([bias, bias.new_zeros(B, 1)], dim=1)[:, None]
    kt = torch.cat([k, self_k.to(k.dtype)], 1).transpose(1, 2).contiguous()
    vt = torch.cat([v, self_v.to(v.dtype)], 1).transpose(1, 2).contiguous()
    mask = bias[:, None].to(q.dtype)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    choice = torch._fused_sdp_choice(q, kt, vt, mask, 0.0, False, scale=dh ** -0.5,
                                     enable_gqa=True)
    ms = cuda_ms(lambda: sdpa(q, kt, vt, attn_mask=mask, scale=dh ** -0.5,
                              enable_gqa=True), iters=50)
    return ms, SDPBackend(choice).name


def sdpa_lse_time(torch, qg, k, v, self_k, self_v, bias, nq):
    """The library yardstick of a dense core with its softmax state: one
    ``aten._scaled_dot_product_efficient_attention`` call with
    ``compute_log_sumexp`` over the same ring plus the self columns, the
    kv heads repeated to the query heads and the mask laid out (row
    stride a multiple of 16) outside the timed region; the port never
    calls it.  Returns ms, or None (logged) where the call is refused."""
    B, G, QH, dh = qg.shape
    Hg = QH // nq
    q = qg.reshape(B, G, nq, Hg, dh).permute(0, 1, 3, 2, 4).reshape(B, G * Hg, nq, dh)
    if self_k.dim() == 3:
        self_k, self_v = self_k[:, None], self_v[:, None]
        bias = torch.cat([bias, bias.new_zeros(B, 1)], dim=1)[:, None]
    kt = torch.cat([k, self_k.to(k.dtype)], 1).transpose(1, 2).repeat_interleave(Hg, dim=1)
    vt = torch.cat([v, self_v.to(v.dtype)], 1).transpose(1, 2).repeat_interleave(Hg, dim=1)
    kt, vt = kt.contiguous(), vt.contiguous()
    S = kt.shape[2]
    mask = torch.zeros((B, G * Hg, nq, -(-S // 16) * 16), dtype=q.dtype, device=q.device)
    mask = mask[..., :S]
    mask.copy_(bias[:, None].to(q.dtype).expand(B, G * Hg, nq, S))
    call = torch.ops.aten._scaled_dot_product_efficient_attention
    try:
        out, lse = call(q, kt, vt, mask, True, scale=dh ** -0.5)[:2]
        torch.cuda.synchronize()
        if (lse.shape[:2] != (B, G * Hg) or lse.shape[2] < nq   # lse rows padded to 32
                or not torch.isfinite(out).all()):
            raise ValueError(f"output {tuple(out.shape)}, lse {tuple(lse.shape)}")
        return cuda_ms(lambda: call(q, kt, vt, mask, True, scale=dh ** -0.5), iters=50)
    except (RuntimeError, ValueError) as e:
        log(f"_scaled_dot_product_efficient_attention refused the shape: {e}")
        return None


def phase_dense(torch, gen, paged, nq, arch="qwen3-4b"):
    """The dense cores at ``arch``'s dense shape against their plain
    versions in f32 and bf16: nq = 1, K1's (the ring) or K4's (``paged``:
    the ragged pool of ``paged_inputs``) dense core, the dense decode
    kernel of ``csrc/dense_decode.cu``; nq = 4, K5's or K7's dense core,
    the dense verify kernel of ``csrc/dense_verify.cu``.  The pool must
    equal the ring kernel on the gathered view bit for bit in both types,
    and in bf16 itself on an in-order placement of the same pages.  Timed
    beside its bound (the dense function's bytes), the plain version, one
    SDPA call on the same ring (or view) plus the self columns, and the
    route it replaces, K1 / K4 / K5 / K7 at an identity R_k with identity
    rotation tables, in this call."""
    from repro_torch.kernels import dense_decode as KD
    from repro_torch.kernels import latent_decode as K
    one = nq == 1
    if paged:
        a, ptab, pools, cols, flops = paged_inputs(torch, gen, nq, dense=True, arch=arch)
    else:
        a = ring_inputs(torch, gen, nq, dense=True, arch=arch)
        pools, ptab = {"zk": a["zk"], "zv": a["zv"]}, None
    B, S, G, Hg, dh, _, _, _ = a["shape"]
    bias = a["bias"] if paged or not one else a["bias"][:, 0, :S].contiguous()
    sel = (lambda x: x[:, 0]) if one else (lambda x: x)
    ring_name = "dense_decode_attention" + ("" if one else "_mq")
    name = ring_name + ("_paged" if paged else "")
    kernel, plain = getattr(KD, name), getattr(KD, name + "_plain")
    lead = (ptab,) if paged else ()
    res, view_diff = {}, None
    for dt in (torch.float32, torch.bfloat16):
        args = (*lead, a["q"].to(dt), pools["zk"].to(dt), pools["zv"].to(dt), bias)
        kw = dict(scale=dh ** -0.5, self_k=sel(a["self_zk"]).to(dt),
                  self_v=sel(a["self_zv"]).to(dt))
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        res[dt] = compare(name, got, plain(*args, **kw), dt)
        if not paged:
            continue
        view = (args[1], K.gather_pages(args[2], ptab), K.gather_pages(args[3], ptab), bias)
        ring = getattr(KD, ring_name)(*view, **kw)
        torch.cuda.synchronize()
        view_diff = (got.float() - ring.float()).abs().max().item()
        log(f"{name} {dt}: max abs diff against {ring_name} on the gathered ring "
            f"{view_diff:.3e} (0 expected: same chunks, same order)")
        if not torch.equal(got, ring):
            raise AssertionError(f"{name} differs from the ring kernel on the gathered "
                                 f"ring by {view_diff:.3e}")
        if dt == torch.bfloat16:
            order, opools = in_order(torch, ptab, {"zk": args[2], "zv": args[3]})
            again = kernel(order, args[1], opools["zk"], opools["zv"], bias, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, again):
                raise AssertionError(f"{name} depends on the page placement")
    ms = cuda_ms(lambda: kernel(*args, **kw), iters=50)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=3)
    # the route this kernel replaces: K1 / K4 / K5 / K7 at an identity R_k,
    # identity tables
    old = getattr(K, "latent_decode_attention" + ("" if one else "_mq")
                  + ("_paged" if paged else ""))
    old_args = args[:-1] + (a["r_k"].to(torch.bfloat16), a["cos"], a["sin"], bias)
    old_kw = dict(scale=dh ** -0.5, self_zk=kw["self_k"], self_zv=kw["self_v"],
                  self_cos=sel(a["self_cos"]), self_sin=sel(a["self_sin"]))
    old_ms = cuda_ms(lambda: old(*old_args, **old_kw), iters=50)
    selfs = [kw["self_k"], kw["self_v"]]
    if paged:   # the dense function's own operands: mapped pages, table, q, self K/V, mask
        used_pages = int(torch.unique(ptab[ptab != 0]).numel())
        lat = used_pages * PAGE * G * 2 * dh * args[2].element_size()
        b_ms, by = bound(lat + cols * 4 * nq + nbytes(ptab, args[1], got, *selfs), flops)
        sd_k, sd_v = view[1], view[2]
    else:
        b_ms, by = bound(nbytes(*args, *selfs, got), dense_flops(B, S + nq, G, Hg, dh, nq))
        sd_k, sd_v = args[1], args[2]
    library_ms, backend = sdpa_time(torch, args[-4], sd_k, sd_v, *selfs, bias, nq)
    log(f"{name} B={B} S={S}+{nq} Hkv={G} q_per_kv={Hg} nq={nq} dh={dh}"
        + (f" page_size={PAGE} {used_pages} pages" if paged else "")
        + f": max err f32 {res[torch.float32]:.3e} bf16 {res[torch.bfloat16]:.3e}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {b_ms:.4f} ms ({by}), sdpa "
        f"{library_ms:.4f} ms ({backend}), old route ({old.__name__} at an identity R_k) "
        f"{old_ms:.4f} ms; kernel {ms / b_ms:.2f}x its bound, {ms / library_ms:.2f}x sdpa, "
        f"{ms / old_ms:.2f}x the old route")
    fn = old.__name__
    line = {"latent_decode_attention": 177, "latent_decode_attention_paged": 456,
            "latent_decode_attention_mq": 338, "latent_decode_attention_mq_paged": 567}[fn]
    entry = {"route": "cuda", "replaces": f"src/repro/kernels/latent_decode.py:{line}",
             "tpu_kernel": f"src/repro/kernels/latent_decode.py::{fn}",
             "max_abs_err": res[torch.bfloat16], "max_err_f32": res[torch.float32],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
             "library_ms": library_ms, "sdpa_backend": backend, "old_route_ms": old_ms,
             "shape": (f"B={B} S={S}+{nq} Hkv={G} q_per_kv={Hg} nq={nq} dh={dh} bf16"
                       + (f", page_size={PAGE} {used_pages} pages, ragged table"
                          if paged else ""))}
    if paged:
        entry["view_max_abs_diff"] = view_diff
    entry.update(DENSE_CORES[fn])
    if one and Hg >= KD._TC_DECODE_ROWS:   # the decode's rows on the verify's m16 body
        entry["source"] = "src/repro_torch/csrc/dense_verify.cu"
    if nq > 4:   # another row of the same wrapper, at more rows a kv head
        entry["launch_key"] = entry["name"]
        entry["name"] = f"{entry['name']} (nq {nq})"
    return family_row(entry, arch)


def phase_decode_bodies(torch, gen):
    """The dense decode at 8 query rows a kv head (qwen3-4b's heads at
    q_per_kv 8: B 8, a 4,096-token ring plus the self column, Hkv 8, dh
    128) on both bodies: ``csrc/dense_decode.cu``'s CUDA-core body, which
    the wrapper runs up to 7 rows, and ``csrc/dense_verify.cu``'s m16
    tensor-core body, which it runs from 8; each held to the plain version
    in f32 and bf16 and timed in this call beside the bound.  No served
    model has 8 rows a kv head, so these are not the main path's launches:
    the times say where the threshold belongs."""
    from repro_torch.kernels import dense_decode as KD
    B, S, Hkv, qpk, dh = 8, 4096, 8, 8, 128
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    ops_ = dict(q=rn(B, Hkv, qpk, dh), k=rn(B, S, Hkv, dh), v=rn(B, S, Hkv, dh),
                sk=rn(B, Hkv, dh), sv=rn(B, Hkv, dh))
    bias = torch.zeros(B, S, device="cuda")
    out = {}
    for body in ("cuda_core", "tensor_core"):
        err = {}
        for dt in (torch.float32, torch.bfloat16):
            q, k, v, sk, sv = (ops_[n].to(dt) for n in ("q", "k", "v", "sk", "sv"))
            got = KD.launch(q, k, v, bias, dh ** -0.5, sk, sv, body=body)
            torch.cuda.synchronize()
            want = KD.dense_decode_attention_plain(q, k, v, bias, scale=dh ** -0.5,
                                                   self_k=sk, self_v=sv)
            err[dt] = compare(f"dense decode, {body} body, q_per_kv 8", got, want, dt)
        ms = cuda_ms(lambda: KD.launch(q, k, v, bias, dh ** -0.5, sk, sv, body=body),
                     iters=50)
        out[body] = {"ms": ms, "max_abs_err": err[torch.bfloat16],
                     "max_err_f32": err[torch.float32]}
    b_ms, by = bound(nbytes(q, k, v, bias, sk, sv, got), dense_flops(B, S + 1, Hkv, qpk, dh, 1))
    out.update(bound_ms=b_ms, bound_by=by,
               shape=f"B={B} S={S}+1 Hkv={Hkv} q_per_kv={qpk} dh={dh} bf16")
    log(f"dense decode at 8 rows a kv head ({out['shape']}): CUDA-core body "
        f"{out['cuda_core']['ms']:.4f} ms, tensor-core body {out['tensor_core']['ms']:.4f} ms, "
        f"bound {b_ms:.4f} ms ({by})")
    return out


def phase_f32_widths(torch, gen):
    """The float32 template (the parity instantiations) at the widths its
    row-block plans open: K1 and K5 (nq 4) at group_size 8 (G = 1, s = 8,
    Hg = 32) and ranks 768 / 1,024, B = 2 rows of a 1024-token ring,
    against their plain versions within 1e-4 (TF32 off).  Not the main
    path's launches."""
    from repro_torch.kernels import latent_decode as K
    from repro_torch.kernels import ops
    B, S, G, s, qpk, dh = 2, 1024, 1, 8, 4, 128
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    out = {}
    for r in (768, 1024):
        for nq in (1, 4):
            pos = torch.arange(S, device="cuda").expand(B, S).contiguous()
            pos_q = torch.full((B, 1), S, device="cuda") + torch.arange(nq, device="cuda")
            cos, sin = ops.rope_tables_for(pos, dh, 1e6)
            cs, ss = ops.rope_tables_for(pos_q, dh, 1e6)
            feed = torch.ones((B, nq), dtype=torch.bool, device="cuda")
            bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
            args = [rn(B, G, nq * s * qpk, dh), rn(B, S, G, r), rn(B, S, G, r),
                    rn(G, r, s * dh) * r ** -0.5, cos, sin,
                    bias[:, 0, :S].contiguous() if nq == 1 else bias]
            sel = (lambda x: x[:, 0]) if nq == 1 else (lambda x: x)
            kw = dict(scale=dh ** -0.5, k_norm=0.1 * rn(dh), self_zk=sel(rn(B, nq, G, r)),
                      self_zv=sel(rn(B, nq, G, r)), self_cos=sel(cs), self_sin=sel(ss))
            fn = "latent_decode_attention" if nq == 1 else "latent_decode_attention_mq"
            got = getattr(K, fn)(*args, **kw)
            torch.cuda.synchronize()
            err = compare(f"{fn} f32 template r={r} Hg=32 nq={nq}", got,
                          getattr(K, fn + "_plain")(*args, **kw), torch.float32)
            out[f"{fn} r={r} nq={nq}"] = err
    return out


def phase_latent(torch, gen, nq, quant, arch="qwen3-4b"):
    """K1 (nq=1, float), K3 (nq=1, int8), K5 (nq=4, float), K6 (nq=4,
    int8) at the main path's shapes (``arch``'s latent widths); the self
    columns ride as operands."""
    from repro_torch.kernels import latent_decode as K1
    from repro_torch.kernels import latent_decode_q as KQ
    from repro_torch.quant import quantize
    a = ring_inputs(torch, gen, nq, arch=arch)
    B, S, G, Hg, dh, r, s, _ = a["shape"]
    one = nq == 1
    q8 = {k: quantize(a[k], 8) for k in ("zk", "zv", "self_zk", "self_zv")} if quant else {}

    def make(dt):
        t = {k: a[k].to(dt) for k in ("q", "zk", "zv", "r_k", "self_zk", "self_zv")}
        sel = (lambda x: x[:, 0]) if one else (lambda x: x)
        bias = a["bias"][:, 0, :S].contiguous() if one else a["bias"]
        kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], self_cos=sel(a["self_cos"]),
                  self_sin=sel(a["self_sin"]))
        if quant:
            lat = (q8["zk"][0], q8["zk"][1][..., 0], q8["zv"][0], q8["zv"][1][..., 0])
            kw.update(self_zk_q=sel(q8["self_zk"][0]), self_zk_s=sel(q8["self_zk"][1][..., 0]),
                      self_zv_q=sel(q8["self_zv"][0]), self_zv_s=sel(q8["self_zv"][1][..., 0]))
        else:
            lat = (t["zk"], t["zv"])
            kw.update(self_zk=sel(t["self_zk"]), self_zv=sel(t["self_zv"]))
        return (t["q"], *lat, t["r_k"], a["cos"], a["sin"], bias), kw

    mod, base = (KQ, "latent_decode_attention") if quant else (K1, "latent_decode_attention")
    fn = base + ("" if one else "_mq") + ("_quant" if quant else "")
    where = {"latent_decode_attention": ("latent_decode.py", 177, "latent_decode_tc"),
             "latent_decode_attention_quant": ("latent_decode_q.py", 69, "latent_decode_tc"),
             "latent_decode_attention_mq": ("latent_decode.py", 338, "latent_decode_tc"),
             "latent_decode_attention_mq_quant": ("latent_decode_q.py", 158,
                                                  "latent_decode_tc")}[fn]
    meta = {"name": fn, "source": f"src/repro_torch/csrc/{where[2]}.cu",
            "replaces": f"src/repro/kernels/{where[0]}:{where[1]}",
            "tpu_kernel": f"src/repro/kernels/{where[0]}::{fn}",
            "shape": (f"B={B} S={S}+{nq} G={G} Hg={Hg} nq={nq} dh={dh} r="
                      f"{r if a['rv'] == r else '%d/%d' % (r, a['rv'])} "
                      f"{'int8 latents, ' if quant else ''}bf16")}
    entry = kernel_phase(torch, fn, getattr(mod, fn), getattr(mod, fn + "_plain"), make,
                         decode_flops(B, S + nq, G, Hg, dh, r, s, nq, a["rv"]), meta)
    return family_row(entry, arch)


def phase_tc_widths(torch, gen):
    """The bf16 tensor-core bodies of K1, K5 and K6 at widths off the main
    path that the engine still serves, against their plain versions within
    the bf16 limit: K1 at r = 152 (a multiple of 8, padded to 16 in the
    kernel), 384 and 512 (recalkv ratios 0.3, 0.75 and 1: 128-column
    chunks), K6 at nq = 5 and 8 (spec_depth 4 and 7: query blocks along
    grid z) and at r = 512 (a 64-row R_k stage), and K5 at nq = 2, r = 624
    (spec_depth 1: a 64-column chunk; the CUDA-core template served it).
    B = 2 rows of a 1024-token ring; these launches are not the main
    path's.  Then ``group8_widths``, ``wide_rank_times`` and
    ``k2_widths``."""
    from repro_torch.kernels import latent_decode as K1
    from repro_torch.kernels import latent_decode_q as KQ
    from repro_torch.kernels import ops
    from repro_torch.quant import quantize
    B, S, G, Hg, dh, s = 2, 1024, 2, 16, 128, 4
    bf = torch.bfloat16
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    pos = torch.arange(S, device="cuda").expand(B, S).contiguous()
    pos[1, S // 3:] = -1                       # row 1 ragged: dead chunks
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    for kind, nq, r in (("K1", 1, 152), ("K1", 1, 384), ("K1", 1, 512),
                        ("K6", 5, 256), ("K6", 8, 256), ("K6", 4, 512), ("K5", 2, 624)):
        pos_q = torch.full((B, 1), S, device="cuda") + torch.arange(nq, device="cuda")
        cs, ss = ops.rope_tables_for(pos_q, dh, 1e6)
        feed = torch.ones((B, nq), dtype=torch.bool, device="cuda")
        bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
        q, r_k = rn(B, G, nq * Hg, dh).to(bf), (rn(G, r, s * dh) * r ** -0.5).to(bf)
        zk, zv, szk, szv = rn(B, S, G, r), rn(B, S, G, r), rn(B, nq, G, r), rn(B, nq, G, r)
        kw = dict(scale=dh ** -0.5, k_norm=0.1 * rn(dh))
        if kind == "K1":
            kernel, plain = K1.latent_decode_attention, K1.latent_decode_attention_plain
            args = (q, zk.to(bf), zv.to(bf), r_k, cos, sin, bias[:, 0, :S].contiguous())
            kw.update(self_zk=szk[:, 0].to(bf), self_zv=szv[:, 0].to(bf),
                      self_cos=cs[:, 0], self_sin=ss[:, 0])
        elif kind == "K5":
            kernel, plain = K1.latent_decode_attention_mq, K1.latent_decode_attention_mq_plain
            args = (q, zk.to(bf), zv.to(bf), r_k, cos, sin, bias)
            kw.update(self_zk=szk.to(bf), self_zv=szv.to(bf), self_cos=cs, self_sin=ss)
        else:
            kernel = KQ.latent_decode_attention_mq_quant
            plain = KQ.latent_decode_attention_mq_quant_plain
            q8 = [quantize(z, 8) for z in (zk, zv, szk, szv)]
            args = (q, q8[0][0], q8[0][1][..., 0], q8[1][0], q8[1][1][..., 0], r_k, cos,
                    sin, bias)
            kw.update(self_zk_q=q8[2][0], self_zk_s=q8[2][1][..., 0], self_zv_q=q8[3][0],
                      self_zv_s=q8[3][1][..., 0], self_cos=cs, self_sin=ss)
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        compare(f"{kernel.__name__} nq={nq} r={r}", got, plain(*args, **kw), bf)
    group8_widths(torch, gen)
    wide = wide_rank_times(torch, gen)
    k2_widths(torch, gen)
    return wide


def group8_widths(torch, gen):
    """group_size 8 at full width: G = 1 group of s = 8 kv heads, 32 query
    rows per group (past a block's 16, so the head slots split over blocks
    along grid z), on B = 2 rows of a 1024-token ring (row 1 ragged), at r
    = 512 (128-column chunks), 768 and 1024 (64-column chunks: every rank
    up to s * dh).  All six bf16 bodies against their plain versions
    within the bf16 limit: K1, K3 and K4 with one query and its self
    column, K5, K6 and K7 with nq = 4 and their self columns; K4 and K7 on
    the ring's pages at shuffled physical pages must equal K1 and K5 bit
    for bit."""
    from repro_torch.kernels import latent_decode as K1
    from repro_torch.kernels import latent_decode_q as KQ
    from repro_torch.kernels import ops
    from repro_torch.quant import quantize
    B, S, G, Hg, dh, s = 2, 1024, 1, 32, 128, 8
    bf = torch.bfloat16
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    pos = torch.arange(S, device="cuda").expand(B, S).contiguous()
    pos[1, S // 3:] = -1
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    n_sp = S // PAGE
    g = torch.Generator().manual_seed(SEED + 6)
    ptab = (torch.randperm(B * n_sp, generator=g) + 1).reshape(B, n_sp)
    ptab = ptab.to(device="cuda", dtype=torch.int32)

    def q8(z):   # int8 latents and their (..., G) scales
        lat, sc = quantize(z, 8)
        return lat, sc[..., 0]

    def paged(z):   # the ring's pages at the table's physical pages
        pool = torch.zeros((B * n_sp + 1, PAGE) + tuple(z.shape[2:]), device="cuda",
                           dtype=z.dtype)
        pool[ptab.reshape(-1).long()] = z.reshape((B * n_sp, PAGE) + tuple(z.shape[2:]))
        return pool

    for r in (512, 768, 1024):
        r_k = (rn(G, r, s * dh) * r ** -0.5).to(bf)
        zk, zv = rn(B, S, G, r), rn(B, S, G, r)
        for nq in (1, 4):
            pos_q = torch.full((B, 1), S, device="cuda") + torch.arange(nq, device="cuda")
            cs, ss = ops.rope_tables_for(pos_q, dh, 1e6)
            feed = torch.ones((B, nq), dtype=torch.bool, device="cuda")
            bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
            sel = (lambda x: x[:, 0]) if nq == 1 else (lambda x: x)
            tables = (cos, sin, bias[:, 0, :S].contiguous() if nq == 1 else bias)
            q = rn(B, G, nq * Hg, dh).to(bf)
            szk, szv = sel(rn(B, nq, G, r)), sel(rn(B, nq, G, r))
            kw = dict(scale=dh ** -0.5, k_norm=0.1 * rn(dh), self_cos=sel(cs),
                      self_sin=sel(ss))
            kwf = dict(kw, self_zk=szk.to(bf), self_zv=szv.to(bf))
            (szk_q, szk_s), (szv_q, szv_s) = q8(szk), q8(szv)
            kw8 = dict(kw, self_zk_q=szk_q, self_zk_s=szk_s, self_zv_q=szv_q, self_zv_s=szv_s)
            mq = "" if nq == 1 else "_mq"
            runs = {}
            for mod, name, args, kws in (
                    (K1, f"latent_decode_attention{mq}", (q, zk.to(bf), zv.to(bf), r_k),
                     kwf),
                    (K1, f"latent_decode_attention{mq}_paged",
                     (ptab, q, paged(zk.to(bf)), paged(zv.to(bf)), r_k), kwf),
                    (KQ, f"latent_decode_attention{mq}_quant", (q, *q8(zk), *q8(zv), r_k),
                     kw8)):
                got = getattr(mod, name)(*args, *tables, **kws)
                torch.cuda.synchronize()
                compare(f"{name} Hg={Hg} nq={nq} r={r}", got,
                        getattr(mod, name + "_plain")(*args, *tables, **kws), bf)
                runs[name] = got
            ring, pool = runs[f"latent_decode_attention{mq}"], runs[f"latent_decode_attention{mq}_paged"]
            diff = (pool.float() - ring.float()).abs().max().item()
            log(f"latent_decode_attention{mq}_paged Hg={Hg} nq={nq} r={r}: max abs diff "
                f"against latent_decode_attention{mq} on the same ring {diff:.3e} (0 expected)")
            if not torch.equal(pool, ring):
                raise AssertionError(f"{'K4' if nq == 1 else 'K7'} differs from "
                                     f"{'K1' if nq == 1 else 'K5'} at Hg={Hg} r={r} by "
                                     f"{diff:.3e}")


def wide_rank_times(torch, gen):
    """What the 64-column plan costs, at run G's group width: bf16 K1 (one
    query and its self column) and K5 (nq = 4 and their self columns) on B
    = 8 full 4096-token rings of one group of s = 8 kv heads and 32 query
    rows, at the last rank of the 128-column plan and the first of the
    64-column plan (K1 704 / 712, K5 544 / 552) and at 768 and 1024; each
    within the bf16 limit of its plain version and timed beside its bound.
    Returns {"<kernel> r=<r>": {chunk, ms, bound_ms, bound_by,
    max_abs_err}}."""
    from repro_torch.kernels import latent_decode as K1
    from repro_torch.kernels import ops
    B, S, G, Hg, dh, s = 8, 4096, 1, 32, 128, 8
    bf = torch.bfloat16
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    pos = torch.arange(S, device="cuda").expand(B, S).contiguous()
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    lib = K1._lib("latent_decode_tc")
    out = {}
    for nq, ranks in ((1, (704, 712, 768, 1024)), (4, (544, 552, 768, 1024))):
        pos_q = torch.full((B, 1), S, device="cuda") + torch.arange(nq, device="cuda")
        cs, ss = ops.rope_tables_for(pos_q, dh, 1e6)
        feed = torch.ones((B, nq), dtype=torch.bool, device="cuda")
        bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
        sel = (lambda x: x[:, 0]) if nq == 1 else (lambda x: x)
        name = "latent_decode_attention" + ("" if nq == 1 else "_mq")
        kernel, plain = getattr(K1, name), getattr(K1, name + "_plain")
        for r in ranks:
            args = (rn(B, G, nq * Hg, dh).to(bf), rn(B, S, G, r).to(bf), rn(B, S, G, r).to(bf),
                    (rn(G, r, s * dh) * r ** -0.5).to(bf), cos, sin,
                    bias[:, 0, :S].contiguous() if nq == 1 else bias)
            kw = dict(scale=dh ** -0.5, k_norm=0.1 * rn(dh),
                      self_zk=sel(rn(B, nq, G, r)).to(bf), self_zv=sel(rn(B, nq, G, r)).to(bf),
                      self_cos=sel(cs), self_sin=sel(ss))
            got = kernel(*args, **kw)
            torch.cuda.synchronize()
            err = compare(f"{name} Hg={Hg} nq={nq} r={r}", got, plain(*args, **kw), bf)
            ms = cuda_ms(lambda: kernel(*args, **kw), iters=20)
            b_ms, by = bound(nbytes(*args, *kw.values(), got),
                             decode_flops(B, S + nq, G, Hg, dh, r, s, nq))
            chunk = lib.recalkv_tc_chunk(int(nq > 1), 0, dh, r, r)
            log(f"{name} B={B} S={S}+{nq} G={G} Hg={Hg} nq={nq} r={r} ({chunk}-column "
                f"chunks): kernel {ms:.4f} ms, bound {b_ms:.4f} ms ({by}), "
                f"{ms / b_ms:.1f}x bound")
            out[f"{name} r={r}"] = {"chunk": chunk, "ms": ms, "bound_ms": b_ms,
                                    "bound_by": by, "max_abs_err": err}
            del args, kw, got
    return out


def k2_widths(torch, gen):
    """K2 at value widths other than the main path's 256: 128 (the dense
    cache), 152 (ratio 0.3: one 256-column slice, its last 104 columns
    zero-filled), 384, 512 and 1024 (group_size 8 ranks: 2 to 4 slices
    along the grid), B = 2, T = 1000 (ragged), H = 32, Hkv = 8, one value
    group, causal; float32 within 1e-4 and bf16 within the bf16 limit.
    The bf16 calls are timed beside dv = 256 at the same shape (what the
    slices' recomputed scores cost)."""
    from repro_torch.kernels.flash_prefill import (
        flash_prefill_attention as k2, flash_prefill_attention_plain as p2)
    B, T, H, Hkv, dh = 2, 1000, 32, 8, 128
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    times = {}
    for dv in (128, 152, 256, 384, 512, 1024):
        f = (rn(B, T, H, dh), rn(B, T, Hkv, dh), rn(B, T, 1, dv))
        for dt in (torch.float32, torch.bfloat16):
            q, k, v = (x.to(dt) for x in f)
            got = k2(q, k, v)
            torch.cuda.synchronize()
            if dv != 256:
                compare(f"K2 dv={dv}", got, p2(q, k, v), dt)
        times[dv] = cuda_ms(lambda: k2(q, k, v), iters=20)
    log(f"K2 bf16 B={B} T={T} H={H} Hkv={Hkv} Hv=1 ms by dv: "
        + ", ".join(f"{dv} {ms:.4f} ({ms / times[256]:.2f}x dv=256)"
                    for dv, ms in times.items()))


def paged_inputs(torch, gen, nq, dense=False, arch="qwen3-4b"):
    """K4 / K7 operands: ``ring_inputs``' latents paged into a pool through
    a ragged table.  Row b holds ``lens[b]`` tokens (1024..4096); its pages
    sit at shuffled physical pages, pages past its length on the null page
    0, and rows 0 and 1 share their first physical page (same content).
    The bias and rotation tables are slot-major, from the positions the
    table gathers.  Returns (operands, the K1 / K5 ring view of the same
    content, the bound's byte and FLOP counts)."""
    from repro_torch.kernels import ops
    a = ring_inputs(torch, gen, nq, dense, arch)
    B, S, G, Hg, dh, r, s, _ = a["shape"]
    theta = None if dense else 1e6
    n_sp = S // PAGE
    g = torch.Generator().manual_seed(SEED + 3)
    lens = torch.randint(1024, S + 1, (B,), generator=g)
    used = (lens + PAGE - 1) // PAGE
    n_pages = int(used.sum()) + 1
    perm = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    ptab = torch.zeros(B, n_sp, dtype=torch.int32)
    for b in range(B):
        ptab[b, :used[b]] = torch.tensor(perm[:used[b]], dtype=torch.int32)
        perm = perm[used[b]:]
    ptab[1, 0] = ptab[0, 0]
    for k in ("zk", "zv"):
        a[k][1, :PAGE] = a[k][0, :PAGE]
    ptab = ptab.to("cuda")
    pools = {}
    for k in ("zk", "zv"):
        pool = torch.zeros((n_pages, PAGE) + tuple(a[k].shape[2:]), device="cuda")
        rows = a[k].reshape((B, n_sp, PAGE) + tuple(a[k].shape[2:]))
        mapped = ptab != 0
        pool[ptab[mapped].long()] = rows[mapped]
        pools[k] = pool
    # positions below a row's length are on its mapped pages; the rest
    # (partly filled last page, null pages) read -1
    cur = lens.to("cuda")
    t = torch.arange(S, device="cuda")
    pos = torch.where(t[None] < cur[:, None], t[None], -1)
    pos_q = cur[:, None] + torch.arange(nq, device="cuda")
    a["cos"], a["sin"] = ops.rotation_tables(pos, dh, theta)
    a["self_cos"], a["self_sin"] = ops.rotation_tables(pos_q, dh, theta)
    feed = torch.ones((B, nq), dtype=torch.bool, device="cuda")
    bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
    a["bias"] = bias[:, 0, :S].contiguous() if nq == 1 else bias
    cols = int(used.sum()) * PAGE          # mapped ring columns (tiles not skipped)
    flops = (dense_flops(1, cols + B * nq, G, Hg, dh, nq) if dense else
             2.0 * G * (cols + B * nq) * (r * s * dh + nq * Hg * (dh + r)))
    return a, ptab, pools, cols, flops


def in_order(torch, ptab, pools):
    """The same content as ``pools`` through ``ptab``, with every mapped
    slot page at its own physical page in row-major slot order (a second
    placement of one ring)."""
    mapped = ptab != 0
    order = torch.zeros_like(ptab)
    order[mapped] = torch.arange(1, int(mapped.sum()) + 1, device=ptab.device,
                                 dtype=ptab.dtype)
    out = {}
    for k, pool in pools.items():
        p = torch.zeros((int(mapped.sum()) + 1,) + tuple(pool.shape[1:]),
                        device=pool.device, dtype=pool.dtype)
        p[order[mapped].long()] = pool[ptab[mapped].long()]
        out[k] = p
    return order, out


def phase_paged(torch, gen, nq, arch="qwen3-4b"):
    """K4 (nq = 1) or K7 (nq = 4) at the main path's width over a ragged
    pool, against the plain version in f32 and bf16.  Both must equal K1 /
    K5 on the gathered ring bit for bit in both types (same tiles, same
    order; in bf16 K4 / K7 and K1 / K5 are the tensor-core body with two
    row maps), and in bf16 each must equal itself on an in-order placement
    of the same pages.  Each is timed; the bound counts the mapped pages, the table and
    the slot-major tables of the mapped columns."""
    from repro_torch.kernels import latent_decode as K
    a, ptab, pools, cols, flops = paged_inputs(torch, gen, nq, arch=arch)
    B, S, G, Hg, dh, r, s, _ = a["shape"]
    one = nq == 1
    name = "latent_decode_attention_paged" if one else "latent_decode_attention_mq_paged"
    kernel, plain = getattr(K, name), getattr(K, name + "_plain")
    ring = K.latent_decode_attention if one else K.latent_decode_attention_mq
    sel = (lambda x: x[:, 0]) if one else (lambda x: x)
    res, view_err = {}, {}
    for dt in (torch.float32, torch.bfloat16):
        zk, zv = pools["zk"].to(dt), pools["zv"].to(dt)
        args = (ptab, a["q"].to(dt), zk, zv, a["r_k"].to(dt), a["cos"], a["sin"], a["bias"])
        kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], self_zk=sel(a["self_zk"]).to(dt),
                  self_zv=sel(a["self_zv"]).to(dt), self_cos=sel(a["self_cos"]),
                  self_sin=sel(a["self_sin"]))
        got = kernel(*args, **kw)
        torch.cuda.synchronize()
        res[dt] = compare(name, got, plain(*args, **kw), dt)
        view_args = (args[1], K.gather_pages(zk, ptab), K.gather_pages(zv, ptab), *args[4:])
        view = ring(*view_args, **kw)
        torch.cuda.synchronize()
        diff = (got.float() - view.float()).abs().max().item()
        log(f"{name} {dt}: max abs diff against {ring.__name__} on the gathered "
            f"ring {diff:.3e} (0 expected: same tiles, same order)")
        if not torch.equal(got, view):
            raise AssertionError(f"{name} differs from {ring.__name__} on the "
                                 f"gathered ring by {diff:.3e}")
        if dt == torch.bfloat16:
            order, opools = in_order(torch, ptab, {"zk": zk, "zv": zv})
            again = kernel(order, args[1], opools["zk"], opools["zv"], *args[4:], **kw)
            torch.cuda.synchronize()
            pdiff = (got.float() - again.float()).abs().max().item()
            log(f"{name} {dt}: max abs diff between the shuffled and the in-order page "
                f"placement {pdiff:.3e} (0 expected)")
            if not torch.equal(got, again):
                raise AssertionError(f"{name} depends on the page placement ({pdiff:.3e})")
        view_err[dt] = diff
    ms = cuda_ms(lambda: kernel(*args, **kw), iters=50)
    view_ms = cuda_ms(lambda: ring(*view_args, **kw), iters=50)
    plain_ms = cuda_ms(lambda: plain(*args, **kw), iters=3)
    elt = args[2].element_size()
    used_pages = int(torch.unique(ptab[ptab != 0]).numel())
    lat = used_pages * PAGE * G * 2 * r * elt
    tables = cols * (dh * 4 + 4 * nq)            # cos + sin (f32) + bias per column
    b_ms, by = bound(lat + tables + nbytes(ptab, args[1], args[4], got,
                                           *[v for v in kw.values() if hasattr(v, "numel")]),
                     flops)
    log(f"{name} B={B} S={S} page_size={PAGE} "
        f"{used_pages} pages nq={nq}: max err f32 "
        f"{res[torch.float32]:.3e} bf16 {res[torch.bfloat16]:.3e}; kernel {ms:.4f} ms, "
        f"{ring.__name__} on the view {view_ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{b_ms:.4f} ms ({by})")
    line = 456 if one else 567
    entry = {"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/latent_decode_tc.cu",
             "replaces": f"src/repro/kernels/latent_decode.py:{line}",
             "tpu_kernel": f"src/repro/kernels/latent_decode.py::{name}",
             "max_abs_err": res[torch.bfloat16], "max_err_f32": res[torch.float32],
             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
             "library_ms": None, "view_ms": view_ms,
             "view_max_abs_diff": view_err[torch.bfloat16],
             "shape": (f"B={B} S={S}+{nq} page_size={PAGE} pages={used_pages} G={G} "
                       f"Hg={Hg} nq={nq} dh={dh} r={r} bf16, ragged table")}
    return family_row(entry, arch)


def phase_k2(torch, gen, arch="qwen3-4b", window=None, dense=False):
    """K2 at B=8, T=2048 and ``arch``'s heads, its latent value groups as
    values (qwen3-4b: H=32, Hkv=8, Hv=G=2, dv=r=256), causal, or within
    ``window``; with ``dense`` the dense cache's values (Hv = Hkv, dv =
    dh).  The yardstick is one SDPA call on the same function (the window
    as a boolean mask)."""
    from repro_torch.kernels.flash_prefill import (
        flash_prefill_attention as k2, flash_prefill_attention_plain as p2)
    w = WIDTHS[arch]
    B, T, Hkv, dh = 8, 2048, w["Hkv"], w["dh"]
    H = Hkv * w["qpk"]
    Hv, dv = (Hkv, dh) if dense else (w["G"], w.get("rv", w["r"]))
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    f = (rn(B, T, H, dh), rn(B, T, Hkv, dh), rn(B, T, Hv, dv))
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dt) for x in f)
        got = k2(q, k, v, window=window)
        torch.cuda.synchronize()
        res[dt] = compare("K2", got, p2(q, k, v, window=window), dt)
    ms = cuda_ms(lambda: k2(q, k, v, window=window), iters=50)
    plain_ms = cuda_ms(lambda: p2(q, k, v, window=window), iters=2, warmup=1)
    # yardstick: one SDPA call on the same function (values repeated to
    # the kv heads outside the timed region); the port never calls it
    vr = v.repeat_interleave(Hkv // Hv, dim=2).transpose(1, 2)
    qt, kt = q.transpose(1, 2), k.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    if window is None:
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vr, is_causal=True, enable_gqa=True),
                             iters=50)
        pairs = T * (T + 1) / 2
    else:
        t = torch.arange(T, device="cuda")
        mask = (t[None, :] <= t[:, None]) & (t[None, :] > t[:, None] - window)
        library_ms = cuda_ms(lambda: sdpa(qt, kt, vr, attn_mask=mask, enable_gqa=True),
                             iters=50)
        pairs = float(mask.sum())
    flops = 2.0 * B * H * pairs * (dh + dv)
    b_ms, by = bound(nbytes(q, k, v, got), flops)
    how = "causal" if window is None else f"window {window}"
    log(f"K2 flash_prefill B={B} T={T} H={H} Hkv={Hkv} Hv={Hv} dh={dh} dv={dv} {how}: max "
        f"err f32 {res[torch.float32]:.3e} bf16 {res[torch.bfloat16]:.3e}; kernel {ms:.4f} "
        f"ms, plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    entry = {"name": "flash_prefill_attention", "route": "cuda",
             "source": "src/repro_torch/csrc/flash_prefill.cu",
             "replaces": "src/repro/kernels/flash_prefill.py:80",
             "tpu_kernel": "src/repro/kernels/flash_prefill.py::flash_prefill_attention",
             "max_abs_err": res[torch.bfloat16], "max_err_f32": res[torch.float32],
             "ms": ms,
             "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
             "library_ms": library_ms,
             "shape": f"B={B} T={T} H={H} Hkv={Hkv} Hv={Hv} dh={dh} dv={dv} {how} bf16"}
    return family_row(entry, arch, (", dense" if dense else f", dv {dv}")
                      + ("" if window is None else f", window {window}"))


def phase_backends(torch, cfg, params, verify_bits=(None, 8), lens=(512, 300),
                   max_len=1024, source=None):
    """Prefill + 4 decode steps through both backends (kernel-backend
    greedy tokens fed to both), B=2 with prompts of ``lens`` tokens (512 and
    300) in rings of ``max_len``; then, on a float ring (None in
    ``verify_bits``) and an int8 ring (8), prefill + one 4-token verify
    step.  A cross model's prefills read ``source``'s first two rows."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (2, max(lens)), generator=gen, device="cuda")
    lens = torch.tensor(lens, device="cuda")
    fed = torch.randint(0, cfg.vocab_size, (2, 4), generator=gen, device="cuda")
    mask = torch.ones((2, 4), dtype=torch.bool, device="cuda")
    runs = {}
    feed = None
    for backend in ("kernel", "einsum"):
        c = dataclasses.replace(cfg, attn_backend=backend)
        src = None if source is None else source[:2]
        logits, caches = T.prefill(c, params, toks, lens, max_len, source=src)
        outs, cur = [logits], lens.clone()
        for i in range(4):
            tok = logits.argmax(-1) if feed is None else feed[i]
            logits, caches = T.decode_step(c, params, caches, tok, cur)
            outs.append(logits)
            cur = cur + 1
        if feed is None:
            feed = [o.argmax(-1) for o in outs[:-1]]
        runs[("decode", backend)] = torch.stack(outs)
        for bits in verify_bits:
            cb = dataclasses.replace(c, cache_quant_bits=bits)
            _, caches = T.prefill(cb, params, toks, lens, max_len, source=src)
            runs[(f"verify {'int8' if bits else 'float'}", backend)], _ = T.verify_step(
                cb, params, caches, fed, lens, mask)
        del caches
    out = {}
    for what in ["decode"] + [f"verify {'int8' if b else 'float'}" for b in verify_bits]:
        ker, ref = runs[(what, "kernel")], runs[(what, "einsum")]
        if not torch.isfinite(ker).all():
            raise AssertionError(f"kernel-backend {what} logits are not finite")
        err = (ker - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        agree = (ker.argmax(-1) == ref.argmax(-1)).float().mean().item()
        log(f"full-width backends, {cfg.name}{' (dense)' if cfg.recalkv is None else ''}, "
            f"{what}: "
            f"logits max abs err {err:.4e} (relative "
            f"{rel:.3e}), greedy agreement {agree:.3f} over {ker[..., 0].numel()} rows")
        if rel > 5e-2:
            raise AssertionError(f"kernel backend {what} logits differ from einsum by "
                                 f"{rel:.3e} relative (bf16 bound 5e-2)")
        out[what] = {"logits_max_abs_err": err, "logits_rel_err": rel,
                     "greedy_agreement": agree}
    return out


def phase_paged_steps(torch, cfg, params, bits_list=(None, 8)):
    """Decode and 4-token verify steps on paged float and int8 pools
    (page_size 16, every slot page mapped at a shuffled physical page)
    holding the content of a prefilled ring (B=2, prompts of 512 and 300
    tokens, max_len 1024), through the kernel backend.  A decode step and
    then a verify step at the next position, which reads the latents that
    decode wrote, must equal the ring's logits bit for bit, so the decode
    step's paged writes landed where the ring's did; on the float pool a
    verify step before any write must too.  The int8 pool is read through
    the gathered view with K3 / K6; the float pool runs K4 (in bf16 K1's
    tensor-core body through the page table) and K7 (K5's tiles in
    order), the dense model's pool the dense decode and verify kernels
    through the page table."""
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import _merge_slot_paged
    gen = torch.Generator(device="cuda").manual_seed(SEED + 4)
    B, L = 2, 1024
    toks = torch.randint(0, cfg.vocab_size, (B, 512), generator=gen, device="cuda")
    lens = torch.tensor([512, 300], device="cuda")
    tok = torch.randint(0, cfg.vocab_size, (B,), generator=gen, device="cuda")
    fed = torch.randint(0, cfg.vocab_size, (B, 4), generator=gen, device="cuda")
    mask = torch.ones((B, 4), dtype=torch.bool, device="cuda")
    n_sp = L // PAGE
    perm = torch.randperm(B * n_sp, generator=torch.Generator().manual_seed(SEED + 5)) + 1
    pages = (perm.reshape(B, n_sp).to(device="cuda", dtype=torch.int32), PAGE)
    rows = torch.arange(B, device="cuda").repeat_interleave(n_sp)
    cols = torch.arange(n_sp, device="cuda").repeat(B)
    out = {}

    def check(name, g, w):
        if not torch.isfinite(g).all():
            raise AssertionError(f"{name}: logits are not finite")
        diff = (g - w).abs().max().item()
        log(f"{name}: logits max abs diff against the ring {diff:.3e}")
        if not torch.equal(g, w):
            raise AssertionError(f"{name}: logits differ from the ring's by {diff:.3e}")
        out[name] = diff

    for bits in bits_list:
        c = dataclasses.replace(cfg, cache_quant_bits=bits)
        kind = ("int8" if bits else "float") + (" mla" if cfg.mla is not None else
                                                 " dense" if cfg.recalkv is None else "")
        _, ring = T.prefill(c, params, toks, lens, L)
        pool = T.init_decode_cache(c, B, L, "cuda", pages=(B * n_sp + 1, PAGE))
        _merge_slot_paged(pool, ring, rows, cols, pages[0].reshape(-1).long(), PAGE)
        if not bits:   # verify writes nothing, so the pool still holds the ring
            check(f"paged {kind} pool, verify before decode",
                  T.verify_step(c, params, pool, fed, lens, mask, pages=pages)[0],
                  T.verify_step(c, params, ring, fed, lens, mask)[0])
        for what, step in (("decode", lambda cache, pg: T.decode_step(
                               c, params, cache, tok, lens, pages=pg)),
                           ("verify after decode", lambda cache, pg: T.verify_step(
                               c, params, cache, fed, lens + 1, mask, pages=pg))):
            check(f"paged {kind} pool, {what}", step(pool, pages)[0], step(ring, None)[0])
        del ring, pool
    return out


# Engine runs: cache_quant_bits, spec_depth, draft, prefill_chunk, sync_every,
# the kernels that must launch, and the paged pool's keywords (none: ring).
D_SUFFIX = (865, 515, 569, 518, 348, 702, 628, 933, 233, 716, 296, 1011)
D_NEW, D_PAGES = 256, 385
ENGINE_RUNS = {
    "A": dict(bits=None, depth=0, draft=None, chunk=1792, sync=16,
              must=("latent_decode_attention", "flash_prefill_attention")),
    "B": dict(bits=8, depth=3, draft="layers:4", chunk=960, sync=8,
              must=("flash_prefill_attention", "latent_decode_attention_quant",
                    "latent_decode_attention_mq_quant")),
    "C": dict(bits=None, depth=3, draft="ngram", chunk=None, sync=8,
              must=("flash_prefill_attention", "latent_decode_attention_mq")),
    # a 385-page pool (384 usable; 433 MiB of bf16 latents at 72 KiB per
    # token) holds one and a half full-length rings
    "D": dict(bits=None, depth=0, draft=None, chunk=None, sync=16,
              must=("flash_prefill_attention", "latent_decode_attention_paged"),
              paged=dict(cache_layout="paged", page_size=PAGE, n_pages=D_PAGES,
                         policy="prefix-affinity", lazy_pages=True, pin_prefixes=1)),
    "E": dict(bits=None, depth=3, draft="ngram", chunk=None, sync=8,
              must=("flash_prefill_attention", "latent_decode_attention_mq_paged"),
              paged=dict(cache_layout="paged", page_size=PAGE,
                         policy="reach-packing")),
    # the model at group_size 8 (GROUP8), with its own weights
    "F": dict(bits=None, depth=0, draft=None, chunk=None, sync=16,
              must=("latent_decode_attention", "flash_prefill_attention")),
    # the same at rank 768 (a 64-column plan), with its own weights,
    # verifying C's prompts
    "G": dict(bits=None, depth=3, draft="ngram", chunk=None, sync=8,
              must=("flash_prefill_attention", "latent_decode_attention_mq")),
    # the dense model (recalkv=None): K2 at Hv = 8, dv = 128, and the dense
    # cores: the dense decode kernel (H), the dense verify kernel's pool (I)
    "H": dict(bits=None, depth=0, draft=None, chunk=768, sync=16,
              must=("flash_prefill_attention", "dense_decode_attention")),
    "I": dict(bits=None, depth=3, draft="ngram", chunk=None, sync=8,
              must=("flash_prefill_attention", "dense_decode_attention_mq_paged"),
              paged=dict(cache_layout="paged", page_size=PAGE,
                         policy="reach-packing")),
    # I at spec_depth 8: 9 verify queries, past the dense verify kernel's
    # one m16 tile at q_per_kv 4 (36 rows: one partial 64-row group)
    "I9": dict(bits=None, depth=8, draft="ngram", chunk=None, sync=8,
               must=("flash_prefill_attention", "dense_decode_attention_mq_paged"),
               paged=dict(cache_layout="paged", page_size=PAGE,
                          policy="reach-packing")),
    # the artifact the port compressed from H's model (r = 256, G = 2)
    "J": dict(bits=None, depth=0, draft=None, chunk=None, sync=16, new=16,
              must=("flash_prefill_attention", "latent_decode_attention")),
    # continuous batching (CONTINUOUS): 24 requests ending at different
    # lengths on the float ring ...
    "S": dict(bits=None, depth=0, draft=None, chunk=None, sync=16,
              must=("latent_decode_attention", "flash_prefill_attention")),
    # ... and 16 motif prompts on the dense pool with n-gram speculation
    "T": dict(bits=None, depth=3, draft="ngram", chunk=None, sync=8,
              must=("flash_prefill_attention", "dense_decode_attention_mq_paged"),
              paged=dict(cache_layout="paged", page_size=PAGE, policy="fifo")),
}
# The families' runs (bf16, random weights from seed 0, full width and
# depth): "prompts" names the run whose prompts and budgets they take.
# gemma3-12b dense (V, V3) and compressed in the run (U, U3, UB: r 512,
# G 2); minicpm-2b at recalkv_ratio 0.5 (M: G 9, r 128) and dense (M3).
ENGINE_RUNS.update({
    "V": dict(bits=None, depth=0, draft=None, chunk=None, sync=16, prompts="A",
              must=("flash_prefill_attention", "dense_decode_attention")),
    "V3": dict(bits=None, depth=3, draft="ngram", chunk=None, sync=8, prompts="C",
               must=("flash_prefill_attention", "dense_decode_attention_mq")),
    "U": dict(bits=None, depth=0, draft=None, chunk=None, sync=16, prompts="A",
              must=("flash_prefill_attention", "latent_decode_attention")),
    "U3": dict(bits=None, depth=3, draft="ngram", chunk=None, sync=8, prompts="C",
               must=("flash_prefill_attention", "latent_decode_attention_mq")),
    "UB": dict(bits=8, depth=3, draft="layers:4", chunk=960, sync=8, prompts="B",
               must=("flash_prefill_attention", "latent_decode_attention_quant",
                     "latent_decode_attention_mq_quant")),
    "M": dict(ENGINE_RUNS["D"], prompts="D"),
    "M3": dict(bits=None, depth=3, draft="ngram", chunk=None, sync=8, prompts="C",
               must=("flash_prefill_attention", "dense_decode_attention_mq_paged"),
               paged=dict(cache_layout="paged", page_size=PAGE, policy="reach-packing")),
})
# h2o-danube-1.8b (dh 80, every layer local at window 4,096) as gemma3's:
# dense (N, N3) and compressed in the run (NU, NU3, NUB: G 2, r 160);
# qwen3-moe-235b-a22b at MOE_LAYERS layers (q_per_kv 16, MoE FFN): dense
# (Q, Q3), compressed in the run (QU on D's pool and traffic: K4; QU3:
# G 1, r 256).
ENGINE_RUNS.update({"N": ENGINE_RUNS["V"], "N3": ENGINE_RUNS["V3"], "NU": ENGINE_RUNS["U"],
                    "NU3": ENGINE_RUNS["U3"], "NUB": ENGINE_RUNS["UB"],
                    "Q": ENGINE_RUNS["V"], "Q3": ENGINE_RUNS["V3"], "QU": ENGINE_RUNS["M"],
                    "QU3": ENGINE_RUNS["U3"]})
# deepseek-v3-671b at DS_LAYERS layers (MLA; its 3 attn_dense layers and 1
# MoE layer of 256 experts + 1 shared): DS (A's prompts), DS3 (C's,
# "ngram"), DSP (D's pool and traffic: it must share and preempt).  MLA's
# readers and prefill launch no kernel (JAX's einsum path), so none must.
ENGINE_RUNS.update({"DS": dict(ENGINE_RUNS["V"], must=()),
                    "DS3": dict(ENGINE_RUNS["V3"], must=()),
                    "DSP": dict(ENGINE_RUNS["M"], must=())})
# The cross-attention models (``phase_cross``; full width and depth, a
# seeded source): llama-3.2-vision-11b dense (X, A's prompts) and compressed
# in the run (XU, A's; XU3, C's with "ngram"; XUs, S's traffic, sync, the
# twin of the continuous XU+c), and whisper-small dense (W) and compressed
# in the run (WU), both on A's prompts.
ENGINE_RUNS.update({"X": ENGINE_RUNS["V"], "XU": ENGINE_RUNS["U"], "XU3": ENGINE_RUNS["U3"],
                    "XUs": dict(ENGINE_RUNS["S"], prompts="S"),
                    "W": ENGINE_RUNS["V"], "WU": ENGINE_RUNS["U"]})
# The recurrent models (``phase_recurrent``; full width and depth):
# falcon-mamba-7b, dense only (FM, A's prompts), and recurrentgemma-9b dense
# (RG, A's) and compressed in the run (RGU, A's; RGU8 on the int8 ring).
# FMs / RGUs (sync) and their continuous twins FM+c / RGU+c serve R's
# traffic: S's, at prompt lengths of 1,025-2,048, so that every wave pads
# to one 2,048-token bucket.  A prefill runs the mixers over its bucket's
# pads, as the JAX engine does, so a request's state (and stream) depends
# on its wave's bucket; with one bucket it does not depend on how the
# waves form.
ENGINE_RUNS.update({"FM": dict(ENGINE_RUNS["V"], must=()),
                    "FMs": dict(ENGINE_RUNS["S"], prompts="R", must=()),
                    "RG": ENGINE_RUNS["V"], "RGU": ENGINE_RUNS["U"],
                    "RGU8": dict(ENGINE_RUNS["U"], bits=8,
                                 must=("flash_prefill_attention",
                                       "latent_decode_attention_quant")),
                    "RGUs": dict(ENGINE_RUNS["S"], prompts="R")})
# the Fisher-allocated qwen3-4b artifact (``phase_train``) serves A's traffic
ENGINE_RUNS["FI"] = dict(ENGINE_RUNS["A"], prompts="A")
# bytes of K / V (or latents) per token and layer each run's cache must hold
CACHE_BYTES = {"H": 4096, "I": 4096, "I9": 4096, "J": 2048, "V": 8192, "V3": 8192,
               "U": 4096, "U3": 4096, "M": 4608, "M3": 9216, "N": 2560, "N3": 2560,
               "NU": 1280, "NU3": 1280, "Q": 2048, "Q3": 2048, "QU": 1024, "QU3": 1024,
               # MLA: c_kv (512) and the shared RoPE key columns (64), bf16
               "DS": 1152, "DS3": 1152, "DSP": 1152,
               # llama-vision: qwen3-4b's heads; whisper: 12 kv heads of dh 64,
               # G 3 x r 128 compressed
               "X": 4096, "XU": 2048, "XU3": 2048, "XUs": 2048, "W": 3072, "WU": 1536,
               # recurrentgemma: one kv head of dh 256; G 1 x r 128 compressed
               # (int8: 128 B a latent and a float32 scale, keys and values)
               "RG": 1024, "RGU": 512, "RGUs": 512, "RGU8": 264}
# a recurrent model's state per slot, (h, conv) bytes, whatever the prompt:
# falcon-mamba FM_LAYERS layers x (8,192 x 16 float32, 3 x 8,192 bf16) (its
# depth cut from 64 to keep the whole run inside its time limit beside the
# mesh phase: each layer is the same Mamba block);
# recurrentgemma 26 rglru layers x (4,096 float32, 3 x 4,096 bf16)
FM_LAYERS = 16
STATE_BYTES = {**dict.fromkeys(("FM", "FMs"), (FM_LAYERS * 8192 * 16 * 4,
                                               FM_LAYERS * 3 * 8192 * 2)),
               **dict.fromkeys(("RG", "RGU", "RGU8", "RGUs"),
                               (26 * 4096 * 4, 26 * 3 * 4096 * 2))}
# a cross model's cache per slot: its cross layers' source keys and values
# (or latents), cross_source_len positions each, bf16
CROSS_BYTES = {"X": 8 * 1600 * 4096, "XU": 8 * 1600 * 2048, "XU3": 8 * 1600 * 2048,
               "XUs": 8 * 1600 * 2048, "W": 12 * 1500 * 3072, "WU": 12 * 1500 * 1536}
# runs served again by the overlapped engine with the window captured as
# CUDA graphs (overlap=True, aot=True); B also with adaptive speculation.
# Their streams must equal the sync runs' in the same call.
OVERLAPPED = {"A": {}, "B": dict(adaptive_spec=True), "D": {}, "H": {}, "I": {}, "V": {},
              # inline admission: the sync run's one 8-row prefill wave.  A
              # worker thread forms waves as requests arrive, and under MoE
              # the rows of a call share the experts' capacity, so another
              # grouping gives other tokens (so does the JAX engine)
              "FI": {},
              "Q": dict(admission_thread=False), "DS": dict(admission_thread=False),
              # a cross model's wave row i reads source row i: the sync run's
              # one 8-row wave again
              "XU": dict(admission_thread=False), "WU": dict(admission_thread=False),
              # a recurrent state runs over its wave's pads: the sync run's
              # one 8-row wave again
              "FM": dict(admission_thread=False), "RGU": dict(admission_thread=False)}
# runs served three ways in one call (sync; overlapped + graphs at pipeline
# depth 3; the same with continuous batching): streams equal, installs
# inside the windows
CONTINUOUS = {"S": dict(pipeline_depth=3), "T": dict(pipeline_depth=3)}
# runs F and G's latent caches: one group of all 8 kv heads (32 query rows
# per group) at rank 512 = s * dh / 2 (F) and 768 (G, keep ratio 0.75);
# r_v the value width of their K2
GROUP8 = {"F": dict(rank_k=512, rank_v=512, group_size=8),
          "G": dict(rank_k=768, rank_v=768, group_size=8)}


def engine_prompts(torch, run, vocab):
    gen = torch.Generator().manual_seed(SEED + 2)
    rand = lambda n: torch.randint(0, vocab, (n,), generator=gen).numpy()
    if run == "A":          # 512..2048; the 2048 one streams 256 tokens
        return [(rand(n), 32) for n in (512, 640, 768, 1024, 1280, 1536, 1792, 2048)]
    if run == "B":          # 512..1024; the 1024 one streams 64 tokens
        return [(rand(n), 32) for n in (512, 576, 640, 704, 768, 832, 896, 1024)]
    if run == "D":          # a shared 1024-token system prompt + own suffixes
        system = rand(1024)
        return [(np.concatenate([system, rand(n)]), D_NEW) for n in D_SUFFIX]
    if run == "F":
        return [(rand(512), 32)]
    if run == "H":          # 512..1024; the 1024 one streams 256 tokens
        return [(rand(n), 32) for n in (512, 640, 768, 1024)]
    if run == "S":          # 512..2048, budgets 16..96 cycled: slots free apart
        lens = torch.randint(512, 2049, (24,), generator=gen).tolist()
        return [(rand(n), 16 + 8 * (i % 11)) for i, n in enumerate(lens)]
    if run == "R":          # S's, at 1,025..2,048 tokens: one prefill bucket
        lens = torch.randint(1025, 2049, (12,), generator=gen).tolist()
        return [(rand(n), 16 + 8 * (i % 11)) for i, n in enumerate(lens)]
    motif = rand(64)
    if run == "T":          # motif prompts of 320..512, budgets 16..48 cycled
        lens = torch.randint(320, 513, (16,), generator=gen).tolist()
        return [(np.tile(motif, 8)[:n], 16 + 8 * (i % 5)) for i, n in enumerate(lens)]
    # C, E, G, I and J: a motif repeated, for prompt lookup
    return [(np.tile(motif, 8), 16), (np.tile(motif, 6)[:320], 16)]


def launch_counts(kernels) -> dict:
    """Launches since the last reset, by wrapper (the dense decode and
    verify kernels among them)."""
    return {k.__name__: k.launches for k in kernels.KERNELS}


def cache_bytes(torch, cache) -> tuple[int, int]:
    """(K / V or latent bytes, position bytes) per token of the first
    self-attention layer, read from the allocated tensors (ring (B, L, ...)
    or pool (n_pages, page_size, ...) leaves); (0, 0) without one."""
    leaves = next((c["self"] for c in cache if "self" in c), None)
    if leaves is None:
        return 0, 0
    per = {k: v[0, 0].numel() * v.element_size() for k, v in leaves.items()}
    return sum(b for k, b in per.items() if k != "pos"), per["pos"]


def phase_engine(torch, cfg, params, run, artifact=None, overlapped=False, extra=None,
                 label=None):
    """One engine run; with ``artifact`` (a saved path) the engine boots
    through ``Engine.from_artifact`` instead of (cfg, params).  With
    ``overlapped`` the overlapped engine serves it with its window captured
    as CUDA graphs (``OVERLAPPED``): a graph replay does not pass through
    the wrappers' counters, so the run's launches add each graph's captured
    launches times its replays to what the eager prefill counted, and
    ``captures`` may not move after construction.  ``extra`` adds engine
    keywords (``continuous``, ``staging_depth``, ...); ``label`` names the
    run in the log."""
    from repro_torch import kernels
    from repro_torch.serving import Engine, Request
    spec = ENGINE_RUNS[run]
    bits, depth, draft, must = spec["bits"], spec["depth"], spec["draft"], spec["must"]
    gc.collect()   # earlier runs' engines (threads and graphs in reference cycles)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    kw = dict(max_slots=8, max_len=4096, sync_every=spec["sync"],
              prefill_chunk=spec["chunk"], spec_depth=depth, draft=draft,
              **spec.get("paged", {}))
    if overlapped:
        kw.update(overlap=True, aot=True, **OVERLAPPED.get(run, {}))
    kw.update(extra or {})
    t0 = time.perf_counter()
    if artifact is None:
        eng = Engine(dataclasses.replace(cfg, cache_quant_bits=bits), params, **kw)
    else:
        eng = Engine.from_artifact(artifact, **kw)
        cfg = eng.cfg
    boot_s = time.perf_counter() - t0
    captures = eng.metrics()["captures"]
    if overlapped and captures != 2:
        raise AssertionError(f"engine run {run}: {captures} graphs captured, expected 2 "
                             f"(greedy and sampled)")
    kv_bytes, pos_bytes = cache_bytes(torch, eng.cache)
    cross_slot = sum(nbytes(*c["cross"].values()) for c in eng.cache if "cross" in c) // 8
    self_slot = sum(nbytes(*c["self"].values()) for c in eng.cache if "self" in c) // 8
    state_slot = tuple(sum(nbytes(c["state"][k]) for c in eng.cache if "state" in c) // 8
                       for k in ("h", "conv"))
    if any(state_slot):
        log(f"engine run {label or run}: cache bytes per slot: recurrent state h "
            f"{state_slot[0]:,} + conv {state_slot[1]:,}, self {self_slot:,}")
        if state_slot != STATE_BYTES[run]:
            raise AssertionError(f"engine run {run}: the state holds {state_slot} B per "
                                 f"slot, expected {STATE_BYTES[run]}")
    if eng.source is not None:
        log(f"engine run {label or run}: source {tuple(eng.source.shape)}, cache bytes per "
            f"slot: self {self_slot:,}, cross {cross_slot:,}")
        if cross_slot != CROSS_BYTES[run]:
            raise AssertionError(f"engine run {run}: the cross cache holds {cross_slot} B "
                                 f"per slot, expected {CROSS_BYTES[run]}")
    reqs = engine_prompts(torch, spec.get("prompts", run), cfg.vocab_size)
    if "new" in spec:
        reqs = [(p, spec["new"]) for p, _ in reqs]
    for uid, (prompt, n_new) in enumerate(reqs):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n_new))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    eng.close()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts(kernels)
    m = eng.metrics()
    for g in m["graphs"].values():
        for k, n in g["launches"].items():
            launches[k] += n * g["replays"]
    if m["captures"] != captures:
        raise AssertionError(f"engine run {run}: captures moved while serving "
                             f"({captures} -> {m['captures']})")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    pool = {k: m[k] for k in ("cache_layout", "page_size", "pages_total", "pages_peak",
                              "pages_shared", "cow_forks", "preemptions",
                              "prefill_calls_saved", "prefix_resurrections",
                              "pages_pinned", "policy", "lazy_pages")}
    name = label or (f"{run}, overlapped + graphs" if overlapped else run)
    stage_bytes = (sum(nbytes(*c[part].values()) for c in eng._stage["cache"] for part in c)
                   if eng.continuous and "cache" in eng._stage else 0)
    if overlapped:
        log(f"engine run {name}: boot {boot_s:.3f} s, capture {m['capture_s']:.3f} s, "
            f"captures {m['captures']}, window_overlap {m['window_overlap']:.3f}, "
            f"windows_idle {m['windows_idle']}, spec_degraded {m['spec_degraded']}, "
            f"admission_syncs {m['admission_syncs']}, continuous {m['continuous']}, "
            f"slot_swaps {m['slot_swaps']}, staging_depth {m['staging_depth']}, stage "
            f"cache {stage_bytes / 2 ** 30:.3f} GiB, occupancy_device_mean "
            f"{m['occupancy_device_mean']:.3f}, graphs " + "; ".join(
                f"{k}: {g['replays']} replays, captured in {g['capture_s']:.3f} s, "
                f"launches per replay {g['launches']}" for k, g in m["graphs"].items()))
    log(f"engine run {name} (int8 cache: {bits is not None}, spec_depth {depth}, draft "
        f"{draft}): {len(done)} requests, {m['tokens']} tokens in {wall:.3f} s, "
        f"{m['tokens_per_s']:.2f} tok/s, ttft {m['ttft_s']:.3f} s, windows "
        f"{m['windows']}, accept rate {m['accept_rate']:.3f} ({m['draft_accepted']}/"
        f"{m['draft_proposed']}), prefill calls {m['prefill_calls']}, peak memory "
        f"{peak:.2f} GiB, cache bytes per token and layer {kv_bytes} (+ {pos_bytes} "
        f"position), launches {launches}, pool {pool}")
    if run in CACHE_BYTES and kv_bytes != CACHE_BYTES[run]:
        raise AssertionError(f"engine run {run}: the cache holds {kv_bytes} B per token "
                             f"and layer, expected {CACHE_BYTES[run]}")
    if len(done) != len(reqs) or any(len(r.out_tokens) != n for r, (_, n) in
                                     zip(sorted(done, key=lambda r: r.uid), reqs)):
        raise AssertionError(f"engine run {run} did not finish every request")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError(f"engine run {run} emitted an out-of-vocabulary token")
    missing = [k for k in must if launches[k] <= 0]
    if missing:
        raise AssertionError(f"engine run {run}: kernels of its path never launched: "
                             f"{missing} ({launches})")
    # the overlapped D admits on its own schedule (its lazy headroom spans
    # the windows in flight), so only the sync run must reach preemption
    if run in ("D", "DSP") and (m["pages_shared"] < 1
                                or (m["preemptions"] < 1 and not overlapped)):
        raise AssertionError(f"engine run {name} must share pages"
                             + ("" if overlapped else " and preempt") + f": {pool}")
    streams = {r.uid: list(r.out_tokens) for r in done}
    return launches, streams, {
        **{k: m[k] for k in ("tokens", "tokens_per_s", "ttft_s", "windows",
                             "prefill_calls", "run_seconds", "spec_depth", "draft",
                             "draft_proposed", "draft_accepted", "accept_rate",
                             "overlap", "aot", "captures", "capture_s", "window_overlap",
                             "windows_idle", "spec_degraded", "graphs", "continuous",
                             "slot_swaps", "staging_depth", "occupancy_device_mean",
                             "pipeline_depth")},
        "stage_cache_bytes": stage_bytes, "cross_bytes_per_slot": cross_slot,
        "state_bytes_per_slot": sum(state_slot),
        "boot_s": boot_s, "profile_s": m["profile"]["seconds"],
        **pool, "cache_quant_bits": bits, "peak_gib": peak, "wall_s": wall,
        "cache_bytes_per_token_layer": kv_bytes, "pos_bytes_per_token_layer": pos_bytes}


def phase_overlapped(torch, cfg, params, runs, by_run, streams, serving, extra=None):
    """Serve ``runs`` again with the overlapped engine and the window as
    CUDA graphs (``OVERLAPPED``; keys "A+" ...): each run's streams must
    equal its sync run's in this call, token for token.  ``extra`` adds
    engine keywords (a cross model's ``source``)."""
    t0 = time.perf_counter()
    for run in runs:
        key = run + "+"
        by_run[key], streams[key], serving[key] = phase_engine(torch, cfg, params, run,
                                                               overlapped=True, extra=extra)
        if streams[key] != streams[run]:
            raise AssertionError(f"engine run {run}: the overlapped engine's streams "
                                 f"differ from the sync run's: {streams[key]} vs "
                                 f"{streams[run]}")
        a, b = serving[run], serving[key]
        log(f"engine run {run}: overlapped + graphs streams equal the sync run's; tok/s "
            f"{b['tokens_per_s']:.2f} (sync {a['tokens_per_s']:.2f}, "
            f"{b['tokens_per_s'] / a['tokens_per_s']:.2f}x), ttft {b['ttft_s']:.3f} s "
            f"(sync {a['ttft_s']:.3f} s)")
    log(f"overlapped runs {', '.join(runs)} took {time.perf_counter() - t0:.1f} s")


def phase_continuous(torch, cfg, params, run, by_run, streams, serving):
    """Serve ``run`` three ways in one call (``CONTINUOUS``; keys run, run
    "+", run "+c"): sync, overlapped + graphs, and overlapped + graphs
    with continuous batching.  The three streams must be equal, the
    continuous run must install inside its windows (``slot_swaps`` > 0;
    on the ring through the install's row copy) and no run may capture
    after construction (``phase_engine`` checks)."""
    t0 = time.perf_counter()
    keys = (run, run + "+", run + "+c")
    for key, extra in zip(keys, (None, CONTINUOUS[run],
                                 dict(CONTINUOUS[run], continuous=True))):
        label = {run: run, run + "+": f"{run}, overlapped + graphs",
                 run + "+c": f"{run}, overlapped + graphs + continuous"}[key]
        by_run[key], streams[key], serving[key] = phase_engine(
            torch, cfg, params, run, overlapped=extra is not None, extra=extra,
            label=label)
    if not streams[keys[0]] == streams[keys[1]] == streams[keys[2]]:
        raise AssertionError(f"engine run {run}: sync, overlapped and continuous streams "
                             f"differ: {[streams[k] for k in keys]}")
    c = serving[keys[2]]
    if c["slot_swaps"] <= 0:
        raise AssertionError(f"engine run {run}: the continuous engine installed nothing")
    ring = "paged" not in ENGINE_RUNS[run]
    if ring and by_run[keys[2]]["stage_install_rows"] <= 0:
        raise AssertionError(f"engine run {run}: the install's row copy never launched")
    for k in keys:
        v = serving[k]
        log(f"engine run {k}: {v['tokens_per_s']:.2f} tok/s, ttft {v['ttft_s']:.3f} s, "
            f"occupancy_device_mean {v['occupancy_device_mean']:.3f}, windows "
            f"{v['windows']}, windows_idle {v['windows_idle']}, slot_swaps "
            f"{v['slot_swaps']}, peak memory {v['peak_gib']:.2f} GiB, stage cache "
            f"{v['stage_cache_bytes'] / 2 ** 30:.3f} GiB, launches per replay "
            + "; ".join(f"{g}: {d['launches']}" for g, d in v["graphs"].items()))
    log(f"engine run {run}: sync, overlapped and continuous streams equal; "
        f"{c['slot_swaps']} installs; took {time.perf_counter() - t0:.1f} s")


def phase_stage_install(torch, cfg, params, gen):
    """The install's predicated row copy (``csrc/stage_install.cu``) at run
    S's shapes: a float ring and a stage cache of 8 rows x 4,096 positions
    (36 layers of bf16 latents and positions), held against its plain
    version (``torch.where`` on the row) bit for bit installing (slot 3
    from stage row 5) and idle (slot 8, past the batch: nothing moves),
    each timed as graph replays (``graph_ms``); the bound is the
    installing call's row read once and written once.  Then the whole
    install as a window iteration runs it (``Engine._stage_install`` over
    run S's carry, ring and stage cache: the carry rows, the row copy,
    the key), timed the same way idle (nothing staged) and installing
    (one staged row, re-staged by one copy before each call): what a
    replayed iteration pays for it."""
    from repro_torch.kernels import stage_install as KS
    from repro_torch.models import transformer as T
    caches = [T.init_decode_cache(cfg, 8, 4096) for _ in range(2)]
    for c in caches:
        for layer in c:
            for name, leaf in layer["self"].items():
                if name == "pos":
                    leaf.copy_(torch.randint(-1, 4096, leaf.shape, generator=gen,
                                             device="cuda"))
                else:
                    leaf.copy_(torch.randn(leaf.shape, generator=gen, device="cuda"))
    dst, src = ([leaf for layer in c for leaf in layer["self"].values()] for c in caches)
    table = KS.InstallTable(dst, src)
    q = torch.tensor(5, device="cuda")
    worst = 0.0
    for slot in (3, 8):
        s_ = torch.tensor(slot, device="cuda")
        want = [d.clone() for d in dst]
        KS.stage_install_rows_plain(want, src, s_, q)
        KS.stage_install_rows(dst, src, s_, q, table)
        torch.cuda.synchronize()
        for d, w in zip(dst, want):
            if not torch.equal(d, w):
                raise AssertionError(f"stage_install_rows (slot {slot}) differs from its plain "
                                     f"version")
            worst = max(worst, (d.float() - w.float()).abs().max().item())
        del want
    install, idle = torch.tensor(3, device="cuda"), torch.tensor(8, device="cuda")
    ms = graph_ms(lambda: KS.stage_install_rows(dst, src, install, q, table), 20)
    idle_ms = graph_ms(lambda: KS.stage_install_rows(dst, src, idle, q, table), 50)
    plain_ms = graph_ms(lambda: KS.stage_install_rows_plain(dst, src, install, q), 5)
    plain_idle_ms = graph_ms(lambda: KS.stage_install_rows_plain(dst, src, idle, q), 5)
    row = sum(d[0].numel() * d.element_size() for d in dst)
    b_ms, by = bound(2 * row, 0.0)
    log(f"stage_install_rows: a slot row of {row / 2 ** 20:.1f} MiB over {len(dst)} leaves; "
        f"graph replays: installing {ms:.4f} ms (plain {plain_ms:.4f} ms), idle {idle_ms:.4f} ms (plain "
        f"{plain_idle_ms:.4f} ms), bound {b_ms:.4f} ms ({by}); equal to the plain version "
        f"bit for bit")
    del caches, dst, src, table
    torch.cuda.empty_cache()
    from repro_torch.serving.engine import STAGE_FREE, Engine
    eng = Engine(cfg, params, max_slots=8, max_len=4096, sync_every=16, overlap=True,
                 continuous=True)
    st, seq = eng._load_state(), eng._stage["seq"]
    staged = torch.full_like(seq, STAGE_FREE)
    staged[5] = 0
    iter_idle_ms = graph_ms(lambda: Engine._stage_install(st, eng.cache, eng._stage), 50)

    def install():
        seq.copy_(staged)
        return Engine._stage_install(st, eng.cache, eng._stage)

    _, sw = install()
    if int(sw["sw_slot"]) != 0 or int(sw["sw_seq"]) != 0:
        raise AssertionError(f"the install took {sw}, expected stage row 5 into slot 0")
    iter_ms = graph_ms(install, 20)
    eng.close()
    del eng, st, seq
    torch.cuda.empty_cache()
    log(f"Engine._stage_install at run S's carry and ring, graph replays: idle "
        f"{iter_idle_ms:.4f} ms, installing {iter_ms:.4f} ms (the key re-staged by one "
        f"copy each call)")
    return {"name": "stage_install_rows", "route": "cuda",
            "source": "src/repro_torch/csrc/stage_install.cu",
            "replaces": "src/repro/models/transformer.py:720",
            "tpu_kernel": ("src/repro/models/transformer.py::swap_cache_slot (an XLA "
                           "scatter, mode=\"drop\"; no pallas_call)"),
            "shape": (f"ring and stage cache 8 x 4096, 36 layers of bf16 latents "
                      f"(G=2, r=256) + pos; a row {row} B"),
            "max_abs_err": worst, "max_err_f32": None, "ms": ms, "idle_ms": idle_ms,
            "plain_ms": plain_ms, "plain_idle_ms": plain_idle_ms, "bound_ms": b_ms,
            "bound_by": by, "library_ms": None, "install_iteration_ms": iter_ms,
            "install_iteration_idle_ms": iter_idle_ms}


def phase_cli(torch) -> dict:
    """The serving CLI at full width: ``repro_torch.launch.serve.main`` with
    qwen3-4b at ``--recalkv 0.5`` on the kernel backend (named "pallas"),
    ``--continuous --aot``, 8 slots, 16 requests; every request must
    finish with its budget."""
    from repro_torch.launch import serve as cli
    t0 = time.perf_counter()
    new = 32
    done = cli.main(["--arch", "qwen3-4b", "--recalkv", "0.5", "--backend", "pallas",
                     "--continuous", "--aot", "--requests", "16", "--slots", "8",
                     "--max-len", "512", "--new-tokens", str(new)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if sorted(r.uid for r in done) != list(range(16)) or any(
            len(r.out_tokens) != new for r in done):
        raise AssertionError("the serving CLI did not finish every request")
    log(f"serving CLI: 16 requests x {new} tokens, continuous + aot, {wall:.1f} s with "
        f"the model's init")
    torch.cuda.empty_cache()
    return {"requests": len(done), "new_tokens": new, "wall_s": wall}


ARTIFACT = ROOT / "build" / "chip_smoke_artifact"   # gitignored
ALS_RISE = 1e-3     # a value group's error may rise under ALS by rounding only


def phase_compress(torch, cfg, params, groups=2, rank=256, save=True, source=None):
    """Run J's first half on the dense model: ``calibrate`` on 8 synthetic
    "calib" sequences of 512 tokens (vocab 4096: valid ids of the full
    vocabulary, and a 134 MB transition table instead of 185 GB),
    ``compress`` with "recalkv" at keep ratio 0.5 on the kernel backend
    (named "pallas", JAX's alias; it must give ``groups`` latent groups at
    rank ``rank``), and, with ``save``, ``save_artifact``.  Returns the
    record and the artifact.  Prints the
    seconds of each, each layer's value error before and after ALS (a
    rise past ALS_RISE relative fails: each ALS step is an exact
    minimiser), the HSR groups and their within-group CKA against the
    identity grouping's (printed only: random heads leave near-ties).  A
    cross model's batch carries ``source`` (its 8 rows, one a sequence):
    its cross layers compress on identity statistics, their reports after
    the self layers'."""
    from repro_torch import api
    from repro_torch.data import DataConfig, batch
    t0 = time.perf_counter()
    batches = [batch(DataConfig(vocab_size=4096, seq_len=512), "calib", 0, 8)]
    if source is not None:
        batches[0]["source"] = source
    data_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    calib = api.calibrate(cfg, params, batches)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = api.compress(cfg, params, api.CompressionSpec(
        "recalkv", rank_policy=api.RankPolicy(keep_ratio=0.5), backend="pallas"), calib)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    rt = art.cfg.recalkv
    if (rt.num_groups(cfg.num_kv_heads), rt.rank_k, rt.rank_v) != (groups, rank, rank) \
            or art.cfg.attn_backend != "kernel":
        raise AssertionError(f"compressed config {rt}, backend {art.cfg.attn_backend}")
    worst, rows = 0.0, []
    for i, rep in enumerate(art.provenance["layers"]):
        for g, (e0, e1) in enumerate(rep["value_errors"]):
            worst = max(worst, (e1 - e0) / e0)
        rows.append(rep)
        cka = (f"within-group CKA {rep['cka_hsr']:.4f} (identity grouping "
               f"{rep['cka_identity']:.4f})" if "cka_hsr" in rep
               else "one kv head a group: no HSR")
        log(f"layer {i}: HSR groups {rep['groups']}, {cka}, value error before / after "
            f"ALS " + ", ".join(f"{e0:.5e} / {e1:.5e}" for e0, e1 in rep["value_errors"]))
    if worst > ALS_RISE:
        raise AssertionError(f"a value group's error rose by {worst:.3e} relative under "
                             f"ALS (limit {ALS_RISE})")
    save_s = None
    if save:
        t0 = time.perf_counter()
        api.save_artifact(art, str(ARTIFACT))
        save_s = time.perf_counter() - t0
    n_params = count_params(art.params)
    gain = [r["cka_hsr"] - r["cka_identity"] for r in rows if "cka_hsr" in r] or [0.0]
    log(f"compression of {cfg.name}: data {data_s:.2f} s, calibrate {calib_s:.2f} s "
        f"({calib.token_count} tokens), compress {compress_s:.2f} s, save "
        f"{'%.2f s' % save_s if save else 'skipped'}; {n_params / 1e9:.3f} B "
        f"params; peak memory {peak:.2f} GiB; worst relative value-error change under ALS "
        f"{worst:.3e}; HSR within-group CKA minus identity's: mean {np.mean(gain):.4f}, "
        f"min {min(gain):.4f}")
    return {"model": cfg.name, "data_s": data_s, "calibrate_s": calib_s,
            "compress_s": compress_s,
            "save_s": save_s, "peak_gib": peak, "params_b": n_params / 1e9,
            "calib_tokens": calib.token_count, "worst_als_rise": worst,
            "cka_hsr_minus_identity_mean": float(np.mean(gain)),
            "layers": [{"groups": r["groups"], "cka_hsr": r.get("cka_hsr"),
                        "cka_identity": r.get("cka_identity"),
                        "value_errors": r["value_errors"]} for r in rows]}, art


def family_model(torch, arch, ratio=None, layers=None, dtype=None):
    """``arch`` at full width and depth (or ``layers`` of its layers), bf16
    (or ``dtype``), on the kernel backend, with random weights from seed 0
    (a ReCalKV latent cache at ``ratio``)."""
    from repro_torch.configs import get_config
    from repro_torch.models.weights import init_params
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config(arch, recalkv_ratio=ratio), attn_backend="kernel",
                              dtype=dtype or torch.bfloat16)
    full = cfg.num_layers
    if layers is not None:   # a leading prefix (deepseek's attn_dense layers) is cut too
        cfg = dataclasses.replace(cfg, num_layers=layers,
                                  prefix_pattern=cfg.prefix_pattern[:layers])
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"model {cfg.name}{'' if ratio is None else f' recalkv ratio {ratio}'}"
        f"{'' if layers is None else f', {layers} of its {full} layers'}, {cfg.dtype}: "
        f"{count_params(params) / 1e9:.3f} B params initialised in "
        f"{time.perf_counter() - t0:.2f} s, {torch.cuda.memory_allocated() / 2 ** 30:.2f} "
        f"GiB allocated")
    return cfg, params


def phase_families(torch, by_run, streams, serving, backends) -> dict:
    """gemma3-12b and minicpm-2b at full width and depth through ``Engine``
    (``ENGINE_RUNS``).  gemma3 dense: both backends' logits on prompts of
    1,536 and 700 tokens in 2,048-token rings (the 1,024-token local rings
    wrap), then V, V+ (overlapped + graphs, V's streams), V3; then
    ``calibrate`` + ``compress`` of that model (G 2, r 512; not saved), the
    dense weights freed, the compressed model's logits through both
    backends on the float and int8 rings, then U, U+ (overlapped + graphs +
    continuous, U's streams), U3, UB.  minicpm-2b at ratio 0.5: M (D's pool
    and traffic); dense: M3 (the dense pool, n-gram depth 3).  K1, K4, K5
    and K7 may not launch on the dense runs.  Returns the compression
    record."""
    from repro_torch import kernels
    t0 = time.perf_counter()
    cfg, params = family_model(torch, "gemma3-12b")
    kernels.reset_launch_counts()
    backends["gemma3-12b dense"] = phase_backends(torch, cfg, params, (None,), (1536, 700),
                                                  2048)
    by_run["gemma3 steps"] = launch_counts(kernels)
    for run in ("V", "V3"):
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    phase_overlapped(torch, cfg, params, "V", by_run, streams, serving)
    _no_old_route(by_run, ("gemma3 steps", "V", "V+", "V3"), "gemma3-12b")
    t1 = time.perf_counter()
    compression, art = phase_compress(torch, cfg, params, groups=2, rank=512, save=False)
    del params   # the dense weights go; the compressed model serves
    torch.cuda.empty_cache()
    cfg, params = art.cfg, art.params
    del art
    kernels.reset_launch_counts()
    backends["gemma3-12b latent"] = phase_backends(torch, cfg, params, (None, 8), (1536, 700),
                                                   2048)
    by_run["gemma3 latent steps"] = launch_counts(kernels)
    for run in ("U", "U3", "UB"):
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    by_run["U+"], streams["U+"], serving["U+"] = phase_engine(
        torch, cfg, params, "U", overlapped=True, extra=dict(continuous=True),
        label="U, overlapped + graphs + continuous")
    if streams["U+"] != streams["U"]:
        raise AssertionError(f"engine run U+ streams differ from run U's: {streams['U+']} vs "
                             f"{streams['U']}")
    log(f"engine run U+ streams equal run U's; tok/s {serving['U+']['tokens_per_s']:.2f} "
        f"(sync {serving['U']['tokens_per_s']:.2f}), {serving['U+']['slot_swaps']} installs")
    del params
    torch.cuda.empty_cache()
    log(f"gemma3-12b: dense runs {t1 - t0:.1f} s, compression and latent runs "
        f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    for run, ratio in (("M", 0.5), ("M3", None)):
        cfg, params = family_model(torch, "minicpm-2b", ratio, layers=MINICPM_LAYERS)
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
        del params
        torch.cuda.empty_cache()
    log(f"minicpm-2b runs took {time.perf_counter() - t1:.1f} s")
    return compression


OLD_DENSE_ROUTE = ("latent_decode_attention", "latent_decode_attention_paged",
                   "latent_decode_attention_mq", "latent_decode_attention_mq_paged")


def _no_old_route(by_run, runs, what):
    old = {run: {k: by_run[run][k] for k in OLD_DENSE_ROUTE} for run in runs}
    if any(n for counts in old.values() for n in counts.values()):
        raise AssertionError(f"the dense {what} launched K1, K4, K5 or K7: {old}")


def phase_danube(torch, by_run, streams, serving, backends) -> dict:
    """h2o-danube-1.8b at full width and depth (24 ``local`` layers of
    window 4,096, 32 q over 8 kv heads, d_head 80) on the kernel backend:
    the dense model's logits through both backends, N (A's prompts) and N3
    (C's, depth-3 "ngram"); ``calibrate`` + ``compress`` (G 2, r 160; not
    saved), the compressed model's logits through both backends on the
    float and int8 rings, then NU (A's), NU3 (C's, "ngram") and NUB (B's,
    int8 ring, "layers:4").  Returns the compression record."""
    from repro_torch import kernels
    t0 = time.perf_counter()
    cfg, params = family_model(torch, "h2o-danube-1.8b", layers=DANUBE_LAYERS)
    kernels.reset_launch_counts()
    backends["h2o-danube-1.8b dense"] = phase_backends(torch, cfg, params, (None,))
    by_run["danube steps"] = launch_counts(kernels)
    for run in ("N", "N3"):
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    _no_old_route(by_run, ("danube steps", "N", "N3"), "h2o-danube-1.8b")
    compression, art = phase_compress(torch, cfg, params, groups=2, rank=160, save=False)
    del params
    torch.cuda.empty_cache()
    cfg, params = art.cfg, art.params
    del art
    kernels.reset_launch_counts()
    backends["h2o-danube-1.8b latent"] = phase_backends(torch, cfg, params, (None, 8))
    by_run["danube latent steps"] = launch_counts(kernels)
    for run in ("NU", "NU3", "NUB"):
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    del params
    torch.cuda.empty_cache()
    log(f"h2o-danube-1.8b runs and compression took {time.perf_counter() - t0:.1f} s")
    return compression


def phase_qwen3_moe(torch, by_run, streams, serving, backends) -> dict:
    """qwen3-moe-235b-a22b at full width (d 4,096, 64 q over 4 kv heads,
    128 experts top-8 of d_expert 1,536, vocab 151,936) and MOE_LAYERS of
    its 94 layers, on the kernel backend: the dense model's logits through
    both backends, decode and verify on a dense pool equal to the ring's,
    then Q (A's prompts), Q+ (Q overlapped with the window as CUDA graphs,
    the MoE dispatch inside them, admission inline so that its prefill
    wave is Q's: Q's streams) and Q3 (C's, depth-3
    "ngram": the verify MoE at N 32 and the 64-row dense verify);
    ``calibrate`` + ``compress`` (G 1, r 256, the expert tensors shared
    with the dense model; not saved: its 42 GB would not fit the run's
    time), the compressed model's paged steps against its ring (K1 / K4,
    K5 / K7; K3 / K6 on the int8 ring and the int8 pool's view), then QU
    (D's pool and traffic: K4 at q_per_kv 16, sharing and preemption) and
    QU3 (C's prompts on the ring: K5).  First, both backends' logits in
    float32 on 2 of its layers, dense and compressed: in bf16 the two
    backends round attention differently, and a top-8 choice that flips
    changes a token's whole FFN output (on an H100, 7.6e-2 relative and
    greedy agreement 0.8 over 10 rows at 8 layers), so the glue is held
    where routing is stable.  Prints the peak memory of every step.
    Returns the compression record."""
    from repro_torch import kernels
    arch = "qwen3-moe-235b-a22b"
    t0 = time.perf_counter()
    cfg, params = family_model(torch, arch, layers=2, dtype=torch.float32)
    backends[f"{arch} f32 dense"] = phase_backends(torch, cfg, params, (None,))
    art = phase_compress(torch, cfg, params, groups=1, rank=256, save=False)[1]
    del params
    backends[f"{arch} f32 latent"] = phase_backends(torch, art.cfg, art.params, (None, 8))
    del art
    cfg, params = family_model(torch, arch, layers=MOE_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    backends[f"{arch} dense paged"] = phase_paged_steps(torch, cfg, params, (None,))
    by_run["qwen3-moe steps"] = launch_counts(kernels)
    peaks = {"steps": torch.cuda.max_memory_allocated() / 2 ** 30}
    for run in ("Q", "Q3"):
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    phase_overlapped(torch, cfg, params, "Q", by_run, streams, serving)
    _no_old_route(by_run, ("qwen3-moe steps", "Q", "Q+", "Q3"), arch)
    expert = params["layers"][0]["mlp"]["wi"]
    compression, art = phase_compress(torch, cfg, params, groups=1, rank=256, save=False)
    if art.params["layers"][0]["mlp"]["wi"] is not expert:
        raise AssertionError("the compressed qwen3-moe copied the expert tensors")
    peaks["compress"] = compression["peak_gib"]
    del params, expert
    torch.cuda.empty_cache()
    cfg, params = art.cfg, art.params
    del art
    torch.cuda.reset_peak_memory_stats()
    kernels.reset_launch_counts()
    backends[f"{arch} latent paged"] = phase_paged_steps(torch, cfg, params, (None, 8))
    by_run["qwen3-moe latent steps"] = launch_counts(kernels)
    peaks["latent steps"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for run in ("QU", "QU3"):
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    del params
    torch.cuda.empty_cache()
    peaks.update({run: serving[run]["peak_gib"] for run in ("Q", "Q+", "Q3", "QU", "QU3")})
    log(f"qwen3-moe-235b-a22b ({MOE_LAYERS} layers) peak memory GiB by step: "
        + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
        + f"; highest {max(peaks.values()):.2f}; runs and compression took "
        f"{time.perf_counter() - t0:.1f} s")
    compression["peaks_gib"] = peaks
    return compression


def phase_mla_identities(torch, cfg, params) -> dict:
    """deepseek's float32 identities on the card (B 2, prompts of 512 and
    300 tokens in 1,024-token rings, TF32 off): the prefill of one more
    token against the prefill followed by one absorbed ``decode_step`` (the
    non-absorbed attention of ``mla_attention`` against scores in c_kv
    space), and a 4-token ``verify_step`` against 4 sequential decode
    steps, each within MLA_REL of the larger's max |logit|."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    L_ring, B = 1024, 2
    toks = torch.randint(0, cfg.vocab_size, (B, 513), generator=gen, device="cuda")
    lens = torch.tensor([512, 300], device="cuda")
    fed = torch.randint(0, cfg.vocab_size, (B, 4), generator=gen, device="cuda")
    rows = torch.arange(B, device="cuda")
    out = {}

    def check(name, got, want):
        if not torch.isfinite(got).all():
            raise AssertionError(f"{name}: logits are not finite")
        err = (got - want).abs().max().item()
        rel = err / want.abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        log(f"{cfg.name} float32, {name}: logits max abs err {err:.4e} (relative "
            f"{rel:.3e}, limit {MLA_REL:.0e}), greedy agreement {agree:.3f}")
        if rel > MLA_REL:
            raise AssertionError(f"{cfg.name} {name}: logits differ by {rel:.3e} relative")
        out[name] = {"logits_max_abs_err": err, "logits_rel_err": rel,
                     "greedy_agreement": agree}

    full, _ = T.prefill(cfg, params, toks, lens + 1, L_ring)
    _, caches = T.prefill(cfg, params, toks[:, :512], lens, L_ring)
    step, _ = T.decode_step(cfg, params, caches, toks[rows, lens], lens)
    check("prefill T + 1 vs prefill T + decode", step, full)
    _, caches = T.prefill(cfg, params, toks[:, :512], lens, L_ring)
    mask = torch.ones((B, 4), dtype=torch.bool, device="cuda")
    verify, _ = T.verify_step(cfg, params, caches, fed, lens, mask)
    seq = [T.decode_step(cfg, params, caches, fed[:, j], lens + j)[0] for j in range(4)]
    check("verify 4 vs 4 decode steps", verify, torch.stack(seq, dim=1))
    return out


def phase_deepseek(torch, by_run, streams, serving, backends) -> dict:
    """deepseek-v3-671b at full width (d 7,168, 128 heads, MLA r_kv 512 and
    dr 64, 256 experts top-8 of d_expert 2,048 + 1 shared, vocab 129,280)
    on the kernel backend, whose MLA readers fall back to einsum (the
    engine warns, as JAX's does).  First in float32 on 2 of its layers
    (both ``attn_dense``: no routing to flip): the MLA identities
    (``phase_mla_identities``) and decode and verify on a page-16 pool
    equal to the ring bit for bit; then the bf16 model at DS_LAYERS layers
    (the 3 ``attn_dense`` and 1 MoE layer): paged steps equal to the
    ring's, DS (A's prompts), DS+ (DS overlapped with the window as CUDA
    graphs and inline admission: DS's streams), DS3 (C's, depth-3
    "ngram") and DSP (D's pool and traffic: sharing and preemption).  No
    kernel may launch on its path.  Prints the peak memory of every step,
    the init's included.  Returns the phase's record."""
    from repro_torch import kernels
    arch = "deepseek-v3-671b"
    t0 = time.perf_counter()
    cfg, params = family_model(torch, arch, layers=2, dtype=torch.float32)
    kernels.reset_launch_counts()
    backends[f"{arch} f32"] = phase_mla_identities(torch, cfg, params)
    backends[f"{arch} f32 paged"] = phase_paged_steps(torch, cfg, params, (None,))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    cfg, params = family_model(torch, arch, layers=DS_LAYERS)
    peaks = {"init": torch.cuda.max_memory_allocated() / 2 ** 30,
             "weights": torch.cuda.memory_allocated() / 2 ** 30}
    torch.cuda.reset_peak_memory_stats()
    backends[f"{arch} paged"] = phase_paged_steps(torch, cfg, params, (None,))
    by_run["deepseek steps"] = launch_counts(kernels)
    peaks["steps"] = torch.cuda.max_memory_allocated() / 2 ** 30
    for run in ("DS", "DS3", "DSP"):
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    phase_overlapped(torch, cfg, params, ["DS"], by_run, streams, serving)
    launched = {run: {k: n for k, n in by_run[run].items() if n}
                for run in FAMILY_RUNS[arch]}
    if any(launched.values()):
        raise AssertionError(f"{arch}: kernels launched on the MLA path: {launched}")
    log(f"{arch}: no kernel launched over its steps and runs (MLA's readers and "
        f"prefill are einsum, as in the JAX package)")
    del params
    torch.cuda.empty_cache()
    peaks.update({run: serving[run]["peak_gib"] for run in ("DS", "DS+", "DS3", "DSP")})
    seconds = time.perf_counter() - t0
    log(f"{arch} ({DS_LAYERS} layers) peak memory GiB by step: "
        + ", ".join(f"{k} {v:.2f}" for k, v in peaks.items())
        + f"; highest {max(peaks.values()):.2f}; the phase took {seconds:.1f} s")
    return {"peaks_gib": peaks, "seconds": seconds}


def make_source(torch, cfg, seed, rows=8, repeat=False):
    """A seeded stub-frontend source (rows, cross_source_len, d_model) in the
    model dtype on the card; with ``repeat`` one seeded row repeated
    ``rows`` times (a row-independent source)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    n = 1 if repeat else rows
    src = torch.randn((n, cfg.cross_source_len, cfg.d_model), generator=gen,
                      device="cuda").to(cfg.dtype)
    return src.expand(rows, -1, -1) if repeat else src


def count_decode_steps(fn):
    """(fn(), the ``transformer.decode_step`` calls it made): the engine
    calls the module's function, so a wrapper there sees every step."""
    from repro_torch.models import transformer as T
    orig, n = T.decode_step, [0]

    def counted(*a, **k):
        n[0] += 1
        return orig(*a, **k)

    T.decode_step = counted
    try:
        return fn(), n[0]
    finally:
        T.decode_step = orig


def phase_cross(torch, by_run, streams, serving, backends) -> dict:
    """The cross-attention models at full width and depth on the kernel
    backend, bf16, random weights from seed 0, a seeded source (8 rows;
    cross-attention is einsum, as in the JAX package, so under the kernel
    backend the engine warns once).  llama-3.2-vision-11b (40 layers: 32
    ``attn`` with qwen3-4b's heads, 8 ``cross`` over a 1,600-patch
    source): X (dense, A's prompts); ``calibrate`` with the source and
    ``compress`` (G 2, r 256; the cross layers on identity statistics; not
    saved), the dense weights freed, both backends' logits; XU (A's), its
    decode steps counted: each must launch 32 K1 (the self layers) and
    none for the cross layers; XU+ (overlapped + graphs, inline admission:
    XU's streams, 32 K1 a replay); XU3 (C's, "ngram"); then S's traffic
    with one source row repeated (a wave's row i reads source row i, and
    the continuous engine forms other waves than the sync one): XUs
    (sync) and XU+c (overlapped + graphs + continuous at pipeline depth 3
    and staging depth 8, the source's rows: XUs's streams, installs).
    whisper-small (12 encoder + 12 ``attn_cross`` decoder layers over a
    1,500-frame source): W (dense, A's prompts); compressed in the run (G
    3, r 128), both backends' logits, WU (A's) and WU+ (overlapped +
    graphs: WU's streams, 12 K1 a replay).  Each run prints its source
    and its self and cross bytes per slot.  Returns the phase's record."""
    from repro_torch import kernels
    rec, t0 = {}, time.perf_counter()
    arch = "llama-3.2-vision-11b"
    cfg, params = family_model(torch, arch)
    src = make_source(torch, cfg, SEED + 6)
    kw = dict(source=src)
    by_run["X"], streams["X"], serving["X"] = phase_engine(torch, cfg, params, "X", extra=kw)
    _no_old_route(by_run, ("X",), arch)
    t1 = time.perf_counter()
    rec[arch], art = phase_compress(torch, cfg, params, groups=2, rank=256, save=False,
                                    source=src)
    del params
    torch.cuda.empty_cache()
    cfg, params = art.cfg, art.params
    del art
    kernels.reset_launch_counts()
    backends[f"{arch} latent"] = phase_backends(torch, cfg, params, (None, 8), source=src)
    by_run["vision latent steps"] = launch_counts(kernels)
    (by_run["XU"], streams["XU"], serving["XU"]), steps = count_decode_steps(
        lambda: phase_engine(torch, cfg, params, "XU", extra=kw))
    k1 = by_run["XU"]["latent_decode_attention"]
    if k1 != 32 * steps:
        raise AssertionError(f"engine run XU: {k1} K1 launches over {steps} decode steps, "
                             f"expected 32 a step (the self layers; none for the cross)")
    log(f"engine run XU: {steps} decode steps, {k1} K1 launches: 32 a step, none from the "
        f"8 cross layers")
    phase_overlapped(torch, cfg, params, ["XU"], by_run, streams, serving, extra=kw)
    per_replay = serving["XU+"]["graphs"]["greedy"]["launches"]
    if per_replay != {"latent_decode_attention": 32}:
        raise AssertionError(f"engine run XU+: launches per replay {per_replay}, expected "
                             f"32 K1 (the self layers) and nothing else")
    by_run["XU3"], streams["XU3"], serving["XU3"] = phase_engine(torch, cfg, params, "XU3",
                                                                 extra=kw)
    rep = make_source(torch, cfg, SEED + 7, repeat=True)
    by_run["XUs"], streams["XUs"], serving["XUs"] = phase_engine(
        torch, cfg, params, "XUs", extra=dict(source=rep))
    by_run["XU+c"], streams["XU+c"], serving["XU+c"] = phase_engine(
        torch, cfg, params, "XUs", overlapped=True, label="XU+c",
        extra=dict(source=rep, continuous=True, pipeline_depth=3, staging_depth=8))
    if streams["XU+c"] != streams["XUs"]:
        raise AssertionError(f"engine run XU+c: streams differ from XUs's: "
                             f"{streams['XU+c']} vs {streams['XUs']}")
    if serving["XU+c"]["slot_swaps"] <= 0 or by_run["XU+c"]["stage_install_rows"] <= 0:
        raise AssertionError("engine run XU+c: the continuous engine installed nothing")
    log(f"engine run XU+c: streams equal XUs's; {serving['XU+c']['slot_swaps']} installs; "
        f"tok/s {serving['XU+c']['tokens_per_s']:.2f} (sync "
        f"{serving['XUs']['tokens_per_s']:.2f})")
    del params, src, rep
    torch.cuda.empty_cache()
    log(f"{arch}: dense run {t1 - t0:.1f} s, compression and latent runs "
        f"{time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    arch = "whisper-small"
    cfg, params = family_model(torch, arch)
    src = make_source(torch, cfg, SEED + 8)
    kw = dict(source=src)
    by_run["W"], streams["W"], serving["W"] = phase_engine(torch, cfg, params, "W", extra=kw)
    rec[arch], art = phase_compress(torch, cfg, params, groups=3, rank=128, save=False,
                                    source=src)
    del params
    torch.cuda.empty_cache()
    cfg, params = art.cfg, art.params
    del art
    kernels.reset_launch_counts()
    backends[f"{arch} latent"] = phase_backends(torch, cfg, params, (None, 8), source=src)
    by_run["whisper latent steps"] = launch_counts(kernels)
    by_run["WU"], streams["WU"], serving["WU"] = phase_engine(torch, cfg, params, "WU",
                                                              extra=kw)
    phase_overlapped(torch, cfg, params, ["WU"], by_run, streams, serving, extra=kw)
    per_replay = serving["WU+"]["graphs"]["greedy"]["launches"]
    if per_replay != {"latent_decode_attention": 12}:
        raise AssertionError(f"engine run WU+: launches per replay {per_replay}, expected "
                             f"12 K1 (the decoder's self halves) and nothing else")
    del params, src
    torch.cuda.empty_cache()
    rec["seconds"] = time.perf_counter() - t0
    log(f"{arch}: runs and compression {time.perf_counter() - t1:.1f} s; the cross phase "
        f"took {rec['seconds']:.1f} s")
    return rec


def phase_twins(torch, cfg, params, run, key, by_run, streams, serving):
    """``run`` (sync) and ``key`` (its overlapped + graphs + continuous
    twin at pipeline depth 3, inline admission, staging depth 8): equal
    streams, and the continuous engine must install."""
    by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    by_run[key], streams[key], serving[key] = phase_engine(
        torch, cfg, params, run, overlapped=True, label=key,
        extra=dict(continuous=True, pipeline_depth=3, staging_depth=8,
                   admission_thread=False))
    if streams[key] != streams[run]:
        raise AssertionError(f"engine run {key}: streams differ from {run}'s: "
                             f"{streams[key]} vs {streams[run]}")
    if serving[key]["slot_swaps"] <= 0 or by_run[key]["stage_install_rows"] <= 0:
        raise AssertionError(f"engine run {key}: the continuous engine installed nothing")
    log(f"engine run {key}: streams equal {run}'s; {serving[key]['slot_swaps']} installs; "
        f"tok/s {serving[key]['tokens_per_s']:.2f} (sync {serving[run]['tokens_per_s']:.2f})")


def phase_recurrent(torch, by_run, streams, serving, backends) -> dict:
    """The recurrent models at full width and depth, bf16, random weights
    from seed 0, on the kernel backend; their mixers are plain PyTorch, as
    in the JAX package.  falcon-mamba-7b (FM_LAYERS of its 64 Mamba layers,
    d_inner 8,192,
    d_state 16): FM (A's prompts), its decode steps counted: no kernel may
    launch; FM+ (overlapped + graphs, inline admission: FM's streams, no
    launch a replay); FMs and FM+c (R's traffic, sync and continuous: equal
    streams, installs).  recurrentgemma-9b (12 periods of (rglru, rglru,
    local) + 2 rglru; local: MQA, q_per_kv 16, dh 256, window 2,048): both
    backends' logits on prompts of 2,560 and 700 tokens in 4,096-token
    rings (the window rings wrap), RG (A's): 12 dense decodes a step;
    ``calibrate`` + ``compress`` (G 1, s 1, r 128; not saved), the dense
    weights freed, both backends' logits; RGU
    (A's): 12 K1 a step, none from the 26 rglru layers; RGU+ (overlapped +
    graphs, inline admission: RGU's streams, 12 K1 a replay); RGU8 (the
    int8 ring: K3); RGUs and RGU+c (R's traffic).  Each run prints its
    state and self bytes per slot.  Returns the phase's record."""
    from repro_torch import kernels
    rec, t0 = {}, time.perf_counter()
    arch = "falcon-mamba-7b"
    cfg, params = family_model(torch, arch, layers=FM_LAYERS)
    rec[arch] = {"params_b": count_params(params) / 1e9}
    (by_run["FM"], streams["FM"], serving["FM"]), steps = count_decode_steps(
        lambda: phase_engine(torch, cfg, params, "FM"))
    phase_overlapped(torch, cfg, params, ["FM"], by_run, streams, serving)
    phase_twins(torch, cfg, params, "FMs", "FM+c", by_run, streams, serving)
    # no kernel but the continuous install's row copy, eager or per replay
    per_replay = {k: g["launches"] for k, g in serving["FM+"]["graphs"].items()}
    launched = {run: {k: n for k, n in by_run[run].items()
                      if n and (run, k) != ("FM+c", "stage_install_rows")}
                for run in FAMILY_RUNS[arch]}
    if any(launched.values()) or any(per_replay.values()):
        raise AssertionError(f"{arch}: kernels launched on the Mamba path: {launched}, "
                             f"FM+ per replay {per_replay}")
    log(f"engine run FM: {steps} decode steps; no kernel launched over FM, FM+ (none a "
        f"replay), FMs and FM+c (its install's row copy only): the Mamba mixers are plain "
        f"PyTorch, as in the JAX package")
    del params
    torch.cuda.empty_cache()
    rec[arch]["seconds"] = time.perf_counter() - t0
    log(f"{arch}: runs took {rec[arch]['seconds']:.1f} s")
    t1 = time.perf_counter()
    arch = "recurrentgemma-9b"
    cfg, params = family_model(torch, arch)
    rec[arch] = {"params_b": count_params(params) / 1e9}
    kernels.reset_launch_counts()
    lens = dict(lens=(2560, 700), max_len=4096)
    # no verify: a recurrent state cannot roll back a rejected token, so
    # speculation is refused, as in the JAX package
    backends[f"{arch} dense"] = phase_backends(torch, cfg, params, (), **lens)
    by_run["recurrentgemma steps"] = launch_counts(kernels)
    (by_run["RG"], streams["RG"], serving["RG"]), steps = count_decode_steps(
        lambda: phase_engine(torch, cfg, params, "RG"))
    n = by_run["RG"]["dense_decode_attention"]
    if n != 12 * steps:
        raise AssertionError(f"engine run RG: {n} dense decodes over {steps} decode steps, "
                             f"expected 12 a step (the local layers)")
    _no_old_route(by_run, ("recurrentgemma steps", "RG"), arch)
    rec["compression"], art = phase_compress(torch, cfg, params, groups=1, rank=128,
                                             save=False)
    del params
    torch.cuda.empty_cache()
    cfg, params = art.cfg, art.params
    del art
    kernels.reset_launch_counts()
    backends[f"{arch} latent"] = phase_backends(torch, cfg, params, (), **lens)
    by_run["recurrentgemma latent steps"] = launch_counts(kernels)
    (by_run["RGU"], streams["RGU"], serving["RGU"]), steps = count_decode_steps(
        lambda: phase_engine(torch, cfg, params, "RGU"))
    k1 = by_run["RGU"]["latent_decode_attention"]
    if k1 != 12 * steps:
        raise AssertionError(f"engine run RGU: {k1} K1 launches over {steps} decode steps, "
                             f"expected 12 a step (the local layers; none for the rglru)")
    log(f"engine run RGU: {steps} decode steps, {k1} K1 launches: 12 a step, none from the "
        f"26 rglru layers")
    phase_overlapped(torch, cfg, params, ["RGU"], by_run, streams, serving)
    per_replay = serving["RGU+"]["graphs"]["greedy"]["launches"]
    if per_replay != {"latent_decode_attention": 12}:
        raise AssertionError(f"engine run RGU+: launches per replay {per_replay}, expected "
                             f"12 K1 (the local layers) and nothing else")
    by_run["RGU8"], streams["RGU8"], serving["RGU8"] = phase_engine(torch, cfg, params,
                                                                    "RGU8")
    phase_twins(torch, cfg, params, "RGUs", "RGU+c", by_run, streams, serving)
    del params
    torch.cuda.empty_cache()
    rec[arch]["seconds"] = time.perf_counter() - t1
    rec["seconds"] = time.perf_counter() - t0
    log(f"{arch}: runs and compression took {rec[arch]['seconds']:.1f} s; the recurrent "
        f"phase took {rec['seconds']:.1f} s")
    return rec


TRAIN_STEPS, TRAIN_B, TRAIN_T = 8, 8, 512
TRAIN_REL = 1e-4    # float32, TF32 off: one step on the card vs the CPU
TRAIN_G_FLOOR = 1e3  # updated elements compared where |clipped g| >= this many eps
FISHER_ARTIFACT = ROOT / "build" / "chip_smoke_fisher"   # gitignored


def compare_train_steps(ref, got, opt_cfg) -> dict:
    """Two runs of one first train step, each (params after, optimizer
    state after) in the port's layout: per leaf, the first moment (which
    after step 1 is (1 - b1) times the clipped gradient) relative to the
    reference's norm, and the updated params relative to the reference's
    norm over the elements whose clipped gradient is at least
    TRAIN_G_FLOOR eps.  AdamW's first step moves an element by lr * g /
    (|g| + eps): where |g| nears eps that ratio turns summation noise in g
    into a difference in the update as large as the update, so those
    elements are held through the gradient, not the param.  Also the
    whole-leaf param measure, for the log.  Returns the worst of each,
    with its leaf."""
    from repro_torch.models.weights import leaves_in_jax_order
    floor = TRAIN_G_FLOOR * opt_cfg.eps * (1 - opt_cfg.b1)
    out = {"grad": (0.0, None), "update": (0.0, None), "whole": (0.0, None)}
    n_in = n_all = 0

    def keep(name, rel, path):
        if rel > out[name][0]:
            out[name] = (rel, path)

    pairs = zip(leaves_in_jax_order(None, ref[0]), leaves_in_jax_order(None, got[0]),
                leaves_in_jax_order(None, ref[1]["mu"]),
                leaves_in_jax_order(None, got[1]["mu"]), strict=True)
    for (path, (a,), _), (_, (g,), _), (_, (ma,), _), (_, (mg,), _) in pairs:
        a, g, ma, mg = a.cpu(), g.cpu(), ma.cpu(), mg.cpu()
        keep("grad", float((mg - ma).norm() / ma.norm().clamp(min=1e-30)), path)
        keep("whole", float((g - a).norm() / a.norm().clamp(min=1e-30)), path)
        m = ma.abs() >= floor
        n_in, n_all = n_in + int(m.sum()), n_all + m.numel()
        if m.any():
            keep("update", float((g - a)[m].norm() / a[m].norm().clamp(min=1e-30)), path)
    return {**{f"{k}_rel": v[0] for k, v in out.items()},
            **{f"{k}_leaf": v[1] for k, v in out.items()},
            "update_share": n_in / n_all}


def _train_f32_step(torch) -> dict:
    """qwen3-4b's widths at 2 layers in float32: one train step on the card
    against the same step on the CPU plain path (same params from a CPU
    seed, same batch of 2 x 64): loss, grad_norm and, per leaf, the
    gradient and the updated params (``compare_train_steps``) within
    TRAIN_REL."""
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch
    from repro_torch.models.weights import init_params, map_tree
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime import TrainConfig, make_train_step
    t0 = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-4b"), num_layers=2, dtype=torch.float32)
    cpu = init_params(cfg, torch.Generator().manual_seed(SEED), device="cpu")
    gpu = map_tree(cpu, lambda t: t.to("cuda"))
    opt_cfg, tc = AdamWConfig(lr=1e-3), TrainConfig(warmup_steps=0, total_steps=8)
    b = batch(DataConfig(vocab_size=4096, seq_len=64), "train", 0, 2)
    step = make_train_step(cfg, opt_cfg, tc)
    out, after = {}, {}
    for dev, params in (("cpu", cpu), ("cuda", gpu)):
        t1 = time.perf_counter()
        after[dev] = step(params, init_state(params, opt_cfg), b)
        out[dev] = {k: float(v) for k, v in after[dev][2].items()}
        out[dev]["seconds"] = time.perf_counter() - t1
    cmp = compare_train_steps(after["cpu"], after["cuda"], opt_cfg)
    for k in ("loss", "grad_norm"):
        rel = abs(out["cuda"][k] - out["cpu"][k]) / abs(out["cpu"][k])
        if rel > TRAIN_REL:
            raise AssertionError(f"f32 train step: {k} on the card {out['cuda'][k]} vs "
                                 f"the CPU {out['cpu'][k]} ({rel:.3e} relative)")
    for k in ("grad", "update"):
        if cmp[f"{k}_rel"] > TRAIN_REL:
            raise AssertionError(f"f32 train step: the {k} of leaf {cmp[f'{k}_leaf']} is "
                                 f"{cmp[f'{k}_rel']:.3e} (relative norm) from the CPU's")
    log(f"train f32 (qwen3-4b widths, 2 layers, B 2 x T 64): loss card "
        f"{out['cuda']['loss']:.7f} / CPU {out['cpu']['loss']:.7f}, grad_norm "
        f"{out['cuda']['grad_norm']:.7f} / {out['cpu']['grad_norm']:.7f}; worst leaf "
        f"gradient {cmp['grad_rel']:.3e} relative ({cmp['grad_leaf']}), update "
        f"{cmp['update_rel']:.3e} ({cmp['update_leaf']}) over the "
        f"{100 * cmp['update_share']:.2f}% of elements with |g| >= {TRAIN_G_FLOOR:g} eps "
        f"(limit {TRAIN_REL:g} each); whole leaf {cmp['whole_rel']:.3e} "
        f"({cmp['whole_leaf']}); step {out['cuda']['seconds']:.2f} s card, "
        f"{out['cpu']['seconds']:.2f} s CPU; {time.perf_counter() - t0:.1f} s in all")
    return {**out, **cmp}


def phase_train(torch, by_run, streams, serving) -> tuple[dict, list]:
    """Train, compress with Fisher-allocated ranks, serve.  First the
    2-layer float32 step against the CPU (``_train_f32_step``); then
    qwen3-4b at full width and depth (36 layers, bf16, float32 moments,
    remat, one microbatch) takes TRAIN_STEPS steps of B 8 x T 512 from
    ``data.synthetic`` (ids below 4,096): each step's loss, grad_norm,
    lr, wall time and training tokens/s, the peak memory; every loss
    finite, the last below the first, no kernel of ``kernels.KERNELS``
    launched.  On the trained params: ``fisher_scores`` on 2 calibration
    batches of 4 x 512, ``calibrate(fisher=True)``, ``compress`` with
    ``RankPolicy(keep_ratio=0.5, use_fisher=True)`` (G 2, the kernel
    backend), ``save_artifact`` / ``load_artifact``; per-layer ranks not
    uniform; the loaded artifact serves runs FI (A's traffic, its decode
    steps counted: a K1 a layer a step) and FI+ (overlapped + graphs: FI's
    streams, a K1 a layer a replay).  Then K1 and K2 at the artifact's smallest and
    largest (rank_k, rank_v) against their plain versions (rows tagged
    "new shape").  Returns (the phase's record, kernel rows)."""
    from repro_torch import api, kernels
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, batch
    from repro_torch.models import compress as C
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import init_params
    from repro_torch.optim import AdamWConfig, init_state
    from repro_torch.runtime import TrainConfig, make_train_step
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    rec = {"f32_step": _train_f32_step(torch)}

    cfg = dataclasses.replace(get_config("qwen3-4b"), attn_backend="kernel",
                              dtype=torch.bfloat16)
    assert cfg.remat and cfg.scan_layers
    torch.cuda.reset_peak_memory_stats()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    opt_cfg = AdamWConfig(lr=1e-3)
    tc = TrainConfig(warmup_steps=2, total_steps=TRAIN_STEPS)
    opt_state = init_state(params, opt_cfg)
    step_fn = make_train_step(cfg, opt_cfg, tc)
    dc = DataConfig(vocab_size=4096, seq_len=TRAIN_T)
    batches = [{k: torch.as_tensor(v, device="cuda")
                for k, v in batch(dc, "train", i, TRAIN_B).items()}
               for i in range(TRAIN_STEPS)]
    kernels.reset_launch_counts()
    steps = []
    for i in range(TRAIN_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, m = step_fn(params, opt_state, batches[i])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row = {k: float(v) for k, v in m.items()}
        row.update(wall_s=wall, tokens_per_s=TRAIN_B * TRAIN_T / wall)
        steps.append(row)
        log(f"train qwen3-4b step {i}: loss {row['loss']:.4f}, grad_norm "
            f"{row['grad_norm']:.4f}, lr {row['lr']:.3e}, {wall:.3f} s, "
            f"{row['tokens_per_s']:.1f} training tokens/s")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    launched = {k: n for k, n in launch_counts(kernels).items() if n}
    losses = [r["loss"] for r in steps]
    if not all(np.isfinite(losses)) or not losses[-1] < losses[0]:
        raise AssertionError(f"training losses {losses}: not finite, or not falling")
    if launched:
        raise AssertionError(f"kernels launched while training: {launched}")
    warm = [r["wall_s"] for r in steps[1:]]
    rec["train"] = {"steps": steps, "peak_gib": peak, "layers": cfg.num_layers,
                    "tokens_per_s_warm": TRAIN_B * TRAIN_T * len(warm) / sum(warm)}
    log(f"train qwen3-4b ({cfg.num_layers} layers, bf16, f32 moments, remat, B {TRAIN_B} x "
        f"T {TRAIN_T}): "
        f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, warm steps "
        f"{', '.join(f'{w:.3f}' for w in warm)} s, "
        f"{rec['train']['tokens_per_s_warm']:.1f} tokens/s (their tokens over their "
        f"time), peak memory {peak:.2f} GiB, no kernel launched")
    del opt_state, batches, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    calib = [batch(dc, "calib", i, 4) for i in range(2)]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    fk, fv = C.fisher_scores(cfg, params, calib)
    torch.cuda.synchronize()
    fisher_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    cal = api.calibrate(cfg, params, calib, fisher=True)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    art = api.compress(cfg, params, api.CompressionSpec(
        "recalkv", rank_policy=api.RankPolicy(keep_ratio=0.5, use_fisher=True),
        backend="pallas"), cal)
    torch.cuda.synchronize()
    compress_s = time.perf_counter() - t0
    fisher_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    ranks = [tuple(r) for r in art.cfg.recalkv.ranks_by_layer]
    if len(set(ranks)) < 2 or art.cfg.recalkv.num_groups(cfg.num_kv_heads) != 2:
        raise AssertionError(f"Fisher ranks {ranks}: uniform, or not 2 groups")
    t0 = time.perf_counter()
    api.save_artifact(art, str(FISHER_ARTIFACT))
    save_s = time.perf_counter() - t0
    del params, art
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    loaded = api.load_artifact(str(FISHER_ARTIFACT))
    load_s = time.perf_counter() - t0
    if [tuple(r) for r in loaded.cfg.recalkv.ranks_by_layer] != ranks:
        raise AssertionError("the loaded artifact's ranks differ from the saved ones")
    caches = T.init_decode_cache(loaded.cfg, 1, 16)
    per_token = sum(v[0, 0].numel() * v.element_size() for c in caches
                    for k, v in c["self"].items() if k != "pos")
    uniform = cfg.num_layers * 2 * 2 * 256 * 2     # G 2 x (r_k + r_v) 256 bf16
    del caches
    rec["fisher"] = {"fisher_k": fk, "fisher_v": fv, "ranks_by_layer": ranks,
                     "fisher_s": fisher_s, "calibrate_s": calib_s,
                     "compress_s": compress_s, "save_s": save_s, "load_s": load_s,
                     "peak_gib": fisher_peak, "cache_bytes_per_token": per_token,
                     "uniform_cache_bytes_per_token": uniform}
    log(f"Fisher compression of the trained qwen3-4b: fisher_scores {fisher_s:.2f} s, "
        f"calibrate(fisher=True) {calib_s:.2f} s, compress {compress_s:.2f} s, save "
        f"{save_s:.2f} s, load {load_s:.2f} s, peak {fisher_peak:.2f} GiB; ranks "
        f"(r_k, r_v) by layer {ranks}; cache bytes per token over the {cfg.num_layers} layers "
        f"{per_token:,} (uniform r 256: {uniform:,})")

    (by_run["FI"], streams["FI"], serving["FI"]), n_steps = count_decode_steps(
        lambda: phase_engine(torch, loaded.cfg, loaded.params, "FI"))
    k1 = by_run["FI"]["latent_decode_attention"]
    if k1 != cfg.num_layers * n_steps:
        raise AssertionError(f"engine run FI: {k1} K1 launches over {n_steps} decode "
                             f"steps, expected {cfg.num_layers} a step")
    k2 = by_run["FI"]["flash_prefill_attention"]
    if k2 % cfg.num_layers:
        raise AssertionError(f"engine run FI: {k2} K2 launches, not {cfg.num_layers} a "
                             f"prefill call")
    by_run["FI+"], streams["FI+"], serving["FI+"] = phase_engine(
        torch, loaded.cfg, loaded.params, "FI", overlapped=True)
    del loaded
    if streams["FI+"] != streams["FI"]:
        raise AssertionError("engine run FI+: streams differ from run FI's")
    per_replay = serving["FI+"]["graphs"]["greedy"]["launches"]
    if per_replay != {"latent_decode_attention": cfg.num_layers}:
        raise AssertionError(f"engine run FI+: {per_replay} launches a replay, expected "
                             f"{cfg.num_layers} K1")
    log(f"engine runs FI / FI+: {n_steps} decode steps, {k1} K1 ({cfg.num_layers} a step), "
        f"{k2} K2 ({k2 // cfg.num_layers} prefill calls); FI+ streams equal FI's, "
        f"{cfg.num_layers} K1 a replay; tok/s {serving['FI']['tokens_per_s']:.2f} / "
        f"{serving['FI+']['tokens_per_s']:.2f}")
    shutil.rmtree(FISHER_ARTIFACT)

    rows, gen = [], torch.Generator(device="cuda").manual_seed(SEED + 29)
    for tag, (rk, rv) in (("min", min(ranks, key=sum)), ("max", max(ranks, key=sum))):
        key = f"qwen3-4b fisher {tag}"
        WIDTHS[key] = dict(WIDTHS["qwen3-4b"], r=rk, rv=rv)
        FAMILY_TAG[key] = f"new shape: Fisher ranks r_k {rk} r_v {rv}"
        FAMILY_RUNS[key] = FAMILY_RUNS["fisher"]
        rows += [phase_latent(torch, gen, 1, False, key), phase_k2(torch, gen, key)]
    rec["seconds"] = time.perf_counter() - t_phase
    log(f"the training phase took {rec['seconds']:.1f} s")
    return rec, rows


# -- the mesh: kernels' softmax state, sequence-sharded merge, two ranks -------
#
# (a) every decode kernel with ``return_lse`` against its plain version's
# (o, m, l) at the main path's shapes, its output bit for bit that of the
# launch without the state, and its time with and without; (b) the same
# kernels on the same operands split into 2 and 4 sequence shards in one
# process, each shard's (o, m, l) merged by the port's merge
# (``ops.merge_stacked``: the mesh's two all-reduces as reductions over
# the stacked parts), against the unsharded kernel; (c) qwen3-4b at full
# width served by two ranks that share the card (mesh (1, 2), gloo) against
# the single-device engine (``phase_mesh_runs``).

LSE_ROWS = (  # (row, kernel module attribute, nq, int8, paged, dense)
    ("latent_decode_attention", 1, False, False, False),
    ("latent_decode_attention_quant", 1, True, False, False),
    ("latent_decode_attention_paged", 1, False, True, False),
    ("latent_decode_attention_mq", 4, False, False, False),
    ("latent_decode_attention_mq_quant", 4, True, False, False),
    ("latent_decode_attention_mq_paged", 4, False, True, False),
    ("dense_decode_attention", 1, False, False, True),
    ("dense_decode_attention_mq", 4, False, False, True),
)
LSE_REPLACES = {"latent_decode_attention": ("latent_decode.py", 177),
                "latent_decode_attention_quant": ("latent_decode_q.py", 69),
                "latent_decode_attention_paged": ("latent_decode.py", 456),
                "latent_decode_attention_mq": ("latent_decode.py", 338),
                "latent_decode_attention_mq_quant": ("latent_decode_q.py", 158),
                "latent_decode_attention_mq_paged": ("latent_decode.py", 567),
                "dense_decode_attention": ("latent_decode.py", 177),
                "dense_decode_attention_mq": ("latent_decode.py", 338)}


def compare_state(name, got, want, dtype) -> float:
    """A kernel's (m, l) against its plain version's: relative limits (m is
    a logit, l a sum over up to 4,096 columns), 1e-4 (|want| + 1) in f32,
    ``compare``'s per-element bf16 limit in bf16; rows that see no column
    must be NEG_INF / 0 on both sides.  Returns the max abs error."""
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: state is not finite")
    diff = (got - want).abs()
    if dtype == torch.float32:
        limit = 1e-4 * (want.abs() + 1)
    else:
        live = want.abs() < 1e29
        rms = want[live].square().mean().sqrt().item() if live.any() else 0.0
        limit = BF16_REL * want.abs() + BF16_RMS * rms + (~live) * 1.0
    worst = (diff / limit).max().item()
    log(f"{name} {dtype}: max abs err {diff.max().item():.3e}, worst err / limit "
        f"{worst:.3f}")
    if worst > 1:
        raise AssertionError(f"{name}: softmax state disagrees with the plain version "
                             f"in {dtype} (worst err / limit {worst:.3f})")
    return diff.max().item()


def lse_operands(torch, gen, name, nq, quant, paged, dense):
    """(kernel, plain, make(dt) -> (args, kw), shard(args, kw, i, n) ->
    (args, kw) of sequence shard i of n, flops, shape) at the main path's
    shapes (``ring_inputs`` / ``paged_inputs``).  A shard holds columns
    [i S / n, (i + 1) S / n) of the ring (of each page's offsets on the
    pool, the page table whole) and the self columns on the last shard
    only: a decode's are dropped elsewhere, a verify's masked."""
    from repro_torch.kernels import dense_decode as KD
    from repro_torch.kernels import latent_decode as K
    from repro_torch.kernels import latent_decode_q as KQ
    from repro_torch.kernels.latent_decode import NEG_INF
    from repro_torch.quant import quantize
    mod = KD if dense else KQ if quant else K
    kernel, plain = getattr(mod, name), getattr(mod, name + "_plain")
    one = nq == 1
    if paged:
        a, ptab, pools, cols, flops = paged_inputs(torch, gen, nq)
    else:
        a = ring_inputs(torch, gen, nq, dense=dense)
        ptab, pools = None, {"zk": a["zk"], "zv": a["zv"]}
    B, S, G, Hg, dh, r, s, _ = a["shape"]
    if not paged:
        flops = (dense_flops(B, S + nq, G, Hg, dh, nq) if dense
                 else decode_flops(B, S + nq, G, Hg, dh, r, s, nq))
    sel = (lambda x: x[:, 0]) if one else (lambda x: x)
    bias = a["bias"] if paged or not one else a["bias"][:, 0, :S].contiguous()
    q8 = {k: quantize(a[k], 8) for k in ("zk", "zv", "self_zk", "self_zv")} if quant else {}

    def make(dt):
        if dense:
            args = (a["q"].to(dt), a["zk"].to(dt), a["zv"].to(dt), bias)
            return args, dict(scale=dh ** -0.5, self_k=sel(a["self_zk"]).to(dt),
                              self_v=sel(a["self_zv"]).to(dt))
        kw = dict(scale=dh ** -0.5, k_norm=a["k_norm"], self_cos=sel(a["self_cos"]),
                  self_sin=sel(a["self_sin"]))
        if quant:
            lat = (q8["zk"][0], q8["zk"][1][..., 0], q8["zv"][0], q8["zv"][1][..., 0])
            kw.update(self_zk_q=sel(q8["self_zk"][0]), self_zk_s=sel(q8["self_zk"][1][..., 0]),
                      self_zv_q=sel(q8["self_zv"][0]), self_zv_s=sel(q8["self_zv"][1][..., 0]))
        else:
            lat = (pools["zk"].to(dt), pools["zv"].to(dt))
            kw.update(self_zk=sel(a["self_zk"]).to(dt), self_zv=sel(a["self_zv"]).to(dt))
        lead = (ptab,) if paged else ()
        return (*lead, a["q"].to(dt), *lat, a["r_k"].to(dt), a["cos"], a["sin"], bias), kw

    n_lat = 2 if dense else 4 if quant else 2

    def shard(args, kw, i, n):
        last = i == n - 1
        if paged:   # each page's offsets [i w, (i + 1) w); view columns with those offsets
            w = PAGE // n
            view = torch.arange(S, device="cuda")
            keep = view[(view % PAGE) // w == i]
            lat = tuple(x[:, i * w:(i + 1) * w].contiguous() for x in args[2:4])
            cos, sin = (x[:, keep].contiguous() for x in args[5:7])
            ring_cols = keep
            out = (args[0], args[1], *lat, args[4], cos, sin)
        else:
            c = slice(i * S // n, (i + 1) * S // n)
            ring_cols = torch.arange(S, device="cuda")[c]
            lead = args[:1]
            lat = tuple(x[:, c].contiguous() for x in args[1:1 + n_lat])
            rest = args[1 + n_lat:-1]
            if not dense:   # r_k, then the ring's rotation tables
                rest = (rest[0],) + tuple(x[:, c].contiguous() for x in rest[1:])
            out = (*lead, *lat, *rest)
        b = args[-1]
        kw = dict(kw)
        if one:
            b = b[:, ring_cols].contiguous()
            if not last:   # a decode's self column scores on the last shard only
                for k in [k for k in kw if k.startswith("self_")]:
                    kw[k] = None
        else:
            tail = b[..., S:] if last else torch.full_like(b[..., S:], NEG_INF)
            b = torch.cat([b[..., ring_cols], tail], dim=-1).contiguous()
        return (*out, b), kw

    src = ("latent_decode_tc" if not dense
           else "dense_verify" if nq > 1 or Hg >= 8 else "dense_decode")
    shape = (f"B={B} S={S}+{nq}{f' page_size={PAGE}' if paged else ''} "
             f"{'Hkv' if dense else 'G'}={G} {'q_per_kv' if dense else 'Hg'}={Hg} nq={nq} "
             f"dh={dh}{'' if dense else f' r={r}'}{' int8 latents' if quant else ''}")
    return kernel, plain, make, shard, flops, shape, src


def phase_lse(torch, gen) -> list:
    """Parts (a) and (b) for every decode kernel; returns the kernels line's
    rows of the ``return_lse`` variants (launches: the mesh runs')."""
    from repro_torch.kernels import ops
    rows = []
    for name, nq, quant, paged, dense in LSE_ROWS:
        kernel, plain, make, shard, flops, shape, src = lse_operands(
            torch, gen, name, nq, quant, paged, dense)
        err, split = {}, {}
        for dt in (torch.float32, torch.bfloat16):
            args, kw = make(dt)
            o, m, l = kernel(*args, **kw, return_lse=True)
            bare = kernel(*args, **kw)
            torch.cuda.synchronize()
            if not torch.equal(o, bare):
                raise AssertionError(f"{name}: the output with return_lse differs from the "
                                     f"launch without it")
            po, pm, pl = plain(*args, **kw, return_lse=True)
            err[dt] = (compare(f"{name}+lse o", o, po, dt),
                       compare_state(f"{name}+lse m", m, pm, dt),
                       compare_state(f"{name}+lse l", l, pl, dt))
            for n in (2, 4):   # (b): sequence shards merged by the port's merge
                parts = [kernel(*sa, **skw, return_lse=True)
                         for sa, skw in (shard(args, kw, i, n) for i in range(n))]
                o_s, m_s, l_s = (torch.stack(x) for x in zip(*parts))
                merged = ops.merge_stacked(o_s, m_s, l_s)
                w = l_s * torch.exp(m_s - m_s.amax(dim=0))
                mag = ((o_s.float().abs() * w[..., None]).sum(0)
                       / w.sum(0).clamp(min=1e-30)[..., None])
                torch.cuda.synchronize()
                # in bf16 the merge reads each shard's bf16 output: the merged
                # output and the unsharded kernel's each round the function,
                # so each is held to the plain version at the limit and to
                # each other at twice it, the merge's limit at the size of
                # its parts (``compare``'s ``mag``)
                compare(f"{name} merged over {n} shards vs plain", merged, po, dt, mag=mag)
                split[(dt, n)] = compare(f"{name} merged over {n} shards vs the unsharded "
                                         f"kernel", merged, bare, dt,
                                         scale=1.0 if dt == torch.float32 else 2.0, mag=mag)
        ms = cuda_ms(lambda: kernel(*args, **kw, return_lse=True), iters=50)
        ms_bare = cuda_ms(lambda: kernel(*args, **kw), iters=50)
        plain_ms = cuda_ms(lambda: plain(*args, **kw, return_lse=True), iters=3)
        tensors = [t for t in (*args, *kw.values()) if hasattr(t, "numel")]
        if paged:   # the bound's bytes as phase_paged counts them, m / l added
            used = int(torch.unique(args[0][args[0] != 0]).numel())
            B, S = args[1].shape[0], args[0].shape[1] * PAGE
            lat = used * PAGE * sum(x[0, 0].numel() * x.element_size() for x in args[2:4])
            moved = lat + nbytes(args[0], args[1], args[4], bare, *tensors[5:])
        else:
            moved = nbytes(*tensors, bare)
        b_ms, by = bound(moved + nbytes(m, l), flops)
        lib_ms = None
        if dense:   # the library call that also returns the log-sum-exp
            lib_ms = sdpa_lse_time(torch, *args[:3], kw["self_k"], kw["self_v"], args[3], nq)
        log(f"{name}+lse {shape}: max err f32 {err[torch.float32]} bf16 "
            f"{err[torch.bfloat16]} (o, m, l); merged over 2 / 4 shards vs unsharded, bf16 "
            f"{split[(torch.bfloat16, 2)]:.3e} / {split[(torch.bfloat16, 4)]:.3e}; kernel "
            f"{ms:.4f} ms with the state, {ms_bare:.4f} ms without; plain {plain_ms:.4f} ms; "
            f"bound {b_ms:.4f} ms ({by}); library (efficient attention + lse) "
            f"{lib_ms if lib_ms is None else f'{lib_ms:.4f} ms'}")
        f, line = LSE_REPLACES[name]
        rows.append({"name": f"{name}+lse", "launch_key": f"{name}+lse", "route": "cuda",
                     "source": f"src/repro_torch/csrc/{src}.cu",
                     "replaces": f"src/repro/kernels/{f}:{line}",
                     "tpu_kernel": f"src/repro/kernels/{f}::{name} (return_lse=True)",
                     "max_abs_err": err[torch.bfloat16][0], "max_err_f32": err[torch.float32][0],
                     "state_err_bf16": err[torch.bfloat16][1:],
                     "state_err_f32": err[torch.float32][1:],
                     "merge_err": {f"{str(dt)[6:]} x{n}": v for (dt, n), v in split.items()},
                     "ms": ms, "ms_without_lse": ms_bare, "plain_ms": plain_ms,
                     "bound_ms": b_ms, "bound_by": by, "library_ms": lib_ms,
                     "library": None if lib_ms is None else
                     "aten._scaled_dot_product_efficient_attention(compute_log_sumexp=True)",
                     "shape": shape + " bf16", "runs": tuple(MESH_RUNS)})
    return rows


# (c): two ranks on one card.  qwen3-4b at full width, cut to a few of its
# 36 layers (each rank gathers every weight it reads across the host at
# every step: see PERF.md), on a (1, 2) mesh over gloo, at MESH_LAYERS
# (2: the depth cut that keeps the script inside its limit).  MA32 / MA:
# A's prompts (8 of 512-2,048, prefilled whole), f32 / bf16, 4 tokens
# each in windows of 3 decode steps (later steps read the columns earlier
# ones wrote); MD: D's pool (page 16, 385 pages, prefix-affinity) and its
# first 8 prompts (one wave).  Then one short run for each other decode kernel's return_lse
# variant: MB (int8 ring, K3), MB2 (int8 ring at spec_depth 2, K6), MC2
# (float ring at spec_depth 2, K5), MD2 (the pool at spec_depth 2, K7),
# MH / MH2 (the dense cache: its decode and verify kernels).  "layers",
# "new" (tokens a request), "sync" (sync_every) and "first" (prompts)
# cut each run to size: a step costs what its gathers cost (PERF.md),
# the tied embedding's once a step (MeshParams.step) whatever the depth.
# Then the paths the einsum readers' merge serves, each at full width:
# MM32 / MM2, deepseek-v3-671b cut to its first layer (MLA + the dense
# FFN; its untied 129,280 x 7,168 embedding and head dominate the
# gathers), f32 on A's first 4 prompts / bf16 with n-gram speculation
# on C's (MLA's absorbed decode / verify merged in c_kv space); MW / MWU,
# whisper-small at full depth, dense / latent (random latents at ratio
# 0.5), f32, on A's first 4 prompts and W's source (the encoder, the
# sharded cross caches and their merged readers; the self halves on the
# dense decode / K1 with the state); MF, falcon-mamba-7b at 2 of its 64
# layers, f32, on a (2, 1) mesh, R's first 4 prompts (one prefill
# bucket: the state runs over its wave's pads, and two data ranks form
# other waves); MR, recurrentgemma-9b at one period of 3 layers (two
# RG-LRU blocks, one local attention), latent, bf16 (the state gathered
# over "model", the window ring on K1 with the state); ML, qwen3-4b at 4
# layers with the layer draft of 2 (the draft's own sharded ring: K1 /
# K5 with the state), bf16; ME, qwen3-4b at 1 layer on the einsum
# backend, f32 (its readers merged in einsum form).  "arch", "mesh"
# (data, model), "source" (a seed) and "check" (the reader whose first
# merged call is held to the unsharded one: "latent" K1, "mla") set the
# rest.
# Then the overlapped engines and the shapes a mesh does not split, each
# against the single-device SYNC engine ("mesh_kw" applies on the mesh
# only), qwen3-4b latent, f32: MO32 (2 layers, A's first 4 prompts, the
# overlapped engine at depth 2 with the admission thread, (1, 2)); MC32
# (1 layer, A's first 6 prompts over 4 slots with budgets of 2-5 tokens,
# so that slots free mid-window: the continuous engine at depth 3 on
# (2, 1), each data rank installing into its own slots); MU32 (1 layer,
# max_len 4,095: the ring stays whole on both "model" ranks, read by the
# bare K1 with no merge); MP32 (1 layer, 3 slots on (2, 1), which stay
# whole on both data ranks, and D's pool at an even page count, 384
# pages of 16, kept whole on each data rank).  "slots", "max_len" and a
# tuple "new" (budgets cycled) size them.
MESH_LAYERS = 2
MESH_RUNS = {
    "MA32": dict(dtype="float32", prompts="A", ratio=0.5, new=4, sync=3, check="latent"),
    "MA": dict(dtype="bfloat16", prompts="A", ratio=0.5, new=4, sync=3, check="latent"),
    "MD": dict(dtype="bfloat16", prompts="D", ratio=0.5, new=2, sync=1, first=8,
               kw=dict(cache_layout="paged", page_size=PAGE, n_pages=D_PAGES,
                       policy="prefix-affinity")),
    "MB": dict(dtype="bfloat16", prompts="B", ratio=0.5, bits=8, layers=1, new=2, sync=1),
    "MB2": dict(dtype="bfloat16", prompts="B", ratio=0.5, bits=8, layers=1, new=2, sync=1,
                kw=dict(spec_depth=2, draft="ngram")),
    "MC2": dict(dtype="bfloat16", prompts="C", ratio=0.5, layers=1, new=2, sync=1,
                kw=dict(spec_depth=2, draft="ngram")),
    "MD2": dict(dtype="bfloat16", prompts="C", ratio=0.5, layers=1, new=2, sync=1,
                kw=dict(spec_depth=2, draft="ngram", cache_layout="paged",
                        page_size=PAGE)),
    "MH": dict(dtype="bfloat16", prompts="C", ratio=None, layers=1, new=2, sync=1),
    "MH2": dict(dtype="bfloat16", prompts="C", ratio=None, layers=1, new=2, sync=1,
                kw=dict(spec_depth=2, draft="ngram")),
    "MM32": dict(arch="deepseek-v3-671b", dtype="float32", prompts="A", first=4,
                 ratio=None, layers=1, new=2, sync=1),
    "MM2": dict(arch="deepseek-v3-671b", dtype="bfloat16", prompts="C", ratio=None,
                layers=1, new=2, sync=1, check="mla", kw=dict(spec_depth=2, draft="ngram")),
    "MW": dict(arch="whisper-small", dtype="float32", prompts="A", first=4, ratio=None,
               layers=None, new=2, sync=1, source=SEED + 8),
    "MWU": dict(arch="whisper-small", dtype="float32", prompts="A", first=4, ratio=0.5,
                layers=None, new=2, sync=1, source=SEED + 8),
    "MF": dict(arch="falcon-mamba-7b", dtype="float32", prompts="R", first=4, ratio=None,
               layers=2, new=2, sync=1, mesh=(2, 1)),
    "MR": dict(arch="recurrentgemma-9b", dtype="bfloat16", prompts="A", first=4, ratio=0.5,
               layers=3, new=2, sync=1, check="latent"),
    "ML": dict(dtype="bfloat16", prompts="C", ratio=0.5, layers=4, new=2, sync=1,
               check="latent", kw=dict(spec_depth=2, draft="layers:2")),
    "ME": dict(dtype="float32", prompts="C", ratio=0.5, layers=1, new=2, sync=1,
               kw=dict(backend="einsum")),
    "MO32": dict(dtype="float32", prompts="A", first=4, ratio=0.5, new=4, sync=3,
                 check="latent", mesh_kw=dict(overlap=True, pipeline_depth=2,
                                              admission_thread=True)),
    "MC32": dict(dtype="float32", prompts="A", first=6, ratio=0.5, layers=1,
                 new=(2, 3, 4, 5), sync=3, slots=4, mesh=(2, 1),
                 mesh_kw=dict(overlap=True, continuous=True, pipeline_depth=3)),
    "MU32": dict(dtype="float32", prompts="A", first=4, ratio=0.5, layers=1, new=2,
                 sync=1, max_len=4095),
    "MP32": dict(dtype="float32", prompts="D", first=4, ratio=0.5, layers=1, new=2,
                 sync=1, slots=3, mesh=(2, 1),
                 kw=dict(cache_layout="paged", page_size=PAGE, n_pages=384,
                         policy="prefix-affinity")),
}
# each run's return_lse variants that must launch; () where no kernel may
# launch at all (MLA, the einsum backend, an attention-free model)
MESH_MUST = {"MA32": ("latent_decode_attention+lse",), "MA": ("latent_decode_attention+lse",),
             "MD": ("latent_decode_attention_paged+lse",),
             "MB": ("latent_decode_attention_quant+lse",),
             "MB2": ("latent_decode_attention_mq_quant+lse",),
             "MC2": ("latent_decode_attention_mq+lse",),
             "MD2": ("latent_decode_attention_mq_paged+lse",),
             "MH": ("dense_decode_attention+lse",), "MH2": ("dense_decode_attention_mq+lse",),
             "MM32": (), "MM2": (), "MW": ("dense_decode_attention+lse",),
             "MWU": ("latent_decode_attention+lse",), "MF": (),
             "MR": ("latent_decode_attention+lse",),
             "ML": ("latent_decode_attention+lse", "latent_decode_attention_mq+lse"),
             "ME": (), "MO32": ("latent_decode_attention+lse",),
             "MC32": ("latent_decode_attention", "stage_install_rows"),
             "MU32": ("latent_decode_attention",),
             "MP32": ("latent_decode_attention_paged",)}
MESH_NEW = ("MO32", "MC32", "MU32", "MP32")   # this slice's cells
# qwen3-4b mesh cells whose kernels launch bare (no "model" merge): their
# launches count in the bare kernels' rows of the kernels line
MESH_BARE = ("MC32", "MU32", "MP32")


def mesh_model(torch, run, layers):
    """A run's model on the card: its arch at full width (qwen3-4b by
    default), cut to its layers (a leading prefix too: deepseek's
    attn_dense layers), random weights from seed 0."""
    from repro_torch.configs import get_config
    from repro_torch.models.weights import init_params
    spec = MESH_RUNS[run]
    cfg = get_config(spec.get("arch", "qwen3-4b"), recalkv_ratio=spec["ratio"])
    n = spec.get("layers", layers) or cfg.num_layers
    cfg = dataclasses.replace(cfg, attn_backend="kernel", num_layers=n,
                              prefix_pattern=cfg.prefix_pattern[:n],
                              dtype=getattr(torch, spec["dtype"]),
                              cache_quant_bits=spec.get("bits"))
    return cfg, init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))


def mesh_requests(torch, run, vocab):
    spec = MESH_RUNS[run]
    reqs = engine_prompts(torch, spec["prompts"], vocab)[:spec.get("first")]
    new = spec["new"] if isinstance(spec["new"], tuple) else (spec["new"],)
    return [(p, new[i % len(new)]) for i, (p, _) in enumerate(reqs)]


def _checked_first(torch, run, first, orig):
    """``orig`` (a reader taking ``mesh=``, its cache the third argument
    or, for ``ops.latent_decode``, the second) wrapped so that its first
    merged call also runs unsharded on the cache gathered over "model",
    the two outputs held to the run's dtype's limit in ``first``: the
    kernel's at the limit; an einsum reader's (MLA's, whose output is
    checked after its value and output products) at twice it in bf16,
    where both sides carry their own rounding of one function (the
    unsharded reader rounds its weights and its latent output, the merged
    one keeps its parts in float32 and rounds once; the two read 1.459 of
    the limit apart on an H100, PERF.md).  So that twice the limit still
    tells a faulty merge, the einsum reader's output of one rank's
    columns alone (what a merge that loses the other rank's part gives)
    must read past it on some rank (a rank whose columns hold every
    prompt loses nothing alone).  A verify step's rows with no fed column (idle
    slots) are left out: they see no column, which the merge makes 0 and
    the unsharded einsum an average of every column, and the engine
    discards both."""
    from repro_torch.kernels import ops
    at = 1 if orig is ops.latent_decode else 2
    scale = 1.0 if at == 1 else 2.0

    def checked(*a, **kw):
        out = orig(*a, **kw)
        m = kw.get("mesh")
        if m is not None and not first:
            full = {k: m.all_gather(v, "model", dim=1) for k, v in a[at].items()}
            want = orig(*a[:at], full, *a[at + 1:], **{**kw, "mesh": None})
            o, w = (out, want) if at == 1 else (out[0], want[0])
            live = a[5].any(dim=1) if orig.__name__.startswith("verify") else slice(None)
            torch.cuda.synchronize()
            name = f"engine run {run}: the first merged {orig.__name__} (layer 0)"
            first["max_abs_err"] = compare(name, o[live], w[live], o.dtype, scale=scale)
            if at != 1:
                alone = orig(*a, **{**kw, "mesh": None})[0]
                mine = worst_ratio(alone[live], w[live], o.dtype, scale)[2]
                first["unmerged_worst"] = m.all_reduce(
                    torch.tensor([mine], dtype=torch.float64), "model", "max").item()
                log(f"{name}: one rank's columns alone, unmerged, worst err / limit "
                    f"{mine:.3f} on this rank, {first['unmerged_worst']:.3f} over the ranks "
                    f"(x{scale:g})")
                if first["unmerged_worst"] <= 1:
                    raise AssertionError(f"{name}: an unmerged output passes the check "
                                         f"({first['unmerged_worst']:.3f}): it cannot tell "
                                         f"a lost part")
        return out
    return checked


def serve_mesh_run(torch, run, layers, mesh=None, check_first=False):
    """One MESH_RUNS run on this process's card: the single-device engine
    (``mesh`` None) or this rank's engine on ``mesh``.  With
    ``check_first`` the first decode step's first layer also runs
    unsharded on the gathered ring: its merged output against the
    unsharded kernel's, in the run's dtype's limit.  Returns the record."""
    from repro_torch import kernels
    from repro_torch.kernels import ops
    from repro_torch.models import kv_cache as KC
    from repro_torch.serving import Engine, Request
    t_start = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    cfg, params = mesh_model(torch, run, layers)
    spec = MESH_RUNS[run]
    src = (None if spec.get("source") is None
           else make_source(torch, cfg, spec["source"]))
    with warnings.catch_warnings():   # MLA and cross layers: the einsum readers
        warnings.simplefilter("ignore", RuntimeWarning)
        eng = Engine(cfg, params, max_slots=spec.get("slots", 8),
                     max_len=spec.get("max_len", 4096), sync_every=spec["sync"],
                     mesh=mesh, source=src, **spec.get("kw", {}),
                     **(spec.get("mesh_kw", {}) if mesh is not None else {}))
    del params   # on a mesh the engine keeps this rank's shards only
    gc.collect()
    torch.cuda.empty_cache()
    for uid, (prompt, n_new) in enumerate(mesh_requests(torch, run, cfg.vocab_size)):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n_new))
    first = {}
    check = spec.get("check") if check_first else None
    origs = {"latent": [(ops, "latent_decode")],
             "mla": [(KC, "decode_attn_mla"), (KC, "verify_attn_mla")]}.get(check, [])
    saved = [(mod, name, getattr(mod, name)) for mod, name in origs]
    for mod, name, fn in saved:
        setattr(mod, name, _checked_first(torch, run, first, fn))
    kernels.reset_launch_counts()
    if mesh is not None:   # this run's collectives only
        mesh.stats = dict.fromkeys(mesh.stats, 0)
        eng.params.gathered_bytes = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        done = eng.run()
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    m = eng.metrics()
    launches = launch_counts(kernels)
    launches.update({f"{k.__name__}+lse": k.lse_launches for k in kernels.LSE_KERNELS})
    streams = {str(r.uid): [int(t) for t in r.out_tokens] for r in done}
    if len(done) != len(spec_reqs := mesh_requests(torch, run, cfg.vocab_size)):
        raise AssertionError(f"engine run {run}: {len(done)} of {len(spec_reqs)} finished")
    # steps that read every weight: the prefills and the window iterations
    steps = m["prefill_calls"] + m["windows"] * spec["sync"]
    stats = m["mesh_stats"]
    per_step = {"steps": steps,
                "merge_ms_per_step": 1e3 * stats["all_reduce_s"] / steps,
                "gather_ms_per_step": 1e3 * stats["all_gather_s"] / steps,
                "gathered_weight_bytes_per_step": stats["gathered_weight_bytes"] / steps,
                "collectives_per_window": (stats["all_reduce"] + stats["all_gather"])
                / max(m["windows"], 1)}
    rec = {"streams": streams, "tokens": m["tokens"], "wall_s": wall, "per_step": per_step,
           "tokens_per_s": m["tokens"] / wall, "windows": m["windows"],
           "host_syncs": m["host_syncs"], "admission_syncs": m["admission_syncs"],
           "launches": launches, "mesh": m["mesh"], "mesh_stats": m["mesh_stats"],
           "pages_shared": m["pages_shared"], "peak_gib": torch.cuda.max_memory_allocated()
           / 2 ** 30, "first_step": first, "layers": cfg.num_layers, "vocab": cfg.vocab_size,
           "draft_proposed": m["draft_proposed"], "slot_swaps": m["slot_swaps"],
           "slot_shards": eng.scheduler.slot_shards, "overlap": m["overlap"],
           "continuous": m["continuous"], "window_overlap": m["window_overlap"]}
    eng.close()
    del eng
    gc.collect()
    torch.cuda.empty_cache()
    rec["total_s"] = time.perf_counter() - t_start
    return rec


def _mesh_rank(rank, folder, runs, layers):
    """One of the two ranks of phase (c): every run of ``runs`` on a (1, 2)
    gloo mesh over a FileStore in ``folder``; rank 0 writes the records."""
    import torch
    import torch.distributed as dist
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.cuda.set_device(0)
    store = dist.FileStore(str(Path(folder) / "store"), 2)
    meshes = {}
    for shape in dict.fromkeys(MESH_RUNS[run].get("mesh", (1, 2)) for run in runs):
        meshes[shape] = make_mesh(*shape, backend="gloo", store=store, rank=rank,
                                  world_size=2)
    out = {run: serve_mesh_run(torch, run, layers, meshes[MESH_RUNS[run].get("mesh", (1, 2))],
                               check_first=True)
           for run in runs}
    dist.destroy_process_group()
    if rank == 0:
        (Path(folder) / "mesh.json").write_text(json.dumps(out))


def top2_margin(torch, run, layers, uid, tokens) -> float:
    """The single-device model's top-2 logit margin after ``tokens`` (a
    prompt and the stream up to where two streams part)."""
    from repro_torch.models import transformer as T
    cfg, params = mesh_model(torch, run, layers)
    spec = MESH_RUNS[run]
    src = (None if spec.get("source") is None
           else make_source(torch, cfg, spec["source"])[uid:uid + 1])
    toks = torch.tensor(tokens, device="cuda")[None]
    logits, _ = T.prefill(cfg, params, toks, torch.tensor([len(tokens)], device="cuda"),
                          4096, source=src)
    top = logits[0].float().topk(2).values
    del params
    torch.cuda.empty_cache()
    return (top[0] - top[1]).item()


def phase_mesh_runs(torch, layers=MESH_LAYERS, runs=tuple(MESH_RUNS)) -> dict:
    """Part (c): each run on the single-device engine in this process, then
    on two spawned ranks sharing the card; an f32 run's streams must
    equal, a checked run's first merged call must be within its dtype's
    limit (a bf16 run's streams' agreement and, where they part, the
    position and the top-2 margin are reported), every run must serve
    every request with its kernels' return_lse variants (``MESH_MUST``;
    a run with none may launch no kernel).  The tok/s are two ranks
    time-slicing one card over a host transport, not a mesh's speed."""
    import tempfile
    import torch.multiprocessing as mp
    t0 = time.perf_counter()
    single = {run: serve_mesh_run(torch, run, layers) for run in runs}
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    (ROOT / "build").mkdir(exist_ok=True)   # gitignored: absent from a fresh checkout
    with tempfile.TemporaryDirectory(dir=str(ROOT / "build")) as folder:
        ctx = mp.get_context("spawn")
        procs = [ctx.Process(target=_mesh_rank, args=(r, folder, runs, layers))
                 for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(900)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung or any(p.exitcode != 0 for p in procs):
            raise AssertionError(f"mesh ranks failed: exit codes {[p.exitcode for p in procs]}")
        mesh = json.loads((Path(folder) / "mesh.json").read_text())
    rec = {"layers": layers, "single_s": t1 - t0, "mesh_s": time.perf_counter() - t1,
           "by_run": {run: mesh[run]["launches"] for run in runs}}
    for run in runs:
        one, two = single[run], mesh[run]
        agree = sum(a == b for uid in one["streams"]
                    for a, b in zip(one["streams"][uid], two["streams"][uid]))
        total = sum(len(v) for v in one["streams"].values())
        parted = []
        for uid in sorted(one["streams"], key=int):
            a, b = one["streams"][uid], two["streams"][uid]
            if a != b:
                k = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
                parted.append((int(uid), k))
        r = {"equal": one["streams"] == two["streams"], "tokens_agree": agree,
             "tokens": total, "parted": parted,
             "single_tokens_per_s": one["tokens_per_s"],
             "mesh_tokens_per_s_two_ranks_one_card_gloo": two["tokens_per_s"],
             "mesh_wall_s": two["wall_s"], "single_wall_s": one["wall_s"],
             "windows": two["windows"], "host_syncs": two["host_syncs"],
             "admission_syncs": two["admission_syncs"], "mesh_stats": two["mesh_stats"],
             "per_step": two["per_step"],
             "launches": two["launches"], "first_step": two["first_step"],
             "peak_gib_rank0": two["peak_gib"], "pages_shared": two["pages_shared"]}
        if r["host_syncs"] != r["windows"] + r["admission_syncs"]:
            raise AssertionError(f"engine run {run} on the mesh: host syncs {r}")
        spec = MESH_RUNS[run]
        for key in MESH_MUST[run]:
            if two["launches"][key] <= 0:
                raise AssertionError(f"engine run {run} on the mesh never launched "
                                     f"{key}: {two['launches']}")
        if not MESH_MUST[run] and any(two["launches"].values()):
            raise AssertionError(f"engine run {run} on the mesh launched a kernel: "
                                 f"{two['launches']}")
        if spec["dtype"] == "float32" and not r["equal"]:
            raise AssertionError(f"engine run {run} (float32): mesh streams differ from the "
                                 f"single-device engine's at {parted}")
        if spec.get("check") and "max_abs_err" not in two["first_step"]:
            raise AssertionError(f"engine run {run}: the first merged call was not checked")
        if spec.get("kw", {}).get("draft", "").startswith("layers") and two["draft_proposed"] <= 0:
            raise AssertionError(f"engine run {run} on the mesh: the layer draft proposed "
                                 f"no token")
        if spec["dtype"] == "bfloat16" and parted:
            uid, k = parted[0]
            prompt = mesh_requests(torch, run, two["vocab"])[uid][0]
            r["top2_margin_at_first_part"] = top2_margin(
                torch, run, layers, uid, list(prompt) + one["streams"][str(uid)][:k])
        if run == "MD" and r["pages_shared"] < 1:
            raise AssertionError(f"engine run MD on the mesh shared no page: {r}")
        for key, want in spec.get("mesh_kw", {}).items():
            if key in ("overlap", "continuous") and two[key] != want:
                raise AssertionError(f"engine run {run} on the mesh: {key} is {two[key]}")
        if run == "MC32" and two["slot_swaps"] <= 0:
            raise AssertionError(f"engine run MC32 on the mesh installed nothing: {r}")
        if run == "MU32" and (two["mesh_stats"]["all_reduce"] or any(
                v for k, v in two["launches"].items() if k.endswith("+lse"))):
            raise AssertionError(f"engine run MU32 on the mesh merged a whole ring: "
                                 f"{two['mesh_stats']}, {two['launches']}")
        if run == "MP32" and two["slot_shards"] != 1:
            raise AssertionError(f"engine run MP32 on the mesh split 3 slots: {r}")
        r.update(slot_swaps=two["slot_swaps"], slot_shards=two["slot_shards"],
                 window_overlap=two["window_overlap"])
        r["single_total_s"], r["mesh_total_s"] = one["total_s"], two["total_s"]
        log(f"engine run {run} ({spec.get('arch', 'qwen3-4b')}, {spec['dtype']}) on the mesh "
            f"{spec.get('mesh', (1, 2))}, two ranks sharing the card over gloo, "
            f"{two['layers']} layers: streams equal {r['equal']} ({agree}/{total} tokens agree"
            f"{', parted at ' + str(parted) if parted else ''}); single device "
            f"{one['tokens_per_s']:.2f} tok/s, two ranks on one card over a host "
            f"transport {two['tokens_per_s']:.2f} tok/s (not a mesh's speed); windows "
            f"{r['windows']}, host syncs {r['host_syncs']}; collectives {two['mesh_stats']}, "
            f"per step {two['per_step']}; "
            f"first step {two['first_step']}; lse launches "
            f"{ {k: v for k, v in two['launches'].items() if k.endswith('+lse') and v} }")
        rec[run] = r
    new = [run for run in runs if run in MESH_NEW]
    rec["new_cells_s"] = {"single": sum(rec[run]["single_total_s"] for run in new),
                          "mesh_rank0": sum(rec[run]["mesh_total_s"] for run in new)}
    log(f"the mesh runs took {rec['single_s']:.1f} s single-device and {rec['mesh_s']:.1f} s "
        f"on the two ranks; this slice's cells {new}: {rec['new_cells_s']} s")
    return rec


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import kernels
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.config import ReCalKVRuntime
    from repro_torch.models.weights import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"python {sys.version.split()[0]} torch {torch.__version__} cuda "
        f"{torch.version.cuda}; card: {card}")

    t0 = time.perf_counter()
    info = build.build_all()
    built = ", ".join(
        f"{k} ({'cached' if v['cached'] else '%.2f s' % v['seconds']})"
        for k, v in info.items())
    log(f"kernels built in {time.perf_counter() - t0:.2f} s: {built}")
    for name, v in info.items():
        ptx = build.ptxas_summary(v["ptxas"])
        for e in ptx:
            log(f"ptxas {name}: {e['kernel']}: {e['registers']} registers, spill stores "
                f"{e['spill_stores']} B, spill loads {e['spill_loads']} B")
            if name in NO_SPILL and (e["spill_stores"] or e["spill_loads"]):
                raise AssertionError(f"{e['kernel']} spills registers")
        if name == "latent_decode_tc" and not v["cached"]:
            log(f"no spill in the {len(ptx)} kernels of latent_decode_tc.cu (K1, K3-K7 "
                f"at every block plan, and the merge)")

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = [phase_latent(torch, gen, 1, False), phase_k2(torch, gen),
               phase_latent(torch, gen, 1, True), phase_paged(torch, gen, 1),
               phase_latent(torch, gen, 4, False), phase_latent(torch, gen, 4, True),
               phase_paged(torch, gen, 4)]
    wide_ranks = phase_tc_widths(torch, gen)
    torch.cuda.empty_cache()
    t_dense = time.perf_counter()
    entries += [phase_dense(torch, gen, paged, nq) for nq in (1, 4, 16)
                for paged in (False, True)]
    entries.append(phase_dense(torch, gen, False, 9))   # 36 rows: one partial row group
    decode_bodies = phase_decode_bodies(torch, gen)
    f32_widths = phase_f32_widths(torch, gen)
    torch.cuda.empty_cache()
    log(f"dense cores and f32 widths took {time.perf_counter() - t_dense:.1f} s")
    # the families' widths: every body on gemma3-12b's path at dh 256, and
    # minicpm-2b's pools at q_per_kv 1
    t_fam = time.perf_counter()
    g3 = "gemma3-12b"
    entries += [phase_latent(torch, gen, nq, quant, g3) for nq in (1, 4)
                for quant in (False, True)]
    entries += [phase_k2(torch, gen, g3), phase_k2(torch, gen, g3, window=1024),
                phase_k2(torch, gen, g3, dense=True)]
    entries += [phase_dense(torch, gen, False, nq, g3) for nq in (1, 4)]
    entries += [phase_paged(torch, gen, 1, "minicpm-2b"),
                phase_dense(torch, gen, True, 4, "minicpm-2b")]
    # h2o-danube-1.8b's d_head 80 in every body on its path (no pool: its
    # local rings refuse one), and qwen3-moe-235b-a22b's q_per_kv 16 in
    # every body (G 1, Hg 64; the dense verify at nq 4 is 64 rows)
    dn, qm = "h2o-danube-1.8b", "qwen3-moe-235b-a22b"
    entries += [phase_latent(torch, gen, nq, quant, arch) for arch in (dn, qm)
                for nq in (1, 4) for quant in (False, True)]
    entries += [phase_k2(torch, gen, dn), phase_k2(torch, gen, dn, window=1024),
                phase_k2(torch, gen, dn, dense=True)]
    entries += [phase_dense(torch, gen, False, nq, dn) for nq in (1, 4)]
    entries += [phase_paged(torch, gen, nq, qm) for nq in (1, 4)]
    entries += [phase_k2(torch, gen, qm), phase_k2(torch, gen, qm, dense=True)]
    entries += [phase_dense(torch, gen, paged, nq, qm) for nq in (1, 4)
                for paged in (False, True)]
    entries.append(phase_dense(torch, gen, False, 16, qm))   # 256 rows: four row groups
    # whisper-small's widths: its latent cache at ratio 0.5 (K1 at G 3, Hg 4,
    # dh 64, r 128; K2 at dh 64, dv 128) and its dense decode (Hkv 12,
    # q_per_kv 1); llama-3.2-vision-11b's are qwen3-4b's
    ws = "whisper-small"
    entries += [phase_latent(torch, gen, 1, False, ws), phase_k2(torch, gen, ws),
                phase_dense(torch, gen, False, 1, ws)]
    # recurrentgemma-9b's local layers: MQA (Hkv 1, q_per_kv 16) at dh 256
    # over the 2,048-token window ring; its latents G 1, s 1, r 128
    rg = "recurrentgemma-9b"
    entries += [phase_latent(torch, gen, 1, quant, rg) for quant in (False, True)]
    entries += [phase_k2(torch, gen, rg, window=2048),
                phase_k2(torch, gen, rg, window=2048, dense=True),
                phase_dense(torch, gen, False, 1, rg)]
    torch.cuda.empty_cache()
    log(f"the families' kernel widths took {time.perf_counter() - t_fam:.1f} s")
    # the mesh: (a) and (b) for every decode kernel, then (c) on two ranks
    # sharing the card, while this process holds no model
    t_mesh = time.perf_counter()
    entries += phase_lse(torch, gen)
    torch.cuda.empty_cache()
    mesh = phase_mesh_runs(torch)
    log(f"the mesh phase took {time.perf_counter() - t_mesh:.1f} s")

    cfg = get_config("qwen3-4b", recalkv_ratio=0.5)
    cfg = dataclasses.replace(cfg, attn_backend="kernel", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = count_params(params)
    log(f"model {cfg.name} recalkv r={cfg.recalkv.rank_k} G="
        f"{cfg.recalkv.num_groups(cfg.num_kv_heads)}: {n_params / 1e9:.3f} B params "
        f"initialised in {time.perf_counter() - t0:.2f} s")
    entries.append(phase_stage_install(torch, cfg, params, gen))
    backends = phase_backends(torch, cfg, params)
    backends["paged"] = phase_paged_steps(torch, cfg, params)
    serving, by_run, streams = {}, {}, {}
    by_run.update(mesh.pop("by_run"))
    for run in "ABCDE":
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    if streams["E"] != streams["C"]:
        raise AssertionError(f"engine run E (paged pool) streams differ from run C's "
                             f"(ring): {streams['E']} vs {streams['C']}")
    log("engine run E streams equal run C's token for token")
    phase_overlapped(torch, cfg, params, "ABD", by_run, streams, serving)
    # D+ at staging_depth 8 (the default is 2 x max_slots = 16)
    by_run["D+s8"], streams["D+s8"], serving["D+s8"] = phase_engine(
        torch, cfg, params, "D", overlapped=True, extra=dict(staging_depth=8),
        label="D, overlapped + graphs, staging_depth 8")
    if streams["D+s8"] != streams["D"]:
        raise AssertionError("engine run D+s8: streams differ from run D's")
    log(f"engine run D+s8: peak memory {serving['D+s8']['peak_gib']:.2f} GiB at "
        f"staging_depth 8 (D+ at 16: {serving['D+']['peak_gib']:.2f} GiB, sync D "
        f"{serving['D']['peak_gib']:.2f} GiB); tok/s {serving['D+s8']['tokens_per_s']:.2f} "
        f"(D+ {serving['D+']['tokens_per_s']:.2f})")
    phase_continuous(torch, cfg, params, "S", by_run, streams, serving)
    for run, verify_bits in (("F", ()), ("G", (None,))):
        del params   # one model's weights at a time
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(cfg, recalkv=ReCalKVRuntime(**GROUP8[run]))
        params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
        backends[f"group_size 8, run {run}"] = phase_backends(torch, cfg, params,
                                                              verify_bits)
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    # the dense model: its prefill / decode / verify steps and paged steps
    # (K2, and the dense decode and verify kernels), runs H and I,
    # then run J: compress it, free it, serve the artifact
    del params
    torch.cuda.empty_cache()
    t_model = time.perf_counter()
    cfg = dataclasses.replace(get_config("qwen3-4b"), attn_backend="kernel",
                              dtype=torch.bfloat16)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    kernels.reset_launch_counts()
    backends["dense"] = phase_backends(torch, cfg, params, (None,))
    backends["dense paged"] = phase_paged_steps(torch, cfg, params, (None,))
    by_run["steps"] = launch_counts(kernels)
    for run in ("H", "I", "I9"):
        by_run[run], streams[run], serving[run] = phase_engine(torch, cfg, params, run)
    phase_overlapped(torch, cfg, params, "HI", by_run, streams, serving)
    phase_continuous(torch, cfg, params, "T", by_run, streams, serving)
    _no_old_route(by_run, ("steps", "H", "I", "I9", "H+", "I+", "T", "T+", "T+c"), "model")
    log("K1, K4, K5 and K7 (the old dense route) launched 0 times over the dense steps "
        "and runs H, I, I9, T and H, I, T overlapped")
    compression = phase_compress(torch, cfg, params)[0]
    del params   # the dense model goes; J boots from the saved artifact
    torch.cuda.empty_cache()
    by_run["J"], streams["J"], serving["J"] = phase_engine(torch, None, None, "J",
                                                           artifact=str(ARTIFACT))
    shutil.rmtree(ARTIFACT)
    log(f"dense model, runs H-J and the compression took "
        f"{time.perf_counter() - t_model:.1f} s")
    cli = phase_cli(torch)
    family_compression = phase_families(torch, by_run, streams, serving, backends)
    family_compression = {"gemma3-12b": family_compression,
                          "h2o-danube-1.8b": phase_danube(torch, by_run, streams, serving,
                                                          backends),
                          "qwen3-moe-235b-a22b": phase_qwen3_moe(torch, by_run, streams,
                                                                 serving, backends)}
    deepseek = phase_deepseek(torch, by_run, streams, serving, backends)
    cross = phase_cross(torch, by_run, streams, serving, backends)
    recurrent = phase_recurrent(torch, by_run, streams, serving, backends)
    train, rows = phase_train(torch, by_run, streams, serving)
    entries += rows
    family = ({run for runs in FAMILY_RUNS.values() for run in runs}
              | (set(MESH_RUNS) - set(MESH_BARE)))
    qwen_runs = [run for run in by_run if run not in family]
    for e in entries:
        key = e.get("launch_key", e["name"])
        e["launches_by_run"] = {run: by_run[run][key] for run in e.pop("runs", qwen_runs)}
        e["launches"] = sum(e["launches_by_run"].values())
    never = [e["name"] for e in entries if e["launches"] <= 0]
    if never:
        raise AssertionError(f"kernels never launched on the main path: {never}")
    log(json.dumps({"serving": serving, "backends": backends, "wide_ranks": wide_ranks,
                    "decode_bodies": decode_bodies, "f32_widths": f32_widths,
                    "compression": compression, "family_compression": family_compression,
                    "deepseek": deepseek, "cross": cross, "recurrent": recurrent,
                    "train": train, "mesh": mesh,
                    "cli": cli}))
    log(f"chip_smoke phases took {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
