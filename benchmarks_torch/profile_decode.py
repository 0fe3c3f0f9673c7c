#!/usr/bin/env python3
"""Where a prefill and a decode step of the PyTorch / CUDA port spend
their time.

    python3 benchmarks_torch/profile_decode.py [--cache-quant-bits 8] [--spec-depth 3]
                                               [--page-size 16] [--dense] [--aot]
                                               [--src DIR] [--arch NAME]
                                               [--num-layers N]

Builds full-width qwen3-4b (or ``--arch``, at ``--num-layers`` of its
layers) with a ReCalKV latent cache (recalkv_ratio
0.5), bf16, random weights from seed 0, on one CUDA card, at the main
path's shape that chip_smoke.py also uses: 8 rows of 2048-token prompts in
a 4096-token ring.  It prefills them with the kernel backend twice (the
first call warms the libraries up) and then times 8 decode steps (host
clock around synchronised work).  The warm prefill and the decode steps are traced
with ``torch.profiler``: summed device time per kernel name and the
device's busy share of the traced wall time.  Prints one JSON line at the
end.  Needs a card; imports nothing of JAX.

``--cache-quant-bits 8`` serves the int8 latent ring (decode runs K3);
``--spec-depth N`` replaces each decode step by one speculative verify step
over N + 1 fed tokens with all of them committed (``verify_step`` plus
``commit_verify_writes``: K5, or K6 on the int8 ring).  ``--page-size N``
moves the prefilled rings into a paged pool of N-token pages (every slot
page mapped, in a shuffled order) and steps through the page table: K4 /
K7 on the float pool, the gathered view with K3 / K6 on the int8 pool.
``--dense`` serves the dense (uncompressed) model instead
(``recalkv=None``: K / V stored after RoPE, 4,096 bytes per token and
layer; decode runs the dense decode kernel, verify the dense verify kernel;
the int8 ring does not apply).
``--aot`` times the step twice in the same call: eagerly, and captured as
one CUDA graph (what ``Engine(aot=True)`` replays per window iteration:
state in static tensors, one graph launch a step); both feed the same
static draft columns, so they do the same work.  It reports wall, device
time, kernels and host launches a step for each.
``--src DIR`` imports the port from another tree's ``src`` (an older
commit unpacked with ``git archive``), so that two trees are profiled by
the same script in turns on one card.  ``--arch qwen3-moe-235b-a22b
--num-layers 8 --dense --aot`` profiles run Q's model of chip_smoke.py:
every trace then also splits the device time into the expert GEMMs (the
MoE FFN's ``torch.bmm`` calls), the MoE dispatch and combine (the rest of
``layers.moe_ffn``), attention (the port's kernels) and the rest; the
split by code range needs eager steps, so a replayed graph's trace splits
by kernel name only (attention, kernels named as GEMMs, the rest).
``--arch deepseek-v3-671b --num-layers 4 [--aot]`` profiles run DS's model
(its MLA cache: ReCalKV does not apply, so ``--dense`` is implied); its
attention is MLA's einsum readers, which launch no kernel of the port, so
the eager split counts the device time under ``mla_attention`` /
``kv_cache.decode_attn_mla`` / ``verify_attn_mla`` as attention.
``--arch falcon-mamba-7b`` (dense: ReCalKV does not apply) or
``--arch recurrentgemma-9b`` profiles the recurrent models; the eager
split then also counts the device time under ``layers.mamba_mixer`` /
``rglru_mixer`` (plain PyTorch, as in JAX) as the mixers'.
Every run also reports the weights' memory and the peak memory of the
first prefill above them (``torch.cuda.max_memory_allocated``).
Without flags it measures what it always did.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, PROMPT, MAX_LEN, STEPS = 8, 2048, 4096, 8


# Kernel names of the port's attention kernels and their merges, and of
# library GEMMs (cuBLAS / CUTLASS), for the split of a trace's device time.
ATTENTION = ("latent_decode", "dense_decode", "dense_verify", "flash_prefill", "merge")
GEMM_NAMES = ("gemm", "nvjet", "xmma", "cutlass")
# record_function ranges the MoE model's eager steps open (see moe_ranges),
# the MLA model's around its attention (see mla_ranges) and a recurrent
# model's around its mixers (see mixer_ranges)
EXPERT_RANGE, MOE_RANGE, MLA_RANGE = "expert_gemms", "moe_ffn", "mla_attention"
MIXER_RANGE = "recurrent_mixer"
RANGES = (EXPERT_RANGE, MOE_RANGE, MLA_RANGE, MIXER_RANGE)


def traced(fn, n: int):
    """Run ``fn`` n times under the profiler.  Returns (wall ms, device
    busy ms, [(device ms per call, launches per call, name)] sorted, the
    split of device ms per call)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows, ranges = [], {}
    # a range's device time: the kernels launched inside its CPU-side event
    # (the range's span on the device timeline would count the gaps)
    for e in prof.events():
        if e.name in RANGES and e.device_type.name == "CPU":
            ranges[e.name] = ranges.get(e.name, 0.0) + e.device_time_total / 1e3 / n
    for e in prof.key_averages():
        if e.device_type.name != "CUDA" or e.key in RANGES:
            continue                         # device kernels only, no ranges or aten:: ops
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            rows.append((us / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows)
    attention = (sum(ms for ms, _, k in rows if any(a in k for a in ATTENTION))
                 + ranges.get(MLA_RANGE, 0.0))
    split = {"attention_ms": attention}
    if MIXER_RANGE in ranges:   # the mixers' own GEMMs and glue, then the rest
        split.update(mixer_ms=ranges[MIXER_RANGE],
                     rest_ms=busy - attention - ranges[MIXER_RANGE])
    elif MOE_RANGE in ranges:
        experts = ranges.get(EXPERT_RANGE, 0.0)
        split.update(expert_gemms_ms=experts, moe_dispatch_combine_ms=ranges[MOE_RANGE] - experts,
                     rest_ms=busy - attention - ranges[MOE_RANGE])
    else:
        gemm = sum(ms for ms, _, k in rows
                   if any(g in k.lower() for g in GEMM_NAMES)
                   and not any(a in k for a in ATTENTION))
        split.update(gemm_named_ms=gemm, rest_ms=busy - attention - gemm)
    return wall, busy * n, rows, split


def report(title, n, wall, busy, rows, split):
    print(f"{title}: {n} traced, wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall:.3f} of wall), {sum(r[1] for r in rows):.0f} kernels per call")
    for ms, calls, key in rows[:12]:
        print(f"  {ms:12.4f} ms {calls:8.1f} x  {key[:96]}")
    per = busy / n
    print("  device ms per call by part: " + ", ".join(
        f"{k[:-3]} {v:.4f} ({v / per:.3f})" for k, v in split.items()))
    return {"wall_ms": wall / n, "device_busy_ms": per,
            "device_busy_share": busy / wall,
            "kernels_per_call": sum(r[1] for r in rows), "split_ms": split,
            "top": [{"kernel": k[:120], "ms": ms, "calls": c} for ms, c, k in rows[:8]]}


def moe_ranges(L):
    """Open the MoE ranges around ``layers.moe_ffn`` and its expert
    products (the ``torch.bmm`` calls it makes), so an eager trace can
    split the FFN's device time; a captured graph replays without them."""
    import torch
    from torch.profiler import record_function
    moe, bmm = L.moe_ffn, torch.bmm

    def ranged_bmm(*a, **kw):
        with record_function(EXPERT_RANGE):
            return bmm(*a, **kw)

    def ranged_moe(*a, **kw):
        with record_function(MOE_RANGE):
            torch.bmm = ranged_bmm
            try:
                return moe(*a, **kw)
            finally:
                torch.bmm = bmm

    L.moe_ffn = ranged_moe


def mla_ranges(L, KC):
    """Open the MLA range around its full-sequence attention and its
    absorbed decode and verify readers (no kernel of the port: their
    device time is einsums and elementwise glue)."""
    from torch.profiler import record_function

    def ranged(fn):
        def call(*a, **kw):
            with record_function(MLA_RANGE):
                return fn(*a, **kw)
        return call

    L.mla_attention = ranged(L.mla_attention)
    KC.decode_attn_mla = ranged(KC.decode_attn_mla)
    KC.verify_attn_mla = ranged(KC.verify_attn_mla)


def mixer_ranges(L):
    """Open the mixer range around ``layers.mamba_mixer`` and
    ``rglru_mixer`` (no kernel of the port: their projections, conv, scan
    and gates)."""
    from torch.profiler import record_function

    def ranged(fn):
        def call(*a, **kw):
            with record_function(MIXER_RANGE):
                return fn(*a, **kw)
        return call

    L.mamba_mixer = ranged(L.mamba_mixer)
    L.rglru_mixer = ranged(L.rglru_mixer)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--cache-quant-bits", type=int, default=None,
                    help="int8 latent ring (8); default: bf16 latents")
    ap.add_argument("--spec-depth", type=int, default=0,
                    help="time verify steps of spec_depth + 1 tokens instead "
                         "of decode steps")
    ap.add_argument("--page-size", type=int, default=None,
                    help="step over a paged pool of this page size; default: "
                         "the ring")
    ap.add_argument("--dense", action="store_true",
                    help="the dense model (recalkv=None) instead of the latent one")
    ap.add_argument("--aot", action="store_true",
                    help="also time the step captured as a CUDA graph, beside "
                         "the eager step")
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the tree whose src is profiled (default: this one's)")
    ap.add_argument("--arch", default="qwen3-4b",
                    help="the registered arch to profile at full width")
    ap.add_argument("--num-layers", type=int, default=None,
                    help="serve this many of the arch's layers (default: all)")
    args = ap.parse_args()
    if args.dense and args.cache_quant_bits:
        ap.error("--dense takes no --cache-quant-bits: the int8 cache is latent")
    import torch
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import RECALKV_APPLICABLE, get_config
    from repro_torch.models import kv_cache as KC
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import init_params
    from repro_torch.serving.engine import _merge_slot_paged

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    latent = not args.dense and RECALKV_APPLICABLE[args.arch]
    base = (get_config(args.arch, recalkv_ratio=0.5) if latent
            else get_config(args.arch))
    cfg = dataclasses.replace(base, attn_backend="kernel", dtype=torch.bfloat16,
                              cache_quant_bits=args.cache_quant_bits,
                              num_layers=args.num_layers or base.num_layers)
    if cfg.moe is not None:
        moe_ranges(L)
    if cfg.mla is not None:
        mla_ranges(L, KC)
    if cfg.mamba is not None or cfg.rglru is not None:
        mixer_ranges(L)
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    gen = torch.Generator(device="cuda").manual_seed(1)
    B = BATCH
    toks = torch.randint(0, cfg.vocab_size, (B, PROMPT), generator=gen,
                         device="cuda")
    lens = torch.full((B,), PROMPT, device="cuda")
    state = {}

    def prefill():
        state["logits"], state["caches"] = T.prefill(cfg, params, toks, lens,
                                                     MAX_LEN)

    torch.cuda.synchronize()
    weights_gib = torch.cuda.memory_allocated() / 2 ** 30
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
    print(f"card: {card}")
    kind = (f"r={cfg.recalkv.rank_k}" if latent
            else "mla" if cfg.mla is not None else "dense")
    print(f"{cfg.name} ({cfg.num_layers} layers) {kind} bf16, cache_quant_bits "
          f"{args.cache_quant_bits}, spec_depth {args.spec_depth}, page_size "
          f"{args.page_size}, B={B}, prompt {PROMPT}, ring {MAX_LEN}, src "
          f"{args.src}: first (cold) prefill {cold_s:.4f} s, weights "
          f"{weights_gib:.3f} GiB, its peak {peak_gib:.3f} GiB "
          f"(+{peak_gib - weights_gib:.3f})")
    out = {"card": card, "src": args.src, "arch": cfg.name, "num_layers": cfg.num_layers,
           "dense": not latent, "mla": cfg.mla is not None, "batch": B, "prompt": PROMPT,
           "max_len": MAX_LEN, "cache_quant_bits": args.cache_quant_bits,
           "spec_depth": args.spec_depth, "page_size": args.page_size,
           "cold_prefill_s": cold_s, "weights_gib": weights_gib,
           "prefill_peak_gib": peak_gib,
           "prefill": report("warm prefill", 1, *traced(prefill, 1))}
    tok, cur = state["logits"].argmax(-1), lens.clone()
    caches, pages = state.pop("caches"), None
    if args.page_size:
        ps = args.page_size
        n_sp = MAX_LEN // ps
        perm = torch.randperm(B * n_sp, generator=torch.Generator().manual_seed(3)) + 1
        ptab = perm.reshape(B, n_sp).to(device="cuda", dtype=torch.int32)
        pool = T.init_decode_cache(cfg, B, MAX_LEN, "cuda",
                                   pages=(B * n_sp + 1, ps))
        rows = torch.arange(B, device="cuda").repeat_interleave(n_sp)
        cols = torch.arange(n_sp, device="cuda").repeat(B)
        caches = _merge_slot_paged(pool, caches, rows, cols, ptab.reshape(-1).long(), ps)
        pages = (ptab, ps)
        torch.cuda.synchronize()

    n_fed = args.spec_depth + 1
    fed_gen = torch.Generator(device="cuda").manual_seed(2)

    def step():
        nonlocal tok, cur
        if not args.spec_depth:
            lg, _ = T.decode_step(cfg, params, caches, tok, cur, pages=pages)
            tok, cur = lg.argmax(-1), cur + 1
            return
        fed = torch.randint(0, cfg.vocab_size, (B, n_fed), generator=fed_gen,
                            device="cuda")
        fed[:, 0] = tok
        mask = torch.ones((B, n_fed), dtype=torch.bool, device="cuda")
        lg, upd = T.verify_step(cfg, params, caches, fed, cur, mask, pages=pages)
        T.commit_verify_writes(caches, upd, cur, mask, pages=pages)
        tok, cur = lg[:, -1].argmax(-1), cur + n_fed

    what = f"verify step ({n_fed} tokens)" if args.spec_depth else "decode step"
    if pages is not None:
        what += f", paged pool (page_size {args.page_size})"
    if args.aot:
        out.update(aot_steps(torch, T, cfg, params, caches, pages, tok, cur, n_fed, what))
        print(json.dumps(out))
        return 0
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    print(f"{what} {step_ms:.3f} ms (host clock, synchronised, untraced)")
    out["decode_step_ms"] = step_ms
    out["decode"] = report(what, STEPS, *traced(step, STEPS))
    print(json.dumps(out))
    return 0


def timed(torch, fn) -> float:
    """Host-clock ms per call of ``fn`` over STEPS synchronised calls."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / STEPS * 1e3


def aot_steps(torch, T, cfg, params, caches, pages, tok, cur, n_fed, what) -> dict:
    """The step eagerly and as a captured CUDA graph, in turns on one card:
    the token and position live in static tensors that the step updates in
    place, and a verify step feeds fixed random draft columns, so both
    versions do the same work."""
    B = tok.shape[0]
    s_tok, s_cur = tok.clone(), cur.clone()
    tail = torch.randint(0, cfg.vocab_size, (B, n_fed - 1),
                         generator=torch.Generator(device="cuda").manual_seed(2),
                         device="cuda")
    mask = torch.ones((B, n_fed), dtype=torch.bool, device="cuda")

    def body():
        if n_fed == 1:
            lg, _ = T.decode_step(cfg, params, caches, s_tok, s_cur, pages=pages)
            s_tok.copy_(lg.argmax(-1))
        else:
            fed = torch.cat([s_tok[:, None], tail], dim=1)
            lg, upd = T.verify_step(cfg, params, caches, fed, s_cur, mask, pages=pages)
            T.commit_verify_writes(caches, upd, s_cur, mask, pages=pages)
            s_tok.copy_(lg[:, -1].argmax(-1))
        s_cur.add_(n_fed)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            body()
    torch.cuda.current_stream().wait_stream(side)
    t0 = time.perf_counter()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        body()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    res = {"capture_s": capture_s}
    for name, fn in (("eager", body), ("graph", graph.replay),
                     ("graph again", graph.replay), ("eager again", body)):
        ms = timed(torch, fn)
        print(f"{what}, {name}: {ms:.3f} ms (host clock, synchronised, untraced)")
        rep_ = report(f"{what}, {name}", STEPS, *traced(fn, STEPS))
        rep_["step_ms"] = ms
        rep_["host_launches_per_call"] = 1 if name.startswith("graph") else rep_["kernels_per_call"]
        res[name] = rep_
    print(f"captured in {capture_s:.3f} s")
    return {"aot": res}


if __name__ == "__main__":
    sys.exit(main())
