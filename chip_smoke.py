#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; none is caught):

1. versions, and the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
   all at once) and print the build time;
3. each kernel — K1, K2, K3 (int8 decode), K5 (multi-query verify), K6
   (int8 multi-query verify) — at the main path's shapes against its
   plain PyTorch version, in float32 (TF32 off) and bf16, and timed
   beside the plain version, a PyTorch library call where one computes
   the same function, and the least time the card could take (its bound);
4. full-width qwen3-4b with a ReCalKV latent cache (recalkv_ratio 0.5,
   r = 256), bf16, random weights from a seeded torch.Generator: prefill
   and decode steps, and prefill and one 4-token verify step on float and
   int8 rings, through the einsum reference and the kernel backend;
5. the same model served through ``Engine`` (8 slots, max_len 4096) in
   three runs, each with the kernel launch counts of that run:
   A, float ring, no speculation, one chunked prompt (K1, K2);
   B, the slice's main path: int8 ring, spec_depth 3, draft "layers:4",
   one chunked prompt (K2, K3 in the draft's decode steps, K6 in verify);
   C, float ring, spec_depth 3, "ngram" draft on prompts that repeat a
   motif (K2, K5);
6. a ``{"kernels": [...]}`` line (per kernel: ``ms`` is the kernel's
   bf16 time, ``max_abs_err`` its bf16 error, ``max_err_f32`` its float32
   error, ``launches`` its launches over runs A-C), the card line, and the
   final ``{"ok": true, "device": {...}}`` line.

It needs a CUDA card and the repository's ``src``; it imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
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


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def nbytes(*ts) -> int:
    """Bytes of the tensors among ``ts`` (other arguments are skipped)."""
    return sum(t.numel() * t.element_size() for t in ts if hasattr(t, "numel"))


def bound(bytes_: int, flops: float) -> tuple[float, str]:
    tb, tf = bytes_ / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(tb, tf) * 1e3, ("bytes" if tb >= tf else "operations")


def compare(name, got, want, dtype) -> float:
    """Max |got - want|, after checking it against the tolerance above."""
    import torch
    got, want = got.float(), want.float()
    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: kernel output is not finite")
    diff = (got - want).abs()
    rms = want.square().mean().sqrt().item()
    if dtype == torch.float32:
        limit = torch.full_like(want, F32_TOL)
    else:
        limit = BF16_REL * want.abs() + BF16_RMS * rms
    worst = (diff / limit).max().item()
    log(f"{name} {dtype}: max abs err {diff.max().item():.3e}, output rms {rms:.3e} "
        f"max {want.abs().max().item():.3e}, worst err / limit {worst:.3f}")
    if worst > 1:
        raise AssertionError(f"{name}: kernel disagrees with its plain version in "
                             f"{dtype} (worst err / limit {worst:.3f})")
    return diff.max().item()


def ring_inputs(torch, gen, nq=1):
    """Main-path operands: B=8, a full 4096-token ring, G=2, Hg=16, dh=128,
    r=256, s=4, with nq queries and their nq self columns (float32)."""
    from repro_torch.kernels import ops
    B, S, G, Hg, dh, r, s = 8, 4096, 2, 16, 128, 256, 4
    dev = "cuda"
    rn = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    pos = torch.arange(S, device=dev).expand(B, S).contiguous()
    cur = torch.full((B,), S, device=dev)
    pos_q = cur[:, None] + torch.arange(nq, device=dev)
    feed = torch.ones((B, nq), dtype=torch.bool, device=dev)
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    cs, ss = ops.rope_tables_for(pos_q, dh, 1e6)
    bias = ops.verify_bias(torch.cat([pos, pos_q], 1), pos_q, feed, None, S)
    return dict(q=rn(B, G, nq * Hg, dh), zk=rn(B, S, G, r), zv=rn(B, S, G, r),
                r_k=rn(G, r, s * dh) * r ** -0.5, self_zk=rn(B, nq, G, r),
                self_zv=rn(B, nq, G, r), cos=cos, sin=sin, self_cos=cs, self_sin=ss,
                bias=bias, k_norm=0.1 * rn(dh), shape=(B, S, G, Hg, dh, r, s, nq))


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


def decode_flops(B, S_ext, G, Hg, dh, r, s, nq):
    """Key reconstruction once per column, then nq*Hg rows of scores and
    latent values per column."""
    return 2.0 * B * G * S_ext * (r * s * dh + nq * Hg * (dh + r))


def phase_latent(torch, gen, nq, quant):
    """K1 (nq=1, float), K3 (nq=1, int8), K5 (nq=4, float), K6 (nq=4,
    int8) at the main path's shapes; the self columns ride as operands."""
    from repro_torch.kernels import latent_decode as K1
    from repro_torch.kernels import latent_decode_q as KQ
    from repro_torch.quant import quantize
    a = ring_inputs(torch, gen, nq)
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
    where = {"latent_decode_attention": ("latent_decode.py", 177, "latent_decode"),
             "latent_decode_attention_quant": ("latent_decode_q.py", 69, "latent_decode"),
             "latent_decode_attention_mq": ("latent_decode.py", 338, "latent_decode"),
             "latent_decode_attention_mq_quant": ("latent_decode_q.py", 158,
                                                  "latent_decode")}[fn]
    meta = {"name": fn, "source": f"src/repro_torch/csrc/{where[2]}.cu",
            "replaces": f"src/repro/kernels/{where[0]}:{where[1]}",
            "tpu_kernel": f"src/repro/kernels/{where[0]}::{fn}",
            "shape": (f"B={B} S={S}+{nq} G={G} Hg={Hg} nq={nq} dh={dh} r={r} "
                      f"{'int8 latents, ' if quant else ''}bf16")}
    return kernel_phase(torch, fn, getattr(mod, fn), getattr(mod, fn + "_plain"), make,
                        decode_flops(B, S + nq, G, Hg, dh, r, s, nq), meta)


def phase_k2(torch, gen):
    """K2 at B=8, T=2048, H=32, Hkv=8, latent values Hv=2, dv=256, causal."""
    from repro_torch.kernels.flash_prefill import (
        flash_prefill_attention as k2, flash_prefill_attention_plain as p2)
    B, T, H, Hkv, Hv, dh, dv = 8, 2048, 32, 8, 2, 128, 256
    rn = lambda *sh: torch.randn(sh, generator=gen, device="cuda")
    f = (rn(B, T, H, dh), rn(B, T, Hkv, dh), rn(B, T, Hv, dv))
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        q, k, v = (x.to(dt) for x in f)
        got = k2(q, k, v)
        torch.cuda.synchronize()
        res[dt] = compare("K2", got, p2(q, k, v), dt)
    ms = cuda_ms(lambda: k2(q, k, v), iters=5)
    plain_ms = cuda_ms(lambda: p2(q, k, v), iters=2, warmup=1)
    # yardstick: one SDPA call on the same function (values repeated to
    # the kv heads outside the timed region); the port never calls it
    vr = v.repeat_interleave(Hkv // Hv, dim=2).transpose(1, 2)
    qt, kt = q.transpose(1, 2), k.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(lambda: sdpa(qt, kt, vr, is_causal=True, enable_gqa=True),
                         iters=5)
    flops = 2.0 * B * H * (T * (T + 1) / 2) * (dh + dv)
    b_ms, by = bound(nbytes(q, k, v, got), flops)
    log(f"K2 flash_prefill B={B} T={T} H={H} Hkv={Hkv} Hv={Hv} dv={dv}: max err f32 "
        f"{res[torch.float32]:.3e} bf16 {res[torch.bfloat16]:.3e}; kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {b_ms:.4f} ms ({by})")
    return {"name": "flash_prefill_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_prefill.cu",
            "replaces": "src/repro/kernels/flash_prefill.py:80",
            "tpu_kernel": "src/repro/kernels/flash_prefill.py::flash_prefill_attention",
            "max_abs_err": res[torch.bfloat16], "max_err_f32": res[torch.float32],
            "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": library_ms,
            "shape": f"B={B} T={T} H={H} Hkv={Hkv} Hv={Hv} dh={dh} dv={dv} causal bf16"}


def phase_backends(torch, cfg, params):
    """Prefill + 4 decode steps through both backends (kernel-backend
    greedy tokens fed to both), B=2 with prompts of 512 and 300 tokens;
    then, on float and int8 rings, prefill + one 4-token verify step."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    lens = torch.tensor([512, 300], device="cuda")
    fed = torch.randint(0, cfg.vocab_size, (2, 4), generator=gen, device="cuda")
    mask = torch.ones((2, 4), dtype=torch.bool, device="cuda")
    runs = {}
    feed = None
    for backend in ("kernel", "einsum"):
        c = dataclasses.replace(cfg, attn_backend=backend)
        logits, caches = T.prefill(c, params, toks, lens, 1024)
        outs, cur = [logits], lens.clone()
        for i in range(4):
            tok = logits.argmax(-1) if feed is None else feed[i]
            logits, caches = T.decode_step(c, params, caches, tok, cur)
            outs.append(logits)
            cur = cur + 1
        if feed is None:
            feed = [o.argmax(-1) for o in outs[:-1]]
        runs[("decode", backend)] = torch.stack(outs)
        for bits in (None, 8):
            cb = dataclasses.replace(c, cache_quant_bits=bits)
            _, caches = T.prefill(cb, params, toks, lens, 1024)
            runs[(f"verify {'int8' if bits else 'float'}", backend)], _ = T.verify_step(
                cb, params, caches, fed, lens, mask)
        del caches
    out = {}
    for what in ("decode", "verify float", "verify int8"):
        ker, ref = runs[(what, "kernel")], runs[(what, "einsum")]
        if not torch.isfinite(ker).all():
            raise AssertionError(f"kernel-backend {what} logits are not finite")
        err = (ker - ref).abs().max().item()
        rel = err / ref.abs().max().item()
        agree = (ker.argmax(-1) == ref.argmax(-1)).float().mean().item()
        log(f"full-width backends, {what}: logits max abs err {err:.4e} (relative "
            f"{rel:.3e}), greedy agreement {agree:.3f} over {ker[..., 0].numel()} rows")
        if rel > 5e-2:
            raise AssertionError(f"kernel backend {what} logits differ from einsum by "
                                 f"{rel:.3e} relative (bf16 bound 5e-2)")
        out[what] = {"logits_max_abs_err": err, "logits_rel_err": rel,
                     "greedy_agreement": agree}
    return out


# run: (cache_quant_bits, spec_depth, draft, prefill_chunk, sync_every,
#       kernels that must launch)
ENGINE_RUNS = {
    "A": (None, 0, None, 1792, 16,
          ("latent_decode_attention", "flash_prefill_attention")),
    "B": (8, 3, "layers:4", 960, 8,
          ("flash_prefill_attention", "latent_decode_attention_quant",
           "latent_decode_attention_mq_quant")),
    "C": (None, 3, "ngram", None, 8,
          ("flash_prefill_attention", "latent_decode_attention_mq")),
}


def engine_prompts(torch, run, vocab):
    gen = torch.Generator().manual_seed(SEED + 2)
    rand = lambda n: torch.randint(0, vocab, (n,), generator=gen).numpy()
    if run == "A":          # 512..2048; the 2048 one streams 256 tokens
        return [(rand(n), 32) for n in (512, 640, 768, 1024, 1280, 1536, 1792, 2048)]
    if run == "B":          # 512..1024; the 1024 one streams 64 tokens
        return [(rand(n), 32) for n in (512, 576, 640, 704, 768, 832, 896, 1024)]
    motif = rand(64)        # C: a motif repeated, for prompt lookup
    return [(np.tile(motif, 8), 16), (np.tile(motif, 6)[:320], 16)]


def phase_engine(torch, cfg, params, run):
    from repro_torch import kernels
    from repro_torch.serving import Engine, Request
    bits, depth, draft, chunk, sync, must = ENGINE_RUNS[run]
    c = dataclasses.replace(cfg, cache_quant_bits=bits)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(c, params, max_slots=8, max_len=4096, sync_every=sync,
                 prefill_chunk=chunk, spec_depth=depth, draft=draft)
    reqs = engine_prompts(torch, run, cfg.vocab_size)
    for uid, (prompt, n_new) in enumerate(reqs):
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=n_new))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    m = eng.metrics()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"engine run {run} (int8 ring: {bits is not None}, spec_depth {depth}, draft "
        f"{draft}): {len(done)} requests, {m['tokens']} tokens in {wall:.3f} s, "
        f"{m['tokens_per_s']:.2f} tok/s, ttft {m['ttft_s']:.3f} s, windows "
        f"{m['windows']}, accept rate {m['accept_rate']:.3f} ({m['draft_accepted']}/"
        f"{m['draft_proposed']}), prefill calls {m['prefill_calls']}, peak memory "
        f"{peak:.2f} GiB, launches {launches}")
    if len(done) != len(reqs) or any(len(r.out_tokens) != n for r, (_, n) in
                                     zip(sorted(done, key=lambda r: r.uid), reqs)):
        raise AssertionError(f"engine run {run} did not finish every request")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError(f"engine run {run} emitted an out-of-vocabulary token")
    missing = [k for k in must if launches[k] <= 0]
    if missing:
        raise AssertionError(f"engine run {run}: kernels of its path never launched: "
                             f"{missing} ({launches})")
    return launches, {**{k: m[k] for k in ("tokens", "tokens_per_s", "ttft_s", "windows",
                                           "prefill_calls", "run_seconds", "spec_depth",
                                           "draft", "draft_proposed", "draft_accepted",
                                           "accept_rate")},
                      "cache_quant_bits": bits, "peak_gib": peak, "wall_s": wall}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
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

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    entries = [phase_latent(torch, gen, 1, False), phase_k2(torch, gen),
               phase_latent(torch, gen, 1, True), phase_latent(torch, gen, 4, False),
               phase_latent(torch, gen, 4, True)]
    torch.cuda.empty_cache()

    cfg = get_config("qwen3-4b", recalkv_ratio=0.5)
    cfg = dataclasses.replace(cfg, attn_backend="kernel", dtype=torch.bfloat16)
    t0 = time.perf_counter()
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(t.numel() for layer in params["layers"] for d in layer.values()
                   for t in (d.values() if isinstance(d, dict) else [d])) \
        + params["embed"].numel()
    log(f"model {cfg.name} recalkv r={cfg.recalkv.rank_k} G="
        f"{cfg.recalkv.num_groups(cfg.num_kv_heads)}: {n_params / 1e9:.3f} B params "
        f"initialised in {time.perf_counter() - t0:.2f} s")
    backends = phase_backends(torch, cfg, params)
    serving, by_run = {}, {}
    for run in ENGINE_RUNS:
        by_run[run], serving[run] = phase_engine(torch, cfg, params, run)
    for e in entries:
        e["launches_by_run"] = {run: by_run[run][e["name"]] for run in by_run}
        e["launches"] = sum(e["launches_by_run"].values())
    never = [e["name"] for e in entries if e["launches"] <= 0]
    if never:
        raise AssertionError(f"kernels never launched on the engine runs: {never}")
    log(json.dumps({"serving": serving, "backends": backends}))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
