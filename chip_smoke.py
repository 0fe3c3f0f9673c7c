#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port's serving path once on one NVIDIA card.

    python3 chip_smoke.py

Phases, in order (any failure exits non-zero; none is caught):

1. versions, and the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``src/repro_torch/csrc`` (one nvcc each,
   all at once) and print the build time;
3. each kernel at the main path's shapes against its plain PyTorch
   version, in float32 (TF32 off) and bf16, and timed beside the plain
   version, a PyTorch library call where one computes the same function,
   and the least time the card could take (its bound);
4. full-width qwen3-4b with a ReCalKV latent cache (recalkv_ratio 0.5,
   r = 256), bf16, random weights from a seeded torch.Generator: prefill
   and decode steps through the einsum reference and the kernel backend;
5. the same model served through ``Engine`` (8 slots, max_len 4096,
   sync_every 16, one chunked prompt) with the kernel launch counts of
   that run — the main path;
6. a ``{"kernels": [...]}`` line (per kernel: ``ms`` is the kernel's
   bf16 time, ``max_abs_err`` its bf16 error, ``max_err_f32`` its float32
   error), the card line, and the final ``{"ok": true, "device": {...}}``
   line.

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
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


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


def phase_k1(torch, gen):
    """K1 at B=8, a full 4096-token ring, G=2, r=256, s=4, dh=128 (+ self)."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.latent_decode import (
        latent_decode_attention as k1, latent_decode_attention_plain as p1)
    B, S, G, Hg, dh, r, s = 8, 4096, 2, 16, 128, 256, 4
    dev = "cuda"
    rn = lambda *sh: torch.randn(sh, generator=gen, device=dev)
    f = dict(q=rn(B, G, Hg, dh), zk=rn(B, S, G, r), zv=rn(B, S, G, r),
             r_k=rn(G, r, s * dh) * r ** -0.5, self_zk=rn(B, G, r),
             self_zv=rn(B, G, r))
    pos = torch.arange(S, device=dev).expand(B, S).contiguous()
    cur = torch.full((B,), S, device=dev)
    cos, sin = ops.rope_tables_for(pos, dh, 1e6)
    bias = ops.decode_bias(pos, cur, None)
    cs, ss = ops.rope_tables_for(cur, dh, 1e6)
    kn = 0.1 * rn(dh)
    res = {}
    for dt in (torch.float32, torch.bfloat16):
        t = {k: v.to(dt) for k, v in f.items()}
        args = (t["q"], t["zk"], t["zv"], t["r_k"], cos, sin, bias)
        kw = dict(scale=dh ** -0.5, k_norm=kn, self_zk=t["self_zk"],
                  self_zv=t["self_zv"], self_cos=cs, self_sin=ss)
        got = k1(*args, **kw)
        torch.cuda.synchronize()
        res[dt] = compare("K1", got, p1(*args, **kw), dt)
    ms = cuda_ms(lambda: k1(*args, **kw))
    plain_ms = cuda_ms(lambda: p1(*args, **kw), iters=3)
    s_ext = S + 1
    flops = 2.0 * B * G * s_ext * (r * s * dh + Hg * dh + Hg * r)
    b_ms, by = bound(nbytes(*args, kn, t["self_zk"], t["self_zv"], cs, ss, got), flops)
    log(f"K1 latent_decode B={B} S={S}+self G={G} r={r}: max err f32 {res[torch.float32]:.3e} "
        f"bf16 {res[torch.bfloat16]:.3e}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {b_ms:.4f} ms ({by})")
    return {"name": "latent_decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/latent_decode.cu",
            "replaces": "src/repro/kernels/latent_decode.py:177",
            "tpu_kernel": "src/repro/kernels/latent_decode.py::latent_decode_attention",
            "max_abs_err": res[torch.bfloat16], "max_err_f32": res[torch.float32],
            "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": by,
            "library_ms": None, "shape": f"B={B} S={S}+1 G={G} Hg={Hg} dh={dh} r={r} bf16"}


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
    greedy tokens fed to both), B=2 with prompts of 512 and 300 tokens."""
    from repro_torch.models import transformer as T
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    toks = torch.randint(0, cfg.vocab_size, (2, 512), generator=gen, device="cuda")
    lens = torch.tensor([512, 300], device="cuda")
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
        runs[backend] = torch.stack(outs)
        del caches
    ker, ref = runs["kernel"], runs["einsum"]
    if not torch.isfinite(ker).all():
        raise AssertionError("kernel-backend logits are not finite")
    err = (ker - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    agree = (ker.argmax(-1) == ref.argmax(-1)).float().mean().item()
    log(f"full-width backends: logits max abs err {err:.4e} (relative {rel:.3e}), "
        f"greedy agreement {agree:.3f} over {ker.shape[0]} positions x 2 rows")
    if rel > 5e-2:
        raise AssertionError(f"kernel backend logits differ from einsum by {rel:.3e} "
                             f"relative (bf16 bound 5e-2)")
    return {"logits_max_abs_err": err, "logits_rel_err": rel, "greedy_agreement": agree}


def phase_engine(torch, cfg, params):
    from repro_torch import kernels
    from repro_torch.serving import Engine, Request
    torch.cuda.reset_peak_memory_stats()
    eng = Engine(cfg, params, max_slots=8, max_len=4096, sync_every=16,
                 prefill_chunk=1792)
    lens = (512, 640, 768, 1024, 1280, 1536, 1792, 2048)
    gen = torch.Generator().manual_seed(SEED + 2)
    for uid, n in enumerate(lens):
        prompt = torch.randint(0, cfg.vocab_size, (n,), generator=gen).numpy()
        eng.submit(Request(uid=uid, prompt=prompt, max_new_tokens=32))
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels.KERNELS}
    m = eng.metrics()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    log(f"engine: {len(done)} requests, {m['tokens']} tokens in {wall:.3f} s, "
        f"{m['tokens_per_s']:.2f} tok/s, ttft {m['ttft_s']:.3f} s, windows "
        f"{m['windows']}, prefill calls {m['prefill_calls']}, peak memory "
        f"{peak:.2f} GiB, launches {launches}")
    if len(done) != len(lens) or any(len(r.out_tokens) != 32 for r in done):
        raise AssertionError("engine did not finish every request with 32 tokens")
    if any(not 0 <= t < cfg.vocab_size for r in done for t in r.out_tokens):
        raise AssertionError("engine emitted an out-of-vocabulary token")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")
    return launches, {**{k: m[k] for k in ("tokens", "tokens_per_s", "ttft_s", "windows",
                                           "prefill_calls", "run_seconds")},
                      "peak_gib": peak, "wall_s": wall}


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
    entries = [phase_k1(torch, gen), phase_k2(torch, gen)]
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
    launches, serving = phase_engine(torch, cfg, params)
    for e in entries:
        e["launches"] = launches[e["name"]]
    log(json.dumps({"serving": serving, "backends": backends}))
    print(json.dumps({"kernels": entries}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
