#!/usr/bin/env python3
"""Where a prefill and a decode step of the PyTorch / CUDA port spend
their time.

    python3 benchmarks_torch/profile_decode.py

Builds full-width qwen3-4b with a ReCalKV latent cache (recalkv_ratio
0.5), bf16, random weights from seed 0, on one CUDA card, at the main
path's shape that chip_smoke.py also uses: 8 rows of 2048-token prompts in
a 4096-token ring.  It prefills them with the kernel backend twice (the
first call warms the libraries up) and then times 8 decode steps (host
clock around synchronised work).  The warm prefill and the decode steps are traced
with ``torch.profiler``: summed device time per kernel name and the
device's busy share of the traced wall time.  Prints one JSON line at the
end.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, PROMPT, MAX_LEN, STEPS = 8, 2048, 4096, 8


def traced(fn, n: int):
    """Run ``fn`` n times under the profiler.  Returns (wall ms, device
    busy ms, [(device ms per call, launches per call, name)] sorted)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        if e.device_type.name != "CUDA":     # device kernels only, no aten:: ops
            continue
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            rows.append((us / 1e3 / n, e.count / n, e.key))
    rows.sort(reverse=True)
    return wall, sum(r[0] for r in rows) * n, rows


def report(title, n, wall, busy, rows):
    print(f"{title}: {n} traced, wall {wall:.3f} ms, device busy {busy:.3f} ms "
          f"({busy / wall:.3f} of wall), {sum(r[1] for r in rows):.0f} kernels per call")
    for ms, calls, key in rows[:12]:
        print(f"  {ms:12.4f} ms {calls:8.1f} x  {key[:96]}")
    return {"wall_ms": wall / n, "device_busy_ms": busy / n,
            "device_busy_share": busy / wall,
            "kernels_per_call": sum(r[1] for r in rows),
            "top": [{"kernel": k[:120], "ms": ms, "calls": c} for ms, c, k in rows[:8]]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_decode: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.weights import init_params

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = dataclasses.replace(get_config("qwen3-4b", recalkv_ratio=0.5),
                              attn_backend="kernel", dtype=torch.bfloat16)
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
    t0 = time.perf_counter()
    prefill()
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    print(f"card: {card}")
    print(f"qwen3-4b r={cfg.recalkv.rank_k} bf16, B={B}, prompt {PROMPT}, "
          f"ring {MAX_LEN}: first (cold) prefill {cold_s:.4f} s")
    out = {"card": card, "batch": B, "prompt": PROMPT,
           "max_len": MAX_LEN, "cold_prefill_s": cold_s,
           "prefill": report("warm prefill", 1, *traced(prefill, 1))}
    tok, cur = state["logits"].argmax(-1), lens.clone()
    caches = state["caches"]

    def step():
        nonlocal tok, cur
        lg, _ = T.decode_step(cfg, params, caches, tok, cur)
        tok, cur = lg.argmax(-1), cur + 1

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        step()
    torch.cuda.synchronize()
    step_ms = (time.perf_counter() - t0) / STEPS * 1e3
    print(f"decode step {step_ms:.3f} ms (host clock, synchronised, untraced)")
    out["decode_step_ms"] = step_ms
    out["decode"] = report("decode step", STEPS, *traced(step, STEPS))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
