#!/usr/bin/env python3
"""Where the overlapped engine makes the host wait for the card.

    python3 benchmarks_torch/sync_sites.py [--src DIR]

Serves a small bf16 model (smoke qwen3-4b at d_head 64, a ReCalKV latent
cache of rank 64, random weights from seed 0) with ``overlap=True`` on one
CUDA card, eagerly and with ``aot=True``, on the ring, on a lazy paged pool
small enough to preempt (prefix-affinity, one pinned page, 12 requests
sharing a 64-token system prompt), with n-gram speculation, and with
continuous batching (``continuous=True``) on the ring and on a paged pool
with speculation.  Each run
is served under ``torch.cuda.set_sync_debug_mode("warn")``, which warns at
every operation that waits for the device; the script counts the
warnings by their call sites in ``repro_torch`` and prints them with the
run's ``window_overlap``.  The harvest's wait for the trailing window
(an event) is the intended one and is not a synchronising operation in
this sense; a preemption's read of the victim's row is the other intended
wait.  Needs a card; imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import sys
import traceback
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

RUNS = {
    "ring": {},
    "paged, lazy, prefix-affinity": dict(cache_layout="paged", page_size=16, n_pages=40,
                                         policy="prefix-affinity", lazy_pages=True,
                                         pin_prefixes=1),
    "ring, ngram spec_depth 3": dict(spec_depth=3, draft="ngram"),
    "ring, continuous": dict(continuous=True, pipeline_depth=3),
    "paged, continuous, ngram spec_depth 3": dict(cache_layout="paged", page_size=16,
                                                  continuous=True, pipeline_depth=3,
                                                  spec_depth=3, draft="ngram"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("sync_sites: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.src).resolve()))
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.models.config import ReCalKVRuntime
    from repro_torch.models.weights import init_params
    from repro_torch.serving import Engine, Request

    build.build_all()
    cfg = dataclasses.replace(get_config("qwen3-4b", smoke=True), d_head=64,
                              dtype=torch.bfloat16, attn_backend="kernel",
                              recalkv=ReCalKVRuntime(rank_k=64, rank_v=64, group_size=2))
    params = init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    g = np.random.default_rng(0)
    system = g.integers(0, cfg.vocab_size, 64)
    prompts = [np.concatenate([system, g.integers(0, cfg.vocab_size, 20 + 7 * i)])
               for i in range(12)]
    sites = collections.Counter()

    def record(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        stack = [f for f in traceback.extract_stack()[:-1] if "repro_torch" in f.filename]
        where = " <- ".join(f"{f.filename.split('repro_torch/')[-1]}:{f.lineno} {f.name}"
                            for f in stack[-3:][::-1])
        sites[where] += 1

    for name, kw in RUNS.items():
        for aot in (False, True):
            eng = Engine(cfg, params, max_slots=4, max_len=256, sync_every=8, overlap=True,
                         aot=aot, **kw)
            for i, p in enumerate(prompts):
                eng.submit(Request(uid=i, prompt=p, max_new_tokens=48))
            sites.clear()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = record
                torch.cuda.set_sync_debug_mode("warn")
                try:
                    eng.run()
                finally:
                    torch.cuda.set_sync_debug_mode(0)
            eng.close()
            m = eng.metrics()
            print(f"{name}, aot={aot}: {m['windows']} windows, window_overlap "
                  f"{m['window_overlap']:.3f}, preemptions {m['preemptions']}, "
                  f"slot_swaps {m['slot_swaps']}, tokens "
                  f"{m['tokens']}, {sum(sites.values())} synchronising calls")
            for where, n in sites.most_common(8):
                print(f"  {n:5d}  {where or '(outside repro_torch)'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
