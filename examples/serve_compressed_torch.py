"""End to end on the PyTorch port: train -> calibrate -> compress -> save
-> load -> serve (the counterpart of ``examples/serve_compressed.py``).

    PYTHONPATH=src python examples/serve_compressed_torch.py --requests 12 --use-fisher
    PYTHONPATH=src python examples/serve_compressed_torch.py --device cpu --train-steps 60

A trained model goes through a registry strategy offline; with
``--use-fisher`` each layer's rank comes from its Fisher score (the
calibration batches carry labels, ``calibrate(..., fisher=True)``).  The
compressed model is saved as an artifact in the layout both packages
read, and an engine boots from it (``Engine.from_artifact``), as a
separate serving process would, beside the dense model's engine: cache
bytes, tokens/s and greedy agreement side by side.
"""

import argparse
import os
import time

import numpy as np
import torch

from repro_torch.api import (CompressionSpec, RankPolicy, calibrate, compress,
                             save_artifact)
from repro_torch.data import DataConfig, batch as data_batch, sequence
from repro_torch.models.config import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, train_loop
from repro_torch.serving import Engine, Request, SamplingParams


def build_model(steps: int, dev, ckpt_dir: str):
    cfg = ModelConfig(
        name="serve-demo", family="dense",
        num_layers=4, d_model=128, num_heads=8, num_kv_heads=8, d_head=16,
        d_ff=352, vocab_size=512, dtype=torch.float32, scan_layers=False,
        remat=False, attn_chunk=64)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128, copy_frac=0.6)

    def batch_fn(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in data_batch(dc, "train", step, 8).items()}

    out = train_loop(cfg, AdamWConfig(lr=3e-3),
                     TrainConfig(warmup_steps=max(steps // 10, 1), total_steps=steps,
                                 ckpt_dir=ckpt_dir, ckpt_every=100),
                     batch_fn, device=dev, logger=lambda *_: None)
    return cfg, out["params"], dc


def compress_offline(cfg, params, keep: float, method: str, use_fisher: bool):
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=128)
    batches = [data_batch(dc, "calib", s, 4) for s in range(4)]
    t0 = time.perf_counter()
    calib = calibrate(cfg, params, batches, fisher=use_fisher)
    spec = CompressionSpec(method, rank_policy=RankPolicy(keep_ratio=keep,
                                                          use_fisher=use_fisher))
    art = compress(cfg, params, spec, calib)
    return art, time.perf_counter() - t0


def serve_engine(eng, prompts, new_tokens):
    for i, p in enumerate(prompts):
        eng.submit(Request(uid=i, prompt=p, max_new_tokens=new_tokens))
    t0 = time.perf_counter()
    done = eng.run()
    dt = time.perf_counter() - t0
    toks = sum(len(r.out_tokens) for r in done)
    cache_bytes = sum(t.numel() * t.element_size() for c in eng.cache
                      for part in c.values() for t in part.values())
    return {"tok_s": toks / dt, "cache_mb": cache_bytes / 2**20,
            "outs": {r.uid: list(r.out_tokens) for r in done},
            "syncs_per_tok": eng.metrics()["host_syncs_per_token"]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=96)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--train-steps", type=int, default=200)
    ap.add_argument("--keep", type=float, default=0.5)
    ap.add_argument("--method", default="recalkv")
    ap.add_argument("--use-fisher", action="store_true",
                    help="per-layer ranks from Fisher scores (Algorithm 1 l.4-5)")
    ap.add_argument("--artifact-dir", default="experiments/serve_artifact_torch")
    ap.add_argument("--ckpt-dir", default="experiments/serve_demo_torch")
    ap.add_argument("--sync-every", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy (deterministic dense-vs-compressed agreement)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    print("[1/4] training the dense model ...")
    cfg, params, dc = build_model(args.train_steps, dev, args.ckpt_dir)
    print(f"[2/4] offline compression ({args.method!r}, Algorithm 1"
          f"{', Fisher ranks' if args.use_fisher else ''}) ...")
    artifact, seconds = compress_offline(cfg, params, args.keep, args.method,
                                         args.use_fisher)
    ranks = artifact.provenance["ranks_by_layer"]
    print(f"[3/4] persisting artifact to {args.artifact_dir} (ranks {ranks}; "
          f"calibrate + compress {seconds:.2f} s) ...")
    save_artifact(artifact, args.artifact_dir)

    g = np.random.default_rng(0)
    prompts = [np.asarray(sequence(dc, "valid", 50 + i)[:int(g.integers(8, 32))],
                          np.int32) for i in range(args.requests)]
    print("[4/4] serving", args.requests, "requests on both engines ...")
    kw = dict(max_slots=args.slots, max_len=args.max_len,
              sampling=SamplingParams(temperature=args.temperature),
              sync_every=args.sync_every, device=dev)
    dense = serve_engine(Engine(cfg, params, **kw), prompts, args.new_tokens)
    # the compressed engine boots from disk: nothing in memory crosses over
    comp = serve_engine(Engine.from_artifact(args.artifact_dir, **kw), prompts,
                        args.new_tokens)
    agree = float(np.mean([
        np.mean(np.asarray(dense["outs"][i]) == np.asarray(comp["outs"][i]))
        for i in range(args.requests)]))
    print(f"\ndense   : {dense['tok_s']:6.1f} tok/s  cache {dense['cache_mb']:.2f} MiB  "
          f"{dense['syncs_per_tok']:.3f} syncs/tok")
    print(f"{args.method:8s}: {comp['tok_s']:6.1f} tok/s  cache {comp['cache_mb']:.2f} MiB "
          f"({comp['cache_mb'] / dense['cache_mb']:.0%} of dense)  "
          f"{comp['syncs_per_tok']:.3f} syncs/tok")
    print(f"greedy agreement vs dense: {agree:.0%}")
    print(f"artifact on disk: {os.path.abspath(args.artifact_dir)}")
    return {"ranks": ranks, "agree": agree, "dense": dense, "compressed": comp}


if __name__ == "__main__":
    main()
