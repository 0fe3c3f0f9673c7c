"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke]`` (port of ``repro.launch.train``).

Wires config -> data -> train step -> fault-tolerant loop on one card
(``--device cpu`` runs the plain path; ``--smoke`` takes the reduced
config in float32).  The batches come from ``data.synthetic``, whose
Markov table is V x V float64, so a full vocabulary (151,936 for
qwen3-4b) draws its tokens from the first DATA_VOCAB ids (a smoke
vocabulary, below it, is used whole, as the JAX CLI does); the model's
output vocabulary is its own.  A model with cross-attention layers reads the
JAX CLI's source, ``np.random.default_rng(0).normal(size=(batch,
cross_source_len, d_model))`` in the model dtype.  ``--mesh`` (data
parallelism over several cards) is not ported yet (ROADMAP.md Queue 1
item 5a; the serving CLI takes a mesh).
"""

from __future__ import annotations

import argparse
import dataclasses

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, batch as data_batch
from repro_torch.device import resolve_device
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, make_train_step, train_loop

DATA_VOCAB = 4096
MESH_NOT_PORTED = ("multi-GPU training is not ported yet (ROADMAP.md, Queue 1 item 5a); "
                   "the port trains on one card")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCHS)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="cosine")
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--mesh", default=None, help="not ported (one card)")
    args = ap.parse_args(argv)
    if args.mesh:
        raise NotImplementedError(MESH_NOT_PORTED)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch, smoke=args.smoke)
    if args.smoke:
        cfg = dataclasses.replace(cfg, dtype=torch.float32)
    # MiniCPM ships with WSD: honour it by default for that arch
    schedule = "wsd" if args.arch == "minicpm-2b" else args.schedule
    tc = TrainConfig(
        microbatches=args.microbatches, schedule=schedule,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
        grad_compress=args.grad_compress, ckpt_dir=args.ckpt_dir)
    opt_cfg = AdamWConfig(lr=args.lr)

    dc = DataConfig(vocab_size=min(cfg.vocab_size, DATA_VOCAB), seq_len=args.seq)
    src = None
    if cfg.cross_source_len:
        src = torch.as_tensor(np.random.default_rng(0).normal(
            size=(args.batch, cfg.cross_source_len, cfg.d_model)), device=dev).to(cfg.dtype)

    def batch_fn(step):
        out = {k: torch.as_tensor(v, device=dev)
               for k, v in data_batch(dc, "train", step, args.batch).items()}
        if src is not None:
            out["source"] = src
        return out

    out = train_loop(cfg, opt_cfg, tc, batch_fn, device=dev,
                     step_fn=make_train_step(cfg, opt_cfg, tc))
    print(f"final loss: {out['losses'][-1]:.4f} (first: {out['losses'][0]:.4f})")
    return out


if __name__ == "__main__":
    main()
