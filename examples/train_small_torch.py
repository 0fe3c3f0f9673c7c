"""Train a small LM on the synthetic copy corpus with the PyTorch port,
with checkpoint / restart (the counterpart of ``examples/train_small.py``).

    PYTHONPATH=src python examples/train_small_torch.py --steps 300               # the card
    PYTHONPATH=src python examples/train_small_torch.py --steps 300 --device cpu

Exercises the port's training substrate: WSD / cosine schedules, gradient
accumulation, the watchdog, atomic async checkpoints in the JAX package's
layout (kill it mid-run and re-launch: it resumes from the last
checkpoint, and so does ``examples/train_small.py`` from the same
directory).  ``--dmodel 768 --layers 12`` reaches ~100M params; the
default is ~3M.
"""

import argparse

import torch

from repro_torch.data import DataConfig, batch as data_batch
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import leaves_in_jax_order
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, train_loop


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--dmodel", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--schedule", choices=["cosine", "wsd"], default="wsd")
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default="experiments/train_small_torch")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    cfg = ModelConfig(
        name="train-small", family="dense",
        num_layers=args.layers, d_model=args.dmodel, num_heads=args.heads,
        num_kv_heads=args.heads, d_head=args.dmodel // args.heads,
        d_ff=int(args.dmodel * 2.75), vocab_size=512, dtype=torch.float32,
        scan_layers=False, remat=False, attn_chunk=64)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, copy_frac=0.6)
    tc = TrainConfig(
        microbatches=args.microbatches, schedule=args.schedule,
        warmup_steps=max(args.steps // 10, 1), total_steps=args.steps,
        ckpt_dir=args.ckpt_dir, ckpt_every=100)
    dev = torch.device(args.device)

    def batch_fn(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in data_batch(dc, "train", step, args.batch).items()}

    out = train_loop(cfg, AdamWConfig(lr=args.lr), tc, batch_fn, device=dev)
    n = sum(t.numel() for _, ts, _ in leaves_in_jax_order(None, out["params"]) for t in ts)
    print(f"model: {n / 1e6:.1f}M params")
    if out["losses"]:
        print(f"loss: {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f} "
              f"over {len(out['losses'])} steps (ckpts in {args.ckpt_dir})")
    return out


if __name__ == "__main__":
    main()
