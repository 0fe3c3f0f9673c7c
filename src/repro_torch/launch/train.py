"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--smoke]`` (port of ``repro.launch.train``).

Wires config -> data -> train step -> fault-tolerant loop on one card
or a mesh (``--device cpu`` runs the plain path; ``--smoke`` takes the reduced
config in float32).  The batches come from ``data.synthetic``, whose
Markov table is V x V float64, so a full vocabulary (151,936 for
qwen3-4b) draws its tokens from the first DATA_VOCAB ids (a smoke
vocabulary, below it, is used whole, as the JAX CLI does); the model's
output vocabulary is its own.  A model with cross-attention layers reads the
JAX CLI's source, ``np.random.default_rng(0).normal(size=(batch,
cross_source_len, d_model))`` in the model dtype.

``--mesh DATA,MODEL`` trains on a mesh of that many ranks, one process a
rank under ``torchrun`` (rank and world size from its environment):
``torchrun --nproc-per-node N -m repro_torch.launch.train --mesh D,M``
with N = D * M, each rank on ``cuda:LOCAL_RANK`` over ``nccl``;
``--dist-backend gloo`` runs the collectives through the host (two ranks
may then share one card, ``--device cuda:0``).  The step is
``runtime.make_train_step(..., mesh=)``: the JAX launcher's ``--mesh``
step (FSDP over "data", heads and FFN width over "model").  Every rank
makes the same seeded batches and model; rank 0 prints and writes the
checkpoints.  A three-axis spec (JAX's "pod" axis) is refused: it needs
more than one host (ROADMAP.md Queue 1 item 5f).
"""

from __future__ import annotations

import argparse
import dataclasses
import os

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_config
from repro_torch.data import DataConfig, batch as data_batch
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import mesh_from_spec, parse_mesh_spec
from repro_torch.optim import AdamWConfig
from repro_torch.runtime import TrainConfig, make_train_step, train_loop

DATA_VOCAB = 4096
MESH_NO_POD = ("a three-axis mesh (the JAX launcher's \"pod\" axis) is not ported "
               "(ROADMAP.md Queue 1 item 5f): it spans more than one host; "
               "pass --mesh DATA,MODEL")


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
    ap.add_argument("--mesh", default=None, metavar="DATA,MODEL",
                    help="train on a (data, model) mesh, one rank a process "
                         "under torchrun (default: one device)")
    ap.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                    help="the mesh's collectives (default nccl on a card, "
                         "gloo on the CPU)")
    args = ap.parse_args(argv)

    if args.mesh and len(args.mesh.replace("x", ",").split(",")) == 3:
        raise ValueError(f"--mesh {args.mesh}: {MESH_NO_POD}")
    on_mesh = parse_mesh_spec(args.mesh) != (1, 1)
    device = args.device
    if on_mesh and device == "cuda" and (args.dist_backend or "nccl") == "nccl":
        device = f"cuda:{int(os.environ.get('LOCAL_RANK', 0))}"
    mesh = None
    if on_mesh:
        mesh = mesh_from_spec(args.mesh, backend=args.dist_backend or (
            "nccl" if resolve_device(device).type == "cuda" else "gloo"))
    dev = resolve_device(device)
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
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
                     step_fn=make_train_step(cfg, opt_cfg, tc, mesh=mesh), mesh=mesh,
                     logger=say)
    say(f"final loss: {out['losses'][-1]:.4f} (first: {out['losses'][0]:.4f})"
        + (f", mesh {mesh} ({mesh.backend})" if mesh is not None else ""))
    return out


if __name__ == "__main__":
    main()
