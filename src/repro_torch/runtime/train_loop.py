"""Training runtime: the train step with microbatch accumulation, and a
fault-tolerant loop (port of ``repro.runtime.train_loop``).

``make_train_step`` builds the step:

    microbatches     -> float32 gradient accumulation over ``k`` slices of
                        the batch (``k == 1``: the gradients stay in the
                        params' dtype, as they come)
    error feedback   -> optional int8 gradient compression
                        (``optim.grad_compress``)
    AdamW            -> bf16-moment option, updated in place
    schedule         -> cosine / WSD scale from the step counter

``train_loop`` adds checkpoints (atomic, async, in the JAX package's
layout, so either package resumes the other's), restart from the latest,
a per-step watchdog deadline and a NaN guard.

The forward is the einsum path (``transformer.loss_fn``), as the JAX
package trains; no kernel of ``repro_torch.kernels`` launches.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import (init_params, leaves_in_jax_order, map_tree,
                                        opt_state_from_jax, opt_state_to_jax,
                                        params_from_jax, params_to_jax)
from repro_torch.optim import AdamWConfig, apply_updates, init_state, with_error_feedback
from repro_torch.optim.adamw import zeros_like_tree
from repro_torch.optim.schedule import SCHEDULES
from repro_torch.runtime.watchdog import Watchdog


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    schedule: str = "cosine"
    warmup_steps: int = 100
    total_steps: int = 1000
    grad_compress: bool = False       # int8 + error feedback on the grads
    ckpt_dir: str | None = None
    ckpt_every: int = 200
    keep_last: int = 3
    step_deadline_s: float = 600.0    # watchdog: hang / straggler detection


def _slice(batch: dict, i: int, k: int) -> dict:
    """Microbatch ``i`` of ``k``: rows i * B/k .. (i + 1) * B/k of every
    entry (the JAX package's reshape to (k, B/k, ...))."""
    out = {}
    for name, v in batch.items():
        n = v.shape[0] // k
        out[name] = v[i * n:(i + 1) * n]
    return out


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, tc: TrainConfig):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating both in place.  ``opt_state`` carries {mu, nu,
    step[, residual]}; batch: "tokens" / "labels" (B, T) [+ "source"],
    numpy or tensors, B a multiple of ``tc.microbatches``.  The metrics
    ("loss", "grad_norm", "lr") are 0-d float32 tensors on the device."""
    sched = SCHEDULES[tc.schedule]

    def grads_of(params, leaves, mb):
        loss, _ = T.loss_fn(cfg, params, mb)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for t, g in zip(leaves, gs, strict=True)]

    def train_step(params, opt_state, batch):
        k = tc.microbatches
        leaves = [t for _, ts, _ in leaves_in_jax_order(None, params) for t in ts]
        for t in leaves:
            t.requires_grad_(True)
        try:
            if k == 1:
                loss, gs = grads_of(params, leaves, batch)
            else:
                loss, gs = None, None
                for i in range(k):
                    loss_i, g_i = grads_of(params, leaves, _slice(batch, i, k))
                    if gs is None:
                        loss = torch.zeros_like(loss_i, dtype=torch.float32) + loss_i
                        gs = [g.float() for g in g_i]
                    else:
                        loss = loss + loss_i
                        for a, g in zip(gs, g_i, strict=True):
                            a.add_(g.float())
                    del g_i
                gs = [g / k for g in gs]
                loss = loss / k
        finally:
            for t in leaves:
                t.requires_grad_(False)
        by_id = {id(t): g for t, g in zip(leaves, gs, strict=True)}
        grads = map_tree(params, lambda t: by_id[id(t)])
        del gs, by_id
        residual = opt_state.get("residual")
        if tc.grad_compress:
            grads, residual = with_error_feedback(grads, residual, model=cfg)
        lr_scale = sched(opt_state["step"], warmup=tc.warmup_steps,
                         total=tc.total_steps)
        params, new_opt, metrics = apply_updates(params, grads, opt_state, opt_cfg,
                                                 lr_scale, model=cfg)
        if tc.grad_compress:
            new_opt["residual"] = residual
        metrics["loss"] = loss
        return params, new_opt, metrics

    return train_step


def init_train_state(cfg: ModelConfig, opt_cfg: AdamWConfig, tc: TrainConfig,
                     generator: torch.Generator | None = None, device=None):
    """Random params (``init_params`` from ``generator``, default seed 0 on
    ``device``) and a fresh optimizer state (+ a float32 zero residual with
    ``tc.grad_compress``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    params = init_params(cfg, generator, device=dev)
    opt_state = init_state(params, opt_cfg)
    if tc.grad_compress:
        opt_state["residual"] = zeros_like_tree(params, torch.float32)
    return params, opt_state


def save_state(cfg: ModelConfig, directory: str, step: int, params, opt_state, *,
               keep_last: int = 3, async_: bool = False):
    """Checkpoint {"params", "opt"} in the JAX package's layout for
    ``cfg`` (what ``repro.runtime.train_loop`` writes and restores)."""
    tree = {"params": params_to_jax(cfg, params), "opt": opt_state_to_jax(cfg, opt_state)}
    return ckpt_lib.save(directory, step, tree, keep_last=keep_last, async_=async_)


def restore_state(cfg: ModelConfig, directory: str, step: int, params, opt_state):
    """The inverse of :func:`save_state`, shaped and typed as ``params`` /
    ``opt_state`` (a checkpoint written by either package), on their
    device."""
    dev = params["embed"].device
    target = {"params": params_to_jax(cfg, params), "opt": opt_state_to_jax(cfg, opt_state)}
    state = ckpt_lib.restore(directory, step, target)
    return (params_from_jax(cfg, state["params"], device=dev),
            opt_state_from_jax(cfg, state["opt"], device=dev))


def train_loop(cfg: ModelConfig, opt_cfg: AdamWConfig, tc: TrainConfig,
               batch_fn: Callable[[int], dict], *, generator=None, device=None,
               step_fn=None, params=None, opt_state=None, log_every: int = 50,
               logger=print) -> dict[str, Any]:
    """Run to ``tc.total_steps`` with checkpoint / restart + watchdog.
    ``batch_fn(step)`` supplies the global batch (a stateless pipeline:
    a restart replays the counter).  Returns {"params", "opt_state",
    "losses"}."""
    if params is None:
        params, opt_state = init_train_state(cfg, opt_cfg, tc, generator, device)
    step_fn = step_fn or make_train_step(cfg, opt_cfg, tc)

    start = 0
    if tc.ckpt_dir:
        latest = ckpt_lib.latest_step(tc.ckpt_dir)
        if latest is not None:
            params, opt_state = restore_state(cfg, tc.ckpt_dir, latest, params,
                                              opt_state)
            start = latest
            logger(f"[train] restored step {latest} from {tc.ckpt_dir}")

    wd = Watchdog(tc.step_deadline_s)
    losses = []
    pending = None
    for step in range(start, tc.total_steps):
        wd.arm(f"step {step}")
        batch = batch_fn(step)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        loss = float(metrics["loss"])
        wd.disarm()
        if not (loss == loss):  # NaN guard
            raise FloatingPointError(f"NaN loss at step {step}")
        losses.append(loss)
        if step % log_every == 0:
            logger(f"[train] step {step} loss {loss:.4f} "
                   f"gnorm {float(metrics['grad_norm']):.3f}")
        if tc.ckpt_dir and (step + 1) % tc.ckpt_every == 0:
            if pending is not None:
                pending.join()
            pending = save_state(cfg, tc.ckpt_dir, step + 1, params, opt_state,
                                 keep_last=tc.keep_last, async_=True)
    if pending is not None:
        pending.join()
    if tc.ckpt_dir:
        save_state(cfg, tc.ckpt_dir, tc.total_steps, params, opt_state,
                   keep_last=tc.keep_last)
    return {"params": params, "opt_state": opt_state, "losses": losses}
