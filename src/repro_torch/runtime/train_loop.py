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

On a mesh (``make_train_step(..., mesh=)``, ``launch.mesh``; the JAX
launcher's ``--mesh``, whose step is the single-device math partitioned by
XLA) every rank runs the same step on its part of the batch:

    params, state    -> at rest as this rank's shards of
                        ``sharding.rules.param_specs`` (FSDP over "data",
                        heads / FFN width over "model"); the moments and
                        the residual at their param's spec, so the
                        update is elementwise on one slice
    microbatch i     -> rows i * B/k .. (i + 1) * B/k of the global batch
                        (JAX's), then this data rank's part of them
    forward          -> params read through ``MeshParams`` (each leaf
                        gathered once a step, ``GatherShard``); an MoE runs
                        on every data rank's rows, so its capacity, drops
                        and aux are the global microbatch's
    objective        -> this rank's summed cross-entropy over the global
                        microbatch's label count (taken from the labels),
                        plus aux / D: the sum over "data" is JAX's loss
    gradients        -> summed over "data" once a step (the gathers'
                        backward), this rank's slice of the global
                        gradient; the "model" ranks of a data lane run the
                        same rows, so they slice, not sum
    error feedback,  -> on the slices, each leaf's amax and the norm
    norm, AdamW         reduced over the mesh; bf16 moments' noise is the
                        slice of the full leaf's
A batch whose microbatch "data" does not divide is not split (``batch_specs``
replicates it): every data rank runs all of it and nothing is summed over
"data".
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch

from repro_torch import checkpoint as ckpt_lib
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import (OPT_TREES, init_params, leaves_in_jax_order,
                                        map_tree, opt_state_from_jax, opt_state_to_jax,
                                        params_from_jax, params_to_jax)
from repro_torch.optim import AdamWConfig, apply_updates, init_state, with_error_feedback
from repro_torch.optim.adamw import zeros_like_tree
from repro_torch.optim.schedule import SCHEDULES
from repro_torch.runtime.watchdog import Watchdog
from repro_torch.sharding.place import GradReduce, MeshParams, gather_tree, shard_tree


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


def _data_rows(mb: dict, mesh) -> dict:
    """This data rank's rows of a (global) microbatch."""
    n = mesh.axis_size("data")
    return _slice(mb, mesh.axis_index("data"), n) if n > 1 else mb


def _rows(batch: dict, i: int, k: int, mesh) -> tuple[dict, dict]:
    """(microbatch ``i`` of ``k`` of the global batch, this data rank's
    rows of it).  The microbatch is sliced first, as JAX's step slices
    the global batch: taking the data shard first would give each
    microbatch other rows, so other normalisations and MoE drops."""
    mb = _slice(batch, i, k)
    return mb, _data_rows(mb, mesh)


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, tc: TrainConfig, mesh=None):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating both in place.  ``opt_state`` carries {mu, nu,
    step[, residual]}; batch: "tokens" / "labels" (B, T) [+ "source"],
    numpy or tensors, B a multiple of ``tc.microbatches``.  The metrics
    ("loss", "grad_norm", "lr") are 0-d float32 tensors on the device.
    With a ``mesh`` of more than one rank, ``params`` is a
    ``MeshParams`` and ``opt_state`` this rank's shards
    (:func:`shard_train_state`), and every rank passes the same global
    batch (module docstring)."""
    if mesh is not None and mesh.size > 1:
        return _mesh_train_step(cfg, opt_cfg, tc, mesh)
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


def _mesh_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, tc: TrainConfig, mesh):
    """The step on a mesh (module docstring)."""
    sched = SCHEDULES[tc.schedule]

    def train_step(params: MeshParams, opt_state, batch):
        k = tc.microbatches
        whole = (batch["tokens"].shape[0] // k) % mesh.axis_size("data") != 0
        rows = mesh.without("data") if whole else mesh
        red = GradReduce(() if whole else ("data",))
        leaves = [t for _, ts, _ in leaves_in_jax_order(None, params.local) for t in ts]
        dev = leaves[0].device
        parts = aux_sum = torch.zeros((), dtype=torch.float32, device=dev)
        for t in leaves:
            t.requires_grad_(True)
        try:
            with params.step(train=red):
                for i in range(k):
                    red.defer = i < k - 1     # one reduction a step, after the last
                    mb, mine = _rows(batch, i, k, rows)
                    cnt = torch.clamp(torch.sum(
                        (torch.as_tensor(mb["labels"], device=dev) >= 0).float()), min=1.0)
                    source = mine.get("source")
                    hidden, aux = T.forward_hidden(
                        cfg, params, torch.as_tensor(mine["tokens"], device=dev).long(),
                        None if source is None else torch.as_tensor(source, device=dev),
                        mesh=rows)
                    tot, _ = T.chunked_xent(cfg, params, hidden,
                                            torch.as_tensor(mine["labels"], device=dev))
                    part = tot / cnt
                    gs = torch.autograd.grad(part + aux / rows.axis_size("data"), leaves,
                                             allow_unused=True)
                    parts, aux_sum = parts + part.detach(), aux_sum + aux.detach()
                    del hidden, tot, part, aux
        finally:
            for t in leaves:
                t.requires_grad_(False)
        by_id = {id(t): torch.zeros_like(t) if g is None else g.float() / k if k > 1 else g
                 for t, g in zip(leaves, gs, strict=True)}
        grads = map_tree(params.local, lambda t: by_id[id(t)])
        del gs, by_id
        residual = opt_state.get("residual")
        if tc.grad_compress:
            grads, residual = with_error_feedback(grads, residual, model=cfg, mesh=mesh)
        lr_scale = sched(opt_state["step"], warmup=tc.warmup_steps,
                         total=tc.total_steps)
        _, new_opt, metrics = apply_updates(params.local, grads, opt_state, opt_cfg,
                                            lr_scale, model=cfg, mesh=mesh,
                                            specs=params.specs)
        if tc.grad_compress:
            new_opt["residual"] = residual
        metrics["loss"] = (rows.all_reduce(parts, "data") + aux_sum) / k
        return params, new_opt, metrics

    return train_step


def shard_train_state(cfg: ModelConfig, params, opt_state, mesh):
    """Full params and optimizer state -> (``MeshParams`` at
    ``rules.param_specs``, no head grains, as the JAX launcher shards;
    the state's trees as this rank's shards at the same specs, "step"
    whole)."""
    mp = MeshParams(cfg, params, mesh)
    local = {k: shard_tree(v, mp.specs, mesh) if k in OPT_TREES else v
             for k, v in opt_state.items()}
    return mp, local


def gather_train_state(params: MeshParams, opt_state):
    """The inverse of :func:`shard_train_state`: full trees on every rank
    (a collective: every rank calls it)."""
    full = gather_tree(params.local, params.specs, params.mesh)
    return full, {k: gather_tree(v, params.specs, params.mesh) if k in OPT_TREES else v
                  for k, v in opt_state.items()}


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
               logger=print, mesh=None) -> dict[str, Any]:
    """Run to ``tc.total_steps`` with checkpoint / restart + watchdog.
    ``batch_fn(step)`` supplies the global batch (a stateless pipeline:
    a restart replays the counter).  Returns {"params", "opt_state",
    "losses"}.

    With a ``mesh`` of more than one rank every rank calls this with the
    same arguments: ``params`` / ``opt_state`` (or the seeded init) are
    full trees, restored from the latest checkpoint whole and then sharded
    (:func:`shard_train_state`), so a checkpoint written on any mesh, or
    on one device, or by the JAX package, resumes here.  A checkpoint is
    the gathered trees in the JAX layout, written once, by rank 0
    (atomic, async as off a mesh).  The returned params are the
    ``MeshParams`` and the state this rank's shards
    (:func:`gather_train_state` rebuilds them)."""
    on_mesh = mesh is not None and mesh.size > 1
    if params is None:
        params, opt_state = init_train_state(cfg, opt_cfg, tc, generator, device)
    step_fn = step_fn or make_train_step(cfg, opt_cfg, tc, mesh=mesh)

    start = 0
    if tc.ckpt_dir:
        latest = ckpt_lib.latest_step(tc.ckpt_dir)
        if latest is not None:
            params, opt_state = restore_state(cfg, tc.ckpt_dir, latest, params,
                                              opt_state)
            start = latest
            logger(f"[train] restored step {latest} from {tc.ckpt_dir}")
    if on_mesh:
        params, opt_state = shard_train_state(cfg, params, opt_state, mesh)

    def save(step, async_):
        p, o = gather_train_state(params, opt_state) if on_mesh else (params, opt_state)
        if on_mesh and mesh.rank != 0:
            return None
        return save_state(cfg, tc.ckpt_dir, step, p, o, keep_last=tc.keep_last,
                          async_=async_)

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
            pending = save(step + 1, True)
    if pending is not None:
        pending.join()
    if tc.ckpt_dir:
        save(tc.total_steps, False)
    return {"params": params, "opt_state": opt_state, "losses": losses}
