"""AdamW with optional bf16 moments and deterministic stochastic rounding
(port of ``repro.optim.adamw``).

Plain functions over the port's tensors, not ``torch.optim.AdamW``: the
JAX package clips by the global norm, decays by each leaf's rank and
rounds bf16 moments stochastically, and every one of those follows the
JAX param tree, not the port's per-layer one.  Given the model config
(``model=``), a leaf is the JAX package's leaf for that config's layout
(``weights.leaves_in_jax_order``): with ``scan_layers`` a scanned block's leaf is
stacked along a leading period axis, so its norms ``(n_per, d)`` are
matrices and decayed, while the prefix / suffix norms and
``final_norm`` are not; the stochastic rounding keys on the JAX leaf's
index and draws its noise over the stacked shape, sliced per layer.

The update runs in place (params, moments, step), as the JAX launcher's
donated buffers are reused: a 4 B-parameter model has no room for a
second copy of its 48 GB of state on one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import leaves_in_jax_order, map_tree
from repro_torch.serving import prng
from repro_torch.sharding.place import full_shape, shard, spec_by_id


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak; scaled by the schedule fn
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: torch.dtype = torch.float32


def zeros_like_tree(params, dtype: torch.dtype):
    """Zeros of ``dtype`` shaped as every leaf of ``params``, on its device."""
    return map_tree(params, lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device))


def init_state(params, cfg: AdamWConfig) -> dict:
    dev = next(t for _, ts, _ in leaves_in_jax_order(None, params) for t in ts).device
    return {"mu": zeros_like_tree(params, cfg.moment_dtype),
            "nu": zeros_like_tree(params, cfg.moment_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root, as XLA's and CUDA's are;
    PyTorch's CPU kernel is not (up to 1 ulp off), so on the CPU it runs
    in float64, which rounds back to the float32 root exactly."""
    return torch.sqrt(x) if x.is_cuda else torch.sqrt(x.double()).float()


def global_norm(leaves: list[list[torch.Tensor]]) -> torch.Tensor:
    """sqrt of the sum over the (JAX) leaves of each leaf's float32 sum of
    squares, summed in leaf order (a stacked leaf's periods in order)."""
    total = None
    for parts in leaves:
        s = None
        for g in parts:
            t = torch.sum(torch.square(g.float()))
            s = t if s is None else s + t
        total = s if total is None else total + s
    return sqrt32(total)


def _stochastic_round(x: torch.Tensor, dtype: torch.dtype, noise: torch.Tensor):
    """Round float32 ``x`` to ``dtype`` stochastically: add ``noise``
    (uniform in [-0.5, 0.5)) times the bf16 ulp of each element, computed
    on its int32 bits as the JAX package does on uint32 ones."""
    hi = x.view(torch.int32) & -0x10000                   # 0xFFFF0000
    ulp = (hi + 0x10000).view(torch.float32) - hi.view(torch.float32)
    return (x + noise * ulp).to(dtype)


def _mesh_global_norm(leaves: list[list[torch.Tensor]], specs: list, mesh) -> torch.Tensor:
    """:func:`global_norm` of a tree of shards: each (JAX) leaf's sum of
    squares over this rank's shards, counted on one rank of every axis
    the leaf is not split on (its other ranks hold the same values), then
    summed over "data" and "model" and over the leaves in order."""
    sq = []
    for parts, spec in zip(leaves, specs, strict=True):
        s = None
        for g in parts:
            t = torch.sum(torch.square(g.float()))
            s = t if s is None else s + t
        split = {a for entry in spec for a in (
            () if entry is None else (entry,) if isinstance(entry, str) else entry)}
        owner = all(mesh.axis_index(a) == 0 for a in ("data", "model") if a not in split)
        sq.append(s if owner else torch.zeros_like(s))
    sq = torch.stack(sq)
    for axis in ("data", "model"):
        sq = mesh.all_reduce(sq, axis)
    total = None
    for t in sq:
        total = t if total is None else total + t
    return sqrt32(total)


@torch.no_grad()
def apply_updates(params, grads, state: dict, cfg: AdamWConfig, lr_scale=1.0, *,
                  model: ModelConfig, mesh=None, specs=None) -> tuple[Any, dict, dict]:
    """One AdamW step, in place.  ``model`` is the model config whose JAX
    layout defines the leaves.  ``lr_scale`` a float or a 0-d float32
    tensor (a schedule's).  Returns
    (params, state, metrics {"grad_norm", "lr"} as 0-d float32 tensors) —
    the same params and state objects, updated.

    With a ``mesh`` the trees are this rank's shards, every tree at the
    param spec tree ``specs`` (``sharding.rules.param_specs``): the
    update is elementwise, so each rank updates its slice; the gradient
    norm is reduced over the mesh, and a bf16 moment's noise is this
    rank's slice of the full leaf's, so the result equals one device's."""
    flat_p = leaves_in_jax_order(model, params)
    flat_g = [ts for _, ts, _ in leaves_in_jax_order(model, grads)]
    flat_mu = [ts for _, ts, _ in leaves_in_jax_order(model, state["mu"])]
    flat_nu = [ts for _, ts, _ in leaves_in_jax_order(model, state["nu"])]
    dev = flat_p[0][1][0].device
    step = state["step"] + 1
    if mesh is None:
        gnorm = global_norm(flat_g)
        leaf_specs = [None] * len(flat_p)
    else:
        by_id = spec_by_id(params, specs)
        leaf_specs = [by_id[id(ps[0])] for _, ps, _ in flat_p]
        gnorm = _mesh_global_norm(flat_g, leaf_specs, mesh)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.tensor(cfg.b1, dtype=torch.float32, device=dev) ** stepf
    bc2 = 1.0 - torch.tensor(cfg.b2, dtype=torch.float32, device=dev) ** stepf
    if isinstance(lr_scale, torch.Tensor):
        lr = cfg.lr * lr_scale.to(device=dev, dtype=torch.float32)
    else:   # a Python scale multiplies in double first, as in JAX
        lr = torch.tensor(cfg.lr * lr_scale, dtype=torch.float32, device=dev)
    rounding = cfg.moment_dtype != torch.float32
    if rounding:
        key = prng.fold_in(prng.prng_key(0, dev), step.to(torch.int64))
    for i, ((_, ps, stacked), gs, mus, nus, spec) in enumerate(
            zip(flat_p, flat_g, flat_mu, flat_nu, leaf_specs, strict=True)):
        decay = ps[0].dim() + stacked >= 2      # decoupled decay on matrices only
        if rounding:
            k = prng.fold_in(key, i)
            shape = ps[0].shape if mesh is None else full_shape(ps[0].shape, spec, mesh)
            n = math.prod(shape)
            noise_mu = prng.uniform(k, n * len(ps)) - 0.5
            noise_nu = prng.uniform(prng.fold_in(k, 1), n * len(ps)) - 0.5
        for j, (p, g, mu, nu) in enumerate(zip(ps, gs, mus, nus, strict=True)):
            g = g.float() * clip
            # a float32 moment is updated in place (.float() is itself)
            mu_f = mu.float().mul_(cfg.b1).add_(g * (1 - cfg.b1))
            nu_f = nu.float().mul_(cfg.b2).add_(g * (1 - cfg.b2) * g)
            del g
            upd = (mu_f / bc1).div_(sqrt32(nu_f / bc2).add_(cfg.eps))
            if decay:
                upd.add_(cfg.weight_decay * p.float())
            p.copy_(p.float().sub_(upd.mul_(lr)))
            del upd
            if rounding:
                sl = slice(j * n, (j + 1) * n)
                n_mu, n_nu = noise_mu[sl].view(shape), noise_nu[sl].view(shape)
                if mesh is not None:
                    n_mu, n_nu = shard(n_mu, spec, mesh), shard(n_nu, spec, mesh)
                mu.copy_(_stochastic_round(mu_f, mu.dtype, n_mu))
                nu.copy_(_stochastic_round(nu_f, nu.dtype, n_nu))
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr}
