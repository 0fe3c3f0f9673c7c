"""Per-rank memory report of every (arch x shape x mesh) cell, computed
from the sharding rules: the port's stand-in for the JAX package's
``launch/dryrun.py``, ``hlo_analysis.py`` and ``hlo_cost.py``.

The JAX dry-run lowers and compiles each cell for 512 placeholder
devices and reads XLA's memory analysis and the post-SPMD HLO.  PyTorch
has no such compiler, so this report reads the rules instead: on the meta
device (no weights are made) it builds each cell's trees at FULL shapes,
takes each leaf's spec (``sharding.rules``) and reports the bytes one
rank holds of

    params      ``param_specs`` (no head grains, as the training launcher)
    mu, nu      ``opt_specs`` over moments in ``moment_dtype_for``'s dtype
    residual    the float32 error-feedback residual (``--grad-compress``)
    batch       the cell's inputs (``input_specs``) by ``batch_specs``
    caches      a decode cell's caches (``init_decode_cache``) by
                ``cache_specs``

with ``microbatches_for``, ``model_flops`` and the bytes a step's weight
gathers bring to a rank (every sharded leaf gathered once a step, the
port's ``MeshParams``); ``total_bytes`` sums params, moments, batch and
caches (the residual apart: it exists only with ``--grad-compress``).
Compiled memory (activations, temporaries), HLO FLOPs and post-SPMD
collective bytes have no PyTorch counterpart and are not reported.

    python -m repro_torch.launch.dryrun --all            # one JSON line a cell
    python -m repro_torch.launch.dryrun --arch qwen3-4b --shape train_4k --mesh 16x16

Meshes are axis sizes, not devices: "16x16" is ("data", "model") =
(16, 16), "2x16x16" adds a "pod" axis of 2 (the JAX production meshes).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math

import torch

from repro_torch.configs import ARCHS, RECALKV_APPLICABLE, SHAPES, get_config, shape_applicable
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import init_params, leaves_in_jax_order, map_tree
from repro_torch.sharding import rules as R

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16}}


# -- the JAX dry-run's helpers, copied ---------------------------------------

def _attn_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    if cfg.mla is not None:
        a = cfg.mla
        return (d * a.q_lora_rank
                + a.q_lora_rank * cfg.num_heads * (a.qk_nope_dim + a.qk_rope_dim)
                + d * (a.kv_lora_rank + a.qk_rope_dim)
                + a.kv_lora_rank * cfg.num_heads * (a.qk_nope_dim + a.v_head_dim)
                + cfg.num_heads * a.v_head_dim * d)
    q_dim, kv_dim = cfg.num_heads * cfg.d_head, cfg.num_kv_heads * cfg.d_head
    return d * q_dim + 2 * d * kv_dim + q_dim * d


def _ffn_params(cfg: ModelConfig, active_only: bool) -> int:
    d = cfg.d_model
    if cfg.moe is None:
        return 3 * d * cfg.d_ff
    m = cfg.moe
    experts = m.top_k if active_only else m.num_experts
    return 3 * d * m.d_expert * (experts + m.num_shared) + d * m.num_experts


def _block_params(cfg: ModelConfig, kind: str, active_only: bool = False) -> int:
    d = cfg.d_model
    if kind == "mamba":
        di, ds, dtr = cfg.mamba_d_inner, cfg.mamba.d_state, cfg.mamba_dt_rank
        return (d * 2 * di + cfg.mamba.d_conv * di + di + di * (dtr + 2 * ds)
                + dtr * di + di * ds + di + di * d + d)
    if kind == "rglru":
        w = cfg.lru_width
        return (2 * d * w + cfg.rglru.conv_width * w + 2 * w * w + w * d
                + 3 * d * cfg.d_ff + 2 * d)
    if kind == "attn_dense_enc":
        return _attn_params(cfg) + 3 * d * cfg.d_ff + 2 * d
    ffn = (3 * d * cfg.d_ff if kind in ("attn_dense", "cross", "attn_cross")
           else _ffn_params(cfg, active_only))
    attn = _attn_params(cfg) * (2 if kind == "attn_cross" else 1)
    return attn + ffn + 2 * d


def _extras(cfg: ModelConfig) -> int:
    d, v = cfg.d_model, cfg.vocab_size
    n = v * d + d
    if not cfg.tie_embeddings:
        n += d * v
    if cfg.encoder_decoder:
        n += cfg.num_encoder_layers * _block_params(cfg, "attn_dense_enc")
    return n


def param_count(cfg: ModelConfig) -> int:
    """The JAX ``ModelConfig.param_count``: the formula, not the leaves
    (the tied embedding once; norms of q / k not counted)."""
    return sum(_block_params(cfg, k) for k in cfg.expanded_layers()) + _extras(cfg)


def active_param_count(cfg: ModelConfig) -> int:
    """Parameters a token touches (an MoE's top-k experts only)."""
    return sum(_block_params(cfg, k, True) for k in cfg.expanded_layers()) + _extras(cfg)


def microbatches_for(cfg: ModelConfig, global_batch: int) -> int:
    n = param_count(cfg)
    k = 16 if n > 1e11 else 8 if n > 8e9 else 4 if n > 3e9 else 2
    while global_batch % k or (global_batch // k) % 16:
        k //= 2
        if k <= 1:
            return 1
    return max(k, 1)


def moment_dtype_for(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if param_count(cfg) > 5e10 else torch.float32


def model_flops(cfg: ModelConfig, shape_name: str) -> float:
    seq, batch, kind = SHAPES[shape_name]
    n = active_param_count(cfg)
    if kind == "train":
        return 6.0 * n * seq * batch
    if kind == "prefill":
        return 2.0 * n * seq * batch
    return 2.0 * n * batch


# -- the cells ---------------------------------------------------------------

def cell_config(arch: str, shape_name: str) -> ModelConfig:
    """The JAX dry-run's config for a cell: the dense model to train, the
    ReCalKV latent model (ratio 0.5) to serve where it applies; a decode
    cell unrolled (``scan_layers=False``)."""
    kind = SHAPES[shape_name][2]
    latent = kind != "train" and RECALKV_APPLICABLE[arch]
    cfg = get_config(arch, recalkv_ratio=0.5 if latent else None)
    if kind == "decode":
        cfg = dataclasses.replace(cfg, scan_layers=False)
    return cfg


def input_specs(cfg: ModelConfig, shape_name: str) -> dict:
    """Meta tensors of the cell's inputs (a decode cell's caches apart,
    :func:`decode_caches`)."""
    seq, batch, kind = SHAPES[shape_name]
    meta = dict(device="meta")
    i32 = torch.int32
    if kind == "decode":
        return {"tokens": torch.empty((batch,), dtype=i32, **meta),
                "cur": torch.empty((batch,), dtype=i32, **meta)}
    spec = {"tokens": torch.empty((batch, seq), dtype=i32, **meta)}
    spec["labels" if kind == "train" else "lengths"] = torch.empty(
        (batch, seq) if kind == "train" else (batch,), dtype=i32, **meta)
    if cfg.cross_source_len:
        spec["source"] = torch.empty((batch, cfg.cross_source_len, cfg.d_model),
                                     dtype=cfg.dtype, **meta)
    return spec


def decode_caches(cfg: ModelConfig, shape_name: str) -> list:
    seq, batch, _ = SHAPES[shape_name]
    return T.init_decode_cache(cfg, batch, seq, device="meta")


def _entries(entry) -> tuple[str, ...]:
    return () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)


def shard_bytes(shape, dtype: torch.dtype, spec, sizes: dict) -> int:
    """Bytes of one rank's shard of a leaf (the rules split only dims the
    axes divide)."""
    n = math.prod(shape)
    for entry in spec:
        for axis in _entries(entry):
            n //= sizes[axis]
    return n * dtype.itemsize


def _specs_bytes(tree, specs, mesh: dict) -> int:
    """This rank's bytes of a tree (dicts / lists of tensors) under its
    spec tree."""
    if isinstance(tree, dict):
        return sum(_specs_bytes(v, specs[k], mesh) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(_specs_bytes(v, s, mesh) for v, s in zip(tree, specs, strict=True))
    return shard_bytes(tuple(tree.shape), tree.dtype, specs, mesh)


def report(arch: str, shape_name: str, mesh_name: str) -> dict:
    """One cell's per-rank bytes (module docstring)."""
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    ok, why = shape_applicable(arch, shape_name)
    if not ok:
        return dict(rec, status="skipped", reason=why)
    seq, batch, kind = SHAPES[shape_name]
    mesh = MESHES[mesh_name]
    cfg = cell_config(arch, shape_name)
    params = init_params(cfg, torch.Generator(), device="meta")
    p_full = sum(t.numel() * t.element_size() for _, ts, _ in
                 leaves_in_jax_order(None, params) for t in ts)
    p_mine = _specs_bytes(params, R.param_specs(cfg, params, mesh), mesh)
    inputs = input_specs(cfg, shape_name)
    rec.update(status="ok", variant="dense" if cfg.recalkv is None else "recalkv",
               kind=kind, ranks=math.prod(mesh.values()),
               params_bytes=p_mine, params_full_bytes=p_full,
               gather_bytes=p_full - p_mine,
               batch_bytes=_specs_bytes(inputs, R.batch_specs(inputs, mesh), mesh),
               model_flops=model_flops(cfg, shape_name))
    if kind == "train":
        mdt = moment_dtype_for(cfg)
        like = lambda dt: map_tree(params, lambda t: torch.empty(   # noqa: E731
            t.shape, dtype=dt, device="meta"))
        state = {"mu": like(mdt), "nu": like(mdt), "residual": like(torch.float32)}
        specs = R.opt_specs(cfg, state, mesh)
        rec.update(microbatches=microbatches_for(cfg, batch), moment_dtype=str(mdt)[6:],
                   **{f"{k}_bytes": _specs_bytes(v, specs[k], mesh) for k, v in state.items()})
    if kind == "decode":
        caches = decode_caches(cfg, shape_name)
        rec["cache_bytes"] = _specs_bytes(caches, R.cache_specs(caches, mesh), mesh)
    rec["total_bytes"] = sum(rec.get(k, 0) for k in (
        "params_bytes", "mu_bytes", "nu_bytes", "batch_bytes", "cache_bytes"))
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None, choices=ARCHS)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--mesh", default="both", choices=[*MESHES, "both"])
    ap.add_argument("--all", action="store_true", help="every arch, shape and mesh")
    args = ap.parse_args(argv)
    archs = ARCHS if (args.all or not args.arch) else (args.arch,)
    shapes = list(SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = list(MESHES) if (args.all or args.mesh == "both") else [args.mesh]
    out = []
    for arch in archs:
        for shape_name in shapes:
            for mesh_name in meshes:
                rec = report(arch, shape_name, mesh_name)
                print(json.dumps(rec), flush=True)
                out.append(rec)
    return out


if __name__ == "__main__":
    main()
