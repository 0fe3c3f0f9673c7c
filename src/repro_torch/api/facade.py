"""The three public verbs: ``calibrate`` once, ``compress`` many times,
``serve`` anywhere (port of ``repro.api.facade``).

    from repro_torch.api import (CompressionSpec, RankPolicy, calibrate,
                                 compress, serve)

    calib = calibrate(cfg, params, batches)
    art = compress(cfg, params,
                   CompressionSpec("recalkv",
                                   rank_policy=RankPolicy(keep_ratio=0.5)),
                   calib)
    art.save("build/qwen3_r50")             # later: serve(...)
    eng = serve("build/qwen3_r50", max_slots=8, max_len=4096)

``compress`` also accepts the raw calibration batches (it captures the
statistics itself) and a bare method name.  The params live on the
device of the model (``cuda`` unless the caller built them on the CPU);
the compression runs there.  ``calibrate(..., fisher=True)`` also takes
each layer's Fisher score (the batches then carry "labels"), which
``RankPolicy(use_fisher=True)`` turns into per-layer ranks.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import repro_torch.models.compress as C
from repro_torch.api.artifact import CompressionArtifact, load_artifact
from repro_torch.api.registry import get_strategy
from repro_torch.api.spec import CalibrationData, CompressionSpec
from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, check_supported
from repro_torch.serving.engine import Engine


def calibrate(cfg: ModelConfig, params: Any, batches: Sequence[dict], *,
              fisher: bool = False) -> CalibrationData:
    """Run the calibration forward passes once and summarize them.
    ``batches`` are dicts with "tokens" (B, T), "labels" (B, T) with
    ``fisher`` (which also takes each self-attention layer's Fisher
    score for the rank allocator, from gradients of the LM loss) and, for
    a model with cross-attention layers, "source" (B, S_src, d).  The
    result is strategy-agnostic — capture once, reuse across ``compress``
    calls."""
    batches = list(batches)
    stats = C.capture_calibration(cfg, params, batches)
    fk, fv = C.fisher_scores(cfg, params, batches) if fisher else (None, None)
    tokens = sum(math.prod(b["tokens"].shape) for b in batches)
    return CalibrationData(stats=stats, fisher_k=fk, fisher_v=fv, token_count=tokens)


def _as_spec(spec) -> CompressionSpec:
    if isinstance(spec, CompressionSpec):
        return spec
    if isinstance(spec, str):
        return CompressionSpec(method=spec)
    raise TypeError(f"spec must be a CompressionSpec or method name, "
                    f"got {type(spec).__name__}")


def compress(cfg: ModelConfig, params: Any,
             spec: CompressionSpec | str = "recalkv",
             calib: CalibrationData | Sequence[dict] | None = None,
             ) -> CompressionArtifact:
    """Compress a dense model with a registered strategy.  Returns a
    :class:`CompressionArtifact`; ``save_artifact`` persists it in the
    layout both packages read."""
    spec = _as_spec(spec)
    strategy = get_strategy(spec.method)
    if calib is None:
        calib = CalibrationData()
    elif not isinstance(calib, CalibrationData):
        calib = calibrate(cfg, params, calib, fisher=spec.rank_policy.use_fisher)
    ccfg, cparams, info = strategy.compress(cfg, params, spec, calib)
    if spec.backend is not None:
        ccfg = dataclasses.replace(ccfg, attn_backend=spec.backend)
    provenance = {
        "method": spec.method,
        "spec": spec.to_dict(),
        "calib_tokens": calib.token_count,
        "fisher": calib.fisher_k is not None and spec.rank_policy.use_fisher,
        **info,
    }
    provenance["group_size"] = ccfg.recalkv.group_size
    provenance["ranks_by_layer"] = (
        None if ccfg.recalkv.ranks_by_layer is None
        else [list(r) for r in ccfg.recalkv.ranks_by_layer])
    return CompressionArtifact(cfg=ccfg, params=cparams, provenance=provenance)


def serve(artifact: CompressionArtifact | str, *, max_slots: int,
          max_len: int, device=None, **engine_kw):
    """Boot a serving :class:`repro_torch.serving.Engine` from a
    compression artifact — the in-memory result of :func:`compress` or a
    path ``save_artifact`` wrote (by either package).  ``engine_kw`` pass
    through to the Engine (``sampling``, ``sync_every``,
    ``prefill_chunk``, ``backend``, ``spec_depth`` / ``draft``,
    ``cache_layout`` / ``page_size`` / ``n_pages``, ``policy``,
    ``lazy_pages``, ``pin_prefixes``, ``source`` (a cross-attention
    model's frontend embeddings), ``overlap`` / ``pipeline_depth`` /
    ``admission_thread``, ``continuous`` / ``staging_depth``, ``aot``,
    ``adaptive_spec``, ``profile``).
    Widths no CUDA kernel serves are refused before the engine is built
    (``check_supported``), and so is a latent config of a model without
    attention layers (the JAX package's ``compress`` writes a rank-0 one
    for falcon-mamba): ReCalKV does not apply to it."""
    if isinstance(artifact, str):
        artifact = load_artifact(artifact, device=device)
    cfg = artifact.cfg
    if cfg.recalkv is not None:
        C.check_compressible(cfg)
    if engine_kw.get("backend") is not None:
        cfg = dataclasses.replace(cfg, attn_backend=engine_kw["backend"])
    check_supported(cfg, resolve_device(device))
    return Engine(artifact.cfg, artifact.params, max_slots=max_slots,
                  max_len=max_len, device=device, **engine_kw)
