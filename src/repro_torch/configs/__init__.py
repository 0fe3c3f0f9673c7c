"""Architecture registry (port of ``repro.configs``): every arch the JAX
package registers.

``get_config(arch)`` returns the published configuration,
``smoke=True`` a reduced same-family config for CPU tests, and
``recalkv_ratio=0.5`` attaches a uniform-rank ReCalKV latent cache at the
given kept fraction — the same rank rule as the JAX package; an arch
where the technique does not apply (``RECALKV_APPLICABLE``: DeepSeek's MLA
already caches trained latents, falcon-mamba caches no keys or values)
raises ValueError, as in the JAX package.
``cache_quant_bits=8`` stores that ring as int8 latents with per-token
scales (the JAX package sets the field with ``dataclasses.replace``).
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, ReCalKVRuntime

_MODULES = {
    "qwen3-4b": "qwen3_4b",
    "minicpm-2b": "minicpm_2b",
    "gemma3-12b": "gemma3_12b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "llama-3.2-vision-11b": "llama32_vision_11b",
    "whisper-small": "whisper_small",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "recurrentgemma-9b": "recurrentgemma_9b",
}
ARCHS: tuple[str, ...] = tuple(_MODULES)
# ReCalKV applies to archs with cached RoPE'd attention; Mamba has no
# attention, DeepSeek's MLA is already a (trained) latent cache.  The JAX
# package's table.
RECALKV_APPLICABLE = {
    "qwen3-4b": True,
    "minicpm-2b": True,
    "gemma3-12b": True,
    "h2o-danube-1.8b": True,
    "qwen3-moe-235b-a22b": True,
    "deepseek-v3-671b": False,
    "llama-3.2-vision-11b": True,
    "whisper-small": True,
    "falcon-mamba-7b": False,
    "recurrentgemma-9b": True,
}


# (seq_len, global_batch, kind): the JAX package's dry-run cells; "train"
# is a train step, "prefill" a prefill, "decode" one token against a
# seq_len cache (``launch.dryrun`` reports each).
SHAPES = {
    "train_4k": (4096, 256, "train"),
    "prefill_32k": (32768, 32, "prefill"),
    "decode_32k": (32768, 128, "decode"),
    "long_500k": (524288, 1, "decode"),
}

# long_500k needs a sub-quadratic cache: the SSM, hybrid and windowed
# archs run it; pure full-attention archs (and whisper's 448-position
# decoder) skip it, as in the JAX package.
LONG_CONTEXT_ARCHS = {
    "falcon-mamba-7b", "recurrentgemma-9b", "gemma3-12b", "h2o-danube-1.8b",
}


def shape_applicable(arch: str, shape: str) -> tuple[bool, str]:
    """(whether ``arch`` runs the ``SHAPES`` cell ``shape``, why not)."""
    if shape == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
        return False, "pure full-attention arch: 500k decode is quadratic-cost"
    return True, ""


def effective_rank_for_ratio(width: int, keep_ratio: float,
                             multiple: int = 8, min_rank: int = 8) -> int:
    """Rank giving a ``keep_ratio`` cache footprint, rounded to a multiple
    of 8 (copy of ``repro.core.svd.effective_rank_for_ratio``)."""
    r = int(round(width * keep_ratio / multiple)) * multiple
    return max(min_rank, min(width, r))


def get_config(arch: str, *, smoke: bool = False,
               recalkv_ratio: float | None = None,
               cache_quant_bits: int | None = None) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg: ModelConfig = mod.SMOKE if smoke else mod.FULL
    if recalkv_ratio is not None:
        if not RECALKV_APPLICABLE[arch]:
            raise ValueError(
                f"ReCalKV inapplicable to {arch} (see DESIGN.md §Arch-applicability)")
        s = max(1, min(4, cfg.num_kv_heads))
        rank = effective_rank_for_ratio(s * cfg.d_head, recalkv_ratio)
        cfg = dataclasses.replace(
            cfg, recalkv=ReCalKVRuntime(rank_k=rank, rank_v=rank, group_size=s))
    if cache_quant_bits is not None:
        cfg = dataclasses.replace(cfg, cache_quant_bits=cache_quant_bits)
    return cfg
