"""Architecture registry (port of ``repro.configs``), ported archs only.

``get_config(arch)`` returns the published configuration,
``smoke=True`` a reduced same-family config for CPU tests, and
``recalkv_ratio=0.5`` attaches a uniform-rank ReCalKV latent cache at the
given kept fraction — the same rank rule as the JAX package.
"""

from __future__ import annotations

import dataclasses
import importlib

from repro_torch.models.config import ModelConfig, ReCalKVRuntime

_MODULES = {"qwen3-4b": "qwen3_4b"}
ARCHS: tuple[str, ...] = tuple(_MODULES)


def effective_rank_for_ratio(width: int, keep_ratio: float,
                             multiple: int = 8, min_rank: int = 8) -> int:
    """Rank giving a ``keep_ratio`` cache footprint, rounded to a multiple
    of 8 (copy of ``repro.core.svd.effective_rank_for_ratio``)."""
    r = int(round(width * keep_ratio / multiple)) * multiple
    return max(min_rank, min(width, r))


def get_config(arch: str, *, smoke: bool = False,
               recalkv_ratio: float | None = None) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown or not yet ported arch {arch!r}; "
                       f"ported: {ARCHS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    cfg: ModelConfig = mod.SMOKE if smoke else mod.FULL
    if recalkv_ratio is not None:
        s = max(1, min(4, cfg.num_kv_heads))
        rank = effective_rank_for_ratio(s * cfg.d_head, recalkv_ratio)
        cfg = dataclasses.replace(
            cfg, recalkv=ReCalKVRuntime(rank_k=rank, rank_v=rank, group_size=s))
    return cfg
