"""Declarative compression specs (port of ``repro.api.spec``).

A compression run is a :class:`CompressionSpec`: ``method`` (registry
key of a strategy), ``options`` (method-specific knobs), ``rank_policy``
(how latent ranks are chosen) and ``backend`` (the produced config's
attention backend: ``"einsum"``, or ``"kernel"`` — the JAX name
``"pallas"`` is accepted — or None to keep the source config's).  Specs
serialize with the JAX package's values, so either package reads the
other's provenance.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping, Sequence

from repro_torch.core import pipeline as P
from repro_torch.core import svd as _svd
from repro_torch.models.config import _BACKEND_ALIASES, _JAX_BACKEND_NAMES


@dataclasses.dataclass(frozen=True)
class RankPolicy:
    """How per-layer latent ranks are allocated.  ``keep_ratio`` is the
    kept fraction of KV-cache bytes.  ``use_fisher`` (Fisher-guided
    allocation) is not ported: compressing with it raises
    NotImplementedError."""

    keep_ratio: float = 0.5
    group_size: int = 4
    rank_multiple: int = 8
    min_rank: int = 8
    use_fisher: bool = False
    alpha: float = 0.5
    rho_min: float = 0.0625
    rho_max: float = 1.0

    def __post_init__(self):
        if not 0.0 < self.keep_ratio <= 1.0:
            raise ValueError(f"keep_ratio must be in (0, 1], got {self.keep_ratio}")
        if self.group_size < 1:
            raise ValueError("group_size must be >= 1")

    def rank_for_width(self, width: int) -> int:
        """Uniform rank for a latent group of ``width`` columns."""
        return _svd.effective_rank_for_ratio(width, self.keep_ratio,
                                             self.rank_multiple, self.min_rank)


@dataclasses.dataclass(frozen=True)
class CompressionSpec:
    """A complete, serializable description of one compression run."""

    method: str = "recalkv"
    options: Mapping[str, Any] = dataclasses.field(default_factory=dict)
    rank_policy: RankPolicy = dataclasses.field(default_factory=RankPolicy)
    backend: str | None = None

    def __post_init__(self):
        if self.backend is not None:
            object.__setattr__(self, "backend",
                               _BACKEND_ALIASES.get(self.backend, self.backend))

    def to_dict(self) -> dict:
        return {"method": self.method, "options": dict(self.options),
                "rank_policy": dataclasses.asdict(self.rank_policy),
                "backend": _JAX_BACKEND_NAMES.get(self.backend, self.backend)}

    @classmethod
    def from_dict(cls, d: Mapping[str, Any]) -> "CompressionSpec":
        return cls(method=d["method"], options=dict(d.get("options", {})),
                   rank_policy=RankPolicy(**d.get("rank_policy", {})),
                   backend=d.get("backend"))


@dataclasses.dataclass(frozen=True)
class CalibrationData:
    """Captured calibration state, reusable across strategies: one
    second-moment summary per self-attention layer (``stats``); Fisher
    scores stay None in the port."""

    stats: Sequence[P.CalibStats] | None = None
    fisher_k: Sequence[float] | None = None
    fisher_v: Sequence[float] | None = None
    token_count: int = 0
