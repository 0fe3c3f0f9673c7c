"""String-keyed registry of pluggable KV-cache compression strategies
(port of ``repro.api.registry``).

A strategy is any object satisfying the :class:`KVCompressor` protocol —
it consumes a dense model plus calibration data and returns the compressed
``(ModelConfig, params, info)`` triple.  Built-in strategies register at
import time (``api/strategies.py``); downstream code registers its
own with :func:`register_strategy`:

    @register_strategy
    class MyCompressor:
        name = "my-method"
        def compress(self, cfg, params, spec, calib): ...
"""

from __future__ import annotations

from typing import Any, Protocol, runtime_checkable

from repro_torch.api.spec import CalibrationData, CompressionSpec
from repro_torch.models.config import ModelConfig


@runtime_checkable
class KVCompressor(Protocol):
    """Strategy protocol: dense checkpoint -> latent-cache model."""

    name: str

    def compress(
        self,
        cfg: ModelConfig,
        params: Any,
        spec: CompressionSpec,
        calib: CalibrationData,
    ) -> tuple[ModelConfig, Any, dict]:
        """Returns (compressed_cfg, compressed_params, info_dict)."""
        ...


_REGISTRY: dict[str, KVCompressor] = {}


def register_strategy(strategy=None, *, replace: bool = False):
    """Register a KVCompressor instance or class (usable as a decorator).

    Classes are instantiated with no arguments; instances are stored as-is.
    Registration keys on ``strategy.name``.
    """
    if strategy is None:
        return lambda s: register_strategy(s, replace=replace)
    inst = strategy() if isinstance(strategy, type) else strategy
    name = getattr(inst, "name", None)
    if not name or not isinstance(name, str):
        raise ValueError(f"strategy {inst!r} needs a non-empty string .name")
    if not callable(getattr(inst, "compress", None)):
        raise TypeError(f"strategy {name!r} has no compress() method")
    if name in _REGISTRY and not replace:
        raise ValueError(f"strategy {name!r} already registered "
                         "(pass replace=True to override)")
    _REGISTRY[name] = inst
    return strategy


def unregister_strategy(name: str) -> None:
    _REGISTRY.pop(name, None)


def get_strategy(name: str) -> KVCompressor:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"unknown compression strategy {name!r}; "
            f"registered: {list_strategies()}") from None


def list_strategies() -> list[str]:
    """Sorted names of every registered strategy."""
    return sorted(_REGISTRY)
