"""repro_torch.api — the public entry point for KV-cache compression and
its artifacts (port of ``repro.api``):

    from repro_torch.api import (CompressionSpec, RankPolicy, calibrate,
                                 compress, save_artifact, load_artifact,
                                 list_strategies, serve)

Strategies are pluggable (``register_strategy``); artifacts written here
load in the JAX package and the reverse.
"""

from repro_torch.api.artifact import (CompressionArtifact, load_artifact,
                                      save_artifact)
from repro_torch.api.facade import calibrate, compress, serve
from repro_torch.api.registry import (KVCompressor, get_strategy,
                                      list_strategies, register_strategy,
                                      unregister_strategy)
from repro_torch.api.spec import CalibrationData, CompressionSpec, RankPolicy
from repro_torch.api import strategies as _builtin_strategies  # registers built-ins

__all__ = [
    "CalibrationData", "CompressionArtifact", "CompressionSpec",
    "KVCompressor", "RankPolicy", "calibrate", "compress", "get_strategy",
    "list_strategies", "load_artifact", "register_strategy", "save_artifact",
    "serve", "unregister_strategy",
]
