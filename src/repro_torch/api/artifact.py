"""Load compression artifacts written by the JAX package
(port of ``repro.api.artifact.load_artifact``).

    <path>/step_00000000/arrays.npz   # compressed params
    <path>/step_00000000/meta.json    # model config + provenance + keys

The loader needs no model code to rebuild the tree (generic unflatten);
:func:`repro_torch.models.weights.params_from_jax` then lays it out as the
port's per-layer params on the requested device.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch import checkpoint as ckpt
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax

ARTIFACT_KIND = "recalkv-compression-artifact"


@dataclasses.dataclass
class CompressionArtifact:
    """A compressed model plus its provenance, as the port serves it."""

    cfg: ModelConfig
    params: Any
    provenance: dict = dataclasses.field(default_factory=dict)

    @property
    def method(self) -> str:
        return self.provenance.get("method", "unknown")


def load_artifact(path: str, device=None) -> CompressionArtifact:
    """Load an artifact saved by the JAX package's ``save_artifact`` onto
    ``device`` (default ``cuda``)."""
    step = ckpt.latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no compression artifact under {path!r}")
    meta = ckpt.read_meta(path, step)
    if meta.get("kind") != ARTIFACT_KIND:
        raise ValueError(f"{path!r} is not a compression artifact "
                         f"(kind={meta.get('kind')!r})")
    cfg = ModelConfig.from_dict(meta["model_config"])
    tree = ckpt.unflatten(ckpt.load_flat(path, step),
                          seq_paths=meta.get("tuple_paths"))
    params = params_from_jax(cfg, tree["params"], device=device)
    return CompressionArtifact(cfg=cfg, params=params,
                               provenance=meta.get("provenance", {}))
