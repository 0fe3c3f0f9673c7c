"""Durable compression artifacts, written and read in the JAX package's
layout (port of ``repro.api.artifact``).

    <path>/step_00000000/arrays.npz   # compressed params (unrolled tree)
    <path>/step_00000000/meta.json    # model config + provenance + keys

Either package reads what the other writes: the port stores its params
through :func:`~repro_torch.models.weights.params_to_jax` (JAX's unrolled
``prefix`` layout, so the config says ``scan_layers=False``) and its
config with JAX's values (``"pallas"`` for the kernel backend); it loads
with :func:`~repro_torch.models.weights.params_from_jax`.  The writer is
atomic (``checkpoint.save``), and it refuses a directory that holds a
training checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Any

from repro_torch import checkpoint as ckpt
from repro_torch.models.config import ModelConfig
from repro_torch.models.weights import params_from_jax, params_to_jax

ARTIFACT_KIND = "recalkv-compression-artifact"
ARTIFACT_VERSION = 1
_STEP = 0


@dataclasses.dataclass
class CompressionArtifact:
    """A compressed model plus everything needed to serve and audit it."""

    cfg: ModelConfig
    params: Any
    provenance: dict = dataclasses.field(default_factory=dict)

    @property
    def method(self) -> str:
        return self.provenance.get("method", "unknown")

    def save(self, path: str) -> None:
        save_artifact(self, path)

    @classmethod
    def load(cls, path: str, device=None) -> "CompressionArtifact":
        return load_artifact(path, device=device)


def save_artifact(artifact: CompressionArtifact, path: str) -> None:
    """Atomically persist an artifact under ``path``.  ``path`` is an
    artifact directory, not a training-checkpoint directory: saving
    refuses to write next to non-artifact checkpoints (and never trims
    other steps), so it cannot destroy a checkpoint run."""
    existing = ckpt.latest_step(path)
    if existing is not None and (
            existing != _STEP
            or ckpt.read_meta(path, existing).get("kind") != ARTIFACT_KIND):
        raise ValueError(
            f"{path!r} already holds a non-artifact checkpoint (step "
            f"{existing}); refusing to overwrite a training-checkpoint "
            "directory")
    cfg = dataclasses.replace(artifact.cfg, scan_layers=False)
    tree = {"params": params_to_jax(cfg, artifact.params)}
    ckpt.save(path, _STEP, tree, keep_last=0, extra_meta={
        "kind": ARTIFACT_KIND,
        "version": ARTIFACT_VERSION,
        "model_config": cfg.to_dict(),
        "provenance": artifact.provenance,
        "tuple_paths": ckpt.tuple_paths(tree),
    })


def load_artifact(path: str, device=None) -> CompressionArtifact:
    """Load an artifact saved by either package's ``save_artifact`` onto
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
