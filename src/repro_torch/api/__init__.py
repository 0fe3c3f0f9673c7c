"""repro_torch.api — serving side of the artifact workflow: load what the
JAX package compressed and saved (compression itself is not ported yet)."""

from repro_torch.api.artifact import CompressionArtifact, load_artifact

__all__ = ["CompressionArtifact", "load_artifact"]
