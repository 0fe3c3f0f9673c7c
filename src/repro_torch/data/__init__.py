"""Calibration and training data of the port (numpy only)."""

from repro_torch.data.synthetic import DataConfig, batch, batches, sequence

__all__ = ["DataConfig", "batch", "batches", "sequence"]
