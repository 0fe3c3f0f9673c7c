"""Per-token integer quantization of cache latents and the randomized
Hadamard rotation (port of ``repro.quant``)."""

from repro_torch.quant.hadamard import fwht, hadamard_inverse, hadamard_transform
from repro_torch.quant.int_quant import dequantize, fake_quant, quantize

__all__ = ["dequantize", "fake_quant", "fwht", "hadamard_inverse",
           "hadamard_transform", "quantize"]
