"""Per-token integer quantization of cache latents (port of ``repro.quant``)."""

from repro_torch.quant.int_quant import dequantize, fake_quant, quantize

__all__ = ["dequantize", "fake_quant", "quantize"]
