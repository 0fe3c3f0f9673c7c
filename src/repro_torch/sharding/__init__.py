"""Sharding specs for the port's param, cache and carry trees (port of
``repro.sharding``)."""

from repro_torch.sharding.rules import (batch_axes, cache_specs, carry_specs,
                                        head_grains, param_specs,
                                        param_specs_jax_order, slot_stacked_spec)

__all__ = ["batch_axes", "cache_specs", "carry_specs", "head_grains",
           "param_specs", "param_specs_jax_order", "slot_stacked_spec"]
