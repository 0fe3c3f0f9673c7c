"""Sharding specs for the port's param, optimizer-state, batch, cache and
carry trees (port of ``repro.sharding``)."""

from repro_torch.sharding.rules import (batch_axes, batch_specs, cache_specs, carry_specs,
                                        head_grains, opt_specs, param_specs,
                                        param_specs_jax_order, slot_stacked_spec)

__all__ = ["batch_axes", "batch_specs", "cache_specs", "carry_specs", "head_grains",
           "opt_specs", "param_specs", "param_specs_jax_order", "slot_stacked_spec"]
