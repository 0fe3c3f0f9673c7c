"""Built-in KV-compression strategies (port of ``repro.api.strategies``).

The SVD family is one parametric compressor; each registry entry is a
preconfigured instance:

  recalkv        HSR head reordering + whitened SVD + offline calibration
                 (the paper's full Algorithm 1)
  recalkv-hsr    HSR only (paper Table 3 "HSR" row)
  recalkv-calib  offline calibration only (paper Table 3 "calib" row)
  whitened-svd   SVD-LLM-style whitening only (Palu G-LRD + whitening)
  grouped-svd    plain grouped SVD — no reordering, no data awareness

``quantized-latent`` composes: it runs any base strategy, then fake-
quantizes the latent factors (optionally after a folded randomized-
Hadamard rotation of the latent space).  A strategy's info (and so the
artifact's provenance) carries each layer's compression report
(``CompressedAttention.report``) under "layers".
"""

from __future__ import annotations

import dataclasses
from typing import Any

import repro_torch.models.compress as C
from repro_torch.api.registry import get_strategy, register_strategy
from repro_torch.api.spec import CalibrationData, CompressionSpec
from repro_torch.core import pipeline as P
from repro_torch.models.config import ModelConfig
from repro_torch.quant import fake_quant, hadamard_transform


def _merged_options(defaults: dict, spec: CompressionSpec, name: str) -> dict:
    opts = dict(defaults)
    unknown = set(spec.options) - set(defaults)
    if unknown:
        raise ValueError(f"{name}: unknown options {sorted(unknown)}; "
                         f"accepted: {sorted(defaults)}")
    opts.update(spec.options)
    return opts


@dataclasses.dataclass(frozen=True)
class SVDCompressor:
    """Grouped low-rank K/V factorization with optional HSR / whitening /
    calibration — the whole ReCalKV ablation family."""

    name: str
    use_hsr: bool
    use_calibration: bool
    use_whitening: bool
    calib_iters: int = 8

    def _option_defaults(self) -> dict:
        return {"use_hsr": self.use_hsr, "use_calibration": self.use_calibration,
                "use_whitening": self.use_whitening,
                "calib_iters": self.calib_iters}

    def _recal_config(self, spec: CompressionSpec, opts: dict) -> P.ReCalKVConfig:
        pol = spec.rank_policy
        return P.ReCalKVConfig(
            keep_ratio=pol.keep_ratio, group_size=pol.group_size,
            use_hsr=opts["use_hsr"], use_calibration=opts["use_calibration"],
            use_whitening=opts["use_whitening"], use_fisher=pol.use_fisher,
            calib_iters=opts["calib_iters"], rank_multiple=pol.rank_multiple,
            min_rank=pol.min_rank, alpha=pol.alpha, rho_min=pol.rho_min,
            rho_max=pol.rho_max)

    def compress(self, cfg: ModelConfig, params: Any, spec: CompressionSpec,
                 calib: CalibrationData) -> tuple[ModelConfig, Any, dict]:
        opts = _merged_options(self._option_defaults(), spec, self.name)
        rc = self._recal_config(spec, opts)
        if spec.rank_policy.use_fisher and calib.fisher_k is None:
            raise ValueError(
                f"{self.name}: rank_policy.use_fisher=True but the "
                "calibration data carries no Fisher scores — capture with "
                "calibrate(..., fisher=True)")
        stats = calib.stats
        if stats is None:
            if opts["use_whitening"] or opts["use_calibration"]:
                raise ValueError(
                    f"{self.name}: whitening/calibration need calibration "
                    "data — pass calib batches (or use 'grouped-svd')")
            dev = params["embed"].device
            stats = [P.CalibStats.identity(cfg.d_model, device=dev)
                     for _ in C.attn_layer_indices(cfg)]
        reports: list = []
        ccfg, cparams = C.compress_model(cfg, params, stats, rc, calib.fisher_k,
                                         calib.fisher_v, reports=reports)
        return ccfg, cparams, {"options": opts, "layers": reports}


@dataclasses.dataclass(frozen=True)
class QuantizedLatentCompressor:
    """Composition wrapper: run ``base``, then fake-quantize the latent
    factors (L_k, R_k, L_v) at ``bits``; with ``hadamard=True`` a seeded
    randomized-Hadamard rotation of the latent space is folded into the
    factors first (and inverted through the fused output projection)."""

    name: str = "quantized-latent"

    def _option_defaults(self) -> dict:
        return {"base": "recalkv", "bits": 8, "hadamard": False,
                "base_options": {}}

    def compress(self, cfg: ModelConfig, params: Any, spec: CompressionSpec,
                 calib: CalibrationData) -> tuple[ModelConfig, Any, dict]:
        opts = _merged_options(self._option_defaults(), spec, self.name)
        if opts["base"] == self.name:
            raise ValueError("quantized-latent cannot wrap itself")
        base = get_strategy(opts["base"])
        base_spec = CompressionSpec(method=opts["base"],
                                    options=dict(opts["base_options"]),
                                    rank_policy=spec.rank_policy)
        ccfg, cparams, info = base.compress(cfg, params, base_spec, calib)
        cparams = _quantize_latent_factors(cparams, bits=opts["bits"],
                                           hadamard=opts["hadamard"])
        info = dict(info)
        info.update(base=opts["base"], bits=opts["bits"], hadamard=opts["hadamard"])
        return ccfg, cparams, info


def _rotate_left_inverse(w):
    """The inverse Hadamard rotation along axis -2 (the latent rank axis
    of R_k / W~_o), compensating a forward rotation of the latents."""
    return hadamard_transform(w.transpose(-1, -2)).transpose(-1, -2)


def _quantize_latent_factors(params, *, bits: int, hadamard: bool):
    """Fake-quantize the low-rank factors (L_k, R_k, L_v) of every latent
    layer, self- and cross-attention — weight-space PTQ of the factorization, not runtime
    quantization of the cached latents.  ``wo_fused`` stays full
    precision but is rotated to undo the L_v rotation."""
    def one_block(p: dict) -> dict:
        p = dict(p)
        l_k, r_k, l_v = p["l_k"], p["r_k"], p["l_v"]
        if hadamard:
            l_k = hadamard_transform(l_k)
            r_k = _rotate_left_inverse(r_k)
            l_v = hadamard_transform(l_v)
            p["wo_fused"] = _rotate_left_inverse(p["wo_fused"])
        p["l_k"] = fake_quant(l_k, bits)
        p["r_k"] = fake_quant(r_k, bits)
        p["l_v"] = fake_quant(l_v, bits)
        return p

    layers = [{**layer, **{sub: one_block(layer[sub]) for sub in ("attn", "cross")
                           if sub in layer and "l_k" in layer[sub]}}
              for layer in params["layers"]]
    return {**params, "layers": layers}


register_strategy(SVDCompressor(
    "recalkv", use_hsr=True, use_calibration=True, use_whitening=True))
register_strategy(SVDCompressor(
    "recalkv-hsr", use_hsr=True, use_calibration=False, use_whitening=True))
register_strategy(SVDCompressor(
    "recalkv-calib", use_hsr=False, use_calibration=True, use_whitening=True))
register_strategy(SVDCompressor(
    "whitened-svd", use_hsr=False, use_calibration=False, use_whitening=True))
register_strategy(SVDCompressor(
    "grouped-svd", use_hsr=False, use_calibration=False, use_whitening=False))
register_strategy(QuantizedLatentCompressor())
