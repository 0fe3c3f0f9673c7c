"""K3 and K6 — K1 and K5 over an int8 latent ring: CUDA kernels, plain
versions, wrappers.

K3 replaces ``src/repro/kernels/latent_decode_q.py::
latent_decode_attention_quant`` and K6 ``latent_decode_attention_mq_quant``
(the Pallas TPU kernels).  The ring holds int8 latents ``zk_q``/``zv_q``
(B, S, G, r) with float32 scales ``zk_s``/``zv_s`` (B, S, G), one per
(token, group); dequantization (q * scale) happens on chip, in the same
templated kernel as K1 and K5 (``csrc/latent_decode.cu``).  A ring token
then costs r_k + r_v + 8 bytes per group instead of 2 (r_k + r_v) at bf16.

The deferred-write tokens are operands, as for K1 and K5, in the ring's
own int8 layout: K3 takes ``self_zk_q`` (B, G, r_k) int8 with
``self_zk_s`` (B, G) (and the value pair); K6 takes (B, nq, G, r) and
(B, nq, G).  They are the quantized fresh latents, so the kernel scores
their quantize -> dequantize round trip, as the JAX wrapper does when it
appends the quantized entry to the ring.
"""

from __future__ import annotations

from repro_torch.kernels.latent_decode import (
    _on_device, latent_decode_attention_mq_plain, latent_decode_attention_plain,
    launch)
from repro_torch.quant import dequantize


def _deq(q, s):
    return None if q is None else dequantize(q, s[..., None])


def latent_decode_attention_quant_plain(q, zk_q, zk_s, zv_q, zv_s, r_k, cos,
                                        sin, bias, *, scale, k_norm=None,
                                        norm_eps=1e-6, self_zk_q=None,
                                        self_zk_s=None, self_zv_q=None,
                                        self_zv_s=None, self_cos=None,
                                        self_sin=None):
    """Plain version of K3: dequantize, then K1's plain version (float32)."""
    return latent_decode_attention_plain(
        q, _deq(zk_q, zk_s), _deq(zv_q, zv_s), r_k, cos, sin, bias, scale=scale,
        k_norm=k_norm, norm_eps=norm_eps, self_zk=_deq(self_zk_q, self_zk_s),
        self_zv=_deq(self_zv_q, self_zv_s), self_cos=self_cos, self_sin=self_sin)


def latent_decode_attention_mq_quant_plain(q, zk_q, zk_s, zv_q, zv_s, r_k,
                                           cos, sin, bias, *, scale,
                                           k_norm=None, norm_eps=1e-6,
                                           self_zk_q=None, self_zk_s=None,
                                           self_zv_q=None, self_zv_s=None,
                                           self_cos=None, self_sin=None):
    """Plain version of K6: dequantize, then K5's plain version."""
    return latent_decode_attention_mq_plain(
        q, _deq(zk_q, zk_s), _deq(zv_q, zv_s), r_k, cos, sin, bias, scale=scale,
        k_norm=k_norm, norm_eps=norm_eps, self_zk=_deq(self_zk_q, self_zk_s),
        self_zv=_deq(self_zv_q, self_zv_s), self_cos=self_cos, self_sin=self_sin)


def latent_decode_attention_quant(q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin,
                                  bias, *, scale, k_norm=None, norm_eps=1e-6,
                                  self_zk_q=None, self_zk_s=None,
                                  self_zv_q=None, self_zv_s=None,
                                  self_cos=None, self_sin=None):
    """K3.  A CPU tensor runs the plain version; a CUDA tensor runs the
    CUDA kernel or raises.  ``.launches`` counts kernel launches."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps,
              self_zk_q=self_zk_q, self_zk_s=self_zk_s, self_zv_q=self_zv_q,
              self_zv_s=self_zv_s, self_cos=self_cos, self_sin=self_sin)
    if not _on_device("int8 latent decode", q):
        return latent_decode_attention_quant_plain(
            q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin, bias, **kw)
    out = launch("recalkv_latent_decode_quant", q, zk_q, zv_q, r_k, cos, sin,
                 bias, scale, k_norm, norm_eps, self_zk_q, self_zv_q, self_cos,
                 self_sin, scales=(zk_s, zv_s, self_zk_s, self_zv_s))
    latent_decode_attention_quant.launches += 1
    return out


def latent_decode_attention_mq_quant(q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin,
                                     bias, *, scale, k_norm=None,
                                     norm_eps=1e-6, self_zk_q=None,
                                     self_zk_s=None, self_zv_q=None,
                                     self_zv_s=None, self_cos=None,
                                     self_sin=None):
    """K6: K5 over the int8 ring.  Device rule and counter as for K3."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps,
              self_zk_q=self_zk_q, self_zk_s=self_zk_s, self_zv_q=self_zv_q,
              self_zv_s=self_zv_s, self_cos=self_cos, self_sin=self_sin)
    if not _on_device("int8 multi-query latent decode", q):
        return latent_decode_attention_mq_quant_plain(
            q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin, bias, **kw)
    out = launch("recalkv_latent_decode_mq_quant", q, zk_q, zv_q, r_k, cos, sin,
                 bias, scale, k_norm, norm_eps, self_zk_q, self_zv_q, self_cos,
                 self_sin, nq=bias.shape[1],
                 scales=(zk_s, zv_s, self_zk_s, self_zv_s))
    latent_decode_attention_mq_quant.launches += 1
    return out


latent_decode_attention_quant.launches = 0
latent_decode_attention_mq_quant.launches = 0
