"""K3 and K6 — K1 and K5 over an int8 latent ring: CUDA kernels, plain
versions, wrappers.

K3 replaces ``src/repro/kernels/latent_decode_q.py::
latent_decode_attention_quant`` and K6 ``latent_decode_attention_mq_quant``
(the Pallas TPU kernels).  The ring holds int8 latents ``zk_q``/``zv_q``
(B, S, G, r) with float32 scales ``zk_s``/``zv_s`` (B, S, G), one per
(token, group); dequantization (q * scale) happens on chip: the key scale
multiplies each rebuilt key row, the value scale the softmax weight of its
column.  A ring token then costs r_k + r_v + 8 bytes per group instead of
2 (r_k + r_v) at bf16.

K3 and K6 with bf16 q and r_k run the tensor-core body of
``csrc/latent_decode_tc.cu`` (the int8 latents converted to bf16 on their
way into shared memory, which is exact): K3 is K1's instantiation with
int8 latents (one query, 256 ring columns per block up to rank 256), K6
is K5's, scoring up to 4 query sets per head slot in 128-column blocks
(64 at ranks where 128 columns do not fit).  With
float32 q and r_k both run their parity instantiations on the CUDA-core
template of ``csrc/latent_decode.cu``.

The deferred-write tokens are operands, as for K1 and K5, in the ring's
own int8 layout: K3 takes ``self_zk_q`` (B, G, r_k) int8 with
``self_zk_s`` (B, G) (and the value pair); K6 takes (B, nq, G, r) and
(B, nq, G).  They are the quantized fresh latents, so the kernel scores
their quantize -> dequantize round trip, as the JAX wrapper does when it
appends the quantized entry to the ring.
"""

from __future__ import annotations

import torch

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
                                        self_sin=None, return_lse=False):
    """Plain version of K3: dequantize, then K1's plain version (float32)."""
    return latent_decode_attention_plain(
        q, _deq(zk_q, zk_s), _deq(zv_q, zv_s), r_k, cos, sin, bias, scale=scale,
        k_norm=k_norm, norm_eps=norm_eps, self_zk=_deq(self_zk_q, self_zk_s),
        self_zv=_deq(self_zv_q, self_zv_s), self_cos=self_cos, self_sin=self_sin,
        return_lse=return_lse)


def latent_decode_attention_mq_quant_plain(q, zk_q, zk_s, zv_q, zv_s, r_k,
                                           cos, sin, bias, *, scale,
                                           k_norm=None, norm_eps=1e-6,
                                           self_zk_q=None, self_zk_s=None,
                                           self_zv_q=None, self_zv_s=None,
                                           self_cos=None, self_sin=None,
                                           return_lse=False):
    """Plain version of K6: dequantize, then K5's plain version."""
    return latent_decode_attention_mq_plain(
        q, _deq(zk_q, zk_s), _deq(zv_q, zv_s), r_k, cos, sin, bias, scale=scale,
        k_norm=k_norm, norm_eps=norm_eps, self_zk=_deq(self_zk_q, self_zk_s),
        self_zv=_deq(self_zv_q, self_zv_s), self_cos=self_cos, self_sin=self_sin,
        return_lse=return_lse)


def latent_decode_attention_quant(q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin,
                                  bias, *, scale, k_norm=None, norm_eps=1e-6,
                                  self_zk_q=None, self_zk_s=None,
                                  self_zv_q=None, self_zv_s=None,
                                  self_cos=None, self_sin=None, return_lse=False):
    """K3.  A CPU tensor runs the plain version; a CUDA tensor runs the
    CUDA kernel or raises: bf16 q the tensor-core body, float32 q the
    template.  ``.launches`` counts kernel launches."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps,
              self_zk_q=self_zk_q, self_zk_s=self_zk_s, self_zv_q=self_zv_q,
              self_zv_s=self_zv_s, self_cos=self_cos, self_sin=self_sin,
              return_lse=return_lse)
    if not _on_device("int8 latent decode", q):
        return latent_decode_attention_quant_plain(
            q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin, bias, **kw)
    entry = ("recalkv_latent_decode_quant_tc" if q.dtype == torch.bfloat16
             else "recalkv_latent_decode_quant")
    out = launch(entry, q, zk_q, zv_q, r_k, cos, sin, bias, scale, k_norm,
                 norm_eps, self_zk_q, self_zv_q, self_cos, self_sin,
                 scales=(zk_s, zv_s, self_zk_s, self_zv_s), return_lse=return_lse)
    latent_decode_attention_quant.launches += 1
    latent_decode_attention_quant.lse_launches += int(return_lse)
    return out


def latent_decode_attention_mq_quant(q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin,
                                     bias, *, scale, k_norm=None,
                                     norm_eps=1e-6, self_zk_q=None,
                                     self_zk_s=None, self_zv_q=None,
                                     self_zv_s=None, self_cos=None,
                                     self_sin=None, return_lse=False):
    """K6: K5 over the int8 ring.  Device rule and counter as for K3; bf16
    q runs the tensor-core body, float32 q the template."""
    kw = dict(scale=scale, k_norm=k_norm, norm_eps=norm_eps,
              self_zk_q=self_zk_q, self_zk_s=self_zk_s, self_zv_q=self_zv_q,
              self_zv_s=self_zv_s, self_cos=self_cos, self_sin=self_sin,
              return_lse=return_lse)
    if not _on_device("int8 multi-query latent decode", q):
        return latent_decode_attention_mq_quant_plain(
            q, zk_q, zk_s, zv_q, zv_s, r_k, cos, sin, bias, **kw)
    entry = ("recalkv_latent_decode_mq_quant_tc" if q.dtype == torch.bfloat16
             else "recalkv_latent_decode_mq_quant")
    out = launch(entry, q, zk_q, zv_q, r_k, cos, sin, bias, scale, k_norm,
                 norm_eps, self_zk_q, self_zv_q, self_cos, self_sin,
                 nq=bias.shape[1], scales=(zk_s, zv_s, self_zk_s, self_zv_s),
                 return_lse=return_lse)
    latent_decode_attention_mq_quant.launches += 1
    latent_decode_attention_mq_quant.lse_launches += int(return_lse)
    return out


latent_decode_attention_quant.launches = 0
latent_decode_attention_quant.lse_launches = 0
latent_decode_attention_mq_quant.launches = 0
latent_decode_attention_mq_quant.lse_launches = 0
