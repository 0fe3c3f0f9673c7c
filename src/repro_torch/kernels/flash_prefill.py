"""K2 — causal / sliding-window flash prefill: CUDA kernel, plain version,
wrapper.

Replaces ``src/repro/kernels/flash_prefill.py::flash_prefill_attention``
(the Pallas TPU kernel).  The CUDA source is ``csrc/flash_prefill.cu``;
its header says what bounds it on an H100 and how the design answers it.
On a CUDA tensor it serves dh 64, 80, 128 or 256 and any dv that is a multiple of
8 up to 1024 (value columns in slices of at most 256 per block).

q (B, T, H, dh); k (B, T, Hkv, dh); v (B, T, Hv, dv) -> (B, T, H, dv).
Query head h reads kv head ``h // (H // Hkv)`` and value group
``h // (H // Hv)`` (kv-major head order): on the ReCalKV prefill path the
values are the latent groups, Hv = G and dv = r_v.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from repro_torch.kernels import build

NEG_INF = -1e30


def flash_prefill_attention_plain(q, k, v, *, causal=True, window=None,
                                  scale=None):
    """Plain PyTorch version (port of ``repro.kernels.ref`` with the value
    groups ``Hv`` and width ``dv``), in float32."""
    B, T, H, dh = q.shape
    Hkv, Hv, dv = k.shape[2], v.shape[2], v.shape[3]
    scale = scale if scale is not None else dh ** -0.5
    qr = q.float().reshape(B, T, Hkv, H // Hkv, dh)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qr, k.float()) * scale
    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None, :]
    m = torch.ones((T, T), dtype=torch.bool, device=q.device)
    if causal:
        m &= j <= i
    if window is not None:
        m &= j > i - window
    logits = torch.where(m, logits, torch.full_like(logits, NEG_INF))
    w = torch.softmax(logits, dim=-1).reshape(B, Hv, H // Hv, T, T)
    o = torch.einsum("bvhqs,bsvd->bqvhd", w, v.float())
    return o.reshape(B, T, H, dv).to(q.dtype)


def _lib():
    lib = build.load("flash_prefill")
    if not lib.recalkv_flash_prefill.argtypes:
        p = ctypes.c_void_p
        lib.recalkv_flash_prefill.argtypes = (
            [ctypes.c_int] * 3 + [p] * 4 + [ctypes.c_int] * 7
            + [ctypes.c_float, p])
        lib.recalkv_flash_prefill.restype = ctypes.c_int
        lib.recalkv_flash_prefill_supports.argtypes = [ctypes.c_int] * 2
        lib.recalkv_flash_prefill_supports.restype = ctypes.c_int
    return lib


def _launch(q, k, v, causal, window, scale):
    B, T, H, dh = q.shape
    Hkv, Hv, dv = k.shape[2], v.shape[2], v.shape[3]
    dt = q.dtype
    if dt not in (torch.bfloat16, torch.float32) or k.dtype != dt or v.dtype != dt:
        raise TypeError(f"flash prefill kernel takes bf16 or f32 q/k/v of one "
                        f"dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if H % Hkv or H % Hv or k.shape[:2] != (B, T) or v.shape[:2] != (B, T):
        raise ValueError(f"bad shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    lib = _lib()
    if not lib.recalkv_flash_prefill_supports(dh, dv):
        raise ValueError(f"flash prefill kernel has no (dh={dh}, dv={dv}) "
                         f"instantiation (dh 64, 80, 128 or 256, dv a multiple of 8 up "
                         f"to 1024)")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    out = torch.empty((B, T, H, dv), device=q.device, dtype=dt)
    err = lib.recalkv_flash_prefill(
        int(dt == torch.bfloat16), dh, dv, q.data_ptr(), k.data_ptr(),
        v.data_ptr(), out.data_ptr(), B, T, H, Hkv, Hv, int(causal),
        0 if window is None else int(window), float(scale),
        torch.cuda.current_stream(q.device).cuda_stream)
    build.check(err, "flash_prefill")
    with _COUNT_LOCK:   # the overlapped engine prefills on two threads
        flash_prefill_attention.launches += 1
    return out


def flash_prefill_attention(q, k, v, *, causal=True, window=None, scale=None):
    """K2.  A CPU tensor runs the plain version; a CUDA tensor runs the
    CUDA kernel (built at first use) or raises — there is no fallback.
    ``flash_prefill_attention.launches`` counts kernel launches."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if q.device.type == "cpu":
        return flash_prefill_attention_plain(q, k, v, causal=causal,
                                             window=window, scale=scale)
    if q.device.type != "cuda":
        raise RuntimeError(f"flash prefill: no kernel for device {q.device}")
    return _launch(q, k, v, causal, window, scale)


flash_prefill_attention.launches = 0
_COUNT_LOCK = threading.Lock()
