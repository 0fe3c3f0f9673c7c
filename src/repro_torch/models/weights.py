"""Parameters of the port: the bridge from JAX param trees, and random init.

The port keeps parameters as plain dictionaries with the JAX leaf names
and layouts (row-vector convention, ``y = x @ W``), but one dict per layer
in stack order instead of JAX's prefix / scanned-blocks / suffix split::

    {"embed": (V, d), "final_norm": (d,), ["lm_head": (d, V)],
     "layers": [{"ln1", "ln2",
                 "attn": {"wq", "l_k", "r_k", "l_v", "wo_fused",
                          ["q_norm", "k_norm"]},
                 "mlp": {"wi", "wg", "wo"}}, ...]}

Norm scales stay float32 (as in JAX); matrices take the model dtype.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, check_supported

Params = dict[str, Any]
NORM_LEAVES = frozenset({"ln1", "ln2", "final_norm", "q_norm", "k_norm"})


def to_tensor(arr, device: torch.device, dtype: torch.dtype | None = None):
    """numpy (or numpy-convertible) array -> tensor on ``device``.  bfloat16
    arrives as ml_dtypes' ``bfloat16`` (from a live JAX array) or as a raw
    2-byte void (from an npz written by JAX): both are reinterpreted as
    torch.bfloat16 bit for bit."""
    a = np.array(arr)            # a writable, contiguous copy
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V" and a.dtype.itemsize == 2):
        t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    t = t.to(device)
    return t if dtype is None else t.to(dtype)


def _leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if name in NORM_LEAVES else dtype


def _convert(tree, device, dtype, index=None):
    """Recursively convert a JAX block dict; ``index`` picks one layer out
    of stacked (scan_layers=True) leaves."""
    out = {}
    for name, leaf in tree.items():
        if isinstance(leaf, dict):
            out[name] = _convert(leaf, device, dtype, index)
            continue
        a = np.asarray(leaf)
        if index is not None:
            a = a[index]
        out[name] = to_tensor(a, device, _leaf_dtype(name, dtype))
    return out


def params_from_jax(cfg: ModelConfig, tree: Params, device=None,
                    dtype: torch.dtype | None = None) -> Params:
    """Turn a JAX param tree (leaves as numpy arrays or anything
    ``np.asarray`` takes) into the port's per-layer params on ``device``.

    Handles stacked ``blocks`` (``scan_layers=True``: leaves carry a
    leading period axis) and unrolled ``prefix`` (``scan_layers=False``,
    where per-layer ranks may differ).  ``dtype`` defaults to ``cfg.dtype``."""
    check_supported(cfg)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    out: Params = {
        "embed": to_tensor(tree["embed"], dev, dtype),
        "final_norm": to_tensor(tree["final_norm"], dev, torch.float32),
    }
    if "lm_head" in tree:
        out["lm_head"] = to_tensor(tree["lm_head"], dev, dtype)
    layers = [_convert(b, dev, dtype) for b in tree.get("prefix", ())]
    blocks = tree.get("blocks") or ()
    if blocks:
        n_per = np.asarray(blocks[0]["ln1"]).shape[0]
        for p in range(n_per):
            layers += [_convert(b, dev, dtype, index=p) for b in blocks]
    layers += [_convert(b, dev, dtype) for b in tree.get("suffix", ())]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"param tree holds {len(layers)} layers, "
                         f"config {cfg.name!r} has {cfg.num_layers}")
    out["layers"] = layers
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                device=None) -> Params:
    """Random parameters with the JAX initializer's scales (normal times
    fan-in scale; norm scales zero).  ``generator`` must live on the
    target device; the draw order is fixed, so a seed gives the same
    model every run."""
    check_supported(cfg)
    dev = resolve_device(device)
    dt = cfg.dtype
    d, V = cfg.d_model, cfg.vocab_size
    H, Hkv, dh = cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    rt = cfg.recalkv
    s = rt.slots(Hkv)
    G = Hkv // s

    def normal(shape, scale):
        x = torch.randn(shape, generator=generator, device=dev,
                        dtype=torch.float32)
        return (x * scale).to(dt)

    def zeros(n):
        return torch.zeros(n, device=dev, dtype=torch.float32)

    params: Params = {"embed": normal((V, d), 0.02), "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, V), d ** -0.5)
    layers = []
    for i in range(cfg.num_layers):
        rk, rv = rt.ranks_for(i)
        attn = {
            "wq": normal((d, H * dh), d ** -0.5),
            "l_k": normal((G, d, rk), d ** -0.5),
            "r_k": normal((G, rk, s * dh), rk ** -0.5),
            "l_v": normal((G, d, rv), d ** -0.5),
            "wo_fused": normal((H, rv, d), (H * rv) ** -0.5),
        }
        if cfg.qk_norm:
            attn["q_norm"] = zeros(dh)
            attn["k_norm"] = zeros(dh)
        f = cfg.d_ff
        mlp = {"wi": normal((d, f), d ** -0.5), "wg": normal((d, f), d ** -0.5),
               "wo": normal((f, d), f ** -0.5)}
        layers.append({"ln1": zeros(d), "attn": attn, "ln2": zeros(d),
                       "mlp": mlp})
    params["layers"] = layers
    return params
