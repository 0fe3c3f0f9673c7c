"""Parameters of the port: the bridge from and to JAX param trees, and
random init; and the bridge for decode-cache state (rings or paged pools)
both ways.

The port keeps parameters as plain dictionaries with the JAX leaf names
and layouts (row-vector convention, ``y = x @ W``), but one dict per layer
in stack order instead of JAX's prefix / scanned-blocks / suffix split::

    {"embed": (V, d), "final_norm": (d,), ["lm_head": (d, V)],
     "layers": [{"ln1", "ln2",
                 "attn": {"wq", "l_k", "r_k", "l_v", "wo_fused",
                          ["q_norm", "k_norm"]},
                 "mlp": {"wi", "wg", "wo"}}, ...]}

A dense model (``cfg.recalkv is None``) has ``"attn": {"wq", "wk", "wv",
"wo", ["q_norm", "k_norm"]}`` instead, and an MLA model (``cfg.mla``)
``"attn": {"wq_a", "q_a_norm", "wq_b", "wkv_a", "kv_a_norm", "wkv_b",
"wo"}``.  An MoE model (``cfg.moe``) has ``"mlp": {"router": (d, E),
"wi", "wg": (E, d, f), "wo": (E, f, d), ["shared": {"wi", "wg", "wo"}]}``,
the JAX package's layout, except on ``attn_dense`` layers, whose FFN is
the dense SwiGLU of width ``d_ff``.

A cross-attention layer holds ``"cross"`` (dense ``{"wq", "wk", "wv",
"wo"}`` or latent ``{"wq", "l_k", "r_k", "l_v", "wo_fused"}`` at the
uniform ranks, ``["q_norm", "k_norm"]``): a ``cross`` layer ``{"ln1",
"cross", "ln2", "mlp"}``, an ``attn_cross`` layer ``{"ln1", "attn",
"lnx", "cross", "ln2", "mlp"}``; both FFNs dense.  An encoder-decoder
model also holds ``"encoder": {"layers": [attn_dense blocks],
"final_norm"}`` (JAX's ``{"blocks": (...), "final_norm"}``).

A recurrent layer holds its mixer: a ``mamba`` layer ``{"ln", "mixer":
{"in_proj", "conv_w", "conv_b", "x_proj", "dt_proj", "dt_bias", "A_log",
"D", "out_proj"}}``, an ``rglru`` layer ``{"ln1", "mixer": {"in_main",
"in_gate", "conv_w", "conv_b", "w_a", "w_x", "a_param", "out_proj"},
"ln2", "mlp"}`` (a dense FFN).

Norm scales, the MoE router and the mixers' ``A_log``, ``dt_bias``,
``D`` and ``a_param`` stay float32 (as in JAX); the other leaves take the
model dtype.
"""

from __future__ import annotations

import math
from typing import Any

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, check_supported

Params = dict[str, Any]
NORM_LEAVES = frozenset({"ln", "ln1", "ln2", "lnx", "final_norm", "q_norm", "k_norm",
                         "q_a_norm", "kv_a_norm"})
# kept float32 whatever the model dtype
F32_LEAVES = NORM_LEAVES | {"router", "A_log", "dt_bias", "D", "a_param"}


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


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """The inverse of :func:`to_tensor`: a host numpy array; bfloat16 as
    ml_dtypes' ``bfloat16`` where that package is installed (as a live
    JAX array gives it), else as the raw 2-byte void an npz holds."""
    t = t.detach().cpu()
    if t.dtype != torch.bfloat16:
        return t.numpy()
    raw = t.view(torch.int16).numpy()
    try:
        import ml_dtypes
    except ImportError:
        return raw.view("V2")
    return raw.view(ml_dtypes.bfloat16)


def _leaf_dtype(name: str, dtype: torch.dtype) -> torch.dtype:
    return torch.float32 if name in F32_LEAVES else dtype


def _lead(tree) -> int:
    """The leading axis of a stacked block's first leaf: its periods."""
    leaf = next(iter(tree.values()))
    return _lead(leaf) if isinstance(leaf, dict) else np.asarray(leaf).shape[0]


def _stack(trees: list) -> Params:
    """Stack equal trees of numpy leaves along a new leading (period) axis."""
    return {k: _stack([t[k] for t in trees]) if isinstance(trees[0][k], dict)
            else np.stack([t[k] for t in trees]) for k in trees[0]}


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
        for p in range(_lead(blocks[0])):
            layers += [_convert(b, dev, dtype, index=p) for b in blocks]
    layers += [_convert(b, dev, dtype) for b in tree.get("suffix", ())]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"param tree holds {len(layers)} layers, "
                         f"config {cfg.name!r} has {cfg.num_layers}")
    out["layers"] = layers
    if "encoder" in tree:
        enc = tree["encoder"]
        out["encoder"] = {
            "layers": [_convert(b, dev, dtype) for b in enc["blocks"]],
            "final_norm": to_tensor(enc["final_norm"], dev, torch.float32)}
    return out


def params_to_jax(cfg: ModelConfig, params: Params) -> Params:
    """The inverse of :func:`params_from_jax`: the JAX package's tree for
    ``cfg``'s layer layout, with numpy leaves (see :func:`to_numpy`).
    With ``scan_layers=False`` every layer sits in ``"prefix"`` (what an
    artifact stores); else the prefix layers are unrolled, the scanned
    periods' leaves stacked in ``"blocks"``, and the remainder in
    ``"suffix"``."""
    if len(params["layers"]) != cfg.num_layers:
        raise ValueError(f"params hold {len(params['layers'])} layers, "
                         f"config {cfg.name!r} has {cfg.num_layers}")

    def conv(tree):
        return {k: conv(v) if isinstance(v, dict) else to_numpy(v)
                for k, v in tree.items()}

    out = {k: to_numpy(params[k]) for k in ("embed", "final_norm", "lm_head")
           if k in params}
    if "encoder" in params:
        enc = params["encoder"]
        out["encoder"] = {"blocks": tuple(conv(b) for b in enc["layers"]),
                          "final_norm": to_numpy(enc["final_norm"])}
    layers = params["layers"]
    if not cfg.scan_layers:
        out.update(prefix=tuple(conv(layer) for layer in layers), blocks=(), suffix=())
        return out
    n_pre, period, n_per = len(cfg.prefix_pattern), cfg.period, cfg.num_periods
    body = [conv(layer) for layer in layers[n_pre:n_pre + period * n_per]]
    out.update(prefix=tuple(conv(layer) for layer in layers[:n_pre]),
               blocks=tuple(_stack(body[i::period]) for i in range(period)) if n_per else (),
               suffix=tuple(conv(layer) for layer in layers[n_pre + period * n_per:]))
    return out


# The largest float32 draw ``init_params`` makes at once: a bigger leaf
# (deepseek's (256, 7168, 2048) expert leaves would be 15 GB) is drawn in
# slices along its first axis.  Every leaf of the other registered archs
# is below it, so their draws are unchanged.
DRAW_BYTES = 4 << 30


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

    def normal(shape, scale, dtype=dt):
        def draw(sh):
            x = torch.randn(sh, generator=generator, device=dev, dtype=torch.float32)
            return x.mul_(scale).to(dtype)

        if 4 * math.prod(shape) <= DRAW_BYTES:
            return draw(shape)
        out = torch.empty(shape, device=dev, dtype=dtype)
        step = max(1, DRAW_BYTES // (4 * math.prod(shape[1:])))
        for i in range(0, shape[0], step):
            out[i:i + step] = draw(out[i:i + step].shape)
        return out

    def zeros(n, dtype=torch.float32):
        return torch.zeros(n, device=dev, dtype=dtype)

    def swiglu(f):
        return {"wi": normal((d, f), d ** -0.5), "wg": normal((d, f), d ** -0.5),
                "wo": normal((f, d), f ** -0.5)}

    def gqa(rk, rv):
        """Dense or latent (at ranks rk / rv) attention weights."""
        attn = {"wq": normal((d, H * dh), d ** -0.5)}
        if rt is None:
            attn.update(wk=normal((d, Hkv * dh), d ** -0.5),
                        wv=normal((d, Hkv * dh), d ** -0.5),
                        wo=normal((H * dh, d), (H * dh) ** -0.5))
        else:
            s = rt.slots(Hkv)
            G = Hkv // s
            attn.update(l_k=normal((G, d, rk), d ** -0.5),
                        r_k=normal((G, rk, s * dh), rk ** -0.5),
                        l_v=normal((G, d, rv), d ** -0.5),
                        wo_fused=normal((H, rv, d), (H * rv) ** -0.5))
        if cfg.qk_norm:
            attn["q_norm"] = zeros(dh)
            attn["k_norm"] = zeros(dh)
        return attn

    uniform = (rt.rank_k, rt.rank_v) if rt is not None else (0, 0)
    params: Params = {"embed": normal((V, d), 0.02), "final_norm": zeros(d)}
    if not cfg.tie_embeddings:
        params["lm_head"] = normal((d, V), d ** -0.5)
    layers = []
    for i, kind in enumerate(cfg.expanded_layers()):
        if kind == "mamba":
            di, ds, dtr, K = (cfg.mamba_d_inner, cfg.mamba.d_state, cfg.mamba_dt_rank,
                              cfg.mamba.d_conv)
            A = torch.arange(1, ds + 1, device=dev, dtype=torch.float32).expand(di, ds)
            layers.append({"ln": zeros(d), "mixer": {
                "in_proj": normal((d, 2 * di), d ** -0.5),
                "conv_w": normal((K, di), K ** -0.5), "conv_b": zeros(di, dt),
                "x_proj": normal((di, dtr + 2 * ds), di ** -0.5),
                "dt_proj": normal((dtr, di), dtr ** -0.5),
                "dt_bias": zeros(di) - 4.0, "A_log": torch.log(A),
                "D": zeros(di) + 1.0, "out_proj": normal((di, d), di ** -0.5)}})
            continue
        if kind == "rglru":
            W, K = cfg.lru_width, cfg.rglru.conv_width
            layers.append({"ln1": zeros(d), "mixer": {
                "in_main": normal((d, W), d ** -0.5), "in_gate": normal((d, W), d ** -0.5),
                "conv_w": normal((K, W), K ** -0.5), "conv_b": zeros(W, dt),
                "w_a": normal((W, W), W ** -0.5), "w_x": normal((W, W), W ** -0.5),
                "a_param": zeros(W) + 0.65, "out_proj": normal((W, d), W ** -0.5)},
                "ln2": zeros(d), "mlp": swiglu(cfg.d_ff)})
            continue
        if kind == "cross":
            layers.append({"ln1": zeros(d), "cross": gqa(*uniform), "ln2": zeros(d),
                           "mlp": swiglu(cfg.d_ff)})
            continue
        if cfg.mla is not None:
            a = cfg.mla
            qk, kv = a.qk_nope_dim + a.qk_rope_dim, a.qk_nope_dim + a.v_head_dim
            attn = {"wq_a": normal((d, a.q_lora_rank), d ** -0.5),
                    "q_a_norm": zeros(a.q_lora_rank),
                    "wq_b": normal((a.q_lora_rank, H * qk), a.q_lora_rank ** -0.5),
                    "wkv_a": normal((d, a.kv_lora_rank + a.qk_rope_dim), d ** -0.5),
                    "kv_a_norm": zeros(a.kv_lora_rank),
                    "wkv_b": normal((a.kv_lora_rank, H * kv), a.kv_lora_rank ** -0.5),
                    "wo": normal((H * a.v_head_dim, d), (H * a.v_head_dim) ** -0.5)}
        else:
            attn = gqa(*(rt.ranks_for(i) if rt is not None else uniform))
        if kind == "attn_cross":
            layers.append({"ln1": zeros(d), "attn": attn, "lnx": zeros(d),
                           "cross": gqa(*uniform), "ln2": zeros(d),
                           "mlp": swiglu(cfg.d_ff)})
            continue
        if cfg.moe is None or kind == "attn_dense":
            mlp = swiglu(cfg.d_ff)
        else:   # one leaf at a time: an expert leaf of qwen3-moe is 1.6 GB
            E, f = cfg.moe.num_experts, cfg.moe.d_expert
            mlp = {"router": normal((d, E), d ** -0.5, torch.float32),
                   "wi": normal((E, d, f), d ** -0.5), "wg": normal((E, d, f), d ** -0.5),
                   "wo": normal((E, f, d), f ** -0.5)}
            if cfg.moe.num_shared:
                mlp["shared"] = swiglu(f * cfg.moe.num_shared)
        layers.append({"ln1": zeros(d), "attn": attn, "ln2": zeros(d),
                       "mlp": mlp})
    params["layers"] = layers
    if cfg.encoder_decoder:
        params["encoder"] = {
            "layers": [{"ln1": zeros(d), "attn": gqa(*uniform), "ln2": zeros(d),
                        "mlp": swiglu(cfg.d_ff)}
                       for _ in range(cfg.num_encoder_layers)],
            "final_norm": zeros(d)}
    return params


def caches_from_jax(cfg: ModelConfig, tree: Params, device=None) -> list:
    """Turn a JAX decode-cache tree (``{"prefix", "blocks", "suffix"}``,
    stacked ``blocks`` leaves carrying a leading period axis; leaves as
    numpy arrays) into the port's per-layer list of ``{"self": {...}}``
    dicts (``"cross"`` beside or instead of ``"self"`` on cross-attention
    layers; a recurrent layer's one-level ``{"h", "conv"}`` becomes
    ``{"state": {"h", "conv"}}``).  Works for rings and page-major pools
    alike; ``pos`` becomes int64, other leaves keep their dtype."""
    dev = resolve_device(device)

    def conv(block, index=None):
        if not isinstance(next(iter(block.values())), dict):
            block = {"state": block}
        out = {}
        for part, leaves in block.items():
            out[part] = {}
            for name, leaf in leaves.items():
                a = np.asarray(leaf)
                if index is not None:
                    a = a[index]
                out[part][name] = to_tensor(a, dev, torch.int64 if name == "pos" else None)
        return out

    layers = [conv(b) for b in tree.get("prefix") or ()]
    blocks = tree.get("blocks") or ()
    if blocks:
        for p in range(_lead(blocks[0])):
            layers += [conv(b, p) for b in blocks]
    layers += [conv(b) for b in tree.get("suffix") or ()]
    if len(layers) != cfg.num_layers:
        raise ValueError(f"cache tree holds {len(layers)} layers, config "
                         f"{cfg.name!r} has {cfg.num_layers}")
    return layers


def caches_to_jax(cfg: ModelConfig, caches: list) -> Params:
    """The inverse of :func:`caches_from_jax`: the JAX package's cache tree
    for ``cfg``'s layer layout, with numpy leaves (``pos`` int32; bf16 as
    ml_dtypes' bfloat16; a recurrent layer's state one level deep)."""
    def conv(c):
        out = {part: {k: (to_numpy(v).astype(np.int32) if k == "pos"
                          else to_numpy(v))
                      for k, v in leaves.items()}
               for part, leaves in c.items()}
        return out["state"] if "state" in out else out

    if not cfg.scan_layers:
        return {"prefix": tuple(conv(c) for c in caches), "blocks": None,
                "suffix": ()}
    n_pre, period, n_per = len(cfg.prefix_pattern), cfg.period, cfg.num_periods
    body = [conv(c) for c in caches[n_pre:n_pre + period * n_per]]
    blocks = tuple(_stack(body[i::period]) for i in range(period)) if n_per else None
    return {"prefix": tuple(conv(c) for c in caches[:n_pre]), "blocks": blocks,
            "suffix": tuple(conv(c) for c in caches[n_pre + period * n_per:])}
