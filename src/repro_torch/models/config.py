"""Model configuration (port of ``repro.models.config``).

The dataclasses carry every field of the JAX configuration so that a
``model_config`` dict written by the JAX package loads unchanged
(:meth:`ModelConfig.from_dict`).  The port's model functions implement
every block kind of ``BLOCK_KINDS`` — ``attn``, ``attn_dense`` (always a
dense FFN: DeepSeek's first-k-dense prefix) and sliding-window ``local``
blocks, each with a dense SwiGLU FFN or a capacity-routed MoE FFN
(``moe``), over a dense K/V cache (``recalkv=None``), a ReCalKV latent
cache, float or int8 (``cache_quant_bits``), or DeepSeek's MLA latent
cache (``mla``); cross-attention blocks (``cross``, and ``attn_cross``:
self- then cross-attention, the decoder of an ``encoder_decoder`` model)
over a static source cache; and the recurrent mixers, Mamba-1
(``mamba``, no FFN) and RG-LRU (``rglru``, with a dense FFN), over a
recurrent state.  :func:`check_supported` names what a card's kernels
do not serve.

``attn_backend`` takes ``"einsum"`` (plain PyTorch reference) or
``"kernel"`` (the hand-written CUDA kernels through ``kernels.ops``); the
JAX name ``"pallas"`` maps to ``"kernel"`` on the way in, and
:meth:`to_dict` writes ``"kernel"`` back as ``"pallas"``, so a dict either
package writes loads in the other.  ``dtype`` is a ``torch.dtype``;
:meth:`to_dict` writes it by name as the JAX package does.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

BLOCK_KINDS = ("attn", "attn_dense", "local", "cross", "attn_cross", "mamba", "rglru")
# kinds whose cache is a recurrent state, not position-addressed entries
RECURRENT_KINDS = ("mamba", "rglru")
ATTN_BACKENDS = ("einsum", "kernel")
_BACKEND_ALIASES = {"pallas": "kernel"}
_JAX_BACKEND_NAMES = {v: k for k, v in _BACKEND_ALIASES.items()}


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_expert: int
    num_shared: int = 0
    first_k_dense: int = 0
    capacity_factor: float = 1.25
    router_zloss: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_rope_dim: int = 64
    qk_nope_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0


@dataclasses.dataclass(frozen=True)
class RGLRUConfig:
    lru_width: int = 0
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ReCalKVRuntime:
    """Runtime shape info for a latent (compressed) KV cache.

    ``rank_k``/``rank_v`` are the uniform ranks; ``ranks_by_layer`` holds
    per-layer (rank_k, rank_v) when Fisher allocation varied them ((0, 0)
    for attention-free layers)."""

    rank_k: int
    rank_v: int
    group_size: int = 4
    ranks_by_layer: tuple[tuple[int, int], ...] | None = None

    def num_groups(self, num_kv_heads: int) -> int:
        return num_kv_heads // self.slots(num_kv_heads)

    def slots(self, num_kv_heads: int) -> int:
        """kv heads per latent group (``s``)."""
        return max(1, min(self.group_size, num_kv_heads))

    def ranks_for(self, layer_idx: int | None) -> tuple[int, int]:
        if layer_idx is not None and self.ranks_by_layer is not None:
            rk, rv = self.ranks_by_layer[layer_idx]
            if rk:
                return rk, rv
        return self.rank_k, self.rank_v


_NESTED_CONFIGS = {"moe": MoEConfig, "mla": MLAConfig, "mamba": MambaConfig,
                   "rglru": RGLRUConfig}
_DTYPES_BY_NAME = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                   "float32": torch.float32}
_NAMES_BY_DTYPE = {v: k for k, v in _DTYPES_BY_NAME.items()}


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    layer_pattern: tuple[str, ...] = ("attn",)
    prefix_pattern: tuple[str, ...] = ()
    sliding_window: int | None = None
    qk_norm: bool = False
    rope_theta: float = 10000.0
    rope_theta_global: float | None = None
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    embed_scale: bool = False
    moe: MoEConfig | None = None
    mla: MLAConfig | None = None
    mamba: MambaConfig | None = None
    rglru: RGLRUConfig | None = None
    encoder_decoder: bool = False
    num_encoder_layers: int = 0
    cross_source_len: int = 0
    recalkv: ReCalKVRuntime | None = None
    attn_seq_shard: bool = False
    scan_layers: bool = True
    remat: bool = True
    attn_chunk: int = 512        # query-chunked einsum attention block
    attn_backend: str = "einsum"  # "einsum" reference | "kernel" CUDA kernels
    attn_block: int = 256
    cache_quant_bits: int | None = None
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        for k in self.layer_pattern + self.prefix_pattern:
            if k not in BLOCK_KINDS:
                raise ValueError(f"unknown block kind {k!r}")
        if self.num_heads % max(self.num_kv_heads, 1):
            raise ValueError("num_heads must be divisible by num_kv_heads")
        if self.attn_backend not in ATTN_BACKENDS:
            raise ValueError(
                f"attn_backend must be one of {ATTN_BACKENDS}, "
                f"got {self.attn_backend!r}")
        if self.cache_quant_bits is not None:
            if self.recalkv is None:
                raise ValueError("cache_quant_bits requires a recalkv "
                                 "(latent) cache")
            if self.cache_quant_bits not in (3, 4, 8):
                raise ValueError("cache_quant_bits must be 3, 4 or 8")
        if self.num_layers - len(self.prefix_pattern) < 0:
            raise ValueError("prefix longer than the model")

    # ---- layer layout -----------------------------------------------------

    @property
    def period(self) -> int:
        return len(self.layer_pattern)

    @property
    def num_periods(self) -> int:
        return (self.num_layers - len(self.prefix_pattern)) // self.period

    @property
    def suffix_pattern(self) -> tuple[str, ...]:
        rem = (self.num_layers - len(self.prefix_pattern)) % self.period
        return self.layer_pattern[:rem]

    def expanded_layers(self) -> tuple[str, ...]:
        """Per-layer block kinds for the whole stack, in order."""
        return (self.prefix_pattern + self.layer_pattern * self.num_periods
                + self.suffix_pattern)

    @property
    def mamba_d_inner(self) -> int:
        assert self.mamba is not None
        return self.mamba.expand * self.d_model

    @property
    def mamba_dt_rank(self) -> int:
        assert self.mamba is not None
        return self.mamba.dt_rank or -(-self.d_model // 16)

    @property
    def lru_width(self) -> int:
        assert self.rglru is not None
        return self.rglru.lru_width or self.d_model

    def window_for(self, kind: str) -> int | None:
        if kind == "local":
            if self.sliding_window is None:
                raise ValueError("'local' blocks need cfg.sliding_window")
            return self.sliding_window
        return None

    def cache_len(self, kind: str, seq_len: int) -> int:
        w = self.window_for(kind)
        return seq_len if w is None else min(w, seq_len)

    # ---- serialization -----------------------------------------------------

    def to_dict(self) -> dict:
        """JSON-serializable form with the JAX package's field names and
        values (dtype by name, the kernel backend as ``"pallas"``)."""
        d = dataclasses.asdict(self)
        d["dtype"] = _NAMES_BY_DTYPE[self.dtype]
        d["attn_backend"] = _JAX_BACKEND_NAMES.get(self.attn_backend,
                                                   self.attn_backend)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "ModelConfig":
        d = dict(d)
        d["dtype"] = _DTYPES_BY_NAME[d["dtype"]]
        backend = d.get("attn_backend", "einsum")
        d["attn_backend"] = _BACKEND_ALIASES.get(backend, backend)
        for key, sub in _NESTED_CONFIGS.items():
            if d.get(key) is not None:
                d[key] = sub(**d[key])
        if d.get("recalkv") is not None:
            rt = dict(d["recalkv"])
            if rt.get("ranks_by_layer") is not None:
                rt["ranks_by_layer"] = tuple(
                    (int(rk), int(rv)) for rk, rv in rt["ranks_by_layer"])
            d["recalkv"] = ReCalKVRuntime(**rt)
        for key in ("layer_pattern", "prefix_pattern"):
            d[key] = tuple(d[key])
        return cls(**d)


# Widths every hand-written Hopper body takes (csrc/flash_prefill.cu
# ``supports``, kernels/latent_decode.py's tensor-core limits,
# kernels/dense_decode.py ``launch``): head dim, and query heads per kv head.
KERNEL_D_HEADS = (64, 80, 128, 256)
KERNEL_MAX_Q_PER_KV = 16
# The block kinds the port's model functions serve: all of them.
PORTED_KINDS = BLOCK_KINDS


def check_supported(cfg: ModelConfig, device=None) -> None:
    """Raise NotImplementedError for configurations the port does not
    serve.  Every block kind runs on the CPU and on a card (``PORTED_KINDS``);
    what the port still lacks is training on a mesh and some of serving on
    one (ROADMAP.md Queue 1 items 5a-5e, which ``Engine(mesh=...)`` and the
    CLIs refuse by name).  On a CUDA ``device``
    with the kernel backend this refuses widths no Hopper body serves
    (ROADMAP.md, Queue 3 item 2); the CPU's plain versions serve every
    width, and MLA's readers launch no kernel, so an MLA model is not
    checked for them."""
    if (device is not None and torch.device(device).type == "cuda"
            and cfg.attn_backend == "kernel" and cfg.mla is None):
        qpk = cfg.num_heads // max(cfg.num_kv_heads, 1)
        if cfg.d_head not in KERNEL_D_HEADS or qpk > KERNEL_MAX_Q_PER_KV:
            raise NotImplementedError(
                f"{cfg.name}: d_head {cfg.d_head}, q_per_kv {qpk}: the CUDA "
                f"kernels take d_head in {KERNEL_D_HEADS} and q_per_kv <= "
                f"{KERNEL_MAX_Q_PER_KV} (ROADMAP.md Queue 3 item 2); serve it "
                f"with backend='einsum' or on the CPU")
