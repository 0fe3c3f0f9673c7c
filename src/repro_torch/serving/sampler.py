"""Token sampling for the serving engine (port of ``repro.serving.sampler``).

``SamplingParams`` is the per-request policy (greedy / temperature /
top-k / top-p).  ``filtered_logits`` is an exact port.  Greedy rows are
exact argmax.  Sampled rows draw Gumbel noise from a per-slot
``torch.Generator`` seeded from ``(seed, uid)``, so a request's sampled
stream is reproducible run to run; it does not reproduce ``jax.random``'s
threefry bits (the bit-exact sampler is the next item in ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch

NEG_INF = -1e30
_TEMP_EPS = 1e-6
# Scaled logits are clipped to +-_SCALED_MAX before filtering (a tiny
# temperature would push them to float32 infinity and NaN the top-p
# softmax); NEG_INF masking stays strictly below the bound.
_SCALED_MAX = 1e29


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature 0 -> greedy argmax; top_k 0 and top_p 1 disable their
    filters; ``seed`` and the request uid seed the slot's generator."""

    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0 (0 disables)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")

    @property
    def greedy(self) -> bool:
        return self.temperature < _TEMP_EPS

    def slot_generator(self, uid: int, device) -> torch.Generator:
        """The generator a slot draws from for this request."""
        g = torch.Generator(device=device)
        g.manual_seed((self.seed * 1_000_003 + uid) % (2 ** 63))
        return g


GREEDY = SamplingParams()


def filtered_logits(logits: torch.Tensor, top_k: torch.Tensor,
                    top_p: torch.Tensor) -> torch.Tensor:
    """Per-row top-k then minimal-nucleus top-p masking.

    logits (B, V) float32; top_k (B,) (0 disables); top_p (B,) (>= 1
    disables).  Top-k keeps exactly k entries (ties broken by stable sort
    order); top-p keeps the smallest sorted prefix whose cumulative
    probability reaches top_p (the crossing entry is kept; the top-1
    always survives)."""
    V = logits.shape[-1]
    order = torch.argsort(-logits, dim=-1, stable=True)
    ranks = torch.argsort(order, dim=-1, stable=True)
    k = torch.where(top_k > 0, top_k.clamp(max=V), V)
    keep_k = ranks < k[:, None]
    neg = torch.full_like(logits, NEG_INF)
    masked = torch.where(keep_k, logits, neg)
    sorted_l = torch.gather(masked, -1, order)
    probs = torch.softmax(sorted_l, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    keep_sorted = before < top_p[:, None]
    keep_sorted[:, 0] = True
    keep_p = torch.gather(keep_sorted, -1, ranks)
    return torch.where(keep_k & keep_p, logits, neg)


def sample_row(logits: torch.Tensor, sp: SamplingParams,
               gen: torch.Generator) -> torch.Tensor:
    """One draw for one row (V,): temperature, filters, then Gumbel-max
    with noise from ``gen`` (advanced by one draw)."""
    t = max(sp.temperature, _TEMP_EPS)
    scaled = (logits.float() / t).clamp(-_SCALED_MAX, _SCALED_MAX)[None]
    dev = logits.device
    masked = filtered_logits(scaled, torch.tensor([sp.top_k], device=dev),
                             torch.tensor([sp.top_p], device=dev))[0]
    u = torch.rand(masked.shape, generator=gen, device=dev)
    gumbel = -torch.log(-torch.log(u.clamp(min=1e-20)))
    return (masked + gumbel).argmax()


def sample_tokens(logits: torch.Tensor, specs: list, gens: list) -> torch.Tensor:
    """One token per row of ``logits`` (B, V).  ``specs[i]`` is row i's
    SamplingParams (None for an idle row) and ``gens[i]`` its generator.
    Greedy and idle rows are exact argmax; an all-greedy batch draws
    nothing.  Stays on the device (no host sync)."""
    out = logits.argmax(dim=-1)
    for i, (sp, g) in enumerate(zip(specs, gens)):
        if sp is not None and not sp.greedy:
            out[i] = sample_row(logits[i], sp, g)
    return out
