"""Draft proposers for speculative decoding (port of ``repro.serving.draft``).

Two draft families, selected by the engine's ``draft=`` spec string:

  "ngram"      prompt lookup: match the token about to be fed (and its
               predecessors) against the slot's own fed-token history and
               propose the tokens that followed the most recent earlier
               occurrence.  No parameters, no extra cache.
  "layers:K"   self-draft from the target's first K layers (shared embed,
               final norm and lm_head): the truncated stack keeps its own
               small ring cache and proposes greedily.

Proposals are guesses: the verify step accepts one only when it equals
the token the target's own sampler would have emitted there, so the draft
changes how many tokens a round yields, never the token stream.
"""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.config import RECURRENT_KINDS, ModelConfig
from repro_torch.sharding.place import MeshParams


@dataclasses.dataclass(frozen=True)
class DraftSpec:
    """Parsed ``draft=`` engine option."""

    kind: str                  # "ngram" | "layers"
    layers: int = 0            # draft depth for kind == "layers"

    @classmethod
    def parse(cls, spec: "str | DraftSpec | None") -> "DraftSpec | None":
        if spec is None or isinstance(spec, DraftSpec):
            return spec
        s = str(spec).strip().lower()
        if s in ("", "none"):
            return None
        if s == "ngram":
            return cls("ngram")
        for sep in (":", "="):
            if s.startswith("layers" + sep):
                try:
                    k = int(s.split(sep, 1)[1])
                except ValueError:
                    break
                return cls("layers", k)
        raise ValueError(
            f"draft spec {spec!r} not understood: expected 'ngram' or "
            f"'layers:K' (first K layers of the target as a self-draft)")

    def __str__(self) -> str:
        return self.kind if self.kind == "ngram" else f"layers:{self.layers}"


def ngram_propose(hist: torch.Tensor, cur: torch.Tensor, tok_in: torch.Tensor,
                  depth: int) -> torch.Tensor:
    """Prompt-lookup proposals.  hist (B, L): position p holds the token
    fed at p (entries at p >= cur are stale); cur (B,) the next feed
    position; tok_in (B,) the token about to be fed there.

    Longest available suffix: the 3-gram (hist[cur-2], hist[cur-1],
    tok_in), else the 2-gram, else the unigram, at its most recent
    occurrence that ends before cur - 1 (so at least one real history
    token follows it).  Unknown positions are -1, which never equals a
    sampled token, so verification rejects them.  Returns (B, depth)."""
    B, Lh = hist.shape

    def suffix(off):
        return hist.gather(1, (cur - off).clamp(0, Lh - 1)[:, None])[:, 0]

    t1, t2 = suffix(1), suffix(2)
    idx = torch.arange(Lh, dtype=cur.dtype, device=hist.device)
    base = (hist == tok_in[:, None]) & (idx[None, :] + 1 < cur[:, None])
    z = torch.zeros((B, 1), dtype=torch.bool, device=hist.device)
    p2 = torch.cat([z, hist[:, :-1] == t1[:, None]], dim=1)
    p3 = torch.cat([z, z, hist[:, :-2] == t2[:, None]], dim=1)

    def best(m):
        # most recent qualifying occurrence, -1 when none
        return torch.where(m, idx[None, :], -1).amax(dim=1)

    q3 = best(base & p2 & p3 & (cur[:, None] >= 2))
    q2 = best(base & p2 & (cur[:, None] >= 1))
    q1 = best(base)
    q = torch.where(q3 >= 0, q3, torch.where(q2 >= 0, q2, q1))
    offs = q[:, None] + 1 + torch.arange(depth, dtype=cur.dtype,
                                         device=hist.device)[None, :]
    known = (q[:, None] >= 0) & (offs < cur[:, None])
    prop = hist.gather(1, offs.clamp(0, Lh - 1))
    return torch.where(known, prop, -1)


def make_layer_draft(cfg: ModelConfig, params: dict,
                     k: int) -> tuple[ModelConfig, dict]:
    """Self-draft from the target's first ``k`` layers.  Returns
    (draft_cfg, draft_params): the params are a view that shares the
    target's tensors (embed, final norm, lm_head, an encoder, the first
    k layer dicts) — no copies; on a mesh (``params`` a
    ``sharding.place.MeshParams``) a view over the target's shards.  The
    config keeps ``cache_quant_bits``, so the draft's ring is int8 when
    the target's is."""
    if not 1 <= k <= cfg.num_layers:
        raise ValueError(
            f"layers draft wants {k} layers; target has {cfg.num_layers}")
    kinds = cfg.expanded_layers()[:k]
    if any(kd in RECURRENT_KINDS for kd in kinds):
        raise ValueError("layers draft cannot include recurrent blocks")
    dcfg = dataclasses.replace(cfg, name=f"{cfg.name}-draft{k}", num_layers=k)
    if isinstance(params, MeshParams):
        return dcfg, params.first_layers(k)
    dparams = {kk: params[kk] for kk in ("embed", "final_norm", "lm_head", "encoder")
               if kk in params}
    dparams["layers"] = params["layers"][:k]
    return dcfg, dparams
