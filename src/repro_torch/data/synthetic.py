"""Deterministic synthetic LM data — stateless, index-addressable (a copy
of ``repro.data.synthetic``, numpy only: the same arrays for the same
config, split and index).

Every (seed, split, index) maps to one sequence via counter-based RNG
(numpy Philox), so:
  * any rank can materialize any shard without replay (straggler
    re-assignment and elastic rescaling need no pipeline state);
  * restarts are exactly reproducible from the step counter alone.

The corpus mixes a learned-structure Markov chain with long-range COPY
spans (a random early segment is repeated verbatim later).  The copy task
makes held-out loss *sensitive to KV-cache fidelity* — exactly what the
paper's quality tables measure — while the Markov component gives the
model local statistics to learn.  WikiText-2 is unavailable offline; the
method is data-agnostic (DESIGN.md deviation #4).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int = 512
    seq_len: int = 256
    copy_frac: float = 0.35      # fraction of sequences carrying a copy span
    copy_len: int = 32
    markov_order: int = 1
    seed: int = 1234


SPLITS = {"train": 0, "valid": 1, "calib": 2}


def _rng(cfg: DataConfig, split: str, index: int) -> np.random.Generator:
    # Philox takes a 128-bit key (2 x uint64): mix (seed, split) | index.
    return np.random.Generator(np.random.Philox(
        key=[(cfg.seed << 8) ^ SPLITS[split], index]))


def _transition(cfg: DataConfig) -> np.ndarray:
    """Shared sparse-ish Markov transition matrix (same for all sequences)."""
    g = np.random.Generator(np.random.Philox(key=[cfg.seed, 77]))
    V = cfg.vocab_size
    logits = g.normal(size=(V, V)) * 2.0
    # sparsify: each token prefers ~16 successors
    keep = np.argsort(logits, axis=1)[:, -16:]
    mask = np.full((V, V), -1e9)
    np.put_along_axis(mask, keep, 0.0, axis=1)
    p = np.exp(logits + mask)
    return p / p.sum(axis=1, keepdims=True)


_TRANS_CACHE: dict[tuple, np.ndarray] = {}


def sequence(cfg: DataConfig, split: str, index: int) -> np.ndarray:
    key = (cfg.seed, cfg.vocab_size)
    if key not in _TRANS_CACHE:
        _TRANS_CACHE[key] = _transition(cfg)
    trans = _TRANS_CACHE[key]
    g = _rng(cfg, split, index)
    V, T = cfg.vocab_size, cfg.seq_len
    toks = np.empty(T, np.int64)
    toks[0] = g.integers(V)
    u = g.random(T)
    for t in range(1, T):
        toks[t] = np.searchsorted(np.cumsum(trans[toks[t - 1]]), u[t])
    toks = np.clip(toks, 0, V - 1)
    if g.random() < cfg.copy_frac and T >= 4 * cfg.copy_len:
        src = g.integers(0, T // 2 - cfg.copy_len)
        dst = g.integers(T // 2, T - cfg.copy_len)
        toks[dst : dst + cfg.copy_len] = toks[src : src + cfg.copy_len]
    return toks


def batch(cfg: DataConfig, split: str, step: int, batch_size: int,
          shard: int = 0, num_shards: int = 1) -> dict[str, np.ndarray]:
    """Global batch ``step``'s shard: (B_local, T) tokens + shifted labels."""
    if batch_size % num_shards:
        raise ValueError("batch not divisible by shards")
    local = batch_size // num_shards
    base = step * batch_size + shard * local
    toks = np.stack([sequence(cfg, split, base + i) for i in range(local)])
    labels = np.concatenate(
        [toks[:, 1:], np.full((local, 1), -1, np.int64)], axis=1)
    return {"tokens": toks.astype(np.int32), "labels": labels.astype(np.int32)}


def batches(cfg: DataConfig, split: str, num_steps: int, batch_size: int,
            start_step: int = 0):
    for s in range(start_step, start_step + num_steps):
        yield batch(cfg, split, s, batch_size)
