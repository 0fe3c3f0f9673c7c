"""Token sampling for the serving engine (port of ``repro.serving.sampler``).

``SamplingParams`` is the per-request policy (greedy / temperature /
top-k / top-p); ``sample_tokens`` is the batched sampler the engine calls
every step, with every knob a per-slot tensor.  Greedy rows (temperature
below ``_TEMP_EPS``) are exact argmax.  Sampled rows draw with
``jax.random.categorical`` ported bit for bit (:mod:`.prng`): each slot
carries its own (2,) key, ``fold_in(PRNGKey(seed), uid)`` at admission,
split once per step and advanced only where the slot emitted — so a
request's sampled stream is the JAX engine's, token for token, and does
not depend on ``sync_every``, ``prefill_chunk`` or its batch-mates.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.serving import prng

NEG_INF = -1e30
_TEMP_EPS = 1e-6
# Scaled logits are clipped to +-_SCALED_MAX before filtering (a tiny
# temperature would push them to float32 infinity and NaN the top-p
# softmax); NEG_INF masking stays strictly below the bound.
_SCALED_MAX = 1e29
# XLA's CPU backend rewrites a cumulative sum longer than this into
# blocks of this length (ReduceWindowRewriter): sequential sums inside
# each block plus the recursive cumulative sum of the block totals.
_SCAN_BLOCK = 16


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """temperature 0 -> greedy argmax; top_k 0 and top_p 1 disable their
    filters; ``seed`` is folded with the request uid into the slot's key."""

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

    def slot_key(self, uid: int) -> np.ndarray:
        """The (2,) uint32 key a slot starts from for this request:
        ``fold_in(PRNGKey(seed), uid)``, as the JAX package derives it."""
        key = prng.fold_in(prng.prng_key(self.seed), uid)
        return key.numpy().astype(np.uint32)


GREEDY = SamplingParams()


def blocked_cumsum(x: torch.Tensor) -> torch.Tensor:
    """float32 cumulative sum over the last axis, in the summation order of
    ``jnp.cumsum`` on XLA's CPU backend (``_SCAN_BLOCK``-wide blocks, each
    summed in order, plus the recursive scan of the block totals).  Each
    step is one float32 add (``torch.cumsum`` accumulates in double on the
    CPU, which rounds differently)."""
    *lead, n = x.shape
    b = _SCAN_BLOCK
    if n <= b:
        cols = [x[..., 0]]
        for j in range(1, n):
            cols.append(cols[-1] + x[..., j])
        return torch.stack(cols, dim=-1)
    nb = -(-n // b)
    xp = torch.nn.functional.pad(x, (0, nb * b - n)).reshape(*lead, nb, b)
    within = blocked_cumsum(xp)
    totals = blocked_cumsum(within[..., -1])
    carry = torch.nn.functional.pad(totals[..., :-1], (1, 0))
    return (within + carry[..., None]).reshape(*lead, nb * b)[..., :n]


# XLA's CPU backend splits a row reduction longer than this into windows
# of this length, zero-padded evenly on both sides, summed in order, and
# reduces the window sums the same way until one window is left.
_REDUCE_WINDOW = 32
# XLA's CPU float32 exp (the Cephes range reduction and degree-5
# polynomial it emits, with fused multiply-adds): log2(e), ln(2) split in
# two, and the polynomial's coefficients, highest degree first — all
# float32 constants.
_f32 = lambda v: float(np.float32(v))
_EXP_LOG2E = _f32(1.44269504088896341)
_EXP_LN2 = (_f32(0.693359375), _f32(-2.12194440e-4))
_EXP_POLY = tuple(_f32(c) for c in (1.9875691500e-4, 1.3981999507e-3,
                                    8.3334519073e-3, 4.1665795894e-2,
                                    1.6666665459e-1, 5.0000001201e-1))
_F32_MIN_NORMAL = _f32(1.1754943508222875e-38)


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """float32 a * b + c rounded once (the product is exact in double)."""
    return (a.double() * b + c).float()


def xla_cpu_exp(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA's CPU backend computes it: clamp to [-87.8, 88.8],
    n = floor(x log2(e) + 1/2) clamped to [-127, 127], r = x - n ln(2) in
    two parts, a degree-5 polynomial in r, times 2^n built in the exponent
    bits; results below the smallest normal float flush to 0.  Equal to
    ``jnp.exp`` on the CPU bit for bit (tests/test_torch_sampler.py)."""
    x = x.float().clamp(-87.8, 88.8)
    n = torch.floor(_fma(x, _EXP_LOG2E, 0.5)).clamp(-127, 127)
    r = _fma(n, -_EXP_LN2[0], x)
    r = _fma(n, -_EXP_LN2[1], r)
    z = _fma(r, _EXP_POLY[0], _EXP_POLY[1])
    for c in _EXP_POLY[2:]:
        z = _fma(z, r.double(), c)
    z = 1.0 + _fma(z, (r * r).double(), r)
    pow2 = ((n.to(torch.int32) + 127) << 23).view(torch.float32)
    out = z * pow2
    return torch.where(out < _F32_MIN_NORMAL, 0.0, out)


def xla_cpu_sum(x: torch.Tensor) -> torch.Tensor:
    """float32 sum over the last axis in the order of ``jnp.sum`` on XLA's
    CPU backend: windows of ``_REDUCE_WINDOW``, each summed in order,
    recursively (one float32 add per step)."""
    w = _REDUCE_WINDOW
    while x.shape[-1] > w:
        n = x.shape[-1]
        pad = -n % w
        x = torch.nn.functional.pad(x, (pad // 2, pad - pad // 2))
        x = x.reshape(*x.shape[:-1], -1, w)
        acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        for j in range(w):
            acc = acc + x[..., j]
        x = acc
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for j in range(x.shape[-1]):
        acc = acc + x[..., j]
    return acc


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """Last-axis softmax; on the CPU in XLA's CPU order and exp, so the
    probabilities equal ``jax.nn.softmax``'s bit for bit."""
    if x.device.type != "cpu":
        return torch.softmax(x, dim=-1)
    e = xla_cpu_exp(x - x.amax(dim=-1, keepdim=True))
    return e / xla_cpu_sum(e)[..., None]


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
    probs = _softmax(sorted_l)
    before = blocked_cumsum(probs) - probs
    keep_sorted = before < top_p[:, None]
    keep_sorted[:, 0] = True
    keep_p = torch.gather(keep_sorted, -1, ranks)
    return torch.where(keep_k & keep_p, logits, neg)


def split_keys(keys: torch.Tensor) -> torch.Tensor:
    """Advance per-slot keys one step: (B, 2) -> (B, 2, 2); [:, 1] is this
    step's draw key and [:, 0] the chain carried forward (the JAX
    engine's use of ``jax.random.split``)."""
    return prng.split(keys)


def sample_tokens(logits: torch.Tensor, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  keys: torch.Tensor, *, any_sampled: bool | None = None):
    """One token per row.  logits (B, V); temperature / top_p (B,) float32,
    top_k (B,) int; keys (B, 2) draw keys (use once).  Rows with
    temperature below ``_TEMP_EPS`` return exact argmax.  An all-greedy
    batch draws nothing: ``any_sampled`` says so from the host's own
    knowledge (computed from ``temperature`` when None, which waits for the
    device when the tensor lives on one)."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    is_greedy = temperature < _TEMP_EPS
    if any_sampled is None:
        any_sampled = not bool(is_greedy.all())
    if not any_sampled:
        return greedy
    t = temperature.float().clamp(min=_TEMP_EPS)[:, None]
    scaled = (logits / t).clamp(-_SCALED_MAX, _SCALED_MAX)
    masked = filtered_logits(scaled, top_k, top_p)
    drawn = prng.categorical(keys, masked)
    return torch.where(is_greedy, greedy, drawn)
