"""Admission policies (port of ``repro.serving.policy``; ``fifo`` only —
the prefix-affinity and reach-packing policies need the paged pool,
which is not ported yet)."""

from __future__ import annotations

from collections import deque
from typing import Callable


class AdmissionPolicy:
    """Interface: ``select`` pops up to ``limit`` requests off ``queue``
    in admission order, calling ``fits`` (a budget-debiting gate) at most
    once per admitted request."""

    name = "base"

    def select(self, queue: deque, limit: int,
               fits: Callable | None = None) -> list:
        raise NotImplementedError


class FifoPolicy(AdmissionPolicy):
    """Strict head-of-line FIFO: pop the head while it fits; the first
    request that does not fit ends the wave."""

    name = "fifo"

    def select(self, queue, limit, fits=None):
        out = []
        while queue and len(out) < limit:
            if fits is not None and not fits(queue[0]):
                break
            out.append(queue.popleft())
        return out


_POLICIES = {"fifo": FifoPolicy}


def get_policy(policy: str | AdmissionPolicy | None) -> AdmissionPolicy:
    """Resolve a policy name (or pass an instance through); None is fifo."""
    if policy is None:
        return FifoPolicy()
    if isinstance(policy, AdmissionPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown or not yet ported admission policy "
                         f"{policy!r}: expected one of {sorted(_POLICIES)}") from None
