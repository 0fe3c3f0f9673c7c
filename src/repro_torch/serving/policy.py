"""Admission policies (port of ``repro.serving.policy``).

Admission order is a scheduling lever once pages, not slots, are the
scarce resource (the paged latent pool, ``cache_layout="paged"``), so it
lives in a policy object the scheduler consults:

  ``fifo``            requests admit in submission order; the first one
                      that does not fit ends the wave.  The default.
  ``prefix-affinity`` group queued requests by their first-page
                      ``prefix_key`` so one wave prefills a shared system
                      prompt once and every sharer retains (or
                      resurrects) its pages.  Requires the paged layout.
                      The queue head is always admitted first, and a
                      non-fitting pick ends the wave.
  ``reach-packing``   admit short requests past a blocked long one.  A
                      blocked request may be bypassed in at most
                      ``max_bypass`` selection rounds; after that it is a
                      barrier no later request passes.

Policies also choose the victim when lazy page reservation
(``Engine(lazy_pages=True)``) runs the pool dry: ``pick_victim`` names
the slot the engine preempts.

``select`` pops what it admits off the queue it is given and calls
``fits`` — a gate that debits a resource budget on success — at most once
per admitted request, and only for requests it admits.
"""

from __future__ import annotations

from collections import deque
from typing import Callable

from repro_torch.serving.pages import prefix_key


class AdmissionPolicy:
    """Interface: admission order and preemption victim.

    ``configure`` is called once by the engine with the layout facts a
    policy may key on (page size, the prefix registry).  ``select`` pops
    up to ``limit`` requests off ``queue`` in admission order;
    ``pick_victim`` names a slot from ``candidates`` (admission order,
    oldest first) when the engine must preempt."""

    name = "base"
    #: set by policies that reorder admission by first-page prefix keys;
    #: the engine gates its prefill-skip path on it
    groups_by_prefix = False

    def __init__(self):
        self.page_size: int | None = None
        self.registry = None

    def configure(self, *, page_size: int | None = None, registry=None):
        self.page_size = page_size
        self.registry = registry

    def select(self, queue: deque, limit: int,
               fits: Callable | None = None) -> list:
        raise NotImplementedError

    def pick_victim(self, candidates: list) -> int:
        """The youngest admission (last in admission order): it has the
        least prefill and decode work to redo, and the oldest requests
        keep their latency."""
        return candidates[-1][0]


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


class PrefixAffinityPolicy(AdmissionPolicy):
    """FIFO with shared-prefix pull-forward: after each pick, the first
    queued request whose first-page prefix key matches an already
    selected one joins the same wave, so the shared pages prefill once.
    With no sharer pending, selection is FIFO."""

    name = "prefix-affinity"
    groups_by_prefix = True

    def _key(self, req):
        ps = self.page_size
        if ps is None or len(req.prompt) < ps:
            return None
        return prefix_key(req.prompt, 0, ps)

    def select(self, queue, limit, fits=None):
        out = []
        keys: set = set()
        while queue and len(out) < limit:
            pick = 0
            if keys:
                for i, r in enumerate(queue):
                    k = self._key(r)
                    if k is not None and k in keys:
                        pick = i
                        break
            req = queue[pick]
            if fits is not None and not fits(req):
                # a non-fitting pick ends the wave, head or sharer alike
                break
            del queue[pick]
            out.append(req)
            k = self._key(req)
            if k is not None:
                keys.add(k)
        return out


class ReachPackingPolicy(AdmissionPolicy):
    """A request that does not fit is bypassed and later, smaller ones
    may admit past it.  Each request counts the rounds in which it was
    passed over; at ``max_bypass`` it becomes a barrier, so it waits at
    most ``max_bypass`` admission rounds longer than under FIFO."""

    name = "reach-packing"

    def __init__(self, max_bypass: int = 4):
        super().__init__()
        if max_bypass < 0:
            raise ValueError("max_bypass must be >= 0")
        self.max_bypass = max_bypass
        self._bypassed: dict[int, int] = {}      # uid -> rounds passed over

    def select(self, queue, limit, fits=None):
        out = []
        if fits is None:
            # no resource gate: nothing can block, selection is FIFO
            while queue and len(out) < limit:
                out.append(queue.popleft())
            return out
        skipped = []
        i = 0
        while i < len(queue) and len(out) < limit:
            req = queue[i]
            if fits(req):
                del queue[i]
                out.append(req)
                self._bypassed.pop(req.uid, None)
                continue
            if self._bypassed.get(req.uid, 0) >= self.max_bypass:
                break                             # barrier: stop the scan
            skipped.append(req.uid)
            i += 1
        if out:
            # only rounds that admitted someone past a blocked request
            # count against the bound: an empty wave starves nobody
            for uid in skipped:
                self._bypassed[uid] = self._bypassed.get(uid, 0) + 1
        return out


_POLICIES = {
    "fifo": FifoPolicy,
    "prefix-affinity": PrefixAffinityPolicy,
    "reach-packing": ReachPackingPolicy,
}


def get_policy(policy: str | AdmissionPolicy | None) -> AdmissionPolicy:
    """Resolve a policy name (or pass an instance through); None is fifo."""
    if policy is None:
        return FifoPolicy()
    if isinstance(policy, AdmissionPolicy):
        return policy
    try:
        return _POLICIES[policy]()
    except KeyError:
        raise ValueError(f"unknown admission policy {policy!r}: expected one "
                         f"of {sorted(_POLICIES)}") from None
