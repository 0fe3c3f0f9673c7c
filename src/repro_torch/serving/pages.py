"""Page-pool allocator for the paged latent KV cache (port of
``repro.serving.pages``; pure Python, so the port keeps its own copy).

The ring layout pins ``max_len`` positions per serving slot, so one
long-context request reserves worst-case memory — stranding exactly the
device memory that ReCalKV's compression saved.  The paged layout breaks
every layer's ring into fixed-size pages held in one shared pool; a
per-slot page table (a ``(B, n_slot_pages)`` int32 tensor on the device)
maps slot-page index -> physical page.  This module is the HOST side of
that subsystem: which physical pages exist, who holds references to them,
and which ones hold a registered (shareable) prompt prefix.  Device-side
reads/writes through the table live in ``models.kv_cache`` and
``kernels``; the engine glues the two at admission/retire.

Invariants the allocator maintains (held against the JAX package's pool
in tests/test_torch_pages.py):

  * physical page 0 is the NULL page — never allocated, never written;
    unmapped page-table entries point at it and its ``pos`` stays -1, so
    a gathered view of an unmapped slot-page reads as empty ring.
  * every non-null page is on the free list (refcount 0), held by >= 1
    slots (refcount = number of holders), or PARKED (refcount 0 but
    pinned — resident and exempt from recycling); the three sets
    partition the pool, so pages never leak and never double-free.
  * a page with refcount >= 2 (a shared prompt prefix) is read-only by
    construction: the engine only shares pages wholly covered by the
    sharer's prefilled prompt region, and post-admission writes land at
    positions >= that region.  Divergence is resolved at admission time
    (the deterministic specialization of copy-on-write — a request's
    write range is known when it is admitted, so the first divergent
    page gets a private copy up front; see ``PagePool.fork``).

The prefix registry keys shareable pages by (slot-page index, hash of
the FULL token prefix through that page) — latent content at position t
depends causally on all tokens <= t, so two requests may share page j
only when their first (j+1)*page_size tokens are identical.  The
registry holds no references of its own, but its entries outlive their
holders: a page whose refcount hits zero keeps its key until the page
is actually *recycled* by ``alloc`` (the engine drops keys for freshly
allocated pages).  Free pages are reused in LRU order — least recently
freed first — so a recurring system prompt's pages survive in the free
list as long as pool pressure allows, and a registry hit on a
refcount-0 page can ``resurrect`` it instead of re-prefilling.
"""

from __future__ import annotations

import hashlib

import numpy as np

__all__ = ["PagePool", "PrefixRegistry", "prefix_key"]

NULL_PAGE = 0


class PagePool:
    """LRU free-list + per-page refcount allocator over ``n_pages``
    physical pages.  Page 0 is reserved as the null page.

    The free list is ordered by release time (least recently freed
    first); ``alloc`` recycles from the cold end while ``resurrect``
    can pull a still-registered page back out of the middle, which is
    what lets refcount-0 prefix pages keep serving cache hits."""

    def __init__(self, n_pages: int):
        if n_pages < 2:
            raise ValueError(
                f"n_pages={n_pages}: the pool needs the reserved null page "
                f"plus at least one allocatable page")
        self.n_pages = n_pages
        self._ref = [0] * n_pages
        # dict-as-ordered-set: insertion order == LRU order, O(1) removal
        # from the middle when a free page is resurrected.
        self._free: dict[int, None] = dict.fromkeys(range(1, n_pages))
        # pinned pages are exempt from LRU recycling: at refcount 0 they
        # PARK (off the free list, still resident) instead of joining it,
        # so a cold-start flood can never evict a pinned prefix.
        self._pinned: set[int] = set()
        self.share_events = 0          # cumulative retain() calls
        self.cow_forks = 0             # cumulative divergent-page copies
        self.peak_used = 0             # high-water mark of allocated pages
        self.prefix_resurrections = 0  # refcount-0 pages revived by a hit
        # monotone allocation stamps: a page's stamp changes when alloc()
        # RECYCLES it (content destroyed) — not on resurrect/retain,
        # which preserve content — so a preempted slot can tell on
        # re-admission whether its old pages still hold its content
        # (stamp unchanged) or were overwritten meanwhile.
        self._alloc_seq = 0
        self._last_alloc = [0] * n_pages

    # -- introspection -------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def used(self) -> int:
        """Allocated (non-null) pages right now."""
        return self.n_pages - 1 - len(self._free)

    @property
    def shared_now(self) -> int:
        """Pages currently held by more than one slot."""
        return sum(1 for r in self._ref if r >= 2)

    @property
    def pinned(self) -> int:
        """Pages currently pinned against recycling."""
        return len(self._pinned)

    @property
    def parked(self) -> int:
        """Pinned pages at refcount 0: resident, off the free list, not
        held by any slot.  ``used`` counts them as allocated (they are
        not allocatable), so gauges that want live holders should read
        ``used - parked``."""
        return sum(1 for pg in self._pinned if self._ref[pg] == 0)

    def alloc_stamp(self, page: int) -> int:
        """Monotone stamp of the page's latest recycle by ``alloc``.
        Two reads returning the same stamp bracket a window in which the
        page's content was never destroyed (resurrect/retain preserve
        content and do not bump the stamp)."""
        return self._last_alloc[page]

    def assert_consistent(self):
        """Every non-null page is in exactly one of {free list,
        refcount>0, parked}; the three partition the pool.  Cheap enough
        to call from property tests after every operation."""
        held = sum(1 for pg in range(1, self.n_pages) if self._ref[pg] > 0)
        parked = self.parked
        assert not (self._pinned & set(self._free)), \
            f"pinned pages on the free list: {self._pinned & set(self._free)}"
        for pg in self._free:
            assert self._ref[pg] == 0, \
                f"free page {pg} has refcount {self._ref[pg]}"
        assert len(self._free) + held + parked == self.n_pages - 1, (
            f"pool partition broken: free={len(self._free)} held={held} "
            f"parked={parked} != {self.n_pages - 1} allocatable")

    def is_pinned(self, page: int) -> bool:
        return page in self._pinned

    def refcount(self, page: int) -> int:
        return self._ref[page]

    def can_alloc(self, n: int) -> bool:
        return 0 <= n <= len(self._free)

    # -- lifecycle -----------------------------------------------------------

    def alloc(self, n: int) -> list[int]:
        """Take ``n`` fresh pages (refcount 1 each), recycling the least
        recently freed first.  A recycled page's old content/identity is
        dead — the caller must drop any registry key for it."""
        if n < 0:
            raise ValueError(f"alloc({n})")
        if n > len(self._free):
            raise RuntimeError(
                f"page pool exhausted: want {n}, have {len(self._free)} "
                f"free of {self.n_pages - 1} allocatable")
        pages = []
        for _ in range(n):
            pg = next(iter(self._free))
            del self._free[pg]
            self._ref[pg] = 1
            self._alloc_seq += 1
            self._last_alloc[pg] = self._alloc_seq
            pages.append(pg)
        self.peak_used = max(self.peak_used, self.used)
        return pages

    def resurrect(self, page: int) -> int:
        """Revive a refcount-0 page (a prefix registry hit on a retired
        prompt): its content is still resident because nothing recycled
        it yet, so the new holder skips the prefill entirely.  Works for
        pages on the free list AND for pinned pages parked off it."""
        if not 0 < page < self.n_pages:
            raise ValueError(
                f"page {page} out of range 1..{self.n_pages - 1}")
        if page in self._free:
            del self._free[page]
        elif not (page in self._pinned and self._ref[page] == 0):
            raise ValueError(
                f"page {page} is not free (refcount {self._ref[page]}); "
                f"use retain() to share a live page")
        self._ref[page] = 1
        self.prefix_resurrections += 1
        self.peak_used = max(self.peak_used, self.used)
        return page

    # -- pinning -------------------------------------------------------------

    def pin(self, page: int):
        """Exempt ``page`` from LRU recycling.  A pinned page at refcount
        0 parks off the free list (content resident, never handed out by
        ``alloc``) until ``unpin`` returns it.  Idempotent."""
        if not 0 < page < self.n_pages:
            raise ValueError(
                f"page {page} out of range 1..{self.n_pages - 1}")
        if page in self._pinned:
            return
        self._pinned.add(page)
        # already free: pull it off the list so alloc can't recycle it
        self._free.pop(page, None)

    def unpin(self, page: int):
        """Lift the recycling exemption; a parked page rejoins the WARM
        end of the free list (it was hot enough to pin).  Idempotent."""
        if page not in self._pinned:
            return
        self._pinned.discard(page)
        if self._ref[page] == 0:
            self._free[page] = None

    def retain(self, page: int) -> int:
        """Share an allocated page: one more holder, no copy."""
        self._check_live(page)
        self._ref[page] += 1
        self.share_events += 1
        return page

    def fork(self, page: int) -> int:
        """Copy-on-write fork: allocate a private replacement for ``page``
        and release this holder's reference to the original.  The caller
        owns filling the new page's content (device copy, or a prefill
        scatter when the content is being recomputed anyway)."""
        self._check_live(page)
        new = self.alloc(1)[0]
        self.cow_forks += 1
        self.free(page)
        return new

    def free(self, page: int) -> bool:
        """Drop one reference; returns True when the page's refcount hit
        zero and it joined the warm end of the free list (or parked, if
        pinned — a pinned page never rejoins the allocatable pool).
        Registry keys stay valid past this point — the page's content is
        resident until ``alloc`` recycles it."""
        self._check_live(page)
        self._ref[page] -= 1
        if self._ref[page] == 0:
            if page not in self._pinned:
                self._free[page] = None
            return True
        return False

    def _check_live(self, page: int):
        if not 0 < page < self.n_pages:
            raise ValueError(
                f"page {page} out of range 1..{self.n_pages - 1} "
                f"(page {NULL_PAGE} is the reserved null page)")
        if self._ref[page] <= 0:
            raise ValueError(f"page {page} is not allocated (double free?)")


def prefix_key(prompt: np.ndarray, page_idx: int, page_size: int):
    """Registry key for slot-page ``page_idx`` of a prompt: the page index
    plus a digest of the ENTIRE token prefix through that page (latent
    content at position t depends on all tokens <= t)."""
    end = (page_idx + 1) * page_size
    tokens = np.ascontiguousarray(np.asarray(prompt[:end], np.int32))
    return page_idx, hashlib.sha1(tokens.tobytes()).digest()


class PrefixRegistry:
    """prefix-hash -> resident physical page, for prompt sharing.

    Holds no references: the engine drops a page's entry when the page
    is recycled by ``alloc`` (NOT when its refcount hits zero — a free
    page's content stays resident, and a later lookup can resurrect it).
    One key per page (a page's content is fixed from registration until
    recycle), first registration wins."""

    def __init__(self):
        self._page_for: dict = {}
        self._key_for: dict[int, tuple] = {}

    def lookup(self, key) -> int | None:
        return self._page_for.get(key)

    def register(self, key, page: int):
        if key in self._page_for or page in self._key_for:
            return
        self._page_for[key] = page
        self._key_for[page] = key

    def pages(self):
        """View of the physical pages currently holding a registered
        prefix (the pin-ranking universe)."""
        return self._key_for.keys()

    def drop_page(self, page: int):
        key = self._key_for.pop(page, None)
        if key is not None:
            del self._page_for[key]

    def __len__(self) -> int:
        return len(self._page_for)
