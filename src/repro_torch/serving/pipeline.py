"""Host-side plumbing of the overlapped serving pipeline (port of
``repro.serving.pipeline``).

The overlapped engine keeps up to ``pipeline_depth`` decode windows in
flight and blocks the host only on the trailing window's packed status;
everything else a window boundary used to do synchronously is either
device work queued behind the in-flight windows (row scatters into the
device carry) or deferred onto a worker thread:

  * ``InflightWindow`` is the per-dispatch record: the window's host
    copies (status, tokens, emit flags, draft counts) and the event that
    says they have landed, plus the host snapshot (slot -> request map,
    occupancy, queue depth, dispatch index) that makes the harvest
    interpretable after the scheduler has moved on.
  * ``TokenBacklog`` is one worker thread draining a FIFO of closures:
    each window's token crediting and stream callbacks run there, so the
    dispatch loop never waits on Python-side token handling.  An exception
    is kept and re-raised on the submitting thread at the next ``put`` /
    ``flush`` / ``close``, so a crashed worker fails the run instead of
    hanging it.
  * ``AdmissionWorker`` is the admission-prefill thread: it pops
    queue-head requests and runs their wave prefill and first-token sample
    (on its own CUDA stream on a card), producing ``StagedWave`` records.
    It never mutates scheduler, pool or mirror state: everything
    host-visible merges on the main thread at a window boundary, which is
    what keeps streams token for token equal to the sync engine's
    (prefill is row-independent and the first-token sample is per row).
    In ``lockstep`` (a mesh, where every rank must take the same
    decisions at the same boundaries) the main thread forms each wave and
    ``submit``s it, and ``collect`` at the next boundary hands back every
    wave submitted before it, waiting for any not prepared yet: no
    decision depends on the worker's timing.
  * ``StagedEntry`` (continuous batching) is one request scattered into
    the device staging queue: the host-known carry row it was staged with,
    kept until a harvested window confirms the in-window install, so the
    mirror and the scheduler catch up after the fact.

Ordering contract: items run strictly in ``put`` order on one worker, so a
request's tokens reach it in dispatch order.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from collections import deque
from typing import Any, Callable

__all__ = ["AdmissionWorker", "InflightWindow", "PreemptedRecord",
           "StagedEntry", "StagedWave", "TokenBacklog"]

_STOP = object()


@dataclasses.dataclass
class InflightWindow:
    """One dispatched, not yet harvested decode window.

    ``status`` is the only array the boundary waits for: a packed 1-D
    int32 host copy of (active, buffer position, cur[, per-slot accepted
    and proposed draft counts], stepping-slot count), parsed positionally
    at the harvest.  ``toks`` / ``emits`` (and the draft totals) are host
    copies the backlog worker reads.  ``ready`` is the event recorded after
    every copy (None on the CPU, where they are done at dispatch).
    ``slot_reqs`` snapshots the slot -> request map at dispatch: a later
    boundary may re-assign a slot before this window is harvested."""

    index: int                      # dispatch sequence number
    status: Any                     # (R,) int32 host tensor
    toks: Any                       # (K, B[, S]) host tensor
    emits: Any                      # (K, B[, S]) host tensor
    slot_reqs: list                 # slot -> Request at dispatch time
    occ: int                        # scheduler occupancy at dispatch
    qd: int                         # scheduler queue depth at dispatch
    overlapped: bool                # dispatched before the prior one finished
    ready: Any = None               # torch.cuda.Event after the host copies
    acc: Any = None                 # spec: accepted draft tokens (host)
    prop: Any = None                # spec: proposed draft tokens (host)


@dataclasses.dataclass
class StagedWave:
    """One admission wave prepared off the dispatch path: prompts
    prefilled and first tokens sampled, awaiting its main-thread merge into
    free slots.  ``merged`` counts the leading requests already merged: a
    wave larger than the free slots (or page budget) merges across several
    boundaries, head of line first.  Request i rides prefill row
    ``rows[i]``, or -1 when resident prefix pages cover its first chunk and
    it admits with no prefill; ``keys0`` / ``eos`` / ``full`` / ``specs``
    are per request, ``ks`` / ``first`` / ``new_cache`` per prefill row."""

    reqs: list                      # staged Requests, in staged order
    first_lens: list                # wave-prefill coverage per request
    specs: list                     # resolved SamplingParams per request
    keys0: Any                      # (n, 2) base PRNG keys (numpy)
    eos: Any                        # (n,) eos ids (numpy)
    full: Any                       # (n,) whole prompt prefilled (numpy)
    rows: list                      # prefill row per request, -1 = skip
    ks: Any = None                  # (W, 2, 2) split keys (device)
    first: Any = None               # (W,) first sampled tokens (device)
    first_host: Any = None          # host copy of ``first``
    new_cache: Any = None           # slot-major prefill cache (device)
    draft_new_cache: Any = None     # the layer draft's twin (device)
    ready: Any = None               # torch.cuda.Event after the wave's work
    merged: int = 0                 # leading requests already merged


@dataclasses.dataclass
class StagedEntry:
    """One request in the device staging queue (continuous batching): the
    host-known carry row it was staged with, its un-ingested prompt tail
    and, on the pool, the pages it already owns; kept until a harvested
    window reports its install (by ``seq``, the FIFO key on the device)."""

    req: Any
    host_row: dict                  # state leaf name -> the row (numpy)
    pending: Any                    # un-ingested prompt tail (numpy)
    pages: list | None              # paged: physical pages already owned
    seq: int                        # staging sequence number (device key)
    keys0: Any                      # (2,) base PRNG key (mirror placeholder)
    full: bool                      # whole prompt covered by the prefill


@dataclasses.dataclass
class PreemptedRecord:
    """What re-admits a preempted slot: its window-state row at eviction,
    the un-ingested prompt tail, and the pages it held with their alloc
    stamps (an unchanged stamp proves the page still holds its content)."""

    req: Any
    host_row: dict                  # state leaf name -> the slot's row (numpy)
    pending: Any                    # un-ingested prompt tail (numpy)
    pages: list                     # physical pages held at eviction
    stamps: list                    # pool alloc stamp per page at eviction
    cur: int                        # tokens fed (cache positions written)
    at: int = 0                     # windows dispatched before the eviction


class TokenBacklog:
    """A FIFO of host-side work items drained by one daemon thread.

    Items are zero-argument callables.  The thread starts on the first
    ``put``, so a sync engine never spawns it.  ``flush`` blocks until
    every queued item has run; ``close`` flushes, stops the thread and
    joins it; both re-raise the first exception an item threw."""

    def __init__(self, name: str = "token-backlog"):
        self._name = name
        self._q: queue.Queue = queue.Queue()
        self._thread: threading.Thread | None = None
        self._err: BaseException | None = None
        self._closed = False

    @property
    def started(self) -> bool:
        return self._thread is not None

    @property
    def alive(self) -> bool:
        return self._thread is not None and self._thread.is_alive()

    def _ensure_thread(self):
        if self._thread is None:
            self._thread = threading.Thread(target=self._drain, name=self._name,
                                            daemon=True)
            self._thread.start()

    def _drain(self):
        while True:
            item = self._q.get()
            try:
                if item is _STOP:
                    return
                if self._err is None:
                    item()
            except BaseException as e:  # noqa: BLE001 — re-raised on the caller
                self._err = e
            finally:
                self._q.task_done()

    def _reraise(self):
        if self._err is not None:
            err, self._err = self._err, None
            raise RuntimeError(f"{self._name} worker failed while draining") from err

    def put(self, item: Callable[[], None]):
        if self._closed:
            raise RuntimeError(f"{self._name} is closed")
        self._reraise()
        self._ensure_thread()
        self._q.put(item)

    def flush(self):
        """Block until every item queued so far has been processed."""
        if self._thread is not None:
            self._q.join()
        self._reraise()

    def close(self):
        """Flush, stop and join the worker.  Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self._thread is not None:
            self._q.join()
            self._q.put(_STOP)
            self._thread.join()
            self._thread = None
        self._reraise()


class AdmissionWorker:
    """One daemon thread turning queue-head requests into staged waves.

    * ``take(max_n)`` (engine-provided) pops requests off the scheduler's
      queue under the engine's admission lock, the only scheduler surface
      the worker touches;
    * ``prepare(reqs) -> StagedWave`` (engine-provided) runs the wave
      prefill and first-token sample and mutates nothing host-visible;
    * the main thread drains prepared waves with ``poll()`` at window
      boundaries and owns every scheduler, pool and mirror mutation.

    ``kick(capacity)`` bounds look-ahead: the worker stages at most that
    many requests beyond what the main thread has merged.  A worker
    exception is re-raised on the main thread at the next ``poll``.

    With ``lockstep`` the worker takes no requests itself: the main
    thread ``submit``s each wave's requests and ``collect``s the waves
    (in submission order) at a later boundary; ``busy`` is then whether
    a submitted wave is not collected yet, which only the main thread
    moves, and ``close`` lets every submitted wave finish first (on a
    mesh each rank's worker runs collectives the others' wait for)."""

    def __init__(self, take: Callable[[int], list] | None, prepare: Callable[[list], Any],
                 name: str = "admission-prefill", lockstep: bool = False):
        self._take = take
        self._prepare = prepare
        self._name = name
        self.lockstep = lockstep
        self._cv = threading.Condition()
        self._out: list = []
        self._jobs: deque = deque()     # lockstep: submitted, not yet taken
        self._submitted = self._collected = 0
        self._err: BaseException | None = None
        self._capacity = 0
        self._busy = False
        self._stop = False
        self._thread: threading.Thread | None = None
        self.waves_prepared = 0
        self.prepare_seconds = 0.0     # worker-thread time (profile)

    @property
    def started(self) -> bool:
        return self._thread is not None

    @property
    def busy(self) -> bool:
        """True while the worker holds unpolled output or is preparing;
        in lockstep, while a submitted wave is not collected."""
        if self.lockstep:
            return self._submitted > self._collected
        with self._cv:
            return self._busy or bool(self._out)

    def submit(self, reqs: list):
        """Main thread, lockstep: queue a wave of ``reqs`` for the worker."""
        with self._cv:
            self._jobs.append(reqs)
            self._submitted += 1
            self._ensure_thread()
            self._cv.notify_all()

    def collect(self) -> list:
        """Main thread, lockstep: every wave submitted so far, in order,
        waiting for those still being prepared; re-raises a worker crash."""
        with self._cv:
            self._cv.wait_for(lambda: self._err is not None
                              or self._collected + len(self._out) == self._submitted)
            out, self._out = self._out, []
            self._collected += len(out)
        self._reraise()
        return out

    def _reraise(self):
        with self._cv:
            err, self._err = self._err, None
        if err is not None:
            raise RuntimeError(f"{self._name} worker failed while staging") from err

    def _ensure_thread(self):
        if self._thread is None and not self._stop:
            self._thread = threading.Thread(target=self._run, name=self._name,
                                            daemon=True)
            self._thread.start()

    def kick(self, capacity: int):
        """Main thread: set the staging budget and wake the worker."""
        with self._cv:
            self._capacity = max(0, capacity)
            if self._capacity > 0:
                self._ensure_thread()
            self._cv.notify_all()

    def _run(self):
        while True:
            with self._cv:
                while not self._stop and self._capacity <= 0 and not self._jobs:
                    self._cv.wait()
                if not self._jobs and self._stop:
                    return
                job = self._jobs.popleft() if self._jobs else None
                cap = self._capacity
            try:
                reqs = job if job is not None else self._take(cap)
                if not reqs:
                    with self._cv:
                        # nothing queued: sleep until the next kick
                        self._capacity = 0
                        self._busy = False
                        self._cv.notify_all()
                    continue
                with self._cv:
                    self._busy = True
                    if job is None:
                        self._capacity -= len(reqs)
                t0 = time.perf_counter()
                wave = self._prepare(reqs)
                dt = time.perf_counter() - t0
                with self._cv:
                    self._out.append(wave)
                    self.waves_prepared += 1
                    self.prepare_seconds += dt
                    self._busy = False
                    self._cv.notify_all()
            except BaseException as e:  # noqa: BLE001 — re-raised on the main thread
                with self._cv:
                    self._err = e
                    self._busy = False
                    self._stop = True
                    self._cv.notify_all()
                return

    def poll(self) -> list:
        """Main thread: every prepared wave so far; re-raises a worker
        crash (once), so a failed prefill fails the run."""
        with self._cv:
            out, self._out = self._out, []
        self._reraise()
        return out

    def wait(self, timeout: float | None = None) -> bool:
        """Main thread: block until a prepared wave (or a crash) is there,
        or the timeout lapses.  True when ``poll()`` would yield something."""
        with self._cv:
            self._cv.wait_for(lambda: bool(self._out) or self._err is not None,
                              timeout=timeout)
            return bool(self._out) or self._err is not None

    def close(self):
        """Stop and join the worker; a lockstep worker first prepares
        every wave submitted to it."""
        with self._cv:
            self._stop = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
