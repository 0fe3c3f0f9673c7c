"""Per-step watchdog + step-time statistics (hang / straggler detection)
(port of ``repro.runtime.watchdog``; standard library only).

A host thread arms a deadline before each step; if the step does not
disarm in time the hook fires (default: record it, and ``disarm`` raises
``WatchdogTimeout`` in the main thread).
"""

from __future__ import annotations

import threading
import time


class WatchdogTimeout(RuntimeError):
    pass


class Watchdog:
    def __init__(self, deadline_s: float, on_timeout=None):
        self.deadline_s = deadline_s
        self.on_timeout = on_timeout
        self._timer: threading.Timer | None = None
        self.fired: str | None = None
        self.step_times: list[float] = []
        self._t0 = 0.0

    def _fire(self, label: str):
        self.fired = label
        if self.on_timeout:
            self.on_timeout(label)

    def arm(self, label: str = "step"):
        self.disarm()
        self.fired = None
        self._t0 = time.monotonic()
        self._timer = threading.Timer(self.deadline_s, self._fire, args=(label,))
        self._timer.daemon = True
        self._timer.start()

    def disarm(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
            self.step_times.append(time.monotonic() - self._t0)
        if self.fired is not None:
            raise WatchdogTimeout(
                f"watchdog fired for {self.fired!r} after {self.deadline_s}s")

    def straggler_score(self) -> float:
        """Last step time / median — >2 suggests a straggling host."""
        if len(self.step_times) < 3:
            return 1.0
        xs = sorted(self.step_times)
        med = xs[len(xs) // 2]
        return self.step_times[-1] / max(med, 1e-9)
