"""Liveness primitives shared by the serving loop (DESIGN.md §12).

The counterpart of ``repro.runtime.fault_tolerance``:

* :class:`Heartbeat` -- liveness file an external supervisor can watch;
  ``--pim-heartbeat PATH`` makes the batched server beat it once per
  batch so a dead or wedged server is detectable from outside.
* :class:`StragglerMonitor` -- wall-time spike detection over a trailing
  median; the server records per-batch execution time and surfaces the
  spike count in its stats line.  In a multi-host deployment each host
  reports a heartbeat and the policy hook decides (log / re-shard /
  evict).  Single-process here, same API.

The training loop (:mod:`~repro_torch.runtime.train_loop`) imports both
classes back, as the reference's does.
"""

from __future__ import annotations

import collections
import os
import time
from typing import Callable, Optional

import numpy as np

__all__ = ["Heartbeat", "StragglerMonitor"]


class StragglerMonitor:
    """Flags steps slower than ``threshold`` x the trailing median."""

    def __init__(self, window: int = 50, threshold: float = 2.0,
                 policy: Optional[Callable[[int, float, float], None]] = None):
        self.times = collections.deque(maxlen=window)
        self.threshold = threshold
        self.policy = policy
        self.flagged = []

    def record(self, step: int, dt: float) -> bool:
        is_straggler = False
        if len(self.times) >= 10:
            med = float(np.median(self.times))
            if dt > self.threshold * med:
                is_straggler = True
                self.flagged.append((step, dt, med))
                if self.policy:
                    self.policy(step, dt, med)
        self.times.append(dt)
        return is_straggler


class Heartbeat:
    def __init__(self, path: str, interval_s: float = 10.0):
        self.path = path
        self.interval = interval_s
        self._last = 0.0

    def beat(self, step: int) -> None:
        now = time.time()
        if now - self._last >= self.interval:
            tmp = self.path + ".tmp"
            with open(tmp, "w") as f:
                f.write(f"{step} {now}")
            os.replace(tmp, self.path)
            self._last = now
