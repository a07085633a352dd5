"""Quarantined fault-tolerant *training* loop: the port of
``repro.runtime.train_loop``.

The training-side runtime (resume-from-latest, periodic async
checkpoints, preemption-safe exit).  It lives apart from
:mod:`~repro_torch.runtime.fault_tolerance` so the serving path can reuse
:class:`~repro_torch.runtime.fault_tolerance.Heartbeat` /
:class:`~repro_torch.runtime.fault_tolerance.StragglerMonitor` without
pulling in signal handling or checkpoint machinery.  A step's metrics are
0-d tensors; the log line reads them (``float``), which waits for the
device.
"""

from __future__ import annotations

import os
import signal
import time
from typing import Dict

from .fault_tolerance import Heartbeat, StragglerMonitor

__all__ = ["PreemptionGuard", "train_loop"]


class PreemptionGuard:
    """Converts SIGTERM/SIGINT into a cooperative "checkpoint now, then
    exit" signal (cloud preemption handling)."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self.requested = False
        self._prev = {}
        for s in signals:
            try:
                self._prev[s] = signal.signal(s, self._handler)
            except ValueError:            # not in main thread (tests)
                pass

    def _handler(self, signum, frame):
        self.requested = True

    def restore(self):
        for s, h in self._prev.items():
            signal.signal(s, h)


def train_loop(*, step_fn, state, data_iter, ckpt, total_steps: int,
               ckpt_every: int = 100, log_every: int = 10,
               log_fn=print) -> Dict:
    """Generic fault-tolerant loop.

    step_fn(state, batch) -> (state, metrics);  state must contain 'step'.
    Resumes from the newest checkpoint if one exists; checkpoints
    asynchronously; a preemption request forces a final checkpoint.
    """
    guard = PreemptionGuard()
    mon = StragglerMonitor()
    hb = Heartbeat(os.path.join(ckpt.dir, "HEARTBEAT"), interval_s=5)
    latest = ckpt.latest_step()
    if latest is not None:
        state = ckpt.restore(state, step=latest)
        data_iter.restore({"step": latest})
        start = latest
        log_fn(f"[resume] restored step {latest}")
    else:
        start = 0
    metrics = {}
    for step in range(start, total_steps):
        t0 = time.time()
        batch = next(data_iter)
        state, metrics = step_fn(state, batch)
        dt = time.time() - t0
        mon.record(step, dt)
        hb.beat(step)
        if log_every and step % log_every == 0:
            log_fn(f"[step {step}] "
                   + " ".join(f"{k}={float(v):.4f}"
                              for k, v in metrics.items()) + f" dt={dt:.3f}s")
        if ckpt_every and step and step % ckpt_every == 0:
            ckpt.save_async(step + 1, state)      # tag = steps completed
        if guard.requested:
            log_fn(f"[preempt] checkpointing at step {step} and exiting")
            ckpt.wait()
            ckpt.save(step + 1, state)
            break
    ckpt.wait()
    guard.restore()
    return {"state": state, "metrics": metrics,
            "stragglers": mon.flagged}
