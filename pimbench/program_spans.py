"""What the port records about its own host work, for the per-layer
readers that read it.

``repro_torch.runtime.telemetry`` keeps running totals of its live spans
(``TRACER.totals()``: count and seconds by span name).  A span is live
while a torch profiler records, which in a traced run is the window
alone: the warm-up runs before the profiler starts.  Its counters
(``REGISTRY``: bytes handed to the copies, dispatches, rows, modelled
cycles) are always on and count the warm-up too, so the readers take
only their ratios.

A port that keeps no totals, or lacks a counter, gives None: the metric
is then not measured.  It never gives 0 for what it did not see.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


def _telemetry():
    from repro_torch.runtime import telemetry
    return telemetry


def totals() -> Optional[Dict[str, Tuple[int, float]]]:
    """``{span name: (count, seconds)}``, or None where the port keeps no
    totals."""
    read = getattr(_telemetry().TRACER, "totals", None)
    return None if read is None else read()


def span_share(ctx: dict, *names: str) -> Optional[float]:
    """Seconds in the spans ``names`` over the window's seconds, or None
    where none of them opened."""
    tot = totals()
    if tot is None or ctx["window_s"] <= 0:
        return None
    seconds = [tot[n][1] for n in names if n in tot]
    return sum(seconds) / ctx["window_s"] if seconds else None


def ratio(num: Tuple[str, ...], den: str) -> Optional[float]:
    """The sum of the port's counters ``num`` over its counter ``den``, or
    None where any of them never counted or ``den`` is 0."""
    reg = _telemetry().REGISTRY
    values = [reg.counter(n, None) for n in num + (den,)]
    if any(v is None for v in values) or values[-1] <= 0:
        return None
    return sum(values[:-1]) / values[-1]
