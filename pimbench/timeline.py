"""The card's timeline over the measured window, read from a
``torch.profiler`` trace.

The harness marks the window and each call's two phases with
``record_function`` ranges (``pimbench.window``, ``pimbench.frontend``,
``pimbench.run``), so the host's spans and the device's kernels and copies
are on one clock.  Everything is clipped to the window.  Times are seconds.
"""

from __future__ import annotations

import bisect
import json
from pathlib import Path
from typing import Dict, List, Optional, Tuple

WINDOW = "pimbench.window"
SPANS = ("pimbench.frontend", "pimbench.run")

Interval = Tuple[float, float]


def merged(intervals) -> List[List[float]]:
    """Merged [start, end) intervals."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def total(intervals) -> float:
    return sum(e - s for s, e in merged(intervals))


def overlap(intervals, others) -> float:
    """Time of ``intervals`` that runs while any of ``others`` does."""
    m = merged(others)
    starts = [ms for ms, _ in m]
    out = 0.0
    for s, e in intervals:
        i = max(0, bisect.bisect_right(starts, s) - 1)
        while i < len(m) and m[i][0] < e:
            out += max(0.0, min(e, m[i][1]) - max(s, m[i][0]))
            i += 1
    return out


def gaps(busy, window: Interval) -> List[Interval]:
    """The idle stretches of ``window`` outside ``busy``."""
    out, t = [], window[0]
    for s, e in merged(busy):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if window[1] > t:
        out.append((t, window[1]))
    return out


def read_trace(path: Path) -> List[dict]:
    return [e for e in json.loads(Path(path).read_text())
            .get("traceEvents", []) if e.get("ph") == "X" and "dur" in e]


def timeline(events: List[dict]) -> Optional[Dict]:
    """The window's device activity and host spans, or None where the
    trace holds no window or no device activity in it."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if not win:
        return None
    ws = win[0]["ts"] / 1e6
    we = ws + win[0]["dur"] / 1e6

    def clipped(cat_test):
        out = []
        for e in events:
            if not cat_test(e.get("cat", "")):
                continue
            s = e["ts"] / 1e6
            s, t = max(s, ws), min(s + e["dur"] / 1e6, we)
            if t > s:
                out.append((s, t, e.get("name", "")))
        return out

    kernels = clipped(lambda c: c == "kernel")
    copies = clipped(lambda c: c == "gpu_memcpy")
    memsets = clipped(lambda c: c == "gpu_memset")
    device = kernels + copies + memsets
    if not device:
        return None
    spans = [(s, t, n) for s, t, n in clipped(lambda c: c == "user_annotation")
             if n in SPANS]
    return {
        "window": (ws, we),
        "kernels": kernels,
        "h2d": [c for c in copies if "HtoD" in c[2]],
        "d2h": [c for c in copies if "DtoH" in c[2]],
        "copies": copies,
        "device": device,
        "spans": spans,
    }


def busy_s(tl: Dict) -> float:
    return total((s, e) for s, e, _ in tl["device"])


def window_s(tl: Dict) -> float:
    return tl["window"][1] - tl["window"][0]


def top_device_ops(tl: Dict, n: int = 10) -> List[list]:
    """[name, seconds] of the device operations that took most time."""
    by: Dict[str, float] = {}
    for s, e, name in tl["device"]:
        by[name] = by.get(name, 0.0) + (e - s)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def _host_at(tl: Dict, s: float, e: float) -> str:
    """The host span that covers most of [s, e): the call's frontend or
    its run, or nothing of either (between calls)."""
    best, name = 0.0, "between calls"
    for ss, se, n in tl["spans"]:
        o = min(e, se) - max(s, ss)
        if o > best:
            best, name = o, n.split(".", 1)[1]
    return name


def idle_gaps(tl: Dict, n: int = 10) -> List[list]:
    """[what the host was doing, seconds] of the longest idle gaps."""
    g = sorted(gaps([(s, e) for s, e, _ in tl["device"]], tl["window"]),
               key=lambda iv: iv[0] - iv[1])[:n]
    return [[_host_at(tl, s, e), e - s] for s, e in g]
