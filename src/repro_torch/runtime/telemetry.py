"""Unified telemetry for the PIM stack (DESIGN.md §15).

One module owns every observable signal the pipeline produces:

* :class:`MetricsRegistry` -- a thread-safe registry of **counters** and
  **log-bucketed histograms** (p50/p95/p99 summaries) with
  snapshot/drain semantics.  A single re-entrant lock guards all mutation,
  so executor threads, the serving reader thread and the media scrubber
  can increment concurrently without losing updates -- the fix for the
  historically unguarded ``ops.HEALTH`` Counter.
* :class:`CounterGroup` -- a ``collections.Counter``-shaped *view* over a
  name prefix of a registry.  ``ops.HEALTH`` and ``faults.MEDIA`` are now
  such views (``pim.health.*`` / ``pim.media.*``); their historical
  ``drain_health()`` / ``drain_media_health()`` entry points are thin
  shims over :meth:`CounterGroup.drain`.
* :class:`Tracer` -- lightweight nested trace spans with per-stage wall
  timing through the whole pipeline (prepare -> enqueue -> coalesce/pack
  -> dispatch -> exec -> unpack -> finish), exportable as Chrome-trace /
  Perfetto-compatible JSON (``chrome://tracing``, ``ui.perfetto.dev``).
  A span is live while ``enabled`` is set or a torch profiler records;
  under the profiler it is also a ``record_function`` range, on the
  profiler's clock beside the kernels and copies, and every live span
  adds to running totals (:meth:`Tracer.totals`).  Off, a span is one
  predicate call and the shared null context.
* :class:`PimCostModel` -- the analytical cost model: per executed
  program, modeled PIM cycles (gate count + output-copy stage + INIT,
  one column op per cycle -- the paper's §7 execution model) and energy
  (per-command pJ from :data:`ENERGY_PJ`), recorded next to wall clock so
  schedule choices can be judged on the hardware they target ("The
  Bitlet Model", arXiv:1910.10234; PrIM methodology, arXiv:2110.01709).

Metric naming scheme (dots group, Prometheus rendering maps to ``_``):

====================  ====================================================
``pim.health.*``      fault-tolerance counters (ops.HEALTH view)
``pim.media.*``       media lifecycle counters (faults.MEDIA view)
``pim.serve.*``       serving runtime counters + latency histograms
``pim.batch.*``       per-batch histograms (exec_us, occupancy, groups)
``pim.cache.*``       compiled-program LRU hit/miss/eviction counters
``pim.exec.*``        dispatch counters (dispatches, rows)
``pim.model.*``       analytical cost counters (cycles, energy_pj)
``pim.transfer.*``    bytes handed to the host<->device copies
====================  ====================================================

This module sits at the bottom of the package's import graph: it imports
only the stdlib and ``core.device_model`` (which imports nothing), so
``runtime.faults`` -- itself imported by ``kernels.plan`` -- can depend
on it without a cycle.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import json
import math
import sys
import threading
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from ..core.device_model import PIM_DEFAULT, PIMDevice

__all__ = ["MetricsRegistry", "CounterGroup", "Histogram", "Tracer",
           "PimCostModel", "ModeledCost", "ENERGY_PJ", "REGISTRY",
           "TRACER", "COST_MODEL", "render_prometheus"]


# --------------------------------------------------------------------------
# histograms: log-bucketed, mergeable, percentile summaries
# --------------------------------------------------------------------------

# Buckets per octave: bucket ``i`` covers ``(2**((i-1)/4), 2**(i/4)]``, so
# neighbouring bucket edges differ by 2**(1/4) ~ 1.19x -- percentile
# estimates are exact at bucket edges and within ~9% relative error inside
# a bucket (linear interpolation over a <=19% wide bucket).  Indices are
# computed in O(1) from log2 and stored sparsely, so the value range is
# unbounded in both directions (microseconds to hours).
_SUB = 4


def _bucket_index(v: float) -> int:
    """Index of the log bucket containing ``v`` (> 0): the smallest ``i``
    with ``v <= 2**(i/_SUB)``.  Exact powers of ``2**(1/_SUB)`` land on
    their own upper edge (upper-inclusive buckets)."""
    return math.ceil(_SUB * math.log2(v))


def _bucket_hi(i: int) -> float:
    return 2.0 ** (i / _SUB)


def _bucket_lo(i: int) -> float:
    return 2.0 ** ((i - 1) / _SUB)


class Histogram:
    """Log-bucketed histogram of nonnegative observations.

    Tracks exact ``count``/``sum``/``min``/``max`` plus sparse per-bucket
    counts; values <= 0 land in a dedicated underflow bucket pinned at 0.
    Not internally locked -- the owning :class:`MetricsRegistry` serializes
    all access under its lock.
    """

    __slots__ = ("count", "total", "vmin", "vmax", "zeros", "buckets")

    def __init__(self):
        self.count = 0
        self.total = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf
        self.zeros = 0                     # observations <= 0
        self.buckets: Dict[int, int] = {}

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v
        if v <= 0.0:
            self.zeros += 1
        else:
            i = _bucket_index(v)
            self.buckets[i] = self.buckets.get(i, 0) + 1

    def percentile(self, q: float) -> float:
        """Estimated ``q``-quantile (``q`` in [0, 1]): cumulative bucket
        walk with linear interpolation inside the landing bucket, clamped
        to the exactly-tracked [min, max] envelope -- a single-valued
        histogram therefore reports that value for every quantile."""
        if self.count == 0:
            return math.nan
        target = q * self.count
        cum = self.zeros
        if cum >= target and self.zeros:
            return max(0.0, self.vmin)
        v = self.vmax
        for i in sorted(self.buckets):
            n = self.buckets[i]
            if cum + n >= target:
                frac = (target - cum) / n
                lo, hi = _bucket_lo(i), _bucket_hi(i)
                v = lo + frac * (hi - lo)
                break
            cum += n
        return min(max(v, self.vmin), self.vmax)

    def summary(self) -> dict:
        """``{count, sum, min, max, mean, p50, p95, p99}`` of what was
        observed so far (empty histogram: count 0, the rest NaN-free
        zeros so JSON stays clean)."""
        if self.count == 0:
            return {"count": 0, "sum": 0.0, "min": 0.0, "max": 0.0,
                    "mean": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        r = lambda x: round(float(x), 3)
        return {"count": self.count, "sum": r(self.total),
                "min": r(self.vmin), "max": r(self.vmax),
                "mean": r(self.total / self.count),
                "p50": r(self.percentile(0.50)),
                "p95": r(self.percentile(0.95)),
                "p99": r(self.percentile(0.99))}


# --------------------------------------------------------------------------
# the registry
# --------------------------------------------------------------------------

class MetricsRegistry:
    """Thread-safe registry of counters and histograms.

    All mutation happens under one re-entrant lock; reads return plain
    copies, never live references.  ``drain`` (snapshot-and-reset) is the
    contract the serving stats and the ``drain_health()`` /
    ``drain_media_health()`` shims ride on: a drain observes-and-clears
    atomically, so two racing drainers can never double-count and
    concurrent increments can never be lost between the read and the
    reset."""

    def __init__(self):
        self._lock = threading.RLock()
        self._counters: Dict[str, float] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------------ counters

    def inc(self, name: str, n: float = 1) -> None:
        with self._lock:
            self._counters[name] = self._counters.get(name, 0) + n

    def add_many(self, deltas: Dict[str, float]) -> None:
        """Fold a dict of counter deltas in under ONE lock acquisition --
        the hot-path form (per-dispatch recording is a single call)."""
        with self._lock:
            c = self._counters
            for name, n in deltas.items():
                c[name] = c.get(name, 0) + n

    def set_counter(self, name: str, value: float) -> None:
        """Absolute set (the Counter-compat ``group[k] = v`` form, used by
        gauge-like counters such as ``media.spans_still_bad``)."""
        with self._lock:
            self._counters[name] = value

    def counter(self, name: str, default: float = 0) -> float:
        with self._lock:
            return self._counters.get(name, default)

    def group(self, prefix: str) -> "CounterGroup":
        """A Counter-shaped view over ``prefix``-named counters."""
        return CounterGroup(self, prefix)

    # ------------------------------------------------------------ histograms

    def observe(self, name: str, value: float) -> None:
        with self._lock:
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = Histogram()
            h.observe(value)

    def observe_many(self, values: Dict[str, float]) -> None:
        """Several single observations under one lock acquisition."""
        with self._lock:
            for name, v in values.items():
                h = self._hists.get(name)
                if h is None:
                    h = self._hists[name] = Histogram()
                h.observe(v)

    def summary(self, name: str) -> Optional[dict]:
        """One histogram's summary dict, or None if never observed."""
        with self._lock:
            h = self._hists.get(name)
            return h.summary() if h is not None else None

    # ------------------------------------------------------------ snapshot /
    # drain

    def snapshot(self) -> dict:
        """Point-in-time copy: ``{"counters": {...}, "histograms":
        {name: summary}}``.  Zero-valued counters are kept
        (they exist because someone incremented them past zero and back
        via drain -- snapshot never filters)."""
        with self._lock:
            return {"counters": dict(self._counters),
                    "histograms": {n: h.summary()
                                   for n, h in self._hists.items()}}

    def drain(self, prefix: str = "") -> Dict[str, float]:
        """Snapshot-and-reset every counter whose name starts with
        ``prefix`` (all of them for ""); returns the non-zero removed
        values.  Histograms are untouched."""
        with self._lock:
            out = {}
            for name in [n for n in self._counters
                         if n.startswith(prefix)]:
                v = self._counters.pop(name)
                if v:
                    out[name] = int(v) if float(v).is_integer() else v
            return out


class CounterGroup:
    """A ``collections.Counter``-shaped view over one name prefix of a
    :class:`MetricsRegistry` -- the migration vehicle for the historical
    module-global Counters (``ops.HEALTH``, ``faults.MEDIA``).

    Supports the Counter surface those call sites used (``[]``/``get``/
    ``items``/``clear``/truthiness) plus :meth:`add`, the *atomic*
    increment (``g[k] += 1`` expands to a get-then-set pair, which is not
    atomic across threads; hot increment sites use ``add``).  ``drain()``
    is the snapshot-and-reset behind ``drain_health()``."""

    __slots__ = ("_reg", "_prefix")

    def __init__(self, registry: MetricsRegistry, prefix: str):
        self._reg = registry
        self._prefix = prefix.rstrip(".") + "."

    @property
    def registry(self) -> MetricsRegistry:
        return self._reg

    def _full(self, key: str) -> str:
        return self._prefix + key

    def add(self, key: str, n: float = 1) -> None:
        self._reg.inc(self._full(key), n)

    def __getitem__(self, key: str) -> float:
        v = self._reg.counter(self._full(key))
        return int(v) if float(v).is_integer() else v

    def __setitem__(self, key: str, value: float) -> None:
        self._reg.set_counter(self._full(key), value)

    def get(self, key: str, default: float = 0) -> float:
        v = self._reg.counter(self._full(key), default)
        return int(v) if float(v).is_integer() else v

    def items(self) -> List[Tuple[str, float]]:
        p = self._prefix
        with self._reg._lock:
            return [(n[len(p):], v) for n, v in self._reg._counters.items()
                    if n.startswith(p)]

    def keys(self) -> List[str]:
        return [k for k, _ in self.items()]

    def __iter__(self):
        return iter(self.keys())

    def __len__(self) -> int:
        return len(self.items())

    def __contains__(self, key: str) -> bool:
        with self._reg._lock:
            return self._full(key) in self._reg._counters

    def __bool__(self) -> bool:
        return any(v for _, v in self.items())

    def clear(self) -> None:
        self._reg.drain(self._prefix)

    def drain(self) -> Dict[str, int]:
        """Atomic snapshot-and-reset; returns the non-zero counters with
        the prefix stripped (the historical ``drain_health()`` shape)."""
        p = self._prefix
        return {n[len(p):]: int(v)
                for n, v in self._reg.drain(p).items()}


# --------------------------------------------------------------------------
# trace spans (Chrome-trace / Perfetto "X" complete events)
# --------------------------------------------------------------------------

class _Span:
    """One open live span: a context manager that adds its wall time to
    the tracer's totals on exit, emits a complete ("X") event when the
    tracer is enabled, and is a ``record_function`` range while a torch
    profiler records.  Cheap on purpose -- two perf_counter reads, one
    lock."""

    __slots__ = ("_tracer", "name", "cat", "args", "_t0", "_range")

    def __init__(self, tracer: "Tracer", name: str, cat: str, args: dict,
                 profiler=None):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.args = args
        self._range = None if profiler is None else \
            profiler.record_function(name)

    def __enter__(self) -> "_Span":
        if self._range is not None:
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
        self._tracer._close(self, t1)


_NULL_SPAN = contextlib.nullcontext()


def _recording_profiler():
    """``torch.autograd.profiler`` while a torch profiler records, else
    None.  torch is looked up in ``sys.modules``, never imported: a
    process without torch has no profiler."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof if prof is not None and prof._is_profiler_enabled else None


class Tracer:
    """Nested trace spans with per-stage wall timing, exportable as
    Chrome-trace JSON (the ``{"traceEvents": [...]}`` envelope both
    ``chrome://tracing`` and Perfetto load directly).

    A span is live while ``enabled`` is set (``serve.py
    --pim-trace-file``) or a torch profiler records (:attr:`live`); off,
    :meth:`span` returns the shared null context.  A live span adds its
    count and seconds to running totals under its name (:meth:`totals`),
    so a long window loses nothing to the ring's capacity; under a
    profiler it is also a ``record_function`` range, a
    ``user_annotation`` event on the profiler's clock, nested under the
    caller's range.

    Events go to the ring only while ``enabled``: they carry real thread
    ids and microsecond ``ts``/``dur`` on this tracer's own
    ``perf_counter`` epoch, which is all the Chrome trace model needs to
    stack them.  The ring is bounded (``capacity`` events, oldest
    dropped), so a long-running server can leave tracing on without
    unbounded growth."""

    def __init__(self, capacity: int = 1 << 16):
        self.enabled = False
        self._lock = threading.Lock()
        self._events: "collections.deque" = collections.deque(
            maxlen=capacity)
        self._totals: Dict[str, List[float]] = {}
        self._epoch = time.perf_counter()

    @property
    def live(self) -> bool:
        """True while ``enabled`` is set or a torch profiler records."""
        return self.enabled or _recording_profiler() is not None

    def span(self, name: str, cat: str = "pim", **args):
        """Context manager timing one pipeline stage; the shared null
        context unless the tracer is live."""
        prof = _recording_profiler()
        if prof is None and not self.enabled:
            return _NULL_SPAN
        return _Span(self, name, cat, args, prof)

    def _close(self, span: _Span, t1: float) -> None:
        with self._lock:
            tot = self._totals.get(span.name)
            if tot is None:
                tot = self._totals[span.name] = [0, 0.0]
            tot[0] += 1
            tot[1] += t1 - span._t0
        if self.enabled:
            self.event(span.name, span._t0, t1, cat=span.cat, **span.args)

    def totals(self) -> Dict[str, Tuple[int, float]]:
        """``{name: (count, seconds)}`` of the live spans closed since the
        last :meth:`drain`."""
        with self._lock:
            return {n: (int(c), s) for n, (c, s) in self._totals.items()}

    def event(self, name: str, t0: float, t1: float, cat: str = "pim",
              **args) -> None:
        """Record a retroactive span from ``perf_counter`` stamps --
        how queue-wait (admission -> dequeue) is traced: the waiting
        thread never blocks on instrumentation; the dequeuer back-fills
        the span.  Only while ``enabled``."""
        if not self.enabled:
            return
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": round((t0 - self._epoch) * 1e6, 1),
              "dur": round((t1 - t0) * 1e6, 1),
              "pid": 1, "tid": threading.get_ident() & 0xFFFF}
        if args:
            ev["args"] = args
        with self._lock:
            self._events.append(ev)

    def instant(self, name: str, cat: str = "pim", **args) -> None:
        """Zero-duration instant event (batch boundaries, trips)."""
        if not self.enabled:
            return
        now = time.perf_counter()
        self.event(name, now, now, cat=cat, **args)

    def drain(self) -> List[dict]:
        """The ring's events; clears them and the totals."""
        with self._lock:
            out = list(self._events)
            self._events.clear()
            self._totals.clear()
        return out

    def write_chrome_trace(self, path: str) -> int:
        """Drain the buffer into a Chrome-trace JSON file; returns the
        event count written."""
        events = self.drain()
        with open(path, "w") as f:
            json.dump({"traceEvents": events,
                       "displayTimeUnit": "ms"}, f)
            f.write("\n")
        return len(events)


# --------------------------------------------------------------------------
# analytical cost model (the paper's §7 substrate, Bitlet-style)
# --------------------------------------------------------------------------

#: Command-energy table, pJ.  ``nor``/``init`` are per column op per row
#: (one crossbar column switch: the device model's 24.3 fJ RRAM figure);
#: ``read``/``write`` are per bit moved across the array periphery
#: (sense-amp readout / write-driver programming of the IO ports --
#: order-of-magnitude ReRAM periphery figures, dominated by the gate term
#: for compute-heavy programs, and exactly the knob to retune when a real
#: device datasheet lands).
ENERGY_PJ: Dict[str, float] = {
    "nor": PIM_DEFAULT.gate_energy_fj * 1e-3,     # 0.0243
    "init": PIM_DEFAULT.gate_energy_fj * 1e-3,    # INIT1 is a column op
    "read": 0.05,                                 # per IO bit out
    "write": 0.10,                                # per IO bit in
}


@dataclasses.dataclass(frozen=True)
class ModeledCost:
    """One program's modeled execution on the PIM substrate.

    ``cycles`` counts one column op per cycle (every crossbar in lockstep
    -- the paper's execution model): live NOR gates + the slot
    allocator's output-copy stage + one INIT1 broadcast when the schedule
    folds a constant-one cell.  ``levels`` is the parallel depth (what a
    multi-issue array would bound latency by); both are reported so
    schedule choices can be judged under either model.  Energy splits
    into the gate term (``cycles`` column ops x rows) and the IO term
    (port bits read/written per row)."""
    levels: int
    gates: int
    init_cycles: int
    cycles: int
    io_bits: int                     # port bits moved per row (in + out)
    latency_us: float                # cycles x cycle_ns (row-independent)
    energy_pj_per_row: float

    def energy_pj(self, n_rows: int) -> float:
        return self.energy_pj_per_row * n_rows


@dataclasses.dataclass(frozen=True)
class PimCostModel:
    """Analytical cycles/energy model over levelized schedules, seeded
    from :data:`~repro_torch.core.device_model.PIM_DEFAULT` (RACER-derived
    memristive parameters, as in the paper's §7 case study)."""
    device: PIMDevice = PIM_DEFAULT
    energy_pj: Tuple[Tuple[str, float], ...] = tuple(
        sorted(ENERGY_PJ.items()))

    def _e(self, cmd: str) -> float:
        return dict(self.energy_pj)[cmd]

    def cost(self, *, gates: int, levels: int = 0, init_cycles: int = 0,
             io_bits: int = 0) -> ModeledCost:
        cycles = int(gates) + int(init_cycles)
        e_row = (cycles * self._e("nor")
                 + io_bits * (self._e("read") + self._e("write")) / 2.0)
        return ModeledCost(
            levels=int(levels), gates=int(gates),
            init_cycles=int(init_cycles), cycles=cycles,
            io_bits=int(io_bits),
            latency_us=cycles * self.device.cycle_ns * 1e-3,
            energy_pj_per_row=e_row)

    def schedule_cost(self, sched) -> ModeledCost:
        """Modeled cost of one :class:`~repro_torch.core.gates.LevelSchedule`:
        gate cycles = live gates after DCE + the contiguous-output copy
        stage (``copy_gates`` -- real column ops on the device), INIT1
        counted once when folded, IO bits = every port cell crossing the
        periphery once."""
        return self.cost(
            gates=int(sched.n_gates) + int(getattr(sched, "copy_gates", 0)),
            levels=int(sched.n_levels),
            init_cycles=1 if getattr(sched, "one_cell", None) is not None
            else 0,
            io_bits=sum(len(c) for c in sched.ports.values()))

    def program_cost(self, cost) -> ModeledCost:
        """Modeled cost from a gate-serial :class:`~repro_torch.core.gates.Cost`
        (the un-levelized executors and the closed-form benchmark rows)."""
        return self.cost(gates=int(cost.nor_gates),
                         levels=int(cost.abstract_steps),
                         init_cycles=int(cost.init_cycles))


# --------------------------------------------------------------------------
# process-global instances + hot-path recording helpers
# --------------------------------------------------------------------------

#: The default process-wide registry: module-global counter stores
#: (``ops.HEALTH``, ``faults.MEDIA``, the compiled-cache and dispatch
#: counters) live here.  Serving runtimes own *separate* registries for
#: their per-instance stats so tests stay isolated.
REGISTRY = MetricsRegistry()

#: The default tracer: its spans are live under a torch profiler, and it
#: keeps events once ``--pim-trace-file`` or a test sets ``enabled``.
TRACER = Tracer()

#: The default analytical cost model.
COST_MODEL = PimCostModel()


def record_dispatch(n_rows: int, model: Optional[ModeledCost]) -> None:
    """Fold one levelized dispatch into the global registry: dispatch /
    row counters plus the modeled cycle and energy counters.  ONE lock
    acquisition with a prebuilt dict -- the per-dispatch overhead is a
    handful of dict ops, independent of ``n_rows`` and schedule size
    (pinned by tests/test_telemetry.py)."""
    if model is None:
        REGISTRY.add_many({"pim.exec.dispatches": 1,
                           "pim.exec.rows": n_rows})
        return
    REGISTRY.add_many({
        "pim.exec.dispatches": 1,
        "pim.exec.rows": n_rows,
        "pim.model.cycles": model.cycles,
        "pim.model.energy_pj": model.energy_pj_per_row * n_rows,
    })


def drain_model_counters() -> Dict[str, float]:
    """Snapshot-and-reset the ``pim.exec.*`` + ``pim.model.*`` counters
    (what ``benchmarks/run.py`` windows around one measured call)."""
    out = REGISTRY.drain("pim.exec.")
    out.update(REGISTRY.drain("pim.model."))
    return out


# --------------------------------------------------------------------------
# Prometheus text exposition
# --------------------------------------------------------------------------

def _prom_name(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def render_prometheus(*registries: MetricsRegistry) -> str:
    """Prometheus-style text exposition of one or more registries:
    counters as single samples, histograms as summaries
    (``{quantile="0.5|0.95|0.99"}`` + ``_count``/``_sum``).  Written by
    ``serve.py --pim-metrics-file`` so any textfile-collector style
    scraper can pick serving metrics up without a wire protocol."""
    lines: List[str] = []
    for reg in (registries or (REGISTRY,)):
        snap = reg.snapshot()
        for name in sorted(snap["counters"]):
            pn = _prom_name(name)
            lines.append(f"# TYPE {pn} counter")
            lines.append(f"{pn} {snap['counters'][name]:g}")
        for name in sorted(snap["histograms"]):
            pn = _prom_name(name)
            s = snap["histograms"][name]
            lines.append(f"# TYPE {pn} summary")
            for q, key in (("0.5", "p50"), ("0.95", "p95"),
                           ("0.99", "p99")):
                lines.append(f'{pn}{{quantile="{q}"}} {s[key]:g}')
            lines.append(f"{pn}_count {s['count']:g}")
            lines.append(f"{pn}_sum {s['sum']:g}")
    return "\n".join(lines) + "\n"
