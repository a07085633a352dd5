"""Batched serving runtime for the PIM ufunc API (DESIGN.md §10).

The counterpart of ``repro.runtime.pim_batch``, over the port's
``kernels.ops``.  ``launch/serve.py --pim-stdin`` executes one gate
program per request, which leaves the machine's row axis -- the dimension
the paper's throughput case (Fig. 9) banks on -- mostly idle under heavy
mixed traffic.  This module sits between the JSON request layer and
``kernels/ops.py`` and fills that axis:

* :class:`BatchQueue` -- thread-safe admission with a micro-batching
  window: block for the first request, then keep admitting until the
  window closes, the row cap fills, or the stream ends.  An optional
  queue-depth cap turns :meth:`BatchQueue.offer` into backpressure: past
  the cap a request is rejected (structured, retriable) instead of
  growing the queue without bound -- the producer never blocks and the
  consumer never deadlocks (DESIGN.md §12).
* :func:`plan_groups` -- the planner: group a batch's prepared requests by
  compiled-program content hash + execution config (``Prepared.key`` makes
  structurally identical requests trivially groupable).
* :func:`coalesce` -- concatenate each group's per-port rows, in arrival
  order, into one packed input set.
* :meth:`BatchRuntime.execute` -- run the whole plan through
  ``kernels.ops.run_program_groups`` (group ``k+1`` packs on the host
  while group ``k`` executes on the device -- the streaming pipeline
  generalized across programs), then *split*: scatter each group's output
  rows back to its member requests via ``Prepared.finish`` with
  per-request accounting.
* :class:`PinnedSchedules` -- an LRU-pinned working set of compiled slot
  schedules: hot programs stay resident in the bounded compiled-program
  cache even when cold traffic churns it, so they never recompile
  mid-serving.

Everything operates on :class:`repro_torch.pim_ufunc.Prepared` handles, so
the runtime is equally usable programmatically (tests, ``chip_smoke.py``)
and from the ``--pim-serve`` JSON-lines loop.  Execution runs where each
request's plan says (the CUDA kernels by default).  A family whose
circuit breaker is open is shed -- run without its fault model and verify
policy, counted in ``shed_requests`` and marked ``shed`` -- on its own
card, or on the host's numpy oracle when its plan runs on the host; only
faults that exhaust their retries and deadline misses trip a breaker.
"""

from __future__ import annotations

import collections
import dataclasses
import queue
import threading
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..kernels import ops as kops
from ..pim_ufunc import Prepared
from . import telemetry
from .faults import DeadlineExceeded, FaultError

DEFAULT_WINDOW_MS = 2.0
DEFAULT_MAX_BATCH_ROWS = 1 << 16
DEFAULT_PIN_CAP = 32


# --------------------------------------------------------------------------
# planner
# --------------------------------------------------------------------------

def group_key(prep: Prepared) -> tuple:
    """The coalescing key: program content hash plus the full execution
    config -- ``ExecPlan.key`` covers every dimension that makes two
    executions non-mergeable (backend, schedule, *word layout*, chunking,
    mesh, per-backend tunables), so requests differing in any of them --
    e.g. only in word layout -- never coalesce into one packed state.  Two
    requests with equal keys run bit-identically as one packed state."""
    return (prep.key, prep.plan.key)


@dataclasses.dataclass
class Group:
    """One plan entry: the member requests (by batch index, arrival order)
    that share a program structure and execution config."""
    key: tuple
    members: List[int]
    preps: List[Prepared]
    n_rows: int = 0
    cached: bool = False        # were schedule artifacts already compiled?


def plan_groups(preps: Sequence[Prepared]) -> List[Group]:
    """Group a batch of prepared requests by :func:`group_key`.  Stable:
    groups are ordered by first arrival and members keep arrival order, so
    coalesced row offsets are reproducible."""
    by_key: Dict[tuple, Group] = {}
    plan: List[Group] = []
    for i, p in enumerate(preps):
        k = group_key(p)
        g = by_key.get(k)
        if g is None:
            g = by_key[k] = Group(k, [], [])
            plan.append(g)
        g.members.append(i)
        g.preps.append(p)
        g.n_rows += p.n_rows
    return plan


def coalesce(group: Group) -> Dict[str, np.ndarray]:
    """One packed input set for a group: per port, the members' rows
    concatenated in arrival order (the splitter reverses this by offset).
    Mixed member dtypes (e.g. uint16 and object rows of one width) promote
    under numpy's rules; the bridges take either."""
    first = group.preps[0]
    out = {}
    for name in first.inputs:
        parts = [p.inputs[name] for p in group.preps]
        out[name] = parts[0] if len(parts) == 1 else np.concatenate(parts)
    return out


# --------------------------------------------------------------------------
# pinned schedule working set
# --------------------------------------------------------------------------

class PinnedSchedules:
    """LRU working set of pinned compiled schedules (``cap`` programs).

    ``touch`` pins a program's compiled-cache entry in ``kernels.ops`` (see
    ``pin_program``) and refreshes its recency; when the working set
    overflows, the least-recently-served program is unpinned (it stays
    cached but becomes evictable).  Under mixed traffic this keeps the hot
    programs' levelized schedules and device index buffers resident no
    matter how many cold structures stream past.  ``cap=0`` disables
    pinning entirely."""

    def __init__(self, cap: int = DEFAULT_PIN_CAP):
        if cap < 0:
            raise ValueError(f"pin cap must be >= 0, got {cap}")
        self.cap = int(cap)
        self._lru: "collections.OrderedDict[bytes, bool]" = \
            collections.OrderedDict()

    def __len__(self) -> int:
        return len(self._lru)

    def __contains__(self, key: bytes) -> bool:
        return key in self._lru

    def touch(self, program, plan=None) -> Optional[tuple]:
        """Pin ``program``'s compiled entry under ``plan`` (default: the
        default plan; or refresh its recency); returns the cache key, or
        None when pinning is disabled."""
        if not self.cap:
            return None
        key = kops.cache_key(program, plan)
        if key in self._lru:
            self._lru.move_to_end(key)
            return key
        kops.pin_program(program, plan)
        self._lru[key] = True
        while len(self._lru) > self.cap:
            old, _ = self._lru.popitem(last=False)
            kops.unpin_program(old)
        return key

    def clear(self) -> None:
        """Release every pin (used on server shutdown and in tests)."""
        while self._lru:
            key, _ = self._lru.popitem(last=False)
            kops.unpin_program(key)


# --------------------------------------------------------------------------
# admission queue
# --------------------------------------------------------------------------

class BatchQueue:
    """Thread-safe admission queue with a micro-batching window.

    Producers :meth:`put` items (with a row weight) and finally
    :meth:`close`; one consumer calls :meth:`collect`, which blocks for the
    first item, then keeps admitting until (a) ``window_ms`` elapses from
    that first admission, (b) admitted rows reach ``max_batch_rows`` (the
    request that crosses the cap is still admitted -- requests are never
    split), or (c) the stream ends.  Returns None once the stream is
    exhausted.  ``window_ms=0`` degenerates to "whatever is already
    queued", which keeps single-request latency at its floor.

    ``max_queue_rows`` bounds admission: when set, :meth:`offer` rejects a
    request whose rows would push the queued backlog past the cap --
    *unless* the queue is empty, so an oversized single request is still
    servable (it would never fit otherwise).  Rejection is a return value,
    not an exception, and nothing ever blocks the producer: the server
    turns a False into a structured retriable "overloaded" response."""

    _EOF = object()

    def __init__(self, window_ms: float = DEFAULT_WINDOW_MS,
                 max_batch_rows: int = DEFAULT_MAX_BATCH_ROWS,
                 max_queue_rows: Optional[int] = None):
        if max_batch_rows < 1:
            raise ValueError(
                f"max_batch_rows must be >= 1, got {max_batch_rows}")
        if max_queue_rows is not None and max_queue_rows < 1:
            raise ValueError(
                f"max_queue_rows must be >= 1 or None, got {max_queue_rows}")
        self.window_s = max(0.0, float(window_ms)) * 1e-3
        self.max_batch_rows = int(max_batch_rows)
        self.max_queue_rows = None if max_queue_rows is None \
            else int(max_queue_rows)
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        self._eof = False
        self._lock = threading.Lock()
        self._pending_rows = 0

    def put(self, item, n_rows: int = 0) -> None:
        with self._lock:
            self._pending_rows += int(n_rows)
        self._q.put((item, int(n_rows)))

    def offer(self, item, n_rows: int = 0) -> bool:
        """Admit ``item`` unless the backlog cap would be exceeded; returns
        False (rejection) instead of blocking.  With no cap, equivalent to
        :meth:`put`."""
        n = int(n_rows)
        with self._lock:
            if (self.max_queue_rows is not None and n > 0
                    and self._pending_rows > 0
                    and self._pending_rows + n > self.max_queue_rows):
                return False
            self._pending_rows += n
        self._q.put((item, n))
        return True

    def close(self) -> None:
        """Signal end of stream (producer side)."""
        self._q.put((self._EOF, 0))

    def collect(self) -> Optional[list]:
        """The next admission batch (arrival order), or None at end."""
        if self._eof:
            return None
        item, rows = self._q.get()
        if item is self._EOF:
            self._eof = True
            return None
        self._drain(rows)
        batch = [item]
        total = rows
        deadline = time.monotonic() + self.window_s
        while total < self.max_batch_rows:
            remaining = deadline - time.monotonic()
            try:
                item, rows = self._q.get(timeout=max(0.0, remaining)) \
                    if remaining > 0 else self._q.get_nowait()
            except queue.Empty:
                break
            if item is self._EOF:
                self._eof = True
                break
            self._drain(rows)
            batch.append(item)
            total += rows
        return batch

    def _drain(self, rows: int) -> None:
        with self._lock:
            self._pending_rows = max(0, self._pending_rows - rows)


# --------------------------------------------------------------------------
# error taxonomy (DESIGN.md §12)
# --------------------------------------------------------------------------

_BAD_REQUEST = (KeyError, TypeError, ValueError, OverflowError)

#: The error codes a family's breaker counts as failures: faults that
#: exhaust their retries and deadline misses.  An ``internal`` error (a
#: CUDA launch or build error, an out-of-memory) is answered as an error
#: and never trips a breaker, so it can never turn into shed answers.
TRIP_CODES = ("exec_failed", "deadline_exceeded")


def classify_error(e: BaseException) -> dict:
    """Map an exception to the structured wire-format error body: a
    machine-readable ``code``, the human message, and whether a retry of
    the *same* request could succeed (bad requests never will; transient
    execution faults, deadline misses, and overload might).  A
    :class:`FaultError` carrying structured context (program-key prefix,
    chunk/stage, attempts, remap target -- DESIGN.md §14) surfaces it
    under ``error.fault`` so operators can tell *which* program family is
    failing, not just that retries happened."""
    if isinstance(e, DeadlineExceeded):
        code, retriable = "deadline_exceeded", True
    elif isinstance(e, FaultError):
        code, retriable = "exec_failed", True
    elif isinstance(e, _BAD_REQUEST):
        code, retriable = "bad_request", False
    else:
        code, retriable = "internal", True
    body = {"code": code, "message": f"{type(e).__name__}: {e}",
            "retriable": retriable}
    ctx = getattr(e, "context", None)
    if ctx:
        body["fault"] = dict(ctx)
    return {"error": body}


# --------------------------------------------------------------------------
# per-program-family circuit breakers (DESIGN.md §14)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BreakerPolicy:
    """Knobs of the per-(program family) circuit breaker.

    * ``window`` -- recent request outcomes tracked per family.
    * ``trip_failures`` -- retriable failures (fault / retry-exhaustion /
      deadline) within the window that trip the breaker open.
    * ``cooldown_s`` -- how long an open breaker sheds before it goes
      half-open and lets probes through.
    * ``probes`` -- half-open probe requests; that many consecutive probe
      successes close the breaker, any probe failure re-trips it.
    """
    window: int = 16
    trip_failures: int = 4
    cooldown_s: float = 1.0
    probes: int = 2

    def __post_init__(self):
        if self.window < 1 or self.trip_failures < 1 or self.probes < 1 \
                or self.cooldown_s < 0:
            raise ValueError("window/trip_failures/probes >= 1 and "
                             "cooldown_s >= 0 required")


class CircuitBreaker:
    """One program family's breaker state machine:
    closed -> (sustained failures) -> open -> (cooldown) -> half-open ->
    (probe successes) -> closed, or (probe failure) -> open again.

    ``admit`` decides how the family's next unit of work runs ("run"
    normally, "probe" normally-but-watched, or "shed" to the fallback
    path); ``record`` feeds an outcome back and returns the transition
    event (``"trip"`` / ``"close"`` / None) for the caller's stats."""

    def __init__(self, policy: BreakerPolicy):
        self.policy = policy
        self.state = "closed"
        self._outcomes: "collections.deque" = collections.deque(
            maxlen=policy.window)
        self._opened_at = 0.0
        self._probe_budget = 0
        self._probe_successes = 0

    def admit(self, now: float) -> str:
        if self.state == "open":
            if now - self._opened_at < self.policy.cooldown_s:
                return "shed"
            self.state = "half-open"
            self._probe_budget = self.policy.probes
            self._probe_successes = 0
        if self.state == "half-open":
            if self._probe_budget > 0:
                self._probe_budget -= 1
                return "probe"
            return "shed"
        return "run"

    def _trip(self, now: float) -> str:
        self.state = "open"
        self._opened_at = now
        self._outcomes.clear()
        return "trip"

    def record(self, ok: bool, now: float, probe: bool = False
               ) -> Optional[str]:
        if self.state == "half-open" and probe:
            if not ok:
                return self._trip(now)
            self._probe_successes += 1
            if self._probe_successes >= self.policy.probes:
                self.state = "closed"
                self._outcomes.clear()
                return "close"
            return None
        if self.state != "closed":
            return None        # stale outcome from before the transition
        self._outcomes.append(bool(ok))
        if sum(1 for o in self._outcomes if not o) \
                >= self.policy.trip_failures:
            return self._trip(now)
        return None


# --------------------------------------------------------------------------
# execution engine: coalesce -> pipelined group run -> split
# --------------------------------------------------------------------------

@dataclasses.dataclass
class RequestResult:
    """One request's share of a batch execution.  ``exec_us`` is the whole
    batch's pipelined execution wall time -- groups overlap on the device,
    so per-group times are not separable; the shared figure is the honest
    one.  ``cached`` reports whether the request's program had compiled
    schedule artifacts *before* this batch ran.  ``degraded`` marks a
    request that fell out of group execution and ran (or failed)
    standalone; ``error`` is the structured error body (value is None)
    when even standalone execution failed; ``health`` carries the batch's
    drained fault-tolerance counters (shared across the batch's
    results)."""
    value: object
    group_rows: int
    group_size: int
    batch_rows: int
    exec_us: float
    cached: bool
    degraded: bool = False
    shed: bool = False          # family breaker open -> served on fallback
    error: Optional[dict] = None
    health: Optional[dict] = None


class Stats:
    """Cumulative serving counters (one line at server shutdown).

    Registry-backed (DESIGN.md §15): every field lives as a
    ``pim.serve.<field>`` counter on the runtime's per-instance
    :class:`~repro_torch.runtime.telemetry.MetricsRegistry`, so the serving
    reader thread (``rejected``/``expired``) and the execute loop mutate
    under one lock and the Prometheus exposition sees the same numbers
    the shutdown summary prints.  The historical dataclass attribute API
    is preserved -- ``stats.requests`` reads, ``stats.requests += 1``
    writes -- but cross-thread increments should use the atomic
    :meth:`add` (``+=`` expands to a get-then-set pair)."""

    _FIELDS = dict(
        requests=0, batches=0, groups=0, rows=0, errors=0, exec_s=0.0,
        fused_programs=0,        # requests served by a fused expr program
        # fault-tolerance / admission health (DESIGN.md §12)
        rejected=0,              # admission backpressure rejections
        expired=0,               # requests past deadline at dequeue
        degraded_groups=0,       # groups that fell back to per-request
        retries=0,               # chunk retries after detected corruption
        faults_detected=0,
        faults_corrected=0,
        remapped_rows=0,
        stragglers=0,            # batch exec-time spikes (StragglerMonitor)
        # circuit breakers (DESIGN.md §14)
        breaker_trips=0,         # family breakers tripped open
        breaker_probes=0,        # half-open probe admissions
        breaker_closes=0,        # breakers closed after probe successes
        shed_requests=0)         # requests served on the shed fallback

    PREFIX = "pim.serve."

    def __init__(self, registry: Optional[telemetry.MetricsRegistry] = None):
        object.__setattr__(self, "registry",
                           registry if registry is not None
                           else telemetry.MetricsRegistry())

    def __getattr__(self, name):        # only called on non-instance attrs
        if name not in Stats._FIELDS:
            raise AttributeError(name)
        default = Stats._FIELDS[name]
        v = self.registry.counter(Stats.PREFIX + name, default)
        return v if isinstance(default, float) else int(v)

    def __setattr__(self, name, value):
        if name in Stats._FIELDS:
            self.registry.set_counter(Stats.PREFIX + name, value)
        else:
            object.__setattr__(self, name, value)

    def add(self, name: str, n=1) -> None:
        """Atomic increment of one field (thread-safe, unlike ``+=``)."""
        self.registry.inc(Stats.PREFIX + name, n)

    def as_dict(self) -> Dict[str, float]:
        """All fields as a plain dict (the JSON summary line's core)."""
        return {name: getattr(self, name) for name in Stats._FIELDS}

    def rows_per_s(self) -> float:
        return self.rows / self.exec_s if self.exec_s > 0 else float("nan")

    def absorb_health(self, health: Dict[str, int]) -> None:
        """Fold one batch's drained ``kernels.ops`` HEALTH counters in
        (one lock acquisition)."""
        self.registry.add_many({
            Stats.PREFIX + k: health.get(k, 0)
            for k in ("retries", "faults_detected", "faults_corrected",
                      "remapped_rows")})

    def summary(self, pinned: int = 0) -> str:
        gsz = self.requests / self.groups if self.groups else 0.0
        return (f"pim-serve: {self.requests} requests in {self.batches} "
                f"batches / {self.groups} groups (mean {gsz:.1f} req/group), "
                f"{self.rows} rows @ {self.rows_per_s():,.0f} rows/s, "
                f"errors={self.errors}, fused={self.fused_programs}, "
                f"pinned={pinned}, "
                f"rejected={self.rejected}, expired={self.expired}, "
                f"degraded_groups={self.degraded_groups}, "
                f"faults={self.faults_detected}/{self.faults_corrected} "
                f"(detected/corrected), retries={self.retries}, "
                f"remapped_rows={self.remapped_rows}, "
                f"stragglers={self.stragglers}, "
                f"breaker={self.breaker_trips}/{self.breaker_probes}/"
                f"{self.breaker_closes} (trips/probes/closes), "
                f"shed={self.shed_requests}")


class BatchRuntime:
    """Planner + coalescer + splitter over ``kernels.ops`` group execution,
    with an LRU-pinned schedule working set and cumulative :class:`Stats`.

    One instance per server; :meth:`execute` is also directly usable on a
    list of :class:`Prepared` handles (the benchmark and the property tests
    drive it that way, bypassing the queue).

    ``breaker`` (a :class:`BreakerPolicy`, default on) arms per-program-
    family circuit breakers: a family -- keyed by ``Prepared.key``, the
    program content hash, so recovery traffic for a structure shares its
    breaker across plans -- whose requests keep failing retriably
    (faults exhausting retries, deadline misses) trips open and its
    subsequent requests are *shed*: served standalone without the fault
    model and the verify policy (``degraded+shed``), never dropped -- on
    the numpy oracle plan when the request's plan runs on the host, on its
    own card otherwise.  Other errors (``internal``: a CUDA launch error,
    an out-of-memory) never trip a breaker.  After a
    cooldown, half-open probes run on the primary path; enough successes
    close the breaker.  ``breaker=None`` disables the layer."""

    _SHED = object()

    def __init__(self, pin_cap: int = DEFAULT_PIN_CAP,
                 breaker: Optional[BreakerPolicy] = BreakerPolicy(),
                 metrics: Optional[telemetry.MetricsRegistry] = None):
        # per-instance registry: Stats counters plus the batch histograms
        # (pim.batch.exec_us / occupancy_rows / group_size) land here, so
        # concurrent runtimes (tests!) never share windows; the serving
        # layer adds its queue/request latency histograms to the same
        # registry and renders all of it in one Prometheus exposition
        self.metrics = metrics if metrics is not None \
            else telemetry.MetricsRegistry()
        self.pins = PinnedSchedules(pin_cap)
        self.stats = Stats(self.metrics)
        self.breaker = breaker
        self.breakers: Dict[bytes, CircuitBreaker] = {}

    def close(self) -> None:
        self.pins.clear()

    def _breaker_for(self, prep: Prepared) -> CircuitBreaker:
        br = self.breakers.get(prep.key)
        if br is None:
            br = self.breakers[prep.key] = CircuitBreaker(self.breaker)
        return br

    def _note_breaker_event(self, event: Optional[str]) -> None:
        if event == "trip":
            self.stats.add("breaker_trips")
            telemetry.TRACER.instant("breaker.trip", cat="pim.serve")
        elif event == "close":
            self.stats.add("breaker_closes")
            telemetry.TRACER.instant("breaker.close", cat="pim.serve")

    def record_expired(self, prep: Prepared) -> None:
        """Feed one dequeue-time deadline expiry into the request's family
        breaker: requests of a family that keep dying in the queue are as
        much a sustained-failure signal as ones that fail on the device."""
        if self.breaker is None:
            return
        self._note_breaker_event(
            self._breaker_for(prep).record(False, time.monotonic()))

    def execute(self, preps: Sequence[Prepared],
                deadlines: Optional[Sequence[Optional[float]]] = None,
                ) -> List[RequestResult]:
        """Execute one admission batch; per-request results in input order.

        Plans groups, pins their programs into the working set, runs all
        groups through the pipelined group executor, and splits each
        group's output rows back to its members (each request's
        ``finish`` decodes its own slice -- including div's ``(q, r)``
        pair and fp bit-pattern decode).

        ``deadlines`` (optional, aligned with ``preps``) are absolute
        ``time.monotonic()`` values: a group inherits the *tightest* member
        deadline and the executor checks it between chunks.

        Degradation ladder (DESIGN.md §12): if the pipelined whole-batch
        run raises, each group re-runs alone; a group that still fails
        falls back to per-request execution, so one poisoned request (or a
        row span whose faults exhaust retries) costs its own response --
        never the batch.  Per-request failures surface as structured
        ``error`` bodies on their own :class:`RequestResult`."""
        results: List[Optional[RequestResult]] = [None] * len(preps)
        if not preps:
            return []
        tracer = telemetry.TRACER
        t_coal = time.perf_counter()
        dls = list(deadlines) if deadlines is not None else [None] * len(preps)
        plan = plan_groups(preps)
        now = time.monotonic()
        modes = []
        for g in plan:
            mode = "run"
            if self.breaker is not None:
                mode = self._breaker_for(g.preps[0]).admit(now)
                if mode == "probe":
                    self.stats.add("breaker_probes")
            modes.append(mode)
        specs = []
        for g, mode in zip(plan, modes):
            if mode == "shed":
                specs.append(self._SHED)
                continue
            p0 = g.preps[0]
            g.cached = p0.cached
            self.pins.touch(p0.program, p0.plan)
            member_dls = [dls[i] for i in g.members if dls[i] is not None]
            try:
                inputs = coalesce(g)
            except Exception:
                # a malformed member poisons only its own group: degrade the
                # group to per-request, where the healthy members still run
                specs.append(None)
                continue
            specs.append(dict(program=p0.program, inputs=inputs,
                              n_rows=g.n_rows, plan=p0.plan,
                              deadline=min(member_dls) if member_dls
                              else None))
        t0 = time.perf_counter()
        tracer.event("coalesce", t_coal, t0, cat="pim.serve",
                     requests=len(preps), groups=len(plan))
        live = [s for s in specs if isinstance(s, dict)]
        try:
            live_outs = iter(kops.run_program_groups(live) if live else ())
            outs = [s if s is None or s is self._SHED else next(live_outs)
                    for s in specs]
        except Exception:
            # retry each group alone: a healthy group must not pay for a
            # poisoned neighbour sharing its batch
            outs = []
            for spec in specs:
                if spec is None or spec is self._SHED:
                    outs.append(spec)
                    continue
                try:
                    outs.append(kops.run_program_groups([spec])[0])
                except Exception:
                    outs.append(None)       # degrade to per-request below
        exec_s = time.perf_counter() - t0
        batch_rows = sum(g.n_rows for g in plan)
        exec_us = exec_s * 1e6
        tracer.event("exec", t0, t0 + exec_s, cat="pim.serve",
                     rows=batch_rows, groups=len(live))
        # per-batch latency/occupancy histograms (DESIGN.md §15): exec
        # wall time, row occupancy, and per-group member counts -- what
        # the serving layer's periodic stats lines summarize as p50/p99
        self.metrics.observe_many({"pim.batch.exec_us": exec_us,
                                   "pim.batch.occupancy_rows": batch_rows})
        for g in plan:
            self.metrics.observe("pim.batch.group_size", len(g.preps))
        t_split = time.perf_counter()
        for g, out in zip(plan, outs):
            if out is self._SHED:
                self.stats.add("shed_requests", len(g.preps))
                for i, p in zip(g.members, g.preps):
                    results[i] = self._run_shed(p, dls[i], g, batch_rows,
                                                exec_us)
                continue
            if out is None:
                self.stats.add("degraded_groups")
                for i, p in zip(g.members, g.preps):
                    results[i] = self._run_degraded(p, dls[i], g, batch_rows,
                                                    exec_us)
                continue
            off = 0
            for i, p in zip(g.members, g.preps):
                sub = {k: v[off:off + p.n_rows] for k, v in out.items()}
                off += p.n_rows
                results[i] = RequestResult(
                    value=p.finish(sub), group_rows=g.n_rows,
                    group_size=len(g.preps), batch_rows=batch_rows,
                    exec_us=exec_us, cached=g.cached)
        tracer.event("unpack", t_split, time.perf_counter(),
                     cat="pim.serve", requests=len(preps))
        if self.breaker is not None:
            # feed primary-path outcomes back; shed results never count --
            # they carry no evidence about the primary path's health; only
            # TRIP_CODES count as failures
            tr = time.monotonic()
            for g, mode in zip(plan, modes):
                if mode == "shed":
                    continue
                br = self._breaker_for(g.preps[0])
                for i in g.members:
                    r = results[i]
                    failed = r is None or (
                        r.error is not None
                        and r.error.get("code") in TRIP_CODES)
                    self._note_breaker_event(
                        br.record(not failed, tr, probe=(mode == "probe")))
        health = kops.drain_health()
        if health:
            self.stats.absorb_health(health)
            for r in results:
                if r is not None:
                    r.health = dict(health)
        self.metrics.add_many({       # one lock: the whole batch's deltas
            Stats.PREFIX + "requests": len(preps),
            Stats.PREFIX + "fused_programs": sum(
                1 for p in preps if getattr(p, "fused_ops", 1) > 1),
            Stats.PREFIX + "batches": 1,
            Stats.PREFIX + "groups": len(plan),
            Stats.PREFIX + "rows": batch_rows,
            Stats.PREFIX + "exec_s": exec_s})
        return results  # type: ignore[return-value]

    def _run_degraded(self, p: Prepared, dl: Optional[float], g: Group,
                      batch_rows: int, exec_us: float) -> RequestResult:
        """Standalone execution of one member of a failed group."""
        try:
            if dl is not None and time.monotonic() > dl:
                raise DeadlineExceeded(
                    f"request expired before degraded execution "
                    f"({p.n_rows} rows)")
            if p.plan.backend.name == "numpy":
                value = p.run()
            else:
                value = p.finish(kops.run_program_streaming(
                    p.program, p.inputs, p.n_rows, p.plan, deadline=dl))
            return RequestResult(
                value=value, group_rows=g.n_rows, group_size=len(g.preps),
                batch_rows=batch_rows, exec_us=exec_us, cached=g.cached,
                degraded=True)
        except Exception as e:
            return RequestResult(
                value=None, group_rows=g.n_rows, group_size=len(g.preps),
                batch_rows=batch_rows, exec_us=exec_us, cached=g.cached,
                degraded=True, error=classify_error(e)["error"])

    def _run_shed(self, p: Prepared, dl: Optional[float], g: Group,
                  batch_rows: int, exec_us: float) -> RequestResult:
        """Serve one member of a tripped family standalone, without the
        fault model and the verify policy, marked ``degraded+shed`` --
        shedding degrades a family's service, it never loses its requests.
        A plan on the host sheds to the numpy oracle plan, as in the
        reference; a plan on the card runs on its own card, so an answer
        never moves from the device to a plain version on the host."""
        try:
            if dl is not None and time.monotonic() > dl:
                raise DeadlineExceeded(
                    f"request expired before shed execution ({p.n_rows} "
                    f"rows)")
            if p.plan.backend.name == "cuda":
                value = p.finish(kops.run_program_streaming(
                    p.program, p.inputs, p.n_rows, dataclasses.replace(
                        p.plan, faults=None, verify=None), deadline=dl))
            else:
                oplan = dataclasses.replace(
                    p.plan, backend=kops.BACKENDS["numpy"], mesh=None,
                    layout=kops.ROWS32, chunk_rows=None, faults=None,
                    verify=None)
                value = p.finish(
                    kops.run_program(p.program, p.inputs, p.n_rows, oplan))
            return RequestResult(
                value=value, group_rows=g.n_rows, group_size=len(g.preps),
                batch_rows=batch_rows, exec_us=exec_us, cached=g.cached,
                degraded=True, shed=True)
        except Exception as e:
            return RequestResult(
                value=None, group_rows=g.n_rows, group_size=len(g.preps),
                batch_rows=batch_rows, exec_us=exec_us, cached=g.cached,
                degraded=True, shed=True, error=classify_error(e)["error"])
