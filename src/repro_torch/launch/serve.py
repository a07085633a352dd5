"""Serving entry point of the PIM ufunc API, on a CUDA device.

The PIM half of ``repro.launch.serve``: elementwise arithmetic requests
served by the AritPIM machine through ``repro_torch.pim_ufunc`` -- the
chunked streaming executor on the hand-written kernels, with multi-device
row sharding (DESIGN.md §8).  One-shot synthetic load:

    PYTHONPATH=src python -m repro_torch.launch.serve --pim add \
        --pim-dtype uint32 --pim-rows 500000 --pim-requests 4

or a JSON-lines request loop on stdin/stdout (one request object per
line, one response per line):

    echo '{"op":"add","dtype":"uint16","x":[3,5],"y":[4,6]}' | \
        PYTHONPATH=src python -m repro_torch.launch.serve --pim-stdin

``--pim-serve`` is the batched variant of the same protocol: requests
admitted within a micro-batching window (``--pim-window-ms``, row cap
``--pim-max-batch-rows``) are grouped by compiled-program structure and
each group executes as one packed state (``runtime/pim_batch.py``,
DESIGN.md §10).  Responses keep input order; a stats line goes to stderr
at end of stream.

Every mode runs on the CUDA device unless ``--pim-device cpu`` asks for
the plain PyTorch version on the CPU; with no GPU the default raises
before the first line is read.  ``--pim-cache-dir`` warm-starts a replica
from the persistent artifact cache that a fleet of replicas shares
(``runtime/artifact_cache.py``).

With no ``--pim*`` mode it serves the reference's LM decode loop: a model
of ``--arch`` with random weights from ``--seed``, a random prompt of
``--prompt-len`` tokens for each of ``--batch`` rows teacher-forced
through decode steps, then ``--gen`` greedy tokens (:func:`serve_llm`):

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b

on the CUDA device, or ``--reduced --device cpu`` on the CPU, for every
``--arch`` but the encoder-only ``hubert-xlarge``, which has no decode (a
vision model gets random image embeddings from the same seed).
"""

from __future__ import annotations

import argparse
import json
import sys
import threading
import time

import numpy as np
import torch

from .. import pim_ufunc as pim
from ..configs import registry
from ..core.floatfmt import FORMATS
from ..kernels import ops as kops
from ..kernels import pim_exec
from ..kernels import ref as kref
from ..kernels import slots as kslots
from ..kernels.plan import LAYOUTS, SCHEDULES
from ..models import model as M
from ..runtime import pim_batch, telemetry
from ..runtime.fault_tolerance import Heartbeat, StragglerMonitor
from ..runtime.faults import FaultModel, Scrubber, drain_media_health
from .steps import make_decode_step

_PIM_INT_OPS = ("add", "sub", "mul", "div")
_PIM_FP_OPS = ("fp_add", "fp_sub", "fp_mul", "fp_div")
_PIM_DTYPES = {"uint8": np.uint8, "uint16": np.uint16,
               "uint32": np.uint32, "uint64": np.uint64,
               "float16": np.float16, "float32": np.float32}


def _pim_encode(arr) -> list:
    """JSON-safe row list (Python ints/floats; object arrays of big ints)."""
    if arr.dtype.kind == "f":
        return [float(v) for v in arr]
    return [int(v) for v in arr]


# Parse/validation failures a request line can produce (anything else is a
# server bug and should propagate).
_PIM_REQ_ERRORS = (KeyError, TypeError, ValueError, OverflowError)


def _err(code: str, message: str, retriable: bool) -> dict:
    """Structured wire-format error body (DESIGN.md §12): every failed
    request gets a machine-readable ``code``, the human message, and
    whether retrying the same request could succeed.  Codes: ``bad_json``
    and ``bad_request`` (non-retriable -- the request itself is broken),
    ``overloaded`` (admission backpressure), ``deadline_exceeded``,
    ``exec_failed`` (faults exhausted retries), ``internal``."""
    return {"error": {"code": code, "message": message,
                      "retriable": retriable}}


def _serving_devices() -> tuple:
    """The devices the configured plan runs on (one a shard); raises when
    it names a CUDA device and there is none -- a server never drops to
    the CPU on its own.  The numpy oracle runs on the host: one."""
    plan, _ = pim._resolve({})
    if plan.backend.name == "numpy":
        return ("cpu",)
    return tuple(kops._checked_device(d) for d in plan.devices)


def _pim_prepare_request(req: dict):
    """Parse + validate one JSON request into a ``pim_ufunc.Prepared``
    program handle (raises on malformed requests).

    Request: ``{"op": add|sub|mul|div|fp_add|fp_sub|fp_mul|fp_div,
    "x": [...], "y": [...]}`` plus either ``"dtype"`` (uint8..64 /
    float16/float32) or ``"fmt"`` (bf16 etc., bit-pattern payloads),
    optional ``"width"`` for explicit fixed-point widths, ``"schedule"``
    (slots / slots-static / dense) and ``"layout"`` (rows32 / rows64 --
    the packed word layout; all exec-config keys land in the request's
    ExecPlan, so mixed-config traffic never coalesces wrongly).

    Compound requests (DESIGN.md §13): ``{"op": "expr", "expr":
    ["add", ["mul", "a", "b"], "c"], "inputs": {"a": [...], ...}}`` --
    the nested-list expression (leaves are input names, interior nodes
    ``[op, lhs, rhs]`` over the fusable ops) lowers through
    ``pim_ufunc.fuse`` into **one** compiled program; one ``dtype`` /
    ``fmt`` / ``width`` applies to every leaf.
    """
    op = req["op"]
    if op != "expr" and op not in _PIM_INT_OPS + _PIM_FP_OPS:
        raise ValueError(f"unknown op {op!r}")
    kw = {}
    if req.get("fmt") is not None:
        kw["fmt"] = req["fmt"]
        dtype = None
    else:
        dtype = _PIM_DTYPES[req.get("dtype", "uint32")]
    if req.get("width") is not None:
        kw["width"] = int(req["width"])
    for key in ("schedule", "layout"):
        if req.get(key) is not None:
            kw[key] = req[key]
    if op == "expr":
        return _pim_prepare_expr(req, dtype, kw)
    x = np.asarray(req["x"], dtype)
    y = np.asarray(req["y"], dtype)
    return pim.prepare(op, x, y, **kw)


def _pim_prepare_expr(req: dict, dtype, kw: dict):
    """Lower an ``"expr"`` request into one fused ``Prepared`` handle."""
    inputs = req["inputs"]
    if not isinstance(inputs, dict) or not inputs:
        raise ValueError('"expr" requests need a non-empty "inputs" map')
    width = kw.pop("width", None)
    fmt = kw.pop("fmt", None)
    leaves: dict = {}

    def build(node):
        if isinstance(node, str):
            leaf = leaves.get(node)
            if leaf is None:
                if node not in inputs:
                    raise KeyError(f'expr leaf {node!r} not in "inputs"')
                leaf = leaves[node] = pim.lazy(
                    np.asarray(inputs[node], dtype), width=width, fmt=fmt)
            return leaf
        if (not isinstance(node, (list, tuple)) or len(node) != 3
                or not isinstance(node[0], str)):
            raise ValueError(
                f"expr nodes are [op, lhs, rhs] or input names, got "
                f"{node!r}")
        nop = node[0]
        if nop not in pim.LAZY_OPS:
            raise ValueError(f"op {nop!r} does not fuse "
                             f"(fusable: {', '.join(pim.LAZY_OPS)})")
        return getattr(pim, nop)(build(node[1]), build(node[2]))

    return pim.fuse(build(req["expr"]), **kw)


def _pim_attach_result(resp: dict, op: str, out) -> dict:
    if op == "div":
        resp["q"], resp["r"] = _pim_encode(out[0]), _pim_encode(out[1])
    else:
        resp["result"] = _pim_encode(out)
    return resp


def pim_request(req: dict) -> dict:
    """Serve one ufunc request (see :func:`_pim_prepare_request` for the
    request schema).

    Response: ``{"op", "rows", "us", "cached"}`` with ``"result"`` (or
    ``"q"``/``"r"`` for division).  ``us`` is the execution latency only:
    when the program structure was not yet compiled (``cached: false``),
    first-call compilation -- levelize, schedule packing, the generated
    kernel's build, measured by a discarded warm-up row -- is reported
    separately as ``compile_us``, so serving latency numbers stay honest.
    Failures come back as structured ``{"error": {"code", "message",
    "retriable"}}`` bodies (see :func:`_err`).
    """
    try:
        prep = _pim_prepare_request(req)
    except _PIM_REQ_ERRORS as e:
        return _err("bad_request", f"{type(e).__name__}: {e}", False)
    try:
        cached = prep.cached
        resp = {"op": prep.op, "rows": int(prep.n_rows),
                "cached": bool(cached)}
        if getattr(prep, "fused_ops", 1) > 1:
            resp["fused_ops"] = int(prep.fused_ops)
        if not cached and prep.n_rows:
            t0 = time.perf_counter()
            prep.warm()
            resp["compile_us"] = round((time.perf_counter() - t0) * 1e6, 1)
        t0 = time.perf_counter()
        out = prep.run()
        resp["us"] = round((time.perf_counter() - t0) * 1e6, 1)
        return _pim_attach_result(resp, prep.op, out)
    except Exception as e:                  # noqa: BLE001 -- keep serving
        return pim_batch.classify_error(e)


def serve_pim_stdin(inp=None, outp=None) -> int:
    """JSON-lines loop: one request per input line, one response per output
    line.  Blank lines are skipped; malformed JSON yields a structured
    ``bad_json`` error line.  Raises before reading when the configured
    plan names a CUDA device and there is none."""
    _serving_devices()
    inp = sys.stdin if inp is None else inp
    outp = sys.stdout if outp is None else outp
    served = 0
    for line in inp:
        line = line.strip()
        if not line:
            continue
        try:
            req = json.loads(line)
        except json.JSONDecodeError as e:
            resp = _err("bad_json", f"JSONDecodeError: {e}", False)
        else:
            resp = pim_request(req)
        print(json.dumps(resp, sort_keys=True), file=outp, flush=True)
        served += 1
    return served


def _kernel_section() -> dict:
    """The summary's port-only section: the kernel launches and the plain
    versions' calls of this process (nonzero entries), and its ``nvcc``
    runs and the seconds spent on them."""
    return {"launches": {k: v for k, v in pim_exec.LAUNCHES.items() if v},
            "plain": {k: v for counts in (kslots.CALLS, kref.CALLS)
                      for k, v in counts.items() if v},
            "nvcc_runs": pim_exec.COMPILES["runs"],
            "nvcc_s": round(pim_exec.COMPILES["seconds"], 3)}


def serve_pim_batched(inp=None, outp=None, *, window_ms: float = 2.0,
                      max_batch_rows: int = 1 << 16, pin_cap: int = 32,
                      max_queue_rows=None, deadline_ms=None,
                      heartbeat=None, stats: bool = True,
                      breaker="default",
                      scrub_interval_ms: float = 250.0,
                      stats_interval_ms: float = 0.0,
                      metrics_file=None, trace_file=None,
                      cache_dir=None) -> dict:
    """Batched JSON-lines loop (``--pim-serve``): same request/response
    protocol as :func:`serve_pim_stdin`, but requests admitted within one
    micro-batching window coalesce by compiled-program structure and each
    group executes as one packed state (``runtime/pim_batch.py``).

    A reader thread parses and validates lines into program handles while
    the main loop executes the previous batch, so admission overlaps
    execution.  Only the main loop dispatches to the device (the pinned
    staging buffers and copy streams of ``kernels/transfer.py`` are used
    from that thread alone); the reader reads the process-wide
    ``pim.config``, so scoped ``pim.options`` around this call reach it.
    Responses keep input order (batches are consecutive spans of the
    input).  Per-request accounting: ``us`` (admission to response, the
    end-to-end latency), ``queue_us`` (time spent waiting for the window),
    ``exec_us`` (the batch's shared pipelined execution time), ``batched``
    (requests coalesced into this request's group), and ``cached``.  At
    end of stream a stats summary line goes to stderr.

    Hardening (DESIGN.md §12): ``max_queue_rows`` bounds the admission
    backlog -- a request past the cap gets a retriable ``overloaded``
    error instead of growing the queue (the reader never blocks, the
    executor never deadlocks).  ``deadline_ms`` (per-request override:
    ``"deadline_ms"`` in the request) expires requests still queued or
    mid-execution past their budget.  Every failure is a structured
    ``{"error": {"code", "message", "retriable"}}``; a request that fell
    out of group execution carries ``"degraded": true``; a batch that saw
    fault-tolerance activity attaches its drained ``"health"`` counters.
    ``heartbeat`` names a liveness file beaten once per batch.

    Circuit breakers (DESIGN.md §14): per-program-family breakers in the
    runtime trip on sustained retriable failures (faults exhausting
    retries, deadline misses -- including expiry in the queue); tripped
    families are shed -- run without the fault model, on their own card,
    or on the numpy oracle when the plan runs on the host
    (``degraded+shed``, counted in ``shed_requests``, never dropped) --
    until half-open probes succeed; an ``internal`` error (a CUDA error)
    never trips a breaker.  ``breaker`` is a
    ``runtime.pim_batch.BreakerPolicy``, None to disable, or
    ``"default"``.  Trip/probe/close counts land in the stats line and the
    returned dict.  When the active ufunc config injects faults
    (``pim.options(faults=...)`` around this call, e.g. the
    ``--pim-fault-*`` flags), a background
    :class:`~repro_torch.runtime.faults.Scrubber` re-scans quarantined
    spans every ``scrub_interval_ms`` for the lifetime of the loop; its
    media counters come back under ``"media"``.

    Telemetry (DESIGN.md §15): ``stats_interval_ms > 0`` emits a periodic
    ``{"type": "stats", ...}`` JSON line to stderr (at most once per
    interval, evaluated per batch) with p50/p99 queue-wait and batch-exec
    latency, batch row occupancy, and the compiled-program cache hit
    rate.  ``metrics_file`` keeps a Prometheus-style text exposition of
    the runtime's metrics (plus the process-global health/cache/model
    counters) refreshed at the same cadence and at shutdown.
    ``trace_file`` enables the pipeline tracer for the lifetime of the
    loop and writes the span buffer as Chrome-trace JSON at shutdown.
    With ``stats=True`` the shutdown stats also emit as one
    machine-parseable ``{"type": "summary", ...}`` JSON stderr line next
    to the historical human one.

    Warm starts: ``cache_dir`` installs the persistent compiled-artifact
    cache (``runtime.artifact_cache``) for the lifetime of the process,
    preloads every provenance-bearing schedule, packed stream and kernel
    library from disk onto the configured device before the first
    request (a ``{"type": "warm_start", ...}`` stderr line reports what
    loaded and how long it took; ``executables`` counts the libraries),
    and installs any ``tuned.json`` the autotuner persisted beside it.  A
    replica restarted against a populated cache directory then serves its
    hot programs with no levelize, no packing and no ``nvcc`` -- the
    summary's ``cache.levelized`` and ``cache.packed`` stay 0, and so
    does ``kernels.nvcc_runs``.  A configured plan on a CUDA device when
    there is none raises ``RuntimeError`` before the first line is read.
    """
    _serving_devices()
    if cache_dir:
        t_warm = time.perf_counter()
        pim.configure(cache_dir=str(cache_dir))
        pim._ensure_artifact_cache()        # install + tuned.json now
        counts = kops.artifact_cache().warm()
        print(json.dumps(
            {"type": "warm_start", "dir": str(cache_dir), **counts,
             "us": round((time.perf_counter() - t_warm) * 1e6, 1)},
            sort_keys=True), file=sys.stderr, flush=True)
    inp = sys.stdin if inp is None else inp
    outp = sys.stdout if outp is None else outp
    q = pim_batch.BatchQueue(window_ms=window_ms,
                             max_batch_rows=max_batch_rows,
                             max_queue_rows=max_queue_rows)
    # Bound before the reader thread starts -- its closure reads `tracer`.
    tracer = telemetry.TRACER
    trace_prev = None
    if trace_file:
        trace_prev, tracer.enabled = tracer.enabled, True

    def _admit():
        try:
            for line in inp:
                line = line.strip()
                if not line:
                    continue
                t_admit = time.perf_counter()
                try:
                    req = json.loads(line)
                except json.JSONDecodeError as e:
                    q.put((_err("bad_json", f"JSONDecodeError: {e}", False),
                           None, t_admit, None))
                    continue
                try:
                    prep = _pim_prepare_request(req)
                    dl_ms = req.get("deadline_ms", deadline_ms) \
                        if isinstance(req, dict) else deadline_ms
                    dl = None if dl_ms is None \
                        else time.monotonic() + float(dl_ms) * 1e-3
                except _PIM_REQ_ERRORS as e:
                    q.put((_err("bad_request", f"{type(e).__name__}: {e}",
                                False), None, t_admit, None))
                except Exception as e:      # noqa: BLE001 -- keep serving
                    q.put((_err("internal", f"{type(e).__name__}: {e}",
                                True), None, t_admit, None))
                else:
                    tracer.event("prepare", t_admit, time.perf_counter(),
                                 cat="pim.serve", rows=int(prep.n_rows))
                    if not q.offer((None, prep, t_admit, dl),
                                   n_rows=prep.n_rows):
                        # backpressure: ordered, structured, retriable --
                        # the rejection itself rides the queue rowless
                        q.put((_err(
                            "overloaded",
                            f"admission queue full ({prep.n_rows} rows "
                            f"would exceed max_queue_rows="
                            f"{q.max_queue_rows})", True),
                            None, t_admit, None))
        except Exception:   # noqa: BLE001 -- input stream died mid-read:
            pass            # treat as EOF; admitted requests still serve
        finally:
            q.close()

    threading.Thread(target=_admit, daemon=True).start()
    if breaker == "default":
        runtime = pim_batch.BatchRuntime(pin_cap=pin_cap)
    else:
        runtime = pim_batch.BatchRuntime(pin_cap=pin_cap, breaker=breaker)

    def _rps() -> float:
        v = runtime.stats.rows_per_s()
        return round(v, 1) if v == v else 0.0   # NaN-free strict JSON

    def _cache_section() -> dict:
        reg = telemetry.REGISTRY
        hits = int(reg.counter("pim.cache.hits"))
        misses = int(reg.counter("pim.cache.misses"))
        total = hits + misses
        return {"hits": hits, "misses": misses,
                "evictions": int(reg.counter("pim.cache.evictions")),
                "hit_rate": round(hits / total, 4) if total else 0.0,
                # disk tier (DESIGN.md §16): artifact loads/stores plus
                # the fresh levelize and packing counts a warm start
                # drives to zero
                "levelized": int(reg.counter("pim.cache.levelized")),
                "packed": int(reg.counter("pim.cache.packed")),
                "disk_hits": int(reg.counter("pim.cache.disk_hits")),
                "disk_misses": int(reg.counter("pim.cache.disk_misses")),
                "disk_writes": int(reg.counter("pim.cache.disk_writes")),
                "disk_errors": int(reg.counter("pim.cache.disk_errors")),
                "disk_evictions":
                    int(reg.counter("pim.cache.disk_evictions"))}

    def _hist_section() -> dict:
        out = {}
        for short, name in (("queue_us", "pim.serve.queue_us"),
                            ("request_us", "pim.serve.request_us"),
                            ("exec_us", "pim.batch.exec_us"),
                            ("occupancy_rows", "pim.batch.occupancy_rows"),
                            ("group_size", "pim.batch.group_size")):
            s = runtime.metrics.summary(name)
            if s is not None:
                out[short] = s
        return out

    def _write_metrics_file() -> None:
        if not metrics_file:
            return
        with open(metrics_file, "w") as f:
            f.write(telemetry.render_prometheus(telemetry.REGISTRY,
                                                runtime.metrics))

    mon = StragglerMonitor(window=64, threshold=4.0)
    hb = Heartbeat(heartbeat, interval_s=0.0) if heartbeat else None
    if hb:
        hb.beat(0)                          # liveness from startup
    scrubber = None
    if isinstance(pim.config.faults, FaultModel) and scrub_interval_ms > 0:
        scrubber = Scrubber(pim.config.faults,
                            interval_s=scrub_interval_ms * 1e-3).start()
    served = 0
    last_emit = 0.0             # first qualifying batch always emits
    try:
        while (batch := q.collect()) is not None:
            t_plan = time.perf_counter()
            now = time.monotonic()
            responses: dict = {}
            live = []
            for i, (err, prep, t_admit, dl) in enumerate(batch):
                if err is not None:
                    responses[i] = err
                    if err["error"]["code"] == "overloaded":
                        runtime.stats.add("rejected")
                elif dl is not None and now > dl:
                    responses[i] = _err(
                        "deadline_exceeded",
                        f"request expired in queue ({prep.n_rows} rows)",
                        True)
                    runtime.stats.add("expired")
                    runtime.record_expired(prep)
                else:
                    tracer.event("enqueue", t_admit, t_plan,
                                 cat="pim.serve", rows=int(prep.n_rows))
                    live.append((i, prep, t_admit, dl))
            try:
                results = runtime.execute(
                    [p for _, p, _, _ in live],
                    deadlines=[dl for _, _, _, dl in live])
            except Exception as e:          # noqa: BLE001 -- server bug:
                body = pim_batch.classify_error(e)  # answer, keep serving
                results = None
                for i, prep, t_admit, dl in live:
                    responses[i] = body
            t_done = time.perf_counter()
            if results is not None:
                for (i, prep, t_admit, dl), r in zip(live, results):
                    # per-request latency histograms: queue wait (admit ->
                    # batch start) and end-to-end (admit -> response) --
                    # the p50/p99 the periodic stats lines summarize
                    runtime.metrics.observe_many({
                        "pim.serve.queue_us": (t_plan - t_admit) * 1e6,
                        "pim.serve.request_us": (t_done - t_admit) * 1e6})
                    if r.error is not None:
                        responses[i] = {"error": r.error}
                        continue
                    resp = {"op": prep.op, "rows": int(prep.n_rows),
                            "us": round((t_done - t_admit) * 1e6, 1),
                            "queue_us": round((t_plan - t_admit) * 1e6, 1),
                            "exec_us": round(r.exec_us, 1),
                            "batched": r.group_size, "cached": bool(r.cached)}
                    if getattr(prep, "fused_ops", 1) > 1:
                        resp["fused_ops"] = int(prep.fused_ops)
                    if r.degraded:
                        resp["degraded"] = True
                    if r.shed:
                        resp["shed"] = True
                    if r.health:
                        resp["health"] = r.health
                    responses[i] = _pim_attach_result(resp, prep.op, r.value)
            if mon.record(runtime.stats.batches, t_done - t_plan):
                runtime.stats.add("stragglers")
            if hb:
                hb.beat(runtime.stats.batches)
            runtime.stats.add("errors", sum(
                1 for r in responses.values() if "error" in r))
            for i in range(len(batch)):
                print(json.dumps(responses[i], sort_keys=True), file=outp,
                      flush=True)
            served += len(batch)
            if stats_interval_ms > 0 and \
                    (t_done - last_emit) * 1e3 >= stats_interval_ms:
                last_emit = t_done
                st = runtime.stats
                print(json.dumps(
                    {"type": "stats", "served": served,
                     "requests": st.requests, "batches": st.batches,
                     "groups": st.groups, "rows": st.rows,
                     "errors": st.errors, "shed": st.shed_requests,
                     "rows_per_s": _rps(),
                     "latency": _hist_section(),
                     "cache": _cache_section()},
                    sort_keys=True), file=sys.stderr, flush=True)
                _write_metrics_file()
    finally:
        pinned = len(runtime.pins)
        runtime.close()
        if scrubber is not None:
            scrubber.stop()
        if trace_file:
            tracer.write_chrome_trace(trace_file)
            tracer.enabled = trace_prev
    st = runtime.stats
    media = drain_media_health()
    if stats:
        line = st.summary(pinned=pinned)
        if media:
            line += (f", media={media.get('scrub_passes', 0)} scrubs/"
                     f"{media.get('spans_reclaimed', 0)} reclaimed/"
                     f"{media.get('spans_still_bad', 0)} still-bad")
        print(line, file=sys.stderr)
        # the machine-parseable twin of the human line: every Stats field
        # plus the histogram summaries and the media/cache sections
        print(json.dumps(
            {"type": "summary", "served": served, "pinned": pinned,
             **st.as_dict(), "rows_per_s": _rps(),
             "latency": _hist_section(), "cache": _cache_section(),
             "kernels": _kernel_section(), "media": media},
            sort_keys=True), file=sys.stderr, flush=True)
    _write_metrics_file()
    return {"served": served, "batches": st.batches, "groups": st.groups,
            "rows": st.rows, "errors": st.errors, "pinned": pinned,
            "fused_programs": st.fused_programs,
            "rows_per_s": st.rows_per_s(), "rejected": st.rejected,
            "expired": st.expired, "degraded_groups": st.degraded_groups,
            "faults_detected": st.faults_detected,
            "faults_corrected": st.faults_corrected,
            "retries": st.retries, "remapped_rows": st.remapped_rows,
            "stragglers": st.stragglers,
            "breaker_trips": st.breaker_trips,
            "breaker_probes": st.breaker_probes,
            "breaker_closes": st.breaker_closes,
            "shed_requests": st.shed_requests,
            "media": media}


def serve_pim_synthetic(args) -> dict:
    """One-shot synthetic load: ``--pim-requests`` rounds of ``--pim-rows``
    random rows through the streaming/sharded executor; prints rows/s and
    the number of devices the configured plan runs on."""
    n_dev = len(_serving_devices())
    op = args.pim
    rng = np.random.default_rng(args.seed)
    n = args.pim_rows
    dtype = _PIM_DTYPES[args.pim_dtype]
    is_float = np.dtype(dtype).kind == "f"
    if (op in _PIM_FP_OPS) != is_float:
        sys.exit(f"error: --pim {op} requires --pim-dtype "
                 f"{'float16/float32' if op in _PIM_FP_OPS else 'uint8..64'}"
                 f" (got {args.pim_dtype})")
    if op in _PIM_FP_OPS:
        fmt = {np.float16: FORMATS["fp16"],
               np.float32: FORMATS["fp32"]}[dtype]
        mid = fmt.bias
        x = fmt.random_bits(rng, n, emin=mid - 2, emax=mid + 2)
        y = fmt.random_bits(rng, n, emin=mid - 2, emax=mid + 2)
        vw = {np.float16: np.uint16, np.float32: np.uint32}[dtype]
        x = x.astype(vw).view(dtype)
        y = y.astype(vw).view(dtype)
    else:
        width = np.dtype(dtype).itemsize * 8
        hi = 1 << min(width, 63)
        x = rng.integers(0, hi, n).astype(dtype)
        lo = 1 if op == "div" else 0
        y = rng.integers(lo, hi, n).astype(dtype)
    fn = getattr(pim, op)
    fn(x[:256], y[:256])                     # compile outside the timing
    t0 = time.perf_counter()
    for _ in range(args.pim_requests):
        fn(x, y)
    dt = time.perf_counter() - t0
    total = n * args.pim_requests
    rate = total / dt if dt > 0 else float("nan")
    print(f"pim.{op} [{args.pim_dtype}]: {args.pim_requests} requests x "
          f"{n} rows on {n_dev} device(s) in {dt:.3f}s = {rate:,.0f} rows/s")
    if getattr(args, "json", None):
        # one row in the benchmarks/run.py --json format
        doc = {"meta": {"suite": "aritpim-repro",
                        "tier1": "repro_torch.launch.serve"},
               "rows": [{"name": f"serve/{op}_{args.pim_dtype}_synthetic",
                         "us_per_call": round(dt * 1e6 / args.pim_requests,
                                              3),
                         "rows_per_s": round(rate),
                         "rows": n, "requests": args.pim_requests,
                         "n_devices": n_dev}]}
        with open(args.json, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
    return {"op": op, "rows": total, "seconds": dt, "rows_per_s": rate,
            "n_devices": n_dev}


# ---------------------------------------------------------------- LLM decode

@torch.no_grad()
def generate(cfg, model, tokens, gen: int, *, vision=None, step_ms=None):
    """The reference's decode loop: teacher-force the prompt ``tokens``
    [B, P] through decode steps, then ``gen`` greedy steps; ``vision``
    [B, Sv, Df] (a vision model's image embeddings) goes into every
    step.  The caches are in the weights' dtype.  Returns the
    [B, P + gen] int32 tokens on the model's device.
    Nothing waits for the device inside the loop.  With a list
    ``step_ms``, each step's milliseconds are appended to it (CUDA events
    on a CUDA device).  Records no autograd graph, trainable weights or
    not."""
    b, p = tokens.shape
    max_seq = p + gen
    tokens = tokens.to(torch.int32)
    caches = M.init_caches(cfg, b, max_seq, device=tokens.device,
                           dtype=model["embed"].dtype)
    step = make_decode_step(cfg)
    on_cuda = tokens.device.type == "cuda"
    marks = []

    def mark():
        if step_ms is None:
            return
        if on_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.append(ev)
        else:
            marks.append(time.perf_counter())

    cur = tokens[:, 0]
    out = [cur]
    mark()
    for t in range(max_seq - 1):
        batch = {"token": cur, "pos": t}
        if vision is not None:
            batch["vision"] = vision
        nxt, _, caches = step(model, caches, batch)
        cur = tokens[:, t + 1] if t + 1 < p else nxt
        out.append(cur)
        mark()
    out = torch.stack(out, 1)
    if step_ms is not None:
        if on_cuda:
            marks[-1].synchronize()
            step_ms += [a.elapsed_time(z) for a, z in zip(marks, marks[1:])]
        else:
            step_ms += [(z - a) * 1e3 for a, z in zip(marks, marks[1:])]
    return out


@torch.no_grad()
def serve_llm(args):
    """LM decode serving (the reference's ``serve_llm``): random weights
    and prompt from ``--seed`` on ``--device`` (and a vision model's
    image embeddings [B, vision_seq, frontend_dim], standard normal), the
    prompt teacher-forced, then ``--gen`` greedy tokens.  Prints the
    reference's ``generated``
    line and the decode steps' times; returns the [B, prompt + gen]
    tokens as numpy."""
    cfg = registry.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if cfg.encoder_only:
        raise AssertionError("encoder-only archs have no decode")
    if args.batch < 1 or args.prompt_len < 1 or args.gen < 0:
        raise ValueError(f"--batch {args.batch}, --prompt-len "
                         f"{args.prompt_len}, --gen {args.gen}: need a row, "
                         "a prompt token and no negative count")
    device = kops._checked_device(args.device)
    b, max_seq = args.batch, args.prompt_len + args.gen
    weights = torch.Generator(device=device).manual_seed(args.seed)
    model = M.init_model(cfg, weights, device=device)
    prompt = torch.Generator(device=device).manual_seed(args.seed)
    toks = torch.randint(0, cfg.vocab, (b, args.prompt_len),
                         generator=prompt, device=device, dtype=torch.int32)
    vision = None
    if cfg.frontend == "vision":
        vision = torch.randn(
            (b, cfg.vision_seq, cfg.frontend_dim), device=device,
            generator=torch.Generator(device=device).manual_seed(args.seed))
    step_ms = []
    t0 = time.perf_counter()
    gen = generate(cfg, model, toks, args.gen, vision=vision,
                   step_ms=step_ms).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"generated {b}x{max_seq} tokens in {dt:.2f}s "
          f"({b * max_seq / dt:.1f} tok/s)")
    if step_ms:
        print(f"decode steps on {device}: {len(step_ms)}, first "
              f"{step_ms[0]:.3f} ms, median of the rest "
              f"{float(np.median(step_ms[1:] or step_ms)):.3f} ms, wall "
              f"{dt * 1e3:.3f} ms")
    print("sample row:", gen[0].tolist())
    return gen


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b",
                    choices=sorted(registry.ARCHS))
    ap.add_argument("--reduced", action="store_true",
                    help="the tiny same-family config (ModelConfig.reduced)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where LM decode serving runs (no --pim* mode): "
                         "cuda (raises without one) or cpu")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--pim", metavar="OP", choices=_PIM_INT_OPS + _PIM_FP_OPS,
                    help="serve the PIM ufunc API with synthetic load")
    ap.add_argument("--pim-stdin", action="store_true",
                    help="serve PIM ufunc requests as JSON lines on stdin "
                         "(one program execution per request)")
    ap.add_argument("--pim-serve", action="store_true",
                    help="batched JSON-lines serving: coalesce requests "
                         "that share a program structure inside a "
                         "micro-batching window (runtime/pim_batch)")
    ap.add_argument("--pim-device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the hand-written kernels on the CUDA device "
                         "(raises without one); cpu: their plain PyTorch "
                         "versions on the CPU (backend 'ref')")
    ap.add_argument("--pim-window-ms", type=float, default=2.0,
                    help="batching window after the first admitted "
                         "request (--pim-serve; 0 = only what is queued)")
    ap.add_argument("--pim-max-batch-rows", type=int, default=1 << 16,
                    help="row cap per admission batch (--pim-serve)")
    ap.add_argument("--pim-pin-cap", type=int, default=32,
                    help="LRU-pinned working set of compiled schedules "
                         "(--pim-serve; 0 disables pinning)")
    ap.add_argument("--pim-max-queue-rows", type=int, default=0,
                    help="admission backlog cap in rows (--pim-serve); "
                         "past it requests get a retriable 'overloaded' "
                         "error (0 = unbounded)")
    ap.add_argument("--pim-deadline-ms", type=float, default=None,
                    help="default per-request deadline (--pim-serve); a "
                         "request's own 'deadline_ms' key overrides")
    ap.add_argument("--pim-heartbeat", metavar="PATH", default=None,
                    help="liveness file beaten once per batch "
                         "(--pim-serve; runtime/fault_tolerance.Heartbeat)")
    ap.add_argument("--pim-no-breaker", action="store_true",
                    help="disable the per-program-family circuit breakers "
                         "(--pim-serve; DESIGN.md §14)")
    ap.add_argument("--pim-breaker-failures", type=int, default=None,
                    help="retriable failures in the window that trip a "
                         "family's breaker (--pim-serve; default 4)")
    ap.add_argument("--pim-breaker-cooldown-ms", type=float, default=None,
                    help="open-state cooldown before half-open probes "
                         "(--pim-serve; default 1000)")
    ap.add_argument("--pim-breaker-probes", type=int, default=None,
                    help="half-open probe successes required to close a "
                         "breaker (--pim-serve; default 2)")
    ap.add_argument("--pim-scrub-interval-ms", type=float, default=250.0,
                    help="background quarantined-span scrub period when "
                         "fault injection is on (--pim-serve; 0 disables)")
    ap.add_argument("--pim-stats-interval-ms", type=float, default=0.0,
                    help="emit a periodic {\"type\": \"stats\"} JSON line "
                         "to stderr with p50/p99 queue+exec latency, batch "
                         "occupancy and cache hit rate (--pim-serve; "
                         "0 disables)")
    ap.add_argument("--pim-metrics-file", metavar="PATH", default=None,
                    help="keep a Prometheus-style text exposition of the "
                         "serving metrics refreshed at the stats cadence "
                         "and at shutdown (--pim-serve)")
    ap.add_argument("--pim-cache-dir", metavar="DIR", default=None,
                    help="persistent compiled-artifact cache directory "
                         "(--pim-serve): warm-start from it (schedules, "
                         "packed streams, kernel libraries, tuned.json) "
                         "and write fresh artifacts through to it")
    ap.add_argument("--pim-trace-file", metavar="PATH", default=None,
                    help="enable pipeline trace spans and write them as "
                         "Chrome-trace/Perfetto JSON at shutdown "
                         "(--pim-serve)")
    ap.add_argument("--pim-verify", action="store_true",
                    help="verified execution: per-chunk result checking "
                         "with retry + row remap (DESIGN.md §12)")
    ap.add_argument("--pim-fault-flip", type=float, default=0.0,
                    help="injected per-level transient bit-flip rate "
                         "(fault-injection harness; DESIGN.md §12)")
    ap.add_argument("--pim-fault-dead", type=float, default=0.0,
                    help="injected dead-row rate")
    ap.add_argument("--pim-fault-stuck", type=float, default=0.0,
                    help="injected stuck-at word-column rate")
    ap.add_argument("--pim-fault-seed", type=int, default=0,
                    help="fault-map seed (deterministic injection)")
    ap.add_argument("--pim-rows", type=int, default=1 << 20)
    ap.add_argument("--pim-requests", type=int, default=4)
    ap.add_argument("--pim-dtype", default="uint32",
                    choices=sorted(_PIM_DTYPES))
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="with --pim: write the synthetic-load result as a "
                         "benchmarks/run.py-compatible row")
    ap.add_argument("--pim-schedule", default=None, choices=SCHEDULES,
                    help="executor schedule mode (default: the ufunc "
                         "config default, i.e. the slot-scan kernel)")
    ap.add_argument("--pim-layout", default=None, choices=sorted(LAYOUTS),
                    help="packed word layout: rows32 (uint32 words) or "
                         "rows64 (the paired 64-row layout; halves the "
                         "executor word axis) -- lands in every request's "
                         "ExecPlan")
    args = ap.parse_args(argv)

    overrides = {"device": args.pim_device,
                 "backend": "ref" if args.pim_device == "cpu" else "cuda"}
    if args.pim_schedule:
        overrides["schedule"] = args.pim_schedule
    if args.pim_layout:
        overrides["layout"] = args.pim_layout
    if args.pim_verify:
        overrides["verify"] = True
    if args.pim_fault_flip or args.pim_fault_dead or args.pim_fault_stuck:
        overrides["faults"] = FaultModel(seed=args.pim_fault_seed,
                                         p_flip=args.pim_fault_flip,
                                         p_dead_row=args.pim_fault_dead,
                                         p_stuck=args.pim_fault_stuck)
    breaker = "default"
    if args.pim_no_breaker:
        breaker = None
    elif (args.pim_breaker_failures is not None
          or args.pim_breaker_cooldown_ms is not None
          or args.pim_breaker_probes is not None):
        dflt = pim_batch.BreakerPolicy()
        breaker = pim_batch.BreakerPolicy(
            trip_failures=args.pim_breaker_failures
            if args.pim_breaker_failures is not None else dflt.trip_failures,
            cooldown_s=args.pim_breaker_cooldown_ms * 1e-3
            if args.pim_breaker_cooldown_ms is not None else dflt.cooldown_s,
            probes=args.pim_breaker_probes
            if args.pim_breaker_probes is not None else dflt.probes)
    # scoped override (not configure): the CLI choice must not leak into
    # library defaults when serve is driven programmatically
    with pim.options(**overrides):
        if args.pim_serve:
            return serve_pim_batched(
                window_ms=args.pim_window_ms,
                max_batch_rows=args.pim_max_batch_rows,
                pin_cap=args.pim_pin_cap,
                max_queue_rows=args.pim_max_queue_rows or None,
                deadline_ms=args.pim_deadline_ms,
                heartbeat=args.pim_heartbeat,
                breaker=breaker,
                scrub_interval_ms=args.pim_scrub_interval_ms,
                stats_interval_ms=args.pim_stats_interval_ms,
                metrics_file=args.pim_metrics_file,
                trace_file=args.pim_trace_file,
                cache_dir=args.pim_cache_dir)
        if args.pim_stdin:
            return serve_pim_stdin()
        if args.pim:
            return serve_pim_synthetic(args)
        return serve_llm(args)


if __name__ == "__main__":
    main()
