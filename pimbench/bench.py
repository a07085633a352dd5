"""One run of one cell: set-up, the measured window, the check, the line.

The window is a closed loop with one caller: call the cell's public ufunc
on the next operand set of the pool, wait for its numpy result, and call
again, until ``seconds`` have passed; the call running then finishes, so
the window holds whole calls only.  ``rows_per_s`` is the rows of those
calls over the time from the first call's start to the last call's end.

A traced run (``trace=True``) makes the same calls as
``pim.prepare(op, x, y)`` and then ``.run()``, the ufunc's own body, so
that the two phases are spans of their own, under ``torch.profiler``.

After the window a sample of the calls, drawn from the seed (every call
where their results fit in :data:`KEEP_BYTES`), is held row for row against
the plain reference (:mod:`pimbench.reference`).
"""

from __future__ import annotations

import contextlib
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from pimbench import cells, reference, timeline, traffic

#: Top-level module names that may not be loaded in a run's process: JAX,
#: its libraries and the JAX package the port was made from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
#: Host bytes of results the check keeps from the window.
KEEP_BYTES = 8 << 30
#: Where a run keeps the program's artifact cache and the profiler's trace,
#: inside the checkout (fixed, so that a second run finds the cache).
WORK_DIR = Path("build") / "pimbench"


def forbidden_modules(names=None) -> List[str]:
    """The forbidden top-level names among ``names`` (default: the modules
    this process has loaded), compared whole: ``repro_torch`` is not
    ``repro``."""
    names = sys.modules if names is None else names
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def _result_bytes(config: dict, rows: int) -> int:
    """Host bytes one call's result takes: a float keeps its dtype, an
    integer comes back as uint64."""
    dtype = np.dtype(config["dtype"])
    return (dtype.itemsize if dtype.kind == "f" else 8) * rows


class Keeper:
    """A sample of the window's calls, reservoir-drawn from the seed: every
    call while fewer than ``k`` are kept, then each later call replaces a
    kept one with the probability that keeps the sample uniform."""

    def __init__(self, k: int, seed: int):
        self.k = max(1, int(k))
        self.rng = np.random.default_rng([int(seed) % (1 << 64), 1])
        self.kept: Dict[int, tuple] = {}
        self.seen = 0

    def offer(self, call: int, set_index: int, result) -> None:
        self.seen += 1
        if len(self.kept) < self.k:
            self.kept[call] = (set_index, result)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            del self.kept[sorted(self.kept)[j]]
            self.kept[call] = (set_index, result)


def setup(spec: dict, seed: int, device: str = "cuda",
          plan_kw: Optional[dict] = None) -> dict:
    """Operands from the seed, the program configured and warmed on the
    cell's own program.  ``plan_kw`` (tests on the CPU only) replaces the
    card's plan."""
    t0 = time.perf_counter()
    from repro_torch import pim_ufunc as pim
    t_import = time.perf_counter()
    cfg, tr = spec["config"], spec["traffic"]
    root = Path(spec["root"])
    kw = {"parallel": bool(cfg["parallel"])}
    kw.update(plan_kw if plan_kw is not None else
              {"shards": int(cfg["shards"]),
               "cache_dir": str(root / WORK_DIR / "cache")})
    if device == "cuda":                    # the context, made apart
        torch.empty(1, device=device)
        torch.cuda.synchronize()
    t_context = time.perf_counter()
    sets = traffic.operand_sets(cfg, tr, seed, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    t_operands = time.perf_counter()
    op = tr["op"]
    # the cell's program on two chunks: kernels built or loaded, the
    # schedule from the artifact cache, the streaming loop and both staging
    # buffers of a lane used (a whole call here did not make the window's
    # first call any faster)
    head = 2 * pim.config.chunk_rows
    x, y = sets[0]
    getattr(pim, op)(x[:head], y[:head], **kw)
    parts = {"import repro_torch": t_import - t0,
             "CUDA context": t_context - t_import,
             "operands": t_operands - t_context,
             "warm-up": time.perf_counter() - t_operands}
    return {"spec": spec, "pim": pim, "op": op, "kw": kw, "sets": sets,
            "rows": int(tr["rows_per_call"]), "seed": int(seed),
            "device": device, "setup_parts": parts}


def window(state: dict, seconds: float, trace: bool = False) -> dict:
    """The measured window: whole calls for ``seconds``."""
    pim, op, kw, sets = (state[k] for k in ("pim", "op", "kw", "sets"))
    spec = state["spec"]
    keep = Keeper(KEEP_BYTES // _result_bytes(spec["config"], state["rows"]),
                  state["seed"])
    if trace:
        from torch.profiler import (ProfilerActivity, profile,
                                    record_function)
        prof = profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA])
        mark = record_function
    else:
        prof, mark = contextlib.nullcontext(), None
    ufunc = getattr(pim, op)
    call_s, spans = [], {"frontend": 0.0, "run": 0.0}
    failed, errors = 0, []
    with prof:
        with (mark(timeline.WINDOW) if trace else contextlib.nullcontext()):
            t_start = time.perf_counter()
            deadline = t_start + seconds
            i = 0
            while True:
                s = i % len(sets)
                x, y = sets[s]
                t0 = time.perf_counter()
                try:
                    if trace:
                        with mark("pimbench.frontend"):
                            p = pim.prepare(op, x, y, **kw)
                        t1 = time.perf_counter()
                        with mark("pimbench.run"):
                            out = p.run()
                        spans["frontend"] += t1 - t0
                        spans["run"] += time.perf_counter() - t1
                    else:
                        out = ufunc(x, y, **kw)
                except Exception:           # a failed call is counted
                    failed += 1
                    errors.append(traceback.format_exc())
                    out = None
                t_end = time.perf_counter()
                call_s.append(t_end - t0)
                if out is not None:
                    keep.offer(i, s, out)
                i += 1
                if t_end >= deadline:
                    break
            if state["device"] == "cuda":
                torch.cuda.synchronize()
    return {"calls": i, "failed": failed, "errors": errors,
            "t_start": t_start, "t_end": t_end, "call_s": call_s,
            "spans": spans, "keep": keep, "prof": prof if trace else None}


def check(state: dict, win: dict) -> tuple:
    """Each kept call's whole result against the plain reference on the
    same operands.  Returns the numbers compared, each with its limit, and
    the calls and rows held."""
    sets, op = state["sets"], state["op"]
    want: Dict[int, np.ndarray] = {}
    bad = rows = 0
    for call in sorted(win["keep"].kept):
        s, got = win["keep"].kept[call]
        if s not in want:
            want[s] = reference.expected(op, *sets[s])
        bad += reference.mismatched_rows(got, want[s])
        rows += want[s].size
    checks = {"mismatched_rows": {"value": bad, "limit": 0},
              "failed_calls": {"value": win["failed"], "limit": 0}}
    return checks, len(win["keep"].kept), rows


def passed(checks: dict) -> bool:
    return all(v["value"] <= v["limit"] for v in checks.values())


def trace_context(win: dict, work: Path) -> Optional[dict]:
    """The traced window's timeline (None where the profiler saw no device
    activity: the device metrics are then not measured)."""
    path = work / "trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    win["prof"].export_chrome_trace(str(path))
    try:
        return timeline.timeline(timeline.read_trace(path))
    finally:
        path.unlink()


def metric_context(state: dict, win: dict, tl: Optional[dict],
                   device_kind: str) -> dict:
    """What the per-layer readers read."""
    return {"window_s": win["t_end"] - win["t_start"],
            "spans": win["spans"], "calls": win["calls"] - win["failed"],
            "rows": state["rows"], "frozen": state["spec"]["frozen"],
            "timeline": tl, "device_kind": device_kind}


def rows_per_s(state: dict, win: dict) -> float:
    done = win["calls"] - win["failed"]
    return done * state["rows"] / (win["t_end"] - win["t_start"])


def check_lines(checks: dict) -> List[str]:
    return [f"check {k}: {v['value']} (limit {v['limit']})"
            for k, v in checks.items()]


def line(correct: bool, win: dict, metrics: dict, device: dict,
         checks: dict, breakdown: Optional[dict] = None) -> dict:
    out = {"correct": bool(correct), "attempted": win["calls"],
           "failed": win["failed"], "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return out


def per_layer(spec: dict, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for m in spec["per_layer"]:
        v = cells.metric_reader(m["name"], spec["root"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
