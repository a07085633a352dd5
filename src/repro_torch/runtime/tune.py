"""Backend autotuner on the port: measured, per-target tuned execution
defaults (DESIGN.md §16).

The counterpart of ``repro.runtime.tune``.  It sweeps the ``Backend``
tunables and the schedule choice per ``(program family, layout,
backend)`` on the current device target, measures wall time through the
real execution path (``pim.prepare`` with an explicit plan, warmed,
min-of-reps) beside the analytical ``telemetry.PimCostModel`` cycles and,
on a CUDA device, the kernels' own time from CUDA events, and persists
winners as ``tuned.json`` beside the artifact cache.

Safety property the tests pin: **a tuned configuration can never lose to
the hand defaults** -- the default configuration is always swept first and
a candidate only wins by strictly beating it on measured wall time, so
installing tuned.json is monotone.  A candidate that does not fit the
program (a CTA width whose state does not fit shared memory) is recorded
with its error and never wins.

``backend="ref"`` sweeps exactly the reference's candidates;
``backend="cuda"`` (the default, as for every entry point of the port)
adds the kernels' own tunables: the CTA width (``words_per_cta``) and the
streaming chunk (``chunk_rows``).

Winners are applied through ``kernels.plan.register_tuned`` +
``apply_tuned``: the ufunc frontend overlays them at plan-resolution time
onto knobs the caller left at hand defaults, so explicit choices
(``schedule=``, a custom ``Backend``, ``plan=``) always win, and
``options(tuned=False)`` disables the overlay wholesale.

CLI::

    python -m repro_torch.runtime.tune --quick --out /var/cache/pim
    python -m repro_torch.runtime.tune --backend cuda --rows 1048576 \\
        --families add:16,fp_add:fp16 --reps 5 --out /var/cache/pim
    python -m repro_torch.runtime.tune --backend ref --device cpu --quick
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from ..core.floatfmt import FORMATS
from ..kernels.plan import DEFAULT_BACKEND, DEFAULT_DEVICE
from .artifact_cache import TUNED_BASENAME, device_target

#: Families swept by default: the tracked benchmark families (uint16 +
#: fp16 serial suite -- the mixed 8-op serving traffic).
DEFAULT_FAMILIES = ("add:16", "mul:16", "fp_add:fp16", "fp_mul:fp16")

#: tuned.json format version.
DOC_VERSION = 1

#: SM cycles the card sleeps before a kernel timing (0.1 s at 1980 MHz),
#: so that the host queues the timed launches while it waits and the
#: events time them back to back.
SLEEP_CYCLES = 200_000_000


# --------------------------------------------------------------------------
# sweep space
# --------------------------------------------------------------------------

def candidates(quick: bool = False, backend: str = DEFAULT_BACKEND
               ) -> List[dict]:
    """Candidate override sets, hand-default first (the baseline every
    winner must beat).  ``quick`` is the tiny sweep; the full sweep
    crosses schedule kind x slot width (+ static segmentation).  Under
    ``ref`` the list is the reference's; under ``cuda`` the kernels' CTA
    width and the streaming chunk follow, two points each in the full
    sweep (and one each in the quick one)."""
    cands: List[dict] = [{}]
    if quick:
        cands += [{"slot_width": 4}, {"schedule": "dense"}]
        if backend == "cuda":
            cands += [{"words_per_cta": 64}, {"chunk_rows": 1 << 18}]
        return cands
    for schedule in ("slots", "slots-static", "dense"):
        for slot_width in (4, 6, 8):
            ov: dict = {}
            if schedule != "slots":
                ov["schedule"] = schedule
            if slot_width != 6:
                ov["slot_width"] = slot_width
            if schedule == "dense" and slot_width != 4:
                continue        # dense ignores the slot allocator: one
                #                 representative sweep point is enough
            if ov and ov not in cands:
                cands.append(ov)
    for seg_levels in (64, 256):
        cands.append({"schedule": "slots-static", "seg_levels": seg_levels})
    if backend == "cuda":
        cands += [{"words_per_cta": 32}, {"words_per_cta": 64},
                  {"schedule": "slots-static", "words_per_cta": 32},
                  {"schedule": "dense", "words_per_cta": 64},
                  {"chunk_rows": 1 << 18}, {"chunk_rows": 1 << 19}]
    return cands


def parse_family(family: str):
    """Split a family spec "op:param" into (op, prepare kwargs): int
    families carry a bit width ("mul:16"), fp families a format name
    ("fp_add:fp16")."""
    op, _, param = family.partition(":")
    if not param:
        raise ValueError(f"family spec {family!r} is not 'op:param'")
    if op.startswith("fp_"):
        if param not in FORMATS:
            raise ValueError(f"unknown fp format {param!r} in {family!r}")
        return op, {"fmt": param}
    return op, {"width": int(param)}


def _operands(family: str, rows: int, seed: int = 0):
    """Deterministic valid operands for one family: full-range unsigned
    ints, or normal-range fp bit patterns (never zero/NaN/Inf/subnormal,
    so every op including div accepts them)."""
    op, kw = parse_family(family)
    rng = np.random.default_rng(seed)
    if "width" in kw:
        w = kw["width"]
        hi = 1 << min(w, 63)
        x = rng.integers(0, hi, rows, dtype=np.uint64)
        y = rng.integers(1, hi, rows, dtype=np.uint64)     # div-safe
        return op, x, y, kw
    fmt = FORMATS[kw["fmt"]]
    ne, nm = fmt.ne, fmt.nm

    def patterns():
        e = rng.integers(1, (1 << ne) - 1, rows, dtype=np.uint64)
        m = rng.integers(0, 1 << nm, rows, dtype=np.uint64)
        s = rng.integers(0, 2, rows, dtype=np.uint64)
        return (s << np.uint64(ne + nm)) | (e << np.uint64(nm)) | m
    return op, patterns(), patterns(), kw


# --------------------------------------------------------------------------
# measurement
# --------------------------------------------------------------------------

def _plan_for(overrides: dict, layout: str, backend: str, device: str):
    from ..kernels.plan import BACKENDS, DEFAULT_SCHEDULE, ExecPlan, \
        LAYOUTS, TUNABLE_FIELDS
    bk_over = {k: int(v) for k, v in overrides.items()
               if k in TUNABLE_FIELDS}
    bk = dataclasses.replace(BACKENDS[backend], **bk_over) if bk_over \
        else BACKENDS[backend]
    return ExecPlan(backend=bk,
                    schedule=overrides.get("schedule", DEFAULT_SCHEDULE),
                    layout=LAYOUTS[layout], device=device)


def _kernel_ms(prep, reps: int) -> Optional[float]:
    """Device time (ms, CUDA events, min of ``reps``) of the executor
    launches one ``prep.run()`` makes -- one a chunk of the plan's
    ``chunk_rows`` -- on operands already on the card, queued behind a
    device sleep so the host's work between launches is not timed.
    None on the CPU and for programs with a port wider than 32 cells
    (the io branch, whose host packing is part of each launch)."""
    from ..kernels import ops as kops
    plan = prep.plan
    if torch.device(plan.device).type != "cuda":
        return None
    prog = prep.program
    in_names = tuple(sorted(prep.inputs))
    comp = kops.compiled(prog, plan)
    r = comp.resolve(prog, plan, in_names)
    if not r.fused_ok:
        return None
    chunk = min(plan.chunk_rows or plan.backend.chunk_rows, prep.n_rows)
    x = np.zeros((len(in_names), chunk), np.int32)
    for p, n in enumerate(in_names):
        x[p] = np.asarray(prep.inputs[n])[:chunk]       # cast in place
    x = torch.from_numpy(x).to(plan.device)
    n_chunks = -(-prep.n_rows // chunk)

    def launches():
        for _ in range(n_chunks):
            kops._run_fused(comp, prog, plan, r, in_names, x)
    launches()
    torch.cuda.synchronize()
    best = float("inf")
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    for _ in range(max(1, reps)):
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        launches()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def measure(family: str, overrides: dict, *, layout: str = "rows32",
            backend: str = DEFAULT_BACKEND, device: str = DEFAULT_DEVICE,
            rows: int = 4096, reps: int = 3) -> dict:
    """Wall time + modeled cycles (+ the kernels' ms on a CUDA device)
    for one (family, candidate) point, through the real ufunc execution
    path: prepare with an explicit plan (which bypasses the tuned overlay
    by construction), one untimed warm-up run covering levelize, packing
    and any ``nvcc`` build, then min-of-``reps`` timed runs.  A candidate
    the program cannot take (``ValueError``, e.g. a CTA width whose state
    does not fit) comes back with ``us`` None and its ``error``."""
    from .. import pim_ufunc as pim
    from ..kernels import ops as kops

    op, x, y, kw = _operands(family, rows)
    try:
        plan = _plan_for(overrides, layout, backend, device)
        prep = pim.prepare(op, x, y, plan=plan, **kw)
        prep.run()                              # untimed: compile + build
    except ValueError as e:
        return {"overrides": dict(overrides), "us": None,
                "error": f"{type(e).__name__}: {e}"}
    on_cuda = torch.device(plan.device).type == "cuda"
    walls = []
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        prep.run()
        if on_cuda:
            torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e6)
    best = min(walls)
    r = kops.compiled(prep.program, plan).resolve(
        prep.program, plan, tuple(sorted(prep.inputs)))
    return {"overrides": dict(overrides), "us": best,
            "spread_us": max(walls) - best,
            "rows_per_s": rows / best * 1e6,
            "model_cycles": int(r.model.cycles) if r.model else 0,
            "kernel_ms": _kernel_ms(prep, reps)}


def tune_family(family: str, *, layout: str = "rows32",
                backend: str = DEFAULT_BACKEND, device: str = DEFAULT_DEVICE,
                rows: int = 4096, reps: int = 3, quick: bool = False,
                log=None) -> dict:
    """Sweep one family; returns the entry dict for tuned.json.  The
    hand-default candidate is measured first and a non-default candidate
    wins only by strictly beating it, so the tuned choice is >= defaults
    on the metric that gates the tracked benchmark rows."""
    results = []
    for ov in candidates(quick, backend):
        res = measure(family, ov, layout=layout, backend=backend,
                      device=device, rows=rows, reps=reps)
        results.append(res)
        if log:
            if res["us"] is None:
                log(f"  {family} {ov or '(default)'}: {res['error']}")
            else:
                k = res["kernel_ms"]
                log(f"  {family} {ov or '(default)'}: {res['us']:.0f}us "
                    f"(spread {res['spread_us']:.0f}us)  kernel "
                    f"{'not measured' if k is None else f'{k:.4f} ms'}  "
                    f"{res['model_cycles']} cycles")
    default = results[0]
    if default["us"] is None:
        raise ValueError(f"{family}: the hand defaults do not run: "
                         f"{default['error']}")
    best = min((r for r in results if r["us"] is not None),
               key=lambda r: r["us"])
    if best["us"] >= default["us"]:
        best = default                           # never regress defaults
    return {"family": family, "layout": layout, "backend": backend,
            "overrides": best["overrides"], "us": best["us"],
            "default_us": default["us"],
            "default_spread_us": default["spread_us"],
            "model_cycles": best["model_cycles"],
            "kernel_ms": best["kernel_ms"],
            "default_kernel_ms": default["kernel_ms"],
            "candidates": results}


def tune(families: Sequence[str] = DEFAULT_FAMILIES, *,
         layout: str = "rows32", backend: str = DEFAULT_BACKEND,
         device: str = DEFAULT_DEVICE, rows: int = 4096, reps: int = 3,
         quick: bool = False, log=None) -> dict:
    """Sweep several families into one tuned.json document."""
    entries = [tune_family(f, layout=layout, backend=backend, device=device,
                           rows=rows, reps=reps, quick=quick, log=log)
               for f in families]
    return {"version": DOC_VERSION, "target": device_target(),
            "entries": entries}


# --------------------------------------------------------------------------
# persistence + install
# --------------------------------------------------------------------------

def _resolve_out(out: str) -> str:
    """An ``--out`` that names a directory (e.g. the cache dir) means its
    ``tuned.json``."""
    if os.path.isdir(out) or not out.endswith(".json"):
        return os.path.join(out, TUNED_BASENAME)
    return out


def save(doc: dict, out: str) -> str:
    """Merge-save ``doc`` into ``out`` (atomic replace).  An existing file
    for the same target keeps entries for slots this sweep did not touch;
    a different target's file is replaced wholesale (its entries are
    meaningless here)."""
    path = _resolve_out(out)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    merged = dict(doc)
    try:
        with open(path) as f:
            old = json.load(f)
        if old.get("version") == DOC_VERSION and \
                old.get("target") == doc.get("target"):
            new_keys = {(e["family"], e["layout"], e["backend"])
                        for e in doc["entries"]}
            keep = [e for e in old.get("entries", [])
                    if (e["family"], e["layout"], e["backend"])
                    not in new_keys]
            merged["entries"] = keep + list(doc["entries"])
    except (OSError, ValueError, KeyError, TypeError):
        pass
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(merged, f, indent=1, sort_keys=True)
    os.replace(tmp, path)
    return path


def install(path_or_doc) -> int:
    """Register a tuned.json's winners into the live plan-resolution
    overlay (``kernels.plan.register_tuned``); returns how many entries
    were installed.  Entries for a *different* device target -- or with
    empty overrides (defaults won) -- are skipped; a wrong-version doc
    installs nothing."""
    from ..kernels import plan as kplan
    doc = path_or_doc
    if not isinstance(doc, dict):
        with open(path_or_doc) as f:
            doc = json.load(f)
    if doc.get("version") != DOC_VERSION or \
            doc.get("target") != device_target():
        return 0
    n = 0
    for e in doc.get("entries", []):
        ov = e.get("overrides") or {}
        if not ov:
            continue
        kplan.register_tuned(e["family"], e["layout"], e["backend"], ov)
        n += 1
    return n


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Sweep PIM Backend tunables per program family and "
                    "persist per-target winners (tuned.json)")
    ap.add_argument("--families", default=",".join(DEFAULT_FAMILIES),
                    help="comma-separated op:param specs "
                         "(default: %(default)s)")
    ap.add_argument("--layout", default="rows32",
                    choices=("rows32", "rows64"))
    ap.add_argument("--backend", default=DEFAULT_BACKEND,
                    choices=("ref", "cuda"))
    ap.add_argument("--device", default=DEFAULT_DEVICE,
                    choices=("cuda", "cpu"),
                    help="cuda (raises without one) or cpu (backend ref)")
    ap.add_argument("--rows", type=int, default=4096)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--quick", action="store_true",
                    help="tiny sweep (default + 2 candidates, + 2 of the "
                         "kernels' own under cuda)")
    ap.add_argument("--out", default=None,
                    help="tuned.json path, or a cache directory "
                         "(writes its tuned.json)")
    args = ap.parse_args(argv)

    families = [f.strip() for f in args.families.split(",") if f.strip()]
    t0 = time.perf_counter()
    doc = tune(families, layout=args.layout, backend=args.backend,
               device=args.device, rows=args.rows, reps=args.reps,
               quick=args.quick, log=lambda m: print(m, file=sys.stderr))
    for e in doc["entries"]:
        win = e["overrides"] or "(defaults kept)"
        print(f"{e['family']} [{e['layout']}/{e['backend']}]: {win}  "
              f"{e['us']:.0f}us vs default {e['default_us']:.0f}us "
              f"(spread {e['default_spread_us']:.0f}us)")
    print(f"swept {sum(len(e['candidates']) for e in doc['entries'])} "
          f"points in {time.perf_counter() - t0:.1f} s on "
          f"{doc['target']}")
    if args.out:
        path = save(doc, args.out)
        print(f"wrote {path}")
    else:
        json.dump(doc, sys.stdout, indent=1, sort_keys=True)
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
