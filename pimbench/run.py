"""One run of one benchmark cell of ``repro_torch`` on the card.

    python3 pimbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout.  Prints the cell's end-to-end metrics
(``--trace 0``) or its per-layer metrics (``--trace 1``, under
``torch.profiler``) as one JSON line, last on standard output, and each
number the check compared beside its limit as the last lines on standard
error.  Without as many CUDA devices as the cell asks for it prints no
result and exits 2; it never runs on the CPU.
"""

import time

T0 = time.perf_counter()


def _process_age() -> float:
    """Seconds from this process's start to now, read from /proc (0 where
    it cannot be read): the interpreter's own start, before ``T0``."""
    import os
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


#: set-up is counted from the process's start: AGE seconds before T0
AGE = _process_age()

import argparse  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="the cell's name")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True,
                    help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def power_limit() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


def main(argv=None) -> int:
    args = parse(argv)
    from pimbench import cells
    spec = cells.load_cell(args.workload, ROOT)
    t = time.perf_counter()
    import torch
    t_torch = time.perf_counter()
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    t_query = time.perf_counter()
    before = {"interpreter": AGE, "harness": t - T0,
              "import torch": t_torch - t, "CUDA query": t_query - t_torch}
    if have < spec["chips"]:
        print(f"pimbench: cell {args.workload} needs {spec['chips']} CUDA "
              f"device(s), this machine has {have}; no result",
              file=sys.stderr)
        return 2
    if cells.kind(spec) == "lm":
        from pimbench import lm
        return lm.main(args, spec, before, AGE - T0, power_limit)
    from pimbench import bench, timeline
    work = ROOT / bench.WORK_DIR
    before["harness"] += time.perf_counter() - t_query
    state = bench.setup(spec, args.seed)
    win = bench.window(state, args.seconds, trace=bool(args.trace))
    setup_s = AGE + win["t_start"] - T0
    kind = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": kind, "count": spec["chips"],
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    found = bench.forbidden_modules()
    if found:
        print(f"pimbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    breakdown = None
    if args.trace:
        tl = bench.trace_context(win, work)
        win["prof"] = None
        if tl is None:
            print("pimbench: the profiler saw no device activity in the "
                  "window (not measured); no result", file=sys.stderr)
            return 4
        device["busy_s"] = timeline.busy_s(tl)
        device["window_s"] = timeline.window_s(tl)
        metrics = bench.per_layer(
            spec, bench.metric_context(state, win, tl, kind))
        breakdown = {"device_ops": timeline.top_device_ops(tl),
                     "idle_gaps": timeline.idle_gaps(tl)}
    else:
        values = {"rows_per_s": bench.rows_per_s(state, win),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    checks, kept, rows = bench.check(state, win)
    correct = bench.passed(checks)
    err = sys.stderr
    parts = dict(before, **state["setup_parts"])
    print(f"cell {args.workload} seed {args.seed}: {kind}, power limit "
          f"{power_limit()}; set-up {setup_s:.6f} s ("
          + ", ".join(f"{k} {v:.6f} s" for k, v in parts.items())
          + "); "
          f"{win['calls']} calls of {state['rows']} rows in "
          f"{win['t_end'] - win['t_start']:.6f} s; call seconds "
          f"{[round(s, 6) for s in win['call_s']]}", file=err)
    if args.trace:
        print(f"spans frontend {win['spans']['frontend']:.6f} s, run "
              f"{win['spans']['run']:.6f} s", file=err)
    for e in win["errors"][:1]:
        print(f"first failed call:\n{e}", file=err)
    print(f"held {kept} calls, {rows} rows, against the reference",
          file=err)
    for text in bench.check_lines(checks):
        print(text, file=err)
    err.flush()
    print(json.dumps(bench.line(correct, win, metrics, device, checks,
                                breakdown)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
