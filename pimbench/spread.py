"""Sets of runs of one cell and the spread of each metric, for setting a
bound and for seeing what a run prints.

    python3 pimbench/spread.py --workload <cell> --seconds 51 \
        --seeds 101 102 103 104 105 106 --sets 2 --out build/spread.jsonl

runs ``run.py`` once for each seed of each set, one process at a time,
with the same seeds in every set and the sets interleaved (seed 1 of each
set, then seed 2 of each, ...) so that a machine that drifts over the
call moves every set alike, and writes each run's result line
and the end of its standard error to ``--out``.  It prints, for each set
and metric, the median and the spread: the distance between the first and
the third quartile (``statistics.quantiles(values, n=4)``) as a share of
the median.  ``--first`` adds a run before the sets whose result is
reported apart (in a fresh checkout, the run that compiles).
"""

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def one(workload: str, seed: int, seconds: float, trace: int) -> dict:
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, str(ROOT / "pimbench" / "run.py"), "--workload",
         workload, "--seed", str(seed), "--seconds", str(seconds),
         "--trace", str(trace)], capture_output=True, text=True, cwd=ROOT)
    last = p.stdout.strip().splitlines()[-1:] or [""]
    try:
        result = json.loads(last[0])
    except json.JSONDecodeError:
        result = None
    return {"workload": workload, "seed": seed, "trace": trace,
            "rc": p.returncode, "wall_s": time.perf_counter() - t0,
            "result": result, "stderr": p.stderr[-3000:]}


def spread(values) -> tuple:
    """(median, (Q3 - Q1) / median)."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, (q3 - q1) / med if med else float("inf")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sets", type=int, default=1)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--first", type=int, default=None,
                    help="seed of a run reported apart, before the sets")
    ap.add_argument("--out", required=True)
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    bad = 0
    with out.open("a") as f:
        def record(r, label):
            nonlocal bad
            f.write(json.dumps(dict(r, set=label)) + "\n")
            f.flush()
            res = r["result"] or {}
            ok = r["rc"] == 0 and res.get("correct") is True
            bad += not ok
            print(f"{args.workload} {label} seed {r['seed']} trace "
                  f"{r['trace']}: rc {r['rc']} correct {res.get('correct')} "
                  f"wall {r['wall_s']:.1f} s metrics "
                  f"{ {k: v['value'] for k, v in res.get('metrics', {}).items()} }"
                  f" device {res.get('device')}", flush=True)
            if not ok:
                print(r["stderr"], flush=True)
            return res
        if args.first is not None:
            record(one(args.workload, args.first, args.seconds, args.trace),
                   "first")
        got = [[] for _ in range(args.sets)]
        for seed in args.seeds:
            for s in range(args.sets):
                got[s].append(record(one(args.workload, seed, args.seconds,
                                         args.trace), f"set{s + 1}"))
        for s, runs in enumerate(got):
            names = sorted({k for g in runs for k in g.get("metrics", {})})
            for name in names:
                vals = [g["metrics"][name]["value"] for g in runs
                        if name in g.get("metrics", {})]
                med, sp = spread(vals)
                print(f"{args.workload} set{s + 1} {name}: median {med!r} "
                      f"spread {sp!r} over {len(vals)} runs", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
