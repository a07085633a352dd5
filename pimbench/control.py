"""The check's control: the plain reference one precision step down,
put in the program's place, has to come out not correct.

    python3 pimbench/control.py --workload <cell> --seeds 11 12 13

draws each seed's operand pool as a run of the cell does (on the card,
at the cell's size) and counts, for each set, the rows in which
``reference.control`` differs from ``reference.expected``: the number a
run compares against its limit of 0.  Prints one line a seed and exits 1
if any seed's control passes.  ``--device cpu`` draws on the CPU.
"""

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(spec: dict, seed: int, device: str) -> list:
    """Mismatched rows of the control in each operand set of ``seed``."""
    from pimbench import reference, traffic
    op = spec["traffic"]["op"]
    return [reference.mismatched_rows(reference.control(op, x, y),
                                      reference.expected(op, x, y))
            for x, y in traffic.operand_sets(spec["config"],
                                             spec["traffic"], seed, device)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from pimbench import cells
    spec = cells.load_cell(args.workload, ROOT)
    if cells.kind(spec) == "lm":
        from pimbench import lm
        return lm.control_main(spec, args.seeds, args.device)
    rows = int(spec["traffic"]["rows_per_call"])
    least = None
    for seed in args.seeds:
        t0 = time.perf_counter()
        bad = readings(spec, seed, args.device)
        least = min(bad) if least is None else min(least, min(bad))
        print(f"control {args.workload} seed {seed}: mismatched rows "
              f"{bad} of {rows} a set (limit 0); "
              f"{time.perf_counter() - t0:.3f} s", flush=True)
    print(f"control {args.workload}: least reading {least} (limit 0): "
          f"{'refused, as it must be' if least > 0 else 'PASSED'}")
    return 0 if least > 0 else 1


if __name__ == "__main__":
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    sys.exit(main())
