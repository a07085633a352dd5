"""Batched PIM serving quickstart on PyTorch (DESIGN.md §10).

Mixed traffic -- many small requests over several distinct programs --
through the batched serving runtime, on the card's kernels unless
``--device cpu`` asks for their plain versions: requests are grouped by
compiled-program structure, each group executes as one packed state, and
results scatter back per request.  Compare against the per-request serial
loop.  The same lines as ``examples/pim_serving.py``.

    PYTHONPATH=src python examples_torch/pim_serving.py [--device cpu]

The same runtime serves JSON lines over stdin/stdout:

    printf '%s\n' \
        '{"op":"add","dtype":"uint16","x":[3,5],"y":[4,6]}' \
        '{"op":"div","dtype":"uint8","x":[17],"y":[5]}' \
        '{"op":"fp_add","dtype":"float16","x":[1.5],"y":[0.25]}' | \
        PYTHONPATH=src python -m repro_torch.launch.serve --pim-serve \
            --pim-window-ms 5 --pim-max-batch-rows 65536
"""

import argparse
import time

import numpy as np

from repro_torch import pim_ufunc as pim
from repro_torch.runtime import pim_batch, telemetry

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                help="cuda: the hand-written kernels on the card; cpu: "
                "their plain versions (backend 'ref')")
if ap.parse_args().device == "cpu":
    pim.configure(device="cpu", backend="ref")

rng = np.random.default_rng(0)
N = 512                                  # rows per request


def fp16(n):
    # normal-range fp16 (the paper excludes NaN/Inf/subnormals)
    return (rng.integers(10, 21, n).astype(np.uint16) << 10 |
            rng.integers(0, 1 << 10, n).astype(np.uint16)).view(np.float16)


# 48 requests interleaved over 6 distinct programs
traffic = []
for _ in range(8):
    x = rng.integers(0, 1 << 16, N).astype(np.uint16)
    y = rng.integers(0, 1 << 16, N).astype(np.uint16)
    d = rng.integers(1, 1 << 16, N).astype(np.uint16)
    traffic += [("add", x, y), ("mul", x, y), ("div", x, d),
                ("fp_add", fp16(N), fp16(N)), ("fp_sub", fp16(N), fp16(N)),
                ("fp_mul", fp16(N), fp16(N))]

# prepare() parses/validates and binds each request to its gate program
# without executing -- the handle the planner groups by content hash
preps = [pim.prepare(op, x, y) for op, x, y in traffic]
print(f"{len(preps)} requests, "
      f"{len({p.key for p in preps})} distinct programs, "
      f"{sum(p.n_rows for p in preps)} total rows")

runtime = pim_batch.BatchRuntime(pin_cap=16)
# warm-up both paths: compile every program (on the card: build its
# kernels) at both the per-request and the coalesced-group shapes, so the
# timings below are pure serving
runtime.execute(preps)
for op, x, y in traffic:
    getattr(pim, op)(x, y)

telemetry.drain_model_counters()         # window the analytical cost gauge
t0 = time.perf_counter()
results = runtime.execute(preps)
dt_batched = time.perf_counter() - t0
print(runtime.stats.summary(pinned=len(runtime.pins)))

# per-batch telemetry (DESIGN.md §15): latency percentiles from the
# runtime's own registry, and the modeled device cost of what just ran --
# PIM cycles on the memristive device model next to host wall clock
exec_h = runtime.metrics.summary("pim.batch.exec_us")
occ_h = runtime.metrics.summary("pim.batch.occupancy_rows")
print(f"exec_us  p50={exec_h['p50']:.0f} p99={exec_h['p99']:.0f} "
      f"(n={exec_h['count']})  "
      f"occupancy p50={occ_h['p50']:.0f} rows")
model = telemetry.drain_model_counters()
cyc = model.get("pim.model.cycles", 0)
print(f"modeled: {model.get('pim.exec.dispatches', 0)} dispatches, "
      f"{cyc:,} PIM cycles = "
      f"{cyc * telemetry.PIM_DEFAULT.cycle_ns * 1e-3:.1f} us on-device, "
      f"{model.get('pim.model.energy_pj', 0.0) * 1e-6:.2f} uJ modeled "
      f"energy")

# the serial loop: one program execution per request (--pim-stdin's model)
t0 = time.perf_counter()
serial = [getattr(pim, op)(x, y) for op, x, y in traffic]
dt_serial = time.perf_counter() - t0

# bit-exactness: coalesced == per-request, row for row (div's (q, r) too)
for (op, _, _), res, want in zip(traffic, results, serial):
    if op == "div":
        assert np.array_equal(res.value[0], want[0])
        assert np.array_equal(res.value[1], want[1])
    else:
        assert np.array_equal(res.value, want)
print("batched results bit-exact vs per-request execution")

rows = sum(p.n_rows for p in preps)
print(f"serial : {dt_serial * 1e3:7.1f} ms = {rows / dt_serial:10,.0f} rows/s")
print(f"batched: {dt_batched * 1e3:7.1f} ms = {rows / dt_batched:10,.0f} "
      f"rows/s ({dt_serial / dt_batched:.1f}x)")
runtime.close()
