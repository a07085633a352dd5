"""Streaming + sharded PIM arithmetic at scale on PyTorch (DESIGN.md §8).

A million fp16 additions served by one shared gate program: rows are tiled
into word-aligned chunks, host packing of chunk k+1 overlaps device
execution of chunk k, and each chunk's packed word axis is sharded over
the machine's CUDA devices (``kernels.ops.row_mesh``: none on one card).
With ``--device cpu`` the plain versions run, the rows split over the CPU
named four times, as the reference's four forced host devices.  The same
lines as ``examples/pim_streaming.py``.

    PYTHONPATH=src python examples_torch/pim_streaming.py [--device cpu] \
        [--small]
"""

import argparse
import time

import numpy as np

from repro_torch import pim_ufunc as pim
from repro_torch.core.pim_numerics import program_for
from repro_torch.kernels import ops as kops

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                help="cuda: the hand-written kernels on the card; cpu: "
                "their plain versions (backend 'ref')")
ap.add_argument("--small", action="store_true", help="64 Ki rows, not 1 Mi")
args = ap.parse_args()
if args.device == "cpu":
    # the reference's chunk, chosen on the CPU (the card's default,
    # kernels.plan.DEFAULT_CHUNK_ROWS, was chosen on the H100)
    pim.configure(device="cpu", backend="ref", chunk_rows=1 << 18)
    mesh = ("cpu",) * 4
else:
    mesh = kops.row_mesh()

N = 1 << 20 if not args.small else 1 << 16
rng = np.random.default_rng(0)

print(f"devices: {len(mesh) if mesh else 1}, rows: {N}, "
      f"chunk: {pim.config.chunk_rows}")

# fp16 addition: exponents kept mid-range (the paper excludes
# overflow/underflow and NaN/Inf/subnormals)
x = (rng.integers(10, 21, N).astype(np.uint16) << 10 |
     rng.integers(0, 1 << 10, N).astype(np.uint16)).view(np.float16)
y = (rng.integers(10, 21, N).astype(np.uint16) << 10 |
     rng.integers(0, 1 << 10, N).astype(np.uint16)).view(np.float16)

# compile once at the streaming chunk shape (all chunks share it), then time
warm = min(N, pim.config.chunk_rows)
pim.fp_add(x[:warm], y[:warm], mesh=mesh)
t0 = time.perf_counter()
z = pim.fp_add(x, y, mesh=mesh)
dt = time.perf_counter() - t0
print(f"pim.fp_add: {N} rows in {dt*1e3:.1f} ms "
      f"= {N/dt/1e6:.2f} M rows/s (streamed + sharded)")

# spot-check a sample against numpy's IEEE fp16 addition
idx = rng.integers(0, N, 1000)
assert np.array_equal(z[idx], (x[idx] + y[idx]).astype(np.float16))
print("sampled 1000 rows: bit-exact vs numpy IEEE RNE")

# the same executor, explicitly unsharded, for comparison
t0 = time.perf_counter()
kops.run_program_streaming(
    program_for("fp-serial", "add", "fp16"),
    {"x": x.view(np.uint16).astype(np.uint64),
     "y": y.view(np.uint16).astype(np.uint64)}, N,
    backend=pim.config.backend, device=pim.config.device,
    chunk_rows=pim.config.chunk_rows, mesh=None)
dt1 = time.perf_counter() - t0
print(f"unsharded streaming baseline: {N} rows in {dt1*1e3:.1f} ms "
      f"= {N/dt1/1e6:.2f} M rows/s")
