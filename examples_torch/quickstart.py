"""Quickstart on PyTorch: the AritPIM suite end to end, through the ufunc
frontend.

Every arithmetic family runs on the element-parallel PIM machine (one
shared gate program, thousands of rows) via ``repro_torch.pim_ufunc`` --
arrays in, arrays out, streamed through the chunked executor, on the card's
kernels unless ``--device cpu`` asks for their plain versions -- then
latency and energy are reported from the memristive device model.  The
same lines as ``examples/quickstart.py``.

    PYTHONPATH=src python examples_torch/quickstart.py [--device cpu]
"""

import argparse

import numpy as np

from repro_torch import pim_ufunc as pim
from repro_torch.core import bitserial, bitserial_fp, bitparallel
from repro_torch.core.device_model import GPU_DEFAULT, PIM_DEFAULT
from repro_torch.core.floatfmt import BF16, FP32

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                help="cuda: the hand-written kernels on the card; cpu: "
                "their plain versions (backend 'ref')")
if ap.parse_args().device == "cpu":
    pim.configure(device="cpu", backend="ref")

rng = np.random.default_rng(0)

# --- integer vectors, one program, element-parallel
x = rng.integers(0, 2**16, 1000).astype(np.uint16)
y = rng.integers(0, 2**16, 1000).astype(np.uint16)
assert np.array_equal(pim.add(x, y), x.astype(np.uint64) + y)
assert np.array_equal(pim.mul(x, y), x.astype(np.uint64) * y)
d = rng.integers(1, 2**16, 1000).astype(np.uint16)
q, r = pim.div(x, d)
assert np.array_equal(q, x.astype(np.uint64) // d)
assert np.array_equal(r, x.astype(np.uint64) % d)
print("int16 add/mul/div: 1000 rows, bit-exact")

# --- fp32, exact IEEE RNE
a = rng.standard_normal(512).astype(np.float32)
b = rng.standard_normal(512).astype(np.float32)
for op, want in [("fp_add", a + b), ("fp_sub", a - b),
                 ("fp_mul", a * b), ("fp_div", a / b)]:
    got = getattr(pim, op)(a, b)
    assert np.array_equal(got, want.astype(np.float32))
    print(f"fp32 {op[3:]}: 512 rows, bit-exact vs numpy (IEEE RNE)")

# --- bf16 has no native numpy dtype: bit-pattern arrays + fmt=
xb = BF16.random_bits(rng, 256, emin=120, emax=132).astype(np.uint64)
yb = BF16.random_bits(rng, 256, emin=120, emax=132).astype(np.uint64)
zb = pim.fp_add(xb, yb, fmt="bf16")
assert all(int(z) == BF16.op_exact("add", int(p), int(q)) for z, p, q
           in zip(zb, xb, yb))
print("bf16 add: 256 rows, bit-exact vs the exact rational oracle")

# --- latency & throughput on the memristive case study (paper Fig. 9),
# against the paper's GPU model (an RTX 3070 at its bandwidth roofline)
pim_dev = PIM_DEFAULT
for name, prog in [("int32 add", bitserial.build_add(32)),
                   ("fp32 add", bitserial_fp.build_fp_add(FP32)),
                   ("int32 add (bit-parallel)",
                    bitparallel.build_bp_add(32))]:
    cost = prog.parallel_cost() or prog.cost()
    thr = pim_dev.throughput_ops(cost)
    print(f"{name:26s}: {pim_dev.cycles(cost):6d} cycles "
          f"= {pim_dev.latency_s(cost)*1e6:7.2f} us, "
          f"{thr/1e9:9.1f} GOPS over {pim_dev.parallel_rows/2**20:.0f} Mi rows "
          f"({thr / GPU_DEFAULT.throughput_ops(4):6.1f}x the GPU roofline)")
