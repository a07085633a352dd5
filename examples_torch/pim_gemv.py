"""Compound-program fusion quickstart on PyTorch (DESIGN.md §13).

Three escalating uses of the lazy expression frontend, on the card's
kernels unless ``--device cpu`` asks for their plain versions:

  1. a fused elementwise chain -- ``(a*b)+c`` recorded as a DAG and
     lowered into ONE compiled gate program (one pack, one execution,
     one unpack), vs the same chain as three eager ufunc calls;
  2. ``pim.dot`` -- an in-memory dot product: an element-parallel
     multiply feeding a log-depth adder tree that never leaves the
     packed word domain;
  3. ``pim.gemv`` -- every output lane reduces in parallel rows, so a
     64x1024 int16 GEMV takes 1 + log2(1024) program dispatches total.

The same lines as ``examples/pim_gemv.py``.

    PYTHONPATH=src python examples_torch/pim_gemv.py [--device cpu]
"""

import argparse
import time

import numpy as np

from repro_torch import pim_ufunc as pim
from repro_torch.core.floatfmt import FP16

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                help="cuda: the hand-written kernels on the card; cpu: "
                "their plain versions (backend 'ref')")
kw = {} if ap.parse_args().device == "cuda" else \
    dict(device="cpu", backend="ref")

rng = np.random.default_rng(0)

# ---- 1. fused elementwise chain ------------------------------------------
a = rng.integers(0, 256, 8192).astype(np.uint64)
b = rng.integers(0, 256, 8192).astype(np.uint64)
c = rng.integers(0, 256, 8192).astype(np.uint64)

expr = (pim.lazy(a, width=8) * pim.lazy(b, width=8)) + pim.lazy(c, width=8)
prep = pim.fuse(expr, **kw)
fused = prep.run()
print(f"fused chain: {prep.fused_ops} ops in one program "
      f"{prep.provenance} -> bit-exact: "
      f"{bool(np.array_equal(fused, a * b + c))}")

unfused = pim.add(pim.mul(a, b, width=8, **kw), c, width=16, **kw)
print(f"unfused chain agrees: {bool(np.array_equal(unfused, fused))}")

# ---- 2. in-memory dot product --------------------------------------------
xf = FP16.random_bits(rng, 8192, emin=10, emax=20) \
    .astype(np.uint16).view(np.float16)
yf = FP16.random_bits(rng, 8192, emin=10, emax=20) \
    .astype(np.uint16).view(np.float16)
d = pim.dot(xf, yf, **kw)
# the reference is the same-shape binary tree (fp adds round per level)
t = (xf * yf).astype(np.float16)
while len(t) > 1:
    t = (t[:len(t) // 2] + t[len(t) // 2:]).astype(np.float16)
print(f"fp16 dot(8192): pim={d}  host-tree={t[0]}  "
      f"bit-exact: {d.view(np.uint16) == t[0].view(np.uint16)}")

# ---- 3. GEMV: all output lanes reduce at once ----------------------------
m, k = 64, 1024
w = rng.integers(0, 1 << 16, (m, k)).astype(np.uint64)
v = rng.integers(0, 1 << 16, k).astype(np.uint64)
pim.gemv(w, v, width=16, **kw)          # warm up (compiles the tree)
t0 = time.perf_counter()
y = pim.gemv(w, v, width=16, **kw)
dt = time.perf_counter() - t0
ok = np.array_equal(np.asarray(y, np.uint64), w @ v)
print(f"i16 gemv {m}x{k}: exact vs numpy: {ok}  "
      f"({dt * 1e3:.1f} ms, {m * k / dt:,.0f} products/s)")
