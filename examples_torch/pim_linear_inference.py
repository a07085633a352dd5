"""AritPIM as a numerics backend inside a model, on PyTorch: an int8
PIMLinear layer.

Quantizes a small MLP's weights to int8 and evaluates the GEMMs with the
in-memory bit-serial algorithms (exact integer arithmetic on the PIM
abstract machine, on the card's kernels unless ``--device cpu`` asks for
their plain versions), comparing against the float reference.  The same
lines as ``examples/pim_linear_inference.py``.

    PYTHONPATH=src python examples_torch/pim_linear_inference.py \
        [--device cpu]
"""

import argparse

import numpy as np

from repro_torch.core.pim_numerics import PIMVectorUnit, pim_linear_i8

ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                help="cuda: the hand-written kernels on the card; cpu: "
                "their plain versions (backend 'ref')")
device = ap.parse_args().device

rng = np.random.default_rng(1)
unit = PIMVectorUnit(backend="cuda") if device == "cuda" else \
    PIMVectorUnit(backend="ref", device="cpu")


def quant(w):
    s = np.abs(w).max() / 127.0
    return np.clip(np.round(w / s), -127, 127).astype(np.int8), s


# two-layer MLP
x = rng.standard_normal((4, 32)).astype(np.float32)
w1 = rng.standard_normal((32, 16)).astype(np.float32) / np.sqrt(32)
w2 = rng.standard_normal((16, 8)).astype(np.float32) / np.sqrt(16)

xq, sx = quant(x)
w1q, s1 = quant(w1)
h_pim = pim_linear_i8(unit, xq, w1q).astype(np.float32) * sx * s1
h_pim = np.maximum(h_pim, 0)
hq, sh = quant(h_pim)
w2q, s2 = quant(w2)
y_pim = pim_linear_i8(unit, hq, w2q).astype(np.float32) * sh * s2

y_ref = np.maximum(x @ w1, 0) @ w2
rel = np.abs(y_pim - y_ref).max() / np.abs(y_ref).max()
print(f"PIM int8 2-layer MLP vs float reference: max rel err = {rel:.4f}")
assert rel < 0.06
print("int8 GEMMs themselves are EXACT (verified in tests); the error is "
      "pure quantization.")
