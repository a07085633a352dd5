"""The one operand generator: a traffic file's parameters and a seed in,
a pool of operand sets out.

A traffic file (``pimbench/traffic/<name>.json``) holds:

* ``op``: the public ufunc a call makes (``fp_add``, ``add``, ``sub``, ...);
* ``rows_per_call``: the rows of one call (one PIM row an element);
* ``pool``: how many distinct operand sets the run cycles through, so that
  consecutive calls never see the same data;
* ``operands``: the draw; ``{"kind": "float", "exponent_min": a,
  "exponent_max": b}`` draws sign, unbiased exponent in [a, b] and
  mantissa uniformly, so every operand is finite and normal and, for a
  and b well inside the format's range, every sum or difference of two is
  zero only where it cancels exactly, which the draw removes;
  ``{"kind": "uniform"}`` draws unsigned integers uniformly over the
  dtype.

The configuration gives the dtype.  The draw runs on ``device`` from a
``torch.Generator`` seeded with ``seed`` (the card: a few large calls),
is cut there to the dtype's width and lands in host memory as numpy
arrays, which is what a ufunc takes.  The same seed, sizes and device give
the same operands.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

#: Unsigned dtype of a float's bit pattern.
_BITS = {np.dtype(np.float16): np.uint16, np.dtype(np.float32): np.uint32}
#: Torch integer type of each width in bytes, to cut a draw to on the device.
_CUT = {1: torch.uint8, 2: torch.int16, 4: torch.int32}


def float_fields(dtype) -> Tuple[int, int]:
    """(exponent bits, mantissa bits) of an IEEE binary format."""
    dtype = np.dtype(dtype)
    nm = np.finfo(dtype).nmant
    return dtype.itemsize * 8 - 1 - nm, nm


def _float_bits(gen, rows: int, dtype, spec: dict, device) -> torch.Tensor:
    ne, nm = float_fields(dtype)
    bias = (1 << (ne - 1)) - 1
    lo, hi = int(spec["exponent_min"]), int(spec["exponent_max"])
    if not (1 - bias <= lo <= hi <= bias):
        raise ValueError(f"exponents [{lo}, {hi}] leave the normal range "
                         f"of {np.dtype(dtype)}")
    kw = dict(generator=gen, device=device, dtype=torch.int64)
    sign = torch.randint(0, 2, (rows,), **kw)
    exp = torch.randint(lo + bias, hi + bias + 1, (rows,), **kw)
    mant = torch.randint(0, 1 << nm, (rows,), **kw)
    return (sign << (ne + nm)) | (exp << nm) | mant


def _uniform(gen, rows: int, dtype, device) -> torch.Tensor:
    bits = np.dtype(dtype).itemsize * 8
    if bits > 32:
        raise ValueError(f"uniform operands of {np.dtype(dtype)} are not "
                         "drawn (at most 32 bits)")
    return torch.randint(0, 1 << bits, (rows,), generator=gen,
                         device=device, dtype=torch.int64)


def _host(t: torch.Tensor, dtype) -> np.ndarray:
    """``t``'s low bits as ``dtype`` (unsigned) on the host: cut to the
    width on the device (a conversion keeps the low bits), copied, viewed."""
    dtype = np.dtype(dtype)
    return t.to(_CUT[dtype.itemsize]).cpu().numpy().view(dtype)


def operand_sets(config: dict, traffic: dict, seed: int,
                 device="cuda") -> List[Tuple[np.ndarray, np.ndarray]]:
    """``traffic["pool"]`` operand pairs of ``traffic["rows_per_call"]``
    rows each, of the configuration's dtype, drawn from ``seed``."""
    dtype = np.dtype(config["dtype"])
    rows = int(traffic["rows_per_call"])
    spec = traffic["operands"]
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 64))
    sets = []
    for _ in range(int(traffic["pool"])):
        if spec["kind"] == "float":
            if dtype not in _BITS:
                raise ValueError(f"float operands need a float16/float32 "
                                 f"configuration, not {dtype}")
            x = _float_bits(gen, rows, dtype, spec, device)
            y = _float_bits(gen, rows, dtype, spec, device)
            sign = 1 << (dtype.itemsize * 8 - 1)
            # x + (-x) is an exact zero, no normal result: take y = x there
            y = torch.where((x ^ y) == sign, y ^ sign, y)
            bits = _BITS[dtype]
            sets.append((_host(x, bits).view(dtype),
                         _host(y, bits).view(dtype)))
        elif spec["kind"] == "uniform":
            if dtype.kind != "u":
                raise ValueError(f"uniform operands need an unsigned "
                                 f"configuration, not {dtype}")
            sets.append((_host(_uniform(gen, rows, dtype, device), dtype),
                         _host(_uniform(gen, rows, dtype, device), dtype)))
        else:
            raise ValueError(f"unknown operand kind {spec['kind']!r}")
    return sets
