"""The plain reference: what each public ufunc has to return, in NumPy.

It takes the operands the benchmark made and nothing the program made, and
imports nothing of the program.  Every result of the paper's arithmetic is
exact, so a row is right only when it equals the reference's row: a float
bit for bit (IEEE 754 round to nearest even, which NumPy's float16/float32
arithmetic is), an integer by value (the ufunc returns its sums and
differences as uint64).

``control`` is the same arithmetic one precision step down, the shortcut a
faster program might be tempted by; the check has to refuse it.
"""

from __future__ import annotations

import numpy as np


def _width(x: np.ndarray) -> int:
    return x.dtype.itemsize * 8


def expected(op: str, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """The exact result of ``pim.<op>(x, y)``, row for row."""
    if op in ("fp_add", "fp_sub", "fp_mul"):
        with np.errstate(all="raise"):
            return {"fp_add": np.add, "fp_sub": np.subtract,
                    "fp_mul": np.multiply}[op](x, y)
    w = _width(x)
    if w > 32:
        raise ValueError(f"integer reference for at most 32-bit operands, "
                         f"not {x.dtype}")
    xu, yu = x.astype(np.uint64), y.astype(np.uint64)
    if op == "add":
        return xu + yu                          # the full (w+1)-bit sum
    if op == "sub":
        return (xu - yu) & np.uint64((1 << w) - 1)    # modulo 2**w
    raise ValueError(f"no reference for op {op!r}")


def _bf16(v: np.ndarray) -> np.ndarray:
    """float32 rounded to bfloat16 (nearest even), kept as float32."""
    b = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) & 0xFFFF0000
    return b.astype(np.uint32).view(np.float32)


def control(op: str, x: np.ndarray, y: np.ndarray) -> np.ndarray:
    """``expected`` computed one precision step down: float32 operands and
    result rounded to bfloat16; integer sums and differences in float32
    (24 bits, not 32)."""
    if op in ("fp_add", "fp_sub", "fp_mul"):
        if x.dtype != np.float32:
            raise ValueError(f"no control below {x.dtype}")
        f = {"fp_add": np.add, "fp_sub": np.subtract,
             "fp_mul": np.multiply}[op]
        return _bf16(f(_bf16(x), _bf16(y)))
    w = _width(x)
    if op in ("add", "sub"):
        f = np.add if op == "add" else np.subtract
        r = f(x.astype(np.float32), y.astype(np.float32)).astype(np.float64)
        if op == "sub":
            r = np.mod(r, 2.0 ** w)
        return r.astype(np.uint64)
    raise ValueError(f"no control for op {op!r}")


def mismatched_rows(got, want: np.ndarray) -> int:
    """Rows of ``got`` that differ from the reference ``want``; every row
    when ``got`` has another shape, or a dtype that cannot hold the
    answer (a float result must keep its dtype)."""
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(want.size)
    if want.dtype.kind == "f":
        if got.dtype != want.dtype:
            return int(want.size)
        bits = np.dtype(f"u{want.dtype.itemsize}")
        return int(np.count_nonzero(got.view(bits) != want.view(bits)))
    if got.dtype == object:
        return int(np.count_nonzero(
            ~np.equal(got, want.astype(object)).astype(bool)))
    if got.dtype.kind == "u":
        return int(np.count_nonzero(got.astype(np.uint64) != want))
    if got.dtype.kind == "i":
        bad = got < 0
        return int(np.count_nonzero(
            bad | (np.where(bad, 0, got).astype(np.uint64) != want)))
    return int(want.size)
