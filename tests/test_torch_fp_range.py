"""The fp ufuncs over the whole normal range, against the JAX package.

``tests/test_torch_ufunc.py`` draws exponents within 4 of the bias.  Here
the operands span every normal exponent, and meet the edge values --
+-0, the smallest normal and the largest finite value -- each other and
random values: fp16 and fp32 as native arrays, bf16 as bit patterns with
``fmt="bf16"``; every fp op under ``schedule`` ``slots`` and ``dense``
and ``layout`` ``rows32`` and ``rows64``.  ``repro_torch.pim_ufunc`` on
``device="cpu", backend="ref"`` is held bit for bit against
``repro.pim_ufunc``.  Only ``fp_div`` on the zero divisors raises: there
both raise ``ValueError``.
"""

import itertools

import numpy as np
import pytest

from repro import pim_ufunc as rpim
from repro.core.floatfmt import FORMATS
from repro_torch import pim_ufunc as tpim

CPU = dict(device="cpu", backend="ref")
N_ROWS = 256
NATIVE = {"fp16": (np.uint16, np.float16), "fp32": (np.uint32, np.float32)}


def _edges(f) -> list:
    """+-0, +-the smallest normal, +-the largest finite, as bits."""
    sign = 1 << (f.ne + f.nm)
    top = ((1 << f.ne) - 2) << f.nm | ((1 << f.nm) - 1)
    return [v | s for v in (0, 1 << f.nm, top) for s in (0, sign)]


def _operands(fmt, seed=7):
    """Bits of ``N_ROWS`` pairs: every pair of edge values, each edge
    value against random ones on either side, and random normals of any
    exponent in the rest."""
    f = FORMATS[fmt]
    rng = np.random.default_rng(seed)
    x = f.random_bits(rng, N_ROWS).astype(np.uint64)
    y = f.random_bits(rng, N_ROWS).astype(np.uint64)
    e = _edges(f)
    pairs = np.array(list(itertools.product(e, e)), np.uint64)
    n = len(pairs)
    x[:n], y[:n] = pairs[:, 0], pairs[:, 1]
    x[n:n + len(e)] = e
    y[n + len(e):n + 2 * len(e)] = e
    return x, y


def _as_input(bits, fmt):
    if fmt in NATIVE:
        word, native = NATIVE[fmt]
        return bits.astype(word).view(native), {}
    return bits, {"fmt": fmt}


def _outcome(fn):
    """The result of ``fn()``, or the type of what it raised."""
    try:
        return np.asarray(fn())
    except Exception as e:               # noqa: BLE001 -- compared below
        return type(e)


def _held(op, xb, yb, fmt, options, expect_raise=False):
    """The port against the reference on one call: both raise
    ``ValueError`` where ``expect_raise``, else both return bit-equal
    arrays."""
    x, kw = _as_input(xb, fmt)
    y, _ = _as_input(yb, fmt)
    want = _outcome(lambda: getattr(rpim, op)(x, y, **kw, **options))
    got = _outcome(lambda: getattr(tpim, op)(x, y, **kw, **options, **CPU))
    if expect_raise:
        assert want is ValueError, want
        assert got is want, (got, want)
        return
    assert isinstance(want, np.ndarray), want
    assert isinstance(got, np.ndarray), got
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got.view(np.uint8), want.view(np.uint8))


@pytest.mark.parametrize("layout", ["rows32", "rows64"])
@pytest.mark.parametrize("schedule", ["slots", "dense"])
@pytest.mark.parametrize("fmt", ["fp16", "fp32", "bf16"])
@pytest.mark.parametrize("op", ["fp_add", "fp_sub", "fp_mul", "fp_div"])
def test_fp_ufunc_whole_range_matches_reference(op, fmt, schedule, layout):
    x, y = _operands(fmt)
    options = {"schedule": schedule, "layout": layout}
    if op == "fp_div":
        # both raise on a zero divisor: that much held, the division
        # runs with a smallest normal of the zero's sign in its place
        _held(op, x, y, fmt, options, expect_raise=True)
        f = FORMATS[fmt]
        mag = (1 << (f.ne + f.nm)) - 1
        y = np.where(y & np.uint64(mag) == 0, y | np.uint64(1 << f.nm), y)
    _held(op, x, y, fmt, options)
