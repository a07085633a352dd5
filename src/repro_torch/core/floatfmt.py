"""Floating-point formats and an exact IEEE-754 round-to-nearest-ties-even
oracle used to verify the in-memory algorithms (paper §7.1 verifies against
IEEE-adherent host arithmetic; we use exact rational arithmetic so the oracle
is bit-exact for *every* (ne, nm), including bf16 whose division is not exact
in float64).

Per the paper we exclude NaN/Inf/subnormals/overflow; encoded exponent 0 with
mantissa 0 represents zero.
"""

from __future__ import annotations

import dataclasses
from fractions import Fraction

import numpy as np


@dataclasses.dataclass(frozen=True)
class FloatFormat:
    ne: int
    nm: int

    @property
    def bias(self) -> int:
        return (1 << (self.ne - 1)) - 1

    @property
    def nbits(self) -> int:
        return 1 + self.ne + self.nm

    # ---------------------------------------------------------------- codec
    def encode(self, s: int, e: int, m: int) -> int:
        return (s << (self.ne + self.nm)) | (e << self.nm) | m

    def decode(self, bits: int):
        m = bits & ((1 << self.nm) - 1)
        e = (bits >> self.nm) & ((1 << self.ne) - 1)
        s = bits >> (self.ne + self.nm)
        return s, e, m

    def to_fraction(self, bits: int) -> Fraction:
        s, e, m = self.decode(bits)
        if e == 0:
            return Fraction(0)
        v = Fraction((1 << self.nm) + m, 1 << self.nm) * Fraction(2) ** (e - self.bias)
        return -v if s else v

    def from_fraction(self, v: Fraction) -> int:
        """Round ``v`` to this format with round-to-nearest, ties-to-even.

        Raises if the result over/underflows the normal range (the paper's
        excluded cases; tests avoid generating them).
        """
        if v == 0:
            return 0
        s = 1 if v < 0 else 0
        a = abs(v)
        # find e with 2^e <= a < 2^{e+1}
        e = a.numerator.bit_length() - a.denominator.bit_length()
        if Fraction(2) ** e > a:
            e -= 1
        assert Fraction(2) ** e <= a < Fraction(2) ** (e + 1)
        # mantissa = a / 2^e in [1,2); scaled = a * 2^{nm - e}
        scaled = a * Fraction(2) ** (self.nm - e)
        m_floor = scaled.numerator // scaled.denominator
        rem = scaled - m_floor
        if rem > Fraction(1, 2) or (rem == Fraction(1, 2) and (m_floor & 1)):
            m_floor += 1
        if m_floor == (1 << (self.nm + 1)):   # rounded up to next binade
            m_floor >>= 1
            e += 1
        ebits = e + self.bias
        if not (1 <= ebits <= (1 << self.ne) - 2):
            raise OverflowError(f"exponent {ebits} out of normal range")
        return self.encode(s, ebits, m_floor - (1 << self.nm))

    # ------------------------------------------------------------- operators
    def op_exact(self, op: str, xb: int, yb: int) -> int:
        x, y = self.to_fraction(xb), self.to_fraction(yb)
        if op == "add":
            r = x + y
        elif op == "sub":
            r = x - y
        elif op == "mul":
            r = x * y
        elif op == "div":
            r = x / y
        else:
            raise ValueError(op)
        if r == 0:
            return 0
        return self.from_fraction(r)

    # ------------------------------------------------------- numpy bridges
    def random_bits(self, rng: np.random.Generator, n: int,
                    emin=None, emax=None) -> np.ndarray:
        """Random normal-range encodings with exponents in [emin, emax]
        (biased); keeping exponents near the middle avoids the excluded
        overflow/underflow cases under arithmetic."""
        lo = emin if emin is not None else 1
        hi = emax if emax is not None else (1 << self.ne) - 2
        s = rng.integers(0, 2, n, dtype=np.int64)
        e = rng.integers(lo, hi + 1, n, dtype=np.int64)
        m = rng.integers(0, 1 << self.nm, n, dtype=np.int64)
        return (s << (self.ne + self.nm)) | (e << self.nm) | m


FP16 = FloatFormat(ne=5, nm=10)
BF16 = FloatFormat(ne=8, nm=7)
FP32 = FloatFormat(ne=8, nm=23)
FP64 = FloatFormat(ne=11, nm=52)

FORMATS = {"fp16": FP16, "bf16": BF16, "fp32": FP32, "fp64": FP64}


def np_bits(fmt: FloatFormat, arr: np.ndarray) -> np.ndarray:
    """Bit pattern of a numpy float array in ``fmt`` (fp16/fp32/fp64 only)."""
    if fmt is FP16:
        return arr.astype(np.float16).view(np.uint16).astype(np.uint64)
    if fmt is FP32:
        return arr.astype(np.float32).view(np.uint32).astype(np.uint64)
    if fmt is FP64:
        return arr.astype(np.float64).view(np.uint64)
    raise ValueError("no native numpy dtype for this format")
