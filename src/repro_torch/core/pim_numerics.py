"""The program table of the PIM arithmetic suite.

:func:`program_for` maps (kind, op, width or format) to the memoized
``build_*`` gate program the ufunc frontend runs -- the counterpart of
``repro.core.pim_numerics.program_for``.
"""

from __future__ import annotations

import functools

from . import bitparallel, bitparallel_fp, bitserial, bitserial_fp, gates
from .floatfmt import FORMATS


@functools.lru_cache(maxsize=None)
def program_for(kind: str, op: str, width_or_fmt):
    """The memoized ``build_*`` Program for (kind, op, parameterization).

    kind: 'int-serial' | 'int-parallel' | 'fp-serial' | 'fp-parallel';
    width_or_fmt: bit width for int kinds, FORMATS name for fp kinds.
    """
    if kind == "int-serial":
        return {
            "add": bitserial.build_add,
            "sub": bitserial.build_sub,
            "mul": bitserial.build_mul,
            "div": bitserial.build_div,
        }[op](width_or_fmt)
    if kind == "int-parallel":
        return {
            "add": bitparallel.build_bp_add,
            "sub": bitparallel.build_bp_sub,
            "mul": bitparallel.build_bp_mul,
            "div": lambda n: bitparallel.build_bp_div(n, cpk=384),
        }[op](width_or_fmt)
    if kind == "fp-serial":
        return {
            "add": bitserial_fp.build_fp_add,
            "sub": bitserial_fp.build_fp_sub,
            "mul": bitserial_fp.build_fp_mul,
            "div": bitserial_fp.build_fp_div,
        }[op](FORMATS[width_or_fmt])
    if kind == "fp-parallel":
        return {
            "add": bitparallel_fp.build_bp_fp_add,
            "mul": bitparallel_fp.build_bp_fp_mul,
            "div": bitparallel_fp.build_bp_fp_div,
        }[op](FORMATS[width_or_fmt])
    raise ValueError(kind)


@gates.memoize_build
def build_identity(n: int):
    """``z <- x``, an ``n``-bit copy program."""
    b = gates.Builder()
    x = b.input("x", n)
    b.output("z", b.vec_id(x))
    return b.finish()
