"""Bit-serial element-parallel floating-point arithmetic (paper §4).

The novel routines:

  * :func:`var_shift_right` / :func:`var_shift_left` -- Algorithm 4.1, the
    first in-memory *variable* shifter: every row shifts its own value by its
    own amount, via simulated in-memory multiplexers + a logarithmic shifter.
  * :func:`var_normalize` -- Algorithm 4.3, left-normalize with unknown shift
    amount via a binary search over the OR-prefix.
  * :func:`fp_add_unsigned` -- Algorithm 4.2 (first in-memory FP addition).
  * :func:`fp_add_signed` -- §4.5 (adds negation + variable normalization).
  * :func:`fp_mul` / :func:`fp_div` -- §4.6 (fixed-point cores + 1-bit
    normalization).

All results are *exactly* IEEE-754 round-to-nearest-ties-even (verified
against the rational oracle in :mod:`repro_torch.core.floatfmt`); NaN/Inf/
subnormals/overflow are excluded as in the paper.  Zero (e=0, m=0) is
handled.
"""

from __future__ import annotations

from typing import List, Tuple

from .bitserial import ripple_add, sub
from .bitserial import mul_karatsuba, divide
from .floatfmt import FloatFormat
from .gates import Builder, Program, memoize_build


def _clog2(n: int) -> int:
    return max(1, (n - 1).bit_length())


# --------------------------------------------------------------------------
# small vector helpers
# --------------------------------------------------------------------------

def ext(b: Builder, v: List[int], n: int) -> List[int]:
    """zero-extend (shares the const-0 cell; reads only)."""
    return v + [b.const(0)] * (n - len(v))


def add_bit(b: Builder, v: List[int], bit: int, nbit=None) -> List[int]:
    """v + bit over len(v) bits (carry dropped)."""
    nb = b.not_(bit) if nbit is None else nbit
    z, (c, nc) = ripple_add(b, v, [b.const(0)] * len(v), cin=(bit, nb))
    b.free([c, nc] + ([nb] if nbit is None else []))
    return z


def abs_val(b: Builder, v: List[int]) -> Tuple[List[int], int]:
    """two's-complement |v|; returns (|v|, sign).  §4.3: XOR with the sign
    then add the sign."""
    s = v[-1]
    x = [b.xor(vi, s) for vi in v]
    out = add_bit(b, x, s)
    b.free(x)
    return out, s


def clamp_unsigned(b: Builder, t: List[int], tmax: int) -> List[int]:
    """min(t, tmax) for unsigned t (tmax a compile-time constant)."""
    cvec = b.vec_const(tmax, len(t))
    _, ge = sub(b, t, cvec)                 # ge = (t >= tmax)
    out = b.vec_mux(ge, cvec, t)
    b.free(ge)
    return out


# --------------------------------------------------------------------------
# Algorithm 4.1: variable shift
# --------------------------------------------------------------------------

def var_shift_right(b: Builder, x: List[int], t: List[int],
                    handle_overflow: bool = False):
    """z = x >> t, per-row shift amounts (Algorithm 4.1).

    Faithful to the paper: ``log2(Nx)`` iterations, iteration j selecting
    ``mux_{t_j}(z >> 2^j, z)`` with the multiplexer's ~t_j hoisted once and
    the zero-fill upper cells computed as AND(~t_j, z_i) rather than muxes.

    With ``handle_overflow`` the result is additionally masked to zero when
    any bit of t above the covered range is set (t >= Nx rounded up to a
    power of two); returns (z, t_high_flag) in that case.
    """
    nx = len(x)
    lg = _clog2(nx)
    z = list(x)
    for j in range(min(len(t), lg)):
        s = t[j]
        ns = b.not_(s)
        step = 1 << j
        nz = []
        for i in range(nx):
            if i + step < nx:
                nz.append(b.muxn(s, ns, z[i + step], z[i]))
            else:
                nz.append(b.and_(ns, z[i]))
        for c in z:
            if c not in x:
                b.free(c)
        b.free(ns)
        z = nz
    if not handle_overflow:
        return z
    if len(t) > lg:
        th = b.or_reduce(t[lg:])
        nth = b.not_(th)
        z2 = [b.and_(nth, zi) for zi in z]
        b.free(z + [nth])
        return z2, th
    return z, b.const(0)


def var_shift_left(b: Builder, x: List[int], t: List[int],
                   handle_overflow: bool = False):
    """z = x << t (symmetric to :func:`var_shift_right`, paper fn. 6)."""
    nx = len(x)
    lg = _clog2(nx)
    z = list(x)
    for j in range(min(len(t), lg)):
        s = t[j]
        ns = b.not_(s)
        step = 1 << j
        nz = []
        for i in range(nx):
            if i - step >= 0:
                nz.append(b.muxn(s, ns, z[i - step], z[i]))
            else:
                nz.append(b.and_(ns, z[i]))
        for c in z:
            if c not in x:
                b.free(c)
        b.free(ns)
        z = nz
    if not handle_overflow:
        return z
    if len(t) > lg:
        th = b.or_reduce(t[lg:])
        nth = b.not_(th)
        z2 = [b.and_(nth, zi) for zi in z]
        b.free(z + [nth])
        return z2, th
    return z, b.const(0)


# --------------------------------------------------------------------------
# Algorithm 4.3: variable normalization
# --------------------------------------------------------------------------

def var_normalize(b: Builder, x: List[int]) -> Tuple[List[int], List[int]]:
    """Left-shift x until its MSB is one; also output the shift amount.

    Binary search over the OR-prefix (paper §4.4): iteration j (high to low)
    sets t_j = NOR of the top 2^j bits, then z = mux_{t_j}(z << 2^j, z).
    The only overhead over variable shift is the O(Nx) total OR chain
    (the paper's ~7% figure).  For x == 0: z = 0 and t = all-ones.
    Works for any Nx (no power-of-two padding): the window test guarantees
    the shift never exceeds the remaining leading zeros.

    Returns (z over len(x) bits, t little-endian of ceil(log2(Nx)) bits).
    """
    nx = len(x)
    lg = _clog2(nx)
    z = list(x)
    tbits = [None] * lg
    for j in reversed(range(lg)):
        step = 1 << j
        window = z[nx - step:]
        acc = b.or_reduce(window)
        tj = b.not_(acc)
        b.free(acc)
        ntj = b.not_(tj)
        nz = []
        for i in range(nx):
            if i - step >= 0:
                nz.append(b.muxn(tj, ntj, z[i - step], z[i]))
            else:
                nz.append(b.and_(ntj, z[i]))
        for c in z:
            if c not in x:
                b.free(c)
        b.free(ntj)
        z = nz
        tbits[j] = tj
    return z, tbits


# --------------------------------------------------------------------------
# floating-point helpers
# --------------------------------------------------------------------------

def _unpack(b: Builder, fmt: FloatFormat, v: List[int]):
    """(sign, exponent bits, mantissa-with-hidden bits) from a packed port.
    The hidden bit is OR(e) so that e=0 encodes zero."""
    nm, ne = fmt.nm, fmt.ne
    m = v[:nm]
    e = v[nm:nm + ne]
    s = v[nm + ne]
    hid = b.or_reduce(e)
    return s, e, m + [hid]


def _round_rne(b: Builder, field: List[int], rnd: int, sticky: int):
    """RNE increment.  ``field`` includes the hidden bit.  Returns
    (stored mantissa bits, exponent-increment bit)."""
    lsb = field[0]
    up = b.and_(rnd, b.or_(sticky, lsb))
    nup = b.not_(up)
    inc, (c, nc) = ripple_add(b, field, [b.const(0)] * len(field),
                              cin=(up, nup))
    b.free([nup, nc])
    # on carry the field was all ones -> inc bits are all zero, which is
    # exactly the stored mantissa of the next binade.
    return inc[:len(field) - 1], c


def _mask_zero(b: Builder, nz: int, bits: List[int]) -> List[int]:
    return [b.and_(nz, x) for x in bits]


# --------------------------------------------------------------------------
# Algorithm 4.2 (+ §4.5): floating-point addition
# --------------------------------------------------------------------------

def fp_add(b: Builder, fmt: FloatFormat, x: List[int], y: List[int],
           signed: bool = True) -> List[int]:
    nm, ne = fmt.nm, fmt.ne
    sx, ex, Mx = _unpack(b, fmt, x)
    sy, ey, My = _unpack(b, fmt, y)

    # --- exponent difference and conditional swap (Alg 4.2 lines 1-4)
    de, _ = sub(b, ext(b, ex, ne + 1), ext(b, ey, ne + 1))
    swap = de[ne]                                  # 1 iff ey > ex
    e_big = b.vec_mux(swap, ey, ex)
    M_big = b.vec_mux(swap, My, Mx)
    M_small = b.vec_mux(swap, Mx, My)
    s_big = b.mux(swap, sy, sx)

    # --- |de|, clamped to the exact-alignment bound nm+4 (any larger shift
    #     lands entirely in the sticky region)
    t, _ = abs_val(b, de)
    tc = clamp_unsigned(b, t, nm + 4)
    b.free(t)

    # --- alignment (Alg 4.2 line 5): wide register keeps every shifted-out
    #     bit so G/R/S are exact.  X = M_small << (nm+4), width 2nm+5.
    V = nm + 4                                     # [1.m | G R S] register
    X = [b.const(0)] * (nm + 4) + M_small
    Y = var_shift_right(b, X, tc)
    A = Y[nm + 1:]                                 # aligned small operand
    tail = b.or_reduce(Y[: nm + 1])                # bits below S -> sticky
    A = [b.or_(A[0], tail)] + A[1:]
    b.free(tail)
    B = [b.const(0)] * 3 + M_big                   # big operand, GRS zero

    # --- add / effective-subtract (Alg 4.2 line 6), two's complement
    if signed:
        eop = b.xor(sx, sy)
        neop = b.not_(eop)
        Axor = [b.xor(ai, eop) for ai in A]
        R, (cout, ncout) = ripple_add(b, B + [b.const(0)], Axor + [eop],
                                      cin=(eop, neop))
        b.free(Axor + [cout, ncout, neop])
        neg = b.and_(R[V], eop)
        Rx = [b.xor(ri, neg) for ri in R]
        Rn = add_bit(b, Rx, neg)
        b.free(Rx + list(R))
    else:
        Rn, (cout, ncout) = ripple_add(b, B + [b.const(0)], A + [b.const(0)])
        b.free([cout, ncout])
        neg = b.const(0)

    if signed:
        # --- variable normalization (Alg 4.3) covers every case uniformly:
        #     lz=0 (carry-out), lz=1 (aligned), lz>1 (cancellation)
        Z, lz = var_normalize(b, Rn)
        field = Z[4: V + 1]
        rnd = Z[3]
        sticky = b.or_reduce(Z[:3])
        m_stored, cr = _round_rne(b, field, rnd, sticky)
        # e_out = e_big + 1 + cr - lz
        e1 = add_bit(b, ext(b, e_big, ne + 2), cr)
        e2, _ = sub(b, e1, ext(b, lz, ne + 2))
        e3 = add_bit(b, e2, b.const(1), nbit=b.const(0))
        b.free(e1 + e2)
        nz = b.or_reduce(Z)
        s_out = b.and_(b.xor(s_big, neg), nz)
    else:
        # --- single-bit normalization via Alg 4.1 with Nt=1 (carry bit)
        ovf = Rn[V]
        novf = b.not_(ovf)
        Z = [b.muxn(ovf, novf, b.or_(Rn[1], Rn[0]), Rn[0])]
        Z += [b.muxn(ovf, novf, Rn[i + 1], Rn[i]) for i in range(1, V)]
        b.free(novf)
        field = Z[3:V]
        rnd = Z[2]
        sticky = b.or_reduce(Z[:2])
        m_stored, cr = _round_rne(b, field, rnd, sticky)
        e1 = add_bit(b, ext(b, e_big, ne + 2), ovf)
        e3 = add_bit(b, e1, cr)
        b.free(e1)
        nz = b.or_reduce(Z)
        s_out = b.and_(s_big, nz)

    e_out = _mask_zero(b, nz, e3[:ne])
    m_out = _mask_zero(b, nz, m_stored)
    return m_out + e_out + [s_out]


# --------------------------------------------------------------------------
# §4.6: floating-point multiplication / division
# --------------------------------------------------------------------------

def fp_mul(b: Builder, fmt: FloatFormat, x: List[int], y: List[int],
           karatsuba: bool = True) -> List[int]:
    nm, ne = fmt.nm, fmt.ne
    sx, ex, Mx = _unpack(b, fmt, x)
    sy, ey, My = _unpack(b, fmt, y)

    from .bitserial import mul_shift_add
    P = (mul_karatsuba(b, Mx, My) if karatsuba else mul_shift_add(b, Mx, My))
    ovf = P[2 * nm + 1]                       # product in [2,4)
    # 1-bit normalization (var shift with Nt=1): align MSB to top
    Ps = b.vec_mux(ovf, P, [b.const(0)] + P[:-1])
    field = Ps[nm + 1:]
    rnd = Ps[nm]
    sticky = b.or_reduce(Ps[:nm])
    m_stored, cr = _round_rne(b, field, rnd, sticky)

    # e = ex + ey - bias + ovf + cr
    e1, (c1, nc1) = ripple_add(b, ext(b, ex, ne + 2), ext(b, ey, ne + 2))
    b.free([c1, nc1])
    e2 = add_bit(b, e1, ovf)
    e3 = add_bit(b, e2, cr)
    e4, _ = sub(b, e3, b.vec_const(fmt.bias, ne + 2))
    b.free(e1 + e2 + e3)

    nz = b.and_(Mx[-1], My[-1])               # zero iff an input is zero
    s_out = b.and_(b.xor(sx, sy), nz)
    return _mask_zero(b, nz, m_stored) + _mask_zero(b, nz, e4[:ne]) + [s_out]


def fp_div(b: Builder, fmt: FloatFormat, x: List[int], y: List[int]
           ) -> List[int]:
    nm, ne = fmt.nm, fmt.ne
    sx, ex, Mx = _unpack(b, fmt, x)
    sy, ey, My = _unpack(b, fmt, y)

    _, ge = sub(b, Mx, My)
    lt = b.not_(ge)                            # 1 iff Mx < My (ratio < 1)
    z0 = b.const(0)
    cand0 = [z0] * (nm + 1) + Mx + [z0] * 2    # Mx << (nm+1)
    cand1 = [z0] * (nm + 2) + Mx + [z0]        # Mx << (nm+2)
    D = b.vec_mux(lt, cand1, cand0)            # width 2nm+4 = 2(nm+2)
    q, r = divide(b, D, My + [z0])             # N' = nm+2
    sticky = b.or_reduce(r)
    field = q[1:]
    rnd = q[0]
    m_stored, cr = _round_rne(b, field, rnd, sticky)

    # e = ex - ey + bias - lt + cr
    e1, _ = sub(b, ext(b, ex, ne + 2), ext(b, ey, ne + 2))
    e2, (c2, nc2) = ripple_add(b, e1, b.vec_const(fmt.bias, ne + 2))
    b.free([c2, nc2])
    e3, _ = sub(b, e2, ext(b, [lt], ne + 2))
    e4 = add_bit(b, e3, cr)
    b.free(e1 + e2 + e3)

    nz = Mx[-1]                                # x == 0 -> result 0
    s_out = b.and_(b.xor(sx, sy), nz)
    return _mask_zero(b, nz, m_stored) + _mask_zero(b, nz, e4[:ne]) + [s_out]


# --------------------------------------------------------------------------
# packaged programs
# --------------------------------------------------------------------------

@memoize_build
def build_var_shift(nx: int, nt: int, left: bool = False) -> Program:
    b = Builder()
    x = b.input("x", nx)
    t = b.input("t", nt)
    fn = var_shift_left if left else var_shift_right
    z, _ = fn(b, x, t, handle_overflow=True)
    b.output("z", z)
    return b.finish()


@memoize_build
def build_var_normalize(nx: int) -> Program:
    b = Builder()
    x = b.input("x", nx)
    z, t = var_normalize(b, x)
    b.output("z", z)
    b.output("t", t)
    return b.finish()


def _build_fp2(fn, fmt: FloatFormat, **kw) -> Program:
    b = Builder()
    x = b.input("x", fmt.nbits)
    y = b.input("y", fmt.nbits)
    z = fn(b, fmt, x, y, **kw)
    b.output("z", z)
    return b.finish()


@memoize_build
def build_fp_add(fmt: FloatFormat, signed: bool = True) -> Program:
    return _build_fp2(fp_add, fmt, signed=signed)


@memoize_build
def build_fp_mul(fmt: FloatFormat, karatsuba: bool = True) -> Program:
    return _build_fp2(fp_mul, fmt, karatsuba=karatsuba)


@memoize_build
def build_fp_div(fmt: FloatFormat) -> Program:
    return _build_fp2(fp_div, fmt)


@memoize_build
def build_fp_sub(fmt: FloatFormat) -> Program:
    """x - y == x + (-y): flip y's sign bit then signed add (paper §4.5)."""
    b = Builder()
    x = b.input("x", fmt.nbits)
    y = b.input("y", fmt.nbits)
    yneg = y[:-1] + [b.not_(y[-1])]
    z = fp_add(b, fmt, x, yneg, signed=True)
    b.output("z", z)
    return b.finish()
