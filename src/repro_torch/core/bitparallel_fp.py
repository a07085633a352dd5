"""Bit-parallel element-parallel floating-point arithmetic (paper §6).

Merges §4 (bit-serial FP) with §5 (bit-parallel fixed point): the same
exactly-rounded FP skeletons with every sub-routine swapped for its
partition-parallel counterpart:

  * :func:`bp_var_shift_right` -- Algorithm 6.1: generalized shift technique
    (2^j + 1 cycles) + broadcast of t_j + a parallel 1-bit multiplexer per
    partition; O(Nx + log^2 Nx) cycles.
  * :func:`bp_var_normalize` -- adds the reduction technique for
    t_j = NOR(top 2^j bits).
  * :func:`bp_fp_add` / :func:`bp_fp_mul` / :func:`bp_fp_div`.

Floats are stored strided (bit i in partition i, paper §6); internal wide
registers use k >= 2nm+5 partitions (k > N is trivially supported, paper
fn. 9).  Slot-relocation moves (pshift) keep interacting registers
partition-co-located; their cycle cost is charged honestly.  Results remain
exactly IEEE-754 RNE.
"""

from __future__ import annotations

from typing import List, Tuple

from .bitparallel import bp_add, bp_div, bp_mul, bp_sub
from .floatfmt import FloatFormat
from .gates import Program, memoize_build
from .partitions import PartitionedBuilder, broadcast, pshift, reduce_tree


def _clog2(n: int) -> int:
    return max(1, (n - 1).bit_length())


# --------------------------------------------------------------------------
# parallel vector helpers
# --------------------------------------------------------------------------

def bp_vec_mux(pb, sel, a, b):
    """per-slot (a if sel else b); sel broadcast once, then 2 cycles."""
    bb = broadcast(pb, sel)
    parts = [pb.part(c) for c in a]
    with pb.cycle():
        ns = [pb.not_(bb[p], p_out=p) for p in parts]
    with pb.cycle():
        out = [pb.muxn_(bb[parts[i]], ns[i], a[i], b[i], p_out=parts[i])
               for i in range(len(a))]
    pb.pfree(ns + list(set(bb)))
    return out


def bp_bit_op(pb, op, bits, sel):
    """per-slot op(bit, sel) with sel broadcast (op in {and, or, xor})."""
    fn = {"and": pb.and_, "or": pb.or_, "xor": pb.xor_}[op]
    bb = broadcast(pb, sel)
    parts = [pb.part(c) for c in bits]
    with pb.cycle():
        out = [fn(bits[i], bb[parts[i]], p_out=parts[i])
               for i in range(len(bits))]
    pb.pfree(list(set(bb)))
    return out


def bp_add_bit(pb, v, bit) -> Tuple[List[int], int]:
    """v + bit via the prefix adder; returns (sum, carry-out)."""
    zeros = [pb.const(0, pb.part(c)) for c in v]
    return bp_add(pb, v, zeros, cin=bit)


def bp_abs(pb, v) -> Tuple[List[int], int]:
    s = v[-1]
    x = bp_bit_op(pb, "xor", v, s)
    out, _ = bp_add_bit(pb, x, s)
    pb.pfree(x)
    return out, s


def bp_clamp(pb, t, tmax: int) -> List[int]:
    cvec = [pb.const((tmax >> i) & 1, pb.part(c)) for i, c in enumerate(t)]
    _, ge = bp_sub(pb, t, cvec)
    return bp_vec_mux(pb, ge, cvec, t)


def _move(pb, cell, p):
    return cell if pb.part(cell) == p else pb.id_(cell, p_out=p)


def relocate(pb, reg, delta):
    """Move a contiguous register's bits by ``delta`` partitions (+ = up),
    preserving length.  |delta|+1 cycles (generalized shift technique)."""
    if delta == 0:
        return list(reg)
    base = pb.part(reg[0])
    n = len(reg)
    if delta > 0:
        top = pb.part(reg[-1])
        padded = list(reg) + [pb.const(0, top + 1 + i) for i in range(delta)]
        return pshift(pb, padded, +delta, fill=None)[delta:]
    d = -delta
    padded = [pb.const(0, base - d + i) for i in range(d)] + list(reg)
    return pshift(pb, padded, delta, fill=None)[:n]


def _econst(pb, val, slots):
    return [pb.const((val >> i) & 1, pb.part(c)) for i, c in enumerate(slots)]


# --------------------------------------------------------------------------
# Algorithm 6.1 (+ normalization)
# --------------------------------------------------------------------------

def bp_var_shift_right(pb, x, t):
    nx = len(x)
    lg = _clog2(nx)
    z = list(x)
    for j in range(min(len(t), lg)):
        zs = pshift(pb, z, -(1 << j), fill=0)     # generalized shift
        bb = broadcast(pb, t[j])                  # t_j to all partitions
        parts = [pb.part(c) for c in z]
        with pb.cycle():
            ns = [pb.not_(bb[p], p_out=p) for p in parts]
        oldz = z
        with pb.cycle():
            z = [pb.muxn_(bb[parts[i]], ns[i], zs[i], z[i], p_out=parts[i])
                 for i in range(nx)]
        pb.pfree(ns + zs + [c for c in oldz if c not in x] + list(set(bb)))
    return z


def bp_var_normalize(pb, x):
    """z = x << lz(x); also returns the lz bits (partition of computation).
    t_j = NOR of the top 2^j slots via the reduction technique."""
    nx = len(x)
    lg = _clog2(nx)
    z = list(x)
    tbits = [None] * lg
    for j in reversed(range(lg)):
        step = 1 << j
        window = z[nx - step:]
        red = reduce_tree(pb, list(window), "or") if len(window) > 1 \
            else pb.id_(window[0], p_out=pb.part(window[0]))
        tj = pb.not_(red, p_out=pb.part(red))
        pb.pfree(red)
        zs = pshift(pb, z, +step, fill=0)
        bb = broadcast(pb, tj)
        parts = [pb.part(c) for c in z]
        with pb.cycle():
            ns = [pb.not_(bb[p], p_out=p) for p in parts]
        oldz = z
        with pb.cycle():
            z = [pb.muxn_(bb[parts[i]], ns[i], zs[i], z[i], p_out=parts[i])
                 for i in range(nx)]
        pb.pfree(ns + zs + [c for c in oldz if c not in x] + list(set(bb)))
        tbits[j] = tj
    return z, tbits


# --------------------------------------------------------------------------
# floating-point helpers
# --------------------------------------------------------------------------

def _bp_unpack(pb, fmt: FloatFormat, v):
    nm, ne = fmt.nm, fmt.ne
    m, e, s = v[:nm], v[nm:nm + ne], v[nm + ne]
    hid = reduce_tree(pb, list(e), "or")          # nonzero exponent
    hid = _move(pb, hid, nm)                      # hidden bit at slot nm
    return s, e, m + [hid]


def _bp_round_rne(pb, field, rnd, sticky) -> Tuple[List[int], int]:
    """RNE increment; returns (stored mantissa bits, exponent carry)."""
    p0 = pb.part(field[0])
    sticky = _move(pb, sticky, p0)
    rnd = _move(pb, rnd, p0)
    t = pb.or_(sticky, field[0], p_out=p0)
    up = pb.and_(rnd, t, p_out=p0)
    pb.pfree(t)
    inc, cr = bp_add_bit(pb, field, up)
    return inc[: len(field) - 1], cr


def _bp_mask(pb, nz, bits):
    return bp_bit_op(pb, "and", bits, nz)


# --------------------------------------------------------------------------
# bit-parallel FP add / mul / div
# --------------------------------------------------------------------------

def bp_fp_add(pb, fmt: FloatFormat, x, y) -> List[int]:
    """Signed bit-parallel FP addition: Alg 4.2/§4.5 skeleton over the §5
    toolbox + Alg 6.1 shift/normalize."""
    nm, ne = fmt.nm, fmt.ne
    sx, ex, Mx = _bp_unpack(pb, fmt, x)
    sy, ey, My = _bp_unpack(pb, fmt, y)
    V = nm + 4
    etop = nm + ne  # exponent slots nm..nm+ne-1; extensions at nm+ne, +1

    # exponent difference + conditional swap
    de, _ = bp_sub(pb, ex + [pb.const(0, etop)], ey + [pb.const(0, etop)])
    swap = de[ne]
    e_big = bp_vec_mux(pb, swap, ey, ex)
    M_big = bp_vec_mux(pb, swap, My, Mx)
    M_small = bp_vec_mux(pb, swap, Mx, My)
    nswap = pb.not_(swap, p_out=pb.part(swap))
    s_big = pb.muxn_(swap, nswap, sy, sx, p_out=pb.part(sx))
    pb.pfree(nswap)

    # |de| clamped to nm+4 (larger shifts land entirely in the sticky tail)
    tmag, _ = bp_abs(pb, de)
    tc = bp_clamp(pb, tmag, nm + 4)
    pb.pfree(tmag + de)

    # alignment: place M_small at slots nm+4..2nm+4 of a 2nm+5-slot register
    # (keeps every shifted-out bit), variable-shift right by t, then pull the
    # V-slot window back down so it is co-located with the big operand.
    wide = M_small + [pb.const(0, nm + 1 + i) for i in range(nm + 4)]
    up = pshift(pb, wide, +(nm + 4), fill=0)
    Y = bp_var_shift_right(pb, up, tc)
    tail = reduce_tree(pb, Y[: nm + 1], "or")     # bits below S -> sticky
    A = pshift(pb, Y, -(nm + 1), fill=None)[: V]  # window to slots 0..V-1
    tail = _move(pb, tail, pb.part(A[0]))
    A[0] = pb.or_(A[0], tail, p_out=pb.part(A[0]))
    pb.pfree([tail] + Y + up)
    # big operand: [1.m | G R S] -> mantissa relocated up 3 slots
    Bm = pshift(pb, M_big + [pb.const(0, nm + 1 + i) for i in range(3)],
                +3, fill=None)
    B = [pb.const(0, j) for j in range(3)] + Bm[3:]

    # effective add/subtract over V+1 slots (two's complement)
    eop = pb.xor_(sx, sy, p_out=pb.part(sx))
    Ax = bp_bit_op(pb, "xor", A + [pb.const(0, V)], eop)
    R, _ = bp_add(pb, B + [pb.const(0, V)], Ax, cin=eop)
    eV = _move(pb, eop, pb.part(R[V]))
    neg = pb.and_(R[V], eV, p_out=pb.part(R[V]))
    Rx = bp_bit_op(pb, "xor", R, neg)
    Rn, _ = bp_add_bit(pb, Rx, neg)
    pb.pfree(Rx + R + Ax + [eV] + A)

    # uniform normalization: lz=0 carry-out, lz=1 aligned, lz>1 cancellation
    Z, lz = bp_var_normalize(pb, Rn)
    pb.pfree(Rn)
    field = Z[4: V + 1]
    rnd = Z[3]
    sticky = reduce_tree(pb, Z[:3], "or")
    m_hi, cr = _bp_round_rne(pb, field, rnd, sticky)
    m_stored = relocate(pb, m_hi, -4)               # canonical slots 0..nm-1

    # e_out = e_big + 1 + cr - lz   (exponent slots)
    eslots = e_big + [pb.const(0, etop), pb.const(0, etop + 1)]
    lzs = [_move(pb, t, nm + i) for i, t in enumerate(lz)]
    lze = lzs + [pb.const(0, pb.part(c)) for c in eslots[len(lzs):]]
    e1, _ = bp_add(pb, eslots, _econst(pb, 1, eslots), cin=cr)
    e2, _ = bp_sub(pb, e1, lze)
    pb.pfree(e1)

    nz = reduce_tree(pb, list(Z), "or")
    nzs = _move(pb, nz, pb.part(s_big))
    negs = _move(pb, neg, pb.part(s_big))
    sg = pb.xor_(s_big, negs, p_out=pb.part(s_big))
    s_out = pb.and_(sg, nzs, p_out=pb.part(s_big))
    m_out = _bp_mask(pb, nz, m_stored)
    e_out = _bp_mask(pb, nz, e2[:ne])
    return m_out + e_out + [s_out]


def bp_fp_mul(pb, fmt: FloatFormat, x, y) -> List[int]:
    nm, ne = fmt.nm, fmt.ne
    sx, ex, Mx = _bp_unpack(pb, fmt, x)
    sy, ey, My = _bp_unpack(pb, fmt, y)
    n = nm + 1

    w, zlo = bp_mul(pb, Mx, My)                 # (w|zlo), both at slots 0..n-1
    wr = pshift(pb, w + [pb.const(0, n + i) for i in range(n)], +n, fill=None)
    P = zlo + wr[n:]                            # 2n slots, partitions 0..2n-1
    pb.pfree(w)
    ovf = P[2 * nm + 1]
    Ps = bp_vec_mux(pb, ovf, P, pshift(pb, P, +1, fill=0))
    field = Ps[nm + 1:]
    rnd = Ps[nm]
    sticky = reduce_tree(pb, Ps[:nm], "or")
    m_hi, cr = _bp_round_rne(pb, field, rnd, sticky)
    m_stored = relocate(pb, m_hi, -(nm + 1))        # to slots 0..nm-1

    # e = ex + ey - bias + ovf + cr
    eslots = [pb.const(0, nm + ne), pb.const(0, nm + ne + 1)]
    ovfe = _move(pb, ovf, nm)
    e1, _ = bp_add(pb, ex + eslots[:1] + eslots[1:],
                   ey + [pb.const(0, nm + ne), pb.const(0, nm + ne + 1)],
                   cin=ovfe)
    e2, _ = bp_add_bit(pb, e1, cr)
    e3, _ = bp_sub(pb, e2, _econst(pb, fmt.bias, e2))
    pb.pfree(e1 + e2)

    hx, hy = Mx[-1], My[-1]
    hye = _move(pb, hy, pb.part(hx))
    nz = pb.and_(hx, hye, p_out=pb.part(hx))
    sye = _move(pb, sy, pb.part(sx))
    sg = pb.xor_(sx, sye, p_out=pb.part(sx))
    nzs = _move(pb, nz, pb.part(sg))
    s_out = pb.and_(sg, nzs, p_out=pb.part(sg))
    return _bp_mask(pb, nz, m_stored) + _bp_mask(pb, nz, e3[:ne]) + [s_out]


def bp_fp_div(pb, fmt: FloatFormat, x, y) -> List[int]:
    nm, ne = fmt.nm, fmt.ne
    sx, ex, Mx = _bp_unpack(pb, fmt, x)
    sy, ey, My = _bp_unpack(pb, fmt, y)
    npr = nm + 2                                  # divider width N'

    _, ge = bp_sub(pb, Mx, My)
    lt = pb.not_(ge, p_out=pb.part(ge))
    # dividend D = Mx << (nm+1+lt) as (z_lo | z_hi), N' bits each:
    #   lt=0: z_hi[j-1]=Mx[j] (shift down 1), z_lo[nm+1]=Mx[0]
    #   lt=1: z_hi[j]  =Mx[j],                z_lo = 0
    mx_dn = pshift(pb, Mx + [pb.const(0, nm + 1)], -1, fill=0)
    cand1 = Mx + [pb.const(0, nm + 1)]
    z_hi = bp_vec_mux(pb, lt, cand1, mx_dn)
    nlt = pb.not_(lt, p_out=pb.part(lt))
    mx0 = _move(pb, Mx[0], nm + 1)
    nlt1 = _move(pb, nlt, nm + 1)
    z_top = pb.and_(mx0, nlt1, p_out=nm + 1)
    z_lo = [pb.const(0, j) for j in range(nm + 1)] + [z_top]
    q, r = bp_div(pb, z_lo + z_hi, My + [pb.const(0, nm + 1)])

    sticky = reduce_tree(pb, r, "or")
    field = q[1:]                                  # slots 1..nm+1
    rnd = q[0]
    m_hi, cr = _bp_round_rne(pb, field, rnd, sticky)
    m_stored = relocate(pb, m_hi, -1)

    # e = ex - ey + bias - lt + cr
    ez = lambda: [pb.const(0, nm + ne), pb.const(0, nm + ne + 1)]
    e1, _ = bp_sub(pb, ex + ez(), ey + ez())
    e2, _ = bp_add(pb, e1, _econst(pb, fmt.bias, e1), cin=cr)
    lte = [_move(pb, lt, nm)] + [pb.const(0, pb.part(c)) for c in e2[1:]]
    e3, _ = bp_sub(pb, e2, lte)
    pb.pfree(e1 + e2)

    nz = Mx[-1]
    sye = _move(pb, sy, pb.part(sx))
    sg = pb.xor_(sx, sye, p_out=pb.part(sx))
    nzs = _move(pb, nz, pb.part(sg))
    s_out = pb.and_(sg, nzs, p_out=pb.part(sg))
    return _bp_mask(pb, nz, m_stored) + _bp_mask(pb, nz, e3[:ne]) + [s_out]


# --------------------------------------------------------------------------
# packaged programs
# --------------------------------------------------------------------------

def _k_for(fmt: FloatFormat, op: str) -> int:
    if op == "add":
        return 2 * fmt.nm + 5
    if op == "mul":
        return max(2 * fmt.nm + 2, fmt.nm + fmt.ne + 2)
    return max(fmt.nm + 4 + 2, fmt.nm + fmt.ne + 2)   # div: k >= N'+2


@memoize_build
def build_bp_var_shift(nx: int, nt: int, cpk: int = 128) -> Program:
    pb = PartitionedBuilder(nx, cpk)
    x = pb.input("x", range(nx))
    t = pb.input("t", range(min(nt, nx)))
    z = bp_var_shift_right(pb, x, t)
    pb.output("z", z)
    return pb.finish()


@memoize_build
def build_bp_var_normalize(nx: int, cpk: int = 128) -> Program:
    pb = PartitionedBuilder(nx, cpk)
    x = pb.input("x", range(nx))
    z, t = bp_var_normalize(pb, x)
    pb.output("z", z)
    pb.output("t", t)
    return pb.finish()


def _build_bp_fp(fn, fmt: FloatFormat, op: str, cpk: int) -> Program:
    pb = PartitionedBuilder(_k_for(fmt, op), cpk)
    x = pb.input("x", range(fmt.nbits))
    y = pb.input("y", range(fmt.nbits))
    z = fn(pb, fmt, x, y)
    pb.output("z", z)
    return pb.finish()


@memoize_build
def build_bp_fp_add(fmt: FloatFormat, cpk: int = 256) -> Program:
    return _build_bp_fp(bp_fp_add, fmt, "add", cpk)


@memoize_build
def build_bp_fp_mul(fmt: FloatFormat, cpk: int = 384) -> Program:
    return _build_bp_fp(bp_fp_mul, fmt, "mul", cpk)


@memoize_build
def build_bp_fp_div(fmt: FloatFormat, cpk: int = 512) -> Program:
    return _build_bp_fp(bp_fp_div, fmt, "div", cpk)
