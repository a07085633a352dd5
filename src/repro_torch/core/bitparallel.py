"""Bit-parallel element-parallel fixed-point arithmetic (paper §5).

Numbers are stored in *strided* format: bit i of every operand lives in
partition i.  The algorithms:

  * :func:`bp_add` -- Algorithm 5.1, the first bit-parallel in-memory adder:
    parallel-prefix (Brent-Kung via the prefix technique), O(log N) steps.
  * :func:`bp_sub` -- two's complement on top of bp_add.
  * :func:`bp_mul` -- Algorithm 5.2: MultPIM's CSAS loop with the final
    addition replaced by the proposed bp_add (O(N log N + log N)).
  * :func:`bp_div` -- Algorithm 5.3, the first bit-parallel divider:
    carry-save carry-lookahead (CSCL); the remainder stays in carry-save
    form and only its *sign* is resolved per iteration via a (G,A)
    reduction.  O(N log N).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .gates import Program, memoize_build
from .partitions import (PartitionedBuilder, broadcast, prefix_scan, pshift,
                         reduce_pairs, reduce_tree)


# --------------------------------------------------------------------------
# Algorithm 5.1: parallel-prefix addition
# --------------------------------------------------------------------------

def _combine_ga(pb, left, cur, p_out):
    """(g,a) ∘ (g̃,ã) = (g + a·g̃, a·ã)  -- 3 gate-waves."""
    g, a = cur
    gl, al = left
    t = pb.and_(a, gl, p_out=p_out)
    g2 = pb.or_(g, t, p_out=p_out)
    a2 = pb.and_(a, al, p_out=p_out)
    pb.pfree(t)
    return (g2, a2)


def bp_add(pb: PartitionedBuilder, x: List[int], y: List[int],
           cin: Optional[int] = None) -> Tuple[List[int], int]:
    """z = x + y (+ cin); strided operands.  Returns (z bits, carry-out)."""
    n = len(x)
    assert len(y) == n
    parts = [pb.part(c) for c in x]
    with pb.cycle():
        A = [pb.or_(x[i], y[i], p_out=parts[i]) for i in range(n)]
    with pb.cycle():
        Gb = [pb.and_(x[i], y[i], p_out=parts[i]) for i in range(n)]
    if cin is not None:
        # fold the carry-in into bit 0's (g, a)
        if pb.part(cin) != parts[0]:
            cin = pb.id_(cin, p_out=parts[0])
        t = pb.and_(A[0], cin, p_out=parts[0])
        Gb[0] = pb.or_(Gb[0], t, p_out=parts[0])
        pb.pfree(t)
    st = prefix_scan(pb, list(zip(Gb, A)), _combine_ga)
    GG = [s[0] for s in st]
    c = pshift(pb, GG, +1, fill=None)
    c[0] = cin if cin is not None else pb.const(0, parts[0])
    with pb.cycle():
        u = [pb.xor_(x[i], y[i], p_out=parts[i]) for i in range(n)]
    with pb.cycle():
        z = [pb.xor_(u[i], c[i], p_out=parts[i]) for i in range(n)]
    pb.pfree(u + [a for a in A])
    return z, GG[n - 1]


def bp_sub(pb: PartitionedBuilder, x: List[int], y: List[int]
           ) -> Tuple[List[int], int]:
    """z = x - y; returns (z, ge) with ge = 1 iff x >= y."""
    with pb.cycle():
        ny = [pb.not_(y[i], p_out=pb.part(y[i])) for i in range(len(y))]
    one = pb.const(1, 0)
    return bp_add(pb, x, ny, cin=one)


# --------------------------------------------------------------------------
# Algorithm 5.2: CSAS multiplication + proposed final adder
# --------------------------------------------------------------------------

def bp_mul(pb: PartitionedBuilder, x: List[int], y: List[int]
           ) -> Tuple[List[int], List[int]]:
    """(w|z) = x * y; strided.  Lower half z, upper half w."""
    n = len(x)
    s = [pb.const(0, j) for j in range(n)]
    c = [pb.const(0, j) for j in range(n)]
    z = [None] * n
    for i in range(n):
        bb = broadcast(pb, y[i])                       # b_i to all partitions
        with pb.cycle():
            ab = [pb.and_(x[j], bb[j], p_out=j) for j in range(n)]
        olds, oldc = s, c
        with pb.cycle():                               # carry-save addition
            sc = [pb.fa_(s[j], c[j], ab[j], p_out=j) for j in range(n)]
        s = [t[0] for t in sc]
        c = [t[1] for t in sc]
        z[i] = pb.id_(s[0], p_out=i)                   # output LSB
        news = pshift(pb, s, -1, fill=0)               # sum shifts right
        pb.pfree(ab + olds + oldc + s + list(set(bb)))
        s = news
    # final addition (proposed): w = s + c via Alg 5.1 instead of N more
    # CSAS iterations -- O(N) -> O(log N)
    w, _ = bp_add(pb, s, c)
    return w, z


# --------------------------------------------------------------------------
# Algorithm 5.3: CSCL division
# --------------------------------------------------------------------------

def bp_div(pb: PartitionedBuilder, z: List[int], d: List[int]
           ) -> Tuple[List[int], List[int]]:
    """Non-restoring 2N/N division with the remainder in carry-save form.

    Layout: k >= N+2 partitions; z (2N bits) provides z_hi (initial R) and
    z_lo (bits injected per iteration); precondition z >> N < d.
    Per iteration, only the *sign* of R = S + C is resolved, via a
    carry-lookahead reduction (cheaper than a prefix: paper fn. 12).
    """
    n = len(d)
    w = n + 2
    assert pb.k >= w and len(z) == 2 * n
    z_lo, z_hi = z[:n], z[n:]
    s = list(z_hi) + [pb.const(0, n), pb.const(0, n + 1)]
    c = [pb.const(0, j) for j in range(w)]
    qprev = pb.const(1, w - 1)
    qs = [None] * n
    for i in reversed(range(n)):
        bb = broadcast(pb, qprev)
        # conditional +-d: xd = XOR(d, q'); upper bits are the q' copies
        # themselves (sign extension of the two's complement of d)
        with pb.cycle():
            xd = [pb.xor_(d[j], bb[j], p_out=j) for j in range(n)]
        xd += [bb[n], bb[n + 1]]
        # R <- (R << 1) | z_i : shift both s and c up one partition
        olds, oldc = s, c
        s = pshift(pb, s, +1, fill=None)   # top bit drops (|R|<2^{w-1})
        s[0] = pb.id_(z_lo[i], p_out=0)
        c = pshift(pb, c, +1, fill=None)
        c[0] = bb[0]                      # carry-in q' (the +1 of -d)
        pb.pfree(olds + oldc)
        # carry-save add
        with pb.cycle():
            sc = [pb.fa_(s[j], c[j], xd[j], p_out=j) for j in range(w)]
        pb.pfree(s + c + xd[:n] + list(set(bb)))
        s = [t[0] for t in sc]
        carries = [t[1] for t in sc]
        c = pshift(pb, carries, +1, fill=None)  # carry weight realign
        c[0] = pb.const(0, 0)
        pb.pfree(carries)
        # sign of S + C via carry-lookahead *reduction* over bits 0..w-2
        with pb.cycle():
            Gb = [pb.and_(s[j], c[j], p_out=j) for j in range(w - 1)]
        with pb.cycle():
            A = [pb.or_(s[j], c[j], p_out=j) for j in range(w - 1)]
        carry = reduce_pairs(pb, list(zip(Gb, A)), _combine_ga)[0]
        t = pb.xor_(s[w - 1], c[w - 1], p_out=w - 1)
        sign_n = pb.xnor_(t, carry, p_out=w - 1)       # = NOT sign = q_i
        pb.pfree(Gb + A)
        qs[i] = pb.id_(sign_n, p_out=i)                # strided quotient
        qprev = qs[i]
    # final correction: r = S + C + AND(d, ~q_0)
    nq0 = pb.not_(qs[0], p_out=0)
    bb = broadcast(pb, nq0)
    zero_cells = [pb.const(0, j) for j in range(n, w)]
    with pb.cycle():
        m = [pb.and_(d[j], bb[j], p_out=j) for j in range(n)]
    m += zero_cells
    with pb.cycle():
        sc = [pb.fa_(s[j], c[j], m[j], p_out=j) for j in range(w)]
    s = [t[0] for t in sc]
    c = pshift(pb, [t[1] for t in sc], +1, fill=None)
    c[0] = pb.const(0, 0)
    r, _ = bp_add(pb, s, c)
    return qs, r[:n]


# --------------------------------------------------------------------------
# packaged programs
# --------------------------------------------------------------------------

@memoize_build
def build_bp_add(n: int, cpk: int = 128) -> Program:
    pb = PartitionedBuilder(n, cpk)
    x = pb.input("x", range(n))
    y = pb.input("y", range(n))
    z, cout = bp_add(pb, x, y)
    pb.output("z", z + [cout])
    return pb.finish()


@memoize_build
def build_bp_sub(n: int, cpk: int = 128) -> Program:
    pb = PartitionedBuilder(n, cpk)
    x = pb.input("x", range(n))
    y = pb.input("y", range(n))
    z, ge = bp_sub(pb, x, y)
    pb.output("z", z)
    pb.output("ge", [ge])
    return pb.finish()


@memoize_build
def build_bp_mul(n: int, cpk: int = 160) -> Program:
    pb = PartitionedBuilder(n, cpk)
    x = pb.input("x", range(n))
    y = pb.input("y", range(n))
    w, z = bp_mul(pb, x, y)
    pb.output("z", z + w)
    return pb.finish()


@memoize_build
def build_bp_div(n: int, cpk: int = 256) -> Program:
    pb = PartitionedBuilder(n + 2, cpk)
    z = pb.input("z", list(range(n)) + list(range(n)))
    d = pb.input("d", range(n))
    q, r = bp_div(pb, z, d)
    pb.output("q", q)
    pb.output("r", r)
    return pb.finish()
