"""Bit-serial element-parallel fixed-point arithmetic (paper §3).

All routines take a :class:`~repro_torch.core.gates.Builder` plus little-endian cell
vectors and append pure data-flow gate sequences -- no reads, no branches --
exactly as the abstract model requires (every row executes the same program).

  * :func:`ripple_add`      -- Algorithm 3.1 (state of the art, FACC chain)
  * :func:`negate` / :func:`sub`
  * :func:`mul_shift_add`   -- Algorithm 3.2 base case (Haj-Ali et al.)
  * :func:`mul_karatsuba`   -- Algorithm 3.2 (proposed; crossover N≈20)
  * :func:`divide`          -- Algorithm 3.4 (proposed non-restoring divider)

Top-level ``build_*`` functions wrap each routine into a named-port
:class:`Program` for the simulator / Pallas executor.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

from .gates import Builder, G, Program, memoize_build

KARATSUBA_THRESHOLD = 20  # paper fn. 3


# --------------------------------------------------------------------------
# addition / subtraction (Alg 3.1)
# --------------------------------------------------------------------------

def ripple_add(b: Builder, x: List[int], y: List[int],
               cin: Optional[Tuple[int, int]] = None,
               ) -> Tuple[List[int], Tuple[int, int]]:
    """z = x + y (+ cin).  Returns (sum bits, (carry, ~carry)).

    Maintains both the carry and its complement through the FACC chain --
    the paper's noted optimization of storing carry and NOT-carry.
    ``cin`` is an optional (c, ~c) cell pair.
    """
    assert len(x) == len(y)
    if cin is None:
        c, nc = b.const(0), b.const(1)
    else:
        c, nc = cin
    z = []
    for xi, yi in zip(x, y):
        s, c, nc = b.facc(xi, yi, c, nc)
        z.append(s)
    return z, (c, nc)


def add_into(b: Builder, z: List[int], addend: List[int], offset: int = 0,
             drop_carry: bool = False) -> Optional[int]:
    """z[offset:] += addend, rippling the carry through the remaining high
    bits of ``z`` (half-adder tail).  Rebinds cells inside ``z`` in place.
    Returns the final carry cell (or None when ``drop_carry``)."""
    c, nc = b.const(0), b.const(1)
    n = len(addend)
    assert offset + n <= len(z)
    for j in range(n):
        i = offset + j
        s, c, nc = b.facc(z[i], addend[j], c, nc)
        b.free(z[i])
        z[i] = s
    # propagate carry through remaining bits: half-adder = XOR + AND
    for i in range(offset + n, len(z)):
        s = b.xor(z[i], c)
        c2 = b.and_(z[i], c)
        nc2 = b.not_(c2)
        b.free([z[i], c, nc])
        z[i], c, nc = s, c2, nc2
    if drop_carry:
        b.free([c, nc])
        return None
    b.free(nc)
    return c


def negate(b: Builder, x: List[int]) -> List[int]:
    """two's-complement -x over len(x) bits."""
    nx = b.vec_not(x)
    z, (c, nc) = ripple_add(b, nx, b.vec_const(1, len(x)))
    b.free(nx + [c, nc])
    return z


def sub(b: Builder, x: List[int], y: List[int]) -> Tuple[List[int], int]:
    """z = x - y over N bits; returns (z, borrow') where borrow'=1 iff x>=y."""
    ny = b.vec_not(y)
    z, (c, nc) = ripple_add(b, x, ny, cin=(b.const(1), b.const(0)))
    b.free(ny + [nc])
    return z, c


# --------------------------------------------------------------------------
# multiplication (Alg 3.2)
# --------------------------------------------------------------------------

def mul_shift_add(b: Builder, x: List[int], y: List[int]) -> List[int]:
    """2N-bit product via shift-and-add [Haj-Ali et al.]; the shift is
    *simulated* by indexing (no gates), only an N-bit adder per iteration."""
    n = len(x)
    assert len(y) == n
    z = b.vec_const(0, 2 * n)
    for i in range(n):
        p = b.vec_and_bit(x, y[i])                      # partial product
        # z_{i:i+N+1} <- z_{i:i+N} + p  (carry lands in z_{i+N}, known zero)
        c, nc = b.const(0), b.const(1)
        for j in range(n):
            s, c, nc = b.facc(z[i + j], p[j], c, nc)
            b.free([z[i + j], p[j]])
            z[i + j] = s
        b.free(z[i + n])
        z[i + n] = c
        b.free(nc)
    return z


def _split(x: List[int], h: int):
    return x[:h], x[h:]


def mul_karatsuba(b: Builder, x: List[int], y: List[int],
                  thresh: int = KARATSUBA_THRESHOLD) -> List[int]:
    """Algorithm 3.2: Karatsuba recursion over the bit-serial substrate.

    Unique PIM consideration (paper §3.2): latency is *total gate count*, and
    bit-level indexed access is free, so the crossover drops from thousands of
    digits to N≈20.
    """
    n = len(x)
    assert len(y) == n
    if n <= thresh or n < 4:
        return mul_shift_add(b, x, y)
    orig_n = n
    if n % 2:  # pad to even width with a zero MSB
        z0 = b.const(0)
        x = x + [z0]
        y = y + [z0]
        n += 1
    h = n // 2
    x0, x1 = _split(x, h)
    y0, y1 = _split(y, h)

    # t1' = (x0+x1)(y0+y1), computed first so its operand cells can be reused
    # (paper fn. 2).
    sx, (cx, ncx) = ripple_add(b, x0, x1)
    sy, (cy, ncy) = ripple_add(b, y0, y1)
    b.free([ncx, ncy])
    t1p = mul_karatsuba(b, sx + [cx], sy + [cy], thresh)   # 2(h+1) bits
    b.free(sx + sy + [cx, cy])

    t0 = mul_karatsuba(b, x0, y0, thresh)                  # n bits
    t2 = mul_karatsuba(b, x1, y1, thresh)                  # n bits

    # t1 = t1' - t0 - t2  (fits in n+1 bits; compute over len(t1p) bits)
    w = len(t1p)
    t0e = t0 + [b.const(0)] * (w - len(t0))
    t2e = t2 + [b.const(0)] * (w - len(t2))
    d1, bo1 = sub(b, t1p, t0e)
    b.free(t1p + [bo1])
    t1, bo2 = sub(b, d1, t2e)
    b.free(d1 + [bo2])

    # z = (t2|t0); z_{h:2n} += t1  (carry bounded: product < 2^{2n})
    z = t0 + t2
    add_into(b, z, t1[: n + 1], offset=h, drop_carry=True)
    b.free(t1)
    return z[: 2 * orig_n]  # top pad bits (if any) are provably zero


# --------------------------------------------------------------------------
# division (Alg 3.4)
# --------------------------------------------------------------------------

def divide(b: Builder, z: List[int], d: List[int]
           ) -> Tuple[List[int], List[int]]:
    """Non-restoring 2N/N division (proposed, paper §3.3).

    Inputs: 2N-bit dividend ``z``, N-bit divisor ``d``; outputs N-bit
    quotient ``q`` and remainder ``r`` with z = q*d + r, 0 <= r < d.
    Precondition (standard for 2N/N dividers): z >> N < d, so q fits N bits.

    All of Alg 3.3's control flow is data flow here: the conditional
    add/sub is XOR(d, q_prev) with carry-in q_prev (two's complement),
    remainder shifts are simulated by indexing, and the final correction
    adds AND(d, sign) (Alg 3.4 line 7).
    """
    n = len(d)
    assert len(z) == 2 * n
    w = n + 2                               # |R| < 2d < 2^{n+1}
    zero = b.const(0)
    R = list(z[n:]) + [zero, zero]          # R = z >> n, zero-extended
    qprev, nqprev = b.const(1), b.const(0)  # first op is a subtraction
    qs = []
    for i in reversed(range(n)):
        # R <- (R << 1) | z_i : simulated shift (index bookkeeping, no gates)
        R = [z[i]] + R[: w - 1]
        # addend = +-d: XOR with q_prev, sign-extended by q_prev cells
        xd = [b.xor(dj, qprev) for dj in d] + [qprev] * (w - n)
        Rn, (c, nc) = ripple_add(b, R, xd, cin=(qprev, nqprev))
        b.free([c, nc] + xd[:n])
        for cell in R:
            if cell not in z and cell != zero:
                b.free(cell)
        R = Rn
        sign = R[w - 1]
        qi = b.not_(sign)
        qs.append(qi)
        qprev, nqprev = qi, sign
    # final correction: r <- R + AND(d, sign)   [sign of R == ~q_0]
    sign = nqprev
    corr = b.vec_and_bit(d, sign) + [zero, zero]
    Rf, (c, nc) = ripple_add(b, R, corr)
    b.free([c, nc] + corr[:n])
    q = list(reversed(qs))
    r = Rf[:n]
    return q, r


# --------------------------------------------------------------------------
# packaged programs
# --------------------------------------------------------------------------

@memoize_build
def build_add(n: int) -> Program:
    b = Builder()
    x = b.input("x", n)
    y = b.input("y", n)
    z, (c, _nc) = ripple_add(b, x, y)
    b.output("z", z + [c])
    return b.finish()


@memoize_build
def build_sub(n: int) -> Program:
    b = Builder()
    x = b.input("x", n)
    y = b.input("y", n)
    z, ge = sub(b, x, y)
    b.output("z", z)
    b.output("ge", [ge])
    return b.finish()


@memoize_build
def build_mul(n: int, karatsuba: bool = True,
              thresh: int = KARATSUBA_THRESHOLD) -> Program:
    b = Builder()
    x = b.input("x", n)
    y = b.input("y", n)
    z = mul_karatsuba(b, x, y, thresh) if karatsuba else mul_shift_add(b, x, y)
    b.output("z", z)
    return b.finish()


@memoize_build
def build_div(n: int) -> Program:
    b = Builder()
    z = b.input("z", 2 * n)
    d = b.input("d", n)
    q, r = divide(b, z, d)
    b.output("q", q)
    b.output("r", r)
    return b.finish()
