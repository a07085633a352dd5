"""The PIM arithmetic suite as a numerics backend.

The counterpart of ``repro.core.pim_numerics``: :func:`program_for` maps
(kind, op, width or format) to the memoized ``build_*`` gate program the
ufunc frontend runs, :func:`fused_program_for` stitches an expression
graph into one program, :func:`tree_reduce_rows` sums rows with a
log-depth in-memory adder tree whose packed block stays on the device
between levels, and :class:`PIMVectorUnit` / :func:`pim_linear_i8` expose
the suite as vector ops and an int8 GEMM.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels import transfer
from . import bitparallel, bitparallel_fp, bitserial, bitserial_fp, gates
from .floatfmt import FORMATS


@functools.lru_cache(maxsize=None)
def program_for(kind: str, op: str, width_or_fmt):
    """The memoized ``build_*`` Program for (kind, op, parameterization).

    kind: 'int-serial' | 'int-parallel' | 'fp-serial' | 'fp-parallel';
    width_or_fmt: bit width for int kinds, FORMATS name for fp kinds.
    """
    if kind == "int-serial":
        prog = {
            "add": bitserial.build_add,
            "sub": bitserial.build_sub,
            "mul": bitserial.build_mul,
            "div": bitserial.build_div,
        }[op](width_or_fmt)
    elif kind == "int-parallel":
        prog = {
            "add": bitparallel.build_bp_add,
            "sub": bitparallel.build_bp_sub,
            "mul": bitparallel.build_bp_mul,
            "div": lambda n: bitparallel.build_bp_div(n, cpk=384),
        }[op](width_or_fmt)
    elif kind == "fp-serial":
        prog = {
            "add": bitserial_fp.build_fp_add,
            "sub": bitserial_fp.build_fp_sub,
            "mul": bitserial_fp.build_fp_mul,
            "div": bitserial_fp.build_fp_div,
        }[op](FORMATS[width_or_fmt])
    elif kind == "fp-parallel":
        prog = {
            "add": bitparallel_fp.build_bp_fp_add,
            "mul": bitparallel_fp.build_bp_fp_mul,
            "div": bitparallel_fp.build_bp_fp_div,
        }[op](FORMATS[width_or_fmt])
    else:
        raise ValueError(kind)
    kops.note_provenance(prog, ("program_for", kind, op, width_or_fmt))
    return prog


@gates.memoize_build
def build_identity(n: int):
    """``z <- x``, an ``n``-bit copy program."""
    b = gates.Builder()
    x = b.input("x", n)
    b.output("z", b.vec_id(x))
    return b.finish()


# Output width of a fused int node at operand width ``W`` (both operands
# zero-extended to W): the same conventions as the per-op programs.
_INT_OUT_WIDTH = {"add": lambda w: w + 1, "sub": lambda w: w,
                  "mul": lambda w: 2 * w}

#: Ops the cross-op composer fuses.  Division (data-dependent iteration
#: structure, two result ports) and the bit-parallel builders (partition
#: schedules are per-program artifacts that do not concatenate) run per op.
FUSABLE_OPS = frozenset(_INT_OUT_WIDTH)


@functools.lru_cache(maxsize=None)
def fused_program_for(kind: str, graph: tuple, fmt: str = None):
    """One fused Program for a canonical expression graph (cross-op SSA).

    ``graph`` is a topological tuple of entries: ``("in", name, width)``
    declares a leaf input port (``width`` is ignored for fp kinds -- every
    fp value is an ``fmt`` bit pattern), and ``(op, i, j)`` applies a
    binary op to earlier entries ``i``/``j``.  The last entry is the
    result, exposed as out-port ``"z"``.

    kind: 'int-serial' (operands zero-extend to the wider width; add grows
    one bit, mul doubles, sub wraps) or 'fp-serial' (all values are
    ``fmt`` bit patterns).  The per-op programs are stitched into one
    netlist by :func:`~repro_torch.core.gates.compose`; ``levelize`` then
    value-numbers and removes dead cells across the op boundaries, so
    intermediates never materialize as port unpacks.  Memoized, like
    :func:`program_for`."""
    if kind not in ("int-serial", "fp-serial"):
        raise ValueError(f"unfusable kind {kind!r}")
    is_fp = kind == "fp-serial"
    nbits = FORMATS[fmt].nbits if is_fp else None
    nodes = []
    info = []       # per graph entry: ("ext", name, width) | ("node", idx,
    #                 port, width) -- a compose() binding plus its width
    for e in graph:
        if e[0] == "in":
            _, name, width = e
            info.append(("ext", name, nbits if is_fp else int(width)))
            continue
        op, i, j = e
        if op not in FUSABLE_OPS:
            raise ValueError(f"op {op!r} does not fuse")
        bi, bj = info[i], info[j]
        if is_fp:
            prog = program_for("fp-serial", op, fmt)
            w_out = nbits
        else:
            w = max(bi[-1], bj[-1])
            prog = program_for("int-serial", op, w)
            w_out = _INT_OUT_WIDTH[op](w)
        nodes.append((prog, {"x": bi[:3], "y": bj[:3]}))
        info.append(("node", len(nodes) - 1, "z", w_out))
    last = info[-1]
    if last[0] == "ext":        # bare leaf: route through an identity copy
        nodes.append((build_identity(last[2]), {"x": last}))
        last = ("node", len(nodes) - 1, "z", last[2])
    prog = gates.compose(nodes, {"z": (last[1], last[2])})
    kops.note_provenance(prog, ("fused_program_for", kind, graph, fmt))
    return prog


def fused_out_width(kind: str, graph: tuple, fmt: str = None) -> int:
    """Bit width of the fused graph's ``z`` port (without building it)."""
    if kind == "fp-serial":
        return FORMATS[fmt].nbits
    widths = []
    for e in graph:
        if e[0] == "in":
            widths.append(int(e[2]))
        else:
            op, i, j = e
            widths.append(_INT_OUT_WIDTH[op](max(widths[i], widths[j])))
    return widths[-1]


# ---------------------------------------------------------------------------
# log-depth in-memory tree reduction across the row axis
# ---------------------------------------------------------------------------

def _srl(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 bit patterns by ``0 < k < 32`` (torch's
    ``>>`` on int32 is arithmetic, and would smear row 31 into the top
    ``k`` rows)."""
    return (x >> k) & ((1 << (32 - k)) - 1)


def _halves(block: torch.Tensor, half: int, rpw: int):
    """The two halves of a packed block at span ``2 * half`` rows: rows
    [0, half) and [half, 2 * half), each as a block whose row 0 is its
    first row."""
    if half % rpw == 0:
        hw = half // rpw
        return block[..., :hw], block[..., hw:2 * hw]
    if half % 32 == 0:
        # rows64 split at an odd multiple of 32: the cut lands on the
        # plane boundary inside word m, so the halves re-seam across
        # planes (x keeps plane 0 of word m, y starts at plane 1)
        m = half // 64
        lo, hi = block[0], block[1]
        zw = torch.zeros_like(lo[:, :1])
        x = torch.stack([lo[:, :m + 1], torch.cat([hi[:, :m], zw], dim=1)])
        y = torch.stack([hi[:, m:2 * m + 1],
                         torch.cat([lo[:, m + 1:2 * m + 1], zw], dim=1)])
        return x, y
    return block, _srl(block, half)    # the whole span in one word


def tree_reduce_rows(row_program, inputs: Dict[str, np.ndarray],
                     total_rows: int, group: int, *, kind: str,
                     fmt: str = None, plan=None, fused: bool = True,
                     deadline: float = None) -> np.ndarray:
    """Sum ``row_program``'s per-row ``z`` outputs down the row axis in
    log2(total_rows/group) in-memory adder levels; returns the ``group``
    reduced row values (uint64, or object ints for wide accumulators).

    Row ``r`` belongs to reduction lane ``r % group`` (callers lay out
    GEMV operands as ``r = j*group + m``); lane sums accumulate pairwise:
    level at span R adds rows [0, R/2) to rows [R/2, R).  ``total_rows``
    must be ``group`` times a power of two and ``group`` either a power of
    two (< 32) or a multiple of 32 -- the alignments under which a tree
    level is a word slice (or an in-word bit shift) of the packed block.
    The block stays on the device between levels: one pack on the way in,
    one unpack of the final ``group`` rows on the way out
    (``kernels.ops.dispatch_packed``'s stages, kept on the device).

    kind/``fmt`` select the adder ('int-serial' grows one carry bit per
    level; 'fp-serial' adds ``fmt`` bit patterns under RNE -- the result
    is the *tree order* sum, bit-exact against the same-shaped host tree).
    Zero rows are the padding identity: int adds propagate 0 exactly and
    ``fp_add(x, +0) == x`` / ``fp_mul(+0, +0) == +0`` under RNE.

    ``fused=False`` (or the numpy backend) runs the same pairing through
    per-op ``run_program`` round trips, the bit-identical reference.
    ``deadline`` (absolute ``time.monotonic()``) is checked between
    levels.

    A plan with a fault model or a verify policy runs the tree under
    verified execution, one ``_VerifyRun`` for the whole tree and every
    level a verify cut-point (``stage`` counts the levels).  Under a fault
    model each level's block comes to the host, is injected and checked
    there (the check plane folds the whole block, zero pad rows
    included), and the block that passed is the next level's input, as in
    the reference, whose next level reads that host block; a failed level
    re-runs from its own input block, never from the leaves.  A
    verify-only plan injects and folds nothing, so its blocks stay on the
    device as a plain plan's do."""
    plan = kops.as_plan(plan)
    R = int(total_rows)
    group = int(group)
    spans = R // group
    if group <= 0 or R != group * spans or spans & (spans - 1):
        raise ValueError(
            f"total_rows ({R}) must be group ({group}) x a power of two")
    if group >= 32 and group % 32:
        raise ValueError(f"group {group} must be a power of two or a "
                         "multiple of 32")
    if group < 32 and group & (group - 1):
        raise ValueError(f"group {group} must be a power of two below 32")
    if kind not in ("int-serial", "fp-serial"):
        raise ValueError(f"unreducible kind {kind!r}")
    is_fp = kind == "fp-serial"
    w = len(row_program.ports["z"])

    def adder(width):
        return (program_for("fp-serial", "add", fmt) if is_fp
                else program_for("int-serial", "add", width))

    if not fused or plan.backend.name == "numpy":
        # value-domain reference: same pairing, per-op round trips
        vals = kops.run_program(row_program, inputs, R, plan)["z"]
        while R > group:
            kops._check_deadline(deadline)
            half = R // 2
            out = kops.run_program(adder(w), {"x": vals[:half],
                                              "y": vals[half:R]},
                                   half, plan)
            vals = out["z"]
            if not is_fp:
                w += 1
            R = half
        return vals[:group]

    if set(kops.output_names(row_program)) != {"z"}:
        raise ValueError("tree_reduce_rows needs a row program with the "
                         "single out-port 'z'")
    rpw = 32 * plan.layout.planes
    vrun = kops._VerifyRun(plan) if kops._needs_ft(plan) else None
    on_host = plan.faults is not None
    stage = 0
    with transfer.computing(plan.devices):
        block = kops._packed_stage(row_program, R, plan, inputs=inputs,
                                   vrun=vrun, device_out=not on_host,
                                   deadline=deadline)()
        while R > group:
            kops._check_deadline(deadline)
            half = R // 2
            if on_host:
                block = torch.from_numpy(block.view(np.int32))
            x, y = _halves(block, half, rpw)
            in_block = torch.cat([x, y], dim=-2)
            if on_host:
                in_block = in_block.numpy().view(np.uint32)
            stage += 1
            block = kops._packed_stage(
                adder(w), half, plan, in_names=("x", "y"),
                in_block=in_block, vrun=vrun, stage=stage,
                device_out=not on_host, deadline=deadline)()
            if not is_fp:
                w += 1
            R = half
        if on_host:
            return kops._unpack_sub(block, [("z", w)], group)["z"]
        host = transfer.lane(block.device).download(block)
    return host.result(lambda b: kops._unpack_sub(b, [("z", w)],
                                                  group)["z"])


def reduce_group(n_out: int) -> int:
    """The packed-domain lane count for ``n_out`` reduction outputs: the
    next power of two below 32, a multiple of 32 above (the alignments
    :func:`tree_reduce_rows` accepts)."""
    n = int(n_out)
    if n < 1:
        raise ValueError(f"n_out must be >= 1, got {n}")
    if n >= 32:
        return (n + 31) // 32 * 32
    p = 1
    while p < n:
        p <<= 1
    return p


_NP_FMT = {np.dtype(np.float16): "fp16", np.dtype(np.float32): "fp32"}


class PIMVectorUnit:
    """Elementwise vector arithmetic on the PIM abstract machine: each
    element one memory row, the whole vector one shared gate program.
    ``backend`` is 'cuda' (the kernels), 'ref' (their plain versions) or
    'numpy' (the gate-serial oracle); ``device`` the torch device (the
    plan's default, a CUDA device, when None)."""

    def __init__(self, backend: str = "cuda", parallel: bool = False,
                 device=None):
        self.backend = backend
        self.device = device
        self.mode = "parallel" if parallel else "serial"

    def _run(self, prog, inputs, n):
        return kops.run_program(prog, inputs, n, self.backend,
                                device=self.device)

    # ---------------------------------------------------------------- int
    def _int_op(self, op: str, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        if x.dtype not in (np.uint8, np.uint16, np.uint32, np.uint64):
            raise TypeError(f"PIMVectorUnit.{op} takes unsigned integer or "
                            f"float16/float32 arrays, got {x.dtype}")
        width = x.dtype.itemsize * 8
        prog = program_for(f"int-{self.mode}", op, width)
        n = x.size
        if op == "div":
            out = self._run(prog, {"z": x.ravel().astype(np.uint64),
                                   "d": y.ravel()}, n)
            return (out["q"].astype(x.dtype).reshape(x.shape),
                    out["r"].astype(x.dtype).reshape(x.shape))
        out = self._run(prog, {"x": x.ravel(), "y": y.ravel()}, n)["z"]
        if op == "mul":
            return out.reshape(x.shape)       # double-width product
        return out.astype(np.uint64).reshape(x.shape)

    def add(self, x, y):
        return self._dispatch("add", x, y)

    def sub(self, x, y):
        return self._dispatch("sub", x, y)

    def mul(self, x, y):
        return self._dispatch("mul", x, y)

    def div(self, x, y):
        return self._dispatch("div", x, y)

    # --------------------------------------------------------------- float
    def _fp_op(self, op: str, x: np.ndarray, y: np.ndarray) -> np.ndarray:
        fmt_name = _NP_FMT[x.dtype]
        kind = f"fp-{self.mode}"
        if self.mode == "parallel" and op == "sub":
            # bp sub = bp add with flipped sign bit
            y = (-y).astype(x.dtype)
            op = "add"
        prog = program_for(kind, op, fmt_name)
        out = self._run(prog, {"x": _bits(x), "y": _bits(y)}, x.size)["z"]
        return _from_bits(np.asarray(out, np.uint64), x.dtype, x.shape)

    def _dispatch(self, op, x, y):
        x = np.asarray(x)
        y = np.asarray(y)
        if x.dtype.kind == "f":
            return self._fp_op(op, x, y)
        return self._int_op(op, x, y)


def _bits(x: np.ndarray) -> np.ndarray:
    view = {np.dtype(np.float16): np.uint16,
            np.dtype(np.float32): np.uint32}[x.dtype]
    return x.ravel().view(view).astype(np.uint64)


def _from_bits(bits: np.ndarray, dtype, shape) -> np.ndarray:
    view = {np.dtype(np.float16): np.uint16,
            np.dtype(np.float32): np.uint32}[np.dtype(dtype)]
    return bits.astype(view).view(dtype).reshape(shape)


def pim_linear_i8(unit: PIMVectorUnit, x: np.ndarray, w: np.ndarray
                  ) -> np.ndarray:
    """int8 GEMM on the PIM unit: y[m,n] = sum_k x[m,k] w[k,n].

    Lowered onto the fused reduction tree (:func:`tree_reduce_rows`): each
    output (m, n) is a packed-domain lane, the K products land at rows
    ``j*group + lane``, one element-parallel 16-bit multiply computes all
    M*N*K products at once, and log2(K) in-memory adder levels fold them
    on the device.  Inputs int8 as offset-binary uint16; the 32-bit
    products grow one carry bit per tree level."""
    m, k = x.shape
    k2, n = w.shape
    if k != k2:
        raise ValueError(f"pim_linear_i8: x is {x.shape}, w is {w.shape}")
    xo = (x.astype(np.int32) + 128).astype(np.uint16)   # offset binary
    wo = (w.astype(np.int32) + 128).astype(np.uint16)
    group = reduce_group(m * n)
    kp = 1
    while kp < k:
        kp <<= 1
    xa = np.zeros((kp, group), np.uint64)
    xb = np.zeros((kp, group), np.uint64)
    xa[:k, :m * n] = np.repeat(xo.T, n, axis=1)         # lane m*n + j -> x[m,k]
    xb[:k, :m * n] = np.tile(wo, (1, m))
    acc = tree_reduce_rows(
        program_for("int-serial", "mul", 16),
        {"x": xa.ravel(), "y": xb.ravel()}, kp * group, group,
        kind="int-serial",
        plan=kops.as_plan(backend=unit.backend, device=unit.device))
    acc = np.asarray(acc[:m * n], np.uint64).reshape(m, n)
    # undo the offset: sum (x+128)(w+128) = xw + 128*sx + 128*sw + K*128^2
    sx = x.astype(np.int64).sum(1, keepdims=True)
    sw = w.astype(np.int64).sum(0, keepdims=True)
    return (acc.astype(np.int64) - 128 * sx - 128 * sw - k * 128 * 128)
