"""Gate-level IR for the AritPIM abstract machine.

The paper's abstract model (Fig. 1e): memory is a collection of arrays of
``r x c`` bits; one bitwise *column* operation (e.g. NOR of two columns into a
third) executes per cycle, in parallel over all rows and all arrays.  An
arithmetic algorithm is therefore a straight-line *gate program* over cell
(column) indices of a single row; element parallelism is the trivial
replication of that program over rows.

Two levels of IR:

* **abstract programs** -- instructions drawn from ``G`` (NOT/NOR/AND/OR/XOR/
  XNOR/MUX/FA/...).  One instruction == one "step" in the paper's terminology.
* **NOR programs** -- the same program lowered to the stateful-logic gate set
  {INIT0, INIT1, NOT, NOR} actually supported by memristive PIM (MAGIC) and,
  with trivial substitutions, DRAM PIM.  One instruction == one cycle.

``Program`` carries named ports (cell ranges) so callers can write inputs /
read outputs without knowing the internal allocation, and a cost model
(abstract steps, NOR gates, init cycles, cell footprint == area).
"""

from __future__ import annotations

import dataclasses
import functools
import heapq
from enum import IntEnum
from typing import Dict, List, Optional, Sequence

import numpy as np


class G(IntEnum):
    INIT0 = 0   # out <- 0                     (memristive output init)
    INIT1 = 1   # out <- 1
    NOT = 2     # out <- ~a
    NOR = 3     # out <- ~(a | b)
    OR = 4      # out <- a | b
    AND = 5     # out <- a & b
    NAND = 6    # out <- ~(a & b)
    XOR = 7     # out <- a ^ b
    XNOR = 8    # out <- ~(a ^ b)
    MUX = 9     # out <- a if s else b     ins = (s, a, b)
    MUXN = 10   # mux with precomputed ~s  ins = (s, ns, a, b)
    FA = 11     # out,out2 <- sum,carry    ins = (a, b, c)
    FACC = 12   # carry-complement FA      ins = (a, b, c, nc) outs = (sum, cout, ncout)
    ID = 13     # out <- a                 (copy)


# NOR-lowering cost (gates) per abstract op; INIT cycles equal the number of
# *written* cells (output init) per lowered NOR/NOT gate and are reported
# separately -- see CostModel.
_NOR_GATES = {
    G.INIT0: 0, G.INIT1: 0, G.NOT: 1, G.NOR: 1, G.OR: 2, G.AND: 3,
    G.NAND: 4, G.XOR: 5, G.XNOR: 4, G.MUX: 4, G.MUXN: 3, G.FA: 12,
    G.FACC: 11, G.ID: 2,
}

# Paper fn. 14 normalizes every compared algorithm to a 9-NOR full adder; we
# report both our concrete netlist cost and the normalized cost.
FA_NORS_NORMALIZED = 9


@dataclasses.dataclass
class Instr:
    op: int
    ins: tuple        # cell ids (length depends on op)
    outs: tuple       # cell ids


@dataclasses.dataclass
class Cost:
    abstract_steps: int
    nor_gates: int
    nor_gates_normalized: int   # FAs counted at 9 NORs (paper's convention)
    init_cycles: int
    cells: int                  # peak cell footprint (area proxy)

    def as_dict(self):
        return dataclasses.asdict(self)


class Program:
    """A straight-line gate program over cells of one row."""

    def __init__(self, n_cells: int, instrs: List[Instr],
                 ports: Dict[str, List[int]], parallel_steps=None,
                 in_ports=None):
        self.n_cells = n_cells
        self.instrs = instrs
        self.ports = ports          # name -> list of cell ids (LSB first)
        # bit-parallel programs: list of (list of instr indices) per cycle,
        # None for purely serial programs.
        self.parallel_steps = parallel_steps
        # names of ports declared as inputs (the rest are outputs); empty
        # when direction is unknown (hand-built programs).
        self.in_ports = frozenset(in_ports or ())
        # abstract-instr -> [start, end) span in the lowered instr stream;
        # populated by lower_to_nor() on the *lowered* program.
        self.lowered_spans = None

    @property
    def out_ports(self) -> frozenset:
        """Names of the declared result ports; empty when the program is
        direction-less (no ``in_ports``).  Executors resolve the
        all-ports fallback for direction-less programs in exactly one
        place -- ``kernels.ops.output_names`` -- so every backend agrees."""
        return frozenset(n for n in self.ports if n not in self.in_ports)

    # ------------------------------------------------------------------ cost
    def cost(self) -> Cost:
        steps = 0
        nor = 0
        nor_norm = 0
        init = 0
        for ins in self.instrs:
            op = ins.op
            if op in (G.INIT0, G.INIT1):
                init += 1
                continue
            steps += 1
            g = _NOR_GATES[op]
            nor += g
            nor_norm += FA_NORS_NORMALIZED if op in (G.FA, G.FACC) else g
            init += g  # each lowered NOR/NOT writes one freshly-initialized cell
        return Cost(steps, nor, nor_norm, init, self.n_cells)

    def parallel_cost(self) -> Optional[Cost]:
        """Latency when executed under the partition schedule: per cycle the
        *maximum* NOR depth among concurrent gates (sections run in parallel,
        each section serially evaluating its gate's NOR decomposition)."""
        if self.parallel_steps is None:
            return None
        steps = len(self.parallel_steps)
        nor = 0
        nor_norm = 0
        init = 0
        for idxs in self.parallel_steps:
            ops = [self.instrs[i].op for i in idxs]
            ops = [o for o in ops if o not in (G.INIT0, G.INIT1)]
            if not ops:
                init += 1
                continue
            nor += max(_NOR_GATES[o] for o in ops)
            nor_norm += max(
                FA_NORS_NORMALIZED if o in (G.FA, G.FACC) else _NOR_GATES[o]
                for o in ops)
            init += max(_NOR_GATES[o] for o in ops)
        return Cost(steps, nor, nor_norm, init, self.n_cells)

    # ----------------------------------------------------------------- exec
    def exec_row(self, inputs: Dict[str, int]) -> Dict[str, int]:
        """Reference single-row execution; integers in/out per port."""
        state = np.zeros(self.n_cells, dtype=bool)
        for name, val in inputs.items():
            for k, cell in enumerate(self.ports[name]):
                state[cell] = (val >> k) & 1
        _exec_bool(self.instrs, state)
        out = {}
        for name, cells in self.ports.items():
            out[name] = sum(int(state[c]) << k for k, c in enumerate(cells))
        return out

    def exec_packed(self, state: np.ndarray) -> np.ndarray:
        """Element-parallel execution over bit-packed rows.

        ``state``: uint32[n_words, n_cells]; bit ``w`` of ``state[i, c]`` is
        cell ``c`` of row ``32*i + w``.  Mutated in place and returned.
        """
        assert state.dtype == np.uint32 and state.shape[1] == self.n_cells
        _exec_packed(self.instrs, state)
        return state

    # ------------------------------------------------------------- lowering
    def lower_to_nor(self) -> "Program":
        """Lower to the {INIT0, INIT1, NOT, NOR} gate set.

        The result records ``lowered_spans`` (abstract instr -> lowered
        range) so schedulers can map the builder's native ``parallel_steps``
        onto lowered gates.
        """
        b = Builder(reserve=self.n_cells)
        spans = []
        for ins in self.instrs:
            start = len(b.instrs)
            _lower_instr(b, ins)
            spans.append((start, len(b.instrs)))
        low = Program(b.n_cells, b.instrs, dict(self.ports),
                      in_ports=self.in_ports)
        low.lowered_spans = spans
        return low

    def schedule(self, mode: str = "asap", reuse_cells: bool = True,
                 max_width: Optional[int] = None) -> "LevelSchedule":
        """Levelized execution schedule of the NOR-lowered program (see
        :func:`levelize`)."""
        return levelize(self, mode=mode, reuse_cells=reuse_cells,
                        max_width=max_width)

    def to_arrays(self):
        """Dense (op, a, b, out) int32 arrays of the NOR-lowered program, the
        transport format consumed by the Pallas executor."""
        low = self.lower_to_nor()
        ops, aa, bb, oo = [], [], [], []
        for ins in low.instrs:
            op = ins.op
            if op in (G.INIT0, G.INIT1):
                ops.append(int(op)); aa.append(0); bb.append(0)
            elif op == G.NOT:
                ops.append(int(op)); aa.append(ins.ins[0]); bb.append(ins.ins[0])
            else:
                assert op == G.NOR, op
                ops.append(int(op)); aa.append(ins.ins[0]); bb.append(ins.ins[1])
            oo.append(ins.outs[0])
        return (np.asarray(ops, np.int32), np.asarray(aa, np.int32),
                np.asarray(bb, np.int32), np.asarray(oo, np.int32),
                low.n_cells)


# --------------------------------------------------------------------------
# execution helpers
# --------------------------------------------------------------------------

def _gate_eval(op, vals):
    if op == G.NOT:
        return ~vals[0]
    if op == G.NOR:
        return ~(vals[0] | vals[1])
    if op == G.OR:
        return vals[0] | vals[1]
    if op == G.AND:
        return vals[0] & vals[1]
    if op == G.NAND:
        return ~(vals[0] & vals[1])
    if op == G.XOR:
        return vals[0] ^ vals[1]
    if op == G.XNOR:
        return ~(vals[0] ^ vals[1])
    if op == G.MUX:
        s, a, b = vals
        return (s & a) | (~s & b)
    if op == G.MUXN:
        s, ns, a, b = vals
        return (s & a) | (ns & b)
    if op == G.ID:
        return vals[0]
    raise ValueError(op)


def _exec_generic(instrs, state, zero, one):
    for ins in instrs:
        op = ins.op
        if op == G.INIT0:
            state[ins.outs[0]] = zero
        elif op == G.INIT1:
            state[ins.outs[0]] = one
        elif op == G.FA:
            a, b, c = (state[i] for i in ins.ins)
            state[ins.outs[0]] = a ^ b ^ c
            state[ins.outs[1]] = (a & b) | (a & c) | (b & c)
        elif op == G.FACC:
            a, b, c, _nc = (state[i] for i in ins.ins)
            s = a ^ b ^ c
            co = (a & b) | (a & c) | (b & c)
            state[ins.outs[0]] = s
            state[ins.outs[1]] = co
            state[ins.outs[2]] = ~co
        else:
            state[ins.outs[0]] = _gate_eval(op, [state[i] for i in ins.ins])


def _exec_bool(instrs, state):
    _exec_generic(instrs, state, False, True)


def _exec_packed(instrs, state):
    # state: uint32[n_words, n_cells]; operate on columns state[:, c].
    cols = state.T  # view: [n_cells, n_words]
    zero = np.uint32(0)
    one = np.uint32(0xFFFFFFFF)
    full = np.full(state.shape[0], one, np.uint32)
    _exec_generic(instrs, cols, zero, full)


# --------------------------------------------------------------------------
# builder
# --------------------------------------------------------------------------

class Builder:
    """Allocates cells and appends instructions.

    Cells are integers; ``free`` returns intermediates to a free list so the
    peak footprint (area) stays honest.  ``vec`` helpers treat ``list[int]``
    as little-endian bit vectors.
    """

    def __init__(self, reserve: int = 0):
        self.n_cells = reserve
        self.instrs: List[Instr] = []
        self._free: List[int] = []
        self._const = {}
        self.ports: Dict[str, List[int]] = {}
        self.in_port_names: set = set()
        self._steps: Optional[List[List[int]]] = None  # parallel schedule

    # --------------------------------------------------------- cell mgmt
    def alloc(self, n: int = 1):
        out = []
        for _ in range(n):
            if self._free:
                out.append(self._free.pop())
            else:
                out.append(self.n_cells)
                self.n_cells += 1
        return out if n != 1 else out[0]

    def free(self, cells):
        if isinstance(cells, int):
            cells = [cells]
        port_cells = {c for v in self.ports.values() for c in v}
        for c in set(cells):
            if c in self._const.values() or c in port_cells \
                    or c in self._free:
                continue
            self._free.append(c)

    def input(self, name: str, n: int) -> List[int]:
        v = [self.alloc() for _ in range(n)]
        self.ports[name] = v
        self.in_port_names.add(name)
        return v

    def output(self, name: str, cells: Sequence[int]):
        self.ports[name] = list(cells)

    # ---------------------------------------------------------- emission
    def emit(self, op, ins, outs):
        self.instrs.append(Instr(op, tuple(ins), tuple(outs)))
        if self._steps is not None:
            self._steps.append([len(self.instrs) - 1])
        return outs[0] if len(outs) == 1 else outs

    def const(self, bit: int) -> int:
        if bit not in self._const:
            c = self.alloc()
            self.emit(G.INIT1 if bit else G.INIT0, (), (c,))
            self._const[bit] = c
        return self._const[bit]

    def _unary(self, op, a):
        return self.emit(op, (a,), (self.alloc(),))

    def _binary(self, op, a, b):
        return self.emit(op, (a, b), (self.alloc(),))

    def not_(self, a): return self._unary(G.NOT, a)
    def id_(self, a): return self._unary(G.ID, a)
    def nor(self, a, b): return self._binary(G.NOR, a, b)
    def or_(self, a, b): return self._binary(G.OR, a, b)
    def and_(self, a, b): return self._binary(G.AND, a, b)
    def nand(self, a, b): return self._binary(G.NAND, a, b)
    def xor(self, a, b): return self._binary(G.XOR, a, b)
    def xnor(self, a, b): return self._binary(G.XNOR, a, b)

    def mux(self, s, a, b):
        """out <- a if s else b."""
        return self.emit(G.MUX, (s, a, b), (self.alloc(),))

    def muxn(self, s, ns, a, b):
        """mux with hoisted ~s (3 NORs instead of 4; Alg 4.1 amortization)."""
        return self.emit(G.MUXN, (s, ns, a, b), (self.alloc(),))

    def fa(self, a, b, c):
        s, co = self.alloc(), self.alloc()
        self.emit(G.FA, (a, b, c), (s, co))
        return s, co

    def facc(self, a, b, c, nc):
        s, co, nco = self.alloc(), self.alloc(), self.alloc()
        self.emit(G.FACC, (a, b, c, nc), (s, co, nco))
        return s, co, nco

    # ------------------------------------------------------- vector ops
    def vec_input(self, name, n):
        return self.input(name, n)

    def vec_const(self, value: int, n: int) -> List[int]:
        return [self.const((value >> k) & 1) for k in range(n)]

    def vec_map(self, fn, *vecs):
        n = len(vecs[0])
        assert all(len(v) == n for v in vecs)
        return [fn(*(v[i] for v in vecs)) for i in range(n)]

    def vec_xor(self, x, y): return self.vec_map(self.xor, x, y)
    def vec_and(self, x, y): return self.vec_map(self.and_, x, y)
    def vec_or(self, x, y): return self.vec_map(self.or_, x, y)
    def vec_not(self, x): return self.vec_map(self.not_, x)
    def vec_id(self, x): return self.vec_map(self.id_, x)

    def vec_and_bit(self, x, bit):
        return [self.and_(xi, bit) for xi in x]

    def vec_mux(self, s, a, b):
        """elementwise a if s else b, with ~s hoisted once."""
        ns = self.not_(s)
        out = [self.muxn(s, ns, ai, bi) for ai, bi in zip(a, b)]
        self.free(ns)
        return out

    def or_reduce(self, bits):
        acc = bits[0]
        first = True
        for b in bits[1:]:
            nxt = self.or_(acc, b)
            if not first:
                self.free(acc)
            acc, first = nxt, False
        return acc if not first else self.id_(acc)

    # ------------------------------------------------------ finalization
    def finish(self) -> Program:
        return Program(self.n_cells, self.instrs, dict(self.ports),
                       parallel_steps=self._steps,
                       in_ports=self.in_port_names)


# --------------------------------------------------------------------------
# NOR lowering
# --------------------------------------------------------------------------

def _lower_instr(b: Builder, ins: Instr):
    """Append the NOR/NOT/INIT expansion of ``ins`` to builder ``b`` writing
    results into the *original* output cells (cells ids are preserved because
    the builder was reserved with the abstract program's cell count)."""
    op = ins.op
    I, O = ins.ins, ins.outs

    def nor(a, bb, out=None):
        out = b.alloc() if out is None else out
        b.emit(G.NOR, (a, bb), (out,))
        return out

    def not_(a, out=None):
        out = b.alloc() if out is None else out
        b.emit(G.NOT, (a,), (out,))
        return out

    if op in (G.INIT0, G.INIT1):
        b.emit(op, (), O)
    elif op == G.NOT:
        not_(I[0], O[0])
    elif op == G.NOR:
        nor(I[0], I[1], O[0])
    elif op == G.OR:
        t = nor(I[0], I[1]); not_(t, O[0]); b.free(t)
    elif op == G.AND:
        na, nb = not_(I[0]), not_(I[1])
        nor(na, nb, O[0]); b.free([na, nb])
    elif op == G.NAND:
        na, nb = not_(I[0]), not_(I[1])
        t = nor(na, nb); not_(t, O[0]); b.free([na, nb, t])
    elif op == G.XNOR:
        n1 = nor(I[0], I[1]); n2 = nor(I[0], n1); n3 = nor(I[1], n1)
        nor(n2, n3, O[0]); b.free([n1, n2, n3])
    elif op == G.XOR:
        n1 = nor(I[0], I[1]); n2 = nor(I[0], n1); n3 = nor(I[1], n1)
        n4 = nor(n2, n3); not_(n4, O[0]); b.free([n1, n2, n3, n4])
    elif op in (G.MUX, G.MUXN):
        if op == G.MUX:
            s, a, c = I
            ns = not_(s); tmp_ns = True
        else:
            s, ns, a, c = I
            tmp_ns = False
        # out = (s&a)|(~s&c) = NOR(NOR(a, ns), NOR(c, s))
        t1 = nor(a, ns); t2 = nor(c, s)
        nor(t1, t2, O[0])
        b.free([t1, t2] + ([ns] if tmp_ns else []))
    elif op == G.ID:
        t = not_(I[0]); not_(t, O[0]); b.free(t)
    elif op in (G.FA, G.FACC):
        if op == G.FACC:
            a, x, c, ncin = I
            s_out, co_out, nco_out = O
        else:
            a, x, c = I
            s_out, co_out = O
            nco_out = None
            ncin = not_(c)
        # 11-gate carry-complement netlist (see DESIGN.md §7):
        n1 = nor(a, x)          # ~a~b
        n2 = nor(a, n1)         # ~a b
        n3 = nor(x, n1)         # a ~b
        n4 = nor(n2, n3)        # xnor
        xo = not_(n4)           # xor
        t1 = nor(n4, ncin)      # xor & c
        t2 = nor(xo, c)         # ~xor & ~c
        ab = nor(n1, xo)        # a & b
        nco = nor(ab, t1, out=nco_out)  # ~cout (fresh cell if nco_out is None)
        not_(nco, co_out)
        nor(t1, t2, s_out)      # sum = ~(xor&c | ~xor&~c) = xor ^ c
        b.free([n1, n2, n3, n4, xo, t1, t2, ab])
        if nco_out is None:
            b.free([nco, ncin])
    else:
        raise ValueError(op)


# --------------------------------------------------------------------------
# levelized scheduling (executor pipeline stage 2: IR -> levelize)
# --------------------------------------------------------------------------
#
# The executor consumes programs as *levels*: maximal sets of NOR/NOT gates
# with no read-after-write dependency between them, so each level runs as one
# vectorized gather -> NOR -> scatter over all rows.  The pass is a classic
# mini-backend:
#
#   1. value numbering (SSA renaming) of the NOR-lowered stream -- every
#      write defines a fresh value, which dissolves the WAR/WAW hazards the
#      lowering's temp-cell free list introduces;
#   2. constant folding of INIT0/INIT1 into two shared values (the packed
#      state starts zeroed; a single always-one cell is set at pack time), so
#      scheduled gates are NOR/NOT only;
#   3. dead-code elimination backward from the final value of every port;
#   4. level assignment -- either ASAP over true dependencies ("asap") or
#      the builder's native partition schedule ("native", wave-lockstep
#      expansion of ``parallel_steps``);
#   5. register allocation: values are mapped back onto physical cells with
#      a free-list scan over live ranges, shrinking the state footprint
#      (often drastically for partitioned programs, whose k*cpk layouts are
#      sparse).
#
# The pass is purely an executor artifact: it never mutates the Program, and
# the paper-facing cost model (``Program.cost`` / ``parallel_cost``) is
# computed from the original instruction stream, never from the schedule.

_VZERO = -1     # value id: constant 0 (the zeroed packed state)
_VONE = -2      # value id: constant 1 (one shared cell set at pack time)
_INF = 1 << 60


@dataclasses.dataclass
class LevelSchedule:
    """Dense levelized form of a NOR-lowered program.

    ``a``/``b``/``out`` are int32 ``(n_levels, width)`` physical-cell index
    matrices, padded so that every level has the same width *and* unique
    per-level output indices; ``level_width[l]`` is the number of real gates
    in level ``l``.  NOT is encoded as NOR with b == a; INIT gates are
    folded away, so every lane computes ``out <- ~(a | b)``.

    Two register-allocation layouts (``alloc``):

    * ``"scan"`` -- per-cell free-list reuse; pad lanes read a dedicated
      sink cell and write distinct sink cells (``out == sink + lane``).
    * ``"slots"`` -- contiguous-slot allocation (DESIGN.md §9): each level's
      outputs occupy one contiguous band of a ``slot_width``-wide slot, so
      ``out[l] == out[l, 0] + lane`` for every lane and the level's write is
      a single slice at offset ``level_off[l]``.  Input ports pack into one
      contiguous run starting at cell 0; when the stacked output-port finals
      are not naturally contiguous, explicit double-NOT copy levels
      (``copy_gates``, reported separately from ``n_gates``) move them into
      one contiguous band.  Pad lanes read cell 0 and write the slot's own
      tail, keeping per-level output indices unique.
    """
    n_cells: int                    # physical cells incl. the sink region
    sink: int                       # first scratch cell absorbing pad lanes
    #                                 (scan alloc only; -1 for slots)
    one_cell: Optional[int]         # cell pack_rows must fill with ones
    ports: Dict[str, List[int]]     # port name -> physical cells (final
    #                                 values: where outputs are unpacked)
    in_cells: Dict[str, List[int]]  # input port -> physical cells of the
    #                                 *initial* values (where inputs are
    #                                 packed; differs from ports when a
    #                                 program overwrites an input cell)
    in_ports: frozenset
    out_ports: frozenset
    a: np.ndarray
    b: np.ndarray
    out: np.ndarray
    level_width: np.ndarray         # int32 (n_levels,)
    n_gates: int                    # live gates after DCE
    source_gates: int               # lowered NOR/NOT gates before DCE
    source_cells: int               # lowered cell count before reuse
    alloc: str = "scan"             # register-allocation layout (see above)
    slot_width: Optional[int] = None    # slot granularity ("slots" only)
    copy_gates: int = 0             # inserted output-copy gates ("slots"
    #                                 only; executor artifact, never part of
    #                                 the Program cost model)

    @property
    def n_levels(self) -> int:
        return self.a.shape[0]

    @property
    def width(self) -> int:
        return self.a.shape[1]

    @property
    def level_off(self) -> np.ndarray:
        """Per-level output-band base offsets (``alloc == "slots"`` only):
        level ``l`` writes exactly cells ``[level_off[l], level_off[l] +
        width)``, its band plus the slot's own pad tail."""
        if self.alloc != "slots":
            raise ValueError("level_off is defined for slot schedules only")
        return (self.out[:, 0] if self.n_levels
                else np.zeros(0, np.int32))

    def pack_cells(self, name: str) -> List[int]:
        """Physical cells where ``name``'s per-row values must be packed
        (inputs go to their initial-value cells, outputs read back from
        their final-value cells)."""
        return self.in_cells.get(name, self.ports[name])

    def exec_packed(self, state: np.ndarray) -> np.ndarray:
        """Vectorized numpy execution over bit-packed column state
        (uint32[n_cells, n_words]); one gather/NOR/scatter per level."""
        assert state.shape[0] == self.n_cells
        for l in range(self.n_levels):
            w = self.level_width[l]
            ia, ib, io = self.a[l, :w], self.b[l, :w], self.out[l, :w]
            state[io] = ~(state[ia] | state[ib])
        return state


def _rename(low: Program):
    """Value-number the lowered stream.  Returns (va, vb, is_gate, out_val)
    where gate i defines value ``n0 + i`` and reads values va[i]/vb[i]
    (sentinels _VZERO/_VONE for folded constants), and ``out_val`` maps each
    port cell position to its final value."""
    n0 = low.n_cells
    cur = list(range(n0))
    ni = len(low.instrs)
    va = np.full(ni, _VZERO, np.int64)
    vb = np.full(ni, _VZERO, np.int64)
    is_gate = np.zeros(ni, bool)
    for i, ins in enumerate(low.instrs):
        op = ins.op
        if op == G.INIT0:
            cur[ins.outs[0]] = _VZERO
            continue
        if op == G.INIT1:
            cur[ins.outs[0]] = _VONE
            continue
        assert op in (G.NOT, G.NOR), op
        is_gate[i] = True
        va[i] = cur[ins.ins[0]]
        vb[i] = cur[ins.ins[1]] if op == G.NOR else va[i]
        cur[ins.outs[0]] = n0 + i
    out_val = {name: [cur[c] for c in cells]
               for name, cells in low.ports.items()}
    return va, vb, is_gate, out_val


def _dce(n0, ni, va, vb, out_val):
    """Mark gates reachable (backward) from any port's final value."""
    keep = np.zeros(ni, bool)
    stack = [v for vals in out_val.values() for v in vals if v >= n0]
    while stack:
        g = stack.pop() - n0
        if keep[g]:
            continue
        keep[g] = True
        for o in (int(va[g]), int(vb[g])):
            if o >= n0 and not keep[o - n0]:
                stack.append(o)
    return keep


def _asap_levels(n0, kept, va, vb):
    """Minimal-depth level per kept gate: 1 + max(level of operand defs)."""
    lvl = {}

    def vlevel(v):
        return lvl.get(v, 0) if v >= n0 else 0

    out = {}
    for i in kept:      # program order: defs precede uses
        L = 1 + max(vlevel(int(va[i])), vlevel(int(vb[i])))
        lvl[n0 + i] = L
        out[i] = L
    return out


def _native_levels(program: Program, low: Program, kept_set):
    """Wave-lockstep levels from the builder's native ``parallel_steps``:
    abstract step s starts at base[s]; the j-th lowered gate of each of its
    abstract instrs lands in wave base[s] + j (paper §5.1 semantics: sections
    advance concurrently, each serially evaluating its gate's NOR netlist)."""
    steps = program.parallel_steps
    if steps is None:
        raise ValueError("program has no native parallel schedule")
    spans = low.lowered_spans
    covered = set()
    for idxs in steps:
        covered.update(idxs)
    for j, ins in enumerate(program.instrs):
        if j not in covered and ins.op not in (G.INIT0, G.INIT1):
            raise ValueError(
                f"abstract instr {j} ({G(ins.op).name}) is outside the "
                "native parallel schedule")
    levels = {}
    base = 1
    for idxs in steps:
        longest = 0
        for j in idxs:
            s, e = spans[j]
            for k in range(s, e):
                if k in kept_set:
                    levels[k] = base + (k - s)
            longest = max(longest, e - s)
        base += max(longest, 1)
    return levels


def levelize(program: Program, mode: str = "asap",
             reuse_cells: bool = True,
             max_width: Optional[int] = None,
             alloc: str = "scan") -> LevelSchedule:
    """Levelize ``program``'s NOR lowering into a :class:`LevelSchedule`.

    mode:  'asap'   -- minimal-depth hazard levelization (default);
           'native' -- the builder's own ``parallel_steps``, expanded to
                       NOR waves (bit-parallel programs only).
    reuse_cells: run the register-allocation pass (cells reused once their
    last reader has executed); disable for a direct cell-per-value layout.
    max_width: split levels wider than this into consecutive rows, bounding
    the padding of the dense form.  Safe because register allocation is
    strict (a cell written at level L is never read at level L), so any
    partition of a level into ordered chunks executes identically.
    alloc:  'scan'  -- per-cell free-list register allocation (default);
            'slots' -- contiguous-slot allocation: inputs pack into one
                       run at cell 0, every level's outputs land in one
                       contiguous band of a ``max_width``-wide slot (slots
                       reused at band granularity), and output-port finals
                       are moved into one contiguous band by explicit
                       double-NOT copy levels when needed.  This is the
                       static-offset form the slot executors
                       (``kernels.slots``) consume.

    Levelization never mutates ``program``; the paper-facing cost model
    (``cost()``/``parallel_cost()``) is computed from the original
    instruction stream only, and slot-mode copy gates are an executor
    artifact reported separately (``copy_gates``).
    """
    if alloc not in ("scan", "slots"):
        raise ValueError(f"unknown alloc mode {alloc!r}")
    low = program.lower_to_nor()
    n0 = low.n_cells
    ni = len(low.instrs)
    va, vb, is_gate, out_val = _rename(low)
    keep = _dce(n0, ni, va, vb, out_val)
    kept = [i for i in range(ni) if keep[i]]
    if mode == "asap":
        raw = _asap_levels(n0, kept, va, vb)
    elif mode == "native":
        raw = _native_levels(program, low, set(kept))
    else:
        raise ValueError(mode)
    # compress level ids to consecutive 1..D
    uniq = sorted(set(raw.values()))
    remap = {L: k + 1 for k, L in enumerate(uniq)}
    glevel = {i: remap[raw[i]] for i in kept}
    depth = len(uniq)

    # ---- liveness: last level each value is read at; port finals live out
    last_use: Dict[int, int] = {}
    for i in kept:
        for v in (int(va[i]), int(vb[i])):
            L = glevel[i]
            if last_use.get(v, -1) < L:
                last_use[v] = L
    for vals in out_val.values():
        for v in vals:
            last_use[v] = _INF
    # input ports pack at their *initial* values' cells (a program may
    # overwrite an input cell; its final value then differs).  Keep those
    # initial values allocatable even when never read.  Hand-built programs
    # declare no directions; treat every port as packable there.
    pack_names = low.in_ports if low.in_ports else low.ports.keys()
    in_port_cells = {name: list(low.ports[name])
                     for name in pack_names if name in low.ports}
    for cells in in_port_cells.values():
        for c in cells:
            last_use.setdefault(c, 0)

    by_level: Dict[int, List[int]] = {}
    for i in kept:
        by_level.setdefault(glevel[i], []).append(i)

    if alloc == "slots":
        return _alloc_slots(low, n0, va, vb, out_val, kept, glevel, depth,
                            last_use, in_port_cells, by_level, max_width,
                            is_gate)

    # ---- register allocation over live ranges
    phys: Dict[int, int] = {}
    free: List[int] = []
    n_phys = 0

    def alloc_cell():
        nonlocal n_phys
        if reuse_cells and free:
            return heapq.heappop(free)
        n_phys += 1
        return n_phys - 1

    expiry: Dict[int, List[int]] = {}

    def place(v, cell):
        phys[v] = cell
        lu = last_use[v]
        if lu < _INF:
            expiry.setdefault(lu, []).append(cell)

    one_cell = None
    if _VONE in last_use:
        one_cell = alloc_cell()
        place(_VONE, one_cell)
    if _VZERO in last_use:
        place(_VZERO, alloc_cell())
    for v in sorted(v for v in last_use if 0 <= v < n0):
        place(v, alloc_cell())

    rows_a, rows_b, rows_o = [], [], []
    for L in range(1, depth + 1):
        if reuse_cells:
            for cell in expiry.pop(L - 1, ()):
                heapq.heappush(free, cell)
        ra, rb, ro = [], [], []
        for i in by_level.get(L, ()):
            ra.append(phys[int(va[i])])
            rb.append(phys[int(vb[i])])
            place(n0 + i, alloc_cell())
            ro.append(phys[n0 + i])
        if max_width is not None and len(ra) > max_width:
            for s in range(0, len(ra), max_width):
                rows_a.append(ra[s:s + max_width])
                rows_b.append(rb[s:s + max_width])
                rows_o.append(ro[s:s + max_width])
        else:
            rows_a.append(ra)
            rows_b.append(rb)
            rows_o.append(ro)
    sink = n_phys
    width = max((len(r) for r in rows_a), default=0)
    # padding lanes write *distinct* sink cells so every level's scatter has
    # unique output indices (lets the executors use unique-scatter codegen)
    n_phys += max(width, 1)
    D = len(rows_a)
    a = np.full((D, width), sink, np.int32)
    b = np.full((D, width), sink, np.int32)
    o = np.tile(sink + np.arange(width, dtype=np.int32), (D, 1))
    lw = np.zeros(D, np.int32)
    for l in range(D):
        w = len(rows_a[l])
        lw[l] = w
        a[l, :w] = rows_a[l]
        b[l, :w] = rows_b[l]
        o[l, :w] = rows_o[l]
    ports = {name: [phys[v] for v in vals] for name, vals in out_val.items()}
    in_cells = {name: [phys[c] for c in cells]
                for name, cells in in_port_cells.items()}
    return LevelSchedule(
        n_cells=n_phys, sink=sink, one_cell=one_cell, ports=ports,
        in_cells=in_cells,
        in_ports=low.in_ports, out_ports=low.out_ports,
        a=a, b=b, out=o, level_width=lw,
        n_gates=len(kept), source_gates=int(is_gate.sum()),
        source_cells=n0)


def _alloc_slots(low, n0, va, vb, out_val, kept, glevel, depth, last_use,
                 in_port_cells, by_level, max_width, is_gate):
    """Contiguous-slot register allocation (DESIGN.md §9).

    Layout contract consumed by the slot executors (``kernels.slots``):

    * input-port initial values occupy one contiguous run starting at cell
      0, stacked in sorted-port-name order -- state assembly is a single
      slice update instead of a scatter;
    * every dense level writes one contiguous band: the level's outputs are
      ``off + lane`` for ``off = out[l, 0]``, and the pad lanes fill the
      slot's own tail, so the whole level is one ``max_width``-wide slice
      write with unique output indices;
    * slots (bands of ``max_width`` cells) are reused once every value of
      their current occupancy is dead, keeping the state footprint close to
      the scan allocator's instead of one-cell-per-gate;
    * the stacked output-port finals end in one contiguous ascending run --
      naturally when possible, otherwise via appended double-NOT copy
      levels (2 gates per copied cell, reported in ``copy_gates``, never in
      the Program's cost model).

    Pad lanes read cell 0 (an always-present initial cell, never written by
    any level), so the dense form stays executable by every generic
    backend, and the hazard invariant (no level reads a cell it writes)
    holds for real and pad lanes alike.
    """
    W = max_width
    if W is None:
        W = max((len(g) for g in by_level.values()), default=1)
    W = max(int(W), 1)

    # ---- placement: initial values first, inputs contiguous at cell 0
    phys: Dict[int, int] = {}
    n_phys = 0

    def place_init(v):
        nonlocal n_phys
        if v not in phys:
            phys[v] = n_phys
            n_phys += 1

    for name in sorted(in_port_cells):
        for c in in_port_cells[name]:
            place_init(c)
    one_cell = None
    if _VONE in last_use:
        place_init(_VONE)
        one_cell = phys[_VONE]
    if _VZERO in last_use:
        place_init(_VZERO)
    for v in sorted(v for v in last_use if 0 <= v < n0):
        place_init(v)
    n_init = max(n_phys, 1)     # pad lanes read cell 0; reserve it
    n_phys = n_init

    # ---- slot allocation: one W-wide slot per dense row, band reuse
    free_slots: List[int] = []
    expiry: Dict[int, List[int]] = {}

    def alloc_slot():
        nonlocal n_phys
        if free_slots:
            return heapq.heappop(free_slots)
        base = n_phys
        n_phys += W
        return base

    rows_a, rows_b, rows_off, rows_w = [], [], [], []

    def emit_row(ra, rb, outs_last_use):
        """Allocate one W-slot band for a row of <= W gates; returns the
        band base.  ``outs_last_use[k]`` is the last-read level of the k-th
        output (``_INF`` pins the slot forever)."""
        base = alloc_slot()
        lu = max(outs_last_use, default=0)
        if lu < _INF:
            expiry.setdefault(lu, []).append(base)
        rows_a.append(ra)
        rows_b.append(rb)
        rows_off.append(base)
        rows_w.append(len(ra))
        return base

    for L in range(1, depth + 1):
        for base in expiry.pop(L - 1, ()):
            heapq.heappush(free_slots, base)
        gates = by_level.get(L, ())
        for s in range(0, len(gates), W):
            chunk = gates[s:s + W]
            ra = [phys[int(va[i])] for i in chunk]
            rb = [phys[int(vb[i])] for i in chunk]
            base = emit_row(ra, rb,
                            [last_use.get(n0 + i, L) for i in chunk])
            for k, i in enumerate(chunk):
                phys[n0 + i] = base + k

    # ---- output copy stage: force the stacked output finals contiguous
    out_names = sorted(low.out_ports or low.ports)
    finals = [phys[v] for name in out_names for v in out_val[name]]
    copy_gates = 0
    if finals and finals != list(range(finals[0], finals[0] + len(finals))):
        k = len(finals)
        n_chunks = (k + W - 1) // W
        # stage 1: t <- NOT(final), into per-chunk staging slots
        stage = []
        copy_level = depth + 1
        for s in range(0, k, W):
            chunk = finals[s:s + W]
            base = emit_row(list(chunk), list(chunk),
                            [copy_level + 1] * len(chunk))
            stage.extend(base + j for j in range(len(chunk)))
        # stage 2: out <- NOT(t), into one fresh contiguous band (chunk
        # slots allocated back to back at the top of the state)
        out_base = n_phys
        n_phys += n_chunks * W
        for ci, s in enumerate(range(0, k, W)):
            chunk = stage[s:s + W]
            rows_a.append(list(chunk))
            rows_b.append(list(chunk))
            rows_off.append(out_base + ci * W)
            rows_w.append(len(chunk))
        # remap the output ports onto the copy band, in stacked order
        new_cells = iter(range(out_base, out_base + k))
        remapped = {name: [next(new_cells) for _ in out_val[name]]
                    for name in out_names}
        copy_gates = 2 * k
    else:
        remapped = {}

    # ---- dense matrices
    D = len(rows_a)
    a = np.zeros((D, W), np.int32)
    b = np.zeros((D, W), np.int32)
    o = np.zeros((D, W), np.int32)
    lw = np.asarray(rows_w, np.int32) if D else np.zeros(0, np.int32)
    for l in range(D):
        w = rows_w[l]
        a[l, :w] = rows_a[l]
        b[l, :w] = rows_b[l]
        o[l] = rows_off[l] + np.arange(W, dtype=np.int32)
    ports = {name: remapped.get(name) or [phys[v] for v in vals]
             for name, vals in out_val.items()}
    in_cells = {name: [phys[c] for c in cells]
                for name, cells in in_port_cells.items()}
    return LevelSchedule(
        n_cells=n_phys, sink=-1, one_cell=one_cell, ports=ports,
        in_cells=in_cells,
        in_ports=low.in_ports, out_ports=low.out_ports,
        a=a, b=b, out=o, level_width=lw,
        n_gates=len(kept), source_gates=int(is_gate.sum()),
        source_cells=n0, alloc="slots", slot_width=W,
        copy_gates=copy_gates)


def compose(nodes, outputs) -> Program:
    """Stitch per-op gate programs into one fused netlist (cross-op fusion).

    ``nodes`` is a sequence of ``(program, bindings)``; ``bindings`` maps
    every declared in-port of that program to a source:

    * ``("ext", name, width)`` -- an external input port of the composite
      (allocated on first use; later references share the same cells);
    * ``("node", idx, port)``  -- out-port ``port`` of an earlier node.

    ``outputs`` maps composite out-port names to ``(node_idx, port_name)``.

    Producer out-cells are wired *directly* onto consumer in-cells in one
    shared cell space; :func:`levelize`'s SSA value numbering then dissolves
    the WAW/WAR hazards of the concatenated instruction streams and its DCE
    removes every intermediate value not reachable from a declared output --
    fused intermediates never materialize as port unpacks.  When a consumer
    port is wider than its source, the high bits read a shared constant-0
    cell (zero extension); when narrower, the source truncates.  A node that
    writes any of its own input-port cells gets isolation copies (``G.ID``)
    on that port so the shared producer cells stay intact for other readers.
    """
    b = Builder()
    ext_cells: Dict[str, List[int]] = {}
    node_ports: List[Dict[str, List[int]]] = []
    for prog, bindings in nodes:
        if not prog.in_ports:
            raise ValueError(
                "compose() requires programs with declared in_ports")
        missing = prog.in_ports - set(bindings)
        if missing:
            raise ValueError(f"unbound in-ports: {sorted(missing)}")
        written = {c for ins in prog.instrs for c in ins.outs}
        cmap: Dict[int, int] = {}
        for pname in sorted(prog.in_ports):
            src_spec = bindings[pname]
            if src_spec[0] == "ext":
                _, ename, ewidth = src_spec
                if ename not in ext_cells:
                    ext_cells[ename] = b.input(ename, ewidth)
                src = list(ext_cells[ename])
            elif src_spec[0] == "node":
                _, nidx, oport = src_spec
                src = list(node_ports[nidx][oport])
            else:
                raise ValueError(f"unknown binding {src_spec!r}")
            pcells = prog.ports[pname]
            if len(src) < len(pcells):          # zero-extend
                src = src + [b.const(0)] * (len(pcells) - len(src))
            else:                               # truncate
                src = src[:len(pcells)]
            if any(c in written for c in pcells):
                src = [b.id_(s) for s in src]   # isolation copies
            for c, s in zip(pcells, src):
                cmap[c] = s

        def m(c, _cmap=cmap):
            s = _cmap.get(c)
            if s is None:
                s = _cmap[c] = b.alloc()
            return s

        for ins in prog.instrs:
            b.emit(ins.op, tuple(m(c) for c in ins.ins),
                   tuple(m(c) for c in ins.outs))
        node_ports.append({p: [m(c) for c in prog.ports[p]]
                           for p in prog.ports if p not in prog.in_ports})
    for oname, (nidx, pname) in sorted(outputs.items()):
        b.output(oname, node_ports[nidx][pname])
    return b.finish()


def memoize_build(fn):
    """Memoize a ``build_*`` program constructor by its arguments.

    Program construction is pure but slow; sharing one Program instance per
    parameterization also lets the executor's content-hash compiled-program
    cache hit without rehashing (kernels.ops memoizes keys per instance).
    """
    return functools.lru_cache(maxsize=None)(fn)
