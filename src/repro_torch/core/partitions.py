"""Partition model for bit-parallel element-parallel computing (paper §5.1).

Arrays are divided into ``k`` partitions connected by switches.  With
switches open, each partition (or contiguous *section* of merged partitions)
executes one gate per cycle, concurrently with every other section.  We model
the *minimal* PartitionPIM semantics at the granularity the paper's
algorithms need:

  * a **cycle** is a set of gates whose partition spans are pairwise
    disjoint contiguous ranges (the implied switch configuration);
  * a gate's operands/outputs must all lie within its section.

:class:`PartitionedBuilder` wraps the serial :class:`~repro_torch.core.gates.Builder`
with per-partition cell allocation and cycle grouping + legality validation.
The resulting :class:`Program` is functionally identical to a serial program
(the simulator ignores partitioning) while ``parallel_cost()`` reports the
partition-parallel latency.
"""

from __future__ import annotations

import contextlib
from typing import List, Sequence

from .gates import Builder, G, Program


class PartitionedBuilder:
    def __init__(self, k: int, cpk: int = 128):
        self.k = k
        self.cpk = cpk
        self.b = Builder(reserve=k * cpk)
        self._next = [0] * k
        self._freep: List[List[int]] = [[] for _ in range(k)]
        self._steps: List[List[int]] = []
        self._open = False
        self._consts = {}

    # ------------------------------------------------------------ cells
    def palloc(self, p: int) -> int:
        if self._freep[p]:
            return self._freep[p].pop()
        off = self._next[p]
        if off >= self.cpk:
            raise RuntimeError(f"partition {p} exceeded {self.cpk} cells")
        self._next[p] += 1
        return p * self.cpk + off

    def pfree(self, cells):
        if isinstance(cells, int):
            cells = [cells]
        ports = {c for v in self.b.ports.values() for c in v}
        for c in set(cells):
            p = c // self.cpk
            if c in ports or c in self._consts.values() \
                    or c in self._freep[p]:
                continue
            self._freep[p].append(c)

    def part(self, cell: int) -> int:
        assert cell < self.k * self.cpk
        return cell // self.cpk

    def const(self, bit: int, p: int) -> int:
        """Partition-local constant (INIT emitted in the setup phase)."""
        key = (bit, p)
        if key not in self._consts:
            assert not self._open, "create consts outside cycles"
            c = self.palloc(p)
            self.b.emit(G.INIT1 if bit else G.INIT0, (), (c,))
            self._consts[key] = c
        return self._consts[key]

    def input(self, name: str, partitions: Sequence[int]) -> List[int]:
        cells = [self.palloc(p) for p in partitions]
        self.b.ports[name] = cells
        self.b.in_port_names.add(name)
        return cells

    def output(self, name: str, cells):
        self.b.ports[name] = list(cells)

    # ------------------------------------------------------------ cycles
    @contextlib.contextmanager
    def cycle(self):
        """All gates emitted inside run in ONE parallel cycle; validated."""
        assert not self._open
        self._open = True
        start = len(self.b.instrs)
        yield self
        self._open = False
        idxs = list(range(start, len(self.b.instrs)))
        self._validate(idxs)
        self._steps.append(idxs)

    @contextlib.contextmanager
    def waves(self):
        """Lane-grouped emission: every :meth:`lane` inside marks one
        independent section's gate sequence; on exit, the g-th gate of every
        lane is grouped into cycle g (all lanes advance in lockstep waves).
        Legal because each lane touches only its own section."""
        assert not self._open and not getattr(self, "_lanes", None)
        self._lanes = []
        self._open = True  # reuse the no-auto-cycle path of _emit1
        yield self
        self._open = False
        lanes, self._lanes = self._lanes, None
        n = max((len(l) for l in lanes), default=0)
        for g in range(n):
            idxs = [l[g] for l in lanes if g < len(l)]
            self._validate(idxs)
            self._steps.append(idxs)

    @contextlib.contextmanager
    def lane(self):
        self._lanes.append([])
        self._cur_lane = self._lanes[-1]
        yield self
        self._cur_lane = None

    def _validate(self, idxs):
        spans = []
        for i in idxs:
            ins = self.b.instrs[i]
            cells = [c for c in ins.ins + ins.outs]
            ps = [c // self.cpk for c in cells]
            spans.append((min(ps), max(ps)))
        spans.sort()
        for (l1, h1), (l2, h2) in zip(spans, spans[1:]):
            if l2 <= h1:
                raise RuntimeError(
                    f"illegal cycle: sections [{l1},{h1}] and [{l2},{h2}] overlap")

    # gate helpers usable inside (or outside -> own cycle) a cycle()
    def _emit1(self, fn, *args, p_out: int):
        if self._open:
            out = self.palloc(p_out)
            op, ins = fn(*args)
            self.b.emit(op, ins, (out,))
            if getattr(self, "_lanes", None) is not None and \
                    getattr(self, "_cur_lane", None) is not None:
                self._cur_lane.append(len(self.b.instrs) - 1)
            return out
        with self.cycle():
            return self._emit1(fn, *args, p_out=p_out)

    def id_(self, a, p_out):
        return self._emit1(lambda a: (G.ID, (a,)), a, p_out=p_out)

    def not_(self, a, p_out):
        return self._emit1(lambda a: (G.NOT, (a,)), a, p_out=p_out)

    def and_(self, a, b, p_out):
        return self._emit1(lambda a, b: (G.AND, (a, b)), a, b, p_out=p_out)

    def or_(self, a, b, p_out):
        return self._emit1(lambda a, b: (G.OR, (a, b)), a, b, p_out=p_out)

    def xor_(self, a, b, p_out):
        return self._emit1(lambda a, b: (G.XOR, (a, b)), a, b, p_out=p_out)

    def xnor_(self, a, b, p_out):
        return self._emit1(lambda a, b: (G.XNOR, (a, b)), a, b, p_out=p_out)

    def nor_(self, a, b, p_out):
        return self._emit1(lambda a, b: (G.NOR, (a, b)), a, b, p_out=p_out)

    def mux_(self, s, a, b, p_out):
        return self._emit1(lambda s, a, b: (G.MUX, (s, a, b)), s, a, b,
                           p_out=p_out)

    def muxn_(self, s, ns, a, b, p_out):
        return self._emit1(
            lambda s, ns, a, b: (G.MUXN, (s, ns, a, b)), s, ns, a, b,
            p_out=p_out)

    def fa_(self, a, b, c, p_out):
        """full adder; sum and carry cells in partition ``p_out``."""
        if self._open:
            s, co = self.palloc(p_out), self.palloc(p_out)
            self.b.emit(G.FA, (a, b, c), (s, co))
            if getattr(self, "_lanes", None) is not None and \
                    getattr(self, "_cur_lane", None) is not None:
                self._cur_lane.append(len(self.b.instrs) - 1)
            return s, co
        with self.cycle():
            return self.fa_(a, b, c, p_out=p_out)

    def finish(self) -> Program:
        return Program(self.b.n_cells, self.b.instrs, dict(self.b.ports),
                       parallel_steps=self._steps,
                       in_ports=self.b.in_port_names)


# --------------------------------------------------------------------------
# §5.2 partition toolbox
# --------------------------------------------------------------------------

def pshift(pb: PartitionedBuilder, bits: List[int], delta: int,
           fill=None) -> List[int]:
    """Shift technique (generalized): bit of partition i moves to partition
    i+delta.  |delta|+1 cycles, grouping sources by i mod (|delta|+1) so the
    spanned sections are disjoint.  ``fill``: cells (or const value) for the
    vacated positions."""
    k = len(bits)
    d = delta
    parts = [pb.part(c) for c in bits]     # the slot->partition map
    out: List[int] = [None] * k
    groups = abs(d) + 1
    for g in range(groups):
        with pb.cycle():
            for i in range(k):
                if i % groups != g:
                    continue
                j = i + d
                if 0 <= j < k:
                    out[j] = pb.id_(bits[i], p_out=parts[j])
    for j in range(k):
        if out[j] is None and fill is not None:
            out[j] = pb.const(int(fill), parts[j])
    return out


def broadcast(pb: PartitionedBuilder, src: int, lo: int = 0,
              hi: int = None) -> List[int]:
    """Broadcast technique: copy a single bit to all partitions [lo, hi) in
    ceil(log2(n)) cycles by recursive halving (paper Fig. 6).  If the source
    lives outside partition ``lo`` it is first pulled there (1 cycle)."""
    hi = pb.k if hi is None else hi
    # Always copy the source (even when already at ``lo``) so every returned
    # cell is fresh -- callers may free the whole result without aliasing
    # the (possibly still-live) source.
    src = pb.id_(src, p_out=lo)            # 1 semi-parallel long-range copy
    # ranges: (lo, hi, cell located at partition lo)
    ranges = [(lo, hi, src)]
    while any(h - l > 1 for l, h, _ in ranges):
        with pb.cycle():
            new = []
            for l, h, cell in ranges:
                if h - l <= 1:
                    new.append((l, h, cell))
                    continue
                mid = (l + h) // 2
                c2 = pb.id_(cell, p_out=mid)
                new.append((l, mid, cell))
                new.append((mid, h, c2))
            ranges = new
    out = [None] * pb.k
    for l, _h, cell in ranges:
        out[l] = cell
    return out


def reduce_tree(pb: PartitionedBuilder, bits: List[int], op: str) -> int:
    """Reduction technique: associative ``op`` over all partitions' bits in
    ceil(log2(k)) cycles; result lands in the last partition."""
    fn = {"and": pb.and_, "or": pb.or_, "xor": pb.xor_}[op]
    cur = list(bits)
    idx = [pb.part(c) for c in bits]
    while len(cur) > 1:
        with pb.cycle():
            nxt, nidx = [], []
            for i in range(0, len(cur) - 1, 2):
                nxt.append(fn(cur[i], cur[i + 1], p_out=idx[i + 1]))
                nidx.append(idx[i + 1])
            if len(cur) % 2:
                nxt.append(cur[-1])
                nidx.append(idx[-1])
        cur, idx = nxt, nidx
    return cur[0]


def prefix_scan(pb: PartitionedBuilder, state: List[tuple],
                combine) -> List[tuple]:
    """Prefix technique (Brent-Kung, paper Fig. 6): partition i ends with
    state_0 ∘ ... ∘ state_i in 2*ceil(log2(k)) - 1 waves.

    ``combine(pb, left_state, cur_state, p_out) -> new_state`` emits the ∘
    gates; it runs inside a :meth:`PartitionedBuilder.lane`, so concurrent
    combines advance in lockstep waves (gate g of every pair shares cycle g).
    """
    k = len(state)
    st = list(state)
    lg = max(1, (k - 1).bit_length())

    def run(pairs):
        res = {}
        with pb.waves():
            for l, i in pairs:
                with pb.lane():
                    res[i] = combine(pb, st[l], st[i], pb.part(st[i][0]))
        for _, i in pairs:
            st[i] = res[i]

    for d in range(lg):                       # up-sweep (reduction)
        stride = 1 << d
        run([(i - stride, i)
             for i in range(2 * stride - 1, k, 2 * stride)])
    for d in reversed(range(lg - 1)):         # down-sweep (fill the holes)
        stride = 1 << d
        run([(i, i + stride)
             for i in range(2 * stride - 1, k - stride, 2 * stride)])
    return st


def reduce_pairs(pb: PartitionedBuilder, states: List[tuple],
                 combine) -> tuple:
    """Reduction over multi-cell states (e.g. (generate, alive) pairs for the
    divider's carry-lookahead, paper §5.5): logarithmic tree of ``combine``
    waves; the fold is right-to-left so combine(left, cur) composes in index
    order.  Returns the final state (in the last involved partition)."""
    cur = list(states)
    while len(cur) > 1:
        nxt = []
        with pb.waves():
            res = {}
            for i in range(0, len(cur) - 1, 2):
                with pb.lane():
                    p_out = pb.part(cur[i + 1][0])
                    res[i] = combine(pb, cur[i], cur[i + 1], p_out)
        for i in range(0, len(cur) - 1, 2):
            nxt.append(res[i])
            pb.pfree(list(cur[i]) + list(cur[i + 1]))  # consumed pair states
        if len(cur) % 2:
            nxt.append(cur[-1])
        cur = nxt
    return cur[0]
