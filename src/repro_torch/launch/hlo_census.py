"""Per-device census of a traced step: dot FLOPs, a memory-traffic proxy
and collective bytes by kind; the port of ``repro.launch.hlo_census``.

The reference walks post-SPMD HLO text and multiplies each ``while``
body's counts by its trip count.  Here the step runs once on ``meta``
tensors (shapes and dtypes, no data) under a :class:`Trace`, a dispatch
mode that records every per-device op: DTensor lowers each of its ops to
local ATen ops and ``_c10d_functional`` collectives, and the trace keeps
those (the DTensor-level op above them is left to DTensor).  The Python
loops (layers, microbatches, attention chunks) run in full, so the totals
are loop-aware by construction.

Census per trace:
  * dot FLOPs, ``2 * prod(out_dims) * contraction`` for ``mm``, ``bmm``,
    ``addmm`` and ``baddbmm``, per device (the shapes are local shards);
  * ``mem_bytes``: output plus operand bytes of every op that is not a
    view (fusion is left to the compiler, so this is a proxy);
  * collective payload bytes by kind (the result tensor's bytes), with
    ring wire-cost multipliers (all-reduce 2x, others 1x).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Iterable, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed._functional_collectives import AsyncCollectiveTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

WIRE = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
        "all-to-all": 1.0, "collective-permute": 1.0}

_aten = torch.ops.aten
_c10d = torch.ops._c10d_functional

# op -> (the index of its left operand, the contraction dim of that operand)
_DOTS = {_aten.mm.default: (0, 1), _aten.bmm.default: (0, 2),
         _aten.addmm.default: (1, 1), _aten.baddbmm.default: (1, 2)}

_COLLECTIVES = {
    _c10d.all_reduce.default: "all-reduce",
    _c10d.all_reduce_.default: "all-reduce",
    _c10d.all_reduce_coalesced.default: "all-reduce",
    _c10d.all_gather_into_tensor.default: "all-gather",
    _c10d.all_gather_into_tensor_coalesced.default: "all-gather",
    _c10d.reduce_scatter_tensor.default: "reduce-scatter",
    _c10d.reduce_scatter_tensor_coalesced.default: "reduce-scatter",
    _c10d.all_to_all_single.default: "all-to-all",
}

# ops whose result is their input (a collective's completion)
_PASS = {_c10d.wait_tensor.default, _c10d._wrap_tensor_autograd.default}


def aliases(op) -> Tuple[bool, bool]:
    """(whether the op's result aliases its first input, whether it
    writes it): a view, an in-place op, a collective's completion."""
    if op in _PASS:
        return True, False
    returns = op._schema.returns
    info = returns[0].alias_info if returns else None
    return info is not None, bool(info is not None and info.is_write)


@dataclasses.dataclass
class Node:
    op: object
    inputs: List[int]          # values read, in argument order
    outputs: List[int]         # values made (or aliased)
    flops: int                 # by torch.utils.flop_counter's formula


class Trace(TorchDispatchMode):
    """Records the per-device ops run inside it as :class:`Node` s over
    numbered values (tensors), each with its FLOPs by the formulas
    ``torch.utils.flop_counter.FlopCounterMode`` counts with.  Inputs are
    numbered by :meth:`add_input`, the step's results marked by
    :meth:`mark_outputs`; a tensor the trace did not make is a view of
    the input whose storage it shares (DTensor wraps its local shard in
    one) or else counts as an input."""

    def __init__(self):
        super().__init__()
        self.nodes: List[Node] = []
        self.nbytes: List[int] = []          # per value
        self.shapes: List[tuple] = []
        self.root: List[int] = []            # the value whose memory it is
        self.inputs: List[int] = []
        self.outputs: List[int] = []
        self._token = object()
        self._input_storage: Dict[int, int] = {}

    def _value(self, t: torch.Tensor, root: int = -1) -> int:
        i = len(self.nbytes)
        self.nbytes.append(t.numel() * t.element_size())
        self.shapes.append(tuple(t.shape))
        self.root.append(i if root < 0 else root)
        t._census_value = (self._token, i)   # lives and dies with t
        return i

    def add_input(self, t: torch.Tensor) -> int:
        i = self._value(t)
        self.inputs.append(i)
        self._input_storage[t.untyped_storage()._cdata] = i
        return i

    def _get(self, t: torch.Tensor) -> int:
        if isinstance(t, AsyncCollectiveTensor):
            t = t.elem                  # a collective's result, pending
        token, i = getattr(t, "_census_value", (None, 0))
        if token is self._token:
            return i
        base = self._input_storage.get(t.untyped_storage()._cdata)
        if base is not None:            # a view of an input made outside
            return self._value(t, self.root[base])
        return self.add_input(t)

    def mark_outputs(self, tensors: Iterable[torch.Tensor]) -> None:
        self.outputs = [self._get(t) for t in tensors]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        flat, _ = tree_flatten((args, kwargs))
        if any(isinstance(a, (DTensor, AsyncCollectiveTensor))
               for a in flat):
            return NotImplemented       # lowered to local ops by the class
        out = func(*args, **kwargs)
        if any(isinstance(t, FakeTensor)
               for t in flat + tree_flatten(out)[0]):
            return out          # DTensor deriving a global shape: no work
        ins = [self._get(a) for a in flat if isinstance(a, torch.Tensor)]
        alias, _ = aliases(func)
        outs = []
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                root = self.root[ins[0]] if alias and ins else -1
                outs.append(self._value(t, root))
        formula = flop_registry.get(func.overloadpacket)
        flops = formula(*args, **kwargs, out_val=out) if formula else 0
        self.nodes.append(Node(func, ins, outs, flops))
        return out


def census(trace: Trace) -> dict:
    """Totals of a trace: ``{"dot_flops", "mem_bytes", "collectives":
    {kind: {"count", "bytes"}}}``, per device."""
    flops = 0.0
    mem = 0.0
    coll: Dict[str, Dict[str, float]] = {
        k: {"count": 0, "bytes": 0.0} for k in WIRE}
    nb, shapes = trace.nbytes, trace.shapes
    for node in trace.nodes:
        if node.op in _DOTS:
            i, k = _DOTS[node.op]
            out = shapes[node.outputs[0]]
            flops += 2.0 * math.prod(out) * shapes[node.inputs[i]][k]
        kind = _COLLECTIVES.get(node.op)
        if kind is not None:
            coll[kind]["count"] += 1
            coll[kind]["bytes"] += sum(nb[v] for v in node.outputs) \
                * WIRE[kind]
        alias, writes = aliases(node.op)
        if not alias or writes:
            mem += sum(nb[v] for v in node.outputs) + \
                sum(nb[v] for v in node.inputs)
    return {"dot_flops": flops, "mem_bytes": mem, "collectives": coll}


def peak_temp_bytes(trace: Trace) -> int:
    """The most bytes the trace's intermediates hold at once, in op
    order: each value that aliases nothing is allocated where it is made
    and lives until the last op that reads it or a view of it.  Inputs
    and outputs are not counted (the record's argument and output
    bytes)."""
    keep = {trace.root[v] for v in trace.inputs + trace.outputs}
    last = {}
    for i, node in enumerate(trace.nodes):
        for v in node.inputs + node.outputs:
            last[trace.root[v]] = i
    frees: Dict[int, List[int]] = {}
    for r, i in last.items():
        frees.setdefault(i, []).append(r)
    live = peak = 0
    for i, node in enumerate(trace.nodes):
        for v in node.outputs:
            if trace.root[v] == v and v not in keep:
                live += trace.nbytes[v]
        peak = max(peak, live)
        for r in frees.get(i, ()):
            if r not in keep:
                live -= trace.nbytes[r]
    return peak
