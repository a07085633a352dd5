"""The compile->execute pipeline behind every entry point, on PyTorch.

Pipeline: ``Program`` -> :func:`~repro_torch.core.gates.levelize`
schedule (slot or dense allocation) -> :class:`~repro_torch.kernels.plan.ExecPlan`
-> resolved executor operands on the plan's device -> executor -> unpack.
The dispatch rules are the reference's (``repro.kernels.ops``), with
``cuda`` in the place of ``pallas``:

* ``schedule="slots"`` runs the slot-scan executor (B1); ``"dense"`` the
  level-gather executor (B3); ``"slots-static"`` the straight-line form --
  the generated static-slice kernel (B2) for fused calls on ``cuda`` whose
  inputs are the leading run (every other ``cuda`` call runs B1), the
  segmented static chain on ``ref``.  A slot layout the slot executors
  cannot take (no contiguous output band, or on ``cuda`` no contiguous
  input run) falls to the dense schedule, as in the reference.
* **fused** branch (every port <= 32 cells): per-row values go to the
  device as int32[n_ports, n_rows] and the executor does the bit
  transposes itself; **io** branch (a port wider than 32 cells, or
  object-dtype values): the host packs port rows with numpy
  (:func:`_pack_port_words`) and unpacks the output rows
  (:func:`_unpack_sub`).  ``layout="rows64"`` runs both branches on the
  paired 64-row word layout.
* ``run_program(levelized=False)`` runs the gate-serial executor (B4) over
  the whole state, packed and unpacked on the host (rows32 only).

The scale layer: :func:`run_program_streaming` tiles rows into chunks,
:func:`run_program_groups` pipelines chunks of several programs, and a
plan's mesh (:func:`row_mesh`) splits each dispatch's word axis over
devices.  Operands and results cross to a CUDA device through pinned
staging buffers on copy streams of their own (``kernels.transfer``), so
that the host fills chunk k+1 while chunk k runs.
:func:`dispatch_packed` keeps a dispatch in the packed word domain (the
stages of the reduction trees in ``core.pim_numerics``, whose blocks stay
on the device between levels).

Verified execution: a plan with a fault model (``faults``) or a verify
policy (``verify``) runs each chunk, group and tree stage through the
reference's detect -> retry -> remap loop (:func:`_verified_dispatch`,
:func:`_verified_dispatch_packed`), with the check fold (B6,
``pim_exec.check_words``) on the device when both are set;
:data:`HEALTH` counts what it did.

The ``cuda`` backend runs the kernels (``kernels.pim_exec``), ``ref`` their
plain versions (``kernels.slots``, ``kernels.ref``) on the plan's devices,
``numpy`` the gate-serial oracle (``Program.exec_packed``).
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import threading
import time
import weakref
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from ..core.gates import LevelSchedule, levelize
from ..runtime import telemetry
from ..runtime.faults import (DeadlineExceeded, FaultError,  # noqa: F401
                              FaultModel, VerifyPolicy, note_quarantine,
                              record_wear)
from . import pim_exec
from . import ref as kref
from . import slots as kslots
from . import transfer
from .transfer import checked_device as _checked_device
from .pim_exec import check_words  # noqa: F401
from .plan import (BACKENDS, DEFAULT_LAYOUT, DEFAULT_PLAN,  # noqa: F401
                   DEFAULT_SCHEDULE, LAYOUTS, ROWS32, ROWS64, SCHEDULES,
                   Backend, ExecPlan, WordLayout, as_plan)
# Tunables re-exported from their home on kernels.plan, for callers that
# import them from here.
from .plan import (DEFAULT_CHUNK_ROWS, LEVEL_MAX_WIDTH,  # noqa: F401
                   SLOT_WIDTH)

_FULL = np.uint32(0xFFFFFFFF)


def make_plan(**kw) -> ExecPlan:
    """Build an :class:`ExecPlan` from convenience keywords (``backend=``,
    ``schedule=``, ``layout=``, ``mesh=``, ``chunk_rows=``, ``device=``,
    ``faults=``, ``verify=``, or a ready plan via ``plan=``)."""
    return as_plan(kw.pop("plan", None), **kw)


# --------------------------------------------------------------------------
# plan-keyed compiled-program cache (bounded, weighted LRU)
# --------------------------------------------------------------------------
#
# Programs are levelized (and their schedule operands copied to a device)
# once per (structure, plan compile key): the key pairs a content hash of
# the instruction stream + ports with ``plan.compile_key``.  Eviction is
# safe -- an evicted structure is rebuilt on next use, bit-identically.
# The cache is bounded by entry count and by total schedule weight (levels
# x slot width), so one huge program cannot silently displace the hot set;
# weight pressure alone never shrinks it below ``_COMPILED_MIN_RESIDENT``
# unpinned entries.

_COMPILED_CAP = 64
_COMPILED_WEIGHT_CAP = 8 << 20
_COMPILED_MIN_RESIDENT = 4

_key_memo: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
_compiled: "collections.OrderedDict[tuple, _Compiled]" = \
    collections.OrderedDict()
# Serial-order modeled costs for the numpy oracle, weak-keyed and kept out
# of ``_compiled`` so oracle runs cannot churn the weighted LRU.
_serial_model_memo: "weakref.WeakKeyDictionary" = \
    weakref.WeakKeyDictionary()

#: Compiled-program LRU counters (``pim.cache.hits``/``misses``/
#: ``evictions``/``levelized``) on the global telemetry registry.  The
#: disk tier (``runtime.artifact_cache``) adds ``disk_hits``/
#: ``disk_misses``/``disk_writes``/``disk_errors``/``disk_evictions`` to
#: the same group, and ``levelized`` and ``packed`` count *fresh*
#: levelizations and stream packings -- what a warm-started replica
#: drives to zero.
_CACHE = telemetry.REGISTRY.group("pim.cache")

# --------------------------------------------------------------------------
# optional on-disk artifact tier
# --------------------------------------------------------------------------
#
# When installed, the disk cache sits *below* the in-memory LRU: an
# in-memory miss of a schedule, of a packed stream (B1, B3, B4) or of a
# generated kernel's library (B2, and the fixed kernels' libraries in
# ``pim_exec.build``) first tries the disk before levelizing, packing or
# running nvcc, and every fresh artifact is written through.

_artifacts = None       # Optional[runtime.artifact_cache.ArtifactCache]

# Program build provenance -- how ``core.pim_numerics`` constructed each
# program (the ``program_for``/``fused_program_for`` argument triple).
# Written into on-disk schedule headers so ``ArtifactCache.warm()`` can
# rebuild the program in a fresh process and verify its content hash.
# Weak-keyed: provenance never pins a program alive.
_provenance: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def set_artifact_cache(cache) -> None:
    """Install (or, with None, remove) the process-wide on-disk artifact
    cache consulted by the compiled-program machinery."""
    global _artifacts
    _artifacts = cache


def artifact_cache():
    """The installed on-disk artifact tier, or None."""
    return _artifacts


def note_provenance(program, tag: tuple) -> None:
    """Record how ``program`` was built (a plain-data tag the artifact
    cache persists and ``warm()`` replays)."""
    try:
        _provenance.setdefault(program, tag)
    except TypeError:
        pass


def provenance_of(program):
    return _provenance.get(program)

# Pinned entries (cache key -> refcount) are exempt from eviction.
_pinned: Dict[tuple, int] = {}

# One lock over the LRU, its pins and every read of them: the batched
# server reads ``is_compiled`` (``Prepared.cached``) on whichever thread
# asks while the dispatching thread inserts, pins and evicts.
_CACHE_LOCK = threading.RLock()


def _serial_model(program) -> "telemetry.ModeledCost":
    m = _serial_model_memo.get(program)
    if m is None:
        m = telemetry.COST_MODEL.program_cost(program.cost())
        _serial_model_memo[program] = m
    return m


def clear_compiled_cache() -> int:
    """Drop every *unpinned* compiled-program entry; returns the number
    dropped."""
    with _CACHE_LOCK:
        victims = [k for k in _compiled if k not in _pinned]
        for k in victims:
            del _compiled[k]
    return len(victims)


def _evict_over_cap(protect: Optional[tuple] = None) -> None:
    """Drop least-recently-used *unpinned* entries while over either cap
    (entry count or total schedule weight).  ``protect`` exempts the entry
    a caller is in the middle of handing out."""
    with _CACHE_LOCK:
        weight = sum(e.weight for e in _compiled.values())
        for key in list(_compiled):
            over_n = len(_compiled) > _COMPILED_CAP
            over_w = weight > _COMPILED_WEIGHT_CAP
            if not (over_n or over_w):
                break
            if key in _pinned or key == protect:
                continue
            if not over_n:      # weight pressure only: respect the floor
                unpinned = sum(1 for k in _compiled
                               if k not in _pinned and k != protect)
                if unpinned <= _COMPILED_MIN_RESIDENT:
                    break
            weight -= _compiled[key].weight
            del _compiled[key]
            _CACHE.add("evictions")


def set_compiled_cache_cap(cap: int, weight_cap: Optional[int] = None) -> int:
    """Set the compiled-program LRU capacity (entries) and, optionally, the
    total schedule-weight cap; returns the old entry cap.  Shrinking evicts
    unpinned entries immediately."""
    global _COMPILED_CAP, _COMPILED_WEIGHT_CAP
    if cap < 1:
        raise ValueError(f"cache cap must be >= 1, got {cap}")
    old, _COMPILED_CAP = _COMPILED_CAP, cap
    if weight_cap is not None:
        if weight_cap < 1:
            raise ValueError(f"weight cap must be >= 1, got {weight_cap}")
        _COMPILED_WEIGHT_CAP = weight_cap
    _evict_over_cap()
    return old


def cache_key(program, plan: Optional[ExecPlan] = None) -> tuple:
    """The compiled-program cache key: (program content hash,
    plan.compile_key)."""
    plan = DEFAULT_PLAN if plan is None else plan
    return (content_key(program), plan.compile_key)


def pin_program(program, plan: Optional[ExecPlan] = None) -> tuple:
    """Pin ``program``'s compiled-cache entry against eviction; returns the
    cache key (the token :func:`unpin_program` takes).  Pins nest."""
    key = cache_key(program, plan)
    with _CACHE_LOCK:
        if key not in _compiled:
            _compiled[key] = _Compiled()
            _CACHE.add("misses")
            _evict_over_cap(protect=key)
        _pinned[key] = _pinned.get(key, 0) + 1
    return key


def unpin_program(key: tuple) -> bool:
    """Release one pin on ``key``; returns True while pins remain."""
    with _CACHE_LOCK:
        n = _pinned.get(key, 0)
        if n > 1:
            _pinned[key] = n - 1
            return True
        _pinned.pop(key, None)
        _evict_over_cap()
    return False


def content_key(program) -> bytes:
    """Structural hash of a Program (instrs, ports, cells, schedule hints);
    equal to ``repro.kernels.ops.content_key`` for the same program."""
    try:
        return _key_memo[program]
    except (KeyError, TypeError):
        pass
    h = hashlib.blake2b(digest_size=16)
    h.update(int(program.n_cells).to_bytes(8, "little"))
    flat = []
    for ins in program.instrs:
        flat.extend((int(ins.op), len(ins.ins)))
        flat.extend(int(c) for c in ins.ins)
        flat.extend(int(c) for c in ins.outs)
        flat.append(-1)
    h.update(np.asarray(flat, np.int64).tobytes())
    for name in sorted(program.ports):
        h.update(name.encode())
        h.update(b"\x00i" if name in program.in_ports else b"\x00o")
        h.update(np.asarray(program.ports[name], np.int64).tobytes())
    if program.parallel_steps is not None:
        for idxs in program.parallel_steps:
            h.update(np.asarray(list(idxs) + [-1], np.int64).tobytes())
    key = h.digest()
    try:
        _key_memo[program] = key
    except TypeError:
        pass
    return key


def _stacked_cells(cell_lists) -> np.ndarray:
    """Concatenate per-port cell lists into one int32 index vector."""
    if not cell_lists:
        return np.zeros(0, np.int32)
    return np.concatenate(
        [np.asarray(c, np.int64) for c in cell_lists]).astype(np.int32)


def as_run(idx) -> Optional[int]:
    """Start of the single contiguous ascending run ``idx`` forms, or None."""
    idx = np.asarray(idx)
    if idx.size == 0:
        return 0
    start = int(idx[0])
    if np.array_equal(idx, np.arange(start, start + idx.size)):
        return start
    return None


def output_names(ports_owner) -> list:
    """The port names ``run_program`` returns, sorted: the declared output
    ports, falling back to *every* port for direction-less programs."""
    return sorted(getattr(ports_owner, "out_ports", None)
                  or ports_owner.ports)


# --------------------------------------------------------------------------
# schedules
# --------------------------------------------------------------------------

def _check_shape_and_cells(s: LevelSchedule) -> None:
    if s.a.shape != s.b.shape or s.a.shape != s.out.shape or s.a.ndim != 2:
        raise ValueError("schedule arrays a/b/out must share one 2-D shape")
    if s.n_levels:
        idx = np.concatenate([s.a.ravel(), s.b.ravel(), s.out.ravel()])
        if idx.min() < 0 or idx.max() >= s.n_cells:
            raise ValueError(f"schedule index outside [0, {s.n_cells})")
    cells = [c for cs in list(s.ports.values()) + list(s.in_cells.values())
             for c in cs]
    if cells and not 0 <= min(cells) <= max(cells) < s.n_cells:
        raise ValueError(f"port cell outside [0, {s.n_cells})")
    if s.one_cell is not None and not 0 <= s.one_cell < s.n_cells:
        raise ValueError(f"one_cell {s.one_cell} outside [0, {s.n_cells})")


def _check_slot_schedule(s: LevelSchedule) -> None:
    """Reject a slot schedule whose indices leave the state: the kernels
    index shared memory with them unchecked."""
    _check_shape_and_cells(s)
    if s.n_levels and not np.array_equal(s.out,
                                         s.out[:, :1] + np.arange(s.width)):
        raise ValueError("slot schedule levels must write contiguous "
                         "bands (out[l] == out[l, 0] + lane)")


def _check_dense_schedule(s: LevelSchedule) -> None:
    """Reject a dense schedule whose indices leave the state or whose
    level writes one cell twice: the level-gather kernel indexes shared
    memory unchecked, and its lanes write in no set order."""
    _check_shape_and_cells(s)
    if s.n_levels:
        srt = np.sort(s.out, axis=1)
        if (srt[:, 1:] == srt[:, :-1]).any():
            raise ValueError("dense schedule levels must write distinct "
                             "cells (out[l] unique per level)")


def schedule_from_arrays(d: dict) -> LevelSchedule:
    """Build a :class:`LevelSchedule` from another levelizer's fields,
    given as numpy arrays and plain scalars: ``a``, ``b``, ``out``,
    ``level_width``, ``ports`` (name -> cells), ``in_ports``,
    ``out_ports``, ``one_cell``, ``n_cells``, ``alloc`` (``"slots"``, or
    ``"dense"`` -- levelize's ``"scan"`` allocation, which the name also
    takes) and ``width`` (the slot width, or the dense lane count), plus
    optional ``in_cells``, ``copy_gates`` and ``sink`` (dense).  Tests
    feed one schedule to executors of both packages with it."""
    alloc = d["alloc"]
    if alloc not in ("slots", "dense", "scan"):
        raise ValueError(f"unknown alloc {alloc!r}: slot schedules "
                         "('slots') and dense schedules ('dense') execute "
                         "here")
    a = np.ascontiguousarray(d["a"], np.int32)
    width = int(d["width"])
    if a.shape[0] and a.shape[1] != width:
        raise ValueError(f"schedule arrays are {a.shape[1]} lanes wide, "
                         f"width is {width}")
    level_width = np.ascontiguousarray(d["level_width"], np.int32)
    s = LevelSchedule(
        n_cells=int(d["n_cells"]),
        sink=-1 if alloc == "slots" else int(d.get("sink", -1)),
        one_cell=None if d["one_cell"] is None else int(d["one_cell"]),
        ports={n: [int(c) for c in cs] for n, cs in d["ports"].items()},
        in_cells={n: [int(c) for c in cs]
                  for n, cs in d.get("in_cells", {}).items()},
        in_ports=frozenset(d["in_ports"]), out_ports=frozenset(d["out_ports"]),
        a=a, b=np.ascontiguousarray(d["b"], np.int32),
        out=np.ascontiguousarray(d["out"], np.int32),
        level_width=level_width, n_gates=int(level_width.sum()),
        source_gates=int(level_width.sum()), source_cells=int(d["n_cells"]),
        alloc="slots" if alloc == "slots" else "scan",
        slot_width=width if alloc == "slots" else None,
        copy_gates=int(d.get("copy_gates", 0)))
    (_check_slot_schedule if alloc == "slots" else _check_dense_schedule)(s)
    return s


def _check_installable(program, alloc: str, s: LevelSchedule) -> None:
    """Raise ``ValueError`` unless ``s`` is a schedule of ``program``'s
    ports that passes the kernels' checks for ``alloc``."""
    if set(s.ports) != set(program.ports):
        raise ValueError("schedule ports disagree with the program")
    if (s.alloc == "slots") != (alloc == "slots"):
        raise ValueError(f"a {s.alloc} schedule is no {alloc} schedule")
    (_check_slot_schedule if alloc == "slots" else _check_dense_schedule)(s)


# --------------------------------------------------------------------------
# per-(structure, plan) compilation artifacts
# --------------------------------------------------------------------------

def _alloc_of(kind: str) -> str:
    return "dense" if kind == "dense" else "slots"


def _static_key(plan: ExecPlan, in_names, in_widths, out_widths) -> tuple:
    """What ``_Compiled.static`` keys B2's kernel on."""
    return ("kernel", tuple(in_names), tuple(in_widths), tuple(out_widths),
            plan.layout.planes, plan.backend.words_per_cta)


@dataclasses.dataclass
class _Resolved:
    """One plan + program + input-set binding, resolved once: the
    effective schedule kind (the dense fallback for slot layouts the slot
    executors cannot take is decided here), the device schedule operands,
    the bridge index vectors, the static widths and the kernels' launch
    shape."""
    kind: str                        # effective schedule after fallback
    sched: LevelSchedule
    la: torch.Tensor
    lb: torch.Tensor
    lo: torch.Tensor
    out_idx: torch.Tensor
    names: list
    out_base: Optional[int]
    in_idx: torch.Tensor
    in_base: Optional[int]
    one_cell: Optional[int]
    in_widths: tuple
    out_widths: tuple
    k_out: int
    fused_ok: bool                   # every port fits a 32-bit transpose
    use_static: bool                 # the straight-line emission applies
    words_per_cta: Optional[int]     # CTA width override (None: the rule)
    model: Optional["telemetry.ModeledCost"] = None  # analytical cost gauge
    packed: Optional["pim_exec.Packed"] = None   # B1's or B3's stream (cuda)


@dataclasses.dataclass
class _Compiled:
    """Lazily built artifacts for one (program structure, plan compile key)
    cache entry: the lowered gate arrays, one levelized schedule per
    allocation ("slots", "dense") with its operands and its packed stream
    (B1, B3) per device, resolved bindings, and the straight-line
    executors (static chains and generated kernels)."""
    arrays: Optional[tuple] = None              # (ops, a, b, o, n_cells)
    scheds: Dict[str, LevelSchedule] = dataclasses.field(default_factory=dict)
    devs: Dict[tuple, tuple] = dataclasses.field(default_factory=dict)
    in_idx: Dict[tuple, tuple] = dataclasses.field(default_factory=dict)
    resolved: Dict[tuple, _Resolved] = dataclasses.field(default_factory=dict)
    static: Dict[tuple, object] = dataclasses.field(default_factory=dict)
    gates: Dict[str, tuple] = dataclasses.field(default_factory=dict)
    packed: Dict[tuple, "pim_exec.Packed"] = dataclasses.field(
        default_factory=dict)
    serial_model: Optional["telemetry.ModeledCost"] = None

    @property
    def weight(self) -> int:
        """Levels x width summed over the resident schedules -- what the
        LRU's weight cap bounds."""
        return sum(int(s.n_levels) * int(s.width)
                   for s in self.scheds.values())

    def get_arrays(self, program):
        if self.arrays is None:
            self.arrays = program.to_arrays()
        return self.arrays

    def get_serial_model(self, program) -> "telemetry.ModeledCost":
        """Modeled cost of the gate-serial execution order, memoized."""
        if self.serial_model is None:
            self.serial_model = telemetry.COST_MODEL.program_cost(
                program.cost())
        return self.serial_model

    def get_gates(self, program, device: str) -> tuple:
        """The lowered stream ``(ops, a, b, o)`` on ``device``, its cell
        indices checked once against the lowered state, and on a CUDA
        device B4's packed stream of it (``pim_exec.pack_gates``; None
        elsewhere)."""
        g = self.gates.get(device)
        if g is None:
            ops, a, b, o, n_cells = self.get_arrays(program)
            live = np.concatenate([a[ops >= 2], b[ops >= 2], o])
            if live.size and not 0 <= live.min() <= live.max() < n_cells:
                raise ValueError(f"gate cell index outside [0, {n_cells})")
            packed = None
            if torch.device(device).type == "cuda":
                packed = self._stream(
                    program, (), "gates", len(ops),
                    n_cells + pim_exec.GATE_CONSTANTS,
                    lambda: pim_exec.pack_gates(ops, a, b, o,
                                                n_cells=n_cells)).to(device)
            g = self.gates[device] = tuple(
                torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(device)
                for x in (ops, a, b, o)) + (packed,)
        return g

    def get_schedule(self, program, plan: ExecPlan,
                     kind: Optional[str] = None) -> LevelSchedule:
        """The ``kind`` schedule: from memory, else from the installed
        artifact cache, else levelized (and written through)."""
        alloc = _alloc_of(plan.schedule if kind is None else kind)
        s = self.scheds.get(alloc)
        if s is None:
            content = content_key(program)
            if _artifacts is not None:
                s = _artifacts.load_schedule(content, plan, alloc)
                if s is not None:
                    try:
                        _check_installable(program, alloc, s)
                    except ValueError:
                        # key-collision / stale-entry guard: never trust
                        # a disk schedule the program or kernels disagree
                        # with
                        _CACHE.add("disk_errors")
                        s = None
            if s is None:
                if alloc == "dense":
                    s = levelize(program,
                                 max_width=plan.backend.level_max_width)
                else:
                    s = levelize(program, alloc="slots",
                                 max_width=plan.backend.slot_width)
                _check_installable(program, alloc, s)
                _CACHE.add("levelized")
                if _artifacts is not None:
                    _artifacts.store_schedule(
                        content, plan, alloc, s,
                        provenance=provenance_of(program))
            self.scheds[alloc] = s
        return s

    def install_schedule(self, program, alloc: str,
                         s: LevelSchedule) -> None:
        """Install a schedule loaded from disk (``ArtifactCache.warm``)
        unless one is resident; raises ``ValueError`` where the program's
        ports or the kernels' checks disagree with it."""
        _check_installable(program, _alloc_of(alloc), s)
        self.scheds.setdefault(_alloc_of(alloc), s)

    def get_sched_dev(self, program, plan: ExecPlan, kind: str, device: str):
        alloc = _alloc_of(kind)
        dev = self.devs.get((alloc, device))
        if dev is None:
            s = self.get_schedule(program, plan, kind)
            names = output_names(s)
            cells = _stacked_cells([s.ports[n] for n in names])
            dev = tuple(torch.from_numpy(np.ascontiguousarray(x, np.int32)
                                         ).to(device)
                        for x in (s.a, s.b, s.out, cells)) + \
                (names, as_run(cells) if alloc == "slots" else None)
            self.devs[(alloc, device)] = dev
        return dev

    def get_packed(self, program, plan: ExecPlan, kind: str, device: str
                   ) -> "pim_exec.Packed":
        """The packed stream of the ``kind`` schedule on ``device``, one
        window a level: B1's (``pim_exec.pack_slots``) or B3's
        (``pim_exec.pack_levels``)."""
        key = (_alloc_of(kind), device)
        if key not in self.packed:
            s = self.get_schedule(program, plan, kind)
            pack = pim_exec.pack_levels if key[0] == "dense" else \
                pim_exec.pack_slots
            self.packed[key] = self._stream(
                program, plan, key[0], s.a.size, s.n_cells,
                lambda: pack(s.a, s.b, s.out, n_cells=s.n_cells)
            ).to(device)
        return self.packed[key]

    @staticmethod
    def _stream(program, plan, alloc: str, n_gates: int, n_cells: int,
                pack) -> "pim_exec.Packed":
        """A packed stream on the CPU: from the installed artifact cache
        where it holds one of ``n_gates`` gates over ``n_cells`` cells
        (B4's constant cells included), else ``pack()`` (counted in
        ``packed``, and written through).  B4's stream is keyed on the
        compile key ``()``: it does not depend on the plan."""
        content = content_key(program)
        if _artifacts is not None:
            p = _artifacts.load_packed(content, plan, alloc)
            if p is not None:
                try:
                    pim_exec.check_packed(p, n_gates, n_cells)
                    return p
                except ValueError:
                    _CACHE.add("disk_errors")
        p = pack()
        _CACHE.add("packed")
        if _artifacts is not None:
            _artifacts.store_packed(content, plan, alloc, p,
                                    provenance=provenance_of(program))
        return p

    def install_packed(self, program, plan: ExecPlan, alloc: str,
                       p: "pim_exec.Packed", device: str) -> bool:
        """Install a packed stream loaded from disk on ``device``
        (``ArtifactCache.warm``) unless one is resident; False where its
        schedule is not resident or the stream disagrees with it."""
        s = self.scheds.get(alloc)
        if s is None:
            return False
        try:
            pim_exec.check_packed(p, s.a.size, s.n_cells)
        except ValueError:
            _CACHE.add("disk_errors")
            return False
        self.packed.setdefault((alloc, device), p.to(device))
        return True

    def get_in_idx(self, program, plan: ExecPlan, kind: str, device: str,
                   in_names):
        key = (_alloc_of(kind), device, tuple(in_names))
        if key not in self.in_idx:
            s = self.get_schedule(program, plan, kind)
            cells = _stacked_cells([s.pack_cells(n) for n in in_names])
            self.in_idx[key] = (torch.from_numpy(cells).to(device),
                                as_run(cells))
        return self.in_idx[key]

    def resolve(self, program, plan: ExecPlan, in_names: tuple,
                device: Optional[str] = None) -> _Resolved:
        """Bind ``plan`` to this program for one input-name set on
        ``device`` (default the plan's): pick the effective schedule (the
        dense fallback for slot layouts the slot executors cannot take),
        copy the operands to the device, freeze the static widths and, on
        cuda, pack the schedule's stream.  Memoized."""
        device = _checked_device(plan.device if device is None else device)
        planes = plan.layout.planes
        memo_key = (plan.schedule, plan.backend.name,
                    plan.backend.words_per_cta, planes, device, in_names)
        r = self.resolved.get(memo_key)
        if r is not None:
            return r
        kind = plan.schedule
        sched = self.get_schedule(program, plan, kind)
        la, lb, lo, out_idx, names, out_base = \
            self.get_sched_dev(program, plan, kind, device)
        in_idx, in_base = self.get_in_idx(program, plan, kind, device,
                                          in_names)
        k_out = sum(len(sched.ports[n]) for n in names)
        slots_ok = kind != "dense" and out_base is not None and k_out > 0
        if plan.backend.name == "cuda" and slots_ok and in_base is None:
            slots_ok = False    # the reference's rule for its kernels
        if not slots_ok and kind != "dense":
            kind = "dense"
            sched = self.get_schedule(program, plan, kind)
            la, lb, lo, out_idx, names, out_base = \
                self.get_sched_dev(program, plan, kind, device)
            in_idx, in_base = self.get_in_idx(program, plan, kind, device,
                                              in_names)
        in_widths = tuple(len(sched.pack_cells(n)) for n in in_names)
        out_widths = tuple(len(sched.ports[n]) for n in names)
        on_cuda = plan.backend.name == "cuda"
        r = _Resolved(
            kind=kind, sched=sched, la=la, lb=lb, lo=lo, out_idx=out_idx,
            names=names, out_base=out_base, in_idx=in_idx, in_base=in_base,
            one_cell=None if sched.one_cell is None else int(sched.one_cell),
            in_widths=in_widths, out_widths=out_widths,
            k_out=sum(out_widths),
            fused_ok=bool(in_names) and
            max(in_widths + out_widths, default=0) <= 32,
            use_static=plan.schedule == "slots-static" and slots_ok,
            words_per_cta=plan.backend.words_per_cta,
            model=telemetry.COST_MODEL.schedule_cost(sched),
            packed=self.get_packed(program, plan, kind, device)
            if on_cuda else None)
        self.resolved[memo_key] = r
        return r

    def get_static_chain(self, program, plan: ExecPlan, in_names, fused,
                         in_widths, out_widths):
        """B2's plain version (``slots.build_static_chain``), memoized."""
        key = ("chain", tuple(in_names), fused, in_widths, out_widths,
               plan.layout.planes)
        if key not in self.static:
            s = self.get_schedule(program, plan, "slots")
            cells = _stacked_cells([s.pack_cells(n) for n in in_names])
            self.static[key] = kslots.build_static_chain(
                s, in_widths, out_widths, output_names(s), cells,
                seg_levels=plan.backend.seg_levels, fused=fused,
                planes=plan.layout.planes)
        return self.static[key]

    def get_static(self, program, plan: ExecPlan, in_names, in_widths,
                   out_widths) -> "pim_exec.StaticKernel":
        """B2: the generated static-slice kernel for this schedule, widths
        and layout, built here (from the artifact cache's binary tier, or
        by ``nvcc``) -- at first resolve, so a warm-up keeps ``nvcc`` out
        of every later call.  Memoized."""
        key = _static_key(plan, in_names, in_widths, out_widths)
        if key not in self.static:
            k = self._static_kernel(program, plan, in_names, in_widths,
                                    out_widths)
            k.build()
            self.static[key] = k
        return self.static[key]

    def _static_kernel(self, program, plan: ExecPlan, in_names, in_widths,
                       out_widths) -> "pim_exec.StaticKernel":
        """B2's kernel object, unbuilt; its ``tag`` is what the binary
        tier records to rebuild it (``ArtifactCache.warm``)."""
        s = self.get_schedule(program, plan, "slots")
        tag = {"kind": "static", "content": content_key(program).hex(),
               "compile_key": list(plan.compile_key),
               "in_names": list(in_names),
               "in_widths": [int(w) for w in in_widths],
               "out_widths": [int(w) for w in out_widths],
               "planes": plan.layout.planes,
               "words_per_cta": plan.backend.words_per_cta}
        return pim_exec.StaticKernel(
            s, in_widths, out_widths, output_names(s),
            _stacked_cells([s.pack_cells(n) for n in in_names]),
            planes=plan.layout.planes,
            words_per_cta=plan.backend.words_per_cta,
            seg_levels=plan.backend.seg_levels, tag=tag)

    def install_static(self, program, plan: ExecPlan, in_names, in_widths,
                       out_widths, so_name: str, data: bytes) -> bool:
        """Install B2's library from disk (``ArtifactCache.warm``): the
        kernel's source is regenerated from the resident schedule, and the
        bytes are written to the build directory only where its
        content-addressed name is ``so_name``.  False otherwise."""
        key = _static_key(plan, in_names, in_widths, out_widths)
        if key in self.static:
            return True
        if "slots" not in self.scheds:
            return False
        k = self._static_kernel(program, plan, in_names, in_widths,
                                out_widths)
        if k.so.name != so_name:
            return False
        pim_exec.publish(data, k.so)
        self.static[key] = k
        return True


def compiled(program, plan: Optional[ExecPlan] = None) -> _Compiled:
    key = cache_key(program, plan)
    with _CACHE_LOCK:
        entry = _compiled.get(key)
        if entry is None:
            entry = _compiled[key] = _Compiled()
            _CACHE.add("misses")
        else:
            _compiled.move_to_end(key)
            _CACHE.add("hits")
        _evict_over_cap(protect=key)
    return entry


def is_compiled(program, plan: Optional[ExecPlan] = None) -> bool:
    """True when the cache already holds ``program``'s levelized schedule
    for ``plan``'s schedule kind.  A pure query: never creates an entry,
    never touches LRU order."""
    plan = DEFAULT_PLAN if plan is None else plan
    key = cache_key(program, plan)
    with _CACHE_LOCK:
        entry = _compiled.get(key)
        return entry is not None and \
            _alloc_of(plan.schedule) in entry.scheds


def program_arrays(program):
    """(ops, a, b, out, n_cells) of the NOR-lowered program, cached by
    structural content hash (under the default plan's cache entry)."""
    return compiled(program).get_arrays(program)


def program_schedule(program, plan: Optional[ExecPlan] = None
                     ) -> LevelSchedule:
    """The levelized schedule of ``program`` (slot or dense allocation per
    the plan's schedule kind), cached per (structure, plan compile key)."""
    plan = DEFAULT_PLAN if plan is None else plan
    return compiled(program, plan).get_schedule(program, plan)


# --------------------------------------------------------------------------
# row-major <-> packed-column host bridges (numpy, fully vectorized)
# --------------------------------------------------------------------------

def _ports_of(ports_or_program) -> Dict[str, list]:
    return getattr(ports_or_program, "ports", ports_or_program)


def _value_limbs(vals, n_limbs: int, pad_rows: int) -> np.ndarray:
    """uint32[pad_rows, n_limbs] little-endian 32-bit limbs of per-row
    integers.  Wide ports (> 64 bits) go through an object-dtype array so
    arbitrary-precision values split without any per-row Python loop."""
    vals = np.asarray(vals)
    n = len(vals)
    limbs = np.zeros((pad_rows, n_limbs), np.uint32)
    if n_limbs <= 2 and vals.dtype != object:
        v = np.zeros(pad_rows, np.uint64)
        v[:n] = vals.astype(np.uint64)
        for j in range(n_limbs):
            limbs[:, j] = ((v >> np.uint64(32 * j))
                           & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    else:
        v = np.zeros(pad_rows, object)
        v[:n] = vals.astype(object)
        for j in range(n_limbs):
            limbs[:, j] = ((v >> (32 * j)) & 0xFFFFFFFF).astype(np.uint32)
    return limbs


def _le_bytes(arr: np.ndarray) -> np.ndarray:
    """Little-endian uint8 view of an integer array (copy only on BE hosts),
    so bit k of element e is bit k%8 of byte e*itemsize + k//8."""
    return np.ascontiguousarray(arr).astype(
        arr.dtype.newbyteorder("<"), copy=False).view(np.uint8)


def _pack_port_words(vals, nc: int, n_words: int,
                     layout: WordLayout = ROWS32) -> np.ndarray:
    """Packed words of one port's per-row integers: uint32[nc, n_words]
    under rows32 (bit w of word i is row 32*i + w), or the planes-leading
    uint32[planes, nc, n_words] under rows64 (plane h of word i covers
    rows ``64*i + 32*h + w``)."""
    n_limbs = (nc + 31) // 32
    n32 = n_words * layout.planes
    limbs = _value_limbs(vals, n_limbs, n32 * 32)
    # [pad_rows, 32 * n_limbs] -> cell-major [nc, pad_rows] bit matrix
    bits = np.unpackbits(_le_bytes(limbs), axis=1, bitorder="little")
    cols = np.ascontiguousarray(bits.T[:nc])
    words = np.packbits(cols.reshape(nc, n32, 32), axis=2,
                        bitorder="little")                    # [nc, n32, 4]
    w32 = words.reshape(nc, -1).view("<u4")
    if layout.planes == 1:
        return w32
    # uint32 word planes*i + h of rows32 is plane h of word i
    return np.ascontiguousarray(
        np.moveaxis(w32.reshape(nc, n_words, layout.planes), -1, 0))


def _sub_to_rows32(sub: np.ndarray) -> np.ndarray:
    """Collapse a planes-leading packed block back to the rows32 word
    order: (planes, k, n_words) -> (k, n_words * planes)."""
    if sub.ndim == 2:
        return sub
    planes, k, n_words = sub.shape
    return np.ascontiguousarray(
        np.moveaxis(sub, 0, -1).reshape(k, n_words * planes))


def pack_rows(values: Dict[str, np.ndarray], ports, n_rows: int,
              n_cells: int, one_cell: Optional[int] = None,
              pad_to: int = 1, layout: WordLayout = ROWS32,
              out: Optional[np.ndarray] = None) -> np.ndarray:
    """Pack per-row port integers into column-major word state:
    uint32[n_cells, n_words] under rows32 (bit w of state[c, i] = cell c
    of row 32*i + w), planes-leading uint32[planes, n_cells, n_words]
    under rows64.  ``ports`` is a name -> cell-list mapping (or any object
    with a ``.ports`` attribute); ``one_cell``, when given, is filled with
    ones (the schedule's folded INIT1 constant).  ``out``, when given, is
    the state array to fill (a staging buffer of that shape)."""
    ports = _ports_of(ports)
    n_words = layout.n_words(n_rows, pad_to)
    shape = layout.state_shape(n_cells, n_words)
    if out is None:
        state = np.zeros(shape, np.uint32)
    elif out.shape != shape:
        raise ValueError(f"out is {out.shape}, the state is {shape}")
    else:
        state = out
        state[...] = 0
    if one_cell is not None:
        state[..., one_cell, :] = _FULL
    for name, vals in values.items():
        cells = np.asarray(ports[name], np.int64)
        state[..., cells, :] = _pack_port_words(vals, len(cells), n_words,
                                                layout)
    return state


def unpack_rows(state: np.ndarray, ports, n_rows: int,
                names: Optional[Iterable[str]] = None
                ) -> Dict[str, np.ndarray]:
    """Inverse of :func:`pack_rows` (row-major ints); ``names`` restricts
    which ports are unpacked (default: all).  The layout is read from the
    state's rank.  Ports wider than 63 cells come back as object arrays
    of Python ints."""
    ports = _ports_of(ports)
    names = list(ports if names is None else names)
    all_cells = np.concatenate(
        [np.asarray(ports[n], np.int64) for n in names]) if names else \
        np.zeros(0, np.int64)
    state = np.asarray(state)
    sub = state[all_cells] if state.ndim == 2 else state[:, all_cells]
    return _unpack_sub(sub, [(n, len(ports[n])) for n in names], n_rows)


def _unpack_sub(sub: np.ndarray, name_widths, n_rows: int
                ) -> Dict[str, np.ndarray]:
    """Unpack pre-gathered port rows (stacked in ``name_widths`` order;
    rows32 2-D or planes-leading 3-D)."""
    sub = _sub_to_rows32(np.asarray(sub))
    out = {}
    off = 0
    for name, nc in name_widths:
        w = sub[off:off + nc]                                  # [nc, n_words]
        off += nc
        n_limbs = (nc + 31) // 32
        # word bits -> row-major bit matrix [n_rows, nc] -> limb matrix
        bits = np.unpackbits(_le_bytes(w), axis=1,
                             bitorder="little")[:, :n_rows]
        by = np.packbits(np.ascontiguousarray(bits.T), axis=1,
                         bitorder="little")                # [n_rows, ceil/8]
        if by.shape[1] != 4 * n_limbs:
            pad = np.zeros((n_rows, 4 * n_limbs), np.uint8)
            pad[:, :by.shape[1]] = by
            by = pad
        limbs = by.view("<u4")                             # [n_rows, n_limbs]
        if nc > 63:
            acc = np.zeros(n_rows, object)
            for j in range(n_limbs):
                acc |= limbs[:, j].astype(object) << (32 * j)
            out[name] = acc
        else:
            acc = limbs[:, 0].astype(np.uint64)
            if n_limbs > 1:
                acc |= limbs[:, 1].astype(np.uint64) << np.uint64(32)
            out[name] = acc
    return out




# --------------------------------------------------------------------------
# row sharding and deadlines
# --------------------------------------------------------------------------
#
# Every executor is elementwise along the packed word axis, so a dispatch
# splits that axis into contiguous blocks of whole words, one a shard, and
# runs each block on its shard's device with that device's operands and
# packed stream; the shards' outputs are concatenated at finalize.  No
# collective runs.  The word count is padded to a multiple of the shard
# count; under rows64 a word holds both planes, so the planes stay
# together.

def row_mesh(n_devices: Optional[int] = None) -> Optional[tuple]:
    """The CUDA devices ``cuda:0 .. cuda:n-1`` of this machine (all of
    them, or the first ``n_devices``) as a row mesh, or ``None`` when that
    is one device or none (the unsharded path).  It never names a device
    twice; an explicit ``mesh=`` may, one shard per entry."""
    n = torch.cuda.device_count()
    if n_devices is not None:
        n = min(int(n_devices), n)
    if n <= 1:
        return None
    return tuple(f"cuda:{i}" for i in range(n))


def _check_deadline(deadline: Optional[float]) -> None:
    """Raise :class:`DeadlineExceeded` when the absolute ``time.monotonic``
    deadline has passed (checked at dispatch and between chunks)."""
    if deadline is not None and time.monotonic() > deadline:
        raise DeadlineExceeded("deadline exceeded between chunks")


def _fit_packed(block, n_words: int):
    """Fit a pre-packed word block (numpy, or a tensor kept on the device
    between packed stages) to the dispatch's padded word count: zero-pad
    the trailing word axis (pad rows are all-zero by the packing contract)
    or reject a block wider than the padded shape."""
    have = block.shape[-1]
    if have == n_words:
        return block
    if have > n_words:
        raise ValueError(
            f"packed input has {have} words, dispatch shape allows "
            f"{n_words}")
    if isinstance(block, torch.Tensor):
        return torch.nn.functional.pad(block, (0, n_words - have))
    pad = np.zeros(block.shape[:-1] + (n_words - have,), np.uint32)
    return np.concatenate([block, pad], axis=-1)


# --------------------------------------------------------------------------
# verified execution under injected faults
# --------------------------------------------------------------------------
#
# A plan with a fault model and/or a verify policy runs every chunk, group
# and packed tree level through a detect -> retry -> remap loop, as the
# reference does: the dispatcher injects the model's faults into the output
# on its way to the host (numpy, ``FaultModel.inject_values`` /
# ``inject_packed``), and -- when both are set -- compares the host's refold
# of what it received with the XOR check fold the device computed before
# the readback (``pim_exec.check_words``, B6, on the compute stream behind
# the executor; its plain version on ``ref``).  A failed check re-runs the
# chunk; retries that keep failing re-home it onto a clean spare span.
# Wear and quarantine go to ``runtime.faults``.  A plan with neither never
# enters this machinery.

#: Cumulative health counters (faults_injected/detected/corrected,
#: retries, remapped_rows, spot_checks, spot_mismatches) on the global
#: telemetry registry's ``pim.health.*`` names; :func:`drain_health`
#: snapshots and resets them.
HEALTH: "telemetry.CounterGroup" = telemetry.REGISTRY.group("pim.health")


def drain_health() -> dict:
    """Snapshot and reset :data:`HEALTH`; returns the non-zero counters."""
    return HEALTH.drain()


class _Corrupt(Exception):
    """Internal: a chunk's verification failed (check-word mismatch or
    oracle spot-check miss); drives the retry loop, never escapes it."""


def _state_span(plan: ExecPlan, rows: int) -> int:
    """Physical rows covered by one dispatch's packed state, word padding
    included -- the span the media scan certifies and the injectors
    corrupt; the word count of ``_dispatch_levelized`` (padded to a
    multiple of the shard count)."""
    n_words = plan.layout.n_words(rows, len(plan.devices))
    return n_words * 32 * plan.layout.planes


def _chunk_salt(pkey: bytes, start: int) -> int:
    """Deterministic per-(program, chunk) transient-sampling salt."""
    return (int.from_bytes(pkey[:8], "little")
            ^ (start * 0x9E3779B97F4A7C15)) & ((1 << 64) - 1)


@dataclasses.dataclass
class _FaultCtx:
    """One dispatch attempt's injection + verification context, threaded
    into ``_dispatch_levelized``; its ``finalize`` calls the ``process_*``
    hook of its output representation on the host copy."""
    faults: Optional[FaultModel]
    verify: Optional[VerifyPolicy]
    row_base: int
    salt: int
    attempt: int

    @property
    def folds(self) -> bool:
        """The device folds a check plane: only when there is simulated
        media to distrust and a policy to act on a mismatch."""
        return self.faults is not None and self.verify is not None

    def _checked(self, clean_chk, data, axis: int, injected: int):
        if injected:
            HEALTH.add("faults_injected", injected)
        if clean_chk is not None and self.faults is not None:
            if not np.array_equal(np.bitwise_xor.reduce(data, axis=axis),
                                  clean_chk):
                HEALTH.add("faults_detected")
                raise _Corrupt("check-word mismatch")
        return data

    def process_values(self, o: np.ndarray, out_widths, n_levels: int,
                       clean_chk: Optional[np.ndarray]) -> np.ndarray:
        """Fused branch: ``o`` is uint32[n_ports, padded_rows]."""
        if self.folds and clean_chk is None:
            clean_chk = np.bitwise_xor.reduce(o, axis=0)
        injected = 0
        if self.faults is not None:
            o, injected = self.faults.inject_values(
                o, out_widths, row_base=self.row_base, salt=self.salt,
                attempt=self.attempt, n_levels=n_levels)
        return self._checked(clean_chk, o, 0, injected)

    def process_packed(self, sub: np.ndarray, n_levels: int,
                       clean_chk: Optional[np.ndarray]) -> np.ndarray:
        """io branch: ``sub`` is the packed output block (cell axis -2,
        rows32 2-D or planes-leading 3-D)."""
        if self.folds and clean_chk is None:
            clean_chk = np.bitwise_xor.reduce(sub, axis=sub.ndim - 2)
        injected = 0
        if self.faults is not None:
            sub, injected = self.faults.inject_packed(
                sub, row_base=self.row_base, salt=self.salt,
                attempt=self.attempt, n_levels=n_levels)
        return self._checked(clean_chk, sub, sub.ndim - 2, injected)


# Rows verified since the last oracle spot check, shared across calls so
# the oracle's cost amortizes per row served, not per call.  Starts
# saturated so the first verified execution in a process is spot-checked.
_spot_debt = 1 << 62


class _VerifyRun:
    """Per-execution (one streaming run, one group, one reduction tree)
    retry + remap state: the logical-start -> spare-span remap table and
    the spare allocator.  :data:`HEALTH` aggregates across runs."""

    def __init__(self, plan: ExecPlan):
        self.plan = plan
        self.faults = plan.faults
        self.policy = plan.verify
        self.spare_next = None if self.faults is None \
            else int(self.faults.spare_base)
        self.remap: Dict[int, int] = {}

    def _alloc(self, span: int) -> int:
        base = self.spare_next
        self.spare_next += (span + 63) // 64 * 64
        return base

    def _clean_spare(self, span: int, limit: int) -> int:
        base = self._alloc(span)
        tries = 0
        while self.faults.span_bad(base, span):
            tries += 1
            if tries > limit:
                raise FaultError(
                    f"media scan found no clean {span}-row spare span "
                    f"after {limit} candidates",
                    span_rows=span, scan_limit=limit)
            base = self._alloc(span)
        return base

    def place(self, start: int, span: int) -> int:
        """Physical base for the chunk at logical row ``start``: the
        existing remap target, or -- when the media scan flags the span's
        persistent faults -- a freshly scanned clean spare."""
        base = self.remap.get(start, start)
        if self.faults is None or self.policy is None:
            return base
        if self.faults.span_bad(base, span):
            note_quarantine(base, span)
            base = self._clean_spare(span, self.policy.scan_limit)
            self.remap[start] = base
            HEALTH.add("remapped_rows", span)
        return base

    def rehome(self, start: int, span: int) -> int:
        """Force a fresh spare placement: the current span keeps failing
        verification although the scan called it clean."""
        if self.faults is None:
            return self.remap.get(start, start)
        note_quarantine(self.remap.get(start, start), span)
        base = self._clean_spare(span, self.policy.scan_limit)
        self.remap[start] = base
        HEALTH.add("remapped_rows", span)
        return base

    def maybe_spot(self, program, inputs, n_rows: int, out: dict) -> None:
        """Amortized oracle spot check: every ``spot_interval_rows``
        verified rows, recompute ``spot_rows`` sampled rows on the numpy
        oracle and compare bit-exactly (catches what the per-word parity
        cannot, such as two flips of one bit position).  Raises
        :class:`_Corrupt` on a mismatch so the chunk retries."""
        global _spot_debt
        pol = self.policy
        if pol is None or pol.spot_rows <= 0 or n_rows <= 0:
            return
        _spot_debt += n_rows
        if _spot_debt < pol.spot_interval_rows:
            return
        _spot_debt = 0
        HEALTH.add("spot_checks")
        k = min(pol.spot_rows, n_rows)
        idx = np.unique(np.linspace(0, n_rows - 1, num=k, dtype=np.int64))
        sub_in = {n: np.asarray(v)[idx] for n, v in inputs.items()}
        # the oracle runs on the host: no mesh, no device, no faults
        oplan = dataclasses.replace(
            self.plan, backend=BACKENDS["numpy"], mesh=None, layout=ROWS32,
            chunk_rows=None, device="cpu", faults=None, verify=None)
        want = run_program(program, sub_in, int(idx.size), oplan)
        for name, w in want.items():
            if not np.array_equal(np.asarray(out[name])[idx], w):
                HEALTH.add("spot_mismatches")
                HEALTH.add("faults_detected")
                raise _Corrupt(f"oracle spot check mismatch on {name!r}")


def _retry_loop(plan: ExecPlan, vrun: _VerifyRun, start: int, span: int,
                dispatch: Callable, base: int, failed: Callable,
                check: Callable = lambda out: None,
                deadline: Optional[float] = None) -> Callable:
    """The ``finalize`` of a verified dispatch: wait for attempt 0
    (launched now, asynchronously, as a plain dispatch is), run ``check``
    on its result, and re-dispatch synchronously while it fails --
    re-homing the span from ``remap_after`` retries on.  ``failed(attempt)``
    builds the :class:`FaultError` raised after ``max_retries``."""
    first = dispatch(0, base)

    def finalize():
        pol = plan.verify
        attempt, row_base, fin = 0, base, first
        while True:
            try:
                out = fin()
                check(out)
                break
            except _Corrupt:
                attempt += 1
                if pol is None or attempt > pol.max_retries:
                    raise failed(attempt) from None
                HEALTH.add("retries")
                _check_deadline(deadline)
                time.sleep(min(pol.backoff_s * (1 << (attempt - 1)), 0.05))
                if attempt >= pol.remap_after and plan.faults is not None:
                    row_base = vrun.rehome(start, span)
                fin = dispatch(attempt, row_base)
        if attempt:
            HEALTH.add("faults_corrected")
        return out

    return finalize


def _verified_dispatch(program, inputs: Dict[str, np.ndarray], n_rows: int,
                       plan: ExecPlan, pad_rows: Optional[int],
                       vrun: _VerifyRun, start: int) -> Callable:
    """Dispatch one chunk (logical rows from ``start``) under the plan's
    fault model / verify policy; returns a ``finalize`` that runs the
    detect -> retry -> remap loop and the amortized oracle spot check."""
    span = _state_span(plan, n_rows if pad_rows is None else pad_rows)
    base = vrun.place(start, span)
    pkey = content_key(program)
    salt = _chunk_salt(pkey, start)

    def dispatch(attempt: int, row_base: int) -> Callable:
        fctx = _FaultCtx(plan.faults, plan.verify, row_base, salt, attempt)
        record_wear(row_base, span)           # every attempt writes media
        return _dispatch_levelized(program, inputs, n_rows, plan,
                                   pad_rows=pad_rows, fctx=fctx)

    def failed(attempt: int) -> FaultError:
        return FaultError(
            f"rows [{start}, {start + n_rows}): verification still "
            f"failing after {attempt - 1} retries",
            program_key=pkey[:8].hex(), chunk_start=start, rows=n_rows,
            attempts=attempt, remapped_base=vrun.remap.get(start))

    return _retry_loop(
        plan, vrun, start, span, dispatch, base, failed,
        check=lambda out: vrun.maybe_spot(program, inputs, n_rows, out))


def _verified_dispatch_packed(program, n_rows: int, plan: ExecPlan,
                              vrun: _VerifyRun, stage: int, *,
                              inputs=None, packed_in=None, in_names=None,
                              device_out: bool = False,
                              deadline: Optional[float] = None) -> Callable:
    """A packed-domain stage under the plan's fault model / verify policy
    (the reduction trees' :func:`_verified_dispatch`).  Every stage is its
    own verify cut-point: the check plane folds the whole packed block,
    zero pad rows included, and the stage's input block (``packed_in``) is
    kept until the stage passes, so a detected corruption re-runs only
    this stage.  The tree shares one ``vrun`` keyed at logical row 0 (a
    remap sticks for every later level); ``stage`` salts each level's
    transient stream.  ``device_out`` keeps the output on the device (see
    :func:`_dispatch_levelized`); with no fault model nothing is injected
    or checked, so a verify-only tree keeps its blocks there."""
    if device_out and plan.faults is not None:
        raise ValueError("a stage under a fault model is injected and "
                         "checked on the host: device_out needs "
                         "faults=None")
    span = _state_span(plan, n_rows)
    base = vrun.place(0, span)
    pkey = content_key(program)
    salt = _chunk_salt(pkey, stage)
    names = inputs if packed_in is None else {n: None for n in in_names}

    def dispatch(attempt: int, row_base: int) -> Callable:
        fctx = _FaultCtx(plan.faults, plan.verify, row_base, salt, attempt)
        record_wear(row_base, span)
        return _dispatch_levelized(program, names, n_rows, plan, fctx=fctx,
                                   packed_in=packed_in, packed_out=True,
                                   device_out=device_out)

    def failed(attempt: int) -> FaultError:
        return FaultError(
            f"packed stage {stage} ({n_rows} rows): verification still "
            f"failing after {attempt - 1} retries",
            program_key=pkey[:8].hex(), stage=stage, rows=n_rows,
            attempts=attempt, remapped_base=vrun.remap.get(0))

    return _retry_loop(plan, vrun, 0, span, dispatch, base, failed,
                       deadline=deadline)


def _needs_ft(plan: ExecPlan) -> bool:
    return plan.faults is not None or plan.verify is not None


# --------------------------------------------------------------------------
# execution
# --------------------------------------------------------------------------

def _run_fused(comp, program, plan: ExecPlan, r: _Resolved, in_names,
               x: torch.Tensor) -> torch.Tensor:
    """One fused launch on ``x`` (int32[n_in_ports, n_rows] on the
    shard's device): the executor the resolved binding names."""
    on_cuda = plan.backend.name == "cuda"
    sched_args = (r.in_idx, r.la, r.lb, r.lo, r.out_idx)
    kw = dict(n_cells=r.sched.n_cells, one_cell=r.one_cell,
              words_per_cta=r.words_per_cta, in_widths=r.in_widths,
              out_widths=r.out_widths, planes=plan.layout.planes)
    if r.use_static and not on_cuda:
        return comp.get_static_chain(program, plan, in_names, True,
                                     r.in_widths, r.out_widths)(x)
    if r.use_static and r.in_base == 0:
        return comp.get_static(program, plan, in_names, r.in_widths,
                               r.out_widths)(x)
    if r.kind != "dense":
        run = pim_exec.slots_fused if on_cuda else kslots.slots_fused
        if on_cuda:
            kw["packed"] = r.packed
        return run(x, *sched_args, in_base=r.in_base, out_base=r.out_base,
                   **kw)
    if on_cuda:
        return pim_exec.level_fused(x, *sched_args, packed=r.packed, **kw)
    return kref.pim_exec_ref_level_fused(x, *sched_args, **kw)


def _run_io(comp, program, plan: ExecPlan, r: _Resolved, in_names,
            x: torch.Tensor) -> torch.Tensor:
    """One io launch on packed port rows ``x`` (int32[k_in, n_words],
    planes-leading under rows64, on the shard's device)."""
    on_cuda = plan.backend.name == "cuda"
    sched_args = (r.in_idx, r.la, r.lb, r.lo, r.out_idx)
    common = dict(n_cells=r.sched.n_cells, one_cell=r.one_cell,
                  words_per_cta=r.words_per_cta)
    if r.use_static and not on_cuda:
        return comp.get_static_chain(program, plan, in_names, False,
                                     r.in_widths, r.out_widths)(x)
    if r.kind != "dense":
        # (slots-static on cuda has no wide-port static kernel; the slot
        # scan is the closest shape, as in the reference)
        if on_cuda:
            return pim_exec.slots_io(x, *sched_args, k_out=r.k_out,
                                     in_base=r.in_base, out_base=r.out_base,
                                     packed=r.packed, **common)
        return kslots.slots_io(x, *sched_args, k_out=r.k_out,
                               in_base=r.in_base, out_base=r.out_base,
                               **common)
    if on_cuda:
        return pim_exec.level_io(x, *sched_args, packed=r.packed, **common)
    return kref.pim_exec_ref_level_io(x, *sched_args, **common)


def _gathered(parts: list, consume):
    """``consume`` of the shards' downloads, each array joined along its
    last (word or row) axis; one shard's are read straight out of its
    staging buffer."""
    if len(parts) == 1:
        return parts[0].result(consume)
    got = [p.result(lambda *a: [np.array(x) for x in a]) for p in parts]
    return consume(*(np.concatenate(col, axis=-1) for col in zip(*got)))


def _dispatch_levelized(program, inputs: Dict[str, np.ndarray], n_rows: int,
                        plan: ExecPlan, pad_rows: Optional[int] = None, *,
                        fctx: Optional[_FaultCtx] = None,
                        packed_in=None, packed_out: bool = False,
                        device_out: bool = False):
    """Pack ``inputs`` and launch one levelized execution under ``plan``;
    returns a zero-arg ``finalize`` that waits for the result's copy to
    the host and unpacks it.  The launch is asynchronous, so a caller can
    fill its next chunk on the host while this one runs (on a CUDA device
    through the pinned staging buffers and copy streams of
    ``kernels.transfer``).  ``pad_rows`` (>= n_rows) sets the padded word
    count, as a streaming chunk's.

    Under a plan with a mesh, each shard takes a contiguous block of whole
    words (the word count padded to a multiple of the shard count) and
    runs on its own device; the blocks are joined at finalize.

    ``packed_in``/``packed_out`` keep the data in the packed word domain:
    ``packed_in`` is a word block (numpy uint32, or an int32 tensor kept
    on the device) whose cell axis stacks the in-ports' cells in
    sorted-name order (``inputs`` then only names the ports), and
    ``packed_out`` makes ``finalize`` return the packed output block
    (out-ports stacked in ``output_names`` order) as numpy uint32 -- or,
    with ``device_out``, as an int32 tensor on the mesh's first device,
    made on its compute stream, which a packed stage takes as its
    ``packed_in`` without a trip through the host.

    ``fctx`` is a verified dispatch's attempt (:class:`_FaultCtx`):
    finalize hands the host copy to its ``process_*`` hook (injection,
    check).  Under a fault model the fused branch stages and runs every
    shard's whole padded span, zero inputs in the pad, as the injectors
    address physical rows of it; with a verify policy too, the check fold
    (B6) runs on the output behind the executor and comes back with it.

    When ``telemetry.TRACER`` is enabled, finalize records an ``exec``
    event (``cat="pim.exec"``, with ``rows``, ``levels`` and ``kind``)
    from the launch to its own return; for a ``device_out`` stage that is
    when the tensor is handed over, not when the device is done.  While
    the tracer is live, the host's own work is ``pim.host`` spans that
    never nest in one another: ``run.stage`` (filling a staging buffer
    with values or a packed block), ``run.pack`` (packing port bits),
    ``run.unpack`` (a result back in host rows; ``run.wait`` is the
    copy's, in ``kernels.transfer``)."""
    comp = compiled(program, plan)
    in_names = sorted(inputs)
    devices = tuple(_checked_device(d) for d in plan.devices)
    rs = {d: comp.resolve(program, plan, tuple(in_names), device=d)
          for d in dict.fromkeys(devices)}
    r = rs[devices[0]]
    telemetry.record_dispatch(n_rows, r.model)
    tracer = telemetry.TRACER
    t_disp = time.perf_counter() if tracer.enabled else 0.0

    def traced(fin: Callable) -> Callable:
        if not tracer.enabled:
            return fin

        def wrapped():
            out = fin()
            tracer.event("exec", t_disp, time.perf_counter(),
                         cat="pim.exec", rows=n_rows,
                         levels=int(r.sched.n_levels), kind=r.kind)
            return out
        return wrapped

    layout = plan.layout
    rpw = layout.rows_per_word
    shards = len(devices)
    n_words = layout.n_words(n_rows if pad_rows is None else pad_rows,
                             shards)
    wps = n_words // shards                 # words a shard
    injects = fctx is not None and fctx.faults is not None
    fold = None
    if fctx is not None and fctx.folds:
        fold = pim_exec.check_words if plan.backend.name == "cuda" \
            else kref.check_words
    use_fused = r.fused_ok and packed_in is None and not packed_out
    if use_fused:
        vals = [np.asarray(inputs[n]) for n in in_names]
        use_fused = all(v.dtype != object for v in vals)
    parts = []
    with transfer.computing(devices):
        if use_fused:
            for s, dev in enumerate(devices):
                lo = min(s * wps * rpw, n_rows)
                hi = min(lo + wps * rpw, n_rows)
                if s and hi == lo and not injects:
                    continue                 # a shard of padding only
                lane = transfer.lane(dev, s)
                staged = lane.stage((len(vals),
                                     wps * rpw if injects else hi - lo))
                with tracer.span("run.stage", "pim.host"):
                    for p, v in enumerate(vals):
                        staged.array[p, :hi - lo] = v[lo:hi]  # cast in place
                        staged.array[p, hi - lo:] = 0
                outs = _run_fused(comp, program, plan, rs[dev], in_names,
                                  lane.upload(staged))
                parts.append(lane.download(outs) if fold is None else
                             lane.download(outs, fold(outs, 0)))

            def finalize() -> Dict[str, np.ndarray]:
                def consume(o, chk=None):
                    if fctx is not None:
                        o = fctx.process_values(o, r.out_widths,
                                                r.sched.n_levels, chk)
                    with tracer.span("run.unpack", "pim.host"):
                        return o[:, :n_rows].astype(np.uint64)
                o = _gathered(parts, consume)
                return {n: o[p] for p, n in enumerate(r.names)}
            return traced(finalize)

        k_in = sum(len(r.sched.pack_cells(n)) for n in in_names)
        if packed_in is not None:
            if packed_in.shape[-2] != k_in:
                raise ValueError(
                    f"packed input stacks {packed_in.shape[-2]} cells, "
                    f"in-ports {in_names} need {k_in}")
            if not isinstance(packed_in, torch.Tensor):
                packed_in = np.asarray(packed_in, np.uint32)
            packed_in = _fit_packed(packed_in, n_words)
        subs = []
        for s, dev in enumerate(devices):
            w0 = s * wps
            lane = transfer.lane(dev, s)
            if isinstance(packed_in, torch.Tensor):
                x = packed_in[..., w0:w0 + wps].to(dev).contiguous()
            else:
                staged = lane.stage(layout.state_shape(k_in, wps))
                if packed_in is not None:
                    with tracer.span("run.stage", "pim.host"):
                        staged.array[...] = packed_in[..., w0:w0 + wps]
                else:
                    lo = min(w0 * rpw, n_rows)
                    hi = min(lo + wps * rpw, n_rows)
                    off = 0
                    with tracer.span("run.pack", "pim.host"):
                        for n in in_names:
                            nc = len(r.sched.pack_cells(n))
                            staged.array[..., off:off + nc, :] = \
                                _pack_port_words(
                                    np.asarray(inputs[n])[lo:hi], nc, wps,
                                    layout)
                            off += nc
                x = lane.upload(staged)
            subs.append(_run_io(comp, program, plan, rs[dev], in_names, x))
        if device_out:
            out = subs[0] if shards == 1 else torch.cat(
                [t.to(devices[0]) for t in subs], dim=-1)
            return traced(lambda: out)
        parts = [transfer.lane(dev, s).download(
                     t, *(() if fold is None else (fold(t, t.dim() - 2),)))
                 for s, (dev, t) in enumerate(zip(devices, subs))]

    name_widths = [(n, len(r.sched.ports[n])) for n in r.names]

    def finalize():
        def consume(sub, chk=None):
            if fctx is not None:
                sub = fctx.process_packed(sub, r.sched.n_levels, chk)
            if packed_out:
                return np.array(sub)
            with tracer.span("run.unpack", "pim.host"):
                return _unpack_sub(sub, name_widths, n_rows)
        return _gathered(parts, consume)
    return traced(finalize)


def _run_gate_serial(program, inputs: Dict[str, np.ndarray], n_rows: int,
                     plan: ExecPlan) -> Dict[str, np.ndarray]:
    """The gate-serial executor (B4, or its plain version on ``ref``):
    the whole lowered state is packed on the host, run one gate at a
    time, and unpacked."""
    device = _checked_device(plan.device)
    comp = compiled(program, plan)
    telemetry.record_dispatch(n_rows, comp.get_serial_model(program))
    n_cells = comp.get_arrays(program)[4]
    *gates, packed = comp.get_gates(program, device)
    lane = transfer.lane(device)
    staged = lane.stage(ROWS32.state_shape(n_cells, ROWS32.n_words(n_rows)))
    with telemetry.TRACER.span("run.pack", "pim.host"):
        pack_rows(inputs, program.ports, n_rows, n_cells, out=staged.array)
    with transfer.computing((device,)):
        state = lane.upload(staged)
        if plan.backend.name == "cuda":
            final = pim_exec.gate_serial(state, *gates, packed=packed)
        else:
            final = kref.pim_exec_ref(state, *gates)
        out = lane.download(final)

    def consume(st):
        with telemetry.TRACER.span("run.unpack", "pim.host"):
            return unpack_rows(st, program.ports, n_rows,
                               names=output_names(program))
    return out.result(consume)


def run_program(program, inputs: Dict[str, np.ndarray], n_rows: int,
                plan=None, levelized: bool = True, *, backend=None,
                mesh=None, schedule=None, layout=None, device=None
                ) -> Dict[str, np.ndarray]:
    """Element-parallel execution of a gate program over ``n_rows`` rows.

    ``plan`` is an :class:`ExecPlan` -- or a backend name ('cuda' the
    Hopper kernels, 'ref' their plain PyTorch versions, 'numpy' the
    gate-serial oracle); the keywords build a plan at this boundary.
    'cuda' and 'ref' run the plan's levelized schedule by default;
    ``levelized=False`` selects the gate-serial executors (rows32, one
    device).  The plan's mesh (see :func:`row_mesh`) shards the packed
    word axis over devices.  A plan with a fault model or a verify
    policy runs the verified detect -> retry -> remap loop (levelized
    executors only).  Returns the program's output ports (every port for
    direction-less programs, the :func:`output_names` contract)."""
    plan = as_plan(plan, backend=backend, mesh=mesh, schedule=schedule,
                   layout=layout, device=device)
    if not levelized and (plan.mesh is not None or plan.layout.planes > 1):
        raise ValueError(
            "mesh sharding requires a levelized backend "
            f"(got backend={plan.backend.name!r}, levelized={levelized})"
            if plan.mesh is not None else
            f"layout {plan.layout.name!r} requires the levelized executors")
    if not levelized and _needs_ft(plan):
        raise ValueError("fault injection / verified execution require "
                         "the levelized executors")
    if plan.backend.name == "numpy":
        telemetry.record_dispatch(n_rows, _serial_model(program))
        state = pack_rows(inputs, program.ports, n_rows, program.n_cells)
        st = np.ascontiguousarray(state.T)
        program.exec_packed(st)
        return unpack_rows(st.T, program.ports, n_rows,
                           names=output_names(program))
    if not levelized:
        return _run_gate_serial(program, inputs, n_rows, plan)
    if _needs_ft(plan):
        return _verified_dispatch(program, inputs, n_rows, plan, None,
                                  _VerifyRun(plan), 0)()
    return _dispatch_levelized(program, inputs, n_rows, plan)()


def _row_inputs(inputs: Dict[str, np.ndarray], n_rows: int,
                what: str = "input") -> Dict[str, np.ndarray]:
    inputs = {n: np.asarray(v) for n, v in inputs.items()}
    for n, v in inputs.items():
        if len(v) != n_rows:
            raise ValueError(
                f"{what} {n!r} has {len(v)} rows, expected {n_rows}")
    return inputs


def run_program_streaming(program, inputs: Dict[str, np.ndarray],
                          n_rows: int, plan=None, *, backend=None,
                          chunk_rows=None, mesh=None, schedule=None,
                          layout=None, device=None,
                          deadline: Optional[float] = None
                          ) -> Dict[str, np.ndarray]:
    """Chunked, pipelined, optionally sharded execution over ``n_rows``.

    Rows are tiled into word-aligned chunks of the plan's chunk size; the
    loop launches chunk ``k``, fills chunk ``k+1``'s staging buffer on the
    host while ``k`` runs (on a CUDA device its copy in may run while
    ``k``'s kernel does), then waits for ``k``'s result.  Every chunk, the ragged last
    one too, has the padded word count of a whole chunk.  The plan's mesh
    additionally shards each chunk's word axis over devices.

    ``deadline`` is an absolute ``time.monotonic()`` bound checked before
    dispatch and between chunks (:class:`DeadlineExceeded` on expiry).
    A plan with a fault model or a verify policy runs every chunk through
    the detect -> retry -> remap loop, one :class:`_VerifyRun` for the
    whole run.  Joining the chunks' results is a ``run.join`` span of
    ``telemetry.TRACER``."""
    plan = as_plan(plan, backend=backend, chunk_rows=chunk_rows, mesh=mesh,
                   schedule=schedule, layout=layout, device=device)
    if plan.backend.name == "numpy":
        raise ValueError("streaming requires a levelized backend "
                         "('cuda' or 'ref'), got 'numpy'")
    chunk = plan.effective_chunk_rows
    _check_deadline(deadline)
    vrun = _VerifyRun(plan) if _needs_ft(plan) else None
    if n_rows <= chunk:
        if vrun is None:
            return run_program(program, inputs, n_rows, plan)
        return _verified_dispatch(program, inputs, n_rows, plan, None,
                                  vrun, 0)()
    inputs = _row_inputs(inputs, n_rows)
    parts = []
    pending = None
    for start in range(0, n_rows, chunk):
        _check_deadline(deadline)
        rows_k = min(chunk, n_rows - start)
        chunk_in = {n: v[start:start + rows_k] for n, v in inputs.items()}
        if vrun is None:
            fin = _dispatch_levelized(program, chunk_in, rows_k, plan,
                                      pad_rows=chunk)
        else:
            fin = _verified_dispatch(program, chunk_in, rows_k, plan,
                                     chunk, vrun, start)
        if pending is not None:
            parts.append(pending())     # waits on k-1 while k runs
        pending = fin
    parts.append(pending())
    with telemetry.TRACER.span("run.join", "pim.host"):
        return {name: np.concatenate([p[name] for p in parts])
                for name in parts[0]}


def dispatch_program(program, inputs: Dict[str, np.ndarray], n_rows: int,
                     plan=None, *, backend=None, mesh=None, schedule=None,
                     layout=None, device=None, pad_rows: Optional[int] = None
                     ) -> Callable:
    """Launch one levelized execution asynchronously; returns a zero-arg
    ``finalize`` that waits for the result and unpacks the output ports.
    The pipelining primitive behind :func:`run_program_streaming` and
    :func:`run_program_groups`: callers fill the next unit of work on the
    host while this one runs.  Under a fault model or a verify policy the
    ``finalize`` runs the detect -> retry -> remap loop."""
    plan = as_plan(plan, backend=backend, mesh=mesh, schedule=schedule,
                   layout=layout, device=device)
    if plan.backend.name == "numpy":
        raise ValueError("dispatch requires a levelized backend, got "
                         f"{plan.backend.name!r}")
    if _needs_ft(plan):
        return _verified_dispatch(program, inputs, n_rows, plan, pad_rows,
                                  _VerifyRun(plan), 0)
    return _dispatch_levelized(program, inputs, n_rows, plan,
                               pad_rows=pad_rows)


def _packed_stage(program, n_rows: int, plan: ExecPlan, *, inputs=None,
                  in_block=None, in_names=None, vrun=None, stage: int = 0,
                  device_out: bool = False,
                  deadline: Optional[float] = None) -> Callable:
    """:func:`dispatch_packed` after its argument checks; ``device_out``
    keeps the output block on the device (see :func:`_dispatch_levelized`),
    the form the reduction trees chain their levels with.  A plan with a
    fault model or a verify policy runs the stage verified, under
    ``vrun`` (a fresh one when None)."""
    _check_deadline(deadline)
    if in_block is not None and not in_names:
        raise ValueError("in_block requires in_names")
    if _needs_ft(plan):
        return _verified_dispatch_packed(
            program, n_rows, plan, vrun or _VerifyRun(plan), stage,
            inputs=inputs, packed_in=in_block, in_names=in_names,
            device_out=device_out, deadline=deadline)
    if in_block is not None:
        return _dispatch_levelized(program, {n: None for n in in_names},
                                   n_rows, plan, packed_in=in_block,
                                   packed_out=True, device_out=device_out)
    return _dispatch_levelized(program, inputs, n_rows, plan,
                               packed_out=True, device_out=device_out)


def dispatch_packed(program, n_rows: int, plan=None, *,
                    inputs: Optional[Dict[str, np.ndarray]] = None,
                    in_block: Optional[np.ndarray] = None,
                    in_names: Optional[Tuple[str, ...]] = None,
                    vrun=None, stage: int = 0,
                    deadline: Optional[float] = None) -> Callable:
    """Launch one levelized execution that stays in the packed word
    domain; returns a zero-arg ``finalize`` yielding the packed output
    block (uint32, out-ports' cells stacked in ``output_names`` order,
    rows packed 32 per word along the trailing axis -- rows64 plans keep
    the planes-leading 3-D state shape).

    Feed it either ``inputs`` (row-value dict, packed once on the way in)
    or ``in_block`` + ``in_names`` (a block from a previous packed
    dispatch, cell axis stacking the named in-ports in sorted order) --
    the primitive behind the in-memory reduction trees of ``pim.dot``/
    ``pim.gemv``.  A plan with a fault model or a verify policy runs the
    stage through the packed detect -> retry -> remap loop: pass one
    shared ``vrun`` across a tree's stages (a remap sticks for later
    levels, and a failed stage retries from its own input block, not the
    leaves) and a distinct ``stage`` ordinal to salt each level's
    transient stream.  ``deadline`` (absolute ``time.monotonic()``) is
    checked before dispatch and between retry attempts."""
    plan = as_plan(plan)
    if plan.backend.name == "numpy":
        raise ValueError("packed dispatch requires a levelized backend, "
                         f"got {plan.backend.name!r}")
    if (in_block is None) == (inputs is None):
        raise ValueError("pass exactly one of inputs= or in_block=")
    if in_block is not None:
        in_block = np.ascontiguousarray(np.asarray(in_block, np.uint32))
    return _packed_stage(program, n_rows, plan, inputs=inputs,
                         in_block=in_block, in_names=in_names, vrun=vrun,
                         stage=stage, deadline=deadline)


def run_program_groups(groups: Iterable[dict]) -> list:
    """Execute several program groups back to back with cross-group
    pipelining; returns their output dicts in input order.

    Each group is a dict: ``program``, ``inputs`` (port name -> row
    values), ``n_rows``, plus a ``plan`` (:class:`ExecPlan`; the
    ``backend``/``schedule``/``layout``/``mesh``/``chunk_rows``/
    ``device`` keys normalize into one here, at the boundary).  The loop
    launches group ``k`` and fills group ``k+1`` on the host while ``k``
    runs -- the streaming pipeline across different programs.  Groups
    larger than their plan's chunk size tile into word-aligned chunks
    inside the same pipeline.  A numpy-backend group is a synchronization
    point (the oracle runs on the host).  A group may carry a
    ``deadline`` (absolute ``time.monotonic()``), checked before each of
    its chunks is launched.  A plan with a fault model or a verify policy
    runs its group's chunks through the detect -> retry -> remap loop (one
    :class:`_VerifyRun` a group).

    When ``telemetry.TRACER`` is enabled, each group's input check and the
    final join of each group's chunk outputs record ``inputs`` and
    ``join`` events (``cat="pim.groups"``) beside the dispatcher's
    ``exec`` events."""
    groups = list(groups)
    tracer = telemetry.TRACER
    parts: list = [[] for _ in groups]
    pending: "collections.deque" = collections.deque()

    def drain(limit: int) -> None:
        while len(pending) > limit:
            gi, fin = pending.popleft()
            parts[gi].append(fin())

    for gi, g in enumerate(groups):
        program, n_rows = g["program"], int(g["n_rows"])
        plan = as_plan(g.get("plan"), backend=g.get("backend"),
                       schedule=g.get("schedule"), layout=g.get("layout"),
                       mesh=g.get("mesh"), chunk_rows=g.get("chunk_rows"),
                       device=g.get("device"))
        deadline = g.get("deadline")
        t_in = time.perf_counter()
        inputs = _row_inputs(g["inputs"], n_rows, f"group {gi}: input")
        tracer.event("inputs", t_in, time.perf_counter(), cat="pim.groups",
                     group=gi, rows=n_rows)
        if plan.backend.name == "numpy":
            drain(0)
            _check_deadline(deadline)
            parts[gi].append(run_program(program, inputs, n_rows, plan))
            continue
        vrun = _VerifyRun(plan) if _needs_ft(plan) else None
        chunk = plan.effective_chunk_rows
        if n_rows <= chunk:
            _check_deadline(deadline)
            pending.append((gi, _dispatch_levelized(
                program, inputs, n_rows, plan) if vrun is None
                else _verified_dispatch(program, inputs, n_rows, plan,
                                        None, vrun, 0)))
            drain(1)
            continue
        for start in range(0, n_rows, chunk):
            _check_deadline(deadline)
            rows_k = min(chunk, n_rows - start)
            chunk_in = {n: v[start:start + rows_k]
                        for n, v in inputs.items()}
            pending.append((gi, _dispatch_levelized(
                program, chunk_in, rows_k, plan, pad_rows=chunk)
                if vrun is None
                else _verified_dispatch(program, chunk_in, rows_k, plan,
                                        chunk, vrun, start)))
            drain(1)
    drain(0)
    t_join = time.perf_counter()
    outs = [ps[0] if len(ps) == 1 else
            {k: np.concatenate([p[k] for p in ps]) for k in ps[0]}
            for ps in parts]
    tracer.event("join", t_join, time.perf_counter(), cat="pim.groups",
                 groups=len(parts), chunks=sum(len(ps) for ps in parts))
    return outs
