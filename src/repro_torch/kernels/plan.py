"""The compile->execute pipeline's configuration IR.

The PyTorch/CUDA counterpart of ``repro.kernels.plan``:

* :class:`WordLayout` -- how rows pack into the trailing word axis of the
  executor state (``rows32``: 32 rows per 32-bit word, state
  ``[n_cells, n_words]``; ``rows64``: 64 rows per word pair, a leading
  plane axis of 2).
* :class:`Backend` -- the executor family plus its tunables.  ``cuda`` is
  the hand-written Hopper kernels (``kernels.pim_exec``), ``ref`` their
  plain PyTorch versions (``kernels.slots``, ``kernels.ref``), ``numpy``
  the gate-serial oracle.
* :class:`ExecPlan` -- one immutable description of how a program runs:
  backend, schedule kind, word layout, streaming chunk size, the torch
  device and the row mesh (the devices the packed word axis is split over,
  one shard each).  ``plan.key`` is the full execution identity,
  ``plan.compile_key`` the compiled-program cache's per-plan identity.

:func:`as_plan` is the boundary normalizer: public entry points accept the
convenience strings and convert them to a plan exactly once.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..runtime.faults import FaultModel, VerifyPolicy

# Schedule compilation modes, as in the reference:
#   'slots'        -- contiguous-slot schedule, slot-scan executor (B1);
#   'slots-static' -- slot schedule, straight-line executor: the generated
#                     static-slice kernel (B2) on 'cuda' for fused calls
#                     whose inputs are the leading run, the segmented
#                     static chain on 'ref';
#   'dense'        -- dense index-matrix schedule, gather -> NOR -> scatter
#                     per level (B3).
DEFAULT_SCHEDULE = "slots"
SCHEDULES = ("slots", "slots-static", "dense")


@dataclasses.dataclass(frozen=True)
class WordLayout:
    """How per-row bits pack into the executor's word state.

    ``planes`` is the leading batch axis of the state: 1 keeps the 2-D
    ``[n_cells, n_words]`` state, 2 is the paired layout
    ``[2, n_cells, n_words]`` where word ``i``'s planes are the low and
    high 32-bit halves of one 64-row word."""
    name: str
    planes: int

    @property
    def rows_per_word(self) -> int:
        return 32 * self.planes

    def n_words(self, n_rows: int, pad_to: int = 1) -> int:
        """Trailing word-axis length covering ``n_rows``, padded up to a
        multiple of ``pad_to`` (and at least ``pad_to``)."""
        rpw = self.rows_per_word
        words = (n_rows + rpw - 1) // rpw
        return max((words + pad_to - 1) // pad_to * pad_to, pad_to)

    def state_shape(self, n_cells: int, n_words: int) -> tuple:
        """Executor state shape: 2-D for one plane, planes-leading 3-D."""
        if self.planes == 1:
            return (n_cells, n_words)
        return (self.planes, n_cells, n_words)

    def __str__(self) -> str:
        return self.name


ROWS32 = WordLayout("rows32", 1)
ROWS64 = WordLayout("rows64", 2)
LAYOUTS = {"rows32": ROWS32, "rows64": ROWS64}
DEFAULT_LAYOUT = ROWS32


# Canonical tunable defaults, read by the Backend descriptors below.
#
# SLOT_WIDTH: W of the contiguous-slot allocator, and LEVEL_MAX_WIDTH the
# dense schedule's width cap.  Both stay at the reference's 6 and 8 so both
# packages levelize to byte-identical schedules (the parity tests hold the
# executors against each other on those).  LEVEL_MAX_WIDTH is also the
# widest window of the ring kernels' packed streams (kWin in csrc/ring.cuh):
# the slot scan and the level gather run a level as one window of 2, 4 or
# 8 records, so a cuda plan takes slot widths and dense caps of 1 to 8, and
# a wider one runs only on 'ref'.
# SLOT_SEG_LEVELS: levels per segment of the plain static chain, which
# drops dead bands at each segment boundary as the reference's does.  The
# generated static kernel is one function whatever it is (PERF.md).
# Backend.words_per_cta: the word columns (one thread each, the state in
# shared memory) one CTA of a cuda kernel owns, an explicit override; None
# takes each kernel's rule: as many columns as fit one CTA's shared memory
# (beside the schedule ring for the slot scan and the level gather), at
# most 128 (64 under rows64) over four warps, since the kernels wait on
# each column's chain of levels and the columns an SM holds set their time
# (pim_exec.ring_words_per_cta, static_words_per_cta; PERF.md, the H100
# sweeps of PRs 13 and 14).
# DEFAULT_CHUNK_ROWS: streaming chunk (rows) -- rows per kernel launch.
# The kernel alone runs best from 1<<22 rows up, but the host packs and
# unpacks every chunk, and at 1<<20 rows its arrays stay in the host's
# caches: that chunk gave the fastest end-to-end run on the H100.
# PERF.md records the H100 sweep it was chosen from.
SLOT_WIDTH = 6
LEVEL_MAX_WIDTH = 8
SLOT_SEG_LEVELS = 128
DEFAULT_CHUNK_ROWS = 1 << 20


@dataclasses.dataclass(frozen=True)
class Backend:
    """Executor family descriptor with its tunables (see the canonical
    defaults above for what each knob does)."""
    name: str
    slot_width: int = SLOT_WIDTH
    seg_levels: int = SLOT_SEG_LEVELS
    chunk_rows: int = DEFAULT_CHUNK_ROWS
    words_per_cta: Optional[int] = None
    level_max_width: int = LEVEL_MAX_WIDTH

    def __str__(self) -> str:
        return self.name


BACKENDS = {
    "cuda": Backend("cuda"),
    "ref": Backend("ref"),
    # the gate-serial numpy oracle: schedules and devices don't apply;
    # present so one descriptor type covers every entry point
    "numpy": Backend("numpy"),
}
DEFAULT_BACKEND = "cuda"
DEFAULT_DEVICE = "cuda"


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """One immutable description of *how* a gate program executes: the
    backend descriptor, the schedule kind, the packed word layout, the
    streaming chunk size, the torch device the executor runs on and the
    row mesh.  ``mesh`` is None (the plan runs on ``device``) or a tuple of
    torch device names, one shard each: the packed word axis is split into
    contiguous blocks of whole words, one block a device, and the blocks
    are concatenated at the end (no collective runs).  A device may appear
    more than once, so one device can run several shards.
    ``faults`` is a seeded substrate fault model to inject (None: a
    perfect substrate) and ``verify`` the verified-execution policy
    (None: no checking); they are execution semantics, so they are part
    of ``key`` (a faulty request never shares a packed state with a clean
    one) and not of ``compile_key`` (both run the same artifacts)."""
    backend: Backend = BACKENDS[DEFAULT_BACKEND]
    schedule: str = DEFAULT_SCHEDULE
    layout: WordLayout = ROWS32
    mesh: Optional[tuple] = None         # torch device names, one a shard
    chunk_rows: Optional[int] = None     # None -> backend.chunk_rows
    device: str = DEFAULT_DEVICE
    faults: Optional[FaultModel] = None
    verify: Optional[VerifyPolicy] = None

    def __post_init__(self):
        object.__setattr__(self, "mesh", _mesh_of(self.mesh))
        if self.schedule not in SCHEDULES:
            raise ValueError(f"unknown schedule {self.schedule!r} "
                             f"(expected one of {SCHEDULES})")
        if self.layout.planes > 1 and self.backend.name == "numpy":
            raise ValueError(
                f"layout {self.layout.name!r} requires a levelized "
                f"backend (got backend={self.backend.name!r})")
        if self.mesh is not None and self.backend.name == "numpy":
            raise ValueError(
                "mesh sharding requires a levelized backend "
                f"(got backend={self.backend.name!r})")
        if (self.faults is not None or self.verify is not None) \
                and self.backend.name == "numpy":
            raise ValueError(
                "fault injection / verified execution require a levelized "
                "backend (the numpy oracle is the fault-free reference; "
                f"got backend={self.backend.name!r})")
        if self.backend.name == "cuda" and \
                self.backend.level_max_width > LEVEL_MAX_WIDTH:
            raise ValueError(
                f"backend 'cuda' runs dense schedules of at most "
                f"{LEVEL_MAX_WIDTH} lanes (got level_max_width="
                f"{self.backend.level_max_width})")
        if self.backend.name == "cuda" and \
                self.backend.slot_width > LEVEL_MAX_WIDTH:
            raise ValueError(
                f"backend 'cuda' runs slot schedules of at most "
                f"{LEVEL_MAX_WIDTH} lanes (got slot_width="
                f"{self.backend.slot_width})")
        if self.backend.name == "cuda":
            for device in (self.device,) + (self.mesh or ()):
                if torch.device(device).type != "cuda":
                    raise ValueError(
                        "backend 'cuda' runs only on a CUDA device "
                        f"(got device={device!r}); use backend='ref' for "
                        "the plain PyTorch version")

    @property
    def devices(self) -> tuple:
        """The device of each shard: the mesh, or the plan's one device."""
        return self.mesh if self.mesh is not None else (self.device,)

    # ------------------------------------------------------------- identity

    @property
    def effective_chunk_rows(self) -> int:
        """Streaming chunk size, word-aligned for this layout."""
        rpw = self.layout.rows_per_word
        chunk = int(self.chunk_rows if self.chunk_rows is not None
                    else self.backend.chunk_rows)
        return max(rpw, (chunk + rpw - 1) // rpw * rpw)

    @property
    def key(self) -> tuple:
        """Full execution identity: two requests whose plans differ in any
        field must never share one packed state."""
        return (dataclasses.astuple(self.backend), self.schedule,
                self.layout.name, self.effective_chunk_rows,
                str(torch.device(self.device)), self.mesh,
                None if self.faults is None
                else dataclasses.astuple(self.faults),
                None if self.verify is None
                else dataclasses.astuple(self.verify))

    @property
    def compile_key(self) -> tuple:
        """The plan fields that determine a cache entry's compiled
        artifacts: the allocators' widths and the straight-line segment
        size.  Backend, schedule kind, layout, device, mesh, faults and
        verify are excluded on purpose -- every executor consumes the same
        schedule arrays, one entry holds each alloc's schedule and its
        device copies per device, and injection and checking wrap the
        executor at dispatch."""
        return (self.backend.slot_width, self.backend.level_max_width,
                self.backend.seg_levels)


def _backend_of(backend) -> Backend:
    if isinstance(backend, Backend):
        return backend
    try:
        return BACKENDS[backend]
    except KeyError:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {sorted(BACKENDS)})") from None


def _layout_of(layout) -> WordLayout:
    if isinstance(layout, WordLayout):
        return layout
    try:
        return LAYOUTS[layout]
    except KeyError:
        raise ValueError(f"unknown layout {layout!r} "
                         f"(expected one of {sorted(LAYOUTS)})") from None


def _verify_of(verify) -> Optional[VerifyPolicy]:
    """``verify=``: True means the default policy, a VerifyPolicy passes
    through, False/None mean no checking."""
    if verify is None or verify is False:
        return None
    if verify is True:
        return VerifyPolicy()
    if isinstance(verify, VerifyPolicy):
        return verify
    raise TypeError(f"verify must be a bool or VerifyPolicy, "
                    f"got {type(verify).__name__}")


def _mesh_of(mesh) -> Optional[tuple]:
    """``mesh=``: None, or a sequence of torch devices (names or
    ``torch.device``), normalized to a tuple of device names."""
    if mesh is None:
        return None
    if isinstance(mesh, (str, torch.device)):
        raise TypeError("mesh must be a sequence of devices, got one device "
                        f"{mesh!r}")
    devices = tuple(str(torch.device(d)) for d in mesh)
    if not devices:
        raise ValueError("mesh must name at least one device")
    return devices


def _faults_of(faults) -> Optional[FaultModel]:
    if faults is None or isinstance(faults, FaultModel):
        return faults
    raise TypeError(f"faults must be a FaultModel or None, "
                    f"got {type(faults).__name__}")


def as_plan(plan=None, *, backend=None, schedule=None, layout=None,
            mesh=None, chunk_rows=None, device=None, faults=None,
            verify=None, default_backend: str = DEFAULT_BACKEND) -> ExecPlan:
    """Normalize entry-point arguments into an :class:`ExecPlan`.

    ``plan`` may already be an ExecPlan (returned as-is when no override is
    given, else rebuilt with the overrides), a backend name string, or
    None.  The keyword strings are converted here, exactly once.  A plan
    given a ``mesh`` and no ``device`` takes the mesh's first device."""
    if isinstance(plan, ExecPlan):
        if backend is None and schedule is None and layout is None \
                and mesh is None and chunk_rows is None and device is None \
                and faults is None and verify is None:
            return plan
        return dataclasses.replace(
            plan,
            backend=plan.backend if backend is None else _backend_of(backend),
            schedule=plan.schedule if schedule is None else schedule,
            layout=plan.layout if layout is None else _layout_of(layout),
            mesh=plan.mesh if mesh is None else _mesh_of(mesh),
            chunk_rows=plan.chunk_rows if chunk_rows is None else chunk_rows,
            device=plan.device if device is None else str(device),
            faults=plan.faults if faults is None else _faults_of(faults),
            verify=plan.verify if verify is None else _verify_of(verify))
    if isinstance(plan, str):            # run_program(p, ins, n, "ref")
        if backend is not None and backend != plan:
            raise ValueError(
                f"conflicting backends: positional {plan!r} vs "
                f"keyword {backend!r}")
        backend = plan
    elif plan is not None:
        raise TypeError(
            f"plan must be an ExecPlan, a backend name or None, "
            f"got {type(plan).__name__}")
    mesh = _mesh_of(mesh)
    if device is None:
        device = DEFAULT_DEVICE if mesh is None else mesh[0]
    return ExecPlan(
        backend=_backend_of(default_backend if backend is None else backend),
        schedule=DEFAULT_SCHEDULE if schedule is None else schedule,
        layout=_layout_of(DEFAULT_LAYOUT if layout is None else layout),
        mesh=mesh, chunk_rows=chunk_rows, device=str(device),
        faults=_faults_of(faults), verify=_verify_of(verify))


#: The default plan: the cuda kernel on the current CUDA device.  The
#: compiled-program cache and the pin API use it when callers name none.
DEFAULT_PLAN = ExecPlan()


# --------------------------------------------------------------------------
# tuned defaults
# --------------------------------------------------------------------------
#
# Winners of a tunables sweep per (program family, layout, backend) are
# registered here; ``apply_tuned`` overlays them onto a plan at ufunc
# resolution time -- but only onto fields still at their hand defaults, so
# an explicit user choice (a custom Backend, chunk_rows=) always wins.

#: (family, layout_name, backend_name) -> override dict.  Families are
#: "op:param" strings ("add:16", "fp_mul:fp16").
_tuned: dict = {}

#: Backend fields a tuned override may set.
TUNABLE_FIELDS = ("slot_width", "seg_levels", "level_max_width",
                  "chunk_rows", "words_per_cta")


def register_tuned(family: str, layout: str, backend: str,
                   overrides: dict) -> None:
    """Record tuned defaults for one (family, layout, backend) slot.
    Unknown keys are rejected loudly."""
    bad = set(overrides) - set(TUNABLE_FIELDS)
    if bad:
        raise ValueError(f"unknown tuned override keys {sorted(bad)}")
    _tuned[(family, layout, backend)] = dict(overrides)


def clear_tuned() -> None:
    _tuned.clear()


def apply_tuned(plan: ExecPlan, family: Optional[str]) -> ExecPlan:
    """Overlay registered tuned defaults for ``family`` onto ``plan``; each
    override lands only where the plan still holds the stock
    ``BACKENDS`` value (and, for ``chunk_rows``, an unset or default plan
    chunk), so explicit choices are never overridden."""
    if family is None or not _tuned:
        return plan
    ov = _tuned.get((family, plan.layout.name, plan.backend.name))
    if not ov:
        return plan
    stock = BACKENDS.get(plan.backend.name)
    if stock is None:
        return plan
    bk_changes = {}
    for f in TUNABLE_FIELDS:
        if f in ov and getattr(plan.backend, f) == getattr(stock, f):
            bk_changes[f] = int(ov[f])
    changes = {}
    if bk_changes:
        changes["backend"] = dataclasses.replace(plan.backend, **bk_changes)
    if "chunk_rows" in ov and plan.chunk_rows in (None, DEFAULT_CHUNK_ROWS):
        changes["chunk_rows"] = int(ov["chunk_rows"])
    return dataclasses.replace(plan, **changes) if changes else plan
