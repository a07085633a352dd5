"""NumPy-style ufunc frontend for the AritPIM machine, on a CUDA device.

The counterpart of ``repro.pim_ufunc``: every element occupies one PIM
row, the whole array executes one shared, memoized gate program, and
execution streams through ``kernels.ops.run_program_streaming``.

    from repro_torch import pim_ufunc as pim

    pim.add(x, y)              # uint8/16/32/64 -> full (w+1)-bit sums
    pim.mul(x, y, width=24)    # explicit width; double-width products
    pim.fp_add(a, b)           # float16/float32, exact IEEE RNE
    pim.fp_mul(xb, yb, fmt="bf16")   # bf16 as uint16 bit patterns

Calls run on the CUDA device through the hand-written kernels unless the
caller asks otherwise (``schedule=`` and ``layout=`` pick the kernel and
the word layout, as in the reference): ``device="cpu", backend="ref"`` runs the plain
PyTorch version on the CPU, ``backend="numpy"`` the gate-serial oracle.
With no GPU a default call raises; it never drops to the CPU.

Per the paper, FP operands must be normal-range or zero: NaN/Inf and
subnormals are rejected up front (``check=False`` skips the scan).
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Optional

import numpy as np

from .core.floatfmt import FORMATS
from .core.pim_numerics import program_for
from .kernels import ops as kops
from .kernels import plan as kplan

__all__ = ["add", "sub", "mul", "div",
           "fp_add", "fp_sub", "fp_mul", "fp_div",
           "lazy", "fuse", "reduce_sum", "dot", "gemv",
           "prepare", "Prepared",
           "config", "configure", "options"]

INT_OPS = ("add", "sub", "mul", "div")
FP_OPS = ("fp_add", "fp_sub", "fp_mul", "fp_div")


@dataclasses.dataclass
class Config:
    """Module-wide execution defaults; every ufunc takes keyword overrides.

    backend: 'cuda' (the hand-written kernels, the default), 'ref' (their
    plain PyTorch versions, on any device) or 'numpy' (the gate-serial
    oracle).  device: the torch device the executors run on.  chunk_rows:
    streaming chunk size (rows per kernel launch).  parallel: use the
    bit-parallel builders instead of bit-serial.  schedule: 'slots' (the
    slot-scan kernel), 'slots-static' (the generated straight-line kernel)
    or 'dense' (the level-gather kernel).  layout: 'rows32' or 'rows64'
    (64 rows per word).

    shards, faults, verify and cache_dir mirror the reference's
    configuration; only their defaults run in this package, and any other
    value raises ``NotImplementedError`` naming the ROADMAP item that
    brings it.  tuned: apply registered tuned Backend defaults
    (``kernels.plan.register_tuned``) per program family.
    """
    backend: str = kplan.DEFAULT_BACKEND
    device: str = kplan.DEFAULT_DEVICE
    chunk_rows: int = kplan.DEFAULT_CHUNK_ROWS
    shards: Optional[int] = None
    parallel: bool = False
    schedule: str = kplan.DEFAULT_SCHEDULE
    layout: str = "rows32"
    faults: Optional[object] = None
    verify: Optional[object] = None
    cache_dir: Optional[str] = None
    tuned: bool = True


config = Config()


def configure(**kw) -> Config:
    """Update module defaults (``configure(device='cpu', backend='ref')``);
    returns the live :data:`config`.  All keys are validated before any is
    applied.  Prefer :func:`options` when the change should only cover a
    scope."""
    unknown = [k for k in kw if k not in Config.__dataclass_fields__]
    if unknown:
        raise TypeError(f"unknown config field(s) {sorted(unknown)}")
    for k, v in kw.items():
        setattr(config, k, v)
    return config


@contextlib.contextmanager
def options(**kw):
    """Scoped :data:`config` overrides; the previous defaults come back on
    exit, even on exception.  Yields the live config."""
    saved = {k: getattr(config, k) for k in Config.__dataclass_fields__}
    try:
        yield configure(**kw)
    finally:
        for k, v in saved.items():
            setattr(config, k, v)


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet (ROADMAP {item})")


def _resolve(kw, family: Optional[str] = None):
    """Normalize ufunc keywords + module defaults into one ExecPlan;
    returns ``(plan, parallel)``.  ``family`` ("add:16", "fp_mul:fp16") keys
    the tuned-defaults overlay (``kernels.plan.apply_tuned``)."""
    def opt(name, default):
        v = kw.pop(name, None)
        return default if v is None else v

    if opt("cache_dir", config.cache_dir) is not None:
        raise _not_ported("the artifact cache (cache_dir=)", "A11")
    if "mesh" in kw or opt("shards", config.shards) not in (None, 1):
        raise _not_ported("row sharding over devices (shards=, mesh=)", "A7")
    faults = opt("faults", config.faults)
    verify = opt("verify", config.verify)
    parallel = opt("parallel", config.parallel)
    if "plan" in kw:
        plan = kw.pop("plan")
        for k in ("backend", "device", "schedule", "layout", "chunk_rows",
                  "tuned"):
            if kw.pop(k, None) is not None:
                raise TypeError(
                    f"plan= is exclusive with the {k}= convenience keyword")
        if kw:
            raise TypeError(f"unknown keyword arguments {sorted(kw)}")
        return kops.as_plan(plan, faults=faults, verify=verify), parallel
    backend = opt("backend", config.backend)
    if backend not in kplan.BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {sorted(kplan.BACKENDS)})")
    device = opt("device", config.device)
    chunk_rows = opt("chunk_rows", config.chunk_rows)
    tuned = opt("tuned", config.tuned)
    schedule = opt("schedule", config.schedule)
    layout = opt("layout", config.layout)
    if kw:
        raise TypeError(f"unknown keyword arguments {sorted(kw)}")
    plan = kops.as_plan(backend=backend, schedule=schedule, layout=layout,
                        chunk_rows=chunk_rows, device=device,
                        faults=faults, verify=verify)
    if tuned and family is not None:
        plan = kplan.apply_tuned(plan, family)
    return plan, parallel


@dataclasses.dataclass
class Prepared:
    """A parsed, validated ufunc request bound to its gate program.

    ``prepare(op, x, y, ...)`` does everything a ufunc call does except
    execution: broadcasting, width/format dispatch, operand validation and
    program lookup.  ``run()`` executes and is exactly the one-shot ufunc
    call; ``finish`` turns raw output-port rows into the user-facing
    result (reshape, fp bit decode, div's ``(q, r)`` pair)."""
    op: str
    program: object
    inputs: Dict[str, np.ndarray]
    n_rows: int
    plan: object                 # kernels.plan.ExecPlan
    _finish: Callable

    @property
    def backend(self) -> str:
        return self.plan.backend.name

    @property
    def device(self) -> str:
        return self.plan.device

    @property
    def schedule(self) -> str:
        return self.plan.schedule

    @property
    def layout(self) -> str:
        return self.plan.layout.name

    @property
    def chunk_rows(self) -> int:
        return self.plan.effective_chunk_rows

    @property
    def key(self) -> bytes:
        """Content hash of the program."""
        return kops.content_key(self.program)

    @property
    def cached(self) -> bool:
        """True when the compiled-program cache already holds this
        program's schedule (execution pays no levelize)."""
        if self.plan.backend.name == "numpy":
            return True                     # the oracle never levelizes
        return kops.is_compiled(self.program, self.plan)

    def finish(self, outs: Dict[str, np.ndarray]):
        """Decode raw output-port rows into the user-facing result."""
        return self._finish(outs)

    def run(self):
        """Execute through the streaming executor (identical to the plain
        ufunc call)."""
        return self._finish(_run(self.program, self.inputs, self.n_rows,
                                 self.plan))

    def warm(self, rows: int = 1) -> None:
        """Levelize, copy the schedule to the device and build the kernels
        (the generated static kernel too) without serving: run ``rows``
        leading rows (discarded)."""
        rows = min(self.n_rows, max(1, rows))
        if rows < 1 or self.plan.backend.name == "numpy":
            return
        head = {n: v[:rows] for n, v in self.inputs.items()}
        kops.run_program(self.program, head, rows, self.plan)


def prepare(op: str, x, y, *, width=None, fmt=None, **kw) -> Prepared:
    """Parse + validate one elementwise request and bind it to its program
    without executing (see :class:`Prepared`).  ``op`` is the public ufunc
    name; keywords are exactly the matching ufunc's."""
    if op in INT_OPS:
        if fmt is not None:
            raise TypeError(f"pim.{op} takes no fmt= (fixed point)")
        return _prepare_int(op, x, y, width, kw)
    if op in FP_OPS:
        if width is not None:
            raise TypeError(f"pim.{op} takes no width= (format-implied)")
        return _prepare_fp(op[3:], x, y, dict(kw, fmt=fmt))
    raise ValueError(f"pim.prepare: unknown op {op!r} "
                     f"(expected one of {INT_OPS + FP_OPS})")


def _run(prog, inputs, n_rows, plan):
    if plan.backend.name == "numpy":
        return kops.run_program(prog, inputs, n_rows, plan)
    # streaming falls back to one-shot run_program below chunk_rows itself
    return kops.run_program_streaming(prog, inputs, n_rows, plan)


# --------------------------------------------------------------------------
# fixed point
# --------------------------------------------------------------------------

_DTYPE_WIDTHS = {np.dtype(np.uint8): 8, np.dtype(np.uint16): 16,
                 np.dtype(np.uint32): 32, np.dtype(np.uint64): 64}


def _int_operands(op, x, y, width):
    """Broadcast, infer/validate the bit width, and flatten to rows."""
    x, y = np.broadcast_arrays(np.asarray(x), np.asarray(y))
    if width is None:
        wx = _DTYPE_WIDTHS.get(x.dtype)
        wy = _DTYPE_WIDTHS.get(y.dtype)
        if wx is None or wy is None:
            raise TypeError(
                f"pim.{op}: cannot infer width from dtypes "
                f"({x.dtype}, {y.dtype}); pass unsigned integer arrays or "
                "an explicit width=")
        if wx != wy:
            raise TypeError(
                f"pim.{op}: mixed operand widths {wx} and {wy}; cast to a "
                "common dtype or pass width=")
        width = wx
    else:
        width = int(width)
        if width < 1:
            raise ValueError(f"pim.{op}: width must be >= 1, got {width}")
        for name, v in (("x", x), ("y", y)):
            if v.dtype.kind not in "uiO":
                raise TypeError(
                    f"pim.{op}: operand {name} must be an integer array, "
                    f"got dtype {v.dtype}")
            if v.size and (_vmin(v) < 0 or _vmax(v) >> width):
                raise ValueError(
                    f"pim.{op}: operand {name} has values outside "
                    f"[0, 2**{width})")
    return x.ravel(), y.ravel(), x.shape, width


def _vmin(v):
    return min(v.flat) if v.dtype == object else int(v.min())


def _vmax(v):
    return max(v.flat) if v.dtype == object else int(v.max())


def _prepare_int(op, x, y, width, kw) -> Prepared:
    xr, yr, shape, w = _int_operands(op, x, y, width)
    plan, parallel = _resolve(kw, family=f"{op}:{w}")
    prog = program_for("int-parallel" if parallel else "int-serial", op, w)
    if op == "div":
        if xr.size and _vmin(yr) == 0:
            raise ValueError("pim.div: zero divisor")
        # the divider takes a double-width dividend port z and divisor d
        inputs = {"z": xr.astype(np.uint64) if xr.dtype != object else xr,
                  "d": yr}
        finish = lambda outs: (outs["q"].reshape(shape),
                               outs["r"].reshape(shape))
    else:
        inputs = {"x": xr, "y": yr}
        finish = lambda outs: outs["z"].reshape(shape)
    return Prepared(op, prog, inputs, xr.size, plan, finish)


def add(x, y, *, width=None, **kw):
    """Elementwise ``x + y`` with the full carry: (width+1)-bit sums as
    uint64 (object array beyond 63 bits)."""
    return _prepare_int("add", x, y, width, kw).run()


def sub(x, y, *, width=None, **kw):
    """Elementwise ``x - y`` modulo 2**width (two's-complement wraparound),
    as uint64 (object array beyond 63 bits)."""
    return _prepare_int("sub", x, y, width, kw).run()


def mul(x, y, *, width=None, **kw):
    """Elementwise ``x * y``: exact double-width (2*width-bit) products as
    uint64, or an object array when 2*width exceeds 63 bits."""
    return _prepare_int("mul", x, y, width, kw).run()


def div(x, y, *, width=None, **kw):
    """Elementwise unsigned division: ``(x // y, x % y)`` as uint64 arrays
    (object beyond 63 bits).  Zero divisors are rejected."""
    return _prepare_int("div", x, y, width, kw).run()


# --------------------------------------------------------------------------
# floating point
# --------------------------------------------------------------------------

_NP_FMT = {np.dtype(np.float16): "fp16", np.dtype(np.float32): "fp32"}
_FMT_VIEW = {"fp16": np.uint16, "fp32": np.uint32}


def _check_fp_bits(op, name, bits, fmt, reject_zero=False):
    """Reject the paper's excluded encodings: NaN/Inf (exponent all-ones)
    and subnormals (exponent 0, mantissa != 0).  Zero is a valid encoding
    except as a divisor."""
    b = bits if bits.dtype == object else bits.astype(np.uint64)
    e = np.array([(int(v) >> fmt.nm) & ((1 << fmt.ne) - 1) for v in b.flat],
                 np.int64) if b.dtype == object else \
        ((b >> np.uint64(fmt.nm)) & np.uint64((1 << fmt.ne) - 1)
         ).astype(np.int64)
    m = np.array([int(v) & ((1 << fmt.nm) - 1) for v in b.flat], np.int64) \
        if b.dtype == object else \
        (b & np.uint64((1 << fmt.nm) - 1)).astype(np.int64)
    emax = (1 << fmt.ne) - 1
    if (e == emax).any():
        raise ValueError(f"pim.{op}: operand {name} contains NaN/Inf "
                         "(excluded by the PIM suite)")
    if ((e == 0) & (m != 0)).any():
        raise ValueError(f"pim.{op}: operand {name} contains subnormals "
                         "(excluded by the PIM suite)")
    if reject_zero and ((e == 0) & (m == 0)).any():
        raise ValueError(f"pim.{op}: zero divisor")


def _prepare_fp(op, x, y, kw) -> Prepared:
    fmt = kw.pop("fmt", None)
    check = kw.pop("check", True)
    x, y = np.broadcast_arrays(np.asarray(x), np.asarray(y))
    if fmt is None:
        if x.dtype != y.dtype or x.dtype not in _NP_FMT:
            raise TypeError(
                f"pim.fp_{op}: operands must share a float16/float32 dtype "
                f"(got {x.dtype}, {y.dtype}); other formats take fmt= with "
                "bit-pattern arrays")
        fmt_name = _NP_FMT[x.dtype]
        view = _FMT_VIEW[fmt_name]
        xb = x.ravel().view(view).astype(np.uint64)
        yb = y.ravel().view(view).astype(np.uint64)
        decode = lambda bits: bits.astype(view).view(x.dtype).reshape(x.shape)
    else:
        if fmt not in FORMATS:
            raise ValueError(f"pim.fp_{op}: unknown format {fmt!r} "
                             f"(known: {sorted(FORMATS)})")
        fmt_name = fmt
        nbits = FORMATS[fmt].nbits
        for name, v in (("x", x), ("y", y)):
            if v.dtype.kind not in "uiO":
                raise TypeError(
                    f"pim.fp_{op}: fmt={fmt!r} takes bit-pattern integer "
                    f"arrays, got dtype {v.dtype}")
            if v.size and (_vmin(v) < 0 or _vmax(v) >> nbits):
                raise ValueError(
                    f"pim.fp_{op}: operand {name} has bit patterns outside "
                    f"[0, 2**{nbits})")
        xb = x.ravel().astype(np.uint64)
        yb = y.ravel().astype(np.uint64)
        decode = lambda bits: bits.reshape(x.shape)
    plan, parallel = _resolve(kw, family=f"fp_{op}:{fmt_name}")
    f = FORMATS[fmt_name]
    if check and xb.size:
        _check_fp_bits(f"fp_{op}", "x", xb, f)
        _check_fp_bits(f"fp_{op}", "y", yb, f, reject_zero=(op == "div"))
    if parallel and op == "sub":
        # the bit-parallel suite has no subtractor: flip y's sign, add
        yb = yb ^ np.uint64(1 << (f.nbits - 1))
        op = "add"
    prog = program_for("fp-parallel" if parallel else "fp-serial",
                       op, fmt_name)
    finish = lambda outs: decode(np.asarray(outs["z"], np.uint64))
    return Prepared(f"fp_{op}", prog, {"x": xb, "y": yb}, xb.size, plan,
                    finish)


def fp_add(x, y, *, fmt=None, **kw):
    """Elementwise FP addition, exactly rounded (IEEE RNE).  float16 /
    float32 arrays, or ``fmt='bf16'`` etc. with bit-pattern arrays."""
    return _prepare_fp("add", x, y, dict(kw, fmt=fmt)).run()


def fp_sub(x, y, *, fmt=None, **kw):
    """Elementwise FP subtraction, exactly rounded (IEEE RNE)."""
    return _prepare_fp("sub", x, y, dict(kw, fmt=fmt)).run()


def fp_mul(x, y, *, fmt=None, **kw):
    """Elementwise FP multiplication, exactly rounded (IEEE RNE)."""
    return _prepare_fp("mul", x, y, dict(kw, fmt=fmt)).run()


def fp_div(x, y, *, fmt=None, **kw):
    """Elementwise FP division, exactly rounded (IEEE RNE).  Zero divisors
    are rejected."""
    return _prepare_fp("div", x, y, dict(kw, fmt=fmt)).run()


# --------------------------------------------------------------------------
# fusion and reductions: not ported yet
# --------------------------------------------------------------------------

def _a8(name):
    def not_ported(*args, **kw):
        raise _not_ported(f"pim.{name}", "A8")
    not_ported.__name__ = name
    not_ported.__doc__ = (f"``repro.pim_ufunc.{name}``'s counterpart; raises "
                          "NotImplementedError until ROADMAP A8 lands.")
    return not_ported


lazy = _a8("lazy")
fuse = _a8("fuse")
reduce_sum = _a8("reduce_sum")
dot = _a8("dot")
gemv = _a8("gemv")
