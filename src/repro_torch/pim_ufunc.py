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
the word layout, ``shards=``/``mesh=`` split the rows over devices, as in
the reference): ``device="cpu", backend="ref"`` runs the plain PyTorch
version on the CPU, ``backend="numpy"`` the gate-serial oracle.  With no
GPU a default call raises; it never drops to the CPU.

    e = pim.lazy(a) * pim.lazy(b) + pim.lazy(c)   # records a graph
    pim.fuse(e).run()          # one composed program, one pack and unpack
    pim.dot(x, y); pim.gemv(m, x); pim.reduce_sum(e)   # in-memory trees

Per the paper, FP operands must be normal-range or zero: NaN/Inf and
subnormals are rejected up front (``check=False`` skips the scan).
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .core import pim_numerics as pn
from .core.floatfmt import FORMATS
from .core.pim_numerics import program_for
from .kernels import ops as kops
from .kernels import plan as kplan

__all__ = ["add", "sub", "mul", "div",
           "fp_add", "fp_sub", "fp_mul", "fp_div",
           "lazy", "LazyExpr", "fuse", "reduce_sum", "dot", "gemv",
           "prepare", "Prepared",
           "config", "configure", "options"]

INT_OPS = ("add", "sub", "mul", "div")
FP_OPS = ("fp_add", "fp_sub", "fp_mul", "fp_div")

#: Binary ops the lazy expression graph records (division does not fuse:
#: data-dependent iteration and a two-port result).
LAZY_OPS = ("add", "sub", "mul", "fp_add", "fp_sub", "fp_mul")


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

    shards: CUDA devices to split the rows over (None: all of this
    machine's, 1: none).  faults: a ``runtime.faults.FaultModel`` to
    inject; verify: a ``VerifyPolicy`` (or True for the default one) --
    verified execution's detect -> retry -> remap loop; the numpy oracle
    drops both.  cache_dir: a directory for the on-disk artifact cache
    (``runtime.artifact_cache``; None disables it): setting it installs
    the cache process-wide on the next ufunc resolution and installs any
    tuned.json the autotuner left beside it.  tuned: apply the
    autotuner's registered Backend and schedule defaults
    (``kernels.plan.register_tuned``) per program family; explicit
    per-call choices always win.
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


_installed_cache_dir = None


def _ensure_artifact_cache(cache_dir=None) -> None:
    """Install (or drop) the process-wide on-disk artifact cache to match
    ``cache_dir`` (default ``config.cache_dir``), installing any
    tuned.json the autotuner persisted beside it.  Idempotent per
    directory; runs at every ufunc resolution so a
    ``configure(cache_dir=...)`` takes effect on the next call."""
    global _installed_cache_dir
    cd = config.cache_dir if cache_dir is None else str(cache_dir)
    if cd == _installed_cache_dir:
        return
    if cd is None:
        kops.set_artifact_cache(None)
        _installed_cache_dir = None
        return
    from .runtime.artifact_cache import ArtifactCache
    cache = ArtifactCache(cd)
    kops.set_artifact_cache(cache)
    tuned_path = cache.tuned_path()
    if os.path.exists(tuned_path):
        from .runtime import tune
        try:
            tune.install(tuned_path)
        except (OSError, ValueError, KeyError, TypeError):
            pass        # a corrupt tuned.json never blocks execution
    _installed_cache_dir = cd


def _resolve(kw, family: Optional[str] = None):
    """Normalize ufunc keywords + module defaults into one ExecPlan;
    returns ``(plan, parallel)``.  ``family`` ("add:16", "fp_mul:fp16") keys
    the tuned-defaults overlay (``kernels.plan.apply_tuned``).  ``shards=``
    splits the rows over that many of the machine's CUDA devices
    (``kernels.ops.row_mesh``; None: all of them, 1: none); ``mesh=`` names
    the devices, one shard each.  An explicit ``plan=`` is exclusive with
    the convenience keywords, ``faults=`` and ``verify=`` among them, and
    takes none of the configured defaults; the numpy backend, the
    fault-free oracle, drops faults and verify.  ``cache_dir=`` installs
    the artifact cache as ``configure(cache_dir=)`` does
    (:func:`_ensure_artifact_cache`)."""
    def opt(name, default):
        v = kw.pop(name, None)
        return default if v is None else v

    _ensure_artifact_cache(kw.pop("cache_dir", None))
    parallel = opt("parallel", config.parallel)
    if "plan" in kw:
        plan = kw.pop("plan")
        for k in ("backend", "device", "schedule", "layout", "chunk_rows",
                  "mesh", "shards", "faults", "verify", "tuned"):
            if kw.pop(k, None) is not None:
                raise TypeError(
                    f"plan= is exclusive with the {k}= convenience keyword")
        if kw:
            raise TypeError(f"unknown keyword arguments {sorted(kw)}")
        return kops.as_plan(plan), parallel
    faults = opt("faults", config.faults)
    verify = opt("verify", config.verify)
    backend = opt("backend", config.backend)
    if backend not in kplan.BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {sorted(kplan.BACKENDS)})")
    device = opt("device", config.device)
    chunk_rows = opt("chunk_rows", config.chunk_rows)
    tuned = opt("tuned", config.tuned)
    schedule = opt("schedule", config.schedule)
    layout = opt("layout", config.layout)
    if "mesh" in kw:
        mesh = kw.pop("mesh")
        kw.pop("shards", None)
    elif backend == "numpy" or torch.device(device).type != "cuda":
        kw.pop("shards", None)
        mesh = None
    else:
        mesh = kops.row_mesh(opt("shards", config.shards))
    if backend == "numpy":
        faults = verify = None     # the oracle is the fault-free reference
    if kw:
        raise TypeError(f"unknown keyword arguments {sorted(kw)}")
    plan = kops.as_plan(backend=backend, schedule=schedule, layout=layout,
                        mesh=mesh, chunk_rows=chunk_rows, device=device,
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
    # compound-program provenance: how many primitive ufunc ops the fused
    # program subsumes (1 for plain ufunc requests) and the per-op
    # composition record -- ((op, width_or_fmt), ...) in topological order
    # for ``op == "expr"`` handles from :func:`fuse`.
    fused_ops: int = 1
    provenance: tuple = ()

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
    def mesh(self):
        return self.plan.mesh

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
    uint64 (object array beyond 63 bits).  Lazy operands record a fusable
    expression node instead of executing (see :func:`lazy`)."""
    if _is_lazy(x, y):
        return _lazy_node("add", x, y, width=width, kw=kw)
    return _prepare_int("add", x, y, width, kw).run()


def sub(x, y, *, width=None, **kw):
    """Elementwise ``x - y`` modulo 2**width (two's-complement wraparound),
    as uint64 (object array beyond 63 bits)."""
    if _is_lazy(x, y):
        return _lazy_node("sub", x, y, width=width, kw=kw)
    return _prepare_int("sub", x, y, width, kw).run()


def mul(x, y, *, width=None, **kw):
    """Elementwise ``x * y``: exact double-width (2*width-bit) products as
    uint64, or an object array when 2*width exceeds 63 bits."""
    if _is_lazy(x, y):
        return _lazy_node("mul", x, y, width=width, kw=kw)
    return _prepare_int("mul", x, y, width, kw).run()


def div(x, y, *, width=None, **kw):
    """Elementwise unsigned division: ``(x // y, x % y)`` as uint64 arrays
    (object beyond 63 bits).  Zero divisors are rejected."""
    if _is_lazy(x, y):
        raise TypeError("pim.div does not fuse (see DESIGN.md §13); "
                        "run it eagerly on materialized arrays")
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
    float32 arrays, or ``fmt='bf16'`` etc. with bit-pattern arrays.
    Lazy operands record a fusable expression node (see :func:`lazy`)."""
    if _is_lazy(x, y):
        return _lazy_node("fp_add", x, y, fmt=fmt, kw=kw)
    return _prepare_fp("add", x, y, dict(kw, fmt=fmt)).run()


def fp_sub(x, y, *, fmt=None, **kw):
    """Elementwise FP subtraction, exactly rounded (IEEE RNE)."""
    if _is_lazy(x, y):
        return _lazy_node("fp_sub", x, y, fmt=fmt, kw=kw)
    return _prepare_fp("sub", x, y, dict(kw, fmt=fmt)).run()


def fp_mul(x, y, *, fmt=None, **kw):
    """Elementwise FP multiplication, exactly rounded (IEEE RNE)."""
    if _is_lazy(x, y):
        return _lazy_node("fp_mul", x, y, fmt=fmt, kw=kw)
    return _prepare_fp("mul", x, y, dict(kw, fmt=fmt)).run()


def fp_div(x, y, *, fmt=None, **kw):
    """Elementwise FP division, exactly rounded (IEEE RNE).  Zero divisors
    are rejected."""
    if _is_lazy(x, y):
        raise TypeError("pim.fp_div does not fuse (see DESIGN.md §13); "
                        "run it eagerly on materialized arrays")
    return _prepare_fp("div", x, y, dict(kw, fmt=fmt)).run()


# --------------------------------------------------------------------------
# lazy expression graphs -> one fused program (DESIGN.md §13)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class LazyExpr:
    """A recorded (unexecuted) expression DAG node.

    Leaves hold a validated operand array (``value``: raw ints for fixed
    point, uint64 bit patterns for fp) plus its width or format; interior
    nodes hold a :data:`LAZY_OPS` op and two children.  Ufuncs called with
    a lazy operand return nodes instead of executing; :func:`fuse` (or
    ``expr.run()``) lowers the whole DAG into **one** levelized program --
    one pack, one execution, one unpack, intermediates never leaving the
    array.  ``+``/``-``/``*`` build nodes too, dispatching on ``kind``.
    """
    kind: str                            # 'int' | 'fp'
    op: Optional[str] = None             # None for leaves
    args: tuple = ()                     # child LazyExprs (nodes)
    value: Optional[np.ndarray] = None   # operand array (leaves)
    width: Optional[int] = None          # int leaves
    fmt: Optional[str] = None            # fp leaves/nodes
    dtype: Optional[object] = None       # native float dtype (fp leaves
    #                                      built from float16/float32)

    def _binop(self, op, other, reflect=False):
        if self.kind == "fp":
            op = "fp_" + op
        x, y = (other, self) if reflect else (self, other)
        return globals()[op](x, y)

    def __add__(self, other): return self._binop("add", other)
    def __radd__(self, other): return self._binop("add", other, True)
    def __sub__(self, other): return self._binop("sub", other)
    def __rsub__(self, other): return self._binop("sub", other, True)
    def __mul__(self, other): return self._binop("mul", other)
    def __rmul__(self, other): return self._binop("mul", other, True)

    def fuse(self, **kw) -> "Prepared":
        """Lower the DAG to one fused program handle (see :func:`fuse`)."""
        return fuse(self, **kw)

    def run(self, **kw):
        """Fuse and execute; equivalent to ``fuse(expr, **kw).run()``."""
        return fuse(self, **kw).run()


def lazy(x, *, width=None, fmt=None, check=True) -> LazyExpr:
    """Wrap an operand array as a lazy leaf.  Dispatch mirrors the eager
    ufuncs: float16/float32 arrays (or ``fmt=`` with bit patterns) become
    fp leaves, unsigned integer arrays (or ``width=``) fixed-point leaves.
    Validation (range, NaN/Inf/subnormal rejection) happens here, so a
    recorded graph is always executable.  Idempotent on LazyExpr."""
    if isinstance(x, LazyExpr):
        return x
    x = np.asarray(x)
    if fmt is None and x.dtype in _NP_FMT:
        fmt = _NP_FMT[x.dtype]
        bits = x.view(_FMT_VIEW[fmt]).astype(np.uint64)
        if check and bits.size:
            _check_fp_bits("lazy", "x", bits, FORMATS[fmt])
        return LazyExpr("fp", value=bits, fmt=fmt, dtype=x.dtype)
    if fmt is not None:
        if fmt not in FORMATS:
            raise ValueError(f"pim.lazy: unknown format {fmt!r} "
                             f"(known: {sorted(FORMATS)})")
        nbits = FORMATS[fmt].nbits
        if x.dtype.kind not in "uiO":
            raise TypeError(f"pim.lazy: fmt={fmt!r} takes bit-pattern "
                            f"integer arrays, got dtype {x.dtype}")
        if x.size and (_vmin(x) < 0 or _vmax(x) >> nbits):
            raise ValueError(f"pim.lazy: bit patterns outside "
                             f"[0, 2**{nbits})")
        bits = x.astype(np.uint64)
        if check and bits.size:
            _check_fp_bits("lazy", "x", bits, FORMATS[fmt])
        return LazyExpr("fp", value=bits, fmt=fmt)
    if width is None:
        width = _DTYPE_WIDTHS.get(x.dtype)
        if width is None:
            raise TypeError(
                f"pim.lazy: cannot infer width from dtype {x.dtype}; pass "
                "an unsigned integer array or an explicit width=")
    else:
        width = int(width)
        if width < 1:
            raise ValueError(f"pim.lazy: width must be >= 1, got {width}")
        if x.dtype.kind not in "uiO":
            raise TypeError(f"pim.lazy: operand must be an integer array, "
                            f"got dtype {x.dtype}")
        if x.size and (_vmin(x) < 0 or _vmax(x) >> width):
            raise ValueError(
                f"pim.lazy: operand has values outside [0, 2**{width})")
    return LazyExpr("int", value=x, width=width)


def _is_lazy(*vals) -> bool:
    return any(isinstance(v, LazyExpr) for v in vals)


def _lazy_node(op, x, y, width=None, fmt=None, kw=None) -> LazyExpr:
    """Record one binary node (ufunc lazy branch).  Execution keywords are
    rejected here -- they belong to fuse()/run(), where the whole graph's
    plan is resolved once."""
    if kw:
        raise TypeError(
            f"pim.{op}: execution keywords {sorted(kw)} do not apply to "
            "lazy operands; pass them to fuse()/run()")
    if op not in LAZY_OPS:
        raise TypeError(f"pim.{op} does not fuse (see DESIGN.md §13)")
    kind = "fp" if op.startswith("fp_") else "int"
    x = x if isinstance(x, LazyExpr) else lazy(x, width=width, fmt=fmt)
    y = y if isinstance(y, LazyExpr) else lazy(y, width=width, fmt=fmt)
    if x.kind != kind or y.kind != kind:
        raise TypeError(
            f"pim.{op}: operand kinds ({x.kind}, {y.kind}) do not match "
            "the op")
    if kind == "fp":
        if x.fmt != y.fmt:
            raise TypeError(f"pim.{op}: mixed fp formats "
                            f"({x.fmt}, {y.fmt})")
        return LazyExpr("fp", op=op, args=(x, y), fmt=x.fmt)
    return LazyExpr("int", op=op, args=(x, y))


def _graph_of(expr: LazyExpr):
    """Canonicalize a DAG into the hashable topological tuple
    ``pim_numerics.fused_program_for`` consumes; returns ``(graph,
    leaves)`` with leaves named ``i0, i1, ...`` in discovery order (shared
    subtrees canonicalize once -- the SSA sharing survives into the fused
    netlist)."""
    entries = []
    index: Dict[int, int] = {}
    leaves = []

    def visit(e: LazyExpr) -> int:
        idx = index.get(id(e))
        if idx is not None:
            return idx
        if e.op is None:
            name = f"i{len(leaves)}"
            leaves.append(e)
            entries.append(("in", name, e.width))
        else:
            i = visit(e.args[0])
            j = visit(e.args[1])
            op = e.op[3:] if e.op.startswith("fp_") else e.op
            entries.append((op, i, j))
        idx = index[id(e)] = len(entries) - 1
        return idx

    visit(expr)
    return tuple(entries), leaves


def _expr_pieces(expr: LazyExpr):
    """Lower a DAG to its execution pieces: (program, inputs, n_rows,
    shape, kind, fmt, decode, fused_ops, provenance)."""
    graph, leaves = _graph_of(expr)
    is_fp = expr.kind == "fp"
    fmt = expr.fmt
    arrs = np.broadcast_arrays(*[l.value for l in leaves])
    shape = arrs[0].shape
    inputs = {f"i{k}": a.ravel() for k, a in enumerate(arrs)}
    n_rows = int(arrs[0].size)
    kind = "fp-serial" if is_fp else "int-serial"
    prog = pn.fused_program_for(kind, graph, fmt)
    if is_fp:
        dts = {l.dtype for l in leaves}
        if len(dts) == 1 and None not in dts:
            dt = dts.pop()
            view = _FMT_VIEW[fmt]
            decode = lambda b: np.asarray(b, np.uint64).astype(view) \
                .view(dt).reshape(shape)
        else:
            decode = lambda b: np.asarray(b).reshape(shape)
    else:
        decode = lambda b: np.asarray(b).reshape(shape)
    widths, prov = [], []
    for e in graph:
        if e[0] == "in":
            widths.append(e[2])
        else:
            op, i, j = e
            if is_fp:
                widths.append(None)
                prov.append((f"fp_{op}", fmt))
            else:
                w = max(widths[i], widths[j])
                widths.append(pn._INT_OUT_WIDTH[op](w))
                prov.append((op, w))
    return (prog, inputs, n_rows, shape, kind, fmt, decode,
            max(1, len(prov)), tuple(prov))


def fuse(expr: LazyExpr, **kw) -> Prepared:
    """Lower a lazy expression DAG into **one** fused program handle.

    The per-op gate programs are stitched into a single netlist
    (``gates.compose``) and levelized as a whole -- shared SSA across op
    boundaries, DCE of intermediate port unpacks -- so the chain executes
    with one pack, one compiled program, one unpack, and flows through
    every downstream path (streaming, sharding, serving coalescing) like
    any other :class:`Prepared`.  Keywords are the ufunc execution
    keywords; the handle's ``op`` is ``"expr"``, its ``fused_ops``/
    ``provenance`` record the composition.
    """
    if not isinstance(expr, LazyExpr):
        raise TypeError("pim.fuse takes a LazyExpr (build one with "
                        "pim.lazy / lazy ufunc calls)")
    plan, parallel = _resolve(kw)
    if parallel:
        raise ValueError("expression fusion is bit-serial only (the "
                         "partition schedules of the bit-parallel "
                         "builders do not concatenate)")
    prog, inputs, n_rows, shape, kind, fmt, decode, n_ops, prov = \
        _expr_pieces(expr)
    finish = lambda outs: decode(outs["z"])
    return Prepared("expr", prog, inputs, n_rows, plan, finish,
                    fused_ops=n_ops, provenance=prov)


# --------------------------------------------------------------------------
# in-memory reductions: reduce_sum / dot / gemv
# --------------------------------------------------------------------------

def _pow2_at_least(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _pad_rows(vals: np.ndarray, total: int) -> np.ndarray:
    out = np.zeros(total, object if vals.dtype == object else np.uint64)
    out[:len(vals)] = vals
    return out


def reduce_sum(x, *, width=None, fmt=None, fused=True, deadline=None, **kw):
    """Sum every element of ``x`` (an array or a lazy expression) with a
    log-depth in-memory adder tree; returns a scalar.

    The elementwise stage (the fused expression program, or an identity
    copy for a plain array) and all reduction levels stay in the packed
    word domain, the block on the device between tree levels -- one pack
    in, one single-row unpack out (``pim_numerics.tree_reduce_rows``).  Fixed point sums exactly (the
    accumulator grows one bit per level); fp sums in *tree order* under
    RNE, bit-exact against the same-shaped host tree.  ``fused=False``
    runs the identical pairing through per-op round trips (the unfused
    reference).  ``deadline`` (absolute ``time.monotonic()``) cancels the
    reduction between tree levels."""
    e = lazy(x, width=width, fmt=fmt)
    plan, parallel = _resolve(kw)
    if parallel:
        raise ValueError("reductions are bit-serial only")
    prog, inputs, n_rows, shape, kind, efmt, decode, _, _ = _expr_pieces(e)
    if n_rows < 1:
        raise ValueError("pim.reduce_sum: empty reduction")
    total = _pow2_at_least(n_rows)
    padded = {n: _pad_rows(v, total) for n, v in inputs.items()}
    out = pn.tree_reduce_rows(prog, padded, total, 1, kind=kind, fmt=efmt,
                              plan=plan, fused=fused, deadline=deadline)
    if e.kind == "fp":
        leaves = _graph_of(e)[1]
        dts = {l.dtype for l in leaves}
        if len(dts) == 1 and None not in dts:
            view = _FMT_VIEW[efmt]
            return np.asarray(out, np.uint64).astype(view).view(
                dts.pop())[0]
        return np.asarray(out)[0]
    return np.asarray(out)[0]


def dot(x, y, *, width=None, fmt=None, fused=True, deadline=None, **kw):
    """In-memory dot product ``sum_k x[k] * y[k]``: one element-parallel
    multiply feeding a log-depth adder tree, intermediates never leaving
    the packed array (DESIGN.md §13).  Operands follow ufunc dispatch
    (unsigned ints / ``width=``; float16/float32 / ``fmt=`` bit
    patterns).  Fixed point is exact; fp is the tree-order RNE sum."""
    ex = lazy(x, width=width, fmt=fmt)
    ey = lazy(y, width=width, fmt=fmt)
    return reduce_sum(ex * ey, fused=fused, deadline=deadline, **kw)


def gemv(a, x, *, width=None, fmt=None, fused=True, deadline=None, **kw):
    """In-memory GEMV ``y[m] = sum_k a[m, k] * x[k]``.

    Each output ``m`` is a packed-domain reduction lane: products land at
    rows ``j*group + m`` (one multiply over all M*K products at once) and
    log2(K) in-memory adder levels fold the K axis -- the GEMV executes in
    ``1 + log2(K)`` program dispatches with no host round trip between
    them (the block stays on the device).  Semantics per element match :func:`dot`."""
    ea = lazy(a, width=width, fmt=fmt)
    ex = lazy(x, width=width, fmt=fmt)
    if ea.op is not None or ex.op is not None:
        raise TypeError("pim.gemv takes operand arrays (compose lazy "
                        "expressions with reduce_sum instead)")
    if ea.kind != ex.kind or (ea.kind == "fp" and ea.fmt != ex.fmt):
        raise TypeError(f"pim.gemv: operand kinds/formats do not match "
                        f"({ea.kind}/{ea.fmt} vs {ex.kind}/{ex.fmt})")
    av, xv = ea.value, ex.value
    if av.ndim != 2 or xv.ndim != 1 or av.shape[1] != xv.shape[0]:
        raise ValueError(f"pim.gemv: need a (M, K) matrix and a (K,) "
                         f"vector, got {av.shape} and {xv.shape}")
    m, k = av.shape
    if k < 1 or m < 1:
        raise ValueError("pim.gemv: empty operands")
    plan, parallel = _resolve(kw)
    if parallel:
        raise ValueError("reductions are bit-serial only")
    group = pn.reduce_group(m)
    kp = _pow2_at_least(k)
    is_fp = ea.kind == "fp"
    w = None if is_fp else max(ea.width, ex.width)
    graph = (("in", "i0", w), ("in", "i1", w), ("mul", 0, 1))
    kind = "fp-serial" if is_fp else "int-serial"
    prog = pn.fused_program_for(kind, graph, ea.fmt)
    odt = object if (av.dtype == object or xv.dtype == object) else \
        np.uint64
    xa = np.zeros((kp, group), odt)
    xb = np.zeros((kp, group), odt)
    xa[:k, :m] = av.T                    # row j*group + m  <-  a[m, j]
    xb[:k, :m] = np.asarray(xv)[:, None]
    out = pn.tree_reduce_rows(prog, {"i0": xa.ravel(), "i1": xb.ravel()},
                              kp * group, group, kind=kind, fmt=ea.fmt,
                              plan=plan, fused=fused, deadline=deadline)
    out = np.asarray(out)[:m]
    if is_fp and ea.dtype is not None and ea.dtype == ex.dtype:
        return np.asarray(out, np.uint64).astype(
            _FMT_VIEW[ea.fmt]).view(ea.dtype)
    return out
