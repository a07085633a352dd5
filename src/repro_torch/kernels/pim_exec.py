"""Hopper kernels of the PIM executor: build, binding and wrappers.

Five CUDA kernels, one per kernel of ``repro.kernels.pim_exec``:

* ``csrc/slot_scan.cu`` (B1) -- the slot-scan kernel, the counterpart of
  ``_slot_scan_kernel``, with the bit-transpose bridges of
  ``repro.kernels.slots`` fused into its ``fused`` entry, run from a
  packed stream (:func:`pack_slots`);
* ``csrc/level_gather.cu`` (B3) -- the dense-schedule kernel, the
  counterpart of ``_pim_level_gather_kernel``, run from a packed stream
  (:func:`pack_levels`);
* a generated static-slice kernel per slot schedule (B2), the counterpart
  of ``_pim_level_kernel``: :func:`static_source` writes the schedule out
  as straight-line CUDA with every cell offset a constant;
* ``csrc/gate_serial.cu`` (B4) -- the gate-serial kernel, the counterpart
  of ``_pim_kernel``, run from a packed stream (:func:`pack_gates`);
* ``csrc/check_words.cu`` (B6) -- verified execution's XOR check fold of
  an output block over one axis, the counterpart of ``check_words`` (jnp
  there, no Pallas): :func:`check_words`.

B1, B2 and B3 share ``csrc/pim_state.cuh`` (the state in shared memory,
the fused bridges as warp transposes) and run both word layouts.  B1, B3
and B4 share ``csrc/ring.cuh``: the packed stream (8-byte records of
uint16 cells, in windows of gates that one step runs, tiles of
:data:`TILE_RECORDS` records) streamed into shared memory by TMA bulk
copies, and the loop that runs it; B1 and B3 are its one level kernel,
handed different streams.  Their CTAs are sized by
:func:`ring_words_per_cta`, B2's by :func:`static_words_per_cta`.
Each source is compiled with ``nvcc`` for ``sm_90a`` into a shared library
with a plain C interface at first use (``build/repro_torch/`` at the
checkout root, keyed on the source's hash) and bound with ``ctypes``.

The wrappers take the plain versions' signatures (``kernels.slots`` and
``kernels.ref``).  On a CPU tensor they call the plain version; on a CUDA
tensor they launch the kernel or raise.  Each launch adds one to its entry
in :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from . import ref as kref
from . import slots as kslots
from .plan import LEVEL_MAX_WIDTH, SLOT_SEG_LEVELS

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
#: kernel name -> CUDA source
SOURCES = {"slot_scan": CSRC / "slot_scan.cu",
           "level_gather": CSRC / "level_gather.cu",
           "gate_serial": CSRC / "gate_serial.cu",
           "check_words": CSRC / "check_words.cu"}
#: Headers the sources include; part of every build's key.
HEADERS = (CSRC / "pim_state.cuh", CSRC / "ring.cuh")
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
#: The CUDA toolkit consulted when ``nvcc`` is not on ``PATH``.
CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")
#: Records (8 B each) of one tile of a packed stream (ring.cuh kRecords).
TILE_RECORDS = 512
#: Most gates one window of a packed stream holds (ring.cuh kWin): a slot
#: or dense level's lanes, or a run of independent gate-serial gates.
WINDOW = LEVEL_MAX_WIDTH
#: Most gates a window of B4's stream holds.  The kernel's window body is
#: as wide as the stream's widest window (2, 4, 6 or 8 gates) and runs every
#: lane of it, and gate-serial windows are short (1.6 gates on average on
#: fp32 add), so B4 packs narrower windows than the dense levels' 8.
GATE_WINDOW = 2
#: Shared memory the ring takes in one CTA (ring.cuh kRingBytes, two tile
#: slots and their barriers) plus the state's padding to 16 B before it.
RING_BYTES = 2 * 8 * TILE_RECORDS + 2 * 8 + 15
#: Constant cells (all zeros, all ones) B4 keeps after the state: INIT1
#: and INIT0 gates are NORs of them (:func:`pack_gates`).
GATE_CONSTANTS = 2
#: Warps a ring kernel's CTA spreads its columns over (``ring_lanes``):
#: one for each of the SM's four schedulers.  Eight, two each, ran slower
#: on the H100 (PERF.md, PR 13): each warp then issues the same
#: instructions for half the columns.
RING_WARPS = 4
#: Live lanes a warp of B2's CTA holds at most (:func:`static_words_per_cta`).
STATIC_LANES = 16
#: Most threads a CTA of a ring kernel has (ring.cuh kMaxThreads).
RING_MAX_THREADS = 256
#: Most threads (and so word columns) of any CTA.
MAX_THREADS = 1024
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              f"-DPIM_LEVEL_MAX_WIDTH={LEVEL_MAX_WIDTH}",
              f"-DPIM_TILE_RECORDS={TILE_RECORDS}")

#: Kernel launches per entry (a launch is counted where it is issued);
#: entries under the rows64 layout carry a ``_rows64`` suffix.
LAUNCHES = {f"{e}{sfx}": 0
            for e in ("slot_scan_fused", "slot_scan_io",
                      "level_gather_fused", "level_gather_io",
                      "slots_static_fused")
            for sfx in ("", "_rows64")}
LAUNCHES["gate_serial"] = 0
LAUNCHES["check_words"] = 0

#: Dynamic shared memory one CTA may opt into on sm_90 (227 KB).
SMEM_PER_CTA = 232448

_libs: Dict[Path, ctypes.CDLL] = {}
_named_libs: Dict[str, ctypes.CDLL] = {}
_width_tensors: Dict[tuple, torch.Tensor] = {}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_FUSED_ARGS = [_P, _P, _I, _P, _I, _P, _I, _I, _I, _P, _P, _I, _I, _P, _LL,
               _I, _I, _I, _I, _I, _I, _P]
_IO_ARGS = [_P, _P, _I, _P, _I, _I, _I, _P, _I, _P, _LL, _I, _I, _I, _I, _I,
            _I, _P]
_ARGTYPES = {
    "slot_scan_fused": _FUSED_ARGS, "slot_scan_io": _IO_ARGS,
    "level_gather_fused": _FUSED_ARGS, "level_gather_io": _IO_ARGS,
    "gate_serial": [_P, _P, _P, _I, _I, _I, _LL, _I, _I, _I, _P],
    "check_words": [_P, _P, _LL, _I, _LL, _P],
    "kernel_info": [_I, _I, _I, _I, _P],
    "slots_static_fused": [_P, _P, _I, _P, _I, _P, _P, _I, _I, _P, _LL, _I,
                           _I, _I, _I, _I, _P],
}


def reset_counts() -> None:
    """Zero the kernel launch counters and the plain versions' counters."""
    for counts in (LAUNCHES, kslots.CALLS, kref.CALLS):
        for k in counts:
            counts[k] = 0


def _entry(name: str, planes: int) -> str:
    return name if planes == 1 else f"{name}_rows64"


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(CUDA_HOME, "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit on the machine with the card")


def _build_key(source: bytes) -> str:
    h = hashlib.sha256(source)
    for header in HEADERS:
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _so_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_build_key(SOURCES[name].read_bytes())}.so"


def _compile(jobs: Dict[str, tuple]) -> Dict[str, tuple]:
    """Run one ``nvcc`` per job (name -> (source, library path)), all
    started together; returns name -> (compiler report, seconds from the
    start to that job's end).  Raises with the compiler's output if any
    build fails."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n, (src, so) in jobs.items():
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        log = so.with_suffix(f".{os.getpid()}.log")
        with open(log, "w") as f:      # a file, not a pipe: no job blocks
            proc = subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(src)], stdout=f, stderr=subprocess.STDOUT)
        procs[n] = (so, tmp, log, proc)
    done: Dict[str, float] = {}
    while len(done) < len(procs):
        for n, (_, _, _, proc) in procs.items():
            if n not in done and proc.poll() is not None:
                done[n] = time.perf_counter() - t0
        time.sleep(0.05)
    out, failed = {}, []
    for n, (so, tmp, log, proc) in procs.items():
        out[n] = (log.read_text(), done[n])
        log.unlink()
        if proc.returncode:
            failed.append(n)
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(out[n][0] for n in failed))
    return out


def build(names: Optional[Sequence[str]] = None,
          static: Sequence["StaticKernel"] = ()) -> Dict[str, tuple]:
    """Compile the named fixed kernels (default: all) and the generated
    ``static`` kernels that are not built yet, one ``nvcc`` per source,
    all started together; returns each fresh build's (compiler report,
    seconds), keyed by kernel name or static library name.  The report is
    ``-Xptxas -v``'s: registers, shared memory, spills."""
    names = list(SOURCES if names is None else names)
    todo = {n: (SOURCES[n], _so_path(n)) for n in names
            if not _so_path(n).exists()}
    fresh = {k.so.name: k for k in static if not k.built}
    if not todo and not fresh:
        return {}
    _nvcc()                          # raise before writing any source
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for n, k in fresh.items():
        k.cu.write_text(k.source)
        todo[n] = (k.cu, k.so)
    return _compile(todo)


def _load(so: Path) -> ctypes.CDLL:
    lib = _libs.get(so)
    if lib is None:
        lib = ctypes.CDLL(str(so))
        for fn, argtypes in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _libs[so] = lib
    return lib


def _lib(name: str) -> ctypes.CDLL:
    lib = _named_libs.get(name)
    if lib is None:
        build([name])
        lib = _named_libs[name] = _load(_so_path(name))
    return lib


# --------------------------------------------------------------------------
# launch shape
# --------------------------------------------------------------------------

def fit_words_per_cta(n_cells: int, cap: int, planes: int = 1,
                      reserve: int = 0) -> int:
    """Words per CTA for a state of ``n_cells`` cells of ``planes`` 32-bit
    planes: at most ``cap``, at most :data:`MAX_THREADS`, and at most what
    one CTA's shared memory holds beside ``reserve`` bytes (the ring).
    Raises when a single word column of the state does not fit."""
    col_bytes = 4 * planes * max(int(n_cells), 1)
    room = SMEM_PER_CTA - reserve
    fit = room // col_bytes
    if fit < 1:
        beside = " beside the ring" if reserve else ""
        raise ValueError(
            f"a program state of {n_cells} cells needs {col_bytes} B of "
            f"shared memory per word column, more than the {room} B a CTA "
            f"holds{beside}")
    return max(1, min(int(cap), fit, MAX_THREADS))


def ring_words_per_cta(n_cells: int, planes: int = 1) -> int:
    """Words per CTA of the ring kernels (B1, B3, B4) for a state of
    ``n_cells`` cells of ``planes`` 32-bit planes: as many columns as one
    CTA's shared memory holds beside the ring, at most ``32 // planes`` a
    warp of :data:`RING_WARPS`, so that a warp's shared access is one
    128-byte wavefront.  Each column waits on its own chain of windows, so
    the columns an SM holds set the kernel's time (PERF.md, the sweep of
    PR 13).  Raises when a single column does not fit."""
    return fit_words_per_cta(n_cells, 32 // planes * RING_WARPS, planes,
                             RING_BYTES)


def static_words_per_cta(n_cells: int, planes: int = 1) -> int:
    """Words per CTA of the static-slice kernel (B2): as many columns as
    the state alone lets one CTA hold, at most 16 a warp of
    :data:`RING_WARPS` under either layout.  B2's levels take little time
    beside its bridges, and at 1 Mi rows of fp32 add, fp16 add and uint16
    add 64 columns ran faster than 128 (PERF.md, the sweep of PR 14)."""
    return fit_words_per_cta(n_cells, STATIC_LANES * RING_WARPS, planes)


def ring_lanes(wpc: int) -> int:
    """Live lanes a warp of a CTA of ``wpc`` columns (B1 to B4): the
    columns spread evenly over :data:`RING_WARPS` warps, whole warps once
    they fill them, so that every scheduler of the SM has columns."""
    return min(32, -(-int(wpc) // RING_WARPS))


def state_stride(n_cells: int, wpc: int, planes: int = 1,
                 reserve: int = 0) -> int:
    """Words from one cell's row of a CTA's state to the next: ``wpc``, or
    ``wpc + 1`` where ``wpc`` is even and the extra column fits beside
    ``reserve`` bytes.  A fused bridge has the 32 lanes of a warp touch one
    word of 32 cells at once; an odd stride puts them in 32 banks (16 under
    rows64, whose 8-byte words a warp accesses in halves)."""
    if wpc % 2 == 0 and 4 * planes * max(int(n_cells), 1) * (wpc + 1) + \
            reserve <= SMEM_PER_CTA:
        return wpc + 1
    return wpc


def _checked_wpc(n_cells: int, planes: int, words_per_cta: Optional[int],
                 ring: bool) -> int:
    """``words_per_cta``, checked to fit one CTA (beside the ring for a
    ring kernel), or the rule when it is None."""
    if words_per_cta is None:
        return (ring_words_per_cta if ring else static_words_per_cta)(
            n_cells, planes)
    wpc = int(words_per_cta)
    reserve = RING_BYTES if ring else 0
    max_threads = RING_MAX_THREADS if ring else MAX_THREADS
    need = 4 * planes * max(int(n_cells), 1) * wpc + reserve
    threads = -(-wpc // ring_lanes(wpc)) * 32 if wpc > 0 else 0
    if wpc < 1 or threads > max_threads or need > SMEM_PER_CTA:
        beside = " with the ring" if ring else ""
        raise ValueError(f"{wpc} words per CTA of {n_cells} cells need "
                         f"{need} B of shared memory{beside} and "
                         f"{threads} threads; a CTA holds {SMEM_PER_CTA} B "
                         f"and {max_threads} threads")
    return wpc


def _ring_wpc(n_cells: int, planes: int, words_per_cta: Optional[int]) -> int:
    """``words_per_cta``, checked to fit beside the ring, or the rule."""
    return _checked_wpc(n_cells, planes, words_per_cta, ring=True)


def ring_shape(n_cells: int, planes: int = 1,
               words_per_cta: Optional[int] = None) -> tuple:
    """(words per CTA, stride, lanes a warp) of a ring kernel's launch:
    ``words_per_cta`` checked, or the rule."""
    wpc = _ring_wpc(n_cells, planes, words_per_cta)
    return wpc, state_stride(n_cells, wpc, planes, RING_BYTES), \
        ring_lanes(wpc)


# --------------------------------------------------------------------------
# packed streams of B1, B3 and B4
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Packed:
    """A packed stream (``csrc/ring.cuh``): ``tiles`` int32[n_tiles,
    2 * TILE_RECORDS], each record the uint16 (a, b, o, n) of one NOR gate
    ``o <- ~(a | b)``.  The ``n_windows`` windows take ``width`` records
    each (2, 4, 6 or 8: the kernel's window body), ``(TILE_RECORDS - WINDOW)
    // width`` to a tile; a window of fewer gates repeats its last gate,
    and ``n`` is the window's own gates on its first record, 0 elsewhere.
    ``n_gates`` counts the stream's own gates."""
    tiles: torch.Tensor
    n_windows: int
    n_gates: int
    width: int

    @property
    def n_tiles(self) -> int:
        return int(self.tiles.shape[0])

    def to(self, device) -> "Packed":
        return dataclasses.replace(self, tiles=self.tiles.to(device))


def window_width(n: int) -> int:
    """Records a window of up to ``n`` gates takes: 2, 4, 6 or 8, the
    kernels' window bodies (ring.cuh ``with_width``; 6 is the default slot
    width)."""
    if not 0 <= n <= WINDOW:
        raise ValueError(f"a window holds 1 to {WINDOW} gates (a level 1 "
                         f"to {WINDOW} lanes), got {n}")
    return 2 if n <= 2 else 4 if n <= 4 else 6 if n <= 6 else 8


def _pack(a, b, o, lens) -> Packed:
    """Lay the NOR gates ``(a, b, o)`` out in windows of ``lens`` gates, in
    order, at a fixed stride of :func:`window_width` records on tiles."""
    a, b, o = (np.asarray(x, np.int64).ravel() for x in (a, b, o))
    lens = np.asarray(lens, np.int64)
    cells = np.concatenate([a, b, o])
    if cells.size and not 0 <= cells.min() <= cells.max() < 1 << 16:
        raise ValueError("the packed stream holds cells as uint16; a cell "
                         "lies outside [0, 65536)")
    n_windows = len(lens)
    width = window_width(int(lens.max()) if n_windows else 0)
    per_tile = (TILE_RECORDS - WINDOW) // width
    n_tiles = -(-n_windows // per_tile)
    lane = np.arange(width)
    starts = np.cumsum(lens) - lens
    gate = starts[:, None] + np.minimum(lane, lens[:, None] - 1)
    w = np.arange(n_windows)[:, None]
    at = (w // per_tile) * TILE_RECORDS + (w % per_tile) * width + lane
    n = np.zeros((n_windows, width), np.int64)
    n[:, 0] = lens
    rec = np.zeros((n_tiles * TILE_RECORDS, 4), np.uint16)
    rec[at.ravel()] = np.stack([a[gate], b[gate], o[gate], n],
                               axis=-1).reshape(-1, 4).astype(np.uint16)
    tiles = torch.from_numpy(rec.view(np.int32).reshape(n_tiles,
                                                        2 * TILE_RECORDS))
    return Packed(tiles, n_windows, len(a), width)


def _cells_fit(n_cells: int, constants: int = 0) -> None:
    """Raise unless ``n_cells`` cells and ``constants`` more have uint16
    indices."""
    if n_cells >= 1 << 16 or n_cells + constants > 1 << 16:
        raise ValueError(
            f"a program of {n_cells} cells (and {constants} constant cells) "
            "does not fit the packed stream's uint16 cells: 65536 at most")


def pack_levels(a, b, o, *, n_cells: int) -> Packed:
    """B3's stream of a dense schedule ``a/b/o`` [n_levels, width]: one
    window a level, of all its lanes.  The pad lanes write sink cells that
    no port and no real lane reads, and the kernel runs a window's every
    lane at one cost, so they stay."""
    _cells_fit(n_cells)
    a, b, o = (np.asarray(x, np.int64) for x in (a, b, o))
    n_levels, width = a.shape
    return _pack(a, b, o, np.full(n_levels, width, np.int64))


def pack_slots(la, lb, lo, *, n_cells: int) -> Packed:
    """B1's stream of a slot schedule ``la/lb/lo`` [n_levels, W]: one
    window a level of all its W lanes, lane k writing cell ``lo[l, 0] +
    k`` of the level's band, as the plain version writes the whole band.
    A band may overwrite cells its own level reads: the kernel reads every
    operand of a window before it stores any, which is the level's
    meaning."""
    lo = np.asarray(lo, np.int64)
    band = lo[:, :1] + np.arange(lo.shape[1])
    return pack_levels(la, lb, band, n_cells=n_cells)


def gate_windows(ops, a, b, o, window: int = WINDOW) -> np.ndarray:
    """Gates per window of the lowered stream ``ops/a/b/o``, greedy in
    order: a window ends before a gate that reads a cell the window
    writes, writes a cell it reads or writes, or would make it longer than
    ``window``.  INIT0 and INIT1 read nothing."""
    lens = []
    reads, writes, n = set(), set(), 0
    for op, ia, ib, io in zip(np.asarray(ops).tolist(), np.asarray(a).tolist(),
                              np.asarray(b).tolist(), np.asarray(o).tolist()):
        r = (ia, ib) if op >= 2 else ()
        if n == window or io in reads or io in writes or \
                any(c in writes for c in r):
            lens.append(n)
            reads, writes, n = set(), set(), 0
        reads.update(r)
        writes.add(io)
        n += 1
    if n:
        lens.append(n)
    return np.asarray(lens, np.int64)


def pack_gates(ops, a, b, o, *, n_cells: int, window: int = GATE_WINDOW
               ) -> Packed:
    """B4's stream of the lowered stream ``ops/a/b/o`` over ``n_cells``
    cells: in order, in the windows of :func:`gate_windows` of at most
    ``window`` gates.  Every gate becomes a NOR: INIT1 reads the constant
    cell ``n_cells`` (all zeros) twice, INIT0 the constant cell
    ``n_cells + 1`` (all ones), which the kernel keeps after the state."""
    _cells_fit(n_cells, constants=GATE_CONSTANTS)
    ops = np.asarray(ops)
    const = np.where(ops == 1, n_cells, n_cells + 1)
    a2 = np.where(ops >= 2, a, const)
    b2 = np.where(ops >= 2, b, const)
    return _pack(a2, b2, o, gate_windows(ops, a, b, o, window))


def _widths_tensor(widths: Sequence[int], device) -> torch.Tensor:
    key = (tuple(int(w) for w in widths), str(device))
    t = _width_tensors.get(key)
    if t is None:
        t = torch.tensor(key[0] or (0,), dtype=torch.int32, device=device)
        _width_tensors[key] = t
    return t


def _on_cuda(x: torch.Tensor, entry: str) -> torch.device:
    if x.device.type != "cuda":
        raise ValueError(f"{entry} runs on CUDA tensors, got {x.device}")
    return x.device


def _check(device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _schedule_args(la, lb, lo, dense: bool = False):
    """(n_levels, width) of the schedule operands; refuses a width wider
    than a window of the packed stream (a gate-free schedule passes at any
    width)."""
    if la.dim() != 2 or la.shape != lb.shape or la.shape != lo.shape:
        raise ValueError(f"schedule operands must share one 2-D shape, got "
                         f"{tuple(la.shape)}, {tuple(lb.shape)}, "
                         f"{tuple(lo.shape)}")
    n_levels, width = la.shape
    if n_levels and not 1 <= width <= WINDOW:
        what = ("level-gather kernel runs dense schedules of" if dense else
                "slot-scan kernel runs slot widths")
        raise ValueError(f"the {what} 1 to {WINDOW} lanes, got {width}")
    return n_levels, width


def _ptr(t: torch.Tensor) -> Optional[int]:
    return t.data_ptr() if t.numel() else None


def _raise_on(err: int, entry: str) -> None:
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


def _stream(dev) -> int:
    return torch.cuda.current_stream(dev).cuda_stream


# --------------------------------------------------------------------------
# B1 and B3: the slot-scan and level-gather wrappers
# --------------------------------------------------------------------------

def _fused(lib_name, entry, in_vals, in_idx, out_idx, packed, *, n_cells,
           one_cell, in_widths, out_widths, planes, words_per_cta):
    """Launch a ring kernel's fused entry on the stream ``packed``."""
    dev = in_vals.device
    _check(dev, in_vals=in_vals, in_idx=in_idx, out_idx=out_idx)
    if in_vals.dim() != 2 or in_vals.shape[0] != len(in_widths):
        raise ValueError(f"in_vals must be [{len(in_widths)}, n_rows], got "
                         f"{tuple(in_vals.shape)}")
    if max(tuple(in_widths) + tuple(out_widths), default=0) > 32:
        raise ValueError("the fused entry takes ports of at most 32 cells")
    if in_idx.numel() != sum(in_widths) or \
            out_idx.numel() != sum(out_widths):
        raise ValueError("in_idx/out_idx must stack every port cell")
    if planes not in (1, 2):
        raise ValueError(f"planes must be 1 or 2, got {planes}")
    n_rows = in_vals.shape[1]
    out = torch.empty((len(out_widths), n_rows), dtype=torch.int32,
                      device=dev)
    if n_rows == 0 or not out_widths:
        return out
    shape = ring_shape(n_cells, planes, words_per_cta)
    fn = getattr(_lib(lib_name), entry)
    with torch.cuda.device(dev):
        err = fn(_ptr(in_vals), _widths_tensor(in_widths, dev).data_ptr(),
                 len(in_widths), _ptr(in_idx), in_idx.numel(),
                 _ptr(packed.tiles), packed.n_tiles, packed.n_windows,
                 packed.width, _ptr(out_idx),
                 _widths_tensor(out_widths, dev).data_ptr(),
                 len(out_widths), out_idx.numel(), out.data_ptr(), n_rows,
                 planes, n_cells, -1 if one_cell is None else int(one_cell),
                 *shape, _stream(dev))
    _raise_on(err, entry)
    LAUNCHES[_entry(entry, planes)] += 1
    return out


def _io(lib_name, entry, in_rows, in_idx, out_idx, packed, *, n_cells,
        one_cell, k_out, words_per_cta):
    """Launch a ring kernel's io entry on the stream ``packed``."""
    dev = in_rows.device
    _check(dev, in_rows=in_rows, in_idx=in_idx, out_idx=out_idx)
    planes = 1 if in_rows.dim() == 2 else in_rows.shape[0]
    if in_rows.dim() not in (2, 3) or planes not in (1, 2) or \
            in_rows.shape[-2] != in_idx.numel():
        raise ValueError(f"in_rows must be [{in_idx.numel()}, n_words] or "
                         f"[2, {in_idx.numel()}, n_words], got "
                         f"{tuple(in_rows.shape)}")
    if out_idx.numel() != k_out:
        raise ValueError(f"out_idx has {out_idx.numel()} cells, k_out is "
                         f"{k_out}")
    n_words = in_rows.shape[-1]
    out = torch.empty(kslots.plane_shape(planes, k_out, n_words),
                      dtype=torch.int32, device=dev)
    if n_words == 0 or k_out == 0:
        return out
    shape = ring_shape(n_cells, planes, words_per_cta)
    fn = getattr(_lib(lib_name), entry)
    with torch.cuda.device(dev):
        err = fn(_ptr(in_rows), _ptr(in_idx), in_idx.numel(),
                 _ptr(packed.tiles), packed.n_tiles, packed.n_windows,
                 packed.width, _ptr(out_idx), k_out, out.data_ptr(), n_words,
                 planes, n_cells, -1 if one_cell is None else int(one_cell),
                 *shape, _stream(dev))
    _raise_on(err, entry)
    LAUNCHES[_entry(entry, planes)] += 1
    return out


def _packed_on(dev, packed: Optional[Packed], la, lb, lo, n_cells: int,
               dense: bool) -> Packed:
    """``packed`` (the schedule's :func:`pack_slots` or :func:`pack_levels`
    stream on ``dev``), or ``la/lb/lo`` packed here.  The caller holds the
    result until the launch is queued, so its memory is not reused
    before."""
    if packed is None:
        _check(dev, la=la, lb=lb, lo=lo)
        _schedule_args(la, lb, lo, dense=dense)
        pack = pack_levels if dense else pack_slots
        return pack(la.cpu(), lb.cpu(), lo.cpu(), n_cells=n_cells).to(dev)
    if packed.tiles.device != dev:
        raise ValueError(f"packed stream is on {packed.tiles.device}, "
                         f"expected {dev}")
    return packed


def slots_fused(in_vals, in_idx, la, lb, lo, out_idx, *, n_cells, one_cell,
                in_widths, out_widths, in_base: Optional[int] = None,
                out_base: Optional[int] = None, planes: int = 1,
                words_per_cta: Optional[int] = None,
                packed: Optional[Packed] = None):
    """Fused slot executor (B1): per-row values int32[n_in_ports, n_rows]
    in, int32[n_out_ports, n_rows] out (ports of <= 32 cells, any
    ``n_rows``, ``planes`` the word layout), a slot schedule of 1 to 8
    lanes in between.  The kernel runs ``packed``, the schedule's
    :func:`pack_slots` stream on the card (callers that run a schedule
    often pack it once, as ``kernels.ops`` does); without it the wrapper
    packs ``la/lb/lo`` through the host.  It reads the input and output
    cells through ``in_idx``/``out_idx``; ``in_base``/``out_base`` only
    steer the plain version.  ``words_per_cta`` sets the CTA width
    (default :func:`ring_words_per_cta`)."""
    if in_vals.device.type == "cpu":
        return kslots.slots_fused(
            in_vals, in_idx, la, lb, lo, out_idx, n_cells=n_cells,
            one_cell=one_cell, in_widths=in_widths, out_widths=out_widths,
            in_base=in_base, out_base=out_base, planes=planes)
    dev = _on_cuda(in_vals, "slot_scan_fused")
    packed = _packed_on(dev, packed, la, lb, lo, n_cells, dense=False)
    return _fused("slot_scan", "slot_scan_fused", in_vals, in_idx, out_idx,
                  packed, n_cells=n_cells, one_cell=one_cell,
                  in_widths=in_widths, out_widths=out_widths, planes=planes,
                  words_per_cta=words_per_cta)


def slots_io(in_rows, in_idx, la, lb, lo, out_idx, *, n_cells, one_cell,
             k_out, in_base: Optional[int] = None,
             out_base: Optional[int] = None,
             words_per_cta: Optional[int] = None,
             packed: Optional[Packed] = None):
    """Slot executor over pre-packed port rows (B1): int32[k_in, n_words]
    in, int32[k_out, n_words] out (planes-leading under rows64; any port
    width); ``packed`` and ``words_per_cta`` as for :func:`slots_fused`."""
    if in_rows.device.type == "cpu":
        return kslots.slots_io(
            in_rows, in_idx, la, lb, lo, out_idx, n_cells=n_cells,
            one_cell=one_cell, k_out=k_out, in_base=in_base,
            out_base=out_base)
    dev = _on_cuda(in_rows, "slot_scan_io")
    packed = _packed_on(dev, packed, la, lb, lo, n_cells, dense=False)
    return _io("slot_scan", "slot_scan_io", in_rows, in_idx, out_idx, packed,
               n_cells=n_cells, one_cell=one_cell, k_out=k_out,
               words_per_cta=words_per_cta)


def level_fused(in_vals, in_idx, la, lb, lo, out_idx, *, n_cells, one_cell,
                in_widths, out_widths, planes: int = 1,
                words_per_cta: Optional[int] = None,
                packed: Optional[Packed] = None):
    """Fused dense executor (B3), the signature of
    ``ref.pim_exec_ref_level_fused``: per-row values in and out, a dense
    schedule of up to 8 lanes in between.  The kernel runs ``packed``, the
    schedule's :func:`pack_levels` stream on the card; ``packed`` and
    ``words_per_cta`` as for :func:`slots_fused`."""
    if in_vals.device.type == "cpu":
        return kref.pim_exec_ref_level_fused(
            in_vals, in_idx, la, lb, lo, out_idx, n_cells=n_cells,
            one_cell=one_cell, in_widths=in_widths, out_widths=out_widths,
            planes=planes)
    dev = _on_cuda(in_vals, "level_gather_fused")
    packed = _packed_on(dev, packed, la, lb, lo, n_cells, dense=True)
    return _fused("level_gather", "level_gather_fused", in_vals, in_idx,
                  out_idx, packed, n_cells=n_cells, one_cell=one_cell,
                  in_widths=in_widths, out_widths=out_widths, planes=planes,
                  words_per_cta=words_per_cta)


def level_io(in_rows, in_idx, la, lb, lo, out_idx, *, n_cells,
             one_cell=None, words_per_cta: Optional[int] = None,
             packed: Optional[Packed] = None):
    """Dense executor over pre-packed port rows (B3), the signature of
    ``ref.pim_exec_ref_level_io``: int32[k_in, n_words] in (planes-leading
    under rows64), the ``out_idx`` rows out; ``packed`` and
    ``words_per_cta`` as for :func:`level_fused`."""
    if in_rows.device.type == "cpu":
        return kref.pim_exec_ref_level_io(
            in_rows, in_idx, la, lb, lo, out_idx, n_cells=n_cells,
            one_cell=one_cell)
    dev = _on_cuda(in_rows, "level_gather_io")
    packed = _packed_on(dev, packed, la, lb, lo, n_cells, dense=True)
    return _io("level_gather", "level_gather_io", in_rows, in_idx, out_idx,
               packed, n_cells=n_cells, one_cell=one_cell,
               k_out=out_idx.numel(), words_per_cta=words_per_cta)


# --------------------------------------------------------------------------
# B4: the gate-serial wrapper
# --------------------------------------------------------------------------

def gate_serial(state, ops, a, b, o, *, words_per_cta: Optional[int] = None,
                packed: Optional[Packed] = None):
    """Gate-serial executor (B4), the signature of ``ref.pim_exec_ref``:
    the lowered stream ``ops/a/b/o`` (int32[n_gates] each) over the whole
    state int32[n_cells, n_words]; returns the final state (a new tensor
    on the card, ``state`` itself on the CPU).  The kernel runs
    ``packed``, the stream's :func:`pack_gates` on the card (``kernels.ops``
    packs each program once); without it the wrapper packs ``ops/a/b/o``.
    The kernel indexes shared memory with the cells unchecked: callers
    pass a lowered program's own arrays (``kernels.ops`` checks them
    once).  ``words_per_cta`` sets the CTA width (default
    :func:`ring_words_per_cta`)."""
    if state.device.type == "cpu":
        return kref.pim_exec_ref(state, ops, a, b, o)
    dev = _on_cuda(state, "gate_serial")
    _check(dev, state=state, ops=ops, a=a, b=b, o=o)
    if state.dim() != 2:
        raise ValueError(f"the gate-serial kernel runs rows32 states "
                         f"[n_cells, n_words], got {tuple(state.shape)}")
    n_gates = ops.numel()
    if not (a.numel() == b.numel() == o.numel() == n_gates):
        raise ValueError("ops/a/b/o must have one entry per gate")
    n_cells, n_words = state.shape
    out = torch.empty_like(state)
    if n_words == 0 or n_cells == 0:
        return out
    if packed is None:
        packed = pack_gates(*(x.cpu() for x in (ops, a, b, o)),
                            n_cells=n_cells).to(dev)
    elif packed.tiles.device != dev or packed.n_gates != n_gates:
        raise ValueError("packed must be the stream of these gates on "
                         f"{dev}")
    wpc = _ring_wpc(n_cells + GATE_CONSTANTS, 1, words_per_cta)
    with torch.cuda.device(dev):
        err = _lib("gate_serial").gate_serial(
            state.data_ptr(), out.data_ptr(), _ptr(packed.tiles),
            packed.n_tiles, packed.n_windows, packed.width, n_words,
            n_cells, wpc, ring_lanes(wpc), _stream(dev))
    _raise_on(err, "gate_serial")
    LAUNCHES["gate_serial"] += 1
    return out


# --------------------------------------------------------------------------
# B6: the check-word fold
# --------------------------------------------------------------------------

def check_words(block, axis: int):
    """XOR fold of ``block`` (int32 bit patterns) over ``axis`` (B6), the
    signature of ``ref.check_words``: fused per-port row values
    ``(n_ports, rows)`` over axis 0, packed blocks ``(..., k, n_words)``
    over the cell axis ``ndim - 2``.  On a CPU tensor it calls the plain
    version; on a CUDA tensor it launches the kernel on the current
    stream or raises."""
    if block.device.type == "cpu":
        return kref.check_words(block, axis)
    dev = _on_cuda(block, "check_words")
    _check(dev, block=block)
    if block.dim() == 0 or not -block.dim() <= axis < block.dim():
        raise ValueError(f"axis {axis} is outside a block of shape "
                         f"{tuple(block.shape)}")
    axis %= block.dim()
    shape = tuple(block.shape)
    outer = int(np.prod(shape[:axis], dtype=np.int64))
    inner = int(np.prod(shape[axis + 1:], dtype=np.int64))
    out = torch.empty(shape[:axis] + shape[axis + 1:], dtype=torch.int32,
                      device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = _lib("check_words").check_words(
            _ptr(block), out.data_ptr(), outer, shape[axis], inner,
            _stream(dev))
    _raise_on(err, "check_words")
    LAUNCHES["check_words"] += 1
    return out


# --------------------------------------------------------------------------
# B2: the generated static-slice kernel
# --------------------------------------------------------------------------

_STATIC_HEAD = """\
// Static-slice executor for one slot schedule, written by
// repro_torch.kernels.pim_exec.static_source: {n_levels} levels, {n_gates}
// NOR lanes, {n_cells} cells, planes = {planes}, {wpc} words per CTA over
// {threads} threads ({lanes} live lanes a warp), {stride} words a cell.
//
// Replaces the TPU kernel `_pim_level_kernel` (src/repro/kernels/pim_exec.py,
// built by `make_slots_static`), with the fused bit-transpose bridges of
// pim_state.cuh.  The slot-scan kernel (slot_scan.cu) runs the same schedule
// from a packed stream; here every level is unrolled and every cell offset is
// a compile-time constant (`s[cell * {stride}]`), so the level body is shared
// loads, NORs and shared stores with immediate offsets and no index loads.
// Only each level's real lanes are emitted, {n_fns} device function(s) of
// at most {fn_levels} levels.  The kernel's launch bounds are the threads
// it launches, so a thread may take up to 255 registers and the compiler
// may hoist a level's loads above the stores of the levels before it; the
// bridges keep the loads of a warp's LANES words in flight.  What bounds
// it: the instructions a warp issues, one a shared access and one a NOR,
// with one warp a scheduler, and the fused bridges around them, which wait
// on device memory.

#include "pim_state.cuh"

namespace {{

constexpr int P = {planes};
constexpr int WPC = {wpc};
constexpr int STRIDE = {stride};
constexpr int LANES = {lanes};
constexpr int THREADS = {threads};
constexpr int N_CELLS = {n_cells};
using T = pim::WordOf<P>::T;
"""

_STATIC_TAIL = """
__global__ void __launch_bounds__(THREADS) slots_static_kernel(
    const pim::Params p) {{
  pim::run<P, true, LANES>(p, [](pim::Column me) {{
    if (!me.live) return;
{calls}  }});
}}

}}  // namespace

// Returns cudaGetLastError() of the launch (0 on success).
extern "C" int slots_static_fused(
    const void* in_vals, const void* in_widths, int n_in_ports,
    const void* in_idx, int k_in, const void* out_idx,
    const void* out_widths, int n_out_ports, int k_out, void* out_vals,
    long long n_rows, int n_cells, int one_cell, int wpc, int stride,
    int lanes, void* stream) {{
  if (wpc != WPC || stride != STRIDE || lanes != LANES ||
      n_cells != N_CELLS) {{
    return static_cast<int>(cudaErrorInvalidValue);
  }}
  const pim::Params p = pim::fused_params(
      in_vals, in_widths, n_in_ports, in_idx, k_in, out_idx, out_widths,
      n_out_ports, k_out, out_vals, n_rows, P, n_cells, one_cell, wpc,
      stride, lanes);
  return pim::launch(slots_static_kernel, p,
                     pim::state_bytes(N_CELLS, STRIDE, sizeof(T)), THREADS,
                     stream, p);
}}
"""


def static_shape(n_cells: int, wpc: int, planes: int = 1) -> tuple:
    """(stride, lanes a warp, threads) of B2's CTA of ``wpc`` columns."""
    lanes = ring_lanes(wpc)
    return (state_stride(n_cells, wpc, planes), lanes,
            -(-wpc // lanes) * 32)


def static_source(sched, planes: int, wpc: int,
                  split: Optional[int] = None) -> str:
    """CUDA source of the static-slice kernel for slot schedule ``sched``
    under ``planes`` and ``wpc`` words per CTA (:func:`static_shape`):
    per level, its real lanes' operands are read into registers, NORed,
    and written to the band at constant offsets.  The body is one device
    function; ``split`` cuts it into ``__noinline__`` functions of that
    many levels instead, which only ``chip_smoke.py --split-probe`` builds
    (PERF.md: whole compiles in seconds and runs no slower)."""
    if sched.alloc != "slots":
        raise ValueError("static emission requires a slot schedule "
                         f"(got alloc={sched.alloc!r})")
    stride, lanes, threads = static_shape(sched.n_cells, wpc, planes)
    seg = max(int(split or sched.n_levels), 1)
    parts = [_STATIC_HEAD.format(
        n_levels=sched.n_levels, n_gates=int(sched.level_width.sum()),
        n_cells=sched.n_cells, planes=planes, wpc=wpc, stride=stride,
        lanes=lanes, threads=threads, n_fns=-(-sched.n_levels // seg),
        fn_levels=seg)]
    calls = []
    for lo_row in range(0, sched.n_levels, seg):
        name = f"seg{lo_row // seg}"
        calls.append(f"    {name}(me.col);\n")
        body = [f"\n__device__ __noinline__ void {name}(int col) {{\n",
                "  T* s = pim::state<P>() + col;\n"]
        for l in range(lo_row, min(lo_row + seg, sched.n_levels)):
            w = int(sched.level_width[l])
            off = int(sched.out[l, 0])
            reads = " ".join(
                f"const T v{k} = ~(s[{int(sched.a[l, k]) * stride}] | "
                f"s[{int(sched.b[l, k]) * stride}]);" for k in range(w))
            writes = " ".join(f"s[{(off + k) * stride}] = v{k};"
                              for k in range(w))
            body.append(f"  {{ {reads} {writes} }}\n")
        body.append("}\n")
        parts.append("".join(body))
    parts.append(_STATIC_TAIL.format(calls="".join(calls)))
    return "".join(parts)


class StaticKernel:
    """B2 for one slot schedule, port widths and layout: the generated
    kernel's source and library, and its plain version
    (``slots.build_static_chain``), behind one call with the signature of
    the reference's ``make_slots_static`` result: ``run(in_vals)``,
    per-row values int32[n_in_ports, n_rows] in (any ``n_rows``),
    int32[n_out_ports, n_rows] out.  On a CPU tensor it runs the plain
    chain; on a CUDA tensor it launches the kernel, built by
    :meth:`build` (:func:`build` builds several at once).
    ``words_per_cta`` sets the CTA width (default
    :func:`static_words_per_cta`); ``seg_levels`` is the plain chain's
    segment size; ``split`` goes to :func:`static_source`."""

    def __init__(self, sched, in_widths, out_widths, out_names, in_cells, *,
                 planes: int = 1, words_per_cta: Optional[int] = None,
                 seg_levels: int = SLOT_SEG_LEVELS,
                 split: Optional[int] = None):
        self.sched = sched
        self.in_widths = tuple(int(w) for w in in_widths)
        self.out_widths = tuple(int(w) for w in out_widths)
        self.out_names = list(out_names)
        self.in_cells = [int(c) for c in in_cells]
        if max(self.in_widths + self.out_widths, default=0) > 32:
            raise ValueError("the static kernel takes ports of at most 32 "
                             "cells")
        self.planes = planes
        self.seg_levels = seg_levels
        self.wpc = _checked_wpc(sched.n_cells, planes, words_per_cta,
                                ring=False)
        self.stride, self.lanes, self.threads = static_shape(
            sched.n_cells, self.wpc, planes)
        self.source = static_source(sched, planes, self.wpc, split)
        key = _build_key(self.source.encode())
        self.cu = BUILD_DIR / f"slots_static-{key}.cu"
        self.so = BUILD_DIR / f"slots_static-{key}.so"
        self._plain = None
        self._lib: Optional[ctypes.CDLL] = None
        self._idx: Dict[str, tuple] = {}

    @property
    def built(self) -> bool:
        return self.so.exists()

    def build(self) -> Dict[str, tuple]:
        """Compile the kernel unless it is built; returns {library name:
        (compiler report, seconds)} for a fresh build."""
        return build([], static=[self])

    def plain(self, in_vals):
        if self._plain is None:
            self._plain = kslots.build_static_chain(
                self.sched, self.in_widths, self.out_widths, self.out_names,
                self.in_cells, seg_levels=self.seg_levels, fused=True,
                planes=self.planes)
        return self._plain(in_vals)

    def _operands(self, dev):
        key = str(dev)
        if key not in self._idx:
            s = self.sched
            out_cells = [c for n in self.out_names for c in s.ports[n]]
            self._idx[key] = tuple(
                torch.tensor(c or [0], dtype=torch.int32, device=dev)
                for c in (self.in_cells, out_cells))
        return self._idx[key]

    def __call__(self, in_vals):
        if in_vals.device.type == "cpu":
            return self.plain(in_vals)
        dev = _on_cuda(in_vals, "slots_static_fused")
        _check(dev, in_vals=in_vals)
        if in_vals.dim() != 2 or in_vals.shape[0] != len(self.in_widths):
            raise ValueError(f"in_vals must be [{len(self.in_widths)}, "
                             f"n_rows], got {tuple(in_vals.shape)}")
        n_rows = in_vals.shape[1]
        out = torch.empty((len(self.out_widths), n_rows), dtype=torch.int32,
                          device=dev)
        if n_rows == 0 or not self.out_widths:
            return out
        if self._lib is None:          # one look at the disk, not a call's
            if not self.built:
                self.build()
            self._lib = _load(self.so)
        in_idx, out_idx = self._operands(dev)
        s = self.sched
        with torch.cuda.device(dev):
            err = self._lib.slots_static_fused(
                _ptr(in_vals), _widths_tensor(self.in_widths, dev).data_ptr(),
                len(self.in_widths), in_idx.data_ptr(), len(self.in_cells),
                out_idx.data_ptr(),
                _widths_tensor(self.out_widths, dev).data_ptr(),
                len(self.out_widths), sum(self.out_widths), out.data_ptr(),
                n_rows, s.n_cells,
                -1 if s.one_cell is None else int(s.one_cell), self.wpc,
                self.stride, self.lanes, _stream(dev))
        _raise_on(err, "slots_static_fused")
        LAUNCHES[_entry("slots_static_fused", self.planes)] += 1
        return out
