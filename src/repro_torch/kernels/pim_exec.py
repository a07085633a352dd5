"""Hopper kernels of the PIM executor: build, binding and wrappers.

``csrc/slot_scan.cu`` holds the slot-scan kernel, the CUDA counterpart of
``repro.kernels.pim_exec._slot_scan_kernel`` with the bit-transpose
bridges of ``repro.kernels.slots`` fused into its ``fused`` entry.  It is
compiled with ``nvcc`` for ``sm_90a`` into a shared library with a plain C
interface at first use (``build/repro_torch/`` at the checkout root, keyed
on the source hash) and bound with ``ctypes``.

The wrappers take the plain versions' signatures (``kernels.slots``).  On
a CPU tensor they call the plain version; on a CUDA tensor they launch the
kernel or raise.  Each launch adds one to :data:`LAUNCHES`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

from . import slots as kslots
from .plan import SLOT_WIDTH

_PKG = Path(__file__).resolve().parent.parent
#: kernel name -> CUDA source
SOURCES = {"slot_scan": _PKG / "csrc" / "slot_scan.cu"}
BUILD_DIR = _PKG.parent.parent / "build" / "repro_torch"
#: The CUDA toolkit consulted when ``nvcc`` is not on ``PATH``.
CUDA_HOME = os.environ.get("CUDA_HOME", "/usr/local/cuda")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Kernel launches per entry (a launch is counted where it is issued).
LAUNCHES = {"slot_scan_fused": 0, "slot_scan_io": 0}

#: Dynamic shared memory one CTA may opt into on sm_90 (227 KB).
SMEM_PER_CTA = 232448

_libs: Dict[str, ctypes.CDLL] = {}
_width_tensors: Dict[tuple, torch.Tensor] = {}

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ARGTYPES = {
    "slot_scan_fused": [_P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _P, _P, _I,
                        _I, _P, _LL, _I, _I, _I, _P],
    "slot_scan_io": [_P, _P, _I, _P, _P, _P, _I, _I, _P, _I, _P, _LL, _I,
                     _I, _I, _P],
}


def reset_counts() -> None:
    """Zero the kernel launch counters and the plain versions' counters."""
    for counts in (LAUNCHES, kslots.CALLS):
        for k in counts:
            counts[k] = 0


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


def _so_path(name: str) -> Path:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names: Optional[Sequence[str]] = None) -> Dict[str, str]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` per source, all started together; returns each fresh
    build's compiler report (``-Xptxas -v``: registers, shared memory,
    spills).  Raises with the compiler's output if a build fails."""
    names = list(SOURCES if names is None else names)
    todo = [n for n in names if not _so_path(n).exists()]
    if not todo:
        return {}
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = _so_path(n).with_suffix(f".{os.getpid()}.tmp")
        procs[n] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[n])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = {}, []
    for n, (tmp, proc) in procs.items():
        logs[n] = proc.communicate()[0]
        if proc.returncode:
            failed.append(n)
        else:
            os.replace(tmp, _so_path(n))
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(failed) + ":\n" +
                           "\n".join(logs[n] for n in failed))
    return logs


def _lib(name: str) -> ctypes.CDLL:
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_so_path(name)))
        for fn, argtypes in _ARGTYPES.items():
            if hasattr(lib, fn):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
        _libs[name] = lib
    return lib


# --------------------------------------------------------------------------
# launch shape
# --------------------------------------------------------------------------

def fit_words_per_cta(n_cells: int, cap: int) -> int:
    """Words per CTA for a state of ``n_cells`` cells: at most ``cap``, at
    most what fits in one CTA's shared memory, and a multiple of 32 (one
    warp) from 32 up.  Raises when a single 32-row column of the state
    does not fit."""
    fit = SMEM_PER_CTA // (4 * max(int(n_cells), 1))
    if fit < 1:
        raise ValueError(
            f"a program state of {n_cells} cells needs {4 * n_cells} B of "
            f"shared memory per word column, more than the {SMEM_PER_CTA} B "
            "a CTA can hold")
    wpc = max(1, min(int(cap), fit, 1024))
    return wpc // 32 * 32 if wpc >= 32 else wpc


def _widths_tensor(widths: Sequence[int], device) -> torch.Tensor:
    key = (tuple(int(w) for w in widths), str(device))
    t = _width_tensors.get(key)
    if t is None:
        t = torch.tensor(key[0] or (0,), dtype=torch.int32, device=device)
        _width_tensors[key] = t
    return t


def _check(device, **tensors) -> None:
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")
        if t.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _schedule_args(la, lb, lo):
    if la.dim() != 2 or la.shape != lb.shape or la.shape != lo.shape:
        raise ValueError(f"schedule operands must share one 2-D shape, got "
                         f"{tuple(la.shape)}, {tuple(lb.shape)}, "
                         f"{tuple(lo.shape)}")
    n_levels, width = la.shape
    if n_levels and width != SLOT_WIDTH:
        raise ValueError(f"the slot-scan kernel runs slot width {SLOT_WIDTH} "
                         f"only, got {width}; other widths come with the "
                         "dense schedule (ROADMAP A6)")
    return n_levels, width


def _ptr(t: torch.Tensor) -> Optional[int]:
    return t.data_ptr() if t.numel() else None


def _raise_on(err: int, entry: str) -> None:
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")


# --------------------------------------------------------------------------
# wrappers
# --------------------------------------------------------------------------

def slots_fused(in_vals, in_idx, la, lb, lo, out_idx, *, n_cells, one_cell,
                in_widths, out_widths, in_base: Optional[int] = None,
                out_base: Optional[int] = None,
                words_per_cta: int = 32):
    """Fused slot executor: per-row values int32[n_in_ports, n_rows] in,
    int32[n_out_ports, n_rows] out (ports of <= 32 cells, any ``n_rows``).
    The kernel reads the input and output cells through ``in_idx`` /
    ``out_idx``; ``in_base``/``out_base`` only steer the plain version.
    ``words_per_cta`` caps the CTA width (see :func:`fit_words_per_cta`)."""
    if in_vals.device.type == "cpu":
        return kslots.slots_fused(
            in_vals, in_idx, la, lb, lo, out_idx, n_cells=n_cells,
            one_cell=one_cell, in_widths=in_widths, out_widths=out_widths,
            in_base=in_base, out_base=out_base)
    dev = in_vals.device
    if dev.type != "cuda":
        raise ValueError(f"slot_scan_fused runs on CUDA tensors, got {dev}")
    _check(dev, in_vals=in_vals, in_idx=in_idx, la=la, lb=lb, lo=lo,
           out_idx=out_idx)
    n_levels, width = _schedule_args(la, lb, lo)
    if in_vals.dim() != 2 or in_vals.shape[0] != len(in_widths):
        raise ValueError(f"in_vals must be [{len(in_widths)}, n_rows], got "
                         f"{tuple(in_vals.shape)}")
    if max(tuple(in_widths) + tuple(out_widths), default=0) > 32:
        raise ValueError("the fused entry takes ports of at most 32 cells")
    if in_idx.numel() != sum(in_widths) or \
            out_idx.numel() != sum(out_widths):
        raise ValueError("in_idx/out_idx must stack every port cell")
    n_rows = in_vals.shape[1]
    out = torch.empty((len(out_widths), n_rows), dtype=torch.int32,
                      device=dev)
    if n_rows == 0 or not out_widths:
        return out
    wpc = fit_words_per_cta(n_cells, words_per_cta)
    lib = _lib("slot_scan")
    with torch.cuda.device(dev):
        err = lib.slot_scan_fused(
            _ptr(in_vals), _widths_tensor(in_widths, dev).data_ptr(),
            len(in_widths), _ptr(in_idx), in_idx.numel(),
            _ptr(la), _ptr(lb), _ptr(lo), n_levels, width, _ptr(out_idx),
            _widths_tensor(out_widths, dev).data_ptr(), len(out_widths),
            out_idx.numel(), out.data_ptr(), n_rows, n_cells,
            -1 if one_cell is None else int(one_cell), wpc,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "slot_scan_fused")
    LAUNCHES["slot_scan_fused"] += 1
    return out


def slots_io(in_rows, in_idx, la, lb, lo, out_idx, *, n_cells, one_cell,
             k_out, in_base: Optional[int] = None,
             out_base: Optional[int] = None, words_per_cta: int = 32):
    """Slot executor over pre-packed port rows: int32[k_in, n_words] in,
    int32[k_out, n_words] out (any port width)."""
    if in_rows.device.type == "cpu":
        return kslots.slots_io(
            in_rows, in_idx, la, lb, lo, out_idx, n_cells=n_cells,
            one_cell=one_cell, k_out=k_out, in_base=in_base,
            out_base=out_base)
    dev = in_rows.device
    if dev.type != "cuda":
        raise ValueError(f"slot_scan_io runs on CUDA tensors, got {dev}")
    _check(dev, in_rows=in_rows, in_idx=in_idx, la=la, lb=lb, lo=lo,
           out_idx=out_idx)
    n_levels, width = _schedule_args(la, lb, lo)
    if in_rows.dim() != 2 or in_rows.shape[0] != in_idx.numel():
        raise ValueError(f"in_rows must be [{in_idx.numel()}, n_words], got "
                         f"{tuple(in_rows.shape)}")
    if out_idx.numel() != k_out:
        raise ValueError(f"out_idx has {out_idx.numel()} cells, k_out is "
                         f"{k_out}")
    n_words = in_rows.shape[1]
    out = torch.empty((k_out, n_words), dtype=torch.int32, device=dev)
    if n_words == 0 or k_out == 0:
        return out
    wpc = fit_words_per_cta(n_cells, words_per_cta)
    lib = _lib("slot_scan")
    with torch.cuda.device(dev):
        err = lib.slot_scan_io(
            _ptr(in_rows), _ptr(in_idx), in_idx.numel(), _ptr(la), _ptr(lb),
            _ptr(lo), n_levels, width, _ptr(out_idx), k_out, out.data_ptr(),
            n_words, n_cells, -1 if one_cell is None else int(one_cell), wpc,
            torch.cuda.current_stream(dev).cuda_stream)
    _raise_on(err, "slot_scan_io")
    LAUNCHES["slot_scan_io"] += 1
    return out
