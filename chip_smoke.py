"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # full size: 64 Mi rows
    python3 chip_smoke.py --sweep          # also sweep the cuda Backend tunables
                                           # and the ring kernels' CTA width,
                                           # and profile the main path
    python3 chip_smoke.py --split-probe    # also build B2 whole and split
                                           # and compare them
    python3 chip_smoke.py --probe [DIR]    # also time the ring kernels and
                                           # print launch attributes (and
                                           # those of the kernels in DIR)

Phases, each of which raises (exit code 1) on failure:

1. build every CUDA kernel of the port: the fixed sources in
   ``src/repro_torch/csrc``, the generated static-slice kernels (B2) of
   the programs below and the libraries that read the fixed kernels'
   launch attributes, one ``nvcc`` each, all started together;
2. print the card's name and power limit;
3. hold every kernel entry against its plain PyTorch version on the card,
   bit-exactly (``torch.equal``): the slot scan (B1), the level gather
   (B3), the static-slice kernels (B2) and the gate-serial kernel (B4),
   under rows32 and rows64, and the ring kernels (B3, B4) on long streams
   and at fewer than 32 words per CTA;
4. drive the main path through the public entry points, each run checked
   against numpy with the launch counters zeroed just before and read just
   after -- its kernel must have run and no plain version may have:
   ``pim_ufunc.fp_add`` on float32 at 64 Mi rows (the paper's 8 GB of
   1024x1024 crossbars) under the default slot schedule, ``dense``,
   ``slots-static`` and ``rows64`` (and the last two schedules under
   rows64); ``pim_ufunc.add`` on uint32 at 4 Mi rows (the io branch) under
   the slot and dense schedules, rows32 and rows64; and
   ``ops.run_program(..., levelized=False)`` on fp32 add at 4 Mi rows (the
   gate-serial path carries the whole state through the host);
5. time each kernel entry at one chunk of 1 Mi rows beside its plain
   version, one PyTorch library call computing the same function, and its
   bound, with its launch attributes (CTAs an SM, registers, local bytes).

The line before the last is a JSON object with one record per kernel entry;
the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM data-sheet device memory bandwidth (NVIDIA, 700 W).  The rate of
# the 32-bit NOR word operations is the card's logic-op rate: one LOP3 per
# NOR, 64 a clock per SM on 132 SMs, at the SM clock nvidia-smi reports
# (see ``measure``).
HBM_BYTES_PER_S = 3.35e12
N_SMS = 132
LOPS_PER_SM_CLOCK = 64
SEED = 0
#: Rows of the main path: the paper's 8 GB of 1024x1024 crossbars.
MAIN_ROWS = 64 << 20
#: Rows of the io-branch and gate-serial main-path runs (see PERF.md).
IO_ROWS = 4 << 20
SERIAL_ROWS = 4 << 20

#: entry -> (TPU kernel it replaces, CUDA source)
ENTRIES = {
    "slot_scan": ("src/repro/kernels/pim_exec.py:224",
                  "src/repro_torch/csrc/slot_scan.cu"),
    "level_gather": ("src/repro/kernels/pim_exec.py:134",
                     "src/repro_torch/csrc/level_gather.cu"),
    "slots_static": ("src/repro/kernels/pim_exec.py:332",
                     "src/repro_torch/kernels/pim_exec.py"),
    "gate_serial": ("src/repro/kernels/pim_exec.py:93",
                    "src/repro_torch/csrc/gate_serial.cu"),
}


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events,
    after warm-up calls for at least 50 ms, so that the card's clocks are
    up however long it idled before."""
    t0 = time.perf_counter()
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= 0.05:
            break
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def resolved(program, backend: str = "cuda", **backend_kw):
    from repro_torch.kernels import ops, plan as kplan
    plan = kplan.as_plan(backend=dataclasses.replace(
        kplan.BACKENDS[backend], **backend_kw), device="cuda")
    in_names = tuple(sorted(program.in_ports))
    return ops.compiled(program, plan).resolve(program, plan, in_names)


def operands(program, kind: str = "slots", planes: int = 1):
    """One program's schedule of ``kind`` ('slots' or 'dense') with every
    operand its kernel entries take, on the card (for 'dense' also B3's
    packed stream and the ring kernels' CTA width) --
    built directly, not through ``resolve``, so that each entry runs the
    schedule it is named for whatever the dispatcher would pick."""
    from repro_torch.kernels import ops, pim_exec, plan as kplan
    plan = kplan.as_plan(device="cuda", schedule=kind)
    s = ops.compiled(program, plan).get_schedule(program, plan)
    in_names = sorted(program.in_ports)
    out_names = ops.output_names(s)
    in_cells = ops._stacked_cells([s.pack_cells(n) for n in in_names])
    out_cells = ops._stacked_cells([s.ports[n] for n in out_names])

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    return SimpleNamespace(
        kind=kind, sched=s, planes=planes, in_cells=in_cells,
        out_names=out_names, in_idx=dev(in_cells), la=dev(s.a),
        lb=dev(s.b), lo=dev(s.out), out_idx=dev(out_cells),
        in_widths=tuple(len(s.pack_cells(n)) for n in in_names),
        out_widths=tuple(len(s.ports[n]) for n in out_names),
        k_out=len(out_cells), in_base=ops._as_run(in_cells),
        out_base=ops._as_run(out_cells) if kind == "slots" else None,
        one_cell=s.one_cell,
        packed=pim_exec.pack_levels(s.a, s.b, s.out,
                                    n_cells=s.n_cells).to("cuda")
        if kind == "dense" else None,
        wpc=pim_exec.ring_words_per_cta(s.n_cells, planes)
        if kind == "dense" else
        pim_exec.fit_words_per_cta(s.n_cells, kplan.WORDS_PER_CTA, planes))


def static_kernel(c):
    from repro_torch.kernels import pim_exec, plan as kplan
    return pim_exec.StaticKernel(c.sched, c.in_widths, c.out_widths,
                                 c.out_names, c.in_cells, planes=c.planes,
                                 words_per_cta=kplan.WORDS_PER_CTA)


def random_inputs(c, n_rows: int, fused: bool, rng) -> torch.Tensor:
    """Random bits for every input cell: per-row values masked to each
    port's width (fused) or packed port rows (io, planes-leading under
    rows64), on the card."""
    if fused:
        vals = rng.integers(0, 1 << 32, (len(c.in_widths), n_rows),
                            dtype=np.uint64)
        vals &= np.array([(1 << w) - 1 for w in c.in_widths],
                         np.uint64)[:, None]
        a = vals.astype(np.uint32)
    else:
        k_in = sum(c.in_widths)
        rpw = 32 * c.planes
        shape = (k_in, (n_rows + rpw - 1) // rpw)
        if c.planes > 1:
            shape = (c.planes,) + shape
        a = rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).cuda()


def run_entry(c, x, fused: bool, kernel: bool, static=None):
    """Launch ``c``'s fused or io entry: the kernel (``kernel``) or its
    plain version, on the same inputs.  ``static`` is the program's
    :class:`~repro_torch.kernels.pim_exec.StaticKernel` for B2."""
    from repro_torch.kernels import pim_exec, ref as kref, slots as kslots
    if static is not None:
        return static(x) if kernel else static.plain(x)
    args = (x, c.in_idx, c.la, c.lb, c.lo, c.out_idx)
    kw = dict(n_cells=c.sched.n_cells, one_cell=c.one_cell,
              words_per_cta=c.wpc)
    if c.kind == "slots":
        impl = pim_exec if kernel else kslots
        kw.update(in_base=c.in_base, out_base=c.out_base)
        if fused:
            return impl.slots_fused(*args, in_widths=c.in_widths,
                                    out_widths=c.out_widths,
                                    planes=c.planes, **kw)
        return impl.slots_io(*args, k_out=c.k_out, **kw)
    if kernel:
        kw["packed"] = c.packed
    if fused:
        fn = pim_exec.level_fused if kernel else kref.pim_exec_ref_level_fused
        return fn(*args, in_widths=c.in_widths, out_widths=c.out_widths,
                  planes=c.planes, **kw)
    fn = pim_exec.level_io if kernel else kref.pim_exec_ref_level_io
    return fn(*args, **kw)


def gate_free_program():
    from repro_torch.core import gates
    b = gates.Builder()
    x = b.input("x", 8)
    b.output("z", x)
    return b.finish()


def no_input_program():
    from repro_torch.core import gates
    b = gates.Builder()
    c1, c0 = b.const(1), b.const(0)
    b.output("ones", [c1, b.not_(c0), c1])
    b.output("mix", [c0, c1, c0, c1])
    return b.finish()


def programs():
    from repro_torch.core.pim_numerics import program_for
    return {
        "fp16 add": program_for("fp-serial", "add", "fp16"),
        "fp32 add": program_for("fp-serial", "add", "fp32"),
        "fp32 mul": program_for("fp-serial", "mul", "fp32"),
        "fp32 div": program_for("fp-serial", "div", "fp32"),
        "uint16 add": program_for("int-serial", "add", 16),
        "uint32 add": program_for("int-serial", "add", 32),
        "uint32 mul": program_for("int-serial", "mul", 32),
        "int-parallel mul16": program_for("int-parallel", "mul", 16),
        "int-parallel div64": program_for("int-parallel", "div", 64),
        "gate-free": gate_free_program(),
        "no-input": no_input_program(),
    }


#: Phase 3: (entry, program, fused, rows, planes): the slot scan, the
#: level gather, the static kernels, the gate-serial kernel, then rows64,
#: then the ring kernels on long streams (fp32 mul: 23 tiles for B4) and at
#: fewer than 32 words per CTA (int-parallel div64, 25354 cells: 2).
CHECKS = [
    ("slot_scan", "fp16 add", True, 1 << 20, 1),
    ("slot_scan", "fp32 add", True, 1 << 20, 1),
    ("slot_scan", "fp32 add", True, (1 << 20) + 3, 1),
    ("slot_scan", "fp32 add", True, 1 << 24, 1),
    ("slot_scan", "fp32 mul", True, 1 << 20, 1),
    ("slot_scan", "fp32 div", True, 1 << 20, 1),
    ("slot_scan", "uint16 add", True, 1 << 20, 1),
    ("slot_scan", "int-parallel mul16", True, 1 << 20, 1),
    ("slot_scan", "uint32 add", False, 1 << 20, 1),
    ("slot_scan", "uint32 mul", False, 1 << 20, 1),
    ("slot_scan", "uint32 add", False, (1 << 20) + 77, 1),
    ("slot_scan", "gate-free", True, 1000, 1),
    ("slot_scan", "gate-free", False, 1000, 1),
    ("slot_scan", "no-input", False, 1000, 1),
    ("level_gather", "fp16 add", True, 1 << 20, 1),
    ("level_gather", "fp32 add", True, 1 << 20, 1),
    ("level_gather", "fp32 mul", True, 1 << 20, 1),
    ("level_gather", "fp32 div", True, 1 << 20, 1),
    ("level_gather", "uint16 add", True, 1 << 20, 1),
    ("level_gather", "fp32 add", True, (1 << 20) + 3, 1),
    ("level_gather", "gate-free", True, 1000, 1),
    ("level_gather", "uint32 add", False, 1 << 20, 1),
    ("level_gather", "uint32 mul", False, 1 << 20, 1),
    ("slots_static", "fp16 add", True, 1 << 20, 1),
    ("slots_static", "fp32 add", True, 1 << 20, 1),
    ("slots_static", "uint16 add", True, (1 << 20) + 5, 1),
    ("slots_static", "gate-free", True, 1000, 1),
    ("slots_static", "no-input", True, 1000, 1),
    ("gate_serial", "fp16 add", None, 1 << 20, 1),
    ("gate_serial", "uint32 add", None, 1 << 20, 1),
    ("gate_serial", "uint32 mul", None, 1 << 20, 1),
    ("gate_serial", "fp32 add", None, SERIAL_ROWS, 1),
    ("slot_scan", "fp32 add", True, (1 << 20) + 37, 2),
    ("slot_scan", "uint32 add", False, (1 << 20) + 37, 2),
    ("level_gather", "fp32 add", True, (1 << 20) + 37, 2),
    ("level_gather", "uint32 add", False, (1 << 20) + 37, 2),
    ("slots_static", "fp32 add", True, (1 << 20) + 37, 2),
    ("slots_static", "uint16 add", True, (1 << 20) + 37, 2),
    ("gate_serial", "fp32 mul", None, (1 << 20) + 45, 1),
    ("gate_serial", "int-parallel div64", None, 1000, 1),
    ("level_gather", "fp32 mul", True, (1 << 20) + 37, 2),
]


def static_kernels(progs) -> dict:
    """The B2 kernels phase 3 and the main path run, by (program, planes)."""
    return {(name, planes): static_kernel(
        operands(progs[name], "slots", planes))
        for entry, name, _, _, planes in CHECKS if entry == "slots_static"}


def entry_key(entry: str, fused, planes: int) -> str:
    if entry == "gate_serial":
        return entry
    key = f"{entry}_{'fused' if fused else 'io'}"
    return key if planes == 1 else f"{key}_rows64"


def gate_serial_case(program, n_rows: int, rng):
    """A random whole state, the lowered stream of ``program`` and B4's
    packed stream of it, on the card, for the gate-serial entry."""
    from repro_torch.kernels import pim_exec
    ops_, a, b, o, n_cells = program.to_arrays()
    state = rng.integers(0, 1 << 32, (n_cells, (n_rows + 31) // 32),
                         dtype=np.uint64).astype(np.uint32)
    dev = [torch.from_numpy(np.ascontiguousarray(v, np.int32)).cuda()
           for v in (ops_, a, b, o)]
    packed = pim_exec.pack_gates(ops_, a, b, o, n_cells=n_cells).to("cuda")
    return torch.from_numpy(state.view(np.int32)).cuda(), dev, packed


def check_kernels(progs, statics) -> dict:
    """Phase 3: every kernel entry against its plain version on the card,
    bit-exact.  Returns the largest absolute difference seen per entry
    (0 when all agree)."""
    from repro_torch.kernels import pim_exec, ref as kref
    rng = np.random.default_rng(SEED)
    worst = {}
    for entry, name, fused, rows, planes in CHECKS:
        prog = progs[name]
        if entry == "gate_serial":
            state, gates, packed = gate_serial_case(prog, rows, rng)
            got = pim_exec.gate_serial(state, *gates, packed=packed)
            torch.cuda.synchronize()
            want = kref.pim_exec_ref(state.clone(), *gates)
            info = (f"gates={gates[0].numel()} windows={packed.n_windows} "
                    f"tiles={packed.n_tiles} cells={state.shape[0]} "
                    "words_per_cta=" + str(pim_exec.ring_words_per_cta(
                        state.shape[0] + pim_exec.GATE_CONSTANTS)))
        else:
            kind = "dense" if entry == "level_gather" else "slots"
            c = operands(prog, kind, planes)
            static = statics[(name, planes)] if entry == "slots_static" \
                else None
            x = random_inputs(c, rows, fused, rng)
            got = run_entry(c, x, fused, True, static)
            torch.cuda.synchronize()
            want = run_entry(c, x, fused, False, static)
            info = (f"levels={c.sched.n_levels} width={c.sched.width} "
                    f"cells={c.sched.n_cells} words_per_cta={c.wpc} "
                    f"one_cell={c.one_cell}")
        key = entry_key(entry, fused, planes)
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        worst[key] = max(worst.get(key, 0), err)
        same = torch.equal(got, want)
        print(f"check {key} {name}: rows={rows} {info} equal={same}",
              flush=True)
        if not same:
            raise AssertionError(f"kernel != plain version: {key} {name}")
    return worst


def _plain_calls() -> dict:
    from repro_torch.kernels import ref as kref, slots as kslots
    return {**kslots.CALLS, **kref.CALLS}


def _main_run(label: str, key: str, fn, want) -> tuple:
    """Run ``fn`` with the counters zeroed just before and read just
    after; the result must equal ``want`` bit for bit, ``key``'s kernel
    must have launched and no plain version may have run.  Returns
    (launches, seconds)."""
    from repro_torch.kernels import pim_exec
    pim_exec.reset_counts()
    t0 = time.perf_counter()
    got = fn()
    s = time.perf_counter() - t0
    launches = dict(pim_exec.LAUNCHES)
    plain = _plain_calls()
    if got.dtype != want.dtype or got.shape != want.shape or \
            not np.array_equal(got.view(np.uint8), want.view(np.uint8)):
        raise AssertionError(f"{label} differs from numpy")
    if launches[key] < 1 or any(plain.values()):
        raise AssertionError(f"{label} did not run its kernel: launches "
                             f"{launches}, plain {plain}")
    ran = {k: v for k, v in launches.items() if v}
    print(f"main {label}: bit-exact vs numpy; launches {ran}, plain calls "
          f"0; wall {s * 1e3:.3f} ms", flush=True)
    return launches[key], s


def main_path() -> dict:
    """Phase 4: the public entry points at full size.  Returns the
    launches of each kernel entry in its run and the walls."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.core.pim_numerics import program_for
    from repro_torch.kernels import ops
    rng = np.random.default_rng(SEED)
    a = rng.standard_normal(MAIN_ROWS).astype(np.float32)
    b = rng.standard_normal(MAIN_ROWS).astype(np.float32)
    want = a + b
    launches, walls = {}, {}
    for kw, key in (
            ({}, "slot_scan_fused"),
            ({"schedule": "dense"}, "level_gather_fused"),
            ({"schedule": "slots-static"}, "slots_static_fused"),
            ({"layout": "rows64"}, "slot_scan_fused_rows64"),
            ({"schedule": "dense", "layout": "rows64"},
             "level_gather_fused_rows64"),
            ({"schedule": "slots-static", "layout": "rows64"},
             "slots_static_fused_rows64")):
        # levelize and build outside the timing
        pim.prepare("fp_add", a[:1], b[:1], **kw).warm()
        label = f"fp_add fp32 rows={MAIN_ROWS} {kw or 'default'}"
        launches[key], walls[label] = _main_run(
            label, key, lambda: pim.fp_add(a, b, **kw), want)

    x = rng.integers(0, 1 << 32, IO_ROWS, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 1 << 32, IO_ROWS, dtype=np.uint64).astype(np.uint32)
    want = x.astype(np.uint64) + y
    for kw, key in (
            ({}, "slot_scan_io"),
            ({"schedule": "dense"}, "level_gather_io"),
            ({"layout": "rows64"}, "slot_scan_io_rows64"),
            ({"schedule": "dense", "layout": "rows64"},
             "level_gather_io_rows64")):
        pim.prepare("add", x[:1], y[:1], **kw).warm()
        label = f"add uint32 (io branch) rows={IO_ROWS} {kw or 'default'}"
        launches[key], walls[label] = _main_run(
            label, key, lambda: pim.add(x, y, **kw), want)

    prog = program_for("fp-serial", "add", "fp32")
    a32, b32 = a[:SERIAL_ROWS], b[:SERIAL_ROWS]
    ins = {"x": a32.view(np.uint32), "y": b32.view(np.uint32)}

    def serial():
        out = ops.run_program(prog, ins, SERIAL_ROWS, levelized=False)
        return out["z"].astype(np.uint32).view(np.float32)
    ops.run_program(prog, {k: v[:1] for k, v in ins.items()}, 1,
                    levelized=False)
    label = f"run_program fp32 add levelized=False rows={SERIAL_ROWS}"
    launches["gate_serial"], walls[label] = _main_run(
        label, "gate_serial", serial, a32 + b32)
    return {"launches": launches, "walls": walls}


def bound(entry: str, s, n_rows: int, fused, lop_rate: float,
          n_cells: int = 0) -> tuple:
    """Least time for the same work: bytes moved once (inputs read, outputs
    written: 4 B per row and port fused, 4 B per packed cell word io, the
    whole state in and out for the gate-serial entry) over the HBM rate,
    against the live NOR word operations (one LOP3 per 32-bit word) over
    ``lop_rate``.  ``s`` is the schedule (or, for the gate-serial entry,
    the lowered ``ops`` array).  Returns (ms, "bytes" | "operations")."""
    n_words = (n_rows + 31) // 32
    if entry == "gate_serial":
        nbytes = 2 * 4 * n_cells * n_words
        ops = int((s >= 2).sum()) * n_words
    else:
        if fused:
            nbytes = 4 * n_rows * (len(s.in_widths) + len(s.out_widths))
        else:
            nbytes = 4 * n_words * (sum(s.in_widths) + s.k_out)
        ops = (s.sched.n_gates + s.sched.copy_gates) * n_words
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / lop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: Shared-memory sizes (KB) an H100 SM can split off its 256 KB of L1 and
#: shared memory (the carveout); the rest is L1.
CARVEOUTS_KB = (0, 8, 16, 32, 64, 100, 132, 164, 196, 228)

#: entry -> the kernel (template instance by planes and fused) the launch
#: attributes are read from: the window body of the main path's streams
#: (8 gates for the dense levels, 2 for the gate-serial stream).
INFO_KERNELS = {
    "slot_scan": "slot_scan_kernel<{p}, {f}>",
    "level_gather": "level_gather_kernel<8, {p}, {f}>",
    "gate_serial": "gate_serial_kernel<2>",
}
#: The same in the parent's sources (``--probe DIR``), before the ring.
PARENT_KERNELS = dict(INFO_KERNELS,
                      level_gather="level_gather_kernel<{p}, {f}>",
                      gate_serial="gate_serial_kernel")

_INFO_SOURCE = """\
// Launch attributes of the kernels of one source, for chip_smoke.py.
#include "{source}"

extern "C" int kernel_info(int planes, int fused, int threads, int smem,
                           int* out) {{
  const void* fn = nullptr;
{select}
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes a{{}};
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, fn);
  if (err == cudaSuccess) {{
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(out, fn, threads,
                                                        smem);
  }}
  out[1] = a.numRegs;
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = a.preferredShmemCarveout;
  return static_cast<int>(err);
}}
"""


class KernelInfo:
    """A library that reads one kernel source's launch attributes
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``, and registers,
    local bytes and preferred carveout from ``cudaFuncGetAttributes``): a
    generated file that includes the source, built by ``pim_exec.build``
    like B2.  ``source`` defaults to the port's own file for ``entry``,
    ``kernel`` to its entry in :data:`INFO_KERNELS`."""

    def __init__(self, entry: str, source=None, kernel=None):
        from repro_torch.kernels import pim_exec
        source = Path(source or pim_exec.SOURCES[entry]).resolve()
        kernel = kernel or INFO_KERNELS[entry]
        if "{p}" in kernel:
            select = "".join(
                f"  if (planes == {p} && fused == {int(f)}) fn = "
                f"reinterpret_cast<const void*>(&"
                f"{kernel.format(p=p, f=str(f).lower())});\n"
                for p in (1, 2) for f in (True, False))
        else:
            select = (f"  fn = reinterpret_cast<const void*>(&{kernel});"
                      "\n")
        self.source = _INFO_SOURCE.format(source=source.as_posix(),
                                          select=select)
        deps = self.source.encode() + source.read_bytes() + b"".join(
            h.read_bytes() for h in sorted(source.parent.glob("*.cuh")))
        key = pim_exec._build_key(deps)
        self.cu = pim_exec.BUILD_DIR / f"info_{entry}-{key}.cu"
        self.so = pim_exec.BUILD_DIR / f"info_{entry}-{key}.so"

    @property
    def built(self) -> bool:
        return self.so.exists()

    def __call__(self, planes: int, fused: bool, threads: int, smem: int
                 ) -> dict:
        import ctypes
        from repro_torch.kernels import pim_exec
        out = (ctypes.c_int * 4)()
        err = pim_exec._load(self.so).kernel_info(planes, int(fused),
                                                  threads, smem, out)
        if err:
            raise RuntimeError(f"kernel_info failed: CUDA error {err}")
        per_sm = out[0] * (smem + 1024)       # 1 KB a CTA for the system
        carve = next((c for c in CARVEOUTS_KB if c * 1024 >= per_sm), 228)
        return {"ctas_per_sm": out[0], "threads": threads, "smem": smem,
                "registers": out[1], "local_bytes": out[2],
                "carveout_pref": out[3], "l1_kb": 256 - carve}


#: entry -> KernelInfo, built in phase 1 beside the kernels.
INFO: dict = {}


def threads_for(entry: str, wpc: int) -> int:
    """Threads of ``entry``'s CTA of ``wpc`` columns: whole warps, the ring
    kernels' columns spread over ``pim_exec.RING_WARPS``."""
    from repro_torch.kernels import pim_exec
    if entry == "slot_scan":
        return (wpc + 31) // 32 * 32
    return -(-wpc // pim_exec.ring_lanes(wpc)) * 32


def launch_attrs(entry: str, planes: int, fused, wpc: int, smem: int
                 ) -> str:
    """``entry``'s launch attributes at this CTA shape, as printed."""
    a = INFO[entry](planes, bool(fused), threads_for(entry, wpc), smem)
    return (f"; launch: {a['threads']} threads, {a['smem']} B shared, "
            f"{a['ctas_per_sm']} CTAs/SM, {a['registers']} registers, "
            f"{a['local_bytes']} local B, carveout preference "
            f"{a['carveout_pref']}, L1 left ~{a['l1_kb']} KB")


def ring_smem(n_cells: int, wpc: int, planes: int) -> int:
    """Dynamic shared memory of a ring kernel's CTA (ring.cuh)."""
    from repro_torch.kernels import pim_exec
    return (4 * planes * n_cells * wpc + 15) // 16 * 16 + \
        2 * 8 * pim_exec.TILE_RECORDS + 16


#: Phase 5: (entry, program, fused, planes) timed at one chunk.
TIMED = [
    ("slot_scan", "fp32 add", True, 1),
    ("slot_scan", "uint32 add", False, 1),
    ("level_gather", "fp32 add", True, 1),
    ("level_gather", "uint32 add", False, 1),
    ("slots_static", "fp32 add", True, 1),
    ("slot_scan", "fp32 add", True, 2),
    ("slot_scan", "uint32 add", False, 2),
    ("level_gather", "fp32 add", True, 2),
    ("level_gather", "uint32 add", False, 2),
    ("slots_static", "fp32 add", True, 2),
    ("gate_serial", "fp32 add", None, 1),
]


def measure(progs, statics, chunk_rows: int, launches: dict, worst: dict,
            gpu: str) -> list:
    """Phase 5: device times at the main path's shape (one chunk)."""
    from repro_torch.kernels import pim_exec, ref as kref
    rng = np.random.default_rng(SEED)
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    smem_bytes_per_s = N_SMS * 128 * sm_clock_hz
    lop_rate = N_SMS * LOPS_PER_SM_CLOCK * sm_clock_hz
    n = chunk_rows
    n_words = (n + 31) // 32
    rows = []
    for entry, name, fused, planes in TIMED:
        key = entry_key(entry, fused, planes)
        prog = progs[name]
        if entry == "gate_serial":
            # the packed stream is made here, outside the timed launches
            state, gates, packed = gate_serial_case(prog, n, rng)
            ms = cuda_ms(lambda: pim_exec.gate_serial(state, *gates,
                                                      packed=packed), 50)
            plain_ms = cuda_ms(
                lambda: kref.pim_exec_ref(state.clone(), *gates), 1)
            n_cells = state.shape[0]
            ops_ = prog.to_arrays()[0]
            bound_ms, bound_by = bound(entry, ops_, n, None, lop_rate,
                                       n_cells)
            smem = 12 * len(ops_) * n_words
            wpc = pim_exec.ring_words_per_cta(n_cells +
                                              pim_exec.GATE_CONSTANTS)
            shape = (f"gates={len(ops_)} windows={packed.n_windows} "
                     f"cells={n_cells} words_per_cta={wpc}")
            attrs = launch_attrs(
                entry, 1, False, wpc,
                ring_smem(n_cells + pim_exec.GATE_CONSTANTS, wpc, 1))
        else:
            kind = "dense" if entry == "level_gather" else "slots"
            c = operands(prog, kind, planes)
            static = statics[(name, planes)] if entry == "slots_static" \
                else None
            x = random_inputs(c, n, fused, rng)
            ms = cuda_ms(lambda: run_entry(c, x, fused, True, static), 50)
            plain_ms = cuda_ms(lambda: run_entry(c, x, fused, False, static),
                               1)
            bound_ms, bound_by = bound(entry, c, n, fused, lop_rate)
            s = c.sched
            lanes = int(s.level_width.sum()) if entry == "slots_static" \
                else s.n_levels * s.width
            smem = 12 * lanes * n_words
            shape = (f"levels={s.n_levels} width={s.width} lanes={lanes} "
                     f"cells={s.n_cells} words_per_cta={c.wpc}")
            if entry == "slots_static":
                attrs = ""
            elif entry == "level_gather":
                attrs = launch_attrs(entry, planes, fused, c.wpc,
                                     ring_smem(s.n_cells, c.wpc, planes))
            else:
                attrs = launch_attrs(entry, planes, fused, c.wpc,
                                     4 * planes * s.n_cells * c.wpc)
        if fused is False:
            xa = torch.randint(0, 1 << 32, (n,), device="cuda")
            xb = torch.randint(0, 1 << 32, (n,), device="cuda")
            lib_ms = cuda_ms(lambda: xa + xb, 100)
        else:
            fa = torch.randn(n, device="cuda")
            fb = torch.randn(n, device="cuda")
            lib_ms = cuda_ms(lambda: fa + fb, 100)
        smem_ms = smem / smem_bytes_per_s * 1e3
        print(f"time {key}: {gpu}; {name} rows={n} {shape}; kernel "
              f"{ms:.6f} ms/launch, {launches[key]} launches on the main "
              f"path; plain {plain_ms:.6f} ms; library {lib_ms:.6f} ms; "
              f"bound {bound_ms:.6f} ms ({bound_by}); shared-memory floor "
              f"{smem_ms:.6f} ms at {sm_clock_hz / 1e6:.0f} MHz; logic-op "
              f"rate {lop_rate:.6e}/s{attrs}", flush=True)
        replaces, source = ENTRIES[entry]
        rows.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[key],
            "max_abs_err": worst[key], "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    return rows


def sweep(gpu: str) -> None:
    """Tunables of the cuda Backend: kernel time per words per CTA on four
    programs of different state sizes at one chunk, then end-to-end fp_add
    wall time per chunk size, then where the main path's time goes."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.core.pim_numerics import program_for
    rng = np.random.default_rng(SEED)
    n = 1 << 22
    for label, prog, fused in (
            ("fp16 add", program_for("fp-serial", "add", "fp16"), True),
            ("fp32 add", program_for("fp-serial", "add", "fp32"), True),
            ("fp32 mul", program_for("fp-serial", "mul", "fp32"), True),
            ("uint32 add io", program_for("int-serial", "add", 32), False)):
        c = operands(prog)
        x = random_inputs(c, n, fused, rng)
        for wpc in (4, 8, 16, 32, 64, 128):
            r = resolved(prog, words_per_cta=wpc)
            c.wpc = r.words_per_cta
            ms = cuda_ms(lambda: run_entry(c, x, fused, True), 5)
            print(f"sweep words_per_cta={wpc} (fit {r.words_per_cta}): "
                  f"{gpu}; {label} cells={r.sched.n_cells} kernel "
                  f"{ms:.6f} ms for {n} rows = {n / ms * 1e3:.6e} rows/s",
                  flush=True)
    ring_sweep(gpu)
    chunks = (1 << 18, 1 << 20, 1 << 22, 1 << 24)
    c = operands(program_for("fp-serial", "add", "fp32"))
    x = random_inputs(c, chunks[-1], True, rng)
    for chunk in chunks:
        ms = cuda_ms(lambda: run_entry(c, x[:, :chunk].contiguous(), True,
                                       True), 5)
        print(f"sweep kernel rows={chunk} (words_per_cta "
              f"{c.wpc}): {gpu}; fp32 add kernel {ms:.6f} ms = "
              f"{chunk / ms * 1e3:.6e} rows/s", flush=True)
    a = rng.standard_normal(MAIN_ROWS).astype(np.float32)
    b = rng.standard_normal(MAIN_ROWS).astype(np.float32)
    preps = {c: pim.prepare("fp_add", a, b, chunk_rows=c)
             for c in chunks + (MAIN_ROWS,)}
    for rep in range(3):             # the run phase only, in turns
        for c, prep in preps.items():
            t0 = time.perf_counter()
            prep.run()
            s = time.perf_counter() - t0
            print(f"sweep chunk_rows={c} run {rep}: {gpu}; fp_add fp32 "
                  f"{MAIN_ROWS} rows run {s * 1e3:.3f} ms = "
                  f"{MAIN_ROWS / s:.6e} rows/s", flush=True)
    profile_main(a, b, gpu)


def ring_widths(n_cells: int, planes: int) -> list:
    """CTA widths the ring kernels are swept over: 16 (the slot scan's),
    whole warps up to what fits one CTA beside the ring, and that fill
    (the rule, at most 128)."""
    from repro_torch.kernels import pim_exec
    fill = pim_exec.ring_words_per_cta(n_cells, planes)
    return sorted({16, fill} | set(range(32, fill + 1, 32)))


def ring_sweep(gpu: str) -> None:
    """B3 and B4 per words per CTA at the main path's chunk (1 Mi rows) and
    at 4 Mi rows: the sweep behind ``pim_exec.ring_words_per_cta``."""
    from repro_torch.core.pim_numerics import program_for
    from repro_torch.kernels import pim_exec
    rng = np.random.default_rng(SEED)
    for n in (1 << 20, 1 << 22):
        for label, prog, fused, planes in (
                ("fp32 add", program_for("fp-serial", "add", "fp32"), True,
                 1),
                ("fp32 add", program_for("fp-serial", "add", "fp32"), True,
                 2),
                ("fp32 mul", program_for("fp-serial", "mul", "fp32"), True,
                 1),
                ("uint32 add io", program_for("int-serial", "add", 32),
                 False, 1)):
            c = operands(prog, "dense", planes)
            rule = c.wpc
            x = random_inputs(c, n, fused, rng)
            for wpc in ring_widths(c.sched.n_cells, planes):
                c.wpc = wpc
                ms = cuda_ms(lambda: run_entry(c, x, fused, True), 20)
                print(f"sweep level_gather words_per_cta={wpc} (rule {rule})"
                      f": {gpu}; {label} planes={planes} cells="
                      f"{c.sched.n_cells} rows={n} kernel {ms:.6f} ms",
                      flush=True)
        for label in ("fp32 add", "fp32 mul"):
            prog = program_for("fp-serial", label.split()[1], "fp32")
            state, gates, packed = gate_serial_case(prog, n, rng)
            n_cells = state.shape[0]
            cells = n_cells + pim_exec.GATE_CONSTANTS
            for wpc in ring_widths(cells, 1):
                ms = cuda_ms(lambda: pim_exec.gate_serial(
                    state, *gates, packed=packed, words_per_cta=wpc), 20)
                print(f"sweep gate_serial words_per_cta={wpc} (rule "
                      f"{pim_exec.ring_words_per_cta(cells)}): {gpu}; "
                      f"{label} cells={n_cells} rows={n} kernel {ms:.6f} ms",
                      flush=True)


def probe(progs, gpu: str, parent) -> None:
    """What holds the ring kernels back.  The launch attributes of the
    slot scan (B1), the level gather (B3) and the gate-serial kernel (B4)
    of this tree and, when ``parent`` names the parent's ``csrc``
    directory, of the parent's, at the shapes each launches for fp32 add;
    then each ring kernel at fp32 add and 1 Mi rows at the rule's CTA
    width: B3 under rows32 and rows64, B4 at windows of 1, 2, 4 and 8
    gates, each with its columns
    spread over ``pim_exec.RING_WARPS`` warps and over eight, in turns,
    bit-exact against the plain version; and each kernel with no gates
    (the bridges or the state's trip alone)."""
    from repro_torch.kernels import pim_exec, ref as kref
    prog = progs["fp32 add"]
    slot = operands(prog, "slots", 1)
    dense = operands(prog, "dense", 1)
    ops_, a, b, o, n_serial = prog.to_arrays()
    infos = {("this tree", e): INFO[e] for e in INFO_KERNELS}
    if parent:
        parents = {e: KernelInfo(e, Path(parent) / f"{e}.cu", k)
                   for e, k in PARENT_KERNELS.items()}
        pim_exec.build([], static=list(parents.values()))
        infos.update({("parent", e): k for e, k in parents.items()})
    for (tree, e), info in infos.items():
        if e == "slot_scan":
            wpc, smem = slot.wpc, 4 * slot.sched.n_cells * slot.wpc
        elif tree == "parent":
            cells = dense.sched.n_cells if e == "level_gather" else n_serial
            wpc, smem = 16, 4 * cells * 16
        elif e == "level_gather":
            wpc = dense.wpc
            smem = ring_smem(dense.sched.n_cells, wpc, 1)
        else:
            cells = n_serial + pim_exec.GATE_CONSTANTS
            wpc = pim_exec.ring_words_per_cta(cells)
            smem = ring_smem(cells, wpc, 1)
        threads = (wpc + 31) // 32 * 32 if tree == "parent" \
            else threads_for(e, wpc)
        a_ = info(1, e != "gate_serial", threads, smem)
        print(f"probe attrs {tree} {e} fp32 add: {gpu}; words_per_cta={wpc} "
              f"{a_}", flush=True)

    rng = np.random.default_rng(SEED)
    n = 1 << 20
    x = random_inputs(dense, n, True, rng)
    want = run_entry(dense, x, True, False)
    # the rule's columns spread over eight warps, two a scheduler
    with_warps = {"B3, 8 warps": 8, "B3 rows64, 8 warps": 8,
                  "B4 windows of 2, 8 warps": 8}
    dense64 = operands(prog, "dense", 2)
    x64 = random_inputs(dense64, n, True, rng)
    want64 = run_entry(dense64, x64, True, False)
    variants = {
        "B3": (dense.packed, dense.wpc),
        "B3, 8 warps": (dense.packed, dense.wpc),
        "B3 rows64": (dense64.packed, dense64.wpc),
        "B3 rows64, 8 warps": (dense64.packed, dense64.wpc)}
    state, gates, windows = gate_serial_case(prog, n, rng)
    by_width = {w: pim_exec.pack_gates(ops_, a, b, o, n_cells=n_serial,
                                       window=w).to("cuda")
                for w in (1, 2, 4, 8)}
    serial_want = kref.pim_exec_ref(state.clone(), *gates)
    rule = pim_exec.ring_words_per_cta(n_serial + pim_exec.GATE_CONSTANTS)
    variants.update({f"B4 windows of {w}": (by_width[w], rule)
                     for w in by_width})
    variants["B4 windows of 2, 8 warps"] = (by_width[2], rule)
    # no gates at all: what the bridges (B3) or the state's trip through
    # device memory (B4) cost alone; these give no result to check
    none = np.zeros(0, np.int64)
    empty = pim_exec.pack_gates(none, none, none, none,
                                n_cells=1).to("cuda")
    variants.update({"B3 no gates": (empty, dense.wpc),
                     "B4 no gates": (empty, rule)})

    def launch(label):
        packed, wpc = variants[label]
        warps = pim_exec.RING_WARPS
        pim_exec.RING_WARPS = with_warps.get(label, warps)
        try:
            if label.startswith("B3"):
                c = SimpleNamespace(**vars(dense64 if "rows64" in label
                                         else dense))
                c.packed, c.wpc = packed, wpc
                return run_entry(c, x64 if "rows64" in label else x, True,
                                 True)
            stream = [g[:packed.n_gates] for g in gates]
            return pim_exec.gate_serial(state, *stream, packed=packed,
                                        words_per_cta=wpc)
        finally:
            pim_exec.RING_WARPS = warps

    for label in variants:
        if "no gates" in label:
            continue
        got = launch(label)
        torch.cuda.synchronize()
        want_ = serial_want if label.startswith("B4") else \
            want64 if "rows64" in label else want
        if not torch.equal(got, want_):
            raise AssertionError(f"probe {label} != plain version")
    for rep in range(2):                           # in turns
        for label, (packed, wpc) in variants.items():
            ms = cuda_ms(lambda: launch(label), 50)
            print(f"probe time {label} run {rep}: {gpu}; rows={n} "
                  f"records={packed.n_gates} windows={packed.n_windows} "
                  f"words_per_cta={wpc} warps="
                  f"{with_warps.get(label, pim_exec.RING_WARPS)} kernel "
                  f"{ms:.6f} ms/launch"
                  f"{'' if 'no gates' in label else ', bit-exact vs plain'}",
                  flush=True)


def profile_main(a, b, gpu: str) -> None:
    """Where the main path's time goes: host validation (``prepare``)
    against execution (``run``), and the device's busy time by kernel
    from ``torch.profiler`` over the same call."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch import pim_ufunc as pim
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prep = pim.prepare("fp_add", a, b)
        t1 = time.perf_counter()
        prep.run()
        t2 = time.perf_counter()
    # device-side activities only (kernels, copies): the CPU ops that
    # launched them carry the same device time again
    dev = {e.key: e.self_device_time_total / 1e3
           for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.self_device_time_total > 0}
    wall = (t2 - t0) * 1e3
    print(f"profile fp_add fp32 {len(a)} rows: {gpu}; wall {wall:.3f} ms "
          f"(prepare {(t1 - t0) * 1e3:.3f} ms, run {(t2 - t1) * 1e3:.3f} "
          f"ms, under the profiler)", flush=True)
    if not dev:
        print("profile: the profiler shows no device time (not measured)",
              flush=True)
        return
    busy = sum(dev.values())
    print(f"profile: device busy {busy:.3f} ms = {busy / wall:.6f} of the "
          f"wall, idle {1 - busy / wall:.6f}", flush=True)
    for name, ms in sorted(dev.items(), key=lambda kv: -kv[1])[:6]:
        print(f"profile device: {ms:.3f} ms {name[:90]}", flush=True)


def split_probe(progs, gpu: str) -> None:
    """B2 as it is built (the schedule in one device function) against B2
    split into ``__noinline__`` functions of ``SLOT_SEG_LEVELS`` levels, on
    fp32 add, fp32 div and bit-parallel fp32 div (the largest program B2
    takes): each build's seconds and ``ptxas`` report (all six started
    together), then each kernel at 1 Mi rows, held bit-exact against the
    other and the plain version."""
    from repro_torch.core.pim_numerics import program_for
    from repro_torch.kernels import pim_exec, plan as kplan
    rng = np.random.default_rng(SEED)
    progs = dict(progs, **{
        "fp32 div parallel": program_for("fp-parallel", "div", "fp32")})
    names = ("fp32 add", "fp32 div", "fp32 div parallel")
    kernels = {}
    # a directory of its own, so that every probe kernel is a fresh build
    pim_exec.BUILD_DIR = pim_exec.BUILD_DIR / "split-probe"
    shutil.rmtree(pim_exec.BUILD_DIR, ignore_errors=True)
    for name in names:
        c = operands(progs[name], "slots", 1)
        for label, split in (("split", kplan.SLOT_SEG_LEVELS),
                             ("whole", None)):
            kernels[(name, label)] = (c, pim_exec.StaticKernel(
                c.sched, c.in_widths, c.out_widths, c.out_names, c.in_cells,
                words_per_cta=kplan.WORDS_PER_CTA, split=split))
    logs = pim_exec.build([], static=[k for _, k in kernels.values()])
    for (name, label), (c, k) in kernels.items():
        log, secs = logs[k.so.name]
        print(f"split-probe build {name} {label}: levels={c.sched.n_levels} "
              f"lanes={int(c.sched.level_width.sum())} {secs:.1f} s",
              flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"split-probe ptxas {name} {label}: {line.strip()}",
                      flush=True)
    n = 1 << 20
    for name in names:
        c, split = kernels[(name, "split")]
        whole = kernels[(name, "whole")][1]
        x = random_inputs(c, n, True, rng)
        want = split.plain(x)
        for label, k in (("split", split), ("whole", whole)):
            if not torch.equal(k(x), want):
                raise AssertionError(f"split probe: {name} {label} != plain")
        for rep in range(3):                    # in turns
            for label, k in (("split", split), ("whole", whole)):
                ms = cuda_ms(lambda: k(x), 50)
                print(f"split-probe time {name} {label} run {rep}: {gpu}; "
                      f"rows={n} kernel {ms:.6f} ms/launch, bit-exact vs "
                      "plain", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep words_per_cta and chunk_rows and "
                    "profile the main path")
    ap.add_argument("--split-probe", action="store_true",
                    help="also build B2 whole and split on three programs "
                    "and compare build seconds, ptxas reports and times")
    ap.add_argument("--probe", nargs="?", const="", default=None,
                    metavar="PARENT_CSRC",
                    help="also print the launch attributes of B1, B3 and B4 "
                    "(and of the kernels in PARENT_CSRC) and time the ring "
                    "kernels' variants")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")

    from repro_torch.kernels import pim_exec, plan as kplan
    progs = programs()
    statics = static_kernels(progs)
    INFO.update({e: KernelInfo(e) for e in INFO_KERNELS})
    t0 = time.perf_counter()
    logs = pim_exec.build(static=list(statics.values()) +
                          list(INFO.values()))
    print(f"build: {len(logs)} sources in {time.perf_counter() - t0:.1f} s",
          flush=True)
    names = {k.so.name: f"{prog} planes={planes}"
             for (prog, planes), k in statics.items()}
    names.update({k.so.name: f"launch attributes of {e}"
                  for e, k in INFO.items()})
    for name, (log, secs) in logs.items():
        print(f"build {name} ({names.get(name, 'fixed source')}): "
              f"{secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    gpu = smi("name,power.limit")
    print(gpu, flush=True)
    chunk_rows = kplan.DEFAULT_CHUNK_ROWS

    worst = check_kernels(progs, statics)
    main = main_path()
    kernels = measure(progs, statics, chunk_rows, main["launches"], worst,
                      gpu)
    if args.probe is not None:
        probe(progs, gpu, args.probe)
    if args.sweep:
        sweep(gpu)
    if args.split_probe:
        split_probe(progs, gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
