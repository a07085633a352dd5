"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # full size: 64 Mi rows
    python3 chip_smoke.py --sweep          # also sweep the cuda Backend tunables
                                           # and profile the main path
    python3 chip_smoke.py --split-probe    # also build B2 whole and split
                                           # and compare them

Phases, each of which raises (exit code 1) on failure:

1. build every CUDA kernel of the port: the fixed sources in
   ``src/repro_torch/csrc`` and the generated static-slice kernels (B2) of
   the programs below, one ``nvcc`` each, all started together;
2. print the card's name and power limit;
3. hold every kernel entry against its plain PyTorch version on the card,
   bit-exactly (``torch.equal``): the slot scan (B1), the level gather
   (B3), the static-slice kernels (B2) and the gate-serial kernel (B4),
   under rows32 and rows64;
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
   bound.

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
    operand its kernel entries take, on the card -- built directly, not
    through ``resolve``, so that each entry runs the schedule it is named
    for whatever the dispatcher would pick."""
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
        wpc=pim_exec.fit_words_per_cta(s.n_cells, kplan.WORDS_PER_CTA,
                                       planes))


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
        "gate-free": gate_free_program(),
        "no-input": no_input_program(),
    }


#: Phase 3: (entry, program, fused, rows, planes): the slot scan, the
#: level gather, the static kernels, the gate-serial kernel, then rows64.
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
    """A random whole state and the lowered stream of ``program``, on the
    card, for the gate-serial entry."""
    ops_, a, b, o, n_cells = program.to_arrays()
    state = rng.integers(0, 1 << 32, (n_cells, (n_rows + 31) // 32),
                         dtype=np.uint64).astype(np.uint32)
    dev = [torch.from_numpy(np.ascontiguousarray(v, np.int32)).cuda()
           for v in (ops_, a, b, o)]
    return torch.from_numpy(state.view(np.int32)).cuda(), dev


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
            state, gates = gate_serial_case(prog, rows, rng)
            got = pim_exec.gate_serial(state, *gates)
            torch.cuda.synchronize()
            want = kref.pim_exec_ref(state.clone(), *gates)
            info = f"gates={gates[0].numel()} cells={state.shape[0]}"
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
            state, gates = gate_serial_case(prog, n, rng)
            ms = cuda_ms(lambda: pim_exec.gate_serial(state, *gates), 50)
            plain_ms = cuda_ms(
                lambda: kref.pim_exec_ref(state.clone(), *gates), 1)
            n_cells = state.shape[0]
            ops_ = prog.to_arrays()[0]
            bound_ms, bound_by = bound(entry, ops_, n, None, lop_rate,
                                       n_cells)
            smem = 12 * len(ops_) * n_words
            shape = (f"gates={len(ops_)} cells={n_cells} words_per_cta="
                     f"{pim_exec.fit_words_per_cta(n_cells, 16)}")
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
            shape = (f"levels={s.n_levels} width={s.width} cells="
                     f"{s.n_cells} words_per_cta={c.wpc}")
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
              f"rate {lop_rate:.6e}/s", flush=True)
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
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")

    from repro_torch.kernels import pim_exec, plan as kplan
    progs = programs()
    statics = static_kernels(progs)
    t0 = time.perf_counter()
    logs = pim_exec.build(static=list(statics.values()))
    print(f"build: {len(logs)} sources in {time.perf_counter() - t0:.1f} s",
          flush=True)
    names = {k.so.name: f"{prog} planes={planes}"
             for (prog, planes), k in statics.items()}
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
