"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # full size: 64 Mi rows
    python3 chip_smoke.py --sweep          # also sweep the cuda Backend tunables
                                           # and profile the main path

Phases, each of which raises (exit code 1) on failure:

1. build every CUDA kernel of the port from ``src/repro_torch/csrc``;
2. print the card's name and power limit;
3. hold each kernel against its plain PyTorch version on the card,
   bit-exactly (``torch.equal``), on the programs listed in ``CASES``;
4. drive the main path through the public entry points:
   ``pim_ufunc.fp_add`` on float32 at 64 Mi rows (the paper's 8 GB of
   1024x1024 crossbars) against numpy's ``a + b``, and ``pim_ufunc.add`` on
   uint32 at 4 Mi rows (the io branch) against numpy; the launch counters
   must show the kernels ran and the plain versions did not;
5. time each kernel at the main path's shapes beside its plain version,
   one PyTorch library call computing the same function, and its bound.

The line before the last is a JSON object with one record per kernel; the
last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

# H100 SXM data-sheet peaks (NVIDIA, dense, 700 W): device memory
# bandwidth, and float32 outside the tensor cores -- the fastest 32-bit
# lane rate the card has, used for the 32-bit NOR word operations.
HBM_BYTES_PER_S = 3.35e12
LANE_OPS_PER_S = 67e12
SEED = 0
#: Rows of the main path: the paper's 8 GB of 1024x1024 crossbars.
MAIN_ROWS = 64 << 20


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls (after one warm-up),
    from CUDA events."""
    fn()
    torch.cuda.synchronize()
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


def random_inputs(r, n_rows: int, fused: bool, rng) -> torch.Tensor:
    """Random bits for every input cell: per-row values masked to each
    port's width (fused) or packed port rows (io), on the card."""
    if fused:
        vals = rng.integers(0, 1 << 32, (len(r.in_widths), n_rows),
                            dtype=np.uint64)
        vals &= np.array([(1 << w) - 1 for w in r.in_widths],
                         np.uint64)[:, None]
        a = vals.astype(np.uint32)
    else:
        k_in = sum(r.in_widths)
        a = rng.integers(0, 1 << 32, (k_in, (n_rows + 31) // 32),
                         dtype=np.uint64).astype(np.uint32)
    return torch.from_numpy(a.view(np.int32)).cuda()


def run_entry(r, x, fused: bool, impl):
    kw = dict(n_cells=r.sched.n_cells, one_cell=r.one_cell,
              in_base=r.in_base, out_base=r.out_base,
              words_per_cta=r.words_per_cta)
    args = (x, r.in_idx, r.la, r.lb, r.lo, r.out_idx)
    if fused:
        return impl.slots_fused(*args, in_widths=r.in_widths,
                                out_widths=r.out_widths, **kw)
    return impl.slots_io(*args, k_out=r.k_out, **kw)


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


def check_kernels(chunk_rows: int) -> float:
    """Phase 3: every kernel entry against its plain version on the card,
    bit-exact.  Returns the largest absolute difference seen (0)."""
    from repro_torch.core.pim_numerics import program_for
    from repro_torch.kernels import pim_exec, slots as kslots
    rng = np.random.default_rng(SEED)
    cases = [  # (label, program, fused entry, rows)
        ("fp16 add", program_for("fp-serial", "add", "fp16"), True, 1 << 20),
        ("fp32 add", program_for("fp-serial", "add", "fp32"), True,
         chunk_rows),
        ("fp32 add ragged", program_for("fp-serial", "add", "fp32"), True,
         (1 << 20) + 3),
        ("fp32 add 16 Mi", program_for("fp-serial", "add", "fp32"), True,
         1 << 24),
        ("fp32 mul", program_for("fp-serial", "mul", "fp32"), True, 1 << 20),
        ("fp32 div", program_for("fp-serial", "div", "fp32"), True, 1 << 20),
        ("uint16 add", program_for("int-serial", "add", 16), True, 1 << 20),
        ("int-parallel mul16 (no one_cell)",
         program_for("int-parallel", "mul", 16), True, 1 << 20),
        ("uint32 add io", program_for("int-serial", "add", 32), False,
         chunk_rows),
        ("uint32 mul io", program_for("int-serial", "mul", 32), False,
         1 << 20),
        ("uint32 add io ragged", program_for("int-serial", "add", 32), False,
         (1 << 20) + 77),
        ("gate-free fused", gate_free_program(), True, 1000),
        ("gate-free io", gate_free_program(), False, 1000),
        ("no-input io", no_input_program(), False, 1000),
    ]
    worst = 0
    for label, prog, fused, rows in cases:
        r = resolved(prog)
        x = random_inputs(r, rows, fused, rng)
        got = run_entry(r, x, fused, pim_exec)
        torch.cuda.synchronize()
        want = run_entry(r, x, fused, kslots)
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        worst = max(worst, err)
        print(f"check {label}: rows={rows} levels={r.sched.n_levels} "
              f"cells={r.sched.n_cells} words_per_cta={r.words_per_cta} "
              f"one_cell={r.one_cell} equal={torch.equal(got, want)}",
              flush=True)
        if not torch.equal(got, want):
            raise AssertionError(f"kernel != plain version on {label}")
    return worst


def main_path(io_rows: int) -> dict:
    """Phase 4: the public entry points at full size, with the launch
    counters zeroed just before and read just after each run."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.kernels import pim_exec, slots as kslots
    rng = np.random.default_rng(SEED)
    a = rng.standard_normal(MAIN_ROWS).astype(np.float32)
    b = rng.standard_normal(MAIN_ROWS).astype(np.float32)
    pim.prepare("fp_add", a[:1], b[:1]).warm()  # levelize outside the timing
    pim_exec.reset_counts()
    t0 = time.perf_counter()
    z = pim.fp_add(a, b)
    fp_s = time.perf_counter() - t0
    fused_launches = pim_exec.LAUNCHES["slot_scan_fused"]
    plain_calls = dict(kslots.CALLS)
    if not np.array_equal(z.view(np.uint32), (a + b).view(np.uint32)):
        bad = int(np.sum(z.view(np.uint32) != (a + b).view(np.uint32)))
        raise AssertionError(f"fp_add differs from numpy on {bad} rows")
    if fused_launches < 1 or any(plain_calls.values()):
        raise AssertionError(f"main path did not run the kernel: launches "
                             f"{pim_exec.LAUNCHES}, plain {plain_calls}")
    print(f"main fp_add fp32: rows={MAIN_ROWS} bit-exact vs numpy; "
          f"slot_scan_fused launches={fused_launches} plain calls="
          f"{plain_calls}; wall {fp_s * 1e3:.3f} ms = "
          f"{MAIN_ROWS / fp_s:.6e} rows/s", flush=True)

    x = rng.integers(0, 1 << 32, io_rows, dtype=np.uint64).astype(np.uint32)
    y = rng.integers(0, 1 << 32, io_rows, dtype=np.uint64).astype(np.uint32)
    pim.prepare("add", x[:1], y[:1]).warm()
    pim_exec.reset_counts()
    t0 = time.perf_counter()
    s = pim.add(x, y)
    io_s = time.perf_counter() - t0
    io_launches = pim_exec.LAUNCHES["slot_scan_io"]
    plain_calls = dict(kslots.CALLS)
    if not np.array_equal(s, x.astype(np.uint64) + y):
        raise AssertionError("uint32 add differs from numpy")
    if io_launches < 1 or any(plain_calls.values()):
        raise AssertionError(f"io path did not run the kernel: launches "
                             f"{pim_exec.LAUNCHES}, plain {plain_calls}")
    print(f"main add uint32 (io branch): rows={io_rows} bit-exact vs numpy; "
          f"slot_scan_io launches={io_launches} plain calls={plain_calls}; "
          f"wall {io_s * 1e3:.3f} ms = {io_rows / io_s:.6e} rows/s",
          flush=True)
    return {"slot_scan_fused": fused_launches, "slot_scan_io": io_launches,
            "fp_add_rows_per_s": MAIN_ROWS / fp_s,
            "add_u32_rows_per_s": io_rows / io_s}


def bound(r, n_rows: int, fused: bool) -> tuple:
    """Least time for the same work: bytes moved once (inputs read, outputs
    written; 4 B per row and port fused, 4 B per packed cell word io) over
    the HBM rate, against the live NOR word operations over the 32-bit
    lane rate.  Returns (ms, "bytes" | "operations")."""
    n_words = (n_rows + 31) // 32
    if fused:
        nbytes = 4 * n_rows * (len(r.in_widths) + len(r.out_widths))
    else:
        nbytes = 4 * n_words * (sum(r.in_widths) + r.k_out)
    ops = (r.sched.n_gates + r.sched.copy_gates) * n_words
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / LANE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure(chunk_rows: int, launches: dict, worst: int, gpu: str) -> list:
    """Phase 5: device times at the main path's shape (one chunk)."""
    from repro_torch.core.pim_numerics import program_for
    from repro_torch.kernels import pim_exec, slots as kslots
    rng = np.random.default_rng(SEED)
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    rows = []
    for name, prog, fused, n in (
            ("slot_scan_fused", program_for("fp-serial", "add", "fp32"),
             True, chunk_rows),
            ("slot_scan_io", program_for("int-serial", "add", 32), False,
             chunk_rows)):
        r = resolved(prog)
        if fused:
            a = torch.randn(n, device="cuda")
            b = torch.randn(n, device="cuda")
            x = torch.stack([a.view(torch.int32), b.view(torch.int32)])
            lib_ms = cuda_ms(lambda: a + b, 20)
        else:
            x = random_inputs(r, n, False, rng)
            xa = torch.randint(0, 1 << 32, (n,), device="cuda")
            xb = torch.randint(0, 1 << 32, (n,), device="cuda")
            lib_ms = cuda_ms(lambda: xa + xb, 20)
        ms = cuda_ms(lambda: run_entry(r, x, fused, pim_exec), 10)
        plain_ms = cuda_ms(lambda: run_entry(r, x, fused, kslots), 1)
        bound_ms, bound_by = bound(r, n, fused)
        n_words = (n + 31) // 32
        s = r.sched
        smem_bytes = s.n_levels * s.width * 12 * n_words
        smem_ms = smem_bytes / (132 * 128 * sm_clock_hz) * 1e3
        print(f"time {name}: {gpu}; rows={n} levels={s.n_levels} "
              f"cells={s.n_cells} words_per_cta={r.words_per_cta}; kernel "
              f"{ms:.6f} ms/launch, {launches[name]} launches on the main "
              f"path; plain {plain_ms:.6f} ms; library {lib_ms:.6f} ms; "
              f"bound {bound_ms:.6f} ms ({bound_by}); shared-memory floor "
              f"{smem_ms:.6f} ms at {sm_clock_hz / 1e6:.0f} MHz", flush=True)
        rows.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/csrc/slot_scan.cu",
            "replaces": "src/repro/kernels/pim_exec.py:224",
            "launches": launches[name], "max_abs_err": worst, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms})
    return rows


def sweep(gpu: str) -> None:
    """Tunables of the cuda Backend: kernel time per words per CTA on four
    programs of different state sizes at one chunk, then end-to-end fp_add
    wall time per chunk size, then where the main path's time goes."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.core.pim_numerics import program_for
    from repro_torch.kernels import pim_exec
    rng = np.random.default_rng(SEED)
    n = 1 << 22
    for label, prog, fused in (
            ("fp16 add", program_for("fp-serial", "add", "fp16"), True),
            ("fp32 add", program_for("fp-serial", "add", "fp32"), True),
            ("fp32 mul", program_for("fp-serial", "mul", "fp32"), True),
            ("uint32 add io", program_for("int-serial", "add", 32), False)):
        x = random_inputs(resolved(prog), n, fused, rng)
        for wpc in (4, 8, 16, 32, 64, 128):
            r = resolved(prog, words_per_cta=wpc)
            ms = cuda_ms(lambda: run_entry(r, x, fused, pim_exec), 5)
            print(f"sweep words_per_cta={wpc} (fit {r.words_per_cta}): "
                  f"{gpu}; {label} cells={r.sched.n_cells} kernel "
                  f"{ms:.6f} ms for {n} rows = {n / ms * 1e3:.6e} rows/s",
                  flush=True)
    chunks = (1 << 18, 1 << 20, 1 << 22, 1 << 24)
    prog = program_for("fp-serial", "add", "fp32")
    x = random_inputs(resolved(prog), chunks[-1], True, rng)
    r = resolved(prog)
    for chunk in chunks:
        ms = cuda_ms(lambda: run_entry(r, x[:, :chunk].contiguous(), True,
                                       pim_exec), 5)
        print(f"sweep kernel rows={chunk} (words_per_cta "
              f"{r.words_per_cta}): {gpu}; fp32 add kernel {ms:.6f} ms = "
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


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep words_per_cta and chunk_rows and "
                    "profile the main path")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")

    from repro_torch.kernels import pim_exec, plan as kplan
    t0 = time.perf_counter()
    logs = pim_exec.build()
    print(f"build: {sorted(pim_exec.SOURCES)} in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    gpu = smi("name,power.limit")
    print(gpu, flush=True)
    chunk_rows = kplan.DEFAULT_CHUNK_ROWS
    io_rows = 4 << 20

    worst = check_kernels(chunk_rows)
    counts = main_path(io_rows)
    print(f"main path: {gpu}; fp_add {counts['fp_add_rows_per_s']:.6e} "
          f"rows/s, add uint32 {counts['add_u32_rows_per_s']:.6e} rows/s",
          flush=True)
    kernels = measure(chunk_rows, counts, worst, gpu)
    if args.sweep:
        sweep(gpu)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
