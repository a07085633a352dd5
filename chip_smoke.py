"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py                  # full size: 64 Mi rows
    python3 chip_smoke.py --sweep          # also sweep B1's and B2's CTA
                                           # width and the chunk size
    python3 chip_smoke.py --split-probe    # also build B2 whole and split
                                           # and compare them
    python3 chip_smoke.py --turns DIR      # also run the main path in turns
                                           # with the parent's package whose
                                           # csrc is DIR, profiled
    python3 chip_smoke.py --probe [DIR]    # also print launch attributes and
                                           # time B1, B2 and B3 with no gates
                                           # and B6 on its blocks (and the
                                           # same of the parent's package
                                           # whose csrc is DIR), then B1 io
                                           # rows64 in turns with B6

Phases, each of which raises (exit code 1) on failure:

1. build every CUDA kernel of the port: the fixed sources in
   ``src/repro_torch/csrc``, the generated static-slice kernels (B2) of
   the programs below and the libraries that read the fixed kernels'
   launch attributes, one ``nvcc`` each, all started together;
2. print the card's name and power limit;
3. hold every kernel entry against its plain PyTorch version on the card,
   bit-exactly (``torch.equal``): the slot scan (B1), the level gather
   (B3), the static-slice kernels (B2) and the gate-serial kernel (B4),
   under rows32 and rows64, the ring kernels (B3, B4) on long streams
   and at fewer than 32 words per CTA, the slot scan at slot widths 4 and
   8 and past 8 lanes (slot widths 12, 16, 32 and 64, whose levels take 2
   to 8 windows of at most 8 records each; io at 16; rows64 at 16), the
   level gather at dense caps 16, 32 and 64, and B2 at slot width 16
   under both layouts; and the check fold of verified execution (B6) on fused
   blocks of 1, 31, 32 and 33 ports at 1000, 1 Mi and 16 Mi rows, on
   packed rows32 and rows64 blocks of 1, 33 and 64 cells and odd word
   counts, and on every path of its launcher (:func:`fold_paths`: each
   width mod 4, k = 0, 1 and k about the unrolled 8 rows, widths about
   the 16-byte rule and the copy's grid, blocks that start 4 bytes past
   a 16-byte boundary), also against numpy's XOR reduction of the host
   copy;
4. drive the main path through the public entry points, each run checked
   against numpy with the launch counters zeroed just before and read just
   after -- its kernel must have run and no plain version may have:
   ``pim_ufunc.fp_add`` on float32 at 64 Mi rows (the paper's 8 GB of
   1024x1024 crossbars) under the default slot schedule, ``dense``,
   ``slots-static`` and ``rows64`` (and the last two schedules under
   rows64), and under plans retuned to the widths of :data:`WIDE_MAIN`
   (B1 at slot widths 8, 12, 16 and 32, B3 at dense caps 16 and 32, B2 at
   slot width 16); ``pim_ufunc.add`` on uint32 at 4 Mi rows (the io
   branch) under the slot and dense schedules, rows32 and rows64; and
   ``ops.run_program(..., levelized=False)`` on fp32 add at 4 Mi rows (the
   gate-serial path carries the whole state through the host);
5. the streaming pipeline: the main path's run profiled with
   ``torch.profiler`` (H2D and D2H ms and GB/s through the pinned staging
   buffers, the share of H2D time concurrent with a kernel, the device's
   busy share), a run with 4 Mi-row chunks held against the 1 Mi-row
   default, and the same profile of an fp32 div stream;
6. ``ops.run_program_groups`` over eight mixed groups of 1 Mi rows, each
   held against numpy and against ``ops.run_program`` alone;
7. the main path with ``shards=torch.cuda.device_count()`` and
   ``mesh=("cuda:0", "cuda:0")`` against the unsharded result;
8. the packed reductions: ``pim.gemv`` fp16 4096x4096 and ``pim.dot`` fp32
   at 4 Mi elements against the same adder tree on numpy, and
   ``pim_linear_i8`` 1x4096x4096 against numpy's int64 matmul;
9. ``pim.fuse`` of fp32 ``a*b + c`` at 4 Mi rows under the slot and dense
   schedules against numpy, rounded per op;

   verified: verified execution under injected faults
   (:func:`fault_model`): the main path in turns, plain, ``verify=True``
   and faults with ``VerifyPolicy()``, three rounds, each run bit-exact
   with its health counters, walls and overheads (the check fold B6
   launched once a chunk attempt where both are set, never elsewhere);
   the faults without a policy (the result must differ at the injected
   rows); ``pim.gemv`` fp16 4096x4096 under the faults and a policy
   (the shape of every block it folds recorded, :func:`folded_shapes`),
   and with ``verify=True`` alone (its blocks stay on the card: one D2H
   copy); two shards on one card under the faults;

   serving: batched PIM serving (:func:`serving_phase`): the reference's
   serving mix (uint16 and fp16 add, sub, mul and div, 8 requests each)
   at 1 Mi rows a request (64 Mi rows) through ``BatchRuntime.execute``
   and the per-request serial loop in turns, three rounds, with the
   prepare, coalesce, exec and unpack split and the device's busy share
   (nothing degraded, shed or failed); the same mix at 1024 rows a
   request (8 launches batched, 64 serial); ``serve_pim_batched`` on an
   in-memory JSON-lines stream of 256 requests of 4096 rows with a fused
   expression, a width-70 add (B1 io), ``dense`` (B3), ``slots-static``
   (B2) and ``rows64`` requests and malformed lines, every answer in
   order, its stats and trace spans; the mix under
   ``FaultModel(seed=7, p_flip=5e-4)`` and ``verify=True`` (B6 with
   every B1 launch); and ``python -m repro_torch.launch.serve`` as a
   subprocess (``--pim-serve`` and ``--pim fp_add`` at 16 Mi rows);

   tune: the autotuner's quick ``cuda`` sweep (:func:`tune_phase`) of
   ``add:16`` and ``fp_add:fp16`` at 1 Mi rows, each candidate's wall,
   its spread and its kernels' ms; its tuned.json installed in a fresh
   process through a cache directory, the plans overlaid exactly where
   the winners say, results bit-exact under them;

   warm-start: two ``--pim-serve --pim-cache-dir`` replicas sharing one
   fresh cache directory (:func:`warm_start_phase`), run from a copy of
   ``src/repro_torch`` whose build directory is emptied before each, on
   the serving mix at 1024 rows a request with a ``slots-static`` (B2)
   and a ``dense`` (B3) request: every answer bit-exact; the cold one
   levelizes, packs and runs ``nvcc``, the warm one none of them, with
   disk hits, no disk error, and B1, B2 and B3 launched and no plain
   version; time to the first answer, walls and bytes on disk by tier;

   lm: LM decode serving (:func:`lm_phase`; the LM reaches no TPU
   kernel, and its one kernel is the decode attention,
   ``csrc/decode_attn.cu``): ``qwen3-8b`` at full width (8,190,735,360
   parameters) built on the card from seed 0; ``serve.main`` at the
   reference's defaults (batch 4, prompt 32, gen 16), its tokens checked
   and its steps timed with CUDA events beside their bound, then the same
   loop three more times and the CLI in a fresh process for the spread
   of the median step; the served
   tokens teacher-forced through ``decode_step`` against one ``forward``
   (max |dlogit| under 0.2, the reference's bound), in bf16 and again in
   float32 weights and caches; the reduced model's prefill and 4 decode
   steps on the card against the CPU on one set of weights (0.05);
   batch 32 with a 512-token prompt and 64 generated tokens; a 4 x 1024
   prefill (two 512-query chunks) against ``forward``; a
   ``torch.profiler`` trace of 3 decode steps (busy share, launches a
   step, the top 5 device ops), each layer's attention through the
   decode-attention kernel (``lm.decode_attn.kernel`` one a layer a
   step, ``lm.decode_attn.plain`` none);

   lm families: the other layer families (:func:`lm_families_phase`,
   ROADMAP A14; they reach no TPU kernel, and their full-attention
   decode steps run the decode-attention kernel), one
   model at a time at full width, built on the card from seed 0 with
   the parameter counts of :data:`FAMILIES`: ``recurrentgemma-2b`` and
   ``rwkv6-1.6b`` whole, ``qwen3-moe-235b-a22b`` and
   ``deepseek-v2-236b`` cut to 4 layers and ``llama-3.2-vision-90b`` to
   10 (two groups; its cross gates set to 0.5, the reference's are 0),
   served at the reference's defaults (``serve.main`` for the whole
   models, ``serve.generate`` on the cut ones, with image embeddings for
   the vision model), each step beside its bound, the MoE models'
   dropped and C9-zeroed routing pairs; a ``torch.profiler`` trace of 3
   decode steps; the served tokens through ``decode_step`` against one
   ``forward`` in bf16 and in float32 (0.2; the MoE models at
   capacity_factor 100; the bf16 run of the MoE models and rwkv6
   printed only, :data:`F32_GATED`); the reduced model on the card
   against the CPU (0.05 bf16, 1e-3 for the MoE models in float32); for
   the two recurrent models a prefill of 2560 tokens and 4 decode steps
   against a 3072-token ``forward``, in bf16 and in float32 (0.2, gated
   as decode against forward); for the
   encoder-only ``hubert-xlarge`` the encoder-only refusal of
   ``serve.main``, a timed ``forward`` over frames [4, 1024, 512] and
   prefill's last logits against it (0.05);

   train: LM training (:func:`train_phase`, ROADMAP A15; no kernel of
   its own, it reaches no TPU kernel): ``qwen3-8b`` at full width cut to
   :data:`TRAIN_LAYERS` layers (the most whose state and activations fit
   under 0.9 of the card), weights from seed 0 on the card, 10 steps of
   ``make_train_step`` through ``train_loop`` at the reference CLI's
   defaults (batch 8, seq 256, accum 1, lr 3e-4) on ``DataIterator``'s
   batches: each step's CUDA-event ms, loss, grad norm and lr, tokens/s,
   the peak memory and the step's operations and bytes bounds (gates:
   finite, the last loss below the first, the peak under 0.9 of the
   card); ``save_async`` of the weights (the host copy and the write);
   2 steps at accum 4 in the scan and the fused form; one
   ``adamw.update`` alone beside its bytes bound; a ``torch.profiler``
   trace of 2 steps; one float32 step of reduced ``qwen3-8b`` and
   ``qwen3-moe-235b-a22b`` on the card against the CPU (1e-4 relative);
   the resume check (4 straight steps against 2, ``save``, a new loop
   and 2 more: every weight bit-equal); ``python -m
   repro_torch.launch.train`` as a subprocess, run, resumed at its
   checkpoint and run on to 30 steps;

   mesh: meshes, shardings, compressed all-reduce and the dry run
   (:func:`mesh_phase`, ROADMAP A16 and A17b; no kernel of their own):
   ``serve.main`` on ``qwen3-8b`` at the serving defaults with the
   launcher's one-rank mesh and sharder installed, against
   ``serve.generate`` with none on the same weights and prompt (tokens
   identical; both median steps); the train phase's model (17 layers)
   for :data:`MESH_TRAIN_STEPS` steps plain and with its parameters and
   AdamW state as DTensors on a one-rank NCCL mesh, from the same
   weights and batches (losses within :data:`MESH_TRAIN_TOL`; step ms
   and peak memory of both); ``compressed_psum`` over that group on
   qwen3-8b's embedding and LM head shapes in bf16 (1.24 G elements)
   beside its bytes bound (:data:`PSUM_PASSES`); ``elastic.mesh_for(1,
   [8])`` with no group up (a one-rank NCCL mesh) and ``reshard_plan`` of
   a saved ``qwen3-8b`` state at full width, :data:`ELASTIC_LAYERS`
   layers, onto it (DTensors of the asked placements, values equal, the
   bytes restored; :func:`_mesh_elastic`); a line that collectives
   across distinct cards were not measured; the dry run of ``qwen3-8b``
   for every shape on both production meshes, a process a cell, all at
   once on the host's CPU (each cell's trace seconds, FLOP ratio
   against the model's and collective bytes by kind), then
   ``roofline.markdown`` over its records;
10. time each kernel entry at one chunk of 1 Mi rows beside its plain
   version, one PyTorch library call computing the same function, and its
   bound, with its launch attributes (CTAs an SM, registers, local bytes),
   B1, B3 and B2 on fp32 add also at the widths of :data:`WIDE_MAIN`, and
   the check fold on the faulty fp_add's fused chunk (beside
   ``blk[0].clone()``) and on the blocks the faulty gemv folded, weighted
   by their launches, each launch's block read from device memory (the
   state of its bytes bound, :func:`cold_ms`) and from L2 (its state on
   the path); and the decode-attention kernel (``csrc/decode_attn.cu``,
   no TPU kernel) at the benchmark cell's shape at positions 287 and 575
   (:func:`measure_decode_attn`) beside the plain ``_group_attn``, one
   ``scaled_dot_product_attention`` call (a yardstick the port never
   calls) and its bytes bound;
11. examples: each PIM script of ``examples_torch/`` (quickstart, the int8
   linear layer, fusion with ``dot``/``gemv``, batched serving, streaming
   at 1 Mi rows) run on the card in process (:func:`examples_phase`), its
   lines printed, its correctness flags and asserts held, its seconds and
   launches (B1 fused or io as :data:`EXAMPLES` says, no plain version);
12. offload: the offload planner under the H100 entry of
   ``repro_torch.core.device_model`` for every ``--arch``
   (:func:`offload_phase`), each op class of ``rwkv6-1.6b`` and
   ``qwen3-8b`` measured on the card as one bf16 add or multiply beside
   the planner's time, and the paper's Fig. 9 lines against the card's
   roofline and a measured ``a + b`` over 64 Mi int32 and fp32 elements
   (printed, not gated).

Each phase prints its seconds.

Phases 4 to 9, the verified, the serving and the examples phase each
zero the launch counters just before a run and read them just after: the
run's kernels must have launched and no plain version may have run.

The line before the last is a JSON object with one record per kernel entry;
the last line is ``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import io
import itertools
import json
import math
import os
import re
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

# The card's data-sheet rates (H100 SXM 80GB at 700 W: memory bandwidth,
# bf16 dense peak) come from its entry in the port's device model.  The rate
# of the 32-bit NOR word operations is the card's logic-op rate: one LOP3
# per NOR, 64 a clock per SM on 132 SMs, at the SM clock nvidia-smi reports
# (see ``measure``).
from repro_torch.core.device_model import H100  # noqa: E402

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
    "check_words": ("src/repro/kernels/pim_exec.py:407",
                    "src/repro_torch/csrc/check_words.cu"),
}


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


#: SM cycles the device sleeps before a timed run (0.1 s at 1980 MHz), so
#: that the host queues the run's launches while it waits and the events
#: time the launches back to back, not the host's time between them.
SLEEP_CYCLES = 200_000_000


def cuda_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, from CUDA events,
    after warm-up calls for at least 50 ms, so that the card's clocks are
    up however long it idled before.  The calls are queued behind a device
    sleep (:data:`SLEEP_CYCLES`), so a call whose kernel is shorter than
    its wrapper's host work is timed on the device all the same."""
    t0 = time.perf_counter()
    while True:
        fn()
        torch.cuda.synchronize()
        if time.perf_counter() - t0 >= 0.05:
            break
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: Bytes of other copies :func:`cold_ms` reads between two reads of one
#: copy of a block: over twice the H100's 50 MB L2.
FLUSH_BYTES = 128 << 20


def cold_ms(fn, block, iters: int) -> float:
    """Mean device time of ``fn(b)`` over ``iters`` calls, as
    :func:`cuda_ms` times them, but each call on the next of enough copies
    ``b`` of ``block`` that at least :data:`FLUSH_BYTES` of other copies
    are read between two reads of one: every call finds its block in
    device memory, not in L2, the state a bytes bound at the HBM rate
    assumes."""
    n = 1 + -(-FLUSH_BYTES // (block.numel() * block.element_size()))
    copies = itertools.cycle(block.expand((n,) + block.shape).contiguous()
                             .unbind(0))
    return cuda_ms(lambda: fn(next(copies)), iters)


def resolved(program, backend: str = "cuda", pkg=None, schedule=None,
             **backend_kw):
    """``program`` resolved on the card under ``pkg`` (this tree's
    ``kernels`` modules by default, or the parent's)."""
    if pkg is None:
        from repro_torch.kernels import ops, plan as kplan
    else:
        ops, kplan = pkg.ops, pkg.plan
    plan = kplan.as_plan(backend=dataclasses.replace(
        kplan.BACKENDS[backend], **backend_kw), device="cuda",
        schedule=schedule)
    in_names = tuple(sorted(program.in_ports))
    return ops.compiled(program, plan).resolve(program, plan, in_names)


def operands(program, kind: str = "slots", planes: int = 1,
             slot_width=None, cap=None):
    """One program's schedule of ``kind`` ('slots' or 'dense', the slots at
    ``slot_width`` and the dense schedule at width cap ``cap`` if given)
    with every operand its kernel entries take, on the card, with its
    packed stream and the ring kernels' CTA width -- built directly, not
    through ``resolve``, so that each entry runs the schedule it is named
    for whatever the dispatcher would pick."""
    from repro_torch.kernels import ops, pim_exec, plan as kplan
    backend = kplan.BACKENDS["cuda"]
    if slot_width is not None:
        backend = dataclasses.replace(backend, slot_width=slot_width)
    if cap is not None:
        backend = dataclasses.replace(backend, level_max_width=cap)
    plan = kplan.as_plan(backend=backend, device="cuda", schedule=kind)
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
        k_out=len(out_cells), in_base=ops.as_run(in_cells),
        out_base=ops.as_run(out_cells) if kind == "slots" else None,
        one_cell=s.one_cell,
        packed=(pim_exec.pack_levels if kind == "dense" else
                pim_exec.pack_slots)(s.a, s.b, s.out,
                                     n_cells=s.n_cells).to("cuda"),
        wpc=pim_exec.ring_words_per_cta(s.n_cells, planes))


def static_kernel(c, words_per_cta=None):
    from repro_torch.kernels import pim_exec
    return pim_exec.StaticKernel(c.sched, c.in_widths, c.out_widths,
                                 c.out_names, c.in_cells, planes=c.planes,
                                 words_per_cta=words_per_cta)


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
    if kernel:
        kw["packed"] = c.packed
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
        "int-parallel div64": program_for("int-parallel", "div", 64),
        "gate-free": gate_free_program(),
        "no-input": no_input_program(),
    }


def program_of(progs, name: str) -> tuple:
    """(program, slot width or None, dense cap or None) of a check's
    program name: "fp32 add@4" is fp32 add levelized at slot width 4,
    "fp32 add@cap16" its dense schedule capped at 16 lanes."""
    base, _, width = name.partition("@")
    if width.startswith("cap"):
        return progs[base], None, int(width[3:])
    return progs[base], int(width) if width else None, None


def schedule_of(progs, name: str, kind: str, planes: int = 1):
    """:func:`operands` of the program a check or timed row names."""
    prog, slot_width, cap = program_of(progs, name)
    return operands(prog, kind, planes, slot_width, cap)


#: Phase 3: (entry, program, fused, rows, planes): the slot scan, the
#: level gather, the static kernels, the gate-serial kernel, then rows64,
#: then the ring kernels on long streams (fp32 mul: 23 tiles for B4) and at
#: fewer than 32 words per CTA (int-parallel div64, 25354 cells: 2), then
#: the slot scan at slot widths 4 and 8 (windows of 4 and 8 records), then
#: levels past a window: slot widths 12, 16, 32 and 64 (each level split
#: into 2, 2, 4 and 8 windows of at most 8 records), the level gather at
#: dense caps 16, 32 and 64, and B2 at slot width 16.
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
    ("slot_scan", "fp32 add@4", True, (1 << 20) + 3, 1),
    ("slot_scan", "fp32 add@8", True, (1 << 20) + 3, 1),
    ("slot_scan", "fp32 add@4", True, (1 << 20) + 37, 2),
    ("slot_scan", "fp32 add@8", True, (1 << 20) + 37, 2),
    ("slot_scan", "fp32 mul@8", True, 1 << 20, 1),
    ("slot_scan", "uint32 add@4", False, 1 << 20, 1),
    ("slot_scan", "uint32 add@8", False, (1 << 20) + 77, 2),
    ("slot_scan", "fp32 add@8", True, (1 << 20) + 3, 1),
    ("slot_scan", "fp32 add@12", True, (1 << 20) + 3, 1),
    ("slot_scan", "fp32 add@16", True, (1 << 20) + 3, 1),
    ("slot_scan", "fp32 add@32", True, (1 << 20) + 3, 1),
    ("slot_scan", "fp32 add@64", True, (1 << 20) + 3, 1),
    ("slot_scan", "uint32 mul@16", False, (1 << 20) + 77, 1),
    ("slot_scan", "fp32 add@16", True, (1 << 20) + 37, 2),
    ("level_gather", "fp32 add@cap16", True, (1 << 20) + 3, 1),
    ("level_gather", "fp32 add@cap32", True, (1 << 20) + 3, 1),
    ("level_gather", "fp32 add@cap64", True, (1 << 20) + 3, 1),
    ("slots_static", "fp32 add@16", True, (1 << 20) + 5, 1),
    ("slots_static", "fp32 add@16", True, (1 << 20) + 37, 2),
]


def static_kernels(progs) -> dict:
    """The B2 kernels phase 3 and the main path run, by (program, planes)."""
    return {(name, planes): static_kernel(
        schedule_of(progs, name, "slots", planes))
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
        prog = program_of(progs, name)[0]
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
            c = schedule_of(progs, name, kind, planes)
            static = statics[(name, planes)] if entry == "slots_static" \
                else None
            x = random_inputs(c, rows, fused, rng)
            got = run_entry(c, x, fused, True, static)
            torch.cuda.synchronize()
            want = run_entry(c, x, fused, False, static)
            wpc = static.wpc if static else c.wpc
            info = (f"levels={c.sched.n_levels} width={c.sched.width} "
                    f"windows={c.packed.n_windows} of {c.packed.width} "
                    f"cells={c.sched.n_cells} words_per_cta={wpc} "
                    f"one_cell={c.one_cell}")
        key = entry_key(entry, fused, planes)
        err = int((got.long() - want.long()).abs().max()) if got.numel() \
            else 0
        worst[key] = max(worst.get(key, 0), err)
        if "@" in name:            # the timed rows of a width read theirs
            at = f"{key}@{name.partition('@')[2]}"
            worst[at] = max(worst.get(at, 0), err)
        same = torch.equal(got, want)
        print(f"check {key} {name}: rows={rows} {info} equal={same}",
              flush=True)
        if not same:
            raise AssertionError(f"kernel != plain version: {key} {name}")
    return worst


#: Phase 3's check-fold cases (shape, axis, offset) beside
#: :func:`fold_paths`: fused blocks (ports, rows) over the ports, packed
#: blocks (cells, words) and rows64 blocks (2, cells, words) over the
#: cells, at odd word counts.
FOLD_CHECKS = ([((p, r), 0, 0) for p in (1, 31, 32, 33)
                for r in (1000, 1 << 20, 1 << 24)] +
               [((k, w), 0, 0) for k in (1, 33, 64) for w in (32769, 524289)] +
               [((2, k, w), 1, 0) for k in (1, 33, 64)
                for w in (16385, 262145)])


def fold_constants() -> dict:
    """The integer constants B6's source (``csrc/check_words.cu``) states:
    its CTA width, the copy's CTAs an SM and units a thread, and the CTAs
    an SM the fold's 16-byte units must give."""
    src = (Path(__file__).resolve().parent /
           ENTRIES["check_words"][1]).read_text()
    return {name: int(v) for name, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", src)}


def fold_paths(sms: int) -> list:
    """(shape, axis, offset) of blocks that reach each path of B6's
    launcher on a card of ``sms`` SMs, from the constants its source
    states: k = 0 and 1 (the copy), k about the fold's unrolled 8 rows,
    on widths of every residue mod 4; widths about the fold's 16-byte
    rule (``kWideCtasPerSm`` CTAs an SM); the copy's grid just filled and
    one step past; rows64 blocks (outer 2); views that start ``offset``
    words past a 16-byte boundary."""
    c = fold_constants()
    threads = c["kThreads"]
    wide = 4 * threads * c["kWideCtasPerSm"] * sms   # fewest 16-byte words
    copy_full = 4 * threads * c["kCopyUnits"] * c["kCopyCtasPerSm"] * sms
    return ([((k, w), 0, 0) for k in (0, 1, 2, 3, 4, 5, 8, 9, 16, 17, 33)
             for w in (4096, 4097, 4098, 4099)] +
            [((k, w), 0, 0) for k in (2, 9, 16) for w in (wide - 4, wide)] +
            [((1, w), 0, 0) for w in (copy_full, copy_full + 4 * threads *
                                      c["kCopyUnits"])] +
            [((2, k, w), 1, 0) for k in (0, 1, 3, 17) for w in (4097, 4099)] +
            [((2, 9, wide // 2), 1, 0)] +
            [((k, w), 0, 1) for k in (1, 2, 16) for w in (4096, wide)] +
            [((2, 9, 4096), 1, 1)])


def check_folds(worst: dict) -> None:
    """Phase 3 for B6: the check fold against its plain version on the
    card and against numpy's XOR reduction of the host copy, bit for bit,
    on random bits made on the card (a block with an offset is a view that
    many words into its allocation)."""
    from repro_torch.kernels import pim_exec, ref as kref
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for shape, axis, offset in FOLD_CHECKS + fold_paths(sms):
        n = int(np.prod(shape))
        base = torch.randint(-(1 << 31), 1 << 31, (offset + n,),
                             dtype=torch.int32, device="cuda", generator=g)
        blk = base[offset:].view(shape)
        got = pim_exec.check_words(blk, axis)
        torch.cuda.synchronize()
        want = kref.check_words(blk, axis)
        host = np.bitwise_xor.reduce(blk.cpu().numpy().view(np.uint32),
                                     axis=axis)
        err = int((got.long() - want.long()).abs().max()) \
            if got.numel() else 0
        worst["check_words"] = max(worst.get("check_words", 0), err)
        same = torch.equal(got, want) and \
            np.array_equal(got.cpu().numpy().view(np.uint32), host)
        print(f"check check_words {shape} axis={axis} offset={offset}: "
              f"equal={same} (plain version and numpy)", flush=True)
        if not same:
            raise AssertionError(f"check_words != plain version: {shape} "
                                 f"offset {offset}")


def _plain_calls() -> dict:
    from repro_torch.kernels import ref as kref, slots as kslots
    return {**kslots.CALLS, **kref.CALLS}


def _counted(label: str, keys, fn) -> tuple:
    """Run ``fn`` with the launch counters zeroed just before and read just
    after: every kernel entry of ``keys`` must have launched and no plain
    version may have run.  Returns (result, launches, seconds)."""
    from repro_torch.kernels import pim_exec
    pim_exec.reset_counts()
    t0 = time.perf_counter()
    got = fn()
    s = time.perf_counter() - t0
    launches = dict(pim_exec.LAUNCHES)
    plain = _plain_calls()
    if any(launches[k] < 1 for k in keys) or any(plain.values()):
        raise AssertionError(f"{label} did not run its kernels {keys}: "
                             f"launches {launches}, plain {plain}")
    return got, {k: v for k, v in launches.items() if v}, s


def _same_bits(got, want) -> bool:
    got, want = np.atleast_1d(got), np.atleast_1d(want)
    return got.dtype == want.dtype and got.shape == want.shape and \
        np.array_equal(got.view(np.uint8), want.view(np.uint8))


def _main_run(label: str, key: str, fn, want) -> tuple:
    """Run ``fn`` under :func:`_counted`; the result must equal ``want``
    bit for bit.  Returns (launches of ``key``, seconds)."""
    got, ran, s = _counted(label, (key,), fn)
    if not _same_bits(got, want):
        raise AssertionError(f"{label} differs from numpy")
    print(f"main {label}: bit-exact vs numpy; launches {ran}, plain calls "
          f"0; wall {s * 1e3:.3f} ms", flush=True)
    return ran[key], s


#: The main path under plans retuned to other widths (Backend field,
#: width, schedule, the entry it launches): B1 at slot widths 8, 12, 16 and
#: 32 (levels of 1, 2, 2 and 4 windows), B3 at dense caps 16 and 32, B2 at
#: slot width 16.  Their launches are recorded as the entry's
#: name with the width (``slot_scan_fused@16``, ``level_gather_fused@cap16``).
WIDE_MAIN = [
    ("slot_width", 8, None, "slot_scan_fused"),
    ("slot_width", 12, None, "slot_scan_fused"),
    ("slot_width", 16, None, "slot_scan_fused"),
    ("slot_width", 32, None, "slot_scan_fused"),
    ("level_max_width", 16, "dense", "level_gather_fused"),
    ("level_max_width", 32, "dense", "level_gather_fused"),
    ("slot_width", 16, "slots-static", "slots_static_fused"),
]


def width_tag(field: str, width: int) -> str:
    """The suffix a width gives a program or entry name: "@16" for a slot
    width, "@cap16" for a dense cap."""
    return f"@cap{width}" if field == "level_max_width" else f"@{width}"


def main_path() -> dict:
    """Phase 4: the public entry points at full size.  Returns the
    launches of each kernel entry in its run and the walls."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.core.pim_numerics import program_for
    from repro_torch.kernels import ops, plan as kplan
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
    for field, width, schedule, key in WIDE_MAIN:
        plan = kplan.as_plan(backend=kplan.Backend("cuda", **{field: width}),
                             schedule=schedule)
        pim.prepare("fp_add", a[:1], b[:1], plan=plan).warm()
        label = (f"fp_add fp32 rows={MAIN_ROWS} Backend('cuda', "
                 f"{field}={width}) schedule={plan.schedule}")
        launches[key + width_tag(field, width)], walls[label] = _main_run(
            label, key, lambda: pim.fp_add(a, b, plan=plan), want)

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
    return {"launches": launches, "walls": walls, "a": a, "b": b}


# --------------------------------------------------------------------------
# the scale layer, fusion and the packed reductions (phases 5 to 9)
# --------------------------------------------------------------------------

#: Chunk of the streaming check against the default chunk (phase 5).
BIG_CHUNK_ROWS = 4 << 20
#: B1's CTA width in the device-bound stream of phase 5: two columns a CTA
#: make fp32 div's kernel (1.1 ms a chunk at the rule's 57) about 30 ms a
#: chunk, longer than the host's work on a chunk, so chunk k+1's copy in
#: is queued while chunk k's kernel runs.
SLOW_WORDS_PER_CTA = 2
#: Rows of each program group (phase 6), of the fp32 dot (phase 8) and of
#: the fused expression (phase 9); the gemv's and int8 linear layer's
#: shapes (phase 8): a 4096-wide linear layer, 16 Mi products each.
GROUP_ROWS = 1 << 20
DOT_ROWS = 4 << 20
FUSED_ROWS = 4 << 20
GEMV_SHAPE = (4096, 4096)
LINEAR_SHAPE = (1, 4096, 4096)


def _intervals(events) -> list:
    """Merged [start, end) intervals (us) of trace events."""
    out = []
    for s, e in sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in events):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap_us(events, merged) -> float:
    """Time of ``events`` that runs while any interval of ``merged``
    does."""
    total = 0.0
    for ev in events:
        s, e = ev["ts"], ev["ts"] + ev["dur"]
        for ms, me in merged:
            total += max(0.0, min(e, me) - max(s, ms))
    return total


def device_timeline(fn) -> tuple:
    """Run ``fn`` under ``torch.profiler`` and read the card's timeline
    from its trace: kernels, host-to-device and device-to-host copies.
    Returns (result, wall seconds, stats or None where the profiler saw no
    device activity)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    path = Path("build") / "chip_smoke_trace.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text()).get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    path.unlink()
    kernels = [e for e in events if e.get("cat") == "kernel"]
    copies = [e for e in events if e.get("cat") == "gpu_memcpy"]
    h2d = [e for e in copies if "HtoD" in e.get("name", "")]
    d2h = [e for e in copies if "DtoH" in e.get("name", "")]
    device = kernels + copies + [e for e in events
                                 if e.get("cat") == "gpu_memset"]
    if not device:
        return out, wall, None
    busy = sum(e - s for s, e in _intervals(device))

    def rate(evs):
        us = sum(e["dur"] for e in evs)
        nbytes = sum(e.get("args", {}).get("bytes", 0) for e in evs)
        return us / 1e3, nbytes, (nbytes / us / 1e3 if us else 0.0)

    by_name = {}
    for e in kernels:
        us, k = by_name.get(e["name"], (0.0, 0))
        by_name[e["name"]] = (us + e["dur"], k + 1)
    stats = {"busy_ms": busy / 1e3, "busy_share": busy / 1e6 / wall,
             "kernels": len(kernels),
             "top": sorted(((n, us, k) for n, (us, k) in by_name.items()),
                           key=lambda r: -r[1]),
             "kernel_ms": sum(e["dur"] for e in kernels) / 1e3,
             "h2d": rate(h2d), "d2h": rate(d2h), "h2d_count": len(h2d),
             "d2h_count": len(d2h),
             "h2d_overlap_share": (
                 _overlap_us(h2d, _intervals(kernels)) /
                 sum(e["dur"] for e in h2d) if h2d else 0.0)}
    return out, wall, stats


def timeline_line(label: str, wall: float, st, gpu: str) -> None:
    if st is None:
        print(f"profile {label}: {gpu}; wall {wall * 1e3:.3f} ms; the "
              "profiler shows no device time (not measured)", flush=True)
        return
    (h_ms, h_b, h_gbs), (d_ms, d_b, d_gbs) = st["h2d"], st["d2h"]
    print(f"profile {label}: {gpu}; wall {wall * 1e3:.3f} ms under the "
          f"profiler; device busy {st['busy_ms']:.3f} ms = "
          f"{st['busy_share']:.6f} of the wall; {st['kernels']} kernels "
          f"{st['kernel_ms']:.3f} ms; H2D {st['h2d_count']} copies "
          f"{h_ms:.3f} ms {h_b} B = {h_gbs:.3f} GB/s; D2H {d_ms:.3f} ms "
          f"{d_b} B = {d_gbs:.3f} GB/s; H2D time concurrent with a kernel "
          f"{st['h2d_overlap_share']:.6f}", flush=True)


def streaming_phase(a, b, gpu: str, kw=None) -> np.ndarray:
    """Phase 5: the main path's run on the pipeline, profiled (pinned
    copies, the share of H2D time under a kernel, the device's busy
    share), a run with chunks of :data:`BIG_CHUNK_ROWS` held against the
    default chunk, and the same profile of an fp32 div stream (uniform
    magnitudes in [1, 2)) at B1's CTA rule and at
    :data:`SLOW_WORDS_PER_CTA` columns a CTA, where each chunk's kernel
    outlasts the host's work on the next chunk and the copies can
    overlap the kernels.  Returns the default run's result."""
    from repro_torch import pim_ufunc as pim
    kw = kw or {}
    default = pim.fp_add(a, b, **kw)
    big, ran, s = _counted(
        f"fp_add chunk_rows={BIG_CHUNK_ROWS}", ("slot_scan_fused",),
        lambda: pim.fp_add(a, b, chunk_rows=BIG_CHUNK_ROWS, **kw))
    if not (_same_bits(big, default) and _same_bits(default, a + b)):
        raise AssertionError("fp_add with 4 Mi-row chunks != 1 Mi-row chunks")
    print(f"stream fp_add fp32 rows={len(a)} chunk_rows={BIG_CHUNK_ROWS}: "
          f"bit-exact vs chunk_rows={pim.config.chunk_rows} and numpy; "
          f"launches {ran}; wall {s * 1e3:.3f} ms", flush=True)
    if not torch.cuda.is_available():
        return default
    t0 = time.perf_counter()
    prep = pim.prepare("fp_add", a, b, **kw)
    prepare_ms = (time.perf_counter() - t0) * 1e3
    got, wall, st = device_timeline(prep.run)
    if not _same_bits(got, a + b):
        raise AssertionError("profiled fp_add differs from numpy")
    timeline_line(f"main path fp_add fp32 rows={len(a)} (prepare "
                  f"{prepare_ms:.3f} ms, then the run phase)", wall, st, gpu)
    from repro_torch.kernels import plan as kplan
    rng = np.random.default_rng(SEED + 6)
    n = 16 << 20
    x = uniform_signed(rng, n, np.float32)
    y = uniform_signed(rng, n, np.float32)
    slow = kplan.as_plan(backend=dataclasses.replace(
        kplan.BACKENDS["cuda"], words_per_cta=SLOW_WORDS_PER_CTA))
    for label, opts in (("", kw),
                        (f" words_per_cta={SLOW_WORDS_PER_CTA}",
                         {"plan": slow})):
        prep = pim.prepare("fp_div", x, y, **opts)
        prep.warm()
        got, wall, st = device_timeline(prep.run)
        if not _same_bits(got, x / y):
            raise AssertionError(f"profiled fp_div{label} differs from "
                                 "numpy")
        timeline_line(f"stream fp_div fp32 rows={n}{label} (run phase)",
                      wall, st, gpu)
    return default


def uniform_signed(rng, n, dtype) -> np.ndarray:
    """Magnitudes in [1, 2) with random signs: every product and partial
    sum of such operands is 0 or a normal number in fp16, bf16 and fp32
    (the suite excludes subnormals)."""
    v = rng.uniform(1.0, 2.0, n) * rng.choice([-1.0, 1.0], n)
    return v.astype(dtype)


def _bf16(v: np.ndarray) -> np.ndarray:
    """float32 values rounded to bf16 bit patterns (RNE; no NaN here)."""
    u = v.astype(np.float32).view(np.uint32).astype(np.uint64)
    return ((u + 0x7FFF + ((u >> 16) & 1)) >> 16).astype(np.uint64)


def _from_bf16(bits: np.ndarray) -> np.ndarray:
    return (np.asarray(bits, np.uint64).astype(np.uint32) << 16).view(
        np.float32)


def groups_phase(kw=None, rows: int = GROUP_ROWS) -> dict:
    """Phase 6: ``ops.run_program_groups`` over eight mixed groups of
    ``rows`` rows, each held against numpy and against the same group run
    alone through ``ops.run_program``.  Returns the launches."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.kernels import ops
    kw = kw or {}
    rng = np.random.default_rng(SEED + 7)
    f16 = [uniform_signed(rng, rows, np.float16) for _ in range(2)]
    f32 = [uniform_signed(rng, rows, np.float32) for _ in range(4)]
    bf = [_bf16(uniform_signed(rng, rows, np.float32)) for _ in range(2)]

    def ints(bits):
        return [rng.integers(0, 1 << bits, rows, dtype=np.uint64).astype(
            np.dtype(f"uint{bits}")) for _ in range(2)]
    u16a, u32, u8, u16s = ints(16), ints(32), ints(8), ints(16)
    bf_want = _bf16(_from_bf16(bf[0]) + _from_bf16(bf[1]))
    cases = [
        ("fp16 add", pim.prepare("fp_add", *f16, **kw), f16[0] + f16[1]),
        ("fp32 mul", pim.prepare("fp_mul", *f32[:2], **kw),
         f32[0] * f32[1]),
        ("fp32 div", pim.prepare("fp_div", *f32[2:], **kw),
         f32[2] / f32[3]),
        ("uint16 add", pim.prepare("add", *u16a, **kw),
         u16a[0].astype(np.uint64) + u16a[1]),
        ("uint32 add (io)", pim.prepare("add", *u32, **kw),
         u32[0].astype(np.uint64) + u32[1]),
        ("uint8 mul", pim.prepare("mul", *u8, **kw),
         u8[0].astype(np.uint64) * u8[1]),
        ("uint16 sub", pim.prepare("sub", *u16s, **kw),
         (u16s[0].astype(np.uint64) - u16s[1]) & np.uint64(0xFFFF)),
        ("bf16 add", pim.prepare("fp_add", *bf, fmt="bf16", **kw), bf_want),
    ]
    for _, p, _ in cases:
        p.warm()
    groups = [dict(program=p.program, inputs=p.inputs, n_rows=p.n_rows,
                   plan=p.plan) for _, p, _ in cases]
    keys = ("slot_scan_fused", "slot_scan_io")
    outs, ran, s = _counted("run_program_groups", keys,
                            lambda: ops.run_program_groups(groups))
    for (label, p, want), out in zip(cases, outs):
        alone = ops.run_program(p.program, p.inputs, p.n_rows, p.plan)
        if not (_same_bits(p.finish(out), want) and
                all(np.array_equal(out[k], alone[k]) for k in alone)):
            raise AssertionError(f"group {label} differs")
    print(f"groups: {len(cases)} groups of {rows} rows "
          f"({', '.join(c[0] for c in cases)}): each bit-exact vs numpy and "
          f"vs run_program alone; launches {ran}; wall {s * 1e3:.3f} ms",
          flush=True)
    return ran


def sharding_phase(a, b, want, kw=None, mesh=("cuda:0", "cuda:0")
                   ) -> dict:
    """Phase 7: fp32 ``fp_add`` over the main path's rows with
    ``shards=torch.cuda.device_count()`` and with ``mesh`` (two shards on
    the one card by default), against ``want``, the unsharded result."""
    from repro_torch import pim_ufunc as pim
    kw = kw or {}
    n_dev = torch.cuda.device_count()
    ran = {}
    for label, opts in ((f"shards={n_dev}", {"shards": n_dev}),
                        (f"mesh={mesh}", {"mesh": mesh})):
        got, ran[label], s = _counted(f"fp_add {label}",
                                      ("slot_scan_fused",),
                                      lambda: pim.fp_add(a, b, **opts, **kw))
        if not _same_bits(got, want):
            raise AssertionError(f"fp_add {label} != unsharded")
        print(f"shard fp_add fp32 rows={len(a)} {label} ({n_dev} CUDA "
              f"devices): bit-exact vs unsharded; launches {ran[label]}; "
              f"wall {s * 1e3:.3f} ms", flush=True)
    return ran


def _host_tree(p: np.ndarray) -> np.ndarray:
    """The in-memory adder tree's pairing on the host, along the last axis
    (a power of two): rows [0, R/2) plus rows [R/2, R), in ``p``'s
    dtype, rounded per add."""
    while p.shape[-1] > 1:
        h = p.shape[-1] // 2
        p = (p[..., :h] + p[..., h:]).astype(p.dtype)
    return p[..., 0]


def reductions_phase(gpu: str, kw=None, gemv_shape=GEMV_SHAPE,
                     linear_shape=LINEAR_SHAPE, dot_rows=DOT_ROWS) -> dict:
    """Phase 8: ``pim.gemv`` fp16, ``pim_linear_i8`` and ``pim.dot`` fp32,
    each held against its host reference (the same tree on numpy, or
    numpy's int64 matmul), with its wall, launches (1 + log2 K on one
    card) and device-busy share."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.core import pim_numerics as pn
    kw = kw or {}
    rng = np.random.default_rng(SEED + 9)
    on_card = torch.cuda.is_available()
    ran = {}

    def run(label, fn, key):
        def counted():
            return _counted(label, (key,), fn)
        if on_card:
            (got, launches, s), wall, st = device_timeline(counted)
        else:
            (got, launches, s), st = counted(), None
        ran[label] = launches
        busy = "not measured" if st is None else \
            f"{st['busy_share']:.6f} (busy {st['busy_ms']:.3f} ms)"
        return got, (f"launches {launches}; wall {s * 1e3:.3f} ms; device "
                     f"busy share {busy}")

    m, k = gemv_shape
    a = uniform_signed(rng, m * k, np.float16).reshape(m, k)
    x = uniform_signed(rng, k, np.float16)
    got, info = run(f"gemv fp16 {m}x{k}", lambda: pim.gemv(a, x, **kw),
                    "slot_scan_io")
    prods = np.zeros((m, 1 << (k - 1).bit_length()), np.float16)
    prods[:, :k] = a * x
    want = _host_tree(prods)
    if not _same_bits(got, want):
        raise AssertionError("gemv fp16 != host tree")
    print(f"reduce gemv fp16 {m}x{k}: {gpu}; bit-exact vs the numpy host "
          f"tree; {info}", flush=True)

    bm, bk, bn = linear_shape
    xi = rng.integers(-128, 128, (bm, bk)).astype(np.int8)
    wi = rng.integers(-128, 128, (bk, bn)).astype(np.int8)
    unit = pn.PIMVectorUnit(kw.get("backend", "cuda"),
                            device=kw.get("device"))
    got, info = run(f"pim_linear_i8 {bm}x{bk}x{bn}",
                    lambda: pn.pim_linear_i8(unit, xi, wi), "slot_scan_io")
    if not np.array_equal(got, xi.astype(np.int64) @ wi.astype(np.int64)):
        raise AssertionError("pim_linear_i8 != numpy int64 matmul")
    print(f"reduce pim_linear_i8 x[{bm},{bk}] @ w[{bk},{bn}]: {gpu}; "
          f"bit-exact vs numpy int64 matmul; {info}", flush=True)

    u = uniform_signed(rng, dot_rows, np.float32)
    v = uniform_signed(rng, dot_rows, np.float32)
    got, info = run(f"dot fp32 {dot_rows}", lambda: pim.dot(u, v, **kw),
                    "slot_scan_io")
    total = 1 << (dot_rows - 1).bit_length()
    prods = np.zeros(total, np.float32)
    prods[:dot_rows] = u * v
    if not _same_bits(got, _host_tree(prods)):
        raise AssertionError("dot fp32 != host tree")
    print(f"reduce dot fp32 rows={dot_rows}: {gpu}; bit-exact vs the numpy "
          f"host tree; {info}", flush=True)
    return ran


def fused_phase(gpu: str, kw=None, rows: int = FUSED_ROWS) -> dict:
    """Phase 9: ``pim.fuse`` of fp32 ``a*b + c`` under the slot and dense
    schedules, against numpy's ``(a*b)+c`` rounded per op."""
    from repro_torch import pim_ufunc as pim
    kw = kw or {}
    rng = np.random.default_rng(SEED + 10)
    a, b, c = (uniform_signed(rng, rows, np.float32) for _ in range(3))
    want = (a * b).astype(np.float32) + c
    ran = {}
    for schedule, key in (("slots", "slot_scan_fused"),
                          ("dense", "level_gather_fused")):
        e = pim.fp_add(pim.fp_mul(pim.lazy(a), pim.lazy(b)), pim.lazy(c))
        prep = pim.fuse(e, schedule=schedule, **kw)
        prep.warm()
        got, ran[schedule], s = _counted(f"fuse {schedule}", (key,),
                                         prep.run)
        if not _same_bits(got, want):
            raise AssertionError(f"fused a*b+c ({schedule}) != numpy")
        print(f"fuse fp32 a*b+c rows={rows} schedule={schedule}: {gpu}; "
              f"bit-exact vs numpy per op; one program of "
              f"{prep.fused_ops} ops; launches {ran[schedule]}; wall "
              f"{s * 1e3:.3f} ms", flush=True)
    return ran


# --------------------------------------------------------------------------
# verified execution under injected faults (the verified phase)
# --------------------------------------------------------------------------

#: Chunk-relative row of the forced flip (output cell 0, every chunk's and
#: every tree stage's first attempt) and the faults' chunk size.
FLIP_ROW = 7
FAULT_CHUNK = 1 << 20
#: Rows of the two-shard run under faults.
MESH_FAULT_ROWS = 16 << 20


def fault_model():
    """The verified phase's substrate: a forced flip of output cell 0 at
    row :data:`FLIP_ROW` of every chunk's first attempt, a dead row in
    chunk 3, a word column stuck at 1 in chunk 7, and transient flips at
    the reference's acceptance rate (p_flip=5e-4 a level), seeded."""
    from repro_torch.runtime.faults import FaultModel
    return FaultModel(seed=SEED, p_flip=5e-4, force_flips=((0, FLIP_ROW),),
                      force_dead_rows=(3 * FAULT_CHUNK + 1000,),
                      force_stuck=((7 * FAULT_CHUNK // 32 + 5, 1),))


def _verified_turns(a, b, want, gpu: str, kw) -> dict:
    """fp32 ``fp_add`` at the main path's rows: plain, ``verify=True`` and
    the faults under ``VerifyPolicy()``, in turns, three rounds.  Each run
    is bit-exact, launches B1 once a chunk attempt and the check fold
    once a chunk attempt where faults and a policy are both set, never
    elsewhere.  Returns the check fold's launches in the first faulty
    run."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.kernels import ops
    from repro_torch.runtime.faults import VerifyPolicy
    modes = {"plain": {}, "verify-only": {"verify": True},
             "faults+verify": {"faults": fault_model(),
                               "verify": VerifyPolicy()}}
    n_chunks = -(-len(a) // FAULT_CHUNK)
    folds = None
    for rnd in range(3):
        walls = {}
        for mode, opts in modes.items():
            ops.drain_health()
            t0 = time.perf_counter()
            prep = pim.prepare("fp_add", a, b, **opts, **kw)
            prepare_s = time.perf_counter() - t0
            got, ran, run_s = _counted(f"verified {mode}",
                                       ("slot_scan_fused",), prep.run)
            h = ops.drain_health()
            if not _same_bits(got, want):
                raise AssertionError(f"fp_add {mode} differs from numpy")
            attempts = ran["slot_scan_fused"]
            n_folds = ran.get("check_words", 0)
            if mode == "faults+verify":
                if n_folds != attempts or attempts != n_chunks + \
                        h.get("retries", 0):
                    raise AssertionError(f"{mode}: {attempts} attempts, "
                                         f"{n_folds} folds, health {h}")
                short = [k for k in ("faults_injected", "faults_detected",
                                     "faults_corrected", "retries",
                                     "remapped_rows") if h.get(k, 0) < 1]
                if short:
                    raise AssertionError(f"{mode}: no {short}: {h}")
                folds = folds or n_folds
            elif n_folds or attempts != n_chunks or \
                    h.get("faults_detected") or h.get("retries"):
                raise AssertionError(f"{mode}: launches {ran}, health {h}")
            walls[mode] = (prepare_s + run_s, run_s)
            print(f"verified round {rnd} fp_add fp32 rows={len(a)} {mode}: "
                  f"{gpu}; bit-exact vs numpy; launches {ran}; health {h}; "
                  f"wall {walls[mode][0] * 1e3:.3f} ms (prepare "
                  f"{prepare_s * 1e3:.3f} ms, run phase "
                  f"{run_s * 1e3:.3f} ms)", flush=True)
        pw, pr = walls["plain"]
        print(f"verified round {rnd} overheads vs plain: verify-only wall "
              f"{walls['verify-only'][0] / pw:.6f}x run phase "
              f"{walls['verify-only'][1] / pr:.6f}x; faults+verify wall "
              f"{walls['faults+verify'][0] / pw:.6f}x run phase "
              f"{walls['faults+verify'][1] / pr:.6f}x", flush=True)
    return folds


@contextlib.contextmanager
def folded_shapes():
    """Count the (shape, axis) of each block that the card's check fold
    (``pim_exec.check_words``, which ``ops`` looks up at each call) is
    handed inside the span: yields the Counter."""
    from repro_torch.kernels import pim_exec
    shapes = collections.Counter()
    fold = pim_exec.check_words

    def recorded(block, axis):
        shapes[(tuple(block.shape), axis % block.dim())] += 1
        return fold(block, axis)
    pim_exec.check_words = recorded
    try:
        yield shapes
    finally:
        pim_exec.check_words = fold


def verified_phase(a, b, gpu: str, kw=None, gemv_shape=GEMV_SHAPE,
                   mesh=("cuda:0", "cuda:0")) -> dict:
    """The verified phase (after phase 9): verified execution under
    injected faults through the public entry points, each run checked
    against numpy with the launch counters zeroed just before and read
    just after.  Returns the check fold's launches on its main paths: the
    faulty fp_add (fused blocks) and the faulty gemv (packed blocks)."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.kernels import ops
    from repro_torch.runtime.faults import VerifyPolicy
    kw = kw or {}
    want = a + b
    ran = {"check_words_fused": _verified_turns(a, b, want, gpu, kw)}

    # the faults with no policy reach the result
    fm = fault_model()
    ops.drain_health()
    got, launches, s = _counted("faults without verify",
                                ("slot_scan_fused",),
                                lambda: pim.fp_add(a, b, faults=fm, **kw))
    h = ops.drain_health()
    differ = got.view(np.uint32) != want.view(np.uint32)
    rows = np.arange(FLIP_ROW, len(a), FAULT_CHUNK)
    if launches.get("check_words") or not differ[rows].all() or \
            not differ[3 * FAULT_CHUNK + 1000]:
        raise AssertionError("unverified faults did not reach the result "
                             f"as injected: launches {launches}, {h}")
    print(f"verified fp_add fp32 rows={len(a)} faults without verify: "
          f"{gpu}; differs from numpy at {int(differ.sum())} rows, the "
          f"{len(rows)} forced-flip rows and the dead row among them; "
          f"launches {launches}; health {h}; wall {s * 1e3:.3f} ms",
          flush=True)

    # the packed tree under the faults, and verify-only
    rng = np.random.default_rng(SEED + 9)
    m, k = gemv_shape
    ga = uniform_signed(rng, m * k, np.float16).reshape(m, k)
    gx = uniform_signed(rng, k, np.float16)
    prods = np.zeros((m, 1 << (k - 1).bit_length()), np.float16)
    prods[:, :k] = ga * gx
    tree = _host_tree(prods)
    stages = 1 + (k - 1).bit_length()
    for label, opts in (("faults+verify", {"faults": fm,
                                           "verify": VerifyPolicy()}),
                        ("verify-only", {"verify": True})):
        ops.drain_health()
        keys = ("slot_scan_io",) + (("check_words",) if "faults" in opts
                                    else ())

        def counted():
            return _counted(f"gemv {label}", keys,
                            lambda: pim.gemv(ga, gx, **opts, **kw))
        with folded_shapes() as shapes:
            if torch.cuda.is_available():
                (got, launches, s), _, st = device_timeline(counted)
            else:
                (got, launches, s), st = counted(), None
        h = ops.drain_health()
        if not _same_bits(got, tree):
            raise AssertionError(f"gemv fp16 {label} != host tree")
        n_io = launches["slot_scan_io"]
        if "faults" in opts:
            if launches["check_words"] != n_io or \
                    n_io != stages + h.get("retries", 0) or \
                    sum(shapes.values()) != n_io:
                raise AssertionError(f"gemv {label}: launches {launches}, "
                                     f"folds {shapes}, health {h}")
            ran["check_words_io"] = launches["check_words"]
            ran["check_words_io_shapes"] = dict(shapes)
            print(f"verified gemv fp16 {m}x{k} {label}: check folds "
                  f"(shape, axis): launches {sorted(shapes.items())}",
                  flush=True)
        elif n_io != stages or launches.get("check_words") or \
                (st is not None and st["d2h_count"] != 1):
            raise AssertionError(f"gemv {label}: launches {launches}, "
                                 f"D2H {st and st['d2h_count']}")
        d2h = "not measured" if st is None else \
            f"{st['d2h_count']} D2H copies ({st['d2h'][1]} B)"
        print(f"verified gemv fp16 {m}x{k} {label}: {gpu}; bit-exact vs the "
              f"numpy host tree; {stages} stages; launches {launches}; "
              f"health {h}; {d2h}; wall {s * 1e3:.3f} ms", flush=True)

    # two shards on the one card under the faults
    n = min(MESH_FAULT_ROWS, len(a))
    ops.drain_health()
    got, launches, s = _counted(
        "mesh faults+verify", ("slot_scan_fused", "check_words"),
        lambda: pim.fp_add(a[:n], b[:n], mesh=mesh, faults=fm,
                           verify=VerifyPolicy(), **kw))
    h = ops.drain_health()
    if not _same_bits(got, want[:n]):
        raise AssertionError("fp_add mesh faults+verify differs from numpy")
    print(f"verified fp_add fp32 rows={n} mesh={mesh} faults+verify: {gpu}; "
          f"bit-exact vs numpy; launches {launches}; health {h}; wall "
          f"{s * 1e3:.3f} ms", flush=True)
    return ran


# --------------------------------------------------------------------------
# batched serving (the serving phase)
# --------------------------------------------------------------------------

#: Rows of a request of the serving mix at card size (64 requests: the
#: main path's 64 Mi rows) and at the reference's size
#: (``benchmarks/run.py`` ``_serve_rows``); requests of each program.
SERVE_ROWS = 1 << 20
SERVE_SMALL_ROWS = 1024
SERVE_PER_PROGRAM = 8
#: The JSON-lines stream: requests of ``STREAM_ROWS`` rows each, the
#: micro-batching window and the row cap of a batch.
STREAM_REQUESTS = 256
STREAM_ROWS = 4096
STREAM_WINDOW_MS = 5.0
STREAM_MAX_BATCH_ROWS = 65536


def _mid_fp16(rng, n) -> np.ndarray:
    """fp16 with mid-range exponents (``benchmarks/run.py:548``): every
    sum, difference, product and quotient of two is 0 or normal."""
    return (rng.integers(10, 21, n).astype(np.uint16) << 10 |
            rng.integers(0, 1 << 10, n).astype(np.uint16)).view(np.float16)


def _flushed(v: np.ndarray) -> np.ndarray:
    """numpy's fp16 answer in the suite's range: a result below the normal
    range (here only the difference of two close operands, which is
    exact) comes out of the reference's gate netlist, and of the port, as
    a zero of its sign (``tests/test_torch_serve.py``
    ``test_fp16_underflow_is_a_signed_zero_like_reference`` holds both
    packages to that on the CPU)."""
    b = v.view(np.uint16).copy()
    b[(b & 0x7C00) == 0] &= 0x8000
    return b.view(np.float16)


def _u16_want(op: str, x, y):
    """numpy's answer with the ufunc's semantics: the full sum and product
    and the difference modulo 2**16 as uint64, div's (q, r) pair."""
    x, y = x.astype(np.uint64), y.astype(np.uint64)
    return {"add": lambda: x + y, "mul": lambda: x * y,
            "sub": lambda: (x - y) & np.uint64(0xFFFF),
            "div": lambda: (x // y, x % y)}[op]()


def serving_mix(rows: int, per_program: int = SERVE_PER_PROGRAM,
                seed: int = SEED + 11) -> list:
    """The reference's serving mix (``benchmarks/run.py:531-640``): uint16
    add, sub, mul and div and fp16 add, sub, mul and div, round robin,
    ``per_program`` requests of each at ``rows`` rows.  Returns
    ``[(op, x, y, numpy's answer)]``, fp16 answers :func:`_flushed`."""
    rng = np.random.default_rng(seed)
    traffic = []
    for _ in range(per_program):
        x = rng.integers(0, 1 << 16, rows).astype(np.uint16)
        y = rng.integers(0, 1 << 16, rows).astype(np.uint16)
        d = rng.integers(1, 1 << 16, rows).astype(np.uint16)
        fa, fb, fd = (_mid_fp16(rng, rows) for _ in range(3))
        traffic += [(op, x, v, _u16_want(op, x, v))
                    for op, v in (("add", y), ("sub", y), ("mul", y),
                                  ("div", d))]
        traffic += [(op, fa, v, _flushed(want)) for op, v, want in (
            ("fp_add", fb, fa + fb), ("fp_sub", fb, fa - fb),
            ("fp_mul", fb, fa * fb), ("fp_div", fd, fa / fd))]
    return traffic


def _same_value(got, want) -> bool:
    if isinstance(want, tuple):
        return isinstance(got, tuple) and len(got) == len(want) and \
            all(_same_bits(g, w) for g, w in zip(got, want))
    return _same_bits(got, want)


def _span_ms(events) -> dict:
    """Milliseconds of the serving spans (``cat="pim.serve"``) by name,
    and of the dispatcher's events as ``cat:name``."""
    out: dict = {}
    for e in events:
        key = e["name"] if e.get("cat") == "pim.serve" else \
            f"{e.get('cat')}:{e['name']}"
        out[key] = out.get(key, 0.0) + e["dur"] / 1e3
    return out


def _union_ms(events, cat: str) -> float:
    """Milliseconds of the union of the events of ``cat`` (the dispatcher's
    ``exec`` events overlap: one chunk is staged while another runs)."""
    spans = sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("cat") == cat)
    total, end = 0.0, None
    for t0, t1 in spans:
        if end is None or t0 > end:
            total += t1 - t0
            end = t1
        elif t1 > end:
            total += t1 - end
            end = t1
    return total / 1e3


def _chunks(rows: int, plan) -> int:
    return -(-rows // plan.effective_chunk_rows)


def _serve_turns(traffic, label: str, gpu: str, keys,
                 profile: bool = True) -> dict:
    """The mix through ``BatchRuntime.execute`` and through the
    per-request serial loop (``Prepared.run()``), in turns, three rounds.
    Each run prepares its requests (both paths pay the same validation),
    is held against numpy and is counted: its launches must be one a
    chunk of each group (batched) or of each request (serial).  Each run
    is traced: the batched run's ``exec`` span splits into the groups'
    input checks and output join (``pim.groups`` events), the union of
    the dispatcher's ``exec`` events (staging, launch, copy back and
    unpack of each chunk) and the rest; the serial run reports the same
    union.  Then, with ``profile``, one batched and one serial run under
    ``torch.profiler`` (the device's busy share).  Returns the walls and
    launches by path."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.runtime import pim_batch, telemetry
    rows = sum(len(t[1]) for t in traffic)
    tracer = telemetry.TRACER
    walls = {"batched": [], "serial": []}
    launches = {}

    def prepare():
        return [pim.prepare(op, x, y) for op, x, y, _ in traffic]

    for p in prepare()[:8]:
        p.warm()                      # levelize and pack outside the runs

    def batched():
        rt = pim_batch.BatchRuntime(pin_cap=16)
        try:
            t0 = time.perf_counter()
            preps = prepare()
            prep_s = time.perf_counter() - t0
            results = rt.execute(preps)
        finally:
            rt.close()
        st = rt.stats
        bad = [r.error for r in results if r.error is not None]
        if bad or st.degraded_groups or st.shed_requests:
            raise AssertionError(
                f"{label} batched: errors {bad[:2]}, degraded groups "
                f"{st.degraded_groups}, shed {st.shed_requests}")
        n_launch = sum(_chunks(g.n_rows, g.preps[0].plan)
                       for g in pim_batch.plan_groups(preps))
        return [r.value for r in results], (prep_s, st.groups, n_launch)

    def serial():
        t0 = time.perf_counter()
        preps = prepare()
        prep_s = time.perf_counter() - t0
        n_launch = sum(_chunks(p.n_rows, p.plan) for p in preps)
        return [p.run() for p in preps], (prep_s, len(preps), n_launch)

    for rnd in range(3):
        for path, fn in (("batched", batched), ("serial", serial)):
            was, tracer.enabled = tracer.enabled, True
            tracer.drain()
            try:
                (vals, (prep_s, units, n_launch)), ran, s = _counted(
                    f"{label} {path}", keys, fn)
            finally:
                tracer.enabled = was
            events = tracer.drain()
            spans = _span_ms(events)
            dispatch = _union_ms(events, "pim.exec")
            if not all(_same_value(v, t[3]) for v, t in zip(vals, traffic)):
                raise AssertionError(f"{label} {path} differs from numpy")
            if sum(ran.get(k, 0) for k in keys) != n_launch:
                raise AssertionError(f"{label} {path}: launches {ran}, "
                                     f"expected {n_launch}")
            walls[path].append(s)
            launches[path] = ran
            if path == "serial":
                split = f"; chunk exec events (union) {dispatch:.3f} ms"
            else:
                ex = spans.get("exec", 0.0)
                joined = spans.get("pim.groups:join", 0.0)
                checked = spans.get("pim.groups:inputs", 0.0)
                split = (
                    f"; coalesce {spans.get('coalesce', 0):.3f} ms, exec "
                    f"{ex:.3f} ms (input checks {checked:.3f}, chunk exec "
                    f"events (union) {dispatch:.3f}, output join "
                    f"{joined:.3f}, rest {ex - checked - dispatch - joined:.3f}"
                    f"), unpack {spans.get('unpack', 0):.3f} ms (pim.serve "
                    f"and pim.groups spans)")
            print(f"serve {label} round {rnd} {path}: {gpu}; {len(traffic)} "
                  f"requests, {rows} rows, {units} "
                  f"{'groups' if path == 'batched' else 'runs'}; bit-exact "
                  f"vs numpy; launches {ran}, plain calls 0; wall "
                  f"{s * 1e3:.3f} ms = {rows / s:.1f} rows/s; prepare "
                  f"{prep_s * 1e3:.3f} ms{split}", flush=True)
    if profile and torch.cuda.is_available():
        for path, fn in (("batched", batched), ("serial", serial)):
            _, wall, st = device_timeline(fn)
            timeline_line(f"serve {label} {path} (prepare and run)", wall,
                          st, gpu)
    b, s = min(walls["batched"]), min(walls["serial"])
    print(f"serve {label}: {gpu}; best of 3 in turns: batched "
          f"{b * 1e3:.3f} ms ({rows / b:.1f} rows/s), serial "
          f"{s * 1e3:.3f} ms ({rows / s:.1f} rows/s), serial/batched "
          f"{s / b:.6f}", flush=True)
    return {"walls": walls, "launches": launches}


def _stream_lines(n_requests: int, rows: int, seed: int = SEED + 12):
    """The JSON-lines stream of the serving phase: the eight programs of
    the mix round robin, one fused ``expr`` request, one ``width: 70`` add
    (the io branch), requests under ``"schedule": "dense"`` (B3),
    ``"slots-static"`` (B2) and ``"layout": "rows64"``, and four
    malformed lines.  Returns (lines, numpy's answer of each line: a
    value, a ``(q, r)`` pair, or None where the answer must be an
    error)."""
    rng = np.random.default_rng(seed)
    mix = serving_mix(rows, -(-n_requests // 8), seed)[:n_requests]

    def enc(v):
        return [float(t) for t in v] if v.dtype.kind == "f" else \
            [int(t) for t in v]

    reqs = [({"op": op, "dtype": x.dtype.name, "x": enc(x), "y": enc(y)},
             want) for op, x, y, want in mix]
    a, b, c = (_mid_fp16(rng, rows) for _ in range(3))
    w = [rng.integers(0, 1 << 63, rows, dtype=np.uint64) * 2 + 1
         for _ in range(2)]
    u = [rng.integers(0, 1 << 16, rows).astype(np.uint16) for _ in range(2)]
    f32 = [uniform_signed(rng, rows, np.float32) for _ in range(2)]
    extra = [
        ({"op": "expr", "dtype": "float16",
          "expr": ["fp_add", ["fp_mul", "a", "b"], "c"],
          "inputs": {"a": enc(a), "b": enc(b), "c": enc(c)}},
         (a * b).astype(np.float16) + c),
        ({"op": "add", "dtype": "uint64", "width": 70, "x": enc(w[0]),
          "y": enc(w[1])}, w[0].astype(object) + w[1].astype(object)),
        ({"op": "add", "dtype": "uint16", "x": enc(u[0]), "y": enc(u[1]),
          "schedule": "dense"}, _u16_want("add", *u)),
        ({"op": "fp_add", "dtype": "float32", "x": enc(f32[0]),
          "y": enc(f32[1]), "schedule": "slots-static"}, f32[0] + f32[1]),
        ({"op": "mul", "dtype": "uint16", "x": enc(u[0]), "y": enc(u[1]),
          "layout": "rows64"}, _u16_want("mul", *u)),
    ]
    for i, item in enumerate(extra):
        reqs.insert(3 + 37 * i, item)
    lines = [json.dumps(r) for r, _ in reqs]
    wants = [want for _, want in reqs]
    for i, bad in enumerate(('{"op": "add", "x": [1]',
                             '{"op": "nope", "x": [1], "y": [1]}',
                             '{"op": "div", "dtype": "uint16", "x": [1], '
                             '"y": [0]}',
                             'not json')):
        lines.insert(10 + 60 * i, bad)
        wants.insert(10 + 60 * i, None)
    return lines, wants


def _right_answer(resp: dict, want) -> bool:
    if want is None:
        return "error" in resp
    if "error" in resp:
        return False
    if isinstance(want, tuple):
        return resp["q"] == [int(v) for v in want[0]] and \
            resp["r"] == [int(v) for v in want[1]]
    if want.dtype.kind == "f":
        return _same_bits(np.asarray(resp["result"]).astype(want.dtype),
                          want)
    return resp["result"] == [int(v) for v in want]


def _stream_phase(gpu: str) -> dict:
    """The JSON-lines server in process (``serve_pim_batched`` on an
    in-memory stream): every answer checked in input order, the stats,
    and the trace file's spans.  Returns the launches."""
    from repro_torch.launch import serve
    rows = STREAM_ROWS
    lines, wants = _stream_lines(STREAM_REQUESTS, rows)
    text = "\n".join(lines) + "\n"
    warmed = set()
    for line, want in zip(lines, wants):   # levelize and build outside
        if want is not None:               # the run
            p = serve._pim_prepare_request(json.loads(line))
            if (p.key, p.plan.key) not in warmed:
                warmed.add((p.key, p.plan.key))
                p.warm()
    trace = Path("build") / "chip_smoke_serve_trace.json"
    trace.parent.mkdir(parents=True, exist_ok=True)
    keys = ("slot_scan_fused", "slot_scan_io", "level_gather_fused",
            "slots_static_fused", "slot_scan_fused_rows64")
    outp = io.StringIO()

    def run():
        return serve.serve_pim_batched(
            io.StringIO(text), outp, window_ms=STREAM_WINDOW_MS,
            max_batch_rows=STREAM_MAX_BATCH_ROWS, trace_file=str(trace))
    info, ran, s = _counted("serve stream", keys, run)
    resps = [json.loads(l) for l in outp.getvalue().splitlines()]
    wrong = [i for i, (r, w) in enumerate(zip(resps, wants))
             if not _right_answer(r, w)]
    if len(resps) != len(lines) or wrong:
        raise AssertionError(f"serve stream: {len(resps)} answers for "
                             f"{len(lines)} lines, wrong at {wrong[:5]}")
    n_bad = sum(w is None for w in wants)
    n_rows = sum(r.get("rows", 0) for r in resps)
    if info["served"] != len(lines) or info["errors"] != n_bad or \
            info["batches"] < -(-n_rows // STREAM_MAX_BATCH_ROWS) or \
            info["groups"] < info["batches"] or info["degraded_groups"] or \
            info["shed_requests"]:
        raise AssertionError(f"serve stream stats: {info}")
    spans = _span_ms(json.loads(trace.read_text())["traceEvents"])
    trace.unlink()
    missing = {"prepare", "enqueue", "coalesce", "exec", "unpack",
               "pim.exec:exec"} - set(spans)
    if missing:
        raise AssertionError(f"serve stream trace lacks {missing}")
    print(f"serve stream: {gpu}; {len(lines)} lines ({n_bad} malformed) of "
          f"{rows} rows, window {STREAM_WINDOW_MS} ms, row cap "
          f"{STREAM_MAX_BATCH_ROWS}: every answer right and in order; "
          f"served {info['served']}, errors {info['errors']}, batches "
          f"{info['batches']}, groups {info['groups']}, degraded "
          f"{info['degraded_groups']}, shed {info['shed_requests']}; "
          f"launches {ran}, plain calls 0; wall {s * 1e3:.3f} ms = "
          f"{n_rows / s:.1f} rows/s; trace spans (ms, summed) "
          + ", ".join(f"{k} {v:.3f}" for k, v in sorted(spans.items())),
          flush=True)
    return ran


def _cli_phase(gpu: str) -> None:
    """The CLI as a subprocess on the card: ``--pim-serve`` on four lines
    (one malformed), and the synthetic load at 16 Mi fp32 rows."""
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    reqs = ('{"op":"add","dtype":"uint8","x":[1,2],"y":[3,4]}\n'
            '{"op":"div","dtype":"uint8","x":[17],"y":[5]}\n'
            'broken\n'
            '{"op":"add","dtype":"uint8","x":[9],"y":[9]}\n')
    serve = [sys.executable, "-m", "repro_torch.launch.serve"]
    t0 = time.perf_counter()
    proc = subprocess.run(serve + ["--pim-serve", "--pim-window-ms", "25"],
                          input=reqs, cwd=root, env=env,
                          capture_output=True, text=True, timeout=300)
    s = time.perf_counter() - t0
    lines = [json.loads(l) for l in proc.stdout.splitlines()]
    if proc.returncode != 0 or len(lines) != 4 or \
            lines[0].get("result") != [4, 6] or \
            (lines[1].get("q"), lines[1].get("r")) != ([3], [2]) or \
            "error" not in lines[2] or lines[3].get("result") != [18] or \
            "pim-serve:" not in proc.stderr:
        raise AssertionError(f"serve CLI: exit {proc.returncode}, "
                             f"{proc.stdout[-500:]}{proc.stderr[-1500:]}")
    stats = next(l for l in proc.stderr.splitlines() if "pim-serve:" in l)
    summary = [json.loads(l) for l in proc.stderr.splitlines()
               if l.startswith("{") and '"summary"' in l]
    if len(summary) != 1 or summary[0].get("type") != "summary" or \
            summary[0].get("degraded_groups") != 0 or \
            summary[0].get("shed_requests") != 0 or \
            summary[0].get("errors") != 1:
        raise AssertionError(f"serve CLI summary: {summary}")
    print(f"serve CLI --pim-serve: {gpu}; exit 0 in {s:.3f} s, four answers "
          f"right; summary degraded_groups 0, shed_requests 0, errors 1 (the "
          f"malformed line); {stats}", flush=True)
    t0 = time.perf_counter()
    proc = subprocess.run(serve + ["--pim", "fp_add", "--pim-dtype",
                                   "float32", "--pim-rows", str(16 << 20),
                                   "--pim-requests", "4"],
                          cwd=root, env=env, capture_output=True, text=True,
                          timeout=600)
    s = time.perf_counter() - t0
    out = proc.stdout.strip().splitlines()
    n_dev = torch.cuda.device_count()
    if proc.returncode != 0 or not out or \
            f"on {n_dev} device(s)" not in out[-1]:
        raise AssertionError(f"serve CLI --pim: exit {proc.returncode}, "
                             f"{proc.stdout[-500:]}{proc.stderr[-1500:]}")
    print(f"serve CLI --pim fp_add float32: {gpu}; exit 0 in {s:.3f} s; "
          f"{out[-1]}", flush=True)


def serving_phase(gpu: str) -> dict:
    """The serving phase (after the verified phase): batched PIM serving
    (``runtime.pim_batch``, ``launch.serve``) on the card.

    1. The reference's serving mix, 8 requests of each of 8 programs at
       ``SERVE_ROWS`` rows (64 Mi rows), batched and serial in turns,
       three rounds, then each profiled; nothing degraded, shed or failed.
    2. The same mix at ``SERVE_SMALL_ROWS`` (the reference's 1024): one
       launch a group batched against one a request serial.
    3. The JSON-lines server in process on ``STREAM_REQUESTS`` requests
       of ``STREAM_ROWS`` rows: B1 io, B2 and B3 launched, every answer
       right and in order, the trace's spans.
    4. Step 1's mix under ``FaultModel(seed=7, p_flip=5e-4)`` and
       ``verify=True`` (the reference's ``serve/mixed_8op_faulty``), two
       rounds: bit-exact, retries, B6 launched with every B1 launch,
       nothing shed; a group whose retries run out is rerun per request
       on the card and counted.
    5. The CLI as a subprocess: ``--pim-serve`` and ``--pim``.

    Returns the launches of each step."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.kernels import ops
    from repro_torch.runtime import pim_batch
    from repro_torch.runtime.faults import FaultModel
    ran = {}
    big = serving_mix(SERVE_ROWS)
    clean = _serve_turns(big, f"mix rows={SERVE_ROWS}", gpu,
                         ("slot_scan_fused",))
    ran["mix"] = clean["launches"]
    small = _serve_turns(serving_mix(SERVE_SMALL_ROWS, seed=SEED + 13),
                         f"mix rows={SERVE_SMALL_ROWS}", gpu,
                         ("slot_scan_fused",), profile=False)
    ran["mix_small"] = small["launches"]
    if small["launches"]["batched"]["slot_scan_fused"] != 8 or \
            small["launches"]["serial"]["slot_scan_fused"] != len(big):
        raise AssertionError(f"coalescing: launches {small['launches']}")
    ran["stream"] = _stream_phase(gpu)

    fm = FaultModel(seed=7, p_flip=5e-4)
    best = min(clean["walls"]["batched"])
    for rnd in range(2):
        ops.drain_health()
        rt = pim_batch.BatchRuntime(pin_cap=16)

        def faulty():
            with pim.options(faults=fm, verify=True):
                preps = [pim.prepare(op, x, y) for op, x, y, _ in big]
            try:
                return rt.execute(preps)
            finally:
                rt.close()
        results, launches, s = _counted(
            "serve mix faults+verify", ("slot_scan_fused", "check_words"),
            faulty)
        st = rt.stats
        # a chunk whose flips outlast the policy's retries degrades its
        # group to per-request runs on the card (the ladder, as in the
        # reference); every answer must still be right, none shed
        if not all(r.error is None and _same_value(r.value, t[3])
                   for r, t in zip(results, big)) or st.retries < 1 or \
                st.shed_requests or \
                launches["check_words"] != launches["slot_scan_fused"]:
            raise AssertionError(f"serve mix faults+verify: launches "
                                 f"{launches}, stats {st.as_dict()}")
        degraded = sorted({t[0] for r, t in zip(results, big)
                           if r.degraded})
        print(f"serve mix rows={SERVE_ROWS} faults+verify round {rnd}: "
              f"{gpu}; "
              f"FaultModel(seed=7, p_flip=5e-4), verify=True; bit-exact vs "
              f"numpy; faults_detected {st.faults_detected}, "
              f"faults_corrected {st.faults_corrected}, retries "
              f"{st.retries}, remapped_rows {st.remapped_rows}, degraded "
              f"groups {st.degraded_groups} {degraded} (rerun per request "
              f"on the card), shed {st.shed_requests}; launches "
              f"{launches}, plain calls 0; wall {s * 1e3:.3f} ms = "
              f"{s / best:.6f}x the clean batched best", flush=True)
        ran["faulty"] = launches
    _cli_phase(gpu)
    return ran


#: Rows a request of the warm-start phase: the reference's serving mix at
#: its small size (``benchmarks/run.py``).
WARM_ROWS = 1024
#: Where the warm-start and tune phases keep their trees, caches and
#: tuned.json (inside the checkout, under the ignored build directory).
PHASE_DIR = Path(__file__).resolve().parent / "build" / "chip_smoke_a11"
#: Families and rows of the tune phase's quick sweep.
TUNE_FAMILIES = ("add:16", "fp_add:fp16")
TUNE_ROWS = 1 << 20


def _warm_traffic(rows: int = WARM_ROWS, seed: int = SEED + 21):
    """The warm-start phase's requests: the serving mix (uint16 and fp16
    add, sub, mul and div, 8 requests each) at ``rows`` rows, one
    ``slots-static`` fp32 add (B2) and one ``dense`` uint16 add (B3).
    Returns (JSON lines, numpy's answer of each)."""
    rng = np.random.default_rng(seed)

    def enc(v):
        return [float(t) for t in v] if v.dtype.kind == "f" else \
            [int(t) for t in v]
    reqs = [({"op": op, "dtype": x.dtype.name, "x": enc(x), "y": enc(y)},
             want) for op, x, y, want in serving_mix(rows, seed=seed)]
    f32 = [uniform_signed(rng, rows, np.float32) for _ in range(2)]
    u = [rng.integers(0, 1 << 16, rows).astype(np.uint16) for _ in range(2)]
    reqs.insert(5, ({"op": "fp_add", "dtype": "float32", "x": enc(f32[0]),
                     "y": enc(f32[1]), "schedule": "slots-static"},
                    f32[0] + f32[1]))
    reqs.insert(40, ({"op": "add", "dtype": "uint16", "x": enc(u[0]),
                      "y": enc(u[1]), "schedule": "dense"},
                     _u16_want("add", *u)))
    return [json.dumps(r) for r, _ in reqs], [w for _, w in reqs]


def first_line_then_rest(proc, timeout: float) -> tuple:
    """The first line ``proc`` writes to its stdout, the ``perf_counter``
    time it came, and the rest of its stdout at its exit.  The pipe must
    be unbuffered bytes (``bufsize=0``): ``communicate`` reads the pipe's
    descriptor, and a buffered ``readline`` would have read past the
    first line what ``communicate`` then never sees."""
    if not isinstance(proc.stdout, io.RawIOBase):
        raise ValueError("first_line_then_rest needs a bufsize=0 byte pipe")
    first = proc.stdout.readline().decode()
    t_first = time.perf_counter()
    return first, t_first, proc.communicate(timeout=timeout)[0].decode()


def _replica(tree: Path, cache: Path, lines_file: Path, label: str) -> dict:
    """One ``python -m repro_torch.launch.serve --pim-serve
    --pim-cache-dir`` replica run from ``tree`` (its own build
    directory) on the requests in ``lines_file``: the time from its start
    to its first answer, its wall, its answers and its stderr's
    ``warm_start`` and ``summary`` lines."""
    env = dict(os.environ)
    env["PYTHONPATH"] = str(tree / "src")
    err_file = PHASE_DIR / f"{label}.stderr"
    t0 = time.perf_counter()
    with open(lines_file) as inp, open(err_file, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--pim-serve",
             "--pim-cache-dir", str(cache)], cwd=tree, env=env, stdin=inp,
            stdout=subprocess.PIPE, stderr=err, bufsize=0)
        try:
            first, t_first, rest = first_line_then_rest(proc, 600)
            t_first -= t0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    stderr = err_file.read_text()
    if proc.returncode != 0:
        raise AssertionError(f"warm-start {label}: exit {proc.returncode}, "
                             f"{stderr[-2000:]}")
    jl = [json.loads(l) for l in stderr.splitlines() if l.startswith("{")]
    (warm,) = [l for l in jl if l.get("type") == "warm_start"]
    (summary,) = [l for l in jl if l.get("type") == "summary"]
    answers = []
    for i, line in enumerate((first + rest).splitlines()):
        try:
            answers.append(json.loads(line))
        except json.JSONDecodeError:
            raise AssertionError(
                f"warm-start {label}: line {i} of its stdout is not JSON: "
                f"{line[:500]!r}; stderr ends {stderr[-1500:]!r}") from None
    return {"first_s": t_first, "wall_s": wall, "answers": answers,
            "warm": warm, "summary": summary}


def warm_start_phase(gpu: str) -> dict:
    """Two ``--pim-serve`` replicas on the card share one fresh
    ``--pim-cache-dir``, each run from a copy of ``src/repro_torch`` in a
    tree of its own whose build directory is emptied before it starts: the
    cold one levelizes, packs and runs ``nvcc`` and writes every artifact
    through; the warm one must serve the same requests bit-exactly with
    no levelize, no packing, no ``nvcc`` and no disk error, its B1, B2 and
    B3 launched and no plain version.  Returns the warm replica's
    summary."""
    from repro_torch.runtime.artifact_cache import ArtifactCache
    shutil.rmtree(PHASE_DIR, ignore_errors=True)
    tree, cache = PHASE_DIR / "tree", PHASE_DIR / "cache"
    shutil.copytree(Path(__file__).resolve().parent / "src" / "repro_torch",
                    tree / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    lines, wants = _warm_traffic()
    lines_file = PHASE_DIR / "requests.jsonl"
    lines_file.write_text("\n".join(lines) + "\n")
    runs = {}
    for label in ("cold", "warm"):
        shutil.rmtree(tree / "build", ignore_errors=True)
        r = runs[label] = _replica(tree, cache, lines_file, label)
        wrong = [i for i, (a, w) in enumerate(zip(r["answers"], wants))
                 if not _right_answer(a, w)]
        if len(r["answers"]) != len(lines) or wrong:
            raise AssertionError(f"warm-start {label}: {len(r['answers'])} "
                                 f"answers for {len(lines)} requests, "
                                 f"wrong at {wrong[:5]}")
        c, k = r["summary"]["cache"], r["summary"]["kernels"]
        warm = {n: r["warm"][n] for n in ("schedules", "streams",
                                          "executables", "skipped", "us")}
        print(f"warm-start {label} replica: {gpu}; {len(lines)} requests of "
              f"{WARM_ROWS} rows, every answer bit-exact vs numpy; first "
              f"answer {r['first_s']:.3f} s after start, wall "
              f"{r['wall_s']:.3f} s; levelized {c['levelized']}, packed "
              f"{c['packed']}, disk_hits {c['disk_hits']}, disk_misses "
              f"{c['disk_misses']}, disk_writes {c['disk_writes']}, "
              f"disk_errors {c['disk_errors']}; nvcc runs {k['nvcc_runs']} "
              f"({k['nvcc_s']:.3f} s); warm_start {warm}; "
              f"launches {k['launches']}, plain calls {k['plain'] or 0}",
              flush=True)
    cold, warm = (runs[n]["summary"] for n in ("cold", "warm"))
    cc, wc = cold["cache"], warm["cache"]
    wk = warm["kernels"]
    b123 = ("slot_scan_fused", "slots_static_fused", "level_gather_fused")
    if not (cc["levelized"] > 0 and cc["disk_writes"] > 0 and
            cold["kernels"]["nvcc_runs"] > 0):
        raise AssertionError(f"warm-start cold replica: {cc}, "
                             f"{cold['kernels']}")
    if wc["levelized"] or wc["packed"] or wk["nvcc_runs"] or \
            wc["disk_hits"] <= 0 or wc["disk_errors"] or wk["plain"] or \
            not all(wk["launches"].get(e, 0) > 0 for e in b123):
        raise AssertionError(f"warm-start warm replica: {wc}, {wk}")
    sizes = ArtifactCache(cache).tier_bytes()
    print(f"warm-start cache on disk: {gpu}; bytes by tier {sizes}; first "
          f"answer cold {runs['cold']['first_s']:.3f} s vs warm "
          f"{runs['warm']['first_s']:.3f} s", flush=True)
    return warm


def tune_phase(gpu: str) -> dict:
    """The autotuner's quick ``cuda`` sweep of two families at
    ``TUNE_ROWS`` rows in this process (each candidate's wall and kernel
    ms printed), its tuned.json installed in a fresh process through a
    cache directory, which must overlay the plans exactly where the
    winners say and leave an untuned family alone, and give bit-exact
    results under the winners (against numpy, and against the hand
    defaults).  Returns the tuned.json document."""
    from repro_torch.runtime import tune
    t0 = time.perf_counter()
    doc = tune.tune(TUNE_FAMILIES, backend="cuda", rows=TUNE_ROWS, reps=3,
                    quick=True)
    s = time.perf_counter() - t0
    for e in doc["entries"]:
        for c in e["candidates"]:
            if c["us"] is None:
                line = c["error"]
            else:
                k = c["kernel_ms"]
                line = (f"wall {c['us'] / 1e3:.3f} ms (spread "
                        f"{c['spread_us'] / 1e3:.3f} ms), kernel "
                        f"{'not measured' if k is None else f'{k:.4f} ms'}")
            print(f"tune {e['family']} rows={TUNE_ROWS} "
                  f"{c['overrides'] or '(default)'}: {gpu}; {line}",
                  flush=True)
        if e["us"] > e["default_us"]:
            raise AssertionError(f"tune {e['family']}: winner {e}")
        print(f"tune {e['family']}: winner {e['overrides'] or '(defaults)'} "
              f"wall {e['us'] / 1e3:.3f} ms vs default "
              f"{e['default_us'] / 1e3:.3f} ms (spread "
              f"{e['default_spread_us'] / 1e3:.3f} ms)", flush=True)
    tune_dir = PHASE_DIR / "tuned"
    shutil.rmtree(tune_dir, ignore_errors=True)
    tune.save(doc, str(tune_dir))
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src")
    proc = subprocess.run(
        [sys.executable, "-c", _TUNED_CHECK, str(tune_dir), str(TUNE_ROWS)]
        + list(TUNE_FAMILIES), cwd=root, env=env, capture_output=True,
        text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"tuned.json in a fresh process: exit "
                             f"{proc.returncode}, {proc.stderr[-2000:]}")
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"tune phase: {gpu}; quick cuda sweep of {list(TUNE_FAMILIES)} "
          f"in {s:.3f} s; tuned.json installed in a fresh process: "
          f"{got['installed']} entries, plans overlaid as the winners say "
          f"{got['plans']}, results bit-exact under the winners (vs numpy "
          f"and the hand defaults)", flush=True)
    return doc


#: Run in a fresh process by :func:`tune_phase`: install the tuned.json of
#: a cache directory through ``pim.configure(cache_dir=)``, check each
#: family's plan against its winner and the untuned ``mul:16`` against the
#: hand defaults, and run each family under its winner and under
#: ``tuned=False`` against numpy.  Prints one JSON line.
_TUNED_CHECK = """
import json, sys
import numpy as np
from repro_torch import pim_ufunc as pim
from repro_torch.kernels import plan as kplan
from repro_torch.runtime import tune
cache_dir, rows, families = sys.argv[1], int(sys.argv[2]), sys.argv[3:]
with open(cache_dir + "/tuned.json") as f:
    doc = json.load(f)
pim.configure(cache_dir=cache_dir)
rng = np.random.default_rng(5)
plans = {}
for e in doc["entries"]:
    op, kw = tune.parse_family(e["family"])
    if "width" in kw:
        x = rng.integers(0, 1 << 16, rows).astype(np.uint16)
        y = rng.integers(0, 1 << 16, rows).astype(np.uint16)
        want = x.astype(np.uint64) + y
    else:                     # mid-range fp16: every sum 0 or normal
        x, y = ((rng.integers(10, 21, rows).astype(np.uint16) << 10 |
                 rng.integers(0, 1 << 10, rows).astype(np.uint16)
                 ).view(np.float16) for _ in range(2))
        b = (x + y).view(np.uint16).copy()
        b[(b & 0x7C00) == 0] &= 0x8000
        want = b.view(np.float16)
    assert op in ("add", "fp_add"), op
    prep = pim.prepare(op, x, y)
    ov = e["overrides"]
    stock = kplan.BACKENDS["cuda"]
    for f in kplan.TUNABLE_FIELDS:
        assert getattr(prep.plan.backend, f) == ov.get(f, getattr(stock, f)), f
    assert prep.plan.schedule == ov.get("schedule", kplan.DEFAULT_SCHEDULE)
    if "chunk_rows" in ov:
        assert prep.plan.chunk_rows == ov["chunk_rows"]
    got = prep.run()
    with pim.options(tuned=False):
        dflt = pim.prepare(op, x, y).run()
    assert got.dtype == want.dtype and got.view(np.uint8).tobytes() == \
        want.view(np.uint8).tobytes(), e["family"]
    assert got.view(np.uint8).tobytes() == dflt.view(np.uint8).tobytes()
    plans[e["family"]] = {"schedule": prep.plan.schedule,
                          **{f: getattr(prep.plan.backend, f)
                             for f in ov if f != "schedule"}}
x = np.arange(64, dtype=np.uint16)
p = pim.prepare("mul", x, x)
assert p.plan.schedule == kplan.DEFAULT_SCHEDULE and \
    p.plan.backend == kplan.BACKENDS["cuda"]
print(json.dumps({"installed": len([e for e in doc["entries"]
                                     if e["overrides"]]), "plans": plans}))
"""


# --------------------------------------------------------------------------
# LM decode serving (ROADMAP A13): qwen3-8b at full width
# --------------------------------------------------------------------------

LM_ARCH = "qwen3-8b"
#: Its parameters, from ``jax.eval_shape`` over the reference's
#: ``init_model``.
LM_PARAMS = 8_190_735_360
#: The reference's serving defaults: batch, prompt and generated tokens.
LM_SERVE = (4, 32, 16)
#: The larger serving run and the prefill that takes the chunked path.
LM_BIG = (32, 512, 64)
LM_PREFILL = (4, 1024)
#: The reference's bound on decode against forward (tests/test_archs.py).
DECODE_TOL = 0.2
#: Card against CPU on the reduced model, one set of weights: a bfloat16
#: logit of magnitude up to 4 rounds to 2**-6; the card's and the CPU's
#: matmuls sum in other orders, so a few ulps (the reference's
#: prefill-against-forward bound).
CARD_CPU_TOL = 0.05
LM_DECODES = 4
PROFILE_STEPS = 3
#: Further runs of the serving defaults' loop, for the spread of its
#: median step: on the phase's model, and the CLI in a fresh process.
LM_REPEATS = 3


def _decode_vs_forward(cfg, model, toks, cache_dtype, vision=None) -> tuple:
    """Teacher-force ``toks`` [B, T] through ``decode_step``, then one
    ``forward`` over them (``vision`` into both where given): the max
    |logit difference| at each position, the share of positions (rows x
    T) whose argmax agrees and forward's largest |logit|."""
    from repro_torch.models import model as M
    b, t = toks.shape
    caches = M.init_caches(cfg, b, t, device=toks.device, dtype=cache_dtype)
    batch = {"tokens": toks}
    if vision is not None:
        batch["vision"] = vision
    dec = []
    with torch.no_grad():
        for i in range(t):
            lg, caches = M.decode_step(cfg, model, caches, toks[:, i], i,
                                       vision=vision)
            dec.append(lg.float())
        full = M.forward(cfg, model, batch, remat=False)[0]
    dec = torch.stack(dec, 1)
    full = full.float()
    err = (dec - full).abs().amax(dim=(0, 2)).cpu().numpy()
    agree = float((dec.argmax(-1) == full.argmax(-1)).float().mean())
    return err, agree, float(full.abs().max())


def grow_caches(caches, n: int) -> list:
    """Prefill's caches with ``n`` more positions on every sequence axis
    (full attention's keys and values, MLA's latents); a local ring, a
    recurrent state and a cross layer's empty cache keep their size."""
    from repro_torch.models import model as M
    return [c if M.seq_len(c) is None else
            {k: torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2) + (0, n))
             for k, v in c.items()} for c in caches]


def _prefill_then_decode(cfg, model, toks, n_dec: int, vision=None) -> list:
    """``prefill`` over all but the last ``n_dec`` tokens, its caches
    grown by ``n_dec`` positions, then ``n_dec`` decode steps (``vision``
    into each where given): the logits of each, on the host."""
    from repro_torch.models import model as M
    s = toks.shape[1] - n_dec
    batch = {"tokens": toks[:, :s]}
    if vision is not None:
        batch["vision"] = vision
    with torch.no_grad():
        logits, caches = M.prefill(cfg, model, batch)
        caches = grow_caches(caches, n_dec)
        out = [logits.float().cpu()]
        for t in range(s, s + n_dec):
            logits, caches = M.decode_step(cfg, model, caches, toks[:, t], t,
                                           vision=vision)
            out.append(logits.float().cpu())
    return out


def cache_bytes(cfg, kind: str, batch: int, pos: int) -> int:
    """The bytes one layer's decode step at position ``pos`` must move in
    its cache (bfloat16, float32 states): the keys and values (or MLA's
    latents) of positions 0..pos read and the new ones written; a local
    ring's valid slots and its positions read and one slot written; a
    recurrent or RWKV state read and written; nothing for a cross
    layer."""
    kv = 2 * cfg.n_kv_heads * cfg.hd * 2           # one position's k and v
    if kind in ("attn", "moe", "moe_dense"):
        if cfg.mla is not None:
            kv = (cfg.mla.kv_lora + cfg.mla.rope_head_dim) * 2
        return batch * kv * (pos + 2)
    if kind == "local":
        return batch * (kv * (min(pos + 1, cfg.window) + 1)
                        + cfg.window * 4)
    if kind == "recurrent":
        dr = cfg.d_rnn or cfg.d_model
        return 2 * batch * (dr * 4 + 3 * dr * 2)
    if kind == "rwkv":
        hd = cfg.d_model // cfg.n_heads
        return 2 * batch * (cfg.n_heads * hd * hd * 4 + 2 * cfg.d_model * 2)
    if kind == "cross":
        return 0
    raise ValueError(kind)


def decode_bound(model, cfg, batch: int, pos: int) -> tuple:
    """The least time (ms) of one decode step at ``batch`` rows and
    position ``pos``, as (bytes, operations): every weight but the
    embedding read once, the ``batch`` embedding rows and each layer's
    :func:`cache_bytes` at the HBM rate; the weights' multiply-adds (two
    operations each a row) at the bf16 peak.  A vision model also reads
    its image embeddings and runs, every step, their frontend matmul and
    each cross layer's key and value projections and attention over
    them."""
    from repro_torch.models import model as M
    w = {n: p for n, p in model.named_parameters() if n != "embed"}
    nbytes = sum(p.numel() * p.element_size() for p in w.values())
    nbytes += batch * cfg.d_model * model["embed"].element_size()
    nbytes += sum(cache_bytes(cfg, kind, batch, pos)
                  for kind in M.layer_kinds(cfg))
    ops = 2 * batch * sum(p.numel() for p in w.values())
    if cfg.frontend == "vision":
        sv, kvd = cfg.vision_seq, cfg.n_kv_heads * cfg.hd
        nbytes += batch * sv * cfg.frontend_dim * 4
        n_cross = M.layer_kinds(cfg).count("cross")
        ops += 2 * batch * sv * cfg.frontend_dim * cfg.d_model
        ops += n_cross * (2 * 2 * batch * sv * cfg.d_model * kvd
                          + 2 * 2 * batch * cfg.n_heads * sv * cfg.hd)
    return nbytes / H100.hbm_bw * 1e3, ops / H100.peak_bf16_flops * 1e3


def decode_bound_ms(model, cfg, batch: int, pos: int) -> float:
    """The larger of :func:`decode_bound`'s two times."""
    return max(decode_bound(model, cfg, batch, pos))


def _serve_line(text: str) -> dict:
    """The numbers of ``serve_llm``'s ``decode steps`` line."""
    import re
    m = re.search(r"decode steps on \S+: (\d+), first ([\d.]+) ms, median "
                  r"of the rest ([\d.]+) ms, wall ([\d.]+) ms", text)
    if m is None:
        raise AssertionError(f"lm serve: no decode-steps line in {text!r}")
    n, first, median, wall = m.groups()
    return {"steps": int(n), "first_ms": float(first),
            "median_ms": float(median), "wall_ms": float(wall)}


def lm_phase(gpu: str) -> None:
    """LM decode serving of ``qwen3-8b`` at full width on the card (see
    the module docstring); raises on any failed check.  Every decode
    step's attention runs the decode-attention kernel
    (``csrc/decode_attn.cu`` through ``kernels.attention.decode_attn``),
    in bfloat16 and in the float32 checks alike; the profiled steps count
    it."""
    import contextlib
    import copy
    import gc
    import threading
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = registry.get(LM_ARCH)
    dev = "cuda"
    flags = (f"allow_tf32 {torch.backends.cuda.matmul.allow_tf32}, "
             f"bf16 reduced-precision reduction "
             f"{torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.LM(cfg, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"lm build: {gpu}; {cfg.name} at full width ({cfg.n_layers} "
          f"layers, d_model {cfg.d_model}, heads {cfg.n_heads}/"
          f"{cfg.n_kv_heads}, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}): {n} parameters, {nbytes} B on {dev}, init "
          f"{init_s:.3f} s, max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B; {flags}", flush=True)
    if n != LM_PARAMS:
        raise AssertionError(f"lm build: {n} parameters, want {LM_PARAMS}")

    # serving through the entry point, the reference's defaults
    b, p, g = LM_SERVE
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        gen = serve.main(["--arch", LM_ARCH, "--batch", str(b),
                          "--prompt-len", str(p), "--gen", str(g),
                          "--seed", str(SEED)])
    main_s = time.perf_counter() - t0
    st = _serve_line(buf.getvalue())
    prompt = torch.randint(0, cfg.vocab, (b, p), dtype=torch.int32,
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(SEED)).cpu().numpy()
    bound = float(np.median([decode_bound_ms(model, cfg, b, t)
                             for t in range(1, p + g - 1)]))
    print(f"lm serve: {gpu}; serve.main --arch {LM_ARCH} --batch {b} "
          f"--prompt-len {p} --gen {g}: tokens {gen.shape}, "
          f"{st['steps']} steps, wall {st['wall_ms']:.3f} ms = "
          f"{b * (p + g) / st['wall_ms'] * 1e3:.3f} tok/s (all "
          f"{b * (p + g)} tokens) = {b * g / st['wall_ms'] * 1e3:.3f} "
          f"generated tok/s; first step {st['first_ms']:.3f} ms, median "
          f"step {st['median_ms']:.3f} ms (CUDA events) against its bound "
          f"{bound:.6f} ms ({st['median_ms'] / bound:.3f}x); serve.main "
          f"with the model's init {main_s:.3f} s", flush=True)
    if gen.shape != (b, p + g) or gen.min() < 0 or gen.max() >= cfg.vocab \
            or not np.array_equal(gen[:, :p], prompt):
        raise AssertionError(f"lm serve: tokens {gen.shape} in "
                             f"[{gen.min()}, {gen.max()}], prompt kept "
                             f"{np.array_equal(gen[:, :p], prompt)}")

    # the spread of the median step: the loop again in this process (with
    # the cyclic collector's runs during it), and the CLI in a fresh one
    reps, collections = [], []
    for _ in range(LM_REPEATS):
        ms, runs = [], []
        cb = lambda phase, info: runs.append(info["generation"]) \
            if phase == "start" else None
        gc.callbacks.append(cb)
        try:
            serve.generate(cfg, model, torch.from_numpy(prompt).to(dev), g,
                           step_ms=ms)
        finally:
            gc.callbacks.remove(cb)
        reps.append(round(float(np.median(ms[1:])), 3))
        collections.append(len(runs))
    torch.cuda.empty_cache()            # room for the CLI's own model
    env = dict(os.environ)
    env["PYTHONPATH"] = str(Path(__file__).resolve().parent / "src")
    cli = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", LM_ARCH,
         "--batch", str(b), "--prompt-len", str(p), "--gen", str(g),
         "--seed", str(SEED)], env=env, capture_output=True, text=True,
        timeout=600)
    if cli.returncode:
        raise AssertionError(f"lm serve CLI: exit {cli.returncode}: "
                             f"{cli.stderr[-2000:]}")
    fresh = _serve_line(cli.stdout)
    print(f"lm serve spread: {gpu}; the loop {LM_REPEATS} more times in "
          f"this process: median step {reps} ms (cyclic gc runs during "
          f"each {collections}, threads alive {threading.active_count()}); "
          f"the CLI in a fresh process: median step "
          f"{fresh['median_ms']:.3f} ms, first {fresh['first_ms']:.3f} ms, "
          f"wall {fresh['wall_ms']:.3f} ms", flush=True)

    # decode against forward on the served tokens
    toks = torch.from_numpy(gen).to(dev)
    err, agree, _ = _decode_vs_forward(cfg, model, toks, torch.bfloat16)
    print(f"lm decode-vs-forward: {gpu}; bf16, {toks.shape[0]}x"
          f"{toks.shape[1]} tokens: max |dlogit| {float(err.max()):.6f} "
          f"(bound {DECODE_TOL}), argmax agrees at {agree:.6f} of the "
          f"positions; per position {np.round(err, 4).tolist()}", flush=True)
    if not float(err.max()) < DECODE_TOL:
        raise AssertionError(f"lm decode-vs-forward: {float(err.max())} "
                             f">= {DECODE_TOL}")

    # the card against the CPU, reduced, one set of weights
    rcfg = cfg.reduced()
    cpu = M.LM(rcfg, device="cpu",
               generator=torch.Generator().manual_seed(SEED))
    card = copy.deepcopy(cpu).to(dev)
    rt = torch.from_numpy(np.random.default_rng(SEED).integers(
        0, rcfg.vocab, (2, 16 + LM_DECODES)))
    want = _prefill_then_decode(rcfg, cpu, rt, LM_DECODES)
    got = _prefill_then_decode(rcfg, card, rt.to(dev), LM_DECODES)
    errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
    print(f"lm card-vs-cpu: {gpu}; {rcfg.name} reduced (d_model "
          f"{rcfg.d_model}, {rcfg.n_layers} layers), prefill of 16 then "
          f"{LM_DECODES} decode steps: max |dlogit| "
          f"{[round(e, 6) for e in errs]} (bound {CARD_CPU_TOL})",
          flush=True)
    if not max(errs) < CARD_CPU_TOL:
        raise AssertionError(f"lm card-vs-cpu: {errs}")

    # the larger serving run, and a prefill on the chunked path
    b2, p2, g2 = LM_BIG
    prompt = torch.randint(0, cfg.vocab, (b2, p2), dtype=torch.int32,
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(SEED + 1))
    step_ms = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    big = serve.generate(cfg, model, prompt, g2, step_ms=step_ms).cpu()
    wall = time.perf_counter() - t0
    kv = cfg.n_layers * 2 * b2 * (p2 + g2) * cfg.n_kv_heads * cfg.hd * 2
    bound = float(np.median([decode_bound_ms(model, cfg, b2, t)
                             for t in range(1, p2 + g2 - 1)]))
    med = float(np.median(step_ms[1:]))
    print(f"lm serve big: {gpu}; batch {b2}, prompt {p2}, gen {g2} "
          f"(serve.generate, KV cache {kv} B): tokens {tuple(big.shape)}, "
          f"wall {wall * 1e3:.3f} ms = {b2 * (p2 + g2) / wall:.3f} tok/s "
          f"(all tokens) = {b2 * g2 / wall:.3f} generated tok/s; first step "
          f"{step_ms[0]:.3f} ms, median step {med:.3f} ms against its "
          f"bound {bound:.6f} ms ({med / bound:.3f}x); max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    if tuple(big.shape) != (b2, p2 + g2) or int(big.min()) < 0 or \
            int(big.max()) >= cfg.vocab:
        raise AssertionError(f"lm serve big: {tuple(big.shape)}")
    del big
    bp, sp = LM_PREFILL
    ptoks = torch.from_numpy(np.random.default_rng(SEED + 2).integers(
        0, cfg.vocab, (bp, sp))).to(dev)
    ms = []
    with torch.no_grad():
        for _ in range(2):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            logits, caches = M.prefill(cfg, model, {"tokens": ptoks})
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
        full = M.forward(cfg, model, {"tokens": ptoks})[0][:, -1]
    perr = float((logits.float() - full.float()).abs().max())
    ok = (logits.shape == (bp, cfg.vocab) and len(caches) == cfg.n_layers
          and caches[0]["k"].shape == (bp, sp, cfg.n_kv_heads, cfg.hd)
          and bool(torch.isfinite(logits.float()).all()))
    layer_w = sum(t.numel() for name, t in model.named_parameters()
                  if name not in ("embed", "lm_head"))
    flop = (2 * layer_w * bp * sp + 2 * cfg.d_model * cfg.vocab * bp
            + cfg.n_layers * 4 * bp * sp * (sp + 1) // 2 * cfg.n_heads
            * cfg.hd)
    print(f"lm prefill: {gpu}; {bp}x{sp} tokens ({sp // 512} chunks of "
          f"512 queries): {ms[0]:.3f} ms first, {ms[1]:.3f} ms second = "
          f"{bp * sp / ms[1] * 1e3:.3f} tok/s; operations bound "
          f"{flop / H100.peak_bf16_flops * 1e3:.6f} ms (bf16 "
          f"{H100.peak_bf16_flops / 1e12:g} TFLOP/s); last logits "
          f"against forward max |d| {perr:.6f} (bound {CARD_CPU_TOL})",
          flush=True)
    if not ok or not perr < CARD_CPU_TOL:
        raise AssertionError(f"lm prefill: shapes ok {ok}, {perr}")
    del logits, caches, full

    # the decode step's profile at the serving batch
    caches = M.init_caches(cfg, b, p + g, device=dev)
    tok = toks[:, p]

    def steps():
        for t in range(p, p + PROFILE_STEPS):
            M.decode_step(cfg, model, caches, tok, t)

    steps()
    torch.cuda.synchronize()
    from repro_torch.kernels import pim_exec
    from repro_torch.runtime import telemetry
    telemetry.REGISTRY.drain("lm.decode_attn.")
    pim_exec.LAUNCHES["decode_attn"] = 0
    _, wall, st = device_timeline(steps)
    calls = telemetry.REGISTRY.drain("lm.decode_attn.")
    launches = pim_exec.LAUNCHES["decode_attn"]
    want = PROFILE_STEPS * cfg.n_layers
    print(f"lm decode attention: {PROFILE_STEPS} steps of {cfg.n_layers} "
          f"layers at batch {b}: counters {calls}, {launches} launches",
          flush=True)
    if calls != {"lm.decode_attn.kernel": want} or launches != want:
        raise AssertionError(f"lm decode attention: {calls}, {launches}")
    if st is None:
        print(f"lm profile: {gpu}; {PROFILE_STEPS} decode steps, wall "
              f"{wall * 1e3:.3f} ms; the profiler shows no device time "
              "(not measured)", flush=True)
    else:
        top = "; ".join(f"{name[:60]} {us / 1e3:.3f} ms x{k}"
                        for name, us, k in st["top"][:5])
        print(f"lm profile: {gpu}; {PROFILE_STEPS} decode steps at batch "
              f"{b}: wall {wall * 1e3:.3f} ms under the profiler, device "
              f"busy {st['busy_ms']:.3f} ms = {st['busy_share']:.6f}; "
              f"{st['kernels'] / PROFILE_STEPS:.1f} kernels a step "
              f"({st['kernels'] / PROFILE_STEPS / cfg.n_layers:.1f} a "
              f"layer), {st['kernel_ms'] / PROFILE_STEPS:.3f} kernel ms a "
              f"step; top 5: {top}", flush=True)
    del caches

    # the same check in float32 weights and caches: bfloat16 rounding or
    # a fault?
    model.float()
    err32, agree32, _ = _decode_vs_forward(cfg, model, toks,
                                           torch.float32)
    print(f"lm decode-vs-forward: {gpu}; f32 weights and caches ({flags}): "
          f"max |dlogit| {float(err32.max()):.6f}, argmax agrees at "
          f"{agree32:.6f}; per position {np.round(err32, 5).tolist()}",
          flush=True)
    if not float(err32.max()) < DECODE_TOL:
        raise AssertionError(f"lm decode-vs-forward f32: {err32.max()}")
    del model
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# The other LM families (ROADMAP A14) at full width
# --------------------------------------------------------------------------

#: Each family: its arch, the layers run (None: all; the rest are cut
#: from the end, only where one 80 GB card forces it: the bf16 weights of
#: the cut models stay under 27 GB, so their float32 check fits) and its
#: parameters at that depth, from ``jax.eval_shape`` over the reference's
#: ``init_model`` (``tests/test_torch_lm_families.py`` holds them).
FAMILIES = (
    ("recurrentgemma-2b", None, 3_549_795_840),
    ("rwkv6-1.6b", None, 1_583_892_480),
    ("hubert-xlarge", None, 1_260_360_960),
    ("qwen3-moe-235b-a22b", 4, 11_195_683_840),
    ("deepseek-v2-236b", 4, 13_302_912_000),
    ("llama-3.2-vision-90b", 10, 10_720_813_058),
)
#: hubert's forward: frames [batch, frames, frontend_dim].
HUBERT_FRAMES = (4, 1024)
#: The long check of the two recurrent families: batch, prefill length,
#: decode steps, and the forward they are held against (multiples of 512
#: and 64, so neither the attention's nor the WKV's chunking refuses it).
LONG = (2, 2560, 4, 3072)
#: The MoE models' decode-against-forward check runs at the reference's
#: own capacity for it (``tests/test_archs.py``): nothing dropped.
CHECK_CAPACITY = 100.0
#: Card against CPU for the MoE models, in float32 weights: a few float32
#: ulps of logits of order 1, summed in other orders.
MOE_CARD_CPU_TOL = 1e-3
#: Families whose bfloat16 decode-against-forward and long check are
#: printed, not gated; their float32 runs are the gate.  A MoE top-k
#: choice flips on a bf16 rounding between an M = 4 and an M = 192 GEMM,
#: and a flipped expert moves a logit by more than any bound.  rwkv6's
#: WKV state sums the outer products of one-ulp-different keys and
#: values along the sequence (a decay of about 0.993 a step) through 24
#: layers, so its bf16 decode drifts from forward position by position;
#: the reference's own bf16 decode drifts past 0.2 as well
#: (``tests/test_torch_lm_families.py``,
#: ``test_rwkv_bf16_decode_drifts_in_the_reference_too``).
F32_GATED = ("qwen3-moe-235b-a22b", "deepseek-v2-236b", "rwkv6-1.6b")
#: The vision model's cross gates after init (the reference's are 0, so
#: its cross layers would add nothing).
VISION_GATE = 0.5


def family_config(name: str, layers):
    """The registry's config of ``name``, cut to ``layers`` layers."""
    from repro_torch.configs import registry
    cfg = registry.get(name)
    return cfg if layers is None else dataclasses.replace(cfg,
                                                          n_layers=layers)


def _open_gates(model) -> None:
    for p in model["layers"]:
        if "attn" in p and "gate" in p["attn"]:
            p["attn"]["gate"].fill_(VISION_GATE)


def _moe_routing(cfg, model, toks, vision) -> dict:
    """Teacher-force ``toks`` through ``decode_step`` (the served run's
    computation) with each MoE layer's routing counted: (token, expert)
    pairs routed, pairs the capacity drops, and kept pairs zeroed by the
    reference's scatter (ROADMAP C9: one an expert over capacity)."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    tot = torch.zeros(3, dtype=torch.long, device=toks.device)
    apply_moe = L.apply_moe

    def counted(cfg_, p, x):
        m = cfg_.moe
        t = x.shape[0] * x.shape[1]
        probs = torch.softmax(x.reshape(1, t, -1).float() @ p["router"], -1)
        idx = torch.topk(probs, m.top_k, dim=-1).indices.reshape(-1)
        counts = torch.bincount(idx, minlength=m.n_experts)
        cap = int(np.ceil(t * m.top_k / m.n_experts * m.capacity_factor))
        tot.add_(torch.stack([counts.sum(), (counts - cap).clamp(min=0).sum(),
                              (counts > cap).sum()]))
        return apply_moe(cfg_, p, x)

    b, t = toks.shape
    caches = M.init_caches(cfg, b, t, device=toks.device)
    L.apply_moe = counted
    try:
        with torch.no_grad():
            for i in range(t - 1):
                _, caches = M.decode_step(cfg, model, caches, toks[:, i], i,
                                          vision=vision)
    finally:
        L.apply_moe = apply_moe
    pairs, dropped, zeroed = tot.tolist()
    return {"pairs": pairs, "dropped": dropped, "zeroed": zeroed}


def _family_profile(cfg, model, fn, n: int, label: str, gpu: str) -> None:
    fn()
    torch.cuda.synchronize()
    _, wall, st = device_timeline(fn)
    if st is None:
        print(f"lm family profile: {gpu}; {label}: wall {wall * 1e3:.3f} ms;"
              " the profiler shows no device time (not measured)",
              flush=True)
        return
    top = "; ".join(f"{name[:60]} {us / 1e3:.3f} ms x{k}"
                    for name, us, k in st["top"][:5])
    print(f"lm family profile: {gpu}; {label}: wall {wall * 1e3:.3f} ms "
          f"under the profiler, device busy {st['busy_ms']:.3f} ms = "
          f"{st['busy_share']:.6f}; {st['kernels'] / n:.1f} kernels a step "
          f"({st['kernels'] / n / cfg.n_layers:.1f} a layer), "
          f"{st['kernel_ms'] / n:.3f} kernel ms a step; top 5: {top}",
          flush=True)


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def _hubert_serving(cfg, model, gpu: str) -> tuple:
    """hubert has no decode: ``serve.main`` refuses it as the reference
    does; ``forward`` over the frames, timed, its logits checked."""
    import contextlib
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            serve.main(["--arch", cfg.name, "--seed", str(SEED)])
    except AssertionError as e:
        _check("encoder-only" in str(e), f"hubert serve: {e}")
    else:
        raise AssertionError("hubert serve: served an encoder-only model")
    b, s = HUBERT_FRAMES
    frames = torch.randn((b, s, cfg.frontend_dim), device="cuda",
                         generator=torch.Generator(device="cuda"
                                                   ).manual_seed(SEED))
    ms = []
    with torch.no_grad():
        for _ in range(2):
            start, end = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
            start.record()
            logits, aux = M.forward(cfg, model, {"frames": frames})
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end))
    layer_w = sum(t.numel() for n, t in model.named_parameters()
                  if n not in ("embed", "lm_head"))
    flop = (2 * layer_w * b * s + 2 * cfg.d_model * cfg.vocab * b * s
            + cfg.n_layers * 4 * b * s * s * cfg.n_heads * cfg.hd)
    ok = tuple(logits.shape) == (b, s, cfg.vocab) and \
        bool(torch.isfinite(logits.float()).all())
    print(f"lm family serve: {gpu}; {cfg.name}: serve.main refuses it "
          f"(encoder-only, as the reference asserts); forward over frames "
          f"[{b}, {s}, {cfg.frontend_dim}]: logits {tuple(logits.shape)}, "
          f"finite {ok}; {ms[0]:.3f} ms first, {ms[1]:.3f} ms second = "
          f"{b * s / ms[1] * 1e3:.3f} frames/s against an operations bound "
          f"of {flop / H100.peak_bf16_flops * 1e3:.6f} ms", flush=True)
    _check(ok, f"hubert forward: logits {tuple(logits.shape)}")
    return frames


def _serve_family(cfg, model, layers, gpu: str) -> tuple:
    """The reference's serving defaults: ``serve.main`` for a model at its
    full depth (it builds its own), ``serve.generate`` on this model for a
    cut one.  Returns (tokens [B, P + G] on the card, vision or None)."""
    import contextlib
    from repro_torch.launch import serve
    b, p, g = LM_SERVE
    dev = "cuda"
    prompt = torch.randint(0, cfg.vocab, (b, p), dtype=torch.int32,
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(SEED))
    vision = None
    if cfg.frontend == "vision":
        vision = torch.randn((b, cfg.vision_seq, cfg.frontend_dim),
                             device=dev, generator=torch.Generator(
                                 device=dev).manual_seed(SEED))
    if layers is None:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            gen = serve.main(["--arch", cfg.name, "--batch", str(b),
                              "--prompt-len", str(p), "--gen", str(g),
                              "--seed", str(SEED)])
        st = _serve_line(buf.getvalue())
        how = f"serve.main --arch {cfg.name}"
        first, med, wall = st["first_ms"], st["median_ms"], st["wall_ms"]
        toks = torch.from_numpy(gen).to(dev)
    else:
        ms = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks = serve.generate(cfg, model, prompt, g, vision=vision,
                              step_ms=ms)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        how = (f"serve.generate, {cfg.n_layers} layers"
               + (f", vision {list(vision.shape)} f32" if vision is not None
                  else ""))
        first, med = ms[0], float(np.median(ms[1:]))
    tb, to = zip(*[decode_bound(model, cfg, b, t)
                   for t in range(1, p + g - 1)])
    bound_b, bound_o = float(np.median(tb)), float(np.median(to))
    bound = max(bound_b, bound_o)
    by = "bytes" if bound_b >= bound_o else "operations"
    print(f"lm family serve: {gpu}; {cfg.name} ({how}) at batch {b}, "
          f"prompt {p}, gen {g}: tokens {tuple(toks.shape)}, wall "
          f"{wall:.3f} ms = {b * (p + g) / wall * 1e3:.3f} tok/s (all "
          f"{b * (p + g)} tokens) = {b * g / wall * 1e3:.3f} generated "
          f"tok/s; first step {first:.3f} ms, median step {med:.3f} ms "
          f"(CUDA events) against its bound {bound:.6f} ms ({by}; bytes "
          f"{bound_b:.6f}, operations {bound_o:.6f}; {med / bound:.3f}x)",
          flush=True)
    _check(tuple(toks.shape) == (b, p + g) and int(toks.min()) >= 0
           and int(toks.max()) < cfg.vocab
           and torch.equal(toks[:, :p].to(torch.int32), prompt),
           f"lm family serve {cfg.name}: tokens {tuple(toks.shape)}")
    return toks, vision


def _card_against_cpu(name: str, gpu: str) -> None:
    """The family's reduced config, one set of weights on both devices:
    prefill of 16 then 4 decode steps (hubert: ``forward``), in bf16
    (the MoE models in float32 weights, where routing cannot flip on a
    rounding)."""
    import copy
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    rcfg = registry.get(name).reduced()
    cpu = M.LM(rcfg, device="cpu",
               generator=torch.Generator().manual_seed(SEED))
    _open_gates(cpu)
    moe = rcfg.moe is not None
    if moe:
        cpu.float()
    tol = MOE_CARD_CPU_TOL if moe else CARD_CPU_TOL
    card = copy.deepcopy(cpu).to("cuda")
    rng = np.random.default_rng(SEED)
    rt = torch.from_numpy(rng.integers(0, rcfg.vocab, (2, 16 + LM_DECODES)))
    vis = None
    if rcfg.frontend != "none":
        n = rcfg.vision_seq if rcfg.frontend == "vision" else 16
        vis = torch.from_numpy(rng.standard_normal(
            (2, n, rcfg.frontend_dim)).astype(np.float32))
    if rcfg.encoder_only:
        with torch.no_grad():
            want = [M.forward(rcfg, cpu, {"frames": vis})[0].float()]
            got = [M.forward(rcfg, card, {"frames": vis.cuda()})[0]
                   .float().cpu()]
        what = "forward over 16 frames"
    else:
        want = _prefill_then_decode(rcfg, cpu, rt, LM_DECODES, vis)
        got = _prefill_then_decode(rcfg, card, rt.cuda(), LM_DECODES,
                                   None if vis is None else vis.cuda())
        what = f"prefill of 16 then {LM_DECODES} decode steps"
    errs = [float((a - w).abs().max()) for a, w in zip(got, want)]
    print(f"lm family card-vs-cpu: {gpu}; {name} reduced (d_model "
          f"{rcfg.d_model}, {rcfg.n_layers} layers, "
          f"{'f32' if moe else 'bf16'} weights), {what}: max |dlogit| "
          f"{[round(e, 6) for e in errs]} (bound {tol})", flush=True)
    _check(max(errs) < tol, f"lm family card-vs-cpu {name}: {errs}")


def _long_check(cfg, model, gpu: str, gate: bool) -> None:
    """Prefill of 2560 tokens, then 4 decode steps, against one forward
    over 3072 at positions 2559 to 2563, in the model's dtype: the local
    ring past its window, the chunked WKV state handed to decode.  Raises
    past the bound where ``gate``."""
    from repro_torch.models import model as M
    b, s, n_dec, t = LONG
    toks = torch.from_numpy(np.random.default_rng(SEED + 3).integers(
        0, cfg.vocab, (b, t))).cuda()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = _prefill_then_decode(cfg, model, toks[:, :s + n_dec], n_dec)
    dec_s = time.perf_counter() - t0
    with torch.no_grad():
        full = M.forward(cfg, model, {"tokens": toks})[0]
        want = full[:, s - 1: s + n_dec].float().cpu()
    del full
    errs = [float((g - want[:, i]).abs().max()) for i, g in enumerate(got)]
    dt = "f32" if model["embed"].dtype == torch.float32 else "bf16"
    print(f"lm family long: {gpu}; {cfg.name}, {dt}: batch {b}, prefill "
          f"{s} then {n_dec} decode steps ({dec_s:.3f} s) against forward "
          f"over {t} at positions {s - 1} to {s + n_dec - 1}: max |dlogit| "
          f"{[round(e, 6) for e in errs]} (bound {DECODE_TOL}"
          f"{'' if gate else ', printed: the f32 run is the gate'})",
          flush=True)
    _check(not gate or max(errs) < DECODE_TOL,
           f"lm family long {cfg.name} {dt}: {errs}")


def _family(name: str, layers, want_n: int, gpu: str) -> None:
    from repro_torch.models import model as M
    cfg = family_config(name, layers)
    dev = "cuda"
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.LM(cfg, device=dev,
                 generator=torch.Generator(device=dev).manual_seed(SEED))
    if cfg.frontend == "vision":
        _open_gates(model)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(p.numel() for p in model.parameters())
    nbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    cut = "all" if layers is None else "cut from the end"
    gates = f", cross gates set to {VISION_GATE}" \
        if cfg.frontend == "vision" else ""
    print(f"lm family build: {gpu}; {name} at full width ({cfg.n_layers} "
          f"layers, {cut}; d_model {cfg.d_model}, kinds "
          f"{'+'.join(dict.fromkeys(M.layer_kinds(cfg)))}"
          f"{gates}"
          f"): {n} parameters, {nbytes} B on {dev}, init {init_s:.3f} s, "
          f"max_memory_allocated {torch.cuda.max_memory_allocated()} B",
          flush=True)
    _check(n == want_n, f"lm family build {name}: {n} parameters, want "
           f"{want_n}")
    b, p, g = LM_SERVE

    if cfg.encoder_only:
        frames = _hubert_serving(cfg, model, gpu)
        with torch.no_grad():
            last, _ = M.prefill(cfg, model, {"frames": frames})
            full = M.forward(cfg, model, {"frames": frames})[0][:, -1]
        err = float((last.float() - full.float()).abs().max())
        print(f"lm family prefill-vs-forward: {gpu}; {name}: last logits "
              f"max |d| {err:.6f} (bound {CARD_CPU_TOL})", flush=True)
        _check(err < CARD_CPU_TOL, f"hubert prefill-vs-forward: {err}")
        del last, full
        _card_against_cpu(name, gpu)

        def fwd():
            with torch.no_grad():
                M.forward(cfg, model, {"frames": frames})

        _family_profile(cfg, model, fwd, 1, f"{name}, one forward over "
                        f"frames {list(frames.shape)}", gpu)
        del model
        torch.cuda.empty_cache()
        return

    toks, vision = _serve_family(cfg, model, layers, gpu)
    if cfg.moe is not None:
        r = _moe_routing(cfg, model, toks, vision)
        m = cfg.moe
        slots = int(np.ceil(b * m.top_k / m.n_experts * m.capacity_factor))
        print(f"lm family moe: {gpu}; {name} at batch {b} (capacity "
              f"{slots} a step): {r['pairs']} routed (token, expert) pairs in "
              f"{p + g - 1} steps, {r['dropped']} dropped by the capacity "
              f"= {r['dropped'] / r['pairs']:.6f}, and {r['zeroed']} kept "
              f"pairs zeroed by the reference's scatter (C9) = "
              f"{r['zeroed'] / r['pairs']:.6f}", flush=True)

    caches = M.init_caches(cfg, b, p + g, device=dev)
    tok = toks[:, p]

    def steps():
        with torch.no_grad():
            for t in range(p, p + PROFILE_STEPS):
                M.decode_step(cfg, model, caches, tok, t, vision=vision)

    _family_profile(cfg, model, steps, PROFILE_STEPS, f"{name}, "
                    f"{PROFILE_STEPS} decode steps at batch {b}", gpu)
    del caches

    check_cfg = cfg if cfg.moe is None else dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=CHECK_CAPACITY))
    cap = "" if cfg.moe is None else f", capacity_factor {CHECK_CAPACITY:g}"
    err16, agree, top = _decode_vs_forward(check_cfg, model, toks,
                                           torch.bfloat16, vision)
    gate = name not in F32_GATED
    print(f"lm family decode-vs-forward: {gpu}; {name}{cap}, bf16, "
          f"{toks.shape[0]}x{toks.shape[1]} tokens: max |dlogit| "
          f"{float(err16.max()):.6f} (bound {DECODE_TOL}"
          f"{'' if gate else ', printed: the f32 run is the gate'}), "
          f"argmax agrees at {agree:.6f}, max |logit| {top:.3f}; per "
          f"position {[round(float(e), 3) for e in err16]}", flush=True)
    _card_against_cpu(name, gpu)
    long = cfg.moe is None and cfg.frontend == "none"
    if long:
        _long_check(cfg, model, gpu, gate)
    model.float()
    err, agree, top = _decode_vs_forward(check_cfg, model, toks,
                                         torch.float32, vision)
    print(f"lm family decode-vs-forward: {gpu}; {name}{cap}, f32 weights "
          f"and caches: max |dlogit| {float(err.max()):.6f} (bound "
          f"{DECODE_TOL}), argmax agrees at {agree:.6f}, max |logit| "
          f"{top:.3f}; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated()} B", flush=True)
    if long:
        _long_check(cfg, model, gpu, True)
    del model, toks, vision
    torch.cuda.empty_cache()
    _check(float(err.max()) < DECODE_TOL,
           f"lm family decode-vs-forward f32 {name}: {float(err.max())}")
    _check(not gate or float(err16.max()) < DECODE_TOL,
           f"lm family decode-vs-forward {name}: {float(err16.max())}")


def lm_families_phase(gpu: str) -> None:
    """The other LM families (ROADMAP A14) at full width on the card, one
    model at a time (see the module docstring); raises on any failed
    check."""
    import gc
    t0 = time.perf_counter()
    failed = []
    for name, layers, want_n in FAMILIES:
        try:
            _family(name, layers, want_n, gpu)
        except AssertionError as e:      # the next family still runs
            print(f"lm family FAILED: {gpu}; {name}: {e}", flush=True)
            failed.append(f"{name}: {e}")
        gc.collect()
        torch.cuda.empty_cache()
    print(f"lm families: {gpu}; {len(FAMILIES)} families in "
          f"{time.perf_counter() - t0:.3f} s, {len(failed)} failed",
          flush=True)
    if failed:
        raise AssertionError(f"lm families: {failed}")


# --------------------------------------------------------------------------
# LM training (ROADMAP A15): qwen3-8b at full width, depth cut
# --------------------------------------------------------------------------

TRAIN_ARCH = "qwen3-8b"
#: qwen3-8b's layers trained on one 80 GB card.  Every parameter holds 16
#: B of state (bf16 weight and gradient, the float32 accumulator, two
#: float32 moments): 131 GB for all 36 layers.  A layer has 192,946,432
#: parameters (3.09 GB of state), the embedding and the head
#: 1,244,659,712.  17 layers are 4,524,753,152 parameters, 72.4 GB of
#: state: the most whose measured peak (``train_phase``'s gate) stays
#: under :data:`TRAIN_MEM_SHARE` of the card (PERF.md §4).
TRAIN_LAYERS = 17
#: The reference CLI's defaults: batch 8, seq 256, accum 1, lr 3e-4,
#: warmup ``max(steps // 20, 1)``.
TRAIN_BATCH, TRAIN_SEQ, TRAIN_LR = 8, 256, 3e-4
TRAIN_STEPS = 10
#: Steps of each accumulation form (scan, fused) at this depth.
TRAIN_ACCUM, TRAIN_ACCUM_STEPS = 4, 2
TRAIN_PROFILE_STEPS = 2
TRAIN_MEM_SHARE = 0.9
#: Bytes a parameter of the optimizer's work moves at least, as the
#: reference's step is built: the bf16 gradient written and read (4), the
#: float32 accumulator written, then read by the norm and the update (12),
#: both moments read and written (16), the bf16 weight read by the
#: forward and read and written by the update (6).
TRAIN_OPT_BYTES = 38
#: Bytes a weight of one ``adamw.update`` moves at least: the float32
#: gradient read, both moments read and written, the bf16 weight read
#: and written.
TRAIN_UPDATE_BYTES = 24
#: Card against CPU, one train step of a reduced model in float32 from one
#: set of weights and one batch: the loss, the grad norm and both moments
#: relative to their (leaf's) largest magnitude; the updated weights the
#: same where the gradient's sign is sure (above ``TRAIN_SIGN_FLOOR`` of
#: its leaf's largest: AdamW's first update is ``lr * sign(g)``, and a
#: gradient within the summation noise of 0 may take either sign).
TRAIN_CARD_CPU_TOL = 1e-4
TRAIN_SIGN_FLOOR = 1e-3
TRAIN_CHECK_ARCHS = ("qwen3-8b", "qwen3-moe-235b-a22b")
#: The CLI on the card: the reduced model, 20 steps at batch 8 and seq
#: 128, then the same on its directory (resumes at 20, nothing to do) and
#: with 30 steps.  The reference's loop writes no checkpoint at its end,
#: so ``--ckpt-every 19`` makes its last step (19, tagged 20) one.
TRAIN_CLI = ["--arch", "qwen3-8b", "--reduced", "--batch", "8", "--seq",
             "128", "--ckpt-every", "19"]


def train_bound_ms(n_params: int, n_embed: int, tokens: int) -> tuple:
    """A train step's least time: (operations, bytes) ms.  Operations: 6 x
    N x tokens at the card's bf16 rate, N the parameters but the
    embedding (the forward's 2 N a token, the backward's 4 N; remat's
    second forward is not counted); bytes: :data:`TRAIN_OPT_BYTES` a
    parameter at the memory rate."""
    ops = 6 * (n_params - n_embed) * tokens / H100.peak_bf16_flops * 1e3
    return ops, TRAIN_OPT_BYTES * n_params / H100.hbm_bw * 1e3


def _train_batch(batch: dict, accum: int, device) -> dict:
    return {k: torch.from_numpy(v).to(device).reshape(
                (accum, v.shape[0] // accum) + v.shape[1:])
            for k, v in batch.items()}


def train_card_against_cpu(name: str, device="cuda") -> dict:
    """One train step of ``name``'s reduced config in float32 on the CPU
    and on ``device`` from the same weights and batch; returns the worst
    relative errors (``loss``, ``grad_norm``, ``m``, ``v``, ``params``)
    and how many updated weights differ where the sign is not sure
    (``flips``)."""
    import copy
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = registry.get(name).reduced()
    cpu = M.LM(cfg, device="cpu",
               generator=torch.Generator().manual_seed(SEED)).float()
    card = copy.deepcopy(cpu).to(device)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=32,
                                global_batch=4, seed=SEED), 0)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, total_steps=10,
                                warmup_steps=1)
    step = make_train_step(cfg, 1, opt_cfg)
    outs = [step(lm, adamw.init(lm), _train_batch(batch, 1, lm["embed"]
                                                  .device))
            for lm in (cpu, card)]
    (_, want_o, want), (_, got_o, got) = outs
    rel = lambda a, b: abs(float(a) - float(b)) / max(abs(float(b)), 1e-30)
    errs = {"loss": rel(got["loss"], want["loss"]),
            "grad_norm": rel(got["grad_norm"], want["grad_norm"]),
            "m": 0.0, "v": 0.0, "params": 0.0, "flips": 0}
    named = lambda t: dict(t.named_parameters())
    m_cpu = named(want_o["m"])
    for key, (tree_c, tree_g) in {
            "m": (want_o["m"], got_o["m"]), "v": (want_o["v"], got_o["v"]),
            "params": (cpu, card)}.items():
        got_t = named(tree_g)
        for n, w in named(tree_c).items():
            g = got_t[n].detach().cpu()
            w = w.detach()
            err = (g - w).abs()
            top = float(w.abs().max())
            if key == "params":
                mw = m_cpu[n].abs()
                sure = mw > TRAIN_SIGN_FLOOR * float(mw.max())
                errs["flips"] += int((err[~sure] > TRAIN_CARD_CPU_TOL
                                      * top).sum())
                err = err[sure]
            if err.numel():
                errs[key] = max(errs[key], float(err.max()) / max(top, 1e-30))
    return errs


def _mini_train(ckpt_dir: str, total: int, device):
    """``tests/test_system.py``'s ``_mini_setup`` on ``device``: reduced
    qwen3-8b at vocab 64 from seed 1, lr 1e-3, warmup 2, batch 4 of 32
    tokens; returns (step_fn, state, data config, manager)."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    cfg = registry.get("qwen3-8b").reduced(vocab=64)
    params = M.init_model(cfg, torch.Generator(device=device).manual_seed(1),
                          device=device)
    step = make_train_step(cfg, 1, adamw.AdamWConfig(
        lr=1e-3, total_steps=total, warmup_steps=2))

    def step_fn(state, batch):
        p, o, metrics = step(state["params"], state["opt"],
                             _train_batch(batch, 1, device))
        return {"params": p, "opt": o}, metrics

    return step_fn, {"params": params, "opt": adamw.init(params)}, \
        DataConfig(vocab=64, seq_len=32, global_batch=4, seed=0), \
        CheckpointManager(ckpt_dir, keep=2)


def train_resume_check(work: Path, device="cuda", steps: int = 4) -> bool:
    """``steps`` straight steps against half of them, ``save``, a new loop
    on a fresh model and the other half: whether every weight of the two
    ends is bit-equal."""
    from repro_torch.data.pipeline import DataIterator
    from repro_torch.runtime.train_loop import train_loop
    quiet = dict(ckpt_every=0, log_every=0, log_fn=lambda *_: None)
    step_fn, state, dcfg, ckpt = _mini_train(str(work / "a"), steps, device)
    a = train_loop(step_fn=step_fn, state=state, data_iter=DataIterator(dcfg),
                   ckpt=ckpt, total_steps=steps, **quiet)["state"]["params"]
    half = steps // 2
    step_fn, state, dcfg, ckpt = _mini_train(str(work / "b"), steps, device)
    mid = train_loop(step_fn=step_fn, state=state,
                     data_iter=DataIterator(dcfg), ckpt=ckpt,
                     total_steps=half, **quiet)["state"]
    ckpt.save(half, mid)
    step_fn, fresh, dcfg, ckpt = _mini_train(str(work / "b"), steps, device)
    b = train_loop(step_fn=step_fn, state=fresh,
                   data_iter=DataIterator(dcfg), ckpt=ckpt, total_steps=steps,
                   **quiet)["state"]["params"]
    return all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))


def _train_cli(work: Path, gpu: str) -> None:
    root = Path(__file__).resolve().parent
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + TRAIN_CLI + \
        ["--ckpt-dir", str(work / "cli")]
    runs = []
    # (steps, the resume line, whether a step runs and logs a loss)
    for steps, want, trains in ((20, None, True),
                                (20, "[resume] restored step 20", False),
                                (30, "[resume] restored step 20", True)):
        t0 = time.perf_counter()
        proc = subprocess.run(cmd + ["--steps", str(steps)], cwd=root,
                              env=env, capture_output=True, text=True,
                              timeout=300)
        s = time.perf_counter() - t0
        final = [l for l in proc.stdout.splitlines()
                 if l.startswith("final:")]
        _check(proc.returncode == 0 and len(final) == 1 and
               (want is None or want in proc.stdout) and
               ("'loss'" in final[0]) == trains,
               f"train CLI --steps {steps}: exit {proc.returncode}, "
               f"{proc.stdout[-800:]}{proc.stderr[-1500:]}")
        runs.append(f"--steps {steps}: exit 0 in {s:.3f} s"
                    f"{', ' + want if want else ''}, {final[0]}")
    print(f"train CLI: {gpu}; python -m repro_torch.launch.train "
          f"{' '.join(TRAIN_CLI)}: " + "; ".join(runs), flush=True)


def train_depth_probe(gpu: str, depths=(15, 16, 17, 18)) -> dict:
    """The peak ``max_memory_allocated`` of two train steps of ``qwen3-8b``
    at full width cut to each of ``depths`` layers, in turn, as the phase
    builds and steps it (what :data:`TRAIN_LAYERS` was chosen by; not part
    of the smoke's run).  Run alone on the card:

        python3 -c "import chip_smoke as c; c.train_depth_probe(c.smi('name,power.limit'))"
    """
    import gc
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, batch_at
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    card = torch.cuda.get_device_properties(0).total_memory
    out = {}
    for layers in depths:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        cfg = dataclasses.replace(registry.get(TRAIN_ARCH), n_layers=layers)
        model = M.init_model(
            cfg, torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda")
        opt = adamw.init(model)
        step = make_train_step(cfg, 1, adamw.AdamWConfig(
            lr=TRAIN_LR, total_steps=TRAIN_STEPS, warmup_steps=1))
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                          global_batch=TRAIN_BATCH, seed=SEED)
        try:
            for i in range(2):
                _, opt, _ = step(model, opt,
                                 _train_batch(batch_at(dcfg, i), 1, "cuda"))
            torch.cuda.synchronize()
            out[layers] = torch.cuda.max_memory_allocated()
            what = f"peak {out[layers]} B = {out[layers] / card:.4f}"
        except torch.cuda.OutOfMemoryError:      # the probe's answer
            out[layers] = None
            what = "out of memory"
        print(f"train depth probe: {gpu}; {layers} layers: {what} of the "
              f"card's {card} B", flush=True)
        del model, opt, step
    gc.collect()
    torch.cuda.empty_cache()
    return out


def train_phase(gpu: str) -> None:
    """LM training (ROADMAP A15) on the card (see the module docstring);
    raises on any failed check."""
    import gc
    import tempfile
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime.train_loop import train_loop
    gc.collect()
    torch.cuda.empty_cache()
    t_phase = time.perf_counter()
    dev = "cuda"
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH),
                              n_layers=TRAIN_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    n = sum(p.numel() for p in model.parameters())
    n_embed = model["embed"].numel()
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                                warmup_steps=max(TRAIN_STEPS // 20, 1))
    step = make_train_step(cfg, 1, opt_cfg)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                      global_batch=TRAIN_BATCH, seed=SEED)
    marks, metrics = [], []

    def step_fn(state, batch):
        a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        mb = _train_batch(batch, 1, dev)
        a.record()
        p, o, m = step(state["params"], state["opt"], mb)
        z.record()
        marks.append((a, z))
        metrics.append(m)
        return {"params": p, "opt": o}, m

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(dir=build) as work:
        work = Path(work)
        ckpt = CheckpointManager(str(work / "full"), keep=2)
        t0 = time.perf_counter()
        out = train_loop(step_fn=step_fn,
                         state={"params": model, "opt": adamw.init(model)},
                         data_iter=DataIterator(dcfg), ckpt=ckpt,
                         total_steps=TRAIN_STEPS, ckpt_every=0, log_every=0,
                         log_fn=print)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        card = torch.cuda.get_device_properties(0).total_memory
        ms = [a.elapsed_time(z) for a, z in marks]
        loss = [float(m["loss"]) for m in metrics]
        gn = [float(m["grad_norm"]) for m in metrics]
        lr = [float(m["lr"]) for m in metrics]
        tokens = TRAIN_BATCH * TRAIN_SEQ
        med = float(np.median(ms[1:]))
        ops_ms, bytes_ms = train_bound_ms(n, n_embed, tokens)
        print(f"train build: {gpu}; {cfg.name} at full width, {TRAIN_LAYERS} "
              f"of 36 layers (d_model {cfg.d_model}, heads {cfg.n_heads}/"
              f"{cfg.n_kv_heads}, head_dim {cfg.hd}, d_ff {cfg.d_ff}, vocab "
              f"{cfg.vocab}): {n} parameters ({n_embed} in the embedding), "
              f"max_memory_allocated {peak} B = {peak / card:.4f} of the "
              f"card's {card} B", flush=True)
        print(f"train steps: {gpu}; train_loop, {TRAIN_STEPS} steps at batch "
              f"{TRAIN_BATCH} x seq {TRAIN_SEQ}, accum 1, lr {TRAIN_LR}, "
              f"remat: first step {ms[0]:.3f} ms, median of the rest "
              f"{med:.3f} ms (CUDA events) = {tokens / med * 1e3:.1f} "
              f"tokens/s; wall {wall:.3f} s; bound: operations "
              f"{ops_ms:.3f} ms (6 x {n - n_embed} x {tokens} at "
              f"{H100.peak_bf16_flops / 1e12:g} "
              f"TFLOP/s), bytes {bytes_ms:.3f} ms ({TRAIN_OPT_BYTES} B x {n} "
              f"at {H100.hbm_bw / 1e12:g} TB/s); median / bound "
              f"{med / max(ops_ms, bytes_ms):.3f}x; step ms {[round(x, 3) for x in ms]}", flush=True)
        print(f"train loss: {gpu}; {[round(x, 6) for x in loss]}; grad_norm "
              f"{[round(x, 6) for x in gn]}; lr {[float(f'{x:.6g}') for x in lr]}",
              flush=True)
        _check(all(np.isfinite(loss)) and all(np.isfinite(gn)),
               f"train: a loss or grad norm is not finite: {loss} {gn}")
        _check(loss[-1] < loss[0], f"train: the loss did not fall: {loss}")
        _check(peak < TRAIN_MEM_SHARE * card,
               f"train: peak {peak} B over {TRAIN_MEM_SHARE} of {card} B")

        # the async checkpoint of the weights: the host copy the next step
        # waits for, then the write in the writer thread
        t0 = time.perf_counter()
        ckpt.save_async(TRAIN_STEPS, {"params": model})
        copy_s = time.perf_counter() - t0
        ckpt.wait()
        total_s = time.perf_counter() - t0
        step_dir = work / "full" / f"step_{TRAIN_STEPS:08d}"
        nbytes = sum(p.stat().st_size for p in step_dir.iterdir())
        print(f"train checkpoint: {gpu}; save_async of the {n} bf16 weights: "
              f"returns after {copy_s:.3f} s (the copy to the host), written "
              f"after {total_s:.3f} s, {nbytes} B on disk "
              f"({nbytes / total_s / 1e9:.3f} GB/s)", flush=True)
        shutil.rmtree(step_dir)

        # the two accumulation forms
        it = DataIterator(dcfg, start_step=TRAIN_STEPS)
        for fused in (False, True):
            acc = make_train_step(cfg, TRAIN_ACCUM, opt_cfg,
                                  fused_accum=fused)
            rows = []
            opt = out["state"]["opt"]
            for _ in range(TRAIN_ACCUM_STEPS):
                a, z = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                mb = _train_batch(next(it), TRAIN_ACCUM, dev)
                a.record()
                _, opt, m = acc(model, opt, mb)
                z.record()
                z.synchronize()
                rows.append((a.elapsed_time(z), float(m["loss"]),
                             float(m["grad_norm"])))
            out["state"]["opt"] = opt
            print(f"train accum: {gpu}; accum {TRAIN_ACCUM} x microbatch "
                  f"{TRAIN_BATCH // TRAIN_ACCUM}, "
                  f"{'fused' if fused else 'scan'} form: (ms, loss, "
                  f"grad_norm) {[tuple(round(x, 4) for x in r) for r in rows]}",
                  flush=True)
            _check(all(np.isfinite(r[1:]).all() for r in rows),
                   f"train accum: not finite: {rows}")

        # the optimizer alone: one update of every weight, the first
        # moment standing in for the gradient (the same work)
        opt = out["state"]["opt"]
        grads = dict(opt["m"].named_parameters())
        for _ in range(2):
            a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            _, opt, _ = adamw.update(opt_cfg, grads, opt, model)
            z.record()
            z.synchronize()
        out["state"]["opt"] = opt
        upd_ms = a.elapsed_time(z)
        upd_bound = TRAIN_UPDATE_BYTES * n / H100.hbm_bw * 1e3
        print(f"train optimizer: {gpu}; adamw.update of {n} weights "
              f"{upd_ms:.3f} ms (CUDA events; {upd_ms / med:.3f} of the "
              f"median step) against its bytes bound {upd_bound:.3f} ms "
              f"({TRAIN_UPDATE_BYTES} B a weight at "
              f"{H100.hbm_bw / 1e12:g} TB/s)", flush=True)

        # a trace of two steps
        batches = [_train_batch(next(it), 1, dev)
                   for _ in range(TRAIN_PROFILE_STEPS)]

        def two_steps():
            o = out["state"]["opt"]
            for mb in batches:
                _, o, _ = step(model, o, mb)
            out["state"]["opt"] = o

        _, pwall, st = device_timeline(two_steps)
        if st is None:
            print(f"train profile: {gpu}; wall {pwall * 1e3:.3f} ms; the "
                  "profiler shows no device time (not measured)", flush=True)
        else:
            top = "; ".join(f"{name[:60]} {us / 1e3:.3f} ms x{k}"
                            for name, us, k in st["top"][:5])
            print(f"train profile: {gpu}; {TRAIN_PROFILE_STEPS} steps, wall "
                  f"{pwall * 1e3:.3f} ms under the profiler, device busy "
                  f"{st['busy_ms']:.3f} ms = {st['busy_share']:.6f}; "
                  f"{st['kernels'] / TRAIN_PROFILE_STEPS:.1f} kernels a step, "
                  f"{st['kernel_ms'] / TRAIN_PROFILE_STEPS:.3f} kernel ms a "
                  f"step; top 5: {top}", flush=True)
        del model, out, step, batches
        gc.collect()
        torch.cuda.empty_cache()

        for name in TRAIN_CHECK_ARCHS:
            errs = train_card_against_cpu(name, dev)
            print(f"train card-vs-cpu: {gpu}; {name} reduced, f32, one step: "
                  + ", ".join(f"{k} {v:.3g}" for k, v in errs.items())
                  + f" (bound {TRAIN_CARD_CPU_TOL} relative; flips are "
                  "updates where the gradient's sign is not sure)",
                  flush=True)
            _check(max(v for k, v in errs.items() if k != "flips")
                   <= TRAIN_CARD_CPU_TOL,
                   f"train card-vs-cpu {name}: {errs}")
        same = train_resume_check(work / "resume", dev)
        print(f"train resume: {gpu}; reduced qwen3-8b, 4 straight steps "
              f"against 2, save, a new loop and 2 more: every weight "
              f"bit-equal {same} (default kernels, "
              f"deterministic algorithms "
              f"{torch.are_deterministic_algorithms_enabled()})", flush=True)
        _check(same, "train resume: not bit-identical")
        _train_cli(work, gpu)
    print(f"train: {gpu}; phase {time.perf_counter() - t_phase:.3f} s",
          flush=True)


# --------------------------------------------------------------------------
# meshes, shardings, compressed all-reduce and the dry run (A16, A17b)
# --------------------------------------------------------------------------

#: Train steps of the plain and the sharded run, and how far their losses
#: may part (relative): on one rank every placement replicates, so the
#: sharded step runs the plain step's kernels.
MESH_TRAIN_STEPS = 3
MESH_TRAIN_TOL = 1e-6
#: Calls of ``compressed_psum`` timed, on gradient-shaped leaves:
#: qwen3-8b's embedding [vocab, d] and LM head [d, vocab] in bf16,
#: 1,244,659,712 elements (over 1 Gi).
MESH_PSUM_REPS = 3
#: ``compressed_psum``'s passes over an element of a bf16 gradient, each
#: (what it does, bytes read, bytes written), in the order the code runs
#: them: its least bytes are their sum (the amax and scale are one
#: element a leaf).
PSUM_PASSES = (
    ("g.float()", 2, 4), ("+ residual", 8, 4), ("abs", 4, 4), ("max", 4, 0),
    ("/ scale", 4, 4), ("round", 4, 4), ("clamp", 4, 4), ("to int8", 4, 1),
    ("gf.double()", 4, 8), ("q.double()", 1, 8), ("* scale", 8, 8),
    ("gf - q*scale", 16, 8), ("residual .float()", 8, 4),
    ("q to int32", 1, 4), ("all_reduce SUM", 4, 4), ("s.float()", 4, 4),
    ("* scale", 4, 4), ("/ n", 4, 4), ("to bf16", 4, 2))
#: The dry run's cells on the card's host: qwen3-8b, every shape, both
#: meshes, one process a cell, all started together.
DRYRUN_ARCH = "qwen3-8b"
DRYRUN_TIMEOUT = 900


def _mesh_serving(gpu: str) -> None:
    """``serve.main`` (the launcher's one-rank mesh installed) against
    ``serve.generate`` with no mesh on the same weights and prompt."""
    import contextlib
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    b, p, g = LM_SERVE
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        meshed = serve.main(["--arch", LM_ARCH, "--batch", str(b),
                             "--prompt-len", str(p), "--gen", str(g),
                             "--seed", str(SEED)])
    st = _serve_line(buf.getvalue())
    torch.cuda.empty_cache()
    cfg = registry.get(LM_ARCH)
    dev = "cuda"
    model = M.init_model(cfg, torch.Generator(device=dev).manual_seed(SEED),
                         device=dev)
    prompt = torch.randint(0, cfg.vocab, (b, p), dtype=torch.int32,
                           device=dev, generator=torch.Generator(
                               device=dev).manual_seed(SEED))
    ms = []
    plain = serve.generate(cfg, model, prompt, g, step_ms=ms).cpu().numpy()
    med = float(np.median(ms[1:]))
    same = np.array_equal(meshed, plain)
    print(f"mesh serve: {gpu}; {LM_ARCH} at full width, batch {b}, prompt "
          f"{p}, gen {g}: serve.main on the (1, 1) mesh with the sharder "
          f"installed, median step {st['median_ms']:.3f} ms; serve.generate "
          f"with no mesh, median step {med:.3f} ms (CUDA events); tokens "
          f"identical {same}", flush=True)
    _check(same, "mesh serve: the tokens differ with the mesh installed")
    del model


def _mesh_train(gpu: str, mesh) -> None:
    """The train phase's model, plain and with its parameters and AdamW
    state as DTensors on ``mesh``, from the same weights and batches."""
    import gc
    from repro_torch.configs import registry
    from repro_torch.data.pipeline import DataConfig, DataIterator
    from repro_torch.launch import sharding as SH
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    dev = "cuda"
    cfg = dataclasses.replace(registry.get(TRAIN_ARCH),
                              n_layers=TRAIN_LAYERS)
    opt_cfg = adamw.AdamWConfig(lr=TRAIN_LR, total_steps=TRAIN_STEPS,
                                warmup_steps=max(TRAIN_STEPS // 20, 1))
    it = DataIterator(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                 global_batch=TRAIN_BATCH, seed=SEED))
    batches = [_train_batch(next(it), 1, dev)
               for _ in range(MESH_TRAIN_STEPS)]
    runs = {}
    for sharded in (False, True):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        params = M.init_model(
            cfg, torch.Generator(device=dev).manual_seed(SEED), device=dev)
        opt = adamw.init(params)
        if sharded:
            pshard = SH.param_shardings(mesh, params)
            params = SH.place_tree(params, pshard)
            opt = SH.place_tree(opt, SH.opt_shardings(mesh, opt, pshard))
        step = make_train_step(cfg, 1, opt_cfg)
        ms, loss = [], []
        for mb in batches:
            if sharded:
                mb = SH.place_tree(mb, SH.batch_shardings(mesh, mb,
                                                          accum=True))
            a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            a.record()
            params, opt, m = step(params, opt, mb)
            z.record()
            z.synchronize()
            ms.append(a.elapsed_time(z))
            loss.append(float(m["loss"]))
        kind = type(params["embed"]).__name__
        runs[sharded] = (ms, loss, torch.cuda.max_memory_allocated(), kind)
        del params, opt, step
    (p_ms, p_loss, p_peak, _), (s_ms, s_loss, s_peak, kind) = \
        runs[False], runs[True]
    rel = max(abs(a - b) / abs(b) for a, b in zip(s_loss, p_loss))
    print(f"mesh train: {gpu}; {cfg.name} at full width, {TRAIN_LAYERS} "
          f"layers, {MESH_TRAIN_STEPS} steps at batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}: plain step ms {[round(x, 3) for x in p_ms]}, "
          f"peak {p_peak} B; parameters and AdamW state as {kind}s on the "
          f"(1, 1) NCCL mesh: step ms {[round(x, 3) for x in s_ms]}, peak "
          f"{s_peak} B; losses plain {p_loss}, sharded {s_loss}: worst "
          f"relative difference {rel:.3g} (bound {MESH_TRAIN_TOL})",
          flush=True)
    _check(kind == "DTensor", f"mesh train: the parameters are {kind}s")
    _check(rel <= MESH_TRAIN_TOL, f"mesh train: losses {s_loss} against "
           f"{p_loss}")


def _mesh_psum(gpu: str) -> None:
    """``compressed_psum`` over the NCCL group on gradient-shaped leaves
    of qwen3-8b, timed beside its bytes bound."""
    from repro_torch.configs import registry
    from repro_torch.optim.compression import compressed_psum, \
        init_residuals
    cfg = registry.get(LM_ARCH)
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    grads = {k: (torch.randn(shape, generator=gen, device="cuda") * 1e-3
                 ).to(torch.bfloat16)
             for k, shape in (("embed", (cfg.vocab, cfg.d_model)),
                              ("lm_head", (cfg.d_model, cfg.vocab)))}
    res = init_residuals(grads)
    n = sum(g.numel() for g in grads.values())
    ms = []
    for _ in range(MESH_PSUM_REPS):
        a, z = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        red, res = compressed_psum(grads, res)
        z.record()
        z.synchronize()
        ms.append(a.elapsed_time(z))
    per = sum(r + w for _, r, w in PSUM_PASSES)
    bound = per * n / H100.hbm_bw * 1e3
    err = max(float((red[k].float() - g.float()).abs().max()
                    / (g.float().abs().max() / 127.0))
              for k, g in grads.items())
    med = float(np.median(ms))
    print(f"mesh compressed_psum: {gpu}; {n} bf16 elements "
          f"(embedding and LM head shapes of {LM_ARCH}) over the one-rank "
          f"NCCL group: {[round(x, 3) for x in ms]} ms a call (CUDA "
          f"events), median {med:.3f} ms against its bytes bound "
          f"{bound:.3f} ms ({per} B an element over {len(PSUM_PASSES)} "
          f"passes at {H100.hbm_bw / 1e12:g} TB/s; {med / bound:.3f}x); "
          f"worst |mean - grad| {err:.4f} of the int8 step (one rank: "
          f"the dequantized grad)", flush=True)
    # half a step of rounding to int8, then the mean's rounding to bf16:
    # half an ulp of the largest value, 127 / 256 of a step
    _check(err <= 0.5 + 127 / 256, f"mesh compressed_psum: error {err} of "
           "a step")
    del grads, res, red


#: Layers of the state :func:`_mesh_elastic` saves and restores:
#: ``qwen3-8b`` at full width, so every leaf has its real shape (the
#: 151936 x 4096 embedding and head, each layer's projections stacked over
#: two layers).  1,630,552,576 parameters, about 16.3 GB of bf16 weights
#: and float32 moments, written to disk and restored beside the saved
#: state on the card (twice that at once).  :data:`TRAIN_LAYERS` would be
#: 45.2 GB, 90 GB with its restored copy: more than the card.
ELASTIC_LAYERS = 2


def _mesh_elastic(gpu: str) -> None:
    """``elastic.mesh_for(1, [8])`` with no process group up (a one-rank
    NCCL group made on the card, as the reference builds its mesh over
    ``jax.devices()``), then ``reshard_plan`` of a saved ``qwen3-8b``
    state at full width (:data:`ELASTIC_LAYERS` layers, parameters and
    AdamW moments) onto that mesh: every leaf a DTensor of the placements
    asked, its values the saved ones; the group destroyed after."""
    import tempfile
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs import registry
    from repro_torch.launch import sharding as SH
    from repro_torch.models import convert
    from repro_torch.models import model as M
    from repro_torch.optim import adamw
    from repro_torch.runtime.elastic import mesh_for, reshard_plan
    _check(not dist.is_initialized(), "mesh elastic: a process group is up")
    cfg = dataclasses.replace(registry.get(LM_ARCH), n_layers=ELASTIC_LAYERS)
    params = M.init_model(cfg, torch.Generator(device="cuda").manual_seed(
        SEED), device="cuda")
    tree = {"params": params, "opt": adamw.init(params)}

    def shardings(mesh, tpl):
        pshard = SH.param_shardings(mesh, tpl["params"])
        return {"params": pshard,
                "opt": SH.opt_shardings(mesh, tpl["opt"], pshard)}

    build = Path(__file__).resolve().parent / "build"
    build.mkdir(exist_ok=True)
    free = shutil.disk_usage(build).free
    try:
        mesh = mesh_for(1, [8])
        made = (dist.get_backend(), dist.get_world_size(), mesh.device_type,
                tuple(mesh.shape), tuple(mesh.mesh_dim_names))
        with tempfile.TemporaryDirectory(dir=build) as work:
            ckpt = CheckpointManager(str(Path(work) / "ckpt"))
            t0 = time.perf_counter()
            ckpt.save(1, tree)
            t_saved = time.perf_counter()
            on_disk = sum(f.stat().st_size
                          for f in Path(work).rglob("*.npy"))
            placed = reshard_plan(ckpt, tree, mesh, shardings)
            torch.cuda.synchronize()
            t_placed = time.perf_counter()
        want = shardings(mesh, tree)
        parts = lambda t: {"params": t["params"], "m": t["opt"]["m"],
                           "v": t["opt"]["v"]}
        saved, asked = parts(tree), parts(want)
        n = bad = placed_bytes = 0
        for key, part in parts(placed).items():
            values = dict(saved[key].named_parameters())
            for name, t in part.named_parameters():
                n += 1
                placed_bytes += t.numel() * t.element_size()
                bad += not (isinstance(t, DTensor) and
                            tuple(t.placements) == asked[key][name].placements
                            and t.device.type == "cuda" and
                            torch.equal(t.full_tensor(), values[name]))
        step_ok = int(convert.to_numpy(placed["opt"]["step"])) == \
            int(convert.to_numpy(tree["opt"]["step"]))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    ok = made == ("nccl", 1, "cuda", (1, 1), ("data", "model")) and \
        bad == 0 and step_ok
    print(f"mesh elastic: {gpu}; mesh_for(1, [8]) with no group up gave "
          f"backend, ranks, device, shape, axes {made}; reshard_plan of a "
          f"saved {LM_ARCH} state at full width, {ELASTIC_LAYERS} layers "
          f"({n} parameter and moment leaves, {on_disk} B on disk of "
          f"{free} B free) onto it: {n - bad} DTensors of the asked "
          f"placements equal to the saved values, {placed_bytes} B "
          f"restored onto the card, step equal {step_ok}; save "
          f"{t_saved - t0:.3f} s, restore {t_placed - t_saved:.3f} s "
          f"(the file cache warm): {'passed' if ok else 'FAILED'}",
          flush=True)
    _check(ok, "mesh elastic: mesh_for or reshard_plan is wrong on the card")
    _check(not dist.is_initialized(), "mesh elastic: the group is still up")


def _mesh_dryrun(gpu: str) -> None:
    """The dry run of qwen3-8b on both meshes, a process a cell, then the
    roofline over its records."""
    from repro_torch.configs import registry
    from repro_torch.launch import roofline
    from repro_torch.launch.steps import SHAPES
    root = Path(__file__).resolve().parent
    out = root / "build" / "chip_smoke_dryrun"
    shutil.rmtree(out, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=str(root / "src"),
               OMP_NUM_THREADS="1")
    cells = [(s, mp) for s in SHAPES for mp in (False, True)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         DRYRUN_ARCH, "--shape", s, "--out", str(out), "--force"]
        + (["--multi-pod"] if mp else []), env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for s, mp in cells]
    t0 = time.perf_counter()
    try:
        logs = [p.communicate(timeout=DRYRUN_TIMEOUT)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for (s, mp), p, log in zip(cells, procs, logs):
        _check(p.returncode == 0, f"mesh dry run {s} multi_pod={mp}: exit "
               f"{p.returncode}: {log[-3000:]}")
    cfg = registry.get(DRYRUN_ARCH)
    for s, mp in cells:
        tag = f"{DRYRUN_ARCH}__{s}__{'pod2' if mp else 'pod1'}"
        with open(out / f"{tag}.json") as f:
            rec = json.load(f)
        if rec["skip"]:
            print(f"mesh dryrun: {gpu}; {tag}: skipped ({rec['skip']})",
                  flush=True)
            continue
        chips = roofline.CHIPS[rec["mesh"]]
        ratio = rec["hlo_dot_flops"] * chips / roofline.model_flops(
            cfg, SHAPES[s])
        coll = ", ".join(f"{k} {v['bytes']:.6g} B in {v['count']}"
                         for k, v in rec["collectives"].items()
                         if v["count"])
        print(f"mesh dryrun: {gpu} (its host's CPU traces); {tag}: trace "
              f"{rec['lower_s']} s, count {rec['compile_s']} s; "
              f"hlo_dot_flops x {chips} / model_flops {ratio:.4f}; per "
              f"device: dot {rec['hlo_dot_flops']:.6g} FLOPs, arguments "
              f"{rec['memory']['argument_size_in_bytes']} B, temporaries "
              f"peak {rec['memory']['temp_size_in_bytes']} B; collectives "
              f"{coll}", flush=True)
        _check(rec["hlo_dot_flops"] > 0 and ratio >= 1.0,
               f"mesh dryrun {tag}: {rec['hlo_dot_flops']} FLOPs, ratio "
               f"{ratio}")
    print(f"mesh dryrun: {gpu}; {len(cells)} cells in {wall:.1f} s, "
          f"{len(cells)} processes at once; roofline of the 16x16 cells "
          f"against the H100 (roofline.markdown):", flush=True)
    print(roofline.markdown(str(out)), flush=True)


def mesh_phase(gpu: str) -> None:
    """Meshes, shardings, compressed all-reduce and the dry run (ROADMAP
    A16, A17b) on the card (see the module docstring); raises on any
    failed check."""
    import gc
    from repro_torch.launch import sharding as SH
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    _mesh_serving(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    with SH.launch_mesh("cuda") as mesh:
        _mesh_train(gpu, mesh)
        gc.collect()
        torch.cuda.empty_cache()
        _mesh_psum(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    _mesh_elastic(gpu)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"mesh collectives: {gpu}; collectives across distinct cards "
          "were not measured: this machine has one card, and NCCL refuses "
          "two ranks on one card", flush=True)
    _mesh_dryrun(gpu)
    print(f"mesh: {gpu}; phase {time.perf_counter() - t_phase:.3f} s",
          flush=True)


# --------------------------------------------------------------------------
# the PIM examples and the offload planner on the card (ROADMAP A18, A17)
# --------------------------------------------------------------------------

#: The port's PIM examples, each with the kernel entries it must launch on
#: the card (no plain version may run): B1 fused for the elementwise calls,
#: B1 io for ``dot``/``gemv``'s tree levels and ``pim_linear_i8``.
EXAMPLES = (("quickstart.py", ("slot_scan_fused",)),
            ("pim_linear_inference.py", ("slot_scan_io",)),
            ("pim_gemv.py", ("slot_scan_fused", "slot_scan_io")),
            ("pim_serving.py", ("slot_scan_fused",)),
            ("pim_streaming.py", ("slot_scan_fused",)))
#: The examples' correctness flags: each must read ``True``.
EXAMPLE_FLAGS = ("bit-exact: ", "exact vs numpy: ", "agrees: ")
#: The decode cell the offload planner reckons (its ``report`` default).
OFFLOAD_CELL = (128, 32768)
#: The archs whose op classes are measured on the card: the two that
#: ``benchmarks/run.py``'s offload rows plan.
OFFLOAD_ARCHS = ("rwkv6-1.6b", "qwen3-8b")
#: The planner's op classes that are adds; the rest are multiplies.
OFFLOAD_ADDS = ("residual adds", "kv-cache append")
#: Elements of the Fig. 9 library add on the card: the PIM's 64 Mi rows.
FIG9_ELEMS = 64 << 20


def run_example(path: Path, argv=()) -> str:
    """Run the script at ``path`` in this process as ``__main__`` with
    ``sys.argv`` set, and return what it printed."""
    import contextlib
    import runpy
    saved, sys.argv = sys.argv, [str(path), *argv]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            runpy.run_path(str(path), run_name="__main__")
    finally:
        sys.argv = saved
    return buf.getvalue()


def example_flags_hold(text: str) -> bool:
    """Whether every correctness flag in ``text`` reads ``True``."""
    for flag in EXAMPLE_FLAGS:
        for part in text.split(flag)[1:]:
            if not part.startswith("True"):
                return False
    return bool(text.strip())


def examples_phase(gpu: str) -> dict:
    """Each script of ``examples_torch/`` on the card, in process, under
    :func:`_counted`: its lines, its seconds and its launches.  A script's
    own asserts, a flag that is not ``True`` or a kernel that did not
    launch raise.  Returns script -> (seconds, launches)."""
    root = Path(__file__).resolve().parent / "examples_torch"
    out = {}
    for script, keys in EXAMPLES:
        text, launches, s = _counted(f"example {script}", keys,
                                     lambda: run_example(root / script))
        for line in text.splitlines():
            print(f"example {script}: {line}", flush=True)
        if not example_flags_hold(text):
            raise AssertionError(f"example {script}: a flag is not True")
        print(f"example {script}: {gpu}; {s:.3f} s, launches {launches}, "
              "plain calls 0", flush=True)
        out[script] = (s, launches)
    return out


def offload_phase(gpu: str, device: str = "cuda") -> dict:
    """The offload planner under the H100 entry for every ``--arch`` at
    :data:`OFFLOAD_CELL`, with the count of op classes that offload; for
    :data:`OFFLOAD_ARCHS`, each class's bandwidth-bound op measured on the
    card (one bf16 ``add`` or ``mul`` over its elements: two reads, one
    write, as the planner's 3 x 2 B assumes; CUDA events, the mean of 50
    launches as the "time" lines) beside the planner's time; and the
    paper's Fig. 9 lines against the card.  Printed findings: only an
    exception fails the phase.  Returns the measured classes."""
    from repro_torch.configs import registry
    from repro_torch.core import bitparallel, bitserial, bitserial_fp, offload
    from repro_torch.core.device_model import H100_GPU, PIM_DEFAULT
    from repro_torch.core.floatfmt import FP32
    batch, seq = OFFLOAD_CELL
    n_off = n_all = 0
    for cfg in registry.ARCHS.values():
        for line in offload.report(cfg, batch, seq).splitlines():
            print(f"offload plan: {line}", flush=True)
        plans = offload.decode_step_plan(cfg, batch, seq)
        n_off += sum(p.offload for p in plans)
        n_all += len(plans)
    print(f"offload plan: {gpu}; under {H100.name} "
          f"({H100.hbm_bw / 1e12:g} TB/s) {n_off}/{n_all} op classes "
          f"offload at batch {batch} seq {seq}", flush=True)

    measured = {}
    for arch in OFFLOAD_ARCHS:
        for p in offload.decode_step_plan(registry.get(arch), batch, seq):
            a, b, c = (torch.empty(p.n_elems, dtype=torch.bfloat16,
                                   device=device).normal_()
                       for _ in range(3))
            op = torch.add if p.name in OFFLOAD_ADDS else torch.mul
            us = cuda_ms(lambda: op(a, b, out=c), 50) * 1e3
            flips = (p.pim_us < us) != p.offload
            print(f"offload measured: {gpu}; {arch} {p.name}: bf16 "
                  f"{op.__name__} of {p.n_elems} elements {us:.3f} us "
                  f"(CUDA events) against the planner's {p.tpu_us:.3f} us, "
                  f"measured / planned {us / p.tpu_us:.3f}; PIM "
                  f"{p.pim_us:.3f} us: planned "
                  f"{'YES' if p.offload else 'no'}, measured "
                  f"{'YES' if p.pim_us < us else 'no'}"
                  f"{' (flips)' if flips else ''}", flush=True)
            measured[(arch, p.name)] = (us, p.tpu_us, p.pim_us)
            del a, b, c

    roof = H100_GPU.throughput_ops(4)
    rates = {}
    for dtype in (torch.int32, torch.float32):
        x, y = (torch.ones(FIG9_ELEMS, dtype=dtype, device=device)
                for _ in range(2))
        ms = cuda_ms(lambda: x + y, 50)
        rates[dtype] = FIG9_ELEMS / (ms * 1e-3)
        print(f"fig9 measured: {gpu}; a + b over {FIG9_ELEMS} "
              f"{str(dtype).removeprefix('torch.')} elements {ms:.6f} ms = "
              f"{rates[dtype] / 1e9:.1f} GOPS against the roofline "
              f"{roof / 1e9:.1f} GOPS (3 x 4 B at "
              f"{H100_GPU.mem_bw / 1e12:g} TB/s)", flush=True)
        del x, y
    for name, prog, dtype in (
            ("int32 add", bitserial.build_add(32), torch.int32),
            ("fp32 add", bitserial_fp.build_fp_add(FP32), torch.float32),
            ("int32 add (bit-parallel)", bitparallel.build_bp_add(32),
             torch.int32)):
        cost = prog.parallel_cost() or prog.cost()
        thr = PIM_DEFAULT.throughput_ops(cost)
        print(f"fig9 {name}: {gpu}; PIM {thr / 1e9:.1f} GOPS modeled over "
              f"{PIM_DEFAULT.parallel_rows >> 20} Mi rows = "
              f"{thr / roof:.1f}x the H100 roofline, "
              f"{thr / rates[dtype]:.1f}x the measured a + b", flush=True)
    return measured


def fold_bound(outer: int, k: int, inner: int, lop_rate: float) -> tuple:
    """Least time of B6 on ``outer x k x inner`` words: the block read
    and the fold written once at the HBM rate, against one 32-bit XOR a
    word read at ``lop_rate``."""
    t_bytes = 4 * outer * inner * (k + 1) / H100.hbm_bw * 1e3
    t_ops = outer * k * inner / lop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def measure_folds(chunk_rows: int, folds: dict, worst: dict,
                  gpu: str) -> list:
    """Phase 10 for B6: the check fold on its two main paths beside its
    plain version and its bound.  Fused: one chunk of the faulty fp_add's
    one port, ``(1, chunk_rows)``, where ``blk[0].clone()`` computes the
    same function (the library time).  Packed: each block the faulty gemv
    folded (``folds["check_words_io_shapes"]``, recorded by
    :func:`folded_shapes`), the row's times and bound the means over the
    gemv's launches; torch has no XOR reduction over a longer axis, so
    this row has no library time.  The bound reads the block at the HBM
    rate, so the row's times are :func:`cold_ms`'s (each call's block read
    from device memory); each block also prints its time in L2
    (:func:`cuda_ms`, its state on the path) and its share of the bound,
    and a row of several blocks its share over the blocks at or under
    their bound."""
    from repro_torch.kernels import pim_exec, ref as kref
    sm_clock_hz = float(smi("clocks.max.sm").split()[0]) * 1e6
    lop_rate = N_SMS * LOPS_PER_SM_CLOCK * sm_clock_hz
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    cases = {"check_words_fused": {((1, chunk_rows), 0): 1},
             "check_words_io": folds["check_words_io_shapes"]}
    rows = []
    for key, shapes in cases.items():
        fused = key == "check_words_fused"
        sums = np.zeros(4)                      # ms, plain, lib, bound
        under = np.zeros(2)                     # bound, ms at share <= 1
        n_all = sum(shapes.values())
        bound_of = {}                           # bound_by -> its share
        for (shape, axis), n in sorted(shapes.items()):
            blk = torch.randint(-(1 << 31), 1 << 31, shape,
                                dtype=torch.int32, device="cuda",
                                generator=g)
            ms = cold_ms(lambda b: pim_exec.check_words(b, axis), blk, 200)
            warm_ms = cuda_ms(lambda: pim_exec.check_words(blk, axis), 200)
            plain_ms = cold_ms(lambda b: kref.check_words(b, axis), blk, 20)
            lib_ms = cold_ms(lambda b: b[0].clone(), blk, 200) if fused \
                else float("nan")
            outer = int(np.prod(shape[:axis]))
            inner = int(np.prod(shape[axis + 1:]))
            bound_ms, bound_by = fold_bound(outer, shape[axis], inner,
                                            lop_rate)
            sums += n * np.array([ms, plain_ms, lib_ms, bound_ms])
            if bound_ms <= ms:
                under += n * np.array([bound_ms, ms])
            bound_of[bound_by] = bound_of.get(bound_by, 0) + n * bound_ms
            lib = (f"library {lib_ms:.6f} ms (blk[0].clone(); "
                   f"{cuda_ms(lambda: blk[0].clone(), 200):.6f} in L2)") \
                if fused else \
                "library none (torch has no XOR reduction)"
            print(f"time {key}: {gpu}; block {shape} folded over axis "
                  f"{axis}, {n} of the path's {n_all} launches; kernel "
                  f"{ms:.6f} ms/launch from device memory ({warm_ms:.6f} "
                  f"with the block in L2); plain {plain_ms:.6f} ms; "
                  f"{lib}; bound {bound_ms:.6f} ms ({bound_by}), "
                  f"{bound_ms / ms:.3f} of it", flush=True)
        ms, plain_ms, lib_ms, bound_ms = sums / n_all
        bound_by = max(bound_of, key=bound_of.get)
        if len(shapes) > 1:
            print(f"time {key}: {gpu}; mean over the path's {n_all} "
                  f"launches of {len(shapes)} shapes, from device memory: "
                  f"kernel {ms:.6f} ms/launch; plain {plain_ms:.6f} ms; "
                  f"bound {bound_ms:.6f} ms ({bound_by}); over the launches "
                  "of blocks at or under their bound "
                  f"{under[0] / max(under[1], 1e-30):.3f}"
                  " of it", flush=True)
        replaces, source = ENTRIES["check_words"]
        rows.append({
            "name": key, "route": "cuda", "source": source,
            "replaces": replaces, "launches": folds[key],
            "max_abs_err": worst["check_words"], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if np.isnan(lib_ms) else lib_ms})
    return rows


#: The decode-attention kernel's timed shape: the benchmark cell
#: ``qwen3-8b-decode-b256``'s batch, cache slots, query heads, KV heads and
#: head dim, and the positions timed.
DECODE_ATTN_CELL = (256, 576, 32, 8, 128)
DECODE_ATTN_POSITIONS = (287, 575)


def decode_attn_bytes(b: int, kh: int, hd: int, p: int,
                      itemsize: int = 2) -> int:
    """The bytes decode attention must move at position ``p``: the keys
    and values of slots 0..p read once (1,048,576 (p + 1) B a layer at
    the cell in bfloat16); the query and output are under 0.1 % of it."""
    return 2 * b * kh * hd * itemsize * (p + 1)


def decode_attn_exact(q, k, v, p: int):
    """Decode attention of q [B, 1, H, hd] over k, v [B, S, K, hd] at the
    slots 0..p, in float64: what the kernel and the plain version are
    held to."""
    b, _, h, hd = q.shape
    kh = k.shape[2]
    q64 = q.double().reshape(b, kh, h // kh, hd)
    sc = torch.einsum("bkgd,bskd->bkgs", q64, k[:, :p + 1].double())
    a = torch.softmax(sc / math.sqrt(hd), -1)
    return torch.einsum("bkgs,bskd->bkgd", a,
                        v[:, :p + 1].double()).reshape(b, 1, h, hd)


def measure_decode_attn(gpu: str) -> list:
    """Phase 10 for the decode-attention kernel: at the cell's shape
    (:data:`DECODE_ATTN_CELL`, bfloat16) and each position of
    :data:`DECODE_ATTN_POSITIONS`, its time beside its bytes bound, the
    plain ``_group_attn`` (what the LM ran before the kernel) and one
    ``scaled_dot_product_attention`` call over the slots up to the
    position (the library yardstick; the port never calls it).  The
    caches (302 MB each) are far over the 50 MB L2, so each launch reads
    them from device memory.  Raises where an output's error against
    :func:`decode_attn_exact` exceeds the plain version's largest by more
    than one bfloat16 ulp of the output, or a call launches other than
    once."""
    from repro_torch.kernels import attention, pim_exec
    b, s, h, kh, hd = DECODE_ATTN_CELL
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda")
               .to(torch.bfloat16)
               for shape in ((b, 1, h, hd), (b, s, kh, hd), (b, s, kh, hd)))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rows = []
    for p in DECODE_ATTN_POSITIONS:
        pos = torch.full((b, 1), p, dtype=torch.long, device="cuda")
        before = pim_exec.LAUNCHES["decode_attn"]
        got = attention.decode_attn(q, k, v, pos)
        launches = pim_exec.LAUNCHES["decode_attn"] - before
        want = decode_attn_exact(q, k, v, p)
        err = (got.double() - want).abs()
        plain_err = float((attention.plain(q, k, v, pos).double() - want)
                          .abs().max())
        # one bfloat16 ulp of each output: 2 ** (exponent - 7)
        ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(
            torch.finfo(torch.bfloat16).tiny))) - 7)
        bad = int((err > plain_err + ulp).sum())
        err = float(err.max())
        del want, ulp
        ms = cuda_ms(lambda: attention.decode_attn(q, k, v, pos), 50)
        plain_ms = cuda_ms(lambda: attention.plain(q, k, v, pos), 5)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k[:, :p + 1],
                                                   v[:, :p + 1]))
        lib_ms = cuda_ms(lambda: sdpa(qt, kt, vt, enable_gqa=True), 50)
        nbytes = decode_attn_bytes(b, kh, hd, p)
        bound_ms = nbytes / H100.hbm_bw * 1e3
        key = f"decode_attn@p{p}"
        print(f"time {key}: {gpu}; q [{b}, 1, {h}, {hd}] over k, v [{b}, "
              f"{s}, {kh}, {hd}] bf16 up to slot {p}: kernel {ms:.6f} "
              f"ms/launch ({launches} launch a call), {bound_ms / ms:.3f} "
              f"of its bound; plain _group_attn {plain_ms:.6f} ms; library "
              f"{lib_ms:.6f} ms (scaled_dot_product_attention, "
              f"enable_gqa); bound {bound_ms:.6f} ms (bytes: {nbytes} B at "
              f"{H100.hbm_bw / 1e12:g} TB/s); max error against float64 "
              f"{err} (plain {plain_err}; {bad} outputs over the plain "
              f"error plus one bf16 ulp)", flush=True)
        if bad or launches != 1:
            raise AssertionError(f"time {key}: {bad} outputs over the "
                                 f"plain error plus one ulp, {launches} "
                                 f"launches")
        rows.append({
            "name": key, "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attn.cu",
            "replaces": "none (the einsums of _group_attn)",
            "launches": launches, "max_abs_err": err,
            "plain_max_abs_err": plain_err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": "bytes",
            "library_ms": lib_ms})
    return rows


def fold_turns(progs, chunk_rows: int, io_shapes: dict, gpu: str) -> None:
    """B1 io under rows64 (uint32 add at one chunk, as :func:`measure`
    times it) twice in turns with B6's two rows (the fused chunk and the
    gemv's most launched block): whether B1 io rows64's time moves between
    runs of one call."""
    from repro_torch.kernels import pim_exec
    rng = np.random.default_rng(SEED)
    c = schedule_of(progs, "uint32 add", "slots", 2)
    x = random_inputs(c, chunk_rows, False, rng)
    (shape, axis), _ = max(io_shapes.items(),
                           key=lambda kv: (kv[1], np.prod(kv[0][0])))
    blocks = {"B6 fused": ((1, chunk_rows), 0), "B6 io": (shape, axis)}
    runs = {"B1 io rows64": lambda: run_entry(c, x, False, True)}
    for label, (shape, axis) in blocks.items():
        blk = torch.randint(-(1 << 31), 1 << 31, shape, dtype=torch.int32,
                            device="cuda")
        runs[label] = (lambda blk=blk, axis=axis:
                       pim_exec.check_words(blk, axis))
    for rep in range(2):
        for label, fn in runs.items():
            ms = cuda_ms(fn, 200 if label.startswith("B6") else 50)
            what = f"block {blocks[label][0]}" if label in blocks else \
                f"uint32 add rows={chunk_rows}"
            print(f"turns-time {label} run {rep}: {gpu}; {what} kernel "
                  f"{ms:.6f} ms/launch", flush=True)


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
    t_bytes = nbytes / H100.hbm_bw * 1e3
    t_ops = ops / lop_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


#: Shared-memory sizes (KB) an H100 SM can split off its 256 KB of L1 and
#: shared memory (the carveout); the rest is L1.
CARVEOUTS_KB = (0, 8, 16, 32, 64, 100, 132, 164, 196, 228)

#: entry -> the kernel (template instance by planes and fused) the launch
#: attributes are read from: the window body of the main path's streams
#: (6 records for a slot level, 8 for a dense level, 2 for the gate-serial
#: stream).  B1 and B3 are one template of ring.cuh.
INFO_KERNELS = {
    "slot_scan": "ring::level_kernel<6, {p}, {f}>",
    "level_gather": "ring::level_kernel<8, {p}, {f}>",
    "gate_serial": "gate_serial_kernel<2>",
}
#: The same in a parent's sources (``--probe DIR``) whose slot scan reads
#: its schedule through index arrays (its ``pim_exec`` has no
#: ``ring_shape``); a later parent has this tree's names.
PRE_RING_KERNELS = {
    "slot_scan": "slot_scan_kernel<{p}, {f}>",
    "level_gather": "level_gather_kernel<8, {p}, {f}>",
    "gate_serial": "gate_serial_kernel<2>",
}

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
    generated file that includes the source, built by ``px.build`` like B2
    (``px`` is this tree's ``pim_exec`` or the parent's, whose headers the
    source includes).  ``source`` defaults to the port's own file for
    ``entry``, ``kernel`` to its entry in :data:`INFO_KERNELS`."""

    def __init__(self, entry: str, source=None, kernel=None, px=None):
        if px is None:
            from repro_torch.kernels import pim_exec as px
        self.px = px
        source = Path(source or px.SOURCES[entry]).resolve()
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
        key = px._build_key(deps)
        self.cu = px.BUILD_DIR / f"info_{entry}-{key}.cu"
        self.so = px.BUILD_DIR / f"info_{entry}-{key}.so"

    @property
    def built(self) -> bool:
        return self.so.exists()

    def __call__(self, planes: int, fused: bool, threads: int, smem: int
                 ) -> dict:
        import ctypes
        out = (ctypes.c_int * 4)()
        err = self.px._load(self.so).kernel_info(planes, int(fused),
                                                 threads, smem, out)
        if err:
            raise RuntimeError(f"kernel_info failed: CUDA error {err}")
        per_sm = out[0] * (smem + 1024)       # 1 KB a CTA for the system
        carve = next((c for c in CARVEOUTS_KB if c * 1024 >= per_sm), 228)
        return {"ctas_per_sm": out[0], "threads": threads, "smem": smem,
                "registers": out[1], "local_bytes": out[2],
                "carveout_pref": out[3], "l1_kb": 256 - carve}


#: entry -> KernelInfo, built in phase 1 beside the kernels; B2's by
#: (program, planes) of its timed kernels.
INFO: dict = {}
STATIC_INFO: dict = {}


def ring_info(body: int):
    """The KernelInfo of the level kernel (B1 and B3) at window body
    ``body``: the main-path instance of that body (6 records for B1, 8
    for B3)."""
    for entry in ("slot_scan", "level_gather"):
        if INFO_KERNELS[entry].startswith(f"ring::level_kernel<{body},"):
            return INFO[entry]
    raise KeyError(f"no launch attributes of a {body}-record body")


def cta_shape(entry: str, n_cells: int, planes: int = 1, static=None,
              pim_exec=None) -> dict:
    """The CTA of ``entry`` at the rule's width for a state of ``n_cells``
    cells (the gate-serial state without its two constant cells;
    ``static`` the B2 kernel) in the tree of ``pim_exec`` (this one by
    default): columns, stride, threads and dynamic shared memory."""
    if pim_exec is None:
        from repro_torch.kernels import pim_exec
    word = 4 * planes
    if entry == "slots_static":
        return {"wpc": static.wpc, "stride": static.stride,
                "threads": static.threads,
                "smem": -(-n_cells * static.stride * word // 16) * 16}
    if entry == "gate_serial":
        n_cells += pim_exec.GATE_CONSTANTS
        wpc = stride = pim_exec.ring_words_per_cta(n_cells)
        lanes = pim_exec.ring_lanes(wpc)
    else:
        wpc, stride, lanes = pim_exec.ring_shape(n_cells, planes)
    return {"wpc": wpc, "stride": stride, "threads": -(-wpc // lanes) * 32,
            "smem": -(-n_cells * stride * word // 16) * 16 +
            2 * 8 * pim_exec.TILE_RECORDS + 16}


def launch_attrs(info, planes: int, fused, shape: dict) -> str:
    """The launch attributes ``info`` reads at this CTA shape, as
    printed."""
    a = info(planes, bool(fused), shape["threads"], shape["smem"])
    return (f"; launch: {shape['wpc']} columns, stride {shape['stride']}, "
            f"{a['threads']} threads, {a['smem']} B shared, "
            f"{a['ctas_per_sm']} CTAs/SM, {a['registers']} registers, "
            f"{a['local_bytes']} local B, carveout preference "
            f"{a['carveout_pref']}, L1 left ~{a['l1_kb']} KB")


def pre_ring_shape(entry: str, pkg, slot, dense, serial_cells: int, static
                   ) -> dict:
    """:func:`cta_shape` for fp32 add under rows32 in a parent of
    :data:`PRE_RING_KERNELS`: ``slot`` and ``dense`` are the program
    resolved there under the slot and dense schedules, ``serial_cells``
    the gate-serial state with its constant cells, ``static`` its B2
    kernel.  Its slot scan and B2 ran one thread a column, whole warps."""
    px = pkg.pim_exec

    def ring(cells, wpc):
        return {"wpc": wpc, "stride": wpc,
                "threads": -(-wpc // px.ring_lanes(wpc)) * 32,
                "smem": -(-cells * wpc * 4 // 16) * 16 +
                2 * 8 * px.TILE_RECORDS + 16}
    if entry in ("slot_scan", "slots_static"):
        wpc = slot.words_per_cta if entry == "slot_scan" else static.wpc
        return {"wpc": wpc, "stride": wpc, "threads": (wpc + 31) // 32 * 32,
                "smem": 4 * slot.sched.n_cells * wpc}
    if entry == "level_gather":
        return ring(dense.sched.n_cells, dense.words_per_cta)
    return ring(serial_cells, px.ring_words_per_cta(serial_cells))


#: Phase 10: (entry, program, fused, planes) timed at one chunk.
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
    ("slot_scan", "fp32 add@8", True, 1),
    ("slot_scan", "fp32 add@12", True, 1),
    ("slot_scan", "fp32 add@16", True, 1),
    ("slot_scan", "fp32 add@32", True, 1),
    ("level_gather", "fp32 add@cap16", True, 1),
    ("level_gather", "fp32 add@cap32", True, 1),
    ("slots_static", "fp32 add@16", True, 1),
]


def measure(progs, statics, chunk_rows: int, launches: dict, worst: dict,
            gpu: str) -> list:
    """Phase 10: device times at the main path's shape (one chunk)."""
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
        if "@" in name:
            key += "@" + name.partition("@")[2]
        prog = program_of(progs, name)[0]
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
            cta = cta_shape(entry, n_cells)
            shape = (f"gates={len(ops_)} windows={packed.n_windows} "
                     f"cells={n_cells}")
            attrs = launch_attrs(INFO[entry], 1, False, cta)
        else:
            kind = "dense" if entry == "level_gather" else "slots"
            c = schedule_of(progs, name, kind, planes)
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
                     f"cells={s.n_cells}")
            if not static:
                shape += (f" windows={c.packed.n_windows} of "
                          f"{c.packed.width} records")
            info = STATIC_INFO[(name, planes)] if static else \
                ring_info(c.packed.width)
            attrs = launch_attrs(info, planes, fused,
                                 cta_shape(entry, s.n_cells, planes, static))
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
    """The CTA width of B1 (``pim_exec.ring_words_per_cta``) and of B2
    (``pim_exec.static_words_per_cta``, each width its own build, all built
    together) at one chunk, then the fp32 add kernel per chunk size and
    the end-to-end fp_add run phase per chunk size."""
    from repro_torch import pim_ufunc as pim
    from repro_torch.core.pim_numerics import program_for
    from repro_torch.kernels import pim_exec
    rng = np.random.default_rng(SEED)
    n = 1 << 20
    cases = [(label, program_for(*spec), fused, planes)
             for label, spec, fused, planes in (
                 ("fp16 add", ("fp-serial", "add", "fp16"), True, 1),
                 ("fp32 add", ("fp-serial", "add", "fp32"), True, 1),
                 ("fp32 add", ("fp-serial", "add", "fp32"), True, 2),
                 ("fp32 mul", ("fp-serial", "mul", "fp32"), True, 1),
                 ("uint16 add", ("int-serial", "add", 16), True, 1),
                 ("uint16 add", ("int-serial", "add", 16), True, 2),
                 ("uint32 add io", ("int-serial", "add", 32), False, 1))]
    statics = {}
    for label, prog, fused, planes in cases:
        c = operands(prog, "slots", planes)
        fit = pim_exec.fit_words_per_cta(c.sched.n_cells, 128, planes)
        for wpc in (16, 32, 64, 128):
            if fused and wpc <= fit:
                statics[(label, planes, wpc)] = static_kernel(c, wpc)
    t0 = time.perf_counter()
    logs = pim_exec.build([], static=list(statics.values()))
    print(f"sweep build: {len(logs)} static kernels in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    for (label, planes, wpc), k in statics.items():
        for line in logs.get(k.so.name, ("", 0))[0].splitlines():
            if "registers" in line or "spill" in line:
                print(f"sweep ptxas slots_static {label} planes={planes} "
                      f"words_per_cta={wpc}: {line.strip()}", flush=True)
    for label, prog, fused, planes in cases:
        c = operands(prog, "slots", planes)
        x = random_inputs(c, n, fused, rng)
        rule = c.wpc
        for wpc in ring_widths(c.sched.n_cells, planes):
            c.wpc = wpc
            ms = cuda_ms(lambda: run_entry(c, x, fused, True), 20)
            print(f"sweep slot_scan words_per_cta={wpc} (rule {rule}): "
                  f"{gpu}; {label} planes={planes} cells={c.sched.n_cells} "
                  f"rows={n} kernel {ms:.6f} ms", flush=True)
        rule = pim_exec.static_words_per_cta(c.sched.n_cells, planes)
        for wpc in (16, 32, 64, 128):
            k = statics.get((label, planes, wpc))
            if k is not None:
                ms = cuda_ms(lambda: k(x), 20)
                print(f"sweep slots_static words_per_cta={wpc} (rule "
                      f"{rule}): {gpu}; {label} planes={planes} cells="
                      f"{c.sched.n_cells} rows={n} kernel {ms:.6f} ms",
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


def ring_widths(n_cells: int, planes: int) -> list:
    """CTA widths the slot scan is swept over: 16 (the parent's), whole
    warps up to what fits one CTA beside the ring, and that fill (the
    rule, at most 128)."""
    from repro_torch.kernels import pim_exec
    fill = pim_exec.ring_words_per_cta(n_cells, planes)
    return sorted({16, fill} | set(range(32, fill + 1, 32)))


def parent_package(csrc):
    """The ``repro_torch`` package whose kernel sources are in ``csrc`` (the
    parent commit's, unpacked beside this tree), imported under its own
    name so that its wrappers and builds sit beside this tree's."""
    import importlib
    import importlib.util
    pkg = Path(csrc).resolve().parent
    alias = "parent_repro_torch"
    if alias not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            alias, pkg / "__init__.py", submodule_search_locations=[str(pkg)])
        mod = importlib.util.module_from_spec(spec)
        sys.modules[alias] = mod
        spec.loader.exec_module(mod)
    return SimpleNamespace(
        pim_exec=importlib.import_module(f"{alias}.kernels.pim_exec"),
        ops=importlib.import_module(f"{alias}.kernels.ops"),
        plan=importlib.import_module(f"{alias}.kernels.plan"),
        pim_ufunc=importlib.import_module(f"{alias}.pim_ufunc"))


def turns(a, b, gpu: str, parent) -> None:
    """The main path's run in turns with the parent's package whose
    ``csrc`` is ``parent`` (parent, this tree, this tree, parent), each
    held bit-exact against numpy: the host's ``prepare`` and, under
    ``torch.profiler``, the run phase with its copies and the device's
    busy share."""
    from repro_torch import pim_ufunc as pim
    trees = {"this tree": pim, "parent": parent_package(parent).pim_ufunc}
    trees["parent"].prepare("fp_add", a[:1], b[:1]).warm()
    for rep, tree in enumerate(("parent", "this tree", "this tree",
                                "parent")):
        t0 = time.perf_counter()
        prep = trees[tree].prepare("fp_add", a, b)
        prepare_ms = (time.perf_counter() - t0) * 1e3
        got, wall, st = device_timeline(prep.run)
        if not _same_bits(got, a + b):
            raise AssertionError(f"turns: {tree} fp_add differs from numpy")
        timeline_line(f"turns {tree} run {rep}: fp_add fp32 rows={len(a)} "
                      f"(prepare {prepare_ms:.3f} ms, then the run phase)",
                      wall, st, gpu)


def probe_runs(progs, pkg) -> dict:
    """Launches of ``pkg``'s kernels at the main path's chunk (1 Mi rows):
    B1 (fused and rows64 on fp32 add, io on uint32 add), B2 (fp32 add,
    both layouts), B3 (fp32 add) and B4 (fp32 add), each at its tree's own
    CTA rule, and B1, B2 and B3 with every level taken out ("no gates":
    the fused bridges, the state's zeroing and the launch alone).  ``pkg``
    is this tree's package or the parent's (:func:`parent_package`); each
    entry gets its schedule through the API its tree has, on the same
    seeded inputs.  Returns label -> (fn, result to hold, or None)."""
    import inspect
    px = pkg.pim_exec
    rng = np.random.default_rng(SEED)
    n = 1 << 20
    runs = {}

    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).cuda()

    def bits(shape):
        return torch.from_numpy(rng.integers(
            0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32).view(
                np.int32)).cuda()

    def packed(fn, pack, a, b, o, n_cells):
        """The stream ``fn`` runs, where this tree's ``fn`` takes one."""
        if "packed" not in inspect.signature(fn).parameters:
            return {}
        return {"packed": pack(a, b, o, n_cells=n_cells).to("cuda")}

    for name, kind, fused in (("fp32 add", "slots", True),
                              ("fp32 add", "dense", True),
                              ("uint32 add", "slots", False)):
        prog = progs[name]
        plan = pkg.plan.as_plan(device="cuda", schedule=kind)
        s = pkg.ops.compiled(prog, plan).get_schedule(prog, plan)
        in_names = sorted(prog.in_ports)
        out_names = pkg.ops.output_names(s)
        in_cells = pkg.ops._stacked_cells([s.pack_cells(n_) for n_ in
                                           in_names])
        out_cells = pkg.ops._stacked_cells([s.ports[n_] for n_ in
                                            out_names])
        in_widths = tuple(len(s.pack_cells(n_)) for n_ in in_names)
        out_widths = tuple(len(s.ports[n_]) for n_ in out_names)
        sched = (dev(in_cells), dev(s.a), dev(s.b), dev(s.out),
                 dev(out_cells))
        none = tuple(dev(np.zeros((0, s.width), np.int32)) for _ in "abo")
        kw = dict(n_cells=s.n_cells, one_cell=s.one_cell)
        label = "B1" if kind == "slots" else "B3"
        if not fused:
            fn = px.slots_io
            rows = bits((len(in_cells), n // 32))
            kw.update(k_out=len(out_cells),
                      **packed(fn, getattr(px, "pack_slots", None), s.a,
                               s.b, s.out, s.n_cells))
            runs["B1 io uint32 add"] = (
                lambda fn=fn, a=(rows,) + sched, kw=kw: fn(*a, **kw))
            continue
        fn = px.slots_fused if kind == "slots" else px.level_fused
        pack = px.pack_levels if kind == "dense" else \
            getattr(px, "pack_slots", None)
        vals = rng.integers(0, 1 << 32, (len(in_widths), n),
                            dtype=np.uint64).astype(np.uint32)
        vals &= np.array([(1 << w) - 1 for w in in_widths],
                         np.uint32)[:, None]
        x = torch.from_numpy(vals.view(np.int32)).cuda()
        kw.update(in_widths=in_widths, out_widths=out_widths)
        for planes in ((1, 2) if kind == "slots" else (1,)):
            kp = dict(kw, planes=planes,
                      **packed(fn, pack, s.a, s.b, s.out, s.n_cells))
            sfx = "" if planes == 1 else " rows64"
            runs[f"{label}{sfx}"] = (
                lambda fn=fn, a=(x,) + sched, kw=kp: fn(*a, **kw))
        empty = packed(fn, px.pack_levels, np.zeros((0, 0)),
                       np.zeros((0, 0)), np.zeros((0, 0)), 1)
        runs[f"{label} no gates"] = (
            lambda fn=fn, a=(x, sched[0]) + none + (sched[4],),
            kw=dict(kw, **empty): fn(*a, **kw))
        if kind == "slots":
            for planes in (1, 2):
                k = px.StaticKernel(s, in_widths, out_widths, out_names,
                                    in_cells, planes=planes)
                k.build()
                sfx = "" if planes == 1 else " rows64"
                runs[f"B2{sfx}"] = (lambda k=k, x=x: k(x))
            empty = dataclasses.replace(s, a=s.a[:0], b=s.b[:0],
                                        out=s.out[:0],
                                        level_width=s.level_width[:0])
            k = px.StaticKernel(empty, in_widths, out_widths, out_names,
                                in_cells)
            k.build()
            runs["B2 no gates"] = (lambda k=k, x=x: k(x))
    ops_, a, b, o, n_cells = progs["fp32 add"].to_arrays()
    state = bits((n_cells, n // 32))
    gates_ = [dev(v) for v in (ops_, a, b, o)]
    stream = px.pack_gates(ops_, a, b, o, n_cells=n_cells).to("cuda")
    runs["B4"] = (lambda: px.gate_serial(state, *gates_, packed=stream))
    return runs


def probe(progs, statics, gpu: str, parent, folds: dict,
          chunk_rows: int) -> None:
    """What holds B1 and B2 back: the launch attributes of this tree's
    slot scan (B1), static kernel (B2, fp32 add), level gather (B3) and
    gate-serial kernel (B4) and, when ``parent`` names the parent's
    ``csrc`` directory, of the parent's, at the shapes each launches for
    fp32 add (with the parent's B2 ``ptxas`` report); then the kernels of
    :func:`probe_runs` at 1 Mi rows, this tree's and the parent's in
    turns (parent, tree, tree, parent) with one timer, each result held
    equal between the two, and this tree's B1 on windows of 6 and of 8
    records; with ``parent``, :func:`fold_probe` on the blocks the faulty
    gemv folded (``folds``); last :func:`fold_turns`."""
    from repro_torch.kernels import ops, pim_exec, plan as kplan
    prog = progs["fp32 add"]
    static = statics[("fp32 add", 1)]
    trees = {"this tree": SimpleNamespace(pim_exec=pim_exec, ops=ops,
                                          plan=kplan)}
    if parent:
        trees["parent"] = parent_package(parent)
    for tree, pkg in trees.items():
        px = pkg.pim_exec
        r = resolved(prog, pkg=pkg)
        k = static if tree == "this tree" else px.StaticKernel(
            r.sched, r.in_widths, r.out_widths, r.names,
            ops._stacked_cells([r.sched.pack_cells(n)
                                for n in sorted(prog.in_ports)]))
        if tree != "this tree":
            for line in k.build().get(k.so.name, ("", 0))[0].splitlines():
                if "registers" in line or "spill" in line:
                    print(f"probe ptxas {tree} slots_static fp32 add: "
                          f"{line.strip()}", flush=True)
        ring = hasattr(px, "ring_shape")
        kernels = INFO_KERNELS if ring else PRE_RING_KERNELS
        infos = {e: KernelInfo(e, Path(px.CSRC) / f"{e}.cu", kernels[e], px)
                 for e in kernels}
        infos["slots_static"] = KernelInfo("slots_static", k.cu,
                                           "slots_static_kernel", px)
        px.build([], static=list(infos.values()))
        dense = resolved(prog, pkg=pkg, schedule="dense")
        n_serial = prog.to_arrays()[4]
        for e, info in infos.items():
            if ring:
                cells = {"level_gather": dense.sched.n_cells,
                         "gate_serial": n_serial}.get(e, r.sched.n_cells)
                shape = cta_shape(e, cells, 1, k, px)
            else:
                shape = pre_ring_shape(e, pkg, r, dense,
                                       n_serial + px.GATE_CONSTANTS, k)
            print(f"probe attrs {tree} {e} fp32 add: {gpu}"
                  f"{launch_attrs(info, 1, e != 'gate_serial', shape)}",
                  flush=True)

    runs = {tree: probe_runs(progs, pkg) for tree, pkg in trees.items()}
    # B1's window body: 6 records a slot level (the rule) against 8, the
    # two records past the level repeating its last lane
    rng = np.random.default_rng(SEED)
    c6 = operands(prog, "slots", 1)
    s6 = c6.sched
    band = s6.out[:, :1] + np.arange(s6.width)

    def pad(m):
        return np.concatenate([m, np.repeat(m[:, -1:], 2, axis=1)], axis=1)
    c8 = SimpleNamespace(**vars(c6))
    c8.packed = pim_exec.pack_levels(pad(s6.a), pad(s6.b), pad(band),
                                     n_cells=s6.n_cells).to("cuda")
    x = random_inputs(c6, 1 << 20, True, rng)
    want = run_entry(c6, x, True, False)
    for label, c in (("windows of 6", c6), ("windows of 8", c8)):
        got = run_entry(c, x, True, True)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe B1 {label} != plain version")
        runs["this tree"][f"B1 {label}"] = (
            lambda c=c: run_entry(c, x, True, True))
    # each kernel that gives a result: the parent's and this tree's agree
    for label, fn in runs.get("parent", {}).items():
        if "no gates" in label:
            continue
        got, want = runs["this tree"][label](), fn()
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"probe {label}: this tree != parent")
    order = ["parent", "this tree", "this tree", "parent"] if parent \
        else ["this tree", "this tree"]
    for rep, tree in enumerate(order):             # in turns
        for label, fn in runs[tree].items():
            ms = cuda_ms(fn, 50)
            print(f"probe time {label} {tree} run {rep}: {gpu}; fp32 add "
                  f"(B1 io: uint32 add) rows={1 << 20} kernel {ms:.6f} "
                  "ms/launch", flush=True)
    if parent:
        fold_probe(gpu, parent, folds, chunk_rows)
    fold_turns(progs, chunk_rows, folds, gpu)


def fold_probe(gpu: str, parent, folds: dict, chunk_rows: int = 1 << 20):
    """B6 of this tree and of the parent's package whose ``csrc`` is
    ``parent`` in turns (parent, tree, tree, parent), each result held
    equal between the two: on the fused chunk ``(1, chunk_rows)`` and on
    each block of ``folds`` ((shape, axis) -> launches: the faulty gemv's,
    as the verified phase prints them), with the mean over their
    launches; the blocks in L2, as on the path.  Alone, without the
    smoke's phases::

        python3 -c "import chip_smoke as c; c.fold_probe(c.smi('name,power.limit'), 'PARENT/src/repro_torch/csrc', {((16, 1 << e), 0): 2 for e in range(7, 20)})"
    """
    from repro_torch.kernels import pim_exec
    trees = {"parent": parent_package(parent).pim_exec,
             "this tree": pim_exec}
    g = torch.Generator(device="cuda")
    g.manual_seed(SEED)
    blocks = {((1, chunk_rows), 0): 0, **folds}
    bits = {key: torch.randint(-(1 << 31), 1 << 31, key[0], dtype=torch.int32,
                               device="cuda", generator=g) for key in blocks}
    for (shape, axis), blk in bits.items():
        got, want = (px.check_words(blk, axis) for px in trees.values())
        if not torch.equal(got, want):
            raise AssertionError(f"fold probe {shape}: this tree != parent")
    for rep, tree in enumerate(("parent", "this tree", "this tree",
                                "parent")):
        px, mean = trees[tree], 0.0
        for (shape, axis), n in blocks.items():
            ms = cuda_ms(lambda: px.check_words(bits[(shape, axis)], axis),
                         200)
            mean += n * ms
            print(f"probe time B6 {shape} axis {axis} {tree} run {rep}: "
                  f"{gpu}; kernel {ms:.6f} ms/launch, the block in L2",
                  flush=True)
        print(f"probe time B6 gemv mean {tree} run {rep}: {gpu}; over the "
              f"faulty gemv's {sum(folds.values())} folds "
              f"{mean / sum(folds.values()):.6f} ms/launch", flush=True)


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
                split=split))
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
                    help="also sweep B1's and B2's words_per_cta and "
                    "chunk_rows")
    ap.add_argument("--split-probe", action="store_true",
                    help="also build B2 whole and split on three programs "
                    "and compare build seconds, ptxas reports and times")
    ap.add_argument("--turns", metavar="PARENT_CSRC",
                    help="also run the main path in turns with the parent's "
                    "package whose csrc is PARENT_CSRC, profiled")
    ap.add_argument("--probe", nargs="?", const="", default=None,
                    metavar="PARENT_CSRC",
                    help="also print the launch attributes of B1 to B4 and "
                    "time B1, B2 and B3 with no gates and B6 on the gemv's "
                    "blocks, this tree's and (given PARENT_CSRC) the "
                    "parent's in turns")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")

    from repro_torch.kernels import pim_exec, plan as kplan
    progs = programs()
    statics = static_kernels(progs)
    INFO.update({e: KernelInfo(e) for e in INFO_KERNELS})
    pim_exec.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for entry, name, _, planes in TIMED:
        if entry == "slots_static":      # its source, for the info to read
            k = statics[(name, planes)]
            k.cu.write_text(k.source)
            STATIC_INFO[(name, planes)] = KernelInfo(
                "slots_static", k.cu, "slots_static_kernel")
    t0 = time.perf_counter()
    logs = pim_exec.build(static=list(statics.values()) +
                          list(INFO.values()) + list(STATIC_INFO.values()))
    print(f"build: {len(logs)} sources in {time.perf_counter() - t0:.1f} s",
          flush=True)
    names = {k.so.name: f"{prog} planes={planes}"
             for (prog, planes), k in statics.items()}
    names.update({k.so.name: f"launch attributes of {e}"
                  for e, k in INFO.items()})
    names.update({k.so.name: f"launch attributes of B2 {prog} planes={p}"
                  for (prog, p), k in STATIC_INFO.items()})
    for name, (log, secs) in logs.items():
        print(f"build {name} ({names.get(name, 'fixed source')}): "
              f"{secs:.1f} s", flush=True)
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    gpu = smi("name,power.limit")
    print(gpu, flush=True)
    chunk_rows = kplan.DEFAULT_CHUNK_ROWS

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {name}: {time.perf_counter() - t0:.1f} s", flush=True)
        return out

    worst = phase("check", check_kernels, progs, statics)
    phase("check folds", check_folds, worst)
    main = phase("main", main_path)
    unsharded = phase("streaming", streaming_phase, main["a"], main["b"],
                      gpu)
    phase("groups", groups_phase)
    phase("sharding", sharding_phase, main["a"], main["b"], unsharded)
    phase("reductions", reductions_phase, gpu)
    phase("fused", fused_phase, gpu)
    folds = phase("verified", verified_phase, main["a"], main["b"], gpu)
    phase("serving", serving_phase, gpu)
    phase("tune", tune_phase, gpu)
    phase("warm-start", warm_start_phase, gpu)
    phase("lm", lm_phase, gpu)
    phase("lm families", lm_families_phase, gpu)
    phase("train", train_phase, gpu)
    phase("mesh", mesh_phase, gpu)
    kernels = phase("time", lambda: measure(
        progs, statics, chunk_rows, main["launches"], worst, gpu)
        + measure_folds(chunk_rows, folds, worst, gpu)
        + measure_decode_attn(gpu))
    phase("examples", examples_phase, gpu)
    phase("offload", offload_phase, gpu)
    if args.turns:
        turns(main["a"], main["b"], gpu, args.turns)
    if args.probe is not None:
        probe(progs, statics, gpu, args.probe,
              folds["check_words_io_shapes"], chunk_rows)
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
