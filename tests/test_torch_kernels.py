"""The slot-scan kernel's wrappers, launch shape and, on the card, the CUDA
kernel against its plain PyTorch version.

This file imports neither JAX nor the JAX package, so it runs on a machine
with an NVIDIA GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

The ``cuda``-marked tests skip without a card (the kernel has no CPU mode);
the others run everywhere.
"""

import numpy as np
import pytest
import torch

from repro_torch import pim_ufunc as pim
from repro_torch.core import gates
from repro_torch.core.pim_numerics import program_for
from repro_torch.kernels import ops
from repro_torch.kernels import pim_exec
from repro_torch.kernels import plan as kplan
from repro_torch.kernels import slots

_FULL = np.uint32(0xFFFFFFFF)
CPU_PLAN = kplan.as_plan(backend="ref", device="cpu")


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _bits(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _gate_free():
    b = gates.Builder()
    x = b.input("x", 8)
    b.output("z", x)
    return b.finish()


def _no_input():
    b = gates.Builder()
    c1, c0 = b.const(1), b.const(0)
    b.output("ones", [c1, b.not_(c0), c1])
    b.output("mix", [c0, c1, c0, c1])
    return b.finish()


PROGRAMS = {
    "fp16-add": lambda: program_for("fp-serial", "add", "fp16"),
    "fp32-add": lambda: program_for("fp-serial", "add", "fp32"),
    "fp32-mul": lambda: program_for("fp-serial", "mul", "fp32"),
    "fp32-div": lambda: program_for("fp-serial", "div", "fp32"),
    "uint16-add": lambda: program_for("int-serial", "add", 16),
    "uint32-add": lambda: program_for("int-serial", "add", 32),
    "uint32-mul": lambda: program_for("int-serial", "mul", 32),
    # int-parallel programs fold no INIT1 cell (one_cell is None)
    "bp-mul16": lambda: program_for("int-parallel", "mul", 16),
    "gate-free": _gate_free,
    "no-input": _no_input,
}


def _resolved(name, device="cpu", **backend_kw):
    prog = PROGRAMS[name]()
    backend = kplan.Backend("ref" if device == "cpu" else "cuda",
                            **backend_kw)
    plan = kplan.as_plan(backend=backend, device=device)
    return ops.compiled(prog, plan).resolve(prog, plan,
                                            tuple(sorted(prog.in_ports)))


def _values(r, rng, n_rows):
    vals = _bits(rng, (len(r.in_widths), n_rows))
    for p, w in enumerate(r.in_widths):
        vals[p] &= np.uint32((1 << w) - 1)
    return vals


def _call(entry, r, x, **kw):
    args = (x, r.in_idx, r.la, r.lb, r.lo, r.out_idx)
    common = dict(n_cells=r.sched.n_cells, one_cell=r.one_cell,
                  in_base=r.in_base, out_base=r.out_base, **kw)
    if entry == "fused":
        return pim_exec.slots_fused(*args, in_widths=r.in_widths,
                                    out_widths=r.out_widths, **common)
    return pim_exec.slots_io(*args, k_out=r.k_out, **common)


def _oracle_rows(r, in_rows: np.ndarray) -> np.ndarray:
    """Output port rows from the numpy oracle
    (``LevelSchedule.exec_packed``)."""
    s = r.sched
    st = np.zeros((s.n_cells, in_rows.shape[1]), np.uint32)
    st[_np(r.in_idx).view(np.int32)] = in_rows
    if s.one_cell is not None:
        st[s.one_cell] = _FULL
    s.exec_packed(st)
    return st[_np(r.out_idx).view(np.int32)]


# --------------------------------------------------------------------------
# everywhere: the wrappers on the CPU, the launch shape, the build
# --------------------------------------------------------------------------

def test_wrappers_take_the_plain_version_on_cpu_tensors():
    r = _resolved("uint16-add")
    rng = np.random.default_rng(0)
    vals = _values(r, rng, 64)
    rows = _bits(rng, (int(r.in_idx.numel()), 2))
    pim_exec.reset_counts()
    got = _call("fused", r, _t(vals))
    sub = _call("io", r, _t(rows))
    assert slots.CALLS == {"slots_fused": 1, "slots_io": 1}
    assert pim_exec.LAUNCHES == {"slot_scan_fused": 0, "slot_scan_io": 0}
    assert np.array_equal(_np(got)[0], vals[0] + vals[1])
    assert np.array_equal(_np(sub), _oracle_rows(r, rows))
    pim_exec.reset_counts()
    assert not any(slots.CALLS.values())


def test_wrappers_reject_other_devices():
    r = _resolved("uint16-add")
    meta = torch.zeros((2, 64), dtype=torch.int32, device="meta")
    for entry in ("fused", "io"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            _call(entry, r, meta)


def test_kernel_takes_only_the_slot_width_it_is_built_for():
    """The kernel runs W = 6 schedules; any other width is refused before
    launch, and a gate-free schedule passes whatever its width."""
    for width in (4, 8):
        sched = torch.zeros((3, width), dtype=torch.int32)
        with pytest.raises(ValueError, match="slot width 6 only"):
            pim_exec._schedule_args(sched, sched, sched)
    assert pim_exec._schedule_args(*[torch.zeros((3, 6), dtype=torch.int32)]
                                   * 3) == (3, 6)
    assert pim_exec._schedule_args(*[torch.zeros((0, 8), dtype=torch.int32)]
                                   * 3) == (0, 8)


@pytest.mark.parametrize("n_cells,cap,want", [
    (444, 32, 32), (444, 1024, 128), (4175, 64, 13), (58112, 32, 1),
    (8, 5000, 1024), (444, 40, 32)])
def test_fit_words_per_cta(n_cells, cap, want):
    """At most ``cap``, at most what fits in 227 KB, at most 1024 threads,
    whole warps from 32 up."""
    got = pim_exec.fit_words_per_cta(n_cells, cap)
    assert got == want
    assert got * n_cells * 4 <= pim_exec.SMEM_PER_CTA


def test_fit_words_per_cta_rejects_a_column_too_large():
    with pytest.raises(ValueError, match="shared memory"):
        pim_exec.fit_words_per_cta(pim_exec.SMEM_PER_CTA // 4 + 1, 32)


def test_every_program_state_fits_one_column():
    """No ``program_for`` program comes near the shared-memory limit: the
    widest state (int-parallel mul64, 14031 cells) still fits whole
    32-row columns."""
    s = ops.program_schedule(program_for("int-parallel", "mul", 64),
                             CPU_PLAN)
    assert pim_exec.fit_words_per_cta(s.n_cells, 32) >= 1


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    """Without the CUDA toolkit the build raises; it never leaves a stub."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(pim_exec, "CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(pim_exec, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        pim_exec.build()
    assert not (tmp_path / "build").exists()


# --------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the slot-scan kernel has no CPU "
                    "mode")
    return "cuda"


FUSED = ["fp16-add", "fp32-add", "fp32-mul", "fp32-div", "uint16-add",
         "bp-mul16", "gate-free"]


@pytest.mark.cuda
@pytest.mark.parametrize("name", FUSED)
@pytest.mark.parametrize("n_rows", [4096, 100_003])
def test_kernel_fused_matches_plain_version(cuda, name, n_rows):
    """Ragged row counts and several CTA widths, bit for bit."""
    plain = _resolved(name)
    vals = _values(plain, np.random.default_rng(1), n_rows)
    want = _np(_call("fused", plain, _t(vals)))
    for wpc in (1, 13, 32, 128):
        r = _resolved(name, cuda, words_per_cta=wpc)
        got = _call("fused", r, _t(vals).to(cuda))
        torch.cuda.synchronize()
        assert np.array_equal(_np(got), want), wpc


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uint32-add", "uint32-mul", "uint16-add",
                                  "bp-mul16", "gate-free", "no-input"])
def test_kernel_io_matches_oracle(cuda, name):
    r = _resolved(name, cuda)
    rows = _bits(np.random.default_rng(2), (int(r.in_idx.numel()), 3001))
    got = _call("io", r, _t(rows).to(cuda))
    torch.cuda.synchronize()
    assert np.array_equal(_np(got), _oracle_rows(r, rows))


@pytest.mark.cuda
def test_main_path_launches_the_kernel(cuda):
    rng = np.random.default_rng(3)
    a = rng.standard_normal(5000).astype(np.float32)
    b = rng.standard_normal(5000).astype(np.float32)
    x = rng.integers(0, 1 << 32, 5000, dtype=np.uint64).astype(np.uint32)
    pim_exec.reset_counts()
    assert np.array_equal(pim.fp_add(a, b, chunk_rows=2048), a + b)
    assert np.array_equal(pim.add(x, x), x.astype(np.uint64) * 2)
    assert pim_exec.LAUNCHES == {"slot_scan_fused": 3, "slot_scan_io": 1}
    assert not any(slots.CALLS.values())
