"""The port's slot executor against the JAX package's.

B5, the bit-transpose bridges (``transpose32``/``pack_values``/
``unpack_values``), and B1's plain PyTorch version (``slots_fused``/
``slots_io``) are held bit for bit against ``repro.kernels.slots`` (the jnp
executors), ``repro.kernels.pim_exec`` (the Pallas slot-scan kernel in
interpret mode) and the numpy oracle ``LevelSchedule.exec_packed``.  Every
schedule is the reference's own, carried across with
``ops.schedule_from_arrays``, so the executors are compared on identical
input.  The CUDA kernel is held against this plain version in
``test_torch_kernels.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gates as rgates
from repro.core import pim_numerics as rpn
from repro.kernels import ops as rops
from repro.kernels import pim_exec as rpe
from repro.kernels import slots as rslots
from repro_torch.kernels import ops as tops
from repro_torch.kernels import slots as tslots

_FULL = np.uint32(0xFFFFFFFF)


def _t(a: np.ndarray) -> torch.Tensor:
    """uint32 numpy -> int32 bit patterns on the CPU."""
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np(t) -> np.ndarray:
    """int32 torch / uint32 jax -> uint32 numpy."""
    if isinstance(t, torch.Tensor):
        return t.numpy().view(np.uint32)
    return np.asarray(t, np.uint32)


def _bits(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


# --------------------------------------------------------------------------
# B5: the bit-transpose bridges
# --------------------------------------------------------------------------

def test_transpose32_matches_reference():
    x = _bits(np.random.default_rng(0), (3, 5, 32))
    want = np.asarray(rslots.transpose32(jnp.asarray(x)))
    assert np.array_equal(_np(tslots.transpose32(_t(x))), want)
    assert np.array_equal(_np(tslots.transpose32(tslots.transpose32(_t(x)))),
                          x)


@pytest.mark.parametrize("widths", [(16, 16), (32, 8, 1), (5,), ()])
def test_pack_unpack_values_match_reference(widths):
    rng = np.random.default_rng(1)
    n_rows = 4 * 32
    vals = _bits(rng, (len(widths), n_rows))
    for p, w in enumerate(widths):
        vals[p] &= np.uint32((1 << w) - 1)
    want = np.asarray(rslots.pack_values(jnp.asarray(vals), widths))
    got = tslots.pack_values(_t(vals), widths)
    assert got.shape == want.shape
    assert np.array_equal(_np(got), want)
    if widths:
        sub = _bits(rng, (sum(widths), n_rows // 32))
        want_u = np.asarray(rslots.unpack_values(jnp.asarray(sub), widths))
        assert np.array_equal(_np(tslots.unpack_values(_t(sub), widths)),
                              want_u)
        # unpack inverts pack on in-range values
        assert np.array_equal(_np(tslots.unpack_values(got, widths)), vals)


# --------------------------------------------------------------------------
# B1's plain version
# --------------------------------------------------------------------------

def _gate_free(gates):
    b = gates.Builder()
    x = b.input("x", 8)
    b.output("z", x)
    return b.finish()


def _no_input(gates):
    b = gates.Builder()
    c1, c0 = b.const(1), b.const(0)
    b.output("ones", [c1, b.not_(c0), c1])
    b.output("mix", [c0, c1, c0, c1])
    return b.finish()


PROGRAMS = {
    "fp16-add": lambda pn, g: pn.program_for("fp-serial", "add", "fp16"),
    "fp16-mul": lambda pn, g: pn.program_for("fp-serial", "mul", "fp16"),
    "uint16-add": lambda pn, g: pn.program_for("int-serial", "add", 16),
    "uint8-div": lambda pn, g: pn.program_for("int-serial", "div", 8),
    # int-parallel programs fold no INIT1 cell (one_cell is None)
    "bp-mul8": lambda pn, g: pn.program_for("int-parallel", "mul", 8),
    "uint32-add": lambda pn, g: pn.program_for("int-serial", "add", 32),
    "gate-free": lambda pn, g: _gate_free(g),
    "no-input": lambda pn, g: _no_input(g),
}


class Case:
    """One program's reference schedule, carried into the port, with the
    stacked index operands both packages' executors take."""

    def __init__(self, name: str):
        prog = PROGRAMS[name](rpn, rgates)
        self.r = rops.program_schedule(prog)
        r = self.r
        self.s = tops.schedule_from_arrays(dict(
            a=r.a, b=r.b, out=r.out, level_width=r.level_width,
            ports=r.ports, in_ports=r.in_ports, out_ports=r.out_ports,
            one_cell=r.one_cell, n_cells=r.n_cells, alloc=r.alloc,
            width=r.width, in_cells=r.in_cells, copy_gates=r.copy_gates))
        s = self.s
        self.in_names = sorted(s.in_ports)
        self.out_names = tops.output_names(s)
        self.in_widths = tuple(len(s.pack_cells(n)) for n in self.in_names)
        self.out_widths = tuple(len(s.ports[n]) for n in self.out_names)
        self.in_idx = tops._stacked_cells(
            [s.pack_cells(n) for n in self.in_names])
        self.out_idx = tops._stacked_cells(
            [s.ports[n] for n in self.out_names])
        self.in_base = tops.as_run(self.in_idx)
        self.out_base = tops.as_run(self.out_idx)
        self.k_out = int(self.out_idx.size)

    def operands(self, lib):
        """(in_idx, la, lb, lo, out_idx) as ``lib`` tensors."""
        arrs = (self.in_idx, self.s.a, self.s.b, self.s.out, self.out_idx)
        if lib == "torch":
            return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                         for a in arrs)
        return tuple(jnp.asarray(np.asarray(a, np.int32)) for a in arrs)

    def static(self):
        return dict(n_cells=self.s.n_cells, one_cell=self.s.one_cell,
                    in_base=self.in_base, out_base=self.out_base)

    def values(self, rng, n_rows: int) -> np.ndarray:
        vals = _bits(rng, (len(self.in_widths), n_rows))
        for p, w in enumerate(self.in_widths):
            vals[p] &= np.uint32((1 << w) - 1)
        return vals

    def oracle_rows(self, in_rows: np.ndarray) -> np.ndarray:
        """Output port rows from the numpy oracle: pack the input cells,
        set the folded INIT1 cell, run ``LevelSchedule.exec_packed``."""
        st = np.zeros((self.s.n_cells, in_rows.shape[1]), np.uint32)
        st[self.in_idx] = in_rows
        if self.s.one_cell is not None:
            st[self.s.one_cell] = _FULL
        self.s.exec_packed(st)
        return st[self.out_idx]


def _fused_plain(case, vals):
    return _np(tslots.slots_fused(
        _t(vals), *case.operands("torch"), in_widths=case.in_widths,
        out_widths=case.out_widths, **case.static()))


def _pad32(vals):
    pad = -vals.shape[1] % 32
    return np.concatenate([vals, np.zeros((vals.shape[0], pad), np.uint32)],
                          axis=1)


def _rows_of(case, vals):
    """Packed input port rows (uint32[k_in, n_words]) of per-row values."""
    return _np(tslots.pack_values(_t(_pad32(vals)), case.in_widths))


FUSED = ["fp16-add", "fp16-mul", "uint16-add", "uint8-div", "bp-mul8",
         "gate-free"]


@pytest.mark.parametrize("name", FUSED)
@pytest.mark.parametrize("n_rows", [256, 1000])
def test_slots_fused_matches_reference_and_oracle(name, n_rows):
    """Ragged row counts (1000) are padded for the reference, which takes
    whole words, and trimmed from its result."""
    case = Case(name)
    vals = case.values(np.random.default_rng(2), n_rows)
    got = _fused_plain(case, vals)
    assert got.shape == (len(case.out_widths), n_rows)
    want = np.asarray(rslots.pim_exec_ref_slots_fused(
        jnp.asarray(_pad32(vals)), *case.operands("jax"),
        in_widths=case.in_widths, out_widths=case.out_widths,
        **case.static()))[:, :n_rows]
    assert np.array_equal(got, want)
    oracle = case.oracle_rows(_rows_of(case, vals))
    assert np.array_equal(
        _np(tslots.unpack_values(_t(oracle), case.out_widths))[:, :n_rows],
        got)


@pytest.mark.parametrize("name", ["fp16-add", "uint16-add"])
def test_slots_fused_matches_pallas_interpret(name):
    case = Case(name)
    vals = case.values(np.random.default_rng(3), 256)
    want = np.asarray(rpe.pim_exec_slots_fused(
        jnp.asarray(vals), *case.operands("jax"), in_widths=case.in_widths,
        out_widths=case.out_widths, interpret=True, **case.static()))
    assert np.array_equal(_fused_plain(case, vals), want)


IO = ["uint32-add", "uint16-add", "bp-mul8", "gate-free", "no-input"]


@pytest.mark.parametrize("name", IO)
def test_slots_io_matches_reference_and_oracle(name):
    case = Case(name)
    rows = _bits(np.random.default_rng(4), (int(case.in_idx.size), 9))
    got = _np(tslots.slots_io(_t(rows), *case.operands("torch"),
                              k_out=case.k_out, **case.static()))
    want = np.asarray(rslots.pim_exec_ref_slots_io(
        jnp.asarray(rows), *case.operands("jax"), k_out=case.k_out,
        **case.static()))
    assert np.array_equal(got, want)
    assert np.array_equal(got, case.oracle_rows(rows))


@pytest.mark.parametrize("name", ["uint16-add", "no-input"])
def test_slots_io_matches_pallas_interpret(name):
    case = Case(name)
    rows = _bits(np.random.default_rng(5), (int(case.in_idx.size), 4))
    want = np.asarray(rpe.pim_exec_slots_io(
        jnp.asarray(rows), *case.operands("jax"), k_out=case.k_out,
        interpret=True, **case.static()))
    got = tslots.slots_io(_t(rows), *case.operands("torch"),
                          k_out=case.k_out, **case.static())
    assert np.array_equal(_np(got), want)


def test_plain_version_ignores_band_hints():
    """Without ``in_base``/``out_base`` the plain version falls back to
    indexed reads and writes (what the CUDA kernel always does) and gives
    the same result."""
    case = Case("fp16-add")
    vals = case.values(np.random.default_rng(6), 96)
    hinted = _fused_plain(case, vals)
    plain = _np(tslots.slots_fused(
        _t(vals), *case.operands("torch"), in_widths=case.in_widths,
        out_widths=case.out_widths, n_cells=case.s.n_cells,
        one_cell=case.s.one_cell))
    assert np.array_equal(hinted, plain)
