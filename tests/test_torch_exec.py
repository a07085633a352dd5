"""The port's dense, static and gate-serial executors and its rows64
bridges against the JAX package's.

* B3's plain version (``ref.pim_exec_ref_level_fused``/``_io``) against
  ``repro.kernels.ref`` (jnp) and ``repro.kernels.pim_exec``'s level-gather
  Pallas kernel in interpret mode, under rows32 and rows64;
* B2's plain version (``slots.build_static_chain``, and the static
  kernel's CPU path) against ``repro.kernels.slots.build_static_chain`` and
  ``make_slots_static`` in interpret mode, with partial and aliased inputs;
* B4's plain version (``ref.pim_exec_ref``) against
  ``repro.kernels.ref.pim_exec_ref`` and the numpy oracle (the reference's
  ``pim_exec_padded`` does not run on this jax);
* the rows64 bridges (``pack_values``/``unpack_values`` at ``planes=2``,
  ``_pack_port_words``, ``_sub_to_rows32``, ``_unpack_sub``, ``pack_rows``,
  ``unpack_rows``);
* the reference's dispatch rules and errors.

Every schedule is the reference's own, carried across with
``ops.schedule_from_arrays``; comparisons are bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import pim_ufunc as rpim
from repro.core import bitserial as rbs
from repro.core import gates as rgates
from repro.core import pim_numerics as rpn
from repro.kernels import ops as rops
from repro.kernels import pim_exec as rpe
from repro.kernels import plan as rplan
from repro.kernels import ref as rref
from repro.kernels import slots as rslots
from repro_torch import pim_ufunc as tpim
from repro_torch.core import gates as tgates
from repro_torch.core import pim_numerics as tpn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import pim_exec as tpe
from repro_torch.kernels import plan as tplan
from repro_torch.kernels import ref as tref
from repro_torch.kernels import slots as tslots

_FULL = np.uint32(0xFFFFFFFF)
TILE_ROWS = 256 * 32           # one Pallas TILE_W block of rows32 words


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.numpy().view(np.uint32)
    return np.asarray(t, np.uint32)


def _bits(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _pad(vals, rows_per_word):
    pad = -vals.shape[1] % rows_per_word
    return np.concatenate([vals, np.zeros((vals.shape[0], pad), np.uint32)],
                          axis=1)


def _gate_free(gates=rgates):
    b = gates.Builder()
    x = b.input("x", 8)
    b.output("z", x)
    return b.finish()


PROGRAMS = {
    "fp16-add": lambda: rpn.program_for("fp-serial", "add", "fp16"),
    "fp32-add": lambda: rpn.program_for("fp-serial", "add", "fp32"),
    "uint16-add": lambda: rpn.program_for("int-serial", "add", 16),
    "uint32-add": lambda: rpn.program_for("int-serial", "add", 32),
    "uint8-div": lambda: rpn.program_for("int-serial", "div", 8),
    "bp-mul8": lambda: rpn.program_for("int-parallel", "mul", 8),
    "mul8": lambda: rbs.build_mul(8),
    "gate-free": _gate_free,
}


class Case:
    """One program's reference schedule (``"slots"`` or ``"dense"``),
    carried into the port, with the stacked operands both packages'
    executors take.  ``in_names`` may be a subset of the input ports."""

    def __init__(self, name, alloc="slots", in_names=None):
        self.prog = PROGRAMS[name]()
        if alloc == "dense":
            r = rgates.levelize(self.prog, max_width=8)
        else:
            r = rops.program_schedule(self.prog)
        self.r = r
        self.s = tops.schedule_from_arrays(dict(
            a=r.a, b=r.b, out=r.out, level_width=r.level_width,
            ports=r.ports, in_ports=r.in_ports, out_ports=r.out_ports,
            one_cell=r.one_cell, n_cells=r.n_cells, alloc=alloc,
            width=r.width, in_cells=r.in_cells, copy_gates=r.copy_gates,
            sink=r.sink))
        s = self.s
        self.in_names = sorted(s.in_ports) if in_names is None \
            else list(in_names)
        self.out_names = tops.output_names(s)
        self.in_widths = tuple(len(s.pack_cells(n)) for n in self.in_names)
        self.out_widths = tuple(len(s.ports[n]) for n in self.out_names)
        self.in_cells = tops._stacked_cells(
            [s.pack_cells(n) for n in self.in_names])
        self.out_cells = tops._stacked_cells(
            [s.ports[n] for n in self.out_names])

    def operands(self, lib):
        """(in_idx, la, lb, lo, out_idx) as ``lib`` tensors."""
        arrs = (self.in_cells, self.s.a, self.s.b, self.s.out,
                self.out_cells)
        if lib == "torch":
            return tuple(torch.from_numpy(np.ascontiguousarray(a, np.int32))
                         for a in arrs)
        return tuple(jnp.asarray(np.asarray(a, np.int32)) for a in arrs)

    def static(self):
        return dict(n_cells=self.s.n_cells, one_cell=self.s.one_cell)

    def values(self, rng, n_rows: int) -> np.ndarray:
        vals = _bits(rng, (len(self.in_widths), n_rows))
        for p, w in enumerate(self.in_widths):
            vals[p] &= np.uint32((1 << w) - 1)
        return vals

    def oracle_rows(self, in_rows: np.ndarray) -> np.ndarray:
        """Output port rows from ``LevelSchedule.exec_packed``."""
        st = np.zeros((self.s.n_cells, in_rows.shape[1]), np.uint32)
        st[self.in_cells] = in_rows
        if self.s.one_cell is not None:
            st[self.s.one_cell] = _FULL
        self.s.exec_packed(st)
        return st[self.out_cells]


# --------------------------------------------------------------------------
# B3: the dense executor's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("name", ["fp16-add", "uint16-add", "gate-free"])
def test_level_fused_matches_reference(name, planes):
    """Ragged rows (1000) are padded for the reference, which takes whole
    words, and trimmed from its result."""
    case = Case(name, "dense")
    vals = case.values(np.random.default_rng(20), 1000)
    got = _np(tref.pim_exec_ref_level_fused(
        _t(vals), *case.operands("torch"), in_widths=case.in_widths,
        out_widths=case.out_widths, planes=planes, **case.static()))
    want = np.asarray(rref.pim_exec_ref_level_fused(
        jnp.asarray(_pad(vals, 32 * planes)), *case.operands("jax"),
        in_widths=case.in_widths, out_widths=case.out_widths, planes=planes,
        **case.static()))[:, :1000]
    assert got.shape == (len(case.out_widths), 1000)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", ["fp16-add", "uint16-add", "gate-free"])
def test_level_fused_matches_pallas_interpret(name):
    case = Case(name, "dense")
    vals = case.values(np.random.default_rng(21), TILE_ROWS)
    want = np.asarray(rpe.pim_exec_level_fused(
        jnp.asarray(vals), *case.operands("jax"), in_widths=case.in_widths,
        out_widths=case.out_widths, interpret=True, **case.static()))
    got = tref.pim_exec_ref_level_fused(
        _t(vals), *case.operands("torch"), in_widths=case.in_widths,
        out_widths=case.out_widths, **case.static())
    assert np.array_equal(_np(got), want)


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("name", ["uint16-add", "uint32-add", "gate-free"])
def test_level_io_matches_reference_pallas_and_oracle(name, planes):
    case = Case(name, "dense")
    k_in = int(case.in_cells.size)
    rows = _bits(np.random.default_rng(22), (planes, k_in, 256))
    rows = rows[0] if planes == 1 else rows
    got = _np(tref.pim_exec_ref_level_io(
        _t(rows), *case.operands("torch"), **case.static()))
    want = np.asarray(rref.pim_exec_ref_level_io(
        jnp.asarray(rows), *case.operands("jax"), **case.static()))
    assert np.array_equal(got, want)
    pallas = np.asarray(rpe.pim_exec_level_padded_io(
        jnp.asarray(rows), *case.operands("jax"), interpret=True,
        **case.static()))
    assert np.array_equal(got, pallas)
    for h in range(planes):
        block = rows if planes == 1 else rows[h]
        assert np.array_equal(got if planes == 1 else got[h],
                              case.oracle_rows(block))


# --------------------------------------------------------------------------
# B2: the static emission's plain version
# --------------------------------------------------------------------------

def _ref_chain(case, fused, planes, seg_levels):
    return rslots.build_static_chain(
        case.r, case.in_widths, case.out_widths, case.out_names,
        [int(c) for c in case.in_cells], seg_levels=seg_levels, fused=fused,
        planes=planes)


def _port_chain(case, fused, planes, seg_levels):
    return tslots.build_static_chain(
        case.s, case.in_widths, case.out_widths, case.out_names,
        case.in_cells, seg_levels=seg_levels, fused=fused, planes=planes)


@pytest.mark.parametrize("name,seg_levels", [("fp16-add", 17),
                                             ("fp32-add", 128)])
def test_static_chain_matches_reference(name, seg_levels):
    """Short segments (17 levels) carry live bands across many segment
    boundaries; ragged rows are padded for the reference only."""
    case = Case(name)
    vals = case.values(np.random.default_rng(23), 100)
    got = _np(_port_chain(case, True, 1, seg_levels)(_t(vals)))
    want = np.asarray(_ref_chain(case, True, 1, seg_levels)(
        jnp.asarray(_pad(vals, 32))))[:, :100]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("in_names,planes", [
    (["y"], 1),           # aliased: the inputs are not the leading run
    (["x"], 2),           # partial: the leading run, one port missing
    (["x", "y"], 2)])
def test_static_chain_partial_inputs_match_reference(in_names, planes):
    """Missing input ports stay zero, non-leading inputs are scattered, in
    the fused and the io form."""
    case = Case("uint16-add", in_names=in_names)
    rng = np.random.default_rng(24)
    vals = case.values(rng, 64 * 3)
    got = _np(_port_chain(case, True, planes, 28)(_t(vals)))
    want = np.asarray(_ref_chain(case, True, planes, 28)(jnp.asarray(vals)))
    assert np.array_equal(got, want)
    rows = _bits(rng, (planes, int(case.in_cells.size), 5))
    rows = rows[0] if planes == 1 else rows
    got = _np(_port_chain(case, False, planes, 28)(_t(rows)))
    want = np.asarray(_ref_chain(case, False, planes, 28)(jnp.asarray(rows)))
    assert np.array_equal(got, want)


def test_static_kernel_plain_path_matches_pallas_interpret():
    """The static kernel's CPU path against the reference's static-slice
    Pallas kernel (``make_slots_static``) on the bit-serial 8-bit
    multiplier."""
    case = Case("mul8")
    vals = case.values(np.random.default_rng(25), TILE_ROWS)
    run = rpe.make_slots_static(case.r, case.in_widths, case.out_widths,
                                case.out_names, interpret=True)
    want = np.asarray(run(jnp.asarray(vals)))
    k = tpe.StaticKernel(case.s, case.in_widths, case.out_widths,
                         case.out_names, case.in_cells)
    tslots.CALLS["static_chain"] = 0
    assert np.array_equal(_np(k(_t(vals))), want)
    assert tslots.CALLS["static_chain"] == 1


# --------------------------------------------------------------------------
# B4: the gate-serial executor's plain version
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["uint8-div", "fp16-add", "bp-mul8"])
def test_gate_serial_matches_reference_and_oracle(name):
    rprog = PROGRAMS[name]()
    arrays = rprog.to_arrays()
    tprog = {"uint8-div": lambda: tpn.program_for("int-serial", "div", 8),
             "fp16-add": lambda: tpn.program_for("fp-serial", "add", "fp16"),
             "bp-mul8": lambda: tpn.program_for("int-parallel", "mul", 8)
             }[name]()
    tarrays = tprog.to_arrays()
    for r, t in zip(arrays[:4], tarrays[:4]):
        assert np.array_equal(r, t)
    assert arrays[4] == tarrays[4]
    state = _bits(np.random.default_rng(26), (arrays[4], 7))
    got = _np(tref.pim_exec_ref(_t(state), *[torch.from_numpy(v)
                                              for v in tarrays[:4]]))
    want = np.asarray(rref.pim_exec_ref(
        jnp.asarray(state), *[jnp.asarray(v) for v in arrays[:4]]))
    assert np.array_equal(got, want)
    st = np.ascontiguousarray(state.T)
    tprog.lower_to_nor().exec_packed(st)
    assert np.array_equal(got, st.T)


def test_gate_serial_run_program_matches_reference():
    """``run_program(levelized=False)`` on ``ref`` against the reference's
    ``ref`` gate-serial run, ragged rows included."""
    rng = np.random.default_rng(27)
    for op, width in (("add", 16), ("mul", 8), ("div", 8)):
        rprog = rpn.program_for("int-serial", op, width)
        tprog = tpn.program_for("int-serial", op, width)
        names = sorted(rprog.in_ports)
        ins = {n: rng.integers(1, 1 << width, 77, dtype=np.uint64)
               for n in names}
        got = tops.run_program(tprog, ins, 77, "ref", levelized=False,
                               device="cpu")
        want = rops.run_program(rprog, ins, 77, "ref", levelized=False)
        assert sorted(got) == sorted(want)
        for port in want:
            assert np.array_equal(got[port], want[port]), (op, port)


# --------------------------------------------------------------------------
# rows64 bridges
# --------------------------------------------------------------------------

@pytest.mark.parametrize("widths", [(16, 16), (32, 8, 1), ()])
def test_pack_unpack_values_rows64_match_reference(widths):
    rng = np.random.default_rng(28)
    n_rows = 3 * 64
    vals = _bits(rng, (len(widths), n_rows))
    for p, w in enumerate(widths):
        vals[p] &= np.uint32((1 << w) - 1)
    want = np.asarray(rslots.pack_values(jnp.asarray(vals), widths, 2))
    got = tslots.pack_values(_t(vals), widths, 2)
    assert got.shape == want.shape
    assert np.array_equal(_np(got), want)
    if widths:
        sub = _bits(rng, (2, sum(widths), 3))
        want_u = np.asarray(rslots.unpack_values(jnp.asarray(sub), widths,
                                                 2))
        assert np.array_equal(
            _np(tslots.unpack_values(_t(sub), widths, 2)), want_u)
        assert np.array_equal(_np(tslots.unpack_values(got, widths, 2)),
                              vals)


@pytest.mark.parametrize("nc", [1, 16, 33, 70])
def test_host_bridges_rows64_match_reference(nc):
    """Port words, the rows32 collapse and the unpack of a planes-leading
    block, wide object-dtype ports included; ``pack_rows`` and
    ``unpack_rows`` round-trip under rows64."""
    rng = np.random.default_rng(29)
    n_rows = 200
    if nc > 63:
        vals = np.array([int(v) << 8 | 0x5A for v in
                         rng.integers(0, 2**62, n_rows, dtype=np.uint64)],
                        object)
    else:
        vals = rng.integers(0, 1 << nc, n_rows, dtype=np.uint64)
    n_words = tplan.ROWS64.n_words(n_rows)
    got = tops._pack_port_words(vals, nc, n_words, tplan.ROWS64)
    want = rops._pack_port_words(vals, nc, n_words, rplan.ROWS64)
    assert got.shape == want.shape == (2, nc, n_words)
    assert np.array_equal(got, want)
    assert np.array_equal(tops._sub_to_rows32(got),
                          rops._sub_to_rows32(want))
    t = tops._unpack_sub(got, [("v", nc)], n_rows)["v"]
    r = rops._unpack_sub(want, [("v", nc)], n_rows)["v"]
    assert t.dtype == r.dtype and list(t) == list(r) == list(vals)
    ports = {"v": list(range(3, 3 + nc))}
    state = tops.pack_rows({"v": vals}, ports, n_rows, nc + 5, one_cell=1,
                           layout=tplan.ROWS64)
    ref_state = rops.pack_rows({"v": vals}, ports, n_rows, nc + 5,
                               one_cell=1, pad_to=1, layout=rplan.ROWS64)
    assert np.array_equal(state, ref_state)
    assert list(tops.unpack_rows(state, ports, n_rows)["v"]) == list(vals)


# --------------------------------------------------------------------------
# the reference's dispatch rules and errors
# --------------------------------------------------------------------------

def _errors_alike(fn_t, fn_r, fragment):
    with pytest.raises(ValueError, match=fragment) as et:
        fn_t()
    with pytest.raises(ValueError, match=fragment) as er:
        fn_r()
    assert type(et.value) is type(er.value)


def test_rows64_errors_match_reference():
    """rows64 needs the levelized executors and a levelized backend, in
    both packages."""
    prog_t = tpn.program_for("int-serial", "add", 8)
    prog_r = rpn.program_for("int-serial", "add", 8)
    x = np.uint8([1, 2])
    ins = {"x": x, "y": x}
    _errors_alike(
        lambda: tops.run_program(prog_t, ins, 2, "ref", levelized=False,
                                 layout="rows64", device="cpu"),
        lambda: rops.run_program(prog_r, ins, 2, "ref", levelized=False,
                                 layout="rows64"),
        "layout 'rows64' requires the levelized executors")
    _errors_alike(
        lambda: tpim.add(x, x, backend="numpy", layout="rows64",
                         device="cpu"),
        lambda: rpim.add(x, x, backend="numpy", layout="rows64"),
        r"layout 'rows64' requires a levelized (jax )?backend "
        r"\(got backend='numpy'\)")


@pytest.mark.parametrize("schedule", ["slots", "slots-static", "dense"])
@pytest.mark.parametrize("name", ["fp16-add", "uint8-div", "gate-free"])
def test_resolve_picks_the_reference_route(name, schedule):
    """Same effective schedule, static flag and schedule arrays as the
    reference on the ``ref`` backend."""
    rprog = PROGRAMS[name]()
    tprog = {"fp16-add": lambda: tpn.program_for("fp-serial", "add", "fp16"),
             "uint8-div": lambda: tpn.program_for("int-serial", "div", 8),
             "gate-free": lambda: _gate_free(tgates)}[name]()
    in_names = tuple(sorted(rprog.in_ports))
    rplan_ = rplan.ExecPlan(schedule=schedule)
    tplan_ = tplan.as_plan(backend="ref", device="cpu", schedule=schedule)
    r = rops.compiled(rprog, rplan_).resolve(rprog, rplan_, in_names)
    t = tops.compiled(tprog, tplan_).resolve(tprog, tplan_, in_names)
    assert (t.kind, t.use_static, t.fused_ok, t.in_base, t.out_base) == \
        (r.kind, r.use_static, r.fused_ok, r.in_base, r.out_base)
    for f in ("a", "b", "out"):
        assert np.array_equal(getattr(t.sched, f), getattr(r.sched, f))
