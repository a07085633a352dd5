"""The packed streams of the ring kernels (B1 ``csrc/slot_scan.cu``, B3
``csrc/level_gather.cu``, B4 ``csrc/gate_serial.cu``) and, on the card,
the kernels that run them.

Everywhere: the window packer, the level packer and the slot packer on
every ``program_for`` family the port serves and on random programs; a
plain PyTorch emulation of the kernels' loop (per tile, window by window:
load every operand of the window, then store in order) run on the packed
stream must give the state of ``ref.pim_exec_ref`` and the numpy oracle
(``Program.exec_packed``), the outputs of
``ref.pim_exec_ref_level_fused``/``_io`` under both layouts, or those of
the JAX package's slot executors at slot widths 4, 6 and 8 (the wide
widths 9 to 64 in ``test_torch_ring_wide.py``); the window rule of every
width; streams of windows of 8 records or fewer held to digests of their
earlier bytes; the uint16 limit; the CTA rule.  The ``cuda``-marked
tests skip without a card.

Only the slot packer's tests import the JAX package, inside the test, so
this file runs on a machine with an NVIDIA GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_ring.py
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
from repro_torch.kernels import ref
from repro_torch.kernels import slots

TILE = pim_exec.TILE_RECORDS
CPU_DENSE = kplan.as_plan(backend="ref", device="cpu", schedule="dense")

#: One program of every (kind, op) that ``program_for`` serves, small.
FAMILIES = [("int-serial", op, 8) for op in ("add", "sub", "mul", "div")] + \
    [("int-parallel", op, 8) for op in ("add", "sub", "mul", "div")] + \
    [("fp-serial", op, "fp16") for op in ("add", "sub", "mul", "div")] + \
    [("fp-parallel", op, "fp16") for op in ("add", "mul", "div")]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a, np.uint32).view(np.int32))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy().view(np.uint32)


def _bits(rng, shape) -> np.ndarray:
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _random_program(seed, n_gates=40):
    """A random gate DAG over two 16-bit inputs, as the reference's bridge
    tests build them."""
    rng = np.random.default_rng(seed)
    b = gates.Builder()
    avail = b.input("x", 16) + b.input("y", 16)
    fns = [b.nor, b.or_, b.and_, b.xor, b.xnor, b.nand]
    for _ in range(n_gates):
        f = fns[rng.integers(0, len(fns))]
        i, j = rng.integers(0, len(avail), 2)
        avail.append(f(avail[i], avail[j]))
    b.output("z", avail[-16:])
    return b.finish()


def _gate_free():
    b = gates.Builder()
    b.output("z", b.input("x", 8))
    return b.finish()


def _no_input():
    b = gates.Builder()
    c1, c0 = b.const(1), b.const(0)
    b.output("ones", [c1, b.not_(c0), c1])
    b.output("mix", [c0, c1, c0, c1])
    return b.finish()


def _program(case):
    if isinstance(case, tuple):
        return program_for(*case)
    return _random_program(int(case.split("-")[1]))


CASES = FAMILIES + ["random-0", "random-1", "random-2"]
IDS = ["-".join(map(str, c)) if isinstance(c, tuple) else c for c in CASES]


# --------------------------------------------------------------------------
# the kernels' loop, in plain PyTorch
# --------------------------------------------------------------------------

def _windows(packed):
    """The windows of a packed stream as the kernel reads them: ``width``
    records each, at a fixed stride, ``(TILE - WINDOW) // width`` to a
    tile."""
    rec = packed.tiles.cpu().numpy().view(np.uint16).reshape(
        packed.n_tiles, TILE, 4)
    per_tile = (TILE - pim_exec.WINDOW) // packed.width
    assert packed.n_tiles == -(-packed.n_windows // per_tile)
    for w in range(packed.n_windows):
        pos = (w % per_tile) * packed.width
        yield rec[w // per_tile, pos:pos + packed.width].astype(np.int64)


def _run_packed(st, packed):
    """Run ``packed`` over ``st`` (cell axis -2) as the kernel does: every
    operand of a window first, then its results in order."""
    for w in _windows(packed):
        a, b = torch.from_numpy(w[:, 0]), torch.from_numpy(w[:, 1])
        v = ~(st.index_select(-2, a) | st.index_select(-2, b))
        for k, o in enumerate(w[:, 2].tolist()):
            st[..., o, :] = v[..., k, :]
    return st


def _run_packed_gates(st, packed):
    """:func:`_run_packed` on a gate-serial state with the kernel's two
    constant cells after it (all zeros, all ones)."""
    const = torch.tensor([[0], [-1]], dtype=st.dtype).expand(2, st.shape[1])
    return _run_packed(torch.cat([st, const]), packed)[:st.shape[0]]


def _run_packed_fused(in_vals, packed, in_idx, out_idx, *, n_cells,
                      one_cell, in_widths, out_widths, planes):
    """``ref.pim_exec_ref_level_fused`` with its level loop replaced by
    :func:`_run_packed`."""
    n_rows = in_vals.shape[1]
    in_vals = slots._pad_rows(in_vals, 32 * planes)
    st = ref.assemble_state(slots.pack_values(in_vals, in_widths, planes),
                            in_idx, in_vals.shape[1] // (32 * planes),
                            n_cells=n_cells, one_cell=one_cell)
    sub = _run_packed(st, packed).index_select(-2, out_idx.long())
    return slots.unpack_values(sub, out_widths, planes)[:, :n_rows]


# --------------------------------------------------------------------------
# B4: the window packer
# --------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_gate_windows_are_greedy_independent_runs(case):
    """Windows cover the stream in order, hold 1 to 8 gates with no
    read-after-write, write-after-read or write-after-write among them,
    and each ends only where the next gate would add one or the window is
    full."""
    ops_, a, b, o, _ = _program(case).to_arrays()
    lens = pim_exec.gate_windows(ops_, a, b, o)
    assert lens.sum() == len(ops_) and lens.min() >= 1 and \
        lens.max() <= pim_exec.WINDOW
    start = 0
    for n in lens.tolist():
        reads, writes = set(), set()
        for i in range(start, start + n):
            r = {int(a[i]), int(b[i])} if ops_[i] >= 2 else set()
            assert not r & writes and int(o[i]) not in reads | writes
            reads |= r
            writes.add(int(o[i]))
        start += n
        if start < len(ops_) and n < pim_exec.WINDOW:
            r = {int(a[start]), int(b[start])} if ops_[start] >= 2 else set()
            assert r & writes or int(o[start]) in reads | writes


def test_gate_window_counts():
    """The window counts of the serial streams the port times (fp16 and
    fp32 add, fp32 mul) at windows of 8 and 4 gates; ``width`` is the
    records a window takes, the kernels' body of 2, 4, 6 or 8 gates."""
    for fmt, op, want in (("fp16", "add", (1180, 1182)),
                          ("fp32", "add", (2323, 2327)),
                          ("fp32", "mul", (4957, 4965))):
        ops_, a, b, o, n_cells = program_for("fp-serial", op, fmt).to_arrays()
        for window, n in zip((8, 4), want):
            p = pim_exec.pack_gates(ops_, a, b, o, n_cells=n_cells,
                                    window=window)
            assert (p.n_windows, p.n_gates, p.width) == \
                (n, len(ops_), window)
    p = pim_exec.pack_gates(ops_, a, b, o, n_cells=n_cells)
    assert (p.n_windows, p.width) == (5608, pim_exec.GATE_WINDOW)
    p = pim_exec.pack_gates(ops_, a, b, o, n_cells=n_cells, window=1)
    assert (p.n_windows, p.width) == (len(ops_), 2)
    with pytest.raises(ValueError, match="windows of 1 to 8 gates"):
        pim_exec.pack_gates(ops_, a, b, o, n_cells=n_cells, window=9)
    assert [pim_exec.window_width(n) for n in range(9)] == \
        [2, 2, 2, 4, 4, 6, 6, 8, 8]


@pytest.mark.parametrize("case", CASES + ["fp32-mul", "hazards"],
                         ids=IDS + ["fp32-mul", "hazards"])
def test_packed_gates_run_like_the_serial_stream(case):
    """Load-the-window-then-store on the packed stream gives the state of
    the gate-serial plain version and of the numpy oracle; fp32 mul spans
    23 tiles, ``hazards`` is a raw stream over 12 cells."""
    rng = np.random.default_rng(40)
    prog = None
    if case == "hazards":
        n = 3000
        ops_ = rng.integers(0, 4, n).astype(np.int32)
        a, b, o = (rng.integers(0, 12, n).astype(np.int32) for _ in range(3))
        b[ops_ == 2] = a[ops_ == 2]
        n_cells = 12
    else:
        prog = program_for("fp-serial", "mul", "fp32") \
            if case == "fp32-mul" else _program(case)
        ops_, a, b, o, n_cells = prog.to_arrays()
    packed = pim_exec.pack_gates(ops_, a, b, o, n_cells=n_cells)
    assert packed.tiles.shape == (packed.n_tiles, 2 * TILE)
    state = _bits(rng, (n_cells, 5))
    got = _np(_run_packed_gates(_t(state), packed))
    want = _np(ref.pim_exec_ref(_t(state), *(torch.from_numpy(x)
                                             for x in (ops_, a, b, o))))
    assert np.array_equal(got, want)
    if prog is not None:
        oracle = np.ascontiguousarray(state.T)
        prog.lower_to_nor().exec_packed(oracle)
        assert np.array_equal(got, oracle.T)


def test_packed_tiles_layout():
    """Windows sit at a fixed stride, every tile ends in at least one
    window's worth of zero records, and the records hold the stream in
    order, each window's length on its first record and its last gate
    repeated to its width; INIT1 reads the zero cell ``n_cells`` and INIT0
    the ones cell ``n_cells + 1``."""
    ops_, a, b, o, n_cells = program_for("fp-serial", "add",
                                         "fp32").to_arrays()
    p = pim_exec.pack_gates(ops_, a, b, o, n_cells=n_cells)
    rec = p.tiles.numpy().view(np.uint16).reshape(p.n_tiles, TILE, 4)
    assert not rec[:, TILE - pim_exec.WINDOW:].any()
    windows = list(_windows(p))
    lens = pim_exec.gate_windows(ops_, a, b, o, pim_exec.GATE_WINDOW)
    assert [int(w[0, 3]) for w in windows] == lens.tolist()
    for w, n in zip(windows, lens):
        assert not w[1:, 3].any() and (w[n:, :3] == w[n - 1, :3]).all()
    flat = np.concatenate([w[:n, :3] for w, n in zip(windows, lens)])
    const = np.where(ops_ == 1, n_cells, n_cells + 1)
    want = np.stack([np.where(ops_ >= 2, a, const),
                     np.where(ops_ >= 2, b, const), o], 1)
    assert np.array_equal(flat, want)
    assert (ops_ == 0).any() and (ops_ == 1).any()


def test_empty_streams_have_no_tiles():
    empty = np.zeros(0, np.int32)
    assert pim_exec.pack_gates(empty, empty, empty, empty,
                               n_cells=4).n_tiles == 0
    none = np.zeros((0, 0), np.int32)
    p = pim_exec.pack_levels(none, none, none, n_cells=4)
    assert (p.n_tiles, p.n_windows, p.n_gates) == (0, 0, 0)


@pytest.mark.parametrize("packer", ["gates", "levels"])
def test_packers_refuse_programs_of_65536_cells(packer):
    """Cells travel as uint16: a program of 65536 cells or more raises,
    whatever cells its gates touch; 65535 cells pack as a dense schedule,
    65534 as a gate-serial stream (which adds two constant cells)."""
    one = np.array([3], np.int32)
    top = (1 << 16) - (2 if packer == "gates" else 1)
    for n_cells, ok in ((1 << 16, False), ((1 << 16) + 5, False),
                        (top + 1, False), (top, True)):
        if packer == "gates":
            call = lambda: pim_exec.pack_gates(one, one, one, one,  # noqa
                                               n_cells=n_cells)
        else:
            call = lambda: pim_exec.pack_levels(  # noqa: E731
                one[None], one[None], one[None], n_cells=n_cells)
        if ok:
            assert call().n_gates == 1
        else:
            with pytest.raises(ValueError, match="65536"):
                call()


def test_widest_program_fits_uint16():
    """The widest ``program_for`` state, the int-parallel div64 gate-serial
    stream, has 25354 cells: it packs."""
    ops_, a, b, o, n_cells = program_for("int-parallel", "div",
                                         64).to_arrays()
    assert n_cells == 25354
    p = pim_exec.pack_gates(ops_, a, b, o, n_cells=n_cells)
    assert p.n_gates == len(ops_)


# --------------------------------------------------------------------------
# B3: the level packer
# --------------------------------------------------------------------------

def _dense(case, cap=None):
    """The dense schedule of ``case`` (at width cap ``cap`` if given) with
    its operands as the kernel entries take them."""
    prog = _program(case) if case not in ("gate-free", "no-input") else \
        {"gate-free": _gate_free, "no-input": _no_input}[case]()
    plan = CPU_DENSE if cap is None else kplan.as_plan(
        backend=kplan.Backend("ref", level_max_width=cap), device="cpu",
        schedule="dense")
    s = ops.program_schedule(prog, plan)
    in_names = sorted(prog.in_ports)
    out_names = ops.output_names(s)
    in_cells = ops._stacked_cells([s.pack_cells(n) for n in in_names])
    out_cells = ops._stacked_cells([s.ports[n] for n in out_names])
    return s, dict(
        in_idx=torch.from_numpy(in_cells), out_idx=torch.from_numpy(out_cells),
        la=torch.from_numpy(s.a), lb=torch.from_numpy(s.b),
        lo=torch.from_numpy(s.out),
        in_widths=tuple(len(s.pack_cells(n)) for n in in_names),
        out_widths=tuple(len(s.ports[n]) for n in out_names))


DENSE_CASES = CASES + ["gate-free", "no-input"]
DENSE_IDS = IDS + ["gate-free", "no-input"]


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("case", DENSE_CASES, ids=DENSE_IDS)
def test_packed_levels_run_like_the_dense_schedule(case, planes):
    """One window a level, all its lanes, gives the outputs of the plain
    dense executor, fused and io, under both layouts."""
    s, d = _dense(case)
    packed = pim_exec.pack_levels(s.a, s.b, s.out, n_cells=s.n_cells)
    assert (packed.n_windows, packed.n_gates) == (s.n_levels,
                                                  s.n_levels * s.width)
    rng = np.random.default_rng(41)
    kw = dict(n_cells=s.n_cells, one_cell=s.one_cell)
    sched = (d["in_idx"], d["la"], d["lb"], d["lo"], d["out_idx"])
    if d["in_widths"] and max(d["in_widths"] + d["out_widths"]) <= 32:
        vals = _bits(rng, (len(d["in_widths"]), 77))
        for p, w in enumerate(d["in_widths"]):
            vals[p] &= np.uint32((1 << w) - 1)
        want = ref.pim_exec_ref_level_fused(
            _t(vals), *sched, in_widths=d["in_widths"],
            out_widths=d["out_widths"], planes=planes, **kw)
        got = _run_packed_fused(
            _t(vals), packed, d["in_idx"], d["out_idx"],
            in_widths=d["in_widths"], out_widths=d["out_widths"],
            planes=planes, **kw)
        assert torch.equal(got, want)
    k_in = int(d["in_idx"].numel())
    rows = _bits(rng, (k_in, 3) if planes == 1 else (planes, k_in, 3))
    want = ref.pim_exec_ref_level_io(_t(rows), *sched, **kw)
    st = ref.assemble_state(_t(rows), d["in_idx"], 3, **kw)
    got = _run_packed(st, packed).index_select(-2, d["out_idx"].long())
    assert torch.equal(got, want)


@pytest.mark.parametrize("width,body", [(1, 2), (3, 4), (5, 6), (8, 8)])
def test_narrow_levels_repeat_their_last_lane(width, body):
    """A dense schedule narrower than the kernel's window body (a cuda plan
    may cap the dense width below 8) pads each level by repeating its last
    lane, which stores the same value again: the outputs stay the plain
    executor's."""
    prog = program_for("fp-serial", "add", "fp16")
    plan = kplan.as_plan(backend=kplan.Backend("ref", level_max_width=width),
                         device="cpu", schedule="dense")
    s = ops.program_schedule(prog, plan)
    assert s.width == width
    packed = pim_exec.pack_levels(s.a, s.b, s.out, n_cells=s.n_cells)
    assert packed.width == body
    in_cells = ops._stacked_cells([s.pack_cells(n) for n in ("x", "y")])
    out_cells = ops._stacked_cells([s.ports["z"]])
    rows = _bits(np.random.default_rng(42), (len(in_cells), 4))
    kw = dict(n_cells=s.n_cells, one_cell=s.one_cell)
    in_idx, out_idx = torch.from_numpy(in_cells), torch.from_numpy(out_cells)
    want = ref.pim_exec_ref_level_io(
        _t(rows), in_idx, *(torch.from_numpy(x) for x in (s.a, s.b, s.out)),
        out_idx, **kw)
    st = ref.assemble_state(_t(rows), in_idx, 4, **kw)
    got = _run_packed(st, packed).index_select(-2, out_idx.long())
    assert torch.equal(got, want)


def test_level_packer_refuses_levels_wider_than_a_window():
    """A level wider than a window (8 lanes) is split into consecutive
    windows, which is exact only if the level reads no cell it writes:
    such a level is refused.  A level of one window may (its window reads
    every operand first)."""
    one = np.zeros((2, 8), np.int32)
    p = pim_exec.pack_levels(one, one, one, n_cells=4)
    assert (p.n_windows, p.width) == (2, 8)
    for width, windows, body in ((9, 2, 6), (33, 5, 8), (64, 8, 8)):
        wide = np.zeros((2, width), np.int32)
        with pytest.raises(ValueError, match="reads a cell it writes"):
            pim_exec.pack_levels(wide, wide, wide, n_cells=4)
        a = np.tile(np.arange(width), (2, 1))
        p = pim_exec.pack_levels(a, a, a + width, n_cells=2 * width)
        assert (p.n_windows, p.n_gates, p.width) == \
            (2 * windows, 2 * width, body)


# --------------------------------------------------------------------------
# B1: the slot packer
# --------------------------------------------------------------------------

def _slots(case, width):
    """The slot schedule of ``case`` at slot width ``width``, as ``_dense``
    gives the dense one."""
    prog = _program(case) if case not in ("gate-free", "no-input") else \
        {"gate-free": _gate_free, "no-input": _no_input}[case]()
    plan = kplan.as_plan(backend=kplan.Backend("ref", slot_width=width),
                         device="cpu")
    s = ops.program_schedule(prog, plan)
    in_names = sorted(prog.in_ports)
    out_names = ops.output_names(s)
    in_cells = ops._stacked_cells([s.pack_cells(n) for n in in_names])
    out_cells = ops._stacked_cells([s.ports[n] for n in out_names])
    return s, dict(
        in_idx=in_cells, out_idx=out_cells,
        in_widths=tuple(len(s.pack_cells(n)) for n in in_names),
        out_widths=tuple(len(s.ports[n]) for n in out_names),
        kw=dict(n_cells=s.n_cells, one_cell=s.one_cell,
                in_base=ops.as_run(in_cells),
                out_base=ops.as_run(out_cells)))


def _oracle_values(s, d, vals):
    """Per-row outputs of the numpy oracle (``LevelSchedule.exec_packed``)
    on per-row input values."""
    n_rows = vals.shape[1]
    rows = _np(slots.pack_values(slots._pad_rows(_t(vals), 32),
                                 d["in_widths"]))
    st = np.zeros((s.n_cells, rows.shape[1]), np.uint32)
    st[d["in_idx"]] = rows
    if s.one_cell is not None:
        st[s.one_cell] = np.uint32(0xFFFFFFFF)
    s.exec_packed(st)
    out = slots.unpack_values(_t(st[d["out_idx"]]), d["out_widths"])
    return _np(out)[:, :n_rows]


SLOT_CASES = ["fp-serial-add-fp16", "random-1", "gate-free", "no-input"]


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("width", [4, 6, 8])
@pytest.mark.parametrize("case", SLOT_CASES)
def test_packed_slots_run_like_the_slot_schedule(case, width, planes):
    """One window a level of all its W lanes, lane k writing ``lo[l, 0] +
    k``, run window by window (every operand, then the band) gives the
    outputs of the JAX package's slot executors
    (``kernels.slots.pim_exec_ref_slots_fused`` and ``_io``) and of the
    numpy oracle, fused on ragged rows and io, under both layouts; a
    level's band may overwrite the cells it reads."""
    import jax.numpy as jnp
    from repro.kernels import slots as rslots
    name = {"fp-serial-add-fp16": ("fp-serial", "add", "fp16")}.get(case,
                                                                    case)
    s, d = _slots(name, width)
    assert s.width == width or s.n_levels == 0
    packed = pim_exec.pack_slots(s.a, s.b, s.out, n_cells=s.n_cells)
    assert (packed.n_windows, packed.n_gates) == (s.n_levels,
                                                  s.n_levels * s.width)
    assert packed.width == (pim_exec.window_width(width) if s.n_levels
                            else 2)
    sched = tuple(jnp.asarray(np.asarray(x, np.int32))
                  for x in (d["in_idx"], s.a, s.b, s.out, d["out_idx"]))
    rng = np.random.default_rng(46)
    if d["in_widths"]:
        n_rows = 77
        vals = _bits(rng, (len(d["in_widths"]), n_rows))
        for p, w in enumerate(d["in_widths"]):
            vals[p] &= np.uint32((1 << w) - 1)
        got = _np(_run_packed_fused(
            _t(vals), packed, torch.from_numpy(d["in_idx"]),
            torch.from_numpy(d["out_idx"]), in_widths=d["in_widths"],
            out_widths=d["out_widths"], planes=planes,
            n_cells=s.n_cells, one_cell=s.one_cell))
        padded = _np(slots._pad_rows(_t(vals), 32 * planes))
        want = np.asarray(rslots.pim_exec_ref_slots_fused(
            jnp.asarray(padded), *sched, in_widths=d["in_widths"],
            out_widths=d["out_widths"], planes=planes, **d["kw"]))
        assert np.array_equal(got, want[:, :n_rows])
        assert np.array_equal(got, _oracle_values(s, d, vals))
    k_in = len(d["in_idx"])
    rows = _bits(rng, (k_in, 3) if planes == 1 else (planes, k_in, 3))
    st = ref.assemble_state(_t(rows), torch.from_numpy(d["in_idx"]), 3,
                            n_cells=s.n_cells, one_cell=s.one_cell)
    got = _np(_run_packed(st, packed).index_select(
        -2, torch.from_numpy(d["out_idx"]).long()))
    want = np.asarray(rslots.pim_exec_ref_slots_io(
        jnp.asarray(rows), *sched, k_out=len(d["out_idx"]), **d["kw"]))
    assert np.array_equal(got, want)
    if planes == 1:
        oracle = np.zeros((s.n_cells, 3), np.uint32)
        oracle[d["in_idx"]] = rows
        if s.one_cell is not None:
            oracle[s.one_cell] = np.uint32(0xFFFFFFFF)
        s.exec_packed(oracle)
        assert np.array_equal(got, oracle[d["out_idx"]])


def test_slot_bands_may_overwrite_their_own_operands():
    """A level whose band overwrites cells it reads (the slot schedules of
    ``program_for`` happen to have none): the load-then-store window gives
    the plain slot executor's result, which reads the whole level first."""
    la = np.array([[4, 5, 6, 0], [1, 6, 7, 4], [5, 5, 2, 3]], np.int32)
    lb = np.array([[7, 4, 1, 2], [5, 4, 3, 6], [6, 7, 4, 0]], np.int32)
    lo = np.array([[4, 5, 6, 7], [4, 5, 6, 7], [6, 7, 8, 9]], np.int32)
    in_idx, out_idx = np.arange(8, dtype=np.int32), np.arange(4, 10,
                                                              dtype=np.int32)
    rows = _bits(np.random.default_rng(47), (8, 5))
    want = slots.slots_io(_t(rows), *(torch.from_numpy(x) for x in (
        in_idx, la, lb, lo, out_idx)), n_cells=10, one_cell=None, k_out=6,
        in_base=0, out_base=4)
    packed = pim_exec.pack_slots(la, lb, lo, n_cells=10)
    st = ref.assemble_state(_t(rows), torch.from_numpy(in_idx), 5,
                            n_cells=10, one_cell=None)
    got = _run_packed(st, packed)[4:10]
    assert torch.equal(got, want)
    naive = ref.assemble_state(_t(rows), torch.from_numpy(in_idx), 5,
                               n_cells=10, one_cell=None)
    for l in range(3):                     # lane by lane: not the level
        for k in range(4):
            naive[lo[l, k]] = ~(naive[la[l, k]] | naive[lb[l, k]])
    assert not torch.equal(naive[4:10], want)


def test_slot_packer_refuses_levels_wider_than_a_window():
    """As for the level packer: a slot level split over windows whose
    band overwrites a cell it reads is refused; one of one window may."""
    one = np.zeros((2, 8), np.int32)
    assert pim_exec.pack_slots(one, one, one, n_cells=16).width == 8
    for width, windows, body in ((9, 2, 6), (40, 5, 8)):
        wide = np.zeros((2, width), np.int32)
        with pytest.raises(ValueError, match="reads a cell it writes"):
            pim_exec.pack_slots(wide, wide, wide, n_cells=64)
        p = pim_exec.pack_slots(wide, wide, wide + 1, n_cells=64)
        assert (p.n_windows, p.width) == (2 * windows, body)
    with pytest.raises(ValueError, match="65536"):
        pim_exec.pack_slots(wide[:, :6], wide[:, :6], wide[:, :6],
                            n_cells=1 << 16)


# --------------------------------------------------------------------------
# wide schedules: levels split into windows of at most 8
# --------------------------------------------------------------------------

FAMILY_IDS = ["-".join(map(str, f)) for f in FAMILIES]


def test_window_rule_covers_every_width():
    """The body a window of n gates takes, and the windows a level of any
    width takes: one window up to 8 lanes, else the fewest windows of at
    most 8, as even as they come."""
    assert [pim_exec.window_width(n) for n in range(9)] == \
        [2] * 3 + [4] * 2 + [6] * 2 + [8] * 2
    with pytest.raises(ValueError, match="1 to 8 gates"):
        pim_exec.window_width(9)
    for width in range(1, 200):
        lens = pim_exec.level_windows(width)
        assert sum(lens) == width and max(lens) <= pim_exec.WINDOW
        assert len(lens) == -(-width // 8) and max(lens) - min(lens) <= 1
    assert pim_exec.level_windows(9) == [5, 4]
    assert pim_exec.level_windows(12) == [6, 6]
    assert pim_exec.level_windows(33) == [7, 7, 7, 6, 6]
    assert pim_exec.level_windows(64) == [8] * 8


@pytest.mark.parametrize("fam", FAMILIES, ids=FAMILY_IDS)
def test_narrow_streams_keep_their_bytes(fam):
    """Every stream of a schedule of 8 lanes or fewer is byte for byte
    what it was before wider ones were split: the slot streams at slot widths 1
    to 8, the dense streams at caps 1 to 8 and the gate-serial stream, of
    each family (a digest of the tiles and counts, taken from the earlier
    packer)."""
    import hashlib
    h = hashlib.sha256()
    prog = program_for(*fam)
    for w in range(1, 9):
        for kind in ("slots", "dense"):
            be = kplan.Backend("ref", slot_width=w) if kind == "slots" \
                else kplan.Backend("ref", level_max_width=w)
            s = ops.program_schedule(prog, kplan.as_plan(
                backend=be, device="cpu", schedule=kind))
            pack = pim_exec.pack_slots if kind == "slots" else \
                pim_exec.pack_levels
            p = pack(s.a, s.b, s.out, n_cells=s.n_cells)
            h.update(np.asarray([p.n_windows, p.n_gates, p.width],
                                np.int64).tobytes())
            h.update(p.tiles.numpy().tobytes())
    ops_, a, b, o, n_cells = prog.to_arrays()
    p = pim_exec.pack_gates(ops_, a, b, o, n_cells=n_cells)
    h.update(np.asarray([p.n_windows, p.n_gates, p.width],
                        np.int64).tobytes())
    h.update(p.tiles.numpy().tobytes())
    assert h.hexdigest()[:16] == NARROW_DIGESTS["-".join(map(str, fam))]


NARROW_DIGESTS = {
    "int-serial-add-8": "b8f2016c4048b40e",
    "int-serial-sub-8": "b97e895c77fb806b",
    "int-serial-mul-8": "6d90d9a60a36817a",
    "int-serial-div-8": "e621c84cdd65023a",
    "int-parallel-add-8": "cfc9e2f92143a84f",
    "int-parallel-sub-8": "b86ee54fa549fa98",
    "int-parallel-mul-8": "898e8652c57b2c0f",
    "int-parallel-div-8": "f6b71451d7ed599f",
    "fp-serial-add-fp16": "1861d37bbea4f3fc",
    "fp-serial-sub-fp16": "eda68ef9f813f230",
    "fp-serial-mul-fp16": "f9a9a67da083938a",
    "fp-serial-div-fp16": "c9b6a3bc4595f0a7",
    "fp-parallel-add-fp16": "6950e2c0e23453cc",
    "fp-parallel-mul-fp16": "9877c8f1b6fcc656",
    "fp-parallel-div-fp16": "7ee798e60f74b897",
}


@pytest.mark.parametrize("kind", ["slots", "dense"])
def test_reference_schedules_are_hazard_free_at_every_width(kind):
    """What splitting a level rests on: in the schedules of both
    allocators, at widths 8 to 64, no level reads a cell it writes, pad
    lanes included."""
    for fam in (("fp-serial", "add", "fp16"), ("int-parallel", "mul", 8)):
        for width in (8, 16, 33, 64):
            s = _slots(fam, width)[0] if kind == "slots" else \
                _dense(fam, cap=width)[0]
            out = s.out if kind == "dense" else \
                s.out[:, :1] + np.arange(s.width)
            for l in range(s.n_levels):
                reads = set(s.a[l].tolist()) | set(s.b[l].tolist())
                assert not set(out[l].tolist()) & reads, (width, l)


# --------------------------------------------------------------------------
# the CTA rule and the cached streams
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n_cells,planes,want", [
    (605, 1, 92), (355, 1, 128), (355, 2, 64), (998, 2, 28), (202, 1, 128),
    (50, 1, 128), (1402, 1, 39), (25354, 1, 2), (10304, 2, 2)])
def test_ring_words_per_cta(n_cells, planes, want):
    """As many columns as one CTA holds beside the ring, at most four warps
    of 32 words, or of 16 under rows64, spread evenly over the warps."""
    got = pim_exec.ring_words_per_cta(n_cells, planes)
    assert got == want
    assert got * n_cells * 4 * planes + pim_exec.RING_BYTES <= \
        pim_exec.SMEM_PER_CTA
    lanes = pim_exec.ring_lanes(got)
    warps = -(-got // lanes)
    assert warps <= pim_exec.RING_WARPS and lanes <= 32 // planes
    assert warps == pim_exec.RING_WARPS or got < pim_exec.RING_WARPS


def test_ring_words_per_cta_rejects_a_column_too_large():
    with pytest.raises(ValueError, match="beside the ring"):
        pim_exec.ring_words_per_cta(
            (pim_exec.SMEM_PER_CTA - pim_exec.RING_BYTES) // 4 + 1)
    with pytest.raises(ValueError, match="shared memory with the ring"):
        pim_exec._ring_wpc(605, 1, 96)
    with pytest.raises(ValueError, match="256 threads"):
        pim_exec._ring_wpc(50, 1, 257)
    assert pim_exec._ring_wpc(605, 1, 92) == 92


def test_resolve_packs_no_stream_for_the_plain_version():
    """On ``ref`` a dense plan packs no stream and the gate-serial path no
    gates (the card's streams are tested under ``cuda``)."""
    prog = program_for("fp-serial", "add", "fp16")
    comp = ops.compiled(prog, CPU_DENSE)
    assert comp.resolve(prog, CPU_DENSE, ("x", "y")).packed is None
    assert not comp.packed
    assert comp.get_gates(prog, "cpu")[4] is None


# --------------------------------------------------------------------------
# on the card: the ring kernels against their plain versions
# --------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the ring kernels have no CPU mode")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("n_rows", [1, 4099, 100_003, 131_072])
@pytest.mark.parametrize("case", [("int-serial", "div", 8),
                                  ("fp-serial", "mul", "fp32"),
                                  ("int-parallel", "div", 64), "random-1",
                                  "gate-free", "no-input"],
                         ids=["uint8-div", "fp32-mul", "bp-div64",
                              "random-1", "gate-free", "no-input"])
def test_gate_serial_ring_kernel_matches_plain_version(cuda, case, n_rows):
    """B4 at ragged row counts and at one whose rows move as 16-byte
    vectors (131072), on a stream of many tiles, at fewer than 32 words
    per CTA (int-parallel div64: 2), and on gate-free and no-input
    programs; with the packed stream given and packed by the wrapper."""
    if isinstance(case, tuple) and case[2] == 64 and n_rows > 4099:
        pytest.skip("int-parallel div64 runs 162394 gates a word: the "
                    "plain version is timed out at this size")
    prog = {"gate-free": _gate_free, "no-input": _no_input}.get(
        case, lambda: _program(case))()
    arrays = prog.to_arrays()
    n_cells = arrays[4]
    state = _bits(np.random.default_rng(43), (n_cells, -(-n_rows // 32)))
    gates_ = [torch.from_numpy(v) for v in arrays[:4]]
    want = _np(ref.pim_exec_ref(_t(state), *gates_))
    packed = pim_exec.pack_gates(*arrays[:4], n_cells=n_cells).to(cuda)
    for kw in ({"packed": packed}, {}):
        got = pim_exec.gate_serial(_t(state).to(cuda),
                                   *[g.to(cuda) for g in gates_], **kw)
        torch.cuda.synchronize()
        assert np.array_equal(_np(got), want)
    if n_cells > 10000:
        assert pim_exec.ring_words_per_cta(n_cells) < 32


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("case", [("fp-serial", "mul", "fp32"),
                                  ("fp-serial", "add", "fp16"), "random-2",
                                  "gate-free"],
                         ids=["fp32-mul", "fp16-add", "random-2",
                              "gate-free"])
def test_level_gather_ring_kernel_matches_plain_version(cuda, case, planes):
    """B3 fused and io from the packed stream, at ragged row counts and at
    the rule's CTA width and below it."""
    s, d = _dense(case)
    packed = pim_exec.pack_levels(s.a, s.b, s.out,
                                  n_cells=s.n_cells).to(cuda)
    dc = {k: v.to(cuda) for k, v in d.items() if isinstance(v, torch.Tensor)}
    sched = [dc[k] for k in ("in_idx", "la", "lb", "lo", "out_idx")]
    kw = dict(n_cells=s.n_cells, one_cell=s.one_cell)
    rng = np.random.default_rng(44)
    vals = _bits(rng, (len(d["in_widths"]), 100_003))
    for p, w in enumerate(d["in_widths"]):
        vals[p] &= np.uint32((1 << w) - 1)
    widths = dict(in_widths=d["in_widths"], out_widths=d["out_widths"],
                  planes=planes)
    want = _np(ref.pim_exec_ref_level_fused(
        _t(vals), *[d[k] for k in ("in_idx", "la", "lb", "lo", "out_idx")],
        **widths, **kw))
    for wpc in (None, 16, 7):
        got = pim_exec.level_fused(_t(vals).to(cuda), *sched, packed=packed,
                                   words_per_cta=wpc, **widths, **kw)
        torch.cuda.synchronize()
        assert np.array_equal(_np(got), want), wpc
    k_in = int(d["in_idx"].numel())
    rows = _bits(rng, (k_in, 3001) if planes == 1 else (planes, k_in, 3001))
    want = _np(ref.pim_exec_ref_level_io(
        _t(rows), *[d[k] for k in ("in_idx", "la", "lb", "lo", "out_idx")],
        **kw))
    got = pim_exec.level_io(_t(rows).to(cuda), *sched, packed=packed, **kw)
    torch.cuda.synchronize()
    assert np.array_equal(_np(got), want)


@pytest.mark.cuda
def test_main_paths_cache_their_streams(cuda):
    """The slot and dense schedules and ``levelized=False`` launch their
    ring kernel from the stream cached at resolve time, bit-exact."""
    rng = np.random.default_rng(45)
    a = rng.standard_normal(5000).astype(np.float32)
    b = rng.standard_normal(5000).astype(np.float32)
    pim_exec.reset_counts()
    assert np.array_equal(pim.fp_add(a, b, schedule="dense"), a + b)
    assert np.array_equal(pim.fp_add(a, b), a + b)
    assert pim_exec.LAUNCHES["level_gather_fused"] == 1
    assert pim_exec.LAUNCHES["slot_scan_fused"] == 1
    prog = program_for("fp-serial", "add", "fp16")
    for kind in ("dense", "slots"):
        plan = kplan.as_plan(schedule=kind)
        comp = ops.compiled(prog, plan)
        r = comp.resolve(prog, plan, ("x", "y"))
        assert r.packed is comp.packed[(kind, "cuda")]
    x, y = rng.integers(0, 1 << 16, (2, 777), dtype=np.uint64)
    prog = program_for("int-serial", "add", 16)
    out = ops.run_program(prog, {"x": x, "y": y}, 777, levelized=False)
    assert np.array_equal(out["z"], x + y)
    assert ops.compiled(prog).gates["cuda"][4] is not None
