"""Wide schedules on the ring kernels' packed streams: slot widths and
dense caps of 9 to 64 lanes, whose levels take consecutive windows of at
most 8 records (``pim_exec.level_windows``), exact because no level reads
a cell it writes.  The packed stream of each ``program_for``
family, run window by window by the plain emulation of the kernels' loop
in ``test_torch_ring`` (every operand of a window, then its stores), must
give the outputs of the JAX package's slot executors
(``repro.kernels.slots``) or of ``ref.pim_exec_ref_level_fused``/``_io``,
under both layouts, and of the numpy oracle.  The kernels themselves are
held against their plain versions at these widths by the ``cuda`` tests
of ``test_torch_kernels.py`` and by ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import pim_exec
from repro_torch.kernels import ref
from repro_torch.kernels import slots

from test_torch_ring import (FAMILIES, TILE, _bits, _dense, _np,  # noqa: F401
                             _oracle_values, _run_packed, _run_packed_fused,
                             _slots, _t, _windows)

#: Widths past one window: levels of 9 to 64 lanes split into 2 to 8
#: windows (9 lanes: 5 + 4; 33: 7 + 7 + 7 + 6 + 6; 64: eight of 8).
WIDE = [9, 12, 16, 24, 32, 33, 64]
FAMILY_IDS = ["-".join(map(str, f)) for f in FAMILIES]


def _check_wide_stream(packed, s, width):
    """The stream of a ``width``-lane schedule: the windows of
    ``level_windows`` a level; the body, the tiles and the counts."""
    lens = pim_exec.level_windows(width)
    assert packed.n_gates == s.n_levels * width
    assert packed.n_windows == s.n_levels * len(lens)
    if s.n_levels:
        assert packed.width == pim_exec.window_width(max(lens))
        assert len(lens) > 1 and packed.width <= pim_exec.WINDOW
        pim_exec.check_packed(packed, s.a.size, s.n_cells)
        rec = packed.tiles.numpy().view(np.uint16).reshape(
            packed.n_tiles, TILE, 4)
        assert not rec[:, TILE - pim_exec.WINDOW:].any()
        firsts = [int(w[0, 3]) for w in _windows(packed)]
        assert firsts == lens * s.n_levels


@pytest.mark.parametrize("width", WIDE)
@pytest.mark.parametrize("fam", FAMILIES, ids=FAMILY_IDS)
def test_wide_slot_streams_run_like_the_slot_schedule(fam, width):
    """A slot schedule of 9 to 64 lanes packed and run window by window
    (every operand of a window, then its stores) gives the outputs of the
    JAX package's slot executors, fused on ragged rows and io, under both
    layouts, and of the numpy oracle."""
    import jax.numpy as jnp
    from repro.kernels import slots as rslots
    s, d = _slots(fam, width)
    assert s.width == width
    packed = pim_exec.pack_slots(s.a, s.b, s.out, n_cells=s.n_cells)
    _check_wide_stream(packed, s, width)
    sched = tuple(jnp.asarray(np.asarray(x, np.int32))
                  for x in (d["in_idx"], s.a, s.b, s.out, d["out_idx"]))
    rng = np.random.default_rng(48)
    n_rows = 77
    vals = _bits(rng, (len(d["in_widths"]), n_rows))
    for p, w in enumerate(d["in_widths"]):
        vals[p] &= np.uint32((1 << w) - 1)
    for planes in (1, 2):
        got = _np(_run_packed_fused(
            _t(vals), packed, torch.from_numpy(d["in_idx"]),
            torch.from_numpy(d["out_idx"]), in_widths=d["in_widths"],
            out_widths=d["out_widths"], planes=planes,
            n_cells=s.n_cells, one_cell=s.one_cell))
        padded = _np(slots._pad_rows(_t(vals), 32 * planes))
        want = np.asarray(rslots.pim_exec_ref_slots_fused(
            jnp.asarray(padded), *sched, in_widths=d["in_widths"],
            out_widths=d["out_widths"], planes=planes, **d["kw"]))
        assert np.array_equal(got, want[:, :n_rows]), planes
        k_in = len(d["in_idx"])
        rows = _bits(rng, (k_in, 3) if planes == 1 else (planes, k_in, 3))
        st = ref.assemble_state(_t(rows), torch.from_numpy(d["in_idx"]), 3,
                                n_cells=s.n_cells, one_cell=s.one_cell)
        io = _np(_run_packed(st, packed).index_select(
            -2, torch.from_numpy(d["out_idx"]).long()))
        want = np.asarray(rslots.pim_exec_ref_slots_io(
            jnp.asarray(rows), *sched, k_out=len(d["out_idx"]), **d["kw"]))
        assert np.array_equal(io, want), planes
    assert np.array_equal(got, _oracle_values(s, d, vals))


@pytest.mark.parametrize("width", WIDE)
@pytest.mark.parametrize("fam", FAMILIES, ids=FAMILY_IDS)
def test_wide_dense_streams_run_like_the_dense_schedule(fam, width):
    """A dense schedule capped at 9 to 64 lanes packed and run window by
    window gives the outputs of ``ref.pim_exec_ref_level_fused`` and
    ``_io`` under both layouts, and of the numpy oracle."""
    s, d = _dense(fam, cap=width)
    assert s.width <= width
    packed = pim_exec.pack_levels(s.a, s.b, s.out, n_cells=s.n_cells)
    if s.width > pim_exec.WINDOW:
        _check_wide_stream(packed, s, s.width)
    rng = np.random.default_rng(49)
    kw = dict(n_cells=s.n_cells, one_cell=s.one_cell)
    sched = (d["in_idx"], d["la"], d["lb"], d["lo"], d["out_idx"])
    vals = _bits(rng, (len(d["in_widths"]), 77))
    for p, w in enumerate(d["in_widths"]):
        vals[p] &= np.uint32((1 << w) - 1)
    for planes in (1, 2):
        want = ref.pim_exec_ref_level_fused(
            _t(vals), *sched, in_widths=d["in_widths"],
            out_widths=d["out_widths"], planes=planes, **kw)
        got = _run_packed_fused(
            _t(vals), packed, d["in_idx"], d["out_idx"],
            in_widths=d["in_widths"], out_widths=d["out_widths"],
            planes=planes, **kw)
        assert torch.equal(got, want), planes
        k_in = int(d["in_idx"].numel())
        rows = _bits(rng, (k_in, 3) if planes == 1 else (planes, k_in, 3))
        want = ref.pim_exec_ref_level_io(_t(rows), *sched, **kw)
        st = ref.assemble_state(_t(rows), d["in_idx"], 3, **kw)
        io = _run_packed(st, packed).index_select(-2, d["out_idx"].long())
        assert torch.equal(io, want), planes
        if planes == 1:
            oracle = np.zeros((s.n_cells, 3), np.uint32)
            oracle[d["in_idx"].numpy()] = rows
            if s.one_cell is not None:
                oracle[s.one_cell] = np.uint32(0xFFFFFFFF)
            s.exec_packed(oracle)
            assert np.array_equal(_np(io), oracle[d["out_idx"].numpy()])
