"""The port's copied core against the JAX package: program content keys,
levelized schedules (byte for byte) and the modeled cost."""

import dataclasses

import numpy as np
import pytest

from repro.core import gates as rgates
from repro.core import pim_numerics as rpn
from repro.kernels import ops as rops
from repro.runtime import telemetry as rtel
from repro_torch.core import gates as tgates
from repro_torch.core import pim_numerics as tpn
from repro_torch.kernels import ops as tops
from repro_torch.runtime import telemetry as ttel

INT_OPS = ("add", "sub", "mul", "div")
FP_KINDS = (("fp-serial", INT_OPS), ("fp-parallel", ("add", "mul", "div")))

# Every program_for family at the widths and formats the ufuncs serve.
FAMILIES = (
    [(k, op, w) for k in ("int-serial", "int-parallel")
     for w in (8, 16, 32, 64) for op in INT_OPS] +
    [(k, op, f) for k, ops in FP_KINDS
     for f in ("fp16", "bf16", "fp32") for op in ops])

# Levelizing the 64-bit multipliers and dividers takes seconds per package;
# their 64-bit ports are covered by add/sub, their depth by the 32-bit ones.
SCHEDULED = [c for c in FAMILIES
             if not (c[2] == 64 and c[1] in ("mul", "div"))]
DENSE = SCHEDULED


def _ids(cases):
    return [f"{k}-{op}-{p}" for k, op, p in cases]


def _assert_same_schedule(r, t):
    for f in ("a", "b", "out", "level_width"):
        ra, ta = getattr(r, f), getattr(t, f)
        assert ra.dtype == ta.dtype and ra.shape == ta.shape, f
        assert ra.tobytes() == ta.tobytes(), f
    for f in ("n_cells", "sink", "one_cell", "ports", "in_cells", "in_ports",
              "out_ports", "n_gates", "source_gates", "source_cells",
              "alloc", "slot_width", "copy_gates"):
        assert getattr(r, f) == getattr(t, f), f


@pytest.mark.parametrize("kind,op,param", FAMILIES, ids=_ids(FAMILIES))
def test_content_key_matches_reference(kind, op, param):
    rprog = rpn.program_for(kind, op, param)
    tprog = tpn.program_for(kind, op, param)
    assert tops.content_key(tprog) == rops.content_key(rprog)
    assert dataclasses.astuple(tprog.cost()) == \
        dataclasses.astuple(rprog.cost())


@pytest.mark.parametrize("kind,op,param", SCHEDULED, ids=_ids(SCHEDULED))
def test_slot_schedule_and_cost_match_reference(kind, op, param):
    """alloc="slots" at the reference's W=6, through each package's
    compiled-program cache (the schedule the executors run)."""
    r = rops.program_schedule(rpn.program_for(kind, op, param))
    t = tops.program_schedule(tpn.program_for(kind, op, param))
    assert t.slot_width == 6
    _assert_same_schedule(r, t)
    assert dataclasses.astuple(ttel.COST_MODEL.schedule_cost(t)) == \
        dataclasses.astuple(rtel.COST_MODEL.schedule_cost(r))


@pytest.mark.parametrize("kind,op,param", DENSE, ids=_ids(DENSE))
def test_dense_schedule_matches_reference(kind, op, param):
    r = rgates.levelize(rpn.program_for(kind, op, param), max_width=8)
    t = tgates.levelize(tpn.program_for(kind, op, param), max_width=8)
    _assert_same_schedule(r, t)


# Wide slot widths and dense caps: the widths a retuned Backend may carry,
# run on the card as levels split into windows of at most 8 lanes.
WIDE_WIDTHS = (12, 16, 32, 64)
WIDE_PROGRAMS = [("fp-serial", "add", "fp32"), ("fp-parallel", "add", "fp32"),
                 ("fp-serial", "mul", "fp32"), ("int-serial", "mul", 16)]


@pytest.mark.parametrize("width", WIDE_WIDTHS)
@pytest.mark.parametrize("kind,op,param", WIDE_PROGRAMS,
                         ids=_ids(WIDE_PROGRAMS))
def test_wide_schedules_match_reference(kind, op, param, width):
    """Slot schedules at slot width ``width`` and dense schedules capped at
    it, byte for byte the reference's, through each package's
    compiled-program cache under a retuned Backend."""
    from repro.kernels import plan as rplan
    from repro_torch.kernels import plan as tplan
    rprog, tprog = rpn.program_for(kind, op, param), \
        tpn.program_for(kind, op, param)
    for schedule, field in (("slots", "slot_width"),
                            ("dense", "level_max_width")):
        rp = rplan.as_plan(backend=rplan.Backend("ref", **{field: width}),
                           schedule=schedule)
        tp = tplan.as_plan(backend=tplan.Backend("ref", **{field: width}),
                           device="cpu", schedule=schedule)
        r = rops.program_schedule(rprog, rp)
        t = tops.program_schedule(tprog, tp)
        _assert_same_schedule(r, t)
        assert t.width <= width
        if schedule == "slots":
            assert t.slot_width == width


def test_fp16_add_modeled_cycles():
    """The tracked fp16-add row's modeled cost (1835 cycles) is a pure
    function of the schedule, so the port reproduces it exactly."""
    t = tops.program_schedule(tpn.program_for("fp-serial", "add", "fp16"))
    assert ttel.COST_MODEL.schedule_cost(t).cycles == 1835


def test_dense_and_serial_modeled_cycles_match_reference():
    """The dense schedule's modeled cost (1803 cycles for fp16 add) and the
    gate-serial model (3830) are pure functions of the program, so the port
    reproduces them exactly (BENCH_10's rows)."""
    rprog = rpn.program_for("fp-serial", "add", "fp16")
    tprog = tpn.program_for("fp-serial", "add", "fp16")
    dense = tplan.as_plan(backend="ref", device="cpu", schedule="dense")
    t = tops.program_schedule(tprog, dense)
    r = rops.program_schedule(rprog, "dense")
    _assert_same_schedule(r, t)
    tc = ttel.COST_MODEL.schedule_cost(t)
    assert tc.cycles == 1803
    assert dataclasses.astuple(tc) == \
        dataclasses.astuple(rtel.COST_MODEL.schedule_cost(r))
    ts = tops.compiled(tprog, dense).get_serial_model(tprog)
    rs = rops.compiled(rprog).get_serial_model(rprog)
    assert ts.cycles == 3830
    assert dataclasses.astuple(ts) == dataclasses.astuple(rs)


def test_dense_schedule_from_arrays_roundtrips_and_rejects():
    """A reference dense schedule carries across whole; a level that writes
    one cell twice, or an index outside the state, is refused."""
    r = rgates.levelize(rpn.program_for("int-serial", "add", 8), max_width=8)
    d = dict(a=r.a, b=r.b, out=r.out, level_width=r.level_width,
             ports=r.ports, in_ports=r.in_ports, out_ports=r.out_ports,
             one_cell=r.one_cell, n_cells=r.n_cells, alloc="dense",
             width=r.width, in_cells=r.in_cells, sink=r.sink)
    t = tops.schedule_from_arrays(d)
    for f in ("a", "b", "out", "level_width"):
        assert np.array_equal(getattr(t, f), getattr(r, f))
    assert (t.ports, t.one_cell, t.n_cells, t.sink, t.alloc) == \
        (r.ports, r.one_cell, r.n_cells, r.sink, r.alloc)
    out = r.out.copy()
    out[0, 1] = out[0, 0]
    with pytest.raises(ValueError, match="distinct cells"):
        tops.schedule_from_arrays(dict(d, out=out))
    with pytest.raises(ValueError, match="outside"):
        tops.schedule_from_arrays(dict(d, n_cells=r.sink))


def test_identity_program_matches_reference():
    assert tops.content_key(tpn.build_identity(12)) == \
        rops.content_key(rpn.build_identity(12))


def test_schedule_from_arrays_roundtrips_reference_schedule():
    r = rops.program_schedule(rpn.program_for("int-serial", "mul", 8))
    t = tops.schedule_from_arrays(dict(
        a=r.a, b=r.b, out=r.out, level_width=r.level_width, ports=r.ports,
        in_ports=r.in_ports, out_ports=r.out_ports, one_cell=r.one_cell,
        n_cells=r.n_cells, alloc=r.alloc, width=r.width,
        in_cells=r.in_cells))
    for f in ("a", "b", "out", "level_width"):
        assert np.array_equal(getattr(t, f), getattr(r, f))
    assert (t.ports, t.one_cell, t.n_cells, t.slot_width) == \
        (r.ports, r.one_cell, r.n_cells, 6)


@pytest.mark.parametrize("change,match", [
    (dict(alloc="banded"), "slot schedules"),
    (dict(width=5), "lanes wide"),
    (dict(n_cells=10), "outside"),
    (dict(one_cell=10**6), "outside"),
])
def test_schedule_from_arrays_rejects_bad_schedules(change, match):
    r = rops.program_schedule(rpn.program_for("int-serial", "add", 8))
    d = dict(a=r.a, b=r.b, out=r.out, level_width=r.level_width,
             ports=r.ports, in_ports=r.in_ports, out_ports=r.out_ports,
             one_cell=r.one_cell, n_cells=r.n_cells, alloc=r.alloc,
             width=r.width)
    d.update(change)
    with pytest.raises(ValueError, match=match):
        tops.schedule_from_arrays(d)


# --------------------------------------------------------------------------
# the execution plan and the compiled-program cache
# --------------------------------------------------------------------------

from repro.kernels import plan as rplan  # noqa: E402
from repro_torch.kernels import plan as tplan  # noqa: E402


def test_word_layout_and_chunking_match_reference():
    for name in ("rows32", "rows64"):
        r, t = rplan.LAYOUTS[name], tplan.LAYOUTS[name]
        assert t.rows_per_word == r.rows_per_word
        for rows in (0, 1, 31, 32, 33, 63, 64, 65, 1000):
            for pad in (1, 4):
                assert t.n_words(rows, pad) == r.n_words(rows, pad)
        assert t.state_shape(5, 7) == r.state_shape(5, 7)
    for chunk in (1, 31, 32, 1000, 1 << 18):
        t = tplan.as_plan(backend="ref", device="cpu", chunk_rows=chunk)
        r = rplan.ExecPlan(chunk_rows=chunk)
        assert t.effective_chunk_rows == r.effective_chunk_rows


def test_plan_keys():
    """``key`` separates every execution choice; ``compile_key`` only the
    slot width, so backends and devices share one schedule."""
    base = tplan.as_plan(backend="ref", device="cpu")
    assert base.compile_key == (6, 8, 128)
    assert base.compile_key == rplan.ExecPlan().compile_key
    narrow = tplan.as_plan(backend=tplan.Backend("ref", slot_width=4),
                           device="cpu")
    wide_cta = tplan.as_plan(backend=tplan.Backend("ref", words_per_cta=64),
                             device="cpu")
    assert narrow.compile_key != base.compile_key
    assert wide_cta.compile_key == base.compile_key
    assert len({base.key, narrow.key, wide_cta.key,
                tplan.as_plan(base, chunk_rows=64).key}) == 4
    assert tplan.as_plan(base) is base
    with pytest.raises(ValueError, match="conflicting backends"):
        tplan.as_plan("ref", backend="numpy")


def test_tuned_defaults_overlay_only_hand_defaults():
    tplan.clear_tuned()
    try:
        tplan.register_tuned("add:16", "rows32", "ref",
                             {"chunk_rows": 4096, "words_per_cta": 64})
        with pytest.raises(ValueError, match="unknown tuned override"):
            tplan.register_tuned("add:16", "rows32", "ref", {"tile": 1})
        base = tplan.as_plan(backend="ref", device="cpu")
        tuned = tplan.apply_tuned(base, "add:16")
        assert tuned.effective_chunk_rows == 4096
        assert tuned.backend.words_per_cta == 64
        assert tplan.apply_tuned(base, "add:8") is base
        mine = tplan.as_plan(backend=tplan.Backend("ref", words_per_cta=8),
                             device="cpu", chunk_rows=96)
        kept = tplan.apply_tuned(mine, "add:16")
        assert (kept.backend.words_per_cta, kept.effective_chunk_rows) == \
            (8, 96)
    finally:
        tplan.clear_tuned()


def test_compiled_cache_evicts_unpinned_and_rebuilds_identically():
    plan = tplan.as_plan(backend="ref", device="cpu")
    progs = [tpn.program_for("int-serial", op, 8)
             for op in ("add", "sub", "mul")]
    before = [tops.program_schedule(p, plan) for p in progs]
    old = tops.set_compiled_cache_cap(64)
    try:
        key = tops.pin_program(progs[0], plan)
        tops.set_compiled_cache_cap(1)        # evicts all but the pin
        assert tops.is_compiled(progs[0], plan)
        assert not tops.is_compiled(progs[1], plan)
        assert tops.pin_program(progs[0], plan) == key      # pins nest
        assert tops.unpin_program(key) is True
        assert tops.unpin_program(key) is False
        again = tops.program_schedule(progs[1], plan)
        _assert_same_schedule(before[1], again)
    finally:
        tops.set_compiled_cache_cap(old)
