"""The port's scale layer against the JAX package's.

``repro_torch.kernels.ops`` on ``device="cpu", backend="ref"`` (the plain
PyTorch executors) is held bit for bit against ``repro.kernels.ops`` on
its ``ref`` backend, with inputs made from a seed with numpy: streaming
across chunk edges with a ragged last chunk on every schedule and layout,
``dispatch_program``, ``run_program_groups`` over mixed groups, row
sharding over ``mesh=("cpu",) * k`` (one device, k shards), deadlines
between chunks, and the reference's validation errors.
"""

import time

import numpy as np
import pytest
import torch

from repro.core import bitserial as rbs
from repro.core import bitserial_fp as rbsfp
from repro.core.floatfmt import FORMATS as RFORMATS
from repro.kernels import ops as rops
from repro.runtime.faults import DeadlineExceeded as RDeadlineExceeded
from repro_torch import pim_ufunc as tpim
from repro_torch.core.pim_numerics import program_for
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plan as tplan
from repro_torch.kernels import transfer
from repro_torch.runtime.faults import DeadlineExceeded

CPU = dict(device="cpu", backend="ref")
SCHEDULES = ("slots", "slots-static", "dense")
LAYOUTS = ("rows32", "rows64")
#: Row counts of the reference's chunk-edge test (tests/test_ufunc.py).
EDGE_ROWS = (96, 97, 127, 128, 129)


def _same(got: dict, want: dict) -> bool:
    return set(got) == set(want) and all(
        [int(v) for v in np.ravel(got[k])] ==
        [int(v) for v in np.ravel(want[k])] for k in want)


def _ports(rng, program, n):
    """Random values for every in-port of ``program`` (its width)."""
    return {name: rng.integers(0, 1 << min(len(cells), 63), n,
                               dtype=np.uint64)
            for name, cells in program.ports.items()
            if name in program.in_ports}


# (name, reference program, port program): add16 runs the fused branch,
# add32 (a 33-cell sum) and mul32 (a 64-cell product) the io branch
PROGRAMS = {
    "add16": (lambda: rbs.build_add(16),
              lambda: program_for("int-serial", "add", 16)),
    "add32": (lambda: rbs.build_add(32),
              lambda: program_for("int-serial", "add", 32)),
    "mul32": (lambda: rbs.build_mul(32),
              lambda: program_for("int-serial", "mul", 32)),
}
_want_cache: dict = {}


def _case(name, n, seed=9):
    """(port program, inputs, the reference's one-shot run_program)."""
    key = (name, n, seed)
    if key not in _want_cache:
        rprog, tprog = PROGRAMS[name][0](), PROGRAMS[name][1]()
        ins = _ports(np.random.default_rng(seed + n), tprog, n)
        _want_cache[key] = (tprog, ins,
                            rops.run_program(rprog, ins, n, backend="ref"))
    return _want_cache[key]


# --------------------------------------------------------------------------
# streaming
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("name", ["add16", "add32"])
def test_streaming_matches_reference_across_chunk_edges(name, schedule,
                                                        layout):
    """Chunk boundaries at 0, 1, 31, 32 and 33 rows from a chunk edge, the
    last chunk ragged, on every schedule and layout: streaming equals the
    reference's one-shot run_program (chunks of 32 rows, 64 under rows64,
    the layout's word)."""
    for n in EDGE_ROWS:
        prog, ins, want = _case(name, n)
        got = tops.run_program_streaming(prog, ins, n, chunk_rows=32,
                                         schedule=schedule, layout=layout,
                                         **CPU)
        assert _same(got, want), n


def test_streaming_chunks_reuse_their_staging_lanes(monkeypatch):
    """Every chunk of a stream dispatches with the padded shape of a whole
    chunk, the ragged tail too, and goes through the shard's lane."""
    prog, ins, want = _case("add16", 129)
    seen = []
    orig = tops._dispatch_levelized

    def spy(program, inputs, n_rows, plan, pad_rows=None, **kw):
        seen.append((n_rows, pad_rows))
        return orig(program, inputs, n_rows, plan, pad_rows, **kw)

    monkeypatch.setattr(tops, "_dispatch_levelized", spy)
    got = tops.run_program_streaming(prog, ins, 129, chunk_rows=32, **CPU)
    assert _same(got, want)
    assert seen == [(32, 32)] * 4 + [(1, 32)]
    assert transfer.lane("cpu") is transfer.lane("cpu", 0)


def test_streaming_below_one_chunk_runs_once():
    prog, ins, want = _case("add16", 97)
    assert _same(tops.run_program_streaming(prog, ins, 97, **CPU), want)


# --------------------------------------------------------------------------
# dispatch_program and run_program_groups
# --------------------------------------------------------------------------

@pytest.mark.parametrize("pad_rows", [None, 128])
@pytest.mark.parametrize("name", ["add16", "mul32"])
def test_dispatch_program_matches_reference(name, pad_rows):
    prog, ins, want = _case(name, 97)
    fin = tops.dispatch_program(prog, ins, 97, pad_rows=pad_rows, **CPU)
    assert callable(fin)
    assert _same(fin(), want)


def _fp16_bits(rng, n):
    return RFORMATS["fp16"].random_bits(rng, n, emin=10, emax=20).astype(
        np.uint64)


def test_run_program_groups_matches_reference():
    """Mixed groups -- int and fp, a numpy group in the middle (a
    synchronization point), a group larger than its chunk (tests/
    test_pim_batch.py's case) -- in one pipeline, against the reference's
    run_program_groups."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 1 << 16, 100).astype(np.uint64)
    y = rng.integers(0, 1 << 16, 100).astype(np.uint64)
    u = rng.integers(0, 256, 7).astype(np.uint64)
    v = rng.integers(0, 256, 7).astype(np.uint64)
    fa, fb = _fp16_bits(rng, 70), _fp16_bits(rng, 70)
    w = rng.integers(0, 1 << 32, 40).astype(np.uint64)

    def groups(add16, mul8, fp16, add32, **kw):
        return [
            dict(program=add16, inputs={"x": x, "y": y}, n_rows=100,
                 chunk_rows=32, **kw),                      # 4 chunks
            dict(program=mul8, inputs={"x": u, "y": v}, n_rows=7, **kw),
            dict(program=add16, inputs={"x": x[:3], "y": y[:3]}, n_rows=3,
                 backend="numpy"),                          # sync point
            dict(program=fp16, inputs={"x": fa, "y": fb}, n_rows=70,
                 chunk_rows=64, **kw),                      # 2 chunks
            dict(program=add32, inputs={"x": w, "y": w[::-1].copy()},
                 n_rows=40, **kw),                          # io branch
        ]

    want = rops.run_program_groups(groups(
        rbs.build_add(16), rbs.build_mul(8),
        rbsfp.build_fp_add(RFORMATS["fp16"]), rbs.build_add(32),
        backend="ref"))
    got = tops.run_program_groups(groups(
        program_for("int-serial", "add", 16),
        program_for("int-serial", "mul", 8),
        program_for("fp-serial", "add", "fp16"),
        program_for("int-serial", "add", 32), **CPU))
    assert len(got) == len(want) == 5
    for g, wv in zip(got, want):
        assert _same(g, wv)
    assert np.array_equal(got[1]["z"], u * v)
    assert np.array_equal(got[2]["z"], x[:3] + y[:3])


def test_run_program_groups_take_plans_and_layouts():
    prog, ins, want = _case("add16", 129)
    plan = tplan.as_plan(layout="rows64", schedule="dense", chunk_rows=64,
                         **CPU)
    got = tops.run_program_groups([
        dict(program=prog, inputs=ins, n_rows=129, plan=plan),
        dict(program=prog, inputs=ins, n_rows=129, layout="rows64",
             mesh=("cpu",) * 3, chunk_rows=64, backend="ref")])
    assert _same(got[0], want) and _same(got[1], want)


# --------------------------------------------------------------------------
# row sharding
# --------------------------------------------------------------------------

@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("shards", [2, 3, 4])
@pytest.mark.parametrize("name", ["add16", "mul32"])
def test_sharded_run_program_matches_unsharded_reference(name, shards,
                                                         layout):
    """``mesh=("cpu",) * k``: k shards on one device, each a contiguous
    block of whole words (rows64 keeps both planes of a word together),
    equal to the reference's unsharded run_program -- which the
    reference's own sharded test holds equal to its sharded one."""
    for n in (97, 1000):
        prog, ins, want = _case(name, n)
        got = tops.run_program(prog, ins, n, mesh=("cpu",) * shards,
                               layout=layout, backend="ref")
        assert _same(got, want), n


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_sharded_streaming_matches_reference(schedule):
    for name in ("add16", "mul32"):
        prog, ins, want = _case(name, 1000)
        got = tops.run_program_streaming(
            prog, ins, 1000, chunk_rows=256, mesh=("cpu",) * 3,
            schedule=schedule, backend="ref")
        assert _same(got, want), name


def test_sharded_packed_block_pads_shards_of_zero_rows():
    """A shard with no real rows still returns its block of zero-padded
    words: 33 rows over 4 shards are 4 words, the last two padding."""
    prog, ins, _ = _case("add16", 33)
    rprog = PROGRAMS["add16"][0]()
    want = rops.dispatch_packed(rprog, 33, "ref", inputs=ins)()
    got = tops.dispatch_packed(prog, 33, tplan.as_plan(
        mesh=("cpu",) * 4, backend="ref"), inputs=ins)()
    assert got.dtype == np.uint32 and got.shape == (want.shape[0], 4)
    assert np.array_equal(got[:, :want.shape[1]], want)
    assert not got[:, want.shape[1]:].any()


def test_ufunc_shards_and_mesh_match_reference():
    from repro import pim_ufunc as rpim
    rng = np.random.default_rng(3)
    x = rng.integers(0, 1 << 16, 300, dtype=np.uint64).astype(np.uint16)
    y = rng.integers(0, 1 << 16, 300, dtype=np.uint64).astype(np.uint16)
    want = rpim.add(x, y)
    for kw in ({"shards": 1}, {"shards": 4}, {"mesh": ("cpu",) * 2},
               {"mesh": ("cpu",) * 3, "chunk_rows": 64}):
        p = tpim.prepare("add", x, y, **kw, **CPU)
        assert p.mesh == kw.get("mesh"), kw     # no CUDA device: no mesh
        assert np.array_equal(p.run(), want), kw


def test_row_mesh_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert tops.row_mesh() is None
    assert tops.row_mesh(4) is None


def test_row_mesh_never_repeats_a_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tops.row_mesh() == ("cuda:0", "cuda:1", "cuda:2", "cuda:3")
    assert tops.row_mesh(2) == ("cuda:0", "cuda:1")
    assert tops.row_mesh(8) == tops.row_mesh()
    assert tops.row_mesh(1) is None


def test_plan_mesh_identity():
    a = tplan.as_plan(mesh=["cpu", "cpu"], backend="ref")
    b = tplan.as_plan(mesh=("cpu",) * 3, backend="ref")
    plain = tplan.as_plan(**CPU)
    assert a.mesh == ("cpu", "cpu") and a.device == "cpu"
    assert a.devices == ("cpu", "cpu") and plain.devices == ("cpu",)
    assert a.key != b.key != plain.key
    assert a.compile_key == b.compile_key == plain.compile_key
    assert tplan.as_plan(plain, mesh=("cpu",) * 2).mesh == ("cpu", "cpu")


# --------------------------------------------------------------------------
# deadlines
# --------------------------------------------------------------------------

def _fake_clock(monkeypatch):
    """time.monotonic of the port's ops, one second a call."""
    ticks = iter(range(10 ** 6))
    monkeypatch.setattr(tops.time, "monotonic", lambda: next(ticks))


def test_deadline_exceeded_between_chunks(monkeypatch):
    prog, ins, _ = _case("add16", 129)
    launched = []
    orig = tops._dispatch_levelized
    monkeypatch.setattr(tops, "_dispatch_levelized",
                        lambda *a, **k: launched.append(1) or orig(*a, **k))
    _fake_clock(monkeypatch)
    with pytest.raises(DeadlineExceeded, match="deadline exceeded"):
        tops.run_program_streaming(prog, ins, 129, chunk_rows=32,
                                   deadline=2.5, **CPU)
    assert len(launched) == 2           # checks at 0, 1, 2 pass; 3 raises
    assert issubclass(DeadlineExceeded, RuntimeError)
    assert issubclass(RDeadlineExceeded, RuntimeError)


def test_deadline_in_the_past_launches_nothing(monkeypatch):
    prog, ins, _ = _case("add16", 97)
    gone = time.monotonic() - 1.0
    with pytest.raises(DeadlineExceeded):
        tops.run_program_streaming(prog, ins, 97, deadline=gone, **CPU)
    with pytest.raises(DeadlineExceeded):
        tops.run_program_groups([dict(program=prog, inputs=ins, n_rows=97,
                                      deadline=gone, **CPU)])
    with pytest.raises(DeadlineExceeded):
        tops.dispatch_packed(prog, 97, tplan.as_plan(**CPU), inputs=ins,
                             deadline=gone)


def test_group_deadline_between_chunks(monkeypatch):
    prog, ins, _ = _case("add16", 129)
    _fake_clock(monkeypatch)
    with pytest.raises(DeadlineExceeded):
        tops.run_program_groups([dict(program=prog, inputs=ins, n_rows=129,
                                      chunk_rows=32, deadline=3.5, **CPU)])


# --------------------------------------------------------------------------
# the reference's validation errors
# --------------------------------------------------------------------------

def _raises_like(fn_t, fn_r, exc, match):
    with pytest.raises(exc, match=match):
        fn_t()
    with pytest.raises(exc, match=match):
        fn_r()


def test_validation_errors_match_reference():
    tp, rp = PROGRAMS["add16"][1](), PROGRAMS["add16"][0]()
    x = np.arange(64, dtype=np.uint64)
    short = {"x": x[:10], "y": x[:10]}
    _raises_like(
        lambda: tops.run_program_streaming(tp, {"x": x, "y": x}, 64,
                                           backend="numpy"),
        lambda: rops.run_program_streaming(rp, {"x": x, "y": x}, 64,
                                           backend="numpy"),
        ValueError, "streaming requires a levelized")
    _raises_like(
        lambda: tops.run_program_streaming(tp, short, 64, chunk_rows=32,
                                           **CPU),
        lambda: rops.run_program_streaming(rp, short, 64, backend="ref",
                                           chunk_rows=32),
        ValueError, "has 10 rows, expected 64")
    _raises_like(
        lambda: tops.run_program_groups([dict(program=tp, inputs=short,
                                              n_rows=64, **CPU)]),
        lambda: rops.run_program_groups([dict(program=rp, inputs=short,
                                              n_rows=64, backend="ref")]),
        ValueError, "group 0: input 'x' has 10 rows")
    _raises_like(
        lambda: tops.dispatch_program(tp, {"x": x, "y": x}, 64,
                                      backend="numpy"),
        lambda: rops.dispatch_program(rp, {"x": x, "y": x}, 64,
                                      backend="numpy"),
        ValueError, "dispatch requires a levelized")
    _raises_like(
        lambda: tplan.as_plan(backend="numpy", mesh=("cpu",)),
        lambda: rops.as_plan(backend="numpy", mesh=object()),
        ValueError, "mesh sharding requires a levelized")
    _raises_like(
        lambda: tops.run_program(tp, {"x": x, "y": x}, 64, levelized=False,
                                 mesh=("cpu",) * 2, backend="ref"),
        lambda: rops.run_program(rp, {"x": x, "y": x}, 64, levelized=False,
                                 mesh=object(), backend="ref"),
        ValueError, "mesh sharding requires a levelized")


def test_packed_dispatch_errors_match_reference():
    tp, rp = PROGRAMS["add16"][1](), PROGRAMS["add16"][0]()
    tplan_, rplan_ = tplan.as_plan(**CPU), rops.as_plan(backend="ref")
    x = np.arange(64, dtype=np.uint64)
    block = np.zeros((32, 2), np.uint32)
    cases = [
        (dict(), ValueError, "exactly one of inputs= or in_block="),
        (dict(inputs={"x": x, "y": x}, in_block=block),
         ValueError, "exactly one of"),
        (dict(in_block=block), ValueError, "in_block requires in_names"),
        (dict(in_block=block[:31], in_names=("x", "y")), ValueError,
         "packed input stacks 31 cells"),
        (dict(in_block=np.zeros((32, 3), np.uint32), in_names=("x", "y")),
         ValueError, "packed input has 3 words, dispatch shape allows 2"),
    ]
    for kw, exc, match in cases:
        _raises_like(lambda: tops.dispatch_packed(tp, 64, tplan_, **kw)(),
                     lambda: rops.dispatch_packed(rp, 64, rplan_, **kw)(),
                     exc, match)
    _raises_like(
        lambda: tops.dispatch_packed(tp, 64, "numpy", inputs={"x": x}),
        lambda: rops.dispatch_packed(rp, 64, "numpy", inputs={"x": x}),
        ValueError, "packed dispatch requires a levelized")
    # a stage ordinal only salts a verified stage: a plain plan runs as
    # with none, in both packages
    got = tops.dispatch_packed(tp, 64, tplan_, inputs={"x": x, "y": x},
                               stage=1)()
    want = rops.dispatch_packed(rp, 64, rplan_, inputs={"x": x, "y": x},
                                stage=1)()
    assert np.array_equal(got, np.asarray(want))


def test_packed_dispatch_matches_reference_block():
    """The packed output block of one stage, from values and from a block,
    both layouts and every schedule, equals the reference's."""
    tp, rp = PROGRAMS["add32"][1](), PROGRAMS["add32"][0]()
    rng = np.random.default_rng(2)
    ins = _ports(rng, tp, 97)
    for layout in LAYOUTS:
        want = rops.dispatch_packed(rp, 97, rops.as_plan(
            backend="ref", layout=layout), inputs=ins)()
        rows = 64 if layout == "rows32" else 128          # two words
        blk = rng.integers(0, 1 << 32, want.shape[:-2] + (64, 2),
                           dtype=np.uint64).astype(np.uint32)
        want_b = rops.dispatch_packed(rp, rows, rops.as_plan(
            backend="ref", layout=layout), in_block=blk,
            in_names=("x", "y"))()
        for schedule in SCHEDULES:
            plan = tplan.as_plan(layout=layout, schedule=schedule, **CPU)
            got = tops.dispatch_packed(tp, 97, plan, inputs=ins)()
            assert got.dtype == np.uint32
            assert np.array_equal(got, want), (layout, schedule)
            got_b = tops.dispatch_packed(tp, rows, plan, in_block=blk,
                                         in_names=("x", "y"))()
            assert np.array_equal(got_b, want_b), (layout, schedule)
