"""The port's fusion and packed reductions against the JAX package's.

``repro_torch.pim_ufunc``'s ``lazy``/``fuse``/``reduce_sum``/``dot``/
``gemv`` and ``repro_torch.core.pim_numerics``' ``tree_reduce_rows``,
``PIMVectorUnit`` and ``pim_linear_i8`` on ``device="cpu",
backend="ref"`` are held bit for bit against ``repro`` on its ``ref``
backend and against numpy, with inputs made from a seed with numpy: fused
chains on every schedule and layout, dot and gemv in int and fp16, the
one pack and one unpack of a reduction, the tree's in-word shift with row
31 set and its rows64 re-seam at odd multiples of 32 rows, every packed
tree level against the reference's.
"""

import numpy as np
import pytest
import torch

from repro import pim_ufunc as rpim
from repro.core import pim_numerics as rpn
from repro.kernels import ops as rops
from repro_torch import pim_ufunc as tpim
from repro_torch.core import pim_numerics as tpn
from repro_torch.kernels import ops as tops
from repro_torch.kernels import plan as tplan

CPU = dict(device="cpu", backend="ref")
SCHEDULES = ("slots", "slots-static", "dense")
LAYOUTS = ("rows32", "rows64")


def _u16(a):
    return np.asarray(a).view(np.uint16)


def _chain(pim, spec, leaves, fmt=None, width=None):
    """The lazy graph of ``spec`` (``(op, l, r)`` nested, leaf indices)
    under one package's ``pim``: int leaves at ``width`` bits, fp leaves
    native (``fmt`` None) or bit patterns."""
    if isinstance(spec, int):
        if width is not None:
            return pim.lazy(leaves[spec], width=width)
        return pim.lazy(leaves[spec], fmt=fmt)
    op, ls, rs = spec
    if width is None:
        op = "fp_" + op
    return getattr(pim, op)(_chain(pim, ls, leaves, fmt, width),
                            _chain(pim, rs, leaves, fmt, width))


def _host_fp16_tree_sum(prods, total):
    """Same-shape host reference for the in-memory fp16 adder tree."""
    p = np.zeros(total, np.float16)
    p[:len(prods)] = prods
    while len(p) > 1:
        h = len(p) // 2
        p = (p[:h] + p[h:]).astype(np.float16)
    return p[0]


# ------------------------------------------- chain parity: schedules/layouts

SPEC = ("add", ("mul", 0, 1), ("sub", 2, 3))
_chain_want: dict = {}


def _chain_case(kind):
    """(leaves, the reference's fused result) of the depth-3 chain of
    tests/test_fusion.py, 33 rows (rows64 padding), made once."""
    if kind not in _chain_want:
        rng = np.random.default_rng(7)
        n = 33
        if kind == "int":
            leaves = [rng.integers(0, 16, n).astype(np.uint64)
                      for _ in range(4)]
            kw = dict(width=4)
        elif kind == "fp16":
            leaves = [rng.standard_normal(n).astype(np.float16)
                      for _ in range(4)]
            kw = {}
        else:
            leaves = [((rng.integers(100, 140, n) << 7)
                       | rng.integers(0, 128, n)).astype(np.uint64)
                      for _ in range(4)]            # normal bf16 patterns
            kw = dict(fmt="bf16")
        want = _chain(rpim, SPEC, leaves, **kw).run(backend="ref")
        _chain_want[kind] = (leaves, kw, want)
    return _chain_want[kind]


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("kind", ["int", "fp16", "bf16"])
def test_fused_chain_matches_reference(kind, schedule, layout):
    leaves, kw, want = _chain_case(kind)
    got = _chain(tpim, SPEC, leaves, **kw).run(schedule=schedule,
                                               layout=layout, **CPU)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert [int(v) for v in np.ravel(got.view(np.uint16) if kind == "fp16"
                                     else got)] == \
        [int(v) for v in np.ravel(want.view(np.uint16) if kind == "fp16"
                                  else want)]


def _rand_chain(rng, n_ops):
    """tests/test_fusion.py's random chain of ``n_ops`` nodes (at most two
    muls)."""
    muls, spec = 0, 0
    for i in range(n_ops):
        op = rng.choice(["add", "sub", "mul"])
        if op == "mul":
            if muls >= 2:
                op = rng.choice(["add", "sub"])
            else:
                muls += 1
        spec = (op, spec, i + 1) if rng.random() < 0.7 \
            else (op, i + 1, spec)
    return spec


def test_randomized_chains_match_reference():
    """Chains of 2 to 5 ops -- the widest of tests/test_fusion.py is the
    depth-5 one -- fused, int and fp16, against the reference's fused
    chain and the per-op eager chain of the port."""
    rng = np.random.default_rng(11)
    for n_ops in (2, 3, 4, 5):
        spec = _rand_chain(rng, n_ops)
        ints = [rng.integers(0, 16, 40).astype(np.uint64)
                for _ in range(n_ops + 1)]
        got = _chain(tpim, spec, ints, width=4).run(**CPU)
        want = _chain(rpim, spec, ints, width=4).run(backend="ref")
        assert [int(v) for v in got] == [int(v) for v in want], spec
        fps = [rng.standard_normal(40).astype(np.float16)
               for _ in range(n_ops + 1)]
        gotf = _chain(tpim, spec, fps).run(**CPU)
        wantf = _chain(rpim, spec, fps).run(backend="ref")
        assert np.array_equal(_u16(gotf), _u16(wantf)), spec


def test_fused_handle_matches_reference():
    rng = np.random.default_rng(3)
    a, b, c = (rng.integers(0, 256, 65).astype(np.uint64) for _ in range(3))
    t = tpim.fuse((tpim.lazy(a, width=8) * tpim.lazy(b, width=8))
                  + tpim.lazy(c, width=8), **CPU)
    r = rpim.fuse((rpim.lazy(a, width=8) * rpim.lazy(b, width=8))
                  + rpim.lazy(c, width=8), backend="ref")
    assert t.op == r.op == "expr"
    assert t.fused_ops == r.fused_ops == 2
    assert t.provenance == r.provenance == (("mul", 8), ("add", 16))
    assert t.key == rops.content_key(r.program)
    assert np.array_equal(t.run(), a * b + c)
    plain = tpim.prepare("add", a.astype(np.uint8), b.astype(np.uint8),
                         **CPU)
    assert plain.fused_ops == 1 and plain.provenance == ()


def test_fused_chain_is_one_program_one_pack_one_unpack(monkeypatch):
    rng = np.random.default_rng(3)
    a, b, c = (rng.integers(0, 256, 65).astype(np.uint64) for _ in range(3))
    calls = []
    orig = tops._dispatch_levelized
    monkeypatch.setattr(tops, "_dispatch_levelized", lambda *a_, **k: (
        calls.append(k.get("packed_in") is None) or orig(*a_, **k)))
    e = (tpim.lazy(a, width=8) * tpim.lazy(b, width=8)) \
        + tpim.lazy(c, width=8)
    assert np.array_equal(e.run(**CPU), a * b + c)
    assert calls == [True]
    calls.clear()
    unfused = tpim.add(tpim.mul(a, b, width=8, **CPU), c, width=16, **CPU)
    assert len(calls) == 2 and np.array_equal(unfused, a * b + c)


@pytest.mark.parametrize("call", [
    lambda pim, la, a: pim.div(la, la),
    lambda pim, la, a: pim.fp_div(pim.lazy(a.astype(np.float16)),
                                  np.float16(1)),
    lambda pim, la, a: pim.add(la, pim.lazy(a.astype(np.float16))),
    lambda pim, la, a: pim.fp_add(pim.lazy(np.full(4, 0x3f80, np.uint64),
                                           fmt="bf16"),
                                  pim.lazy(a.astype(np.float16))),
    lambda pim, la, a: pim.add(la, la, backend="ref"),
    lambda pim, la, a: pim.fuse(a),
    lambda pim, la, a: pim.gemv(la + la, la),
], ids=["div", "fp_div", "kinds", "formats", "exec-keyword", "not-lazy",
        "gemv-of-expression"])
def test_fusion_type_errors_match_reference(call):
    a = np.arange(4, dtype=np.uint8)
    for pim in (tpim, rpim):
        with pytest.raises(TypeError) as err:
            call(pim, pim.lazy(a), a)
        if pim is tpim:
            message = str(err.value)
        else:
            assert str(err.value) == message


def test_fusion_value_errors_match_reference():
    a = np.arange(4, dtype=np.uint8)
    for pim in (tpim, rpim):
        with pytest.raises(ValueError, match="bit-serial only"):
            pim.fuse(pim.lazy(a) + pim.lazy(a), parallel=True,
                     **(CPU if pim is tpim else {"backend": "ref"}))
        with pytest.raises(ValueError, match="width must be >= 1"):
            pim.lazy(a, width=0)
        with pytest.raises(ValueError, match="unknown format"):
            pim.lazy(a, fmt="fp8")
        with pytest.raises(ValueError, match="need a"):
            pim.gemv(a, a, width=8)
        with pytest.raises(ValueError, match="empty reduction"):
            pim.reduce_sum(np.zeros(0, np.uint8),
                           **(CPU if pim is tpim else {"backend": "ref"}))


# --------------------------------------------------------- dot / gemv

@pytest.mark.parametrize("n", [1, 31, 64, 1000])
def test_dot_int_matches_reference_and_numpy(n):
    rng = np.random.default_rng(n)
    x = rng.integers(0, 256, n).astype(np.uint64)
    y = rng.integers(0, 256, n).astype(np.uint64)
    got = tpim.dot(x, y, width=8, **CPU)
    assert int(got) == int(np.dot(x.astype(object), y.astype(object)))
    assert int(got) == int(rpim.dot(x, y, width=8, backend="ref"))


@pytest.mark.parametrize("n", [17, 48])
def test_dot_fp16_tree_order_nonpow2(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float16)
    y = rng.standard_normal(n).astype(np.float16)
    got = tpim.dot(x, y, **CPU)
    total = 1 << (n - 1).bit_length()
    want = _host_fp16_tree_sum((x * y).astype(np.float16), total)
    assert got.dtype == np.float16
    assert _u16(got) == _u16(want)
    assert _u16(got) == _u16(rpim.dot(x, y, backend="ref"))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("schedule", SCHEDULES)
def test_dot_fused_equals_unfused(schedule, layout):
    """fused=False runs the same pairing through per-op round trips."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 256, 37).astype(np.uint64)
    y = rng.integers(0, 256, 37).astype(np.uint64)
    kw = dict(schedule=schedule, layout=layout, **CPU)
    assert int(tpim.dot(x, y, width=8, **kw)) == \
        int(tpim.dot(x, y, width=8, fused=False, **kw)) == \
        int(np.dot(x.astype(object), y.astype(object)))
    xf = rng.standard_normal(37).astype(np.float16)
    yf = rng.standard_normal(37).astype(np.float16)
    a = tpim.dot(xf, yf, **kw)
    assert _u16(a) == _u16(tpim.dot(xf, yf, fused=False, **kw))
    assert _u16(a) == _u16(rpim.dot(xf, yf, backend="ref", fused=False))


@pytest.mark.parametrize("m", [1, 31, 64, 1000])
def test_gemv_int_matches_numpy_and_reference(m):
    rng = np.random.default_rng(m)
    k = 17                                   # non-pow2 reduction width
    a = rng.integers(0, 16, (m, k)).astype(np.uint64)
    x = rng.integers(0, 16, k).astype(np.uint64)
    got = tpim.gemv(a, x, width=4, **CPU)
    assert np.array_equal(np.asarray(got, np.uint64), a @ x)
    if m in (31, 64):
        want = rpim.gemv(a, x, width=4, backend="ref")
        assert np.array_equal(np.asarray(got, np.uint64),
                              np.asarray(want, np.uint64))


@pytest.mark.parametrize("m", [1, 31, 64, 1000])
def test_gemv_fp16_matches_host_tree(m):
    rng = np.random.default_rng(9 + m)
    k = 12
    a = rng.standard_normal((m, k)).astype(np.float16)
    x = rng.standard_normal(k).astype(np.float16)
    got = tpim.gemv(a, x, **CPU)
    assert got.dtype == np.float16 and got.shape == (m,)
    want = np.array([_host_fp16_tree_sum((a[i] * x).astype(np.float16), 16)
                     for i in range(m)], np.float16)
    assert np.array_equal(_u16(got), _u16(want))
    if m == 31:
        assert np.array_equal(_u16(got), _u16(rpim.gemv(a, x,
                                                        backend="ref")))


def test_reduce_sum_of_fused_expression():
    rng = np.random.default_rng(13)
    a, b, c = (rng.integers(0, 16, 20).astype(np.uint64) for _ in range(3))
    for pim, kw in ((tpim, CPU), (rpim, {"backend": "ref"})):
        e = (pim.lazy(a, width=4) * pim.lazy(b, width=4)) \
            + pim.lazy(c, width=4)
        assert int(pim.reduce_sum(e, **kw)) == int(np.sum(a * b + c))
    x = rng.standard_normal(20).astype(np.float16)
    got = tpim.reduce_sum(x, **CPU)
    assert _u16(got) == _u16(rpim.reduce_sum(x, backend="ref"))
    assert _u16(got) == _u16(_host_fp16_tree_sum(x, 32))


def test_dot_packed_domain_single_pack_unpack(monkeypatch):
    """An 8k-row dot stays in the packed word domain: one value-domain
    pack (the products' operands), log2(8192) stages fed from a block
    kept on the device, and one unpack of the scalar."""
    rng = np.random.default_rng(17)
    x = rng.integers(0, 256, 8000).astype(np.uint64)
    y = rng.integers(0, 256, 8000).astype(np.uint64)
    packs, unpacks = [], []
    orig_d, orig_u = tops._dispatch_levelized, tops._unpack_sub

    def count_d(*args, **kw):
        packs.append(kw.get("packed_in") is None)
        if kw.get("packed_in") is not None:
            assert isinstance(kw["packed_in"], torch.Tensor)
        return orig_d(*args, **kw)

    monkeypatch.setattr(tops, "_dispatch_levelized", count_d)
    monkeypatch.setattr(tops, "_unpack_sub",
                        lambda *a, **k: unpacks.append(1) or orig_u(*a, **k))
    got = tpim.dot(x, y, width=8, **CPU)
    assert int(got) == int(np.dot(x.astype(object), y.astype(object)))
    assert sum(packs) == 1
    assert len(packs) == 1 + 13
    assert len(unpacks) == 1


# ------------------------------------- the tree, level by level

def _record_levels(monkeypatch):
    """Every packed stage's input block, the port's (from the device) and
    the reference's, in order."""
    seen = {"t": [], "r": []}
    orig_t, orig_r = tops._packed_stage, rops.dispatch_packed

    def spy_t(program, n_rows, plan, **kw):
        if kw.get("in_block") is not None:
            seen["t"].append(kw["in_block"].cpu().numpy().view(np.uint32))
        return orig_t(program, n_rows, plan, **kw)

    def spy_r(program, n_rows, plan=None, **kw):
        if kw.get("in_block") is not None:
            seen["r"].append(np.asarray(kw["in_block"], np.uint32))
        return orig_r(program, n_rows, plan, **kw)

    monkeypatch.setattr(tops, "_packed_stage", spy_t)
    monkeypatch.setattr(rops, "dispatch_packed", spy_r)
    return seen


def _same_levels(seen):
    assert len(seen["t"]) == len(seen["r"]) > 0
    for lvl, (t, r) in enumerate(zip(seen["t"], seen["r"])):
        assert t.shape == r.shape and np.array_equal(t, r), lvl


def test_tree_in_word_shift_with_row_31_set(monkeypatch):
    """A 32-row lane reduces in-word (halves 16, 8, 4, 2, 1); the products
    set bit 31 of the word (row 31), so an arithmetic shift would smear
    ones into the shifted half.  Every level's block equals the
    reference's logical shift."""
    x = np.full(32, 255, np.uint64)
    y = np.arange(200, 232, dtype=np.uint64)       # every product wide
    seen = _record_levels(monkeypatch)
    got = tpim.dot(x, y, width=8, **CPU)
    want = rpim.dot(x, y, width=8, backend="ref")
    assert int(got) == int(want) == int((x * y).sum())
    assert all((b[:, 0] >> 31).any() for b in seen["t"][:1])
    _same_levels(seen)


def test_tree_halves_shift_logically():
    """The tree's in-word step on a word whose every bit is set: the
    shifted half has zeros above ``32 - half``."""
    block = torch.full((3, 2), -1, dtype=torch.int32)
    for half in (1, 2, 4, 8, 16):
        x, y = tpn._halves(block, half, 32)
        assert torch.equal(x, block)
        want = np.full((3, 2), 0xFFFFFFFF >> half, np.uint32)
        assert np.array_equal(y.numpy().view(np.uint32), want), half


@pytest.mark.parametrize("m,k", [(96, 2), (160, 2), (96, 4), (33, 3)])
def test_tree_rows64_reseam_matches_reference(monkeypatch, m, k):
    """Under rows64 a half that is an odd multiple of 32 rows (96, 160)
    cuts inside a 64-row word: the halves re-seam across the planes.
    Every level's block and the result equal the reference's."""
    rng = np.random.default_rng(m + k)
    a = rng.integers(0, 16, (m, k)).astype(np.uint64)
    x = rng.integers(0, 16, k).astype(np.uint64)
    seen = _record_levels(monkeypatch)
    got = tpim.gemv(a, x, width=4, layout="rows64", **CPU)
    want = rpim.gemv(a, x, width=4, layout="rows64", backend="ref")
    assert np.array_equal(np.asarray(got, np.uint64), a @ x)
    assert np.array_equal(np.asarray(got, np.uint64),
                          np.asarray(want, np.uint64))
    _same_levels(seen)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tree_levels_match_reference_fp16(monkeypatch, layout):
    rng = np.random.default_rng(21)
    a = rng.standard_normal((5, 12)).astype(np.float16)
    x = rng.standard_normal(12).astype(np.float16)
    seen = _record_levels(monkeypatch)
    got = tpim.gemv(a, x, layout=layout, **CPU)
    want = rpim.gemv(a, x, layout=layout, backend="ref")
    assert np.array_equal(_u16(got), _u16(want))
    _same_levels(seen)


@pytest.mark.parametrize("shards", [2, 3, 4])
def test_sharded_tree_matches_reference(shards):
    rng = np.random.default_rng(shards)
    a = rng.integers(0, 16, (40, 9)).astype(np.uint64)
    x = rng.integers(0, 16, 9).astype(np.uint64)
    got = tpim.gemv(a, x, width=4, mesh=("cpu",) * shards, **CPU)
    assert np.array_equal(np.asarray(got, np.uint64), a @ x)
    xf = rng.standard_normal(50).astype(np.float16)
    yf = rng.standard_normal(50).astype(np.float16)
    assert _u16(tpim.dot(xf, yf, mesh=("cpu",) * shards, **CPU)) == \
        _u16(rpim.dot(xf, yf, backend="ref"))


def test_tree_reduce_rows_validation_matches_reference():
    tprog = tpn.program_for("int-serial", "add", 8)
    rprog = rpn.program_for("int-serial", "add", 8)
    ins = {"x": np.zeros(8, np.uint64), "y": np.zeros(8, np.uint64)}
    for args, match in (((8, 3), "must be group"), ((96, 48), "multiple of 32"),
                        ((24, 3), "power of two below 32")):
        for pn, prog, plan in ((tpn, tprog, tplan.as_plan(**CPU)),
                               (rpn, rprog, "ref")):
            with pytest.raises(ValueError, match=match):
                pn.tree_reduce_rows(prog, ins, *args, kind="int-serial",
                                    plan=plan)
    with pytest.raises(ValueError, match="unreducible kind"):
        tpn.tree_reduce_rows(tprog, ins, 8, 1, kind="int-parallel",
                             plan=tplan.as_plan(**CPU))
    for n in (1, 5, 31, 32, 33, 100):
        assert tpn.reduce_group(n) == rpn.reduce_group(n)


# ------------------------------------- PIMVectorUnit and pim_linear_i8

@pytest.mark.parametrize("parallel", [False, True], ids=["serial",
                                                         "parallel"])
def test_vector_unit_matches_reference(parallel):
    rng = np.random.default_rng(4)
    tu = tpn.PIMVectorUnit("ref", parallel=parallel, device="cpu")
    ru = rpn.PIMVectorUnit("ref", parallel=parallel)
    x = rng.integers(0, 1 << 16, 50, dtype=np.uint64).astype(np.uint16)
    y = rng.integers(1, 1 << 16, 50, dtype=np.uint64).astype(np.uint16)
    f = rng.standard_normal(50).astype(np.float16)
    g = rng.standard_normal(50).astype(np.float16)
    for op in ("add", "sub", "mul", "div"):
        t, r = getattr(tu, op)(x, y), getattr(ru, op)(x, y)
        for a, b in zip(t if op == "div" else (t,),
                        r if op == "div" else (r,)):
            assert a.dtype == b.dtype and np.array_equal(a, b), op
        if op == "div":
            continue
        tf, rf = getattr(tu, op)(f, g), getattr(ru, op)(f, g)
        assert tf.dtype == np.float16 and np.array_equal(_u16(tf), _u16(rf))
    numpy_unit = tpn.PIMVectorUnit("numpy")
    assert np.array_equal(numpy_unit.add(x, y), x.astype(np.uint64) + y)
    with pytest.raises(TypeError, match="unsigned integer"):
        tu.add(x.astype(np.int16), y.astype(np.int16))


@pytest.mark.parametrize("shape", [(1, 17, 3), (3, 40, 2), (2, 8, 20)])
def test_pim_linear_i8_matches_reference_and_numpy(shape):
    m, k, n = shape
    rng = np.random.default_rng(m * 100 + k)
    x = rng.integers(-128, 128, (m, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, n)).astype(np.int8)
    got = tpn.pim_linear_i8(tpn.PIMVectorUnit("ref", device="cpu"), x, w)
    assert got.dtype == np.int64
    assert np.array_equal(got, x.astype(np.int64) @ w.astype(np.int64))
    if shape == (3, 40, 2):
        want = rpn.pim_linear_i8(rpn.PIMVectorUnit("ref"), x, w)
        assert np.array_equal(got, want)


def test_fused_program_for_matches_reference():
    """One fused program per graph, content-equal to the reference's, and
    the widths it reports."""
    graphs = [
        ("int-serial", (("in", "i0", 8), ("in", "i1", 8), ("mul", 0, 1)),
         None),
        ("int-serial", (("in", "i0", 4), ("in", "i1", 6), ("add", 0, 1),
                        ("in", "i2", 4), ("sub", 2, 3)), None),
        ("fp-serial", (("in", "i0", None), ("in", "i1", None),
                       ("mul", 0, 1), ("in", "i2", None), ("add", 2, 3)),
         "fp32"),
        ("int-serial", (("in", "i0", 5),), None),
    ]
    for kind, graph, fmt in graphs:
        t = tpn.fused_program_for(kind, graph, fmt)
        r = rpn.fused_program_for(kind, graph, fmt)
        assert tops.content_key(t) == rops.content_key(r)
        assert tpn.fused_out_width(kind, graph, fmt) == \
            rpn.fused_out_width(kind, graph, fmt) == len(t.ports["z"])
    with pytest.raises(ValueError, match="does not fuse"):
        tpn.fused_program_for("int-serial",
                              (("in", "a", 4), ("in", "b", 4),
                               ("div", 0, 1)))
    with pytest.raises(ValueError, match="unfusable kind"):
        tpn.fused_program_for("int-parallel", (("in", "a", 4),))
