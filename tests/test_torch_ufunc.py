"""The port's main path end to end against the JAX package's.

``repro_torch.pim_ufunc`` with ``device="cpu", backend="ref"`` (the plain
PyTorch executor) is held bit for bit against ``repro.pim_ufunc`` on its
default ``ref`` backend, with inputs made from a seed with numpy: the int
ufuncs at 8/16/32 bits and the fp ufuncs at fp16/fp32 and bf16, bit-serial
and bit-parallel, the streaming executor, and the reference's validation
errors; then the same grid under ``schedule="dense"``,
``schedule="slots-static"`` and ``layout="rows64"``.
"""

import numpy as np
import pytest

from repro import pim_ufunc as rpim
from repro.core.floatfmt import FORMATS
from repro_torch import pim_ufunc as tpim
from repro_torch.kernels import ops as tops
from repro_torch.kernels import slots as tslots

CPU = dict(device="cpu", backend="ref")
N_ROWS = 300                   # 9 whole words and a ragged tail of 12 rows


def _same(a, b):
    """Bit-for-bit equality of two results (arrays or div's pairs)."""
    if isinstance(a, tuple):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == object:          # ports past 63 bits: Python ints
        return all(int(x) == int(y) for x, y in zip(a.flat, b.flat))
    return np.array_equal(a.view(np.uint8), b.view(np.uint8))


def _same_values(got, want):
    """Equal integer values, whatever the result's dtype."""
    if isinstance(got, tuple):
        return all(_same_values(g, w) for g, w in zip(got, want))
    return np.shape(got) == np.shape(want) and \
        all(int(x) == int(y) for x, y in zip(np.ravel(got), np.ravel(want)))


def _int_operands(dtype, n=N_ROWS, seed=0):
    rng = np.random.default_rng(seed)
    hi = np.iinfo(dtype).max
    x = rng.integers(0, hi, n, dtype=np.uint64, endpoint=True).astype(dtype)
    y = rng.integers(1, hi, n, dtype=np.uint64, endpoint=True).astype(dtype)
    return x, y


def _fp_operands(fmt, n=N_ROWS, seed=1):
    """Normal-range encodings: native float arrays for fp16/fp32,
    bit-pattern arrays (with ``fmt=``) otherwise."""
    rng = np.random.default_rng(seed)
    f = FORMATS[fmt]
    lo, hi = (1 << (f.ne - 1)) - 4, (1 << (f.ne - 1)) + 3
    x = f.random_bits(rng, n, emin=lo, emax=hi)
    y = f.random_bits(rng, n, emin=lo, emax=hi)
    if fmt == "fp16":
        return x.astype(np.uint16).view(np.float16), \
            y.astype(np.uint16).view(np.float16), {}
    if fmt == "fp32":
        return x.astype(np.uint32).view(np.float32), \
            y.astype(np.uint32).view(np.float32), {}
    return x.astype(np.uint64), y.astype(np.uint64), {"fmt": fmt}


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "parallel"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_int_ufunc_matches_reference(op, dtype, parallel):
    x, y = _int_operands(dtype)
    got = getattr(tpim, op)(x, y, parallel=parallel, **CPU)
    assert _same(got, getattr(rpim, op)(x, y, parallel=parallel))
    wide = x.astype(np.uint64)
    want = {"add": lambda: wide + y, "mul": lambda: wide * y,
            "sub": lambda: (wide - y) & np.uint64(np.iinfo(dtype).max),
            "div": lambda: (wide // y, wide % y)}[op]()
    assert _same_values(got, want)


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "parallel"])
@pytest.mark.parametrize("fmt", ["fp16", "bf16", "fp32"])
@pytest.mark.parametrize("op", ["fp_add", "fp_sub", "fp_mul", "fp_div"])
def test_fp_ufunc_matches_reference(op, fmt, parallel):
    x, y, kw = _fp_operands(fmt)
    got = getattr(tpim, op)(x, y, parallel=parallel, **kw, **CPU)
    assert _same(got, getattr(rpim, op)(x, y, parallel=parallel, **kw))
    if not kw:
        want = {"fp_add": np.add, "fp_sub": np.subtract,
                "fp_mul": np.multiply, "fp_div": np.divide}[op](x, y)
        assert _same(got, want)


def test_quickstart_operations_match_reference():
    """The operations of ``examples/quickstart.py`` on the same inputs."""
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**16, 1000).astype(np.uint16)
    y = rng.integers(0, 2**16, 1000).astype(np.uint16)
    d = rng.integers(1, 2**16, 1000).astype(np.uint16)
    for op, a, b in (("add", x, y), ("mul", x, y), ("div", x, d)):
        assert _same(getattr(tpim, op)(a, b, **CPU), getattr(rpim, op)(a, b))
    a = rng.standard_normal(512).astype(np.float32)
    b = rng.standard_normal(512).astype(np.float32)
    for op in ("fp_add", "fp_sub", "fp_mul", "fp_div"):
        assert _same(getattr(tpim, op)(a, b, **CPU), getattr(rpim, op)(a, b))
    bf16 = FORMATS["bf16"]
    xb = bf16.random_bits(rng, 256, emin=120, emax=132).astype(np.uint64)
    yb = bf16.random_bits(rng, 256, emin=120, emax=132).astype(np.uint64)
    assert _same(tpim.fp_add(xb, yb, fmt="bf16", **CPU),
                 rpim.fp_add(xb, yb, fmt="bf16"))


@pytest.mark.parametrize("op,dtype", [
    ("fp_add", np.float32),          # the fused branch
    ("add", np.uint32),              # the io branch: z has 33 cells
    ("div", np.uint16)])             # two output ports
def test_streaming_equals_one_shot(op, dtype):
    """Chunks of 64 rows (4 whole chunks and a ragged fifth) give the
    one-shot result; the plain executor runs once per chunk."""
    if dtype == np.float32:
        x, y, _ = _fp_operands("fp32")
    else:
        x, y = _int_operands(dtype)
    one_shot = getattr(tpim, op)(x, y, **CPU)
    tslots.CALLS.update(dict.fromkeys(tslots.CALLS, 0))
    chunked = getattr(tpim, op)(x, y, chunk_rows=64, **CPU)
    assert sum(tslots.CALLS.values()) == 5
    assert _same(chunked, one_shot)
    assert _same(chunked, getattr(rpim, op)(x, y, chunk_rows=64))


def test_wide_object_operands_take_the_io_branch():
    """Ports past 63 bits come back as Python ints, as in the reference."""
    rng = np.random.default_rng(3)
    x = np.array([int(v) << 8 | 0xAB for v in
                  rng.integers(0, 2**62, 70, dtype=np.uint64)], object)
    y = np.array([int(v) for v in rng.integers(0, 2**62, 70,
                                               dtype=np.uint64)], object)
    got = tpim.add(x, y, width=70, **CPU)
    assert got.dtype == object
    assert list(got) == list(rpim.add(x, y, width=70))
    assert all(int(g) == int(a) + int(b) for g, a, b in zip(got, x, y))


def test_shapes_broadcast_and_zero_rows():
    x = np.arange(12, dtype=np.uint8).reshape(3, 4)
    y = np.uint8(200)
    assert _same(tpim.add(x, y, **CPU), rpim.add(x, y))
    e = np.zeros(0, np.float16)
    assert _same(tpim.fp_mul(e, e, **CPU), rpim.fp_mul(e, e))


def test_numpy_oracle_backend_matches_reference():
    x, y = _int_operands(np.uint16, n=40)
    assert _same(tpim.mul(x, y, backend="numpy", device="cpu"),
                 rpim.mul(x, y, backend="numpy"))


def test_prepared_handle_matches_reference():
    x, y, _ = _fp_operands("fp16", n=64)
    tp = tpim.prepare("fp_mul", x, y, **CPU)
    rp = rpim.prepare("fp_mul", x, y)
    assert tp.key == rp.key
    assert (tp.op, tp.n_rows, tp.backend, tp.device) == \
        ("fp_mul", 64, "ref", "cpu")
    tp.warm()
    assert tp.cached
    assert _same(tp.run(), rp.run())
    assert _same(tp.finish(tops.run_program(tp.program, tp.inputs, 64,
                                            tp.plan)), rp.run())


def test_configure_and_options_scope_the_defaults():
    x, y = _int_operands(np.uint8, n=33)
    with tpim.options(**CPU) as cfg:
        assert (cfg.device, cfg.backend) == ("cpu", "ref")
        assert _same(tpim.sub(x, y), rpim.sub(x, y))
    assert (tpim.config.device, tpim.config.backend) == ("cuda", "cuda")
    with pytest.raises(TypeError, match="unknown config field"):
        tpim.configure(devices="cpu")


def _errors_alike(fn_t, fn_r):
    with pytest.raises(Exception) as et:
        fn_t()
    with pytest.raises(Exception) as er:
        fn_r()
    assert type(et.value) is type(er.value)
    assert str(et.value) == str(er.value)


@pytest.mark.parametrize("op,x,y,kw", [
    ("fp_add", np.float32([1.0, np.nan]), np.float32([1.0, 2.0]), {}),
    ("fp_mul", np.float16([1.0, 2.0]), np.float16([np.inf, 2.0]), {}),
    ("fp_add", np.float32([1e-45, 1.0]), np.float32([1.0, 1.0]), {}),
    ("fp_sub", np.array([1, 0x3F80]), np.array([0x3F80, 0x3F80]),
     {"fmt": "bf16"}),
    ("fp_div", np.float32([1.0, 2.0]), np.float32([1.0, 0.0]), {}),
    ("div", np.uint8([1, 2]), np.uint8([1, 0]), {}),
    ("add", np.uint8([1, 2]), np.uint16([1, 2]), {}),
    ("fp_add", np.float16([1.0]), np.float32([1.0]), {}),
    ("mul", np.float32([1.0]), np.float32([1.0]), {}),
    ("add", np.uint8([1, 2]), np.uint8([1, 2]), {"width": 0}),
    ("add", np.uint16([1, 300]), np.uint16([1, 2]), {"width": 8}),
    ("fp_add", np.array([1, 2]), np.array([1, 2]), {"fmt": "fp8"}),
    ("fp_add", np.array([1, 1 << 16]), np.array([1, 2]), {"fmt": "bf16"}),
    ("add", np.uint8([1]), np.uint8([1]), {"fmt": "fp16"}),
    ("pow", np.uint8([1]), np.uint8([1]), {}),
])
def test_validation_errors_match_reference(op, x, y, kw):
    """NaN/Inf, subnormals, zero divisors, mixed widths and malformed
    requests raise what the reference raises, before any execution."""
    _errors_alike(lambda: tpim.prepare(op, x, y, **kw, **CPU),
                  lambda: rpim.prepare(op, x, y, **kw))


@pytest.mark.parametrize("kw,exc", [
    ({"backend": "pallas"}, ValueError),
    ({"schedule": "levels"}, ValueError),
    ({"layout": "rows16"}, ValueError),
    ({"widht": 8}, TypeError),
    ({"plan": "ref", "backend": "ref"}, TypeError)])
def test_bad_options_raise(kw, exc):
    x, y = _int_operands(np.uint8, n=4)
    with pytest.raises(exc):
        tpim.add(x, y, **dict(CPU, **kw))


# --------------------------------------------------------------------------
# the slice as a whole: the dense, static and rows64 options
# --------------------------------------------------------------------------
#
# Every case runs the port under all three options, which must agree with
# each other and with numpy.  Each case also holds one option against the
# reference under the same option, in rotation by width or format, which
# keeps the file's run short: the dense and rows64 options directly, and
# slots-static against the reference's default slot run (the reference's
# static chain compiles for tens of seconds a program on XLA:CPU; its own
# tests hold it equal to the slot run).  The operands are those of the
# tests above, so that run's compiles serve these too.

OPTIONS = {"dense": {"schedule": "dense"},
           "slots-static": {"schedule": "slots-static"},
           "rows64": {"layout": "rows64"}}
HELD = {np.uint8: "dense", np.uint16: "rows64", np.uint32: "slots-static",
        "fp16": "dense", "bf16": "rows64", "fp32": "slots-static"}


def _held_reference(fn, option):
    kw = {} if option == "slots-static" else OPTIONS[option]
    return fn(**kw)


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "parallel"])
@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.uint32])
@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_int_ufunc_options_match_reference(op, dtype, parallel):
    x, y = _int_operands(dtype)
    got = {o: getattr(tpim, op)(x, y, parallel=parallel, **kw, **CPU)
           for o, kw in OPTIONS.items()}
    want = _held_reference(
        lambda **kw: getattr(rpim, op)(x, y, parallel=parallel, **kw),
        HELD[dtype])
    for o, g in got.items():
        assert _same(g, want), o
    wide = x.astype(np.uint64)
    exact = {"add": lambda: wide + y, "mul": lambda: wide * y,
             "sub": lambda: (wide - y) & np.uint64(np.iinfo(dtype).max),
             "div": lambda: (wide // y, wide % y)}[op]()
    assert _same_values(got["dense"], exact)


@pytest.mark.parametrize("parallel", [False, True], ids=["serial", "parallel"])
@pytest.mark.parametrize("fmt", ["fp16", "bf16", "fp32"])
@pytest.mark.parametrize("op", ["fp_add", "fp_sub", "fp_mul", "fp_div"])
def test_fp_ufunc_options_match_reference(op, fmt, parallel):
    x, y, kw = _fp_operands(fmt)
    got = {o: getattr(tpim, op)(x, y, parallel=parallel, **kw, **okw, **CPU)
           for o, okw in OPTIONS.items()}
    want = _held_reference(
        lambda **okw: getattr(rpim, op)(x, y, parallel=parallel, **kw,
                                        **okw), HELD[fmt])
    for o, g in got.items():
        assert _same(g, want), o


@pytest.mark.parametrize("fmt", ["fp16", "bf16", "fp32"])
@pytest.mark.parametrize("width", ["slot_width", "level_max_width"])
@pytest.mark.parametrize("op", ["fp_add", "fp_mul", "fp_div"])
def test_fp_ufunc_wide_widths_match_reference(op, width, fmt):
    """A plan retuned to slot width 16, or to a dense cap of 16, runs the
    fp ufuncs bit for bit as the reference's plan with the same Backend
    (the card runs their levels as windows of at most 8 lanes)."""
    from repro.kernels import plan as rplan
    from repro_torch.kernels import plan as tplan
    x, y, kw = _fp_operands(fmt)
    schedule = "dense" if width == "level_max_width" else None
    tp = tplan.as_plan(backend=tplan.Backend("ref", **{width: 16}),
                       device="cpu", schedule=schedule)
    rp = rplan.as_plan(backend=rplan.Backend("ref", **{width: 16}),
                       schedule=schedule)
    got = getattr(tpim, op)(x, y, plan=tp, **kw)
    assert _same(got, getattr(rpim, op)(x, y, plan=rp, **kw))
    if not kw:
        want = {"fp_add": np.add, "fp_mul": np.multiply,
                "fp_div": np.divide}[op](x, y)
        assert _same(got, want)


@pytest.mark.parametrize("option", ["rows64", "dense"])
def test_streaming_options_match_reference(option):
    """Chunks of 512 rows (three whole chunks and a ragged fourth), fused
    and io branch."""
    x, y, _ = _fp_operands("fp32", n=1800)
    kw = OPTIONS[option]
    got = tpim.fp_add(x, y, chunk_rows=512, **kw, **CPU)
    assert _same(got, rpim.fp_add(x, y, chunk_rows=512, **kw))
    assert _same(got, x + y)
    a, b = _int_operands(np.uint32, n=1800)
    got = tpim.add(a, b, chunk_rows=512, **kw, **CPU)
    assert _same(got, rpim.add(a, b, chunk_rows=512, **kw))


def test_prepared_handle_names_its_options():
    x, y, _ = _fp_operands("fp16", n=64)
    tp = tpim.prepare("fp_add", x, y, schedule="dense", layout="rows64",
                      **CPU)
    rp = rpim.prepare("fp_add", x, y, schedule="dense", layout="rows64")
    assert (tp.schedule, tp.layout) == (rp.schedule, rp.layout) == \
        ("dense", "rows64")
    tp.warm()
    assert tp.cached
    assert _same(tp.run(), rp.run())
