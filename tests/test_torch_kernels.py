"""The kernel wrappers, launch shapes and builds and, on the card, every
CUDA kernel entry against its plain PyTorch version: the slot scan (B1),
the generated static-slice kernel (B2), the level gather (B3) and the
gate-serial kernel (B4), under rows32 and rows64.

This file imports neither JAX nor the JAX package, so it runs on a machine
with an NVIDIA GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py

The ``cuda``-marked tests skip without a card (the kernels have no CPU
mode); the others run everywhere.
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


def _bridge_ports():
    """Ports of 1, 16, 17 and 32 cells in and out: each output the NOT of
    the input of its width."""
    b = gates.Builder()
    for w in (1, 16, 17, 32):
        b.output(f"z{w}", [b.not_(c) for c in b.input(f"x{w}", w)])
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
    "bridge-ports": _bridge_ports,
}


def _resolved(name, device="cpu", layout=None, **backend_kw):
    prog = PROGRAMS[name]()
    backend = kplan.Backend("ref" if device == "cpu" else "cuda",
                            **backend_kw)
    plan = kplan.as_plan(backend=backend, device=device, layout=layout)
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
                  in_base=r.in_base, out_base=r.out_base,
                  words_per_cta=r.words_per_cta, **kw)
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
    assert (slots.CALLS["slots_fused"], slots.CALLS["slots_io"]) == (1, 1)
    assert not any(pim_exec.LAUNCHES.values())
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


@pytest.mark.parametrize("width", range(1, 10))
def test_kernel_takes_only_the_slot_width_it_is_built_for(width):
    """The kernel runs slot widths 1 to 8, a level a window of 2, 4, 6 or 8
    records of the packed stream; a wider schedule is refused before
    launch, and a gate-free schedule passes whatever its width."""
    sched = torch.zeros((3, width), dtype=torch.int32)
    if width <= pim_exec.WINDOW:
        assert pim_exec._schedule_args(sched, sched, sched) == (3, width)
    else:
        with pytest.raises(ValueError, match="slot widths 1 to 8 lanes"):
            pim_exec._schedule_args(sched, sched, sched)
    none = torch.zeros((0, width), dtype=torch.int32)
    assert pim_exec._schedule_args(none, none, none) == (0, width)


@pytest.mark.parametrize("width,ok", [(4, True), (8, True), (9, False)])
def test_cuda_plans_take_slot_widths_up_to_eight(width, ok):
    """A cuda plan levelizes slot schedules of up to 8 lanes, what the
    slot scan runs; a wider one is refused before any schedule is built
    and runs on ``ref``."""
    backend = kplan.Backend("cuda", slot_width=width)
    if ok:
        assert kplan.as_plan(backend=backend).backend.slot_width == width
    else:
        with pytest.raises(ValueError, match="at most 8 lanes"):
            kplan.as_plan(backend=backend)
    kplan.as_plan(backend=kplan.Backend("ref", slot_width=width),
                  device="cpu")


@pytest.mark.parametrize("n_cells,cap,want", [
    (444, 32, 32), (444, 1024, 130), (4175, 64, 13), (58112, 32, 1),
    (8, 5000, 1024), (444, 40, 40)])
def test_fit_words_per_cta(n_cells, cap, want):
    """At most ``cap``, at most what fits in 227 KB, at most 1024 columns
    (threads); the columns are spread over warps, so any count goes."""
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
    """Ragged row counts and several CTA widths (the rule's first), bit for
    bit."""
    plain = _resolved(name)
    vals = _values(plain, np.random.default_rng(1), n_rows)
    want = _np(_call("fused", plain, _t(vals)))
    for wpc in (None, 1, 13, 32):
        r = _resolved(name, cuda, words_per_cta=wpc)
        got = _call("fused", r, _t(vals).to(cuda))
        torch.cuda.synchronize()
        assert np.array_equal(_np(got), want), wpc


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("width", [4, 6, 8])
@pytest.mark.parametrize("name", ["fp16-add", "fp32-add", "uint32-add"])
def test_slot_scan_runs_slot_widths(cuda, name, width, planes):
    """B1 on schedules levelized at slot widths 4, 6 and 8 (windows of 4
    and 8 records), fused on ragged rows and io, under both layouts, bit
    for bit against the plain version."""
    layout = "rows64" if planes == 2 else "rows32"
    plain = _resolved(name, slot_width=width)
    r = _resolved(name, cuda, layout, slot_width=width)
    assert r.sched.width == width and r.packed.width == width
    rng = np.random.default_rng(14)
    if max(plain.in_widths + plain.out_widths) <= 32:
        vals = _values(plain, rng, 100_003)
        want = _np(_call("fused", plain, _t(vals), planes=planes))
        got = _call("fused", r, _t(vals).to(cuda), planes=planes,
                    packed=r.packed)
        torch.cuda.synchronize()
        assert np.array_equal(_np(got), want)
    k_in = int(plain.in_idx.numel())
    rows = _bits(rng, (k_in, 3001) if planes == 1 else (planes, k_in, 3001))
    want = _np(_call("io", plain, _t(rows)))
    got = _call("io", r, _t(rows).to(cuda), packed=r.packed)
    torch.cuda.synchronize()
    assert np.array_equal(_np(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("width", [4, 8])
def test_fp_add_runs_tuned_slot_widths_on_cuda(cuda, width):
    """A plan with another slot width runs ``pim.fp_add`` through B1 on the
    card, bit-exact against numpy."""
    rng = np.random.default_rng(15)
    a = rng.standard_normal(5000).astype(np.float32)
    b = rng.standard_normal(5000).astype(np.float32)
    pim_exec.reset_counts()
    plan = kplan.as_plan(backend=kplan.Backend("cuda", slot_width=width))
    got = pim.fp_add(a, b, plan=plan)
    assert np.array_equal(got, a + b)
    assert {k: v for k, v in pim_exec.LAUNCHES.items() if v} == \
        {"slot_scan_fused": 1}


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
    assert {k: v for k, v in pim_exec.LAUNCHES.items() if v} == \
        {"slot_scan_fused": 3, "slot_scan_io": 1}
    assert not any(slots.CALLS.values())


# --------------------------------------------------------------------------
# everywhere: the B2, B3 and B4 wrappers, shapes and the static generator
# --------------------------------------------------------------------------

def _operands(name, kind="slots", device="cpu"):
    """Schedule ``kind`` of a program with its stacked operands, built
    directly (not through ``resolve``) so each entry gets its own kind."""
    prog = PROGRAMS[name]()
    plan = kplan.as_plan(backend="ref", device="cpu", schedule=kind)
    s = ops.compiled(prog, plan).get_schedule(prog, plan)
    in_names = sorted(prog.in_ports)
    out_names = ops.output_names(s)
    in_cells = ops._stacked_cells([s.pack_cells(n) for n in in_names])
    out_cells = ops._stacked_cells([s.ports[n] for n in out_names])

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a, np.int32)).to(device)

    return dict(sched=s, prog=prog, in_cells=in_cells, out_names=out_names,
                in_widths=tuple(len(s.pack_cells(n)) for n in in_names),
                out_widths=tuple(len(s.ports[n]) for n in out_names),
                args=(t(in_cells), t(s.a), t(s.b), t(s.out), t(out_cells)),
                kw=dict(n_cells=s.n_cells, one_cell=s.one_cell))


def _static(o, planes=1):
    return pim_exec.StaticKernel(o["sched"], o["in_widths"],
                                 o["out_widths"], o["out_names"],
                                 o["in_cells"], planes=planes)


def _vals(o, rng, n_rows):
    vals = _bits(rng, (len(o["in_widths"]), n_rows))
    for p, w in enumerate(o["in_widths"]):
        vals[p] &= np.uint32((1 << w) - 1)
    return vals


def _io_rows(o, rng, n_words, planes=1):
    k_in = int(o["args"][0].numel())
    shape = (k_in, n_words) if planes == 1 else (planes, k_in, n_words)
    return _bits(rng, shape)


@pytest.mark.parametrize("entry", ["level_fused", "level_io", "static",
                                   "gate_serial"])
def test_dense_static_serial_wrappers_take_plain_version_on_cpu(entry):
    """On CPU tensors each wrapper runs its plain version, counts a
    plain call and launches nothing; the result matches the numpy
    oracle."""
    rng = np.random.default_rng(5)
    pim_exec.reset_counts()
    if entry == "gate_serial":
        prog = PROGRAMS["uint16-add"]()
        ops_, a, b, o, n_cells = prog.to_arrays()
        x, y = rng.integers(0, 1 << 16, (2, 100), dtype=np.uint64)
        state = ops.pack_rows({"x": x, "y": y}, prog.ports, 100, n_cells)
        got = pim_exec.gate_serial(_t(state), *[torch.from_numpy(v)
                                                for v in (ops_, a, b, o)])
        assert ref.CALLS["gate_serial"] == 1
        z = ops.unpack_rows(_np(got), prog.ports, 100, names=["z"])["z"]
        assert np.array_equal(z, x + y)
    else:
        o = _operands("uint16-add", "dense" if entry != "static" else "slots")
        vals = _vals(o, rng, 100)
        if entry == "level_fused":
            got = pim_exec.level_fused(_t(vals), *o["args"],
                                       in_widths=o["in_widths"],
                                       out_widths=o["out_widths"], **o["kw"])
            assert ref.CALLS["level_fused"] == 1
        elif entry == "static":
            got = _static(o)(_t(vals))
            assert slots.CALLS["static_chain"] == 1
        else:
            rows = _np(slots.pack_values(_t(np.pad(vals, ((0, 0), (0, 28)))),
                                         o["in_widths"]))
            sub = pim_exec.level_io(_t(rows), *o["args"], **o["kw"])
            got = slots.unpack_values(sub, o["out_widths"])[:, :100]
            assert ref.CALLS["level_io"] == 1
        assert np.array_equal(_np(got)[0],
                              vals[0].astype(np.uint64) + vals[1])
    assert not any(pim_exec.LAUNCHES.values())


def test_level_gather_takes_dense_widths_up_to_eight():
    for width in (1, 5, 8):
        sched = torch.zeros((3, width), dtype=torch.int32)
        assert pim_exec._schedule_args(sched, sched, sched, dense=True) == \
            (3, width)
    wide = torch.zeros((3, 9), dtype=torch.int32)
    with pytest.raises(ValueError, match="1 to 8 lanes"):
        pim_exec._schedule_args(wide, wide, wide, dense=True)
    # the plan refuses a cuda backend that would levelize wider than the
    # kernel, before any schedule is built; narrower is fine
    with pytest.raises(ValueError, match="at most 8 lanes"):
        kplan.as_plan(backend=kplan.Backend("cuda", level_max_width=9),
                      device="cuda")
    kplan.as_plan(backend=kplan.Backend("cuda", level_max_width=4),
                  device="cuda")
    kplan.as_plan(backend=kplan.Backend("ref", level_max_width=9),
                  device="cpu")
    assert f"-DPIM_LEVEL_MAX_WIDTH={kplan.LEVEL_MAX_WIDTH}" in \
        pim_exec.NVCC_FLAGS


@pytest.mark.parametrize("n_cells,cap,planes,want", [
    (444, 16, 2, 16), (444, 1024, 2, 65), (10304, 32, 1, 5),
    (10304, 32, 2, 2), (25354, 32, 1, 2), (58112, 32, 2, 0)])
def test_fit_words_per_cta_counts_planes(n_cells, cap, planes, want):
    """rows64 doubles a column's shared memory; the largest states take a
    few words per CTA, and a column past 227 KB raises."""
    if not want:
        with pytest.raises(ValueError, match="shared memory"):
            pim_exec.fit_words_per_cta(n_cells, cap, planes)
        return
    got = pim_exec.fit_words_per_cta(n_cells, cap, planes)
    assert got == want
    assert got * n_cells * 4 * planes <= pim_exec.SMEM_PER_CTA


@pytest.mark.parametrize("kind", ["dense", "gate-serial"])
def test_largest_states_fit_one_column(kind):
    """The widest dense state (int-parallel mul64) under rows64 and the
    widest gate-serial state (int-parallel div64) still fit whole word
    columns in one CTA: no kernel needs a device-memory state."""
    if kind == "dense":
        prog = program_for("int-parallel", "mul", 64)
        plan = kplan.as_plan(backend="ref", device="cpu", schedule="dense")
        n_cells, planes = ops.program_schedule(prog, plan).n_cells, 2
    else:
        n_cells = program_for("int-parallel", "div", 64).to_arrays()[4]
        planes = 1
    assert pim_exec.fit_words_per_cta(n_cells, 32, planes) >= 1


def test_static_source_is_straight_line_code():
    """Every real lane of every level becomes one NOR with constant
    offsets, in one device function, or in functions of ``split`` levels;
    the library is keyed on the source."""
    o = _operands("uint16-add")
    s = o["sched"]
    src = pim_exec.static_source(s, planes=1, wpc=16)
    assert src.count("~(s[") == int(s.level_width.sum())
    assert src.count("__noinline__") == 1
    split = pim_exec.static_source(s, planes=1, wpc=16, split=17)
    assert split.count("~(s[") == int(s.level_width.sum())
    assert split.count("__noinline__") == -(-s.n_levels // 17)
    assert "__ldg(p.la" not in src and "p.la" not in src
    stride = pim_exec.state_stride(s.n_cells, 16)
    assert stride == 17
    a0, b0 = int(s.a[0, 0]) * stride, int(s.b[0, 0]) * stride
    assert f"const T v0 = ~(s[{a0}] | s[{b0}]);" in src
    k1, k2 = _static(o), _static(o, planes=2)
    assert k1.so != k2.so and k1.so == _static(o).so
    assert k1.so.parent == pim_exec.BUILD_DIR
    with pytest.raises(ValueError, match="slot schedule"):
        pim_exec.static_source(_operands("uint16-add", "dense")["sched"],
                               1, 16)


def test_static_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", "")
    monkeypatch.setattr(pim_exec, "CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(pim_exec, "BUILD_DIR", tmp_path / "build")
    k = _static(_operands("uint16-add"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        k.build()
    assert not (tmp_path / "build").exists()


@pytest.mark.parametrize("wpc,planes,lanes,threads", [
    (16, 1, 4, 128), (32, 1, 8, 128), (64, 1, 16, 128), (128, 1, 32, 128),
    (64, 2, 16, 128), (13, 1, 4, 128), (3, 1, 1, 96)])
def test_static_launch_bounds_follow_its_threads(wpc, planes, lanes,
                                                 threads):
    """B2 declares the launch bounds of the threads it launches (its
    columns spread over four warps as the ring kernels' are), not 1024,
    so the compiler may give a thread more than 64 registers."""
    s = _operands("uint16-add")["sched"]
    src = pim_exec.static_source(s, planes=planes, wpc=wpc)
    assert pim_exec.static_shape(s.n_cells, wpc, planes)[1:] == (lanes,
                                                                  threads)
    assert f"constexpr int THREADS = {threads};" in src
    assert f"constexpr int LANES = {lanes};" in src
    assert "__launch_bounds__(THREADS)" in src
    assert "__launch_bounds__(1024)" not in src
    assert "pim::run<P, true, LANES>" in src       # a batch of LANES words


@pytest.mark.parametrize("n_cells,planes,want", [
    (444, 1, 64), (444, 2, 64), (1134, 1, 51), (1134, 2, 25),
    (25354, 1, 2), (2000, 2, 14)])
def test_static_words_per_cta(n_cells, planes, want):
    """B2's CTA rule: as many columns as the state alone lets one CTA
    hold, at most four warps of 16 under either layout."""
    assert pim_exec.static_words_per_cta(n_cells, planes) == want
    k = pim_exec.StaticKernel(_operands("fp32-add")["sched"], (32, 32),
                              (32,), ["z"], list(range(64)), planes=planes)
    assert k.wpc == pim_exec.static_words_per_cta(k.sched.n_cells, planes)
    with pytest.raises(ValueError, match="shared memory"):
        pim_exec.StaticKernel(k.sched, (32, 32), (32,), ["z"],
                              list(range(64)), words_per_cta=1000)


@pytest.mark.parametrize("n_cells,wpc,planes,reserve,want", [
    (444, 128, 1, 0, 129), (444, 126, 1, pim_exec.RING_BYTES, 126),
    (444, 125, 1, 0, 125), (605, 92, 1, pim_exec.RING_BYTES, 92),
    (355, 128, 1, pim_exec.RING_BYTES, 129), (444, 64, 2, 0, 65)])
def test_state_stride_is_odd_where_it_fits(n_cells, wpc, planes, reserve,
                                           want):
    """An even CTA width gets one column of padding when it fits, so the
    32 lanes of a bridge, one cell each, hit 32 banks."""
    got = pim_exec.state_stride(n_cells, wpc, planes, reserve)
    assert got == want
    assert 4 * planes * n_cells * got + reserve <= pim_exec.SMEM_PER_CTA
    rows = (np.arange(32) * got) % 32 if planes == 1 else \
        (np.arange(16) * 2 * got) % 32
    assert got % 2 == 0 or len(set(rows.tolist())) == len(rows)


def _warp_transpose(x: np.ndarray) -> np.ndarray:
    """``pim::transpose32`` of csrc/pim_state.cuh, lane by lane: five
    ``__shfl_xor_sync`` block swaps over the 32 lanes' words ``x``."""
    lane = np.arange(32)
    for step, mask in ((16, 0x0000FFFF), (8, 0x00FF00FF), (4, 0x0F0F0F0F),
                       (2, 0x33333333), (1, 0x55555555)):
        y = x[lane ^ step]
        m, sh = np.uint32(mask), np.uint32(step)
        x = np.where(lane & step, ((y >> sh) & m) | (x & ~m),
                     (x & m) | ((y & m) << sh)).astype(np.uint32)
    return x


@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("widths", [(1,), (16,), (17,), (32,),
                                    (32, 17, 1, 16)])
def test_bridges_warp_transpose_matches_pack_values(widths, planes):
    """The fused bridges as the kernels run them, emulated lane by lane:
    lane i loads row 32 * (P * word + h) + i of each port, the warp
    transpose leaves lane b the word of the port's cell b (plane h), and
    the output bridge's transpose back gives every row's value again --
    the plain version's ``pack_values``/``unpack_values``."""
    rng = np.random.default_rng(13)
    n_words = 3
    n_rows = 32 * planes * n_words
    vals = _bits(rng, (len(widths), n_rows))
    for p, w in enumerate(widths):
        vals[p] &= np.uint32((1 << w) - 1)
    got = np.zeros((planes, sum(widths), n_words), np.uint32)
    back = np.zeros_like(vals)
    s = 0
    for p, w in enumerate(widths):
        for j in range(n_words):
            for h in range(planes):
                row0 = 32 * (planes * j + h)
                t = _warp_transpose(vals[p, row0:row0 + 32])
                got[h, s:s + w, j] = t[:w]          # lanes b < w store
                out = np.where(np.arange(32) < w, t, 0).astype(np.uint32)
                back[p, row0:row0 + 32] = _warp_transpose(out)
        s += w
    want = _np(slots.pack_values(_t(vals), widths, planes))
    assert np.array_equal(got[0] if planes == 1 else got, want)
    assert np.array_equal(back, vals)


# --------------------------------------------------------------------------
# on the card: B2, B3, B4 and rows64 against their plain versions
# --------------------------------------------------------------------------

NEW_FUSED = ["fp16-add", "fp32-add", "uint16-add", "bp-mul16", "gate-free"]


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("name", NEW_FUSED)
def test_level_gather_fused_matches_plain_version(cuda, name, planes):
    o = _operands(name, "dense")
    oc = _operands(name, "dense", cuda)
    vals = _vals(o, np.random.default_rng(6), 100_003)
    want = _np(ref.pim_exec_ref_level_fused(
        _t(vals), *o["args"], in_widths=o["in_widths"],
        out_widths=o["out_widths"], planes=planes, **o["kw"]))
    for wpc in (1, 13, 32):
        got = pim_exec.level_fused(
            _t(vals).to(cuda), *oc["args"], in_widths=o["in_widths"],
            out_widths=o["out_widths"], planes=planes, words_per_cta=wpc,
            **o["kw"])
        torch.cuda.synchronize()
        assert np.array_equal(_np(got), want), wpc


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("entry", ["slots", "dense"])
@pytest.mark.parametrize("name", ["uint32-add", "uint32-mul", "no-input"])
def test_io_entries_match_plain_version(cuda, name, entry, planes):
    o = _operands(name, entry)
    oc = _operands(name, entry, cuda)
    rows = _io_rows(o, np.random.default_rng(7), 3001, planes)
    if entry == "slots":
        want = slots.slots_io(_t(rows), *o["args"], k_out=len(
            o["args"][4]), **o["kw"])
        got = pim_exec.slots_io(_t(rows).to(cuda), *oc["args"],
                                k_out=len(o["args"][4]), **o["kw"])
    else:
        want = ref.pim_exec_ref_level_io(_t(rows), *o["args"], **o["kw"])
        got = pim_exec.level_io(_t(rows).to(cuda), *oc["args"], **o["kw"])
    torch.cuda.synchronize()
    assert np.array_equal(_np(got), _np(want))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fp16-add", "bp-mul16", "gate-free"])
def test_slot_scan_rows64_matches_plain_version(cuda, name):
    o = _operands(name)
    oc = _operands(name, "slots", cuda)
    vals = _vals(o, np.random.default_rng(8), 100_003)
    want = _np(slots.slots_fused(_t(vals), *o["args"],
                                 in_widths=o["in_widths"],
                                 out_widths=o["out_widths"], planes=2,
                                 **o["kw"]))
    got = pim_exec.slots_fused(_t(vals).to(cuda), *oc["args"],
                               in_widths=o["in_widths"],
                               out_widths=o["out_widths"], planes=2,
                               **o["kw"])
    torch.cuda.synchronize()
    assert np.array_equal(_np(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("name", ["fp16-add", "uint16-add", "gate-free",
                                  "no-input"])
def test_static_kernel_matches_plain_version(cuda, name, planes):
    k = _static(_operands(name), planes)
    vals = _vals(_operands(name), np.random.default_rng(9), 4099)
    want = _np(k(_t(vals)))
    got = k(_t(vals).to(cuda))
    torch.cuda.synchronize()
    assert np.array_equal(_np(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("name", ["fp32-add", "uint16-add", "fp32-mul"])
def test_static_kernel_cta_widths_match_plain_version(cuda, name, planes):
    """B2 at 16, 32, 64 and 128 columns a CTA where they fit (the sweep's
    widths), each its own build, on ragged rows."""
    o = _operands(name)
    vals = _vals(o, np.random.default_rng(16), 100_003)
    want = None
    for wpc in (16, 32, 64, 128):
        if wpc > pim_exec.fit_words_per_cta(o["sched"].n_cells, wpc, planes):
            continue
        k = pim_exec.StaticKernel(o["sched"], o["in_widths"],
                                  o["out_widths"], o["out_names"],
                                  o["in_cells"], planes=planes,
                                  words_per_cta=wpc)
        if want is None:
            want = _np(k(_t(vals)))
        got = k(_t(vals).to(cuda))
        torch.cuda.synchronize()
        assert np.array_equal(_np(got), want), wpc


@pytest.mark.cuda
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("entry", ["slots", "static", "dense"])
def test_bridges_take_ports_of_1_16_17_32_cells(cuda, entry, planes):
    """The fused bridges shared by B1, B2 and B3 on ports of 1, 16, 17 and
    32 cells, in and out, at a ragged row count."""
    o = _operands("bridge-ports", "dense" if entry == "dense" else "slots")
    assert sorted(o["in_widths"]) == [1, 16, 17, 32]
    oc = _operands("bridge-ports", "dense" if entry == "dense" else "slots",
                   cuda)
    vals = _vals(o, np.random.default_rng(17), 4099)
    kw = dict(in_widths=o["in_widths"], out_widths=o["out_widths"],
              planes=planes, **o["kw"])
    if entry == "static":
        k = _static(o, planes)
        want, got = k(_t(vals)), k(_t(vals).to(cuda))
    elif entry == "slots":
        want = slots.slots_fused(_t(vals), *o["args"], **kw)
        got = pim_exec.slots_fused(_t(vals).to(cuda), *oc["args"], **kw)
    else:
        want = ref.pim_exec_ref_level_fused(_t(vals), *o["args"], **kw)
        got = pim_exec.level_fused(_t(vals).to(cuda), *oc["args"], **kw)
    torch.cuda.synchronize()
    assert np.array_equal(_np(got), _np(want))
    names = sorted(_bridge_ports().in_ports)
    for p, n in enumerate(names):
        q = o["out_names"].index("z" + n[1:])
        width = o["in_widths"][p]
        assert np.array_equal(_np(got)[q],
                              ~vals[p] & np.uint32((1 << width) - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["uint16-add", "fp16-add", "uint32-mul"])
def test_gate_serial_kernel_matches_plain_version(cuda, name):
    prog = PROGRAMS[name]()
    arrays = prog.to_arrays()
    state = _bits(np.random.default_rng(10), (arrays[4], 3001 // 32 + 1))
    gates = [torch.from_numpy(v) for v in arrays[:4]]
    want = _np(ref.pim_exec_ref(_t(state), *gates))
    got = pim_exec.gate_serial(_t(state).to(cuda), *[g.to(cuda)
                                                     for g in gates])
    torch.cuda.synchronize()
    assert np.array_equal(_np(got), want)


@pytest.mark.cuda
@pytest.mark.parametrize("kw,key", [
    ({"schedule": "dense"}, "level_gather_fused"),
    ({"schedule": "slots-static"}, "slots_static_fused"),
    ({"layout": "rows64"}, "slot_scan_fused_rows64"),
    ({"schedule": "dense", "layout": "rows64"}, "level_gather_fused_rows64"),
    ({"schedule": "slots-static", "layout": "rows64"},
     "slots_static_fused_rows64")])
def test_options_launch_their_kernels(cuda, kw, key):
    rng = np.random.default_rng(11)
    a = rng.standard_normal(5000).astype(np.float32)
    b = rng.standard_normal(5000).astype(np.float32)
    pim_exec.reset_counts()
    assert np.array_equal(pim.fp_add(a, b, chunk_rows=2048, **kw), a + b)
    assert {k: v for k, v in pim_exec.LAUNCHES.items() if v} == {key: 3}
    assert not any(slots.CALLS.values()) and not any(ref.CALLS.values())


@pytest.mark.cuda
def test_gate_serial_path_launches_its_kernel(cuda):
    prog = program_for("int-serial", "add", 16)
    rng = np.random.default_rng(12)
    x, y = rng.integers(0, 1 << 16, (2, 777), dtype=np.uint64)
    pim_exec.reset_counts()
    out = ops.run_program(prog, {"x": x, "y": y}, 777, levelized=False)
    assert np.array_equal(out["z"], x + y)
    assert pim_exec.LAUNCHES["gate_serial"] == 1
    assert not any(ref.CALLS.values())


# --------------------------------------------------------------------------
# on the card: the scale layer and the packed reductions
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["slots", "dense"])
@pytest.mark.parametrize("layout", ["rows32", "rows64"])
def test_packed_stage_on_a_device_block_matches_plain_version(cuda, kind,
                                                             layout):
    """B1 io and B3 io on a packed block kept on the device (a tree level's
    input), out as a device block, against the plain version on the CPU."""
    prog = program_for("int-serial", "add", 24)
    planes = 1 if layout == "rows32" else 2
    n_rows = 64 * 37 + 5
    n_words = kplan.LAYOUTS[layout].n_words(n_rows)
    rng = np.random.default_rng(21)
    shape = (48, n_words) if planes == 1 else (2, 48, n_words)
    blk = _bits(rng, shape)
    want = ops.dispatch_packed(
        prog, n_rows, kplan.as_plan(schedule=kind, layout=layout,
                                    backend="ref", device="cpu"),
        in_block=blk, in_names=("x", "y"))()
    plan = kplan.as_plan(schedule=kind, layout=layout)
    pim_exec.reset_counts()
    got = ops._packed_stage(prog, n_rows, plan, in_block=_t(blk).to(cuda),
                            in_names=("x", "y"), device_out=True)()
    assert got.device.type == "cuda"
    torch.cuda.synchronize()
    assert np.array_equal(_np(got), want)
    entry = ("slot_scan_io" if kind == "slots" else "level_gather_io") + \
        ("" if planes == 1 else "_rows64")
    assert pim_exec.LAUNCHES[entry] == 1
    host = ops.dispatch_packed(prog, n_rows, plan, in_block=blk,
                               in_names=("x", "y"))()
    assert host.dtype == np.uint32 and np.array_equal(host, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["fp32-add", "uint32-add"])
def test_streaming_pipeline_matches_plain_version(cuda, name):
    """Three whole chunks and a ragged tail through the pinned staging
    buffers and copy streams, against ``backend="ref"`` on the card and on
    the CPU."""
    prog = PROGRAMS[name]()
    n = 3 * 4096 + 77
    rng = np.random.default_rng(22)
    ins = {p: _bits(rng, n).astype(np.uint64) for p in sorted(prog.in_ports)}
    want = ops.run_program(prog, ins, n, backend="ref", device="cpu")
    pim_exec.reset_counts()
    got = ops.run_program_streaming(prog, ins, n, chunk_rows=4096)
    assert sum(pim_exec.LAUNCHES.values()) == 4
    plain = ops.run_program_streaming(prog, ins, n, chunk_rows=4096,
                                      backend="ref")
    for k in want:
        assert np.array_equal(got[k], want[k]) and \
            np.array_equal(plain[k], want[k]), k


@pytest.mark.cuda
def test_mesh_on_one_card_matches_unsharded(cuda):
    prog = PROGRAMS["fp32-add"]()
    rng = np.random.default_rng(23)
    n = 100_003
    ins = {p: _bits(rng, n).astype(np.uint64) & np.uint64(0x3FFFFFFF)
           for p in ("x", "y")}
    want = ops.run_program(prog, ins, n)
    for mesh in (("cuda:0", "cuda:0"), ("cuda:0",) * 3):
        got = ops.run_program_streaming(prog, ins, n, mesh=mesh,
                                        chunk_rows=1 << 15)
        assert np.array_equal(got["z"], want["z"]), mesh


@pytest.mark.cuda
def test_reductions_on_the_card(cuda):
    rng = np.random.default_rng(24)
    a = rng.integers(0, 16, (100, 37)).astype(np.uint64)
    x = rng.integers(0, 16, 37).astype(np.uint64)
    pim_exec.reset_counts()
    assert np.array_equal(np.asarray(pim.gemv(a, x, width=4), np.uint64),
                          a @ x)
    assert pim_exec.LAUNCHES["slot_scan_io"] == 1 + 6
    u = rng.integers(0, 256, 1000).astype(np.uint64)
    assert int(pim.dot(u, u, width=8, layout="rows64")) == int((u * u).sum())
    f = (rng.uniform(1, 2, 64) * rng.choice([-1, 1], 64)).astype(np.float16)
    got = pim.dot(f, f, schedule="dense")
    p = (f * f).astype(np.float16)
    while len(p) > 1:
        p = (p[:len(p) // 2] + p[len(p) // 2:]).astype(np.float16)
    assert got.view(np.uint16) == p[0].view(np.uint16)


@pytest.mark.cuda
def test_fused_fp32_chain_on_the_card(cuda):
    rng = np.random.default_rng(25)
    a, b, c = (rng.uniform(1, 2, 5000).astype(np.float32) for _ in range(3))
    want = (a * b).astype(np.float32) + c
    for schedule in ("slots", "dense", "slots-static"):
        e = pim.fp_add(pim.fp_mul(pim.lazy(a), pim.lazy(b)), pim.lazy(c))
        got = pim.fuse(e, schedule=schedule).run()
        assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


# --------------------------------------------------------------------------
# B6: the check-word fold of verified execution
# --------------------------------------------------------------------------

def test_check_words_takes_the_plain_version_on_cpu_tensors():
    rng = np.random.default_rng(26)
    blk = _bits(rng, (2, 33, 7))
    pim_exec.reset_counts()
    got = pim_exec.check_words(_t(blk), 1)
    assert ref.CALLS["check_words"] == 1
    assert not any(pim_exec.LAUNCHES.values())
    assert np.array_equal(_np(got), np.bitwise_xor.reduce(blk, axis=1))


def test_check_words_rejects_other_devices():
    meta = torch.zeros((2, 64), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pim_exec.check_words(meta, 0)


#: (shape, axis) of the fold on the card: fused blocks of 1, 31, 32 and 33
#: ports, packed rows32 and rows64 blocks of odd word counts.
CHECK_SHAPES = [((1, 1000), 0), ((31, 1000), 0), ((32, 4097), 0),
                ((33, (1 << 20) + 3), 0), ((1, 7), 0), ((33, 32769), 0),
                ((64, 33), 0), ((2, 1, 5), 1), ((2, 33, 32769), 1),
                ((2, 64, 4097), 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape,axis", CHECK_SHAPES,
                         ids=[f"{s}-axis{a}" for s, a in CHECK_SHAPES])
def test_check_words_matches_plain_version(cuda, shape, axis):
    rng = np.random.default_rng(27)
    blk = _bits(rng, shape)
    pim_exec.reset_counts()
    got = pim_exec.check_words(_t(blk).to(cuda), axis)
    torch.cuda.synchronize()
    assert pim_exec.LAUNCHES["check_words"] == 1
    assert not ref.CALLS["check_words"]
    want = ref.check_words(_t(blk), axis)
    assert torch.equal(got.cpu(), want)
    assert np.array_equal(_np(got), np.bitwise_xor.reduce(blk, axis=axis))


@pytest.mark.cuda
def test_verified_main_path_launches_the_fold(cuda):
    """A plan with faults and verify folds every chunk attempt on the
    card; a verify-only plan folds nothing, as in the reference."""
    from repro_torch.runtime.faults import FaultModel, VerifyPolicy
    rng = np.random.default_rng(28)
    a = rng.standard_normal(5000).astype(np.float32)
    b = rng.standard_normal(5000).astype(np.float32)
    ops.drain_health()
    pim_exec.reset_counts()
    assert np.array_equal(pim.fp_add(a, b, chunk_rows=2048, verify=True),
                          a + b)
    assert pim_exec.LAUNCHES["check_words"] == 0
    fm = FaultModel(seed=3, force_flips=((0, 5),))
    pim_exec.reset_counts()
    got = pim.fp_add(a, b, chunk_rows=2048, faults=fm,
                     verify=VerifyPolicy(backoff_s=1e-5))
    assert np.array_equal(got, a + b)
    h = ops.drain_health()
    assert h["faults_detected"] >= 1 and h["retries"] >= 1
    assert pim_exec.LAUNCHES["check_words"] == 3 + h["retries"]
    assert pim_exec.LAUNCHES["slot_scan_fused"] == 3 + h["retries"]
    assert not any(slots.CALLS.values()) and not ref.CALLS["check_words"]


@pytest.mark.cuda
def test_batched_serving_on_the_card(cuda):
    """A small mixed batch through ``BatchRuntime`` on the card: every
    result bit-exact against numpy, the slot scan launched (fused and io)
    and no plain version run, nothing degraded and nothing shed."""
    from repro_torch.runtime import pim_batch
    rng = np.random.default_rng(29)
    n = 3000

    def u(bits, lo=0):
        return rng.integers(lo, 1 << bits, n, dtype=np.uint64).astype(
            np.dtype(f"uint{bits}"))

    def f16():
        return (rng.uniform(1.0, 2.0, n) *
                rng.choice([-1.0, 1.0], n)).astype(np.float16)

    a8, b8, a16, b16, d16 = u(8), u(8), u(16), u(16), u(16, 1)
    fa, fb = f16(), f16()
    wide = np.array([(1 << 69) + int(v) for v in u(16)], object)
    cases = [
        ("add", a8, b8, {}, a8.astype(np.uint64) + b8),
        ("mul", a16, b16, {}, a16.astype(np.uint64) * b16),
        ("div", a16, d16, {}, (a16 // d16, a16 % d16)),
        ("fp_add", fa, fb, {}, fa + fb),
        ("fp_mul", fa, fb, {}, fa * fb),
        ("add", wide, b16.astype(object), {"width": 70},
         wide + b16.astype(object)),
    ]
    preps = [pim.prepare(op, x, y, **kw) for op, x, y, kw, _ in cases] * 2
    for p in preps[:len(cases)]:
        p.warm()
    rt = pim_batch.BatchRuntime()
    pim_exec.reset_counts()
    try:
        results = rt.execute(preps)
    finally:
        rt.close()
    for r, (op, _, _, _, want) in zip(results, cases * 2):
        got = r.value
        if op == "div":
            assert all(np.array_equal(g, w) for g, w in zip(got, want))
        else:
            assert np.array_equal(np.asarray(got).astype(object),
                                  np.asarray(want).astype(object)), op
    assert pim_exec.LAUNCHES["slot_scan_fused"] == len(cases) - 1
    assert pim_exec.LAUNCHES["slot_scan_io"] == 1
    assert not any(slots.CALLS.values()) and not any(ref.CALLS.values())
    st = rt.stats
    assert (st.groups, st.requests) == (len(cases), 2 * len(cases))
    assert st.shed_requests == 0 and st.degraded_groups == 0 and \
        st.errors == 0


@pytest.mark.cuda
def test_a_tripped_family_sheds_on_the_card(cuda, monkeypatch):
    """Faults that exhaust their retries trip a family's breaker on the
    card; its next request is shed on the card itself (the slot scan, no
    plain version, never the host's numpy oracle), without the fault
    model, bit-exact and marked ``shed``."""
    from repro_torch.runtime import pim_batch
    from repro_torch.runtime.faults import FaultModel, VerifyPolicy
    real = ops.run_program

    def run_program(program, inputs, n_rows, plan=None, **kwargs):
        assert plan is None or plan.backend.name != "numpy"
        return real(program, inputs, n_rows, plan, **kwargs)
    monkeypatch.setattr(ops, "run_program", run_program)
    x = np.arange(4096, dtype=np.uint16)
    y = x[::-1].copy()
    with pim.options(faults=FaultModel(seed=3, p_flip=1.0),
                     verify=VerifyPolicy(max_retries=1, remap_after=99,
                                         backoff_s=1e-6)):
        prep = pim.prepare("add", x, y)
    pim.prepare("add", x, y).warm()     # the same build, fault-free
    rt = pim_batch.BatchRuntime(breaker=pim_batch.BreakerPolicy(
        window=8, trip_failures=2, cooldown_s=60.0, probes=1))
    try:
        failed = [rt.execute([prep])[0] for _ in range(2)]
        pim_exec.reset_counts()
        shed = rt.execute([prep])[0]
    finally:
        rt.close()
    ops.drain_health()
    assert all(r.error["code"] == "exec_failed" for r in failed)
    assert shed.shed and shed.error is None
    assert np.array_equal(shed.value, x.astype(np.uint64) + y)
    assert pim_exec.LAUNCHES["slot_scan_fused"] == 1
    assert pim_exec.LAUNCHES["check_words"] == 0
    assert not any(slots.CALLS.values()) and not any(ref.CALLS.values())
    assert rt.stats.shed_requests == 1 and rt.stats.breaker_trips == 1


def _static_add16(rows: int = 4096):
    """uint16 add under ``slots-static`` (B2) on the card, checked against
    numpy; returns the launches and plain calls of the run."""
    rng = np.random.default_rng(21)
    x = rng.integers(0, 1 << 16, rows).astype(np.uint16)
    y = rng.integers(0, 1 << 16, rows).astype(np.uint16)
    pim_exec.reset_counts()
    got = pim.add(x, y, schedule="slots-static")
    assert np.array_equal(got, x.astype(np.uint64) + y)
    plain = {k: v for c in (slots.CALLS, ref.CALLS) for k, v in c.items()
             if v}
    return dict(pim_exec.LAUNCHES), plain


@pytest.fixture
def binary_tier(cuda, tmp_path, monkeypatch):
    """An artifact cache installed on the card, and a function that points
    the kernels' build directory at a fresh empty directory."""
    from repro_torch.runtime.artifact_cache import ArtifactCache
    c = ArtifactCache(tmp_path / "cache")
    ops.set_artifact_cache(c)
    dirs = iter(tmp_path / f"build{i}" for i in range(8))

    def fresh_build_dir():
        monkeypatch.setattr(pim_exec, "BUILD_DIR", next(dirs))
        ops.clear_compiled_cache()
        return pim_exec.BUILD_DIR
    try:
        yield c, fresh_build_dir
    finally:
        ops.set_artifact_cache(None)
        ops.clear_compiled_cache()


def _disk(name: str) -> int:
    from repro_torch.runtime import telemetry
    return int(telemetry.REGISTRY.counter(f"pim.cache.{name}"))


@pytest.mark.cuda
def test_static_kernel_loads_from_the_binary_tier(binary_tier):
    """B2's library, built once with the cache installed, comes back from
    the binary tier into an empty build directory: no ``nvcc`` runs, the
    kernel launches (no plain version) and the result is bit-exact."""
    cache, fresh_build_dir = binary_tier
    fresh_build_dir()
    runs0 = pim_exec.COMPILES["runs"]
    _static_add16()
    assert pim_exec.COMPILES["runs"] > runs0
    assert any(h["kind"] == "bin" and (h["tag"] or {}).get("kind") ==
               "static" for h in cache.entries())
    build = fresh_build_dir()
    runs1, hits1 = pim_exec.COMPILES["runs"], _disk("disk_hits")
    launches, plain = _static_add16()
    assert pim_exec.COMPILES["runs"] == runs1
    assert _disk("disk_hits") > hits1
    assert launches["slots_static_fused"] >= 1 and not plain
    assert [p.name for p in build.iterdir() if p.suffix == ".so"]


@pytest.mark.cuda
def test_a_corrupted_binary_is_rebuilt_and_counted(binary_tier):
    """A flipped byte in B2's cached library fails its digest: the load
    counts ``disk_errors``, ``nvcc`` rebuilds it (never the plain version)
    and the rebuild is written through, so the next empty build
    directory loads it again."""
    cache, fresh_build_dir = binary_tier
    fresh_build_dir()
    _static_add16()
    (path,) = [e.path for e in cache._files()
               if e.name.startswith("bin-") and
               (cache._read(e.path)[0]["tag"] or {}).get("kind") == "static"]
    with open(path, "r+b") as f:
        f.seek(-100, 2)
        b = f.read(1)
        f.seek(-100, 2)
        f.write(bytes([b[0] ^ 0xFF]))
    fresh_build_dir()
    runs0, err0 = pim_exec.COMPILES["runs"], _disk("disk_errors")
    launches, plain = _static_add16()
    assert _disk("disk_errors") == err0 + 1
    assert pim_exec.COMPILES["runs"] == runs0 + 1
    assert launches["slots_static_fused"] >= 1 and not plain
    fresh_build_dir()
    runs1 = pim_exec.COMPILES["runs"]
    _static_add16()
    assert pim_exec.COMPILES["runs"] == runs1


# --------------------------------------------------------------------------
# the LM (ROADMAP A13) on the card against the CPU
# --------------------------------------------------------------------------

#: A bfloat16 logit of magnitude up to 4 rounds to 2**-6; the card's and
#: the CPU's matmuls sum in other orders, so a few ulps.
LM_CARD_CPU_TOL = 0.05


@pytest.fixture
def lm_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: holds the card against the CPU")
    return "cuda"


def _lm_prefill_then_decode(cfg, model, toks, n_dec, vision=None):
    from repro_torch.models import model as M
    s = toks.shape[1] - n_dec
    batch = {"tokens": toks[:, :s]}
    if vision is not None:
        batch["vision"] = vision
    logits, caches = M.prefill(cfg, model, batch)
    # only a sequence axis grows: a local ring, a recurrent state and a
    # cross layer's empty cache keep their size
    caches = [c if M.seq_len(c) is None else
              {k: torch.nn.functional.pad(v, (0, 0) * (v.dim() - 2)
                                          + (0, n_dec))
               for k, v in c.items()} for c in caches]
    out = [logits.float().cpu()]
    for t in range(s, s + n_dec):
        logits, caches = M.decode_step(cfg, model, caches, toks[:, t], t,
                                       vision=vision)
        out.append(logits.float().cpu())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("group,window", [(("attn",), 0),
                                          (("attn", "local"), 4)],
                         ids=["attn", "local"])
def test_lm_on_the_card_matches_the_cpu(lm_cuda, group, window):
    """The reduced qwen3-8b (and its variant with a local layer of window
    4, run past it), one set of weights on both devices: prefill of 8
    tokens, then 4 decode steps; logits within ``LM_CARD_CPU_TOL``."""
    import copy
    from repro_torch.configs.registry import ARCHS
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    cfg = ARCHS["qwen3-8b"].reduced(group=group, window=window)
    cpu = M.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    card = copy.deepcopy(cpu).to(lm_cuda)
    toks = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab, (2, 12)))
    want = _lm_prefill_then_decode(cfg, cpu, toks, 4)
    got = _lm_prefill_then_decode(cfg, card, toks.to(lm_cuda), 4)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < LM_CARD_CPU_TOL
    gen = serve.generate(cfg, card, toks[:, :6].to(lm_cuda), 6)
    assert gen.device.type == "cuda" and tuple(gen.shape) == (2, 12)
    assert torch.equal(gen[:, :6].cpu(), toks[:, :6].to(torch.int32))


#: Card against CPU for the MoE models, in float32 weights (a top-k choice
#: can flip on a bfloat16 rounding): a few float32 ulps of logits of
#: order 1, summed in other orders.
LM_MOE_CARD_CPU_TOL = 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["recurrentgemma-2b", "qwen3-moe-235b-a22b",
                                  "deepseek-v2-236b", "rwkv6-1.6b",
                                  "llama-3.2-vision-90b", "hubert-xlarge"])
def test_lm_families_on_the_card_match_the_cpu(lm_cuda, name):
    """Each other family reduced, one set of weights on both devices (the
    vision model's cross gates set to 0.5, so that its cross layers
    count): prefill of 16 tokens, then 4 decode steps (hubert, which has
    no decode: ``forward`` over 16 frames); logits within
    ``LM_CARD_CPU_TOL`` in bfloat16, ``LM_MOE_CARD_CPU_TOL`` for the MoE
    models in float32."""
    import copy
    from repro_torch.configs.registry import ARCHS
    from repro_torch.models import model as M
    cfg = ARCHS[name].reduced()
    cpu = M.LM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    for p in cpu["layers"]:
        if "attn" in p and "gate" in p["attn"]:
            p["attn"]["gate"].fill_(0.5)
    tol = LM_CARD_CPU_TOL
    if cfg.moe is not None:
        cpu.float()
        tol = LM_MOE_CARD_CPU_TOL
    card = copy.deepcopy(cpu).to(lm_cuda)
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 20)))
    feats = None
    if cfg.frontend != "none":
        n = cfg.vision_seq if cfg.frontend == "vision" else 16
        feats = torch.from_numpy(rng.standard_normal(
            (2, n, cfg.frontend_dim)).astype(np.float32))
    if cfg.encoder_only:
        want = [M.forward(cfg, cpu, {"frames": feats})[0].float()]
        got = [M.forward(cfg, card, {"frames": feats.to(lm_cuda)})[0]
               .float().cpu()]
    else:
        want = _lm_prefill_then_decode(cfg, cpu, toks, 4, feats)
        got = _lm_prefill_then_decode(
            cfg, card, toks.to(lm_cuda), 4,
            None if feats is None else feats.to(lm_cuda))
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) < tol


@pytest.fixture(scope="module")
def smoke_mod():
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-8b", "qwen3-moe-235b-a22b"])
def test_train_step_on_the_card_matches_the_cpu(lm_cuda, smoke_mod, name):
    """One train step of the reduced model in float32 from one set of
    weights and one batch on both devices: loss, grad norm, both moments
    and the updated weights within ``chip_smoke.TRAIN_CARD_CPU_TOL`` of
    their largest (the weights where the gradient's sign is sure)."""
    errs = smoke_mod.train_card_against_cpu(name, lm_cuda)
    assert max(v for k, v in errs.items() if k != "flips") <= \
        smoke_mod.TRAIN_CARD_CPU_TOL, errs


@pytest.mark.cuda
def test_train_resume_on_the_card_is_bit_identical(lm_cuda, smoke_mod,
                                                   tmp_path):
    """Four straight steps against two, a checkpoint, a new loop on a
    fresh model and two more: every weight bit-equal."""
    assert smoke_mod.train_resume_check(tmp_path, lm_cuda)
