"""Verified execution under injected faults in the port, held against
``repro`` on the CPU: each test of ``tests/test_faults.py`` (its packed
and tree matrices are in ``test_torch_faults_packed.py``) runs through
both packages on their ``ref`` backends with the same inputs from a
seeded numpy generator, and the results, the drained ``HEALTH``
counters, the wear ledger and the quarantine queue must be equal (and
the results equal to the numpy oracle).  Also the plain check fold (B6)
against the reference's, the ``exec`` trace span, and sharded fault runs
against the numpy oracle."""

import time
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from _fault_parity import (PACKAGES, PORT, REF, both,  # noqa: F401
                           both_packages_clean, same, state)
from repro.kernels import pim_exec as rpx
from repro.kernels.plan import LAYOUTS, SCHEDULES
from repro.runtime.faults import FaultModel, VerifyPolicy
from repro_torch.kernels import ref as tref
from repro_torch.runtime import telemetry as ttelemetry
from repro.runtime import telemetry as rtelemetry


def _operands(n=160, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 1 << 16, n).astype(np.uint16)
    y = rng.integers(0, 1 << 16, n).astype(np.uint16)
    return x, y, x.astype(np.uint64) + y


def _prog(pkg):
    return pkg.pn.program_for("int-serial", "add", 16)


def _plan(pkg, **kw):
    for k in ("faults", "verify"):
        if k in kw:
            kw[k] = pkg.carry(kw[k])
    return pkg.ops.make_plan(**pkg.cpu, **kw)


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode()) & 0xFFFF


# ------------------------------------------------------------- fault maps

@pytest.mark.parametrize("kw", [
    {"p_flip": 1.5}, {"p_dead_row": -0.1}, {"spare_base": 33}])
def test_fault_model_validation(kw):
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            pkg.faults.FaultModel(**kw)


@pytest.mark.parametrize("kw", [{"max_retries": -1}, {"remap_after": 0}])
def test_verify_policy_validation(kw):
    for pkg in PACKAGES:
        with pytest.raises(ValueError):
            pkg.faults.VerifyPolicy(**kw)


def test_fault_maps_deterministic_and_subrange_consistent():
    def maps(pkg):
        fm = pkg.carry(FaultModel(seed=11, p_dead_row=0.03, p_stuck=0.05))
        other = pkg.carry(FaultModel(seed=12, p_dead_row=0.03, p_stuck=0.05))
        whole = fm.dead_rows(0, 4096)
        assert np.array_equal(whole, np.concatenate(
            [fm.dead_rows(0, 1000), fm.dead_rows(1000, 4096)]))
        assert not np.array_equal(whole, other.dead_rows(0, 4096))
        return whole, fm.stuck_cols(0, 256), other.dead_rows(0, 4096)
    both(maps)


def test_forced_faults_and_span_bad():
    def forced(pkg):
        fm = pkg.carry(FaultModel(seed=0, force_dead_rows=(70, 3),
                                  force_stuck=((2, 1),)))
        assert np.array_equal(fm.dead_rows(0, 100), [3, 70])
        return (fm.dead_rows(0, 100), fm.stuck_cols(0, 8),
                [fm.span_bad(b, 64) for b in (0, 64, 128)])
    both(forced)


def test_transient_flips_attempt0_only():
    def flips(pkg):
        fm = pkg.carry(FaultModel(seed=0, force_flips=((1, 9),)))
        c0, r0 = fm.sample_flips(5, 0, 3, 4, 64)
        c1, _ = fm.sample_flips(5, 1, 3, 4, 64)
        assert 1 in c0 and 9 in r0 and len(c1) == 0
        rate = pkg.carry(FaultModel(seed=3, p_flip=0.02))
        return (c0, r0, c1, rate.sample_flips(5, 1, 8, 4, 64),
                rate.sample_flips(9, 0, 300, 33, 4096))
    both(flips)


def test_word_coords_roundtrip():
    rows = np.array([0, 31, 32, 63, 64, 70, 127, 128])

    def coords(pkg):
        out = []
        for planes in (1, 2):
            pl, w, bit = pkg.faults.word_coords(rows, planes)
            assert np.array_equal(w * 32 * planes + pl * 32 + bit, rows)
            out.append((pl, w, bit))
        return out
    both(coords)


# ------------------------------------------------ B6: the plain check fold

def _check_words_both(block: np.ndarray, axis: int) -> np.ndarray:
    """The port's plain fold and the reference's on one block."""
    want = np.asarray(rpx.check_words(jnp.asarray(block), axis))
    t = torch.from_numpy(np.ascontiguousarray(block).view(np.int32))
    n = tref.CALLS["check_words"]
    got = tref.check_words(t, axis).numpy().view(np.uint32)
    assert tref.CALLS["check_words"] == n + 1
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert np.array_equal(want, np.bitwise_xor.reduce(block, axis=axis))
    return got


def _bits(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


@pytest.mark.parametrize("ports", [1, 31, 32, 33])
@pytest.mark.parametrize("rows", [1, 1000, 1031])
def test_check_words_fused_matches_reference(ports, rows):
    rng = np.random.default_rng(_seed(ports, rows))
    _check_words_both(_bits(rng, (ports, rows)), 0)


@pytest.mark.parametrize("k", [1, 33, 64])
@pytest.mark.parametrize("planes", [1, 2])
@pytest.mark.parametrize("n_words", [1, 7, 33])
def test_check_words_packed_matches_reference(k, planes, n_words):
    rng = np.random.default_rng(_seed(k, planes, n_words))
    shape = (k, n_words) if planes == 1 else (planes, k, n_words)
    _check_words_both(_bits(rng, shape), len(shape) - 2)


def _fold_paths() -> list:
    """``chip_smoke.fold_paths`` on the H100's SM count: the blocks that
    reach each path of the card's fold (held there in
    tests/test_torch_kernels.py), some views ``offset`` words into their
    buffer."""
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke.fold_paths(smoke.N_SMS)


KERNEL_BRANCHES = _fold_paths()


@pytest.mark.parametrize("shape,axis,offset", KERNEL_BRANCHES,
                         ids=[f"{s}-axis{a}" + (f"-offset{o}" if o else "")
                              for s, a, o in KERNEL_BRANCHES])
def test_check_words_kernel_branches_match_reference(shape, axis, offset):
    rng = np.random.default_rng(_seed(shape, axis, offset))
    flat = _bits(rng, (offset + int(np.prod(shape)),))
    _check_words_both(flat[offset:].reshape(shape), axis)


def test_check_words_through_ops_matches_reference():
    """``ops.check_words`` (the wrapper: the plain version on a CPU
    tensor) against ``repro.kernels.ops.check_words``."""
    blk = _bits(np.random.default_rng(0), (5, 7))
    want = np.asarray(REF.ops.check_words(jnp.asarray(blk), 0))
    got = PORT.ops.check_words(torch.from_numpy(blk.view(np.int32)), 0)
    assert np.array_equal(got.numpy().view(np.uint32), want)


def test_check_words_of_an_empty_axis_is_zero():
    got = tref.check_words(torch.zeros((0, 5), dtype=torch.int32), 0)
    want = np.asarray(rpx.check_words(jnp.zeros((0, 5), jnp.uint32), 0))
    assert np.array_equal(got.numpy().view(np.uint32), want)


# -------------------------------------------------- plan-layer integration

def test_plan_key_includes_faults_but_compile_key_does_not():
    def keys(pkg):
        base = _plan(pkg)
        faulty = _plan(pkg, faults=FaultModel(seed=1), verify=True)
        other = _plan(pkg, faults=FaultModel(seed=2), verify=True)
        assert base.key != faulty.key != other.key
        assert base.compile_key == faulty.compile_key
        return [base.key == faulty.key, faulty.key == other.key,
                base.compile_key == faulty.compile_key]
    both(keys)


def test_numpy_backend_rejects_faults():
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="fault injection / verified "
                           "execution require a levelized"):
            pkg.ops.make_plan(backend="numpy",
                              faults=pkg.carry(FaultModel(seed=1)))
        with pytest.raises(ValueError):
            pkg.ops.make_plan(backend="numpy", verify=True)


def test_ufunc_config_plumbs_faults_and_verify():
    x, y, want = _operands(40)

    def plumbs(pkg):
        with pkg.pim.options(**pkg.cpu,
                             faults=pkg.carry(FaultModel(
                                 seed=3, force_flips=((0, 2),))),
                             verify=True):
            got = pkg.pim.add(x, y)
        assert np.array_equal(got, want)
        return got
    _, st = both(plumbs)
    h = st["health"]
    assert h["faults_detected"] >= 1 and h["faults_corrected"] >= 1

    def numpy_drops(pkg):
        # numpy drops faults/verify (it is the oracle)
        got = pkg.pim.add(x, y, backend="numpy", verify=True,
                          faults=pkg.carry(FaultModel(seed=1, p_flip=1.0)))
        assert np.array_equal(got, want)
        return got
    _, st = both(numpy_drops)
    assert not st["health"]


# ------------------------------------------- detect -> retry -> remap

FAULT_KINDS = {
    "flip": FaultModel(seed=5, force_flips=((1, 9),)),
    "dead": FaultModel(seed=5, force_dead_rows=(70,)),
    "stuck": FaultModel(seed=5, force_stuck=((1, 1),)),
}


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", sorted(FAULT_KINDS))
def test_single_fault_recovery_matrix(schedule, layout, kind):
    """One injected fault of each kind recovers bit-exactly on every
    schedule x layout through the multi-chunk streaming executor, with
    the reference's health, wear and quarantine."""
    x, y, want = _operands(seed=_seed(schedule, layout, kind))

    def run(pkg):
        plan = _plan(pkg, schedule=schedule, layout=layout, chunk_rows=64,
                     faults=FAULT_KINDS[kind],
                     verify=VerifyPolicy(backoff_s=1e-5))
        got = pkg.ops.run_program_streaming(_prog(pkg), {"x": x, "y": y},
                                            len(x), plan)
        assert np.array_equal(got["z"], want)
        return got
    _, st = both(run)
    h = st["health"]
    assert h.get("faults_detected", 0) + h.get("remapped_rows", 0) > 0


def test_randomized_low_rate_faults_recover():
    x, y, want = _operands(n=300, seed=7)

    def run(pkg):
        outs = []
        for seed in range(3):
            plan = _plan(pkg, chunk_rows=128,
                         faults=FaultModel(seed=seed, p_flip=2e-4,
                                           p_dead_row=1e-3),
                         verify=VerifyPolicy(backoff_s=1e-5))
            got = pkg.ops.run_program_streaming(
                _prog(pkg), {"x": x, "y": y}, len(x), plan)
            assert np.array_equal(got["z"], want), seed
            outs.append(got)
        return outs
    both(run)


def test_unverified_faults_corrupt_observably():
    """With no verify policy the injected flip reaches the result -- at
    the same row and bit in both packages."""
    x, y, want = _operands()

    def run(pkg):
        plan = _plan(pkg, faults=FaultModel(seed=1, force_flips=((0, 7),)))
        return pkg.ops.run_program(_prog(pkg), {"x": x, "y": y}, len(x),
                                   plan)
    got, st = both(run)
    assert not np.array_equal(got["z"], want)
    assert st["health"]["faults_injected"] >= 1
    assert "faults_detected" not in st["health"]


def _raises_fault_error(pkg, plan, n=64):
    x, y, _ = _operands(n)
    with pytest.raises(pkg.faults.FaultError) as ei:
        pkg.ops.run_program(_prog(pkg), {"x": x, "y": y}, len(x), plan)
    return ei.value.context


def test_retry_exhaustion_raises_fault_error():
    _, st = both(lambda pkg: _raises_fault_error(pkg, _plan(
        pkg, faults=FaultModel(seed=2, p_flip=1.0),
        verify=VerifyPolicy(max_retries=2, backoff_s=1e-6))))
    assert st["health"]["retries"] >= 2


def test_media_scan_exhaustion_raises_fault_error():
    both(lambda pkg: _raises_fault_error(pkg, _plan(
        pkg, faults=FaultModel(seed=2, p_dead_row=1.0),
        verify=VerifyPolicy(scan_limit=4, backoff_s=1e-6))))


def test_verify_without_faults_is_clean_passthrough():
    x, y, want = _operands(80)

    def run(pkg):
        got = pkg.ops.run_program(_prog(pkg), {"x": x, "y": y}, len(x),
                                  _plan(pkg, verify=True))
        assert np.array_equal(got["z"], want)
        return got
    _, st = both(run)
    assert "faults_detected" not in st["health"]
    assert "retries" not in st["health"]


def test_plain_plan_skips_verified_dispatch(monkeypatch):
    """A plan with neither faults nor verify never enters the port's
    verified dispatcher."""
    def boom(*a, **k):
        raise AssertionError("_verified_dispatch entered on a plain plan")
    monkeypatch.setattr(PORT.ops, "_verified_dispatch", boom)
    x, y, want = _operands(80)
    got = PORT.ops.run_program_streaming(
        _prog(PORT), {"x": x, "y": y}, len(x), _plan(PORT, chunk_rows=32))
    assert np.array_equal(got["z"], want)
    groups = [dict(program=_prog(PORT), inputs={"x": x, "y": y},
                   n_rows=len(x), plan=_plan(PORT, chunk_rows=32))]
    assert np.array_equal(PORT.ops.run_program_groups(groups)[0]["z"], want)
    fin = PORT.ops.dispatch_program(_prog(PORT), {"x": x, "y": y}, len(x),
                                    _plan(PORT))
    assert np.array_equal(fin()["z"], want)


def test_fault_error_structured_context():
    for pkg in PACKAGES:
        assert pkg.faults.FaultError("x").context == {}
        e = pkg.faults.FaultError("bad", program_key="ab12", attempts=3,
                                  chunk_start=None)
        assert e.context == {"program_key": "ab12", "attempts": 3}
    ctx, _ = both(lambda pkg: _raises_fault_error(pkg, _plan(
        pkg, faults=FaultModel(seed=2, p_flip=1.0),
        verify=VerifyPolicy(max_retries=1, backoff_s=1e-6,
                            remap_after=99))))
    assert ctx["attempts"] >= 1 and ctx["rows"] == 64
    assert "program_key" in ctx


# ------------------------------- media lifecycle: wear + scrubbing

def test_wear_and_quarantine_from_verified_run():
    x, y, want = _operands(64)

    def run(pkg):
        plan = _plan(pkg, chunk_rows=64,
                     faults=FaultModel(seed=4, force_dead_rows=(1,)),
                     verify=VerifyPolicy(backoff_s=1e-5))
        got = pkg.ops.run_program_streaming(_prog(pkg), {"x": x, "y": y},
                                            len(x), plan)
        assert np.array_equal(got["z"], want)
        return got
    _, st = both(run)
    assert st["quarantine"] and st["wear"]
    assert st["media"]["wear_writes"] >= 1
    assert st["media"]["quarantined_spans"] >= 1


def test_scrubber_reclaims_transient_quarantine_keeps_bad():
    def scrub(pkg):
        fm = pkg.carry(FaultModel(seed=0, force_dead_rows=(70,)))
        pkg.faults.note_quarantine(0, 64)
        pkg.faults.note_quarantine(64, 64)
        r = pkg.faults.Scrubber(fm).scrub_once()
        assert r == {"scrubbed": 2, "reclaimed": 1, "still_bad": 1}
        return r
    _, st = both(scrub)
    assert st["quarantine"] == {64: 64}
    assert st["media"]["scrub_passes"] == 1


def test_scrubber_thread_runs_and_stops():
    for pkg in PACKAGES:
        pkg.faults.note_quarantine(128, 64)
        s = pkg.faults.Scrubber(pkg.carry(FaultModel(seed=0)),
                                interval_s=0.01).start()
        deadline = time.monotonic() + 5.0
        while pkg.faults.quarantined_spans() and \
                time.monotonic() < deadline:
            time.sleep(0.01)
        s.stop()
        assert not pkg.faults.quarantined_spans()
        assert pkg.faults.drain_media_health()["scrub_passes"] >= 1
        s.stop()


# ----------------------------------------------------------- deadlines

def test_streaming_deadline_raises():
    x, y, _ = _operands(200)
    for pkg in PACKAGES:
        with pytest.raises(pkg.faults.DeadlineExceeded):
            pkg.ops.run_program_streaming(
                _prog(pkg), {"x": x, "y": y}, len(x),
                _plan(pkg, chunk_rows=32), deadline=time.monotonic() - 1.0)


def test_group_deadline_key():
    x, y, _ = _operands(64)
    for pkg in PACKAGES:
        specs = [dict(program=_prog(pkg), inputs={"x": x, "y": y},
                      n_rows=len(x), plan=_plan(pkg),
                      deadline=time.monotonic() - 1.0)]
        with pytest.raises(pkg.faults.DeadlineExceeded):
            pkg.ops.run_program_groups(specs)


# ------------------------------------- the other entry points, verified

@pytest.mark.parametrize("entry", ["groups", "dispatch_program",
                                   "dispatch_packed"])
def test_entry_points_run_verified(entry):
    """``run_program_groups``, ``dispatch_program`` and ``dispatch_packed``
    under a fault model and a verify policy agree with the reference."""
    x, y, want = _operands(150, seed=3)

    def run(pkg):
        plan = _plan(pkg, chunk_rows=64,
                     faults=FaultModel(seed=5, force_flips=((1, 9),),
                                       p_flip=0.01),
                     verify=VerifyPolicy(backoff_s=1e-5))
        prog = _prog(pkg)
        if entry == "groups":
            out = pkg.ops.run_program_groups(
                [dict(program=prog, inputs={"x": x, "y": y}, n_rows=len(x),
                      plan=plan),
                 dict(program=prog, inputs={"x": y, "y": x}, n_rows=len(x),
                      plan=plan)])
            assert all(np.array_equal(o["z"], want) for o in out)
            return out
        if entry == "dispatch_program":
            out = pkg.ops.dispatch_program(prog, {"x": x, "y": y}, len(x),
                                           plan)()
            assert np.array_equal(out["z"], want)
            return out
        return pkg.ops.dispatch_packed(prog, len(x), plan,
                                       inputs={"x": x, "y": y})()
    both(run)


def test_levelized_false_refuses_faults():
    x, y, _ = _operands(64)
    for pkg in PACKAGES:
        with pytest.raises(ValueError, match="levelized executors"):
            pkg.ops.run_program(_prog(pkg), {"x": x, "y": y}, len(x),
                                _plan(pkg, verify=True), levelized=False)


@pytest.mark.parametrize("op", ["add", "fp_add"])
def test_sharded_fault_runs_match_numpy(op):
    """A mesh of two CPU shards under a fault model and a verify policy
    recovers bit-exactly against the numpy oracle (the reference's mesh
    needs several jax devices, so only the oracle holds it here)."""
    rng = np.random.default_rng(_seed(op))
    if op == "add":
        x, y = (rng.integers(0, 1 << 16, 300).astype(np.uint16)
                for _ in range(2))
    else:
        x, y = (rng.standard_normal(300).astype(np.float32)
                for _ in range(2))
    fm = PORT.carry(FaultModel(seed=5, force_flips=((1, 9),), p_flip=5e-4,
                               force_dead_rows=(70,)))
    kw = dict(backend="ref", device="cpu", chunk_rows=128, faults=fm,
              verify=PORT.carry(VerifyPolicy(backoff_s=1e-5)))
    fn = getattr(PORT.pim, op)
    want = fn(x, y, backend="numpy")
    got = fn(x, y, mesh=("cpu", "cpu"), **kw)
    assert same(got, want)
    h = PORT.ops.drain_health()
    assert h.get("faults_detected", 0) >= 1 and h.get("remapped_rows", 0)
    PORT.faults.drain_media_health()


# ------------------------------------------------------ the exec span (C5)

@pytest.mark.parametrize("chunks", [1, 4])
def test_exec_span_matches_reference(chunks):
    """The port's dispatcher records the reference's ``exec`` events:
    the same names, categories and arguments (rows, levels, kind)."""
    x, y, _ = _operands(256, seed=chunks)
    events = {}
    for pkg, tel in ((REF, rtelemetry), (PORT, ttelemetry)):
        tel.TRACER.drain()
        tel.TRACER.enabled = True
        try:
            pkg.pim.add(x, y, chunk_rows=256 // chunks, **pkg.cpu)
        finally:
            tel.TRACER.enabled = False
        events[pkg.name] = [(e["name"], e["cat"], e.get("args"))
                            for e in tel.TRACER.drain()
                            if e["cat"] == "pim.exec"]
    assert events["repro_torch"] == events["repro"]
    assert len(events["repro"]) == chunks
    assert events["repro"][0][0] == "exec"
