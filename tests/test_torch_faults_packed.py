"""Verified execution of the port's compound paths, held against ``repro``
on the CPU: ``pim.dot`` and ``pim.gemv`` (the packed reduction trees,
every level a verify cut-point) and a depth-3 fused chain, under each
fault kind on every schedule x layout, with the reference's results,
``HEALTH`` counters, wear ledger and quarantine queue (the packed half of
``tests/test_faults.py``; see ``test_torch_faults.py``)."""

import time
import zlib

import numpy as np
import pytest

from _fault_parity import (PACKAGES, PORT, both,  # noqa: F401
                           both_packages_clean, same)
from repro.kernels.plan import LAYOUTS, SCHEDULES
from repro.runtime.faults import FaultModel, VerifyPolicy

PACKED_FAULTS = {
    "flip": FaultModel(seed=5, force_flips=((0, 2),)),
    "dead": FaultModel(seed=5, force_dead_rows=(1,)),
    "stuck": FaultModel(seed=5, force_stuck=((0, 1),)),
    "rate": FaultModel(seed=9, p_flip=5e-4),
}


def _seed(*key) -> int:
    return zlib.crc32(repr(key).encode()) & 0xFFFF


def _options(pkg, **kw):
    for k in ("faults", "verify"):
        if k in kw:
            kw[k] = pkg.carry(kw[k])
    return pkg.pim.options(**pkg.cpu, **kw)


@pytest.mark.parametrize("schedule", SCHEDULES)
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("kind", sorted(PACKED_FAULTS))
def test_packed_tree_and_fused_fault_recovery_matrix(schedule, layout, kind):
    """dot, gemv (packed log-depth trees) and a depth-3 fused chain recover
    bit-exactly against the numpy oracle from every fault kind on every
    schedule x layout -- forced single faults and the acceptance rate's
    transient flips (p_flip=5e-4) -- with the reference's health."""
    seed = _seed(schedule, layout, kind)

    def run(pkg):
        rng = np.random.default_rng(seed)
        pim = pkg.pim
        out = []
        with _options(pkg, schedule=schedule, layout=layout,
                      faults=PACKED_FAULTS[kind],
                      verify=VerifyPolicy(backoff_s=1e-5)):
            xd = rng.integers(0, 256, 64).astype(np.uint8)
            yd = rng.integers(0, 256, 64).astype(np.uint8)
            got = pim.dot(xd, yd)
            assert int(got) == int(pim.dot(xd, yd, backend="numpy",
                                           layout="rows32"))
            out.append(got)
            a = rng.integers(0, 1 << 16, (3, 8)).astype(np.uint16)
            v = rng.integers(0, 1 << 16, 8).astype(np.uint16)
            got = pim.gemv(a, v)
            assert same(got, pim.gemv(a, v, backend="numpy",
                                      layout="rows32"))
            out.append(got)
            x = rng.integers(0, 256, 48).astype(np.uint8)
            y = rng.integers(1, 256, 48).astype(np.uint8)
            z = rng.integers(0, 256, 48).astype(np.uint8)
            chain = pim.sub(pim.add(pim.mul(pim.lazy(x), pim.lazy(y)),
                                    pim.lazy(z)), pim.lazy(x))
            got = chain.run()
            assert same(got, chain.run(backend="numpy", layout="rows32"))
            out.append(got)
        return out
    both(run)


def test_gemv_wide_group_rows64_faulty():
    """A K=96 reduction on rows64 walks the plane-aware tree pairings
    (word slice, plane re-seam, in-word shift) under a forced transient
    flip and lands bit-exact, as in the reference."""
    rng = np.random.default_rng(96)
    a = rng.integers(0, 1 << 16, (2, 96)).astype(np.uint16)
    v = rng.integers(0, 1 << 16, 96).astype(np.uint16)

    def run(pkg):
        with _options(pkg, layout="rows64",
                      faults=FaultModel(seed=5, force_flips=((0, 2),)),
                      verify=VerifyPolicy(backoff_s=1e-5)):
            got = pkg.pim.gemv(a, v)
            assert same(got, pkg.pim.gemv(a, v, backend="numpy",
                                          layout="rows32"))
        return got
    _, st = both(run)
    assert st["health"].get("faults_detected", 0) >= 1


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_verify_only_tree_matches_reference(layout):
    """A verify-only tree injects and folds nothing: the port keeps its
    blocks on the device (here the CPU), and records the reference's wear
    for every level."""
    rng = np.random.default_rng(_seed(layout))
    a = rng.integers(0, 1 << 16, (3, 40)).astype(np.uint16)
    v = rng.integers(0, 1 << 16, 40).astype(np.uint16)

    def run(pkg):
        with _options(pkg, layout=layout, verify=True):
            return [pkg.pim.gemv(a, v), pkg.pim.reduce_sum(a[0])]
    _, st = both(run)
    assert st["wear"] and not st["health"].get("faults_detected")


def test_packed_tree_deadline_between_levels():
    x = np.arange(64, dtype=np.uint8)
    for pkg in PACKAGES:
        with _options(pkg):
            with pytest.raises(pkg.faults.DeadlineExceeded):
                pkg.pim.dot(x, x, deadline=time.monotonic() - 1.0)


def test_plain_plan_skips_verified_packed_dispatch(monkeypatch):
    """With faults and verify unset the port's verified packed dispatcher
    is never entered."""
    def boom(*a, **k):
        raise AssertionError(
            "_verified_dispatch_packed entered on a plain plan")
    monkeypatch.setattr(PORT.ops, "_verified_dispatch_packed", boom)
    x = np.arange(64, dtype=np.uint8)
    y = x[::-1].copy()
    with _options(PORT):
        got = PORT.pim.dot(x, y)
        gemv = PORT.pim.gemv(x.reshape(4, 16), y[:16])
    assert int(got) == int(np.dot(x.astype(np.int64), y.astype(np.int64)))
    assert np.array_equal(np.asarray(gemv, np.int64),
                          x.reshape(4, 16).astype(np.int64) @ y[:16])


def test_sharded_tree_under_faults_matches_numpy():
    """A gemv over two CPU shards under a fault model and a verify policy
    against the numpy oracle (the reference's mesh needs several jax
    devices)."""
    rng = np.random.default_rng(7)
    a = rng.integers(0, 1 << 16, (3, 24)).astype(np.uint16)
    v = rng.integers(0, 1 << 16, 24).astype(np.uint16)
    with _options(PORT, faults=FaultModel(seed=5, force_flips=((0, 2),),
                                          p_flip=5e-4),
                  verify=VerifyPolicy(backoff_s=1e-5)):
        got = PORT.pim.gemv(a, v, mesh=("cpu", "cpu"))
        want = PORT.pim.gemv(a, v, backend="numpy")
    assert same(got, want)
    assert PORT.ops.drain_health().get("faults_detected", 0) >= 1
