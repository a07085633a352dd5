"""Shared harness of the port's fault parity tests (``test_torch_faults*``):
the two packages side by side, a fixture that resets both packages'
health, media and spot-check state around each case, and :func:`both`,
which runs one scenario through each package on its ``ref`` backend and
holds the results, the drained ``HEALTH`` counters, the wear ledger, the
quarantine queue and the media counters equal."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from repro import pim_ufunc as rpim
from repro.core import pim_numerics as rpn
from repro.kernels import ops as rops
from repro.runtime import faults as rfaults
from repro_torch import pim_ufunc as tpim
from repro_torch.core import pim_numerics as tpn
from repro_torch.kernels import ops as tops
from repro_torch.runtime import faults as tfaults


def _carry_to(module):
    def carry(x):
        """A reference FaultModel or VerifyPolicy as ``module``'s own."""
        if x is None or isinstance(x, bool):
            return x
        return getattr(module, type(x).__name__)(**dataclasses.asdict(x))
    return carry


REF = SimpleNamespace(name="repro", pim=rpim, pn=rpn, ops=rops,
                      faults=rfaults, cpu={"backend": "ref"},
                      carry=_carry_to(rfaults))
PORT = SimpleNamespace(name="repro_torch", pim=tpim, pn=tpn, ops=tops,
                       faults=tfaults,
                       cpu={"backend": "ref", "device": "cpu"},
                       carry=_carry_to(tfaults))
PACKAGES = (REF, PORT)
#: Both packages' spot-check debt before each case: saturated, so the
#: first verified chunk of a case is spot-checked in both.
SPOT_DEBT = 1 << 62


def _reset_media(pkg) -> None:
    for base in pkg.faults.quarantined_spans():
        pkg.faults.release_span(base)
    pkg.faults.WEAR.clear()
    pkg.faults.drain_media_health()


@pytest.fixture(autouse=True)
def both_packages_clean():
    """Each case starts with both packages' HEALTH, media state and spot
    debt alike, and fails if it leaves HEALTH counters undrained (the
    reference suite's leak check, for both packages)."""
    for pkg in PACKAGES:
        pkg.ops.drain_health()
        _reset_media(pkg)
        pkg.ops._spot_debt = SPOT_DEBT
    yield
    leaked = {}
    for pkg in PACKAGES:
        _reset_media(pkg)
        got = pkg.ops.drain_health()
        if got:
            leaked[pkg.name] = got
    assert not leaked, f"case leaked undrained HEALTH counters: {leaked}"


def state(pkg) -> dict:
    """Drain ``pkg``'s health and media counters; with its wear ledger and
    quarantine queue."""
    return {"health": pkg.ops.drain_health(),
            "wear": pkg.faults.wear_snapshot(top=1 << 20),
            "quarantine": pkg.faults.quarantined_spans(),
            "media": pkg.faults.drain_media_health()}


def same(a, b) -> bool:
    """Bit-equal results: dicts and sequences element by element, arrays
    by shape and values (bit patterns where both have one numeric
    dtype)."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and \
            all(same(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return isinstance(b, (tuple, list)) and len(a) == len(b) and \
            all(same(x, y) for x, y in zip(a, b))
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape:
        return False
    if a.dtype == b.dtype and a.dtype != object:
        return np.array_equal(np.ascontiguousarray(a).view(np.uint8),
                              np.ascontiguousarray(b).view(np.uint8))
    return np.array_equal(a.astype(object), b.astype(object))


def both(scenario):
    """Run ``scenario(pkg)`` through the reference, then the port; assert
    equal results and equal health, wear, quarantine and media state.
    Returns (the port's result, its state)."""
    got = {}
    for pkg in PACKAGES:
        out = scenario(pkg)
        got[pkg.name] = (out, state(pkg))
    (r_out, r_state), (t_out, t_state) = got["repro"], got["repro_torch"]
    assert same(r_out, t_out), (r_out, t_out)
    assert r_state == t_state
    return t_out, t_state
