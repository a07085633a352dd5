"""The operand generator stays in the suite's domain for any seed, and the
plain reference agrees with known small cases; its control, one precision
step down, is refused by the check."""

import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pimbench import cells, control, reference, traffic  # noqa: E402

SEEDS = [0, 1, 2 ** 31 - 1, 2 ** 31 + 11, 2 ** 40 + 3, 2 ** 63 + 5, -7]
CELLS = cells.cell_names("ufunc")


def small(cell, rows=4096):
    spec = cells.load_cell(cell)
    spec["traffic"]["rows_per_call"] = rows
    return spec


@pytest.mark.parametrize("seed", SEEDS)
def test_float_operands_are_normal_and_never_cancel(seed):
    spec = small("fp32-add-64Mi")
    lo = spec["traffic"]["operands"]["exponent_min"]
    hi = spec["traffic"]["operands"]["exponent_max"]
    sets = traffic.operand_sets(spec["config"], spec["traffic"], seed,
                                device="cpu")
    assert len(sets) == spec["traffic"]["pool"]
    for x, y in sets:
        for v in (x, y):
            assert v.dtype == np.float32 and v.shape == (4096,)
            assert np.isfinite(v).all()
            e = (v.view(np.uint32) >> 23) & 0xFF
            assert (e >= lo + 127).all() and (e <= hi + 127).all()
        assert not (x == -y).any()
        s = reference.expected("fp_add", x, y)     # raises outside range
        assert (np.abs(s) >= np.finfo(np.float32).tiny).all()


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS[1:])
def test_integer_operands_cover_the_dtype(cell, seed):
    spec = small(cell)
    sets = traffic.operand_sets(spec["config"], spec["traffic"], seed,
                                device="cpu")
    for x, y in sets:
        assert x.dtype == np.uint32 and y.dtype == np.uint32
        assert x.max() > 1 << 31 and x.min() < 1 << 24
    a, b = sets[0][0], sets[1][0]
    assert not np.array_equal(a, b)         # the pool's sets differ


def test_the_same_seed_gives_the_same_operands():
    spec = small("fp32-add-64Mi")
    one = traffic.operand_sets(spec["config"], spec["traffic"], 2 ** 33 + 1,
                               device="cpu")
    two = traffic.operand_sets(spec["config"], spec["traffic"], 2 ** 33 + 1,
                               device="cpu")
    other = traffic.operand_sets(spec["config"], spec["traffic"], 2 ** 33 + 2,
                                 device="cpu")
    for (x1, y1), (x2, y2) in zip(one, two):
        assert np.array_equal(x1.view(np.uint32), x2.view(np.uint32))
        assert np.array_equal(y1.view(np.uint32), y2.view(np.uint32))
    assert not np.array_equal(one[0][0], other[0][0])


def test_the_generator_refuses_what_it_cannot_draw():
    spec = small("fp32-add-64Mi")
    bad = dict(spec["traffic"], operands={"kind": "float",
                                          "exponent_min": -200,
                                          "exponent_max": 0})
    with pytest.raises(ValueError, match="normal range"):
        traffic.operand_sets(spec["config"], bad, 1, device="cpu")
    with pytest.raises(ValueError, match="unknown operand kind"):
        traffic.operand_sets(spec["config"], dict(
            spec["traffic"], operands={"kind": "zipf"}), 1, device="cpu")


def test_known_float_cases():
    f = np.float32
    x = np.array([1.5, 1.0, 1.0, -2.0, 3.0], f)
    y = np.array([0.25, 2.0 ** -24, 3 * 2.0 ** -24, 0.5, -3.0], f)
    want = np.array([1.75, 1.0, 1.0 + 2.0 ** -22, -1.5, 0.0], f)
    got = reference.expected("fp_add", x, y)
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))


def test_known_integer_cases():
    u = np.uint32
    x = np.array([0xFFFFFFFF, 0, 7, 0x80000000], u)
    y = np.array([0xFFFFFFFF, 1, 5, 2], u)
    assert reference.expected("sub", x, y).tolist() == [
        0, 0xFFFFFFFF, 2, 0x7FFFFFFE]
    assert reference.expected("add", x, y).tolist() == [
        0x1FFFFFFFE, 1, 12, 0x80000002]


def test_mismatched_rows():
    want = np.array([1.0, 2.0, -0.0], np.float32)
    assert reference.mismatched_rows(want.copy(), want) == 0
    assert reference.mismatched_rows(np.array([1.0, 2.0, 0.0], np.float32),
                                     want) == 1     # -0 is not +0
    assert reference.mismatched_rows(want.astype(np.float64), want) == 3
    assert reference.mismatched_rows(want[:2], want) == 3
    ints = np.array([2 ** 64 - 1, 5], np.uint64)
    assert reference.mismatched_rows(
        np.array([2 ** 64 - 1, 5], dtype=object), ints) == 0
    assert reference.mismatched_rows(
        np.array([2 ** 64 - 2, 5], dtype=object), ints) == 1
    assert reference.mismatched_rows(np.array([-1, 5], np.int64), ints) == 1
    assert reference.mismatched_rows(np.array([1, 5], np.uint32),
                                     np.array([1, 5], np.uint64)) == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_refused(cell):
    """The control at a size a test run holds: the reference one precision
    step down, in the program's place, mismatches most rows."""
    bad = control.readings(small(cell), 2 ** 31 + 17, "cpu")
    assert min(bad) > 4096 // 2
