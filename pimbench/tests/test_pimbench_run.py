"""A run end to end at a size a test holds: the harness's look for a card
skipped, the port's plain version on the CPU in the card's place.  A sound
run is correct; a run whose timed path is broken underneath is not, for
each fault a cell of this benchmark can have.  Without a card the command
prints no result and fails; nothing under pimbench/ loads JAX or the
package the port was made from."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pimbench import bench, cells  # noqa: E402

CPU = {"device": "cpu", "backend": "ref", "chunk_rows": 1024}
CELLS = cells.cell_names("ufunc")


def run_on_cpu(cell, seed=2 ** 31 + 3, rows=2048, seconds=0.05,
               broken=None):
    """Set-up, window and check of ``cell`` at ``rows`` rows on the CPU;
    ``broken(pim)`` breaks the timed path after set-up."""
    spec = cells.load_cell(cell)
    spec["traffic"]["rows_per_call"] = rows
    state = bench.setup(spec, seed, device="cpu", plan_kw=CPU)
    if broken is not None:
        broken(state["pim"])
    win = bench.window(state, seconds)
    checks, kept, n_rows = bench.check(state, win)
    return state, win, checks, kept, n_rows


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    state, win, checks, kept, rows = run_on_cpu(cell)
    assert win["calls"] >= 1 and win["failed"] == 0
    assert kept == win["calls"] and rows == kept * 2048
    assert bench.passed(checks)
    assert bench.rows_per_s(state, win) > 0
    line = bench.line(True, win, {"rows_per_s": {"value": 1.0,
                                                 "unit": "rows/s"}},
                      {"platform": "gpu"}, checks)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["checks"] == {"mismatched_rows": {"value": 0, "limit": 0},
                              "failed_calls": {"value": 0, "limit": 0}}
    assert json.loads(json.dumps(line)) == line
    assert bench.check_lines(checks) == [
        "check mismatched_rows: 0 (limit 0)",
        "check failed_calls: 0 (limit 0)"]


def _unchanged(x, y, z):
    """The step returns its state unchanged: the operand comes back."""
    return x.astype(z.dtype) if z.dtype != object else x.astype(object)


def _half(x, y, z):
    """Half of the batch left out: its rows repeat the computed half."""
    n = len(z) // 2
    z = z.copy()
    z[n:2 * n] = z[:n]
    return z


def _altered(x, y, z):
    """One answer altered where it is produced: one row's low bit."""
    z = z.copy()
    if z.dtype.kind == "f":
        z.view(f"u{z.itemsize}")[7] ^= 1
    else:
        z[7] = z[7] ^ 1
    return z


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, monkeypatch):
    op = cells.load_cell(cell)["traffic"]["op"]

    def broken(pim):
        real = getattr(pim, op)
        monkeypatch.setattr(pim, op, lambda x, y, **kw: fault(
            x, y, np.asarray(real(x, y, **kw))))
    _, win, checks, _, _ = run_on_cpu(cell, broken=broken)
    assert not bench.passed(checks)
    assert checks["mismatched_rows"]["value"] >= 1
    assert win["failed"] == 0


def test_a_call_that_raises_is_counted_and_not_correct(monkeypatch):
    def raises(x, y, **kw):
        raise RuntimeError("a broken executor")
    _, win, checks, kept, _ = run_on_cpu(
        "int32-sub-64Mi", seconds=0.01,
        broken=lambda pim: monkeypatch.setattr(pim, "sub", raises))
    assert win["failed"] == win["calls"] >= 1 and kept == 0
    assert "a broken executor" in win["errors"][0]
    assert not bench.passed(checks)


def test_the_sample_of_calls_is_drawn_from_the_seed():
    def kept(seed):
        k = bench.Keeper(3, seed)
        for i in range(50):
            k.offer(i, i % 3, i)
        return sorted(k.kept)
    assert kept(5) == kept(5)
    assert len(kept(5)) == 3 and kept(5) != kept(6)
    assert max(kept(2 ** 40)) > 2


def test_forbidden_modules_are_found_by_whole_top_level_name():
    assert bench.forbidden_modules(["repro_torch.kernels", "reprobe",
                                    "numpy", "torch"]) == []
    assert bench.forbidden_modules(["jax.numpy", "repro.core", "flax",
                                    "jaxlib", "repro_torch"]) == [
        "flax", "jax", "jaxlib", "repro"]


@pytest.fixture
def no_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")


def _run(cwd, *extra):
    return subprocess.run(
        [sys.executable, "pimbench/run.py", "--workload", "fp32-add-64Mi",
         "--seed", "1", "--seconds", "1", "--trace", "0", *extra],
        cwd=cwd, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))


def test_without_a_card_the_run_prints_no_result_and_fails(no_card):
    p = _run(ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def test_the_benchmark_alone_without_the_program_fails(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "pimbench", tmp_path / "pimbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_nothing_under_pimbench_imports_jax_or_the_reference_package():
    files = sorted((ROOT / "pimbench").rglob("*.py"))
    assert files
    for f in files:
        top = set(_imports(f))
        assert not top & set(bench.FORBIDDEN), f
    ref = set(_imports(ROOT / "pimbench" / "reference.py"))
    assert ref == {"__future__", "numpy"}


def test_nothing_under_pimbench_reads_the_jax_benchmarks():
    for f in sorted((ROOT / "pimbench").rglob("*")):
        if "tests" not in f.parts and f.suffix in (".py", ".json"):
            text = f.read_text()
            for word in ("benchmarks/", "BENCH_", "chip_smoke"):
                assert word not in text, (f, word)
