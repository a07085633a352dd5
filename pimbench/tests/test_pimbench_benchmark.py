"""BENCHMARK.json keeps to its contract, and a cell, its configuration,
traffic and per-layer metrics are found by name from files of their own."""

import json
import re
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pimbench import cells  # noqa: E402

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def assert_top_level_keys_and_command(root):
    bench = cells.load_benchmark(root)
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["pimbench"]
    assert len(bench["command"]) <= 32
    assert all(_line(w) for w in bench["command"])
    assert (root / bench["command"][1]).is_file()
    assert len((root / "BENCHMARK.json").read_bytes()) <= 64 << 10


def assert_run_seconds_fits_a_full_check_of_24_cells(root):
    rs = cells.load_benchmark(root)["run_seconds"]
    assert 1 <= rs <= 51 and isinstance(rs, int)
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def assert_entries_have_the_contract_keys_and_names(root):
    bench = cells.load_benchmark(root)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and \
            _line(c["why"])
        assert c["file"].startswith("pimbench/")
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    assert len({c["file"] for c in bench["configs"]}) == len(bench["configs"])
    assert len({c["source"] for c in bench["configs"]}) == \
        len(bench["configs"])
    pairs = set()
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(bench["workloads"])
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in bench["end_to_end"]}[
        "setup_s"] == 0.25
    e2e = {m["name"] for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= {w["name"] for w in bench["workloads"]}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def assert_a_cell_is_found_by_name_from_its_files(cell, root):
    spec = cells.load_cell(cell, root)
    assert spec["name"] == cell and spec["chips"] == 1
    if cells.kind(spec) == "ufunc":
        assert spec["traffic"]["op"] in ("fp_add", "add", "sub")
        assert spec["config"]["rows"] >= spec["traffic"]["rows_per_call"]
        assert {"nor_gates", "rows_per_word", "bytes_per_row",
                "executor_kernels"} <= set(spec["frozen"])
    else:
        assert cells.kind(spec) == "lm"
        assert spec["traffic"]["kind"] == "decode"
        assert (root / spec["config"]["reference"]).is_file()
        assert {"flops_per_step", "flops_per_context", "bytes_per_step",
                "bytes_per_context"} <= set(spec["frozen"])
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert spec["per_layer"]
    for m in spec["per_layer"]:
        assert callable(cells.metric_reader(m["name"], root))


def assert_the_contract(root):
    """Every check above, on the benchmark at ``root``."""
    assert_top_level_keys_and_command(root)
    assert_run_seconds_fits_a_full_check_of_24_cells(root)
    assert_entries_have_the_contract_keys_and_names(root)
    for w in cells.load_benchmark(root)["workloads"]:
        assert_a_cell_is_found_by_name_from_its_files(w["name"], root)


def test_top_level_keys_and_command():
    assert_top_level_keys_and_command(ROOT)


def test_run_seconds_fits_a_full_check_of_24_cells():
    assert_run_seconds_fits_a_full_check_of_24_cells(ROOT)


def test_entries_have_the_contract_keys_and_names():
    assert_entries_have_the_contract_keys_and_names(ROOT)


@pytest.mark.parametrize("cell", CELLS)
def test_a_cell_is_found_by_name_from_its_files(cell):
    assert_a_cell_is_found_by_name_from_its_files(cell, ROOT)


def test_an_unknown_cell_is_refused():
    with pytest.raises(ValueError, match="no cell named"):
        cells.load_cell("no-such-cell")


def test_a_later_cell_is_added_by_files_alone(tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric are new
    files and new entries; no file of the harness changes."""
    shutil.copytree(ROOT / "pimbench", tmp_path / "pimbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    bench["configs"].append(dict(bench["configs"][1], name="fig9-int16",
                                 file="pimbench/configs/fig9-int16.json"))
    bench["workloads"].append({"name": "int16-add-1Mi",
                               "config": "fig9-int16", "traffic": "add.1Mi",
                               "chips": 1, "why": "a later cell"})
    bench["per_layer"].append({"name": "calls_in_window", "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "frontend", "moves": "rows_per_s",
                               "workloads": ["int16-add-1Mi"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    here = tmp_path / "pimbench"
    (here / "configs" / "fig9-int16.json").write_text(json.dumps(
        {"rows": 1 << 20, "dtype": "uint16", "parallel": False,
         "shards": 1}))
    (here / "traffic" / "add.1Mi.json").write_text(json.dumps(
        {"op": "add", "rows_per_call": 1 << 20, "pool": 2,
         "operands": {"kind": "uniform"}}))
    (here / "workloads" / "int16-add-1Mi.json").write_text(json.dumps(
        {"nor_gates": 1, "rows_per_word": 32, "bytes_per_row": 8,
         "executor_kernels": ["level_kernel"]}))
    (here / "metrics" / "calls_in_window.py").write_text(
        "def read(ctx):\n    return ctx['calls']\n")
    spec = cells.load_cell("int16-add-1Mi", tmp_path)
    assert spec["config"]["dtype"] == "uint16"
    assert [m["name"] for m in spec["per_layer"]] == ["calls_in_window"]
    assert cells.metric_reader("calls_in_window", tmp_path)(
        {"calls": 7}) == 7
    # the metrics listed for other cells do not leak into this one
    assert "frontend_share" not in {m["name"] for m in spec["per_layer"]}
