"""A cell's files, found by the names in ``BENCHMARK.json``.

A cell names a configuration and a traffic mix; each lives in a file of its
own, and so does what the cell freezes of the yardstick and each per-layer
metric's reader:

* ``<file>`` of the configuration's entry in ``configs`` (here
  ``pimbench/configs/<config>.json``): the deployment, its sizes and the
  guarantees it states;
* ``pimbench/traffic/<traffic>.json``: the parameters the one generator
  (:mod:`pimbench.traffic`) reads;
* ``pimbench/workloads/<cell>.json``: the cell's frozen operation count,
  bytes a row and the names of its executor kernels (the roofline);
* ``pimbench/metrics/<metric>.py``: a function ``read(ctx)`` that returns
  the metric's value, or None where it finds nothing to read.

So a later change adds a configuration, a traffic mix, a cell or a metric by
adding files and appending to ``BENCHMARK.json``, and edits no file under
``pimbench/``.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Optional

ROOT = Path(__file__).resolve().parents[1]


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def _named(entries, name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise ValueError(f"no {what} named {name!r} in BENCHMARK.json "
                     f"(known: {sorted(e['name'] for e in entries)})")


def _for_cell(metrics, cell: str) -> list:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, root: Path = ROOT) -> dict:
    """Everything one run of cell ``name`` needs, read from its files."""
    root = Path(root)
    bench = load_benchmark(root)
    cell = _named(bench["workloads"], name, "cell")
    config = _named(bench["configs"], cell["config"], "configuration")
    here = root / "pimbench"
    return {
        "name": name,
        "chips": int(cell["chips"]),
        "config": json.loads((root / config["file"]).read_text()),
        "traffic": json.loads(
            (here / "traffic" / f"{cell['traffic']}.json").read_text()),
        "frozen": json.loads(
            (here / "workloads" / f"{name}.json").read_text()),
        "end_to_end": _for_cell(bench["end_to_end"], name),
        "per_layer": _for_cell(bench["per_layer"], name),
        "root": root,
    }


def kind(spec: dict) -> str:
    """The harness branch that runs a cell: ``"lm"`` where its
    configuration says so, else ``"ufunc"``."""
    return spec["config"].get("kind", "ufunc")


def cell_names(of_kind: str, root: Path = ROOT) -> list:
    """The names of the cells of one kind, in ``BENCHMARK.json``'s order."""
    return [w["name"] for w in load_benchmark(root)["workloads"]
            if kind(load_cell(w["name"], root)) == of_kind]


def metric_reader(name: str, root: Path = ROOT) -> Callable[[dict],
                                                           Optional[float]]:
    """The ``read`` function of ``pimbench/metrics/<name>.py``."""
    path = Path(root) / "pimbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "pimbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
