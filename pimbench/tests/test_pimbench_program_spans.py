"""The readers of the port's own spans and counters: silent where the port
recorded nothing (or keeps no totals, as a port before these spans), the
right share or ratio from seeded totals and counters, and shares that add
up within the harness's own spans on a traced run of each cell on the
CPU."""

import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from pimbench import bench, cells  # noqa: E402
from repro_torch.runtime import telemetry  # noqa: E402

#: reader -> the span names it sums
SPAN_READERS = {"widen_share": ("frontend.widen",),
                "validate_share": ("frontend.validate",),
                "stage_share": ("run.stage",),
                "pack_share": ("run.pack",),
                "wait_share": ("run.wait",),
                "unpack_share": ("run.unpack", "run.finish"),
                "join_share": ("run.join",)}
COUNTER_READERS = ("staged_bytes_per_row", "model_cycles")
CELLS = cells.cell_names("ufunc")


def _read(name, ctx):
    return cells.metric_reader(name)(ctx)


@pytest.fixture
def fresh(monkeypatch):
    monkeypatch.setattr(telemetry, "TRACER", telemetry.Tracer())
    monkeypatch.setattr(telemetry, "REGISTRY", telemetry.MetricsRegistry())


@pytest.mark.parametrize("name", sorted(SPAN_READERS) + list(COUNTER_READERS))
def test_a_reader_is_silent_with_nothing_recorded(fresh, name):
    assert _read(name, {"window_s": 2.0}) is None


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_is_silent_on_a_port_without_totals(monkeypatch, name):
    monkeypatch.setattr(telemetry, "TRACER", types.SimpleNamespace())
    assert _read(name, {"window_s": 2.0}) is None


@pytest.mark.parametrize("name", sorted(SPAN_READERS))
def test_a_span_reader_gives_its_spans_seconds_over_the_window(
        monkeypatch, name):
    tot = {"frontend.widen": (1, 0.5), "frontend.validate": (2, 0.25),
           "run.stage": (4, 0.125), "run.pack": (4, 0.375),
           "run.wait": (8, 0.0625), "run.unpack": (4, 0.75),
           "run.finish": (1, 0.0078125), "run.join": (1, 0.1875),
           "exec": (4, 9.0)}
    monkeypatch.setattr(telemetry, "TRACER",
                        types.SimpleNamespace(totals=lambda: dict(tot)))
    want = sum(tot[n][1] for n in SPAN_READERS[name]) / 2.0
    assert _read(name, {"window_s": 2.0}) == want
    assert _read(name, {"window_s": 0.0}) is None


def test_unpack_share_reads_either_of_its_spans(monkeypatch):
    monkeypatch.setattr(telemetry, "TRACER", types.SimpleNamespace(
        totals=lambda: {"run.finish": (1, 0.5)}))
    assert _read("unpack_share", {"window_s": 2.0}) == 0.25


def test_counter_readers_give_their_ratios(fresh):
    reg = telemetry.REGISTRY
    reg.add_many({"pim.transfer.h2d_bytes": 64, "pim.transfer.d2h_bytes": 33,
                  "pim.exec.rows": 8, "pim.exec.dispatches": 4,
                  "pim.model.cycles": 4 * 3657})
    assert _read("staged_bytes_per_row", {}) == 97 / 8
    assert _read("model_cycles", {}) == 3657


def test_counter_readers_are_silent_on_a_port_without_transfer_counters(
        fresh):
    """A port that counts dispatches but no copies (the one before these
    counters) gives no bytes a row, and still its modelled cycles."""
    telemetry.REGISTRY.add_many({"pim.exec.rows": 8,
                                 "pim.exec.dispatches": 2,
                                 "pim.model.cycles": 768})
    assert _read("staged_bytes_per_row", {}) is None
    assert _read("model_cycles", {}) == 384


@pytest.mark.parametrize("cell", CELLS)
def test_a_traced_cpu_run_reconciles_with_the_harness_s_spans(fresh, cell):
    """On a traced window of the cell's op on the port's plain version the
    spans are live (the profiler records), their shares add up to no more
    than the harness's span around the same layer, and each metric the
    cell lists reads a value where the plain version has its span (the
    CPU waits on no copy)."""
    spec = cells.load_cell(cell)
    spec["traffic"]["rows_per_call"] = 4096
    state = bench.setup(spec, 2 ** 31 + 11, device="cpu",
                        plan_kw={"device": "cpu", "backend": "ref",
                                 "chunk_rows": 1024})
    assert telemetry.TRACER.totals() == {}      # the warm-up is not traced
    win = bench.window(state, 0.05, trace=True)
    ctx = bench.metric_context(state, win, None, "cpu")
    got = {k: v["value"] for k, v in bench.per_layer(spec, ctx).items()}
    listed = {m["name"] for m in spec["per_layer"]}
    assert set(got) == listed - {"copy_share", "copy_overlap",
                                 "kernel_roofline", "device_idle",
                                 "wait_share"}
    run = win["spans"]["run"] / ctx["window_s"]
    front = win["spans"]["frontend"] / ctx["window_s"]
    assert sum(got.get(k, 0.0) for k in ("stage_share", "pack_share",
                                         "unpack_share", "join_share")) \
        <= run
    assert got.get("widen_share", 0.0) + got.get("validate_share", 0.0) \
        <= front
    want_bytes = {"fp32-add-64Mi": 12.0, "int32-sub-64Mi": 16.0,
                  "int32-add-4Mi": 12.125}[cell]
    assert got["staged_bytes_per_row"] == want_bytes
    program = state["pim"].prepare(state["op"], *state["sets"][0],
                                   **state["kw"])
    from repro_torch.kernels import ops as kops
    r = kops.compiled(program.program, program.plan).resolve(
        program.program, program.plan, tuple(sorted(program.inputs)),
        device="cpu")
    assert got["model_cycles"] == \
        telemetry.COST_MODEL.schedule_cost(r.sched).cycles
