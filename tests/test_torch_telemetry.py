"""The port's tracer and transfer counters (``repro_torch.runtime.telemetry``):
off, a span is the shared null context; under a torch profiler it is a
``record_function`` range on the profiler's clock and adds to running
totals; the host spans of the ufunc path never overlap; the transfer
counters count the staged bytes; the modelled cycles are the resolved
schedule's; the operand check's counters count the rows it scanned.
Everything runs the plain version on the CPU."""

import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import pim_ufunc as pim
from repro_torch.kernels import ops as kops
from repro_torch.kernels import transfer
from repro_torch.runtime import telemetry

CHUNK = 256
CHUNKS = 4
N = CHUNK * CHUNKS
CPU = dict(device="cpu", backend="ref", chunk_rows=CHUNK)

#: The spans the per-layer metrics read; none nests in another.
MEASURED = ("frontend.widen", "frontend.validate", "run.stage", "run.pack",
            "run.wait", "run.unpack", "run.join", "run.finish")


@pytest.fixture
def tracer(monkeypatch):
    """A fresh process tracer and registry, so that counts are this
    test's own."""
    t = telemetry.Tracer()
    monkeypatch.setattr(telemetry, "TRACER", t)
    monkeypatch.setattr(telemetry, "REGISTRY", telemetry.MetricsRegistry())
    return t


def _operands(op, n=N, seed=0):
    rng = np.random.default_rng(seed)
    if op.startswith("fp_"):
        x = rng.uniform(-4, 4, n).astype(np.float32)
        y = rng.uniform(-4, 4, n).astype(np.float32)
        return x, y
    hi = 1 << 32
    return (rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32),
            rng.integers(0, hi, n, dtype=np.uint64).astype(np.uint32))


def _call(op, n=N):
    x, y = _operands(op, n)
    return getattr(pim, op)(x, y, **CPU)


def _warm(*ops):
    """Levelize the programs before a counted call."""
    for op in ops:
        _call(op, 64)


def test_off_a_span_is_the_shared_null_context(tracer):
    assert not tracer.enabled and not tracer.live
    assert tracer.span("run.stage", "pim.host") is telemetry._NULL_SPAN
    _call("fp_add")
    assert tracer.totals() == {} and tracer.drain() == []


def test_a_span_is_live_under_a_profiler_and_while_enabled(tracer):
    with profile(activities=[ProfilerActivity.CPU]):
        assert tracer.live
        assert tracer.span("run.stage") is not telemetry._NULL_SPAN
    assert not tracer.live
    tracer.enabled = True
    assert tracer.live
    with tracer.span("x", "pim.host", on="h2d"):
        pass
    (ev,) = tracer.drain()
    assert (ev["name"], ev["cat"], ev["args"]) == ("x", "pim.host",
                                                  {"on": "h2d"})


def test_spans_are_profiler_ranges_nested_in_the_caller_s(tracer, tmp_path):
    """Under ``torch.profiler`` every span is a ``user_annotation`` event
    inside the caller's ``record_function`` range, and only the totals
    keep it: the ring stays empty while the tracer is not enabled."""
    _warm("fp_add", "add")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("caller"):
            _call("fp_add")
            _call("add")
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("cat") == "user_annotation"]
    (caller,) = [e for e in events if e["name"] == "caller"]
    c0, c1 = caller["ts"], caller["ts"] + caller["dur"]
    names = {}
    for e in events:
        if e["name"] != "caller":
            names[e["name"]] = names.get(e["name"], 0) + 1
            assert c0 <= e["ts"] and e["ts"] + e["dur"] <= c1, e
    assert names == {"frontend.widen": 1, "frontend.validate": 2,
                     "run.stage": CHUNKS, "run.pack": CHUNKS,
                     "run.unpack": 2 * CHUNKS, "run.join": 2,
                     "run.finish": 2}
    assert {n: c for n, (c, _) in tracer.totals().items()} == names
    assert tracer.drain() == []
    assert tracer.totals() == {}


@pytest.mark.parametrize("op, counts", [
    ("fp_add", {"frontend.widen": 1, "frontend.validate": 1,
                "run.stage": CHUNKS, "run.unpack": CHUNKS, "run.join": 1,
                "run.finish": 1}),
    ("sub", {"frontend.validate": 1, "run.stage": CHUNKS,
             "run.unpack": CHUNKS, "run.join": 1, "run.finish": 1}),
    ("add", {"frontend.validate": 1, "run.pack": CHUNKS,
             "run.unpack": CHUNKS, "run.join": 1, "run.finish": 1}),
])
def test_totals_count_each_span_once_a_chunk(tracer, op, counts):
    _warm(op)
    tracer.enabled = True
    _call(op)
    tot = tracer.totals()
    assert {n: c for n, (c, _) in tot.items()} == counts
    assert all(s >= 0 for _, s in tot.values())


@pytest.mark.parametrize("op", ["fp_add", "sub", "add"])
def test_measured_spans_never_overlap(tracer, op):
    """The spans the metrics read never nest, so their shares add up."""
    _warm(op)
    tracer.enabled = True
    _call(op)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"])
                   for e in tracer.drain() if e["cat"] == "pim.host")
    assert {n for _, _, n in spans} <= set(MEASURED)
    assert spans
    for (_, end, a), (start, _, b) in zip(spans, spans[1:]):
        assert end <= start + 0.2, (a, b)       # ts and dur round to 0.1 us


def test_a_wait_on_a_copy_is_a_span_beside_the_unpack(tracer):
    """``Download.result`` waits on its copy's event in a ``run.wait``
    span (``on="d2h"``), before and apart from the caller's own work."""
    class Event:
        waited = 0

        def synchronize(self):
            Event.waited += 1

    tracer.enabled = True
    d = transfer.Download([torch.arange(4, dtype=torch.int32)], Event())
    got = d.result(lambda h: np.array(h))
    assert Event.waited == 1 and got.tolist() == [0, 1, 2, 3]
    (ev,) = tracer.drain()
    assert (ev["name"], ev["cat"], ev["args"]) == ("run.wait", "pim.host",
                                                  {"on": "d2h"})
    tracer.enabled = False
    transfer.Download([torch.zeros(1, dtype=torch.int32)],
                      Event()).result(lambda h: None)
    assert Event.waited == 2 and tracer.totals() == {}


def _staged_bytes(op):
    """The bytes of the staged shapes of ``op``'s chunks: the fused
    branch stages int32[n_ports, rows] in and out, the io branch the
    packed state of the in- and out-ports' cells."""
    x, y = _operands(op)
    p = pim.prepare(op, x, y, **CPU)
    r = kops.compiled(p.program, p.plan).resolve(
        p.program, p.plan, tuple(sorted(p.inputs)), device="cpu")
    if r.fused_ok:
        return 4 * len(r.in_widths) * N, 4 * len(r.out_widths) * N
    wps = p.plan.layout.n_words(CHUNK)
    k_in = sum(r.in_widths)
    return (4 * int(np.prod(p.plan.layout.state_shape(k_in, wps))) * CHUNKS,
            4 * int(np.prod(p.plan.layout.state_shape(r.k_out, wps)))
            * CHUNKS)


#: fp_add: two 32-bit operands in, the sum out; sub: the same in, the
#: difference and its 1-bit ``ge`` port out, each a whole int32; add: the
#: packed 64 cells in and 33 out, 32 rows a word.
@pytest.mark.parametrize("op, per_row", [("fp_add", 12.0), ("sub", 16.0),
                                         ("add", 12.125)])
def test_transfer_counters_count_the_staged_bytes(tracer, op, per_row):
    _warm(op)
    h2d, d2h = _staged_bytes(op)
    telemetry.REGISTRY.drain()
    _call(op)
    c = telemetry.REGISTRY.snapshot()["counters"]
    assert c["pim.transfer.h2d_bytes"] == h2d
    assert c["pim.transfer.d2h_bytes"] == d2h
    assert c["pim.exec.rows"] == N and c["pim.exec.dispatches"] == CHUNKS
    assert (h2d + d2h) / N == per_row


@pytest.mark.parametrize("op", ["fp_add", "sub", "add", "mul"])
def test_model_cycles_are_the_resolved_schedule_s(tracer, op):
    _warm(op)
    telemetry.REGISTRY.drain()
    _call(op)
    x, y = _operands(op)
    p = pim.prepare(op, x, y, **CPU)
    r = kops.compiled(p.program, p.plan).resolve(
        p.program, p.plan, tuple(sorted(p.inputs)), device="cpu")
    c = telemetry.REGISTRY.snapshot()["counters"]
    assert c["pim.model.cycles"] / c["pim.exec.dispatches"] == \
        telemetry.COST_MODEL.schedule_cost(r.sched).cycles
    assert "pim.exec.levels" not in c


def test_the_registry_keeps_counters_and_histograms_only(tracer):
    reg = telemetry.REGISTRY
    reg.inc("pim.a", 2)
    reg.observe("pim.h", 3.0)
    assert set(reg.snapshot()) == {"counters", "histograms"}
    text = telemetry.render_prometheus(reg)
    assert "# TYPE pim_a counter\npim_a 2" in text
    assert "# TYPE pim_h summary" in text and "gauge" not in text
    assert not hasattr(reg, "set_gauge") and \
        not hasattr(reg, "drain_histograms")


def _check_counts():
    c = telemetry.REGISTRY.snapshot()["counters"]
    return (c.get("pim.frontend.check_rows", 0),
            c.get("pim.frontend.check_rows_object", 0))


@pytest.mark.parametrize("op", ["fp_add", "fp_sub", "fp_mul", "fp_div"])
def test_the_check_counts_both_operands_rows(tracer, op):
    x, y = _operands("fp_add")
    pim.prepare(op, x, y, **CPU)
    assert _check_counts() == (2 * N, 0)
    pim.prepare(op, x, y, check=False, **CPU)
    assert _check_counts() == (2 * N, 0)


def test_a_lazy_leaf_counts_its_rows(tracer):
    x, _ = _operands("fp_add")
    pim.lazy(x)
    pim.lazy(x.view(np.uint32), fmt="fp32")
    pim.lazy(x, check=False)
    assert _check_counts() == (2 * N, 0)


@pytest.mark.parametrize("op", ["add", "sub", "mul", "div"])
def test_an_int_ufunc_runs_no_check(tracer, op):
    x, y = _operands(op)
    pim.prepare(op, x, y | np.uint32(1), **CPU)
    assert _check_counts() == (0, 0)


def test_only_object_patterns_take_the_per_element_check(tracer):
    x, y = (v.view(np.uint32) for v in _operands("fp_add"))
    pim.prepare("fp_add", x.astype(np.int64), y, fmt="fp32", **CPU)
    assert _check_counts() == (2 * N, 0)
    pim.prepare("fp_add", x.astype(object), y, fmt="fp32", **CPU)
    assert _check_counts() == (3 * N, N)
