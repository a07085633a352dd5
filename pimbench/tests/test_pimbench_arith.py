"""The yardstick's arithmetic on fixed numbers: roofline bounds, the
timeline's intervals, and each per-layer reader on a made-up window."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from pimbench import cells, roofline, timeline  # noqa: E402

H100 = "NVIDIA H100 80GB HBM3"
FP32_ADD = {"nor_gates": 3719, "rows_per_word": 32, "bytes_per_row": 12,
            "executor_kernels": ["level_kernel"]}


def test_the_h100_peaks():
    p = roofline.peaks(H100)
    assert p["word_ops_per_s"] == pytest.approx(1.672704e13)
    assert p["bytes_per_s"] == 3.35e12
    assert roofline.peaks("some other card") is None
    assert roofline.bound_s(FP32_ADD, 1 << 26, "some other card") is None


@pytest.mark.parametrize("cell, rows, ms, by", [
    ("fp32-add-64Mi", 1 << 26, 0.466269, "operations"),
    ("int32-add-4Mi", 1 << 22, 0.0162764, "bytes"),
    ("int32-sub-64Mi", 1 << 26, 0.240390, "bytes"),
])
def test_each_cells_bound(cell, rows, ms, by):
    frozen = cells.load_cell(cell)["frozen"]
    t, what = roofline.bound_s(frozen, rows, H100)
    assert t * 1e3 == pytest.approx(ms, rel=1e-5) and what == by


def test_call_work_counts_whole_words():
    assert roofline.call_work(FP32_ADD, 33) == (2 * 3719, 33 * 12)
    assert roofline.call_work(FP32_ADD, 32) == (3719, 32 * 12)


def test_intervals_merge_overlap_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0)]
    assert timeline.merged(iv) == [[0.0, 2.0], [3.0, 4.0]]
    assert timeline.total(iv) == 3.0
    assert timeline.overlap([(1.5, 3.5)], iv) == pytest.approx(1.0)
    assert timeline.overlap([(4.5, 5.0)], iv) == 0.0
    assert timeline.gaps(iv, (0.0, 5.0)) == [(2.0, 3.0), (4.0, 5.0)]


def _ev(cat, name, s_us, dur_us):
    return {"ph": "X", "cat": cat, "name": name, "ts": s_us, "dur": dur_us}


def made_up_trace():
    """A 10 s window: two calls, each 4 s of frontend then 1 s of run, in
    which a 0.2 s H2D copy (half under a kernel), a 0.3 s kernel and a
    0.1 s D2H copy run; one kernel outside the window."""
    ev = [_ev("user_annotation", timeline.WINDOW, 0, 10e6),
          _ev("kernel", "void ring::level_kernel<4>(...)", -1e6, 0.5e6)]
    for c in range(2):
        t = c * 5e6
        ev += [_ev("user_annotation", "pimbench.frontend", t, 4e6),
               _ev("user_annotation", "pimbench.run", t + 4e6, 1e6),
               _ev("gpu_memcpy", "Memcpy HtoD (Pinned -> Device)",
                   t + 4.1e6, 0.2e6),
               _ev("kernel", "void ring::level_kernel<4>(...)",
                   t + 4.2e6, 0.3e6),
               _ev("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)",
                   t + 4.6e6, 0.1e6)]
    return ev


def test_timeline_of_a_made_up_trace():
    tl = timeline.timeline(made_up_trace())
    assert timeline.window_s(tl) == pytest.approx(10.0)
    assert timeline.busy_s(tl) == pytest.approx(2 * 0.5)
    assert len(tl["kernels"]) == 2          # the one outside is clipped
    top = timeline.top_device_ops(tl)
    assert top[0][0].startswith("void ring::level_kernel")
    assert top[0][1] == pytest.approx(0.6)
    gaps = timeline.idle_gaps(tl)
    assert [g[0] for g in gaps] == ["frontend", "frontend", "run", "run",
                                    "run"]
    assert [round(g[1], 6) for g in gaps] == [4.4, 4.1, 0.3, 0.1, 0.1]


def test_no_window_or_no_device_activity_reads_nothing():
    assert timeline.timeline([]) is None
    only_host = [e for e in made_up_trace()
                 if e["cat"] == "user_annotation"]
    assert timeline.timeline(only_host) is None


def _ctx(tl, kind=H100):
    return {"window_s": 10.0, "spans": {"frontend": 8.0, "run": 2.0},
            "calls": 2, "rows": 1 << 26, "frozen": FP32_ADD,
            "timeline": tl, "device_kind": kind}


def _read(name, ctx):
    return cells.metric_reader(name)(ctx)


def test_each_reader_on_the_made_up_window():
    ctx = _ctx(timeline.timeline(made_up_trace()))
    assert _read("frontend_share", ctx) == pytest.approx(0.8)
    assert _read("run_share", ctx) == pytest.approx(0.2)
    assert _read("copy_share", ctx) == pytest.approx(0.06)
    assert _read("copy_overlap", ctx) == pytest.approx(0.5)
    assert _read("device_idle", ctx) == pytest.approx(1 - 0.1)
    # 2 calls x 0.466269 ms of bound over 2 x 300 ms of the kernel
    assert _read("kernel_roofline", ctx) == pytest.approx(
        100 * 0.466269e-3 / 0.3, rel=1e-5)


def test_device_readers_are_silent_without_a_trace_or_peaks():
    ctx = _ctx(None)
    for name in ("copy_share", "copy_overlap", "device_idle",
                 "kernel_roofline"):
        assert _read(name, ctx) is None
    ctx = _ctx(timeline.timeline(made_up_trace()), kind="another card")
    assert _read("kernel_roofline", ctx) is None
    ctx = _ctx(timeline.timeline(made_up_trace()))
    ctx["frozen"] = dict(FP32_ADD, executor_kernels=["no_such_kernel"])
    assert _read("kernel_roofline", ctx) is None
