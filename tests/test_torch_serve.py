"""Batched PIM serving in the port (``runtime.pim_batch``,
``runtime.fault_tolerance``, ``launch.serve``), held against ``repro`` on
the CPU.

Each scenario runs through both packages -- ``repro`` on its ``ref``
backend, the port on ``device="cpu", backend="ref"`` -- with inputs from a
seeded numpy generator: per-request results (``np.array_equal``, the
executors are exact), the planner's groups, the runtime's counters, the
JSON-lines responses less their timing fields, the error bodies, the
breakers' transitions and, under injected faults, ``HEALTH`` must be
equal.  Then what only the port has: the trace file's spans, liveness
counters, deadlines and its CLI with ``--pim-device cpu``.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from _fault_parity import (PORT, REF, both,  # noqa: F401
                           both_packages_clean, same)
from repro.launch import serve as rserve
from repro.runtime import fault_tolerance as rft
from repro.runtime import pim_batch as rpb
from repro.runtime.faults import FaultModel, VerifyPolicy
from repro_torch.launch import serve as tserve
from repro_torch.runtime import fault_tolerance as tft
from repro_torch.runtime import pim_batch as tpb
from repro_torch.runtime import telemetry as ttelemetry
# the reference suite's request streams
from test_pim_batch import _BAD_LINES, _fp16, _mixed_traffic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: Each package's serving modules.
SERVE = {REF.name: SimpleNamespace(serve=rserve, pb=rpb),
         PORT.name: SimpleNamespace(serve=tserve, pb=tpb)}

#: Response fields that carry the wall clock.
TIMING = ("us", "queue_us", "exec_us", "compile_us")


def _cpu(pkg, **kw):
    """``pkg``'s scoped options on its CPU backend, fault options carried
    over to its own types."""
    return pkg.pim.options(**pkg.cpu, **{k: pkg.carry(v)
                                        for k, v in kw.items()})


def _untimed(resp: dict) -> dict:
    return {k: v for k, v in resp.items() if k not in TIMING}


STAT_FIELDS = ("requests", "batches", "groups", "rows", "errors",
               "degraded_groups", "shed_requests", "fused_programs",
               "retries", "faults_detected", "faults_corrected",
               "remapped_rows", "breaker_trips", "breaker_probes",
               "breaker_closes")


def _stats(rt) -> dict:
    return {k: getattr(rt.stats, k) for k in STAT_FIELDS}


def _result(r) -> tuple:
    return (r.value, r.group_rows, r.group_size, r.batch_rows, r.degraded,
            r.shed, r.error, r.health)


# ------------------------------------------------------------ mixed traffic

@pytest.mark.parametrize("seed,n_requests", [(42, 32), (7, 17)])
def test_mixed_traffic_matches_reference(seed, n_requests):
    """One coalesced batch of the mixed stream: the groups (members, rows,
    arrival order), every request's result -- equal to its own serial
    run -- and the runtime's counters are the reference's."""
    traffic = _mixed_traffic(np.random.default_rng(seed), n_requests)

    def scenario(pkg):
        with _cpu(pkg):
            preps = [pkg.pim.prepare(op, x, y, **kw)
                     for op, x, y, kw in traffic]
        pb = SERVE[pkg.name].pb
        plan = pb.plan_groups(preps)
        rt = pb.BatchRuntime(pin_cap=8)
        try:
            results = rt.execute(preps)
            serial = [p.run() for p in preps]
        finally:
            rt.close()
        assert len(rt.pins) == 0
        for r, want in zip(results, serial):
            assert same(r.value, want)
        return ([(g.members, g.n_rows) for g in plan],
                [_result(r) for r in results], _stats(rt))

    _, _ = both(scenario)


def test_group_keys_separate_exec_config_like_reference():
    """Requests that differ only in schedule, layout or backend share a
    program hash but never a group, in both packages."""
    x, y = np.uint8([1, 2]), np.uint8([2, 3])

    def scenario(pkg):
        with _cpu(pkg):
            ps = [pkg.pim.prepare("add", x, y),
                  pkg.pim.prepare("add", x, y, schedule="dense"),
                  pkg.pim.prepare("add", x, y, schedule="slots-static"),
                  pkg.pim.prepare("add", x, y, layout="rows64"),
                  pkg.pim.prepare("add", x, y, backend="numpy"),
                  pkg.pim.prepare("add", x[::-1], y)]
        assert len({p.key for p in ps}) == 1
        plan = SERVE[pkg.name].pb.plan_groups(ps)
        rt = SERVE[pkg.name].pb.BatchRuntime()
        try:
            rs = rt.execute(ps)
        finally:
            rt.close()
        return [g.members for g in plan], [r.value for r in rs]

    (members, values), _ = both(scenario)
    assert members == [[0, 5], [1], [2], [3], [4]]


# ------------------------------------------------------------- the protocol

def _mixed_lines(seed: int = 3, n: int = 6) -> str:
    """A stream over the eight programs, a width-70 add, the dense,
    slots-static and rows64 plans, bf16 bit patterns, a fused expression
    and malformed lines."""
    rng = np.random.default_rng(seed)

    def ints(hi, lo=0):
        return [int(v) for v in rng.integers(lo, hi, n, dtype=np.uint64)]

    def f16():
        return [float(v) for v in _fp16(rng, n)]

    reqs = [{"op": op, "dtype": "uint16", "x": ints(1 << 16),
             "y": ints(1 << 16, 1 if op == "div" else 0)}
            for op in ("add", "sub", "mul", "div")]
    reqs += [{"op": op, "dtype": "float16", "x": f16(), "y": f16()}
             for op in ("fp_add", "fp_sub", "fp_mul", "fp_div")]
    reqs += [{"op": "add", "dtype": "uint64", "width": 70,
              "x": ints(1 << 64), "y": ints(1 << 64)},
             {"op": "add", "dtype": "uint16", "x": ints(1 << 16),
              "y": ints(1 << 16), "schedule": "dense"},
             {"op": "fp_add", "dtype": "float16", "x": f16(), "y": f16(),
              "schedule": "slots-static"},
             {"op": "mul", "dtype": "uint16", "x": ints(1 << 16),
              "y": ints(1 << 16), "layout": "rows64"},
             {"op": "fp_mul", "fmt": "bf16", "x": [0x3F80, 0x4000],
              "y": [0x4040, 0xBF80]},
             {"op": "expr", "dtype": "float16",
              "expr": ["fp_add", ["fp_mul", "a", "b"], "c"],
              "inputs": {"a": f16(), "b": f16(), "c": f16()}},
             {"op": "add", "dtype": "uint16", "x": ints(1 << 16),
              "y": ints(1 << 16)}]
    lines = [json.dumps(r) for r in reqs]
    lines.insert(3, "{broken")
    lines.insert(9, json.dumps({"op": "expr", "expr": ["div", "a", "a"],
                                "inputs": {"a": [1]}}))
    return "\n".join(lines) + "\n"


def _serve_lines(pkg, mode: str, text: str, **kw):
    """Run one serving mode of ``pkg`` over ``text`` on its CPU backend,
    from an empty compiled-program cache (so ``cached`` flags compare);
    returns (the untimed responses, what the call returned)."""
    s = SERVE[pkg.name].serve
    pkg.ops.clear_compiled_cache()
    outp = io.StringIO()
    with _cpu(pkg, **kw):
        if mode == "stdin":
            info = s.serve_pim_stdin(io.StringIO(text), outp)
        elif mode == "batched":
            # one batch: the window outlasts the reader, which closes the
            # batch at the end of the stream
            info = s.serve_pim_batched(io.StringIO(text), outp,
                                       window_ms=60000, stats=False)
        else:
            outs = []
            for line in text.splitlines():
                if line.strip():
                    try:
                        req = json.loads(line)
                    except json.JSONDecodeError:
                        continue
                    outs.append(s.pim_request(req))
            return [_untimed(r) for r in outs], len(outs)
    return [_untimed(json.loads(l)) for l in
            outp.getvalue().splitlines()], info


@pytest.mark.parametrize("mode", ["stdin", "batched", "request"])
@pytest.mark.parametrize("stream", ["bad_lines", "mixed"])
def test_protocol_matches_reference(mode, stream):
    """``serve_pim_stdin``, ``serve_pim_batched`` and ``pim_request``
    answer the reference's malformed lines and a mixed stream with the
    reference's responses (results, ``cached``, ``batched``,
    ``fused_ops``, error bodies), less their timing fields."""
    text = _BAD_LINES if stream == "bad_lines" else _mixed_lines()

    def scenario(pkg):
        lines, info = _serve_lines(pkg, mode, text)
        if isinstance(info, dict):
            info = {k: v for k, v in info.items() if k != "rows_per_s"}
        return lines, info

    (lines, info), _ = both(scenario)
    n_lines = sum(1 for l in text.splitlines() if l.strip())
    assert len(lines) == n_lines - (mode == "request") * 1
    if stream == "bad_lines" and mode != "request":
        assert lines[0]["result"] == [4, 6] and \
            lines[1]["error"]["code"] == "bad_json"
        assert (lines[7]["q"], lines[7]["r"]) == ([3], [2])
    if mode == "batched":
        assert info["batches"] == 1 and info["degraded_groups"] == 0


# ---------------------------------------------------- queue and breakers

def _queue_row_cap(pb):
    q = pb.BatchQueue(window_ms=200, max_batch_rows=100)
    for i in range(5):
        q.put(i, n_rows=30)
    q.close()
    return [q.collect(), q.collect(), q.collect(), q.collect()]


def _queue_zero_window(pb):
    q = pb.BatchQueue(window_ms=0, max_batch_rows=1 << 30)
    for i in range(3):
        q.put(i, n_rows=1)
    out = [q.collect()]
    q.close()
    out.append(q.collect())
    for kw in ({"max_batch_rows": 0}, {"max_queue_rows": 0}):
        with pytest.raises(ValueError):
            pb.BatchQueue(**kw)
    return out


def _queue_backpressure(pb):
    q = pb.BatchQueue(window_ms=0, max_queue_rows=16)
    out = [q.offer("a", 8), q.offer("b", 8), q.offer("c", 8), q.collect(),
           q.offer("big", 100)]
    q.close()
    return out + [q.collect(), q.collect()]


@pytest.mark.parametrize("case", [_queue_row_cap, _queue_zero_window,
                                  _queue_backpressure],
                         ids=["row_cap", "zero_window", "backpressure"])
def test_batch_queue_matches_reference(case):
    got = case(tpb)
    assert got == case(rpb)
    assert got[0] in ([0, 1, 2, 3], [0, 1, 2], True)


def _breaker_trace(pb, policy_kw, events):
    br = pb.CircuitBreaker(pb.BreakerPolicy(**policy_kw))
    out = []
    for ev in events:
        if ev[0] == "admit":
            out.append(br.admit(ev[1]))
        else:
            out.append(br.record(ev[1], ev[2], probe=ev[3]))
        out.append(br.state)
    return out


#: (policy, events) on an injected clock: ("admit", now) or
#: ("record", ok, now, probe).
BREAKER_CASES = {
    "trip_shed_probe_close": (
        dict(window=8, trip_failures=3, cooldown_s=0.05, probes=2),
        [("admit", 0.0), ("record", False, 0.0, False),
         ("record", False, 0.0, False), ("record", False, 0.0, False),
         ("admit", 0.01), ("record", False, 0.02, False), ("admit", 0.06),
         ("admit", 0.06), ("admit", 0.06), ("record", True, 0.07, True),
         ("record", True, 0.07, True), ("admit", 0.08)]),
    "failed_probe_retrips": (
        dict(window=4, trip_failures=2, cooldown_s=1.0, probes=1),
        [("record", False, 0.0, False), ("record", True, 0.1, False),
         ("record", False, 0.2, False), ("admit", 0.5), ("admit", 1.3),
         ("record", False, 1.4, True), ("admit", 1.5), ("admit", 2.5)]),
    "window_slides": (
        dict(window=3, trip_failures=2, cooldown_s=0.0, probes=1),
        [("record", False, 0.0, False), ("record", True, 0.0, False),
         ("record", True, 0.0, False), ("record", True, 0.0, False),
         ("record", False, 0.0, False), ("admit", 0.0)]),
}


@pytest.mark.parametrize("name", sorted(BREAKER_CASES))
def test_breaker_state_machine_matches_reference(name):
    policy, events = BREAKER_CASES[name]
    got = _breaker_trace(tpb, policy, events)
    assert got == _breaker_trace(rpb, policy, events)
    assert "open" in got or name == "window_slides"


@pytest.mark.parametrize("bad", [dict(window=0), dict(trip_failures=0),
                                 dict(probes=0), dict(cooldown_s=-1.0)])
def test_breaker_policy_validation_like_reference(bad):
    for pb in (rpb, tpb):
        with pytest.raises(ValueError):
            pb.BreakerPolicy(**bad)


def _errors(pkg) -> list:
    f = pkg.faults
    return [ValueError("x"), KeyError("k"), OverflowError("o"),
            f.DeadlineExceeded("late"), f.FaultError("bare"),
            f.FaultError("exhausted", program_key="ab12ef", attempts=3,
                         remapped_base=None),
            RuntimeError("device fault")]


def test_classify_error_matches_reference():
    """The wire-format error bodies, with the fault context."""
    got = [tpb.classify_error(e) for e in _errors(PORT)]
    assert got == [rpb.classify_error(e) for e in _errors(REF)]
    assert got[5]["error"]["fault"] == {"program_key": "ab12ef",
                                        "attempts": 3}


def test_classify_error_sends_cuda_errors_to_internal():
    """A CUDA launch error (a ``RuntimeError``) and an out-of-memory on
    the card are ``internal`` and retriable, never a bad request."""
    for e in (RuntimeError("CUDA error: an illegal memory access was "
                           "encountered"),
              torch.cuda.OutOfMemoryError("CUDA out of memory")):
        body = tpb.classify_error(e)["error"]
        assert body["code"] == "internal" and body["retriable"] is True


def _doomed_prep(pkg, x, y, faulty=True):
    """A Prepared whose primary-path execution always fails (p_flip=1.0
    with one retry) -- or its healthy same-family counterpart."""
    kw = {"faults": FaultModel(seed=3, p_flip=1.0),
          "verify": VerifyPolicy(max_retries=1, remap_after=99,
                                 backoff_s=1e-6)} if faulty else {}
    with _cpu(pkg, **kw):
        return pkg.pim.prepare("add", x, y)


def test_breaker_trips_sheds_and_recovers_like_reference():
    """Sustained retriable failures trip the family's breaker; its next
    request is shed to the numpy oracle (correct, ``degraded+shed``,
    counted); after the cooldown a probe closes it -- with the
    reference's results, error bodies and counters."""
    x = np.arange(64, dtype=np.uint16)
    y = x[::-1].copy()

    def scenario(pkg):
        pb = SERVE[pkg.name].pb
        rt = pb.BatchRuntime(breaker=pb.BreakerPolicy(
            window=8, trip_failures=3, cooldown_s=0.5, probes=1))
        out = [_result(rt.execute([_doomed_prep(pkg, x, y)])[0])
               for _ in range(3)]
        fam = _doomed_prep(pkg, x, y).key
        out.append(rt.breakers[fam].state)
        out.append(_result(rt.execute([_doomed_prep(pkg, x, y)])[0]))
        time.sleep(0.55)
        out.append(_result(rt.execute([_doomed_prep(pkg, x, y, False)])[0]))
        out.append(rt.breakers[fam].state)
        rt.close()
        return out, _stats(rt)

    (out, st), _ = both(scenario)
    assert out[3] == "open" and out[-1] == "closed"
    assert out[4][5] and out[4][6] is None          # shed, answered
    assert st["shed_requests"] == 1 and st["breaker_trips"] == 1 and \
        st["breaker_closes"] == 1


def test_record_expired_and_disabled_breakers_like_reference():
    x = np.arange(8, dtype=np.uint8)

    def scenario(pkg):
        pb = SERVE[pkg.name].pb
        rt = pb.BatchRuntime(breaker=pb.BreakerPolicy(trip_failures=2,
                                                      cooldown_s=9.0))
        p = _doomed_prep(pkg, x, x, faulty=False)
        rt.record_expired(p)
        rt.record_expired(p)
        shed = _result(rt.execute([_doomed_prep(pkg, x, x, False)])[0])
        off = pb.BatchRuntime(breaker=None)
        failed = [_result(off.execute([_doomed_prep(pkg, x, x)])[0])
                  for _ in range(5)]
        off.record_expired(p)
        rt.close()
        off.close()
        return shed, failed, _stats(rt), _stats(off), len(off.breakers)

    (shed, failed, st, st_off, n_off), _ = both(scenario)
    assert shed[5] and st["breaker_trips"] == 1
    assert all(f[6]["code"] == "exec_failed" for f in failed)
    assert st_off["shed_requests"] == 0 and n_off == 0


def _on_the_card(prep):
    """``prep`` with its plan moved to the card (``backend="cuda"``), for
    runs whose executor calls the test replaces."""
    return dataclasses.replace(prep, plan=dataclasses.replace(
        prep.plan, backend=tpb.kops.BACKENDS["cuda"], device="cuda"))


def _no_oracle(monkeypatch):
    """Make any run on the host's numpy oracle fail the test."""
    real = tpb.kops.run_program

    def run_program(program, inputs, n_rows, plan=None, **kwargs):
        if plan is not None and plan.backend.name == "numpy":
            raise AssertionError("a request was answered on the numpy "
                                 "oracle")
        return real(program, inputs, n_rows, plan, **kwargs)
    monkeypatch.setattr(tpb.kops, "run_program", run_program)


def test_cuda_errors_never_trip_a_breaker_or_shed(monkeypatch):
    """A request planned on the card whose launch raises a CUDA error
    (``RuntimeError``) is answered as an ``internal`` error, batch after
    batch: its family's breaker never trips and nothing is shed to the
    host."""
    def launch_fails(*args, **kwargs):
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")
    monkeypatch.setattr(tpb.kops, "run_program_groups", launch_fails)
    monkeypatch.setattr(tpb.kops, "run_program_streaming", launch_fails)
    _no_oracle(monkeypatch)
    x = np.arange(64, dtype=np.uint16)
    with _cpu(PORT):
        prep = _on_the_card(PORT.pim.prepare("add", x, x))
    rt = tpb.BatchRuntime(breaker=tpb.BreakerPolicy(
        window=8, trip_failures=2, cooldown_s=9.0, probes=1))
    results = [rt.execute([prep])[0] for _ in range(6)]
    rt.close()
    assert all(r.error["code"] == "internal" and r.degraded and not r.shed
               for r in results)
    assert rt.stats.shed_requests == 0 and rt.stats.breaker_trips == 0
    assert rt.breakers[prep.key].state == "closed"


def test_a_tripped_family_on_the_card_sheds_on_its_own_card(monkeypatch):
    """Faults that exhaust their retries trip a card-planned family's
    breaker; its next request is shed on its own plan, still on the card,
    without the fault model and the verify policy -- never on the host's
    numpy oracle -- and answered right."""
    real = tpb.kops.run_program_streaming
    x = np.arange(64, dtype=np.uint16)
    y = x[::-1].copy()
    with _cpu(PORT):
        cpu_plan = PORT.pim.prepare("add", x, y).plan
    plans = []

    def groups_fail(specs):
        raise PORT.faults.FaultError("exhausted", attempts=2)

    def streaming(program, inputs, n_rows, plan, deadline=None):
        plans.append(plan)
        if plan.faults is not None:
            raise PORT.faults.FaultError("exhausted", attempts=2)
        return real(program, inputs, n_rows, cpu_plan, deadline=deadline)

    monkeypatch.setattr(tpb.kops, "run_program_groups", groups_fail)
    monkeypatch.setattr(tpb.kops, "run_program_streaming", streaming)
    _no_oracle(monkeypatch)
    with _cpu(PORT, faults=FaultModel(seed=3, p_flip=1.0),
              verify=VerifyPolicy(max_retries=1)):
        prep = _on_the_card(PORT.pim.prepare("add", x, y))
    rt = tpb.BatchRuntime(breaker=tpb.BreakerPolicy(
        window=8, trip_failures=2, cooldown_s=9.0, probes=1))
    failed = [rt.execute([prep])[0] for _ in range(2)]
    shed = rt.execute([prep])[0]
    rt.close()
    assert all(r.error["code"] == "exec_failed" for r in failed)
    assert rt.breakers[prep.key].state == "open"
    assert shed.shed and shed.error is None
    assert np.array_equal(shed.value, x.astype(np.uint64) + y)
    assert rt.stats.shed_requests == 1 and rt.stats.breaker_trips == 1
    assert plans[-1].backend.name == "cuda" and plans[-1].device == "cuda"
    assert plans[-1].faults is None and plans[-1].verify is None


def test_fp16_underflow_is_a_signed_zero_like_reference():
    """The serving mix's fp16 operands have mid-range exponents (10 to
    20); the difference of two close ones can fall below the normal
    range.  The reference's gate netlist gives such a result as a zero of
    its sign, and so does the port: that is numpy's answer as the card's
    check of the mix holds it (numpy's subnormal flushed to a signed
    zero)."""
    rng = np.random.default_rng(5)
    n = 256
    a = (np.uint16(10 << 10) | rng.integers(0, 1 << 10, n).astype(
        np.uint16))
    b = np.clip(a.astype(np.int32) + rng.choice([-1, 1], n), 10 << 10,
                (11 << 10) - 1).astype(np.uint16)
    half = n // 2                 # the rest drawn as the mix draws them
    a[half:] = (rng.integers(10, 21, n - half).astype(np.uint16) << 10 |
                rng.integers(0, 1 << 10, n - half).astype(np.uint16))
    b[half:] = (rng.integers(10, 21, n - half).astype(np.uint16) << 10 |
                rng.integers(0, 1 << 10, n - half).astype(np.uint16))
    a[:half:2] |= np.uint16(0x8000)          # both signs of the result
    b[:half:2] |= np.uint16(0x8000)
    x, y = a.view(np.float16), b.view(np.float16)
    want = (x - y).view(np.uint16).copy()
    under = ((want & 0x7C00) == 0) & ((want & 0x3FF) != 0)
    assert under.sum() > 8 and (want[under] & 0x8000).any() and \
        not (want[under] & 0x8000).all()
    want[(want & 0x7C00) == 0] &= np.uint16(0x8000)
    got = {pkg.name: np.asarray(pkg.pim.fp_sub(x, y, **pkg.cpu))
           for pkg in (REF, PORT)}
    for v in got.values():
        assert v.dtype == np.float16
        assert np.array_equal(v.view(np.uint16), want)


# --------------------------------------------------------- verified serving

def test_verified_faulty_mix_matches_reference():
    """The mixed stream under transient flips at the reference's
    acceptance rate and ``verify=True`` (its ``serve/mixed_8op_faulty``):
    bit-exact results, equal to the fault-free run, with the reference's
    ``HEALTH`` on each result and in the counters."""
    traffic = _mixed_traffic(np.random.default_rng(11), 16)
    fm = FaultModel(seed=7, p_flip=5e-4)

    def scenario(pkg):
        with _cpu(pkg, faults=fm, verify=True):
            preps = [pkg.pim.prepare(op, x, y, **kw)
                     for op, x, y, kw in traffic]
        with _cpu(pkg):
            clean = [pkg.pim.prepare(op, x, y, **kw).run()
                     for op, x, y, kw in traffic]
        rt = SERVE[pkg.name].pb.BatchRuntime()
        try:
            results = rt.execute(preps)
        finally:
            rt.close()
        for r, want in zip(results, clean):
            assert r.error is None and same(r.value, want)
        return [_result(r) for r in results], _stats(rt)

    (results, st), _ = both(scenario)
    assert st["retries"] > 0 and st["faults_corrected"] > 0
    assert st["degraded_groups"] == 0 and st["shed_requests"] == 0


@pytest.mark.parametrize("case", ["forced_flip", "doomed_group",
                                  "poisoned_member"])
def test_verified_serving_paths_match_reference(case):
    """A forced flip corrected through the JSON-lines server; a group
    whose faults exhaust its retries degrading alone; a member that cannot
    be packed costing only its own response."""
    x = np.arange(50, dtype=np.uint16)
    y = x[::-1].copy()

    def scenario(pkg):
        s, pb = SERVE[pkg.name].serve, SERVE[pkg.name].pb
        if case == "forced_flip":
            line = json.dumps({"op": "add", "dtype": "uint16",
                               "x": [10, 20], "y": [30, 40]})
            with _cpu(pkg, faults=FaultModel(seed=4, force_flips=((0, 3),)),
                      verify=True):
                outp = io.StringIO()
                info = s.serve_pim_batched(io.StringIO(line + "\n"), outp,
                                           window_ms=0, stats=False)
            info.pop("rows_per_s")
            # the scrubber thread's passes count wall time, not work
            info["media"].pop("scrub_passes", None)
            return _untimed(json.loads(outp.getvalue())), info
        rt = pb.BatchRuntime(pin_cap=4)
        with _cpu(pkg):
            good = pkg.pim.prepare("add", x, y)
            other = pkg.pim.prepare("mul", x[:8], y[:8])
        if case == "doomed_group":
            with _cpu(pkg, faults=FaultModel(seed=2, p_flip=1.0),
                      verify=True):
                bad = pkg.pim.prepare("add", x[:10], y[:10])
        else:
            with _cpu(pkg):
                bad = pkg.pim.prepare("add", x, y)
            bad.inputs["y"] = np.array(["nope"] * 50, dtype=object)
        rs = rt.execute([good, bad, other])
        rt.close()
        return [_result(r) for r in rs], _stats(rt)

    (out, info), _ = both(scenario)
    if case == "forced_flip":
        assert out["result"] == [40, 60]
        assert out["health"]["faults_corrected"] >= 1
        assert info["retries"] >= 1
    else:
        assert out[1][4] and out[1][6] is not None       # degraded, error
        assert out[2][6] is None and info["degraded_groups"] == 1


# ------------------------------------------------------------ the port alone

def _drive(lines, **kw):
    """``serve_pim_batched`` of the port over canned requests on the CPU;
    returns (responses in order, the summary dict)."""
    text = "\n".join(json.dumps(l) if isinstance(l, dict) else l
                     for l in lines) + "\n"
    outp = io.StringIO()
    kw.setdefault("window_ms", 0)
    with PORT.pim.options(**PORT.cpu):
        info = tserve.serve_pim_batched(io.StringIO(text), outp,
                                        stats=False, **kw)
    return [json.loads(s) for s in outp.getvalue().splitlines()], info


def test_heartbeat_and_straggler_counters(tmp_path):
    hb = tmp_path / "HEARTBEAT"
    rs, info = _drive([{"op": "add", "dtype": "uint8", "x": [1], "y": [2]}],
                      heartbeat=str(hb))
    assert rs[0]["result"] == [3]
    assert hb.exists() and hb.read_text().split()[0].isdigit()
    assert info["stragglers"] == 0          # single batch cannot spike
    mon = tft.StragglerMonitor(window=16, threshold=2.0)
    flags = [mon.record(i, 1.0) for i in range(12)] + [mon.record(12, 5.0)]
    ref = rft.StragglerMonitor(window=16, threshold=2.0)
    assert flags == [ref.record(i, 1.0) for i in range(12)] + \
        [ref.record(12, 5.0)]
    assert flags[-1] and not any(flags[:-1]) and mon.flagged == [(12, 5.0,
                                                                  1.0)]


def test_trace_file_holds_the_serving_spans(tmp_path):
    """``trace_file`` writes the reader's ``prepare``, the loop's
    ``enqueue``, the runtime's ``coalesce``/``exec``/``unpack`` and the
    dispatcher's own ``exec`` event (``pim.exec``); the tracer is off
    again afterwards."""
    trace = tmp_path / "trace.json"
    was = ttelemetry.TRACER.enabled
    rs, info = _drive([{"op": "add", "dtype": "uint8", "x": [1, 2],
                        "y": [3, 4]},
                       {"op": "mul", "dtype": "uint8", "x": [3], "y": [4]}],
                      trace_file=str(trace), window_ms=25)
    assert [r["result"] for r in rs] == [[4, 6], [12]]
    events = json.loads(trace.read_text())["traceEvents"]
    serve_names = {e["name"] for e in events if e.get("cat") == "pim.serve"}
    assert {"prepare", "enqueue", "coalesce", "exec",
            "unpack"} <= serve_names, serve_names
    assert any(e["name"] == "exec" and e.get("cat") == "pim.exec"
               for e in events)
    assert ttelemetry.TRACER.enabled == was


def test_deadlines_expire_in_queue_and_in_execution():
    """A server-wide deadline of 0 expires a request at dequeue; a
    request's own ``deadline_ms`` overrides it; a deadline already past
    when the runtime executes degrades the group and answers
    ``deadline_exceeded`` -- as in the reference."""
    rs, info = _drive([{"op": "add", "dtype": "uint8", "x": [1], "y": [2]}],
                      deadline_ms=0.0)
    assert rs[0]["error"]["code"] == "deadline_exceeded"
    assert rs[0]["error"]["retriable"] is True and info["expired"] == 1
    rs, info = _drive([{"op": "add", "dtype": "uint8", "x": [1], "y": [2],
                        "deadline_ms": 60000}], deadline_ms=0.0)
    assert rs[0]["result"] == [3] and info["expired"] == 0

    x = np.arange(40, dtype=np.uint16)

    def scenario(pkg):
        with _cpu(pkg):
            p = pkg.pim.prepare("add", x, x)
        rt = SERVE[pkg.name].pb.BatchRuntime()
        r = rt.execute([p], deadlines=[time.monotonic() - 1.0])[0]
        rt.close()
        return _result(r)

    r, _ = both(scenario)
    assert r[4] and r[6]["code"] == "deadline_exceeded"


def test_backpressure_flood_no_deadlock_no_loss():
    reqs = [{"op": "add", "dtype": "uint16",
             "x": list(range(8)), "y": list(range(8))} for _ in range(40)]
    rs, info = _drive(reqs, max_queue_rows=16)
    assert len(rs) == 40 and info["served"] == 40
    ok = [r for r in rs if "result" in r]
    rej = [r for r in rs if "error" in r]
    assert len(ok) >= 1 and len(rej) >= 1 and info["rejected"] == len(rej)
    assert all(r["error"]["code"] == "overloaded" for r in rej)
    assert all(r["result"] == [2 * i for i in range(8)] for r in ok)


def test_reader_errors_and_a_dying_stream_keep_serving(monkeypatch):
    real = tserve._pim_prepare_request

    def flaky(req):
        if req.get("op") == "crashme":
            raise RuntimeError("reader exploded")
        return real(req)

    monkeypatch.setattr(tserve, "_pim_prepare_request", flaky)
    rs, _ = _drive([{"op": "crashme", "x": [1], "y": [1]},
                    {"op": "add", "dtype": "uint8", "x": [2], "y": [3]}])
    assert rs[0]["error"]["code"] == "internal" and rs[1]["result"] == [5]

    class DyingStream:
        def __iter__(self):
            yield '{"op":"add","dtype":"uint8","x":[1],"y":[2]}\n'
            raise OSError("stream torn down")

    outp = io.StringIO()
    with PORT.pim.options(**PORT.cpu):
        info = tserve.serve_pim_batched(DyingStream(), outp, window_ms=25,
                                        stats=False)
    assert info["served"] == 1
    assert json.loads(outp.getvalue())["result"] == [3]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return env


def test_serve_cli_roundtrip_on_the_cpu():
    """``python -m repro_torch.launch.serve --pim-serve --pim-device cpu``
    answers the reference suite's four lines in order and writes the
    stats line."""
    reqs = ('{"op":"add","dtype":"uint8","x":[1,2],"y":[3,4]}\n'
            '{"op":"div","dtype":"uint8","x":[17],"y":[5]}\n'
            'broken\n'
            '{"op":"add","dtype":"uint8","x":[9],"y":[9]}\n')
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--pim-serve",
         "--pim-device", "cpu", "--pim-window-ms", "25",
         "--pim-max-batch-rows", "4096"],
        input=reqs, cwd=REPO, env=_env(), capture_output=True, text=True,
        timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    lines = [json.loads(l) for l in proc.stdout.splitlines()]
    assert len(lines) == 4
    assert lines[0]["result"] == [4, 6]
    assert (lines[1]["q"], lines[1]["r"]) == ([3], [2])
    assert lines[2]["error"]["code"] == "bad_json"
    assert lines[3]["result"] == [18]
    assert "pim-serve:" in proc.stderr
