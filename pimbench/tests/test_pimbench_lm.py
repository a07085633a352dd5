"""The decode branch on the CPU, at sizes a test run holds: the plain Qwen3
reference against the port's forward and decode steps on seeded weights; a
sound run is correct and a run whose timed path is broken underneath is
not, for each fault a decode cell can have; the fp8 control is refused;
the yardstick against hand counts; the readers; each LM cell's files; a
later LM family, and a second LM cell, added by files and entries alone."""

import ast
import dataclasses
import json
import math
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "src", Path(__file__).resolve().parent):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from pimbench import bench, cells, lm, lm_work  # noqa: E402
from test_pimbench_benchmark import (  # noqa: E402
    assert_a_cell_is_found_by_name_from_its_files, assert_the_contract)

CELL = "qwen3-8b-decode-b256"
#: the LM cells of ``BENCHMARK.json``, read and never pinned: a later
#: configuration adds its cell by files and entries alone
LM_CELLS = cells.cell_names("lm")
#: the readers every decode cell reports
DECODE_READERS = ("mfu", "step_roofline", "launches_per_step",
                  "device_idle.decode")
SEED = 2 ** 31 + 29
#: the port's forward in bfloat16 against the float32 reference, two
#: layers of width 64: bfloat16 keeps 8 significant bits, so each rounded
#: activation is off by up to 2**-9 of itself; over the two layers' dozen
#: rounded products and the head, logits of about unit size differ by a
#: few hundredths at most (0.02 read on these seeds)
LOGIT_TOL = 0.08


@pytest.fixture(autouse=True)
def one_thread():
    """Each test on one CPU thread: its products are small, and a test run
    shares the machine's cores among its workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reduced(d=64, ff=128, layers=2, heads=4, kv=2, hd=16, vocab=256,
            batch=4, prompt=8, gen=8, requests=8):
    """The cell at a small size: the port's cut (``port_replace``) and the
    published keys changed alike, so that the configuration still holds."""
    spec = cells.load_cell(CELL)
    config = spec["config"]
    sizes = {"hidden_size": d, "intermediate_size": ff,
             "num_hidden_layers": layers, "num_attention_heads": heads,
             "num_key_value_heads": kv, "head_dim": hd, "vocab_size": vocab}
    config.update(sizes)
    config["port_replace"] = {f: sizes[k]
                              for f, k in config["port_fields"].items()
                              if k in sizes}
    spec["traffic"].update(batch=batch, prompt_len=prompt, gen=gen,
                           check_requests=requests,
                           trace_positions=[prompt - 2, prompt, prompt + 2])
    return spec


def run_on_cpu(spec, seed=SEED, broken=None, trace=False):
    """Set-up, a window of one call and the check, on the CPU;
    ``broken(state)`` breaks the timed path after set-up."""
    state = lm.setup(spec, seed, device="cpu")
    if broken is not None:
        broken(state)
    win = lm.window(state, 0.0, trace=trace)
    lm.free_program(state)
    checks, held = lm.check(state, win)
    return state, win, checks, held


@pytest.mark.parametrize("seed", [SEED, 7])
def test_the_reference_matches_the_port_s_forward(seed):
    from repro_torch.models import model as M
    spec = reduced()
    cfg = lm.port_config(spec["config"])
    weights = lm.make_weights(lm.weight_shapes(cfg), spec["config"], seed,
                              "cpu")
    model = M.LM(cfg, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    tokens = lm.prompt_sets(spec["traffic"], cfg.vocab, seed, "cpu")[0]
    got, _ = M.forward(cfg, model, {"tokens": tokens}, remat=False)
    ref = lm.load_reference(spec)
    for row in range(tokens.shape[0]):
        want = ref.forward(spec["config"], weights, tokens[row], 0)
        assert want.dtype == torch.float32
        assert (got[row].float() - want).abs().max() < LOGIT_TOL


def test_the_reference_matches_the_port_s_decode_steps():
    """The port's cache path, teacher-forced step by step through the step
    ``serve.generate`` runs, against the reference's whole-sequence
    forward at every position."""
    from repro_torch.launch import steps
    from repro_torch.models import model as M
    spec = reduced()
    cfg = lm.port_config(spec["config"])
    weights = lm.make_weights(lm.weight_shapes(cfg), spec["config"], SEED,
                              "cpu")
    model = M.LM(cfg, device="meta")
    model.load_state_dict(weights, strict=True, assign=True)
    tokens = lm.prompt_sets(spec["traffic"], cfg.vocab, SEED, "cpu")[1]
    b, s = tokens.shape
    caches = M.init_caches(cfg, b, s, device="cpu")
    step = steps.make_decode_step(cfg)
    got = []
    for t in range(s):
        _, logits, caches = step(model, caches, {"token": tokens[:, t],
                                                 "pos": t})
        got.append(logits.float())
    got = torch.stack(got, 1)
    ref = lm.load_reference(spec)
    for row in range(b):
        want = ref.forward(spec["config"], weights, tokens[row], 0)
        assert (got[row] - want).abs().max() < LOGIT_TOL


def test_a_sound_run_is_correct():
    state, win, checks, held = run_on_cpu(reduced())
    assert win["calls"] == 1 and win["failed"] == 0 and held == 4
    assert bench.passed(checks)
    assert 0 <= checks["served_gap_max"]["value"] < \
        checks["served_gap_max"]["limit"]
    assert lm.tokens_per_s(state, win) > 0
    line = bench.line(True, win, {"tokens_per_s": {"value": 1.0,
                                                   "unit": "tokens/s"}},
                      {"platform": "gpu"}, checks)
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert list(line["checks"]) == ["served_gap_max", "prompt_mismatches",
                                    "malformed_tokens", "failed_calls"]
    assert json.loads(json.dumps(line)) == line


def _token_altered(state, monkeypatch):
    """One token altered where it is produced: row 0's third greedy
    token."""
    serve, at = state["serve"], state["spec"]["traffic"]["prompt_len"] + 2
    real, vocab = serve.make_decode_step, state["cfg"].vocab

    def make(cfg):
        step = real(cfg)

        def altered(params, caches, batch):
            nxt, logits, caches = step(params, caches, batch)
            if batch["pos"] == at:
                nxt = nxt.clone()
                nxt[0] = (nxt[0] + 1) % vocab
            return nxt, logits, caches
        return altered
    monkeypatch.setattr(serve, "make_decode_step", make)


def _state_unchanged(state, monkeypatch):
    """A step that returns its state unchanged: no cache is written."""
    from repro_torch.models import layers
    monkeypatch.setattr(layers, "write_at", lambda cache, index, v: cache)


def _cache_position_off_by_one(state, monkeypatch):
    """Each step writes its key and value one cache position late."""
    from repro_torch.models import layers
    real = layers.write_at
    monkeypatch.setattr(layers, "write_at", lambda cache, index, v: real(
        cache, (index + 1).clamp(max=cache.shape[1] - 1), v))


def _qk_norm_skipped(state, monkeypatch):
    """The per-head norm of the queries and keys left out."""
    state["cfg"] = dataclasses.replace(state["cfg"], qk_norm=False)


def _half_the_batch(state, monkeypatch):
    """Half of the batch left out: the rest repeats the computed half's
    tokens."""
    serve, real = state["serve"], state["serve"].generate

    def half(cfg, model, tokens, gen, **kw):
        b, p = tokens.shape
        out = real(cfg, model, tokens[:b // 2], gen, **kw)
        return torch.cat([tokens, out[:, p:].repeat(2, 1)], 1)
    monkeypatch.setattr(serve, "generate", half)


@pytest.mark.parametrize("fault", [_token_altered, _state_unchanged,
                                   _cache_position_off_by_one,
                                   _qk_norm_skipped, _half_the_batch])
def test_a_broken_timed_path_is_not_correct(fault, monkeypatch):
    _, win, checks, held = run_on_cpu(
        reduced(), broken=lambda state: fault(state, monkeypatch))
    assert win["failed"] == 0 and held == 4
    assert not bench.passed(checks)
    assert checks["served_gap_max"]["value"] > \
        checks["served_gap_max"]["limit"]


def test_a_call_that_raises_is_counted_and_not_correct(monkeypatch):
    def raises(*a, **kw):
        raise RuntimeError("a broken decode loop")
    _, win, checks, held = run_on_cpu(
        reduced(), broken=lambda state: monkeypatch.setattr(
            state["serve"], "generate", raises))
    assert win["failed"] == win["calls"] == 1 and held == 0
    assert "a broken decode loop" in win["errors"][0]
    assert not bench.passed(checks)


def test_a_wrong_prompt_or_token_id_is_not_correct(monkeypatch):
    def wrong(state):
        real = state["serve"].generate

        def gen(*a, **kw):
            out = real(*a, **kw)
            out[1, 0] = (out[1, 0] + 1) % 256
            out[2, -1] = 256
            return out
        monkeypatch.setattr(state["serve"], "generate", gen)
    _, _, checks, held = run_on_cpu(reduced(), broken=wrong)
    assert checks["prompt_mismatches"]["value"] == 1
    assert checks["malformed_tokens"]["value"] == 1
    assert held == 3 and not bench.passed(checks)


@pytest.mark.parametrize("seed", [SEED, 5])
def test_the_fp8_control_is_refused(seed):
    """The control at the published depth and a width a test holds: the
    reference on fp8 weights, put in the program's place, reads above the
    limit, and the program below it."""
    spec = reduced(d=128, ff=384, layers=36, heads=4, kv=2, hd=32,
                   vocab=8192, batch=8, prompt=16, gen=48)
    r = lm.control_readings(spec, seed, "cpu")
    limit = spec["config"]["check"]["served_gap_max"]
    assert r["control"] > limit > r["program"]


def test_fp8_weights_round_matrices_and_keep_norms():
    w = {"m": torch.randn(64, 32, dtype=torch.bfloat16),
         "g": torch.randn(64)}
    low = lm.Fp8Weights(w)
    assert torch.equal(low["g"], w["g"])
    m = low["m"]
    assert m.dtype == torch.float32 and not torch.equal(m, w["m"].float())
    scale = w["m"].float().abs().max() / 448
    assert torch.equal(m, (m / scale).to(torch.float8_e4m3fn).float()
                       * scale)
    rel = ((m - w["m"].float()).abs() / w["m"].float().abs()).median()
    assert 2 ** -8 < rel < 2 ** -3


def test_served_gap_is_the_widest_gap_below_the_best():
    logits = torch.tensor([[1.0, 3.0, 2.0], [0.0, -1.0, 5.0]])
    assert lm.served_gap(logits, torch.tensor([1, 2])) == 0.0
    assert lm.served_gap(logits, torch.tensor([2, 0])) == 5.0


def test_the_check_s_sample_is_drawn_from_the_seed():
    a = lm.sample_requests(3, 32, 8, 2 ** 40 + 1)
    assert a == lm.sample_requests(3, 32, 8, 2 ** 40 + 1)
    assert a != lm.sample_requests(3, 32, 8, 2 ** 40 + 2)
    assert len(set(a)) == 8 and all(0 <= c < 3 and 0 <= r < 32
                                    for c, r in a)
    assert len(lm.sample_requests(1, 4, 8, -3)) == 4


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 11, 2 ** 63 + 5, -7])
def test_weights_and_prompts_come_from_the_seed(seed):
    spec = reduced()
    shapes = lm.weight_shapes(lm.port_config(spec["config"]))
    a = lm.make_weights(shapes, spec["config"], seed, "cpu")
    b = lm.make_weights(shapes, spec["config"], seed, "cpu")
    c = lm.make_weights(shapes, spec["config"], seed + 1, "cpu")
    assert sorted(a) == sorted(shapes)
    for name, (shape, dtype) in shapes.items():
        assert a[name].shape == shape and a[name].dtype == dtype
        assert torch.equal(a[name], b[name])
        assert not torch.equal(a[name], c[name])
    assert 0.015 < a["embed"].float().std() < 0.025
    assert 0.07 < a["layers.0.ln1"].std() < 0.13
    wq = a["layers.0.attn.wq"].float()
    assert 0.8 < wq.std() * 8 < 1.2            # 1/sqrt(64)
    p = lm.prompt_sets(spec["traffic"], 256, seed, "cpu")
    assert p.shape == (3, 4, 8) and p.dtype == torch.int32
    assert torch.equal(p, lm.prompt_sets(spec["traffic"], 256, seed, "cpu"))
    assert 0 <= int(p.min()) and int(p.max()) < 256
    assert not torch.equal(p[0], p[1])


def test_the_port_s_config_is_held_to_the_published_keys():
    spec = cells.load_cell(CELL)
    cfg = lm.port_config(spec["config"])
    assert (cfg.d_model, cfg.n_layers, cfg.vocab) == (4096, 36, 151936)
    config = dict(spec["config"], num_key_value_heads=4)
    with pytest.raises(ValueError, match="n_kv_heads"):
        lm.port_config(config)
    config = dict(spec["config"], port_values={"qk_norm": False})
    with pytest.raises(ValueError, match="qk_norm"):
        lm.port_config(config)


def test_lm_work_against_hand_counts():
    config = {"hidden_size": 8, "intermediate_size": 12,
              "num_hidden_layers": 2, "num_attention_heads": 2,
              "num_key_value_heads": 1, "head_dim": 4, "vocab_size": 10}
    w = lm_work.dense_decode_step(config, 3)
    # a layer: q 8x8, k 8x4, v 8x4, o 8x8, MLP 3 x 8x12; head 8x10
    m = 2 * (64 + 32 + 32 + 64 + 288) + 80
    assert w["flops_per_step"] == 2 * 3 * m
    assert w["flops_per_context"] == 4 * 3 * 2 * 2 * 4
    norms = 2 * (2 * 8 + 2 * 4) + 8
    kv = 2 * 3 * 2 * 2 * 4            # bf16, batch 3, 2 layers, k and v
    assert w["bytes_per_context"] == kv
    assert w["bytes_per_step"] == 2 * m + 4 * norms + 2 * 3 * 8 + kv
    assert lm_work.span_work(w, [0, 2]) == (
        2 * w["flops_per_step"] + 4 * w["flops_per_context"],
        2 * w["bytes_per_step"] + 4 * kv)


def test_the_frozen_work_is_the_configuration_s():
    spec = cells.load_cell(CELL)
    want = lm_work.dense_decode_step(spec["config"],
                                     spec["traffic"]["batch"])
    assert {k: spec["frozen"][k] for k in want} == want
    # the step's products hold every parameter but the embedding and norms
    from repro_torch.models import model as M
    cfg = lm.port_config(spec["config"])
    n = sum(p.numel() for p in M.LM(cfg, device="meta").parameters())
    norms = 36 * (2 * 4096 + 2 * 128) + 4096
    assert want["flops_per_step"] == 2 * 256 * (n - 151936 * 4096 - norms)


def _ctx(**kw):
    from pimbench import timeline
    events = [{"name": timeline.WINDOW, "cat": "user_annotation", "ph": "X",
               "ts": 0, "dur": 2e6}]
    events += [{"name": "k", "cat": "kernel", "ph": "X", "ts": 1e5 * i,
                "dur": 5e4} for i in range(20)]
    ctx = {"timeline": timeline.timeline(events), "window_s": 2.0,
           "steps": list(range(528, 536)),
           "timed_steps": list(range(512, 528)), "timed_s": 1.0,
           "frozen": cells.load_cell(CELL)["frozen"],
           "device_kind": "NVIDIA H100 80GB HBM3"}
    ctx.update(kw)
    return ctx


def test_the_step_readers():
    read = lambda name, ctx: cells.metric_reader(name)(ctx)
    ctx = _ctx()
    flops, nbytes = lm_work.span_work(ctx["frozen"], range(512, 528))
    assert read("mfu", ctx) == pytest.approx(100 * flops / 989.4e12)
    assert read("step_roofline", ctx) == pytest.approx(
        100 * nbytes / 3.35e12)             # bytes bound the step
    assert read("mfu", ctx) < read("step_roofline", ctx) < 100
    assert read("launches_per_step", ctx) == 20 / 8
    assert read("device_idle.decode", ctx) == pytest.approx(0.5)
    for name in ("mfu", "step_roofline"):
        assert read(name, _ctx(device_kind="another card")) is None
        assert read(name, _ctx(timed_steps=[])) is None
    assert read("launches_per_step", _ctx(timeline=None)) is None
    assert read("device_idle.decode", _ctx(timeline=None)) is None


def test_the_traced_spans_time_and_trace_fixed_steps():
    spec = reduced()
    state = lm.setup(spec, SEED, device="cpu")
    real = state["serve"].make_decode_step
    win = lm.window(state, 0.0, trace=True)
    span = win["span"]
    assert state["serve"].make_decode_step is real
    assert span.timed_steps == [6, 7] and span.steps == [8, 9]
    assert span.timed_s > 0 and span.prof is not None


def test_idle_gaps_are_named_by_the_innermost_host_op():
    from pimbench import timeline
    x = lambda name, cat, ts, dur: {"name": name, "cat": cat, "ph": "X",
                                    "ts": ts, "dur": dur}
    events = [x(timeline.WINDOW, "user_annotation", 0, 100),
              x("k", "kernel", 0, 10), x("k", "kernel", 60, 40),
              x("aten::linear", "cpu_op", 5, 80),
              x("aten::mm", "cpu_op", 12, 45)]
    tl = timeline.timeline(events)
    assert lm.host_gaps(tl, events) == [["aten::mm", 50e-6]]


def _qwen3_moe_tree(state, spec):
    assert state["cfg"].moe.n_experts == 4
    assert state["shapes"]["layers.0.moe.w1"][0] == (4, 64, 32)


def _deepseek_v2_tree(state, spec):
    """Latent attention in every layer, a leading dense FFN, then routed
    experts as 3-D stacks beside the shared experts; each stack drawn at
    the scale of its fan_in, the second-to-last axis."""
    shapes = state["shapes"]
    for i in range(3):
        assert {f"layers.{i}.attn.wq_a", f"layers.{i}.attn.wkv_b"} <= \
            set(shapes)
    assert shapes["layers.0.ffn.w1"][0] == (64, 128)
    assert not any(n.startswith("layers.0.moe.") for n in shapes)
    for i in (1, 2):
        assert shapes[f"layers.{i}.moe.w1"][0] == (8, 64, 32)
        assert shapes[f"layers.{i}.moe.w2"][0] == (8, 32, 64)
        assert shapes[f"layers.{i}.moe.shared.w1"][0] == (64, 2 * 32)
        assert f"layers.{i}.ffn.w1" not in shapes
    weights = lm.make_weights(shapes, spec["config"], SEED, "cpu")
    for name in ("layers.1.moe.w1", "layers.1.moe.w2"):
        w = weights[name].float()
        assert 0.9 < w.std() * math.sqrt(w.shape[-2]) < 1.1


#: later families at a small width: the port's ``arch``, its published
#: keys, the port's cut, what it holds fixed, and what its drawn tree shows
LATER_FAMILIES = {
    "qwen3-moe": dict(
        arch="qwen3-moe-235b-a22b",
        published={"hidden_size": 64, "intermediate_size": 32,
                   "num_hidden_layers": 1, "num_attention_heads": 4,
                   "num_key_value_heads": 2, "head_dim": 16,
                   "vocab_size": 128},
        port_replace={"n_layers": 1, "d_model": 64, "n_heads": 4,
                      "n_kv_heads": 2, "head_dim": 16, "d_ff": 32,
                      "vocab": 128, "moe": {"n_experts": 4, "top_k": 2,
                                            "d_expert": 32}},
        port_values={"group": ["moe"]},
        tree=_qwen3_moe_tree),
    "deepseek-v2": dict(
        arch="deepseek-v2-236b",
        published={"hidden_size": 64, "intermediate_size": 128,
                   "moe_intermediate_size": 32, "num_hidden_layers": 3,
                   "num_attention_heads": 4, "num_key_value_heads": 4,
                   "n_routed_experts": 8, "num_experts_per_tok": 2,
                   "n_shared_experts": 2, "first_k_dense_replace": 1,
                   "q_lora_rank": 32, "kv_lora_rank": 16,
                   "qk_rope_head_dim": 8, "qk_nope_head_dim": 16,
                   "v_head_dim": 16, "vocab_size": 128},
        port_replace={"n_layers": 3, "d_model": 64, "n_heads": 4,
                      "n_kv_heads": 4, "head_dim": 24, "vocab": 128,
                      "moe": {"n_experts": 8, "top_k": 2, "d_expert": 32,
                              "n_shared": 2, "d_ff_dense": 128},
                      "mla": {"q_lora": 32, "kv_lora": 16,
                              "rope_head_dim": 8, "nope_head_dim": 16,
                              "v_head_dim": 16}},
        port_values={"group": ["moe"], "prefix": ["moe_dense"]},
        tree=_deepseek_v2_tree),
}


def _copy_harness(root):
    """The harness under ``root``, without its tests."""
    shutil.copytree(ROOT / "pimbench", root / "pimbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))


def _new_file(path, text):
    """Write a file the harness does not have: adding a cell edits none."""
    assert not path.exists(), path
    path.write_text(text)


@pytest.mark.parametrize("family", list(LATER_FAMILIES))
def test_a_later_lm_configuration_is_added_by_files_alone(family, tmp_path):
    """A mixture-of-experts family (the port's qwen3-moe, or DeepSeek-V2
    with latent attention, at a small width), its own reference (a stub
    here), traffic, frozen work and a reader are new files and entries; no
    file of the harness changes, and a run on the CPU finds and runs them
    all."""
    f = LATER_FAMILIES[family]
    name, cell = f"{family}-tiny", f"{family}-tiny-decode"
    _copy_harness(tmp_path)
    bench_json = cells.load_benchmark()
    bench_json["configs"].append({
        "name": name, "source": "a later family",
        "file": f"pimbench/configs/{name}.json",
        "reduced": ["num_hidden_layers"], "why": "a later family"})
    bench_json["workloads"].append({
        "name": cell, "config": name, "traffic": "decode.tiny", "chips": 1,
        "why": "a later cell"})
    tokens = [m for m in bench_json["end_to_end"]
              if m["name"] == "tokens_per_s"]
    tokens[0]["workloads"].append(cell)
    bench_json["per_layer"].append({
        "name": "steps_traced", "unit": "steps", "better": "higher",
        "source": "host_clock", "layer": "model step",
        "moves": "tokens_per_s", "workloads": [cell]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    here = tmp_path / "pimbench"
    _new_file(here / "configs" / f"{name}.json", json.dumps(dict(
        f["published"], kind="lm", arch=f["arch"],
        reference="pimbench/lm_reference/stub.py",
        port_replace=f["port_replace"],
        port_fields={"d_model": "hidden_size", "n_layers":
                     "num_hidden_layers", "n_heads": "num_attention_heads",
                     "vocab": "vocab_size"},
        port_values=f["port_values"],
        weights={"embed": 0.02, "vectors": 0.1},
        check={"served_gap_max": 0.0})))
    _new_file(here / "lm_reference" / "stub.py",
              "import torch\n\n\n"
              "def forward(config, weights, tokens, first):\n"
              "    \"\"\"Every token ties: any served token is at the best."
              "\"\"\"\n"
              "    return torch.zeros(len(tokens) - first,"
              " config['vocab_size'])\n")
    _new_file(here / "traffic" / "decode.tiny.json", json.dumps(
        {"kind": "decode", "batch": 2, "prompt_len": 4, "gen": 3, "pool": 2,
         "prompt_ids": {"kind": "uniform"}, "check_requests": 2,
         "trace_positions": [1, 3, 5]}))
    _new_file(here / "workloads" / f"{cell}.json", json.dumps(
        {"flops_per_step": 1, "flops_per_context": 0, "bytes_per_step": 1,
         "bytes_per_context": 0}))
    _new_file(here / "metrics" / "steps_traced.py",
              "def read(ctx):\n    return len(ctx['steps'])\n")
    spec = cells.load_cell(cell, tmp_path)
    assert cells.kind(spec) == "lm"
    assert [m["name"] for m in spec["end_to_end"]] == ["tokens_per_s",
                                                       "setup_s"]
    assert [m["name"] for m in spec["per_layer"]] == ["steps_traced"]
    state, win, checks, held = run_on_cpu(spec, trace=True)
    assert win["calls"] == 1 and win["failed"] == 0
    assert held == 2 and bench.passed(checks)
    f["tree"](state, spec)
    ctx = {"steps": win["span"].steps}
    assert bench.per_layer(spec, ctx) == {
        "steps_traced": {"value": 2.0, "unit": "steps"}}
    assert cells.cell_names("lm", tmp_path) == LM_CELLS + [cell]


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            yield node.module.split(".")[0]


def test_the_plain_references_import_torch_alone():
    files = sorted((ROOT / "pimbench" / "lm_reference").glob("*.py"))
    assert files
    for f in files:
        assert set(_imports(f)) <= {"__future__", "contextlib", "math",
                                    "torch"}, f


def test_without_a_card_an_lm_run_prints_no_result_and_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    p = subprocess.run(
        [sys.executable, "pimbench/run.py", "--workload", CELL, "--seed",
         "1", "--seconds", "1", "--trace", "1"], cwd=ROOT,
        capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=""))
    assert p.returncode != 0 and p.stdout == ""
    assert "needs 1 CUDA device" in p.stderr


def assert_a_decode_cell(cell, root=ROOT):
    """What every decode cell of the benchmark at ``root`` needs, and what
    ``qwen3-8b-decode-b256`` alone has."""
    assert_a_cell_is_found_by_name_from_its_files(cell, root)
    bench_json = cells.load_benchmark(root)
    name = next(w["config"] for w in bench_json["workloads"]
                if w["name"] == cell)
    entry = next(c for c in bench_json["configs"] if c["name"] == name)
    spec = cells.load_cell(cell, root)
    config, t = spec["config"], spec["traffic"]
    assert cells.kind(spec) == "lm"
    assert config["reduced"] == entry["reduced"]
    assert set(entry["reduced"]) <= set(config)
    a, b, c = t["trace_positions"]
    assert 0 <= a < b < c <= t["prompt_len"] + t["gen"] - 1
    gap = config["check"]["served_gap_max"]
    assert np.isfinite(gap) and gap > 0
    assert {m["name"] for m in spec["end_to_end"]} == {"tokens_per_s",
                                                      "setup_s"}
    per_layer = {m["name"] for m in spec["per_layer"]}
    assert set(DECODE_READERS) <= per_layer
    if cell == CELL:
        assert config["reduced"] == []
        assert per_layer == set(DECODE_READERS)


@pytest.mark.parametrize("cell", LM_CELLS)
def test_the_lm_cell_s_files(cell):
    assert LM_CELLS[0] == CELL
    assert_a_decode_cell(cell)


def test_a_second_lm_cell_needs_no_edit(tmp_path):
    """A second ``qwen3-8b`` cell, at batch 64, added by entries and new
    files alone: the copy keeps to the contract, and each of its LM cells
    to what a decode cell needs."""
    cell, traffic = "qwen3-8b-later-decode", "decode.later-b64-p512-g64"
    _copy_harness(tmp_path)
    bench_json = cells.load_benchmark()
    bench_json["workloads"].append({
        "name": cell, "config": "qwen3-8b", "traffic": traffic, "chips": 1,
        "why": "a later cell: the same model and lengths at batch 64"})
    for m in bench_json["end_to_end"] + bench_json["per_layer"]:
        if m["name"] in ("tokens_per_s",) + DECODE_READERS:
            m["workloads"].append(cell)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench_json))
    here, spec = tmp_path / "pimbench", cells.load_cell(CELL)
    _new_file(here / "traffic" / f"{traffic}.json",
              json.dumps(dict(spec["traffic"], batch=64)))
    _new_file(here / "workloads" / f"{cell}.json", json.dumps(dict(
        lm_work.dense_decode_step(spec["config"], 64), batch=64)))
    names = cells.cell_names("lm", tmp_path)
    assert names == LM_CELLS + [cell] and names[0] == CELL
    assert_the_contract(tmp_path)
    for name in names:
        assert_a_decode_cell(name, tmp_path)
