"""The decode branch of the harness: one run of an LM cell.

A cell runs this branch where its configuration file says ``"kind":
"lm"``.  The file holds the published configuration under its published
keys, the port's architecture (``arch``, looked up in
``repro_torch.configs.registry``), any cut of it (``port_replace``, applied
with ``dataclasses.replace``; a nested group by a dict), the port's fields
that must equal published keys (``port_fields``) or values
(``port_values``), how the weights are drawn (``weights``), the limit of
the check (``check``) and the path of the plain reference (``reference``),
a module with ``forward(config, weights, tokens, first)``.

Set-up: the port's model on the card, its weights drawn from the seed by
the harness (:func:`make_weights`, in the type each is served in, a few
large draws) and handed to the port's parameter tree by name; a pool of
prompt sets drawn from the seed (:func:`prompt_sets`); a warm-up
``generate`` of two steps at the window's batch.

Window: a closed loop with one caller.  Each call is one whole
``repro_torch.launch.serve.generate(cfg, model, prompts, gen)`` on the next
prompt set of the pool, and ``.cpu()`` of its tokens; after ``seconds`` the
call running finishes, so the window holds whole calls.  ``tokens_per_s``
counts ``batch * (prompt_len + gen)`` tokens a whole call over the time
from the first call's start to the last call's end, as ``serve_llm``
counts them.

Check (:func:`check`), once the window has closed and the program's state
is freed: every call's prompt positions equal the prompt sent and every
token id lies in the vocabulary; a sample of the requests drawn from the
seed is run through the plain float32 reference, on weights drawn again
from the seed, over the prompt and the served tokens, and at each served
position the gap by which the served token's reference logit lies below
the reference's best is taken.  ``served_gap_max``, the widest gap, is
held to the configuration's limit.  That holds for greedy tokens only, and
the traffic is greedy.

A traced run (``--trace 1``) times and profiles the spans of
:class:`StepSpan`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import math
import sys
import time
import traceback
from pathlib import Path
from typing import Dict, List

import numpy as np
import torch

from pimbench import bench, timeline

#: Elements of one draw of the weights (a draw of more is split in these).
DRAW = 1 << 30


def _stream_seed(seed: int, stream: int) -> int:
    """A 64-bit seed of its own for each of the run's streams (weights,
    prompts, the check's sample), from any whole ``seed``."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0])


def port_config(config: dict):
    """The port's model configuration for ``config``: its registry entry
    with ``port_replace`` applied, held to the published keys."""
    from repro_torch.configs import registry
    cfg = registry.get(config["arch"])
    changes = {}
    for field, value in config.get("port_replace", {}).items():
        old = getattr(cfg, field)
        changes[field] = dataclasses.replace(old, **value) \
            if isinstance(value, dict) and dataclasses.is_dataclass(old) \
            else value
    cfg = dataclasses.replace(cfg, **changes)
    want = {f: config[k] for f, k in config.get("port_fields", {}).items()}
    want.update(config.get("port_values", {}))
    for field, value in want.items():
        got = getattr(cfg, field)
        got = list(got) if isinstance(got, tuple) else got
        if got != value:
            raise ValueError(f"the port's {config['arch']} has {field} = "
                             f"{got!r}, the configuration {value!r}")
    return cfg


def weight_shapes(cfg) -> Dict[str, tuple]:
    """Every parameter of the port's model: name -> (shape, dtype), in the
    order of its tree (from a model on the ``meta`` device)."""
    from repro_torch.models import model as M
    return {n: (tuple(p.shape), p.dtype)
            for n, p in M.LM(cfg, device="meta").named_parameters()}


def _scale(name: str, shape: tuple, rules: dict) -> float:
    if name == "embed":
        return float(rules["embed"])
    if len(shape) < 2:
        return float(rules["vectors"])
    return 1.0 / math.sqrt(shape[-2])


def make_weights(shapes: Dict[str, tuple], config: dict, seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """The weights from ``seed``: standard normal draws on ``device``, one
    buffer a dtype filled in draws of at most :data:`DRAW` elements, each
    tensor a view of it times its scale (the embedding's, the vectors', or
    1/sqrt(fan_in) for a matrix, fan_in its second-to-last axis).  The same
    seed, shapes and device give the same weights."""
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream_seed(seed, 0))
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for name, (_, dtype) in shapes.items():
        by_dtype.setdefault(dtype, []).append(name)
    out = {}
    for dtype, names in by_dtype.items():
        sizes = [math.prod(shapes[n][0]) for n in names]
        flat = torch.empty(sum(sizes), dtype=dtype, device=device)
        for a in range(0, flat.numel(), DRAW):
            flat[a:a + DRAW].normal_(generator=gen)
        off = 0
        for name, size in zip(names, sizes):
            t = flat[off:off + size].view(shapes[name][0])
            out[name] = t.mul_(_scale(name, shapes[name][0],
                                      config["weights"]))
            off += size
    return out


def prompt_sets(traffic: dict, vocab: int, seed: int,
                device) -> torch.Tensor:
    """``pool`` prompt sets [pool, batch, prompt_len] of int32 ids drawn
    uniformly over the vocabulary from ``seed``, on ``device``."""
    if traffic["prompt_ids"]["kind"] != "uniform":
        raise ValueError(f"unknown prompt kind "
                         f"{traffic['prompt_ids']['kind']!r}")
    gen = torch.Generator(device=device)
    gen.manual_seed(_stream_seed(seed, 1))
    return torch.randint(0, vocab, (int(traffic["pool"]),
                                    int(traffic["batch"]),
                                    int(traffic["prompt_len"])),
                         generator=gen, device=device, dtype=torch.int32)


def load_reference(spec: dict):
    """The configuration's plain reference, loaded by its path."""
    path = Path(spec["root"]) / spec["config"]["reference"]
    name = "pimbench_lm_reference_" + path.stem.replace("-", "_")
    mod_spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def setup(spec: dict, seed: int, device: str = "cuda") -> dict:
    """The port's model with the seed's weights, the prompt pool and the
    warm-up."""
    t0 = time.perf_counter()
    from repro_torch.launch import serve
    from repro_torch.models import model as M
    t_import = time.perf_counter()
    config, traffic = spec["config"], spec["traffic"]
    cfg = port_config(config)
    if torch.device(device).type == "cuda":    # the context, made apart
        torch.empty(1, device=device)
        _sync(device)
    t_context = time.perf_counter()
    shapes = weight_shapes(cfg)
    model = M.LM(cfg, device="meta")
    model.load_state_dict(make_weights(shapes, config, seed, device),
                          strict=True, assign=True)
    prompts = prompt_sets(traffic, config["vocab_size"], seed, device)
    _sync(device)
    t_weights = time.perf_counter()
    # two steps at the window's batch: the step's kernels and the library
    # handles; the cache's length is first met in the window's first call
    serve.generate(cfg, model, prompts[0][:, :1], 2).cpu()
    parts = {"import repro_torch": t_import - t0,
             "CUDA context": t_context - t_import,
             "weights and prompts": t_weights - t_context,
             "warm-up": time.perf_counter() - t_weights}
    return {"spec": spec, "cfg": cfg, "serve": serve, "model": model,
            "shapes": shapes, "prompts": prompts, "seed": int(seed),
            "device": device, "setup_parts": parts}


class StepSpan:
    """The traced run's two spans in the window's first call, given by the
    traffic's ``trace_positions`` [a, b, c]: the decode steps at positions
    [a, b) timed on the host's clock without the profiler (``timed_s``),
    then the steps at [b, c) under ``torch.profiler`` inside a
    ``timeline.WINDOW`` range (``steps``), the card synchronised at each
    span's ends, so that every run times and traces the same steps.  The
    profiler's own cost on each launch makes a traced step two to five
    times slower; the untraced span gives the step's time, the traced one
    what ran on the card.  A whole call (575 steps of some 3,300 launches)
    would not export in a run's time.  The steps are found by wrapping
    ``serve.make_decode_step``, which ``serve.generate`` calls for the step
    it runs; the wrapper opens and closes the spans and changes nothing
    else."""

    def __init__(self, serve, timed_from: int, traced_from: int,
                 traced_to: int, device):
        self.serve = serve
        self.edges = (int(timed_from), int(traced_from), int(traced_to))
        self.device = device
        self.prof = self.mark = self.real = None
        self.timed_steps: List[int] = []
        self.steps: List[int] = []
        self.timed_s = None
        self.phase = None               # "timed", "traced", or None
        self._t0 = 0.0

    def __enter__(self):
        self.real = self.serve.make_decode_step
        self.serve.make_decode_step = self._make
        return self

    def __exit__(self, *exc):
        self.serve.make_decode_step = self.real
        if self.phase == "traced":      # a call that failed in the span
            self._close()
        return False

    def _open(self) -> None:
        from torch.profiler import ProfilerActivity, profile, \
            record_function
        acts = [ProfilerActivity.CPU]
        if torch.device(self.device).type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        _sync(self.device)
        self.mark = record_function(timeline.WINDOW)
        self.mark.__enter__()
        self.phase = "traced"

    def _close(self) -> None:
        _sync(self.device)
        self.mark.__exit__(None, None, None)
        self.prof.stop()
        self.phase = "done"

    def _at(self, pos: int) -> None:
        a, b, c = self.edges
        if self.phase is None and pos == a:
            _sync(self.device)
            self._t0 = time.perf_counter()
            self.phase = "timed"
        elif self.phase == "timed" and pos == b:
            _sync(self.device)
            self.timed_s = time.perf_counter() - self._t0
            self._open()
        elif self.phase == "traced" and pos == c:
            self._close()
        if self.phase == "timed":
            self.timed_steps.append(pos)
        elif self.phase == "traced":
            self.steps.append(pos)

    def _make(self, cfg):
        step = self.real(cfg)

        def traced(params, caches, batch):
            self._at(int(batch["pos"]))
            return step(params, caches, batch)
        return traced


def window(state: dict, seconds: float, trace: bool = False) -> dict:
    """The measured window: whole ``generate`` calls for ``seconds``."""
    traffic = state["spec"]["traffic"]
    prompts, gen = state["prompts"], int(traffic["gen"])
    span = StepSpan(state["serve"], *traffic["trace_positions"],
                    state["device"]) if trace else None
    outs, call_s, errors = [], [], []
    failed = 0
    with span if trace else contextlib.nullcontext():
        t_start = time.perf_counter()
        deadline = t_start + seconds
        i = 0
        while True:
            s = i % len(prompts)
            t0 = time.perf_counter()
            try:
                out = state["serve"].generate(state["cfg"], state["model"],
                                              prompts[s], gen).cpu()
            except Exception:               # a failed call is counted
                failed += 1
                errors.append(traceback.format_exc())
                out = None
            t_end = time.perf_counter()
            call_s.append(t_end - t0)
            if out is not None:
                outs.append((i, s, out.numpy()))
            i += 1
            if t_end >= deadline:
                break
    return {"calls": i, "failed": failed, "errors": errors,
            "t_start": t_start, "t_end": t_end, "call_s": call_s,
            "outs": outs, "span": span}


def tokens_per_s(state: dict, win: dict) -> float:
    t = state["spec"]["traffic"]
    per_call = int(t["batch"]) * (int(t["prompt_len"]) + int(t["gen"]))
    done = win["calls"] - win["failed"]
    return done * per_call / (win["t_end"] - win["t_start"])


def free_program(state: dict) -> None:
    """Drops the program's model and its caches from the card."""
    state.pop("model", None)
    gc.collect()
    if torch.device(state["device"]).type == "cuda":
        torch.cuda.empty_cache()


def sample_requests(n_calls: int, batch: int, k: int,
                    seed: int) -> List[tuple]:
    """(call, row) of ``k`` requests drawn from the seed among the
    ``n_calls`` calls' requests (all of them where there are no more)."""
    rng = np.random.default_rng(_stream_seed(seed, 2))
    total = n_calls * batch
    picked = rng.choice(total, size=min(int(k), total), replace=False)
    return [(int(j) // batch, int(j) % batch) for j in sorted(picked)]


def served_gap(logits: torch.Tensor, tokens: torch.Tensor) -> float:
    """The widest gap, over positions, by which ``tokens``' logit lies
    below the best logit at its position (``logits`` [G, V], ``tokens``
    [G])."""
    best = logits.max(-1).values
    got = logits.gather(-1, tokens.long()[:, None])[:, 0]
    return float((best - got).max())


def held_requests(state: dict, win: dict):
    """The check's sample of the window's requests, each that is whole
    and in the vocabulary as one int64 sequence [prompt_len + gen] on the
    run's device (a malformed one is :func:`check`'s to count)."""
    traffic = state["spec"]["traffic"]
    length = int(traffic["prompt_len"]) + int(traffic["gen"])
    vocab = int(state["spec"]["config"]["vocab_size"])
    for k, row in sample_requests(len(win["outs"]), int(traffic["batch"]),
                                  traffic["check_requests"], state["seed"]):
        out = win["outs"][k][2]
        seq = out[row] if out.ndim == 2 and row < len(out) else out[:0]
        if seq.shape == (length,) and ((seq >= 0) & (seq < vocab)).all():
            yield torch.as_tensor(seq.astype(np.int64),
                                  device=state["device"])


def check(state: dict, win: dict) -> tuple:
    """The numbers compared, each with its limit, and the requests held
    against the reference.  Runs after :func:`free_program`."""
    spec = state["spec"]
    config, traffic = spec["config"], spec["traffic"]
    p, g = int(traffic["prompt_len"]), int(traffic["gen"])
    batch, vocab = int(traffic["batch"]), int(config["vocab_size"])
    prompts = state["prompts"].cpu().numpy()
    prompt_bad = malformed = 0
    for _, s, out in win["outs"]:
        if out.shape != (batch, p + g):
            malformed += batch * (p + g)
            continue
        prompt_bad += int((out[:, :p] != prompts[s]).sum())
        malformed += int(((out < 0) | (out >= vocab)).sum())
    ref = load_reference(spec)
    weights = make_weights(state["shapes"], config, state["seed"],
                           state["device"])
    gap = 0.0
    held = 0
    for seq in held_requests(state, win):
        logits = ref.forward(config, weights, seq[:-1], p - 1)
        gap = max(gap, served_gap(logits, seq[p:]))
        held += 1
    checks = {
        "served_gap_max": {"value": gap,
                           "limit": config["check"]["served_gap_max"]},
        "prompt_mismatches": {"value": prompt_bad, "limit": 0},
        "malformed_tokens": {"value": malformed, "limit": 0},
        "failed_calls": {"value": win["failed"], "limit": 0}}
    return checks, held


class Fp8Weights:
    """The weights one precision step below the configuration's bfloat16,
    for the control: every matrix rounded to ``float8_e4m3fn`` with one
    scale a tensor (its largest magnitude to 448, the format's largest),
    then widened to float32; the float32 norm gains as they are."""

    def __init__(self, weights):
        self.weights = weights

    def __getitem__(self, name: str) -> torch.Tensor:
        t = self.weights[name]
        if t.dim() < 2:
            return t
        t = t.float()
        scale = t.abs().amax().clamp_min(1e-30) / 448.0
        return (t / scale).to(torch.float8_e4m3fn).float() * scale


def control_readings(spec: dict, seed: int, device: str = "cuda") -> dict:
    """The program's ``served_gap_max`` and the control's on one call of
    the cell (the window's first), on the run's sample of its requests:
    the control's is, at each served position, the gap of the token that
    the reference on :class:`Fp8Weights` puts first."""
    state = setup(spec, seed, device)
    win = window(state, 0.0)
    free_program(state)
    config = spec["config"]
    p = int(spec["traffic"]["prompt_len"])
    ref = load_reference(spec)
    weights = make_weights(state["shapes"], config, seed, device)
    low = Fp8Weights(weights)
    program = control = 0.0
    t0 = time.perf_counter()
    for seq in held_requests(state, win):
        logits = ref.forward(config, weights, seq[:-1], p - 1)
        program = max(program, served_gap(logits, seq[p:]))
        lower = ref.forward(config, low, seq[:-1], p - 1)
        control = max(control, served_gap(logits, lower.argmax(-1)))
    return {"program": program, "control": control,
            "call_s": win["call_s"], "failed": win["failed"],
            "check_s": time.perf_counter() - t0}


def control_main(spec: dict, seeds: List[int], device: str) -> int:
    """``control.py`` for an LM cell: one line a seed with the program's
    reading and the control's; exits 1 if any seed's control passes."""
    limit = spec["config"]["check"]["served_gap_max"]
    progs, ctrls = [], []
    for seed in seeds:
        r = control_readings(spec, seed, device)
        progs.append(r["program"])
        ctrls.append(r["control"])
        print(f"control {spec['name']} seed {seed}: served_gap_max program "
              f"{r['program']!r} control {r['control']!r} (limit {limit}); "
              f"call {r['call_s']} s, failed {r['failed']}, reference "
              f"{r['check_s']:.3f} s", flush=True)
    refused = all(c > limit for c in ctrls)
    print(f"control {spec['name']}: program highest {max(progs)!r}, "
          f"control least {min(ctrls)!r} (limit {limit}): "
          f"{'refused, as it must be' if refused else 'PASSED'}")
    return 0 if refused else 1


def host_gaps(tl: dict, events: List[dict], n: int = 10) -> List[list]:
    """[the host operation, seconds] of the longest idle gaps of the card
    in the span: each gap named by the innermost ``cpu_op`` that covers at
    least half of it ("no host op" where none does)."""
    ws, we = tl["window"]
    ops = []
    for e in events:
        if e.get("cat") == "cpu_op":
            s = e["ts"] / 1e6
            t = s + e["dur"] / 1e6
            if t > ws and s < we:
                ops.append((s, t, e.get("name", "")))
    g = sorted(timeline.gaps([(s, e) for s, e, _ in tl["device"]],
                             tl["window"]), key=lambda iv: iv[0] - iv[1])[:n]
    out = []
    for s, e in g:
        best = None
        for os_, oe, name in ops:
            if min(e, oe) - max(s, os_) >= 0.5 * (e - s) and (
                    best is None or oe - os_ < best[0]):
                best = (oe - os_, name)
        out.append([best[1] if best else "no host op", e - s])
    return out


def main(args, spec: dict, before: dict, origin: float,
         power_limit) -> int:
    """One run of an LM cell on the card, as ``run.py`` describes;
    ``origin`` is the process's age at ``run.py``'s clock zero, negated
    into the clock's frame."""
    root = Path(spec["root"])
    state = setup(spec, args.seed)
    win = window(state, args.seconds, trace=bool(args.trace))
    setup_s = origin + win["t_start"]
    kind = torch.cuda.get_device_name(0)
    device = {"platform": "gpu", "kind": kind, "count": spec["chips"],
              "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0))}
    breakdown = None
    span = win["span"]
    if args.trace:
        tl = events = None
        if span.prof is not None:
            path = root / bench.WORK_DIR / "trace.json"
            path.parent.mkdir(parents=True, exist_ok=True)
            span.prof.export_chrome_trace(str(path))
            try:
                events = timeline.read_trace(path)
            finally:
                path.unlink()
            tl = timeline.timeline(events)
        span.prof = None
        if tl is None:
            print("pimbench: the profiler saw no device activity in the "
                  "span (not measured); no result", file=sys.stderr)
            return 4
        device["busy_s"] = timeline.busy_s(tl)
        device["window_s"] = timeline.window_s(tl)
        ctx = {"timeline": tl, "window_s": timeline.window_s(tl),
               "steps": list(span.steps),
               "timed_steps": list(span.timed_steps),
               "timed_s": span.timed_s, "frozen": spec["frozen"],
               "device_kind": kind, "calls": win["calls"] - win["failed"]}
        metrics = bench.per_layer(spec, ctx)
        breakdown = {"device_ops": timeline.top_device_ops(tl),
                     "idle_gaps": host_gaps(tl, events)}
        del events
    else:
        values = {"tokens_per_s": tokens_per_s(state, win),
                  "setup_s": setup_s}
        metrics = {m["name"]: {"value": values[m["name"]],
                               "unit": m["unit"]}
                   for m in spec["end_to_end"]}
    free_program(state)
    t0 = time.perf_counter()
    checks, held = check(state, win)
    t_check = time.perf_counter() - t0
    found = bench.forbidden_modules()
    if found:
        print(f"pimbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    err = sys.stderr
    parts = dict(before, **state["setup_parts"])
    t = spec["traffic"]
    print(f"cell {args.workload} seed {args.seed}: {kind}, power limit "
          f"{power_limit()}; set-up {setup_s:.6f} s ("
          + ", ".join(f"{k} {v:.6f} s" for k, v in parts.items())
          + "); "
          f"{win['calls']} calls of {t['batch']}x({t['prompt_len']}+"
          f"{t['gen']}) tokens in {win['t_end'] - win['t_start']:.6f} s; "
          f"call seconds {[round(s, 6) for s in win['call_s']]}", file=err)
    if args.trace:
        print(f"untraced steps at positions {span.timed_steps[:1]} to "
              f"{span.timed_steps[-1:]} in {span.timed_s} s; traced steps "
              f"at {span.steps[:1]} to {span.steps[-1:]} in "
              f"{device['window_s']} s", file=err)
    for e in win["errors"][:1]:
        print(f"first failed call:\n{e}", file=err)
    print(f"held {held} requests of {len(win['outs'])} calls against the "
          f"float32 reference in {t_check:.3f} s", file=err)
    for text in bench.check_lines(checks):
        print(text, file=err)
    err.flush()
    print(json.dumps(bench.line(bench.passed(checks), win, metrics, device,
                                checks, breakdown)), flush=True)
    return 0
