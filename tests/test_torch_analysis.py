"""The port's single-card analysis tools against the reference's: the PIM
offload planner (``core.offload``), the roofline model
(``launch.roofline``) and the abstract input specs (``launch.steps``
``batch_specs``, ``input_specs``).

Under the reference's accelerator (``TPU_DEFAULT``) every number equals
the reference's (``==``) and the offload report is the same text; under
the port's default, the H100 entry of ``core.device_model``, the
reference's own properties hold.  The specs are ``meta`` tensors of the
reference's ``jax.eval_shape`` shapes and dtypes, leaf for leaf.
"""

import dataclasses
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as RARCHS
from repro.core import offload as roffload
from repro.launch import roofline as rroofline, steps as rsteps

from repro_torch.configs.registry import ARCHS
from repro_torch.core import device_model as dm, offload
from repro_torch.launch import roofline, steps
from repro_torch.models import convert

CELLS = [(a, s) for a in ARCHS for s in steps.SHAPES]
KEPT = [(a, s) for a, s in CELLS
        if steps.cell_skip_reason(ARCHS[a], steps.SHAPES[s]) is None]


def _ids(cells):
    return [f"{a}-{s}" for a, s in cells]


# --------------------------------------------------------------------------
# the device model
# --------------------------------------------------------------------------

def test_the_reference_devices_are_unchanged():
    from repro.core import device_model as rdm
    for name in ("PIM_DEFAULT", "GPU_DEFAULT", "TPU_DEFAULT"):
        assert dataclasses.asdict(getattr(dm, name)) == \
            dataclasses.asdict(getattr(rdm, name)), name


def test_h100_entry():
    """The H100 SXM 80GB at 700 W, from NVIDIA's data sheet: one card, two
    views of it that agree on the memory rate."""
    assert dm.H100_GPU.mem_bw == dm.H100.hbm_bw == 3.35e12
    assert dm.H100_GPU.tdp_w == 700.0
    assert dm.H100.peak_bf16_flops == 989e12
    assert dm.H100.ici_bw == 450e9 and dm.H100.hbm_bytes == 80 * 10 ** 9
    assert dm.H100.name == dm.H100_GPU.name
    # the bandwidth roofline of an fp32 add: 3 operands of 4 bytes
    assert dm.H100_GPU.throughput_ops(4) == 3.35e12 / 12


# --------------------------------------------------------------------------
# the offload planner
# --------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_offload_matches_reference_under_its_accelerator(arch, size):
    cfg, rcfg = ARCHS[arch], RARCHS[arch]
    batch, seq = (128, 32768) if size == "full" else (1, 8)
    if size == "reduced":
        cfg, rcfg = cfg.reduced(), rcfg.reduced()
    got = offload.decode_step_plan(cfg, batch, seq, accel=dm.TPU_DEFAULT)
    want = roffload.decode_step_plan(rcfg, batch, seq)
    assert [dataclasses.asdict(p) for p in got] == \
        [dataclasses.asdict(p) for p in want]
    assert offload.report(cfg, batch, seq, accel=dm.TPU_DEFAULT) == \
        roffload.report(rcfg, batch, seq)


def test_offload_planner_on_the_h100():
    """The reference test's properties under the port's default, and the
    report naming the chip."""
    cfg = ARCHS["rwkv6-1.6b"]
    plans = offload.decode_step_plan(cfg, batch=128, seq=32768)
    assert any(p.offload for p in plans)       # Mi-scale elementwise wins
    small = offload.decode_step_plan(cfg.reduced(), batch=1, seq=8)
    assert not all(p.offload for p in small)   # tiny vectors lose (latency)
    text = offload.report(cfg)
    assert "offload plan" in text
    head, cols = text.splitlines()[:2]
    assert head.endswith(f"on {dm.H100.name}") and "h100_us" in cols
    for p in plans:
        assert p.tpu_us == round(p.n_elems * 6 / 3.35e12 * 1e6, 3)


def test_offload_on_the_h100_is_tpu_scaled():
    """The accelerator's time scales with its bandwidth alone; the PIM time
    and the element counts do not move."""
    for cfg in ARCHS.values():
        h = offload.decode_step_plan(cfg, 128, 32768)
        t = offload.decode_step_plan(cfg, 128, 32768, accel=dm.TPU_DEFAULT)
        assert [(p.name, p.n_elems, p.pim_us) for p in h] == \
            [(p.name, p.n_elems, p.pim_us) for p in t]
        for a, b in zip(h, t):
            assert a.tpu_us == pytest.approx(b.tpu_us * 819e9 / 3.35e12,
                                             abs=1e-3)
            assert a.offload == (a.pim_us < a.n_elems * 6 / 3.35e12 * 1e6)


def test_offload_main_prints_the_h100_plan():
    import os
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parent.parent / "src"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.core.offload"], check=True,
        capture_output=True, text=True,
        env={**os.environ, "PYTHONPATH": str(src)}).stdout
    assert out == offload.report(ARCHS["rwkv6-1.6b"]) + "\n"


# --------------------------------------------------------------------------
# the roofline
# --------------------------------------------------------------------------

@pytest.mark.parametrize("arch,shape", CELLS, ids=_ids(CELLS))
def test_roofline_terms_equal_the_reference(arch, shape):
    cfg, rcfg = ARCHS[arch], RARCHS[arch]
    plan, rplan = steps.SHAPES[shape], rsteps.SHAPES[shape]
    assert roofline.kv_cache_bytes(cfg, plan.seq, plan.global_batch) == \
        rroofline.kv_cache_bytes(rcfg, rplan.seq, rplan.global_batch)
    assert roofline.model_flops(cfg, plan) == \
        rroofline.model_flops(rcfg, rplan)
    assert roofline.CHIPS == rroofline.CHIPS and roofline.TP == rroofline.TP
    for chips in roofline.CHIPS.values():
        assert roofline.traffic_model(cfg, plan, chips) == \
            rroofline.traffic_model(rcfg, rplan, chips)


def _records(tmp_path, seed: int = 0) -> list:
    """Hand-made dry-run records in the reference's schema
    (``launch/dryrun.py``): every cell on both meshes, the skipped ones as
    skips, and one perf-iteration variant the loader leaves out."""
    rng = np.random.default_rng(seed)
    recs = []
    for arch, shape in CELLS:
        cfg, plan = RARCHS[arch], rsteps.SHAPES[shape]
        for mesh in rroofline.CHIPS:
            rec = {"arch": arch, "shape": shape, "mesh": mesh,
                   "kind": plan.kind,
                   "skip": rsteps.cell_skip_reason(cfg, plan)}
            if not rec["skip"]:
                rec.update({
                    "variant": "baseline",
                    "accum": rsteps.accum_for(cfg, plan),
                    "n_params": cfg.n_params,
                    "n_params_active": cfg.n_params_active,
                    "memory": {"argument_size_in_bytes":
                               int(rng.integers(1, 1 << 36)),
                               "temp_size_in_bytes":
                               int(rng.integers(1, 1 << 36))},
                    "cost": {"flops": float(rng.uniform(1e12, 1e16))},
                    "hlo_dot_flops": float(rng.uniform(1e12, 1e16)),
                    "hlo_mem_bytes": float(rng.uniform(1e9, 1e12)),
                    "collectives": {
                        k: {"count": int(rng.integers(1, 100)),
                            "bytes": float(rng.uniform(1e6, 1e11))}
                        for k in ("all-gather", "all-reduce",
                                  "reduce-scatter")},
                })
            recs.append(rec)
    variant = dict(next(r for r in recs if not r["skip"]),
                   variant="fused_accum")
    recs.append(variant)
    for i, rec in enumerate(recs):
        tag = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}__{i}"
        (tmp_path / f"{tag}.json").write_text(json.dumps(rec))
    return recs


def test_analyze_load_markdown_equal_the_reference(tmp_path):
    recs = _records(tmp_path)
    tpu = {"accel": dm.TPU_DEFAULT}
    for rec in recs:
        if not rec["skip"]:
            assert roofline.analyze(rec, **tpu) == rroofline.analyze(rec)
    for mesh in roofline.CHIPS:
        got = roofline.load(str(tmp_path), mesh, **tpu)
        assert got == rroofline.load(str(tmp_path), mesh)
        assert len(got) == len(KEPT)
    assert roofline.markdown(str(tmp_path), **tpu) == \
        rroofline.markdown(str(tmp_path))


def test_analyze_on_the_h100(tmp_path):
    """Under the port's default each term divides by the H100's rate."""
    for rec in _records(tmp_path, seed=1):
        if rec["skip"]:
            continue
        got = roofline.analyze(rec)
        want = rroofline.analyze(rec)
        assert got["compute_s"] == rec["hlo_dot_flops"] / 989e12
        assert got["memory_s"] == want["traffic"]["total"] / 3.35e12
        assert got["collective_s"] == want["coll_bytes"] / 450e9
        assert got["model_flops"] == want["model_flops"]
        assert got["useful_ratio"] == want["useful_ratio"]
    assert roofline.markdown(str(tmp_path)).count("\n") == len(KEPT) + 1


# --------------------------------------------------------------------------
# the abstract input specs
# --------------------------------------------------------------------------

def _dtype(x) -> str:
    return str(x.dtype).removeprefix("torch.")


def _same(t: torch.Tensor, ref, what, stacked: bool = False) -> None:
    """``t`` is a meta tensor of ``ref``'s shape (less its leading axis
    when ``stacked``) and dtype."""
    assert t.device.type == "meta", what
    assert tuple(t.shape) == tuple(ref.shape)[int(stacked):], what
    assert _dtype(t) == _dtype(ref), what


@pytest.mark.parametrize("arch,shape", KEPT, ids=_ids(KEPT))
def test_batch_specs_match_the_reference(arch, shape):
    got = steps.batch_specs(ARCHS[arch], steps.SHAPES[shape])
    want = rsteps.batch_specs(RARCHS[arch], rsteps.SHAPES[shape])
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k], k)


def _at(tree, path):
    for key in path:
        tree = tree[key]
    return tree


def _tree_matches(cfg, tree, ref_tree) -> int:
    """Every reference leaf of ``ref_tree`` has the port's tensors of
    ``tree`` (an ``LM`` or a tree of its shape) in its shape and dtype,
    a group's stacked on its leading axis; returns the elements."""
    leaves = convert.reference_leaves(cfg, tree)
    assert len(leaves) == len(jax.tree.leaves(ref_tree))
    total = 0
    for path, tensors in leaves:
        ref = _at(ref_tree, path)
        for t in tensors:
            _same(t, ref, path, stacked=convert.stacked(path))
            total += t.numel()
        if convert.stacked(path):
            assert ref.shape[0] == len(tensors) == cfg.n_groups, path
    return total


@pytest.mark.parametrize("arch,shape", KEPT, ids=_ids(KEPT))
def test_input_specs_match_eval_shape(arch, shape):
    """``input_specs`` on ``meta`` against ``jax.eval_shape``, leaf for
    leaf after ``convert``'s name mapping: the parameters (their total
    the reference's leaves' total), AdamW's state and the decode caches
    (the port's per-layer list against the reference's stacked groups).
    ``cfg.n_params`` is the reference's analytic count, which leaves out
    the norms' vectors, so it is not the total of either package."""
    cfg, plan = ARCHS[arch], steps.SHAPES[shape]
    got = steps.input_specs(cfg, plan)
    want = rsteps.input_specs(RARCHS[arch], rsteps.SHAPES[shape])
    assert set(got) == set(want)
    total = _tree_matches(cfg, got["params"], want["params"])
    assert total == sum(math.prod(l.shape)
                        for l in jax.tree.leaves(want["params"]))
    for k in want["batch"]:
        _same(got["batch"][k], want["batch"][k], k)
    if "opt" in want:
        for k in ("m", "v"):
            assert _tree_matches(cfg, got["opt"][k], want["opt"][k]) == total
        _same(got["opt"]["step"], want["opt"]["step"], "step")
    if "caches" in want:
        caches, ref = got["caches"], want["caches"]
        assert len(caches) == cfg.n_layers
        n = 0
        for i, cache in enumerate(caches):
            for key, t in cache.items():
                path, g = convert._reference_path(cfg, f"layers.{i}.{key}")
                _same(t, _at(ref, path), path, stacked=g is not None)
                if g is not None:
                    assert _at(ref, path).shape[0] == cfg.n_groups
                n += 1
        assert n == len(jax.tree.leaves(ref["prefix"])) + \
            cfg.n_groups * len(jax.tree.leaves(ref["groups"]))


def test_input_specs_allocate_nothing():
    """The largest config's specs are all ``meta``: no storage, no
    generator."""
    cfg = ARCHS["deepseek-v2-236b"]
    specs = steps.input_specs(cfg, steps.SHAPES["train_4k"])
    tensors = list(specs["params"].parameters()) + \
        list(specs["opt"]["m"].parameters()) + \
        list(specs["opt"]["v"].parameters()) + list(specs["batch"].values())
    assert all(t.is_meta for t in tensors)
    assert sum(t.numel() for t in specs["params"].parameters()) > 2.3e11
