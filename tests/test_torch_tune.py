"""The port's autotuner (``repro_torch.runtime.tune``) and tuned-defaults
overlay (``repro_torch.kernels.plan``), held to the reference's on the
CPU.

One case for each test of ``tests/test_tune.py`` (the default can never
lose the sweep, winners persist and install as a per-target tuned.json,
the overlay applies tuned values only to knobs left at hand defaults, the
CLI quick path runs end to end), then the parity anchors: the same
overrides give field-equal plans in both packages -- the ``schedule``
key among them -- and the ``ref`` sweep is the reference's sweep.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from repro import pim_ufunc as rpim
from repro.kernels import plan as rplan
from repro.runtime import tune as rtune
from repro_torch import pim_ufunc as pim
from repro_torch.kernels import plan as kplan
from repro_torch.runtime import tune
from repro_torch.runtime.artifact_cache import device_target

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = {"device": "cpu", "backend": "ref"}


@pytest.fixture(autouse=True)
def _clean_overlay():
    kplan.clear_tuned()
    rplan.clear_tuned()
    yield
    kplan.clear_tuned()
    rplan.clear_tuned()


@pytest.mark.parametrize("backend", ["ref", "cuda"])
def test_candidates_default_first(backend):
    for quick in (False, True):
        cands = tune.candidates(quick, backend)
        assert cands[0] == {}, "hand defaults must be the baseline"
        keys = [json.dumps(c, sort_keys=True) for c in cands]
        assert len(keys) == len(set(keys)), "duplicate sweep point"
        for c in cands:
            assert set(c) <= set(kplan.TUNABLE_FIELDS) | {"schedule"}


@pytest.mark.parametrize("quick", [False, True], ids=["full", "quick"])
def test_ref_candidates_are_the_reference_sweep(quick):
    assert tune.candidates(quick, "ref") == rtune.candidates(quick)
    cuda = tune.candidates(quick, "cuda")
    assert cuda[:len(rtune.candidates(quick))] == rtune.candidates(quick)
    assert len(cuda) == (5 if quick else 15)


def test_parse_family():
    assert tune.parse_family("add:16") == ("add", {"width": 16})
    assert tune.parse_family("fp_mul:fp16") == ("fp_mul", {"fmt": "fp16"})
    for bad in ("add", "fp_add:fp11"):
        with pytest.raises(ValueError):
            tune.parse_family(bad)
        with pytest.raises(ValueError):
            rtune.parse_family(bad)
    for fam in ("add:16", "fp_div:bf16"):
        assert tune.parse_family(fam) == rtune.parse_family(fam)
        _, x, y, _ = tune._operands(fam, 64)
        _, rx, ry, _ = rtune._operands(fam, 64)
        assert np.array_equal(x, rx) and np.array_equal(y, ry)


@pytest.mark.parametrize("family", ["add:16", "fp_mul:fp16"])
def test_tune_family_never_loses_to_defaults(family):
    """Whatever the sweep measures, the winner's wall time is <= the
    hand-default candidate's, because defaults are swept first and only
    strictly faster candidates replace them; on the CPU no kernel time is
    measured."""
    e = tune.tune_family(family, backend="ref", device="cpu", rows=256,
                         reps=1, quick=True)
    assert e["candidates"][0]["overrides"] == {}
    assert [c["overrides"] for c in e["candidates"]] == \
        rtune.candidates(True)
    assert e["us"] <= e["default_us"]
    assert e["model_cycles"] > 0
    assert e["kernel_ms"] is None and e["default_kernel_ms"] is None


def test_a_candidate_that_does_not_fit_never_wins(monkeypatch):
    """A candidate the program refuses (on the card, a CTA width whose
    state does not fit shared memory raises ``ValueError`` at resolve) is
    recorded with its error and never wins; the sweep goes on.  The
    ``cuda`` sweep runs here on the plain version."""
    plan_for = tune._plan_for

    def refusing(ov, layout, backend, device):
        if "words_per_cta" in ov:
            raise ValueError("state does not fit one CTA")
        return plan_for(ov, layout, "ref", device)
    monkeypatch.setattr(tune, "_plan_for", refusing)
    e = tune.tune_family("add:16", backend="cuda", device="cpu", rows=128,
                         reps=1, quick=True)
    (bad,) = [c for c in e["candidates"] if "words_per_cta" in c["overrides"]]
    assert bad["us"] is None and "ValueError" in bad["error"]
    assert "words_per_cta" not in e["overrides"]
    assert e["us"] <= e["default_us"]


def test_save_install_and_overlay(tmp_path):
    """A tuned.json round trip: save to a cache directory, install, and
    the ufunc frontend resolves tuned values -- but only onto knobs left
    at hand defaults; explicit choices and ``tuned=False`` win."""
    doc = {"version": tune.DOC_VERSION, "target": device_target(),
           "entries": [{"family": "add:16", "layout": "rows32",
                        "backend": "ref",
                        "overrides": {"slot_width": 4,
                                      "schedule": "dense"}}]}
    path = tune.save(doc, str(tmp_path))
    assert os.path.basename(path) == "tuned.json"
    assert tune.install(path) == 1

    x = np.arange(64, dtype=np.uint16)
    prep = pim.prepare("add", x, x, width=16, **CPU)
    assert prep.plan.backend.slot_width == 4
    assert prep.plan.schedule == "dense"
    assert np.array_equal(prep.run(), x.astype(np.uint64) * 2)

    # an explicit schedule beats the overlay; untouched knobs still tune
    prep = pim.prepare("add", x, x, width=16, schedule="slots-static", **CPU)
    assert prep.plan.schedule == "slots-static"
    assert prep.plan.backend.slot_width == 4

    # a different family is untouched
    prep = pim.prepare("mul", x, x, width=16, **CPU)
    assert prep.plan.schedule == kplan.DEFAULT_SCHEDULE

    # tuned=False forces hand defaults wholesale
    with pim.options(tuned=False):
        prep = pim.prepare("add", x, x, width=16, **CPU)
    assert prep.plan.schedule == kplan.DEFAULT_SCHEDULE
    assert prep.plan.backend.slot_width == \
        kplan.BACKENDS["ref"].slot_width


def test_save_merges_per_target(tmp_path):
    base = {"version": tune.DOC_VERSION, "target": device_target(),
            "entries": [{"family": "add:16", "layout": "rows32",
                         "backend": "ref", "overrides": {"slot_width": 4}}]}
    tune.save(base, str(tmp_path))
    update = {"version": tune.DOC_VERSION, "target": device_target(),
              "entries": [{"family": "mul:16", "layout": "rows32",
                           "backend": "ref",
                           "overrides": {"slot_width": 8}}]}
    path = tune.save(update, str(tmp_path))
    with open(path) as f:
        merged = json.load(f)
    assert {e["family"] for e in merged["entries"]} == {"add:16", "mul:16"}
    alien = dict(update, target="cuda:Other GPU:sm_80:torch-0:cuda-0")
    with open(tune.save(alien, str(tmp_path))) as f:
        assert [e["family"] for e in json.load(f)["entries"]] == ["mul:16"]


def test_install_skips_other_targets_and_versions(tmp_path):
    """A tuned.json written for another target (another card, or a
    reference TPU target) installs nothing, nor does another version or
    a defaults-won entry; a tuned.json in a cache directory written for
    another target leaves the plans as they are."""
    entries = [{"family": "add:16", "layout": "rows32", "backend": "ref",
                "overrides": {"slot_width": 4}}]
    for target in ("tpu:v9", "cuda:NVIDIA H100 80GB HBM3:sm_90:torch-0:"
                   "cuda-0", "cpu:torch-0:cuda-None"):
        assert tune.install({"version": tune.DOC_VERSION, "target": target,
                             "entries": entries}) == 0
    assert tune.install({"version": tune.DOC_VERSION + 1,
                         "target": device_target(),
                         "entries": entries}) == 0
    assert tune.install({"version": tune.DOC_VERSION,
                         "target": device_target(),
                         "entries": [dict(entries[0], overrides={})]}) == 0
    tune.save({"version": tune.DOC_VERSION, "target": "tpu:v9",
               "entries": entries}, str(tmp_path))
    x = np.arange(8, dtype=np.uint16)
    try:
        got = pim.add(x, x, width=16, cache_dir=str(tmp_path), **CPU)
        prep = pim.prepare("add", x, x, width=16, **CPU)
    finally:
        pim._ensure_artifact_cache()
    assert np.array_equal(got, x.astype(np.uint64) * 2)
    assert prep.plan.backend.slot_width == kplan.SLOT_WIDTH
    assert kplan.tuned_overrides("add:16", "rows32", "ref") is None


def test_register_tuned_rejects_bad_overrides():
    with pytest.raises((KeyError, ValueError)):
        kplan.register_tuned("add:16", "rows32", "ref", {"bogus_knob": 1})
    with pytest.raises((KeyError, ValueError)):
        kplan.register_tuned("add:16", "rows32", "ref",
                             {"schedule": "verilog"})


@pytest.mark.parametrize("overrides", [
    {"schedule": "dense", "slot_width": 4},
    {"schedule": "slots-static", "seg_levels": 64},
    {"slot_width": 8, "chunk_rows": 4096},
    {"level_max_width": 4},
], ids=["dense_sw4", "static_seg64", "sw8_chunk", "dense_cap4"])
def test_tuned_overrides_give_the_reference_plans(overrides):
    """The same registered overrides give field-equal plans in both
    packages (backend tunables, schedule, layout, chunk), and the plain
    ufunc call under them agrees."""
    for p in (rplan, kplan):
        p.register_tuned("add:16", "rows32", "ref", overrides)
        assert p.tuned_overrides("add:16", "rows32", "ref") == overrides
    x = np.arange(300, dtype=np.uint16)
    want = rpim.prepare("add", x, x, width=16, backend="ref")
    got = pim.prepare("add", x, x, width=16, **CPU)
    wb, gb = want.plan.backend, got.plan.backend
    for f in rplan.TUNABLE_FIELDS:         # each package's own stock
        if f in overrides:                 # default where untouched (the
            assert getattr(gb, f) == getattr(wb, f) == overrides[f], f
        else:                              # chunk defaults differ)
            assert getattr(gb, f) == getattr(kplan.BACKENDS["ref"], f), f
            assert getattr(wb, f) == getattr(rplan.BACKENDS["ref"], f), f
    assert (got.plan.schedule, got.plan.layout.name) == \
        (want.plan.schedule, want.plan.layout.name)
    if "chunk_rows" in overrides:
        assert got.plan.chunk_rows == want.plan.chunk_rows == \
            overrides["chunk_rows"]
    assert got.plan.schedule == overrides.get("schedule",
                                              kplan.DEFAULT_SCHEDULE)
    assert np.array_equal(got.run(), want.run())


def test_tune_cli_quick_smoke(tmp_path):
    """The CLI's --quick sweep of one family on the CPU writes a valid
    tuned.json beside the artifact cache."""
    out = tmp_path / "cache"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.runtime.tune", "--quick",
         "--backend", "ref", "--device", "cpu", "--families", "add:16",
         "--rows", "128", "--reps", "1", "--out", str(out)],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "add:16" in proc.stdout and "swept 3 points" in proc.stdout
    with open(out / "tuned.json") as f:
        doc = json.load(f)
    assert doc["version"] == tune.DOC_VERSION
    assert doc["target"] == device_target()
    (e,) = doc["entries"]
    assert e["family"] == "add:16" and e["us"] <= e["default_us"]
    assert len(e["candidates"]) == 3
