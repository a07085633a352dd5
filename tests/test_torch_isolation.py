"""The port stands alone, runs on the card by default, and refuses what it
has not ported.

* No module of ``src/repro_torch``, no script of ``examples_torch`` and not
  ``chip_smoke.py`` imports JAX, anything of the JAX package ``repro`` or
  ``ml_dtypes`` (the port reads bfloat16 bits through ``int16``).
* With no GPU, a default call raises instead of running on the CPU.
* What is not ported raises ``NotImplementedError`` naming the ROADMAP
  item that brings it; the options and entry points ported since (the
  artifact cache's ``cache_dir=`` and ``--pim-cache-dir`` among them) run
  through the port and agree with ``repro`` on the CPU.
* The port's ``kernels.ops`` has every public name of ``repro``'s but the
  JAX-only ones.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import pim_ufunc as pim
from repro_torch.kernels import plan as kplan

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + \
    sorted((ROOT / "examples_torch").glob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    """Absolute names of every module ``path`` imports; relative imports
    are resolved against the file's place in ``src``."""
    tree = ast.parse(path.read_text(), filename=str(path))
    parts = path.relative_to(ROOT / "src").with_suffix("").parts \
        if PKG in path.parents else ()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0:
                yield node.module
                continue
            base = parts[:len(parts) - node.level]
            if not base:
                yield "." * node.level + (node.module or "")
                continue
            yield ".".join(base + ((node.module,) if node.module else ()))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(ROOT)) for p in SOURCES])
def test_no_jax_and_no_reference_imports(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "ml_dtypes"), \
            (path, name)
        assert not name.startswith("."), (path, name)   # escapes src/


def test_the_scan_sees_the_whole_package():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES if PKG in p.parents}
    assert {"core/gates.py", "core/pim_numerics.py", "kernels/ops.py",
            "kernels/pim_exec.py", "kernels/slots.py", "kernels/plan.py",
            "kernels/transfer.py", "runtime/telemetry.py",
            "runtime/faults.py", "pim_ufunc.py"} <= names
    assert {"kernels/ref.py"} <= names
    assert {"runtime/pim_batch.py", "runtime/fault_tolerance.py",
            "launch/serve.py"} <= names
    assert {"runtime/artifact_cache.py", "runtime/tune.py"} <= names
    assert {"models/config.py", "models/layers.py", "models/model.py",
            "models/convert.py", "configs/registry.py", "configs/qwen3_8b.py",
            "launch/steps.py"} <= names
    assert {"optim/adamw.py", "data/pipeline.py", "checkpoint/manager.py",
            "runtime/train_loop.py", "launch/train.py"} <= names
    assert (ROOT / "examples_torch" / "train_lm.py") in SOURCES
    assert len([n for n in names if n.startswith("configs/")]) == 12
    for src in ("slot_scan.cu", "level_gather.cu", "gate_serial.cu",
                "check_words.cu", "pim_state.cuh", "ring.cuh"):
        assert (PKG / "csrc" / src).exists(), src


def test_default_call_raises_without_a_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    a = np.float32([1.0, 2.0])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pim.fp_add(a, a)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        pim.add(np.uint8([1]), np.uint8([2]), backend="ref")


def test_cuda_backend_refuses_the_cpu():
    a = np.float32([1.0, 2.0])
    with pytest.raises(ValueError, match="backend 'cuda' runs only on a "
                       "CUDA device"):
        pim.fp_add(a, a, device="cpu")
    with pytest.raises(ValueError, match="CUDA device"):
        kplan.as_plan(backend="cuda", device="cpu")


@pytest.mark.parametrize("kw,item", [
    ({"cache_dir": "artifacts"}, "A11"),
])
def test_unported_options_raise(kw, item, tmp_path):
    """The options that raised for want of their ROADMAP item run since
    it was ported: ``cache_dir=`` (A11) installs the artifact cache, whose
    schedule entries are the reference's, and the result is
    ``repro``'s."""
    from repro import pim_ufunc as rpim
    from repro_torch.kernels import ops as tops
    x = np.uint8([1, 2])
    kw = {k: str(tmp_path / v) for k, v in kw.items()}
    tops.clear_compiled_cache()
    try:
        got = pim.add(x, x, device="cpu", backend="ref", **kw)
        assert tops.artifact_cache().root == kw["cache_dir"], item
    finally:
        pim._ensure_artifact_cache()
    assert np.array_equal(got, rpim.add(x, x))
    assert [n for n in (tmp_path / "artifacts").iterdir()
            if n.name.startswith("sched-")]


def test_training_raises_without_a_gpu(monkeypatch, tmp_path):
    """Training (ROADMAP A15) runs on the card by default: with no GPU
    ``launch.train`` raises before it builds the model."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--reduced", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])


def test_lm_serving_raises_without_a_gpu(monkeypatch):
    """A call with no ``--pim*`` mode serves the LM (ROADMAP A13), on the
    card by default: with no GPU it raises before it builds the model."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main([])


def test_serve_cache_dir_raises_the_artifact_cache_item(tmp_path, capsys,
                                                        monkeypatch):
    """``--pim-cache-dir`` raised ROADMAP A11's ``NotImplementedError``
    until the artifact cache was ported; now it warm-starts the server
    from the directory (a ``warm_start`` line with the reference's keys
    and the port's ``streams``) and writes fresh artifacts through."""
    import io
    import json
    from repro_torch.kernels import ops as tops
    from repro_torch.launch import serve
    tops.clear_compiled_cache()
    monkeypatch.setattr("sys.stdin", io.StringIO(
        '{"op":"add","dtype":"uint8","x":[1,2],"y":[3,4]}\n'))
    cache_dir = tmp_path / "artifacts"
    try:
        serve.main(["--pim-serve", "--pim-device", "cpu",
                    "--pim-cache-dir", str(cache_dir)])
    finally:
        pim._ensure_artifact_cache()
    out, err = capsys.readouterr()
    assert json.loads(out)["result"] == [4, 6]
    (warm,) = [json.loads(l) for l in err.splitlines()
               if '"warm_start"' in l]
    assert {"dir", "schedules", "executables", "skipped", "us"} <= set(warm)
    assert [n for n in cache_dir.iterdir() if n.name.startswith("sched-")]


@pytest.mark.parametrize("mode", [["--pim-serve"], ["--pim-stdin"],
                                  ["--pim", "add", "--pim-rows", "8"]])
def test_serve_raises_without_a_gpu(monkeypatch, mode):
    """With no GPU the server's default device raises before it reads a
    line; it never serves on the CPU unless ``--pim-device cpu`` asks."""
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(mode)


def _fault_kw(module, name: str) -> dict:
    """The fault options of the former refusal cases, built from
    ``module`` (``repro.runtime.faults`` or the port's)."""
    return {"faults": {"faults": module.FaultModel(
                seed=1, force_flips=((0, 3),))},
            "verify": {"verify": True},
            "policy": {"verify": module.VerifyPolicy(backoff_s=1e-5)},
            "both": {"faults": module.FaultModel(seed=1,
                                                 force_flips=((0, 3),)),
                     "verify": module.VerifyPolicy(backoff_s=1e-5)}}[name]


@pytest.mark.parametrize("name", ["faults", "verify", "policy", "both"])
def test_fault_options_match_reference(name):
    """``faults=``/``verify=`` run through the port and agree with
    ``repro``: the result (corrupted at the same bit where there is no
    policy) and the health counters."""
    from repro import pim_ufunc as rpim
    from repro.kernels import ops as rops
    from repro.runtime import faults as rfaults
    from repro_torch.kernels import ops as tops
    from repro_torch.runtime import faults as tfaults
    x = np.arange(100, dtype=np.uint8)
    y = x[::-1].copy()
    for ops in (rops, tops):
        ops.drain_health()
        ops._spot_debt = 1 << 62
    want = rpim.add(x, y, backend="ref", **_fault_kw(rfaults, name))
    want_health = rops.drain_health()
    got = pim.add(x, y, device="cpu", backend="ref",
                  **_fault_kw(tfaults, name))
    assert got.dtype == want.dtype and np.array_equal(got, want)
    assert tops.drain_health() == want_health
    if name == "faults":
        assert not np.array_equal(got, x.astype(np.uint16) + y)
    for f in (rfaults, tfaults):
        f.drain_media_health()


def test_fault_configuration_matches_reference():
    """The configured ``verify=`` default runs through the port as it does
    through ``repro``."""
    from repro import pim_ufunc as rpim
    from repro.kernels import ops as rops
    from repro_torch.kernels import ops as tops
    x = np.uint8([1, 2])
    for ops in (rops, tops):
        ops.drain_health()
        ops._spot_debt = 1 << 62
    with rpim.options(backend="ref", verify=True):
        want = rpim.add(x, x)
    with pim.options(device="cpu", backend="ref", verify=True):
        got = pim.add(x, x)
    assert np.array_equal(got, want) and np.array_equal(got, x + x)
    assert tops.drain_health() == rops.drain_health() == {"spot_checks": 1}


def test_plan_key_separates_fault_plans_like_reference():
    """``ExecPlan.key`` carries faults and verify (a faulty request never
    coalesces with a clean one), ``compile_key`` neither, in both
    packages."""
    from repro.kernels import ops as rops
    from repro.runtime import faults as rfaults
    from repro_torch.kernels import ops as tops
    from repro_torch.runtime import faults as tfaults
    out = []
    for ops, f, kw in ((rops, rfaults, {"backend": "ref"}),
                       (tops, tfaults, {"backend": "ref", "device": "cpu"})):
        plans = [ops.make_plan(**kw),
                 ops.make_plan(**kw, faults=f.FaultModel(seed=1)),
                 ops.make_plan(**kw, faults=f.FaultModel(seed=2)),
                 ops.make_plan(**kw, verify=True),
                 ops.make_plan(**kw, verify=f.VerifyPolicy(max_retries=1))]
        keys = [p.key for p in plans]
        out.append([[a == b for b in keys] for a in keys])
        assert len({p.compile_key for p in plans}) == 1
    assert out[0] == out[1]
    assert sum(map(sum, out[1])) == 5        # every plan its own key


@pytest.mark.parametrize("kw", [{"faults": "model"}, {"verify": True}],
                         ids=["faults", "verify"])
def test_plan_is_exclusive_with_fault_options_like_reference(kw):
    """An explicit ``plan=`` beside ``faults=``/``verify=`` raises
    ``TypeError`` in both packages, and takes none of the configured
    fault defaults."""
    from repro import pim_ufunc as rpim
    from repro.kernels import ops as rops
    from repro.runtime import faults as rfaults
    from repro_torch.kernels import ops as tops
    from repro_torch.runtime import faults as tfaults
    x = np.uint8([1, 2])
    for p, ops, f, cpu in ((rpim, rops, rfaults, {"backend": "ref"}),
                           (pim, tops, tfaults,
                            {"backend": "ref", "device": "cpu"})):
        opt = {k: f.FaultModel(seed=1) if v == "model" else v
               for k, v in kw.items()}
        plan = ops.make_plan(**cpu)
        with pytest.raises(TypeError, match="plan= is exclusive with the "
                           f"{next(iter(kw))}= convenience keyword"):
            p.add(x, x, plan=plan, **opt)
        ops.drain_health()
        with p.options(**opt):
            got = p.prepare("add", x, x, plan=plan)
        assert got.plan.faults is None and got.plan.verify is None
        assert np.array_equal(got.run(), x + x)
        assert not ops.drain_health()


def test_numpy_backend_drops_and_refuses_faults_like_reference():
    """``backend="numpy"``, the oracle, drops faults and verify at the
    ufunc boundary and refuses them in an ``ExecPlan``, in both
    packages."""
    from repro import pim_ufunc as rpim
    from repro.kernels import ops as rops
    from repro.runtime import faults as rfaults
    from repro_torch.kernels import ops as tops
    from repro_torch.runtime import faults as tfaults
    x = np.arange(40, dtype=np.uint8)
    for p, ops, f in ((rpim, rops, rfaults), (pim, tops, tfaults)):
        fm = f.FaultModel(seed=1, p_flip=1.0)
        prep = p.prepare("add", x, x, backend="numpy", faults=fm,
                         verify=True)
        assert prep.plan.faults is None and prep.plan.verify is None
        assert np.array_equal(prep.run(), x.astype(np.uint16) + x)
        assert not ops.drain_health()
        with pytest.raises(ValueError, match="fault injection / verified "
                           "execution require a levelized"):
            ops.make_plan(backend="numpy", faults=fm)


#: Public names of ``repro.kernels.ops`` the port does not carry: the JAX
#: and Pallas ones.
_JAX_ONLY = {"Mesh", "P", "shard_map", "TILE_W", "make_slots_static"}


def test_ops_has_the_reference_public_names():
    import inspect
    from repro.kernels import ops as rops
    from repro_torch.kernels import ops as tops
    public = {n for n, v in vars(rops).items()
              if not n.startswith("_") and not inspect.ismodule(v)}
    missing = {n for n in public - set(vars(tops))
               if not n.startswith("pim_exec_")} - _JAX_ONLY
    assert not missing, sorted(missing)
    assert {"artifact_cache", "set_artifact_cache", "note_provenance",
            "provenance_of"} <= set(vars(tops))


@pytest.mark.parametrize("kw", [{"shards": 2}, {"mesh": ("cpu", "cpu")}],
                         ids=["shards", "mesh"])
def test_sharding_options_match_reference(kw):
    """``shards=`` (no CUDA device here: one shard) and ``mesh=`` (two
    shards on the CPU) run through the port and agree with ``repro``."""
    from repro import pim_ufunc as rpim
    x = np.arange(100, dtype=np.uint8)
    y = x[::-1].copy()
    want = rpim.add(x, y)
    got = pim.add(x, y, device="cpu", backend="ref", **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


def _lazy_sum(p, a, b):
    return p.lazy(a, width=8) + p.lazy(b, width=8)


@pytest.mark.parametrize("name", ["lazy", "fuse", "reduce_sum", "dot",
                                  "gemv"])
def test_fusion_entry_points_match_reference(name):
    """The entry points of fusion and the packed reductions run through
    the port and agree with ``repro``."""
    from repro import pim_ufunc as rpim
    a = np.arange(1, 13, dtype=np.uint8)
    b = (a * 7 % 11).astype(np.uint8)
    ref = {"backend": "ref"}
    cpu = {"device": "cpu", "backend": "ref"}
    calls = {
        "lazy": lambda p, kw: _lazy_sum(p, a, b).run(**kw),
        "fuse": lambda p, kw: p.fuse(_lazy_sum(p, a, b), **kw).run(),
        "reduce_sum": lambda p, kw: p.reduce_sum(_lazy_sum(p, a, b), **kw),
        "dot": lambda p, kw: p.dot(a, b, **kw),
        "gemv": lambda p, kw: p.gemv(a.reshape(3, 4), b[:4], **kw),
    }
    got, want = calls[name](pim, cpu), calls[name](rpim, ref)
    assert np.array_equal(np.asarray(got, np.uint64),
                          np.asarray(want, np.uint64))
