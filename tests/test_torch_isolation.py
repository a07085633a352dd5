"""The port stands alone, runs on the card by default, and refuses what it
has not ported.

* No module of ``src/repro_torch`` and not ``chip_smoke.py`` imports JAX or
  anything of the JAX package ``repro``.
* With no GPU, a default call raises instead of running on the CPU.
* Every option that is not ported raises ``NotImplementedError`` naming the
  ROADMAP item that brings it; the options and entry points ported since
  run through the port and agree with ``repro`` on the CPU.
"""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import pim_ufunc as pim
from repro_torch.kernels import plan as kplan
from repro_torch.runtime.faults import FaultModel, VerifyPolicy

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


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
        assert top not in ("jax", "jaxlib", "repro"), (path, name)
        assert not name.startswith("."), (path, name)   # escapes src/


def test_the_scan_sees_the_whole_package():
    names = {p.relative_to(PKG).as_posix() for p in SOURCES if PKG in p.parents}
    assert {"core/gates.py", "core/pim_numerics.py", "kernels/ops.py",
            "kernels/pim_exec.py", "kernels/slots.py", "kernels/plan.py",
            "kernels/transfer.py", "runtime/telemetry.py",
            "runtime/faults.py", "pim_ufunc.py"} <= names
    assert {"kernels/ref.py"} <= names
    for src in ("slot_scan.cu", "level_gather.cu", "gate_serial.cu",
                "pim_state.cuh"):
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
    ({"faults": FaultModel(seed=1)}, "A9"),
    ({"verify": True}, "A9"),
    ({"verify": VerifyPolicy()}, "A9"),
    ({"cache_dir": "artifacts"}, "A11"),
])
def test_unported_options_raise(kw, item):
    x = np.uint8([1, 2])
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        pim.add(x, x, device="cpu", backend="ref", **kw)


def test_unported_configuration_raises():
    x = np.uint8([1, 2])
    with pim.options(device="cpu", backend="ref", verify=True):
        with pytest.raises(NotImplementedError, match="ROADMAP A9"):
            pim.add(x, x)


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
