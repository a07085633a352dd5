"""The state around the port's train step against ``repro`` on the CPU:
``models.convert.to_reference``, ``checkpoint.manager``,
``runtime.train_loop``, ``launch.train`` and ``examples_torch/train_lm.py``.

Checkpoints are compared byte for byte: the same state written by both
managers gives equal ``arr_*.npy`` files and manifest leaves, and each
package restores the other's to the same bits.  The port's versions of
``test_system.py``'s ``test_tiny_lm_loss_decreases`` and
``test_resume_is_bit_identical`` run the port alone: its step writes the
parameters in place, so the resumed run starts from a fresh model that
the checkpoint fills (the reference's test feeds one functional state to
two loops).
"""

import json
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.manager import CheckpointManager as RManager
from repro.configs.registry import ARCHS as RARCHS
from repro.optim import adamw as radamw
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.registry import ARCHS as TARCHS
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.launch import steps, train
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.runtime.train_loop import PreemptionGuard, train_loop
from test_torch_lm import _cfgs, _random_tree
from test_torch_train import _f32_tree

ROOT = Path(__file__).resolve().parent.parent


def _bits(a) -> np.ndarray:
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


@pytest.mark.parametrize("name", list(RARCHS))
def test_to_reference_inverts_from_reference(name):
    """``to_reference(from_reference(tree))`` is ``tree`` bit for bit (its
    structure, stacked group leaves, 0-d leaves, bfloat16 as ``uint16``),
    and ``from_reference`` takes that output back to equal tensors."""
    rcfg, cfg = _cfgs(name)
    tree = _random_tree(rcfg, 5)
    lm = convert.from_reference(cfg, tree, device="cpu")
    back = convert.to_reference(cfg, lm)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(got, _bits(want))
        assert got.dtype == _bits(want).dtype
    again = convert.from_reference(cfg, back, device="cpu")
    for (n, a), (m, b) in zip(lm.named_parameters(),
                              again.named_parameters()):
        assert n == m and a.dtype == b.dtype and torch.equal(a, b), n


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------

def _states(name: str, seed: int = 6):
    """One training state in both packages: bfloat16 parameters, random
    float32 moments, step 7 (int32)."""
    rcfg, cfg = _cfgs(name)
    tree = _random_tree(rcfg, seed)
    rng = np.random.default_rng(seed)
    draw = lambda: jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), tree)
    m, v = draw(), draw()
    ref = {"params": jax.tree.map(jnp.asarray, tree),
           "opt": {"m": jax.tree.map(jnp.asarray, m),
                   "v": jax.tree.map(jnp.asarray, v),
                   "step": jnp.int32(7)}}
    port = {"params": convert.from_reference(cfg, tree, device="cpu"),
            "opt": {"m": _f32_tree(cfg, m), "v": _f32_tree(cfg, v),
                    "step": torch.tensor(7, dtype=torch.int32)}}
    return cfg, ref, port


def _port_leaves(cfg, state) -> list:
    """A port state's leaves in the reference's order, as numpy bits."""
    return (jax.tree.leaves(convert.to_reference(cfg, state["opt"]["m"]))
            + [state["opt"]["step"].numpy()]
            + jax.tree.leaves(convert.to_reference(cfg, state["opt"]["v"]))
            + jax.tree.leaves(convert.to_reference(cfg, state["params"])))


CKPT_ARCHS = ["deepseek-v2-236b", "llama-3.2-vision-90b"]


@pytest.mark.parametrize("name", CKPT_ARCHS)
def test_both_managers_write_the_same_files(name, tmp_path):
    """deepseek has a prefix layer, llama-vision a 0-d leaf in a group."""
    _, ref, port = _states(name)
    RManager(str(tmp_path / "ref")).save(3, ref)
    CheckpointManager(str(tmp_path / "port")).save(3, port)
    a, b = tmp_path / "ref" / "step_00000003", \
        tmp_path / "port" / "step_00000003"
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    for n in names:
        if n.endswith(".npy"):
            assert (a / n).read_bytes() == (b / n).read_bytes(), n
    ma, mb = (json.loads((d / "manifest.json").read_text()) for d in (a, b))
    for key in ("step", "n_leaves", "leaves", "digest"):
        assert ma[key] == mb[key], key
    assert any(leaf["dtype"] == "bfloat16" for leaf in mb["leaves"])
    assert (tmp_path / "port" / "LATEST").read_text() == "3"


@pytest.mark.parametrize("name", CKPT_ARCHS)
def test_each_package_restores_the_other_s(name, tmp_path):
    cfg, ref, port = _states(name)
    RManager(str(tmp_path / "ref")).save(3, ref)
    CheckpointManager(str(tmp_path / "port")).save(3, port)
    _, ref0, port0 = _states(name, seed=9)          # other values
    got = CheckpointManager(str(tmp_path / "ref")).restore(port0)
    assert isinstance(got["params"], M.LM)
    assert got["params"]["embed"].dtype == torch.bfloat16
    assert got["opt"]["step"].dtype == torch.int32
    want = [_bits(x) for x in jax.tree.leaves(ref)]
    for g, w in zip(_port_leaves(cfg, got), want):
        np.testing.assert_array_equal(g, w)
    back = RManager(str(tmp_path / "port")).restore(ref0)
    for g, w in zip(jax.tree.leaves(back), jax.tree.leaves(ref)):
        assert np.asarray(g).dtype == np.asarray(w).dtype
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert int(port0["opt"]["step"]) == 7           # the template unchanged
    assert not torch.equal(port0["params"]["embed"],
                           port["params"]["embed"])


def test_bf16_round_trip_onto_the_template(tmp_path):
    """A bfloat16 leaf's bits come back through ``uint16``, every leaf on
    its template's device and in its dtype; a list keeps its type."""
    tree = {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": torch.randn(3, 4).to(torch.bfloat16)},
            "l": [torch.tensor(-0.0, dtype=torch.bfloat16)],
            "step": torch.tensor(7, dtype=torch.int32)}
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, tree)
    man = json.loads((tmp_path / "step_00000001" / "manifest.json")
                     .read_text())
    assert [leaf["dtype"] for leaf in man["leaves"]] == \
        ["float32", "bfloat16", "bfloat16", "int32"]
    out = ckpt.restore(tree)
    assert isinstance(out["l"], list)
    for a, b in ((out["a"], tree["a"]), (out["b"]["c"], tree["b"]["c"]),
                 (out["l"][0], tree["l"][0]), (out["step"], tree["step"])):
        assert a.dtype == b.dtype and a.device == b.device
        assert torch.equal(a.view(-1).view(torch.uint8),
                           b.view(-1).view(torch.uint8))


def test_keep_latest_and_refusals(tmp_path):
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    with pytest.raises(FileNotFoundError):
        ckpt.restore({"w": torch.zeros(2)})
    tree = {"w": torch.zeros(4), "step": torch.tensor(0)}
    for s in (1, 2, 3):
        ckpt.save(s, tree)
    assert ckpt.all_steps() == [2, 3]          # retention pruned step 1
    assert ckpt.latest_step() == 3
    assert (tmp_path / "LATEST").read_text() == "3"
    os.makedirs(str(tmp_path / "step_00000099.tmp"))
    assert ckpt.all_steps() == [2, 3]          # a crashed save is invisible
    with pytest.raises(ValueError, match="tree mismatch"):
        ckpt.restore({"w": torch.zeros(4)})
    with pytest.raises(ValueError, match="template"):
        ckpt.restore({"w": torch.zeros(5), "step": torch.tensor(0)})
    assert torch.equal(ckpt.restore(tree, step=2)["w"], tree["w"])


def test_save_async_copies_before_it_returns(tmp_path):
    """An in-place update right after ``save_async`` (the next train step)
    does not reach the checkpoint."""
    ckpt = CheckpointManager(str(tmp_path))
    w = torch.arange(1 << 16, dtype=torch.float32)
    want = w.clone()
    ckpt.save_async(5, {"w": w})
    w.add_(1.0)
    ckpt.wait()
    assert ckpt.latest_step() == 5
    assert torch.equal(ckpt.restore({"w": w})["w"], want)


# --------------------------------------------------------------------------
# the loop
# --------------------------------------------------------------------------

def test_train_loop_resume(tmp_path):
    """The reference's loop test on port tensors: a checkpoint every 3
    steps, then a restart from the one at step 6."""
    def step_fn(state, batch):
        s = state["step"] + 1
        return {"step": s, "w": state["w"] * 0.9}, {"loss": s.float()}

    cfg = DataConfig(vocab=100, seq_len=8, global_batch=2)
    ckpt = CheckpointManager(str(tmp_path), keep=2)
    state = {"step": torch.tensor(0, dtype=torch.int32), "w": torch.ones(4)}
    train_loop(step_fn=step_fn, state=state, data_iter=DataIterator(cfg),
               ckpt=ckpt, total_steps=7, ckpt_every=3, log_every=0,
               log_fn=lambda *_: None)
    assert ckpt.all_steps() == [4, 7]
    logs = []
    out = train_loop(step_fn=step_fn, state=state,
                     data_iter=DataIterator(cfg), ckpt=ckpt, total_steps=9,
                     ckpt_every=100, log_every=0, log_fn=logs.append)
    assert logs == ["[resume] restored step 7"]
    assert int(out["state"]["step"]) == 9
    assert np.isclose(float(out["state"]["w"][0]), 0.9 ** 9)


def test_preemption_checkpoints_and_exits(tmp_path):
    """SIGTERM in a step: the loop saves the steps done and stops; the
    handlers it replaced are back afterwards."""
    def step_fn(state, batch):
        if int(state["step"]) == 2:
            os.kill(os.getpid(), signal.SIGTERM)
        return {"step": state["step"] + 1}, {}

    before = signal.getsignal(signal.SIGTERM)
    ckpt = CheckpointManager(str(tmp_path))
    logs = []
    out = train_loop(step_fn=step_fn, state={"step": torch.tensor(0)},
                     data_iter=DataIterator(DataConfig(8, 4, 1)), ckpt=ckpt,
                     total_steps=10, ckpt_every=0, log_every=0,
                     log_fn=logs.append)
    assert int(out["state"]["step"]) == 3 and ckpt.latest_step() == 3
    assert logs == ["[preempt] checkpointing at step 2 and exiting"]
    assert signal.getsignal(signal.SIGTERM) == before
    guard = PreemptionGuard(signals=())
    assert not guard.requested


def _mini_setup(tmp_path, total):
    """The reference's ``_mini_setup`` (``tests/test_system.py``) in the
    port: reduced qwen3-8b at vocab 64, seed 1, lr 1e-3, warmup 2."""
    cfg = TARCHS["qwen3-8b"].reduced(vocab=64)
    params = M.init_model(cfg, torch.Generator().manual_seed(1),
                          device="cpu")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, total_steps=total, warmup_steps=2)
    step = steps.make_train_step(cfg, 1, opt_cfg)
    dcfg = DataConfig(vocab=64, seq_len=32, global_batch=4, seed=0)

    def step_fn(state, batch):
        mb = {k: torch.from_numpy(v)[None] for k, v in batch.items()}
        p, o, metrics = step(state["params"], state["opt"], mb)
        return {"params": p, "opt": o}, metrics

    state = {"params": params, "opt": adamw.init(params)}
    return step_fn, state, dcfg, CheckpointManager(str(tmp_path), keep=2)


def test_tiny_lm_loss_decreases(tmp_path):
    step_fn, state, dcfg, _ = _mini_setup(tmp_path, 30)
    losses = []
    it = DataIterator(dcfg)
    for _ in range(30):
        state, m = step_fn(state, next(it))
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0] - 0.2, losses[::10]


def test_resume_is_bit_identical(tmp_path):
    quiet = dict(ckpt_every=0, log_every=0, log_fn=lambda *_: None)
    # run 1: straight through 8 steps
    step_fn, state, dcfg, ckpt1 = _mini_setup(tmp_path / "a", 8)
    out_a = train_loop(step_fn=step_fn, state=state,
                       data_iter=DataIterator(dcfg), ckpt=ckpt1,
                       total_steps=8, **quiet)
    # run 2: 4 steps, a checkpoint, then a new process's loop: a fresh
    # model the checkpoint replaces, resumed to 8
    step_fn, state, dcfg, ckpt2 = _mini_setup(tmp_path / "b", 8)
    st4 = train_loop(step_fn=step_fn, state=state,
                     data_iter=DataIterator(dcfg), ckpt=ckpt2,
                     total_steps=4, **quiet)["state"]
    ckpt2.save(4, st4)
    step_fn, fresh, dcfg, ckpt2 = _mini_setup(tmp_path / "b", 8)
    out_b = train_loop(step_fn=step_fn, state=fresh,
                       data_iter=DataIterator(dcfg), ckpt=ckpt2,
                       total_steps=8, **quiet)
    a, b = out_a["state"]["params"], out_b["state"]["params"]
    assert torch.equal(a["embed"], b["embed"])
    for (n, x), (_, y) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(x, y), n
    assert torch.equal(out_a["state"]["opt"]["v"]["embed"],
                       out_b["state"]["opt"]["v"]["embed"])


# --------------------------------------------------------------------------
# the CLI and the example
# --------------------------------------------------------------------------

def _flags(path: Path) -> set:
    return set(re.findall(r'add_argument\("(--[a-z-]+)"', path.read_text()))


def test_the_cli_takes_the_reference_s_flags_and_device():
    ref = _flags(ROOT / "src" / "repro" / "launch" / "train.py")
    port = _flags(ROOT / "src" / "repro_torch" / "launch" / "train.py")
    assert ref <= port and port - ref == {"--device"}


def test_train_main_runs_and_resumes_on_the_cpu(tmp_path, capsys):
    argv = ["--arch", "qwen3-8b", "--reduced", "--d-model", "32",
            "--layers", "2", "--batch", "4", "--accum", "2", "--seq", "16",
            "--ckpt-dir", str(tmp_path), "--ckpt-every", "3",
            "--device", "cpu"]
    out = train.main(argv + ["--steps", "4"])
    text = capsys.readouterr().out
    assert "[step 0]" in text and "final: {'loss'" in text
    assert set(out["metrics"]) == {"loss", "grad_norm", "lr"}
    assert out["state"]["params"]["embed"].shape == (256, 32)
    assert CheckpointManager(str(tmp_path)).latest_step() == 4
    out = train.main(argv + ["--steps", "6"])
    text = capsys.readouterr().out
    assert "[resume] restored step 4" in text
    assert all(np.isfinite(float(v)) for v in out["metrics"].values())


def test_the_example_drives_the_port_s_cli(tmp_path):
    """``examples_torch/train_lm.py`` passes the reference example's
    arguments to ``repro_torch.launch.train``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run(
        [sys.executable, str(ROOT / "examples_torch" / "train_lm.py"),
         "--steps", "2", "--device", "cpu", "--ckpt-dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    assert "final: {'loss'" in run.stdout
