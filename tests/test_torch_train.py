"""The port's training step (``models.model.loss_fn`` with remat,
``optim.adamw``, ``launch.steps.make_train_step``) and its data against
``repro`` on the CPU.

As in ``test_torch_lm.py``, the same parameters drawn with numpy from a
seed go into both packages (``convert.from_reference``), here in float32,
and the reference runs unsharded: ``jax.value_and_grad`` of its
``loss_fn`` and ``jax.jit`` of its ``make_train_step`` with no activation
sharder (its ``launch.train.main`` fails in this container, ROADMAP C3).
Gradients come back to the reference's tree through
``convert.to_reference``.

Tolerances, each from float32:

* the loss: ``F32_TOL`` = 2e-5 (``test_torch_lm.py``), a few ulps of a
  value near 6;
* a gradient, a moment, the grad norm: ``GRAD_TOL`` = 1e-4 of the leaf's
  largest magnitude.  The two packages sum in different orders through a
  few layers' backward; the largest difference seen on the ten reduced
  archs is 1.5e-5 of it (rwkv6's WKV scan), so the bound has a margin of
  about 6;
* an updated parameter after the first AdamW step: its update is
  ``lr * g / (|g| + eps)``, a sign, so an element whose gradient is
  within the summation noise of 0 may move by ``2 lr`` in one package and
  not the other.  Parameters are held to ``F32_TOL`` where the
  reference's gradient exceeds ``SIGN_FLOOR`` = 1e-3 of its leaf's
  largest (10x ``GRAD_TOL``: its sign is the same in both); the moments,
  which are linear in the gradient, are held everywhere;
* one AdamW update on the reference's own gradients and state (bfloat16
  parameters, as the reference trains): unclipped, bit-equal moments and
  parameters; clipped, the scale follows the last bits of the global
  norm (``NORM_TOL`` = 1e-5 relative: a float32 sum of 16384 squares in
  another order), so the moments are held to ``MOMENT_ULPS`` = 4 float32
  ulps of the leaf's largest and the parameters to ``ADAMW_ULPS`` = 1
  bfloat16 ulp (0 seen); the learning rate of :func:`adamw.schedule`
  within ``SCHED_ULPS`` = 2 float32 ulps (XLA's and PyTorch's ``cos``
  and ``pow`` may differ in the last bit; equal at every step seen).

Trouble spots of the gradients met here: the MoE dispatch's overwritten
kept pair (ROADMAP C9,
:func:`test_moe_dispatch_gradient_skips_the_overwritten_slot`), the
combine's scatter-add (the port's ordered sum, whose backward is a
gather), the RG-LRU scan (log-depth doubling against
``associative_scan``), rwkv6's WKV ``lax.scan`` over two 64-position
chunks and the 512-query attention chunks (``LONG``), all in float32.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.data import pipeline as rpipe
from repro.launch import steps as rsteps
from repro.models import layers as RL
from repro.models import model as RM
from repro.optim import adamw as radamw
from repro_torch.data import pipeline as tpipe
from repro_torch.launch import steps
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.optim import adamw
from test_torch_lm import F32_TOL, _cfgs, _models, _np, _random_tree

GRAD_TOL = 1e-4
SIGN_FLOOR = 1e-3
ADAMW_ULPS = 1
SCHED_ULPS = 2
MOMENT_ULPS = 4
NORM_TOL = 1e-5

ARCHS = ["qwen3-8b", "qwen1.5-32b", "qwen2.5-32b", "mistral-nemo-12b",
         "recurrentgemma-2b", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
         "hubert-xlarge", "rwkv6-1.6b", "llama-3.2-vision-90b"]
#: (arch, batch, seq): every arch at 2 x 32, and the long paths, two
#: 512-query attention chunks and two 64-position WKV chunks
LONG = [("qwen3-8b", 1, 1024), ("rwkv6-1.6b", 1, 128)]
GRAD_CASES = [(n, 2, 32) for n in ARCHS] + LONG
GRAD_IDS = ARCHS + [f"{n}-{s}" for n, _, s in LONG]


def _batch(cfg, b: int, s: int, seed: int = 3) -> dict:
    """Inputs and labels drawn with numpy; the last label of a row is -1
    (masked), as the data pipeline makes it."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg.frontend == "audio":
        out["frames"] = rng.standard_normal(
            (b, s, cfg.frontend_dim)).astype(np.float32)
    else:
        out["tokens"] = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    if cfg.frontend == "vision":
        out["vision"] = rng.standard_normal(
            (b, cfg.vision_seq, cfg.frontend_dim)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, (b, s)).astype(np.int32)
    labels[:, -1] = -1
    out["labels"] = labels
    return out


def _torch_batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _f32_models(name: str, seed: int = 0):
    """``test_torch_lm._models`` in float32, rwkv6's decay bias ``w0``
    drawn around its init value -5 (``N(0, 0.1**2)`` around 0 decays by
    about e**-1 a position, and the reference's chunked WKV overflows
    ``exp`` to a NaN across a 64-position chunk)."""
    rcfg, cfg = _cfgs(name)
    tree = _random_tree(rcfg, seed)
    tree = jax.tree_util.tree_map_with_path(
        lambda path, a: np.asarray(a, np.float32)
        - (5.0 if path[-1].key == "w0" else 0.0), tree)
    return rcfg, cfg, jax.tree.map(jnp.asarray, tree), _f32_tree(cfg, tree)


@functools.lru_cache(maxsize=None)
def _ref_value_and_grad(name: str):
    """One jitted ``value_and_grad`` of the reference's loss an arch."""
    rcfg = _cfgs(name)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, b: RM.loss_fn(rcfg, p, b), has_aux=True))


def _port_grads(cfg, lm, batch, **kw):
    names, leaves = zip(*lm.named_parameters())
    for p in leaves:
        p.requires_grad_(True)
    loss, aux = M.loss_fn(cfg, lm, batch, **kw)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return loss.detach(), {k: v.detach() for k, v in aux.items()}, \
        dict(zip(names, grads))


def _leaves_close(got_tree, want_tree, tol=GRAD_TOL) -> float:
    """Every leaf of ``got_tree`` (the port's, through ``to_reference``)
    within ``tol`` of its ``want_tree`` leaf's largest magnitude; returns
    the worst ratio."""
    got = jax.tree_util.tree_leaves_with_path(got_tree)
    want = jax.tree_util.tree_leaves_with_path(want_tree)
    assert [p for p, _ in got] == [p for p, _ in want]
    worst = 0.0
    for (path, g), (_, w) in zip(got, want):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, path
        top = float(np.abs(w).max()) if w.size else 0.0
        err = float(np.abs(g - w).max()) if w.size else 0.0
        assert err <= tol * max(top, 1e-30), (path, err, top)
        worst = max(worst, err / max(top, 1e-30))
    return worst


# --------------------------------------------------------------------------
# the loss and its gradients
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name,b,s", GRAD_CASES, ids=GRAD_IDS)
def test_loss_and_grads_match_reference(name, b, s):
    rcfg, cfg, rp, lm = _f32_models(name)
    batch = _batch(cfg, b, s)
    (rloss, raux), rgrads = _ref_value_and_grad(name)(
        rp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, aux, grads = _port_grads(cfg, lm, _torch_batch(batch))
    assert abs(float(loss) - float(rloss)) <= F32_TOL
    assert abs(float(aux["nll"]) - float(raux["nll"])) <= F32_TOL
    assert abs(float(aux["aux"]) - float(raux["aux"])) <= F32_TOL
    _leaves_close(convert.to_reference(cfg, grads), rgrads)


@pytest.mark.parametrize("name", ARCHS)
def test_remat_changes_no_gradient_bit(name):
    """Each group under ``torch.utils.checkpoint`` (recomputed in the
    backward) gives the gradients of the plain forward bit for bit."""
    _, cfg, _, lm = _f32_models(name)
    batch = _torch_batch(_batch(cfg, 2, 32))
    loss_on, _, on = _port_grads(cfg, lm, batch, remat=True)
    loss_off, _, off = _port_grads(cfg, lm, batch, remat=False)
    assert torch.equal(loss_on, loss_off)
    assert on.keys() == off.keys()
    for k in on:
        assert torch.equal(on[k], off[k]), k


def test_serving_records_no_graph_on_trainable_weights():
    """Trainable weights (as a train step leaves them) do not make prefill
    or a decode step record autograd graphs; the decode caches are still
    written in place."""
    _, cfg, _, lm = _models(("qwen3-8b", {}))
    for p in lm.parameters():
        p.requires_grad_(True)
    toks = torch.from_numpy(_batch(cfg, 2, 8)["tokens"])
    logits, caches = M.prefill(cfg, lm, {"tokens": toks})
    assert not logits.requires_grad
    caches = M.init_caches(cfg, 2, 8, device="cpu")
    out, new = M.decode_step(cfg, lm, caches, toks[:, 0], 0)
    assert not out.requires_grad and new[0]["k"] is caches[0]["k"]
    assert caches[0]["k"][:, 0].abs().sum() > 0


def test_moe_dispatch_gradient_skips_the_overwritten_slot():
    """ROADMAP C9 in the backward: five tokens routed to expert 0 at
    capacity 4.  The reference's scatter writes the dropped token's zero
    over slot 3, so ``jax.grad`` gives the kept token 3 (and the dropped
    token 4) no gradient through the experts; the port's masked dispatch
    gives the same gradients, zeros included."""
    rcfg, cfg = _cfgs("qwen3-moe-235b-a22b")
    moe = dataclasses.replace(rcfg.moe, top_k=1, capacity_factor=3.0)
    rcfg = dataclasses.replace(rcfg, moe=moe)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=1, capacity_factor=3.0))
    rng = np.random.default_rng(12)
    tree = jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) / np.sqrt(a.shape[-2])
                   ).astype(np.float32),
        RL.init_moe(rcfg, jax.random.PRNGKey(0)))
    router = np.zeros((rcfg.d_model, moe.n_experts), np.float32)
    router[:, 0] = 1.0
    tree["router"] = router
    x = rng.uniform(0.5, 1.5, (1, 5, rcfg.d_model)).astype(np.float32)
    cot = rng.standard_normal(x.shape).astype(np.float32)

    def rloss(p, xx):
        return jnp.sum(RL.apply_moe(rcfg, p, xx)[0] * cot)

    rgp, rgx = jax.grad(rloss, argnums=(0, 1))(
        jax.tree.map(jnp.asarray, tree), jnp.asarray(x))
    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in tree.items()}
    xt = torch.from_numpy(x).requires_grad_(True)
    y, _ = L.apply_moe(cfg, tp, xt)
    gx, *gp = torch.autograd.grad((y * torch.from_numpy(cot)).sum(),
                                  [xt] + list(tp.values()))
    for g in (np.asarray(rgx), gx.numpy()):
        assert np.all(np.abs(g[0, :3]).max(-1) > 0)
        assert not np.any(g[0, 3:])
    _close_rel(gx, rgx)
    for (k, t), g in zip(tp.items(), gp):
        _close_rel(g, rgp[k])


def _close_rel(got, want, tol=GRAD_TOL):
    got, want = _np(got), _np(want)
    top = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * max(top, 1e-30)


# --------------------------------------------------------------------------
# the train step
# --------------------------------------------------------------------------

STEP_CASES = [("qwen3-8b", 1, False), ("qwen3-8b", 2, False),
              ("qwen3-8b", 1, True), ("qwen3-8b", 2, True),
              ("qwen3-moe-235b-a22b", 2, False)]
STEP_IDS = [f"{n}-accum{a}-{'fused' if f else 'scan'}"
            for n, a, f in STEP_CASES]


@pytest.mark.parametrize("name,accum,fused", STEP_CASES, ids=STEP_IDS)
def test_train_step_matches_reference(name, accum, fused):
    """One step of ``make_train_step`` (scan or fused form) against the
    reference's jitted one, from the same float32 weights and batch: the
    metrics, both moments and the updated parameters (see the module
    docstring for the sign of a near-zero gradient)."""
    rcfg, cfg, rp, lm = _f32_models(name)
    opt_cfg = dict(lr=1e-3, total_steps=10, warmup_steps=2)
    dcfg = rpipe.DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4,
                            seed=5)
    flat = rpipe.batch_at(dcfg, 0)
    batch = {k: v.reshape((accum, 4 // accum) + v.shape[1:])
             for k, v in flat.items()}
    rstep = jax.jit(rsteps.make_train_step(
        rcfg, accum, radamw.AdamWConfig(**opt_cfg), fused_accum=fused))
    want_p, want_o, want_m = rstep(rp, radamw.init(rp),
                                   {k: jnp.asarray(v)
                                    for k, v in batch.items()})
    step = steps.make_train_step(cfg, accum, adamw.AdamWConfig(**opt_cfg),
                                 fused_accum=fused)
    got_p, got_o, got_m = step(lm, adamw.init(lm), _torch_batch(batch))
    assert set(got_m) == {"loss", "grad_norm", "lr"}
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= F32_TOL
    assert abs(float(got_m["grad_norm"]) - float(want_m["grad_norm"])) <= \
        GRAD_TOL * float(want_m["grad_norm"])
    assert float(got_m["lr"]) == float(want_m["lr"])
    assert int(got_o["step"]) == int(want_o["step"]) == 1
    for key in ("m", "v"):
        _leaves_close(convert.to_reference(cfg, got_o[key]), want_o[key])
    got = jax.tree_util.tree_leaves(convert.to_reference(cfg, got_p))
    m = jax.tree_util.tree_leaves(want_o["m"])
    for g, w, mw in zip(got, jax.tree_util.tree_leaves(want_p), m):
        mw = np.abs(np.asarray(mw))
        sure = mw > SIGN_FLOOR * mw.max()
        err = np.abs(np.asarray(g) - np.asarray(w))
        assert err[sure].max(initial=0.0) <= F32_TOL
        assert err.max() <= 2 * float(want_m["lr"]) + F32_TOL


def test_accum_for_matches_reference():
    from repro.configs.registry import ARCHS as RARCHS
    from repro_torch.configs.registry import ARCHS as TARCHS
    for name in RARCHS:
        for shape in rsteps.SHAPES:
            assert steps.accum_for(TARCHS[name], steps.SHAPES[shape]) == \
                rsteps.accum_for(RARCHS[name], rsteps.SHAPES[shape])


# --------------------------------------------------------------------------
# AdamW
# --------------------------------------------------------------------------

def _ulps_bf16(a, b) -> int:
    ia = a.view(np.int16).astype(np.int64)
    ib = b.view(np.int16).astype(np.int64)
    return int(np.abs(ia - ib).max()) if ia.size else 0


@pytest.mark.parametrize("clipped", [False, True],
                         ids=["unclipped", "clipped"])
@pytest.mark.parametrize("name", ["qwen3-8b", "deepseek-v2-236b",
                                  "llama-3.2-vision-90b"])
def test_adamw_update_matches_reference(name, clipped):
    """One update on the reference's own gradients and state (step 4 to 5,
    bfloat16 parameters): deepseek's prefix layer holds 1-d norms that do
    not decay beside the groups' stacked ones that do, llama-vision's
    cross gate is 0-d.  Unclipped (global norm under ``clip_norm``) the
    moments are bit-equal; clipped, the scale follows the norm's last
    bits, which sum in another order within a leaf, and the moments are
    held to ``MOMENT_ULPS`` float32 ulps of the leaf's largest."""
    rcfg, cfg = _cfgs(name)
    tree = _random_tree(rcfg, 1)
    rng = np.random.default_rng(2)
    draw = lambda scale: jax.tree.map(
        lambda a: (rng.standard_normal(a.shape) * scale).astype(np.float32),
        tree)
    grads, m = draw(1.0 if clipped else 1e-4), draw(0.1)
    v = jax.tree.map(lambda a: np.abs(a), draw(0.01))
    cfg_o = dict(lr=1e-2, total_steps=20, warmup_steps=3, clip_norm=1.0)
    rstate = {"m": jax.tree.map(jnp.asarray, m),
              "v": jax.tree.map(jnp.asarray, v), "step": jnp.int32(4)}
    want_p, want_s, want_m = radamw.update(
        radamw.AdamWConfig(**cfg_o), jax.tree.map(jnp.asarray, grads),
        rstate, jax.tree.map(jnp.asarray, tree))
    lm = convert.from_reference(cfg, tree, device="cpu")
    state = {"m": _f32_tree(cfg, m), "v": _f32_tree(cfg, v),
             "step": torch.tensor(4, dtype=torch.int32)}
    got_p, got_s, got_m = adamw.update(
        adamw.AdamWConfig(**cfg_o),
        dict(_f32_tree(cfg, grads).named_parameters()), state, lm)
    assert got_p is lm and int(got_s["step"]) == 5
    assert float(got_m["grad_norm"]) == pytest.approx(
        float(want_m["grad_norm"]), rel=NORM_TOL)
    assert (float(got_m["grad_norm"]) > 1.0) == clipped
    assert abs(float(got_m["lr"]) - float(want_m["lr"])) <= \
        SCHED_ULPS * np.spacing(np.float32(want_m["lr"]))
    for key in ("m", "v"):
        for g, w in zip(jax.tree.leaves(convert.to_reference(cfg,
                                                             got_s[key])),
                        jax.tree.leaves(want_s[key])):
            w = np.asarray(w)
            if clipped:
                ulp = np.spacing(np.abs(w).max())
                assert np.abs(g - w).max() <= MOMENT_ULPS * ulp
            else:
                np.testing.assert_array_equal(g, w)
    got = jax.tree.leaves(convert.to_reference(cfg, got_p))
    for g, w in zip(got, jax.tree.leaves(want_p)):
        w = np.asarray(w)
        if w.dtype == ml_dtypes.bfloat16:
            assert _ulps_bf16(g, w.view(np.uint16)) <= \
                (ADAMW_ULPS if clipped else 0)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=F32_TOL)


def _f32_tree(cfg, tree):
    """A float32 reference tree as a port tree of its shape (moments,
    gradients)."""
    want = dict(M.LM(cfg, device="meta").named_parameters())
    got = {}
    for path, arr in convert._leaves(tree):
        for name, idx in convert.port_names(cfg, path):
            got[name] = torch.from_numpy(np.array(np.asarray(arr)[idx],
                                                  np.float32))
            assert got[name].shape == want[name].shape
    return convert.assemble(cfg, got)


def test_schedule_matches_reference_at_every_step():
    for over in ({"warmup_steps": 1, "total_steps": 30},
                 {"warmup_steps": 3, "total_steps": 30, "lr": 1e-3}):
        rc, tc = radamw.AdamWConfig(**over), adamw.AdamWConfig(**over)
        for step in range(31):
            want = np.float32(radamw.schedule(rc, jnp.int32(step)))
            got = np.float32(adamw.schedule(
                tc, torch.tensor(step, dtype=torch.int32)))
            assert abs(got - want) <= SCHED_ULPS * np.spacing(want), step


@pytest.mark.parametrize("name", ["deepseek-v2-236b", "recurrentgemma-2b"])
def test_global_norm_sums_in_the_reference_leaf_order(name):
    """``reference_leaves`` walks the port's tensors in
    ``jax.tree.leaves`` order (deepseek's prefix, recurrentgemma's
    three-layer groups), and the norm agrees with the reference's."""
    rcfg, cfg = _cfgs(name)
    tree = _random_tree(rcfg, 4)
    lm = convert.from_reference(cfg, tree, device="cpu")
    want_paths = [tuple(getattr(k, "key", getattr(k, "idx", None))
                        for k in path)
                  for path, _ in jax.tree_util.tree_leaves_with_path(tree)]
    got = convert.reference_leaves(cfg, lm)
    assert [p for p, _ in got] == want_paths
    for (path, tensors), leaf in zip(got, jax.tree.leaves(tree)):
        shape = np.shape(leaf)[1:] if convert.stacked(path) \
            else np.shape(leaf)
        assert len(tensors) == (rcfg.n_groups if convert.stacked(path)
                                else 1)
        assert all(tuple(t.shape) == shape for t in tensors)
    want = float(radamw.global_norm(jax.tree.map(jnp.asarray, tree)))
    assert float(adamw.global_norm(lm)) == pytest.approx(want, rel=NORM_TOL)


# --------------------------------------------------------------------------
# data
# --------------------------------------------------------------------------

DATA = [dict(vocab=1000, seq_len=64, global_batch=8, seed=7),
        dict(vocab=256, seq_len=32, global_batch=4, seed=0,
             mean_doc_len=8),
        dict(vocab=64, seq_len=16, global_batch=4, seed=3, kind="audio",
             frontend_dim=32),
        dict(vocab=256, seq_len=16, global_batch=2, seed=1, kind="vlm",
             frontend_dim=32, vision_seq=8)]


@pytest.mark.parametrize("n_shards", [1, 2])
@pytest.mark.parametrize("case", range(len(DATA)),
                         ids=["lm", "lm-short-docs", "audio", "vlm"])
def test_batch_at_matches_reference(case, n_shards):
    rc, tc = rpipe.DataConfig(**DATA[case]), tpipe.DataConfig(**DATA[case])
    for step in (0, 1, 17):
        for shard in range(n_shards):
            want = rpipe.batch_at(rc, step, shard, n_shards)
            got = tpipe.batch_at(tc, step, shard, n_shards)
            assert want.keys() == got.keys()
            for k in want:
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
    it = tpipe.DataIterator(tc, start_step=5)
    rit = rpipe.DataIterator(rc)
    rit.restore({"step": 5})
    for _ in range(2):
        a, b = next(it), next(rit)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert it.state() == rit.state() == {"step": 7}
