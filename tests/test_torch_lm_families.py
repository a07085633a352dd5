"""The port's other LM families against ``repro`` on the CPU: MLA, the
capacity MoE, the RG-LRU block, RWKV6's time and channel mixes, the
vision cross-attention layer and the audio frontend, each function and
each of the six models (``recurrentgemma-2b``, ``qwen3-moe-235b-a22b``,
``deepseek-v2-236b``, ``rwkv6-1.6b``, ``llama-3.2-vision-90b``,
``hubert-xlarge``) reduced.

As in ``test_torch_lm.py``, the same parameters drawn with numpy from a
seed go into both packages, every constant-initialised one (norms, biases,
the cross layer's gate, ``mu``, ``mu_c``, ``w0``, ``u``, ``lam``) given
seeded noise so that it counts, and the reference runs unsharded
(ROADMAP C3).  Tolerances, from the dtype (``test_torch_lm.py``):
``F32_TOL`` = 2e-5 on values of order 1, ``BF16_TOL`` = 2**-5 on a
layer's output, ``LOGIT_TOL`` = 0.1 on the logits of a two-layer model.
Two follow from them here:

* a layer's output is held to ``F32_TOL`` or ``BF16_TOL`` relative to
  its largest value where that exceeds 1 (in bfloat16 two ulps of it,
  ``2**-6 * max|want|``; :func:`_layer_tol`): the residual stream, a
  squared ReLU, grow past order 1;
* the roundings of independent layers add like a random walk, so a
  deeper model's bfloat16 logits are held to ``LOGIT_TOL * sqrt(L / 2)``
  for ``L`` layers (:func:`_logit_tol`; 0.2 for the 8-layer
  ``recurrentgemma-2b``, the reference's own decode-against-forward
  bound).

The MoE models' bfloat16 logits are not compared end to end: a top-k
choice whose probability margin is 0.001 (reduced ``deepseek-v2-236b``
has one) flips under a one-ulp difference of the layer's input, and a
flipped expert moves a logit by more than any bound.  Their layers are
held one by one on the reference's own inputs instead
(:func:`test_each_layer_on_the_reference_input`), and their logits end to
end in float32.
"""

import dataclasses
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import ARCHS as RARCHS
from repro.launch import steps as rsteps
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs.registry import ARCHS
from repro_torch.launch import serve
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M
from test_torch_lm import (BF16_TOL, DTYPE_IDS, F32_TOL, LOGIT_TOL, _cfgs,
                           _close, _models, _np, _rand, _ref_fns,
                           meta_matches_reference)

FAMILIES = ["recurrentgemma-2b", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
            "rwkv6-1.6b", "llama-3.2-vision-90b", "hubert-xlarge"]
MOE = ("qwen3-moe-235b-a22b", "deepseek-v2-236b")
#: Every (family, dtype) whose logits are compared end to end.
END_TO_END = [(n, f32) for n in FAMILIES for f32 in (False, True)
              if f32 or n not in MOE]
DTYPES = [jnp.float32, jnp.bfloat16]
END_TO_END_IDS = [f"{n}-{'f32' if f32 else 'bf16'}" for n, f32 in END_TO_END]


def _logit_tol(cfg, f32: bool) -> float:
    return F32_TOL if f32 else LOGIT_TOL * np.sqrt(max(cfg.n_layers, 2) / 2)


def _layer_tol(want, f32: bool) -> float:
    top = float(np.max(np.abs(_np(want)))) if _np(want).size else 0.0
    if f32:
        return F32_TOL * max(1.0, top)
    return max(BF16_TOL, 2 ** -6 * top)


def _leaf_noise(tree, rng, f32=False):
    """Every leaf of a layer's parameter dict redrawn by numpy: matrices
    (and stacked experts) ``N(0, 1/fan_in)``, vectors and scalars
    ``N(0, 0.1**2)``, in the leaf's dtype (float32 with ``f32``); as
    (reference, port) trees."""
    def fill(a):
        shape = a.shape
        scale = 1 / np.sqrt(shape[-2]) if len(shape) >= 2 else 0.1
        v = rng.standard_normal(shape).astype(np.float32) * scale
        return v.astype(np.float32 if f32 else a.dtype)
    tree = jax.tree.map(fill, tree)
    return (jax.tree.map(jnp.asarray, tree),
            jax.tree.map(convert.to_tensor, tree))


def _t(x) -> torch.Tensor:
    """A reference array as a port tensor of the same values and dtype."""
    a = np.asarray(x)
    return torch.from_numpy(a.copy()) if a.dtype == np.int32 \
        else convert.to_tensor(a)


def _caches_close(got, want, f32):
    assert set(got) == set(want)
    for key in want:
        _close(got[key], want[key], _layer_tol(want[key], f32))


def _pos(b, s, start=0):
    p = np.tile(np.arange(start, start + s), (b, 1))
    return jnp.asarray(p, jnp.int32), torch.from_numpy(p)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_apply_mla(dtype):
    """The non-absorbed forward, ``"collect"`` (the latent ``c`` and the
    rope key ``r``), then one absorbed decode step on those caches grown
    to 12 positions."""
    f32 = dtype == jnp.float32
    rcfg, cfg = _cfgs("deepseek-v2-236b")
    rng = np.random.default_rng(10)
    rp, tp = _leaf_noise(RL.init_mla(rcfg, jax.random.PRNGKey(0)), rng, f32)
    s = 7
    xj, xt = _rand(rng, (2, s, rcfg.d_model), dtype)
    pj, pt = _pos(2, s)
    want, _ = RL.apply_mla(rcfg, rp, xj, pos=pj)
    got, none = L.apply_mla(cfg, tp, xt, pos=pt)
    assert none is None
    _close(got, want, _layer_tol(want, f32))
    want, rc = RL.apply_mla(rcfg, rp, xj, pos=pj, cache="collect")
    got, tc = L.apply_mla(cfg, tp, xt, pos=pt, cache="collect")
    _close(got, want, _layer_tol(want, f32))
    _caches_close(tc, rc, f32)
    rc = {k: jnp.pad(v, ((0, 0), (0, 5), (0, 0))) for k, v in rc.items()}
    tc = {k: _t(v) for k, v in rc.items()}
    x1j, x1t = _rand(rng, (2, 1, rcfg.d_model), dtype)
    pj, pt = _pos(2, 1, s)
    want, rc = RL.apply_mla(rcfg, rp, x1j, pos=pj, cache=rc)
    got, tc = L.apply_mla(cfg, tp, x1t, pos=pt, cache=tc)
    _close(got, want, _layer_tol(want, f32))
    _caches_close(tc, rc, f32)


@pytest.fixture
def moe_groups():
    """Set both packages' MoE dispatch groups; back to 1 after the
    test."""
    def set_groups(n):
        RL.set_moe_groups(n)
        L.set_moe_groups(n)
    yield set_groups
    set_groups(1)


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("groups", [1, 2])
@pytest.mark.parametrize("name", MOE)
def test_apply_moe(moe_groups, name, groups, dtype):
    """``y`` and the aux loss, one or two dispatch groups, routed experts
    (and ``deepseek-v2-236b``'s shared ones); 16 tokens of 2 choices over
    4 experts at capacity ``ceil(tokens_per_group * 2 / 4 * 1.25)``, so
    experts overflow."""
    f32 = dtype == jnp.float32
    moe_groups(groups)
    rcfg, cfg = _cfgs(name)
    rng = np.random.default_rng(11)
    rp, tp = _leaf_noise(RL.init_moe(rcfg, jax.random.PRNGKey(0)), rng, f32)
    xj, xt = _rand(rng, (2, 8, rcfg.d_model), dtype)
    want, waux = RL.apply_moe(rcfg, rp, xj)
    got, gaux = L.apply_moe(cfg, tp, xt)
    _close(got, want, _layer_tol(want, f32))
    _close(gaux, waux, F32_TOL)


def test_moe_overflow_zeroes_the_expert_s_last_slot():
    """ROADMAP C9, a quirk of the reference that the port keeps: five
    tokens all routed to expert 0 at capacity 4.  The reference writes
    the dropped token's zero to slot ``cap - 1`` after the token kept
    there, so tokens 0 to 2 get the expert's output and tokens 3 and 4
    get nothing, in both packages."""
    rcfg, cfg = _cfgs("qwen3-moe-235b-a22b")
    moe = dataclasses.replace(rcfg.moe, top_k=1, capacity_factor=3.0)
    rcfg = dataclasses.replace(rcfg, moe=moe)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=1, capacity_factor=3.0))
    rng = np.random.default_rng(12)
    rp, tp = _leaf_noise(RL.init_moe(rcfg, jax.random.PRNGKey(0)), rng)
    router = np.zeros((rcfg.d_model, moe.n_experts), np.float32)
    router[:, 0] = 1.0
    rp["router"], tp["router"] = jnp.asarray(router), torch.from_numpy(router)
    x = rng.uniform(0.5, 1.5, (1, 5, rcfg.d_model)).astype(np.float32)
    xj = jnp.asarray(x).astype(jnp.bfloat16)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    assert int(np.ceil(5 * 1 / moe.n_experts * moe.capacity_factor)) == 4
    want, _ = RL.apply_moe(rcfg, rp, xj)
    got, _ = L.apply_moe(cfg, tp, xt)
    for y in (_np(want), _np(got)):
        assert np.all(np.abs(y[0, :3]).max(-1) > 0)
        assert not np.any(y[0, 3:])
    _close(got, want, _layer_tol(want, False))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_apply_rglru(dtype):
    """Prefill (the scan), ``"collect"`` (the last state and the last 3
    conv inputs), then two decode steps on those caches."""
    f32 = dtype == jnp.float32
    rcfg, cfg = _cfgs("recurrentgemma-2b")
    rng = np.random.default_rng(13)
    rp, tp = _leaf_noise(RL.init_rglru(rcfg, jax.random.PRNGKey(0)), rng,
                         f32)
    xj, xt = _rand(rng, (2, 9, rcfg.d_model), dtype)
    want, _ = RL.apply_rglru(rcfg, rp, xj)
    got, none = L.apply_rglru(cfg, tp, xt)
    assert none is None
    _close(got, want, _layer_tol(want, f32))
    want, rc = RL.apply_rglru(rcfg, rp, xj, cache="collect")
    got, tc = L.apply_rglru(cfg, tp, xt, cache="collect")
    _close(got, want, _layer_tol(want, f32))
    _caches_close(tc, rc, f32)
    tc = {k: _t(v) for k, v in rc.items()}
    for _ in range(2):
        x1j, x1t = _rand(rng, (2, 1, rcfg.d_model), dtype)
        want, rc = RL.apply_rglru(rcfg, rp, x1j, cache=rc)
        got, tc = L.apply_rglru(cfg, tp, x1t, cache=tc)
        _close(got, want, _layer_tol(want, f32))
        _caches_close(tc, rc, f32)


@pytest.mark.parametrize("t", [16, 64, 128])
def test_wkv_chunked(t):
    """One chunk of 16, one of 64, two of 64 (the state carried across):
    the output and the final state."""
    rng = np.random.default_rng(14)
    b, h, hd = 2, 3, 8
    shape = (b, h, t, hd)
    r, k, v = (rng.standard_normal(shape).astype(np.float32) * sc
               for sc in (0.5, 0.5, 1.0))
    w = np.exp(-np.exp(rng.standard_normal(shape) * 0.5 - 1.0)
               ).astype(np.float32)
    u = (rng.standard_normal((h, hd)) * 0.1).astype(np.float32)
    s0 = (rng.standard_normal((b, h, hd, hd)) * 0.1).astype(np.float32)
    ins = (r, k, v, w, u, s0)
    want_y, want_s = RL._wkv_chunked(*map(jnp.asarray, ins))
    got_y, got_s = L._wkv_chunked(*map(torch.from_numpy, ins))
    _close(got_y, want_y, _layer_tol(want_y, True))
    _close(got_s, want_s, _layer_tol(want_s, True))


def test_wkv_chunked_refuses_a_length_it_cannot_chunk():
    """100 positions are more than a chunk and not a multiple of 64: the
    reference cannot reshape them, the port says why."""
    z = np.full((1, 2, 100, 4), 0.5, np.float32)
    u, s0 = np.zeros((2, 4), np.float32), np.zeros((1, 2, 4, 4), np.float32)
    with pytest.raises(TypeError, match="cannot reshape"):
        RL._wkv_chunked(*map(jnp.asarray, (z, z, z, z, u, s0)))
    with pytest.raises(ValueError, match="not a multiple of the 64"):
        L._wkv_chunked(*map(torch.from_numpy, (z, z, z, z, u, s0)))


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
def test_apply_rwkv_timemix_and_channelmix(dtype):
    """Each mix on 8 positions with ``"collect"`` (the WKV state and the
    last inputs), then two single-position decode steps (the time mix's
    fast path) on those caches."""
    f32 = dtype == jnp.float32
    rcfg, cfg = _cfgs("rwkv6-1.6b")
    rng = np.random.default_rng(15)
    rp, tp = _leaf_noise(RL.init_rwkv(rcfg, jax.random.PRNGKey(0)), rng, f32)
    xj, xt = _rand(rng, (2, 8, rcfg.d_model), dtype)
    pairs = ((RL.apply_rwkv_timemix, L.apply_rwkv_timemix),
             (RL.apply_rwkv_channelmix, L.apply_rwkv_channelmix))
    caches = []
    for rf, tf in pairs:
        want, _ = rf(rcfg, rp, xj)
        got, none = tf(cfg, tp, xt)
        assert none is None
        _close(got, want, _layer_tol(want, f32))
        want, rc = rf(rcfg, rp, xj, cache="collect")
        got, tc = tf(cfg, tp, xt, cache="collect")
        _close(got, want, _layer_tol(want, f32))
        _caches_close(tc, rc, f32)
        caches.append(rc)
    rc = {**caches[0], **caches[1]}
    tc = {k: _t(v) for k, v in rc.items()}
    for _ in range(2):
        x1j, x1t = _rand(rng, (2, 1, rcfg.d_model), dtype)
        for rf, tf in pairs:
            want, rnew = rf(rcfg, rp, x1j, cache=rc)
            got, tnew = tf(cfg, tp, x1t, cache=tc)
            _close(got, want, _layer_tol(want, f32))
            _caches_close(tnew, rnew, f32)
            rc = {**rc, **rnew}


# --------------------------------------------------------------------------
# the models
# --------------------------------------------------------------------------

def _batches(cfg, b, t, seed=8):
    """The reference's and the port's batch: tokens, and ``vision``
    [B, vision_seq, frontend_dim] or ``frames`` [B, T, frontend_dim]
    (standard normal) where the config has a frontend."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, t))
    rb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks)}
    if cfg.frontend != "none":
        key, n = (("vision", cfg.vision_seq) if cfg.frontend == "vision"
                  else ("frames", t))
        feats = rng.standard_normal((b, n, cfg.frontend_dim)
                                    ).astype(np.float32)
        rb[key], tb[key] = jnp.asarray(feats), torch.from_numpy(feats)
    return rb, tb


@pytest.mark.parametrize("name,f32", END_TO_END, ids=END_TO_END_IDS)
def test_forward_prefill_decode_match_reference(name, f32):
    """``forward``'s logits at every position and its aux loss,
    ``prefill``'s last logits, and 8 teacher-forced ``decode_step``s
    (not for the encoder-only ``hubert-xlarge``), each against the
    reference on the same parameters and inputs; the caches in the
    parameters' dtype."""
    rcfg, cfg, rp, lm = _models((name, {}), f32=f32)
    tol = _logit_tol(cfg, f32)
    fwd, pre, dec = _ref_fns(name, ())
    B, T = 2, 8
    rb, tb = _batches(cfg, B, T)
    want, waux = fwd(rp, rb)
    got, gaux = M.forward(cfg, lm, tb)
    _close(got, want, tol)
    _close(gaux, waux, F32_TOL)
    if name in MOE:
        assert float(gaux) > 0
    want, _ = pre(rp, rb)
    got, _ = M.prefill(cfg, lm, tb)
    _close(got, want, tol)
    if cfg.encoder_only:
        return
    cdt = jnp.float32 if f32 else jnp.bfloat16
    rc = jax.tree.map(lambda c: c.astype(cdt) if c.dtype == jnp.bfloat16
                      else c, RM.init_caches(rcfg, B, 16))
    tc = M.init_caches(cfg, B, 16, device="cpu",
                       dtype=torch.float32 if f32 else torch.bfloat16)
    for t in range(T):
        want, rc = dec(rp, rc, rb["tokens"][:, t], jnp.int32(t),
                       rb.get("vision"))
        got, tc = M.decode_step(cfg, lm, tc, tb["tokens"][:, t], t,
                                vision=tb.get("vision"))
        _close(got, want, tol)


def _unstacked(rcfg, rp):
    """The reference's layers in order, each group's leaves indexed."""
    return list(rp["prefix"]) + [
        jax.tree.map(lambda a: a[g], rp["groups"][j])
        for g in range(rcfg.n_groups) for j in range(len(rcfg.group))]


@pytest.mark.parametrize("dtype", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("name", FAMILIES)
def test_each_layer_on_the_reference_input(name, dtype):
    """Every layer of the reduced model, given the reference's own input
    to it (the reference run eagerly, layer by layer, on its unstacked
    parameters): the output without a cache and its aux loss, with
    ``"collect"`` and its caches, then one decode step on the reference's
    caches grown to 12 positions, its output and new caches.  A cross
    layer gets its keys and values from the vision states; decode runs
    it without a cache, as ``decode_step`` does."""
    f32 = dtype == jnp.float32
    rcfg, cfg, rp, lm = _models((name, {}), f32=f32)
    B, T = 2, 8
    rb, tb = _batches(cfg, B, T)
    x = (rb["frames"].astype(jnp.bfloat16) @ rp["frontend"]
         if cfg.frontend == "audio" else rp["embed"][rb["tokens"]])
    xv = rb["vision"].astype(jnp.bfloat16) @ rp["frontend"] \
        if cfg.frontend == "vision" else None
    x1 = rp["embed"][rb["tokens"][:, :1]]
    pj, pt = _pos(B, T)
    p1j, p1t = _pos(B, 1, T)
    for kind, lr, lt in zip(M.layer_kinds(cfg), _unstacked(rcfg, rp),
                            lm["layers"]):
        ckv = tkv = None
        if kind == "cross":
            ckv = RM._cross_kv(rcfg, lr["attn"], xv)
            tkv = tuple(map(_t, ckv))
        want, _, waux = RM.apply_layer(rcfg, kind, lr, x, pos=pj,
                                       cross_kv=ckv)
        got, _, gaux = M.apply_layer(cfg, kind, lt, _t(x), pos=pt,
                                     cross_kv=tkv)
        _close(got, want, _layer_tol(want, f32))
        _close(gaux, waux, F32_TOL)
        _, rc, _ = RM.apply_layer(rcfg, kind, lr, x, pos=pj, cache="collect",
                                  cross_kv=ckv)
        _, tc, _ = M.apply_layer(cfg, kind, lt, _t(x), pos=pt,
                                 cache="collect", cross_kv=tkv)
        _caches_close(tc, rc, f32)
        if not cfg.encoder_only:
            if M.seq_len(tc) is not None:        # room for position T
                rc = jax.tree.map(lambda c: jnp.pad(
                    c, [(0, 0), (0, 4)] + [(0, 0)] * (c.ndim - 2)), rc)
            if kind == "cross":
                wdec, _, _ = RM.apply_layer(rcfg, kind, lr, x1, pos=p1j,
                                            cross_kv=ckv)
                gdec, _, _ = M.apply_layer(cfg, kind, lt, _t(x1), pos=p1t,
                                           cross_kv=tkv)
            else:
                tc = {k: _t(v) for k, v in rc.items()}
                wdec, rc, _ = RM.apply_layer(rcfg, kind, lr, x1, pos=p1j,
                                             cache=rc)
                gdec, tc, _ = M.apply_layer(cfg, kind, lt, _t(x1), pos=p1t,
                                            cache=tc)
                _caches_close(tc, rc, f32)
            _close(gdec, wdec, _layer_tol(wdec, f32))
            x1 = wdec
        x = want


def _greedy_against_reference(rcfg, cfg, rp, lm, tol, f32=False):
    """``serve.generate`` against the reference's ``serve_llm`` loop
    (``jax.jit(make_decode_step(cfg))``, prompt teacher-forced, then
    greedy, ``vision`` in every step; the caches in the weights' dtype):
    the prompt comes back as given,
    and each greedy token is the reference's wherever the reference's
    top-2 margin exceeds ``tol``; a row whose token differs at a near-tie
    is not compared further."""
    B, P, G = 4, 6, 10
    rb, tb = _batches(cfg, B, P, seed=9)
    got = serve.generate(cfg, lm, tb["tokens"], G,
                         vision=tb.get("vision")).numpy()
    assert got.shape == (B, P + G) and got.dtype == np.int32
    assert np.array_equal(got[:, :P], tb["tokens"].numpy())
    step = jax.jit(rsteps.make_decode_step(rcfg))
    caches = RM.init_caches(rcfg, B, P + G)
    if f32:
        caches = jax.tree.map(lambda c: c.astype(jnp.float32)
                              if c.dtype == jnp.bfloat16 else c, caches)
    tj = rb["tokens"]
    cur, live, compared = tj[:, 0], np.ones(B, bool), 0
    for t in range(P + G - 1):
        batch = {"token": cur, "pos": jnp.int32(t)}
        if "vision" in rb:
            batch["vision"] = rb["vision"]
        nxt, logits, caches = step(rp, caches, batch)
        if t + 1 < P:
            cur = tj[:, t + 1]
            continue
        top2 = np.sort(_np(logits), -1)[:, -2:]
        same = np.asarray(nxt) == got[:, t + 1]
        tie = top2[:, 1] - top2[:, 0] <= tol
        assert np.all(same | tie | ~live), t
        compared += int(np.sum(live & ~tie))
        live &= same
        cur = jnp.asarray(got[:, t + 1])
    assert compared >= B * G // 4         # not vacuous


@pytest.mark.parametrize("name", ["recurrentgemma-2b", "llama-3.2-vision-90b"])
def test_generate_matches_the_reference_loop(name):
    """In bfloat16, with the same vision input for the vision model."""
    rcfg, cfg, rp, lm = _models((name, {}))
    _greedy_against_reference(rcfg, cfg, rp, lm, _logit_tol(cfg, False))


def test_generate_moe_matches_the_reference_loop():
    """``qwen3-moe-235b-a22b`` at its default capacity (4 rows a step,
    capacity 3 of 8 choices over 4 experts: C9 is live), in float32,
    where routing cannot flip on a rounding."""
    rcfg, cfg, rp, lm = _models(("qwen3-moe-235b-a22b", {}), f32=True)
    _greedy_against_reference(rcfg, cfg, rp, lm, F32_TOL, f32=True)


def test_rwkv_bf16_decode_drifts_in_the_reference_too():
    """Why ``chip_smoke.py`` gates rwkv6's full-depth decode against
    forward in float32 only: the reference's own bfloat16 decode, on
    rwkv6's 24 layers at d_model 512 (its own init, seed 0), drifts from
    its forward by more than its 0.2 bound over 48 positions, while the
    port's float32 decode stays within a few float32 ulps of its
    forward."""
    rcfg = dataclasses.replace(RARCHS["rwkv6-1.6b"], d_model=512,
                               n_heads=8, d_ff=1792, vocab=1024)
    cfg = dataclasses.replace(ARCHS["rwkv6-1.6b"], d_model=512, n_heads=8,
                              d_ff=1792, vocab=1024)
    rp = RM.init_model(rcfg, jax.random.PRNGKey(0))
    lm = convert.from_reference(cfg, jax.tree.map(np.asarray, rp),
                                device="cpu").float()
    B, T = 2, 48
    toks = np.random.default_rng(16).integers(0, cfg.vocab, (B, T))
    full, _ = jax.jit(functools.partial(RM.forward, rcfg, remat=False))(
        rp, {"tokens": jnp.asarray(toks, jnp.int32)})
    dec = jax.jit(functools.partial(RM.decode_step, rcfg))
    caches = RM.init_caches(rcfg, B, T)
    drift = 0.0
    for t in range(T):
        lg, caches = dec(rp, caches, jnp.asarray(toks[:, t], jnp.int32),
                         jnp.int32(t))
        drift = max(drift, float(np.max(np.abs(_np(lg) - _np(full[:, t])))))
    assert drift > 0.2
    tt = torch.from_numpy(toks)
    tc = M.init_caches(cfg, B, T, device="cpu", dtype=torch.float32)
    want, _ = M.forward(cfg, lm, {"tokens": tt})
    for t in range(T):
        got, tc = M.decode_step(cfg, lm, tc, tt[:, t], t)
        _close(got, want[:, t], 1e-3)


def test_decode_step_checks_only_caches_with_a_sequence_axis():
    """Recurrent states and a local ring have no positions to run out
    of; an MLA latent cache has, like full attention's."""
    _, cfg, _, lm = _models(("recurrentgemma-2b", {}))
    caches = M.init_caches(cfg, 1, 4, device="cpu")
    tok = torch.zeros(1, dtype=torch.long)
    logits, _ = M.decode_step(cfg, lm, caches, tok, 40)
    assert logits.shape == (1, cfg.vocab)
    _, cfg, _, lm = _models(("deepseek-v2-236b", {}))
    caches = M.init_caches(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="outside the 4-position cache"):
        M.decode_step(cfg, lm, caches, tok, 4)


@pytest.mark.parametrize("name", [n for n in FAMILIES
                                  if not ARCHS[n].encoder_only])
def test_serve_main_on_the_cpu(name, capsys):
    """``serve.main --arch X --reduced --device cpu`` for every family
    with a decode; the same seed gives the same tokens (a vision model's
    image embeddings included)."""
    argv = ["--arch", name, "--reduced", "--batch", "2", "--prompt-len", "4",
            "--gen", "3", "--device", "cpu"]
    gen = serve.main(argv)
    cfg = ARCHS[name].reduced()
    assert gen.shape == (2, 7) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < cfg.vocab)).all()
    assert "generated 2x7 tokens in" in capsys.readouterr().out
    assert np.array_equal(gen, serve.main(argv))


# --------------------------------------------------------------------------
# the smoke's full-width configs
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", FAMILIES)
def test_the_smoke_s_family_configs_are_the_reference_s(smoke, name):
    """Each family the smoke runs at full width, cut in depth where it
    says (``dataclasses.replace(cfg, n_layers=...)``): the reference's
    config cut the same way, the port's parameters on ``meta`` of the
    shapes of ``jax.eval_shape(init_model)``'s, and the count the smoke
    checks on the card."""
    (layers, n), = [(l, n) for f, l, n in smoke.FAMILIES if f == name]
    rcfg = RARCHS[name] if layers is None else \
        dataclasses.replace(RARCHS[name], n_layers=layers)
    cfg = smoke.family_config(name, layers)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(rcfg)
    assert meta_matches_reference(rcfg, cfg) == n
