"""The port's LM (``repro_torch.models``, ``launch.steps``, ``serve_llm``)
against ``repro`` on the CPU.

The same parameters, drawn with numpy from a seed, go into both packages
(``convert.from_reference`` on the port's side), and the same inputs.  The
reference runs unsharded: no activation sharder is installed (its
``serve.main`` fails in this container in ``launch/sharding.py``, ROADMAP
C3), so the port is held against ``repro.models.model``'s functions.

Tolerances, each from the dtype:

* float32 parameters and inputs (the algorithm): ``F32_TOL`` = 2e-5
  absolute on values of order 1, a few float32 ulps of difference in the
  order of the sums.
* bfloat16 (the reference's working dtype): one bfloat16 rounding is a
  relative 2**-8; XLA and PyTorch round the projections' and the
  elementwise ops' results at different places, so a value of order 1
  may differ by an ulp or two.  ``BF16_TOL`` = 2**-5 (two ulps of a
  value in [2, 4)) on layer outputs; logits of the two-layer reduced
  models, where the roundings compound, ``LOGIT_TOL`` = 0.1 (the
  reference's own decode-against-forward bound is 0.2,
  ``tests/test_archs.py``).
"""

import dataclasses
import functools

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
from repro_torch.launch import serve, steps
from repro_torch.models import convert
from repro_torch.models import layers as L
from repro_torch.models import model as M

F32_TOL = 2e-5
BF16_TOL = 2 ** -5
LOGIT_TOL = 0.1

DENSE = ["qwen3-8b", "qwen2.5-32b", "qwen1.5-32b", "mistral-nemo-12b"]
#: qwen3-8b reduced with an attention and a local layer of window 4
LOCAL = ("qwen3-8b", {"group": ("attn", "local"), "window": 4})
CASES = [(n, {}) for n in DENSE] + [LOCAL]
CASE_IDS = DENSE + ["qwen3-8b-local"]
FAMILIES = ["recurrentgemma-2b", "qwen3-moe-235b-a22b", "deepseek-v2-236b",
            "rwkv6-1.6b", "llama-3.2-vision-90b", "hubert-xlarge"]
#: Every architecture's parameters at full width, from ``jax.eval_shape``
#: over the reference's ``init_model``.
FULL_PARAMS = {
    "qwen3-8b": 8_190_735_360, "qwen1.5-32b": 35_197_096_960,
    "qwen2.5-32b": 32_763_876_352, "mistral-nemo-12b": 12_247_782_400,
    "recurrentgemma-2b": 3_549_795_840,
    "qwen3-moe-235b-a22b": 235_093_634_560,
    "deepseek-v2-236b": 235_741_434_880, "hubert-xlarge": 1_260_360_960,
    "rwkv6-1.6b": 1_583_892_480, "llama-3.2-vision-90b": 87_729_709_076}


def _cfgs(name, overrides=None):
    """The reduced config in both packages."""
    overrides = overrides or {}
    return (RARCHS[name].reduced(**overrides),
            ARCHS[name].reduced(**overrides))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want))) if got.size else 0.0
    assert err <= tol, err
    return err


def _random_tree(rcfg, seed: int):
    """The reference's parameter tree with every leaf drawn by numpy:
    matrices ``N(0, 1/fan_in)``, the embedding ``N(0, 0.02**2)``, norms and
    biases ``N(0, 0.1**2)`` (nonzero, so that they count), in each leaf's
    dtype."""
    shapes = jax.eval_shape(lambda: RM.init_model(rcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(seed)

    def fill(path, s):
        name = path[-1].key
        shape = s.shape
        if name == "embed":
            scale = 0.02
        elif len(shape) >= 2 and path[0].key != "groups" or len(shape) >= 3:
            scale = 1.0 / np.sqrt(shape[-2])
        else:
            scale = 0.1
        v = rng.standard_normal(shape).astype(np.float32) * scale
        return v.astype(s.dtype)

    return jax.tree_util.tree_map_with_path(fill, shapes)


def _models(case, seed=0, f32=False):
    """Both packages' models on one random tree; with ``f32``, its values
    in float32 in both."""
    name, over = case
    rcfg, cfg = _cfgs(name, over)
    tree = _random_tree(rcfg, seed)
    lm = convert.from_reference(cfg, tree, device="cpu")
    if f32:
        tree = jax.tree.map(lambda a: a.astype(np.float32), tree)
        lm = lm.float()
    return rcfg, cfg, jax.tree.map(jnp.asarray, tree), lm


def _rand(rng, shape, dtype, scale=1.0):
    v = rng.standard_normal(shape).astype(np.float32) * scale
    return jnp.asarray(v).astype(dtype), \
        torch.from_numpy(v).to({jnp.float32: torch.float32,
                                jnp.bfloat16: torch.bfloat16}[dtype])


DTYPES = [(jnp.float32, F32_TOL), (jnp.bfloat16, BF16_TOL)]
DTYPE_IDS = ["f32", "bf16"]


# --------------------------------------------------------------------------
# configs and parameters
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(RARCHS))
def test_configs_are_the_reference_copies(name):
    r, t = RARCHS[name], ARCHS[name]
    assert dataclasses.asdict(r) == dataclasses.asdict(t)
    for attr in ("hd", "n_groups", "sub_quadratic", "n_params",
                 "n_params_active"):
        assert getattr(r, attr) == getattr(t, attr), attr
    assert dataclasses.asdict(r.reduced()) == dataclasses.asdict(t.reduced())


@pytest.mark.parametrize("case", CASES + [(n, {}) for n in FAMILIES],
                         ids=CASE_IDS + FAMILIES)
def test_from_reference_round_trip(case):
    """Every leaf lands bit for bit in exactly one port tensor (bfloat16
    compared as uint16), 0-d ones (a cross layer's gate, one a group)
    keeping their shape, and the counts agree."""
    name, over = case
    rcfg, cfg = _cfgs(name, over)
    tree = jax.tree.map(np.asarray,
                        RM.init_model(rcfg, jax.random.PRNGKey(3)))
    lm = convert.from_reference(cfg, tree, device="cpu")
    got = dict(lm.named_parameters())
    n_leaves = n_elems = 0
    for path, arr in convert._leaves(tree):
        for pname, idx in convert.port_names(cfg, path):
            want = np.array(np.asarray(arr)[idx], order="C")
            t = got[pname]
            if want.dtype.name == "bfloat16":
                assert t.dtype == torch.bfloat16
                assert np.array_equal(t.view(torch.int16).numpy().view(
                    np.uint16), want.view(np.uint16)), pname
            else:
                assert t.dtype == torch.float32
                assert np.array_equal(t.numpy(), want), pname
            n_leaves += 1
            n_elems += want.size
    assert n_leaves == len(got)
    assert n_elems == sum(t.numel() for t in got.values()) == \
        sum(np.asarray(a).size for a in jax.tree.leaves(tree))


def test_from_reference_raises_on_a_leaf_left_over():
    rcfg, cfg = _cfgs("qwen3-8b")
    tree = jax.tree.map(np.asarray,
                        RM.init_model(rcfg, jax.random.PRNGKey(0)))
    tree["prefix"] = [{"extra": np.zeros(3, np.float32)}]
    with pytest.raises(ValueError, match="has no port tensor"):
        convert.from_reference(cfg, tree, device="cpu")
    tree = jax.tree.map(np.asarray,
                        RM.init_model(rcfg, jax.random.PRNGKey(0)))
    del tree["norm_f"]
    with pytest.raises(ValueError, match="no reference leaf.*norm_f"):
        convert.from_reference(cfg, tree, device="cpu")


def meta_matches_reference(rcfg, cfg) -> int:
    """Assert that the port's parameters of ``cfg`` on ``meta`` have the
    shapes and dtypes of ``jax.eval_shape(init_model)``'s unstacked
    leaves for ``rcfg``; return their count."""
    shapes = jax.eval_shape(
        lambda: RM.init_model(rcfg, jax.random.PRNGKey(0)))
    lm = M.LM(cfg, device="meta")
    got = {n: (tuple(t.shape), t.dtype) for n, t in lm.named_parameters()}
    want = {}
    for path, s in convert._leaves(shapes):
        for pname, idx in convert.port_names(cfg, path):
            want[pname] = (tuple(s.shape[len(idx):]),
                           {"bfloat16": torch.bfloat16,
                            "float32": torch.float32}[s.dtype.name])
    assert got == want
    n = sum(int(np.prod(s.shape)) for s in jax.tree.leaves(shapes))
    assert sum(t.numel() for t in lm.parameters()) == n
    return n


@pytest.mark.parametrize("name", list(FULL_PARAMS))
def test_full_width_shapes_on_meta(name):
    """At full width the port's parameters have the shapes and dtypes of
    ``jax.eval_shape(init_model)``'s unstacked leaves, and their count is
    :data:`FULL_PARAMS`'s; nothing is allocated."""
    assert meta_matches_reference(RARCHS[name], ARCHS[name]) == \
        FULL_PARAMS[name]


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
def test_rms_norm(dtype, tol):
    rng = np.random.default_rng(1)
    xj, xt = _rand(rng, (2, 5, 64), dtype, 3.0)
    wj, wt = _rand(rng, (64,), jnp.float32, 0.1)
    _close(L.rms_norm(xt, wt, 1e-6), RL.rms_norm(xj, wj, 1e-6), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rotary(dtype, tol, theta):
    rng = np.random.default_rng(2)
    xj, xt = _rand(rng, (2, 7, 4, 16), dtype)
    pos = rng.integers(0, 2048, (2, 7))
    _close(L.rotary(xt, torch.from_numpy(pos), theta),
           RL.rotary(xj, jnp.asarray(pos, jnp.int32), theta), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
def test_group_attn_gqa(dtype, tol):
    """Eight query heads on two KV heads: query head h reads KV head
    h // 4, under a random mask (every row keeps one key)."""
    rng = np.random.default_rng(3)
    qj, qt = _rand(rng, (2, 5, 8, 16), dtype)
    kj, kt = _rand(rng, (2, 9, 2, 16), dtype)
    vj, vt = _rand(rng, (2, 9, 2, 16), dtype)
    mask = rng.random((2, 5, 9)) < 0.6
    mask[..., 0] = True
    _close(L._group_attn(qt, kt, vt, torch.from_numpy(mask)),
           RL._group_attn(qj, kj, vj, jnp.asarray(mask)), tol)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
@pytest.mark.parametrize("sq,window", [(16, 0), (512, 0), (512, 100),
                                       (1024, 0), (1024, 300)],
                         ids=["16", "512", "512-window", "1024-chunked",
                              "1024-chunked-window"])
def test_sdpa(dtype, tol, sq, window):
    """At most 512 queries in one tile; 1024 in two chunks of 512."""
    rng = np.random.default_rng(4)
    qj, qt = _rand(rng, (1, sq, 4, 8), dtype)
    kj, kt = _rand(rng, (1, sq, 2, 8), dtype)
    vj, vt = _rand(rng, (1, sq, 2, 8), dtype)
    _close(L._sdpa(qt, kt, vt, causal=True, window=window),
           RL._sdpa(qj, kj, vj, causal=True, window=window), tol)


def _attn_params(rcfg, cfg, rng, cross=False):
    rp = RL.init_attention(rcfg, jax.random.PRNGKey(0), cross=cross)
    tree = {k: (rng.standard_normal(v.shape).astype(np.float32)
                * (1 / np.sqrt(v.shape[0]) if v.ndim == 2 else 0.1)
                ).astype(v.dtype) for k, v in rp.items()}
    return ({k: jnp.asarray(v) for k, v in tree.items()},
            {k: convert.to_tensor(v) for k, v in tree.items()})


ATTN_CASES = {
    "attn": ("qwen3-8b", {}, "attn"),
    "local": ("qwen3-8b", {"window": 4}, "local"),
    "qkv-bias": ("qwen1.5-32b", {}, "attn"),
    "gqa-qkv-bias": ("qwen2.5-32b", {}, "attn"),
    "plain": ("mistral-nemo-12b", {}, "attn"),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_apply_attention_prefill_and_decode(case):
    """Prefill with ``cache="collect"`` (the decode caches compared too:
    the ring of a local layer with its positions), then one decode step
    on those caches, grown to 12 positions for ``attn``."""
    name, over, kind = ATTN_CASES[case]
    rcfg, cfg = _cfgs(name, over)
    rng = np.random.default_rng(5)
    rp, tp = _attn_params(rcfg, cfg, rng)
    s = 7
    xj, xt = _rand(rng, (2, s, rcfg.d_model), jnp.bfloat16)
    pos = np.tile(np.arange(s), (2, 1))
    want, rc = RL.apply_attention(rcfg, rp, xj, pos=jnp.asarray(pos),
                                  kind=kind, cache="collect")
    got, tc = L.apply_attention(cfg, tp, xt, pos=torch.from_numpy(pos),
                                kind=kind, cache="collect")
    _close(got, want, BF16_TOL)
    assert set(tc) == set(rc)
    for key in rc:
        if key == "pos":
            assert np.array_equal(tc[key].numpy(), np.asarray(rc[key]))
        else:
            _close(tc[key], rc[key], BF16_TOL)
    if kind == "attn":      # room for the next position
        grow = lambda c: jnp.pad(c, ((0, 0), (0, 5), (0, 0), (0, 0)))
        rc = {k: grow(v) for k, v in rc.items()}
        tc = {k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 5))
              for k, v in tc.items()}
    x1j, x1t = _rand(rng, (2, 1, rcfg.d_model), jnp.bfloat16)
    want, rc = RL.apply_attention(rcfg, rp, x1j,
                                  pos=jnp.full((2, 1), s, jnp.int32),
                                  kind=kind, cache=rc)
    got, tc = L.apply_attention(cfg, tp, x1t,
                                pos=torch.full((2, 1), s, dtype=torch.long),
                                kind=kind, cache=tc)
    _close(got, want, BF16_TOL)
    for key in rc:
        if key == "pos":
            assert np.array_equal(tc[key].numpy(), np.asarray(rc[key]))
        else:
            _close(tc[key], rc[key], BF16_TOL)


def test_apply_attention_cross():
    """The cross branch: keys and values given, no rotary, no mask, the
    output scaled by tanh of the gate."""
    rcfg, cfg = _cfgs("qwen3-8b")
    rng = np.random.default_rng(6)
    rp, tp = _attn_params(rcfg, cfg, rng, cross=True)
    xj, xt = _rand(rng, (2, 5, rcfg.d_model), jnp.bfloat16)
    kj, kt = _rand(rng, (2, 6, rcfg.n_kv_heads, rcfg.hd), jnp.bfloat16)
    vj, vt = _rand(rng, (2, 6, rcfg.n_kv_heads, rcfg.hd), jnp.bfloat16)
    pos = np.tile(np.arange(5), (2, 1))
    want, rc = RL.apply_attention(rcfg, rp, xj, pos=jnp.asarray(pos),
                                  kind="cross", cache="collect",
                                  cross_kv=(kj, vj))
    got, tc = L.apply_attention(cfg, tp, xt, pos=torch.from_numpy(pos),
                                kind="cross", cache="collect",
                                cross_kv=(kt, vt))
    assert rc == tc == {}
    assert float(np.max(np.abs(_np(want)))) > 0
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("dtype,tol", DTYPES, ids=DTYPE_IDS)
def test_apply_ffn(dtype, tol):
    rng = np.random.default_rng(7)
    p = {k: _rand(rng, shape, dtype, 1 / np.sqrt(shape[0]))
         for k, shape in (("w1", (64, 128)), ("w3", (64, 128)),
                          ("w2", (128, 64)))}
    xj, xt = _rand(rng, (2, 5, 64), dtype)
    _close(L.apply_ffn({k: v[1] for k, v in p.items()}, xt),
           RL.apply_ffn({k: v[0] for k, v in p.items()}, xj), tol)


# --------------------------------------------------------------------------
# the model
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _ref_fns(name, over):
    rcfg = RARCHS[name].reduced(**dict(over))
    return (jax.jit(functools.partial(RM.forward, rcfg, remat=False)),
            jax.jit(functools.partial(RM.prefill, rcfg)),
            jax.jit(functools.partial(RM.decode_step, rcfg)))


def _tokens(cfg, b, t, seed=8):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab, (b, t))
    return jnp.asarray(toks, jnp.int32), torch.from_numpy(toks)


@pytest.mark.parametrize("f32", [False, True], ids=["bf16", "f32"])
@pytest.mark.parametrize("case", CASES, ids=CASE_IDS)
def test_forward_prefill_decode_match_reference(case, f32):
    """``forward``'s logits at every position, ``prefill``'s last logits,
    and 8 teacher-forced ``decode_step``s (past the local window of 4),
    each against the reference on the same parameters; the caches in the
    parameters' dtype."""
    name, over = case
    rcfg, cfg, rp, lm = _models(case, f32=f32)
    tol = F32_TOL if f32 else LOGIT_TOL
    fwd, pre, dec = _ref_fns(name, tuple(sorted(over.items())))
    B, T = 2, 8
    tj, tt = _tokens(cfg, B, T)
    want, _ = fwd(rp, {"tokens": tj})
    got, _ = M.forward(cfg, lm, {"tokens": tt})
    _close(got, want, tol)
    want, _ = pre(rp, {"tokens": tj})
    got, _ = M.prefill(cfg, lm, {"tokens": tt})
    _close(got, want, tol)
    cdt = jnp.float32 if f32 else jnp.bfloat16
    rc = jax.tree.map(lambda c: c.astype(cdt) if c.dtype == jnp.bfloat16
                      else c, RM.init_caches(rcfg, B, 16))
    tc = M.init_caches(cfg, B, 16, device="cpu",
                       dtype=torch.float32 if f32 else torch.bfloat16)
    for t in range(T):
        want, rc = dec(rp, rc, tj[:, t], jnp.int32(t))
        got, tc = M.decode_step(cfg, lm, tc, tt[:, t], t)
        _close(got, want, tol)


def test_prefill_caches_continue_decoding():
    """Prefill's caches, grown to the decode length, continue decoding as
    the reference's do (its ``test_prefill_then_decode_continues``)."""
    rcfg, cfg, rp, lm = _models(CASES[0])
    B, S = 2, 16
    tj, tt = _tokens(cfg, B, S + 4)
    _, rc = RM.prefill(rcfg, rp, {"tokens": tj[:, :S]})
    _, tc = M.prefill(cfg, lm, {"tokens": tt[:, :S]})
    rc = {"prefix": rc["prefix"], "groups": jax.tree.map(
        lambda c: jnp.pad(c, [(0, 0), (0, 0), (0, 4), (0, 0), (0, 0)]),
        rc["groups"])}
    tc = [{k: torch.nn.functional.pad(v, (0, 0, 0, 0, 0, 4))
           for k, v in c.items()} for c in tc]
    for t in range(S, S + 4):
        want, rc = RM.decode_step(rcfg, rp, rc, tj[:, t], jnp.int32(t))
        got, tc = M.decode_step(cfg, lm, tc, tt[:, t], t)
        _close(got, want, LOGIT_TOL)


def test_decode_step_refuses_a_position_past_the_cache():
    _, cfg, _, lm = _models(CASES[0])
    caches = M.init_caches(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="outside the 4-position cache"):
        M.decode_step(cfg, lm, caches, torch.zeros(1, dtype=torch.long), 4)


@pytest.mark.parametrize("case", [CASES[0], LOCAL], ids=["qwen3-8b",
                                                         "qwen3-8b-local"])
def test_generate_matches_the_reference_loop(case):
    """``serve.generate`` against the reference's ``serve_llm`` loop
    (``jax.jit(make_decode_step(cfg))``, prompt teacher-forced, then
    greedy): the prompt comes back as given, and each greedy token is the
    reference's wherever the reference's top-2 margin exceeds
    ``LOGIT_TOL``; a row whose token differs at a near-tie is not compared
    further (its inputs differ from then on)."""
    rcfg, cfg, rp, lm = _models(case)
    B, P, G = 4, 6, 10
    tj, tt = _tokens(cfg, B, P, seed=9)
    got = serve.generate(cfg, lm, tt, G).numpy()
    assert got.shape == (B, P + G) and got.dtype == np.int32
    assert np.array_equal(got[:, :P], tt.numpy())
    step = jax.jit(rsteps.make_decode_step(rcfg))
    caches = RM.init_caches(rcfg, B, P + G)
    cur, live, compared = tj[:, 0], np.ones(B, bool), 0
    for t in range(P + G - 1):
        nxt, logits, caches = step(rp, caches,
                                   {"token": cur, "pos": jnp.int32(t)})
        if t + 1 < P:
            cur = tj[:, t + 1]
            continue
        top2 = np.sort(_np(logits), -1)[:, -2:]
        same = np.asarray(nxt) == got[:, t + 1]
        tie = top2[:, 1] - top2[:, 0] <= LOGIT_TOL
        assert np.all(same | tie | ~live), t
        compared += int(np.sum(live & ~tie))
        live &= same
        cur = jnp.asarray(got[:, t + 1])
    assert compared >= B * G // 4         # not vacuous


def test_serve_main_on_the_cpu(capsys):
    gen = serve.main(["--arch", "qwen3-8b", "--reduced", "--batch", "2",
                      "--prompt-len", "8", "--gen", "4", "--device", "cpu"])
    assert gen.shape == (2, 12) and gen.dtype == np.int32
    assert ((gen >= 0) & (gen < ARCHS["qwen3-8b"].reduced().vocab)).all()
    out = capsys.readouterr().out
    assert "generated 2x12 tokens in" in out and "tok/s" in out
    # the same seed gives the same weights, prompt and tokens
    again = serve.main(["--reduced", "--batch", "2", "--prompt-len", "8",
                        "--gen", "4", "--device", "cpu"])
    assert np.array_equal(gen, again)


@pytest.mark.parametrize("argv", [["--prompt-len", "0"], ["--gen", "-1"],
                                  ["--batch", "0"]])
def test_serve_main_refuses_empty_counts(argv):
    with pytest.raises(ValueError, match="need a row, a prompt token"):
        serve.main(["--reduced", "--device", "cpu"] + argv)


def test_serve_main_with_one_token_and_no_step(capsys):
    gen = serve.main(["--reduced", "--device", "cpu", "--prompt-len", "1",
                      "--gen", "0", "--batch", "1"])
    assert gen.shape == (1, 1)
    assert "decode steps" not in capsys.readouterr().out


@pytest.mark.parametrize("name", ["hubert-xlarge"])
def test_other_families_raise_a14(name):
    """Every family is ported (``test_torch_lm_families.py``); what still
    raises is the reference's own refusal: an encoder-only model has no
    decode to serve."""
    with pytest.raises(AssertionError, match="encoder-only"):
        serve.main(["--arch", name, "--reduced", "--device", "cpu"])


def test_steps_grid_is_the_reference_grid():
    assert {k: dataclasses.astuple(v) for k, v in steps.SHAPES.items()} == \
        {k: dataclasses.astuple(v) for k, v in rsteps.SHAPES.items()}
    for name in RARCHS:
        for shape in rsteps.SHAPES:
            assert steps.cell_skip_reason(
                ARCHS[name], steps.SHAPES[shape]) == rsteps.cell_skip_reason(
                RARCHS[name], rsteps.SHAPES[shape])


def test_prefill_step_and_decode_step_builders():
    _, cfg, _, lm = _models(CASES[0])
    _, tt = _tokens(cfg, 2, 5)
    logits, caches = steps.make_prefill_step(cfg)(lm, {"tokens": tt})
    assert logits.shape == (2, cfg.vocab) and len(caches) == cfg.n_layers
    caches = M.init_caches(cfg, 2, 5, device="cpu")
    nxt, logits, caches = steps.make_decode_step(cfg)(
        lm, caches, {"token": tt[:, 0], "pos": 0})
    assert nxt.dtype == torch.int32
    assert torch.equal(nxt, logits.argmax(-1).to(torch.int32))
