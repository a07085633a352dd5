"""The decode-attention kernel (``csrc/decode_attn.cu``) on the card.

Each test holds :func:`repro_torch.kernels.attention.decode_attn` to a
float64 evaluation of the same attention and to the plain ``_group_attn``
on the same inputs: the kernel's error may exceed the plain version's
largest by one bfloat16 ulp of the output (in float32 caches, its
largest error within twice the plain version's).  The kernel has no CPU
version, so those tests are ``cuda``-marked and skip without a card; the
wrapper's rules from the shape and its CPU path are tested here too.
This file imports neither JAX nor the JAX package:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_attn.py
"""

import math

import numpy as np
import pytest
import torch

from repro_torch.kernels import attention, pim_exec

#: The benchmark's cell: batch, slots, query heads, KV heads, head dim.
CELL = (256, 576, 32, 8, 128)
GROUPS = (1, 2, 4, 5, 8, 16)
HEAD_DIMS = (16, 64, 80, 128, 144, 256)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the decode-attention kernel has "
                    "no CPU version")
    return torch.device("cuda")


def _inputs(dev, b, s, h, kh, hd, seed, dtype=torch.bfloat16):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = (2 * torch.randn((b, 1, h, hd), generator=gen, device=dev)).to(dtype)
    k = torch.randn((b, s, kh, hd), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kh, hd), generator=gen, device=dev).to(dtype)
    return q, k, v


def _pos(dev, b, p):
    return torch.full((b, 1), p, dtype=torch.long, device=dev)


def _exact(q, k, v, p):
    """The attention in float64 over the slots up to ``p``."""
    b, _, h, hd = q.shape
    kh = k.shape[2]
    n = min(p + 1, k.shape[1])
    q64 = q.double().reshape(b, kh, h // kh, hd)
    s = torch.einsum("bkgd,bskd->bkgs", q64, k[:, :n].double()) \
        / math.sqrt(hd)
    o = torch.einsum("bkgs,bskd->bkgd", torch.softmax(s, -1),
                     v[:, :n].double())
    return o.reshape(b, 1, h, hd)


def _ulp(x, dtype):
    """One ulp of each value of ``x`` in ``dtype`` (bfloat16)."""
    e = torch.floor(torch.log2(x.abs().clamp_min(torch.finfo(dtype).tiny)))
    return torch.exp2(e - 7)


def _hold(q, k, v, p):
    """The kernel's output, after holding it to the float64 attention and
    the plain version's error.  In bfloat16 each output's error may exceed
    the plain version's largest by one bfloat16 ulp of the output.  In
    float32 both compute the same float32 scores, products and sums in
    other orders, and the scores' rounding (about 1e-6 here) dominates
    either's error; the kernel's largest may be at most twice the plain
    version's."""
    pos = _pos(q.device, q.shape[0], p)
    got = attention.decode_attn(q, k, v, pos)
    plain = attention.plain(q, k, v, pos)
    torch.cuda.synchronize()
    assert got.shape == q.shape and got.dtype == k.dtype
    want = _exact(q, k, v, p)
    err = (got.double() - want).abs()
    plain_err = (plain.double() - want).abs().max()
    if k.dtype == torch.bfloat16:
        bad = err > plain_err + _ulp(want, torch.bfloat16)
    else:
        bad = err > 2 * plain_err
    assert not bad.any(), (f"{int(bad.sum())} outputs; kernel error "
                           f"{float(err.max())}, plain {float(plain_err)}")
    return got


@pytest.mark.parametrize("hd,itemsize,tile", [
    (16, 2, 128), (64, 2, 128), (128, 2, 64), (256, 2, 32), (48, 2, 128),
    (80, 2, 64), (16, 4, 128), (128, 4, 32), (256, 4, 16)])
def test_tiles_hold_about_16_kb_of_keys(hd, itemsize, tile):
    """A power of two from 16 to 128 slots, the most whose keys fit."""
    assert attention.tile_slots(hd, itemsize) == tile


@pytest.mark.parametrize("q_dtype,kv_dtype,hd,tile", [
    (torch.bfloat16, torch.bfloat16, 128, 64),
    (torch.bfloat16, torch.bfloat16, 16, 64),
    (torch.bfloat16, torch.bfloat16, 144, 32),
    (torch.bfloat16, torch.bfloat16, 256, 32),
    (torch.float32, torch.bfloat16, 128, 64),
    (torch.float32, torch.bfloat16, 16, 128),
    (torch.bfloat16, torch.float32, 128, 32),
    (torch.float32, torch.float32, 64, 64)])
def test_the_path_and_tile_come_from_dtypes_and_head_dim(q_dtype, kv_dtype,
                                                         hd, tile):
    """bfloat16 over bfloat16 up to head dim 128 takes the tensor cores'
    64-slot tiles; anything else the CUDA cores' :func:`tile_slots`."""
    assert attention.tile_for(q_dtype, kv_dtype, hd) == tile


def test_on_the_cpu_the_wrapper_is_the_plain_version():
    """CPU tensors take ``_group_attn`` under the prefix mask and launch
    nothing."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(torch.bfloat16)
               for shape in ((2, 1, 8, 16), (2, 12, 2, 16), (2, 12, 2, 16)))
    pos = torch.full((2, 1), 5, dtype=torch.long)
    before = dict(pim_exec.LAUNCHES)
    got = attention.decode_attn(q, k, v, pos)
    assert pim_exec.LAUNCHES == before
    want = attention.plain(q, k, v, pos)
    assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    exact = _exact(q, k, v, 5)
    assert float((got.double() - exact).abs().max()) < 2 ** -6


@pytest.mark.cuda
@pytest.mark.parametrize("p", [0, 1, 63, 64, 287, 511, 575])
def test_the_cells_shape(card, p):
    b, s, h, kh, hd = CELL
    q, k, v = _inputs(card, b, s, h, kh, hd, seed=p)
    before = pim_exec.LAUNCHES["decode_attn"]
    _hold(q, k, v, p)
    assert pim_exec.LAUNCHES["decode_attn"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("g", GROUPS)
def test_groups_and_head_dims(card, g, hd):
    """A small batch, the position inside the last tile: the tensor cores
    up to head dim 128, the CUDA cores above, one launch each."""
    b, s, kh, p = 2, 200, 2, 137
    q, k, v = _inputs(card, b, s, g * kh, kh, hd, seed=100 * g + hd)
    before = pim_exec.LAUNCHES["decode_attn"]
    _hold(q, k, v, p)
    assert pim_exec.LAUNCHES["decode_attn"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("b,p", [(2, 137), (64, 300)], ids=["b2", "b64"])
def test_float32_caches(card, b, p):
    """Float32 weights and caches (the float32 checks of the LM on the
    card) take the kernel too."""
    q, k, v = _inputs(card, b, 400, 8, 2, 128, seed=b, dtype=torch.float32)
    _hold(q, k, v, p)


@pytest.mark.cuda
def test_a_float32_query_over_bfloat16_caches(card):
    """A float32 model's decode step over caches left in bfloat16 (the
    default of ``init_caches``): the query stays float32."""
    q, k, v = _inputs(card, 4, 300, 8, 2, 128, seed=5)
    q = q.float() + torch.randn(q.shape, device=card) * 1e-3
    _hold(q, k, v, 250)


@pytest.mark.cuda
def test_strided_caches(card):
    """Caches laid out [B, K, S, hd] and seen as [B, S, K, hd], and a
    query that is a slice: strides, not copies."""
    b, s, h, kh, hd = 4, 96, 8, 2, 64
    q, k, v = _inputs(card, b, s, h, kh, hd, seed=7)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    vt = v.transpose(1, 2).contiguous().transpose(1, 2)
    wide = torch.cat([q, q], 2)[:, :, :h]
    assert not kt.is_contiguous() and not wide.is_contiguous()
    got = _hold(wide, kt, vt, 50)
    assert torch.equal(got, attention.decode_attn(
        q, k, v, _pos(card, b, 50)))


def _planted(k, v, p, value):
    k, v = k.clone(), v.clone()
    k[:, p + 1:] = value
    v[:, p + 1:] = value
    return k, v


@pytest.mark.cuda
@pytest.mark.parametrize("shape,p", [(CELL, 287), (CELL, 575),
                                     ((2, 200, 8, 2, 128), 137),
                                     ((3, 150, 5, 1, 16), 0)],
                         ids=["cell-287", "cell-575", "small", "first-slot"])
def test_slots_past_the_position_are_never_read(card, shape, p):
    """NaN or 1e30 in every slot past the position leaves the output
    bit-identical to zeros there."""
    b, s, h, kh, hd = shape
    q, k, v = _inputs(card, b, s, h, kh, hd, seed=11)
    pos = _pos(card, b, p)
    want = attention.decode_attn(q, *_planted(k, v, p, 0.0), pos)
    for value in (float("nan"), 1e30):
        got = attention.decode_attn(q, *_planted(k, v, p, value), pos)
        assert torch.equal(got, want), value
    assert torch.isfinite(want).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    ("head dim 8", (2, 16, 4, 2, 8), torch.bfloat16, ValueError),
    ("head dim 24", (2, 16, 4, 2, 24), torch.bfloat16, ValueError),
    ("head dim 272", (2, 16, 4, 2, 272), torch.bfloat16, ValueError),
    ("17 heads a KV head", (2, 16, 17, 1, 64), torch.bfloat16, ValueError),
    ("heads not a multiple", (2, 16, 6, 4, 64), torch.bfloat16, ValueError),
    ("float16", (2, 16, 4, 2, 64), torch.float16, TypeError),
], ids=lambda c: c[0] if isinstance(c, tuple) else None)
def test_unsupported_shapes_raise(card, case):
    _, (b, s, h, kh, hd), dtype, err = case
    q, k, v = _inputs(card, b, s, h, kh, hd, seed=0, dtype=dtype)
    with pytest.raises(err):
        attention.decode_attn(q, k, v, _pos(card, b, 3))


@pytest.mark.cuda
def test_unsupported_layouts_raise(card):
    q, k, v = _inputs(card, 2, 16, 4, 2, 64, seed=0)
    pos = _pos(card, 2, 3)
    with pytest.raises(ValueError, match=r"\[B, 1, H, hd\]"):
        attention.decode_attn(torch.cat([q, q], 1), k, v, pos)
    with pytest.raises(ValueError, match="last axis"):
        attention.decode_attn(q, k.transpose(1, 3).contiguous()
                              .transpose(1, 3), v, pos)
    with pytest.raises(TypeError, match="int64"):
        attention.decode_attn(q, k, v, pos.int())
    odd = torch.zeros(2 * 16 * 2 * 65, dtype=k.dtype, device=card)
    with pytest.raises(ValueError, match="16-byte"):
        attention.decode_attn(q, odd.as_strided(k.shape, (16 * 2 * 65,
                                                          2 * 65, 65, 1)),
                              v, pos)


@pytest.mark.cuda
def test_a_decode_step_on_the_card_takes_the_kernel(card):
    """Every layer of a decode step on CUDA tensors counts one kernel
    call and no plain one; the plain version on the same weights and
    caches gives the same next token."""
    from repro_torch.configs import registry
    from repro_torch.models import model as M
    from repro_torch.runtime import telemetry
    cfg = registry.get("qwen3-8b").reduced()
    lm = M.LM(cfg, device=card,
              generator=torch.Generator(device=card).manual_seed(0))
    caches = M.init_caches(cfg, 2, 8, device=card)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 4))).to(card)
    telemetry.REGISTRY.drain("lm.decode_attn.")
    with torch.no_grad():
        for t in range(4):
            logits, caches = M.decode_step(cfg, lm, caches, toks[:, t], t)
    assert telemetry.REGISTRY.drain("lm.decode_attn.") == {
        "lm.decode_attn.kernel": 4 * cfg.n_layers}
    assert torch.isfinite(logits.float()).all()
