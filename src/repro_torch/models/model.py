"""Model assembly on PyTorch: parameters, forward, loss, prefill, decode
step.

The port of ``repro.models.model`` for every layer kind (``attn``,
``local``, ``cross``, ``moe``, ``moe_dense``, ``recurrent``, ``rwkv``),
MLA attention and the audio and vision frontends: a ``prefix`` then
``n_groups`` repetitions of ``cfg.group``.  The reference stacks each
group's parameters on a leading axis and scans over it; here the layers
are one flat list in the order the scan visits them (:func:`layer_kinds`),
and a group's parameters are its layers' own tensors.  The decode caches
follow the same list.  ``forward`` runs the groups one by one, each under
``torch.utils.checkpoint`` when it trains (the reference's remat of the
scan body).

:class:`LM` holds the parameters on an explicit device, drawn from an
explicit ``torch.Generator`` (weights made on the card stay on the card);
:func:`repro_torch.models.convert.from_reference` fills one from the
reference's parameters instead.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..kernels.ops import _checked_device
from . import layers as L
from .config import ModelConfig

set_activation_sharder = L.set_activation_sharder
_shard = L._shard


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Every layer's kind, in order: the prefix, then the groups."""
    return list(cfg.prefix) + list(cfg.group) * cfg.n_groups


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_attn(cfg: ModelConfig, gen, *, device) -> L.Params:
    """The attention of a ``moe`` or ``moe_dense`` layer."""
    if cfg.mla is not None:
        return L.init_mla(cfg, gen, device=device)
    return L.init_attention(cfg, gen, device=device)


def init_layer(cfg: ModelConfig, kind: str, gen, *, device) -> L.Params:
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=device)
    p: Dict[str, Any] = {"ln1": zeros(), "ln2": zeros()}
    if kind in ("attn", "local", "cross"):
        if cfg.mla is not None and kind == "attn":
            p["attn"] = L.init_mla(cfg, gen, device=device)
        else:
            p["attn"] = L.init_attention(cfg, gen, cross=(kind == "cross"),
                                         device=device)
        p["ffn"] = L.init_ffn(gen, d, cfg.d_ff, device=device)
    elif kind == "moe":
        p["attn"] = _init_attn(cfg, gen, device=device)
        p["moe"] = L.init_moe(cfg, gen, device=device)
    elif kind == "moe_dense":
        p["attn"] = _init_attn(cfg, gen, device=device)
        p["ffn"] = L.init_ffn(gen, d, cfg.moe.d_ff_dense, device=device)
    elif kind == "recurrent":
        p["rnn"] = L.init_rglru(cfg, gen, device=device)
        p["ffn"] = L.init_ffn(gen, d, cfg.d_ff, device=device)
    elif kind == "rwkv":
        p["tmix"] = L.init_rwkv(cfg, gen, device=device)
    else:
        raise ValueError(kind)
    return L.Params(p)


class LM(L.Params):
    """The parameters of one model on ``device`` (``"cuda"`` unless the
    caller asks for another; ``"meta"`` allocates nothing), drawn from
    ``generator``, a ``torch.Generator`` on that device: ``embed`` [V, d]
    and ``norm_f`` [d], ``lm_head`` [d, V] unless tied, ``frontend``
    [frontend_dim, d] with a frontend, and ``layers``, one
    :class:`~repro_torch.models.layers.Params` a layer."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        device = _checked_device(device)
        if generator is None and torch.device(device).type != "meta":
            raise ValueError("LM needs a torch.Generator on its device")
        d = cfg.d_model
        items: Dict[str, Any] = {
            "embed": L._dense_init(generator, (cfg.vocab, d), 0.02,
                                   device=device),
            "norm_f": torch.zeros((d,), dtype=torch.float32, device=device)}
        if not cfg.tie_embeddings:
            items["lm_head"] = L._dense_init(generator, (d, cfg.vocab),
                                             device=device)
        if cfg.frontend != "none":
            items["frontend"] = L._dense_init(
                generator, (cfg.frontend_dim, d), device=device)
        items["layers"] = nn.ModuleList(
            init_layer(cfg, kind, generator, device=device)
            for kind in layer_kinds(cfg))
        super().__init__(items)
        self.cfg = cfg


def init_model(cfg: ModelConfig, generator: torch.Generator, *,
               device="cuda") -> LM:
    return LM(cfg, device=device, generator=generator)


# --------------------------------------------------------------------------
# layer application
# --------------------------------------------------------------------------

def apply_layer(cfg: ModelConfig, kind: str, p, x, *, pos, cache=None,
                cross_kv=None):
    """One pre-norm block: the mixer (attention, MLA, RG-LRU or the RWKV
    time mix), then the feed-forward (dense, MoE or the RWKV channel mix),
    each added to the residual.  Returns (x, new_cache, aux); aux is the
    MoE's load-balance loss, 0 for other layers."""
    aux = 0.0
    if kind == "rwkv":
        h, tc = L.apply_rwkv_timemix(
            cfg, p["tmix"], L.rms_norm(x, p["ln1"], cfg.norm_eps),
            cache=cache)
        x = x + h
        h, cc = L.apply_rwkv_channelmix(
            cfg, p["tmix"], L.rms_norm(x, p["ln2"], cfg.norm_eps),
            cache=cache)
        x = x + h
        new_cache = None if cache is None else {**tc, **cc}
        return x, new_cache, aux

    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    if kind == "recurrent":
        h, new_cache = L.apply_rglru(cfg, p["rnn"], h, cache=cache)
    elif cfg.mla is not None and kind in ("attn", "moe", "moe_dense"):
        h, new_cache = L.apply_mla(cfg, p["attn"], h, pos=pos, cache=cache)
    else:
        akind = {"moe": "attn", "moe_dense": "attn"}.get(kind, kind)
        h, new_cache = L.apply_attention(cfg, p["attn"], h, pos=pos,
                                         kind=akind, cache=cache,
                                         cross_kv=cross_kv)
    x = x + h
    h = L.rms_norm(x, p["ln2"], cfg.norm_eps)
    if kind == "moe":
        h, aux = L.apply_moe(cfg, p["moe"], h)
    else:
        h = L.apply_ffn(p["ffn"], h)
    return x + h, new_cache, aux


def _cross_kv(cfg: ModelConfig, p_attn, xv):
    b, sv, _ = xv.shape
    k = (xv @ p_attn["wk"]).reshape(b, sv, cfg.n_kv_heads, cfg.hd)
    v = (xv @ p_attn["wv"]).reshape(b, sv, cfg.n_kv_heads, cfg.hd)
    return k, v


def _frontend(params, feats):
    """Precomputed frame or patch embeddings, cast to bfloat16, times the
    frontend weight: in float32 when the weights are, as jnp promotes
    (``torch.matmul`` refuses mixed dtypes)."""
    w = params["frontend"]
    dt = torch.promote_types(torch.bfloat16, w.dtype)
    return feats.to(torch.bfloat16).to(dt) @ w.to(dt)


def _embed(cfg: ModelConfig, params, batch):
    """The input embeddings and the vision states (or None)."""
    if cfg.frontend == "audio":
        x = _frontend(params, batch["frames"])
    else:
        x = params["embed"][batch["tokens"].long()]
    xv = _frontend(params, batch["vision"]) if cfg.frontend == "vision" \
        else None
    return _shard("act", x), xv


def _logits(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["norm_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _shard("logits", x @ head)


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------

def _group(cfg: ModelConfig, layers, x, *, pos, xv):
    """One repetition of ``cfg.group``: returns (x, the sum of its layers'
    aux losses)."""
    ax = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(cfg.group, layers):
        ckv = _cross_kv(cfg, p["attn"], xv) if kind == "cross" else None
        x, _, aux = apply_layer(cfg, kind, p, x, pos=pos, cross_kv=ckv)
        ax = ax + aux
    return _shard("act", x), ax


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            remat: bool = True):
    """Returns (logits [B,S,V], the layers' mean aux loss).  ``batch``:
    ``tokens`` [B,S] (or ``frames`` [B,S,Df] for audio), ``vision``
    [B,Sv,Df] for vision.  With ``remat`` and autograd recording, each
    group of ``len(cfg.group)`` layers after the prefix runs under
    ``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
    ``nothing_saveable``): only the group's input is kept, the rest is
    recomputed in the backward pass."""
    x, xv = _embed(cfg, params, batch)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device).expand(b, s)
    layers = list(params["layers"])
    base, width = len(cfg.prefix), len(cfg.group)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for kind, p in zip(cfg.prefix, layers[:base]):
        x, _, aux = apply_layer(cfg, kind, p, x, pos=pos)
        aux_total = aux_total + aux
    auxs = []
    for g in range(cfg.n_groups):
        body = functools.partial(
            _group, cfg, layers[base + g * width: base + (g + 1) * width],
            pos=pos, xv=xv)
        if remat and torch.is_grad_enabled():
            x, ax = checkpoint(body, x, use_reentrant=False,
                               preserve_rng_state=False)
        else:
            x, ax = body(x)
        auxs.append(ax)
    if auxs:
        aux_total = aux_total + torch.stack(auxs).sum()
    return _logits(cfg, params, x), aux_total / max(cfg.n_layers, 1)


def loss_fn(cfg: ModelConfig, params, batch, *, remat: bool = True):
    """The mean next-token cross-entropy over the labels ``>= 0`` (in
    float32) plus 0.01 x the aux loss; returns (loss, {"nll", "aux"}).  A
    negative label is masked; its gather index wraps, as ``jnp``'s."""
    logits, aux = forward(cfg, params, batch, remat=remat)
    labels = batch["labels"].long()
    lf = logits.float()
    logz = torch.logsumexp(lf, dim=-1)
    idx = torch.where(labels < 0, labels + lf.shape[-1], labels)
    ll = torch.gather(lf, -1, idx[..., None])[..., 0]
    mask = (labels >= 0).float()
    nll = ((logz - ll) * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return nll + 0.01 * aux, {"nll": nll, "aux": aux}


@torch.no_grad()
def prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Inference prefill: the full-sequence forward that also emits each
    layer's decode cache; returns (last-position logits [B,V], caches).
    Records no autograd graph, trainable weights or not."""
    x, xv = _embed(cfg, params, batch)
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device).expand(b, s)
    caches = []
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        ckv = _cross_kv(cfg, p["attn"], xv) if kind == "cross" else None
        x, nc, _ = apply_layer(cfg, kind, p, x, pos=pos, cache="collect",
                               cross_kv=ckv)
        caches.append(nc)
    return _logits(cfg, params, x[:, -1:])[:, 0], caches


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, *,
               device="cuda", dtype=torch.bfloat16) -> dict:
    """One layer's empty decode cache, in ``dtype`` where the reference's
    is bfloat16 (float32 states stay float32): keys and values of
    ``max_seq`` positions (``attn``, ``moe``, ``moe_dense``) or MLA's
    latent and rope key of as many, a ``window`` ring with its positions
    (``local``), nothing (``cross``), the RG-LRU state and last 3 conv
    inputs (``recurrent``), the WKV state and the mixes' last inputs
    (``rwkv``)."""
    hd, kv = cfg.hd, cfg.n_kv_heads
    new = lambda shape, dt=dtype: torch.zeros(shape, dtype=dt, device=device)
    if kind in ("attn", "moe", "moe_dense"):
        if cfg.mla is not None:
            m = cfg.mla
            return {"c": new((batch, max_seq, m.kv_lora)),
                    "r": new((batch, max_seq, m.rope_head_dim))}
        return {"k": new((batch, max_seq, kv, hd)),
                "v": new((batch, max_seq, kv, hd))}
    if kind == "local":
        w = cfg.window
        return {"k": new((batch, w, kv, hd)), "v": new((batch, w, kv, hd)),
                "pos": torch.full((batch, w), -10 ** 9, dtype=torch.int32,
                                  device=device)}
    if kind == "cross":
        return {}
    if kind == "recurrent":
        dr = cfg.d_rnn or cfg.d_model
        return {"h": new((batch, dr), torch.float32),
                "conv": new((batch, 3, dr))}
    if kind == "rwkv":
        h = cfg.n_heads
        hd2 = cfg.d_model // h
        return {"s": new((batch, h, hd2, hd2), torch.float32),
                "xa": new((batch, cfg.d_model)),
                "xc": new((batch, cfg.d_model))}
    raise ValueError(kind)


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                device="cuda", dtype=torch.bfloat16) -> List[dict]:
    return [init_cache(cfg, kind, batch, max_seq, device=device, dtype=dtype)
            for kind in layer_kinds(cfg)]


def seq_len(cache: dict) -> Optional[int]:
    """The positions a cache holds along its sequence axis: full
    attention's keys or MLA's latents; None for a ring, a recurrent
    state or a cross layer's empty cache."""
    if "pos" in cache:
        return None
    for key in ("k", "c"):
        if key in cache:
            return cache[key].shape[1]
    return None


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, caches: List[dict], token,
                pos_idx: int, vision=None):
    """One decode step.  token [B], ``pos_idx`` the position (an int on
    the host: the step waits for nothing on the device), ``vision``
    [B,Sv,Df] for a vision model; returns (logits [B,V], caches), the
    caches written in place.  A cross layer recomputes its keys and
    values from ``vision`` every step, as the reference does.  Records no
    autograd graph, trainable weights or not."""
    for c in caches:
        n = seq_len(c)
        if n is not None and not 0 <= pos_idx < n:
            raise ValueError(f"position {pos_idx} is outside the "
                             f"{n}-position cache")
    b = token.shape[0]
    x = params["embed"][token.long()][:, None]
    pos = torch.full((b, 1), int(pos_idx), dtype=torch.long,
                     device=x.device)
    xv = _frontend(params, vision) if cfg.frontend == "vision" else None
    new = []
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], caches):
        if kind == "cross":
            x, _, _ = apply_layer(cfg, kind, p, x, pos=pos,
                                  cross_kv=_cross_kv(cfg, p["attn"], xv))
            nc = c
        else:
            x, nc, _ = apply_layer(cfg, kind, p, x, pos=pos, cache=c)
        new.append(nc)
    return _logits(cfg, params, x)[:, 0], new
