"""Model assembly on PyTorch: parameters, forward, prefill, decode step.

The port of ``repro.models.model`` for the dense-attention family: layers
of the kinds ``attn`` and ``local``, a ``prefix`` then ``n_groups``
repetitions of ``cfg.group``.  The reference stacks each group's
parameters on a leading axis and scans over it; here the layers are one
flat list in the order the scan visits them (:func:`layer_kinds`), and a
group's parameters are its layers' own tensors.  The decode caches follow
the same list.

:class:`LM` holds the parameters on an explicit device, drawn from an
explicit ``torch.Generator`` (weights made on the card stay on the card);
:func:`repro_torch.models.convert.from_reference` fills one from the
reference's parameters instead.  The other layer kinds (``moe``,
``moe_dense``, ``recurrent``, ``rwkv``, ``cross``), an ``mla`` config and a
``frontend`` raise ``NotImplementedError`` naming ROADMAP A14.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch import nn

from ..kernels.ops import _checked_device
from ..pim_ufunc import _not_ported
from . import layers as L
from .config import ModelConfig

set_activation_sharder = L.set_activation_sharder
_shard = L._shard

#: The layer kinds this slice ports.
DENSE_KINDS = ("attn", "local")


def check_ported(cfg: ModelConfig) -> None:
    """Raise ROADMAP A14's ``NotImplementedError`` for what is not
    ported: a layer kind outside :data:`DENSE_KINDS`, MLA, a frontend."""
    if cfg.mla is not None:
        raise _not_ported(f"{cfg.name}: MLA attention", "A14")
    if cfg.frontend != "none":
        raise _not_ported(f"{cfg.name}: the {cfg.frontend} frontend", "A14")
    for kind in dict.fromkeys(cfg.prefix + cfg.group):
        if kind not in DENSE_KINDS:
            raise _not_ported(f"{cfg.name}: the {kind!r} layer", "A14")


def layer_kinds(cfg: ModelConfig) -> List[str]:
    """Every layer's kind, in order: the prefix, then the groups."""
    return list(cfg.prefix) + list(cfg.group) * cfg.n_groups


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_layer(cfg: ModelConfig, kind: str, gen, *, device) -> L.Params:
    if kind not in DENSE_KINDS:
        raise _not_ported(f"the {kind!r} layer", "A14")
    d = cfg.d_model
    zeros = lambda: torch.zeros((d,), dtype=torch.float32, device=device)
    return L.Params({"ln1": zeros(), "ln2": zeros(),
                     "attn": L.init_attention(cfg, gen, device=device),
                     "ffn": L.init_ffn(gen, d, cfg.d_ff, device=device)})


class LM(L.Params):
    """The parameters of one model on ``device`` (``"cuda"`` unless the
    caller asks for another; ``"meta"`` allocates nothing), drawn from
    ``generator``, a ``torch.Generator`` on that device: ``embed`` [V, d]
    and ``norm_f`` [d], ``lm_head`` [d, V] unless tied, and ``layers``, one
    :class:`~repro_torch.models.layers.Params` a layer."""

    def __init__(self, cfg: ModelConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None):
        check_ported(cfg)
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
    """One pre-norm block: attention, then the feed-forward, each added to
    the residual.  Returns (x, new_cache, aux); aux is 0 for dense
    layers."""
    if kind not in DENSE_KINDS:
        raise _not_ported(f"the {kind!r} layer", "A14")
    h = L.rms_norm(x, p["ln1"], cfg.norm_eps)
    h, new_cache = L.apply_attention(cfg, p["attn"], h, pos=pos, kind=kind,
                                     cache=cache, cross_kv=cross_kv)
    x = x + h
    h = L.apply_ffn(p["ffn"], L.rms_norm(x, p["ln2"], cfg.norm_eps))
    return x + h, new_cache, 0.0


def _logits(cfg: ModelConfig, params, x):
    x = L.rms_norm(x, params["norm_f"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return _shard("logits", x @ head)


# --------------------------------------------------------------------------
# forward (prefill)
# --------------------------------------------------------------------------

def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            remat: bool = True):
    """Returns (logits [B,S,V], aux_loss_mean).  ``batch["tokens"]``:
    [B,S].  ``remat`` is accepted and has no effect: nothing is kept for a
    backward pass."""
    check_ported(cfg)
    x = _shard("act", params["embed"][batch["tokens"].long()])
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device).expand(b, s)
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        x, _, _ = apply_layer(cfg, kind, p, x, pos=pos)
    # dense layers have no auxiliary loss
    return _logits(cfg, params, x), torch.zeros((), device=x.device)


def prefill(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor]):
    """Inference prefill: the full-sequence forward that also emits each
    layer's decode cache; returns (last-position logits [B,V], caches)."""
    check_ported(cfg)
    x = _shard("act", params["embed"][batch["tokens"].long()])
    b, s, _ = x.shape
    pos = torch.arange(s, device=x.device).expand(b, s)
    caches = []
    for kind, p in zip(layer_kinds(cfg), params["layers"]):
        x, nc, _ = apply_layer(cfg, kind, p, x, pos=pos, cache="collect")
        caches.append(nc)
    return _logits(cfg, params, x[:, -1:])[:, 0], caches


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, kind: str, batch: int, max_seq: int, *,
               device="cuda", dtype=torch.bfloat16) -> dict:
    """One layer's empty decode cache: keys and values of ``max_seq``
    positions (``attn``) or a ``window`` ring with its positions
    (``local``), in ``dtype`` (the reference's bfloat16)."""
    hd, kv = cfg.hd, cfg.n_kv_heads
    if kind == "attn":
        return {"k": torch.zeros((batch, max_seq, kv, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, max_seq, kv, hd), dtype=dtype,
                                 device=device)}
    if kind == "local":
        w = cfg.window
        return {"k": torch.zeros((batch, w, kv, hd), dtype=dtype,
                                 device=device),
                "v": torch.zeros((batch, w, kv, hd), dtype=dtype,
                                 device=device),
                "pos": torch.full((batch, w), -10 ** 9, dtype=torch.int32,
                                  device=device)}
    raise _not_ported(f"the {kind!r} layer's decode cache", "A14")


def init_caches(cfg: ModelConfig, batch: int, max_seq: int, *,
                device="cuda", dtype=torch.bfloat16) -> List[dict]:
    check_ported(cfg)
    return [init_cache(cfg, kind, batch, max_seq, device=device, dtype=dtype)
            for kind in layer_kinds(cfg)]


def decode_step(cfg: ModelConfig, params, caches: List[dict], token,
                pos_idx: int, vision=None):
    """One decode step.  token [B], ``pos_idx`` the position (an int on
    the host: the step waits for nothing on the device); returns (logits
    [B,V], caches), the caches written in place."""
    check_ported(cfg)
    for kind, c in zip(layer_kinds(cfg), caches):
        n = c["k"].shape[1]
        if kind == "attn" and not 0 <= pos_idx < n:
            raise ValueError(f"position {pos_idx} is outside the "
                             f"{n}-position cache")
    b = token.shape[0]
    x = params["embed"][token.long()][:, None]
    pos = torch.full((b, 1), int(pos_idx), dtype=torch.long,
                     device=x.device)
    new = []
    for kind, p, c in zip(layer_kinds(cfg), params["layers"], caches):
        x, nc, _ = apply_layer(cfg, kind, p, x, pos=pos, cache=c)
        new.append(nc)
    return _logits(cfg, params, x)[:, 0], new
