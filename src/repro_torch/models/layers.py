"""Dense-attention layers of the LM on PyTorch tensors.

The port of the dense subset of ``repro.models.layers``: ``rms_norm``,
``rotary``, grouped-query attention (``attn``, the ``local`` ring buffer
and the ``cross`` branch) with the 512-query chunking, and the gated
feed-forward.  Every function is the reference's jnp expression, op for
op, in the same dtypes: norms and the attention scores and softmax in
float32, projections and the PV product in the weights' dtype.  The
projections are plain ``@``, as they are outside any Pallas kernel in the
reference; the attention is the reference's einsums, not a fused library
attention.

Parameters live in :class:`Params` nodes (``nn.Module``s that index like
the reference's dicts, ``p["wq"]``, ``"bq" in p``); every ``apply_*``
takes either such a node or a plain dict of tensors.  The other families
(MoE, MLA, RG-LRU, RWKV6) are ROADMAP A14.

Unlike the reference, a decode step writes the new key and value into the
cache it is given, in place (``index_copy_`` at the position the device
holds, so no step waits for the host), and returns the same dict: a full
cache is not copied once a layer and a step.
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import numpy as np
import torch
from torch import nn

from .config import ModelConfig

ATTN_CHUNK = 512          # query-chunked attention threshold / block

# activation-sharding hook: (tag, tensor) -> tensor.  The port runs on one
# device, so it stays the identity unless a caller installs one.
_SHARDER = lambda tag, x: x


def set_activation_sharder(fn) -> None:
    global _SHARDER
    _SHARDER = fn


def _shard(tag, x):
    return _SHARDER(tag, x)


class Params(nn.Module):
    """A node of the parameter tree: tensors (frozen ``nn.Parameter``s) and
    child nodes by name, indexed like the reference's dicts."""

    def __init__(self, items: Mapping[str, object]):
        super().__init__()
        for name, value in items.items():
            if isinstance(value, nn.Module):
                self.add_module(name, value)
            else:
                self.register_parameter(
                    name, nn.Parameter(value, requires_grad=False))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


def _dense_init(gen: Optional[torch.Generator], shape, scale=None, *,
                device) -> torch.Tensor:
    """Standard normal times ``scale`` (default ``1/sqrt(fan_in)``) drawn
    in float32 on ``device`` from ``gen``, stored as bfloat16; on the
    ``meta`` device only the shape."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=torch.bfloat16, device="meta")
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(torch.bfloat16)


def rms_norm(x, w, eps=1e-6):
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * (1.0 + w.float())).to(dt)


@functools.lru_cache(maxsize=None)
def _freqs(theta: float, rd: int, device: torch.device) -> torch.Tensor:
    """The reference's float32 inverse frequencies, made once a device."""
    f = 1.0 / (theta ** (np.arange(0, rd, 2, dtype=np.float32) / rd))
    return torch.from_numpy(f.astype(np.float32)).to(device)


def rotary(x, pos, theta, rot_dim=None):
    """x: [..., S, H, hd]; pos: [..., S] integer.  Rotates the two halves
    of the first ``rot_dim`` channels; the angles are float32, so the
    product is float32 before the cast back to ``x.dtype``."""
    hd = x.shape[-1]
    rd = rot_dim or hd
    ang = pos[..., None].float() * _freqs(float(theta), rd, x.device)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    xr, rest = x[..., :rd], x[..., rd:]
    x1, x2 = xr[..., : rd // 2], xr[..., rd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return torch.cat([out.to(x.dtype), rest], -1)


# --------------------------------------------------------------------------
# attention
# --------------------------------------------------------------------------

def init_attention(cfg: ModelConfig, gen, cross: bool = False, *,
                   device) -> Params:
    d, hd = cfg.d_model, cfg.hd
    p = {
        "wq": _dense_init(gen, (d, cfg.n_heads * hd), device=device),
        "wk": _dense_init(gen, (d, cfg.n_kv_heads * hd), device=device),
        "wv": _dense_init(gen, (d, cfg.n_kv_heads * hd), device=device),
        "wo": _dense_init(gen, (cfg.n_heads * hd, d), device=device),
    }
    zeros = functools.partial(torch.zeros, device=device)
    if cfg.qkv_bias:
        p["bq"] = zeros((cfg.n_heads * hd,), dtype=torch.bfloat16)
        p["bk"] = zeros((cfg.n_kv_heads * hd,), dtype=torch.bfloat16)
        p["bv"] = zeros((cfg.n_kv_heads * hd,), dtype=torch.bfloat16)
    if cfg.qk_norm:
        p["qnorm"] = zeros((hd,), dtype=torch.float32)
        p["knorm"] = zeros((hd,), dtype=torch.float32)
    if cross:
        p["gate"] = zeros((), dtype=torch.float32)   # zero-init gate
    return Params(p)


def _group_attn(q, k, v, mask):
    """Grouped-query attention core (no KV-head replication): query head
    ``h`` reads KV head ``h // G``.  q: [B,Sq,H,hd]; k,v: [B,Sk,K,hd];
    mask broadcastable to [B,Sq,Sk]."""
    b, sq, h, hd = q.shape
    kh = k.shape[2]
    g = h // kh
    qg = q.reshape(b, sq, kh, g, hd)
    s = torch.einsum("bqkgd,bskd->bqkgs", qg.float(),
                     k.float()) * (1.0 / np.sqrt(hd))
    s = torch.where(mask[:, :, None, None, :], s, -1e30)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bqkgs,bskd->bqkgd", a.to(v.dtype), v)
    return o.reshape(b, sq, h, v.shape[-1])


def _sdpa(q, k, v, *, causal, window, q_offset=0):
    """Query-chunked attention: above :data:`ATTN_CHUNK` queries, one
    chunk of 512 at a time against all keys (the reference's scan), which
    bounds the [chunk, Sk] score tile."""
    b, sq, h, hd = q.shape
    sk = k.shape[1]
    kpos = torch.arange(sk, device=q.device)

    def attend(qc, qpos):
        m = torch.ones((qc.shape[1], sk), dtype=torch.bool, device=q.device)
        if causal:
            m &= kpos[None, :] <= qpos[:, None]
        if window:
            m &= kpos[None, :] > qpos[:, None] - window
        return _group_attn(qc, k, v, m[None])

    if sq <= ATTN_CHUNK:
        return attend(q, torch.arange(sq, device=q.device) + q_offset)
    if sq % ATTN_CHUNK:
        raise ValueError(f"{sq} queries are not a multiple of the "
                         f"{ATTN_CHUNK}-query chunk")
    qpos = torch.arange(ATTN_CHUNK, device=q.device) + q_offset
    return torch.cat([attend(q[:, i:i + ATTN_CHUNK], qpos + i)
                      for i in range(0, sq, ATTN_CHUNK)], 1)


def _proj(x, p, w: str, bias: str):
    y = x @ p[w]
    return y + p[bias] if bias in p else y


def apply_attention(cfg: ModelConfig, p, x, *, pos, kind: str, cache=None,
                    cross_kv=None):
    """kind: attn | local | cross.  Returns (out, new_cache).  ``cache``:
    None, ``"collect"`` (prefill: emit the decode cache) or a decode cache,
    written in place at ``pos[0]`` (the same position for every row)."""
    b, s, d = x.shape
    hd = cfg.hd
    q = _proj(x, p, "wq", "bq").reshape(b, s, cfg.n_heads, hd)
    if kind == "cross":
        k, v = cross_kv
    else:
        k = _proj(x, p, "wk", "bk").reshape(b, s, cfg.n_kv_heads, hd)
        v = _proj(x, p, "wv", "bv").reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["qnorm"], cfg.norm_eps)
        if kind != "cross":
            k = rms_norm(k, p["knorm"], cfg.norm_eps)
    if kind != "cross":
        q = rotary(q, pos, cfg.rope_theta)
        k = rotary(k, pos, cfg.rope_theta)

    new_cache = None
    if isinstance(cache, dict) and kind != "cross":  # decode: append + read
        ck, cv = cache["k"], cache["v"]
        if kind == "local":
            w = cfg.window
            i = pos[:1, 0] % w                       # ring-buffer slot
            kpos = cache["pos"]
            ck.index_copy_(1, i, k[:, :1].to(ck.dtype))
            cv.index_copy_(1, i, v[:, :1].to(cv.dtype))
            kpos.index_copy_(1, i, pos[:, :1].to(kpos.dtype))
            new_cache = {"k": ck, "v": cv, "pos": kpos}
            valid = (kpos <= pos[:, :1]) & (kpos > pos[:, :1] - w)
        else:
            ck.index_copy_(1, pos[0], k.to(ck.dtype))
            cv.index_copy_(1, pos[0], v.to(cv.dtype))
            new_cache = {"k": ck, "v": cv}
            valid = (torch.arange(ck.shape[1], device=x.device)[None]
                     <= pos[:1, :1]).expand(b, -1)
        out = _group_attn(q, ck, cv, valid[:, None, :])
    else:
        causal = not cfg.encoder_only and kind != "cross"
        out = _sdpa(q, k, v, causal=causal,
                    window=cfg.window if kind == "local" else 0)
        if cache == "collect":                  # prefill: emit decode cache
            if kind == "local":
                w = cfg.window
                n = min(s, w)
                pp = torch.arange(s - n, s, device=x.device)
                slots = pp % w

                def ring(z):
                    r = torch.zeros((b, w) + z.shape[2:], dtype=z.dtype,
                                    device=z.device)
                    r[:, slots] = z[:, -n:]
                    return r

                posbuf = torch.full((w,), -10 ** 9, dtype=torch.int32,
                                    device=x.device)
                posbuf[slots] = pp.to(torch.int32)
                new_cache = {"k": ring(k), "v": ring(v),
                             "pos": posbuf[None].repeat(b, 1)}
            elif kind == "cross":
                new_cache = {}
            else:
                new_cache = {"k": k, "v": v}
        elif isinstance(cache, dict) and kind == "cross":
            new_cache = {}
    out = out.reshape(b, s, cfg.n_heads * hd) @ p["wo"]
    if kind == "cross":
        out = out * torch.tanh(p["gate"]).to(out.dtype)
    return out, new_cache


# --------------------------------------------------------------------------
# feed-forward
# --------------------------------------------------------------------------

def init_ffn(gen, d, ff, *, device) -> Params:
    return Params({"w1": _dense_init(gen, (d, ff), device=device),
                   "w3": _dense_init(gen, (d, ff), device=device),
                   "w2": _dense_init(gen, (ff, d), device=device)})


def apply_ffn(p, x):
    h = x @ p["w1"]
    # jax.nn.silu is x * sigmoid(x), each rounded to x's dtype
    return (h * torch.sigmoid(h) * (x @ p["w3"])) @ p["w2"]
