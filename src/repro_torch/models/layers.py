"""The LM's layers on PyTorch tensors.

The port of ``repro.models.layers``: ``rms_norm``, ``rotary``,
grouped-query attention (``attn``, the ``local`` ring buffer and the
``cross`` branch) with the 512-query chunking, DeepSeek-V2's multi-head
latent attention (MLA), the gated feed-forward, the sort-based capacity
MoE, the Griffin RG-LRU block and RWKV6's time and channel mixes.  Every
function is the reference's jnp expression, op for op, in the same
dtypes: norms, the attention scores and softmax, the router, the
recurrent gates and the WKV scan in float32, projections and the PV
product in the weights' dtype.  The projections are plain ``@``, as they
are outside any Pallas kernel in the reference; the attention is the
reference's einsums, not a fused library attention, except where a
full-attention decode step runs on plain CUDA tensors: that one query
position goes through the port's own kernel
(:func:`repro_torch.kernels.attention.decode_attn`), the same function
read in one pass over the slots up to the position.

Parameters live in :class:`Params` nodes (``nn.Module``s that index like
the reference's dicts, ``p["wq"]``, ``"bq" in p``); every ``apply_*``
takes either such a node or a plain dict of tensors.

Unlike the reference, a decode step writes into the cache it is given, in
place, and returns the same dict: a new key and value (or MLA latent) by
``index_copy_`` at the position the device holds, so no step waits for
the host, and a recurrent state by ``copy_``.  A full cache is not copied
once a layer and a step.

The parameters may be DTensors on a mesh (:mod:`repro_torch.launch.
sharding`): every function then runs as it is, but for the points where
a layout must be fixed or DTensor has no rule.  Weight products take a
fixed tensor-parallel layout (:func:`mm`); the embedding lookup, the
cache writes, the attention core, the WKV scan and the MoE's routing
run on each rank's own block as plain tensors (:func:`lookup`,
:func:`write_at`, :func:`_group_attn_on_mesh`, :func:`_wkv`,
:func:`_moe_on_mesh`); heads split on each rank's block
(:func:`split_dim`).
"""

from __future__ import annotations

import functools
from typing import Mapping, Optional

import contextlib
import math

import numpy as np
import torch
from torch import nn
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset
from torch.distributed.tensor.experimental import local_map

from ..kernels import attention
from ..runtime import telemetry
from .config import ModelConfig

ATTN_CHUNK = 512          # query-chunked attention threshold / block
_DP_AXES = ("pod", "data")  # the mesh axes of batch and FSDP sharding

# activation-sharding hook: (tag, tensor) -> tensor.  The identity unless
# a launcher installs one (launch.sharding.install_activation_sharder).
_SHARDER = lambda tag, x: x


def set_activation_sharder(fn) -> None:
    global _SHARDER
    _SHARDER = fn


def _shard(tag, x):
    return _SHARDER(tag, x)


def whole(x, dim: Optional[int] = None):
    """``x`` with its pending sums taken and, given ``dim``, that
    dimension whole on every rank: a DTensor's ``Partial`` placements
    (and shards of ``dim``) become ``Replicate``; a plain tensor as it is.
    Where DTensor cannot go on: an argmax over a sharded axis (its global
    index needs the shard offsets, which a trace cannot read), a split of
    a sharded axis into parts the shards do not divide; and where a sum
    or max over ranks must be taken."""
    if not isinstance(x, DTensor):
        return x
    if dim is not None:
        dim %= x.ndim
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() or (dim is not None and
                                          p.is_shard(dim)) else p
        for p in x.placements])


def split_dim(x, dim: int, sizes):
    """``x.unflatten(dim, sizes)``: heads out of a projection.  A DTensor
    split on ``dim`` over ranks that divide ``sizes[0]`` is split on each
    rank's own block, its shards going to the first new dimension
    (PyTorch 2.11's DTensor refuses to split a split dimension); over
    ranks that do not (8 KV heads 16 ways) the dimension is made whole
    first (:func:`whole`)."""
    if not isinstance(x, DTensor):
        return x.unflatten(dim, sizes)
    dim %= x.ndim
    n = 1
    for i, p in enumerate(x.placements):
        if p.is_shard(dim):
            n *= x.device_mesh.size(i)
    if n == 1 or sizes[0] % n:
        return whole(x, dim).unflatten(dim, sizes)
    shape = x.shape[:dim] + torch.Size(sizes) + x.shape[dim + 1:]
    local = x.to_local().unflatten(dim, (sizes[0] // n,) + tuple(sizes[1:]))
    return DTensor.from_local(local, x.device_mesh, x.placements,
                              run_check=False, shape=shape,
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def gathered(w):
    """A weight gathered over the data axes (FSDP's all-gather at use),
    its shards on 'model' kept; a plain ``w`` as it is."""
    if not isinstance(w, DTensor):
        return w
    mesh = w.device_mesh
    return w.redistribute(mesh, [
        Replicate() if n in _DP_AXES else p
        for n, p in zip(mesh.mesh_dim_names, w.placements)])


def mm(x, w):
    """``x @ w`` for a weight ``w``.  DTensors are put in the fixed
    tensor-parallel layout first, so that no product has to pick one:
    ``w`` gathered over the data axes (FSDP's all-gather at use), its
    shards on 'model' kept; ``x`` split on dimension 0 (the batch) over
    the data axes (as it is, or over all of them where none splits it yet
    and they divide it), on its last dimension over each mesh dimension
    that splits ``w``'s first (a row-parallel product, its result a
    pending sum), whole over the others (column-parallel)."""
    if not isinstance(w, DTensor):
        return x @ w
    mesh = w.device_mesh
    dp = [i for i, n in enumerate(mesh.mesh_dim_names) if n in _DP_AXES]
    w = gathered(w)
    wp = w.placements
    if isinstance(x, DTensor):
        batch = [i for i in dp if x.placements[i].is_shard(0)]
        if not batch and x.shape[0] % math.prod(
                mesh.size(i) for i in dp) == 0:
            batch = [i for i in dp if mesh.size(i) > 1]
        x = x.redistribute(mesh, [
            Shard(x.ndim - 1) if wp[i].is_shard(0) else
            Shard(0) if i in batch else Replicate()
            for i in range(mesh.ndim)])
    return x @ w


def pinned(x):
    """``x`` as it is, its gradient brought to ``x``'s layout: after a
    reshape that merged heads which could not be split (their merged axis
    whole on every rank), so the backward's split of the gradient meets
    the same whole axis however the product that reads ``x`` lays its
    gradient out.  A plain ``x`` as it is."""
    if not isinstance(x, DTensor):
        return x
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


def lookup(table, ids):
    """``table[ids]``: rows of an embedding table.  Of a DTensor table,
    each rank looks up its own: the table gathered over the data axes,
    as :func:`mm` gathers a weight, its shards on 'model' kept (of the
    vocabulary, or of d_model); the ids of its own rows; a row outside
    its vocabulary shard reads as zero, and the ranks' rows add up (a
    pending sum over the vocabulary axes).  DTensor's own lookup needs
    sharding rules that PyTorch 2.11 lacks (ids split over two mesh
    dimensions; the backward into a table split on d_model)."""
    if not isinstance(table, DTensor):
        return table[ids]
    mesh = table.device_mesh
    names = mesh.mesh_dim_names
    tp = [Replicate() if n in _DP_AXES else p
          for n, p in zip(names, table.placements)]
    ids = ids if isinstance(ids, DTensor) else DTensor.from_local(
        ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ip = [p if p.is_shard(0) and n in _DP_AXES else Replicate()
          for n, p in zip(names, ids.placements)]
    vocab = [i for i, p in enumerate(tp) if p.is_shard(0)]
    # this rank's table block gets the gradient of this rank's ids alone
    grads = [p if p.is_shard() else
             Partial() if ip[i].is_shard(0) else Replicate()
             for i, p in enumerate(tp)]
    local = table.redistribute(mesh, tp).to_local(grad_placements=grads)
    mine = ids.redistribute(mesh, ip).to_local()
    if vocab:
        _, offset = compute_local_shape_and_global_offset(
            table.shape, mesh, tp)
        j = mine - offset[0]
        here = (j >= 0) & (j < local.shape[0])
        rows = local[torch.where(here, j, 0)] * here[..., None]
    else:
        rows = local[mine]
    out = [Partial() if i in vocab else
           Shard(ids.ndim) if tp[i].is_shard(1) else ip[i]
           for i in range(mesh.ndim)]
    shape = tuple(ids.shape) + tuple(table.shape[1:])
    return DTensor.from_local(rows, mesh, out, run_check=False,
                              shape=torch.Size(shape),
                              stride=torch.empty(shape,
                                                 device="meta").stride())


def write_at(cache, index, values):
    """``cache.index_copy_(1, index, values)``: a decode step's write at
    its position.  Of a DTensor cache, each rank writes its own blocks
    (PyTorch 2.11's DTensor has no rule for ``index_copy_``)."""
    if not isinstance(cache, DTensor):
        return cache.index_copy_(1, index, values)
    mesh, pl = cache.device_mesh, cache.placements
    if not isinstance(values, DTensor):
        values = DTensor.from_local(values, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    if isinstance(index, DTensor):
        index = index.full_tensor()
    local = cache.to_local()
    vals = values.redistribute(mesh, [
        Replicate() if p.is_shard(1) else p for p in pl]).to_local()
    if any(p.is_shard(1) for p in pl):
        # the position axis split (a ring's positions): the rank that
        # holds the position writes it, the others write back what they
        # hold, so nothing waits for the host to say which
        _, offset = compute_local_shape_and_global_offset(cache.shape, mesh,
                                                          pl)
        j = index - offset[1]
        here = ((j >= 0) & (j < local.shape[1])).reshape(
            (1, -1) + (1,) * (local.ndim - 2))
        index = j.clamp(0, local.shape[1] - 1)
        vals = torch.where(here, vals, local.index_select(1, index))
    local.index_copy_(1, index, vals)
    return cache


def _attn_layout(x, kv_heads: int):
    """A DTensor ``[B, S, heads, ...]`` in the attention core's layout:
    the batch's shards kept, the heads sharded only over mesh dimensions
    that divide the ``kv_heads`` key/value heads (so a query head's shard
    holds its key/value head), every other dimension whole.  DTensor
    cannot split 8 KV heads 16 ways, nor regroup a sharded head axis into
    (KV head, group) without a strided shard that the output projection
    cannot take.  A plain ``x`` as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    out, n = [], 1
    for i, p in enumerate(x.placements):
        if p.is_shard(0):
            out.append(p)
        elif p.is_shard(2) and kv_heads % (n * mesh.size(i)) == 0:
            n *= mesh.size(i)
            out.append(p)
        else:
            out.append(Replicate())
    return x.redistribute(mesh, out)


@contextlib.contextmanager
def _replicating():
    # torch.distributed.tensor.experimental.implicit_replication, but
    # nestable: that one clears the flag on leaving, an outer scope's too.
    # The flag is thread-local state the autograd engine hands on to its
    # workers, so a backward pass started in the scope runs in it.
    prev = torch._C._get_dtensor_allow_implicit_replication()
    torch._C._set_dtensor_allow_implicit_replication(True)
    try:
        yield
    finally:
        torch._C._set_dtensor_allow_implicit_replication(prev)


def mesh_scope(t):
    """The context a model function (or its backward pass) runs in when
    its parameters are DTensors (``t`` one of them): the tensors it makes
    itself (positions, masks, zeros) are full-size values the same on
    every rank, so they take part as replicated DTensors.  A plain ``t``:
    no context."""
    return _replicating() if isinstance(t, DTensor) \
        else contextlib.nullcontext()


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
                device, dtype=torch.bfloat16) -> torch.Tensor:
    """Standard normal times ``scale`` (default ``1/sqrt(fan_in)``) drawn
    in float32 on ``device`` from ``gen``, stored as ``dtype``; on the
    ``meta`` device only the shape."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, dtype=dtype, device="meta")
    scale = scale if scale is not None else 1.0 / np.sqrt(shape[0])
    return (torch.randn(shape, generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def _full(shape, value, *, device) -> torch.Tensor:
    return torch.full(shape, value, dtype=torch.float32, device=device)


def silu(x):
    """``jax.nn.silu``: ``x * sigmoid(x)``, each rounded to x's dtype."""
    return x * torch.sigmoid(x)


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
    mask broadcastable to [B,Sq,Sk].  Of DTensors, each rank attends with
    its own rows and heads (:func:`_attn_layout`) on plain tensors: no
    step of the core needs a sharding rule."""
    if isinstance(q, DTensor):
        return _group_attn_on_mesh(q, k, v, mask)
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


def _group_attn_on_mesh(q, k, v, mask):
    kh = k.shape[2]
    q = _attn_layout(q, kh)
    mesh, pl = q.device_mesh, q.placements
    if not isinstance(mask, DTensor):
        mask = DTensor.from_local(mask, mesh, [Replicate()] * mesh.ndim,
                                  run_check=False)
    rows = [p if p.is_shard(0) and mask.shape[0] == q.shape[0]
            else Replicate() for p in pl]
    return local_map(_group_attn, out_placements=list(pl),
                     in_placements=(pl, pl, pl, rows),
                     redistribute_inputs=True)(q, k, v, mask)


def _decode_kernel_takes(q, ck, cv) -> bool:
    """Whether a full-attention decode step runs the card's kernel
    (:func:`repro_torch.kernels.attention.decode_attn`): one query
    position, and plain (not DTensor) CUDA tensors.  Else
    :func:`_group_attn` under the mask of the slots up to the position."""
    return q.shape[1] == 1 and all(
        not isinstance(t, DTensor) and t.is_cuda for t in (q, ck, cv))


def _pad_front(x, n: int, value: float = 0.0):
    """``x`` with ``n`` positions of ``value`` in front of axis 1
    (``pad(x, (0, 0, n, 0))``); a DTensor's by a concatenation, which
    PyTorch 2.11's DTensor has a rule for and ``pad`` not."""
    if not isinstance(x, DTensor):
        return torch.nn.functional.pad(x, (0, 0, n, 0), value=value)
    front = torch.full((x.shape[0], n) + tuple(x.shape[2:]), value,
                       dtype=x.dtype, device=x.device)
    return torch.cat([front, x], 1)


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
    y = mm(x, p[w])
    return y + p[bias] if bias in p else y


def apply_attention(cfg: ModelConfig, p, x, *, pos, kind: str, cache=None,
                    cross_kv=None):
    """kind: attn | local | cross.  Returns (out, new_cache).  ``cache``:
    None, ``"collect"`` (prefill: emit the decode cache) or a decode cache,
    written in place at ``pos[0]`` (the same position for every row)."""
    b, s, d = x.shape
    hd = cfg.hd
    heads = lambda y, n: split_dim(y, 2, (n, hd))
    q = heads(_proj(x, p, "wq", "bq"), cfg.n_heads)
    if kind == "cross":
        k, v = cross_kv
    else:
        k = heads(_proj(x, p, "wk", "bk"), cfg.n_kv_heads)
        v = heads(_proj(x, p, "wv", "bv"), cfg.n_kv_heads)
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
            write_at(ck, i, k[:, :1].to(ck.dtype))
            write_at(cv, i, v[:, :1].to(cv.dtype))
            write_at(kpos, i, pos[:, :1].to(kpos.dtype))
            new_cache = {"k": ck, "v": cv, "pos": kpos}
            valid = (kpos <= pos[:, :1]) & (kpos > pos[:, :1] - w)
        else:
            write_at(ck, pos[0], k.to(ck.dtype))
            write_at(cv, pos[0], v.to(cv.dtype))
            new_cache = {"k": ck, "v": cv}
            valid = None
            if not _decode_kernel_takes(q, ck, cv):
                valid = (torch.arange(ck.shape[1], device=x.device)[None]
                         <= pos[:1, :1]).expand(b, -1)
        if valid is None:
            out = attention.decode_attn(q, ck, cv, pos)
            telemetry.REGISTRY.inc("lm.decode_attn.kernel")
        else:
            telemetry.REGISTRY.inc("lm.decode_attn.plain")
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
    out = mm(out.reshape(b, s, cfg.n_heads * hd), p["wo"])
    if kind == "cross":
        out = out * torch.tanh(p["gate"]).to(out.dtype)
    return out, new_cache


# --------------------------------------------------------------------------
# MLA (DeepSeek-V2 multi-head latent attention)
# --------------------------------------------------------------------------

def init_mla(cfg: ModelConfig, gen, *, device) -> Params:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    qdim = h * (m.nope_head_dim + m.rope_head_dim)
    dense = functools.partial(_dense_init, gen, device=device)
    zeros = functools.partial(torch.zeros, dtype=torch.float32,
                              device=device)
    return Params({
        "wq_a": dense((d, m.q_lora)),
        "q_norm": zeros((m.q_lora,)),
        "wq_b": dense((m.q_lora, qdim)),
        "wkv_a": dense((d, m.kv_lora + m.rope_head_dim)),
        "kv_norm": zeros((m.kv_lora,)),
        "wkv_b": dense((m.kv_lora, h * (m.nope_head_dim + m.v_head_dim))),
        "wo": dense((h * m.v_head_dim, d)),
    })


def apply_mla(cfg: ModelConfig, p, x, *, pos, cache=None):
    """Prefill (``cache`` None or ``"collect"``): the non-absorbed path,
    keys of head dim ``nope + rope`` and values of ``v_head_dim`` through
    :func:`_sdpa`.  Decode (``cache`` the latent ``{"c", "r"}``, written
    in place at ``pos[0]``): the absorbed path in float32, scored in the
    latent space."""
    m = cfg.mla
    b, s, _ = x.shape
    h = cfg.n_heads
    nhd, rhd, vhd = m.nope_head_dim, m.rope_head_dim, m.v_head_dim

    q = mm(rms_norm(mm(x, p["wq_a"]), p["q_norm"], cfg.norm_eps),
           p["wq_b"])
    q = split_dim(q, 2, (h, nhd + rhd))
    q_nope, q_rope = q[..., :nhd], q[..., nhd:]
    q_rope = rotary(q_rope, pos, cfg.rope_theta)

    kv = mm(x, p["wkv_a"])
    c_kv = rms_norm(kv[..., : m.kv_lora], p["kv_norm"], cfg.norm_eps)
    k_rope = rotary(kv[..., m.kv_lora:][:, :, None, :], pos, cfg.rope_theta)

    wkv_b = split_dim(gathered(p["wkv_b"]), 1, (h, nhd + vhd))
    scale = 1.0 / np.sqrt(nhd + rhd)

    if isinstance(cache, dict):
        cc, cr = cache["c"], cache["r"]
        write_at(cc, pos[0], c_kv.to(cc.dtype))
        write_at(cr, pos[0], k_rope[:, :, 0].to(cr.dtype))
        new_cache = {"c": cc, "r": cr}
        # absorbed decode: score via the latent space (the MLA cache win)
        q_abs = torch.einsum("bqhn,lhn->bqhl", q_nope.float(),
                             wkv_b[..., :nhd].float())
        ccf = cc.float()
        sc = torch.einsum("bqhl,bkl->bhqk", q_abs, ccf)
        sc = sc + torch.einsum("bqhr,bkr->bhqk", q_rope.float(), cr.float())
        sc = sc * scale
        valid = torch.arange(cc.shape[1], device=x.device)[None] <= \
            pos[:1, :1]
        sc = torch.where(valid[:, None, None, :], sc, -1e30)
        a = torch.softmax(sc, dim=-1)
        o_lat = torch.einsum("bhqk,bkl->bqhl", a, ccf)
        out = torch.einsum("bqhl,lhv->bqhv", o_lat, wkv_b[..., nhd:].float())
        out = out.to(x.dtype)
    else:
        new_cache = {"c": c_kv, "r": k_rope[:, :, 0]} \
            if cache == "collect" else None
        kvu = torch.einsum("bkl,lhx->bkhx", c_kv, wkv_b)
        k_nope, v = kvu[..., :nhd], kvu[..., nhd:]
        k = torch.cat([k_nope, k_rope.expand(b, s, h, rhd)], -1)
        qf = torch.cat([q_nope, q_rope], -1)
        out = _sdpa(qf, k, v, causal=True, window=0)
    out = mm(out.reshape(b, s, h * vhd), p["wo"])
    return out, new_cache


# --------------------------------------------------------------------------
# feed-forward / MoE
# --------------------------------------------------------------------------

def init_ffn(gen, d, ff, *, device) -> Params:
    return Params({"w1": _dense_init(gen, (d, ff), device=device),
                   "w3": _dense_init(gen, (d, ff), device=device),
                   "w2": _dense_init(gen, (ff, d), device=device)})


def apply_ffn(p, x):
    return mm(silu(mm(x, p["w1"])) * mm(x, p["w3"]), p["w2"])


def init_moe(cfg: ModelConfig, gen, *, device) -> Params:
    m = cfg.moe
    d = cfg.d_model
    dense = functools.partial(_dense_init, gen, device=device)
    p = {
        # float32 values of bfloat16-rounded draws, as the reference's
        "router": dense((d, m.n_experts)).float(),
        "w1": dense((m.n_experts, d, m.d_expert)),
        "w3": dense((m.n_experts, d, m.d_expert)),
        "w2": dense((m.n_experts, m.d_expert, d)),
    }
    if m.n_shared:
        p["shared"] = init_ffn(gen, d, m.n_shared * m.d_expert, device=device)
    return Params(p)


# dispatch groups: the launcher sets them to the DP shard count
# (launch.sharding.install_activation_sharder); 1 with no mesh
_MOE_GROUPS = 1


def set_moe_groups(n: int) -> None:
    global _MOE_GROUPS
    _MOE_GROUPS = max(1, int(n))


def apply_moe(cfg: ModelConfig, p, x):
    """The reference's grouped sort-based capacity MoE (drop on overflow):
    top-k of the float32 router's softmax, renormalised; each group's
    (token, expert) pairs in expert order (a stable sort), the first
    ``cap`` of an expert kept.  Returns (y, aux_loss).

    Two of the reference's scatters are rewritten to give its CPU result
    deterministically on any device (``index_put_`` with repeated indices
    is undefined in PyTorch):

    * dispatch: the reference clamps a dropped pair to slot ``cap - 1``
      and writes a zero there, after the pair kept in that slot (its
      scatter runs in sort order, the last write wins).  So an expert
      chosen by more than ``cap`` tokens gets a zero in its last slot
      (ROADMAP C9).  Here the kept pair of that slot is masked, each
      dropped pair goes to a spare row of its own, and no index repeats.
    * combine: the reference adds each pair's bfloat16 output into its
      token in sort order, that is, a token's ``k`` contributions in
      ascending expert order, each partial sum rounded to the dtype.
      Here the ``k`` are summed in that order, one add at a time.

    With DTensors (:func:`_moe_on_mesh`) the routing runs on each rank's
    own groups, and only the expert products are distributed.
    """
    if isinstance(x, DTensor):
        return _moe_on_mesh(cfg, p, x)
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    g = _MOE_GROUPS if t % _MOE_GROUPS == 0 else 1
    cap = int(np.ceil(t // g * m.top_k / m.n_experts * m.capacity_factor))
    buf, route, counts, probs = _dispatch(m, x.reshape(g, t // g, d),
                                          p["router"], cap)
    y = _combine(_experts(p, buf), route, x.dtype).reshape(b, s, d)
    aux = _balance_loss(m, counts, probs, t)
    if m.n_shared:
        y = y + apply_ffn(p["shared"], x)
    return y, aux


def _dispatch(m, xf, router, cap: int):
    """Route groups ``xf`` [G, Tg, d] (plain tensors): returns (the
    dispatched rows [G, E, cap, d], what the combine needs, the pairs an
    expert took [G, E], the router's probabilities [G, Tg, E])."""
    g, tg, d = xf.shape
    k, n_exp = m.top_k, m.n_experts
    dev = xf.device
    logits = mm(xf.float(), router)                          # [G,Tg,E]
    probs = torch.softmax(logits, dim=-1)
    w, idx = torch.topk(probs, k, dim=-1)                    # [G,Tg,k]
    w = w / (w.sum(-1, keepdim=True) + 1e-9)

    n = tg * k
    e_flat = idx.reshape(g, n)
    perm = torch.argsort(e_flat, dim=-1, stable=True)
    se = torch.gather(e_flat, 1, perm)
    counts = torch.zeros((g, n_exp), dtype=torch.long, device=dev
                         ).scatter_add_(1, e_flat, torch.ones_like(e_flat))
    starts = torch.cumsum(counts, 1) - counts
    pos_sorted = torch.arange(n, device=dev) - torch.gather(starts, 1, se)
    # back to the (token, choice) order
    pos = torch.empty_like(pos_sorted).scatter_(1, perm, pos_sorted)
    keep = pos < cap
    over = torch.gather(counts, 1, e_flat) > cap
    filled = keep & ~(over & (pos == cap - 1))               # C9
    gi = torch.arange(g, device=dev)[:, None]
    spare = g * n_exp * cap + gi * n + torch.arange(n, device=dev)
    rows = torch.where(keep, (gi * n_exp + e_flat) * cap + pos, spare)
    src = xf.repeat_interleave(k, dim=1)                     # [G,n,d]
    vals = torch.where(filled[..., None], src, torch.zeros(
        (), dtype=xf.dtype, device=dev))
    buf = torch.zeros((g * n_exp * cap + g * n, d), dtype=xf.dtype,
                      device=dev).index_copy_(0, rows.reshape(-1),
                                              vals.reshape(-1, d))
    buf = buf[: g * n_exp * cap].reshape(g, n_exp, cap, d)
    return buf, (w, idx, keep, pos, cap), counts, probs


def _experts(p, buf):
    """Every expert's gated FFN over its rows [G, E, cap, d]."""
    buf = _shard("moe_buf", buf)
    w1 = _shard("moe_w", p["w1"])
    w3 = _shard("moe_w", p["w3"])
    w2 = _shard("moe_w", p["w2"])
    hid = silu(torch.einsum("gecd,edf->gecf", buf, w1)) * \
        torch.einsum("gecd,edf->gecf", buf, w3)
    return _shard("moe_eo", torch.einsum("gecf,efd->gecd", hid, w2))


def _combine(eo, route, dtype):
    """The tokens' outputs [G, Tg, d] from the experts' [G, E, cap, d], in
    the dtype: each pair's output times its weight (0 when dropped; a
    dropped pair reads slot cap - 1), summed per token in ascending
    expert order."""
    w, idx, keep, pos, cap = route
    g, tg, k = idx.shape
    d = eo.shape[-1]
    gi = torch.arange(g, device=eo.device)[:, None]
    w16 = torch.where(keep, w.reshape(g, tg * k), 0.0).to(dtype)
    slot = torch.clamp(pos, max=cap - 1)
    out = eo[gi, idx.reshape(g, tg * k), slot] * w16[..., None]  # [G,n,d]
    order = torch.argsort(idx, dim=-1)                       # [G,Tg,k]
    out = torch.gather(out.reshape(g, tg, k, d), 2,
                       order[..., None].expand(g, tg, k, d))
    y = torch.zeros((g, tg, d), dtype=dtype, device=eo.device)
    for j in range(k):
        y = y + out[:, :, j]
    return y


def _balance_loss(m, counts, probs, t: int):
    """The load-balance aux loss (Switch-style), over every group."""
    frac = counts.sum(0).float() / (t * m.top_k)
    imp = probs.mean((0, 1))
    return (frac * imp).sum() * m.n_experts


def _moe_on_mesh(cfg: ModelConfig, p, x):
    """:func:`apply_moe` of a DTensor ``x`` [B, S, d]: the dispatch
    groups are the data axes' shards of the batch (the reference's
    launcher sets as many groups as it has), so each rank routes its own
    groups on plain tensors with the whole router (DTensor has no
    sharding rule for the routing's sort, scatter and cumsum), the
    expert products run on DTensors through the sharding points, and
    each rank combines its own tokens.  Where the groups are not the
    batch's shards, every rank routes all of them."""
    m = cfg.moe
    mesh = x.device_mesh
    b, s, d = x.shape
    t = b * s
    g = _MOE_GROUPS if t % _MOE_GROUPS == 0 else 1
    cap = int(np.ceil(t // g * m.top_k / m.n_experts * m.capacity_factor))
    dp = [i for i, n in enumerate(mesh.mesh_dim_names)
          if n in _DP_AXES and mesh.size(i) > 1]
    n_dp = math.prod(mesh.size(i) for i in dp)
    split = dp if b % n_dp == 0 and g % n_dp == 0 else []
    rows = [Shard(0) if i in split else Replicate()
            for i in range(mesh.ndim)]
    # each rank's rows are its own: its router gradient is a partial sum
    # over the split axes, the same on the others
    mine = [Partial() if i in split else Replicate()
            for i in range(mesh.ndim)]
    xl = x.redistribute(mesh, rows).to_local()
    router = p["router"].redistribute(mesh, [Replicate()] * mesh.ndim
                                      ).to_local(grad_placements=mine)
    g_l = g // (n_dp if split else 1)
    buf, route, counts, probs = _dispatch(
        m, xl.reshape(g_l, -1, d), router, cap)
    on = lambda z: DTensor.from_local(z, mesh, rows, run_check=False)
    eo = _experts(p, on(buf)).redistribute(mesh, rows).to_local()
    y = on(_combine(eo, route, x.dtype).reshape(xl.shape))
    aux = _balance_loss(m, on(counts), on(probs), t)
    if m.n_shared:
        y = y + apply_ffn(p["shared"], x)
    return y, aux


# --------------------------------------------------------------------------
# RG-LRU recurrent block (RecurrentGemma / Griffin)
# --------------------------------------------------------------------------

def init_rglru(cfg: ModelConfig, gen, *, device) -> Params:
    d = cfg.d_model
    dr = cfg.d_rnn or d
    dense = functools.partial(_dense_init, gen, device=device)
    return Params({
        "w_x": dense((d, dr)),
        "w_gate": dense((d, dr)),
        "conv": dense((4, dr), 0.1),
        "w_in_gate": dense((dr, dr), 0.01),
        "w_rec_gate": dense((dr, dr), 0.01),
        "lam": _full((dr,), 3.0, device=device),   # a = sigmoid(lam)^(8 r)
        "w_out": dense((dr, d)),
    })


def _linear_scan(a, b):
    """h_t = a_t h_{t-1} + b_t from h_{-1} = 0 along axis 1: the
    reference's ``associative_scan`` of the same combine, in log2(S)
    doubling steps (Hillis-Steele), in float32."""
    s = a.shape[1]
    step = 1
    while step < s:
        a_prev = _pad_front(a[:, :-step], step, 1.0)
        b_prev = _pad_front(b[:, :-step], step)
        b = a * b_prev + b
        a = a * a_prev
        step *= 2
    return b


def apply_rglru(cfg: ModelConfig, p, x, *, cache=None):
    """Griffin recurrent block: conv1d(4) + RG-LRU, gated.  ``cache``:
    None, ``"collect"`` or the decode state ``{"h", "conv"}`` (the last
    state and the last 3 conv inputs), written in place."""
    b, s, _ = x.shape
    u = mm(x, p["w_x"])                                # [B,S,dr]
    # jax.nn.gelu's default is the tanh approximation
    gate = torch.nn.functional.gelu(mm(x, p["w_gate"]).float(),
                                    approximate="tanh")
    # causal depthwise conv width 4
    if isinstance(cache, dict):
        hist = torch.cat([cache["conv"], u], dim=1)   # [B,3+S,dr]
    else:
        hist = _pad_front(u, 3)
    new_conv = hist[:, -3:]
    u = sum(hist[:, i: i + s] * p["conv"][i] for i in range(4))

    uf = u.float()
    r = torch.sigmoid(mm(uf, p["w_rec_gate"].float()))
    i = torch.sigmoid(mm(uf, p["w_in_gate"].float()))
    lam = p["lam"]
    softplus = torch.logaddexp(-lam, torch.zeros_like(lam))   # jax's
    log_a = -8.0 * r * softplus                        # log sigmoid(lam)^(8r)
    a = torch.exp(log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-9)) * (i * uf)

    if isinstance(cache, dict):                        # single-step decode
        h = a[:, 0] * cache["h"] + gated[:, 0]
        hs = h[:, None]
        cache["h"].copy_(h)
        cache["conv"].copy_(new_conv)
        new_cache = cache
    else:
        hs = _linear_scan(a, gated)
        new_cache = {"h": hs[:, -1], "conv": new_conv} \
            if cache == "collect" else None
    out = mm((hs * gate).to(x.dtype), p["w_out"])
    return out, new_cache


# --------------------------------------------------------------------------
# RWKV6 (Finch): time mix with data-dependent decay + channel mix
# --------------------------------------------------------------------------

WKV_CHUNK = 64


def init_rwkv(cfg: ModelConfig, gen, *, device) -> Params:
    d = cfg.d_model
    lora = 64
    dense = functools.partial(_dense_init, gen, device=device)
    return Params({
        "mu": _full((5, d), 0.5, device=device),       # r,k,v,w,g mixes
        "wr": dense((d, d)),
        "wk": dense((d, d)),
        "wv": dense((d, d)),
        "wg": dense((d, d)),
        "w0": _full((d,), -5.0, device=device),
        # float32 values of bfloat16-rounded draws, as the reference's
        "wA": dense((d, lora), 0.01).float(),
        "wB": dense((lora, d), 0.01).float(),
        "u": dense((d,), 0.1, dtype=torch.float32),
        "wo": dense((d, d)),
        "mu_c": _full((2, d), 0.5, device=device),     # channel-mix mixes
        "ck": dense((d, cfg.d_ff)),
        "cv": dense((cfg.d_ff, d)),
        "cr": dense((d, d)),
    })


def _wkv_chunked(r, k, v, w, u, s0):
    """Chunked WKV6 scan.  r,k,v: [B,H,T,hd]; w (decay in (0,1)): same;
    u: [H,hd]; s0: [B,H,hd,hd] initial state.  Returns (y, sT).  ``T``
    splits into chunks of ``min(WKV_CHUNK, T)``, so it must be at most
    :data:`WKV_CHUNK` or a multiple of it."""
    b, h, t, hd = r.shape
    c = min(WKV_CHUNK, t)
    if t % c:
        raise ValueError(f"{t} positions are not a multiple of the "
                         f"{WKV_CHUNK}-position WKV chunk")
    nc = t // c
    rs, ks_, vs, ws = (z.reshape(b, h, nc, c, hd) for z in (r, k, v, w))
    lw = torch.log(ws)                                 # [B,H,nc,C,hd] (<0)
    L = torch.cumsum(lw, dim=3)                        # inclusive
    am = torch.tril(torch.ones((c, c), device=r.device), -1
                    )[None, None, :, :, None]
    s = s0
    ys = []
    for j in range(nc):
        rc, kc, vc = rs[:, :, j], ks_[:, :, j], vs[:, :, j]   # [B,H,C,hd]
        lwc, Lc = lw[:, :, j], L[:, :, j]
        # cross-chunk: y_t += (r_t * P_{t-1}) @ s, P_{t-1} = exp(L_{t-1})
        pprev = torch.exp(Lc - lwc)
        y = torch.einsum("bhcd,bhde->bhce", rc * pprev, s)
        # intra-chunk: A[t,tau] = sum_d r_t[d] k_tau[d] exp(L_{t-1}-L_tau)
        ratio = torch.exp((Lc - lwc)[:, :, :, None, :] - Lc[:, :, None, :, :])
        A = ((rc[:, :, :, None, :] * kc[:, :, None, :, :]) * ratio * am
             ).sum(-1)
        y = y + torch.einsum("bhct,bhte->bhce", A, vc)
        # current-token bonus: y_t += (r_t . u . k_t) v_t
        y = y + (rc * u[None, :, None, :] * kc).sum(-1, keepdim=True) * vc
        # state update: s' = diag(exp(L_C)) s + sum_tau exp(L_C - L_tau) k v^T
        decay_all = torch.exp(Lc[:, :, -1, :])          # [B,H,hd]
        kw = kc * torch.exp(Lc[:, :, -1:, :] - Lc)
        s = decay_all[:, :, :, None] * s + \
            torch.einsum("bhcd,bhce->bhde", kw, vc)
        ys.append(y)
    return torch.stack(ys, 2).reshape(b, h, t, hd), s


def _wkv_step(r, k, v, w, u, s0):
    """One position of WKV6 from the state ``s0``: (y, the new state)."""
    y = ((r * u[None, :, None]) * k).sum(-1, keepdim=True) * v + \
        torch.einsum("bhcd,bhde->bhce", r, s0)
    sT = w[:, :, 0, :, None] * s0 + \
        torch.einsum("bhd,bhe->bhde", k[:, :, 0], v[:, :, 0])
    return y, sT


def _wkv(r, k, v, w, u, s0, *, step: bool):
    """:func:`_wkv_step` or :func:`_wkv_chunked`.  Of DTensors, each rank
    runs its own rows and heads on plain tensors (the scan is independent
    a row and a head; its cumulative sums and einsums have no sharding
    rule in PyTorch 2.11's DTensor)."""
    core = _wkv_step if step else _wkv_chunked
    if not isinstance(r, DTensor):
        return core(r, k, v, w, u, s0)
    mesh = r.device_mesh
    pl = [p if p.is_shard(0) or p.is_shard(1) else Replicate()
          for p in r.placements]
    heads = [Shard(0) if p.is_shard(1) else Replicate() for p in pl]
    if not isinstance(s0, DTensor):
        s0 = DTensor.from_local(s0, mesh, [Replicate()] * mesh.ndim,
                                run_check=False)
    return local_map(core, out_placements=(pl, pl),
                     in_placements=(pl, pl, pl, pl, heads, pl),
                     redistribute_inputs=True)(r, k, v, w, u, s0)


def _shifted(x, cache, key):
    """x one position later: the cache's last input (decode) or zeros in
    front."""
    if isinstance(cache, dict):
        return torch.cat([cache[key][:, None], x[:, :-1]], 1)
    return _pad_front(x, 1)[:, :-1]


def apply_rwkv_timemix(cfg: ModelConfig, p, x, *, cache=None):
    """RWKV6 time mix.  ``cache``: None, ``"collect"`` or the decode state
    (``"s"`` the WKV state, ``"xa"`` the last input), written in place;
    one position with a state takes the reference's decode fast path."""
    b, s, d = x.shape
    h = cfg.n_heads
    hd = d // h
    xprev = _shifted(x, cache, "xa")
    mixes = [x + (xprev - x) * p["mu"][i].to(x.dtype) for i in range(5)]
    heads = lambda z: split_dim(z, 2, (h, hd))
    r = heads(mm(mixes[0], p["wr"]))
    k = heads(mm(mixes[1], p["wk"]))
    v = heads(mm(mixes[2], p["wv"]))
    g = silu(mm(mixes[4], p["wg"]))
    wlog = p["w0"] + mm(torch.tanh(mm(mixes[3].float(), p["wA"])),
                        p["wB"])
    w = heads(torch.exp(-torch.exp(wlog)))                 # decay in (0,1)

    tb = lambda z: z.transpose(1, 2)                   # [B,H,S,hd]
    rf, kf, vf = (tb(z).float() for z in (r, k, v))
    wf = tb(w)
    u = split_dim(p["u"], 0, (h, hd))
    s0 = cache["s"] if isinstance(cache, dict) else \
        torch.zeros((b, h, hd, hd), dtype=torch.float32, device=x.device)
    # one position with a state: the reference's decode fast path
    y, sT = _wkv(rf, kf, vf, wf, u, s0,
                 step=s == 1 and isinstance(cache, dict))
    y = pinned(y.transpose(1, 2).reshape(b, s, d)).to(x.dtype)
    out = mm(y * g, p["wo"])
    if isinstance(cache, dict):
        cache["s"].copy_(sT)
        cache["xa"].copy_(x[:, -1])
        return out, {"s": cache["s"], "xa": cache["xa"]}
    new_cache = {"s": sT, "xa": x[:, -1]} if cache is not None else None
    return out, new_cache


def apply_rwkv_channelmix(cfg, p, x, *, cache=None):
    """RWKV6 channel mix; ``cache`` as in the time mix (``"xc"`` its last
    input)."""
    xprev = _shifted(x, cache, "xc")
    mk = x + (xprev - x) * p["mu_c"][0].to(x.dtype)
    mr = x + (xprev - x) * p["mu_c"][1].to(x.dtype)
    kk = torch.square(torch.relu(mm(mk, p["ck"])))
    out = torch.sigmoid(mm(mr, p["cr"])).to(x.dtype) * mm(kk, p["cv"])
    if isinstance(cache, dict):
        cache["xc"].copy_(x[:, -1])
        return out, {"xc": cache["xc"]}
    new_cache = {"xc": x[:, -1]} if cache is not None else None
    return out, new_cache
