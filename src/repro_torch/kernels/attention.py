"""The LM's grouped-query attention of one decode step on the card.

:func:`decode_attn` wraps ``csrc/decode_attn.cu`` (built and bound by
:mod:`.pim_exec`, launches counted in ``pim_exec.LAUNCHES["decode_attn"]``):
one query position of q [B, 1, H, hd] over the caches k, v [B, S, K, hd]
up to the slot ``pos[0, 0]``, in one pass over those slots.  It replaces no TPU kernel: the reference computes
the same function with the einsums of ``_group_attn``, which is also this
kernel's plain version (:func:`plain`).  On CPU tensors the wrapper calls
the plain version; on CUDA tensors it launches the kernel or raises.

What the wrapper decides from the dtypes and the head dim alone: the
path (the tensor cores for a bfloat16 query over bfloat16 caches with
head dims up to :data:`MMA_MAX_HEAD_DIM`, else the CUDA cores in
float32) and the slots a tile (:func:`tile_for`).  One launch a call,
one CTA a (row, KV head).
"""

from __future__ import annotations

import numpy as np
import torch

from . import pim_exec

#: Bytes of keys one tile holds: a tile takes the most slots, a power of two
#: from :data:`MIN_TILE` to :data:`MAX_TILE`, whose keys fit.
TILE_BYTES = 16384
MIN_TILE = 16
#: The kernel's threads a CTA: the score phase gives each slot of a tile
#: at least one.
MAX_TILE = 128
#: Query heads one KV head serves at most, and the head dims taken.
MAX_GROUP = 16
HEAD_DIMS = range(16, 257, 16)
#: The tensor-core path: its head dims and its slots a tile (16 for each
#: of its 4 warps).
MMA_MAX_HEAD_DIM = 128
MMA_TILE = 64
_F32 = {torch.bfloat16: 0, torch.float32: 1}


def tile_slots(hd: int, itemsize: int) -> int:
    """Slots a tile for rows of ``hd`` values of ``itemsize`` bytes."""
    fit = max(1, TILE_BYTES // (hd * itemsize))
    return max(MIN_TILE, min(MAX_TILE, 1 << (fit.bit_length() - 1)))


def tile_for(q_dtype, kv_dtype, hd: int) -> int:
    """Slots a tile for a query of ``q_dtype`` over caches of ``kv_dtype``
    with rows of ``hd``: :data:`MMA_TILE` on the tensor-core path (both
    bfloat16, ``hd`` at most :data:`MMA_MAX_HEAD_DIM`), else
    :func:`tile_slots`."""
    if q_dtype == kv_dtype == torch.bfloat16 and hd <= MMA_MAX_HEAD_DIM:
        return MMA_TILE
    return tile_slots(hd, torch.finfo(kv_dtype).bits // 8)


def plain(q, k, v, pos):
    """The plain version: ``layers._group_attn`` under the decode step's
    mask, the slots up to ``pos[0, 0]``."""
    from ..models.layers import _group_attn
    valid = (torch.arange(k.shape[1], device=k.device)[None]
             <= pos[:1, :1]).expand(q.shape[0], -1)
    return _group_attn(q, k, v, valid[:, None, :])


def _check(q, k, v, pos) -> None:
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"q must be [B, 1, H, hd], got {tuple(q.shape)}")
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != q.shape[0] \
            or k.shape[3] != q.shape[3]:
        raise ValueError(f"k and v must be [B, S, K, hd] of q's B and hd, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)} for q "
                         f"{tuple(q.shape)}")
    h, kh, hd = q.shape[2], k.shape[2], q.shape[3]
    if k.shape[1] == 0:
        raise ValueError("the caches hold no slot")
    if kh == 0 or h % kh or not 1 <= h // kh <= MAX_GROUP:
        raise ValueError(f"{h} query heads over {kh} KV heads: the kernel "
                         f"takes 1 to {MAX_GROUP} query heads a KV head")
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd}: the kernel takes 16 to 256 in "
                         f"steps of 16")
    if q.dtype not in _F32 or k.dtype not in _F32 or v.dtype != k.dtype:
        raise TypeError(f"q, k, v must be bfloat16 or float32, k and v of "
                        f"one type; got {q.dtype}, {k.dtype}, {v.dtype}")
    if pos.dtype != torch.int64 or pos.numel() == 0:
        raise TypeError(f"pos must be a non-empty int64 tensor, got "
                        f"{pos.dtype} of {pos.numel()} elements")
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, expected {q.device}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(3) != 1:
            raise ValueError(f"{name}'s last axis must be contiguous")
    for name, t in (("k", k), ("v", v)):
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"{name} must start and stride on 16-byte "
                             f"boundaries, got strides {t.stride()}")


def decode_attn(q, k, v, pos):
    """Attention of q [B, 1, H, hd] over the caches k, v [B, S, K, hd] at
    the slots up to ``pos[0, 0]`` (an int64 device tensor, never read on
    the host): [B, 1, H, hd] in the caches' type, query head h on KV head
    h // (H / K).  Takes bfloat16 or float32, 1 to 16 query heads a KV
    head and head dims 16 to 256 in steps of 16; raises on anything else
    on a CUDA tensor.  Launches on the current stream."""
    if q.device.type == "cpu":
        return plain(q, k, v, pos)
    dev = pim_exec._on_cuda(q, "decode_attn")
    _check(q, k, v, pos)
    b, _, h, hd = q.shape
    s, kh = k.shape[1], k.shape[2]
    out = torch.empty((b, 1, h, hd), dtype=k.dtype, device=dev)
    if out.numel() == 0:
        return out
    with torch.cuda.device(dev):
        err = pim_exec._lib("decode_attn").decode_attn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            out.data_ptr(), b, s, h, kh, hd, q.stride(0), q.stride(2),
            *k.stride()[:3], *v.stride()[:3], _F32[q.dtype], _F32[k.dtype],
            tile_for(q.dtype, k.dtype, hd), float(1.0 / np.sqrt(hd)),
            pim_exec._stream(dev))
    pim_exec._raise_on(err, "decode_attn")
    pim_exec.LAUNCHES["decode_attn"] += 1
    return out
