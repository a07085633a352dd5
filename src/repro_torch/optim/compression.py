"""Gradient compression for the data-parallel all-reduce; the port of
``repro.optim.compression``.

Error-feedback int8 quantization (1-bit-Adam family): each worker quantizes
(grad + residual) to int8 with a per-tensor scale, all-reduces the int8
payload (8x less traffic than fp32 / 2x less than bf16), dequantizes,
and keeps the quantization error as residual for the next step.  Where the
reference is a collective inside ``shard_map`` over a mesh axis, here each
rank calls it on its own gradients with a process group (a mesh axis's
from ``DeviceMesh.get_group``), and ``all_reduce`` stands for
``psum``/``pmax``.
The payload travels as int32, as the reference's ``psum`` accumulates it.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.distributed as dist


def init_residuals(grads: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for k, g in grads.items()}


def compressed_psum(grads: Dict[str, torch.Tensor],
                    residuals: Dict[str, torch.Tensor], group=None
                    ) -> Tuple[Dict[str, torch.Tensor],
                               Dict[str, torch.Tensor]]:
    """int8 error-feedback all-reduce over ``group`` (a process group;
    None for the default one; ``mesh.get_group("data")`` for a mesh
    axis).

    Protocol per tensor: (1) all-reduce MAX of the local absmax -> one
    shared fp32 scale (negligible traffic); (2) quantize (grad + residual)
    to int8 with that scale, rounding half to even as ``jnp.round``;
    (3) all-reduce SUM of the int payload; (4) dequantize the sum;
    residual keeps the local quantization error (error feedback preserves
    convergence).  Every rank calls it with its own leaves, in the same
    key order.  Returns (mean-reduced grads, new residuals)."""
    n = dist.get_world_size(group)

    def one(g, r):
        gf = g.float() + r
        amax = torch.max(torch.abs(gf)).reshape(1)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = amax[0] / 127.0 + 1e-12
        q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
        # error feedback, rounded once as the reference's fused
        # multiply-add rounds it: the product is exact in float64, and so
        # is its difference from gf, which is close to it
        new_r = (gf.double() - q.double() * scale.double()).float()
        s = q.to(torch.int32)
        dist.all_reduce(s, op=dist.ReduceOp.SUM, group=group)
        red = s.float() * scale / n
        return red.to(g.dtype), new_r

    out = {k: one(grads[k], residuals[k]) for k in grads}
    return {k: o[0] for k, o in out.items()}, \
        {k: o[1] for k, o in out.items()}
