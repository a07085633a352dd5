"""AdamW on PyTorch tensors (bf16 params, fp32 moments), cosine schedule,
global-norm clipping, decoupled weight decay: the port of
``repro.optim.adamw``.

The parameters are an :class:`~repro_torch.models.model.LM` and the
moments trees of its shape (:func:`repro_torch.models.convert.assemble`).
:func:`update` writes the parameters and moments in place (under
``torch.no_grad``), with the values of the reference's functional update:
every leaf the same elementwise float32 expression, in chunks of
:data:`CHUNK` elements so that a large leaf (the embedding) needs a few
chunk-sized float32 temporaries, not leaf-sized ones.  Two things follow
the reference's tree rather than the port's flat layer list:

* :func:`global_norm` sums the leaves' squared sums in the reference's
  leaf order (:func:`~repro_torch.models.convert.reference_leaves`), a
  stacked group leaf's layers one after another (of DTensor leaves, each
  rank sums its own blocks in that order, and one all-reduce adds the
  ranks' sums);
* weight decay applies to a leaf of ``ndim >= 2`` *as the reference
  stacks it*: a group's norm vector ``[d]`` is a ``[n_groups, d]`` leaf
  there and decays, the same vector in the prefix does not.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import torch
from torch.distributed.tensor import DTensor

from ..models import convert

#: Elements of one leaf updated at a time.
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``; float32."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 \
        * (1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def init(params) -> Dict[str, Any]:
    """Zero float32 moments of ``params``' shape and step 0 (int32, 0-d),
    on the parameters' device."""
    zeros = lambda: convert.assemble(params.cfg, {
        n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
        for n, p in params.named_parameters()})
    return {"m": zeros(), "v": zeros(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=params["embed"].device)}


def _norm(leaves) -> torch.Tensor:
    total = None
    for _, tensors in leaves:
        for t in tensors:
            s = torch.sum(torch.square(t.float()))
            total = s if total is None else total + s
    return torch.sqrt(total)


def global_norm(tree) -> torch.Tensor:
    """The float32 L2 norm of every tensor of ``tree`` (an ``LM`` or a
    tree of its shape), summed in the reference's leaf order."""
    return _norm(convert.reference_leaves(tree.cfg, tree))


def _chunks(n: int):
    for a in range(0, max(n, 1), CHUNK):
        yield slice(a, min(a + CHUNK, n))


@torch.no_grad()
def _update_leaf(cfg: AdamWConfig, g, m, v, p, scale, lr, b1c, b2c,
                 decay: float) -> None:
    """One leaf, in place.  DTensors: each rank updates its own blocks,
    the gradient laid out as the moments; a parameter laid out otherwise
    (the dry run's vocabulary-sharded embedding beside moments sharded on
    d_model) is updated in the moments' layout and copied back."""
    if isinstance(p, DTensor):
        g = g.redistribute(m.device_mesh, m.placements)
        pm = p if p.placements == m.placements else \
            p.redistribute(m.device_mesh, m.placements)
        _update_local(cfg, *(t.to_local() for t in (g, m, v, pm)), scale,
                      lr, b1c, b2c, decay)
        if pm is not p:
            p.to_local().copy_(
                pm.redistribute(p.device_mesh, p.placements).to_local())
        return
    _update_local(cfg, g, m, v, p, scale, lr, b1c, b2c, decay)


def _update_local(cfg: AdamWConfig, g, m, v, p, scale, lr, b1c, b2c,
                  decay: float) -> None:
    shrink = 1 - lr * decay
    g, m, v, p = (t.reshape(-1) for t in (g, m, v, p))
    for sl in _chunks(p.numel()):
        gc = g[sl].float() * scale
        mc, vc, pc = m[sl], v[sl], p[sl]
        mc.mul_(cfg.b1).add_((1 - cfg.b1) * gc)
        vc.mul_(cfg.b2).add_((1 - cfg.b2) * gc * gc)
        u = (mc / b1c) / (torch.sqrt(vc / b2c) + cfg.eps)
        pc.copy_((pc.float() * shrink - lr * u).to(p.dtype))


def update(cfg: AdamWConfig, grads, state, params):
    """One AdamW step.  ``grads``: a tree of ``params``' shape or a mapping
    of the port's parameter names to gradients (any float dtype).  Writes
    ``params`` and the moments in place and returns (params, the new
    state, {"grad_norm", "lr"})."""
    mcfg = params.cfg
    step = state["step"] + 1
    g_leaves = convert.reference_leaves(mcfg, grads)
    gn = _norm(g_leaves)
    scale = torch.clamp(cfg.clip_norm / (gn + 1e-9), max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    # the same on every rank: each rank's own blocks take them as they are
    consts = [c.to_local() if isinstance(c, DTensor) else c
              for c in (scale, lr, b1c, b2c)]
    trees = [convert.reference_leaves(mcfg, t)
             for t in (params, state["m"], state["v"])]
    for (path, gs), (_, ps), (_, ms), (_, vs) in zip(g_leaves, *trees):
        for g, p, m, v in zip(gs, ps, ms, vs):
            ndim = p.dim() + convert.stacked(path)
            decay = cfg.weight_decay if ndim >= 2 else 0.0
            _update_leaf(cfg, g, m, v, p, *consts, decay)
    return params, {"m": state["m"], "v": state["v"], "step": step}, \
        {"grad_norm": gn, "lr": lr}
