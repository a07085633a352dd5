"""Step builders and the (architecture x input-shape) cells, on PyTorch.

The serving half of ``repro.launch.steps``: the assigned LM shape grid

  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> prefill (logits + caches)
  decode_32k   seq 32768,  global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288, global_batch 1     -> serve_step; sub-quadratic
                                                 archs only

with the reference's skips, the gradient-accumulation depth, the abstract
input specs (``batch_specs``, ``input_specs``: tensors on the ``meta``
device, shapes and dtypes with nothing allocated) and the train, prefill
and decode steps.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch.distributed.tensor import DTensor

from ..models import layers as L
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw


@dataclasses.dataclass(frozen=True)
class ShapePlan:
    name: str
    kind: str            # train / prefill / decode
    seq: int
    global_batch: int


SHAPES = {
    "train_4k": ShapePlan("train_4k", "train", 4096, 256),
    "prefill_32k": ShapePlan("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapePlan("decode_32k", "decode", 32768, 128),
    "long_500k": ShapePlan("long_500k", "decode", 524288, 1),
}


def cell_skip_reason(cfg: ModelConfig, shape: ShapePlan) -> Optional[str]:
    if cfg.encoder_only and shape.kind == "decode":
        return "encoder-only: no autoregressive step"
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return "full attention is quadratic at 500k ctx (DESIGN.md)"
    return None


def accum_for(cfg: ModelConfig, shape: ShapePlan) -> int:
    """Gradient-accumulation depth: keep the dispatched/activation working
    set of a microbatch inside HBM (MoE dispatch inflates by top_k)."""
    if shape.kind != "train":
        return 1
    if cfg.moe is not None or cfg.n_layers >= 90 or cfg.d_model >= 8192:
        return 16
    if cfg.n_params > 2e10:
        return 8
    return 4


# --------------------------------------------------------------------------
# input specs (meta tensors; no allocation)
# --------------------------------------------------------------------------

def batch_specs(cfg: ModelConfig, shape: ShapePlan, *, accum: int = 0
                ) -> Dict:
    """``accum``: the train step's accumulation depth (0:
    :func:`accum_for`'s)."""
    def sd(dims, dtype):
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "train":
        a = accum or accum_for(cfg, shape)
        mb = shape.global_batch // a
        assert mb >= 1, (cfg.name, shape.name)
        out = {}
        if cfg.frontend == "audio":
            out["frames"] = sd((a, mb, shape.seq, cfg.frontend_dim),
                               torch.float32)
        else:
            out["tokens"] = sd((a, mb, shape.seq), torch.int32)
        out["labels"] = sd((a, mb, shape.seq), torch.int32)
        if cfg.frontend == "vision":
            out["vision"] = sd((a, mb, cfg.vision_seq, cfg.frontend_dim),
                               torch.float32)
        return out
    if shape.kind == "prefill":
        b = shape.global_batch
        out = {}
        if cfg.frontend == "audio":
            out["frames"] = sd((b, shape.seq, cfg.frontend_dim),
                               torch.float32)
        else:
            out["tokens"] = sd((b, shape.seq), torch.int32)
        if cfg.frontend == "vision":
            out["vision"] = sd((b, cfg.vision_seq, cfg.frontend_dim),
                               torch.float32)
        return out
    # decode
    out = {"token": sd((shape.global_batch,), torch.int32),
           "pos": sd((), torch.int32)}
    if cfg.frontend == "vision":
        out["vision"] = sd((shape.global_batch, cfg.vision_seq,
                            cfg.frontend_dim), torch.float32)
    return out


def input_specs(cfg: ModelConfig, shape: ShapePlan, *, accum: int = 0
                ) -> Dict:
    """All abstract inputs for the cell, on the ``meta`` device: batch +
    params (an :class:`~repro_torch.models.model.LM`) (+ opt/caches, the
    port's per-layer list)."""
    params = M.LM(cfg, device="meta")
    specs = {"params": params,
             "batch": batch_specs(cfg, shape, accum=accum)}
    if shape.kind == "train":
        specs["opt"] = adamw.init(params)
    if shape.kind == "decode":
        specs["caches"] = M.init_caches(cfg, shape.global_batch, shape.seq,
                                        device="meta")
    return specs


def make_train_step(cfg: ModelConfig, accum: int,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    acc_dtype=torch.float32, fused_accum: bool = False):
    """Gradient-accumulated train step: ``train_step(params, opt_state,
    batch)`` -> (params, opt_state, {"loss", "grad_norm", "lr"}), with
    ``batch``'s tensors [accum, microbatch, ...] on the parameters'
    device.  The parameters are made trainable (``requires_grad``) and
    updated in place (:func:`repro_torch.optim.adamw.update`).

    Scan form: each microbatch's backward in turn, its gradients (in the
    parameters' dtype) added into an ``acc_dtype`` accumulator, divided by
    ``accum``; the loss is the microbatch losses' mean.  ``fused_accum``:
    one backward of the microbatch losses' sum over ``accum``, whose
    gradients (in the parameters' dtype) go to the optimizer as they are;
    the loss is that mean.  A parameter no loss reaches gets a zero
    gradient, as under ``jax.grad``.  The parameters, the optimizer state
    and the batch may be DTensors (:mod:`~repro_torch.launch.sharding`):
    each gradient is then laid out as its parameter, and the metrics come
    back as plain tensors, the same on every rank."""
    def grads_of(loss, leaves):
        """The gradients, each laid out as its parameter (a DTensor's
        pending sums over the batch's ranks reduced)."""
        with L.mesh_scope(loss):
            gs = torch.autograd.grad(loss, leaves, allow_unused=True,
                                     materialize_grads=True)
            return [g.redistribute(p.device_mesh, p.placements)
                    if isinstance(p, DTensor) else g
                    for g, p in zip(gs, leaves)]

    def train_step(params, opt_state, batch):
        names, leaves = zip(*params.named_parameters())
        for p in leaves:
            p.requires_grad_(True)
        micro = [{k: v[i] for k, v in batch.items()} for i in range(accum)]
        with torch.enable_grad():
            if fused_accum:
                total = torch.zeros((), dtype=torch.float32,
                                    device=leaves[0].device)
                for mb in micro:
                    total = total + M.loss_fn(cfg, params, mb)[0]
                loss = total / accum
                gacc = dict(zip(names, grads_of(loss, leaves)))
                losses = [loss.detach()]
            else:
                gacc = {n: torch.zeros_like(p, dtype=acc_dtype)
                        for n, p in zip(names, leaves)}
                losses = []
                for mb in micro:
                    loss, _ = M.loss_fn(cfg, params, mb)
                    for a, g in zip(gacc.values(), grads_of(loss, leaves)):
                        a.add_(g.to(acc_dtype))
                    losses.append(loss.detach())
                for a in gacc.values():
                    a.div_(accum)
        new_p, new_opt, om = adamw.update(opt_cfg, gacc, opt_state, params)
        metrics = {"loss": torch.stack(losses).mean(), **om}
        # the same on every rank: a DTensor's value as a plain tensor
        return new_p, new_opt, {k: L.whole(v).to_local()
                                if isinstance(v, DTensor) else v
                                for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ModelConfig):
    def prefill_step(params, batch):
        return M.prefill(cfg, params, batch)
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    """``serve_step(params, caches, batch)`` -> (next token [B] int32,
    logits [B,V], caches); ``batch``: ``token`` [B] and ``pos`` (an int).
    Greedy: the next token is the logits' argmax (the first on a tie)."""
    def serve_step(params, caches, batch):
        logits, new_caches = M.decode_step(
            cfg, params, caches, batch["token"], batch["pos"],
            vision=batch.get("vision"))
        next_tok = torch.argmax(L.whole(logits, -1), dim=-1).to(torch.int32)
        return next_tok, logits, new_caches
    return serve_step
