"""Step builders and the (architecture x input-shape) cells, on PyTorch.

The serving half of ``repro.launch.steps``: the assigned LM shape grid

  train_4k     seq 4096,   global_batch 256   -> train_step
  prefill_32k  seq 32768,  global_batch 32    -> prefill (logits + caches)
  decode_32k   seq 32768,  global_batch 128   -> serve_step (1 new token)
  long_500k    seq 524288, global_batch 1     -> serve_step; sub-quadratic
                                                 archs only

with the reference's skips, and the prefill and decode steps.  The train
step and the abstract input specs wait for ROADMAP A15 and A17.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..models import model as M
from ..models.config import ModelConfig


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
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return next_tok, logits, new_caches
    return serve_step
