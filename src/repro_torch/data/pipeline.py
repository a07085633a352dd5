"""Deterministic synthetic data pipeline (numpy only; a copy of
``repro.data.pipeline``, so both packages give equal batches).

Production posture: the iterator is a pure function of (seed, step,
shard_index) so restarts and elastic re-sharding resume exactly -- the
checkpoint only needs the step counter.  Token streams are Zipf-distributed
with document structure (BOS-delimited, packed); audio/vision batches carry
synthetic frontier embeddings (the modality frontends are stubs per the
assignment).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    frontend_dim: int = 0
    vision_seq: int = 0
    kind: str = "lm"          # lm / audio / vlm


def _rng(cfg: DataConfig, step: int, shard: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, shard]))


def batch_at(cfg: DataConfig, step: int, shard: int = 0, n_shards: int = 1):
    """The (step, shard)-th batch; deterministic and shard-disjoint."""
    b = cfg.global_batch // n_shards
    rng = _rng(cfg, step, shard)
    out = {}
    if cfg.kind == "audio":
        frames = rng.standard_normal(
            (b, cfg.seq_len, cfg.frontend_dim)).astype(np.float32)
        out["frames"] = frames
        out["labels"] = rng.integers(0, cfg.vocab,
                                     (b, cfg.seq_len)).astype(np.int32)
        return out
    # zipf-ish token stream with BOS-packed documents
    toks = rng.zipf(1.2, size=(b, cfg.seq_len)).astype(np.int64)
    toks = np.clip(toks, 1, cfg.vocab - 1).astype(np.int32)
    doc_ends = rng.random((b, cfg.seq_len)) < (1.0 / cfg.mean_doc_len)
    toks[doc_ends] = 0                       # BOS
    out["tokens"] = toks
    labels = np.roll(toks, -1, axis=1).astype(np.int32)
    labels[:, -1] = -1                       # no target for the final pos
    out["labels"] = labels
    if cfg.kind == "vlm":
        out["vision"] = rng.standard_normal(
            (b, cfg.vision_seq, cfg.frontend_dim)).astype(np.float32)
    return out


class DataIterator:
    """Stateful wrapper; state == step (restores exactly from checkpoints)."""

    def __init__(self, cfg: DataConfig, start_step: int = 0,
                 shard: int = 0, n_shards: int = 1):
        self.cfg = cfg
        self.step = start_step
        self.shard = shard
        self.n_shards = n_shards

    def __next__(self):
        b = batch_at(self.cfg, self.step, self.shard, self.n_shards)
        self.step += 1
        return b

    def state(self):
        return {"step": self.step}

    def restore(self, state):
        self.step = int(state["step"])
