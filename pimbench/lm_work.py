"""The yardstick of an LM decode cell: a decode step's operations and bytes,
and the card's peaks for them.

A step of batch B at position p (its context: the p + 1 positions 0..p) of
a dense decoder with grouped-query attention and per-head q/k norms, as
Qwen3 is, needs

    FLOPs = 2 B M + 4 B L H hd (p + 1)
    bytes = 2 M + 4 N + 2 B d + 2 B L (2 K hd) + 2 B L (2 K hd) (p + 1)

with d the hidden size, F the MLP's width, L layers, H query heads and K
key-value heads of hd, V the vocabulary, and

* M = L (d H hd + 2 d K hd + H hd d + 3 d F) + d V: the parameters of the
  step's matrix products (each layer's q, k, v and output projections and
  its three MLP matrices, and the output head); each is a multiply and an
  add a row.  The embedding is a gather, no product;
* attention, a layer and a row: q.k over the context and the weighted sum
  of the values, 2 H hd (p + 1) each;
* bytes: every weight read once in the type it is served in (the matrices
  in bfloat16, 2 bytes; the N = L (2 d + 2 hd) + d norm gains in float32,
  4 bytes), the embedding gathered as one bfloat16 row a sequence, each
  layer's new key and value written once, and the cache's keys and values
  read to the position, all bfloat16.

This counts what the step needs, not what a program does: a program that
reads its whole cache with the later positions masked does more than the
count, never less.  The counts are frozen in the cell's file
(``pimbench/workloads/<cell>.json``) when the cell is defined, so a change
to the program cannot move the yardstick.
"""

from __future__ import annotations

from typing import Iterable, Optional, Tuple

#: Card name (``torch.cuda.get_device_name()``) -> the LM's peaks: dense
#: bfloat16 tensor-core operations a second and HBM bytes a second, NVIDIA's
#: data sheet for the H100 SXM part at its 700 W limit.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"flops_per_s": 989.4e12,
                              "bytes_per_s": 3.35e12},
}


def peaks(device_kind: str) -> Optional[dict]:
    return PEAKS.get(device_kind)


def dense_decode_step(config: dict, batch: int) -> dict:
    """The frozen counts of a decode step of ``batch`` rows, from the
    configuration's published keys: the part of the FLOPs and bytes that
    every step needs and the part that grows with each position of the
    context."""
    d, f = config["hidden_size"], config["intermediate_size"]
    layers = config["num_hidden_layers"]
    h, k, hd = (config["num_attention_heads"],
                config["num_key_value_heads"], config["head_dim"])
    v = config["vocab_size"]
    m = layers * (d * h * hd + 2 * d * k * hd + h * hd * d + 3 * d * f) \
        + d * v
    norms = layers * (2 * d + 2 * hd) + d
    kv_row = 2 * batch * layers * 2 * k * hd      # bytes of one position
    return {"batch": batch,
            "flops_per_step": 2 * batch * m,
            "flops_per_context": 4 * batch * layers * h * hd,
            "bytes_per_step": 2 * m + 4 * norms + 2 * batch * d + kv_row,
            "bytes_per_context": kv_row}


def span_work(frozen: dict, positions: Iterable[int]) -> Tuple[int, int]:
    """(FLOPs, bytes) of the decode steps at ``positions``."""
    flops = by = 0
    for p in positions:
        flops += frozen["flops_per_step"] + frozen["flops_per_context"] * (
            p + 1)
        by += frozen["bytes_per_step"] + frozen["bytes_per_context"] * (
            p + 1)
    return flops, by
