"""Plain Qwen3 in float32: the reference that the decode cells of a Qwen3
configuration are held to.

It follows Qwen3's published description (the model card and config.json
of Qwen/Qwen3-8B, and the Qwen3 modelling code they name), with every size
read from the configuration file's published keys:

* token embedding of ``vocab_size`` rows of ``hidden_size``;
* ``num_hidden_layers`` pre-norm blocks, each: RMSNorm; grouped-query
  attention, queries in ``num_attention_heads`` heads and keys and values
  in ``num_key_value_heads`` heads, all of ``head_dim``, no biases
  (``attention_bias`` false); an RMSNorm over each head of the queries and
  of the keys; rotary position embedding over the whole head
  (``rope_theta``, the two halves rotated); causal softmax attention, query
  head h reading key head h // (heads / key heads); the output projection;
  the residual add; RMSNorm; the SwiGLU MLP of ``intermediate_size``,
  ``down(silu(gate(x)) * up(x))``; the residual add;
* a final RMSNorm and an untied output head (``tie_word_embeddings``
  false), giving the logits.

Every RMSNorm is ``x / sqrt(mean(x^2) + rms_norm_eps) * gain``.

It runs one sequence at a time over its whole length: no cache, no
batching, every product in float32 with TF32 off, each weight upcast from
the stored tensor when its layer runs, so that it fits on the card once the
program's state is freed.  It imports nothing but ``torch``.

The weights are read by name, as tensors.  Names and layouts are those of
the parameter tree of the program under test (``repro_torch``), and where
that tree or the program departs from the description it is noted here:

* names: ``embed``, ``layers.<i>.ln1``, ``layers.<i>.attn.wq``, ``wk``,
  ``wv``, ``wo``, ``qnorm``, ``knorm``, ``layers.<i>.ln2``,
  ``layers.<i>.ffn.w1`` (gate), ``w3`` (up), ``w2`` (down), ``norm_f``,
  ``lm_head``;
* every projection is stored [in, out] (the published checkpoints store
  [out, in]), so a product is ``x @ w``;
* a norm's gain is stored as its offset from 1, in float32: the gain is
  ``1 + stored`` (the published checkpoints store the gain itself);
* the program rounds activations to bfloat16 between operations and keeps
  its decode caches in bfloat16; its norms and attention scores are
  float32;
* the program teacher-forces the prompt through single-position decode
  steps, and its decode attention reads the whole cache with the positions
  after the current one masked; both give the mathematics above.
"""

from __future__ import annotations

import contextlib
import math

import torch


@contextlib.contextmanager
def _no_tf32():
    """Float32 products in float32: TF32 off for the reference's span."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _rms(x, stored_gain, eps):
    gain = 1.0 + stored_gain.float()
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * gain


def _rope(x, theta: float):
    """x [S, heads, head_dim] at positions 0..S-1."""
    s, _, hd = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                        device=x.device) / hd))
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] \
        * inv[None]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[:, None]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


@torch.no_grad()
def forward(config: dict, weights, tokens: torch.Tensor,
            first: int) -> torch.Tensor:
    """The float32 logits [S - first, vocab_size] at positions first..S-1
    of one sequence ``tokens`` [S], on the weights' device."""
    c = config
    heads, kv, hd = (c["num_attention_heads"], c["num_key_value_heads"],
                     c["head_dim"])
    eps, theta = float(c["rms_norm_eps"]), float(c["rope_theta"])
    w = lambda name: weights[name].float()
    with _no_tf32():
        s = tokens.shape[0]
        x = weights["embed"][tokens.long()].float()
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=x.device).tril()
        for i in range(c["num_hidden_layers"]):
            p = f"layers.{i}."
            h = _rms(x, weights[p + "ln1"], eps)
            q = (h @ w(p + "attn.wq")).view(s, heads, hd)
            k = (h @ w(p + "attn.wk")).view(s, kv, hd)
            v = (h @ w(p + "attn.wv")).view(s, kv, hd)
            q = _rope(_rms(q, weights[p + "attn.qnorm"], eps), theta)
            k = _rope(_rms(k, weights[p + "attn.knorm"], eps), theta)
            k = k.repeat_interleave(heads // kv, dim=1)
            v = v.repeat_interleave(heads // kv, dim=1)
            score = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
            att = score.masked_fill(~causal, float("-inf")).softmax(-1)
            o = torch.einsum("hqk,khd->qhd", att, v).reshape(s, heads * hd)
            x = x + o @ w(p + "attn.wo")
            h = _rms(x, weights[p + "ln2"], eps)
            gate = h @ w(p + "ffn.w1")
            x = x + (gate * torch.sigmoid(gate) * (h @ w(p + "ffn.w3"))) \
                @ w(p + "ffn.w2")
        x = _rms(x[first:], weights["norm_f"], eps)
        head = weights["embed"].T if c.get("tie_word_embeddings") \
            else weights["lm_head"]
        return x @ head.float()
