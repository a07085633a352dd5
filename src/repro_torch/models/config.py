"""Model configuration covering all ten assigned architecture families.

A copy of ``repro.models.config`` (pure Python), so that the port imports
nothing of the JAX package."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int
    n_shared: int = 0
    capacity_factor: float = 1.25
    first_dense: int = 0          # leading dense layers (deepseek-v2)
    d_ff_dense: int = 0           # their ffn width


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 multi-head latent attention."""
    q_lora: int = 1536
    kv_lora: int = 512
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                       # 0 -> d_model // n_heads
    # layer-kind pattern: repeating group + optional non-repeated prefix
    group: Tuple[str, ...] = ("attn",)      # kinds: attn/local/recurrent/
    prefix: Tuple[str, ...] = ()            # rwkv/cross/moe/moe_dense
    # attention flavor
    qk_norm: bool = False
    qkv_bias: bool = False
    window: int = 0                         # local attention window
    rope_theta: float = 10000.0
    mla: Optional[MLAConfig] = None
    # mixture of experts
    moe: Optional[MoEConfig] = None
    # recurrent blocks
    d_rnn: int = 0                          # RG-LRU width (0 -> d_model)
    # modality frontend stubs
    frontend: str = "none"                  # none / audio / vision
    frontend_dim: int = 0                   # stub embedding dim
    vision_seq: int = 1601                  # image tokens (precomputed stub)
    encoder_only: bool = False
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def n_groups(self) -> int:
        n = self.n_layers - len(self.prefix)
        assert n % len(self.group) == 0, (self.name, n, self.group)
        return n // len(self.group)

    @property
    def sub_quadratic(self) -> bool:
        """True when no layer attends over unbounded context (long_500k ok).
        'moe'/'moe_dense' layers carry full attention too."""
        kinds = set(self.group) | set(self.prefix)
        return not (kinds & {"attn", "cross", "moe", "moe_dense"}) and "cross" not in kinds

    @property
    def n_params(self) -> int:
        """Total parameter count (embedding + layers), for 6ND."""
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        if self.frontend != "none":
            total += self.frontend_dim * d
        kinds = list(self.prefix) + list(self.group) * self.n_groups
        for kind in kinds:
            total += self._layer_params(kind)
        return total

    @property
    def n_params_active(self) -> int:
        d, v = self.d_model, self.vocab
        total = v * d * (1 if self.tie_embeddings else 2)
        kinds = list(self.prefix) + list(self.group) * self.n_groups
        for kind in kinds:
            total += self._layer_params(kind, active=True)
        return total

    def _layer_params(self, kind: str, active: bool = False) -> int:
        d = self.d_model
        hd = self.hd
        if kind in ("attn", "local", "cross"):
            if self.mla is not None:
                m = self.mla
                qdim = self.n_heads * (m.nope_head_dim + m.rope_head_dim)
                attn = (d * m.q_lora + m.q_lora * qdim
                        + d * (m.kv_lora + m.rope_head_dim)
                        + m.kv_lora * self.n_heads
                        * (m.nope_head_dim + m.v_head_dim)
                        + self.n_heads * m.v_head_dim * d)
            else:
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            ffn = 3 * d * self.d_ff
            return attn + ffn + 2 * d
        if kind == "recurrent":
            dr = self.d_rnn or d
            return 2 * d * dr + dr * d + 2 * dr + 3 * d * self.d_ff + 2 * d
        if kind == "rwkv":
            return 4 * d * d + d * d + 2 * d * self.d_ff + 2 * d
        if kind in ("moe", "moe_dense"):
            m = self.moe
            if self.mla is not None:
                mm = self.mla
                qdim = self.n_heads * (mm.nope_head_dim + mm.rope_head_dim)
                attn = (d * mm.q_lora + mm.q_lora * qdim
                        + d * (mm.kv_lora + mm.rope_head_dim)
                        + mm.kv_lora * self.n_heads
                        * (mm.nope_head_dim + mm.v_head_dim)
                        + self.n_heads * mm.v_head_dim * d)
            else:
                attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd \
                    + self.n_heads * hd * d
            if kind == "moe_dense":
                return attn + 3 * d * m.d_ff_dense + 2 * d
            router = d * m.n_experts
            n_e = (m.top_k + m.n_shared) if active else \
                (m.n_experts + m.n_shared)
            return attn + router + n_e * 3 * d * m.d_expert + 2 * d
        raise ValueError(kind)

    def reduced(self, **overrides) -> "ModelConfig":
        """Tiny same-family config for CPU smoke tests."""
        base = dict(
            n_layers=len(self.prefix) + 2 * len(self.group),
            d_model=64, n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads
            else self.n_kv_heads,
            d_ff=128, vocab=256, head_dim=16, window=min(self.window, 32),
            d_rnn=32 if self.d_rnn else 0, frontend_dim=32
            if self.frontend != "none" else 0, vision_seq=8)
        if self.moe:
            base["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_expert=32,
                d_ff_dense=128 if self.moe.d_ff_dense else 0)
        if self.mla:
            base["mla"] = MLAConfig(q_lora=32, kv_lora=16, rope_head_dim=8,
                                    nope_head_dim=16, v_head_dim=16)
        base.update(overrides)
        return dataclasses.replace(self, **base)
