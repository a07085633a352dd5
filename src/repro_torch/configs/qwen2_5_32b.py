"""qwen2.5-32b [dense] -- 64L d_model=5120 40H (GQA kv=8) d_ff=27648
vocab=152064; GQA, QKV bias.  [hf:Qwen/Qwen2.5-0.5B family]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="qwen2.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=27648, vocab=152064, head_dim=128, qkv_bias=True,
    rope_theta=1_000_000.0)
