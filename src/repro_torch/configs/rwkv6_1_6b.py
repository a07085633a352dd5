"""rwkv6-1.6b (Finch) [ssm] -- 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536; data-dependent decay WKV6.  [arXiv:2404.05892]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b", n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536, head_dim=64, group=("rwkv",))
