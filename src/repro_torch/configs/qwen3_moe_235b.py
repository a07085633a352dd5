"""qwen3-moe-235b-a22b [moe] -- 94L d_model=4096 64H (GQA kv=4)
d_ff(expert)=1536 vocab=151936; 128 experts top-8, qk_norm.
[hf:Qwen/Qwen3-235B-A22B family]"""
from ..models.config import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b", n_layers=94, d_model=4096, n_heads=64,
    n_kv_heads=4, d_ff=1536, vocab=151936, head_dim=128, qk_norm=True,
    rope_theta=1_000_000.0, group=("moe",),
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=1536))
