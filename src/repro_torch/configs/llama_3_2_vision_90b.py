"""llama-3.2-vision-90b [vlm] -- 100L d_model=8192 64H (GQA kv=8)
d_ff=28672 vocab=128256; cross-attention image layers every 5th layer;
the vision tower is a STUB (input_specs provides precomputed patch
embeddings).  [hf:meta-llama/Llama-3.2-90B-Vision family]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b", n_layers=100, d_model=8192, n_heads=64,
    n_kv_heads=8, d_ff=28672, vocab=128256, head_dim=128,
    group=("attn", "attn", "attn", "attn", "cross"),
    frontend="vision", frontend_dim=7680, vision_seq=1601,
    rope_theta=500_000.0)
