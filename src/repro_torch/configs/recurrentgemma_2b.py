"""recurrentgemma-2b [hybrid] -- 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; RG-LRU + local attention (2 recurrent : 1 local-attn
repeating; two leading recurrent layers make up 26).  [arXiv:2402.19427]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b", n_layers=26, d_model=2560, n_heads=10,
    n_kv_heads=1, d_ff=7680, vocab=256000, head_dim=256,
    group=("recurrent", "recurrent", "local"),
    prefix=("recurrent", "recurrent"),
    window=2048, d_rnn=2560)
