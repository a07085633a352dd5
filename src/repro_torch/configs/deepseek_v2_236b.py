"""deepseek-v2-236b [moe] -- 60L d_model=5120 128H (MLA) d_ff(expert)=1536
vocab=102400; MLA kv_lora=512, 2 shared + 160 routed top-6, first layer
dense.  [arXiv:2405.04434]"""
from ..models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v2-236b", n_layers=60, d_model=5120, n_heads=128,
    n_kv_heads=128, d_ff=1536, vocab=102400,
    head_dim=192,  # nope 128 + rope 64
    group=("moe",), prefix=("moe_dense",),
    mla=MLAConfig(q_lora=1536, kv_lora=512, rope_head_dim=64,
                  nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(n_experts=160, top_k=6, d_expert=1536, n_shared=2,
                  first_dense=1, d_ff_dense=12288))
