"""hubert-xlarge [audio] -- 48L d_model=1280 16H (MHA kv=16) d_ff=5120
vocab=504; encoder-only; the conv waveform frontend is a STUB
(input_specs provides precomputed frame embeddings).  [arXiv:2106.07447]"""
from ..models.config import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge", n_layers=48, d_model=1280, n_heads=16,
    n_kv_heads=16, d_ff=5120, vocab=504, head_dim=80, encoder_only=True,
    frontend="audio", frontend_dim=512)
