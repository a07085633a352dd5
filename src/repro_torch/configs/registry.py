"""--arch <id> registry for every assigned architecture."""
from . import (deepseek_v2_236b, hubert_xlarge, llama_3_2_vision_90b,
               mistral_nemo_12b, qwen1_5_32b, qwen2_5_32b, qwen3_8b,
               qwen3_moe_235b, recurrentgemma_2b, rwkv6_1_6b)

ARCHS = {
    "qwen3-8b": qwen3_8b.CONFIG,
    "qwen1.5-32b": qwen1_5_32b.CONFIG,
    "qwen2.5-32b": qwen2_5_32b.CONFIG,
    "mistral-nemo-12b": mistral_nemo_12b.CONFIG,
    "recurrentgemma-2b": recurrentgemma_2b.CONFIG,
    "qwen3-moe-235b-a22b": qwen3_moe_235b.CONFIG,
    "deepseek-v2-236b": deepseek_v2_236b.CONFIG,
    "hubert-xlarge": hubert_xlarge.CONFIG,
    "rwkv6-1.6b": rwkv6_1_6b.CONFIG,
    "llama-3.2-vision-90b": llama_3_2_vision_90b.CONFIG,
}


def get(name: str):
    return ARCHS[name]
