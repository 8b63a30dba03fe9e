"""qwen2.5-3b [dense] — hf:Qwen/Qwen2.5 family. 36L, d=2048, 16H GQA kv=2,
d_ff=11008, vocab=151936, QKV bias."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register
def qwen2_5_3b() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense", n_layers=36, d_model=2048,
        n_heads=16, n_kv_heads=2, head_dim=128, d_ff=11008, vocab=151936,
        qkv_bias=True, rope_theta=1000000.0, norm="rmsnorm", act="swiglu",
        param_dtype="bfloat16", remat=True, attn_chunk=512)
