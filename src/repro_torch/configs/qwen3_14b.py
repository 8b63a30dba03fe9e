"""qwen3-14b [dense] — hf:Qwen/Qwen3 family. 40L, d=5120, 40H GQA kv=8,
d_ff=17408, vocab=151936, qk_norm."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register
def qwen3_14b() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b", family="dense", n_layers=40, d_model=5120,
        n_heads=40, n_kv_heads=8, head_dim=128, d_ff=17408, vocab=151936,
        qk_norm=True, rope_theta=1000000.0, norm="rmsnorm", act="swiglu",
        param_dtype="bfloat16", remat=True, attn_chunk=512)
