"""llama3-405b [dense] — arXiv:2407.21783. 126L, d=16384, 128H GQA kv=8,
d_ff=53248, vocab=128256."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register
def llama3_405b() -> ModelConfig:
    return ModelConfig(
        name="llama3-405b", family="dense", n_layers=126, d_model=16384,
        n_heads=128, n_kv_heads=8, head_dim=128, d_ff=53248, vocab=128256,
        rope_theta=500000.0, norm="rmsnorm", act="swiglu",
        param_dtype="bfloat16", remat=True, attn_chunk=512)
