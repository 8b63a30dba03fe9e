"""hymba-1.5b [hybrid] — arXiv:2411.13676. 32L, d=1600, 25H GQA kv=5 (hd 64)
parallel attn+mamba heads, d_ff=5504, ssm_state=16, vocab=32001, SWA + 3
global-attention layers, 128 meta tokens."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register
def hymba_1_5b() -> ModelConfig:
    return ModelConfig(
        name="hymba-1.5b", family="hybrid", n_layers=32, d_model=1600,
        n_heads=25, n_kv_heads=5, head_dim=64, d_ff=5504, vocab=32001,
        ssm_heads=25, ssm_state=16, window=1024, full_attn_layers=(0, 15, 31),
        meta_tokens=128, rope_theta=10000.0, norm="rmsnorm", act="swiglu",
        param_dtype="bfloat16", attn_chunk=512, remat=True)
