"""rwkv6-3b [ssm] — arXiv:2404.05892 (Finch). 32L, d=2560 (40 heads x 64),
attention-free, d_ff=8960, vocab=65536, data-dependent decay."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register
def rwkv6_3b() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b", family="ssm", n_layers=32, d_model=2560,
        n_heads=40, n_kv_heads=40, head_dim=64, d_ff=8960, vocab=65536,
        norm="layernorm", act="relu_sq", param_dtype="bfloat16")
