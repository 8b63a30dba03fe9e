"""qwen2-1.5b [dense] — arXiv:2407.10671. 28L, d=1536, 12H GQA kv=2,
d_ff=8960, vocab=151936, QKV bias."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, register_policy
from repro_torch.core.policy import ParamGroup, PrivacyPolicy


@register
def qwen2_1_5b() -> ModelConfig:
    return ModelConfig(
        name="qwen2-1.5b", family="dense", n_layers=28, d_model=1536,
        n_heads=12, n_kv_heads=2, head_dim=128, d_ff=8960, vocab=151936,
        qkv_bias=True, rope_theta=1000000.0, param_dtype="bfloat16",
        attn_chunk=512,
        remat=True)


@register_policy("qwen2-1.5b")
def qwen2_1_5b_policy() -> PrivacyPolicy:
    """Embedding + LM head clipped group-wise with their own R; the
    transformer blocks form the flat pool."""
    return PrivacyPolicy(groups=(
        ParamGroup("vocab", r"(embed|head)/.*", R=0.5, scope="group"),
        ParamGroup("trunk", ".*", R=1.0, scope="flat"),
    ), mode="bk-mixopt")
