"""deepseek-moe-16b [moe] — arXiv:2401.06066. 28L, d=2048, 16H kv=16,
expert d_ff=1408, 64 routed top-6 + 2 shared, first layer dense,
vocab=102400."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register, register_policy
from repro_torch.core.policy import ParamGroup, PrivacyPolicy


@register
def deepseek_moe_16b() -> ModelConfig:
    return ModelConfig(
        name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=10944, vocab=102400,
        n_experts=64, top_k=6, n_shared=2, moe_d_ff=1408, first_k_dense=1,
        capacity_factor=1.25, renorm_topk=False, rope_theta=10000.0,
        param_dtype="bfloat16", attn_chunk=512)


@register_policy("deepseek-moe-16b")
def deepseek_moe_16b_policy() -> PrivacyPolicy:
    """Routed expert weights, the router and the dense trunk (attention,
    shared experts, embeddings) are three clipping units with their own R;
    sensitivity sqrt(0.5^2 + 0.25^2 + 1^2)."""
    return PrivacyPolicy(groups=(
        ParamGroup("experts", r".*/experts/.*", R=0.5, scope="group"),
        ParamGroup("router", r".*/router/.*", R=0.25, scope="group"),
        ParamGroup("dense", ".*", R=1.0, scope="group"),
    ), mode="bk-mixopt")
