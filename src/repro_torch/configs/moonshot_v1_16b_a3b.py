"""moonshot-v1-16b-a3b [moe] — hf:moonshotai/Moonlight-16B-A3B (kimi).
48L (assignment spec), d=2048, 16H kv=16, expert d_ff=1408, 64 routed top-6
+ 2 shared, vocab=163840."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register
def moonshot_v1_16b_a3b() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=11264, vocab=163840,
        n_experts=64, top_k=6, n_shared=2, moe_d_ff=1408, first_k_dense=1,
        capacity_factor=1.25, renorm_topk=True, rope_theta=50000.0,
        norm="rmsnorm", act="swiglu", param_dtype="bfloat16", remat=True,
        attn_chunk=512)
