"""internvl2-26b [vlm] — arXiv:2404.16821. InternLM2-20B backbone: 48L,
d=6144, 48H GQA kv=8, d_ff=16384, vocab=92553. InternViT frontend is a STUB
(precomputed patch embeddings, vit_dim=3200, projected by a tapped linear)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register
def internvl2_26b() -> ModelConfig:
    return ModelConfig(
        name="internvl2-26b", family="vlm", n_layers=48, d_model=6144,
        n_heads=48, n_kv_heads=8, head_dim=128, d_ff=16384, vocab=92553,
        patch_tokens=1024, vit_dim=3200,
        rope_theta=1000000.0, norm="rmsnorm", act="swiglu",
        param_dtype="bfloat16", remat=True, attn_chunk=512)
