"""whisper-small [audio] — arXiv:2212.04356. 12L enc + 12L dec, d=768,
12H (MHA), d_ff=3072, vocab=51865, LayerNorm+GELU, conv frontend STUBBED
(precomputed frame embeddings, frame_dim=80-mel x stride stub = 768)."""
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import register


@register
def whisper_small() -> ModelConfig:
    return ModelConfig(
        name="whisper-small", family="encdec", n_layers=12, d_model=768,
        n_heads=12, n_kv_heads=12, head_dim=64, d_ff=3072, vocab=51865,
        encoder_layers=12, decoder_len=448, frame_dim=768,
        norm="layernorm", act="gelu", param_dtype="bfloat16", attn_chunk=512,
        remat=True)
