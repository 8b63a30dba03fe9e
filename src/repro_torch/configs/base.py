"""Model / training configuration dataclasses (the subset the port runs).

Field names and defaults follow ``repro.configs.base`` so a config reads the
same in both packages. The port's dense model is the qwen2 / llama block
(RMSNorm, SwiGLU, rope, GQA); activations follow ``param_dtype``."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # only the dense decoder is ported
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 128
    vocab: int = 256
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    rope_theta: float = 10000.0
    attn_chunk: int = 0          # q-chunked attention block (0 = full)
    param_dtype: str = "float32"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def with_(self, **kw) -> "ModelConfig":
        return replace(self, **kw)


@dataclass(frozen=True)
class TrainConfig:
    global_batch: int = 8
    microbatch: int = 0          # physical batch per step (0 = global)
    seq_len: int = 128
    steps: int = 10
    lr: float = 1e-3
    lr_schedule: str = "cosine"
    optimizer: str = "adamw"
    weight_decay: float = 0.0
    warmup: int = 0
    seed: int = 0
