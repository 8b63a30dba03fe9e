"""Model / training configuration dataclasses (the subset the port runs).

Field names and defaults follow ``repro.configs.base`` so a config reads the
same in both packages. The port's transformer block is the qwen2 / qwen2.5
/ qwen3 / llama3 block (RMSNorm, SwiGLU, rope, GQA, optional QKV bias and
qk-norm), with a DeepSeekMoE feed-forward in the ``moe`` family
(deepseek-moe, moonshot); the ``ssm`` family is RWKV6 (``models.rwkv6``,
layernorm and its squared-ReLU channel mix); the ``hybrid`` family is Hymba
(``models.hymba``: attention and Mamba-style SSM heads side by side,
sliding-window layers, meta tokens); the ``encdec`` family is Whisper
(``models.whisper``: a bidirectional encoder over frame embeddings, a
decoder with causal self-attention and cross-attention, LayerNorm + GELU);
the ``vlm`` family is InternVL2 (the transformer with ``patch_tokens``
precomputed ViT patch embeddings of width ``vit_dim`` projected by a tapped
linear and put before the tokens). Activations follow ``param_dtype``.
``remat`` recomputes each block of the transformer's, rwkv6's and hymba's
stacks in the backward (``core.tape.Tape.block``), where the reference
wraps its scanned blocks in ``jax.checkpoint``."""
from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"        # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int = 2
    d_model: int = 64
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 128
    vocab: int = 256
    head_dim: int = 0            # 0 -> d_model // n_heads
    qkv_bias: bool = False
    qk_norm: bool = False        # RMSNorm over each q and k head (qwen3)
    norm: str = "rmsnorm"        # rmsnorm (transformer) | layernorm (rwkv6,
                                 # whisper)
    act: str = "swiglu"          # swiglu (transformer) | relu_sq (rwkv6) |
                                 # gelu (whisper)
    rope_theta: float = 10000.0
    attn_chunk: int = 0          # q-chunked attention block (0 = full)
    # recompute each block of a stacked loop in the backward instead of
    # keeping its saved tensors (the reference's jax.checkpoint per scanned
    # block); whisper's blocks ignore it, as the reference's do
    remat: bool = False
    param_dtype: str = "float32"

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared: int = 0
    moe_d_ff: int = 0
    first_k_dense: int = 0       # leading dense-FFN layers (DeepSeekMoE style)
    capacity_factor: float = 2.0
    renorm_topk: bool = True

    # SSM / hybrid
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_chunk: int = 32          # wkv / ssm chunked-scan length
    window: int = 0              # sliding window for local attn layers
    full_attn_layers: tuple = () # hybrid: layer indices with global attention
    meta_tokens: int = 0         # Hymba learnable prefix tokens

    # enc-dec (whisper)
    encoder_layers: int = 0
    decoder_len: int = 448
    frame_dim: int = 0           # stub frontend embedding dim (0 -> d_model)

    # vlm (internvl2): precomputed patch embeddings, projected and prefixed
    patch_tokens: int = 0
    vit_dim: int = 0

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
    # DP-FTRL (optimizer="ftrl"): momentum over noisy gradient prefixes,
    # epoch restarts every N steps (0 = never; also drives the tree-noise
    # mechanism's restarts), and Honaker tree completion at each restart
    ftrl_momentum: float = 0.0
    restart_every: int = 0
    tree_completion: bool = False
    seed: int = 0
    # loss log + device->host flush period in steps: the loop keeps losses
    # on the device and drains them every log_every steps (and at exit)
    log_every: int = 10
    # checkpoint every N steps into checkpoint_dir ("" or N = 0: none; a
    # SIGTERM or a stall still forces one where a dir is set), keeping the
    # newest keep_checkpoints
    checkpoint_every: int = 0
    checkpoint_dir: str = ""
    keep_checkpoints: int = 3
    # tape residency override (core.tape.TAPE_POLICIES): "" keeps whatever
    # the DPConfig / policy preset configured; tape_chunks 0 likewise
    tape: str = ""
    tape_chunks: int = 0
    # "" keeps the policy's scopes; flat | group | layer re-scopes every
    # trainable group (core.policy.with_scope)
    clipping_scope: str = ""
    # the reference's measured kernel autotune at startup: "auto" (on the
    # card), "on" or "off". A stated no-op here: the port's kernels take
    # their tiles and grids from the card's occupancy at launch, so the
    # driver logs that 0 cells are tuned (launch.train.AUTOTUNE_NOTE)
    autotune: str = "auto"


@dataclass(frozen=True)
class ShapeConfig:
    """One input shape of the dry-run grid (``launch.steps.plan_cell``):
    sequence length, global batch, and the step it feeds."""
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


# the JAX package's grid, cell for cell
SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
