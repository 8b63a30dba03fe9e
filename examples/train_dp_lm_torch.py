"""End-to-end driver on the PyTorch/CUDA port: DP-train a ~100M-param
GPT2-class LM with checkpoint/restart, gradient accumulation and the RDP
accountant, through ``launch.train.train``. Runs on the card by default.

Full run (one H100):
    PYTHONPATH=src python examples/train_dp_lm_torch.py
Smoke run (add ``--device cpu`` off the card):
    PYTHONPATH=src python examples/train_dp_lm_torch.py --smoke
DP-FTRL instead of DP-SGD-style AdamW (tree-aggregation noise, epoch
restarts with Honaker completion):
    PYTHONPATH=src python examples/train_dp_lm_torch.py --smoke --ftrl
"""
import argparse
import dataclasses
import os
import tempfile

from repro_torch.configs.base import ModelConfig, TrainConfig
from repro_torch.core.bk import DPConfig
from repro_torch.launch.train import train


def gpt2_100m() -> ModelConfig:
    # ~104M params: 12L, d=768, vocab=50257 — GPT2-small class
    return ModelConfig(name="gpt2-100m", family="dense", n_layers=12,
                       d_model=768, n_heads=12, n_kv_heads=12, head_dim=64,
                       d_ff=3072, vocab=50257, norm="layernorm", act="gelu",
                       param_dtype="bfloat16")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=0)
    ap.add_argument("--ftrl", action="store_true",
                    help="momentum DP-FTRL + tree-aggregation noise with "
                         "epoch restarts and Honaker completion")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ckpt-dir", default="",
                    help="checkpoints (default: a fresh temporary folder)")
    args = ap.parse_args(argv)
    ckpt = args.ckpt_dir or tempfile.mkdtemp(prefix="dp_lm_")

    if args.smoke:
        cfg = gpt2_100m().with_(n_layers=2, d_model=64, n_heads=4,
                                n_kv_heads=4, head_dim=16, d_ff=128,
                                vocab=512, param_dtype="float32")
        tc = TrainConfig(global_batch=8, microbatch=4, seq_len=32,
                         steps=args.steps or 20, lr=1e-3, log_every=5,
                         checkpoint_dir=ckpt, checkpoint_every=10)
    else:
        cfg = gpt2_100m()
        tc = TrainConfig(global_batch=64, microbatch=16, seq_len=256,
                         steps=args.steps or 300, lr=3e-4, warmup=20,
                         checkpoint_dir=ckpt, checkpoint_every=50)
    if args.ftrl:
        # restart the tree (and the FTRL anchor) every ~quarter of the run;
        # train() switches the noise mechanism to 'tree' itself
        tc = dataclasses.replace(tc, optimizer="ftrl", ftrl_momentum=0.9,
                                 restart_every=max(2, tc.steps // 4),
                                 tree_completion=True, weight_decay=0.0,
                                 lr_schedule="constant", warmup=0)

    dp = DPConfig(mode="bk-mixopt", clipping="automatic", R=1.0)
    _, losses = train(cfg, tc, dp, device=args.device, dataset_size=100_000,
                      target_epsilon=3.0)
    assert losses[-1] < losses[0], "loss should decrease under DP training"
    print(f"done: loss {losses[0]:.3f} -> {losses[-1]:.3f} over "
          f"{len(losses)} steps (eps<=3.0); checkpoints in "
          f"{os.path.abspath(ckpt)}")
    return losses


if __name__ == "__main__":
    main()
