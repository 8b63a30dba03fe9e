"""Quickstart on the PyTorch/CUDA port: the paper's Sec. 4 usage pattern.

Swap a standard training step for its DP version by choosing a
clipping mode: same optimizer, same accuracy semantics, BK cost profile.
Runs on the card by default (the hand-written kernels); ``--device cpu``
runs their plain PyTorch versions.

    PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.registry import build, smoke_config
from repro_torch.core.bk import DPConfig
from repro_torch.core.engine import PrivacyEngine
from repro_torch.core.noise import fold_in, prng_key
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.train import resolve_device
from repro_torch.optim.optimizers import make_optimizer


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--steps", type=int, default=5)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. a model from the zoo (reduced config so this runs in seconds)
    cfg = smoke_config("qwen2-1.5b").with_(param_dtype="float32")
    model = build(cfg)
    params = model.init(0, dev)

    # 2. a PrivacyEngine: pick the implementation ('bk-mixopt' = the
    #    paper's hybrid BK) and the privacy budget; sigma is calibrated by
    #    the RDP accountant
    engine = PrivacyEngine(
        model.apply, DPConfig(mode="bk-mixopt", clipping="automatic", R=1.0),
        batch_size=16, dataset_size=50_000, epochs=3, target_epsilon=3.0)
    print(f"accountant: sigma={engine.cfg.sigma:.3f} -> "
          f"eps={engine.budget.epsilon:.2f} at delta={engine.budget.delta}")

    # 3. the usual training loop: engine.grad is a drop-in for the gradient
    opt = make_optimizer("adamw", lambda step: 1e-3)
    opt_state = opt.init(params)
    losses = []
    for step in range(args.steps):
        batch = make_batch(cfg, 16, 32, seed=0, step=step, device=dev)
        grads, aux = engine.grad(params, batch, fold_in(prng_key(1), step),
                                 step)
        params, opt_state = opt.update(grads, opt_state, params, step)
        losses.append(float(aux["loss"]))
        print(f"step {step}: private loss {losses[-1]:.4f}")
    assert all(torch.isfinite(torch.tensor(losses)))
    print("OK — differentially private training with Book-Keeping.")
    return losses


if __name__ == "__main__":
    main()
