"""DP training driver: synthetic batches -> BK clipped sum -> noise +
optimizer, one step at a time, printing the loss of every step.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        --steps 3 --batch 8 --seq 512 --sigma 1.0
    PYTHONPATH=src python -m repro_torch.launch.train \
        --arch deepseek-moe-16b --smoke --device cpu --steps 2
    PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \
        --steps 2 --clipping-scope layer --tape recompute

Runs on the CUDA card by default; ``--device cpu`` runs the same engine with
the kernels' plain PyTorch versions (tests, small configs). Without a card
the default raises instead of falling back to the CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import (build, get_config, get_policy,
                                          has_policy, list_archs,
                                          list_policies, smoke_config)
from repro_torch.core.bk import DPConfig
from repro_torch.core.policy import with_scope
from repro_torch.core.tape import TAPE_POLICIES
from repro_torch.data.synthetic import make_batch
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import make_schedule


def resolve_device(device) -> torch.device:
    """The device an entry point runs on; 'cuda' without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available: the port runs on the card by "
            "default; pass --device cpu (device='cpu') to run the plain "
            "PyTorch versions on the CPU")
    return dev


def resolve_dp(arch: str, policy_name: str, mode: str, clipping: str,
               sigma: float, log=print):
    """--policy/--mode/--clipping/--sigma -> DPConfig or PrivacyPolicy."""
    if policy_name == "auto":
        policy_name = arch if has_policy(arch) else ""
    if not policy_name:
        return DPConfig(mode=mode, clipping=clipping, sigma=sigma)
    dp = get_policy(policy_name, mode=mode, sigma=sigma)
    if clipping != "automatic":
        log(f"note: --clipping {clipping} is IGNORED — the policy preset "
            f"{policy_name!r} defines clipping per group (pass --policy '' "
            "for a flat DPConfig)")
    log(f"policy preset {policy_name!r}: "
        + ", ".join(f"{g.name}({g.scope}{'' if g.trainable else ',frozen'}"
                    f" R={g.R})" for g in dp.groups))
    return dp


def train_policy(dp, tc: TrainConfig):
    """``dp`` with the TrainConfig's overrides, as :func:`train` runs it:
    ``tc.tape`` / ``tc.tape_chunks`` replace the tape residency when set,
    and ``tc.clipping_scope`` re-scopes every trainable group
    (``with_scope``; 'layer' makes each param path its own clip unit, and
    the BK backward streams)."""
    if tc.tape or tc.tape_chunks:
        dp = dataclasses.replace(
            dp, **({"tape_policy": tc.tape} if tc.tape else {}),
            **({"tape_chunks": tc.tape_chunks} if tc.tape_chunks else {}))
    return with_scope(dp, tc.clipping_scope) if tc.clipping_scope else dp


def train(model_cfg, tc: TrainConfig, dp, device="cuda", log=print,
          on_step=None):
    """Run ``tc.steps`` DP steps from a random init (seed ``tc.seed``)
    under ``train_policy(dp, tc)``. ``on_step(step, loss, seconds)`` is
    called after every step; the time covers the step up to its loss on the
    host. -> (params, losses)."""
    dev = resolve_device(device)
    dp = train_policy(dp, tc)
    model = build(model_cfg)
    opt = make_optimizer(tc.optimizer,
                         make_schedule(tc.lr_schedule, tc.lr, tc.warmup,
                                       tc.steps),
                         weight_decay=tc.weight_decay)
    params = model.init(tc.seed, dev)
    state = TrainState(params, opt.init(params), 0, tc.seed + 1)
    step_fn = make_train_step(model.apply, params, opt, dp, tc.microbatch)
    losses = []
    for step in range(tc.steps):
        batch = make_batch(model_cfg, tc.global_batch, tc.seq_len, tc.seed,
                           step, dev)
        t0 = time.perf_counter()
        state, loss = step_fn(state, batch)
        loss = float(loss)          # waits for the device
        dt = time.perf_counter() - t0
        losses.append(loss)
        log(f"step {step:5d} loss {loss:.4f} ({dt:.3f}s)")
        if on_step is not None:
            on_step(step, loss, dt)
    return state.params, losses


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config, float32")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--mode", default="bk-mixopt",
                    choices=["bk", "bk-mixghost", "bk-mixopt"])
    ap.add_argument("--clipping", default="automatic")
    ap.add_argument("--sigma", type=float, default=0.0)
    ap.add_argument("--policy", default="auto",
                    help="PrivacyPolicy preset name; 'auto' = the arch's "
                         f"registered preset (known: {list_policies()}), "
                         "'' = flat DPConfig")
    ap.add_argument("--tape", default="", choices=("",) + TAPE_POLICIES,
                    help="tape residency of the book-kept tap state between "
                         "BK phases 2-3: hold native, compressed (bf16, "
                         "int8), re-derive in phase 3 (recompute), or let "
                         "the planner pick per tap (auto); '' keeps the "
                         "policy's")
    ap.add_argument("--tape-chunks", type=int, default=0,
                    help="phase-3 re-derivation chunks of the recompute "
                         "taps of one clip unit (0 keeps the policy's)")
    ap.add_argument("--clipping-scope", default="",
                    choices=["", "flat", "group", "layer"],
                    help="re-scope every trainable group's clipping norm: "
                         "flat (one pool), group (per policy group), layer "
                         "(each param path its own clip unit, streamed); "
                         "'' keeps the policy's scopes")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    mc = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        mc = mc.with_(param_dtype="float32")
    tc = TrainConfig(global_batch=args.batch, microbatch=args.microbatch,
                     seq_len=args.seq, steps=args.steps, lr=args.lr,
                     optimizer=args.optimizer, seed=args.seed,
                     tape=args.tape, tape_chunks=args.tape_chunks,
                     clipping_scope=args.clipping_scope)
    dp = resolve_dp(args.arch, args.policy, args.mode, args.clipping,
                    args.sigma)
    return train(mc, tc, dp, device=args.device)


if __name__ == "__main__":
    main()
