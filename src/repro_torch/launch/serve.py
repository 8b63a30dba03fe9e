"""Serving entry point: greedy autoregressive decode against the model's cache.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2-1.5b \
        --batch 4 --prompt-len 16 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-3b \
        --smoke --device cpu

Runs on the CUDA card by default; ``--device cpu`` runs the plain PyTorch
versions. Without a card the default raises instead of falling back.
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs.registry import (build, get_config, list_archs,
                                          smoke_config)
from repro_torch.launch.train import resolve_device


def generate(model, params, prompts, gen_len: int, cache_len: int = 0,
             return_logits: bool = False):
    """prompts (B, Tp) int -> (B, Tp+gen) greedy continuation. The prompt is
    teacher-forced through ``decode_step`` (exercising the cache), then each
    token is the argmax of the last logits. ``return_logits``: also the
    logits of every step, (B, Tp+gen, V) f32 (step i's predict token i+1)."""
    B, Tp = prompts.shape
    S = cache_len or (Tp + gen_len)
    cache = model.init_cache(B, S, device=prompts.device)
    steps = []
    last = None
    for i in range(Tp):
        last, cache = model.decode_step(params, cache, prompts[:, i], i)
        steps.append(last)
    out = [prompts]
    nxt = torch.argmax(last, dim=-1).to(prompts.dtype)
    for i in range(Tp, Tp + gen_len):
        out.append(nxt[:, None])
        last, cache = model.decode_step(params, cache, nxt, i)
        steps.append(last)
        nxt = torch.argmax(last, dim=-1).to(prompts.dtype)
    tokens = torch.cat(out, dim=1)
    if return_logits:
        return tokens, torch.stack(steps, dim=1).float()
    return tokens


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", choices=list_archs(), default="qwen2-1.5b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build(cfg)
    params = model.init(args.seed, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=gen, device=dev, dtype=torch.int32)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, args.gen)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    toks = args.batch * (args.prompt_len + args.gen)
    print(f"{cfg.name} on {dev}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({toks / dt:.1f} tok/s)")
    print(out[0].tolist())
    return out


if __name__ == "__main__":
    main()
