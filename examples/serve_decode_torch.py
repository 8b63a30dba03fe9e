"""Batched serving on the PyTorch/CUDA port: greedy autoregressive decode
against a KV cache (the recurrent state for rwkv6), on a reduced config of
any zoo architecture. Runs on the card by default.

    PYTHONPATH=src python examples/serve_decode_torch.py [arch] \
        [--device cpu]
"""
import argparse

import torch

from repro_torch.configs.registry import build, list_archs, smoke_config
from repro_torch.launch.serve import generate
from repro_torch.launch.train import resolve_device


def main(argv=None) -> torch.Tensor:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("arch", nargs="?", default="hymba-1.5b",
                    choices=list_archs())
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = smoke_config(args.arch).with_(param_dtype="float32")
    model = build(cfg)
    params = model.init(0, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (4, 4), generator=gen, device=dev,
                            dtype=torch.int32)
    out = generate(model, params, prompts, gen_len=8)
    assert out.shape == (4, 12)
    assert bool(torch.all((out >= 0) & (out < cfg.vocab)))
    print(f"{args.arch}: generated {tuple(out.shape)} on {dev}")
    print(out.cpu())
    return out


if __name__ == "__main__":
    main()
