"""Peak device memory and step seconds of a DP step at full width, by
depth: how many layers of a config one card holds under chip_smoke.py's
train settings (the arch's registered policy or a flat DPConfig,
bk-mixopt, automatic clipping, sigma 1.0).

    PYTHONPATH=src python3 scripts/depth_probe.py rwkv6-3b:32 \
        qwen3-14b:10:8:512:adamw llama3-405b:1:4:512:sgd \
        qwen2-1.5b:28:8:512:adamw:noremat qwen2-1.5b:28:8:512:adamw:tensors

A case is ``arch:layers[:batch[:seq[:optimizer[:variant]]]]`` (defaults 8,
512, adamw); ``layers`` 0 keeps the config's depth. ``variant``:
``remat`` (the config as registered: every registered config remats),
``noremat`` (``remat=False``), or ``tensors`` (remat, each tap's output
tensor its differentiation target in place of its autograd edge, as the
tape held them before: alive until phase 1 ends; equal params say the
edges' grads are bitwise the tensors'). Each case trains 2 steps through
``repro_torch.launch.train.train`` on the card and prints one JSON line:
its layers, parameters, peak ``max_memory_allocated``, step seconds,
losses and ``params_sha256``, beside the card's name and power limit; a
case that runs out of device memory prints ``"oom": true``.
"""
import gc
import json
import subprocess
import sys
import time

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import cut_depth, get_config
from repro_torch.core import tape
from repro_torch.launch.train import resolve_dp, train


def _tensor_targets():
    """Make each tap's output tensor its target (``autograd.grad`` takes a
    tensor where it takes an edge) -> undo."""
    edge = tape.get_gradient_edge
    tape.get_gradient_edge = lambda s: s

    def undo():
        tape.get_gradient_edge = edge
    return undo


def run_case(spec: str, card: str) -> dict:
    parts = spec.split(":")
    arch, layers = parts[0], int(parts[1])
    B = int(parts[2]) if len(parts) > 2 else 8
    T = int(parts[3]) if len(parts) > 3 else 512
    opt = parts[4] if len(parts) > 4 else "adamw"
    variant = parts[5] if len(parts) > 5 else "remat"
    cfg = cut_depth(get_config(arch), layers)
    if variant == "noremat":
        cfg = cfg.with_(remat=False)
    tc = TrainConfig(global_batch=B, seq_len=T, steps=2, lr=3e-4,
                     optimizer=opt)
    dp = resolve_dp(arch, "auto", "bk-mixopt", "automatic", 1.0,
                    log=lambda m: None)
    undo = _tensor_targets() if variant == "tensors" else (lambda: None)
    out = {"case": spec, "arch": arch, "layers": cfg.n_layers, "batch": B,
           "seq": T, "optimizer": opt, "variant": variant, "card": card}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    seconds, summary = [], {}
    t0 = time.perf_counter()
    try:
        params, losses = train(cfg, tc, dp, device="cuda",
                               log=lambda m: None, summary_out=summary,
                               on_step=lambda s, loss, sec:
                               seconds.append(sec))
        torch.cuda.synchronize()
        out.update(params=sum(p.numel() for p in _leaves(params)),
                   losses=losses, params_sha256=summary["params_sha256"])
        del params
    except torch.cuda.OutOfMemoryError as e:
        out.update(oom=True, error=str(e).splitlines()[0][:200])
    finally:
        undo()
    out.update(peak_bytes=torch.cuda.max_memory_allocated(),
               step_seconds=seconds,
               wall_seconds=time.perf_counter() - t0)
    return out


def main(specs):
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for spec in specs:
        print(json.dumps(run_case(spec, card)), flush=True)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


if __name__ == "__main__":
    main(sys.argv[1:] or ["rwkv6-3b:2", "rwkv6-3b:4"])
