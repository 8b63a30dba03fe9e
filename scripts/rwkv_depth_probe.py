"""Peak device memory of rwkv6-3b's DP step at full width, by depth: how
many of its 32 layers one card holds under chip_smoke.py's ``train_rwkv``
settings (bk-mixopt, automatic clipping, sigma 1.0, AdamW, B=8, T=512, bf16).

    PYTHONPATH=src python3 scripts/rwkv_depth_probe.py 2 4 8

Each depth trains 2 steps through ``repro_torch.launch.train.train`` on the
card and prints one JSON line: its layers, parameters, peak
``max_memory_allocated`` and step seconds, beside the card's name and power
limit. Peaks grow linearly in depth, so two depths give the per-layer cost.
"""
import json
import subprocess
import sys
import time

import torch

from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import get_config
from repro_torch.core.bk import DPConfig
from repro_torch.launch.train import train


def main(depths):
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    for layers in depths:
        cfg = get_config("rwkv6-3b").with_(n_layers=layers)
        tc = TrainConfig(global_batch=8, seq_len=512, steps=2, lr=3e-4)
        dp = DPConfig(mode="bk-mixopt", clipping="automatic", sigma=1.0)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        seconds = []
        t0 = time.perf_counter()
        params, losses = train(cfg, tc, dp, device="cuda",
                               log=lambda m: None,
                               on_step=lambda s, loss, sec:
                               seconds.append(sec))
        torch.cuda.synchronize()
        print(json.dumps({
            "layers": layers, "card": card,
            "params": sum(p.numel() for p in _leaves(params)),
            "peak_bytes": torch.cuda.max_memory_allocated(),
            "step_seconds": seconds, "losses": losses,
            "wall_seconds": time.perf_counter() - t0}), flush=True)
        del params


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


if __name__ == "__main__":
    main([int(a) for a in sys.argv[1:]] or [2, 4])
