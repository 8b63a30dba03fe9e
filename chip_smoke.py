#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py                      # every phase, one card

Phases, each printing one JSON line:

  card     the card's name and power limit (nvidia-smi), torch and CUDA
  build    compile the kernel library from ``src/repro_torch/kernels/csrc``
  kernels  each of the four kernels against its plain PyTorch version on the
           card: at the main path's full-width shapes (qwen2-1.5b, B=8,
           T=512, bf16) and at one ragged f32 shape; times with CUDA events
  train    3 steps of the full qwen2-1.5b config (28 layers, bf16) under its
           policy preset: bk-mixopt, sigma=1.0, AdamW, B=8, T=512, through
           ``repro_torch.launch.train.train``; launch counts per step; the
           last step runs under torch.profiler (device time by kernel)
  parity   one BK step of a 2-layer, full-width, f32 model with the kernels
           and with ``use_kernels=False``: clipped sums and per-sample norms

Then a ``kernels`` summary line and, last, the ``ok`` line. Any failed check
raises, and the script exits non-zero without the ``ok`` line. It needs a
CUDA card and the ``src/repro_torch`` package beside it. It imports nothing
of JAX and nothing of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ("card", "build", "kernels", "train", "parity")

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and operations/s by type
PEAK_BYTES = 3.35e12
PEAK_OPS = {"bfloat16": 989e12, "float32": 67e12}
# kernel-vs-plain tolerances: f32 as tests/test_kernel_parity.py:15; bf16 as
# its :18 (the plain clipped grads round C to bf16 like the JAX reference)
TOL = {"float32": (1e-3, 1e-4), "bfloat16": (5e-2, 2e-2)}
TRAIN = dict(batch=8, seq=512, steps=3, sigma=1.0)
# each kernel's launches per train step at qwen2-1.5b: 5 mm taps, 1 emb tap
PER_STEP = {"ghost_norm": 5, "clipped_grad": 5, "emb_ghost_norm": 1,
            "emb_clipped_grad": 1}
SOURCES = {
    "ghost_norm": ("src/repro_torch/kernels/csrc/ghost_norm.cu",
                   "src/repro/kernels/ghost_norm.py:62"),
    "clipped_grad": ("src/repro_torch/kernels/csrc/clipped_grad.cu",
                     "src/repro/kernels/clipped_grad.py:39"),
    "emb_ghost_norm": ("src/repro_torch/kernels/csrc/emb_norm.cu",
                       "src/repro/kernels/emb_norm.py:50"),
    "emb_clipped_grad": ("src/repro_torch/kernels/csrc/emb_grad.cu",
                         "src/repro/kernels/emb_grad.py:50"),
}


def emit(**obj):
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of ``fn`` over ``reps`` runs, by CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return statistics.median(times)


def compare(got, want, dtype_name: str) -> dict:
    """Max abs / rel error of got vs want, and the allclose verdict."""
    import torch
    rtol, atol = TOL[dtype_name]
    g, w = got.reshape(-1), want.reshape(-1)
    max_abs, max_rel, ok, n = 0.0, 0.0, True, 1 << 26
    for i in range(0, g.numel(), n):     # in slices: outputs reach 3 GB
        gi, wi = g[i:i + n].double(), w[i:i + n].double()
        if not torch.isfinite(gi).all():
            raise AssertionError("kernel output is not finite")
        diff = (gi - wi).abs()
        max_abs = max(max_abs, float(diff.max()))
        max_rel = max(max_rel,
                      float((diff / wi.abs().clamp_min(1e-30)).max()))
        ok = ok and bool((diff <= atol + rtol * wi.abs()).all())
    return {"max_abs_err": max_abs, "max_rel_err": max_rel,
            "rtol": rtol, "atol": atol, "ok": ok}


def bound(nbytes: float, ops: float, dtype_name: str):
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS[dtype_name] * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- phases
def phase_card():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    line = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    print(line, flush=True)
    emit(phase="card", nvidia_smi=line, torch=torch.__version__,
         cuda=torch.version.cuda, device=torch.cuda.get_device_name(0),
         count=torch.cuda.device_count())
    return line


def phase_build():
    from repro_torch.kernels import build
    info = build.build()
    regs = [ln.strip() for ln in info["ptxas"].splitlines()
            if "registers" in ln or "spill" in ln]
    emit(phase="build", seconds=info["seconds"], cached=info["cached"],
         library=str(Path(info["path"]).relative_to(ROOT)), ptxas=regs)
    build.load()


def _mm_taps(cfg):
    """(name, L, d, p) of the main path's matmul taps."""
    H, K, h, d = cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.d_model
    L = cfg.n_layers
    return [("qkv", L, d, (H + 2 * K) * h), ("o", L, H * h, d),
            ("up", L, d, 2 * cfg.d_ff), ("down", L, cfg.d_ff, d),
            ("head", 1, d, cfg.vocab)]


def _match_pairs(ids):
    """Id-equal pairs (t' <= t) per (l, b) row, summed: the dots that the
    embedding norm needs for these ids."""
    import torch
    ids = ids.reshape(-1, ids.shape[-1])
    eq = ids[:, :, None] == ids[:, None, :]
    return int(torch.tril(eq).sum())


def phase_kernels(cfg):
    """Each kernel vs its plain version on the card -> per-kernel summary."""
    import torch
    from repro_torch.data.synthetic import make_batch
    from repro_torch.kernels import clipped_grad as cg
    from repro_torch.kernels import emb_grad as eg
    from repro_torch.kernels import emb_norm as en
    from repro_torch.kernels import ghost_norm as gn

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    B, T = TRAIN["batch"], TRAIN["seq"]
    summary = {k: dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=None,
                       max_abs_err=0.0, t_bytes=0.0, t_ops=0.0)
               for k in SOURCES}

    def rnd(*shape, dtype=torch.bfloat16):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    def record(name, case, got, want, dtype_name, ms_k, ms_p, nbytes, ops,
               ms_lib=None, main=True):
        cmp = compare(got, want, dtype_name)
        b_ms, b_by = bound(nbytes, ops, dtype_name)
        emit(phase="kernels", kernel=name, case=case, **cmp, kernel_ms=ms_k,
             plain_ms=ms_p, library_ms=ms_lib, bound_ms=b_ms, bound_by=b_by,
             bytes=nbytes, ops=ops)
        if not cmp["ok"]:
            raise AssertionError(f"{name} [{case}] disagrees with its plain "
                                 f"version: {cmp}")
        if main:
            s = summary[name]
            s["ms"] += ms_k
            s["plain_ms"] += ms_p
            s["bound_ms"] += b_ms
            s["t_bytes" if b_by == "bytes" else "t_ops"] += b_ms
            s["max_abs_err"] = max(s["max_abs_err"], cmp["max_abs_err"])
            if ms_lib is not None:
                s["library_ms"] = (s["library_ms"] or 0.0) + ms_lib

    def mm_case(case, L, Bc, Tc, d, p, dtype, main=True):
        dname = str(dtype).split(".")[-1]
        a, ds = rnd(L, Bc, Tc, d, dtype=dtype), rnd(L, Bc, Tc, p, dtype=dtype)
        # clip factors the record dtype holds exactly: the plain version
        # rounds C to it (as the JAX reference does), the kernel keeps f32
        C = (torch.rand(Bc, generator=gen, device=dev) + 0.1).to(dtype).float()
        esz = a.element_size()
        # ghost_norm
        got = gn.ghost_norm(a, ds)
        want = gn.plain(a, ds)
        ms_k = cuda_ms(lambda: gn.ghost_norm(a, ds))
        ms_p = cuda_ms(lambda: gn.plain(a, ds), reps=3, warmup=1)
        record("ghost_norm", case, got, want, dname, ms_k, ms_p,
               (a.numel() + ds.numel()) * esz + Bc * 4,
               2.0 * (d + p) * L * Bc * Tc * (Tc + 1) / 2, main=main)
        # clipped_grad
        got = cg.clipped_grad(a, C, ds)
        want = cg.plain(a, C, ds)
        ms_k = cuda_ms(lambda: cg.clipped_grad(a, C, ds), reps=5, warmup=1)
        ms_p = cuda_ms(lambda: cg.plain(a, C, ds), reps=3, warmup=1)
        ms_lib = cuda_ms(lambda: torch.einsum("lbtd,b,lbtp->ldp", a,
                                              C.to(dtype), ds))
        record("clipped_grad", case, got, want, dname, ms_k, ms_p,
               (a.numel() + ds.numel()) * esz + Bc * 4 + L * d * p * 4,
               2.0 * L * Bc * Tc * d * p, ms_lib, main=main)
        del a, ds, got, want
        torch.cuda.empty_cache()

    def emb_case(case, ids, d, V, dtype, main=True):
        dname = str(dtype).split(".")[-1]
        L, Bc, Tc = (ids if ids.dim() == 3 else ids[None]).shape
        ds = rnd(*ids.shape, d, dtype=dtype)
        C = torch.rand(Bc, generator=gen, device=dev) + 0.1
        esz = ds.element_size()
        got = en.emb_ghost_norm(ids, ds)
        want = en.plain(ids, ds)
        ms_k = cuda_ms(lambda: en.emb_ghost_norm(ids, ds))
        ms_p = cuda_ms(lambda: en.plain(ids, ds), reps=3, warmup=1)
        record("emb_ghost_norm", case, got, want, dname, ms_k, ms_p,
               ids.numel() * 4 + ds.numel() * esz + Bc * 4,
               2.0 * d * _match_pairs(ids), main=main)
        got = eg.emb_clipped_grad(ids, C, ds, V)
        want = eg.plain(ids, C, ds, V)
        valid = ((ids >= 0) & (ids < V)).reshape(-1)
        flat = (ids.long() + torch.arange(L, device=dev)[:, None, None] * V
                ).reshape(-1)[valid]
        w = (ds.float() * C[:, None, None]).reshape(-1, d)[valid]

        def library():
            return torch.zeros(L * V, d, device=dev).index_add_(0, flat, w)

        ms_k = cuda_ms(lambda: eg.emb_clipped_grad(ids, C, ds, V))
        ms_p = cuda_ms(lambda: eg.plain(ids, C, ds, V), reps=3, warmup=1)
        ms_lib = cuda_ms(library)
        record("emb_clipped_grad", case, got, want, dname, ms_k, ms_p,
               ids.numel() * 4 + Bc * 4 + ds.numel() * esz + L * V * d * 4,
               2.0 * int(valid.sum()) * d, ms_lib, main=main)
        del ds, got, want, w
        torch.cuda.empty_cache()

    for name, L, d, p in _mm_taps(cfg):
        mm_case(f"{name} L={L} B={B} T={T} d={d} p={p} bf16", L, B, T, d, p,
                torch.bfloat16)
    tokens = make_batch(cfg, B, T, seed=0, step=0, device=dev)["tokens"]
    emb_case(f"embed B={B} T={T} d={cfg.d_model} V={cfg.vocab} bf16",
             tokens, cfg.d_model, cfg.vocab, torch.bfloat16)
    # ragged: T not a multiple of any tile, odd d / p / V, stacked, f32;
    # some ids outside [0, V) (dropped by both versions)
    mm_case("ragged L=3 B=3 T=509 d=37 p=53 f32", 3, 3, 509, 37, 53,
            torch.float32, main=False)
    ids = torch.randint(0, 1001, (3, 3, 509), generator=gen, device=dev,
                        dtype=torch.int32)
    ids[:, :, ::97] = -1
    ids[:, :, 5::101] = 1001 + 7
    emb_case("ragged L=3 B=3 T=509 d=37 V=1001 f32", ids, 37, 1001,
             torch.float32, main=False)
    return summary


def _profile_summary(prof, window_ms: float) -> dict:
    """Device time of one profiled step, by kernel and by kind."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            by_name[e.name] = by_name.get(e.name, 0.0) + us / 1e3
    ours = ("ghost_norm_kernel", "clipped_grad_kernel", "emb_norm_kernel",
            "emb_grad_kernel", "reduce_rows_kernel")
    kinds = {"port_kernels": 0.0, "gemm": 0.0, "other": 0.0}
    for name, ms in by_name.items():
        low = name.lower()
        kind = ("port_kernels" if any(k in name for k in ours) else
                "gemm" if any(k in low for k in ("gemm", "cutlass", "nvjet",
                                                 "sm90_", "cublas"))
                else "other")
        kinds[kind] += ms
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    return {"window_ms": window_ms, "device_busy_ms": busy,
            "idle_share": max(0.0, 1.0 - busy / window_ms),
            "by_kind_ms": kinds,
            "top_kernels_ms": [[n[:90], ms] for n, ms in top]}


def phase_train(cfg):
    """Full-depth steps through the train entry point; -> launch counts.
    The last step runs under torch.profiler."""
    import torch
    from repro_torch.configs.base import TrainConfig
    from repro_torch.kernels import clipped_grad as cg
    from repro_torch.kernels import emb_grad as eg
    from repro_torch.kernels import emb_norm as en
    from repro_torch.kernels import ghost_norm as gn
    from repro_torch.launch.train import resolve_dp, train

    wrappers = {"ghost_norm": gn.ghost_norm, "clipped_grad": cg.clipped_grad,
                "emb_ghost_norm": en.emb_ghost_norm,
                "emb_clipped_grad": eg.emb_clipped_grad}
    tc = TrainConfig(global_batch=TRAIN["batch"], seq_len=TRAIN["seq"],
                     steps=TRAIN["steps"], lr=3e-4, optimizer="adamw")
    dp = resolve_dp(cfg.name, "auto", "bk-mixopt", "automatic",
                    TRAIN["sigma"], log=lambda m: None)
    per_step, prof = [], {}

    def on_step(step, loss, seconds):
        counts = {k: w.launches for k, w in wrappers.items()}
        prev = per_step[-1]["total"] if per_step else dict.fromkeys(counts, 0)
        per_step.append({"step": step, "loss": loss, "seconds": seconds,
                         "launches": {k: counts[k] - prev[k] for k in counts},
                         "total": counts})
        if step == TRAIN["steps"] - 2:
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            prof["p"] = torch.profiler.profile(activities=acts)
            prof["p"].start()
            prof["t0"] = time.perf_counter()
        elif "p" in prof and step == TRAIN["steps"] - 1:
            torch.cuda.synchronize()
            prof["ms"] = (time.perf_counter() - prof["t0"]) * 1e3
            prof["p"].stop()

    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for w in wrappers.values():       # counts from here on are the path's
        w.launches = 0
    _, losses = train(cfg, tc, dp, device="cuda", log=lambda m: None,
                      on_step=on_step)
    torch.cuda.synchronize()
    totals = {k: w.launches for k, w in wrappers.items()}
    peak = torch.cuda.max_memory_allocated()
    for s in per_step:
        emit(phase="train", step=s["step"], loss=s["loss"],
             step_seconds=s["seconds"], launches=s["launches"])
    emit(phase="train", arch=cfg.name, layers=cfg.n_layers,
         d_model=cfg.d_model, vocab=cfg.vocab, dtype=cfg.param_dtype,
         mode="bk-mixopt", policy=cfg.name, optimizer="adamw", **TRAIN,
         losses=losses, max_memory_allocated=peak, launches=totals,
         grad_norm_direct="absent (not on this path, no kernel ported)")
    emit(phase="profile", step=TRAIN["steps"] - 1,
         **_profile_summary(prof["p"], prof["ms"]))
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss: {losses}")
    for s in per_step:
        for k, n in s["launches"].items():
            if n != PER_STEP[k]:
                raise AssertionError(f"step {s['step']}: {k} launched {n} "
                                     f"times, want {PER_STEP[k]}")
    return totals


def phase_parity(cfg):
    """One BK step with and without the kernels, 2 layers, full width, f32."""
    import torch
    from repro_torch.configs.registry import build, get_policy
    from repro_torch.core.bk import bk_clipped_sum
    from repro_torch.data.synthetic import make_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    small = cfg.with_(n_layers=2, param_dtype="float32")
    model = build(small)
    params = model.init(seed=1, device="cuda")
    batch = make_batch(small, TRAIN["batch"], TRAIN["seq"], seed=1,
                       device="cuda")
    rtol, atol = TOL["float32"]
    out = {}
    for use in (True, False):
        pol = get_policy(cfg.name, mode="bk-mixopt", use_kernels=use)
        sums, aux = bk_clipped_sum(model.apply, params, batch, pol)
        out[use] = (sums, aux)
        torch.cuda.synchronize()
    (sk, ak), (sp, ap) = out[True], out[False]
    worst, bad = 0.0, []
    pairs = [(f"sum:{k}", sk[k], sp[k]) for k in sorted(sk)]
    pairs.append(("per_sample_norms", ak["per_sample_norms"],
                  ap["per_sample_norms"]))
    pairs += [(f"group_norms:{k}", ak["group_norms"][k], ap["group_norms"][k])
              for k in ak["group_norms"]]
    for name, g, w in pairs:
        diff = (g.double() - w.double()).abs()
        worst = max(worst, float(diff.max()))
        if not bool((diff <= atol + rtol * w.double().abs()).all()):
            bad.append(name)
    emit(phase="parity", layers=2, d_model=small.d_model, vocab=small.vocab,
         dtype="float32", batch=TRAIN["batch"], seq=TRAIN["seq"],
         allow_tf32=torch.backends.cuda.matmul.allow_tf32,
         cudnn_allow_tf32=torch.backends.cudnn.allow_tf32, rtol=rtol,
         atol=atol, compared=len(pairs), max_abs_err=worst, failed=bad)
    if bad:
        raise AssertionError(f"kernel path disagrees with use_kernels=False "
                             f"on {bad}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help=f"comma-separated subset of {PHASES}")
    args = ap.parse_args(argv)
    phases = args.phases.split(",")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch").is_dir():
        print("chip_smoke: src/repro_torch is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs.registry import get_config
    cfg = get_config("qwen2-1.5b")

    t0 = time.perf_counter()
    phase_card()
    if "build" in phases or "kernels" in phases:
        phase_build()
    summary = phase_kernels(cfg) if "kernels" in phases else None
    launches = phase_train(cfg) if "train" in phases else None
    if "parity" in phases:
        phase_parity(cfg)
    if summary is not None:
        kernels = []
        for name, s in summary.items():
            kernels.append({
                "name": name, "route": "cuda", "source": SOURCES[name][0],
                "replaces": SOURCES[name][1],
                "launches": launches[name] if launches else None,
                "max_abs_err": s["max_abs_err"], "ms": s["ms"],
                "plain_ms": s["plain_ms"], "bound_ms": s["bound_ms"],
                "bound_by": ("bytes" if s["t_bytes"] >= s["t_ops"]
                             else "operations"),
                "library_ms": s["library_ms"]})
        emit(kernels=kernels)
    emit(phase="done", seconds=time.perf_counter() - t0)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
