"""The decoder configs the port registers beside qwen2-1.5b (qwen2.5-3b,
qwen3-14b, llama3-405b, moonshot-v1-16b-a3b) and qk-norm, at smoke size,
f32, against the JAX package: qwen3-14b's per-sample losses, taps and
records, BK norms and clipped sums (its qk-norm scales on the psp route, a
(B, h) scale a sample), prefill and decode logits; moonshot's losses and
clipped sums (``renorm_topk``); ``cut_depth`` of each new config; and each
full-width train path of chip_smoke.py planned on meta tensors, its launches
a step as the script asserts them on the card (rwkv6's wkv6 twice a layer:
its blocks remat; internvl2-26b's batch with its patches)."""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import DPConfig as JDPConfig
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.bk import tap_act_structs as jtap_act_structs
from repro.core.tape import Tape as JTape
from repro.utils.tree import unflatten as junflatten
from repro_torch.configs.registry import (build, cut_depth, get_config,
                                          smoke_config)
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.bk import (DPConfig, bk_clipped_sum, plan_report,
                                 tap_act_structs)
from repro_torch.core.tape import Tape
from repro_torch.data.pipeline import Pipeline, PipelineConfig
from repro_torch.models import layers as L

B = 3
TOL = dict(rtol=1e-3, atol=1e-4)           # tests/test_kernel_parity.py:15
ROOT = Path(__file__).resolve().parents[1]


@functools.lru_cache(maxsize=None)
def _numpy_params(arch):
    """The port's smoke params from seed 0, every vector scale moved off 1
    (so that qk-norm's scales act), as flat numpy in the JAX package's keys
    and layouts."""
    flat = params_to_numpy(build(smoke_config(arch).with_(
        param_dtype="float32")).init(0, "cpu"))
    rng = np.random.default_rng(1)
    return {k: (v + 0.2 * rng.standard_normal(v.shape).astype(np.float32)
                if k.endswith("/g") else v) for k, v in flat.items()}


def _models(arch):
    jm = jbuild(jsmoke(arch).with_(dtype="float32", param_dtype="float32"))
    flat = _numpy_params(arch)
    jp = junflatten({k: jnp.asarray(v) for k, v in flat.items()})
    tm = build(smoke_config(arch).with_(param_dtype="float32"))
    return jm, jp, tm, params_from_jax(flat, "cpu")


def _tokens(T, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (B, T)
                                                ).astype(np.int32)


def _bk_against_jax(arch, T):
    jm, jp, tm, tp = _models(arch)
    toks = _tokens(T)
    want, waux = jax.jit(lambda p, b: jbk_clipped_sum(
        jm.apply, p, b, JDPConfig(mode="bk-mixopt", use_kernels=False)))(
            jp, {"tokens": toks})
    got, aux = bk_clipped_sum(tm.apply, tp, {"tokens": torch.from_numpy(toks)},
                              DPConfig(mode="bk-mixopt"), mesh=None)
    for k in ("loss", "per_sample_norms"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(waux[k]),
                                   err_msg=k, **TOL)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), err_msg=k,
                                   **TOL)
    return got


def test_qwen3_losses_taps_and_records_match_jax():
    """Per-sample losses, and the tap / record keys, shapes and dtypes of
    ``tap_act_structs``; qk-norm adds the scales ``attn/qn/g`` and
    ``attn/kn/g`` of width h and no tap."""
    jm, jp, tm, tp = _models("qwen3-14b")
    assert tm.cfg.qk_norm and tp["blocks"]["attn"]["qn"]["g"].shape == (2, 8)
    toks = _tokens(16)
    want = np.asarray(jm.apply(jp, {"tokens": jnp.asarray(toks)},
                               JTape.null()))
    got = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, Tape.null())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    jtaps, jacts = jtap_act_structs(jm.apply, jp, {"tokens": toks})
    taps, acts = tap_act_structs(tm.apply, tp,
                                 {"tokens": torch.from_numpy(toks)})
    norm = lambda d: {k: (tuple(v.shape), str(v.dtype)) for k, v in d.items()}
    tnorm = lambda d: {k: (tuple(s), str(dt).replace("torch.", ""))
                       for k, (s, dt) in d.items()}
    assert tnorm(taps) == norm(jtaps) and tnorm(acts) == norm(jacts)
    assert not any("qn" in k or "kn" in k for k in taps)


def test_qwen3_bk_clipped_sum_matches_jax():
    """bk-mixopt's norms and clipped sums, the qk-norm scales' among them:
    each is (L, h) and reaches the block per sample as (B, h)."""
    got = _bk_against_jax("qwen3-14b", 16)
    assert got["blocks/attn/qn/g"].shape == (2, 8)
    assert float(got["blocks/attn/kn/g"].abs().max()) > 0


def test_qwen3_prefill_and_decode_match_jax():
    """The prefill's last logits, then a decode chain over the same tokens
    (each step's logits), against the JAX package's."""
    jm, jp, tm, tp = _models("qwen3-14b")
    toks = _tokens(12, seed=2)
    want = np.asarray(jax.jit(jm.prefill)(jp, jnp.asarray(toks)))
    np.testing.assert_allclose(tm.prefill(tp, torch.from_numpy(toks)).numpy(),
                               want, **TOL)
    jc, tc = jm.init_cache(B, 16), tm.init_cache(B, 16, device="cpu")
    jdecode = jax.jit(jm.decode_step)
    for i in range(toks.shape[1]):
        j, jc = jdecode(jp, jc, jnp.asarray(toks[:, i]),
                        jnp.asarray(i, jnp.int32))
        t, tc = tm.decode_step(tp, tc, torch.tensor(toks[:, i]), i)
        np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                   err_msg=f"step {i}", **TOL)
    np.testing.assert_allclose(t.numpy(), want, **TOL)


def test_moonshot_losses_and_bk_clipped_sum_match_jax():
    """moonshot (DeepSeekMoE with ``renorm_topk``, a dense first layer):
    per-sample losses and bk-mixopt's norms and clipped sums."""
    jm, jp, tm, tp = _models("moonshot-v1-16b-a3b")
    assert tm.cfg.renorm_topk and tm.cfg.first_k_dense == 1
    toks = _tokens(16)
    want = np.asarray(jm.apply(jp, {"tokens": jnp.asarray(toks)},
                               JTape.null()))
    got = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, Tape.null())
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    sums = _bk_against_jax("moonshot-v1-16b-a3b", 16)
    assert "blocks/mlp/experts/up/w" in sums and "dense0_0/mlp/up/w" in sums


def test_qk_norm_takes_a_per_sample_scale():
    """A per-sample scale (B, h) aligns to q (B, T, H, h) as (B, 1, 1, h):
    each sample's rows normed by its own scale."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(B, 5, 4, 8, generator=gen)
    g = torch.randn(B, 8, generator=gen)
    assert L.align(g, q).shape == (B, 1, 1, 8)
    got = L.rmsnorm({"g": g}, q)
    for b in range(B):
        torch.testing.assert_close(got[b], L.rmsnorm({"g": g[b]}, q[b]))


@pytest.mark.parametrize("arch,layers", [
    ("qwen2.5-3b", 36), ("qwen3-14b", 11), ("llama3-405b", 1),
    ("moonshot-v1-16b-a3b", 8), ("internvl2-26b", 8)])
def test_cut_depth_of_the_new_configs(arch, layers):
    cfg = get_config(arch)
    cut = cut_depth(cfg, layers)
    assert cut.n_layers == layers and cut.d_model == cfg.d_model
    assert cut.vocab == cfg.vocab and cut.remat and cut.with_(
        n_layers=cfg.n_layers) == cfg
    assert cut_depth(cfg, 0) is cfg
    if cfg.family == "moe":
        assert cut.first_k_dense == 1
    if cfg.family == "vlm":
        assert (cut.patch_tokens, cut.vit_dim) == (1024, 3200)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("path", ["train_qwen25", "train_qwen3",
                                  "train_llama3", "train_moonshot",
                                  "train_rwkv", "train_hymba",
                                  "train_internvl2"])
def test_full_width_plans_are_chip_smokes(path, monkeypatch):
    """Each path at full width and its depth (meta tensors, no compute):
    the kernels ``plan_report`` routes a step to are the launch counts
    chip_smoke.py asserts on the card, every tap of a stacked block marked
    'remat' (so rwkv6's wkv6 forward runs twice a layer, its backward
    once), and none of an unstacked one. The meta batch is the pipeline's
    spec: the vlm's carries its patches."""
    cs = _chip_smoke()
    meta = lambda gen, shape, dtype, *a: torch.empty(tuple(shape),
                                                     dtype=dtype,
                                                     device="meta")
    for fn in ("normal_init", "zeros_init", "ones_init"):
        monkeypatch.setattr(L, fn, meta)
    run = cs.RUNS[path]
    cfg, dp = cs.run_config(path)
    model = build(cfg)
    batch = Pipeline(cfg, PipelineConfig(run["batch"], run["seq"]),
                     "cpu").spec()
    report = plan_report(model.apply, model.init(0, "cpu"), batch, dp)
    counts = dict.fromkeys(run["per_step"], 0)
    for key, plans in report.items():
        kind = key.split("#")[1].split(".")[0]
        if plans["grad"] != "cache":
            counts[cs.NORM_KERNEL[kind, plans["norm"].method]] += 1
        if plans["grad"] in counts:
            counts[plans["grad"]] += 1
        assert plans["remat"] == key.endswith(".s"), key
    if cfg.family == "ssm":
        recomputed = report["blocks/att/r#mm.s"]["remat"]
        counts["wkv6"] = (1 + recomputed) * cfg.n_layers
        counts["wkv6_backward"] = cfg.n_layers
    assert counts == run["per_step"]
    assert cfg.n_layers == {"train_qwen25": 36, "train_rwkv": 32,
                            "train_hymba": 32}.get(path, run["layers"])
