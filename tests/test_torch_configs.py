"""The decoder configs the port registers beside qwen2-1.5b (qwen2.5-3b,
qwen3-14b, llama3-405b, moonshot-v1-16b-a3b) and qk-norm, at smoke size,
f32, against the JAX package: qwen3-14b's per-sample losses, taps and
records, BK norms and clipped sums (its qk-norm scales on the psp route, a
(B, h) scale a sample), prefill and decode logits; moonshot's losses and
clipped sums (``renorm_topk``); the same for the GPT2-class block
(LayerNorm, GELU MLP) of the examples' gpt2-100m; ``cut_depth`` of each new
config; and each
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

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.registry import build as jbuild
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import DPConfig as JDPConfig
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.bk import tap_act_structs as jtap_act_structs
from repro.core.tape import Tape as JTape
from repro.utils.tree import flatten as jflatten
from repro.utils.tree import unflatten as junflatten
from repro_torch.configs.base import ModelConfig
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


# examples/train_dp_lm.py's gpt2-100m (LayerNorm, GELU MLP; no registry
# entry in either package) at that example's --smoke reduction
GPT2 = dict(name="gpt2-100m", family="dense", n_layers=2, d_model=64,
            n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=512,
            norm="layernorm", act="gelu")


def _configs(arch):
    """(the JAX package's, the port's) smoke config of ``arch``, f32."""
    if arch == "gpt2-100m":
        j, t = JModelConfig(**GPT2), ModelConfig(**GPT2)
    else:
        j, t = jsmoke(arch), smoke_config(arch)
    return (j.with_(dtype="float32", param_dtype="float32"),
            t.with_(param_dtype="float32"))


@functools.lru_cache(maxsize=None)
def _numpy_params(arch):
    """The port's smoke params from seed 0, every vector scale moved off 1
    (so that qk-norm's scales act), every LayerNorm shift off 0 and the
    readout scaled up 100 times (the init's small readout puts every loss
    within 1e-3 of log V, blind to the features), as flat numpy in the JAX
    package's keys and layouts."""
    flat = params_to_numpy(build(_configs(arch)[1]).init(0, "cpu"))
    rng = np.random.default_rng(1)
    moved = ("/g", "ln1/b", "ln2/b", "final_norm/b")
    flat["head/w"] = flat["head/w"] * 100.0
    return {k: (v + 0.2 * rng.standard_normal(v.shape).astype(np.float32)
                if k.endswith(moved) else v) for k, v in flat.items()}


def _models(arch):
    jcfg, tcfg = _configs(arch)
    flat = _numpy_params(arch)
    jp = junflatten({k: jnp.asarray(v) for k, v in flat.items()})
    return jbuild(jcfg), jp, build(tcfg), params_from_jax(flat, "cpu")


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


def test_gpt2_init_keys_shapes_dtypes_match_jax():
    """The GPT2-class block's params: the JAX package's keys, shapes and
    dtypes (LayerNorm scale and shift, a GELU MLP's single up leaf), the
    scales ones and the shifts zeros as there."""
    jcfg, tcfg = _configs("gpt2-100m")
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jflatten(jp).items()}
    flat = params_to_numpy(build(tcfg).init(0, "cpu"))
    got = {k: (tuple(v.shape), str(v.dtype)) for k, v in flat.items()}
    assert got == want
    for k in ("blocks/ln1", "blocks/ln2", "final_norm"):
        np.testing.assert_array_equal(flat[k + "/g"], 1.0)
        np.testing.assert_array_equal(flat[k + "/b"], 0.0)
    assert flat["blocks/mlp/up/w"].shape == (2, 64, 128)


@pytest.mark.parametrize("T", [16, 33])
def test_gpt2_losses_taps_and_records_match_jax(T):
    """LayerNorm + GELU: per-sample losses, masked too, and the tap /
    record keys, shapes and dtypes of ``tap_act_structs`` (the shifts, as
    the scales, on the psp route: no tap)."""
    jm, jp, tm, tp = _models("gpt2-100m")
    toks = _tokens(T)
    mask = np.ones((B, T), np.float32)
    mask[1, T // 2:] = 0.0
    for batch in ({"tokens": toks}, {"tokens": toks, "mask": mask}):
        want = np.asarray(jm.apply(jp, {k: jnp.asarray(v)
                                        for k, v in batch.items()},
                                   JTape.null()))
        got = tm.apply(tp, {k: torch.from_numpy(v)
                            for k, v in batch.items()}, Tape.null())
        np.testing.assert_allclose(got.numpy(), want, **TOL)
    jtaps, jacts = jtap_act_structs(jm.apply, jp, {"tokens": toks})
    taps, acts = tap_act_structs(tm.apply, tp,
                                 {"tokens": torch.from_numpy(toks)})
    norm = lambda d: {k: (tuple(v.shape), str(v.dtype)) for k, v in d.items()}
    tnorm = lambda d: {k: (tuple(s), str(dt).replace("torch.", ""))
                       for k, (s, dt) in d.items()}
    assert tnorm(taps) == norm(jtaps) and tnorm(acts) == norm(jacts)
    assert not any("ln" in k or "final_norm" in k for k in taps)


def test_gpt2_bk_clipped_sum_matches_jax():
    """bk-mixopt's norms and clipped sums of the GPT2-class block, the
    LayerNorm shifts' and the GELU MLP's among them."""
    got = _bk_against_jax("gpt2-100m", 16)
    assert got["blocks/ln1/b"].shape == (2, 64)
    assert float(got["final_norm/b"].abs().max()) > 0
    assert got["blocks/mlp/up/w"].shape == (2, 64, 128)


def test_gpt2_prefill_and_decode_match_jax():
    """The GPT2-class block's prefill logits, then a decode chain over the
    same tokens, against the JAX package's."""
    jm, jp, tm, tp = _models("gpt2-100m")
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


def test_gpt2_example_config_is_the_references():
    """The torch example's gpt2-100m is the JAX example's, field for field
    (less the port's absent ``max_t``; bf16 params as a run on the card
    keeps them), and its smoke reduction is :data:`GPT2`."""
    import importlib.util as iu
    mods = []
    for name in ("train_dp_lm", "train_dp_lm_torch"):
        spec = iu.spec_from_file_location(name, ROOT / "examples" /
                                          f"{name}.py")
        mods.append(iu.module_from_spec(spec))
        spec.loader.exec_module(mods[-1])
    j, t = mods[0].gpt2_100m(), mods[1].gpt2_100m()
    for f in ("name", "family", "n_layers", "d_model", "n_heads",
              "n_kv_heads", "head_dim", "d_ff", "vocab", "norm", "act",
              "qkv_bias", "qk_norm", "rope_theta"):
        assert getattr(t, f) == getattr(j, f), f
    small = {k: v for k, v in GPT2.items() if k not in ("name", "family",
                                                         "norm", "act")}
    assert t.with_(**small) == ModelConfig(**GPT2).with_(
        param_dtype=t.param_dtype)


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
