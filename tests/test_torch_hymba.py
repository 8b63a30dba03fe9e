"""The port's hybrid family (hymba-1.5b) against the JAX package at smoke
size (5 layers, window 8, 4 meta tokens), f32: the same params (converted
key by key) and numpy tokens -> the same per-sample losses, BK norms and
clipped sums under bk and bk-mixopt (the reference without its Pallas
kernels), prefill logits, decode chain and caches. The chunked SSM
(``models.ssm.ssd``) against the reference's token-by-token scan and a
float64 recurrence under strong and weak decay; banded attention on both
of its routes; the port's opacus against its bk-mixopt; the CLIs."""
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import DPConfig as JDPConfig
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.tape import Tape as JTape
from repro.models import attention as jattn
from repro.models import ssm as jssm
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, get_config, smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.bk import DPConfig, bk_clipped_sum, plan_report
from repro_torch.core.engine import make_grad_fn
from repro_torch.core.noise import prng_key
from repro_torch.core.tape import Tape
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tattn
from repro_torch.models import ssm as tssm
from repro_torch.models.hymba import HymbaLM
from repro_torch.utils.tree import flatten

ARCH, B = "hymba-1.5b", 3
TOL = dict(rtol=1e-3, atol=1e-4)           # tests/test_kernel_parity.py:15
OPACUS_NORM_TOL = dict(rtol=2e-4, atol=1e-5)   # tests/test_arch_smoke.py:97
OPACUS_TOL = dict(rtol=2e-3, atol=2e-5)        # tests/test_arch_smoke.py:100
F64_TOL = dict(rtol=1e-5, atol=1e-6)       # the chunked form in float64


def _cfgs(**kw):
    return (jsmoke(ARCH).with_(dtype="float32", param_dtype="float32", **kw),
            smoke_config(ARCH).with_(param_dtype="float32", **kw))


@functools.lru_cache(maxsize=None)
def _jax(**kw):
    jcfg, _ = _cfgs(**kw)
    jm = jbuild(jcfg)
    return jm, jm.init(jax.random.PRNGKey(0))


def _port(**kw):
    """The port's model and a fresh copy of the JAX params."""
    _, jp = _jax(**kw)
    tm = build(_cfgs(**kw)[1])
    return tm, params_from_jax({k: np.asarray(v)
                                for k, v in jflatten(jp).items()}, "cpu")


def _tokens(T, seed=None):
    return np.random.default_rng(T if seed is None else seed).integers(
        0, 64, (B, T)).astype(np.int32)


def test_registry_builds_hymba():
    assert isinstance(build(get_config(ARCH)), HymbaLM)
    cfg = get_config(ARCH)
    assert (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd, cfg.ssm_state,
            cfg.vocab, cfg.meta_tokens, cfg.window) == (
                1600, 25, 5, 64, 16, 32001, 128, 1024)


def test_params_round_trip_the_reference_keys():
    """The port's init has the JAX package's flat keys, shapes and dtypes;
    the JAX params go to the port and come back bitwise."""
    jm, jp = _jax()
    want = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    tm, tp = _port()
    mine = flatten(tm.init(0, "cpu"))
    assert sorted(mine) == sorted(want)
    for k, v in mine.items():
        assert tuple(v.shape) == want[k].shape, k
    assert {"swa_a/ssm/A_log", "swa_b/mlp/up/w", "meta/m",
            "g_mid/fuse_o/w"} <= set(want)
    back = params_to_numpy(tp)
    assert sorted(back) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


@pytest.mark.parametrize("T", [16, 40])
def test_apply_losses_match_jax(T):
    """T_eff = T + 4 meta tokens: 20 (one SSM chunk) and 44 (two, the
    second ragged); the window (8) bites at both."""
    jm, jp = _jax()
    tm, tp = _port()
    toks = _tokens(T)
    want = np.asarray(jax.jit(lambda p, b: jm.apply(p, b, JTape(None)))(
        jp, {"tokens": toks}))
    got = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, Tape.null())
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_apply_taps_every_op_of_the_reference():
    """Six mm taps a block (three unstacked blocks, two stacked segments),
    the head and the embedding; meta/m and the SSM vectors on the psp
    route; the head's record keeps the meta rows."""
    tm, tp = _port()
    tb = {"tokens": torch.from_numpy(_tokens(16))}
    report = plan_report(tm.apply, tp, tb, DPConfig(mode="bk-mixopt"))
    ops = ("attn/qkv", "ssm/xz", "ssm/bcdt", "fuse_o", "mlp/up", "mlp/down")
    want = ({f"{g}/{o}#mm" for g in ("g0", "g_mid", "g_last") for o in ops}
            | {f"{g}/{o}#mm.s" for g in ("swa_a", "swa_b") for o in ops}
            | {"head#mm", "embed#emb"})
    assert set(report) == want
    tape = Tape(active=lambda k: True)
    with torch.no_grad():
        tm.apply(tp, tb, tape)
    assert tuple(tape.acts["head#mm"].shape) == (B, 16 + 4, 32)
    assert tuple(tape.acts["swa_a/ssm/bcdt#mm.s"].shape) == (1, B, 20, 32)


@pytest.mark.parametrize("mode", ["bk", "bk-mixopt"])
def test_bk_clipped_sum_matches_jax(mode):
    """Per-sample norms, losses and the clipped sums of the port's
    ``bk_clipped_sum(..., mesh=None)`` against the reference's."""
    jm, jp = _jax()
    tm, tp = _port()
    toks = _tokens(40)
    want, waux = jax.jit(lambda p, b: jbk_clipped_sum(
        jm.apply, p, b, JDPConfig(mode=mode, use_kernels=False)))(
            jp, {"tokens": toks})
    got, aux = bk_clipped_sum(tm.apply, tp,
                              {"tokens": torch.from_numpy(toks)},
                              DPConfig(mode=mode), mesh=None)
    np.testing.assert_allclose(aux["per_sample_norms"].numpy(),
                               np.asarray(waux["per_sample_norms"]), **TOL)
    np.testing.assert_allclose(aux["loss"].numpy(), np.asarray(waux["loss"]),
                               **TOL)
    want = {k: np.asarray(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)


def test_opacus_matches_bk_mixopt():
    """The port's opacus (vmap(grad) through the model: the chunked SSM and
    banded attention under vmap) against its bk-mixopt."""
    tm, tp = _port()
    tb = {"tokens": torch.from_numpy(_tokens(40))}
    ref, ra = make_grad_fn(tm.apply, DPConfig(mode="opacus"))(
        tp, tb, prng_key(3))
    got, ga = make_grad_fn(tm.apply, DPConfig(mode="bk-mixopt"))(
        tp, tb, prng_key(3))
    np.testing.assert_allclose(ga["per_sample_norms"].numpy(),
                               ra["per_sample_norms"].numpy(),
                               **OPACUS_NORM_TOL)
    ref = flatten(ref)
    for k, g in sorted(flatten(got).items()):
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), err_msg=k,
                                   **OPACUS_TOL)


@pytest.mark.parametrize("T", [12, 28])
def test_prefill_matches_jax(T):
    """T_eff 16 and 32: the prefill's banded layers take the chunked band
    at attn_chunk=4 (and the one masked product at the default 512)."""
    for kw in ({}, {"attn_chunk": 4}):
        jm, jp = _jax(**kw)
        tm, tp = _port(**kw)
        toks = _tokens(T)
        want = np.asarray(jax.jit(jm.prefill)(jp, jnp.asarray(toks)))
        got = tm.prefill(tp, torch.from_numpy(toks))
        assert got.shape == (B, 64) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, err_msg=str(kw), **TOL)


def test_decode_steps_and_caches_match_jax():
    """Three decode steps from empty caches (no meta tokens, as the
    reference decodes), then one at a position past the window (8): each
    step's logits and every cache entry."""
    jm, jp = _jax()
    tm, tp = _port()
    S = 12
    jc, tc = jm.init_cache(B, S), tm.init_cache(B, S, device="cpu")
    want_struct = {k: (tuple(v.shape), str(v.dtype))
                   for k, v in jflatten(jc).items()}
    got_struct = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                  for k, v in flatten(tc).items()}
    assert got_struct == want_struct
    toks = _tokens(S)
    jdecode = jax.jit(jm.decode_step)
    for i in range(S):
        j, jc = jdecode(jp, jc, jnp.asarray(toks[:, i]),
                        jnp.asarray(i, jnp.int32))
        t, tc = tm.decode_step(tp, tc, torch.from_numpy(toks[:, i]), i)
        if i < 3 or i == S - 1:
            np.testing.assert_allclose(t.numpy(), np.asarray(j),
                                       err_msg=f"step {i}", **TOL)
            jflat = {k: np.asarray(v) for k, v in jflatten(jc).items()}
            for k, v in flatten(tc).items():
                np.testing.assert_allclose(v.numpy(), jflat[k],
                                           err_msg=f"step {i} {k}", **TOL)


def _ssm_inputs(T, seed=0):
    rng = np.random.default_rng(seed)
    cfg = _cfgs()[1]
    d = cfg.d_model
    p = {"xz": {"w": rng.normal(0, d ** -0.5, (d, 2 * cfg.ssm_heads * cfg.hd))},
         "bcdt": {"w": rng.normal(0, d ** -0.5,
                                  (d, 2 * cfg.ssm_state + cfg.ssm_heads))},
         "A_log": rng.normal(0, 0.5, (cfg.ssm_heads,)),
         "D": rng.normal(1, 0.1, (cfg.ssm_heads,)),
         "dt_bias": rng.normal(0, 0.5, (cfg.ssm_heads,))}
    xn = rng.normal(0, 1, (B, T, d))
    p = jax.tree.map(lambda a: np.asarray(a, np.float32), p)
    return cfg, p, xn.astype(np.float32)


@pytest.mark.parametrize("T", [45, 64])
def test_ssm_apply_matches_jax_scan(T):
    """The chunked SSM (chunks of 32) against the reference's token scan:
    T not a multiple of the chunk, and one that is."""
    cfg, p, xn = _ssm_inputs(T)
    want = np.asarray(jssm.ssm_apply(p, JTape(None), jnp.asarray(xn), cfg))
    tp = jax.tree.map(torch.from_numpy, p)
    got = tssm.ssm_apply(tp, Tape.null(), torch.from_numpy(xn), cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def _recurrence64(x, a, Bm, Cm, dt):
    """h_t = exp(a_t) h_{t-1} + dt_t x_t B_t, y_t = h_t C_t, float64."""
    Bsz, T, H, P = x.shape
    h = torch.zeros(Bsz, H, P, Bm.shape[-1], dtype=torch.float64)
    ys = []
    for t in range(T):
        h = (torch.exp(a[:, t])[..., None, None] * h
             + dt[:, t, :, None, None] * x[:, t, ..., None]
             * Bm[:, t, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", h, Cm[:, t]))
    return torch.stack(ys, 1)


@pytest.mark.parametrize("decay", [0.01, 0.999])
def test_ssd_against_float64_recurrence(decay):
    """Strong (exp(A dt) = 0.01: in-chunk products underflow f32 after ~20
    tokens) and weak (0.999) decay: the chunked form in float64 against the
    token-by-token recurrence at F64_TOL, and in f32 at TOL."""
    gen = torch.Generator().manual_seed(7)
    Bsz, T, H, P, N = 2, 77, 3, 8, 4
    x = torch.randn(Bsz, T, H, P, generator=gen, dtype=torch.float64)
    Bm = torch.randn(Bsz, T, N, generator=gen, dtype=torch.float64)
    Cm = torch.randn(Bsz, T, N, generator=gen, dtype=torch.float64)
    dt = torch.rand(Bsz, T, H, generator=gen, dtype=torch.float64) + 0.5
    a = torch.full((Bsz, T, H), math.log(decay), dtype=torch.float64)
    want = _recurrence64(x, a, Bm, Cm, dt)
    got = tssm.ssd(x, a, Bm, Cm, dt, 32)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want.numpy(), **F64_TOL)
    got32 = tssm.ssd(*(t.float() for t in (x, a, Bm, Cm, dt)), 32)
    assert torch.isfinite(got32).all()
    np.testing.assert_allclose(got32.double().numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("T,chunk", [(24, 4), (22, 4), (24, 0)])
def test_banded_attention_matches_jax(T, chunk):
    """Both routes: the chunked band (T a multiple of the chunk) and the one
    masked product (T not a multiple; chunk 0 -> min(T, 128) = T)."""
    rng = np.random.default_rng(T + chunk)
    q = rng.normal(size=(2, T, 4, 8)).astype(np.float32)
    k = rng.normal(size=(2, T, 2, 8)).astype(np.float32)
    v = rng.normal(size=(2, T, 2, 8)).astype(np.float32)
    want = np.asarray(jattn.banded_attention(q, k, v, window=6, chunk=chunk))
    got = tattn.banded_attention(*map(torch.from_numpy, (q, k, v)), window=6,
                                 chunk=chunk)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


@pytest.mark.parametrize("window", [0, 5])
def test_decode_attention_window_matches_jax(window):
    rng = np.random.default_rng(window)
    q = rng.normal(size=(2, 1, 4, 8)).astype(np.float32)
    ck = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    cv = rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
    for pos in (3, 11):
        want = np.asarray(jattn.decode_attention(q, ck, cv, pos,
                                                 window=window))
        got = tattn.decode_attention(*map(torch.from_numpy, (q, ck, cv)),
                                     pos, window)
        np.testing.assert_allclose(got.numpy(), want, err_msg=str(pos),
                                   **TOL)


def test_train_cli_takes_a_noised_step(tmp_path):
    """``--arch hymba-1.5b --smoke --device cpu``: two noised AdamW steps
    (a flat DPConfig: no registered policy); every param moves, meta/m
    too."""
    out = tmp_path / "s.json"
    params, losses = ttrain.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "16", "--sigma", "1.0", "--out", str(out)])
    summary = json.loads(out.read_text())
    assert summary["steps_done"] == 2 and summary["epsilon"] > 0
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    init = flatten(build(smoke_config(ARCH).with_(
        param_dtype="float32")).init(0, "cpu"))
    moved = [k for k, v in flatten(params).items()
             if torch.equal(v, init[k])]
    assert not moved, moved


def test_serve_cli_generates():
    out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                      "--batch", "2", "--prompt-len", "5", "--gen", "4"])
    assert tuple(out.shape) == (2, 9)
