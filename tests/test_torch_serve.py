"""The port's serving path for the qwen2 family (and the MoE family's
prefill and decode) against the JAX package's at smoke size, f32: the
same params (converted key by key) and numpy tokens -> the same prefill
logits, decode chain, caches and greedy tokens. On the CPU
the prefill's attention runs flash_attention's plain version; the kernel is
held to it on the card by chip_smoke.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import smoke_config as jsmoke
from repro.launch.serve import generate as jgenerate
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve
from repro_torch.utils.tree import flatten

TOL = dict(rtol=1e-3, atol=1e-4)        # tests/test_kernel_parity.py:15
ARCH = "qwen2-1.5b"


@functools.lru_cache(maxsize=None)
def models(arch=ARCH, seed=0):
    """(JAX model, JAX params, port model, port params) at smoke size, f32,
    the port's params converted from the JAX ones (shared between tests:
    serving never writes the params)."""
    jm = jbuild(jsmoke(arch).with_(dtype="float32", param_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(seed))
    flat = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    tm = build(smoke_config(arch).with_(param_dtype="float32"))
    return jm, jp, tm, params_from_jax(flat, "cpu")


def tokens(B, T, vocab=64, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, T)
                                                ).astype(np.int32)


def decode_chain(jm, jp, tm, tp, toks, S):
    """Both models' decode_step over toks (B,T) -> (JAX logits, port
    logits, JAX cache, port cache)."""
    B, T = toks.shape
    jc, tc = jm.init_cache(B, S), tm.init_cache(B, S, device="cpu")
    jdecode = jax.jit(jm.decode_step)
    jl, tl = [], []
    for i in range(T):
        j, jc = jdecode(jp, jc, jnp.asarray(toks[:, i]),
                        jnp.asarray(i, jnp.int32))
        t, tc = tm.decode_step(tp, tc, torch.tensor(toks[:, i]), i)
        jl.append(np.asarray(j))
        tl.append(t.numpy())
    return np.stack(jl, 1), np.stack(tl, 1), jc, tc


@pytest.mark.parametrize("arch,T", [(ARCH, 16), (ARCH, 33),
                                    ("deepseek-moe-16b", 12)])
def test_prefill_matches_jax(arch, T):
    jm, jp, tm, tp = models(arch)
    toks = tokens(3, T)
    want = np.asarray(jax.jit(jm.prefill)(jp, jnp.asarray(toks)))
    got = tm.prefill(tp, torch.from_numpy(toks))
    assert got.shape == (3, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_init_cache_matches_jax():
    jm, _, tm, _ = models()
    want = {k: (tuple(v.shape), str(v.dtype))
            for k, v in jflatten(jm.init_cache(3, 20)).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in flatten(tm.init_cache(3, 20, device="cpu")).items()}
    assert got == want
    assert want["blocks/k"] == ((2, 3, 20, 2, 8), "float32")


@pytest.mark.parametrize("arch", [ARCH, "deepseek-moe-16b"])
def test_decode_chain_matches_jax(arch):
    jm, jp, tm, tp = models(arch)
    toks = tokens(2, 12, seed=1)
    jl, tl, jc, tc = decode_chain(jm, jp, tm, tp, toks, 16)
    np.testing.assert_allclose(tl, jl, **TOL)
    for k, v in jflatten(jc).items():        # the caches, written in place
        np.testing.assert_allclose(flatten(tc)[k].numpy(), np.asarray(v),
                                   **TOL)


def test_decode_last_logits_equal_prefill():
    """The teacher-forced decode's logits at the last prompt position are
    the prefill's (the gate chip_smoke.py applies on the card)."""
    _, _, tm, tp = models()
    toks = torch.from_numpy(tokens(2, 20, seed=2))
    _, logits = serve.generate(tm, tp, toks, 0, return_logits=True)
    assert logits.shape == (2, 20, 64)
    torch.testing.assert_close(logits[:, -1], tm.prefill(tp, toks), **TOL)


def test_generate_matches_jax():
    jm, jp, tm, tp = models()
    prompts = tokens(3, 8, seed=3)
    want = np.asarray(jgenerate(jm, jp, jnp.asarray(prompts), 6))
    got, logits = serve.generate(tm, tp, torch.from_numpy(prompts), 6,
                                 return_logits=True)
    assert got.shape == (3, 14) and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    # per-step logits: the JAX decode replayed along the same tokens
    jl, _, _, _ = decode_chain(jm, jp, tm, tp, want, 14)
    assert logits.shape == (3, 14, 64)
    np.testing.assert_allclose(logits.numpy(), jl, **TOL)


def test_serve_cli_on_cpu():
    out = serve.main(["--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (2, 7) and out.device.type == "cpu"
    assert int(out.min()) >= 0 and int(out.max()) < 64


def test_serve_cli_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        serve.main(["--smoke"])
