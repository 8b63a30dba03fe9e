"""The port's rwkv6 family (serving side) against the JAX package's at smoke
size, f32: the same params (converted key by key, rwkv6's flat keys
unchanged) and numpy tokens -> the same prefill logits (below 2 * ssm_chunk
through ``wkv6_ref``, above it through ``wkv6_chunked`` with padding, as the
JAX model routes them on the CPU), decode chain, state caches and greedy
tokens. Its DP training: tests/test_torch_rwkv6_train.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_config as jget
from repro.launch.serve import generate as jgenerate
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.convert import params_to_numpy
from repro_torch.launch import serve
from repro_torch.utils.tree import flatten
from test_torch_serve import TOL, decode_chain, models, tokens

ARCH = "rwkv6-3b"


def test_config_matches_the_jax_registry():
    j, t = jget(ARCH), get_config(ARCH)
    for f in ("family", "n_layers", "d_model", "n_heads", "n_kv_heads",
              "head_dim", "d_ff", "vocab", "norm", "act", "param_dtype",
              "ssm_chunk"):
        assert getattr(t, f) == getattr(j, f), f
    s = smoke_config(ARCH)
    assert (s.d_model, s.n_heads, s.hd, s.n_layers) == (128, 2, 64, 2)


def test_init_keys_shapes_dtypes_match_jax():
    _, jp, tm, tp = models(ARCH)
    want = {k: (tuple(v.shape), str(v.dtype)) for k, v in jflatten(jp).items()}
    got = {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
           for k, v in params_to_numpy(tm.init(0, "cpu")).items()}
    assert got == want
    assert want["blocks/att/u"] == ((2, 2, 64), "float32")
    # converted params cross unchanged: the vectors, u and the LoRA linears
    for k in ("blocks/att/u", "blocks/att/w0", "blocks/att/tm_w2_3/w",
              "blocks/ffn/maa_fk", "ln_in/b"):
        np.testing.assert_array_equal(flatten(tp)[k].numpy(),
                                      np.asarray(jflatten(jp)[k]))


@pytest.mark.parametrize("T", [48, 80])
def test_prefill_matches_jax(T):
    """T=48 < 2*ssm_chunk: the sequential route; T=80: chunked, padded."""
    jm, jp, tm, tp = models(ARCH)
    toks = tokens(2, T)
    want = np.asarray(jax.jit(jm.prefill)(jp, jnp.asarray(toks)))
    got = tm.prefill(tp, torch.from_numpy(toks))
    assert got.shape == (2, 64) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_decode_chain_matches_jax():
    jm, jp, tm, tp = models(ARCH)
    toks = tokens(2, 10, seed=1)
    jl, tl, jc, tc = decode_chain(jm, jp, tm, tp, toks, 0)
    np.testing.assert_allclose(tl, jl, **TOL)
    for k, v in jflatten(jc).items():        # S, att_sx, ffn_sx
        assert tuple(tc[k].shape) == v.shape
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(v), **TOL)


def test_decode_last_logits_equal_prefill():
    _, _, tm, tp = models(ARCH)
    toks = torch.from_numpy(tokens(2, 20, seed=2))
    _, logits = serve.generate(tm, tp, toks, 0, return_logits=True)
    torch.testing.assert_close(logits[:, -1], tm.prefill(tp, toks), **TOL)


def test_generate_matches_jax():
    jm, jp, tm, tp = models(ARCH)
    prompts = tokens(2, 8, seed=3)
    want = np.asarray(jgenerate(jm, jp, jnp.asarray(prompts), 6))
    got, logits = serve.generate(tm, tp, torch.from_numpy(prompts), 6,
                                 return_logits=True)
    np.testing.assert_array_equal(got.numpy(), want)
    jl, _, _, _ = decode_chain(jm, jp, tm, tp, want, 0)
    np.testing.assert_allclose(logits.numpy(), jl, **TOL)

