"""The port's BK engine against the JAX package's ``bk_clipped_sum``
(no mesh) at smoke size: clipped sums and aux (per-sample norms, per-unit
norms and clip factors) for every BK mode x clipping fn, for the qwen2-1.5b
policy preset, and for a frozen group. At T=16 every mm tap takes the ghost
norm; at T=33 (2T^2 >= pd) qkv, o, down and head go direct, which runs the
mixopt cache of instantiated per-sample grads."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import get_policy as jget_policy
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import DPConfig as JDPConfig
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.policy import ParamGroup as JParamGroup
from repro.core.policy import PrivacyPolicy as JPrivacyPolicy
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, get_policy, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.bk import DPConfig, bk_clipped_sum
from repro_torch.core.policy import ParamGroup, PrivacyPolicy

TOL = dict(rtol=1e-3, atol=1e-4)        # tests/test_kernel_parity.py:15
MODES = ["bk", "bk-mixghost", "bk-mixopt"]
# R between the smoke model's per-sample norms (~1.43-1.48 at T=16,
# ~0.99-1.01 at T=33), so abadi and flat clip some samples and keep others
R_AT = {16: 1.45, 33: 1.0}


@functools.lru_cache(maxsize=None)
def _jax_setup(T, B=3):
    jcfg = jsmoke("qwen2-1.5b").with_(dtype="float32", param_dtype="float32")
    jm = jbuild(jcfg)
    toks = np.random.default_rng(0).integers(0, 64, (B, T)).astype(np.int32)
    return jm, jm.init(jax.random.PRNGKey(0)), toks


def _setup(T, B=3):
    """JAX model/params/batch and the port's, holding the same values (the
    port's params are fresh tensors on every call)."""
    jm, jp, toks = _jax_setup(T, B)
    tcfg = smoke_config("qwen2-1.5b").with_(param_dtype="float32")
    tp = params_from_jax({k: np.asarray(v) for k, v in jflatten(jp).items()},
                         "cpu")
    return (jm, jp, {"tokens": jnp.asarray(toks)},
            build(tcfg), tp, {"tokens": torch.from_numpy(toks)})


def _compare(jcfg, tcfg, T):
    jm, jp, jb, tm, tp, tb = _setup(T)
    want, waux = jax.jit(lambda p, b: jbk_clipped_sum(jm.apply, p, b, jcfg))(
        jp, jb)
    got, gaux = bk_clipped_sum(tm.apply, tp, tb, tcfg)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(gaux["loss"].numpy(), np.asarray(waux["loss"]),
                               **TOL)
    np.testing.assert_allclose(gaux["per_sample_norms"].numpy(),
                               np.asarray(waux["per_sample_norms"]), **TOL)
    for part in ("group_norms", "group_clip_factors"):
        assert sorted(gaux[part]) == sorted(waux[part])
        for u in waux[part]:
            np.testing.assert_allclose(gaux[part][u].numpy(),
                                       np.asarray(waux[part][u]),
                                       err_msg=f"{part}:{u}", **TOL)


CLIPPINGS = ["automatic", "abadi", "flat"]


# at T=16 every mode runs the same all-ghost computation, so one mode there
@pytest.mark.parametrize("mode,clipping,T",
                         [(m, c, 33) for m in MODES for c in CLIPPINGS]
                         + [("bk", c, 16) for c in CLIPPINGS])
def test_clipped_sum_matches_jax(mode, clipping, T):
    kw = dict(mode=mode, clipping=clipping, R=R_AT[T])
    # the JAX side on its jnp path (its Pallas kernels are held to it by
    # tests/test_kernel_parity.py); the port's wrappers run their plain
    # versions on these CPU tensors
    _compare(JDPConfig(use_kernels=False, **kw), DPConfig(**kw), T)


@pytest.mark.parametrize("mode", MODES)
def test_qwen2_policy_preset_matches_jax(mode):
    _compare(jget_policy("qwen2-1.5b", mode=mode, use_kernels=False),
             get_policy("qwen2-1.5b", mode=mode), 33)


def test_preset_matches_jax_with_its_pallas_kernels():
    """The reference as the train driver runs it (kernels on, interpret)."""
    _compare(jget_policy("qwen2-1.5b", mode="bk-mixopt"),
             get_policy("qwen2-1.5b", mode="bk-mixopt"), 16)


def test_frozen_group_and_method_override_match_jax():
    def groups(PG):
        return (PG("emb", "embed/.*", trainable=False),
                PG("attn", "blocks/attn/.*", R=0.7, scope="group",
                   method="direct", clipping="abadi"),
                PG("rest", ".*"))

    _compare(JPrivacyPolicy(groups(JParamGroup), mode="bk-mixghost",
                            use_kernels=False),
             PrivacyPolicy(groups(ParamGroup), mode="bk-mixghost"), 16)


def test_layer_scope_is_not_ported():
    _, _, _, tm, tp, tb = _setup(16)
    pol = PrivacyPolicy((ParamGroup("all", ".*", scope="layer"),))
    with pytest.raises(NotImplementedError, match="fused_clip_grad"):
        bk_clipped_sum(tm.apply, tp, tb, pol)


def test_weights_take_no_grad_and_params_are_untouched():
    """Ghost differentiation: the weights never require grad, and the
    caller's params come back unchanged."""
    _, _, _, tm, tp, tb = _setup(16)
    before = {k: v.clone() for k, v in tp["blocks"]["mlp"]["up"].items()}
    tp["blocks"]["mlp"]["up"]["w"].requires_grad_()
    bk_clipped_sum(tm.apply, tp, tb, DPConfig(mode="bk"))
    assert tp["blocks"]["mlp"]["up"]["w"].grad is None
    torch.testing.assert_close(tp["blocks"]["mlp"]["up"]["w"].detach(),
                               before["w"])
