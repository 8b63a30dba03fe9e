"""The port's MoE family (deepseek-moe-16b) against the JAX package's at the
JAX MoE smoke config (E=4, top-2, moe_d_ff 16, one leading dense layer, one
shared expert), f32: same params (converted key by key), same numpy batch
-> same per-sample losses, tap keys, records (activations and slot masks,
including a capacity overflow), and the same BK clipped sums for the
registered three-group policy in every BK mode and with the experts group
forced to the direct norm. Also the params round trip and the train CLI."""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import get_config as jget_config
from repro.configs.registry import get_policy as jget_policy
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.bk import tap_act_structs as jtap_act_structs
from repro.core.tape import Tape as JTape
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, get_config, get_policy
from repro_torch.configs.registry import smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.bk import bk_clipped_sum, tap_act_structs
from repro_torch.core.tape import Tape
from repro_torch.launch import train as ttrain
from repro_torch.utils.tree import flatten

ARCH = "deepseek-moe-16b"
TOL = dict(rtol=1e-3, atol=1e-4)        # tests/test_kernel_parity.py:15
MODES = ["bk", "bk-mixghost", "bk-mixopt"]
MOE_FIELDS = ("n_experts", "top_k", "n_shared", "moe_d_ff", "first_k_dense",
              "capacity_factor", "renorm_topk")


@functools.lru_cache(maxsize=None)
def _jax_model(capacity_factor=None, seed=0):
    jcfg = jsmoke(ARCH).with_(dtype="float32", param_dtype="float32")
    if capacity_factor is not None:
        jcfg = jcfg.with_(capacity_factor=capacity_factor)
    jm = jbuild(jcfg)
    return jm, jm.init(jax.random.PRNGKey(seed))


def _models(capacity_factor=None):
    jm, jp = _jax_model(capacity_factor)
    tcfg = smoke_config(ARCH).with_(param_dtype="float32")
    if capacity_factor is not None:
        tcfg = tcfg.with_(capacity_factor=capacity_factor)
    tp = params_from_jax({k: np.asarray(v) for k, v in jflatten(jp).items()},
                         "cpu")
    return jm, jp, build(tcfg), tp


def _tokens(B, T, seed=0):
    return np.random.default_rng(seed).integers(0, 64, (B, T)).astype(
        np.int32)


def _struct(x):
    """Shape/dtype of a record, a dict of records, or a (shape, dtype)."""
    if isinstance(x, dict):
        return {k: _struct(v) for k, v in x.items()}
    if isinstance(x, tuple):
        return (tuple(x[0]), str(x[1]).replace("torch.", ""))
    return (tuple(x.shape), str(x.dtype).replace("torch.", ""))


def test_configs_match_the_jax_registry():
    j, t = jget_config(ARCH), get_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab", "qkv_bias", "rope_theta", "param_dtype",
              "attn_chunk") + MOE_FIELDS:
        assert getattr(t, f) == getattr(j, f), f
    js, ts = jsmoke(ARCH), smoke_config(ARCH)
    for f in ("n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim",
              "d_ff", "vocab") + MOE_FIELDS:
        assert getattr(ts, f) == getattr(js, f), f


def test_init_keys_shapes_dtypes_match_jax():
    _, jp, tm, _ = _models()
    want = {k: _struct(v) for k, v in jflatten(jp).items()}
    got = {k: _struct(v) for k, v in flatten(tm.init(0, "cpu")).items()}
    assert got == want
    assert "dense0_0/mlp/up/w" in got and \
        "blocks/mlp/experts/up/w" in got and "blocks/mlp/shared/up/w" in got


def test_params_round_trip_moe_and_dense0_keys():
    _, jp, _, tp = _models()
    back = params_to_numpy(tp)
    flat = jflatten(jp)
    assert sorted(back) == sorted(flat)
    for k in ("dense0_0/attn/qkv/w", "dense0_0/mlp/down/w",
              "blocks/mlp/router/w", "blocks/mlp/experts/up/w",
              "blocks/mlp/experts/down/w", "blocks/mlp/shared/down/w"):
        np.testing.assert_array_equal(back[k], np.asarray(flat[k]), err_msg=k)
    assert tp["blocks"]["mlp"]["experts"]["up"]["w"].shape == (1, 4, 32, 32)
    assert tp["dense0_0"]["mlp"]["up"]["w"].shape == (32, 96)


@pytest.mark.parametrize("T", [16, 33])
def test_per_sample_losses_match_jax(T):
    jm, jp, tm, tp = _models()
    toks = _tokens(3, T)
    want = np.asarray(jax.jit(lambda p, b: jm.apply(p, b, JTape.null()))(
        jp, {"tokens": jnp.asarray(toks)}))
    got = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, Tape.null())
    assert got.shape == (3,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_tap_and_record_structure_matches_jax():
    jm, jp, tm, tp = _models()
    toks = _tokens(3, 16)
    jtaps, jacts = jtap_act_structs(jm.apply, jp, {"tokens": jnp.asarray(toks)})
    taps, acts = tap_act_structs(tm.apply, tp,
                                 {"tokens": torch.from_numpy(toks)})
    assert {k: _struct(v) for k, v in taps.items()} == \
        {k: _struct(v) for k, v in jtaps.items()}
    assert {k: _struct(v) for k, v in acts.items()} == \
        {k: _struct(v) for k, v in jacts.items()}
    assert _struct(acts["blocks/mlp/experts/up#moe.s"]) == {
        "a": ((1, 3, 4, 10, 32), "float32"), "mask": ((1, 3, 4, 10), "float32")}
    assert "dense0_0/attn/qkv#mm" in acts


@pytest.mark.parametrize("capacity_factor", [None, 0.5])
def test_records_and_losses_match_jax(capacity_factor):
    """Slot assignment, drops, masks and gathered activations equal the
    JAX package's; at capacity_factor 0.5 (C=4 of 16 tokens, 8 routed per
    expert on average) tokens are dropped."""
    jm, jp, tm, tp = _models(capacity_factor)
    toks = _tokens(3, 16, seed=1)

    def run(p, b):
        tape = JTape(None)
        return jm.apply(p, b, tape), tape.acts

    jloss, jacts = jax.jit(run)(jp, {"tokens": jnp.asarray(toks)})
    tape = Tape(active=lambda key: True)
    loss = tm.apply(tp, {"tokens": torch.from_numpy(toks)}, tape)
    np.testing.assert_allclose(loss.detach().numpy(), np.asarray(jloss),
                               **TOL)
    for key in ("blocks/mlp/experts/up#moe.s", "blocks/mlp/experts/down#moe.s"):
        jrec, rec = jacts[key], tape.acts[key]
        np.testing.assert_array_equal(rec["mask"].numpy(),
                                      np.asarray(jrec["mask"]), err_msg=key)
        np.testing.assert_allclose(rec["a"].numpy(), np.asarray(jrec["a"]),
                                   err_msg=key, **TOL)
    mask = tape.acts["blocks/mlp/experts/up#moe.s"]["mask"]
    C, kept = mask.shape[-1], int(mask.sum())
    assert C == (10 if capacity_factor is None else 4)
    if capacity_factor is not None:     # 3 samples x 16 tokens x top-2
        assert kept <= 3 * 4 * C < 3 * 16 * 2


def _policy(get, mode, direct, **kw):
    pol = get(ARCH, mode=mode, **kw)
    if not direct:
        return pol
    groups = tuple(dataclasses.replace(g, method="direct")
                   if g.name == "experts" else g for g in pol.groups)
    return dataclasses.replace(pol, groups=groups)


def _compare_sums(jpol, tpol, T=16):
    jm, jp, tm, tp = _models()
    toks = _tokens(3, T)
    want, waux = jax.jit(lambda p, b: jbk_clipped_sum(jm.apply, p, b, jpol))(
        jp, {"tokens": jnp.asarray(toks)})
    got, gaux = bk_clipped_sum(tm.apply, tp, {"tokens": torch.from_numpy(toks)},
                               tpol)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **TOL)
    np.testing.assert_allclose(gaux["per_sample_norms"].numpy(),
                               np.asarray(waux["per_sample_norms"]), **TOL)
    assert sorted(gaux["group_norms"]) == ["dense", "experts", "router"]
    for part in ("group_norms", "group_clip_factors"):
        for u in waux[part]:
            np.testing.assert_allclose(gaux[part][u].numpy(),
                                       np.asarray(waux[part][u]),
                                       err_msg=f"{part}:{u}", **TOL)


@pytest.mark.parametrize("direct", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_clipped_sum_matches_jax(mode, direct):
    """The registered policy (experts/router/dense groups), and the same
    with the experts group forced to the direct norm; the JAX side on its
    jnp path, the port's wrappers on their plain versions (CPU)."""
    _compare_sums(_policy(jget_policy, mode, direct, use_kernels=False),
                  _policy(get_policy, mode, direct))


def test_clipped_sum_matches_jax_with_its_pallas_kernels():
    """The reference as the train driver runs it (kernels on, interpret),
    with the experts forced direct: moe_direct_norm and moe_clipped_grad."""
    _compare_sums(_policy(jget_policy, "bk-mixopt", True),
                  _policy(get_policy, "bk-mixopt", True))


def test_train_cli_runs_moe_on_cpu():
    params, losses = ttrain.main(["--arch", ARCH, "--smoke", "--device",
                                  "cpu", "--steps", "2", "--seq", "16",
                                  "--sigma", "0.5"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert params["blocks"]["mlp"]["experts"]["up"]["w"].device.type == "cpu"


def test_train_cli_moe_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--arch", ARCH, "--smoke", "--steps", "1"])
