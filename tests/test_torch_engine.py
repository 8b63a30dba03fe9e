"""The port's engine against the JAX package's on the smoke qwen2-1.5b (f32):
each of the eight modes of ``make_grad_fn`` against the same mode of the
JAX package under the registered policy (2 clip units) and under a policy
with a frozen group and a method override; ``accumulated_private_grad``
with microbatches; one ``make_train_step`` step of each baseline mode
against the reference's ``accumulated_private_grad`` + ``Optimizer.update``
composed by hand (no mesh); ``PrivacyEngine``; and the train CLI's
``--mode``. Inputs from numpy, params through ``repro_torch.convert``; where
sigma > 0 each package draws its own phase-4 noise under the same key (the
port's draws are the reference's, tests/test_torch_noise.py). The JAX side
runs ``use_kernels=False``."""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import get_policy as jget_policy
from repro.configs.registry import smoke_config as jsmoke
from repro.core.engine import ALL_MODES as JALL_MODES
from repro.core.engine import make_grad_fn as jmake_grad_fn
from repro.core.policy import ParamGroup as JParamGroup
from repro.core.policy import PrivacyPolicy as JPrivacyPolicy
from repro.optim.accumulate import \
    accumulated_private_grad as jaccumulated_private_grad
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro.optim.schedules import make_schedule as jmake_schedule
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, get_policy, smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.bk import plan_report
from repro_torch.core.engine import ALL_MODES, PrivacyEngine, make_grad_fn
from repro_torch.core.noise import prng_key
from repro_torch.core.policy import ParamGroup, PrivacyPolicy
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.optim.accumulate import accumulated_private_grad
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import make_schedule
from repro_torch.utils.tree import flatten, unflatten

B, T, SEED, RNG, LR = 4, 16, 0, 9, 1e-2
NORM_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_bk_equivalence.py:40
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)     # :42
NOISE_TOL = dict(rtol=1e-4, atol=1e-5)    # :53
TOL = dict(rtol=1e-3, atol=1e-4)          # tests/test_kernel_parity.py:15
BASELINES = [m for m in ALL_MODES if not m.startswith("bk")]


def _frozen(pkg_group, pkg_policy, mode, sigma=0.0, **kw):
    """The embedding frozen, the head its own unit on the direct norm, the
    trunk one flat pool."""
    return pkg_policy(groups=(
        pkg_group("embed", "embed", trainable=False),
        pkg_group("head", "head", R=0.5, scope="group", method="direct"),
        pkg_group("trunk", ".*", R=1.0)), mode=mode, sigma=sigma, **kw)


def _policies(name, mode, sigma=0.0):
    """-> (JAX policy, port policy) of the same name."""
    if name == "registered":
        return (jget_policy("qwen2-1.5b", mode=mode, sigma=sigma,
                            use_kernels=False),
                get_policy("qwen2-1.5b", mode=mode, sigma=sigma))
    return (_frozen(JParamGroup, JPrivacyPolicy, mode, sigma,
                    use_kernels=False),
            _frozen(ParamGroup, PrivacyPolicy, mode, sigma))


@functools.lru_cache(maxsize=None)
def _setup():
    jm = jbuild(jsmoke("qwen2-1.5b").with_(dtype="float32",
                                           param_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(SEED))
    toks = np.random.default_rng(5).integers(0, 64, (B, T)).astype(np.int32)
    tm = build(smoke_config("qwen2-1.5b").with_(param_dtype="float32"))
    return jm, jp, toks, tm


def _port_params():
    """A fresh copy of the JAX params (the port's steps update in place)."""
    _, jp, _, _ = _setup()
    return params_from_jax({k: np.asarray(v) for k, v in jflatten(jp).items()},
                           "cpu")


def _close(got: dict, want, tol):
    want = {k: np.asarray(v) for k, v in jflatten(want).items()}
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(np.asarray(got[k]), want[k], err_msg=k,
                                   **tol)


def test_all_modes_are_the_jax_packages():
    assert ALL_MODES == JALL_MODES


@pytest.mark.parametrize("mode", ALL_MODES)
@pytest.mark.parametrize("policy", ["registered", "frozen_group"])
def test_mode_matches_jax_same_mode(policy, mode):
    """Each mode of the port against the same mode of the JAX package:
    grads and per-sample norms (total, and each unit's) at
    test_bk_equivalence's tolerances; frozen leaves zero."""
    jm, jp, toks, tm = _setup()
    jpol, tpol = _policies(policy, mode)
    want, waux = jax.jit(jmake_grad_fn(jm.apply, jpol))(
        jp, {"tokens": jnp.asarray(toks)}, jax.random.PRNGKey(RNG))
    got, aux = make_grad_fn(tm.apply, tpol)(
        _port_params(), {"tokens": torch.from_numpy(toks)}, prng_key(RNG))
    _close({k: v.numpy() for k, v in flatten(got).items()}, want, GRAD_TOL)
    np.testing.assert_allclose(float(aux["loss"]), float(waux["loss"]),
                               rtol=1e-6)
    if mode == "nonprivate":
        return
    np.testing.assert_allclose(aux["per_sample_norms"].numpy(),
                               np.asarray(waux["per_sample_norms"]),
                               **NORM_TOL)
    assert sorted(aux["group_norms"]) == sorted(waux["group_norms"])
    for u, n in waux["group_norms"].items():
        np.testing.assert_allclose(aux["group_norms"][u].numpy(),
                                   np.asarray(n), err_msg=u, **NORM_TOL)
    if policy == "frozen_group":
        assert not flatten(got)["embed/w"].any()


@pytest.mark.parametrize("mode", ["nonprivate", "ghostclip", "opacus"])
def test_accumulated_private_grad_microbatches_match_jax(mode):
    """Microbatches of 2 over B = 4: each at sigma 0, scaled back to sums,
    noised once (sigma 0.5, the port's own draws) or, for nonprivate, the
    mean;
    against the reference's ``accumulated_private_grad`` (no mesh)."""
    jm, jp, toks, tm = _setup()
    jpol, tpol = _policies("registered", mode, sigma=0.5)
    rng = jax.random.PRNGKey(RNG)
    want, waux = jax.jit(lambda p, b: jaccumulated_private_grad(
        jm.apply, p, b, rng, jpol, 2, 0))(jp, {"tokens": jnp.asarray(toks)})
    got, aux = accumulated_private_grad(
        tm.apply, _port_params(), {"tokens": torch.from_numpy(toks)},
        prng_key(RNG), tpol, 2, 0)
    _close({k: v.numpy() for k, v in flatten(got).items()}, want, NOISE_TOL)
    np.testing.assert_allclose(float(aux["loss"]), float(waux["loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", BASELINES)
def test_train_step_matches_jax_update(mode):
    """One AdamW step of each baseline mode (sigma 0.5, each package's own
    draws under the same key)
    against the reference composed by hand: ``fold_in(rng, step)`` ->
    ``accumulated_private_grad`` -> ``Optimizer.update``."""
    jm, jp, toks, tm = _setup()
    jpol, tpol = _policies("registered", mode, sigma=0.5)
    jopt = jmake_optimizer("adamw", jmake_schedule("cosine", LR, 0, 1))
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED + 1), 0)

    @jax.jit
    def jstep(p, st, b):
        grads, aux = jaccumulated_private_grad(jm.apply, p, b, rng, jpol, 0,
                                               jnp.int32(0))
        return jopt.update(grads, st, p, jnp.int32(0)) + (aux["loss"],)

    want_p, _, jloss = jstep(jp, jopt.init(jp), {"tokens": jnp.asarray(toks)})
    tp = _port_params()
    opt = make_optimizer("adamw", make_schedule("cosine", LR, 0, 1))
    step_fn = make_train_step(tm.apply, tp, opt, tpol)
    state, loss = step_fn(TrainState(tp, opt.init(tp), 0,
                                     prng_key(SEED + 1)),
                          {"tokens": torch.from_numpy(toks)})
    assert state.step == 1
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    _close(params_to_numpy(state.params), want_p, TOL)


def test_optimizer_update_is_update_leaves():
    """``update`` over a materialized tree is ``update_leaves`` over its
    leaves, bitwise (both optimizers)."""
    for name in ("adamw", "sgd"):
        opt = make_optimizer(name, lambda s: 0.1, weight_decay=0.01)
        a, b = _port_params(), _port_params()
        grads = {k: torch.full_like(v, 0.5) for k, v in flatten(a).items()}
        pa, sa = opt.update(unflatten(grads), opt.init(a), a, 0)
        pb, sb = opt.update_leaves(lambda path, p: grads[path], opt.init(b),
                                   b, 0)
        for k, v in flatten(pa).items():
            assert torch.equal(v, flatten(pb)[k]), (name, k)


def test_privacy_engine_grad_and_kernel_report():
    """``PrivacyEngine.grad`` is ``make_grad_fn``'s; ``kernel_report`` is
    ``core.bk.plan_report`` (the qwen2 smoke taps under mode 'bk': five mm
    taps and the embedding, all ghost)."""
    _, _, toks, tm = _setup()
    pol = get_policy("qwen2-1.5b", mode="bk")
    engine = PrivacyEngine(tm.apply, pol)
    tp, batch = _port_params(), {"tokens": torch.from_numpy(toks)}
    got, _ = engine.grad(tp, batch, prng_key(SEED))
    want, _ = make_grad_fn(tm.apply, pol)(tp, batch, prng_key(SEED))
    for k, v in flatten(want).items():
        assert torch.equal(flatten(got)[k], v), k
    report = engine.kernel_report(tp, batch)
    assert report.keys() == plan_report(tm.apply, tp, batch, pol).keys()
    assert len(report) == 6
    assert {plans["norm"].method for plans in report.values()} == {"ghost"}


def test_privacy_engine_target_epsilon_needs_the_accountant():
    """With the accountant ported, target_epsilon calibrates sigma by
    budget_for (the reference's budget) instead of raising, on two grids
    (batch, dataset size, epochs); without it there is no budget."""
    from repro.core.accounting import budget_for
    _, _, _, tm = _setup()
    for batch, n, epochs in ((4, 1000, 1.0), (64, 50000, 0.5)):
        engine = PrivacyEngine(tm.apply, get_policy("qwen2-1.5b"),
                               batch_size=batch, dataset_size=n,
                               epochs=epochs, target_epsilon=3.0)
        want = budget_for(3.0, 1e-5, batch, n, epochs)
        assert vars(engine.budget) == vars(want)
        assert engine.policy.sigma == want.sigma
    assert PrivacyEngine(tm.apply, get_policy("qwen2-1.5b")).budget is None


@pytest.mark.parametrize("mode", ALL_MODES)
def test_train_cli_accepts_every_mode(mode):
    params, losses = ttrain.main(["--smoke", "--device", "cpu", "--steps",
                                  "1", "--seq", "16", "--sigma", "0.5",
                                  "--mode", mode])
    assert len(losses) == 1 and math.isfinite(losses[0])
    assert params["head"]["w"].device.type == "cpu"


def test_opacus_runs_the_moe_family():
    """torch.func.vmap runs the MoE dispatch (no in-place scatter, no
    one_hot): opacus on the smoke deepseek-moe-16b against the JAX
    package's opacus, under the registered policy."""
    jm = jbuild(jsmoke("deepseek-moe-16b").with_(dtype="float32",
                                                 param_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(SEED))
    toks = np.random.default_rng(6).integers(0, 64, (B, T)).astype(np.int32)
    want, waux = jax.jit(jmake_grad_fn(jm.apply, jget_policy(
        "deepseek-moe-16b", mode="opacus", use_kernels=False)))(
        jp, {"tokens": jnp.asarray(toks)}, jax.random.PRNGKey(RNG))
    tm = build(smoke_config("deepseek-moe-16b").with_(param_dtype="float32"))
    tp = params_from_jax({k: np.asarray(v) for k, v in jflatten(jp).items()},
                         "cpu")
    got, aux = make_grad_fn(tm.apply, get_policy("deepseek-moe-16b",
                                                 mode="opacus"))(
        tp, {"tokens": torch.from_numpy(toks)}, prng_key(RNG))
    _close({k: v.numpy() for k, v in flatten(got).items()}, want, GRAD_TOL)
    np.testing.assert_allclose(aux["per_sample_norms"].numpy(),
                               np.asarray(waux["per_sample_norms"]),
                               **NORM_TOL)
