"""The port's train step against the JAX package's pieces composed by hand
(``fold_in(rng, step)`` -> ``bk_clipped_sum`` -> ``noise_leaf_fn`` ->
``update_leaves``): 3 AdamW steps at sigma=0.5, each package drawing its
own noise under the same keys (the port's counter-based draws are the
reference's, tests/test_torch_noise.py). Also the train CLI on the CPU,
and its refusal to run without a card unless asked."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import get_policy as jget_policy
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.policy import noise_leaf_fn as jnoise_leaf_fn
from repro.core.policy import resolve_policy as jresolve_policy
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro.optim.schedules import make_schedule as jmake_schedule
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, get_policy, smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import noise
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import TrainState, make_train_step
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import make_schedule

TOL = dict(rtol=1e-3, atol=1e-4)        # tests/test_kernel_parity.py:15
STEPS, B, T, LR, SIGMA, SEED = 3, 4, 16, 1e-2, 0.5, 0


@pytest.mark.parametrize("optimizer", ["adamw", "sgd"])
def test_three_noised_steps_match_jax_pieces(optimizer):
    jcfg = jsmoke("qwen2-1.5b").with_(dtype="float32", param_dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(SEED))
    tp = params_from_jax({k: np.asarray(v) for k, v in jflatten(jp).items()},
                         "cpu")
    batches = [np.random.default_rng(s).integers(0, 64, (B, T)).astype(
        np.int32) for s in range(STEPS)]

    # ---- JAX: the step's pieces composed by hand (no mesh)
    jpol = jget_policy("qwen2-1.5b", mode="bk-mixopt", sigma=SIGMA,
                       use_kernels=False)
    jres = jresolve_policy(jpol, jflatten(jp))
    jopt = jmake_optimizer(optimizer, jmake_schedule("cosine", LR, 0, STEPS))
    jstate = jopt.init(jp)
    base = jax.random.PRNGKey(SEED + 1)
    sums_fn = jax.jit(lambda p, b: jbk_clipped_sum(jm.apply, p, b, jpol))

    @jax.jit
    def noise_update(p, st, sums, rng, step):
        leaf = jnoise_leaf_fn(jpol, jres, rng, float(B), step=step)
        return jopt.update_leaves(lambda path, x: leaf(path, sums[path]), st,
                                  p, step)

    jlosses = []
    for step in range(STEPS):
        rng = jax.random.fold_in(base, step)
        sums, aux = sums_fn(jp, {"tokens": jnp.asarray(batches[step])})
        jlosses.append(float(aux["loss"]))
        jp, jstate = noise_update(jp, jstate, sums, rng, jnp.int32(step))

    # ---- the port's step, drawing its own noise from the same base key
    tm = build(smoke_config("qwen2-1.5b").with_(param_dtype="float32"))
    opt = make_optimizer(optimizer, make_schedule("cosine", LR, 0, STEPS))
    step_fn = make_train_step(
        tm.apply, tp, opt, get_policy("qwen2-1.5b", mode="bk-mixopt",
                                      sigma=SIGMA))
    state = TrainState(tp, opt.init(tp), 0, noise.prng_key(SEED + 1))
    losses = []
    for step in range(STEPS):
        state, loss = step_fn(state, {"tokens": torch.from_numpy(
            batches[step])})
        losses.append(float(loss))
    assert state.step == STEPS
    np.testing.assert_allclose(losses, jlosses, **TOL)
    got = params_to_numpy(state.params)
    for k, v in jflatten(jp).items():
        np.testing.assert_allclose(got[k], np.asarray(v), err_msg=k, **TOL)


def test_private_grad_matches_jax():
    """bk_private_grad: clipped sum + noise + 1/B under the same key, vs
    the JAX one."""
    from repro.core.bk import bk_private_grad as jbk_private_grad
    from repro_torch.core.bk import bk_private_grad
    from repro_torch.utils.tree import flatten
    jm = jbuild(jsmoke("qwen2-1.5b").with_(dtype="float32",
                                           param_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(1))
    toks = np.random.default_rng(5).integers(0, 64, (B, T)).astype(np.int32)
    jpol = jget_policy("qwen2-1.5b", sigma=SIGMA, use_kernels=False)
    rng = jax.random.PRNGKey(9)
    want, _ = jax.jit(lambda p, b: jbk_private_grad(jm.apply, p, b, rng,
                                                    jpol))(
        jp, {"tokens": jnp.asarray(toks)})
    flat = jflatten(jp)
    tm = build(smoke_config("qwen2-1.5b").with_(param_dtype="float32"))
    tp = params_from_jax({k: np.asarray(v) for k, v in flat.items()}, "cpu")
    got, _ = bk_private_grad(
        tm.apply, tp, {"tokens": torch.from_numpy(toks)}, noise.prng_key(9),
        get_policy("qwen2-1.5b", sigma=SIGMA))
    got = flatten(got)
    for k, v in jflatten(want).items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(v), err_msg=k,
                                   **TOL)


def _draw(seed, step, path, shape):
    key = noise._path_rng(noise.fold_in(noise.prng_key(seed), step), path)
    return noise.counter_normal(key, shape)


def test_noise_is_a_pure_function_of_seed_step_and_path():
    a = _draw(7, 2, "blocks/mlp/up/w", (3, 4))
    b = _draw(7, 2, "blocks/mlp/up/w", (3, 4))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    for other in [_draw(7, 3, "blocks/mlp/up/w", (3, 4)),
                  _draw(7, 2, "blocks/mlp/down/w", (3, 4)),
                  _draw(8, 2, "blocks/mlp/up/w", (3, 4))]:
        assert not torch.equal(a, other)
    x = _draw(0, 0, "head/w", (200000,))
    assert abs(float(x.mean())) < 0.01 and abs(float(x.std()) - 1) < 0.01


def test_gaussian_mechanism_adds_scaled_noise_and_divides():
    g = torch.ones(5)
    rng = noise.fold_in(noise.prng_key(0), 0)
    mech = noise.GaussianMechanism()
    out = mech.add_leaf("w", g, rng, sigma=0.5, scale=3.0, denom=4.0)
    xi = noise.counter_normal(noise._path_rng(rng, "w"), (5,))
    torch.testing.assert_close(out, (1 + 0.5 * 3 * xi) / 4)
    assert torch.equal(mech.add_leaf("w", g, rng, 0.0, 3.0, 4.0), g / 4)


def test_microbatched_sum_equals_full_batch():
    from repro_torch.optim.accumulate import accumulated_clipped_sum
    tm = build(smoke_config("qwen2-1.5b").with_(param_dtype="float32"))
    tp = tm.init(0, "cpu")
    batch = {"tokens": torch.from_numpy(
        np.random.default_rng(0).integers(0, 64, (4, T)).astype(np.int32))}
    pol = get_policy("qwen2-1.5b")
    full, faux, n = accumulated_clipped_sum(tm.apply, tp, batch, pol, 0)
    mb, maux, m = accumulated_clipped_sum(tm.apply, tp, batch, pol, 2)
    assert n == m == 4
    for k in full:
        torch.testing.assert_close(mb[k], full[k], rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(maux["per_sample_norms"],
                               faux["per_sample_norms"])


def test_train_cli_runs_on_cpu():
    params, losses = ttrain.main(["--smoke", "--device", "cpu", "--steps",
                                  "2", "--seq", "16", "--sigma", "0.5"])
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert params["blocks"]["mlp"]["up"]["w"].device.type == "cpu"


def test_train_cli_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device runs")
    with pytest.raises(RuntimeError, match="--device cpu"):
        ttrain.main(["--smoke", "--steps", "1"])
