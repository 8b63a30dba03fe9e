"""The port's train driver on the CPU at smoke size, against the JAX
package's accountant and pieces: sigma calibrated by ``--epsilon`` equal to
the reference's ``budget_for`` (the sgm and the tree accountant), the
end-of-run epsilon equal to the reference ledger's for the same steps, the
three FTRL refusals of tests/test_ftrl.py by their assertions (the
reference driver itself builds a device mesh and is not run here), four
DP-FTRL steps with a restart against ``repro.core.bk.bk_clipped_sum`` +
``noise_leaf_fn`` + ``repro.optim.ftrl`` composed by hand, and the JSON
summary (its ``params_sha256`` the reference's ``params_digest`` of the
same parameters)."""
import dataclasses
import json
import math

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint.run_state import params_digest as jparams_digest
from repro.configs.registry import build as jbuild
from repro.configs.registry import get_policy as jget_policy
from repro.configs.registry import smoke_config as jsmoke
from repro.core import accounting as ja
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.policy import noise_leaf_fn as jnoise_leaf_fn
from repro.core.policy import resolve_policy as jresolve_policy
from repro.data.pipeline import Pipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro.optim.optimizers import make_optimizer as jmake_optimizer
from repro.utils.tree import flatten as jflatten
from repro_torch.checkpoint.run_state import params_digest
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core.bk import DPConfig
from repro_torch.core.policy import ParamGroup, PrivacyPolicy
from repro_torch.launch import train as ttrain

TOL = dict(rtol=1e-3, atol=1e-4)        # tests/test_kernel_parity.py:15
B, T, N, DELTA = 8, 16, 50000, 1e-5
CFG = smoke_config("qwen2-1.5b").with_(param_dtype="float32")


def _quiet(*a):
    pass


def _budget(mech, steps, restart=0):
    return ja.budget_for(3.0, DELTA, B, N, steps * B / N, mechanism=mech,
                         restart_every=restart)


def test_ftrl_cli_sigma_and_epsilon_are_the_reference_accountants(
        tmp_path):
    """The acceptance line: the CLI's DP-FTRL run calibrates sigma with the
    tree accountant and ends with the reference ledger's epsilon; its
    summary has the reference's keys."""
    out = tmp_path / "s.json"
    params, losses = ttrain.main(
        ["--smoke", "--device", "cpu", "--optimizer", "ftrl",
         "--restart-every", "2", "--tree-completion", "--epsilon", "3",
         "--steps", "4", "--seq", str(T), "--out", str(out)])
    summary = json.loads(out.read_text())
    assert sorted(summary) == ["delta", "epsilon", "ledger", "params_sha256",
                               "resumed_from", "steps_done"]
    assert len(losses) == 4 and all(math.isfinite(x) for x in losses)
    (entry,) = summary["ledger"]["entries"]
    want = _budget("tree", 4, restart=2)
    assert entry["sigma"] == want.sigma and entry["mechanism"] == "tree"
    assert (entry["restart_every"], entry["steps"]) == (2, 4)
    led = ja.PrivacyLedger()
    for step in range(4):
        led.record_to(step + 1, sigma=want.sigma, sample_rate=B / N,
                      mechanism="tree", restart_every=2, participations=1)
    assert summary["epsilon"] == led.epsilon(DELTA) <= 3.0
    assert summary["steps_done"] == 4 and summary["resumed_from"] == 0
    assert ja.PrivacyLedger.from_json(summary["ledger"]).entries == \
        led.entries
    assert summary["params_sha256"] == params_digest(params)


def test_sgm_calibration_epsilon_and_digest():
    """AdamW under --epsilon: sigma by the sgm accountant, the ledger's
    epsilon the reference's, and the digest equal to the reference's
    params_digest of the converted parameters."""
    summary, logs = {}, []
    tc = TrainConfig(global_batch=B, seq_len=T, steps=2, lr=1e-3,
                     log_every=1)
    params, _ = ttrain.train(CFG, tc, ttrain.resolve_dp(
        "qwen2-1.5b", "auto", "bk-mixopt", "automatic", 0.0, log=_quiet),
        device="cpu", log=logs.append, dataset_size=N, target_epsilon=3.0,
        summary_out=summary)
    want = _budget("sgm", 2)
    (entry,) = summary["ledger"]["entries"]
    assert entry["sigma"] == want.sigma and entry["mechanism"] == "sgm"
    assert summary["epsilon"] == ja.compute_epsilon(want.sigma, B / N, 2,
                                                    DELTA)
    assert any("sgm accountant" in m for m in logs), logs
    assert any("privacy spent" in m for m in logs), logs
    flat = params_to_numpy(params)
    assert summary["params_sha256"] == jparams_digest(
        {k: jnp.asarray(v) for k, v in flat.items()})


def test_params_digest_bf16_matches_the_reference():
    r = np.random.default_rng(0)
    a = r.standard_normal((3, 5)).astype(ml_dtypes.bfloat16)
    b = r.standard_normal((4,)).astype(np.float32)
    port = params_from_jax({"x/w": a, "y/b": b}, "cpu")
    assert port["x"]["w"].dtype == torch.bfloat16
    assert params_digest(port) == jparams_digest(
        {"x": {"w": jnp.asarray(a)}, "y": {"b": jnp.asarray(b)}})


# the refusals of tests/test_ftrl.py:104-160, on the port's driver
def test_train_honors_policy_configured_tree_noise():
    pol = PrivacyPolicy(groups=(ParamGroup("all", ".*"),), mode="bk",
                        sigma=0.3, noise="tree", noise_depth=4,
                        noise_restart_every=2, noise_completion=True)
    logs = []
    tc = TrainConfig(global_batch=4, seq_len=T, steps=5, lr=1e-3,
                     lr_schedule="constant", optimizer="ftrl")
    _, losses = ttrain.train(CFG, tc, pol, device="cpu", log=logs.append)
    assert np.all(np.isfinite(losses)) and len(losses) == 5
    assert any("restart_every=2" in str(m) and "depth=4" in str(m)
               and "completion=True" in str(m) for m in logs), logs
    with pytest.raises(ValueError, match="restart together"):
        ttrain.train(CFG, dataclasses.replace(tc, restart_every=3), pol,
                     device="cpu", log=_quiet)


def test_train_rejects_undersized_tree_depth():
    pol = PrivacyPolicy(groups=(ParamGroup("all", ".*"),), mode="bk",
                        sigma=0.3, noise="tree", noise_depth=3)
    tc = TrainConfig(global_batch=4, seq_len=T, steps=20, optimizer="adamw")
    with pytest.raises(ValueError, match="noise_depth"):
        ttrain.train(CFG, tc, pol, device="cpu", log=_quiet)


@pytest.mark.parametrize("knob", [dict(restart_every=10),
                                  dict(tree_completion=True),
                                  dict(ftrl_momentum=0.9)])
def test_train_rejects_ftrl_knobs_on_other_optimizers(knob):
    tc = TrainConfig(global_batch=4, seq_len=T, steps=2, optimizer="adamw",
                     **knob)
    with pytest.raises(ValueError, match="ftrl"):
        ttrain.train(CFG, tc, DPConfig(mode="bk", sigma=0.1), device="cpu",
                     log=_quiet)


def test_tree_completion_needs_restarts():
    tc = TrainConfig(global_batch=4, seq_len=T, steps=2, optimizer="ftrl",
                     tree_completion=True)
    with pytest.raises(ValueError, match="restart-every"):
        ttrain.train(CFG, tc, DPConfig(mode="bk", sigma=0.1), device="cpu",
                     log=_quiet)


def test_four_ftrl_steps_match_the_reference_pieces(monkeypatch):
    """train() under --optimizer ftrl (momentum 0.9, restarts every 2 with
    completion, sigma from --epsilon), from the reference's initial
    params: its losses and final params against the JAX package's step
    composed by hand (the same batches: the pipelines are bitwise equal)."""
    steps, lr, mom, restart = 4, 1e-2, 0.9, 2
    jcfg = jsmoke("qwen2-1.5b").with_(dtype="float32", param_dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    flat0 = {k: np.asarray(v) for k, v in jflatten(jp).items()}
    sigma = _budget("tree", steps, restart).sigma

    # ---- JAX: the tree policy the driver builds, the pieces by hand
    jpol = dataclasses.replace(
        jget_policy("qwen2-1.5b", mode="bk-mixopt", sigma=sigma,
                    use_kernels=False),
        noise="tree", noise_depth=2, noise_restart_every=restart,
        noise_completion=True)
    jres = jresolve_policy(jpol, jflatten(jp))
    jopt = jmake_optimizer("ftrl", lambda s: lr, momentum=mom,
                           restart_every=restart)
    jstate = jopt.init(jp)
    pipe = JPipeline(jcfg, JPipelineConfig(B, T, seed=0))
    base = jax.random.PRNGKey(1)
    sums_fn = jax.jit(lambda p, b: jbk_clipped_sum(jm.apply, p, b, jpol))

    @jax.jit
    def update(p, st, sums, step):
        leaf = jnoise_leaf_fn(jpol, jres, jax.random.fold_in(base, step),
                              float(B), step=step)
        return jopt.update_leaves(lambda path, x: leaf(path, sums[path]),
                                  st, p, step)

    jlosses = []
    for step in range(steps):
        sums, aux = sums_fn(jp, pipe.batch(step))
        jlosses.append(float(aux["loss"]))
        jp, jstate = update(jp, jstate, sums, jnp.int32(step))

    # ---- the port's driver from the same initial params
    model = ttrain.build(CFG)
    monkeypatch.setattr(model, "init",
                        lambda seed, dev: params_from_jax(flat0, dev))
    monkeypatch.setattr(ttrain, "build", lambda cfg: model)
    tc = TrainConfig(global_batch=B, seq_len=T, steps=steps, lr=lr,
                     lr_schedule="constant", optimizer="ftrl",
                     ftrl_momentum=mom, restart_every=restart,
                     tree_completion=True)
    summary = {}
    params, losses = ttrain.train(
        CFG, tc, ttrain.resolve_dp("qwen2-1.5b", "auto", "bk-mixopt",
                                   "automatic", 0.0, log=_quiet),
        device="cpu", log=_quiet, dataset_size=N, target_epsilon=3.0,
        summary_out=summary)
    assert summary["ledger"]["entries"][0]["sigma"] == sigma
    np.testing.assert_allclose(losses, jlosses, **TOL)
    got = params_to_numpy(params)
    for k, v in jflatten(jp).items():
        np.testing.assert_allclose(got[k], np.asarray(v), err_msg=k, **TOL)


@pytest.mark.parametrize("arch,layers,want", [
    ("qwen2-1.5b", 14, dict(n_layers=14)),
    ("hymba-1.5b", 5, dict(n_layers=5, full_attn_layers=(0, 2, 4))),
    ("whisper-small", 2, dict(n_layers=2, encoder_layers=2)),
    ("rwkv6-3b", 0, dict(n_layers=32))])
def test_layers_flag_cuts_depth_at_full_width(arch, layers, want):
    """``--layers N`` hands ``train`` the arch at full width cut to N layers
    (``configs.registry.cut_depth``; 0 keeps every layer): a hybrid keeps
    its first, middle and last layers global, an encoder-decoder cuts both
    stacks."""
    from repro_torch.configs.registry import cut_depth, get_config
    kwargs, _ = ttrain.cli_args(["--arch", arch, "--layers", str(layers),
                                 "--device", "cpu"])
    full = get_config(arch)
    cfg = kwargs["model_cfg"]
    assert cfg == cut_depth(full, layers)
    assert cfg.d_model == full.d_model and cfg.vocab == full.vocab
    for k, v in want.items():
        assert getattr(cfg, k) == v, k
