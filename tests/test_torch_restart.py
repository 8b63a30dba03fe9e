"""Checkpoint and restart of the port's train driver on the CPU, by the
assertions of tests/test_elastic_restart.py and
tests/test_system.py::test_train_resume_exact (whose reference runs build a
device mesh and are not run here).

Each run is the port's CLI (``repro_torch.launch.train.main``, the argv of
tests/test_elastic_restart.py with ``--device cpu``) in a subprocess with
faults injected through ``REPRO_FAULT``: killed at a step (SGD, and FTRL
across a restart boundary), preempted by SIGTERM, killed in the middle of a
checkpoint write and before its commit; run again with the same command
line, it ends bitwise where the run that never stopped ends
(``params_sha256``) with the same epsilon. Every child runs with the same
explicit thread count, so the runs compute alike. Also: a continuation to
more steps, ``check_resume`` raising on each privacy-critical key and
logging the rest, and ``pack_meta`` equal to the JAX package's."""
import dataclasses
import json
import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import run_state as rrs
from repro.configs.base import TrainConfig as JTrainConfig
from repro.configs.registry import smoke_config as jsmoke
from repro.core.accounting import PrivacyLedger as JPrivacyLedger
from repro.core.policy import ParamGroup as JParamGroup
from repro.core.policy import PrivacyPolicy as JPrivacyPolicy
from repro.data.pipeline import Pipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.checkpoint import run_state as rs
from repro_torch.configs.base import TrainConfig
from repro_torch.configs.registry import smoke_config
from repro_torch.core.accounting import PrivacyLedger
from repro_torch.core.bk import DPConfig
from repro_torch.core.policy import ParamGroup, PrivacyPolicy
from repro_torch.data.pipeline import Pipeline, PipelineConfig
from repro_torch.launch import train as ttrain
from repro_torch.runtime import fault_injection as fi

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THREADS = 2
ENV = {"PYTHONPATH": "src", "OMP_NUM_THREADS": str(THREADS),
       "MKL_NUM_THREADS": str(THREADS)}
STEPS = 8


def _argv(ckpt_dir, out, steps=STEPS, optimizer="sgd"):
    argv = ["--arch", "qwen2-1.5b", "--smoke", "--device", "cpu",
            "--steps", str(steps), "--batch", "4", "--seq", "16",
            "--lr", "1e-3", "--optimizer", optimizer, "--mode", "bk",
            "--policy", "", "--sigma", "0.5", "--log-every", "100",
            "--ckpt-dir", str(ckpt_dir), "--ckpt-every", "2",
            "--out", str(out)]
    if optimizer == "ftrl":
        argv += ["--restart-every", "4"]
    return argv


def _run_train(ckpt_dir, out, fault=None, extra=(), **kw):
    argv = _argv(ckpt_dir, out, **kw) + list(extra)
    code = (f"import torch\ntorch.set_num_threads({THREADS})\n"
            "from repro_torch.launch.train import main\n"
            f"main({argv!r})\n")
    return fi.run_subprocess(code, fault=fault, env=ENV, cwd=ROOT)


def _summary(out) -> dict:
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """Uninterrupted runs, one per optimizer: what a crashed and resumed
    run must reproduce bitwise."""
    refs = {}
    for opt in ("sgd", "ftrl"):
        d = tmp_path_factory.mktemp(f"ref_{opt}")
        _run_train(d / "ck", d / "out.json", optimizer=opt)
        refs[opt] = _summary(d / "out.json")
        assert refs[opt]["steps_done"] == STEPS
        assert refs[opt]["resumed_from"] == 0
        assert np.isfinite(refs[opt]["epsilon"])
        saves = refs[opt]["checkpoints"]["saves"]
        assert [s["step"] for s in saves] == [0, 2, 4, 6]
        assert all(s["bytes"] > 0 and s["writer_seconds"] >= 0
                   for s in saves)
    return refs


@pytest.mark.parametrize("opt,kill_step", [("sgd", 5), ("ftrl", 6)])
def test_sigkill_resume_bitwise(tmp_path, reference, opt, kill_step):
    """SIGKILL mid-run, resume, finish: the final params bitwise and epsilon
    equal to the run that never crashed. The FTRL case crosses a tree and
    anchor restart (restart_every=4) before it dies."""
    ck, out = tmp_path / "ck", tmp_path / "out.json"
    _run_train(ck, out, optimizer=opt,
               fault=fi.FaultSpec("step", kill_step, "sigkill"))
    assert not os.path.exists(out)              # died before the summary
    assert ckpt.latest_step(str(ck)) is not None
    r = _run_train(ck, out, optimizer=opt)      # the same command line
    got = _summary(out)
    assert got["resumed_from"] > 0              # resumed, not re-run
    assert f"resumed from step {got['resumed_from'] - 1}" in r.stdout
    assert got["steps_done"] == STEPS
    assert got["params_sha256"] == reference[opt]["params_sha256"]
    assert got["epsilon"] == reference[opt]["epsilon"]
    assert got["ledger"] == reference[opt]["ledger"]
    assert got["checkpoints"]["restore_seconds"] > 0


def test_sigterm_preemption_graceful_resume(tmp_path, reference):
    """SIGTERM takes the graceful path: the guard's flag is set, the loop
    saves the current step and exits 0; the restarted run continues to the
    same bitwise result."""
    ck, out = tmp_path / "ck", tmp_path / "out.json"
    r = _run_train(ck, out, fault=fi.FaultSpec("step", 3, "sigterm"))
    assert "preempted at step 3; checkpoint saved" in r.stdout
    assert ckpt.latest_step(str(ck)) == 3       # the forced save
    assert _summary(out)["steps_done"] == 4
    _run_train(ck, out)
    got = _summary(out)
    assert got["resumed_from"] == 4
    assert got["params_sha256"] == reference["sgd"]["params_sha256"]
    assert got["epsilon"] == reference["sgd"]["epsilon"]


def test_sigkill_mid_checkpoint_write_resume(tmp_path, reference):
    """SIGKILL while the payload is written (the manifest not yet on disk):
    the torn write is invisible (only a .tmp dir, never a listed step) and
    the rerun still ends at the reference."""
    ck, out = tmp_path / "ck", tmp_path / "out.json"
    _run_train(ck, out, fault=fi.FaultSpec("ckpt_mid_write",
                                           action="sigkill"))
    assert ckpt.steps(str(ck)) == []            # nothing committed
    assert ckpt.latest_step(str(ck)) is None
    leftovers = os.listdir(str(ck))
    assert leftovers and all(d.endswith(".tmp") for d in leftovers)
    _run_train(ck, out)                         # starts from scratch
    got = _summary(out)
    assert got["resumed_from"] == 0
    assert got["params_sha256"] == reference["sgd"]["params_sha256"]
    assert got["epsilon"] == reference["sgd"]["epsilon"]


def test_sigkill_pre_commit_leaves_no_checkpoint(tmp_path):
    """SIGKILL after payload and manifest are written but before the
    rename: still no visible checkpoint, and a later save at the same step
    clears the stale staging dir and commits."""
    ck, out = tmp_path / "ck", tmp_path / "out.json"
    _run_train(ck, out, fault=fi.FaultSpec("ckpt_pre_commit",
                                           action="sigkill"))
    assert ckpt.latest_step(str(ck)) is None
    tmp_dirs = [d for d in os.listdir(str(ck)) if d.endswith(".tmp")]
    assert tmp_dirs, "a pre-commit kill leaves the staging dir"
    assert os.path.exists(os.path.join(str(ck), tmp_dirs[0], ckpt.MANIFEST))
    ckpt.save(str(ck), 0, {"w": torch.ones(2, 2)})
    assert ckpt.latest_step(str(ck)) == 0
    assert ckpt.steps(str(ck)) == [0]


def test_continuation_to_more_steps(tmp_path):
    """A finished 4-step run continued to ``--steps 6``: it resumes at 4,
    accounts 6 steps (epsilon larger than the 4-step run's) and logs the
    steps drift as non-critical."""
    ck = tmp_path / "ck"
    _run_train(ck, tmp_path / "a.json", steps=4, extra=["--ckpt-every", "1"])
    assert ckpt.latest_step(str(ck)) == 3
    first = _summary(tmp_path / "a.json")
    r = _run_train(ck, tmp_path / "b.json", steps=6)
    got = _summary(tmp_path / "b.json")
    assert got["resumed_from"] == 4 and got["steps_done"] == 6
    assert np.isfinite(got["epsilon"]) and got["epsilon"] > first["epsilon"]
    assert "resume config drift (non-critical) steps: 4 -> 6" in r.stdout


def test_resume_refuses_a_changed_sigma(tmp_path):
    """The CLI refuses to resume a checkpoint under another sigma (the
    ledger would describe a different release)."""
    ck = tmp_path / "ck"
    _run_train(ck, tmp_path / "a.json", steps=2)
    with pytest.raises(AssertionError, match="privacy-critical.*sigma"):
        _run_train(ck, tmp_path / "b.json", steps=4,
                   extra=["--sigma", "0.6"])


# --------------------------------------------- in-process resume, bitwise
def _smoke():
    return smoke_config("qwen2-1.5b").with_(param_dtype="float32")


def test_train_resume_exact(tmp_path):
    """train(10) == train(6, checkpoint every step) + resume to 10,
    bitwise (tests/test_system.py asks the same of the JAX package within
    rtol 1e-6)."""
    dp = DPConfig(mode="bk", clipping="automatic", sigma=0.2)
    quiet = lambda *a: None                                    # noqa: E731
    tc = TrainConfig(global_batch=4, seq_len=16, steps=10, lr=1e-3,
                     lr_schedule="constant")
    full, _ = ttrain.train(_smoke(), tc, dp, device="cpu", log=quiet)
    ttrain.train(_smoke(), dataclasses.replace(
        tc, steps=6, checkpoint_dir=str(tmp_path), checkpoint_every=1),
        dp, device="cpu", log=quiet)
    assert ckpt.steps(str(tmp_path)) == [3, 4, 5]       # keep 3
    summary = {}
    resumed, losses = ttrain.train(_smoke(), dataclasses.replace(
        tc, checkpoint_dir=str(tmp_path), checkpoint_every=100),
        dp, device="cpu", log=quiet, summary_out=summary)
    assert summary["resumed_from"] == 6 and len(losses) == 4
    assert summary["params_sha256"] == rs.params_digest(full)


# ------------------------------------------------------ the run state
def _run_state(pkg_policy, pkg_group, optimizer="sgd", restart=0):
    tree = optimizer == "ftrl"
    return pkg_policy(groups=(pkg_group("all", ".*"),), mode="bk",
                      sigma=0.5, noise="tree" if tree else "gaussian",
                      noise_depth=3 if tree else 0,
                      noise_restart_every=restart)


@pytest.mark.parametrize("optimizer,restart", [("sgd", 0), ("ftrl", 4)])
def test_pack_meta_equals_the_references(optimizer, restart):
    """For the same run config, the port's manifest meta is the JAX
    package's JSON: the noise state, the ledger, the pipeline and the
    fingerprint."""
    kw = dict(global_batch=4, seq_len=16, steps=8, lr=1e-3,
              optimizer=optimizer, restart_every=restart, seed=3)
    metas = []
    for TC, PP, PG, PL, Pipe, PCfg, cfg, mod in (
            (TrainConfig, PrivacyPolicy, ParamGroup, PrivacyLedger, Pipeline,
             PipelineConfig, smoke_config("qwen2-1.5b"), rs),
            (JTrainConfig, JPrivacyPolicy, JParamGroup, JPrivacyLedger,
             JPipeline, JPipelineConfig, jsmoke("qwen2-1.5b"), rrs)):
        tc = TC(**kw)
        policy = _run_state(PP, PG, optimizer, restart)
        ledger = PL()
        for step in range(5):
            ledger.record_to(step + 1, sigma=0.5, sample_rate=4 / 50000,
                             mechanism="tree" if restart else "sgm",
                             restart_every=restart)
        pipe = Pipe(cfg, PCfg(4, 16, seed=3))
        metas.append(json.dumps(mod.pack_meta(
            policy.mechanism(), ledger, pipe,
            mod.config_fingerprint(tc, policy, restart)), sort_keys=True))
    assert metas[0] == metas[1]
    assert rs.RUN_STATE_VERSION == rrs.RUN_STATE_VERSION
    assert rs.PRIVACY_CRITICAL == rrs.PRIVACY_CRITICAL


def _resume_inputs(**tc_kw):
    tc = TrainConfig(global_batch=4, seq_len=16, steps=8, lr=1e-3, seed=3)
    policy = _run_state(PrivacyPolicy, ParamGroup)
    pipe = Pipeline(smoke_config("qwen2-1.5b"), PipelineConfig(4, 16, seed=3),
                    device="cpu")
    ledger = PrivacyLedger()
    ledger.record_to(3, sigma=0.5, sample_rate=0.1)
    meta = rs.pack_meta(policy.mechanism(), ledger, pipe,
                        rs.config_fingerprint(tc, policy, 0))
    return meta, policy, pipe, rs.config_fingerprint(tc, policy, 0)


@pytest.mark.parametrize("key", rs.PRIVACY_CRITICAL)
def test_check_resume_raises_on_privacy_critical_drift(key):
    meta, policy, pipe, config = _resume_inputs()
    changed = {"seed": 4, "sigma": 0.6, "global_batch": 8,
               "optimizer": "lamb", "restart_every": 2, "noise": "tree",
               "mode": "bk-mixopt"}[key]
    with pytest.raises(ValueError, match=f"privacy-critical.*{key}"):
        rs.check_resume(meta, policy.mechanism(), pipe,
                        dict(config, **{key: changed}), log=lambda m: None)


def test_check_resume_logs_other_drift_and_restores_the_ledger():
    meta, policy, pipe, config = _resume_inputs()
    logs = []
    ledger = rs.check_resume(meta, policy.mechanism(), pipe,
                             dict(config, lr=2e-3, steps=12),
                             log=logs.append)
    assert ledger.recorded_to == 3 and ledger.to_json() == meta["ledger"]
    assert logs == [
        "resume config drift (non-critical) lr: 0.001 -> 0.002",
        "resume config drift (non-critical) steps: 8 -> 12"]


def test_check_resume_refuses_a_version_a_pipeline_or_a_mechanism():
    meta, policy, pipe, config = _resume_inputs()
    with pytest.raises(ValueError, match="run_state_version"):
        rs.check_resume(dict(meta, run_state_version=2), policy.mechanism(),
                        pipe, config)
    other = Pipeline(smoke_config("qwen2-1.5b"), PipelineConfig(8, 16, seed=3),
                     device="cpu")
    with pytest.raises(ValueError, match="pipeline"):
        rs.check_resume(meta, policy.mechanism(), other, config)
    tree = _run_state(PrivacyPolicy, ParamGroup, "ftrl")
    with pytest.raises(ValueError, match="noise"):
        rs.check_resume(meta, tree.mechanism(), pipe, config)
