"""The run state a privacy-exact restart needs (counterpart of
``repro/checkpoint/run_state.py``; the same schema, version and checks).

    array payload (``checkpoint.checkpoint``)
      params        model parameters
      opt           optimizer state (DP-FTRL: the anchor ``theta0``, the
                    noisy gradient prefix ``sum``, the momentum ``m``)
      step          the last completed absolute step (int64 scalar)
      rng           the TrainState's base key, uint32 (2,): each step folds
                    its own index in, so (rng, step) replays the per-step
                    keys

    manifest meta (this module's schema)
      run_state_version   1
      noise               NoiseMechanism.state_dict()
      ledger              PrivacyLedger.to_json()
      pipeline            Pipeline.state_dict() (the cursor is the step)
      config              the run config's fingerprint, for drift checks

On resume, drift in a PRIVACY_CRITICAL config key raises (continuing would
change the release the ledger accounts); other drift only warns (extending
``steps`` is a legitimate continuation). The noise mechanism and the
pipeline check their own state in ``load_state`` and raise on drift.
"""
from __future__ import annotations

import hashlib

import torch

from repro_torch.core.accounting import PrivacyLedger
from repro_torch.utils.tree import flatten

RUN_STATE_VERSION = 1

# Resuming with any of these changed alters the mechanism mid-release: the
# per-step keys (seed), the noise magnitude (sigma), the sensitivity unit
# and sampling (global_batch), the optimizer that consumes the release, or
# the tree's epochs (restart_every).
PRIVACY_CRITICAL = ("seed", "sigma", "global_batch", "optimizer",
                    "restart_every", "noise", "mode")


def config_fingerprint(tc, policy, restart_every: int) -> dict:
    """The drift-check view of a run config (json-able scalars only)."""
    return {
        "seed": int(tc.seed),
        "sigma": float(policy.sigma),
        "global_batch": int(tc.global_batch),
        "optimizer": str(tc.optimizer),
        "restart_every": int(restart_every),
        "noise": str(policy.noise),
        "mode": str(policy.mode),
        "steps": int(tc.steps),
        "seq_len": int(tc.seq_len),
        "lr": float(tc.lr),
        "microbatch": int(tc.microbatch),
    }


def pack_meta(mechanism, ledger: PrivacyLedger, pipeline,
              config: dict) -> dict:
    """The manifest-meta half of a run-state checkpoint."""
    return {
        "run_state_version": RUN_STATE_VERSION,
        "noise": mechanism.state_dict(),
        "ledger": ledger.to_json(),
        "pipeline": pipeline.state_dict(),
        "config": config,
    }


def check_resume(meta: dict, mechanism, pipeline, config: dict,
                 log=print) -> PrivacyLedger:
    """Check a checkpoint's meta against the resuming run -> the restored
    ledger. Raises on privacy-critical drift; logs any other."""
    version = meta.get("run_state_version")
    if version != RUN_STATE_VERSION:
        raise ValueError(
            f"checkpoint run_state_version={version!r}; this build resumes "
            f"version {RUN_STATE_VERSION}")
    mechanism.load_state(meta["noise"])
    pipeline.load_state(meta["pipeline"])
    saved = meta.get("config", {})
    drift = {k: (saved.get(k), config[k]) for k in config
             if k in saved and saved[k] != config[k]}
    critical = {k: v for k, v in drift.items() if k in PRIVACY_CRITICAL}
    if critical:
        raise ValueError(
            "privacy-critical config drift between checkpoint and resumed "
            "run (checkpointed != configured): "
            + ", ".join(f"{k}: {a!r} != {b!r}"
                        for k, (a, b) in sorted(critical.items())))
    for k, (a, b) in sorted(drift.items()):
        log(f"resume config drift (non-critical) {k}: {a!r} -> {b!r}")
    return PrivacyLedger.from_json(meta.get("ledger"))


def params_digest(params) -> str:
    """Order-stable sha256 over every parameter's raw bytes, path by sorted
    path: the bitwise restart-parity witness. A bf16 parameter hashes as
    its two raw bytes an element, as numpy's bfloat16 does, so the same
    parameters give the same digest in either package."""
    h = hashlib.sha256()
    flat = flatten(params)
    for path in sorted(flat):
        t = flat[path].detach().contiguous().cpu()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(path.encode())
        h.update(t.numpy().reshape(-1))      # the buffer itself, no copy
    return h.hexdigest()
