"""Deterministic fault injection for crash/restart testing (counterpart of
``repro/runtime/fault_injection.py``: the same environment variable,
grammar, sites, actions and exit code).

The train driver and the checkpoint writer carry named *fault sites*,
``maybe_fault(site, step=...)`` calls that do nothing unless the
``REPRO_FAULT`` environment variable requests a fault:

    REPRO_FAULT="<site>[@<step>][:<action>]"

Sites:

  step             top of the train loop, before step N runs (``@N`` pins
                   the step)
  ckpt_mid_write   ``checkpoint.write_shard_file``: the payload is on disk,
                   the manifest is not (a torn write, which the commit
                   protocol must keep invisible)
  ckpt_pre_commit  ``checkpoint.commit``: payload and manifest written, the
                   staging directory not yet renamed into place

Actions:

  sigkill   SIGKILL to self: a hard crash, nothing runs afterwards (the
            default)
  sigterm   SIGTERM to self: graceful preemption; the signal returns to the
            caller and :class:`repro_torch.runtime.fault_tolerance
            .PreemptionGuard`'s handler sets its stop flag, so the loop
            checkpoints and exits through the normal path
  exit      ``os._exit(FAULT_EXIT_CODE)``: a hard exit without a signal

A subprocess test runs the production command line with, say,
``REPRO_FAULT=step@7`` and asserts the recovery; :func:`run_subprocess`
wraps the spawn and the death-mode assertion.
"""
from __future__ import annotations

import os
import signal
import subprocess
import sys
from dataclasses import dataclass
from typing import Optional

ENV_VAR = "REPRO_FAULT"
FAULT_EXIT_CODE = 113
ACTIONS = ("sigkill", "sigterm", "exit")


@dataclass(frozen=True)
class FaultSpec:
    """One requested fault: fire at ``site`` (optionally at one train step)
    with ``action``."""
    site: str
    step: Optional[int] = None
    action: str = "sigkill"

    def encode(self) -> str:
        s = self.site
        if self.step is not None:
            s += f"@{self.step}"
        return f"{s}:{self.action}"


def parse_fault(text: str) -> Optional[FaultSpec]:
    """``"site[@step][:action]"`` -> FaultSpec; '' or None -> None."""
    if not text:
        return None
    text = text.strip()
    action = "sigkill"
    if ":" in text:
        text, action = text.rsplit(":", 1)
    if action not in ACTIONS:
        raise ValueError(f"unknown fault action {action!r}; options: "
                         f"{ACTIONS}")
    step = None
    if "@" in text:
        text, step_s = text.rsplit("@", 1)
        step = int(step_s)
    if not text:
        raise ValueError("fault spec needs a site name")
    return FaultSpec(site=text, step=step, action=action)


def active_fault() -> Optional[FaultSpec]:
    """The fault the environment requests, read again on every call (a
    test may change it between phases of one process)."""
    return parse_fault(os.environ.get(ENV_VAR, ""))


def _fire(spec: FaultSpec) -> None:
    if spec.action == "sigkill":
        os.kill(os.getpid(), signal.SIGKILL)
    elif spec.action == "sigterm":
        # returns: the installed handler (PreemptionGuard) sets its flag
        # and the caller goes on into the graceful-shutdown path
        os.kill(os.getpid(), signal.SIGTERM)
    else:
        os._exit(FAULT_EXIT_CODE)


def maybe_fault(site: str, step: Optional[int] = None) -> bool:
    """Fire the requested fault if it names this site (and this step, when
    the spec pins one). Returns True when a returning action (sigterm)
    fired; never returns for sigkill or exit."""
    spec = active_fault()
    if spec is None or spec.site != site:
        return False
    if spec.step is not None and step != spec.step:
        return False
    _fire(spec)
    return True


# ------------------------------------------------------------ test harness
def expected_death(spec: FaultSpec) -> tuple:
    """The return codes a process killed by ``spec`` may report."""
    if spec.action == "sigkill":
        return (-signal.SIGKILL, 128 + signal.SIGKILL)
    if spec.action == "exit":
        return (FAULT_EXIT_CODE,)
    return (0,)  # sigterm: the graceful checkpoint-and-exit path


def run_subprocess(code: str, fault: Optional[FaultSpec] = None,
                   env: Optional[dict] = None, timeout: int = 600,
                   cwd: Optional[str] = None) -> subprocess.CompletedProcess:
    """Run ``python -c code`` with an optional injected fault.

    With a fault, asserts that the subprocess died the way the fault's
    action says (a run that survives its own crash test is a broken test);
    without one, asserts that it exited 0."""
    run_env = dict(os.environ)
    if env:
        run_env.update(env)
    run_env.pop(ENV_VAR, None)
    if fault is not None:
        run_env[ENV_VAR] = fault.encode()
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=run_env, timeout=timeout, cwd=cwd)
    ok = (0,) if fault is None else expected_death(fault)
    if r.returncode not in ok:
        raise AssertionError(
            f"subprocess exited {r.returncode}, expected one of {ok}\n"
            f"--- stdout ---\n{r.stdout[-2000:]}\n"
            f"--- stderr ---\n{r.stderr[-4000:]}")
    return r
