"""The port's fault-tolerance runtime (``repro_torch.runtime``) by the cases
of tests/test_fault_tolerance.py: PreemptionGuard's signal handling (and
its handler put back), Heartbeat's structured stall reports (the backend is
the torch device type), CheckpointManager's cadence, forced saves, async
ordering, meta round trip and empty resume, plus its copy-before-the-next-
step contract (the optimizers update in place) and a writer's error raised
by ``wait``; and the fault-injection harness, whose ``parse_fault`` equals
the JAX package's on the same strings, the bad ones included."""
import os
import signal
import threading
import time

import numpy as np
import pytest
import torch

from repro.runtime import fault_injection as rfi
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.runtime import fault_injection as fi
from repro_torch.runtime.fault_tolerance import (CheckpointManager, Heartbeat,
                                                 PreemptionGuard, StallReport)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ----------------------------------------------------------- PreemptionGuard
def test_preemption_guard_handles_sigterm():
    old = signal.getsignal(signal.SIGTERM)
    try:
        guard = PreemptionGuard(install=True)
        assert not guard.should_stop()
        os.kill(os.getpid(), signal.SIGTERM)
        # delivered in the main thread before kill returns to Python code
        assert guard.should_stop()
    finally:
        signal.signal(signal.SIGTERM, old)


def test_preemption_guard_close_restores_the_handler():
    old = signal.getsignal(signal.SIGTERM)
    try:
        guard = PreemptionGuard(install=True)
        assert signal.getsignal(signal.SIGTERM) == guard._handler
        guard.close()
        assert signal.getsignal(signal.SIGTERM) == old
        guard.close()                        # a second close does nothing
        assert signal.getsignal(signal.SIGTERM) == old
    finally:
        signal.signal(signal.SIGTERM, old)


def test_preemption_guard_request_stop_without_signal():
    guard = PreemptionGuard(install=False)
    assert not guard.should_stop()
    guard.request_stop()
    assert guard.should_stop()


def test_preemption_guard_off_main_thread_is_safe():
    """Installing from a thread other than the main one does not raise
    (signal.signal does); request_stop still works."""
    out = {}

    def run():
        g = PreemptionGuard(install=True)
        g.request_stop()
        out["stopped"] = g.should_stop()
        g.close()

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive() and out["stopped"]


# ----------------------------------------------------------------- Heartbeat
def test_heartbeat_quiet_while_beating():
    stalls = []
    hb = Heartbeat(timeout_s=0.4, on_stall=stalls.append, poll_s=0.05,
                   device="cpu")
    for s in range(6):
        hb.beat(s)
        time.sleep(0.05)
    hb.close()
    assert stalls == [] and not hb.stalled


@pytest.mark.parametrize("device", ["cpu", "cuda"])
def test_heartbeat_stall_report_is_structured(device):
    stalls = []
    hb = Heartbeat(timeout_s=0.15, on_stall=stalls.append, poll_s=0.05,
                   device=device)
    hb.beat(7)
    time.sleep(0.45)
    hb.close()
    assert stalls, "watchdog never fired"
    rep = stalls[0]
    assert isinstance(rep, StallReport)
    assert rep.last_step == 7
    assert rep.seconds_since_beat > 0.15
    assert rep.timeout_s == 0.15
    assert rep.backend == torch.device(device).type == device
    assert str(rep.last_step) in rep.describe()
    assert f"backend {device}" in rep.describe()


def test_heartbeat_recovers_after_beat():
    hb = Heartbeat(timeout_s=0.15, on_stall=lambda r: None, poll_s=0.05,
                   device="cpu")
    time.sleep(0.3)
    assert hb.stalled
    hb.beat(1)
    assert not hb.stalled
    hb.close()


# --------------------------------------------------------- CheckpointManager
def _state(v: float):
    return {"params": {"w": torch.full((4, 4), v)}, "step": np.asarray(0)}


def test_manager_save_cadence_and_force(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=3, keep=10,
                            async_save=False)
    saved = [s for s in range(7) if mgr.maybe_save(s, _state(float(s)))]
    assert saved == [0, 3, 6]
    assert not mgr.maybe_save(7, _state(7.0))
    assert mgr.maybe_save(7, _state(7.0), force=True)
    assert ckpt.steps(str(tmp_path)) == [0, 3, 6, 7]
    assert [r["step"] for r in mgr.saves] == [0, 3, 6, 7]
    assert all(r["bytes"] == ckpt.nbytes(ckpt._ckpt_dir(str(tmp_path),
                                                        r["step"]))
               for r in mgr.saves)
    mgr.close()


def test_manager_async_wait_ordering(tmp_path):
    """An async save is complete after wait(); a second save (or resume)
    joins the writer in flight first, so the newest checkpoint wins and no
    torn interleaving is possible."""
    mgr = CheckpointManager(str(tmp_path), every=1, keep=10, async_save=True)
    assert mgr.maybe_save(0, _state(0.0))
    assert mgr.maybe_save(1, _state(1.0))  # joins save(0) first
    mgr.wait()
    assert ckpt.steps(str(tmp_path)) == [0, 1]
    state, step, _ = mgr.resume(device="cpu")
    assert step == 1
    torch.testing.assert_close(state["params"]["w"], torch.full((4, 4), 1.0),
                               rtol=0, atol=0)
    assert mgr.restore_seconds is not None and mgr.restore_seconds >= 0
    assert all("writer_seconds" in r for r in mgr.saves)
    mgr.close()


def test_manager_snapshot_copies_before_the_next_step(tmp_path):
    """The port's optimizers update params and state in place: a step that
    runs while the previous save is still being written must not change
    what that save writes. The host buffers are reused from save to save,
    so the next save waits for the writer first."""
    mgr = CheckpointManager(str(tmp_path), every=1, keep=10, async_save=True)
    w = torch.zeros(256, 256)
    state = {"params": {"w": w}}
    assert mgr.maybe_save(0, state)
    w.add_(1.0)                          # the next step, in place
    assert mgr.maybe_save(1, state)
    buffer = mgr._buffers["params/w"]
    w.add_(1.0)
    mgr.wait()
    assert mgr._buffers["params/w"] is buffer        # reused, not realloc'd
    for step, want in ((0, 0.0), (1, 1.0)):
        got, _, _ = ckpt.restore(str(tmp_path), step, device="cpu")
        assert torch.equal(got["params"]["w"], torch.full((256, 256), want))
    mgr.close()
    assert mgr._buffers == {}


def test_manager_wait_raises_the_writers_error(tmp_path):
    """A failed async write is not lost: wait() (and the next save) raise
    it."""
    blocker = tmp_path / "root"
    blocker.write_text("a file where the checkpoint dir should be")
    mgr = CheckpointManager(str(blocker), every=1, async_save=True)
    assert mgr.maybe_save(0, _state(0.0))
    with pytest.raises(OSError):
        mgr.wait()
    mgr.close()


def test_manager_meta_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, async_save=False)
    meta = {"run_state_version": 1, "ledger": {"recorded_to": 5}}
    mgr.maybe_save(4, _state(2.0), meta=meta)
    _, step, got = mgr.resume(device="cpu")
    assert step == 4 and got == meta


def test_manager_resume_empty(tmp_path):
    state, step, meta = CheckpointManager(str(tmp_path)).resume(device="cpu")
    assert state is None and step == -1 and meta == {}


def test_manager_resume_places_on_device_with_template_dtypes(tmp_path):
    mgr = CheckpointManager(str(tmp_path), every=1, async_save=False)
    mgr.maybe_save(2, {"params": {"w": torch.arange(6.0).reshape(2, 3)},
                       "step": np.asarray(2)})
    state, step, _ = mgr.resume(
        template={"params": {"w": torch.zeros(2, 3, dtype=torch.float64)},
                  "step": np.asarray(0, np.int32)}, device="cpu")
    assert step == 2
    assert state["params"]["w"].dtype == torch.float64
    assert state["params"]["w"].device.type == "cpu"
    assert state["step"].dtype == torch.int32 and int(state["step"]) == 2


# ------------------------------------------------------------ fault injection
PARSE_CASES = ["step@7:sigterm", "ckpt_mid_write", "ckpt_pre_commit:exit",
               "step@0", "  step@12:sigkill  ", "a@b@3", "", "step:explode",
               "@3:sigkill", "step@x", ":sigkill", "site:with:colon"]


@pytest.mark.parametrize("text", PARSE_CASES)
def test_parse_fault_matches_the_reference(text):
    """The same strings give the same specs, or the same error type."""
    try:
        want = rfi.parse_fault(text)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            fi.parse_fault(text)
        assert str(got.value) == str(e)
        return
    got = fi.parse_fault(text)
    assert (None if got is None else (got.site, got.step, got.action)) == \
        (None if want is None else (want.site, want.step, want.action))
    assert got is None or got.encode() == want.encode()


def test_parse_fault_grammar():
    spec = fi.parse_fault("step@7:sigterm")
    assert spec == fi.FaultSpec("step", 7, "sigterm")
    assert fi.parse_fault(spec.encode()) == spec
    assert fi.parse_fault("ckpt_mid_write") == \
        fi.FaultSpec("ckpt_mid_write", None, "sigkill")
    assert fi.parse_fault("") is None
    with pytest.raises(ValueError, match="action"):
        fi.parse_fault("step:explode")
    with pytest.raises(ValueError, match="site"):
        fi.parse_fault("@3:sigkill")
    assert (fi.ENV_VAR, fi.FAULT_EXIT_CODE, fi.ACTIONS) == \
        (rfi.ENV_VAR, rfi.FAULT_EXIT_CODE, rfi.ACTIONS)


def test_maybe_fault_matching(monkeypatch):
    fired = []
    monkeypatch.setattr(fi, "_fire", lambda spec: fired.append(spec))
    monkeypatch.delenv(fi.ENV_VAR, raising=False)
    assert not fi.maybe_fault("step", 3)          # no fault requested
    monkeypatch.setenv(fi.ENV_VAR, "step@5")
    assert not fi.maybe_fault("step", 3)          # wrong step
    assert not fi.maybe_fault("ckpt_mid_write")   # wrong site
    assert fi.maybe_fault("step", 5)
    monkeypatch.setenv(fi.ENV_VAR, "step:sigterm")
    assert fi.maybe_fault("step", 0) and fi.maybe_fault("step", 9)
    assert len(fired) == 3


def test_sigterm_fault_drives_preemption_guard(monkeypatch):
    """The sigterm action returns to the caller with the guard's flag set:
    the graceful-preemption path the train loop takes."""
    old = signal.getsignal(signal.SIGTERM)
    try:
        guard = PreemptionGuard(install=True)
        monkeypatch.setenv(fi.ENV_VAR, "step@2:sigterm")
        assert not fi.maybe_fault("step", 1)
        assert not guard.should_stop()
        assert fi.maybe_fault("step", 2)
        assert guard.should_stop()
    finally:
        signal.signal(signal.SIGTERM, old)


@pytest.mark.parametrize("action", fi.ACTIONS)
def test_expected_death_matches_the_reference(action):
    assert fi.expected_death(fi.FaultSpec("step", 1, action)) == \
        rfi.expected_death(rfi.FaultSpec("step", 1, action))


def test_run_subprocess_asserts_death_mode():
    code = ("from repro_torch.runtime.fault_injection import maybe_fault\n"
            "maybe_fault('boom')\nprint('SURVIVED')")
    env = {"PYTHONPATH": "src"}
    r = fi.run_subprocess(code, fi.FaultSpec("boom", action="exit"),
                          env=env, cwd=ROOT)
    assert "SURVIVED" not in r.stdout
    # a run that survives its own crash test fails the harness
    with pytest.raises(AssertionError):
        fi.run_subprocess(code, fi.FaultSpec("other_site", action="exit"),
                          env=env, cwd=ROOT)
    r = fi.run_subprocess(code, fi.FaultSpec("boom", action="sigkill"),
                          env=env, cwd=ROOT)
    assert "SURVIVED" not in r.stdout
    # no fault: plain success asserted
    r = fi.run_subprocess("print('ok')", env=env, cwd=ROOT)
    assert "ok" in r.stdout
