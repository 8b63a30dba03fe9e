"""Fault tolerance: preemption, the step watchdog, and checkpoint/restart
(counterpart of ``repro/runtime/fault_tolerance.py``), on one device or on
every rank of a mesh (the train loop agrees on a stop across the ranks; a
:class:`CheckpointManager` of a rank saves its blocks, process 0 commits).

The failure model is (a) SIGTERM preemption with a grace window, (b) a
hung step, (c) a hard crash. The remedy is checkpoint/restart: the run is
started again with the same command line and resumes from the latest
valid checkpoint (atomic and checksummed, ``checkpoint.checkpoint``); the
data pipeline and the noise are counter-based, so the resumed run is
bitwise the run that never stopped.
"""
from __future__ import annotations

import signal
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.checkpoint import checkpoint as ckpt


class PreemptionGuard:
    """Installs a SIGTERM handler that sets a flag; the train loop polls
    ``should_stop()`` once a step and checkpoints before it exits.
    ``close()`` puts the previous handler back."""

    def __init__(self, install: bool = True):
        self._stop = threading.Event()
        self._installed, self._previous = False, None
        if install:
            try:
                self._previous = signal.signal(signal.SIGTERM, self._handler)
                self._installed = True
            except ValueError:  # not the main thread
                pass

    def _handler(self, signum, frame):
        self._stop.set()

    def request_stop(self):
        self._stop.set()

    def should_stop(self) -> bool:
        return self._stop.is_set()

    def close(self):
        if self._installed:
            signal.signal(signal.SIGTERM, self._previous
                          if self._previous is not None else signal.SIG_DFL)
            self._installed = False


@dataclass(frozen=True)
class StallReport:
    """What ``Heartbeat.on_stall`` receives: the last step that finished,
    how long ago, the patience, and the torch device type the steps run
    on."""
    last_step: int
    seconds_since_beat: float
    timeout_s: float
    backend: str

    def describe(self) -> str:
        return (f"stall: no step since step {self.last_step} for "
                f"{self.seconds_since_beat:.0f}s "
                f"(timeout {self.timeout_s:.0f}s, backend {self.backend})")


class Heartbeat:
    """Step-progress watchdog. The train loop calls ``beat(step)`` after
    every step; a daemon thread checks that beats keep arriving within
    ``timeout_s`` and otherwise calls ``on_stall`` with a
    :class:`StallReport` (the train driver then asks for a graceful stop,
    so the loop saves a checkpoint before it exits, if it ever returns)."""

    def __init__(self, timeout_s: float = 300.0, on_stall=None, poll_s=None,
                 device="cuda"):
        self.timeout_s = timeout_s
        self.on_stall = on_stall or (lambda report: None)
        self.backend = torch.device(device).type
        self._last = time.monotonic()
        self._step = -1
        self.stalled = False
        self._stop = threading.Event()
        self._poll = poll_s or min(5.0, timeout_s / 4)
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def beat(self, step: int):
        self._step = step
        self._last = time.monotonic()
        self.stalled = False

    def _report(self) -> StallReport:
        return StallReport(last_step=self._step,
                           seconds_since_beat=time.monotonic() - self._last,
                           timeout_s=self.timeout_s, backend=self.backend)

    def _run(self):
        while not self._stop.wait(self._poll):
            if time.monotonic() - self._last > self.timeout_s:
                self.stalled = True
                self.on_stall(self._report())

    def close(self):
        self._stop.set()
        self._thread.join(timeout=1.0)


@dataclass
class CheckpointManager:
    """Save every ``every`` steps and when forced; resume from the latest.

    ``maybe_save`` copies the state to the host before it returns (the
    blocking part: the next step updates params and state in place), into
    host buffers kept and reused from save to save, pinned for device
    tensors, so nothing is allocated on the device. The npz write, the
    fsyncs and the commit then run on a writer thread (unless
    ``async_save`` is off or the save is forced). One write is in flight at
    a time: a new save, ``wait`` or ``resume`` joins the previous one
    first, and ``wait`` raises what the writer raised.

    ``saves`` holds a record a save: its step, the seconds the snapshot
    blocked the caller (``snapshot_seconds``), and once written, the
    writer's seconds and the checkpoint's bytes. ``restore_seconds`` is the
    time ``resume`` took (``latest_step`` and ``restore``).

    On a mesh each rank holds a manager with its ``process_index``, the
    world's ``process_count``, a gloo ``group`` the writer threads alone
    use, and its ``layout`` ({path: (offsets, global shape)} of the blocks
    it writes, ``checkpoint.shard_snapshot``); every rank saves at the same
    steps."""

    root: str
    every: int = 100
    keep: int = 3
    async_save: bool = True
    process_index: int = 0
    process_count: int = 1
    group: object = None
    layout: Optional[dict] = None
    saves: list = field(default_factory=list)
    restore_seconds: Optional[float] = None
    _pending: Optional[Future] = field(default=None, repr=False)
    _writer: Optional[ThreadPoolExecutor] = field(default=None, repr=False)
    _buffers: dict = field(default_factory=dict, repr=False)

    def maybe_save(self, step: int, state, force: bool = False,
                   meta: dict = None) -> bool:
        if not force and (self.every <= 0 or step % self.every != 0):
            return False
        self.wait()           # the writer reads the buffers this refills
        t0 = time.perf_counter()
        slices = ckpt.shard_snapshot(state, self._buffers, self.layout)
        record = {"step": step, "snapshot_seconds": time.perf_counter() - t0}
        self.saves.append(record)
        if self.async_save and not force:
            if self._writer is None:
                self._writer = ThreadPoolExecutor(
                    1, thread_name_prefix="checkpoint-writer")
            self._pending = self._writer.submit(self._write, step, slices,
                                                meta, record)
        else:
            self._write(step, slices, meta, record)
        return True

    def _write(self, step, slices, meta, record):
        t0 = time.perf_counter()
        path = ckpt.save(self.root, step, slices, self.keep, meta=meta,
                         process_index=self.process_index,
                         process_count=self.process_count, group=self.group)
        record.update(writer_seconds=time.perf_counter() - t0,
                      bytes=ckpt.nbytes(path))

    def wait(self):
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.result()

    def resume(self, template=None, device="cuda", blocks=None):
        """-> (state, step, meta) from the latest valid checkpoint, its
        tensors on ``device`` (``blocks``: the rank's blocks of them,
        ``checkpoint.restore``); (None, -1, {}) when there is none."""
        self.wait()
        t0 = time.perf_counter()
        step = ckpt.latest_step(self.root)
        if step is None:
            return None, -1, {}
        out = ckpt.restore(self.root, step, template=template, device=device,
                           blocks=blocks)
        self.restore_seconds = time.perf_counter() - t0
        return out

    def close(self):
        """Let the writer finish, stop its thread and drop the buffers."""
        if self._writer is not None:
            self._writer.shutdown(wait=True)
            self._writer = None
        self._buffers.clear()
