"""How many device events torch.profiler keeps from short sessions over a
process's life, with and without idle margins around the recorded calls.

    python3 scripts/profiler_window.py [seconds]     # on the card; 200 s

Every ~6 s it profiles three launches of the port's ``counter_noise``
kernel (a 50 M-element f32 leaf, ~0.6 ms each) in two sessions shaped as
``chip_smoke.device_ms``'s (two warm-up steps, then the recorded one): the
calls right at the window's ends, and the calls 0.2 s inside it. Each line
prints the device events each session kept (of 3) and their start times in
ms from the window's start. The profiler keeps only the events whose
timestamps, converted to the host clock, fall inside its window; where that
conversion drifts or jitters, the unpadded sessions lose events.
"""
import json
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))
from repro_torch.kernels import build, counter_noise as cn  # noqa: E402


def session(call, pad: float):
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA],
            schedule=torch.profiler.schedule(wait=0, warmup=2, active=1,
                                             repeat=1)) as prof:
        for i, n in enumerate((1, 1, 3)):
            if i == 2:
                time.sleep(pad)
            for _ in range(n):
                call()
            torch.cuda.synchronize()
            time.sleep(pad)
            prof.step()
    ev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    return len(ev), [round(e.time_range.start / 1e3, 1) for e in ev]


def main(seconds: float = 200.0) -> None:
    build.build()
    g = torch.randn(50_000_000, device="cuda")

    def call():
        cn.counter_noise(g, [(1, 2)], [], 1.0, 8.0)

    t0 = time.time()
    while time.time() - t0 < seconds:
        print(json.dumps({"t": round(time.time() - t0, 1),
                          "unpadded": session(call, 0.0),
                          "padded": session(call, 0.2)}), flush=True)
        time.sleep(5)


if __name__ == "__main__":
    main(*(float(a) for a in sys.argv[1:]))
