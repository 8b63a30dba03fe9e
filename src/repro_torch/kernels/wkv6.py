"""wkv6: the RWKV6 time-mix recurrence as a CUDA kernel (the rwkv6 serving
prefill's state scan).

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

Replaces the TPU kernel ``repro/kernels/wkv6.py::wkv6``. Source:
``csrc/wkv6.cu``, which also says what bounds it on the H100. The kernel
steps through the tokens with the state in registers and never divides by
the cumulative decay, so it computes the recurrence exactly under any decay
(the Pallas kernel's chunked form, and ``models.rwkv6.wkv6_chunked``, lose it
once the in-chunk product of the decays underflows f32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

F32 = torch.float32


def plain(r, k, v, w, u) -> torch.Tensor:
    """The plain version, the sequential recurrence ``models.rwkv6.wkv6_ref``
    (imported here: that module launches this one's kernel). What a CPU
    tensor runs, and what the kernel is held to."""
    from repro_torch.models.rwkv6 import wkv6_ref
    return wkv6_ref(r, k, v, w, u)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor) -> torch.Tensor:
    """r, k, v, w (B,T,H,h); u (H,h) -> (B,T,H,h) f32."""
    if r.device.type == "cpu":
        return plain(r, k, v, w, u)
    u32 = u.to(F32).contiguous()
    bf16 = build.check_inputs("wkv6", (r, k, v, w), f32=(u32,))
    B, T, H, h = r.shape
    shapes = [tuple(t.shape) for t in (r, k, v, w, u)]
    if shapes != [(B, T, H, h)] * 4 + [(H, h)]:
        raise ValueError(f"wkv6: r, k, v, w must share one (B,T,H,h) shape "
                         f"and u be (H,h), got {shapes}")
    if not 1 <= h <= 128:
        raise ValueError(f"wkv6: head size {h} is not in [1, 128]")
    out = torch.empty(B, T, H, h, dtype=F32, device=r.device)
    lib = build.load()
    build.check(lib.dp_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(),
                            w.data_ptr(), u32.data_ptr(), out.data_ptr(), B,
                            T, H, h, int(bf16), build.stream_ptr(r)), "wkv6")
    wkv6.launches += 1
    return out


wkv6.launches = 0
