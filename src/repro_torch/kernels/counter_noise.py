"""counter_noise: phase-4 noise drawn and added in one CUDA pass.

    out = (g + alpha * (sum_hi z(key) - sum_lo z(key))) / denom

with z the counter-based normal of ``core.noise.counter_normal`` at each
element's linear index. One key is the Gaussian mechanism; the tree
mechanism's increment is two key lists (``core.noise``). The keys are
derived on the host (Python ints, no device work) and travel as kernel
parameters. Source: ``csrc/counter_noise.cu`` with ``csrc/counter_normal.cuh``
(threefry2x32, the uniform, ndtri), which also says what bounds it on the
H100. It replaces no TPU kernel: the JAX package draws this noise with jnp.

The wrapper runs :func:`plain` for CPU tensors only; a CUDA tensor launches
the kernel or raises. ``threefry_bits`` and ``ndtri_f32`` run the same
device functions over given counters and uniforms, for the checks on the
card; the main path does not call them.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import noise
from repro_torch.kernels import build

MAX_KEYS = 64          # csrc/counter_noise.cu: keys a launch takes


def window(shape, offsets=None, full_shape=None) -> tuple:
    """-> (start, trail): the linear index of the block ``shape`` at
    ``offsets`` in ``full_shape``, and the span of counter word 0. The block
    must be a contiguous run of the whole tensor's linear order: leading
    dims of 1, then whole dims."""
    shape = tuple(int(s) for s in shape)
    full = tuple(int(s) for s in full_shape) if full_shape is not None \
        else shape
    _, trail, _ = noise.counter_split(full)
    if offsets is None:
        offsets = (0,) * len(full)
    offsets = tuple(int(o) for o in offsets)
    if len(shape) != len(full) or len(offsets) != len(full):
        raise ValueError(f"block {shape} at {offsets} does not match the "
                         f"rank of {full}")
    j = next((d for d, s in enumerate(shape) if s != 1), len(shape))
    if any(shape[d] != full[d] or offsets[d] for d in range(j + 1,
                                                             len(full))):
        raise NotImplementedError(
            f"counter_noise draws a contiguous window of a tensor; block "
            f"{shape} at {offsets} of {full} is a shard (ROADMAP B7: "
            "distributed)")
    if any(o + s > f for o, s, f in zip(offsets, shape, full)):
        raise ValueError(f"block {shape} at {offsets} lies outside {full}")
    start, stride = 0, 1
    for d in reversed(range(len(full))):
        start += offsets[d] * stride
        stride *= full[d]
    return start, trail


def _scalar(x: float, dtype) -> float:
    """``x`` rounded to the leaf's dtype, as the reference's weakly typed
    scalar is."""
    return float(torch.tensor(float(x), dtype=dtype))


def plain(g, hi_keys, lo_keys, alpha: float, denom: float, start: int = 0,
          trail: int | None = None) -> torch.Tensor:
    """The kernel's function in plain torch: each key's draw by
    ``noise.linear_normal``, summed in order from 0 in f32, then the
    reference's arithmetic in the leaf's dtype (0-dim device operands, so
    the division is a true division on either device)."""
    n = g.numel()
    trail = trail if trail is not None else noise.counter_split(g.shape)[1]

    def total(keys):
        s = torch.zeros(n, dtype=torch.float32, device=g.device)
        for key in keys:
            s = s + noise.linear_normal(key, start, n, trail, g.device)
        return s

    xi = (total(hi_keys) - total(lo_keys)).view(g.shape)
    dt = g.dtype
    a = torch.tensor(alpha, dtype=dt, device=g.device)
    d = torch.tensor(denom, dtype=dt, device=g.device)
    return (g + a * xi.to(dt)) / d


def counter_noise(g: torch.Tensor, hi_keys, lo_keys, alpha: float,
                  denom: float, offsets=None, full_shape=None,
                  inplace: bool = False) -> torch.Tensor:
    """(g + alpha * (sum of the hi keys' draws - sum of the lo keys'))
    / denom, the draws at g's coordinates (``offsets`` of ``full_shape``,
    a contiguous window; the whole of g by default). f32 or bf16 leaves;
    ``inplace`` writes the result over g (a CUDA leaf). One launch."""
    start, trail = window(g.shape, offsets, full_shape)
    hi_keys, lo_keys = list(hi_keys), list(lo_keys)
    if g.device.type == "cpu":
        return plain(g, hi_keys, lo_keys, alpha, denom, start, trail)
    bf16 = build.check_inputs("counter_noise", (g,))
    if len(hi_keys) + len(lo_keys) > MAX_KEYS:
        raise ValueError(f"counter_noise takes at most {MAX_KEYS} keys, got "
                         f"{len(hi_keys) + len(lo_keys)}")
    out = g if inplace else torch.empty_like(g)
    if g.numel() == 0:
        return out
    words = [int(w) & noise.M32 for key in hi_keys + lo_keys for w in key]
    keys = (ctypes.c_uint32 * max(1, len(words)))(*words)
    lib = build.load()
    build.check(lib.dp_counter_noise(
        g.data_ptr(), out.data_ptr(), ctypes.addressof(keys), len(hi_keys),
        len(lo_keys), start, trail, g.numel(), _scalar(alpha, g.dtype),
        _scalar(denom, g.dtype), int(bf16), build.stream_ptr(g)),
        "counter_noise")
    counter_noise.launches += 1
    return out


def _as_int32(x: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> the same bits as int32."""
    return torch.where(x >= 1 << 31, x - (1 << 32), x).to(torch.int32)


def threefry_bits(words: torch.Tensor) -> torch.Tensor:
    """(n, 4) int64 rows (k0, k1, x0, x1) of uint32 values -> (n, 2) int64:
    one threefry2x32 block a row, by the device function on a CUDA tensor,
    by ``noise.threefry2x32`` on a CPU one."""
    if words.device.type == "cpu":
        return torch.stack(noise.threefry2x32(*words.unbind(1)), 1)
    inp = _as_int32(words).contiguous()
    out = torch.empty(words.shape[0], 2, dtype=torch.int32,
                      device=words.device)
    build.check(build.load().dp_threefry_bits(
        inp.data_ptr(), out.data_ptr(), words.shape[0],
        build.stream_ptr(words)), "threefry_bits")
    return out.to(torch.int64) & noise.M32


def ndtri_f32(u: torch.Tensor) -> torch.Tensor:
    """The device ndtri over f32 uniforms, or ``noise.ndtri`` on a CPU
    tensor."""
    if u.device.type == "cpu":
        return noise.ndtri(u)
    build.check_inputs("ndtri_f32", (u,), f32=(u,))
    out = torch.empty_like(u)
    build.check(build.load().dp_ndtri_f32(
        u.data_ptr(), out.data_ptr(), u.numel(), build.stream_ptr(u)),
        "ndtri_f32")
    return out


counter_noise.launches = 0
