"""counter_noise: phase-4 noise drawn and added in one CUDA pass.

    out = (g + alpha * (sum_hi z(key) - sum_lo z(key))) / denom

with z the counter-based normal of ``core.noise.counter_normal`` at each
element's linear index in the whole tensor: g is the whole tensor, a
contiguous window of it, or (on a mesh) a rank's block of it, whose
``core.noise.geometry`` the block route of the kernel walks row by row
(``dp_counter_noise_block``), so a block's draws are bitwise that block of
the whole tensor's. One key is the Gaussian mechanism; the tree
mechanism's increment is two key lists (``core.noise``). The keys are
derived on the host (Python ints, no device work) and travel as kernel
parameters in a key plan (:func:`key_plan`: each distinct key once, with
the sums it is added to), so a key both lists hold is drawn once.
Source: ``csrc/counter_noise.cu`` with ``csrc/counter_normal.cuh``
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

MAX_KEYS = 64          # csrc/counter_normal.cuh: distinct keys a launch takes
HI, LO = 1, 2          # a plan key's sides: added to the hi sum, the lo sum


def window(shape, offsets=None, full_shape=None) -> tuple:
    """-> (start, trail): the linear index of the block ``shape`` at
    ``offsets`` in ``full_shape``, and the span of counter word 0, for a
    block that is a contiguous run of the whole tensor's linear order
    (leading dims of 1, then whole dims). Any other block has a
    ``core.noise.geometry`` with dims, and raises here."""
    geo = noise.geometry(shape, offsets, full_shape)
    if not geo.contiguous:
        raise ValueError(f"block {tuple(shape)} at {offsets} of "
                         f"{full_shape} is not a contiguous window: "
                         "its draws take the block route "
                         "(core.noise.geometry)")
    return geo.start, geo.trail


def geometry_args(geo: noise.Geometry):
    """A block geometry as the block entries take it: 8 uint64 (start, the
    strides of dims 0..2, the 4 dims), a ctypes array."""
    return (ctypes.c_ulonglong * 8)(geo.start, *geo.strides, *geo.dims)


def _scalar(x: float, dtype) -> float:
    """``x`` rounded to the leaf's dtype, as the reference's weakly typed
    scalar is."""
    return float(torch.tensor(float(x), dtype=dtype))


def key_plan(hi_keys, lo_keys) -> list:
    """-> [(key, sides), ...]: the distinct keys of the two lists, each
    once, in an order that keeps each list's own order; ``sides`` is HI
    where the key is in ``hi_keys``, LO where it is in ``lo_keys``, HI | LO
    where both hold it. Walking the plan and adding each key's draw to the
    sums its sides name adds each list's draws in the list's own order, so
    hi - lo is bitwise the two lists summed apart, with one draw a distinct
    key. Raises ValueError where the lists hold their shared keys in
    conflicting orders (no walk keeps both) or a list holds a key twice."""
    hi = [tuple(int(w) for w in k) for k in hi_keys]
    lo = [tuple(int(w) for w in k) for k in lo_keys]
    for name, keys in (("hi", hi), ("lo", lo)):
        if len(set(keys)) != len(keys):
            raise ValueError(f"key_plan: the {name} list holds a key twice: "
                             f"{keys}")
    shared = set(hi) & set(lo)
    plan, i, j = [], 0, 0
    while i < len(hi) or j < len(lo):
        if i < len(hi) and hi[i] not in shared:
            plan.append((hi[i], HI))
            i += 1
        elif j < len(lo) and lo[j] not in shared:
            plan.append((lo[j], LO))
            j += 1
        elif i < len(hi) and j < len(lo) and hi[i] == lo[j]:
            plan.append((hi[i], HI | LO))
            i += 1
            j += 1
        else:
            raise ValueError(f"key_plan: the hi and lo lists hold their "
                             f"shared keys in conflicting orders: hi {hi}, "
                             f"lo {lo}")
    return plan


def plan_args(hi_keys, lo_keys, name: str) -> tuple:
    """The key plan as the C entries take it: (keys, sides, n_keys), two
    uint32 words a key and one byte of sides a key, as ctypes arrays."""
    plan = key_plan(hi_keys, lo_keys)
    if len(plan) > MAX_KEYS:
        raise ValueError(f"{name} takes at most {MAX_KEYS} distinct keys, "
                         f"got {len(plan)}")
    words = [w & noise.M32 for key, _ in plan for w in key]
    keys = (ctypes.c_uint32 * max(1, len(words)))(*words)
    sides = (ctypes.c_uint8 * max(1, len(plan)))(*[s for _, s in plan])
    return keys, sides, len(plan)


def plain(g, hi_keys, lo_keys, alpha: float, denom: float, start: int = 0,
          trail: int | None = None, dims: tuple = (),
          strides: tuple = ()) -> torch.Tensor:
    """The kernel's function in plain torch: each distinct key's draw by
    ``noise.linear_normal`` (a window from ``start``) or
    ``noise.block_normal`` (a block: ``dims`` and ``strides`` of its
    ``core.noise.Geometry``), as :func:`key_plan` walks the keys, added to
    the hi sum, the lo sum or both, each sum in its list's order from 0 in
    f32, then the reference's arithmetic in the leaf's dtype (0-dim device
    operands, so the division is a true division on either device)."""
    n = g.numel()
    trail = trail if trail is not None else noise.counter_split(g.shape)[1]
    geo = noise.Geometry(start, trail, tuple(dims), tuple(strides))
    a = torch.zeros(n, dtype=torch.float32, device=g.device)
    b = torch.zeros(n, dtype=torch.float32, device=g.device)
    for key, sides in key_plan(hi_keys, lo_keys):
        z = (noise.linear_normal(key, start, n, trail, g.device)
             if geo.contiguous else noise.block_normal(key, geo, g.device))
        if sides & HI:
            a = a + z
        if sides & LO:
            b = b + z
    xi = (a - b).view(g.shape)
    dt = g.dtype
    a = torch.tensor(alpha, dtype=dt, device=g.device)
    d = torch.tensor(denom, dtype=dt, device=g.device)
    return (g + a * xi.to(dt)) / d


def counter_noise(g: torch.Tensor, hi_keys, lo_keys, alpha: float,
                  denom: float, offsets=None, full_shape=None,
                  inplace: bool = False) -> torch.Tensor:
    """(g + alpha * (sum of the hi keys' draws - sum of the lo keys'))
    / denom, the draws at g's coordinates: g is the block at ``offsets`` of
    ``full_shape`` (the whole tensor by default), a contiguous window or
    any block (``core.noise.geometry``). f32 or bf16 leaves; ``inplace``
    writes the result over g (a CUDA leaf). One launch: the window's entry,
    or the block route's."""
    geo = noise.geometry(g.shape, offsets, full_shape)
    hi_keys, lo_keys = list(hi_keys), list(lo_keys)
    if g.device.type == "cpu":
        return plain(g, hi_keys, lo_keys, alpha, denom, geo.start, geo.trail,
                     geo.dims, geo.strides)
    bf16 = build.check_inputs("counter_noise", (g,))
    keys, sides, n_keys = plan_args(hi_keys, lo_keys, "counter_noise")
    out = g if inplace else torch.empty_like(g)
    if g.numel() == 0:
        return out
    lib = build.lib_for(g)
    tail = (g.numel(), _scalar(alpha, g.dtype), _scalar(denom, g.dtype),
            int(bf16), build.stream_ptr(g))
    if geo.contiguous:
        build.check(lib.dp_counter_noise(
            g.data_ptr(), out.data_ptr(), ctypes.addressof(keys),
            ctypes.addressof(sides), n_keys, geo.start, geo.trail, *tail),
            "counter_noise")
    else:
        where = geometry_args(geo)
        build.check(lib.dp_counter_noise_block(
            g.data_ptr(), out.data_ptr(), ctypes.addressof(keys),
            ctypes.addressof(sides), n_keys, ctypes.addressof(where),
            geo.trail, *tail), "counter_noise")
    counter_noise.launches += build.counted(lib)
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
