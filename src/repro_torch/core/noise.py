"""Phase-4 noise: counter-based Gaussian draws keyed as the JAX package keys
them, and the mechanisms that add them (counterpart of
``repro/core/noise.py``).

    private leaf = (G + sigma * scale * xi) / denom,    xi ~ N(0, I)

A key is a pair of Python ints ``(k0, k1)``, each a uint32: the raw data
of a JAX threefry ``PRNGKey``. Keys are derived on the host with no device
work: :func:`prng_key` (JAX's ``PRNGKey``), :func:`fold_in`
(``threefry2x32(key, (0, data))``, JAX's ``_threefry_fold_in``) and
:func:`_path_rng` (``fold_in`` of ``crc32(path) & 0x7FFFFFFF``). A train
step draws under ``fold_in(base, step)`` with ``base = prng_key(seed + 1)``.

:func:`counter_normal` draws the value at a tensor's global coordinate as a
pure function of (key, linear index): one threefry2x32 block per element,
the index as the counter (split across both counter words past 2^32
elements), the top 24 bits of word 0 to a uniform
``u = m * 2^-24 + 2^-25``, then :func:`ndtri`, the reference's f32
polynomial op for op. The bits and the uniforms equal the reference's
bitwise; the normals agree within a few ulp (``log`` and ``sqrt`` round
differently in the two libraries).

One deliberate departure: where ``m = 2^24 - 1`` the reference's uniform
rounds to exactly 1.0 (1 - 2^-25 is a tie, and ties go to even) and its
normal is +inf (2 of the first 2^26 draws under a train step's embedding
key, tests/test_torch_noise.py), and one inf in a clipped sum makes
AdamW's moments inf and the parameter NaN. Here that bucket's uniform is the largest f32 below 1, 1 - 2^-24
(0x3F7FFFFF), so every draw is finite.

On a CUDA leaf the draw and the add run in one kernel,
``kernels.counter_noise`` (``csrc/counter_noise.cu``); on a CPU leaf its
plain version, these functions. The BK train step defers each leaf's noise
(:class:`NoisedLeaf`) into the optimizer's one pass over it,
``kernels.noise_update``, which draws the same values. Two mechanisms are
registered, as in the reference: 'gaussian' (independent noise each step,
keyed by the step's key) and 'tree' (binary-tree aggregation for DP-FTRL:
node noise keyed by a fixed seed, each step adding the increment N(t) -
N(t-1), with epoch restarts and completion). Meshes (``sharded_normal``
with a mesh) are ROADMAP B7.

``path_seed`` keys the int8 tape store's rounding draws and the synthetic
batches (``core.bk``, ``data.synthetic``): ``torch.Generator`` draws, which
differ from the reference's.
"""
from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Mapping

import torch

M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1
# threefry2x32's rotations, by group of four rounds, and key parity (JAX's
# jax._src.prng.threefry2x32 and the Random123 paper)
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
PARITY = 0x1BD11BDA
TOP_BUCKET = (1 << 24) - 1
_CHUNK = 1 << 24          # elements a plain draw computes at once


# ----------------------------------------------------------------- keys
def threefry2x32(k0, k1, x0, x1):
    """One threefry2x32 block (20 rounds) of key (k0, k1) on counter
    (x0, x1) -> (y0, y1). Every argument is a uint32 held in a Python int or
    in an int64 tensor; the arithmetic is masked to 32 bits, so the same
    code serves the host's key derivation and the plain draw."""
    ks = (k0, k1, k0 ^ k1 ^ PARITY)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for j in range(5):
        for r in ROTATIONS[j % 2]:
            x0 = (x0 + x1) & M32
            x1 = ((x1 << r) | (x1 >> (32 - r))) & M32
            x1 = x1 ^ x0
        x0 = (x0 + ks[(j + 1) % 3]) & M32
        x1 = (x1 + ks[(j + 2) % 3] + j + 1) & M32
    return x0, x1


def prng_key(seed: int) -> tuple:
    """JAX's ``PRNGKey(seed)`` (threefry, 32-bit seeds): (0, seed as a
    uint32)."""
    seed = int(seed)
    if not -(1 << 31) <= seed < 1 << 31:
        raise ValueError(f"prng_key takes an int32 seed, got {seed}")
    return (0, seed & M32)


def fold_in(key, data: int) -> tuple:
    """JAX's ``fold_in``: threefry2x32 of ``key`` on counter (0, data)."""
    return threefry2x32(int(key[0]), int(key[1]), 0, int(data) & M32)


def _path_rng(key, path: str) -> tuple:
    return fold_in(key, zlib.crc32(path.encode()) & 0x7FFFFFFF)


def key_seed(key) -> int:
    """A key as one 64-bit int (the int8 tape store's seed)."""
    return (int(key[0]) << 32) | int(key[1])


def _mix64(x: int) -> int:
    """splitmix64 finalizer: a bijective avalanche on 64-bit ints."""
    x = (x ^ (x >> 30)) * 0xBF58476D1CE4E5B9 & _M64
    x = (x ^ (x >> 27)) * 0x94D049BB133111EB & _M64
    return x ^ (x >> 31)


def path_seed(seed: int, step: int, path: str) -> int:
    """``torch.Generator`` seed of one path's int8 tape rounding draws (a
    non-negative int63)."""
    x = _mix64((seed & _M64) ^ 0x9E3779B97F4A7C15)
    x = _mix64(x ^ (step & _M64))
    x = _mix64(x ^ zlib.crc32(path.encode()))
    return x >> 1


def tape_seed(rng) -> int:
    """The int8 tape store's seed under a step's key."""
    return path_seed(key_seed(rng), 0, "tape")


# ---------------------------------------------------------------- ndtri
# jax._src.scipy.special._ndtri's constants (cephes), as float64 literals;
# each becomes an f32 as the reference's np.array(..., dtype=float32) does
P0 = (-5.99633501014107895267E1, 9.80010754185999661536E1,
      -5.66762857469070293439E1, 1.39312609387279679503E1,
      -1.23916583867381258016E0)
Q0 = (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0,
      8.63602421390890590575E1, -2.25462687854119370527E2,
      2.00260212380060660359E2, -8.20372256168333339912E1,
      1.59056225126211695515E1, -1.18331621121330003142E0)
P1 = (4.05544892305962419923E0, 3.15251094599893866154E1,
      5.71628192246421288162E1, 4.40805073893200834700E1,
      1.46849561928858024014E1, 2.18663306850790267539E0,
      -1.40256079171354495875E-1, -3.50424626827848203418E-2,
      -8.57456785154685413611E-4)
Q1 = (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1,
      4.13172038254672030440E1, 1.50425385692907503408E1,
      2.50464946208309415979E0, -1.42182922854787788574E-1,
      -3.80806407691578277194E-2, -9.33259480895457427372E-4)
P2 = (3.23774891776946035970E0, 6.91522889068984211695E0,
      3.93881025292474443415E0, 1.33303460815807542389E0,
      2.01485389549179081538E-1, 1.23716634817820021358E-2,
      3.01581553508235416007E-4, 2.65806974686737550832E-6,
      6.23974539184983293730E-9)
Q2 = (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0,
      1.37702099489081330271E0, 2.16236993594496635890E-1,
      1.34204006088543189037E-2, 3.28014464682127739104E-4,
      2.89247864745380683936E-6, 6.79019408009981274425E-9)
EXPM1_M2 = -math.expm1(-2.0)
EXP_M2 = math.exp(-2.0)
ONE_M_EXP_M2 = 1.0 - math.exp(-2.0)
SQRT_2PI = math.sqrt(2.0 * math.pi)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    """A float64 literal rounded to f32, on ``like``'s device (0-dim: a
    device operand, never the host-scalar path of CUDA's division)."""
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def _polyval(coeffs, x: torch.Tensor) -> torch.Tensor:
    """jnp.polyval's Horner order: y = 0; y = y * x + c for c in coeffs."""
    y = torch.zeros_like(x)
    for c in coeffs:
        y = y * x + _f32(c, x)
    return y


def ndtri(p: torch.Tensor) -> torch.Tensor:
    """The inverse normal CDF of an f32 tensor, op for op after the
    reference's ``_ndtri`` (both branches computed, then selected)."""
    half, one = _f32(0.5, p), _f32(1.0, p)
    mcp = torch.where(p > _f32(EXPM1_M2, p), one - p, p)
    mcp = torch.where(mcp == 0, half, mcp)
    w = mcp - half
    ww = w * w
    big = w + w * ww * (_polyval(P0, ww) / _polyval(Q0, ww))
    big = big * -_f32(SQRT_2PI, p)
    z = torch.sqrt(_f32(-2.0, p) * torch.log(mcp))
    first = z - torch.log(z) / z
    rz = torch.reciprocal(z)
    small = first - _polyval(P2, rz) / _polyval(Q2, rz) / z
    other = first - _polyval(P1, rz) / _polyval(Q1, rz) / z
    x = torch.where(mcp > _f32(EXP_M2, p), big,
                    torch.where(z >= _f32(8.0, p), small, other))
    x = torch.where(p > _f32(ONE_M_EXP_M2, p), x, -x)
    inf = _f32(float("inf"), p)
    return torch.where(p == 0, -inf, torch.where(p == 1, inf, x))


# ------------------------------------------------------------ the counter
def counter_split(full) -> tuple:
    """-> (k, trail, lead): dims [k:] of ``full`` index counter word 0
    (their product ``trail`` < 2^32), dims [:k] word 1 (``lead``). Raises
    past 2^64 elements or for a single dim >= 2^32."""
    full = tuple(int(s) for s in full)
    k, trail = len(full), 1
    while k > 0 and trail * full[k - 1] < (1 << 32):
        k -= 1
        trail *= full[k]
    lead = 1
    for s in full[:k]:
        lead *= s
    if lead >= 1 << 32:
        raise ValueError(
            f"counter_normal supports < 2^64 elements per tensor (and no "
            f"single dim >= 2^32), got shape {full}")
    return k, trail, lead


def uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 bits (int64) -> the f32 uniform of their top 24 bits:
    m * 2^-24 + 2^-25, the top bucket at 1 - 2^-24 (module docstring)."""
    m = bits >> 8
    u = m.to(torch.float32) * _f32(2.0 ** -24, bits) \
        + _f32(2.0 ** -25, bits)
    return torch.where(m == TOP_BUCKET, _f32(1.0 - 2.0 ** -24, bits), u)


def counter_bits(rng, shape, offsets=None, full_shape=None, device=None):
    """The threefry word under :func:`counter_normal`'s value at each
    coordinate of the block ``shape`` at ``offsets`` of ``full_shape``:
    uint32 values in an int64 tensor."""
    shape = tuple(int(s) for s in shape)
    full = tuple(full_shape) if full_shape is not None else shape
    k, _, _ = counter_split(full)

    def plane(dims) -> torch.Tensor:
        idx = torch.zeros(shape, dtype=torch.int64, device=device)
        stride = 1
        for d in reversed(dims):
            view = [1] * len(shape)
            view[d] = shape[d]
            coord = torch.arange(shape[d], device=device).view(view)
            if offsets is not None:
                coord = coord + int(offsets[d])
            idx = (idx + coord * stride) & M32
            stride *= int(full[d])
        return idx

    lo, hi = plane(range(k, len(full))), plane(range(k))
    return threefry2x32(int(rng[0]), int(rng[1]), lo, hi)[0]


def counter_normal(rng, shape, dtype=torch.float32, offsets=None,
                   full_shape=None, device=None) -> torch.Tensor:
    """Counter-based N(0,1): the value at global coordinate x is a pure
    function of (key, linear index of x within ``full_shape``). A block
    at per-dim ``offsets`` of ``full_shape`` reproduces that block of the
    whole tensor's draw exactly."""
    return ndtri(uniform(counter_bits(rng, shape, offsets, full_shape,
                                      device))).to(dtype)


def linear_normal(rng, start: int, n: int, trail: int,
                  device=None) -> torch.Tensor:
    """:func:`counter_normal`'s values at linear indices start .. start+n-1
    of a tensor whose counter word 0 spans ``trail`` (``counter_split``):
    word 0 = index mod trail, word 1 = index div trail. (n,) f32, computed
    in chunks of 2^24 elements."""
    out = torch.empty(n, dtype=torch.float32, device=device)
    for a in range(0, n, _CHUNK):
        b = min(n, a + _CHUNK)
        hi0, lo0 = divmod(start + a, trail)
        c = torch.arange(b - a, dtype=torch.int64, device=device) + lo0
        hi, lo = torch.div(c, trail, rounding_mode="floor") + hi0, c % trail
        bits = threefry2x32(int(rng[0]), int(rng[1]), lo & M32, hi & M32)[0]
        out[a:b] = ndtri(uniform(bits))
    return out


def sharded_normal(rng, shape, dtype=torch.float32, mesh=None, spec=None,
                   device=None) -> torch.Tensor:
    """N(0,1) draw of a whole tensor. Shard-local generation on a mesh is
    ROADMAP B7."""
    if mesh is not None:
        raise NotImplementedError("sharded_normal on a mesh is not ported "
                                  "(ROADMAP B7: distributed)")
    return counter_normal(rng, shape, dtype, device=device)


# ------------------------------------------------------------- the add
def _scale_for(sensitivity, path: str) -> float:
    """Per-leaf noise scale: a shared float or a {path: scale} mapping."""
    if isinstance(sensitivity, Mapping):
        return sensitivity[path]
    return sensitivity


def next_pow2(n: int) -> int:
    """Smallest power of two >= n (tree-completion horizon)."""
    return 1 << max(0, int(n) - 1).bit_length()


def partial_sigma(sigma: float, n_shards: int) -> float:
    return sigma / (n_shards ** 0.5)


@dataclass(frozen=True)
class NoisedLeaf:
    """A leaf's phase 4, not yet drawn: (g + alpha * (sum of the hi keys'
    draws - sum of the lo keys')) / denom over g's linear indices start ..
    start + g.numel() - 1 of a tensor whose counter word 0 spans ``trail``.
    What a mechanism's ``add_leaf(..., out="deferred")`` returns for
    ``Optimizer.update_leaves``, whose ``kernels.noise_update`` draws it
    inside the optimizer's pass over the leaf."""
    g: torch.Tensor
    hi_keys: tuple
    lo_keys: tuple
    alpha: float
    denom: float
    start: int
    trail: int


# where a noised leaf goes (add_leaf's ``out``): a new tensor, over the sum
# (a CUDA leaf's kernel writes over ``g``; the caller drops it), or not
# drawn yet (a NoisedLeaf for the optimizer's pass to draw)
OUTS = ("new", "inplace", "deferred")


def _noise(g, hi_keys, lo_keys, alpha, denom, out="new"):
    from repro_torch.kernels.counter_noise import counter_noise, window
    if out not in OUTS:
        raise ValueError(f"out must be one of {OUTS}, got {out!r}")
    if out == "deferred":
        return NoisedLeaf(g, tuple(hi_keys), tuple(lo_keys), alpha, denom,
                          *window(g.shape))
    return counter_noise(g, hi_keys, lo_keys, alpha, denom,
                         inplace=out == "inplace")


def add_noise(flat_grads: dict, rng, sigma: float, R, denom: float,
              mesh=None, pspecs=None) -> dict:
    """(G + sigma*R*xi) / denom per leaf. sigma==0 -> just G/denom. ``R``
    may be a float (shared scale) or a {path: scale} mapping."""
    if mesh is not None:
        raise NotImplementedError("add_noise on a mesh is not ported "
                                  "(ROADMAP B7: distributed)")
    out = {}
    for path, g in flat_grads.items():
        if sigma > 0.0:
            out[path] = _noise(g, [_path_rng(rng, path)], [],
                               sigma * _scale_for(R, path), denom)
        else:
            out[path] = g / denom
    return out


# ----------------------------------------------------------------- mechanisms
class GaussianMechanism:
    """Per-step independent Gaussian noise — the DP-SGD default."""
    name = "gaussian"

    def __init__(self, seed: int = 0, depth: int = 0,
                 restart_every: int = 0, completion: bool = False):
        del seed, depth, restart_every, completion  # stateless: per-step rng

    def state_dict(self) -> dict:
        """Per-step noise is keyed off the step key the TrainState already
        holds: the mechanism carries no restorable state."""
        return {"name": self.name}

    def load_state(self, state: dict) -> None:
        if state.get("name") != self.name:
            raise ValueError(
                f"checkpoint noise state is {state.get('name')!r} but the "
                f"resumed run configures {self.name!r} — resuming would "
                "switch the noise mechanism mid-release")

    def add_leaf(self, path: str, g, rng, sigma: float, scale,
                 denom: float, step=None, out: str = "new"):
        """One leaf of ``add``; ``out`` (``OUTS``) says where a noised leaf
        goes: a new tensor, over ``g``, or a :class:`NoisedLeaf`."""
        del step  # per-step independence: the per-call rng is the state
        if sigma > 0.0:
            return _noise(g, [_path_rng(rng, path)], [], sigma * scale,
                          denom, out)
        return g / denom

    def add(self, flat_grads: dict, rng, sigma: float, sensitivity,
            denom: float, step=None) -> dict:
        return {path: self.add_leaf(path, g, rng, sigma,
                                    _scale_for(sensitivity, path), denom,
                                    step=step)
                for path, g in flat_grads.items()}


class TreeAggregationMechanism:
    """Binary-tree aggregated noise (DP-FTRL).

    Node (level l, index i>=1) covers steps [(i-1)*2^l + 1, i*2^l]. At step t
    (1-indexed) the prefix [1..t] is covered by one node per set bit b of t,
    with index i = t >> b, so the cumulative noise N(t) sums popcount(t)
    unit-variance node draws. The per-call ``rng`` is ignored: node noise
    keys off the fixed ``seed`` + (path, epoch, level, index) only, so the
    increments telescope.

    ``restart_every=E`` rebuilds the tree every E steps: step t maps to
    epoch step//E with local prefix (step % E) + 1. ``completion=True``
    advances the last increment of each epoch to N_e(next_pow2(E)). Only
    the levels whose index bit is set are drawn: the reference adds 0·z for
    the others, and every z here is finite.
    """
    name = "tree"

    def __init__(self, seed: int = 0, depth: int = 30,
                 restart_every: int = 0, completion: bool = False):
        self.seed = seed
        self.depth = depth           # supports up to 2^depth - 1 steps
        self.restart_every = int(restart_every)
        self.completion = bool(completion)
        if self.completion and self.restart_every <= 0:
            raise ValueError("tree completion needs restart_every > 0 "
                             "(it corrects the noise at epoch boundaries)")
        if self.restart_every > 0 and \
                next_pow2(self.restart_every) >= (1 << depth):
            raise ValueError(
                f"depth {depth} cannot cover the per-epoch horizon "
                f"{next_pow2(self.restart_every)} (restart_every="
                f"{self.restart_every})")

    def state_dict(self) -> dict:
        """The node noise is a pure function of (seed, path, epoch, level,
        index), so the restorable state is the configuration that keys it.
        Depth is excluded: it is a draw-cost knob, not part of the noise."""
        return {"name": self.name, "seed": self.seed,
                "restart_every": self.restart_every,
                "completion": self.completion}

    def load_state(self, state: dict) -> None:
        """Raise unless this mechanism continues the checkpointed release
        (the same seed, restart period and completion flag)."""
        mine = self.state_dict()
        drift = {k: (state.get(k), mine[k]) for k in mine
                 if state.get(k) != mine[k]}
        if drift:
            raise ValueError(
                "tree-noise state drift between checkpoint and resumed run "
                "(checkpointed != configured): "
                + ", ".join(f"{k}: {a!r} != {b!r}"
                            for k, (a, b) in sorted(drift.items())))

    def _node(self, path: str, level: int, idx: int, epoch: int = 0):
        k = fold_in(_path_rng(prng_key(self.seed), path), epoch)
        return fold_in(fold_in(k, level), idx)

    def node_keys(self, path: str, t: int, epoch: int = 0) -> list:
        """The keys of the nodes covering [1..t], by ascending level."""
        return [self._node(path, b, t >> b, epoch)
                for b in range(self.depth) if (t >> b) & 1]

    def prefix_noise(self, path: str, shape, t: int, dtype=torch.float32,
                     epoch: int = 0, device=None) -> torch.Tensor:
        """N_e(t): the sum of the node draws covering [1..t] (f32, by
        ascending level)."""
        out = torch.zeros(tuple(shape), dtype=torch.float32, device=device)
        for key in self.node_keys(path, t, epoch):
            out = out + counter_normal(key, shape, device=device)
        return out.to(dtype)

    def _epoch_local(self, step: int):
        """Global 0-indexed step -> (epoch, local 1-indexed prefix t)."""
        if self.restart_every <= 0:
            return 0, step + 1
        return step // self.restart_every, (step % self.restart_every) + 1

    def _local_prefix(self, sigma: float, step):
        """Validated (epoch, t, t_hi) for one call (shared by every leaf)."""
        if sigma > 0.0 and step is None:
            # a forgotten step would re-add the same N(1) - N(0) every call
            raise ValueError(
                "tree aggregation is stateful: pass the step index — "
                "grad_fn(params, batch, rng, step) / engine.grad(..., step)")
        epoch, t = self._epoch_local(int(step) if step is not None else 0)
        if t >= (1 << self.depth):
            raise ValueError(
                f"step {t - 1} exceeds the tree horizon 2^depth-1 = "
                f"{(1 << self.depth) - 1}; raise depth (or set "
                "restart_every) to cover the run")
        t_hi = t
        if self.completion and t == self.restart_every:
            t_hi = next_pow2(self.restart_every)
        return epoch, t, t_hi

    def add_leaf(self, path: str, g, rng, sigma: float, scale,
                 denom: float, step=None, out: str = "new"):
        del rng  # node noise keys off the fixed seed only
        epoch, t, t_hi = self._local_prefix(sigma, step)
        if sigma > 0.0:
            return _noise(g, self.node_keys(path, t_hi, epoch),
                          self.node_keys(path, t - 1, epoch), sigma * scale,
                          denom, out)
        return g / denom

    def add(self, flat_grads: dict, rng, sigma: float, sensitivity,
            denom: float, step=None) -> dict:
        return {path: self.add_leaf(path, g, rng, sigma,
                                    _scale_for(sensitivity, path), denom,
                                    step=step)
                for path, g in flat_grads.items()}


NOISE_MECHANISMS = {
    "gaussian": GaussianMechanism,
    "tree": TreeAggregationMechanism,
}


def get_mechanism(name: str, seed: int = 0, depth: int | None = None,
                  restart_every: int = 0, completion: bool = False):
    """Build a registered mechanism. ``depth`` None/0 keeps the mechanism's
    own default (the tree's 30): a pass-through, never a clobber."""
    try:
        cls = NOISE_MECHANISMS[name]
    except KeyError:
        raise ValueError(f"unknown noise mechanism {name!r}; options: "
                         f"{sorted(NOISE_MECHANISMS)}")
    kw = {"seed": seed, "restart_every": restart_every,
          "completion": completion}
    if depth:
        kw["depth"] = depth
    return cls(**kw)
