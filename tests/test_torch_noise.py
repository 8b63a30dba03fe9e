"""The port's phase-4 noise (``repro_torch.core.noise``, the
``counter_noise`` kernel's plain version and wrapper, the policy's noise
knobs) against the JAX package's ``repro.core.noise`` and
``repro.core.policy``: threefry2x32, the keys (``prng_key``, ``fold_in``,
``_path_rng``) and the counter's bits and uniforms bitwise; ``ndtri`` over
all 2^24 uniforms within 8 ulp; ``counter_normal``'s normals within 8 ulp;
the Gaussian and tree mechanisms, ``add_noise`` and heterogeneous
``noise_leaf_fn`` at f32 TOL. The reference's top bucket (its uniform
rounds to 1.0 and its normal is +inf) is the one place the port differs
on purpose: there its uniform is 1 - 2^-24 and its normal finite. Also the
committed golden file that ``chip_smoke.py`` reads, regenerated here from
JAX (``python tests/test_torch_noise.py --write`` rewrites it), and the
wrapper's C-call arguments through a fake library."""
import json
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from jax.extend.random import threefry2x32_p

from repro.configs.registry import build as jbuild
from repro.configs.registry import smoke_config as jsmoke
from repro.core import noise as jn
from repro.core import policy as jpol
from repro.utils.tree import flatten as jflatten
from repro_torch.core import noise
from repro_torch.core import policy as tpol
from repro_torch.kernels import build
from repro_torch.kernels import counter_noise as cn_mod

TOL = dict(rtol=1e-3, atol=1e-4)          # tests/test_kernel_parity.py:15
TOL_BF16 = dict(rtol=5e-2, atol=2e-2)     # :18
ULP = 8                                   # the normals' bound (ndtri)
M32 = 0xFFFFFFFF
GOLDEN = (Path(__file__).resolve().parents[1] / "src" / "repro_torch"
          / "core" / "noise_golden.json")
KATS = [((0, 0), (0, 0), (0x6b200159, 0x99ba4efe)),
        ((M32, M32), (M32, M32), (0x1cb996fc, 0xbb002be7)),
        ((0x13198a2e, 0x03707344), (0x243f6a88, 0x85a308d3),
         (0xc4923a9c, 0x483df7a0))]


def _key(k) -> tuple:
    return tuple(int(v) for v in np.asarray(k))


def _ulp(a, b) -> np.ndarray:
    """|a - b| in f32 ulps (the distance of their ordered bit patterns)."""
    def ordered(x):
        i = np.ascontiguousarray(x, np.float32).view(np.int32).astype(
            np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return np.abs(ordered(a) - ordered(b))


def _close_where_finite(got, want, tol, what=""):
    """The port's values against the reference's where the reference is
    finite; the port finite everywhere. -> the reference's non-finite
    count (its top bucket)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.isfinite(got).all(), what
    ok = np.isfinite(want)
    np.testing.assert_allclose(got[ok], want[ok], err_msg=what, **tol)
    return int((~ok).sum())


# ------------------------------------------------------------------ threefry
@pytest.mark.parametrize("key,ctr,want", KATS)
def test_threefry_known_answers(key, ctr, want):
    assert noise.threefry2x32(*key, *ctr) == want
    got = threefry2x32_p.bind(*(jnp.asarray([v], jnp.uint32)
                                for v in (*key, *ctr)))
    assert tuple(int(np.asarray(g)[0]) for g in got) == want


def test_threefry_matches_jax_on_random_words():
    w = np.random.default_rng(0).integers(0, 1 << 32, (4, 4096),
                                          dtype=np.uint64)
    want = threefry2x32_p.bind(*(jnp.asarray(v.astype(np.uint32))
                                 for v in w))
    got = noise.threefry2x32(*(torch.from_numpy(v.astype(np.int64))
                               for v in w))
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g.numpy(),
                                      np.asarray(x).astype(np.int64))
    # the same function on Python ints (the host's key derivation)
    for i in range(0, 4096, 511):
        assert noise.threefry2x32(*(int(v[i]) for v in w)) == \
            (int(np.asarray(want[0])[i]), int(np.asarray(want[1])[i]))


# ---------------------------------------------------------------------- keys
@pytest.mark.parametrize("seed", [0, 1, 5, 7, 2 ** 31 - 1, -1, -7])
def test_prng_key_matches_jax(seed):
    assert noise.prng_key(seed) == _key(jax.random.PRNGKey(seed))


def test_prng_key_refuses_seeds_past_int32():
    with pytest.raises(ValueError, match="int32"):
        noise.prng_key(1 << 31)


def test_fold_in_known_answer():
    assert noise.prng_key(5) == (0, 5)
    assert noise.fold_in(noise.prng_key(5), 7) == (1394159668, 1590028285)


@pytest.mark.parametrize("step", [0, 1, 2, 7, 255, 12345, 2 ** 31 - 1])
def test_fold_in_matches_jax(step):
    for seed in (0, 1, 9):
        base = jax.random.PRNGKey(seed)
        assert noise.fold_in(_key(base), step) == \
            _key(jax.random.fold_in(base, step))


def test_path_rng_matches_jax_over_the_smoke_paths():
    """crc32(path) & 0x7FFFFFFF folded in, over every param path of the
    qwen2-1.5b smoke model, under a train step's key."""
    paths = sorted(jflatten(jbuild(jsmoke("qwen2-1.5b")).init(
        jax.random.PRNGKey(0))))
    assert len(paths) >= 10
    rng = jax.random.fold_in(jax.random.PRNGKey(1), 3)
    for p in paths:
        assert noise._path_rng(_key(rng), p) == _key(jn._path_rng(rng, p))


# --------------------------------------------------------------------- ndtri
def _all_uniforms():
    return noise.uniform(torch.arange(1 << 24, dtype=torch.int64) << 8)


def test_uniforms_are_the_references_except_the_top_bucket():
    bits = np.arange(1 << 24, dtype=np.uint32) << np.uint32(8)
    want = np.asarray((jnp.asarray(bits) >> jnp.uint32(8)).astype(
        jnp.float32) * jnp.float32(2 ** -24) + jnp.float32(2 ** -25))
    got = _all_uniforms().numpy()
    np.testing.assert_array_equal(got[:-1].view(np.int32),
                                  want[:-1].view(np.int32))
    assert want[-1] == 1.0          # the reference's top bucket
    assert got[-1].view(np.int32) == 0x3F7FFFFF
    assert (got < 1.0).all() and (got > 0.0).all()


def test_ndtri_over_every_uniform_within_8_ulp():
    """All 2^24 uniforms the counter can give, against
    jax.scipy.special.ndtri at the same f32 inputs: within 8 ulp, finite
    everywhere; the top bucket is exactly ndtri(1 - 2^-24)."""
    u = _all_uniforms()
    got = noise.ndtri(u).numpy()
    want = np.asarray(jax.jit(jax.scipy.special.ndtri)(jnp.asarray(
        u.numpy())))
    assert np.isfinite(got).all() and np.isfinite(want).all()
    assert int(_ulp(got, want).max()) <= ULP
    top = noise.ndtri(torch.tensor([1.0 - 2.0 ** -24])).numpy()
    assert got[-1].view(np.int32) == top[0].view(np.int32)
    assert 5.0 < got[-1] < 6.0


def test_no_draw_is_negative_zero():
    """The kernels draw a plan of one HI key as z itself, not (0 + z) - 0:
    equal bit for bit because no normal of the 2^24 uniforms is -0 (the one
    zero, at the uniform 1/2, is +0)."""
    z = noise.ndtri(_all_uniforms())
    zero = z == 0
    assert int(zero.sum()) == 1 and not bool(torch.signbit(z[zero]).any())
    zeros = torch.zeros_like(z)
    assert torch.equal(((zeros + z) - zeros).view(torch.int32),
                       z.view(torch.int32))


def test_reference_top_bucket_is_inf_and_the_ports_is_finite():
    """The reference's one departure from a finite normal: among the first
    2^26 counters under a train step's embedding key, the draws whose top
    24 bits are all ones (2 here) are +inf in ``repro.core.noise.
    counter_normal``, and exactly ndtri(1 - 2^-24) in the port."""
    rng = jn._path_rng(jax.random.fold_in(jax.random.PRNGKey(0), 0),
                       "params/embed")
    k0, k1 = _key(rng)
    draw = jax.jit(lambda lo: threefry2x32_p.bind(
        jnp.full(lo.shape, k0, jnp.uint32),
        jnp.full(lo.shape, k1, jnp.uint32), lo,
        jnp.zeros_like(lo))[0] >> jnp.uint32(8))
    n, chunk, top = 1 << 26, 1 << 23, []
    for a in range(0, n, chunk):
        m = np.asarray(draw(jnp.arange(a, a + chunk, dtype=jnp.uint32)))
        top += (np.flatnonzero(m == 0xFFFFFF) + a).tolist()
    assert len(top) == 2
    want = noise.ndtri(torch.tensor([1.0 - 2.0 ** -24]))
    for i in top:
        ref = jn.counter_normal(rng, (1,), jnp.float32, offsets=[i],
                                full_shape=(n,))
        assert np.isposinf(np.asarray(ref)).all()
        got = noise.counter_normal((k0, k1), (1,), offsets=(i,),
                                   full_shape=(n,))
        assert torch.equal(got, want)


def test_ndtri_edges_match_jax():
    p = torch.tensor([0.0, 1.0, 0.5, 2.0 ** -25, 0.1353352832366127,
                      0.8646647, 1e-20, 1e-30], dtype=torch.float32)
    got = noise.ndtri(p).numpy()
    want = np.asarray(jax.scipy.special.ndtri(jnp.asarray(p.numpy())))
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert int(_ulp(got[fin], want[fin]).max()) <= ULP


# ------------------------------------------------------------ counter_normal
CASES = [  # (shape, offsets, full_shape)
    ((3, 5), None, None),
    ((7,), None, None),
    ((2, 3, 4), None, None),
    ((2, 3, 4), (1, 2, 0), (4, 6, 4)),
    # past 2^32 elements: the leading index rides counter word 1
    ((2, 8), (3, 2 ** 31 - 8), (8, 2 ** 31)),
    ((1, 16), (5, 0), (8, 2 ** 31)),
    ((1, 2, 4), (2, 3, 2 ** 30 - 4), (3, 5, 2 ** 30)),
]


def _ref_uniforms(monkeypatch, rng, shape, offsets, full):
    """The reference's uniforms: its counter_normal with ndtri the
    identity."""
    with monkeypatch.context() as m:
        m.setattr(jax.scipy.special, "ndtri", lambda u: u)
        return np.asarray(jn.counter_normal(rng, shape, jnp.float32,
                                            offsets=offsets,
                                            full_shape=full))


@pytest.mark.parametrize("shape,offsets,full", CASES)
def test_counter_normal_matches_jax(monkeypatch, shape, offsets, full):
    """Bits to uniforms bitwise (bar the top bucket), normals within 8
    ulp, f32 and bf16 (one bf16 rounding apart at most)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(0), 3)
    k = _key(rng)
    u_ref = _ref_uniforms(monkeypatch, rng, shape, offsets, full)
    u = noise.uniform(noise.counter_bits(k, shape, offsets, full)).numpy()
    top = u_ref == 1.0
    np.testing.assert_array_equal(u[~top].view(np.int32),
                                  u_ref[~top].view(np.int32))
    want = np.asarray(jn.counter_normal(rng, shape, jnp.float32,
                                        offsets=offsets, full_shape=full))
    got = noise.counter_normal(k, shape, offsets=offsets,
                               full_shape=full).numpy()
    assert got.shape == tuple(shape) and np.isfinite(got).all()
    fin = np.isfinite(want)
    assert int(_ulp(got[fin], want[fin]).max()) <= ULP
    got16 = noise.counter_normal(k, shape, torch.bfloat16, offsets=offsets,
                                 full_shape=full).float().numpy()
    want16 = np.asarray(jn.counter_normal(
        rng, shape, jnp.bfloat16, offsets=offsets,
        full_shape=full)).astype(np.float32)
    np.testing.assert_allclose(got16[fin], want16[fin], rtol=2 ** -7,
                               atol=0)


def test_counter_normal_blocks_tile_the_whole_draw():
    """Any partition of (key, full_shape) into blocks reproduces the whole
    tensor's draw bitwise, and linear windows (the kernel's form) too."""
    k = noise.fold_in(noise.prng_key(2), 1)
    whole = noise.counter_normal(k, (6, 10))
    for r in range(0, 6, 2):
        for c in range(0, 10, 5):
            blk = noise.counter_normal(k, (2, 5), offsets=(r, c),
                                       full_shape=(6, 10))
            assert torch.equal(blk, whole[r:r + 2, c:c + 5])
    lin = noise.linear_normal(k, 13, 29, 60)
    assert torch.equal(lin, whole.reshape(-1)[13:42])


def test_counter_normal_refuses_past_2_64():
    with pytest.raises(ValueError, match="2\\^64"):
        noise.counter_normal((0, 1), (1, 1), full_shape=(1 << 33, 1 << 32))
    with pytest.raises(ValueError, match="2\\^64"):
        noise.counter_split((1 << 33,))


def test_sharded_normal_on_a_mesh_is_b7():
    """Without a mesh the whole draw; on a (2, 2) mesh (ROADMAP B7) each
    rank's draw, and add_noise's leaf, is its block of the whole leaf's,
    bitwise."""
    import types
    assert torch.equal(noise.sharded_normal((0, 4), (3, 2)),
                       noise.counter_normal((0, 4), (3, 2)))
    whole = noise.counter_normal((0, 4), (4, 6))
    g = torch.zeros(4, 6)
    for d in range(2):
        for m in range(2):
            mesh = types.SimpleNamespace(shape={"data": 2, "model": 2},
                                         axis_names=("data", "model"),
                                         coords={"data": d, "model": m})
            want = whole[2 * d:2 * d + 2, 3 * m:3 * m + 3]
            assert torch.equal(noise.sharded_normal(
                (0, 4), (4, 6), mesh=mesh, spec=("data", "model")), want)
            out = noise.add_noise({"w": g}, (0, 1), 1.0, 1.0, 1.0,
                                  mesh=mesh, pspecs={"w": ("data", "model")})
            key = noise._path_rng((0, 1), "w")
            assert torch.equal(out["w"], noise.counter_normal(
                key, (4, 6))[2 * d:2 * d + 2, 3 * m:3 * m + 3])


def test_small_helpers_match_jax():
    for n in (0, 1, 2, 3, 5, 6, 8, 9, 1000):
        assert noise.next_pow2(n) == jn.next_pow2(n)
    assert noise.partial_sigma(1.2, 4) == jn.partial_sigma(1.2, 4)
    assert noise._scale_for({"a": 2.0}, "a") == jn._scale_for({"a": 2.0},
                                                              "a")
    assert noise._scale_for(3.0, "a") == 3.0


# ----------------------------------------------------------------- mechanisms
def _leaves(dtype=np.float32, seed=0):
    r = np.random.default_rng(seed)
    return {"blocks/mlp/up/w": r.standard_normal((2, 6, 10)).astype(dtype),
            "embed/w": r.standard_normal((17, 6)).astype(dtype),
            "final_norm/g": r.standard_normal((6,)).astype(dtype)}


def _to_jax(flat):
    return {k: jnp.asarray(v) for k, v in flat.items()}


def _to_torch(flat, dtype=torch.float32):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
            for k, v in flat.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gaussian_mechanism_matches_jax(dtype):
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    flat = _leaves(np_dt)
    rng = jax.random.fold_in(jax.random.PRNGKey(1), 4)
    want = jn.GaussianMechanism().add(_to_jax(flat), rng, 0.7, 1.3, 8.0)
    got = noise.GaussianMechanism().add(
        _to_torch(flat, getattr(torch, dtype)), _key(rng), 0.7, 1.3, 8.0)
    tol = TOL if dtype == "float32" else TOL_BF16
    for k in flat:
        assert got[k].dtype == getattr(torch, dtype)
        _close_where_finite(got[k].float(), np.asarray(want[k], np.float32),
                            tol, k)
    # sigma 0: the mean alone
    z = noise.GaussianMechanism().add(_to_torch(flat), _key(rng), 0.0, 1.3,
                                      8.0)
    for k, v in flat.items():
        np.testing.assert_array_equal(z[k].numpy(), v / np.float32(8.0))


def test_add_noise_matches_jax_with_a_scale_mapping():
    flat = _leaves()
    rng = jax.random.PRNGKey(9)
    scales = {"blocks/mlp/up/w": 0.5, "embed/w": 2.0, "final_norm/g": 1.0}
    want = jn.add_noise(_to_jax(flat), rng, 0.9, scales, 4.0)
    got = noise.add_noise(_to_torch(flat), _key(rng), 0.9, scales, 4.0)
    for k in flat:
        _close_where_finite(got[k], want[k], TOL, k)


@pytest.mark.parametrize("E,completion,steps", [
    (0, False, 11),          # no restarts: telescopes to N(11)
    (6, False, 14),          # two epochs and a bit (fresh trees)
    (6, True, 14),           # completion at each epoch's last step
    (5, True, 6),
])
def test_tree_mechanism_matches_jax_step_by_step(E, completion, steps):
    """Each step's increment against the reference's, and the running sum
    against its prefix noise (the reference's telescoping)."""
    kw = dict(seed=3, depth=8, restart_every=E, completion=completion)
    jm, tm = jn.TreeAggregationMechanism(**kw), \
        noise.TreeAggregationMechanism(**kw)
    flat = {"a/w": np.zeros((4, 5), np.float32),
            "b": np.zeros((7,), np.float32)}
    acc = {k: torch.zeros(v.shape) for k, v in flat.items()}
    for step in range(steps):
        want = jm.add(_to_jax(flat), None, 1.0, 1.0, 1.0, step=step)
        got = tm.add(_to_torch(flat), None, 1.0, 1.0, 1.0, step=step)
        for k in flat:
            _close_where_finite(got[k], want[k], TOL, f"{k} step {step}")
            acc[k] = acc[k] + got[k]
    epoch, t = tm._epoch_local(steps - 1)
    for k, v in flat.items():
        want = jm.prefix_noise(k, v.shape, t, epoch=epoch)
        got = tm.prefix_noise(k, v.shape, t, epoch=epoch)
        _close_where_finite(got, want, TOL, k)
        if E == 0:
            _close_where_finite(acc[k], want, TOL, k)


def test_tree_completion_advances_the_epochs_last_increment():
    """With completion the epoch's increments sum to N(next_pow2(E)): one
    node, the root path."""
    E = 6
    tm = noise.TreeAggregationMechanism(seed=0, depth=5, restart_every=E,
                                        completion=True)
    g = {"p": torch.zeros(64)}
    acc = torch.zeros(64)
    for step in range(E):
        acc = acc + tm.add(g, None, 1.0, 1.0, 1.0, step=step)["p"]
    assert len(tm.node_keys("p", 8)) == 1
    torch.testing.assert_close(acc, tm.prefix_noise("p", (64,), 8),
                               rtol=1e-4, atol=1e-5)


def test_tree_mechanism_refusals_match_the_reference():
    tm = noise.TreeAggregationMechanism(seed=0, depth=3)
    g = {"p": torch.zeros(4)}
    tm.add(g, None, 1.0, 1.0, 1.0, step=6)          # t = 7: the horizon
    with pytest.raises(ValueError, match="horizon"):
        tm.add(g, None, 1.0, 1.0, 1.0, step=7)
    with pytest.raises(ValueError, match="stateful"):
        tm.add(g, None, 1.0, 1.0, 1.0)
    with pytest.raises(ValueError):
        noise.TreeAggregationMechanism(completion=True)
    with pytest.raises(ValueError, match="horizon"):
        noise.TreeAggregationMechanism(depth=3, restart_every=9)


def test_mechanism_state_dicts_and_drift():
    for kw in (dict(), dict(seed=4, depth=9, restart_every=7,
                            completion=True)):
        tm = noise.TreeAggregationMechanism(**kw)
        assert tm.state_dict() == jn.TreeAggregationMechanism(
            **kw).state_dict()
        tm.load_state(tm.state_dict())
    tm = noise.TreeAggregationMechanism(seed=4, restart_every=7)
    for drift in (dict(seed=5), dict(restart_every=8),
                  dict(completion=True)):
        with pytest.raises(ValueError, match="drift"):
            tm.load_state({**tm.state_dict(), **drift})
    gm = noise.GaussianMechanism()
    assert gm.state_dict() == jn.GaussianMechanism().state_dict()
    gm.load_state({"name": "gaussian"})
    with pytest.raises(ValueError, match="switch"):
        gm.load_state({"name": "tree"})


def test_get_mechanism_depth_passthrough():
    assert noise.get_mechanism("tree").depth == 30
    assert noise.get_mechanism("tree", depth=0).depth == 30
    assert noise.get_mechanism("tree", depth=7).depth == 7
    assert isinstance(noise.get_mechanism("gaussian"),
                      noise.GaussianMechanism)
    assert sorted(noise.NOISE_MECHANISMS) == sorted(jn.NOISE_MECHANISMS)
    with pytest.raises(ValueError, match="unknown noise mechanism"):
        noise.get_mechanism("laplace")


# ------------------------------------------------------------------- policy
def _two_group(pkg, scale_a=1.0, scale_b=1.0, sigma=0.7, **kw):
    return pkg.PrivacyPolicy(groups=(
        pkg.ParamGroup("a", "x", R=1.0, scope="group", sigma_scale=scale_a),
        pkg.ParamGroup("b", ".*", R=2.0, scope="group",
                       sigma_scale=scale_b)), sigma=sigma, **kw)


@pytest.mark.parametrize("scales", [(1.0, 1.0), (0.25, 2.0)])
def test_noise_leaf_fn_matches_jax(scales):
    """Per-group sigma_scale (heterogeneous) and the flat scheme, leaf by
    leaf, and ``finalize_noise`` over the whole dict."""
    paths = ["x/w", "y/w", "y/b"]
    r = np.random.default_rng(3)
    sums = {p: r.standard_normal((5, 9)).astype(np.float32) for p in paths}
    jp, tp = _two_group(jpol, *scales), _two_group(tpol, *scales)
    jres, tres = jpol.resolve_policy(jp, paths), \
        tpol.resolve_policy(tp, paths)
    assert tres.heterogeneous == jres.heterogeneous
    assert tres.noise_scales() == pytest.approx(jres.noise_scales())
    assert tres.noise_multipliers() == pytest.approx(
        jres.noise_multipliers())
    rng = jax.random.fold_in(jax.random.PRNGKey(1), 2)
    jleaf = jpol.noise_leaf_fn(jp, jres, rng, 4.0, step=2)
    tleaf = tpol.noise_leaf_fn(tp, tres, _key(rng), 4.0, step=2)
    for p in paths:
        _close_where_finite(tleaf(p, torch.from_numpy(sums[p])),
                            jleaf(p, jnp.asarray(sums[p])), TOL, p)
    want = jpol.finalize_noise(jp, jres, _to_jax(sums), rng, 4.0, step=2)
    got = tpol.finalize_noise(tp, tres, _to_torch(sums), _key(rng), 4.0,
                              step=2)
    for p in paths:
        _close_where_finite(got[p], want[p], TOL, p)


def test_noise_leaf_fn_tree_policy_matches_jax():
    paths = ["x/w", "y/w"]
    sums = {p: np.ones((3, 4), np.float32) for p in paths}
    kw = dict(noise="tree", noise_seed=5, noise_depth=6,
              noise_restart_every=5, noise_completion=True)
    jp, tp = _two_group(jpol, 0.5, 1.0, **kw), _two_group(tpol, 0.5, 1.0,
                                                          **kw)
    assert tp.mechanism().state_dict() == jp.mechanism().state_dict()
    jres, tres = jpol.resolve_policy(jp, paths), \
        tpol.resolve_policy(tp, paths)
    for step in (0, 3, 4, 5):
        jleaf = jpol.noise_leaf_fn(jp, jres, None, 2.0, step=step)
        tleaf = tpol.noise_leaf_fn(tp, tres, None, 2.0, step=step)
        for p in paths:
            _close_where_finite(tleaf(p, torch.from_numpy(sums[p])),
                                jleaf(p, jnp.asarray(sums[p])), TOL,
                                f"{p} step {step}")


def test_frozen_leaves_pass_through_untouched():
    pol = tpol.PrivacyPolicy(groups=(
        tpol.ParamGroup("f", "x", trainable=False),
        tpol.ParamGroup("rest", ".*")), sigma=1.0)
    res = tpol.resolve_policy(pol, ["x/w", "y/w"])
    g = torch.zeros(4)
    leaf = tpol.noise_leaf_fn(pol, res, (0, 1), 2.0)
    assert leaf("x/w", g) is g
    assert not torch.equal(leaf("y/w", g), g)


def test_policy_noise_knobs_validate_as_the_reference():
    with pytest.raises(ValueError, match="noise='tree'"):
        tpol.PrivacyPolicy(groups=(tpol.ParamGroup("all", ".*"),),
                           noise_restart_every=10)
    with pytest.raises(ValueError, match="noise='tree'"):
        tpol.PrivacyPolicy(groups=(tpol.ParamGroup("all", ".*"),),
                           noise_completion=True)
    with pytest.raises(ValueError, match="noise_restart_every"):
        tpol.PrivacyPolicy(groups=(tpol.ParamGroup("all", ".*"),),
                           noise="tree", noise_completion=True)
    tpol.PrivacyPolicy(groups=(tpol.ParamGroup("all", ".*"),), noise="tree",
                       noise_restart_every=10, noise_completion=True)
    with pytest.raises(ValueError, match="sigma_scale"):
        tpol.ParamGroup("a", ".*", sigma_scale=0.0)
    with pytest.raises(ValueError, match="sigma_scale"):
        tpol.resolve_policy(tpol.PrivacyPolicy(groups=(
            tpol.ParamGroup("a", "x", sigma_scale=2.0),
            tpol.ParamGroup("b", ".*"))), ["x/w", "y/w"])
    pol = tpol.PrivacyPolicy(groups=(tpol.ParamGroup("all", ".*"),),
                             noise="tree", noise_depth=7)
    assert pol.mechanism().depth == 7


# ------------------------------------------------- the kernel's plain version
def test_plain_version_is_the_mechanisms_arithmetic():
    """``counter_noise.plain`` (what a CPU leaf runs, and what the kernel
    is held to on the card) is the mechanism's sum of draws and the
    reference's rounding points, f32 and bf16."""
    k1, k2, k3 = ((0, 1), (2, 3), (4, 5))
    g = torch.randn(3, 7, generator=torch.Generator().manual_seed(0))
    xi = noise.counter_normal(k1, (3, 7)) + noise.counter_normal(k2, (3, 7))
    xi = xi - noise.counter_normal(k3, (3, 7))
    want = (g + torch.tensor(0.6) * xi) / torch.tensor(3.0)
    assert torch.equal(cn_mod.counter_noise(g, [k1, k2], [k3], 0.6, 3.0),
                       want)
    gb = g.to(torch.bfloat16)
    a16, d16 = torch.tensor(0.6, dtype=torch.bfloat16), \
        torch.tensor(3.0, dtype=torch.bfloat16)
    want16 = (gb + a16 * xi.to(torch.bfloat16)) / d16
    assert torch.equal(cn_mod.counter_noise(gb, [k1, k2], [k3], 0.6, 3.0),
                       want16)


# ------------------------------------------------------------ the key plan
def _lists_plain(g, hi_keys, lo_keys, alpha, denom):
    """The plain version as it was before the key plan: each list's draws
    summed apart from 0 in f32 (a key both lists hold drawn for each), then
    hi - lo and the reference's arithmetic in the leaf's dtype."""
    n, trail = g.numel(), noise.counter_split(g.shape)[1]

    def total(keys):
        s = torch.zeros(n, dtype=torch.float32)
        for key in keys:
            s = s + noise.linear_normal(key, 0, n, trail, g.device)
        return s

    hi, lo = total(hi_keys), total(lo_keys)
    xi = (hi - lo).view(g.shape)
    dt = g.dtype
    return hi, lo, (g + torch.tensor(alpha, dtype=dt) * xi.to(dt)) / \
        torch.tensor(denom, dtype=dt)


def _plan_sums(plan, n, trail):
    """The plan's walk as the kernels take it: each key drawn once, added
    to the hi sum, the lo sum or both."""
    a = torch.zeros(n, dtype=torch.float32)
    b = torch.zeros(n, dtype=torch.float32)
    for key, sides in plan:
        z = noise.linear_normal(key, 0, n, trail, torch.device("cpu"))
        if sides & cn_mod.HI:
            a = a + z
        if sides & cn_mod.LO:
            b = b + z
    return a, b


# (restart_every, completion): no restarts (local t = step + 1), restarts
# with and without completion (t = E completes to next_pow2(E))
PLAN_TREES = [(0, False), (32, False), (32, True), (20, False), (20, True)]


def _tree_steps(E, completion):
    """-> [(step, t, hi keys, lo keys)]: every local t in 1..32 (two epochs
    where the tree restarts) of a depth-6 tree on one leaf."""
    tree = noise.TreeAggregationMechanism(seed=4, depth=6, restart_every=E,
                                          completion=completion)
    out = []
    for step in range(2 * E if E else 32):
        epoch, t, t_hi = tree._local_prefix(1.0, step)
        out.append((step, t, tree.node_keys("blocks/mlp/up/w", t_hi, epoch),
                    tree.node_keys("blocks/mlp/up/w", t - 1, epoch)))
    return out


@pytest.mark.parametrize("E,completion", PLAN_TREES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_key_plan_walk_is_bitwise_the_two_lists(E, completion, dtype):
    """At every local t in 1..32 of a tree (with and without restarts and
    completion) the plan's walk gives the hi and lo sums bitwise equal to
    each list summed apart, and ``counter_noise.plain`` (now by the plan)
    gives bitwise the output of the two-list chain it replaced, f32 and
    bf16 (tolerance: none, bitwise)."""
    shape = (3, 37)
    trail = noise.counter_split(shape)[1]
    g = torch.randn(shape, generator=torch.Generator().manual_seed(E)).to(
        dtype)
    shared = 0
    for step, t, hi, lo in _tree_steps(E, completion):
        plan = cn_mod.key_plan(hi, lo)
        a, b = _plan_sums(plan, g.numel(), trail)
        want_hi, want_lo, want = _lists_plain(g, hi, lo, 0.7, 4.0)
        assert torch.equal(a, want_hi) and torch.equal(b, want_lo), (step, t)
        assert torch.equal(cn_mod.plain(g, hi, lo, 0.7, 4.0), want), (step, t)
        assert [k for k, s in plan if s & cn_mod.HI] == hi
        assert [k for k, s in plan if s & cn_mod.LO] == lo
        shared += sum(s == cn_mod.HI | cn_mod.LO for _, s in plan)
    assert shared > 0          # some t share a node between hi and lo


def test_key_plan_merges_keeps_orders_and_raises_on_conflicts():
    """The plan holds each distinct key once, in an order that keeps both
    lists' own, with its sides; lists that hold their shared keys in
    conflicting orders, or a key twice, raise by name."""
    A, B, C, D = (0, 1), (0, 2), (0, 3), (0, 4)
    HI, LO = cn_mod.HI, cn_mod.LO
    assert cn_mod.key_plan([A], []) == [(A, HI)]
    assert cn_mod.key_plan([], [A]) == [(A, LO)]
    assert cn_mod.key_plan([A, C], [B, C]) == [(A, HI), (B, LO),
                                               (C, HI | LO)]
    assert cn_mod.key_plan([A, C, D], [C]) == [(A, HI), (C, HI | LO),
                                               (D, HI)]
    assert cn_mod.key_plan([A], [A]) == [(A, HI | LO)]
    # the tree at t = 3: nodes (0, 3), (1, 1) over t - 1 = 2: node (1, 1)
    tree = noise.TreeAggregationMechanism(seed=3, depth=10)
    hi, lo = tree.node_keys("w", 3), tree.node_keys("w", 2)
    assert cn_mod.key_plan(hi, lo) == [(hi[0], HI), (hi[1], HI | LO)]
    with pytest.raises(ValueError, match="key_plan.*conflicting orders"):
        cn_mod.key_plan([A, B], [B, A])
    with pytest.raises(ValueError, match="key_plan.*conflicting orders"):
        cn_mod.key_plan([A, B, C], [C, D, A])
    with pytest.raises(ValueError, match="key_plan.*twice"):
        cn_mod.key_plan([A, B, A], [])
    with pytest.raises(ValueError, match="key_plan.*twice"):
        cn_mod.key_plan([], [C, C])
    # a shared key drawn once: bitwise the two-list chain all the same
    g = torch.randn(5, 9, generator=torch.Generator().manual_seed(1))
    assert torch.equal(cn_mod.plain(g, [A, C], [B, C], 0.7, 4.0),
                       _lists_plain(g, [A, C], [B, C], 0.7, 4.0)[2])


@pytest.mark.parametrize("E,completion", PLAN_TREES)
def test_plan_draws_are_chip_smokes_draws(E, completion):
    """The draws a plan makes (one a distinct key) are what chip_smoke.py
    counts a noised row's bound by (``kernels.sass.draws(hi, lo)``): an
    FTRL step at t = 3 makes 2, where the two lists hold 3 keys."""
    from repro_torch.kernels.sass import draws
    for step, t, hi, lo in _tree_steps(E, completion):
        assert len(cn_mod.key_plan(hi, lo)) == draws(hi, lo), (step, t)
        if t == 3 and not completion:
            assert (len(hi) + len(lo), draws(hi, lo)) == (3, 2)


def test_window_of_a_tensor_past_2_32():
    """A contiguous window of a (8, 2^31) tensor: its draws are that block
    of counter_normal; a block that is not contiguous is a shard, which
    takes the block route (ROADMAP B7), not a window."""
    full = (8, 2 ** 31)
    assert cn_mod.window((1, 6), (2, 2 ** 31 - 6), full) == \
        (3 * 2 ** 31 - 6, 2 ** 31)
    g = torch.zeros(1, 6)
    got = cn_mod.counter_noise(g, [(7, 9)], [], 1.0, 1.0,
                               offsets=(2, 2 ** 31 - 6), full_shape=full)
    assert torch.equal(got, noise.counter_normal(
        (7, 9), (1, 6), offsets=(2, 2 ** 31 - 6), full_shape=full))
    with pytest.raises(ValueError, match="not a contiguous window"):
        cn_mod.window((2, 3), (0, 0), (4, 6))
    with pytest.raises(ValueError, match="outside"):
        cn_mod.window((1, 4), (0, 3), (4, 6))


class _FakeLib:
    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("dp_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(build, "check_inputs",
                        lambda name, floats, ints=(), f32=():
                        floats[0].dtype == torch.bfloat16)
    return lib


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wrapper_launches_with_its_arguments(fake_lib, dtype):
    """A leaf that is not on the CPU reaches ``dp_counter_noise`` once,
    with the key plan's count, the window, alpha and denom rounded to the
    leaf's dtype, and counts the launch; inplace writes over the leaf."""
    g = torch.empty(3, 1001, dtype=dtype, device="meta")
    n0 = cn_mod.counter_noise.launches
    out = cn_mod.counter_noise(g, [(1, 2), (3, 4)], [(5, 6)], 0.7, 8.0)
    assert out.shape == g.shape and out is not g
    assert cn_mod.counter_noise.launches == n0 + 1
    (name, args), = fake_lib.calls
    assert name == "dp_counter_noise"
    assert len(args) == len(build.SIGNATURES[name])
    n_keys, start, trail, n, alpha, denom, bf16 = args[4:11]
    assert (n_keys, start, trail, n, denom) == (3, 0, 3003, 3003, 8.0)
    assert alpha == float(torch.tensor(0.7, dtype=dtype))
    assert bf16 == int(dtype == torch.bfloat16)
    assert cn_mod.counter_noise(g, [(1, 2)], [], 0.7, 8.0,
                                inplace=True) is g


def test_wrapper_refuses_what_the_kernel_does_not_take(fake_lib):
    g = torch.empty(4, device="meta")
    with pytest.raises(ValueError, match="at most"):
        cn_mod.counter_noise(g, [(0, k) for k in range(65)], [], 1.0, 1.0)
    # 65 keys in all, 64 of them distinct: the plan fits
    keys = [(0, k) for k in range(64)]
    cn_mod.counter_noise(g, keys, keys[:1], 1.0, 1.0)
    (name, args), = fake_lib.calls
    assert args[4] == 64
    fake_lib.calls.clear()
    with pytest.raises(ValueError, match="conflicting orders"):
        cn_mod.counter_noise(g, keys[:2], keys[1::-1], 1.0, 1.0)
    assert fake_lib.calls == []


def test_wrapper_refuses_a_tensor_neither_cpu_nor_cuda():
    with pytest.raises(ValueError, match="CUDA device"):
        cn_mod.counter_noise(torch.empty(4, device="meta"), [(0, 1)], [],
                             1.0, 1.0)
    with pytest.raises(ValueError, match="CUDA device"):
        cn_mod.ndtri_f32(torch.empty(4, device="meta"))


def test_check_entries_run_the_plain_functions_on_the_cpu():
    rows = torch.tensor([[*k, *c] for k, c, _ in KATS], dtype=torch.int64)
    got = cn_mod.threefry_bits(rows)
    assert [tuple(r) for r in got.tolist()] == [w for _, _, w in KATS]
    u = torch.rand(100, generator=torch.Generator().manual_seed(1))
    assert torch.equal(cn_mod.ndtri_f32(u), noise.ndtri(u))


def test_mechanism_launches_one_kernel_a_leaf(fake_lib):
    """On a leaf that is not on the CPU the Gaussian mechanism and the
    tree launch the kernel once each, with the tree's level keys."""
    g = torch.empty(2, 3, device="meta")
    noise.GaussianMechanism().add_leaf("w", g, (0, 1), 1.0, 2.0, 4.0)
    tree = noise.TreeAggregationMechanism(seed=1, depth=8)
    tree.add_leaf("w", g, None, 1.0, 2.0, 4.0, step=5)   # t = 6, t - 1 = 5
    assert [n for n, _ in fake_lib.calls] == ["dp_counter_noise"] * 2
    # the Gaussian: one key; the tree at t = 6 (hi: nodes (1, 3), (2, 1))
    # over t - 1 = 5 (lo: nodes (0, 5), (2, 1)): 3 distinct keys
    assert fake_lib.calls[0][1][4] == 1
    assert fake_lib.calls[1][1][4] == 3
    words = fake_lib.calls[1][1][2]
    assert isinstance(words, int)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deferred_leaf_is_the_eager_leaf_on_the_cpu(dtype):
    """add_leaf(..., out="deferred") returns the leaf's noise undrawn (a
    NoisedLeaf: the sum, the keys, alpha, denom, the window); drawn by
    ``noise_update.gradient`` it is bitwise the eager leaf, for the
    Gaussian mechanism and the tree's increment."""
    from repro_torch.kernels import noise_update as nu
    g = torch.randn(3, 7, generator=torch.Generator().manual_seed(2)).to(
        dtype)
    gm = noise.GaussianMechanism()
    tree = noise.TreeAggregationMechanism(seed=1, depth=8, restart_every=4,
                                          completion=True)
    for mech, rng, step in ((gm, (0, 9), None), (tree, None, 3),
                            (tree, None, 5)):
        rec = mech.add_leaf("w", g, rng, 0.7, 1.3, 4.0, step=step,
                            out="deferred")
        assert isinstance(rec, noise.NoisedLeaf) and rec.g is g
        assert (rec.alpha, rec.denom, rec.start, rec.trail) == \
            (0.7 * 1.3, 4.0, 0, 21)
        eager = mech.add_leaf("w", g, rng, 0.7, 1.3, 4.0, step=step)
        assert torch.equal(nu.gradient(rec), eager)
    # sigma 0: the mechanism's own g / denom, a tensor
    assert torch.equal(gm.add_leaf("w", g, (0, 9), 0.0, 1.3, 4.0,
                                   out="deferred"), g / 4.0)


def test_deferred_leaf_launches_nothing(fake_lib):
    """On a leaf that is not on the CPU, out="deferred" draws nothing: the
    record carries the keys the eager launch would have passed."""
    g = torch.empty(2, 3, device="meta")
    tree = noise.TreeAggregationMechanism(seed=1, depth=8)
    rec = tree.add_leaf("w", g, None, 1.0, 2.0, 4.0, step=5, out="deferred")
    assert fake_lib.calls == []
    assert list(rec.hi_keys) == tree.node_keys("w", 6)
    assert list(rec.lo_keys) == tree.node_keys("w", 5)
    rec = noise.GaussianMechanism().add_leaf("w", g, (0, 1), 1.0, 2.0, 4.0,
                                             out="deferred")
    assert rec.hi_keys == (noise._path_rng((0, 1), "w"),) and \
        rec.lo_keys == ()
    assert fake_lib.calls == []



def test_add_leaf_refuses_an_unknown_out():
    """out is one of noise.OUTS: another word raises, for both mechanisms,
    rather than falling back to a new tensor."""
    g = torch.ones(2, 3)
    tree = noise.TreeAggregationMechanism(seed=1, depth=8)
    for mech, rng, step in ((noise.GaussianMechanism(), (0, 1), None),
                            (tree, None, 5)):
        with pytest.raises(ValueError, match="out must be one of"):
            mech.add_leaf("w", g, rng, 1.0, 2.0, 4.0, step=step,
                          out="over")


# -------------------------------------------------------------- golden file
TRIPLES = ((0, 0, "embed/w"), (0, 2, "blocks/mlp/up/w"), (5, 7, "head/w"))
# (full shape, indices): a qwen2-1.5b leaf, and a tensor past 2^32 elements
# (word 1 carries the row) with a window of 8 past 2^32
WINDOW = 2 ** 32 + 3
SHAPES = (((151936, 1536), (0, 1, 2 ** 24 - 1, 151936 * 1536 - 1)),
          ((8, 2 ** 31), (2 ** 24 - 1, 2 ** 31, 2 ** 32 - 1,
                          *range(WINDOW, WINDOW + 8))))


def golden() -> dict:
    """The golden values from the JAX package: per (seed, step, path) the
    base key ``PRNGKey(seed + 1)``, the step key, the leaf key, and at each
    index of each full shape the counter's bits and the normal (f32 bits as
    an int, and as a float)."""
    out = []
    for seed, step, path in TRIPLES:
        base = jax.random.PRNGKey(seed + 1)
        skey = jax.random.fold_in(base, step)
        key = jn._path_rng(skey, path)
        k0, k1 = _key(key)
        values = []
        for full, idxs in SHAPES:
            _, trail, _ = noise.counter_split(full)
            for i in idxs:
                off = np.unravel_index(i, full)
                bits = threefry2x32_p.bind(
                    *(jnp.asarray([v], jnp.uint32)
                      for v in (k0, k1, i % trail, i // trail)))[0]
                z = np.asarray(jn.counter_normal(
                    key, (1,) * len(full), jnp.float32,
                    offsets=[int(o) for o in off], full_shape=full))
                z = np.float32(z.reshape(-1)[0])
                values.append({"full_shape": list(full), "index": int(i),
                               "bits": int(np.asarray(bits)[0]),
                               "normal_bits": int(z.view(np.uint32)),
                               "normal": float(z)})
        out.append({"seed": seed, "step": step, "path": path,
                    "crc32": zlib.crc32(path.encode()) & 0x7FFFFFFF,
                    "base_key": list(_key(base)),
                    "step_key": list(_key(skey)), "key": [k0, k1],
                    "values": values})
    return {"source": "repro.core.noise (JAX), tests/test_torch_noise.py",
            "triples": out}


def test_golden_file_is_the_jax_packages_output():
    assert json.loads(GOLDEN.read_text()) == golden()


def test_golden_keys_and_bits_on_the_port():
    """The port's host keys and plain draws reproduce the golden file: keys
    and bits exactly, normals within 8 ulp (all finite there)."""
    for t in json.loads(GOLDEN.read_text())["triples"]:
        base = noise.prng_key(t["seed"] + 1)
        skey = noise.fold_in(base, t["step"])
        key = noise._path_rng(skey, t["path"])
        assert [list(base), list(skey), list(key)] == \
            [t["base_key"], t["step_key"], t["key"]]
        for v in t["values"]:
            off = np.unravel_index(v["index"], v["full_shape"])
            shape = (1,) * len(off)
            bits = noise.counter_bits(key, shape, off, v["full_shape"])
            assert int(bits.reshape(-1)[0]) == v["bits"]
            z = noise.counter_normal(key, shape, offsets=off,
                                     full_shape=v["full_shape"])
            assert np.isfinite(v["normal"])
            assert int(_ulp(z.numpy().reshape(-1),
                            np.float32([v["normal"]]))[0]) <= ULP


if __name__ == "__main__":
    if sys.argv[1:] == ["--write"]:
        GOLDEN.write_text(json.dumps(golden(), indent=1) + "\n")
        print(f"wrote {GOLDEN}")
