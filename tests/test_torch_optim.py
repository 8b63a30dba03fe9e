"""The port's optimizer step with phase 4 folded in (``repro_torch.optim.
optimizers`` over ``repro_torch.kernels.noise_update``) against the JAX
package's ``repro.optim.optimizers`` with ``repro.core.policy.
noise_leaf_fn``: the deferred path (each leaf's noise handed to
``update_leaves`` as a ``core.noise.NoisedLeaf``) for sgd and adamw, the
Gaussian and tree mechanisms, f32 and bf16 leaves, a frozen leaf and sigma
0, at the ROADMAP tolerances (f32 TOL, bf16 TOL). On the CPU the wrapper
runs its plain version, which must stay bitwise what the port computed
before the kernel (the eager noise, then the torch chain). The wrapper's C
arguments and refusals through a fake library."""
import ctypes

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import policy as jpol
from repro.optim import optimizers as jopt
from repro.utils.tree import flatten as jflatten
from repro_torch.core import noise
from repro_torch.core import policy as tpol
from repro_torch.kernels import build
from repro_torch.kernels import noise_update as nu
from repro_torch.optim import optimizers as topt
from repro_torch.utils.tree import flatten as tflatten

TOL = dict(rtol=1e-3, atol=1e-4)          # tests/test_kernel_parity.py:15
TOL_BF16 = dict(rtol=5e-2, atol=2e-2)     # :18
PATHS = ("x/w", "y/w", "y/b", "z/w")      # z: the frozen group
SHAPES = {"x/w": (6, 10), "y/w": (17, 6), "y/b": (6,), "z/w": (4, 5)}
LR = 3e-3


def _policy(pkg, sigma, **kw):
    return pkg.PrivacyPolicy(groups=(
        pkg.ParamGroup("f", "z", trainable=False),
        pkg.ParamGroup("a", "x", R=1.0, scope="group", sigma_scale=0.5),
        pkg.ParamGroup("b", ".*", R=2.0, scope="group")), sigma=sigma, **kw)


def _inputs(np_dt, seed=0):
    r = np.random.default_rng(seed)
    params = {p: (0.1 * r.standard_normal(s)).astype(np_dt)
              for p, s in SHAPES.items()}
    sums = [{p: r.standard_normal(s).astype(np_dt) for p, s in SHAPES.items()}
            for _ in range(3)]
    return params, sums


def _torch(flat, dtype):
    return {k: torch.from_numpy(np.asarray(v, np.float32)).to(dtype)
            for k, v in flat.items()}


def _make(pkg, name, wd):
    if pkg is jopt:
        return jopt.make_optimizer(name, lambda s: LR, weight_decay=wd)
    return topt.make_optimizer(name, lambda s: LR, weight_decay=wd)


def _run_jax(name, wd, sigma, np_dt, kw):
    params, sums = _inputs(np_dt)
    jp = _policy(jpol, sigma, **kw)
    res = jpol.resolve_policy(jp, list(SHAPES))
    opt = _make(jopt, name, wd)
    p = {k: jnp.asarray(v) for k, v in params.items()}
    state = opt.init(p)
    base = jax.random.PRNGKey(1)
    for step, s in enumerate(sums):
        leaf = jpol.noise_leaf_fn(jp, res, jax.random.fold_in(base, step),
                                  4.0, step=step)
        js = {k: jnp.asarray(v) for k, v in s.items()}
        p, state = opt.update_leaves(lambda path, _p: leaf(path, js[path]),
                                     state, p, jnp.asarray(step))
    return jflatten(p), {k: jflatten(v) for k, v in state.items()}


def _run_torch(name, wd, sigma, dtype, np_dt, kw):
    params, sums = _inputs(np_dt)
    tp = _policy(tpol, sigma, **kw)
    res = tpol.resolve_policy(tp, list(SHAPES))
    opt = _make(topt, name, wd)
    p = _torch(params, dtype)
    state = opt.init(p)
    base = noise.prng_key(1)
    for step, s in enumerate(sums):
        leaf = tpol.noise_leaf_fn(tp, res, noise.fold_in(base, step), 4.0,
                                  step=step, out="deferred")
        ts = _torch(s, dtype)
        p, state = opt.update_leaves(lambda path, _p: leaf(path, ts[path]),
                                     state, p, step)
    return p, {k: tflatten(v) for k, v in state.items()}


MECHANISMS = {"gaussian": {},
              "tree": dict(noise="tree", noise_seed=5, noise_depth=6,
                           noise_restart_every=2, noise_completion=True)}


@pytest.mark.parametrize("mech", sorted(MECHANISMS))
@pytest.mark.parametrize("name,wd", [("sgd", 0.0), ("sgd", 0.05),
                                     ("adamw", 0.0), ("adamw", 0.05)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigma", [0.7, 0.0])
def test_deferred_update_matches_jax(mech, name, wd, dtype, sigma):
    """Three steps (the tree: an epoch of 2 with completion, then the next
    epoch's first): params and every moment against the reference's."""
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    want_p, want_s = _run_jax(name, wd, sigma, np_dt, MECHANISMS[mech])
    got_p, got_s = _run_torch(name, wd, sigma, getattr(torch, dtype), np_dt,
                              MECHANISMS[mech])
    tol = TOL if dtype == "float32" else TOL_BF16
    for k in SHAPES:
        assert got_p[k].dtype == getattr(torch, dtype)
        np.testing.assert_allclose(got_p[k].float().numpy(),
                                   np.asarray(want_p[k], np.float32),
                                   err_msg=k, **tol)
        for s in want_s:
            np.testing.assert_allclose(
                got_s[s][k].numpy(), np.asarray(want_s[s][k], np.float32),
                err_msg=f"{s} {k}", **tol)


def _chain_before(name, wd, b1=0.9, b2=0.999, eps=1e-8, momentum=0.9):
    """The port's update before the kernel: the per-leaf torch chain, the
    noise already added (verbatim the former optim/optimizers.py)."""
    f32 = torch.float32

    def apply(p, upd):
        p32 = p.to(f32)
        if wd:
            upd.add_(p32, alpha=wd)
        p.copy_(p32.sub_(upd, alpha=LR))

    def update_leaves(grad_for, state, params, step):
        if name == "sgd":
            for path, p in params.items():
                m = state["m"][path]
                m.mul_(momentum).add_(grad_for(path, p).to(f32))
                apply(p, m.clone())
            return params, state
        t = step + 1
        bc1, bc2 = 1.0 - b1 ** t, 1.0 - b2 ** t
        for path, p in params.items():
            g = grad_for(path, p).to(f32)
            m, v = state["m"][path], state["v"][path]
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            del g
            upd = (m / bc1).div_((v / bc2).sqrt_().add_(eps))
            apply(p, upd)
        return params, state

    return update_leaves


@pytest.mark.parametrize("mech", sorted(MECHANISMS))
@pytest.mark.parametrize("name", ["sgd", "adamw"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_deferred_path_is_bitwise_the_eager_path_on_the_cpu(mech, name,
                                                            dtype):
    """NoisedLeaf into update_leaves computes, bit for bit, what the port
    computed before the kernel: counter_noise's eager leaves into the
    former torch chain."""
    np_dt = np.float32 if dtype == torch.float32 else ml_dtypes.bfloat16
    got_p, got_s = _run_torch(name, 0.05, 0.7, dtype, np_dt,
                              MECHANISMS[mech])
    params, sums = _inputs(np_dt)
    tp = _policy(tpol, 0.7, **MECHANISMS[mech])
    res = tpol.resolve_policy(tp, list(SHAPES))
    p = _torch(params, dtype)
    state = {k: {q: torch.zeros_like(v, dtype=torch.float32)
                 for q, v in p.items()}
             for k in (("m",) if name == "sgd" else ("m", "v"))}
    update = _chain_before(name, 0.05)
    for step, s in enumerate(sums):
        leaf = tpol.noise_leaf_fn(tp, res, noise.fold_in(noise.prng_key(1),
                                                         step), 4.0,
                                  step=step)
        ts = _torch(s, dtype)
        update(lambda path, _p: leaf(path, ts[path]), state, p, step)
    for k in SHAPES:
        assert torch.equal(got_p[k], p[k]), k
        for s in state:
            assert torch.equal(got_s[s][k], state[s][k]), f"{s} {k}"


def test_deferred_records_and_what_passes_through():
    """out="deferred": a noised leaf is a NoisedLeaf over the sum itself (no
    draw yet); a frozen leaf and sigma 0 are tensors, as the eager path
    gives them."""
    tp = _policy(tpol, 0.7)
    res = tpol.resolve_policy(tp, list(SHAPES))
    g = torch.ones(6, 10)
    leaf = tpol.noise_leaf_fn(tp, res, (0, 3), 4.0, step=0, out="deferred")
    rec = leaf("x/w", g)
    assert isinstance(rec, noise.NoisedLeaf)
    assert rec.g is g and (rec.start, rec.trail) == (0, 60)
    assert rec.denom == 4.0 and len(rec.hi_keys) == 1 and not rec.lo_keys
    eager = tpol.noise_leaf_fn(tp, res, (0, 3), 4.0, step=0)("x/w", g)
    assert torch.equal(nu.gradient(rec), eager)
    frozen = torch.zeros(4, 5)
    assert leaf("z/w", frozen) is frozen
    zero = tpol.noise_leaf_fn(_policy(tpol, 0.0), res, (0, 3), 4.0, step=0,
                              out="deferred")("x/w", g)
    assert isinstance(zero, torch.Tensor) and torch.equal(zero, g / 4.0)


def test_update_delegates_to_update_leaves():
    """The materialized-tree contract (the baselines') runs the same body:
    one noise_update call a leaf, the tensor taken as given."""
    params, sums = _inputs(np.float32)
    opt = _make(topt, "adamw", 0.05)
    a, b = _torch(params, torch.float32), _torch(params, torch.float32)
    sa, sb = opt.init(a), opt.init(b)
    g = _torch(sums[0], torch.float32)
    opt.update(g, sa, a, 0)
    opt.update_leaves(lambda path, _p: g[path], sb, b, 0)
    for k in SHAPES:
        assert torch.equal(a[k], b[k])


# ------------------------------------------------------- the C call (fake)
class _FakeLib:
    def __init__(self):
        self.calls = []

    def dp_noise_update(self, *args):
        hyper = list((ctypes.c_float * 11).from_address(args[14]))
        n = args[5] + args[6]
        keys = list((ctypes.c_uint32 * max(1, 2 * n)).from_address(args[4]))
        self.calls.append((args, hyper, keys[:2 * n]))
        return 0


@pytest.fixture
def fake_lib(monkeypatch):
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)

    def dtypes_only(name, floats, ints=(), f32=()):
        # the device and layout checks need a card; keep the dtype rules
        dt = floats[0].dtype
        if dt not in (torch.float32, torch.bfloat16):
            raise ValueError(f"{name}: records must be one of "
                             f"float32/bfloat16, got {dt}")
        if any(t.dtype is not torch.float32 for t in f32):
            raise ValueError(f"{name}: clip factors and masks must be "
                             "float32")
        return dt is torch.bfloat16

    monkeypatch.setattr(build, "check_inputs", dtypes_only)
    return lib


def _meta(shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("g_dt,p_dt", [(torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.float32),
                                       (torch.bfloat16, torch.float32)])
def test_wrapper_launches_with_its_arguments(fake_lib, g_dt, p_dt):
    """A parameter that is not on the CPU reaches ``dp_noise_update`` once:
    the record's keys, window, alpha and denom (rounded to the sum's
    dtype), the dtypes, the optimizer and its scalars; the launch is
    counted."""
    shape = (3, 1001)
    rec = noise.NoisedLeaf(_meta(shape, g_dt), ((1, 2), (3, 4)), ((5, 6),),
                           0.7, 8.0, 11, 3003)
    p, m, v = _meta(shape, p_dt), _meta(shape), _meta(shape)
    n0 = nu.noise_update.launches
    hp = nu.AdamW(1e-3, 0.9, 0.99, 1e-8, 0.19, 0.0199, 0.1)
    nu.noise_update(rec, p, m, v, hp)
    assert nu.noise_update.launches == n0 + 1
    (args, hyper, keys), = fake_lib.calls
    assert len(args) == len(build.SIGNATURES["dp_noise_update"])
    (n_hi, n_lo, noisy, start, trail, n, g_bf16, p_bf16,
     adamw) = args[5:14]
    assert (n_hi, n_lo, noisy, start, trail, n) == (2, 1, 1, 11, 3003, 3003)
    assert (g_bf16, p_bf16, adamw) == (int(g_dt == torch.bfloat16),
                                       int(p_dt == torch.bfloat16), 1)
    assert keys == [1, 2, 3, 4, 5, 6]
    want = [float(torch.tensor(0.7, dtype=g_dt)), 8.0, 1e-3, 0.9, 0.1,
            0.99, 1 - 0.99, 1e-8, 0.19, 0.0199, 0.1]
    np.testing.assert_allclose(hyper, np.float32(want), rtol=1e-7)


def test_wrapper_without_noise_and_sgd(fake_lib):
    """A tensor is taken as given (the noise flag off, no keys); SGD passes
    its momentum as b1 and no v."""
    p, m = _meta((5,), torch.bfloat16), _meta((5,))
    nu.noise_update(_meta((5,), torch.bfloat16), p, m, None,
                    nu.SGD(0.1, 0.8, 0.01))
    (args, hyper, keys), = fake_lib.calls
    assert args[3] in (0, None) and args[5:8] == (0, 0, 0)
    assert args[13] == 0 and keys == []
    np.testing.assert_allclose(hyper[2:4], np.float32([0.1, 0.8]))
    assert hyper[10] == np.float32(0.01)


def test_wrapper_refuses_what_the_kernel_does_not_take(fake_lib):
    shape = (4,)
    p, m, v = _meta(shape), _meta(shape), _meta(shape)
    hp = nu.AdamW(1e-3, 0.9, 0.99, 1e-8, 0.1, 0.01)
    too_many = noise.NoisedLeaf(_meta(shape), tuple((0, k) for k in
                                                    range(65)), (), 1.0, 1.0,
                                0, 4)
    with pytest.raises(ValueError, match="at most"):
        nu.noise_update(too_many, p, m, v, hp)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        nu.noise_update(_meta(shape, torch.float16), p, m, v, hp)
    with pytest.raises(ValueError, match="float32"):
        nu.noise_update(_meta(shape), p, m, _meta(shape, torch.bfloat16), hp)
    with pytest.raises(ValueError, match="match in size"):
        nu.noise_update(_meta((5,)), p, m, v, hp)
    assert fake_lib.calls == []


def test_wrapper_refuses_a_tensor_neither_cpu_nor_cuda():
    shape = (4,)
    with pytest.raises(ValueError, match="CUDA device"):
        nu.noise_update(_meta(shape), _meta(shape), _meta(shape),
                        _meta(shape), nu.AdamW(1e-3, 0.9, 0.99, 1e-8, 0.1,
                                               0.01))


def test_train_step_launches_one_update_a_leaf(fake_lib):
    """On a parameter that is not on the CPU, update_leaves launches the
    kernel once a leaf, deferred noise or not, and counter_noise never."""
    from repro_torch.kernels import counter_noise as cn
    tp = _policy(tpol, 0.7)
    res = tpol.resolve_policy(tp, list(SHAPES))
    params = {k: _meta(s) for k, s in SHAPES.items()}
    opt = _make(topt, "adamw", 0.0)
    state = {"m": {k: _meta(s) for k, s in SHAPES.items()},
             "v": {k: _meta(s) for k, s in SHAPES.items()}}
    leaf = tpol.noise_leaf_fn(tp, res, (0, 1), 4.0, step=0, out="deferred")
    n0 = cn.counter_noise.launches
    opt.update_leaves(lambda path, p: leaf(path, _meta(p.shape)), state,
                      params, 0)
    assert cn.counter_noise.launches == n0
    assert [a[7] for a, _, _ in fake_lib.calls] == [
        int(k not in res.frozen) for k in SHAPES]


def _chip_smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name", ["sgd", "adamw"])
def test_bf16_p_gate_holds_the_step_itself(name):
    """chip_smoke.py holds a bf16 p to the plain version's f32 p (the chain
    run on p widened: bitwise the bf16 run's p before its rounding) within
    half a bf16 ulp plus f32 TOL. The plain version passes it; a step that
    keeps p, drops lr or flips the update's sign fails it."""
    cs = _chip_smoke()
    rng = np.random.default_rng(11)
    shape = (64, 257)
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(
        torch.bfloat16)
    rec = noise.NoisedLeaf(g, ((3, 9),), (), 0.7, 4.0, 0, shape[1])
    m0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        * 1e-2
    v0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32)) \
        ** 2 * 1e-4
    p0 = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
          * 0.02).to(torch.bfloat16)

    def step(hp, p):
        nu.plain(rec, p, m0.clone(), v0.clone() if name == "adamw" else
                 None, hp)
        return p

    def hyper(lr):
        if name == "sgd":
            return nu.SGD(lr, 0.9, 0.01)
        return nu.AdamW(lr, 0.9, 0.999, 1e-8, 0.1, 1e-3, 0.01)

    want32 = step(hyper(3e-4), p0.float())
    got = step(hyper(3e-4), p0.clone())
    assert torch.equal(got, want32.to(torch.bfloat16))
    tol = cs.TOL["float32"]
    assert cs.p_rounding_excess(got, want32, tol) <= 0
    # a step whose f32 arithmetic rounds elsewhere (a few f32 ulps off),
    # then rounded to bf16: up to one bf16 ulp from ``got``, and held
    for rel in (3e-7, -3e-7):
        near = (want32 * (1 + rel)).to(torch.bfloat16)
        assert cs.p_rounding_excess(near, want32, tol) <= 0
    for wrong in (p0, step(hyper(3e-4 * 0.5), p0.clone()),
                  step(hyper(1.0), p0.clone()),
                  step(hyper(-3e-4), p0.clone())):
        assert cs.p_rounding_excess(wrong, want32, tol) > 0


# ------------------------------------------------- ftrl, lamb, adafactor
def _run_steps(pkg, name, opt_kw, sigma, np_dt, mech, steps, dtype=None):
    """``steps`` deferred steps of ``name`` under the test policy with
    ``mech``'s noise knobs, through one package -> (flat params, state)."""
    r = np.random.default_rng(3)
    params = {p: (0.1 * r.standard_normal(s)).astype(np_dt)
              for p, s in SHAPES.items()}
    sums = [{p: r.standard_normal(s).astype(np_dt) for p, s in SHAPES.items()}
            for _ in range(steps)]
    pol = _policy(jpol if pkg is jopt else tpol, sigma, **mech)
    if pkg is jopt:
        res = jpol.resolve_policy(pol, list(SHAPES))
        opt = jopt.make_optimizer(name, lambda s: LR, **opt_kw)
        p = {k: jnp.asarray(v) for k, v in params.items()}
        state = opt.init(p)
        for step, s in enumerate(sums):
            leaf = jpol.noise_leaf_fn(pol, res, jax.random.fold_in(
                jax.random.PRNGKey(1), step), 4.0, step=step)
            js = {k: jnp.asarray(v) for k, v in s.items()}
            p, state = opt.update_leaves(
                lambda path, _p: leaf(path, js[path]), state, p,
                jnp.asarray(step))
        return jflatten(p), jflatten(state)
    res = tpol.resolve_policy(pol, list(SHAPES))
    opt = topt.make_optimizer(name, lambda s: LR, **opt_kw)
    p = _torch(params, dtype)
    state = opt.init(p)
    for step, s in enumerate(sums):
        leaf = tpol.noise_leaf_fn(pol, res, noise.fold_in(noise.prng_key(1),
                                                          step), 4.0,
                                  step=step, out="deferred")
        ts = _torch(s, dtype)
        p, state = opt.update_leaves(lambda path, _p: leaf(path, ts[path]),
                                     state, p, step)
    return tflatten(p), tflatten(state)


def _assert_close(got, want, dtype):
    tol = TOL if dtype == "float32" else TOL_BF16
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   err_msg=k, **tol)


def _tree(restart):
    return dict(noise="tree", noise_seed=5, noise_depth=6,
                noise_restart_every=restart, noise_completion=restart > 0)


@pytest.mark.parametrize("momentum", [0.0, 0.9])
@pytest.mark.parametrize("restart", [0, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigma", [0.7, 0.0])
def test_ftrl_matches_jax(momentum, restart, dtype, sigma):
    """Five DP-FTRL steps over tree-noised deferred leaves (restarts every
    2 with completion: steps 1 and 3 complete a tree, steps 2 and 4
    restart it and the anchor), params, sum, m and theta0 against
    repro.optim.ftrl's."""
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    kw = dict(momentum=momentum, restart_every=restart)
    want_p, want_s = _run_steps(jopt, "ftrl", kw, sigma, np_dt,
                                _tree(restart), 5)
    got_p, got_s = _run_steps(topt, "ftrl", kw, sigma, np_dt, _tree(restart),
                              5, getattr(torch, dtype))
    assert all(v.dtype == getattr(torch, dtype) for v in got_p.values())
    _assert_close(got_p, want_p, dtype)
    _assert_close(got_s, want_s, dtype)


@pytest.mark.parametrize("name", ["lamb", "adafactor"])
@pytest.mark.parametrize("mech", sorted(MECHANISMS))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sigma", [0.7, 0.0])
def test_lamb_adafactor_match_jax(name, mech, dtype, sigma):
    """Three steps (the noise drawn by counter_noise's route, then the torch
    chain), params and state (adafactor's ``<param>/vr|vc`` and ``/v``
    keys) against the reference's."""
    np_dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    want_p, want_s = _run_steps(jopt, name, {}, sigma, np_dt,
                                MECHANISMS[mech], 3)
    got_p, got_s = _run_steps(topt, name, {}, sigma, np_dt,
                              MECHANISMS[mech], 3, getattr(torch, dtype))
    _assert_close(got_p, want_p, dtype)
    _assert_close(got_s, want_s, dtype)
    if name == "adafactor":
        assert {k.rsplit("/", 1)[1] for k in got_s} == {"vr", "vc", "v"}


def test_adafactor_state_layout_across_convert():
    """A stacked (L, d, p) weight keeps vr (L, d) and vc (L, p); the
    reference's state converts to the port's key for key, shape for
    shape."""
    from repro_torch.convert import params_from_jax
    shapes = {"blocks/w": (3, 5, 7), "head/w": (5, 7), "norm/g": (5,)}
    jp = {k: jnp.zeros(s) for k, s in shapes.items()}
    want = jflatten(jopt.make_optimizer("adafactor", lambda s: LR).init(
        {"blocks": {"w": jp["blocks/w"]}, "head": {"w": jp["head/w"]},
         "norm": {"g": jp["norm/g"]}}))
    got = tflatten(topt.make_optimizer("adafactor", lambda s: LR).init(
        {"blocks": {"w": torch.zeros(3, 5, 7)},
         "head": {"w": torch.zeros(5, 7)}, "norm": {"g": torch.zeros(5)}}))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert tuple(got["s/blocks/w/vr"].shape) == (3, 5)
    assert tuple(got["s/blocks/w/vc"].shape) == (3, 7)
    back = tflatten(params_from_jax({k: np.asarray(v)
                                     for k, v in want.items()}, "cpu"))
    assert sorted(back) == sorted(got)


def test_make_optimizer_names_and_refusals():
    for name in ("sgd", "adamw", "lamb", "adafactor", "ftrl"):
        assert topt.make_optimizer(name, lambda s: LR).update_leaves
    with pytest.raises(ValueError, match="unknown optimizer"):
        topt.make_optimizer("adagrad", lambda s: LR)
    from repro_torch.optim.ftrl import epoch_of, ftrl
    with pytest.raises(ValueError, match="weight decay"):
        topt.make_optimizer("ftrl", lambda s: LR, weight_decay=0.1)
    with pytest.raises(ValueError, match="restart_every"):
        ftrl(lambda s: LR, restart_every=-1)
    assert [epoch_of(s, 3) for s in (0, 2, 3, 7)] == [0, 0, 1, 2]
    assert epoch_of(7, 0) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ftrl_anchor_is_a_copy_and_restart_rebases(dtype):
    """theta0 never aliases p (the step writes p in place); a restart step
    takes p as the new anchor and restarts s and m from the gradient."""
    p = {"w": torch.full((3, 4), 0.5, dtype=dtype)}
    opt = topt.make_optimizer("ftrl", lambda s: LR, momentum=0.9,
                              restart_every=2)
    state = opt.init(p)
    assert state["theta0"]["w"].data_ptr() != p["w"].data_ptr()
    g = {"w": torch.ones(3, 4, dtype=dtype)}
    for step in range(2):
        opt.update(g, state, p, step)
    assert torch.equal(state["theta0"]["w"],
                       torch.full((3, 4), 0.5))           # not moved
    before = p["w"].float().clone()
    opt.update(g, state, p, 2)                            # restart
    assert torch.equal(state["theta0"]["w"], before)
    assert torch.equal(state["sum"]["w"], torch.ones(3, 4))
    assert torch.equal(state["m"]["w"], torch.ones(3, 4))


def test_ftrl_plain_chain_rounds_as_written():
    """The plain FTRL branch: s, m and theta0 exactly the chain's products
    then sums (no contraction), restart or not."""
    r = np.random.default_rng(2)
    mk = (lambda: torch.from_numpy(r.standard_normal(4099).astype(
        np.float32)))
    g, p0, s0, m0, t00 = mk(), mk(), mk(), mk(), mk()
    for restart in (False, True):
        p, s, m, t0 = p0.clone(), s0.clone(), m0.clone(), t00.clone()
        nu.plain(g, p, s, m, nu.FTRL(3e-3, 0.9, restart), t0=t0)
        keep = np.float32(0.0 if restart else 1.0)
        ws = (keep * s0.numpy()) + g.numpy()
        wm = np.float32(0.9 * float(keep)) * m0.numpy() + ws
        wt = p0.numpy() if restart else t00.numpy()
        assert np.array_equal(s.numpy(), ws)
        assert np.array_equal(m.numpy(), wm)
        assert np.array_equal(t0.numpy(), wt)
        np.testing.assert_allclose(p.numpy(), wt - np.float32(3e-3) * wm,
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("g_dt,p_dt", [(torch.bfloat16, torch.bfloat16),
                                       (torch.float32, torch.float32)])
@pytest.mark.parametrize("restart", [False, True])
def test_ftrl_wrapper_launches_with_its_arguments(fake_lib, g_dt, p_dt,
                                                  restart):
    """An FTRL step reaches ``dp_noise_update`` once with opt code 2, the
    record's keys and window, momentum x keep and keep (0 on a restart
    step) in the hyper-parameters, and the anchor as the third state."""
    shape = (3, 1001)
    rec = noise.NoisedLeaf(_meta(shape, g_dt), ((1, 2), (3, 4)), ((5, 6),),
                           0.7, 8.0, 0, 1001)
    p, s, m, t0 = _meta(shape, p_dt), _meta(shape), _meta(shape), \
        _meta(shape)
    n0 = nu.noise_update.launches
    nu.noise_update(rec, p, s, m, nu.FTRL(1e-3, 0.9, restart), t0=t0)
    assert nu.noise_update.launches == n0 + 1
    (args, hyper, keys), = fake_lib.calls
    assert len(args) == len(build.SIGNATURES["dp_noise_update"]) == 17
    assert args[5:14] == (2, 1, 1, 0, 1001, 3003,
                          int(g_dt == torch.bfloat16),
                          int(p_dt == torch.bfloat16), 2)
    assert keys == [1, 2, 3, 4, 5, 6]
    keep = 0.0 if restart else 1.0
    want = [float(torch.tensor(0.7, dtype=g_dt)), 8.0, 1e-3, 0.9 * keep,
            keep, 0.0, 0.0, 0.0, 1.0, 1.0, 0.0]
    np.testing.assert_allclose(hyper, np.float32(want), rtol=1e-7)
    with pytest.raises(ValueError, match="anchor"):
        nu.noise_update(rec, p, s, m, nu.FTRL(1e-3, 0.9))
    with pytest.raises(ValueError, match="match in size"):
        nu.noise_update(rec, p, s, m, nu.FTRL(1e-3, 0.9), t0=_meta((4,)))
    with pytest.raises(ValueError, match="float32"):
        nu.noise_update(rec, p, s, m, nu.FTRL(1e-3, 0.9),
                        t0=_meta(shape, torch.bfloat16))
    assert len(fake_lib.calls) == 1


def test_bf16_p_gate_holds_the_ftrl_step():
    """chip_smoke.py's bf16 p rule on the FTRL step: the plain version
    passes it; a step that keeps p, drops lr or flips its sign fails."""
    cs = _chip_smoke()
    rng = np.random.default_rng(12)
    shape = (64, 257)
    f = (lambda scale: torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)) * scale)
    g = f(1.0).to(torch.bfloat16)
    rec = noise.NoisedLeaf(g, ((3, 9),), (), 0.7, 4.0, 0, shape[1])
    s0, m0, t00 = f(1.0), f(1.0), f(0.02)
    p0 = f(0.02).to(torch.bfloat16)

    def step(lr, p):
        nu.plain(rec, p, s0.clone(), m0.clone(), nu.FTRL(lr, 0.9),
                 t0=t00.clone())
        return p

    want32 = step(3e-4, p0.float())
    got = step(3e-4, p0.clone())
    assert torch.equal(got, want32.to(torch.bfloat16))
    tol = cs.TOL["float32"]
    assert cs.p_rounding_excess(got, want32, tol) <= 0
    for wrong in (p0, step(3e-4 * 0.5, p0.clone()), step(-3e-4, p0.clone())):
        assert cs.p_rounding_excess(wrong, want32, tol) > 0


@pytest.mark.parametrize("name", ["ftrl", "lamb", "adafactor"])
def test_optimizer_parity_gate_catches_a_wrong_step(name):
    """chip_smoke.py's card-to-CPU comparison of ftrl, lamb and adafactor
    (``optimizer_gap`` over ``_optimizer_run``'s noised steps): a second
    run of the same steps passes it; a run at half the lr or with the
    step's sign flipped fails it on every param the step moves."""
    from repro_torch.utils.tree import unflatten
    cs = _chip_smoke()
    params, sums = _inputs(np.float32, seed=4)
    params = unflatten(_torch(params, torch.float32))
    sums = _torch(sums[0], torch.float32)
    policy = _policy(tpol, 0.7)
    p0 = tflatten(params)

    def run(lr):
        p, s, _ = cs._optimizer_run(name, params, sums, policy, 4.0, "cpu",
                                    lr=lr)
        return p, s

    want = run(3e-4)
    same = cs.optimizer_gap(*run(3e-4), *want, p0)
    assert same["failed"] == [] and same["step_err"] == 0.0
    moved = {"step:" + k for k in p0
             if not torch.equal(want[0][k], p0[k])}
    assert moved
    for lr in (1.5e-4, -3e-4):
        gap = cs.optimizer_gap(*run(lr), *want, p0)
        assert moved <= set(gap["failed"]), (lr, gap)
