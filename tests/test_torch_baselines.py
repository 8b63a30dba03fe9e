"""The port's eight DP modes on the MLP against the JAX package: the
counterpart of every case of ``tests/test_bk_equivalence.py``. Every mode of
the port (``repro_torch.core.engine.make_grad_fn``) is held to the JAX
``opacus`` mode on the same params and batch (made with numpy, params
crossing through ``repro_torch.convert``), at that file's tolerances: norms
rtol 1e-5 / atol 1e-6, grads rtol 1e-4 / atol 1e-6. The JAX side runs
``use_kernels=False`` (its einsum path)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bk import DPConfig as JDPConfig
from repro.core.engine import make_grad_fn as jmake_grad_fn
from repro.core.tape import Tape as JTape
from repro.models.mlp import MLP as JMLP
from repro.models.mlp import MLPConfig as JMLPConfig
from repro.utils.tree import flatten as jflatten
from repro_torch.convert import params_from_jax
from repro_torch.core.bk import DPConfig
from repro_torch.core.engine import ALL_MODES, make_grad_fn
from repro_torch.core.noise import prng_key
from repro_torch.core.tape import Tape
from repro_torch.models.mlp import MLP, MLPConfig
from repro_torch.utils.tree import flatten

B = 8
NORM_TOL = dict(rtol=1e-5, atol=1e-6)     # tests/test_bk_equivalence.py:40
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)     # :42
NOISE_TOL = dict(rtol=1e-4, atol=1e-5)    # :53
DP_MODES = [m for m in ALL_MODES if m != "nonprivate"]
SIGMA, RNG = 0.7, 7


@functools.lru_cache(maxsize=None)
def _setup(bias=True):
    """-> (JAX model, JAX params, JAX batch, port model, port params, port
    batch): MLP(12 -> 16 x 3 -> 5) as test_bk_equivalence builds it, the
    batch from numpy."""
    kw = dict(d_in=12, width=16, depth=3, n_classes=5, bias=bias)
    jm, tm = JMLP(JMLPConfig(**kw)), MLP(MLPConfig(**kw))
    jp = jm.init(jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, 12)).astype(np.float32)
    y = rng.integers(0, 5, B).astype(np.int32)
    tp = params_from_jax({k: np.asarray(v) for k, v in jflatten(jp).items()},
                         "cpu")
    return (jm, jp, {"x": jnp.asarray(x), "y": jnp.asarray(y)}, tm, tp,
            {"x": torch.from_numpy(x), "y": torch.from_numpy(y)})


@functools.lru_cache(maxsize=None)
def _jax(mode, clipping="automatic", sigma=0.0, bias=True):
    jm, jp, jb, *_ = _setup(bias)
    cfg = JDPConfig(mode=mode, clipping=clipping, R=1.0, sigma=sigma,
                    use_kernels=False)
    g, aux = jax.jit(jmake_grad_fn(jm.apply, cfg))(jp, jb,
                                                   jax.random.PRNGKey(RNG))
    return ({k: np.asarray(v) for k, v in jflatten(g).items()},
            {k: np.asarray(v) for k, v in aux.items()
             if k in ("per_sample_norms", "clip_factors", "loss")})


def _port(mode, clipping="automatic", sigma=0.0, bias=True, rng=RNG):
    """The port's mode under the key ``prng_key(rng)``."""
    *_, tm, tp, tb = _setup(bias)
    cfg = DPConfig(mode=mode, clipping=clipping, R=1.0, sigma=sigma)
    g, aux = make_grad_fn(tm.apply, cfg)(tp, tb, prng_key(rng))
    return flatten(g), aux


def _assert_grads(got, want, tol):
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **tol)


@pytest.mark.parametrize("mode", DP_MODES)
@pytest.mark.parametrize("clipping", ["automatic", "abadi", "flat"])
def test_all_modes_agree_with_jax_opacus(mode, clipping):
    want, waux = _jax("opacus", clipping)
    got, aux = _port(mode, clipping)
    np.testing.assert_allclose(aux["per_sample_norms"].numpy(),
                               waux["per_sample_norms"], **NORM_TOL)
    _assert_grads(got, want, GRAD_TOL)


@pytest.mark.parametrize("mode", DP_MODES)
def test_noise_identical_across_modes(mode):
    """The same key gives every mode the same noise, the reference's: each
    port mode at sigma 0.7 against JAX opacus under that key."""
    want, _ = _jax("opacus", sigma=SIGMA)
    got, _ = _port(mode, sigma=SIGMA)
    _assert_grads(got, want, NOISE_TOL)


@pytest.mark.parametrize("mode", DP_MODES)
def test_port_noise_is_the_same_in_every_mode(mode):
    """The port's own noise for a key is the same in every mode
    (``finalize_noise`` is ``noise_leaf_fn`` leaf for leaf)."""
    want, _ = _port("opacus", sigma=SIGMA)
    got, _ = _port(mode, sigma=SIGMA)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   err_msg=k, **NOISE_TOL)


def test_grads_tree_matches_params_tree():
    *_, tm, tp, tb = _setup()
    for mode in ALL_MODES:
        grads, _ = make_grad_fn(tm.apply, DPConfig(mode=mode))(
            tp, tb, prng_key(0))
        assert grads.keys() == tp.keys(), mode
        for p, g in flatten(grads).items():
            assert g.shape == flatten(tp)[p].shape, (mode, p)
            assert g.dtype == flatten(tp)[p].dtype, (mode, p)


@pytest.mark.parametrize("mode", DP_MODES)
def test_clip_factors_bound_sensitivity(mode):
    _, aux = _port(mode, clipping="abadi")
    clipped = aux["per_sample_norms"] * aux["clip_factors"]
    assert bool(torch.all(clipped <= 1.0 + 1e-5))


def test_nonprivate_matches_plain_grad():
    """nonprivate: the JAX gradient of the mean loss, and the JAX
    package's own nonprivate mode."""
    jm, jp, jb, *_ = _setup()
    ref = jax.grad(lambda p: jnp.mean(jm.apply(p, jb, JTape(None))))(jp)
    got, aux = _port("nonprivate")
    _assert_grads(got, {k: np.asarray(v) for k, v in jflatten(ref).items()},
                  dict(rtol=1e-5, atol=1e-7))
    want, waux = _jax("nonprivate")
    _assert_grads(got, want, dict(rtol=1e-5, atol=1e-7))
    np.testing.assert_allclose(float(aux["loss"]), float(waux["loss"]),
                               rtol=1e-6)


@pytest.mark.parametrize("mode", DP_MODES)
def test_no_bias_model(mode):
    want, _ = _jax("opacus", bias=False)
    got, _ = _port(mode, bias=False)
    _assert_grads(got, want, GRAD_TOL)


def test_mlp_forward_matches_jax():
    """The MLP's per-sample losses, and its seeded init's keys, shapes and
    dtypes, against the JAX package's."""
    jm, jp, jb, tm, tp, tb = _setup()
    want = np.asarray(jm.apply(jp, jb, JTape(None)))
    got = tm.apply(tp, tb, Tape.null())
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    mine = flatten(tm.init(3, "cpu"))
    assert {k: (tuple(v.shape), str(v.dtype)) for k, v in mine.items()} == \
        {k: (tuple(v.shape), "torch." + str(v.dtype))
         for k, v in jflatten(jp).items()}


def test_unknown_mode_raises():
    *_, tm, _, _ = _setup()
    with pytest.raises(ValueError, match="unknown mode"):
        make_grad_fn(tm.apply, DPConfig(mode="bk-fast"))
