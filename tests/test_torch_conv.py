"""The port's conv taps (``models.layers.conv2d`` / ``conv1d``: im2col
generalized-linear ops) against the JAX package's on the CPU: outputs and
records on the same numpy inputs and params under SAME (odd and even H,
stride 1 and 2: JAX pads asymmetrically), VALID and explicit padding; the
reference test's TinyCNN (tests/test_conv_dp.py) with the same params and
batch: its per-sample norms and grads in bk, bk-mixopt, bk-mixghost and
ghostclip against the reference's opacus and the port's own, at that
test's tolerances; its record shapes; the layerwise hybrid decision at
ResNet-18's conv1 and an fc; and the loss falling over 15 DP steps."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.bk import DPConfig as JDPConfig
from repro.core.engine import make_grad_fn as jmake_grad_fn
from repro.core.tape import Tape as JTape
from repro.models import layers as JL
from repro.utils.tree import flatten as jflatten
from repro_torch.convert import params_from_jax
from repro_torch.core import ghost
from repro_torch.core.bk import DPConfig, plan_report
from repro_torch.core.engine import make_grad_fn
from repro_torch.core.noise import fold_in, prng_key
from repro_torch.core.tape import Tape
from repro_torch.models import layers as L
from repro_torch.utils.tree import flatten

B, H, W, C, NC = 4, 8, 8, 3, 5
NORM_TOL = dict(rtol=1e-5, atol=1e-6)        # tests/test_conv_dp.py:61
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)        # tests/test_conv_dp.py:65
MODES = ["bk", "bk-mixopt", "bk-mixghost", "ghostclip"]


# (H, W, kh, kw, stride, padding): SAME on even and odd sides at strides 1
# and 2 (8 at k 3, s 2 pads (0, 1); 7 pads (1, 1)), a 7x7 stem, VALID, and
# explicit asymmetric pairs
CASES = [(8, 8, 3, 3, 1, "SAME"), (8, 8, 3, 3, 2, "SAME"),
         (7, 9, 3, 3, 2, "SAME"), (7, 7, 3, 3, 1, "SAME"),
         (9, 10, 7, 7, 2, "SAME"), (8, 8, 2, 2, 1, "VALID"),
         (9, 8, 3, 2, 2, "VALID"), (8, 8, 3, 3, 1, ((1, 2), (0, 1))),
         (6, 7, 3, 3, 2, ((2, 0), (1, 1)))]


@pytest.mark.parametrize("H_,W_,kh,kw,s,pad", CASES)
def test_conv2d_matches_jax(H_, W_, kh, kw, s, pad):
    """Outputs (with a bias) and the (B, H'*W', kh*kw*C) records, whose
    features are channel-major as ``conv_general_dilated_patches`` orders
    them, so the weight's rows carry across unchanged."""
    rng = np.random.default_rng(H_ * 100 + W_ + kh + s)
    x = rng.standard_normal((2, H_, W_, C)).astype(np.float32)
    w = rng.standard_normal((kh * kw * C, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    jt = JTape(None)
    want = np.asarray(JL.conv2d(jt, "c", {"w": jnp.asarray(w),
                                          "b": jnp.asarray(b)},
                                jnp.asarray(x), kh, kw, s, pad))
    tape = Tape()
    got = L.conv2d(tape, "c", {"w": torch.from_numpy(w),
                               "b": torch.from_numpy(b)},
                   torch.from_numpy(x), kh, kw, s, pad)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    rec = tape.acts["c#mm"]
    np.testing.assert_array_equal(rec.numpy(), np.asarray(jt.acts["c#mm"]))
    assert rec.is_contiguous()


def test_same_padding_is_asymmetric():
    """At H = 8, k = 3, s = 2 JAX pads (0, 1); at H = 7, (1, 1); at H = 10
    and 224, k = 7, s = 2, (2, 3)."""
    assert L._same_pads(8, 3, 2) == (0, 1)
    assert L._same_pads(7, 3, 2) == (1, 1)
    assert L._same_pads(10, 7, 2) == (2, 3)
    assert L._same_pads(224, 7, 2) == (2, 3)


@pytest.mark.parametrize("T,k,s,pad", [(16, 3, 1, "SAME"), (15, 4, 2, "SAME"),
                                       (12, 3, 1, "VALID"),
                                       (10, 3, 2, ((0, 0), (2, 1)))])
def test_conv1d_matches_jax(T, k, s, pad):
    rng = np.random.default_rng(T + k)
    x = rng.standard_normal((2, T, C)).astype(np.float32)
    w = rng.standard_normal((k * C, 4)).astype(np.float32)
    jt = JTape(None)
    want = np.asarray(JL.conv1d(jt, "c", {"w": jnp.asarray(w)},
                                jnp.asarray(x), k, s, pad))
    tape = Tape()
    got = L.conv1d(tape, "c", {"w": torch.from_numpy(w)},
                   torch.from_numpy(x), k, s, pad)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(tape.acts["c#mm"].numpy(),
                                  np.asarray(jt.acts["c#mm"]))


def test_conv_init_layout_matches_jax():
    """(kh*kw*C, c_out) weights at fan-in 1/sqrt(kh*kw*C), a zero bias."""
    gen = torch.Generator().manual_seed(0)
    p = L.conv2d_init(gen, 3, 3, 64, 128, torch.float32, bias=True)
    j = JL.conv2d_init(jax.random.PRNGKey(0), 3, 3, 64, 128, jnp.float32,
                       bias=True)
    assert {k: tuple(v.shape) for k, v in p.items()} == \
        {k: v.shape for k, v in j.items()}
    assert abs(float(p["w"].std()) - 1 / np.sqrt(576)) < 2e-3
    assert not p["b"].any()
    q = L.conv1d_init(gen, 5, 8, 16, torch.bfloat16)
    assert tuple(q["w"].shape) == (40, 16) and q["w"].dtype == torch.bfloat16


class JTinyCNN:
    """tests/test_conv_dp.py's model: conv3x3 -> relu -> conv3x3(s2) ->
    relu -> gap -> linear."""

    def init(self, rng):
        ks = jax.random.split(rng, 3)
        return {
            "c1": JL.conv2d_init(ks[0], 3, 3, C, 8, jnp.float32, bias=True),
            "c2": JL.conv2d_init(ks[1], 3, 3, 8, 16, jnp.float32),
            "head": JL.linear_init(ks[2], 16, NC, jnp.float32, bias=True),
        }

    def apply(self, params, batch, tape):
        x = batch["x"]
        x = jax.nn.relu(JL.conv2d(tape, "c1", params["c1"], x, 3, 3))
        x = jax.nn.relu(JL.conv2d(tape, "c2", params["c2"], x, 3, 3,
                                  stride=2))
        x = jnp.mean(x, axis=(1, 2))[:, None, :]
        logits = JL.linear(tape, "head", params["head"], x)[:, 0]
        logits = logits.astype(jnp.float32)
        logz = jax.nn.logsumexp(logits, axis=-1)
        gold = jnp.take_along_axis(logits, batch["y"][:, None], axis=-1)[:, 0]
        return logz - gold


def tiny_cnn(params, batch, tape):
    """The same model on the port's layers."""
    x = torch.relu(L.conv2d(tape, "c1", params["c1"], batch["x"], 3, 3))
    x = torch.relu(L.conv2d(tape, "c2", params["c2"], x, 3, 3, stride=2))
    x = x.mean(dim=(1, 2))[:, None, :]
    logits = L.linear(tape, "head", params["head"], x)[:, 0].float()
    gold = torch.gather(logits, -1, batch["y"][:, None].long())[:, 0]
    return torch.logsumexp(logits, dim=-1) - gold


class Ref:
    """The reference's TinyCNN, params, batch and opacus grads, once."""

    def __init__(self):
        self.model = JTinyCNN()
        self.params = self.model.init(jax.random.PRNGKey(0))
        self.batch = {"x": jax.random.normal(jax.random.PRNGKey(1),
                                             (B, H, W, C)),
                      "y": jax.random.randint(jax.random.PRNGKey(2), (B,), 0,
                                              NC)}
        grads, aux = jmake_grad_fn(self.model.apply, JDPConfig(
            mode="opacus"))(self.params, self.batch, jax.random.PRNGKey(3))
        self.grads = {k: np.asarray(v) for k, v in jflatten(grads).items()}
        self.norms = np.asarray(aux["per_sample_norms"])

    def port(self):
        flat = {k: np.asarray(v) for k, v in jflatten(self.params).items()}
        batch = {k: torch.from_numpy(np.array(v))
                 for k, v in self.batch.items()}
        return params_from_jax(flat, "cpu"), batch


@pytest.fixture(scope="module")
def ref():
    return Ref()


def _check(got, aux, want, want_norms, label):
    np.testing.assert_allclose(aux["per_sample_norms"].numpy(), want_norms,
                               err_msg=label, **NORM_TOL)
    got = flatten(got)
    assert sorted(got) == sorted(want), label
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w, err_msg=f"{label} {k}",
                                   **GRAD_TOL)


@pytest.mark.parametrize("mode", MODES)
def test_cnn_bk_equals_opacus(ref, mode):
    """Each mode's per-sample norms and grads against the reference's opacus
    and the port's own opacus (vmap(grad) through the im2col unfold)."""
    params, batch = ref.port()
    got, aux = make_grad_fn(tiny_cnn, DPConfig(mode=mode))(
        params, batch, prng_key(3))
    _check(got, aux, ref.grads, ref.norms, f"{mode} vs reference opacus")
    mine, maux = make_grad_fn(tiny_cnn, DPConfig(mode="opacus"))(
        params, batch, prng_key(3))
    _check(got, aux, {k: v.numpy() for k, v in flatten(mine).items()},
           maux["per_sample_norms"].numpy(), f"{mode} vs port opacus")


def test_cnn_plan_routes_the_conv_taps(ref):
    """c1 (T = 64, d = 27, p = 8: 2T^2 >= pd) takes the direct norm, whose
    small per-sample grads bk-mixopt caches and bk-mixghost does not; c2
    (T = 16, d = 72, p = 16) and the head (T = 1) the ghost norm; mode 'bk'
    ghost everywhere."""
    params, batch = ref.port()
    for mode, c1 in (("bk-mixopt", "cache"), ("bk-mixghost", "direct"),
                     ("bk", "ghost")):
        rep = plan_report(tiny_cnn, params, batch, DPConfig(mode=mode))
        assert sorted(rep) == ["c1#mm", "c2#mm", "head#mm"]
        got = {k: "cache" if r["grad"] == "cache" else r["norm"].method
               for k, r in rep.items()}
        assert got == {"c1#mm": c1, "c2#mm": "ghost", "head#mm": "ghost"}, \
            (mode, rep)


def test_conv_record_shapes(ref):
    params, batch = ref.port()
    tape = Tape(None)
    tiny_cnn(params, batch, tape)
    assert tuple(tape.acts["c1#mm"].shape) == (B, H * W, 3 * 3 * C)
    assert tuple(tape.acts["c2#mm"].shape) == (B, (H // 2) * (W // 2),
                                               3 * 3 * 8)
    assert tuple(tape.acts["head#mm"].shape) == (B, 1, 16)


def test_conv_hybrid_decision_regimes():
    """ResNet-18's conv1 at 224x224 (T = 112^2, d = 3*49, p = 64) takes
    the direct norm; an fc (T = 1) the ghost norm."""
    assert not ghost.prefer_ghost(T=112 * 112, d=147, p=64)
    assert ghost.prefer_ghost(T=1, d=512, p=1000)
    assert not ghost.prefer_ghost(T=56 * 56, d=576, p=128)


def test_cnn_dp_training_reduces_loss(ref):
    """15 bk-mixopt steps (sigma 0.1, lr 5e-2) lower the mean loss, as the
    reference test's run does."""
    params, batch = ref.port()
    fn = make_grad_fn(tiny_cnn, DPConfig(mode="bk-mixopt", sigma=0.1))

    def loss(p):
        with torch.no_grad():
            return float(tiny_cnn(p, batch, Tape.null()).mean())

    l0 = loss(params)
    for step in range(15):
        grads, _ = fn(params, batch, fold_in(prng_key(5), step), step)
        g = flatten(grads)
        params = {k: {n: v - 5e-2 * g[f"{k}/{n}"] for n, v in sub.items()}
                  for k, sub in params.items()}
    assert loss(params) < l0
