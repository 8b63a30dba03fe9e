"""The port's rwkv6 DP training against the JAX package's at smoke size,
f32: the same params (converted key by key) and numpy tokens -> the same
per-sample losses from ``Rwkv6LM.apply``, the same bk-mixopt per-sample
norms and grads as the reference's ``make_grad_fn`` (at T=16 the
recurrence takes ``wkv6_ref``, at T=64 ``wkv6_chunked``, as the JAX model
routes it on the CPU; the reference without its Pallas kernels), the
port's opacus equal to its bk-mixopt (the reference's own
test_bk_equals_opacus_per_arch tolerances), and one noised step of the
train CLI. rwkv6-3b has no registered policy: a flat DPConfig."""
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import DPConfig as JDPConfig
from repro.core.engine import make_grad_fn as jmake_grad_fn
from repro.core.tape import Tape as JTape
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.bk import DPConfig, plan_report
from repro_torch.core.engine import make_grad_fn
from repro_torch.core.noise import prng_key
from repro_torch.core.tape import Tape
from repro_torch.launch import train as ttrain
from repro_torch.utils.tree import flatten

ARCH, B = "rwkv6-3b", 3
TOL = dict(rtol=1e-3, atol=1e-4)           # tests/test_kernel_parity.py:15
OPACUS_NORM_TOL = dict(rtol=2e-4, atol=1e-5)   # tests/test_arch_smoke.py:97
OPACUS_TOL = dict(rtol=2e-3, atol=2e-5)        # tests/test_arch_smoke.py:100


@functools.lru_cache(maxsize=None)
def _jax(T):
    jm = jbuild(jsmoke(ARCH).with_(dtype="float32", param_dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    toks = np.random.default_rng(T).integers(0, 64, (B, T)).astype(np.int32)
    return jm, jp, toks


def _port(T):
    """The port's model, a fresh copy of the JAX params, the batch."""
    _, jp, toks = _jax(T)
    tm = build(smoke_config(ARCH).with_(param_dtype="float32"))
    tp = params_from_jax({k: np.asarray(v) for k, v in jflatten(jp).items()},
                         "cpu")
    return tm, tp, {"tokens": torch.from_numpy(toks)}


@pytest.mark.parametrize("T", [16, 64])
def test_apply_losses_match_jax(T):
    jm, jp, toks = _jax(T)
    tm, tp, tb = _port(T)
    want = np.asarray(jm.apply(jp, {"tokens": toks}, JTape(None)))
    got = tm.apply(tp, tb, Tape.null())
    assert got.shape == (B,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_apply_taps_every_op_of_the_reference():
    """The 17 mm taps (16 stacked over the blocks, the head) and the
    embedding, as the reference's tape keys them; u and the other vectors
    on the psp route."""
    tm, tp, tb = _port(16)
    report = plan_report(tm.apply, tp, tb, DPConfig(mode="bk-mixopt"))
    att = ["tm_w1", *(f"tm_w2_{i}" for i in range(5)), "wa", "wb",
           *"rkvgo"]
    want = ({f"blocks/att/{n}#mm.s" for n in att}
            | {f"blocks/ffn/{n}#mm.s" for n in ("key", "value",
                                                 "receptance")}
            | {"head#mm", "embed#emb"})
    assert set(report) == want


@pytest.mark.parametrize("T", [16, 64])
def test_bk_mixopt_matches_jax(T):
    """Per-sample norms, loss and the private grads (sigma 0: the clipped
    sum over B) of the port's bk-mixopt against the reference's."""
    jm, jp, toks = _jax(T)
    tm, tp, tb = _port(T)
    want, waux = jax.jit(jmake_grad_fn(
        jm.apply, JDPConfig(mode="bk-mixopt", use_kernels=False)))(
            jp, {"tokens": toks}, jax.random.PRNGKey(3))
    got, aux = make_grad_fn(tm.apply, DPConfig(mode="bk-mixopt"))(
        tp, tb, prng_key(3))
    np.testing.assert_allclose(aux["per_sample_norms"].numpy(),
                               np.asarray(waux["per_sample_norms"]), **TOL)
    np.testing.assert_allclose(float(aux["loss"]), float(waux["loss"]),
                               rtol=1e-5)
    want = {k: np.asarray(v) for k, v in jflatten(want).items()}
    got = flatten(got)
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape, k
        np.testing.assert_allclose(got[k].numpy(), want[k], err_msg=k, **TOL)


@pytest.mark.parametrize("T", [16, 64])
def test_opacus_matches_bk_mixopt(T):
    """The port's opacus (vmap(grad) through the model, the recurrence's
    CPU forms under vmap) against its bk-mixopt."""
    tm, tp, tb = _port(T)
    ref, ra = make_grad_fn(tm.apply, DPConfig(mode="opacus"))(
        tp, tb, prng_key(3))
    got, ga = make_grad_fn(tm.apply, DPConfig(mode="bk-mixopt"))(
        tp, tb, prng_key(3))
    np.testing.assert_allclose(ga["per_sample_norms"].numpy(),
                               ra["per_sample_norms"].numpy(),
                               **OPACUS_NORM_TOL)
    ref = flatten(ref)
    for k, g in sorted(flatten(got).items()):
        np.testing.assert_allclose(g.numpy(), ref[k].numpy(), err_msg=k,
                                   **OPACUS_TOL)


def test_train_cli_takes_a_noised_step(tmp_path):
    """``--arch rwkv6-3b --smoke --device cpu``: two noised AdamW steps;
    the summary accounts them, every param moves, and the first loss is
    near ln(vocab) + 1/2 (the head's 1/sqrt(d) init after a layernorm gives
    logits of unit variance, and E log sum_v exp(z_v) = ln V + var / 2)."""
    out = tmp_path / "s.json"
    params, losses = ttrain.main([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
        "--batch", "2", "--seq", "16", "--sigma", "1.0", "--out", str(out)])
    summary = json.loads(out.read_text())
    assert summary["steps_done"] == 2 and summary["epsilon"] > 0
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert abs(losses[0] - (math.log(64) + 0.5)) < 0.25
    init = build(smoke_config(ARCH).with_(param_dtype="float32")).init(
        0, "cpu")
    moved = {k: not torch.equal(v, flatten(init)[k])
             for k, v in flatten(params).items()}
    assert all(moved.values()), [k for k, m in moved.items() if not m]
