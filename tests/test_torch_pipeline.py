"""The port's data pipeline (``repro_torch.data.pipeline`` over
``repro_torch.data.synthetic``) against the JAX package's
``repro.data.pipeline``: tokens and the Poisson mask bitwise the
reference's over seeds x steps x poisson_q, at smoke and full widths (a
vocab past 2^16 takes randint's other multiplier); JAX's draws
(split, random bits, uniform, randint) piece by piece; the state round
trip and the drift error of ``load_state``."""
import jax
import numpy as np
import pytest

from repro.configs.registry import get_config as jget_config
from repro.configs.registry import smoke_config as jsmoke
from repro.data.pipeline import Pipeline as JPipeline
from repro.data.pipeline import PipelineConfig as JPipelineConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.core.noise import prng_key
from repro_torch.data import synthetic
from repro_torch.data.pipeline import Pipeline, PipelineConfig


@pytest.mark.parametrize("arch,smoke", [("qwen2-1.5b", True),
                                        ("qwen2-1.5b", False),
                                        ("deepseek-moe-16b", False),
                                        ("rwkv6-3b", True)])
@pytest.mark.parametrize("poisson_q", [0.0, 0.05, 0.5])
@pytest.mark.parametrize("seed", [0, 11])
def test_batches_bitwise_the_reference(arch, smoke, poisson_q, seed):
    jcfg = jsmoke(arch) if smoke else jget_config(arch)
    tcfg = smoke_config(arch) if smoke else get_config(arch)
    want = JPipeline(jcfg, JPipelineConfig(16, 24, seed, poisson_q))
    got = Pipeline(tcfg, PipelineConfig(16, 24, seed, poisson_q), "cpu")
    for step in (0, 1, 5):
        a, b = want.batch(step), got.batch(step)
        assert sorted(a) == sorted(b)
        np.testing.assert_array_equal(b["tokens"].numpy(),
                                      np.asarray(a["tokens"]))
        assert b["tokens"].numpy().dtype == np.asarray(a["tokens"]).dtype
        if poisson_q:
            np.testing.assert_array_equal(b["mask"].numpy(),
                                          np.asarray(a["mask"]))
    if poisson_q == 0.5:       # the mask includes and excludes samples
        rows = got.batch(0)["mask"][:, 0]
        assert 0 < int(rows.sum()) < 16


def test_iteration_is_batch_of_step():
    cfg = smoke_config("qwen2-1.5b")
    pipe = Pipeline(cfg, PipelineConfig(4, 8, 3, 0.3), "cpu")
    for step, b in zip(range(3), pipe):
        ref = pipe.batch(step)
        assert all((b[k] == ref[k]).all() for k in ref)
    spec = pipe.spec()["tokens"]
    assert tuple(spec.shape) == (4, 8) and spec.dtype == ref["tokens"].dtype


@pytest.mark.parametrize("vocab", [2, 1000, 65536, 65537, 151936])
def test_draws_bitwise_jax(vocab):
    key = jax.random.PRNGKey(5)
    assert [tuple(int(w) for w in k) for k in
            jax.random.key_data(jax.random.split(key, 3))] == \
        synthetic.split(prng_key(5), 3)
    np.testing.assert_array_equal(
        synthetic.random_bits(prng_key(5), (3, 7), "cpu").numpy(),
        np.asarray(jax.random.bits(key, (3, 7))).astype(np.int64))
    np.testing.assert_array_equal(
        synthetic.uniform(prng_key(5), (3, 7), "cpu").numpy(),
        np.asarray(jax.random.uniform(key, (3, 7))))
    np.testing.assert_array_equal(
        synthetic.randint(prng_key(5), (5, 9), vocab, "cpu").numpy(),
        np.asarray(jax.random.randint(key, (5, 9), 0, vocab)))


def test_state_round_trip_and_drift_error():
    cfg = smoke_config("qwen2-1.5b")
    pipe = Pipeline(cfg, PipelineConfig(8, 16, seed=3, poisson_q=0.1),
                    "cpu")
    state = pipe.state_dict()
    assert state == JPipeline(jsmoke("qwen2-1.5b"), JPipelineConfig(
        8, 16, seed=3, poisson_q=0.1)).state_dict()
    pipe.load_state(dict(state))
    for key, value in (("seed", 4), ("batch", 16), ("poisson_q", 0.0)):
        with pytest.raises(ValueError, match=f"drift.*{key}"):
            pipe.load_state(dict(state, **{key: value}))
    with pytest.raises(ValueError, match="seq_len"):
        pipe.load_state({k: v for k, v in state.items() if k != "seq_len"})
