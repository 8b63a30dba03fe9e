"""Rematerialization in the port (``core.tape.Tape.block``, ``cfg.remat``)
at smoke size, f32: for each family the JAX package remats (qwen2-1.5b,
deepseek-moe-16b, rwkv6-3b, hymba-1.5b) the BK clipped sums, norms and
per-sample losses with remat on equal those with remat off (bitwise: the
recompute runs the same ops on the same inputs) and the JAX package's
``bk_clipped_sum(..., mesh=None)`` at its own ``remat=True``; one step's
tape holds the same records and targets either way, each stacked block
runs twice (its forward and its recompute) and records once. Also: the
recompute tape, the int8 store (its rounding drawn once a record), the
opacus baseline (a ``torch.func`` transform: no checkpoint, the same
values), and the blocks the reference does not remat (the unstacked ones,
whisper's)."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import DPConfig as JDPConfig
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.utils.tree import unflatten as junflatten
from repro_torch.configs.registry import build, smoke_config
from repro_torch.convert import params_from_jax, params_to_numpy
from repro_torch.core import tape as ttape
from repro_torch.core.bk import (DPConfig, bk_clipped_sum, plan_report,
                                 tapped_backward)
from repro_torch.core.engine import make_grad_fn
from repro_torch.core.noise import prng_key
from repro_torch.core.policy import as_policy, resolve_policy
from repro_torch.data.synthetic import make_batch
from repro_torch.models import hymba, rwkv6, transformer
from repro_torch.utils.tree import flatten

B, T = 3, 16
TOL = dict(rtol=1e-3, atol=1e-4)           # tests/test_kernel_parity.py:15
FAMILIES = ["qwen2-1.5b", "deepseek-moe-16b", "rwkv6-3b", "hymba-1.5b"]
# each family's stacked block function, by the module that loops over it
BLOCK_FN = {"qwen2-1.5b": (transformer, "dense_block_apply"),
            "deepseek-moe-16b": (transformer, "dense_block_apply"),
            "rwkv6-3b": (rwkv6, "block_apply"),
            "hymba-1.5b": (hymba, "block_apply")}


@functools.lru_cache(maxsize=None)
def _numpy_params(arch):
    """The port's smoke params from seed 0 as flat numpy (the JAX package's
    keys and layouts, so its model reads them as they are)."""
    cfg = smoke_config(arch).with_(param_dtype="float32")
    return params_to_numpy(build(cfg).init(0, "cpu"))


def _jax(arch):
    jm = jbuild(jsmoke(arch).with_(dtype="float32", param_dtype="float32"))
    return jm, junflatten({k: jnp.asarray(v)
                           for k, v in _numpy_params(arch).items()})


def _port(arch, remat=True):
    """The port's model (``remat`` as asked) and a fresh copy of the
    params."""
    cfg = smoke_config(arch).with_(param_dtype="float32", remat=remat)
    return build(cfg), params_from_jax(_numpy_params(arch), "cpu")


def _tokens(seed=0):
    return np.random.default_rng(seed).integers(0, 64, (B, T)
                                                ).astype(np.int32)


def _count_calls(monkeypatch, module, name):
    calls = []
    fn = getattr(module, name)

    def counted(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)
    monkeypatch.setattr(module, name, counted)
    return calls


def _assert_bitwise(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_remat_matches_no_remat_and_jax(arch):
    """bk-mixopt with remat on against remat off (sums, norms and losses
    bitwise) and against the JAX package at its remat=True (TOL)."""
    assert smoke_config(arch).remat and jsmoke(arch).remat
    jm, jp = _jax(arch)
    toks = _tokens()
    tb = {"tokens": torch.from_numpy(toks)}
    runs = {}
    for remat in (True, False):
        tm, tp = _port(arch, remat)
        runs[remat] = bk_clipped_sum(tm.apply, tp, tb,
                                     DPConfig(mode="bk-mixopt"), mesh=None)
    (got, aux), (off, off_aux) = runs[True], runs[False]
    _assert_bitwise(got, off)
    for k in ("loss", "per_sample_norms"):
        assert torch.equal(aux[k], off_aux[k]), k
    want, waux = jax.jit(lambda p, b: jbk_clipped_sum(
        jm.apply, p, b, JDPConfig(mode="bk-mixopt", use_kernels=False)))(
            jp, {"tokens": toks})
    for k in ("loss", "per_sample_norms"):
        np.testing.assert_allclose(aux[k].numpy(), np.asarray(waux[k]),
                                   err_msg=k, **TOL)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), np.asarray(w), err_msg=k,
                                   **TOL)


@pytest.mark.parametrize("arch", FAMILIES)
def test_tape_is_the_same_and_each_block_runs_twice(arch, monkeypatch):
    """One phase-1 pass: the same record keys and shapes and the same
    target keys and lengths with remat on and off; under remat each stacked
    block's function runs twice (forward, recompute), once without, and
    the recompute records nothing (the tape's records are complete before
    the backward and unchanged after it)."""
    tapes, calls = {}, {}
    for remat in (True, False):
        tm, tp = _port(arch, remat)
        flat = flatten(tp)
        res = resolve_policy(as_policy(DPConfig(mode="bk-mixopt")), flat)
        psp = sorted(p for p in flat if not p.endswith("/w"))
        seen = _count_calls(monkeypatch, *BLOCK_FN[arch])
        _, tape, grads = tapped_backward(tm.apply, flat,
                                         {"tokens": torch.from_numpy(
                                             _tokens())}, res, psp)
        monkeypatch.undo()
        tapes[remat], calls[remat] = tape, len(seen)
        assert all(g is not None for g in grads)
    on, off = tapes[True], tapes[False]
    shapes = lambda t: {k: tuple(v.shape) for k, v in flatten(t.acts).items()}
    assert shapes(on) == shapes(off)
    lens = lambda t: {k: len(v) if isinstance(v, list) else 1
                      for k, v in t.outs.items()}
    assert lens(on) == lens(off)
    depth = {k.split("/")[0]: n for k, n in lens(on).items()
             if k.endswith(".s")}            # each stacked scope's layers
    assert calls[True] - calls[False] == sum(depth.values()) > 0
    assert on.remat and not off.remat
    assert all(k.endswith(".s") for k in on.remat)


def test_recompute_tape_under_remat():
    """The 'recompute' tape (phase 3 by a reweighted forward + backward,
    which recomputes the blocks again) equals its remat-off run bitwise
    and the native tape at TOL."""
    tb = {"tokens": torch.from_numpy(_tokens(1))}
    out = {}
    for remat in (True, False):
        tm, tp = _port("qwen2-1.5b", remat)
        out[remat] = bk_clipped_sum(tm.apply, tp, tb, DPConfig(
            mode="bk-mixopt", tape_policy="recompute", tape_chunks=2))
    _assert_bitwise(out[True][0], out[False][0])
    tm, tp = _port("qwen2-1.5b")
    native, _ = bk_clipped_sum(tm.apply, tp, tb, DPConfig(mode="bk-mixopt"))
    for k, g in out[True][0].items():
        torch.testing.assert_close(g, native[k], **TOL)


@pytest.mark.parametrize("arch", ["qwen2-1.5b", "rwkv6-3b"])
def test_opacus_runs_blocks_without_checkpoint(arch, monkeypatch):
    """opacus (``vmap(grad)``: a torch.func transform, which refuses
    checkpoint's saved-tensor hooks) with remat on enters no checkpoint and
    equals opacus with remat off bitwise; the BK step with remat on does
    checkpoint its blocks."""
    tb = {"tokens": torch.from_numpy(_tokens(2))}
    got = {}
    for remat in (True, False):
        tm, tp = _port(arch, remat)
        entered = _count_calls(monkeypatch, ttape, "checkpoint")
        g, aux = make_grad_fn(tm.apply, DPConfig(mode="opacus"))(
            tp, tb, prng_key(3))
        assert not entered
        got[remat] = (flatten(g), aux)
        if remat:
            bk_clipped_sum(tm.apply, tp, tb, DPConfig(mode="bk-mixopt"))
            assert entered
        monkeypatch.undo()
    _assert_bitwise(got[True][0], got[False][0])
    assert torch.equal(got[True][1]["per_sample_norms"],
                       got[False][1]["per_sample_norms"])


def test_int8_records_are_drawn_once(monkeypatch):
    """The int8 store quantizes each record once a step, with remat on as
    off: the recompute draws no rounding, so the sums are bitwise equal."""
    tb = {"tokens": torch.from_numpy(_tokens(3))}
    out, stored = {}, {}
    for remat in (True, False):
        tm, tp = _port("qwen2-1.5b", remat)
        calls = _count_calls(monkeypatch, ttape, "store_record")
        out[remat] = bk_clipped_sum(tm.apply, tp, tb, DPConfig(
            mode="bk", tape_policy="int8"), seed=5)
        stored[remat] = len(calls)
        monkeypatch.undo()
    assert stored[True] == stored[False] > 0
    _assert_bitwise(out[True][0], out[False][0])


@pytest.mark.parametrize("arch", ["whisper-small", "deepseek-moe-16b",
                                  "hymba-1.5b"])
def test_unrematerialized_blocks_are_unchanged(arch, monkeypatch):
    """The blocks the reference does not remat: whisper's (its reference
    ignores the flag; no checkpoint at all), and the unstacked ones
    (deepseek's dense0_0, hymba's g0, g_mid and g_last), whose taps
    ``plan_report`` does not mark 'remat' while every stacked tap is; the
    step's sums are bitwise its remat-off twin's."""
    cfg = smoke_config(arch).with_(param_dtype="float32")
    seq = 24 if cfg.family == "encdec" else T
    out = {}
    for remat in (True, False):
        model = build(cfg.with_(remat=remat))
        params = model.init(0, "cpu")
        batch = make_batch(cfg, B, seq, 0, 0, "cpu")
        entered = _count_calls(monkeypatch, ttape, "checkpoint")
        out[remat] = bk_clipped_sum(model.apply, params, batch,
                                    DPConfig(mode="bk-mixopt"))
        checkpointed = len(entered)
        monkeypatch.undo()
        report = plan_report(model.apply, params, batch,
                             DPConfig(mode="bk-mixopt"))
        marked = {k for k, plans in report.items() if plans["remat"]}
        if arch == "whisper-small" or not remat:
            assert not checkpointed and not marked
        else:
            assert checkpointed and marked == {k for k in report
                                               if k.endswith(".s")}
            assert any(not k.endswith(".s") and "#mm" in k and k != "head#mm"
                       for k in report)
    _assert_bitwise(out[True][0], out[False][0])
