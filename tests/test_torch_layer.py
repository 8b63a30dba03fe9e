"""Layer-scope clipping in the port against the JAX package, at smoke size:
``with_scope`` and the resolved clip units; ``fused_clip_grad``'s plain
version against the Pallas kernel (interpret mode); ``bk_clipped_sum`` under
a layer-scoped policy in every BK mode; streamed vs two-phase bitwise
without kernels (the JAX package's own contract,
tests/test_layer_scope.py:131); and the fused/split routes of
``dispatch.fused_plan`` against the JAX package's, at qwen2-1.5b's full
shapes too."""
import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.configs.registry import build as jbuild
from repro.configs.registry import get_policy as jget_policy
from repro.configs.registry import smoke_config as jsmoke
from repro.core.bk import DPConfig as JDPConfig
from repro.core.bk import bk_clipped_sum as jbk_clipped_sum
from repro.core.policy import ParamGroup as JParamGroup
from repro.core.policy import PrivacyPolicy as JPrivacyPolicy
from repro.core.policy import resolve_policy as jresolve_policy
from repro.core.policy import with_scope as jwith_scope
from repro.kernels import dispatch as jdispatch
from repro.kernels.fused_clip import fused_clip_grad as jfused_clip_grad
from repro.utils.tree import flatten as jflatten
from repro_torch.configs.registry import build, get_policy, smoke_config
from repro_torch.convert import params_from_jax
from repro_torch.core.bk import DPConfig, bk_clipped_sum, plan_report
from repro_torch.core.policy import (ParamGroup, PrivacyPolicy,
                                     resolve_policy, with_scope)
from repro_torch.kernels import dispatch
from repro_torch.kernels import fused_clip as fc_mod
from repro_torch.kernels.fused_clip import CLIPS, fused_clip_grad
from repro_torch.utils.tree import flatten

TOL = dict(rtol=1e-3, atol=1e-4)        # tests/test_kernel_parity.py:15
MODES = ["bk", "bk-mixghost", "bk-mixopt"]
T = 16


@functools.lru_cache(maxsize=None)
def _jax_setup(B=3):
    jcfg = jsmoke("qwen2-1.5b").with_(dtype="float32", param_dtype="float32")
    jm = jbuild(jcfg)
    toks = np.random.default_rng(0).integers(0, 64, (B, T)).astype(np.int32)
    return jm, jm.init(jax.random.PRNGKey(0)), toks


def _setup():
    jm, jp, toks = _jax_setup()
    tp = params_from_jax({k: np.asarray(v) for k, v in jflatten(jp).items()},
                         "cpu")
    tm = build(smoke_config("qwen2-1.5b").with_(param_dtype="float32"))
    return jm, jp, {"tokens": jnp.asarray(toks)}, tm, tp, \
        {"tokens": torch.from_numpy(toks)}


def _assert_close(got, want, tol, msg=""):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=msg,
                               **tol)


# ------------------------------------------------------------- resolution
def _policy(PG, PP, DP, preset):
    """The same policy built from one package's classes."""
    if preset == "dpconfig":
        return DP(mode="bk-mixopt", R=0.8)
    return PP((PG("emb", "embed/.*", trainable=False),
               PG("attn", "blocks/attn/.*", R=0.7, scope="group",
                  clipping="abadi"),
               PG("rest", ".*")))


@pytest.mark.parametrize("preset", ["qwen2-1.5b", "dpconfig", "frozen"])
@pytest.mark.parametrize("scope", ["layer", "group", ""])
def test_with_scope_units_match_jax(preset, scope):
    _, jp, _, _, tp, _ = _setup()
    if preset == "qwen2-1.5b":
        jpol, tpol = jget_policy(preset), get_policy(preset)
    else:
        jpol = _policy(JParamGroup, JPrivacyPolicy, JDPConfig, preset)
        tpol = _policy(ParamGroup, PrivacyPolicy, DPConfig, preset)
    jres = jresolve_policy(jwith_scope(jpol, scope), jflatten(jp))
    tres = resolve_policy(with_scope(tpol, scope), flatten(tp))
    assert [(u.name, u.clipping, u.R, u.gamma, u.paths) for u in tres.units] \
        == [(u.name, u.clipping, u.R, u.gamma, u.paths) for u in jres.units]
    assert tres.unit_of == jres.unit_of and tres.frozen == jres.frozen
    assert tres.sensitivity == pytest.approx(jres.sensitivity, rel=1e-12)
    assert {g.name: g.scope for g in with_scope(tpol, scope).groups} == \
        {g.name: g.scope for g in jwith_scope(jpol, scope).groups}
    if scope == "layer":
        assert all(u.name.split(":", 1)[1] == u.paths[0]
                   for u in tres.units)


def test_with_scope_rejects_unknown_scope():
    with pytest.raises(ValueError, match="clipping scope"):
        with_scope(DPConfig(), "per-token")


# --------------------------------------------------- fused_clip_grad plain
def _np(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _torch(x):
    t = torch.from_numpy(np.ascontiguousarray(x.astype(np.float32)))
    return t.to(torch.bfloat16) if x.dtype == ml_dtypes.bfloat16 else t


def _flat_R(sq):
    """An R midway in the widest gap between the per-sample norms, so a
    rounding difference cannot flip the flat indicator."""
    n = np.sort(np.sqrt(np.asarray(sq, np.float64)))
    i = int(np.argmax(np.diff(n)))
    return float((n[i] + n[i + 1]) / 2)


# (L, B, T, d, p); L = 0 is the unstacked 3-d record
FUSED_SHAPES = [(0, 3, 7, 5, 9), (2, 4, 33, 17, 23)]


@pytest.mark.parametrize("L,B,Tn,d,p", FUSED_SHAPES)
@pytest.mark.parametrize("clipping", CLIPS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fused_clip_plain_matches_pallas(L, B, Tn, d, p, clipping, dtype):
    lead = (L,) if L else ()
    a = _np((*lead, B, Tn, d), dtype, 0)
    ds = _np((*lead, B, Tn, p), dtype, 1)
    w = np.abs(np.random.default_rng(2).standard_normal(B)).astype(
        np.float32) + 0.5
    w[1] = 0.0                                  # a masked sample
    ta, tds, tw = _torch(a), _torch(ds), torch.from_numpy(w)
    R, gamma = 1.0, 0.05
    if clipping == "flat":
        R = _flat_R(fused_clip_grad(ta, tds, tw, "automatic", 1.0, gamma)[1])
    jG, jsq = jfused_clip_grad(jnp.asarray(a), jnp.asarray(ds),
                               jnp.asarray(w), clipping, R, gamma,
                               interpret=True)
    G, sq = fused_clip_grad(ta, tds, tw, clipping, R, gamma)
    assert G.dtype == sq.dtype == torch.float32
    assert G.shape == tuple(jG.shape) and sq.shape == (B,)
    _assert_close(sq, jsq, TOL, "sq")
    _assert_close(G, jG, TOL, "G")


def test_fused_clip_plain_keeps_C_in_f32():
    """C is not rounded to the record dtype: a bf16 record's G equals the
    f32 computation on the same (bf16-exact) values."""
    a = _torch(_np((2, 3, 9, 6), "bfloat16", 3))
    ds = _torch(_np((2, 3, 9, 8), "bfloat16", 4))
    w = torch.tensor([1.0, 0.3, 0.7])
    G16, sq16 = fused_clip_grad(a, ds, w, "automatic", 0.9, 0.01)
    G32, sq32 = fused_clip_grad(a.float(), ds.float(), w, "automatic", 0.9,
                                0.01)
    torch.testing.assert_close(G16, G32, rtol=0, atol=0)
    torch.testing.assert_close(sq16, sq32, rtol=0, atol=0)


def test_fused_clip_rejects_unknown_clipping():
    with pytest.raises(ValueError, match="clipping must be one of"):
        fused_clip_grad(torch.zeros(2, 3, 4), torch.zeros(2, 3, 5),
                        torch.ones(2), "softclip", 1.0, 0.01)


# the units of parity_layer's smoke-width case (qwen2-1.5b's smoke_config,
# B = 8, T = 512: qkv 32 -> 64, o 32 -> 32, gate+up 32 -> 96, down 48 -> 32
# at L = 2, the head 32 -> 64), and the gate's edge (edge_square, d = p =
# 512, at B = 8) cut to T = 16
FUSED_SMOKE = [(2, 8, 512, 32, 64), (2, 8, 512, 32, 32), (2, 8, 512, 32, 96),
               (2, 8, 512, 48, 32), (0, 8, 512, 32, 64)]
FUSED_EDGE_CUT = (1, 8, 16, 512, 512)
# (route, tile, sample slots a group, CTAs a tile's rows are split over)
# of the kernel's decomposition: each SIMT tile, wgmma's, groups of 3
# (several barriers a launch), rows split over 8 and 3 CTAs
MODEL_PLANS = [("simt", 16, 8, 8), ("simt", 32, 3, 3), ("simt", 64, 8, 1),
               ("wgmma", 64, 3, 2)]


@pytest.mark.parametrize("L,B,Tn,d,p",
                         FUSED_SMOKE + FUSED_SHAPES + [FUSED_EDGE_CUT])
@pytest.mark.parametrize("clipping", CLIPS)
def test_fused_model_matches_pallas(L, B, Tn, d, p, clipping):
    """The kernel's decomposition (``kernels.fused_clip.fused_model``: its
    tiles, its T pieces, each CTA's partial of sq_b summed in CTA order, C_b
    after each group of samples, G folded in b order; float64) against the
    Pallas kernel in interpret mode, under each clip function with a masked
    sample (w = 0), R at the median norm (flat: midway in the widest gap).
    f32 inputs; the Pallas sums are f32 (rtol 1e-5, atol 1e-6 of G's
    scale)."""
    lead = (L,) if L else ()
    a = _np((*lead, B, Tn, d), "float32", 0)
    ds = _np((*lead, B, Tn, p), "float32", 1)
    w = np.abs(np.random.default_rng(2).standard_normal(B)).astype(
        np.float32) + 0.5
    w[1] = 0.0
    ta, tds, tw = _torch(a), _torch(ds), torch.from_numpy(w)
    gamma = 0.05
    sq0 = fused_clip_grad(ta, tds, tw, "automatic", 1.0, gamma)[1]
    R = _flat_R(sq0) if clipping == "flat" else \
        float(np.median(np.sqrt(sq0.numpy())))
    jG, jsq = jfused_clip_grad(jnp.asarray(a), jnp.asarray(ds),
                               jnp.asarray(w), clipping, R, gamma,
                               interpret=True)
    jG, jsq = np.asarray(jG), np.asarray(jsq)
    # at the edge a 16-wide tile is 1024 CTAs: the model runs the 64 tiles
    plans = MODEL_PLANS if d < 512 else [("simt", 64, 3, 1),
                                         ("wgmma", 64, 8, 1)]
    for kernel, tile, group, split in plans:
        G, sq = fc_mod.fused_model(ta, tds, tw, clipping, R, gamma, kernel,
                                   tile, group, split)
        assert G.dtype == sq.dtype == torch.float64
        assert G.shape == jG.shape and sq.shape == (B,)
        np.testing.assert_allclose(sq.numpy(), jsq, rtol=1e-5,
                                   err_msg=f"{kernel} {tile}")
        np.testing.assert_allclose(G.numpy(), jG, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(jG).max()),
                                   err_msg=f"{kernel} {tile}")


@pytest.mark.parametrize("split", [1, 2, 3, 8])
def test_fused_model_t_pieces_cover_every_row_once(split):
    """The T pieces of each route and tile split a sample's rows: every row
    in exactly one piece (``split`` CTAs of whole stages, 64 rows (wgmma)
    or 1024 / tile; in each SIMT CTA T-group q taking the rows q mod NTG,
    NTG = 16, 4, 1 for tiles 16, 32, 64)."""
    for kernel, tile, ntg in (("simt", 16, 16), ("simt", 32, 4),
                              ("simt", 64, 1), ("wgmma", 64, 1)):
        for T in (1, 7, 509, 512):
            pieces = fc_mod.t_pieces(T, kernel, tile, split)
            assert len(pieces) == split * ntg
            rows = torch.cat(pieces).sort().values
            assert torch.equal(rows, torch.arange(T)), (kernel, tile, T)


# ----------------------------------------------------------- bk_clipped_sum
def _compare(jpol, tpol):
    jm, jp, jb, tm, tp, tb = _setup()
    want, waux = jax.jit(lambda p, b: jbk_clipped_sum(jm.apply, p, b, jpol))(
        jp, jb)
    got, gaux = bk_clipped_sum(tm.apply, tp, tb, tpol)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].shape == tuple(want[k].shape), k
        _assert_close(got[k], want[k], TOL, k)
    _assert_close(gaux["per_sample_norms"], waux["per_sample_norms"], TOL)
    for part in ("group_norms", "group_clip_factors"):
        assert sorted(gaux[part]) == sorted(waux[part])
        for u in waux[part]:
            _assert_close(gaux[part][u], waux[part][u], TOL, f"{part}:{u}")
    return got


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("clipping", ["automatic", "abadi"])
def test_layer_scope_clipped_sum_matches_jax(mode, clipping):
    """The JAX side on its jnp path (the composed split route); the port's
    default run takes fused_clip_grad (its plain version on the CPU) for
    every mm unit in bk-mixghost and bk-mixopt (each fits the fused budget
    at smoke size), and the split route in bk."""
    kw = dict(mode=mode, clipping=clipping, R=0.3)
    _compare(jwith_scope(JDPConfig(use_kernels=False, **kw), "layer"),
             with_scope(DPConfig(**kw), "layer"))


def test_layer_scope_preset_matches_jax_with_its_pallas_kernels():
    """The qwen2-1.5b preset re-scoped to 'layer', the reference with its
    kernels on: the fused Pallas kernel in interpret mode."""
    _compare(jwith_scope(jget_policy("qwen2-1.5b", mode="bk-mixopt"),
                         "layer"),
             with_scope(get_policy("qwen2-1.5b", mode="bk-mixopt"), "layer"))


@pytest.mark.parametrize("mode", MODES)
def test_streamed_bitwise_vs_two_phase_without_kernels(mode, monkeypatch):
    _, _, _, tm, tp, tb = _setup()
    pol = with_scope(DPConfig(mode=mode, use_kernels=False), "layer")
    monkeypatch.setenv("REPRO_STREAM", "1")
    got, gaux = bk_clipped_sum(tm.apply, tp, tb, pol)
    monkeypatch.setenv("REPRO_STREAM", "0")
    two, taux = bk_clipped_sum(tm.apply, tp, tb, pol)
    for k in two:
        torch.testing.assert_close(got[k], two[k], rtol=0, atol=0, msg=k)
    torch.testing.assert_close(gaux["per_sample_norms"],
                               taux["per_sample_norms"], rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["bk-mixghost", "bk-mixopt"])
def test_streamed_fused_close_to_two_phase(mode, monkeypatch):
    """With the kernels on, the fused route computes the same sums in
    another order."""
    _, _, _, tm, tp, tb = _setup()
    pol = with_scope(DPConfig(mode=mode), "layer")
    got, _ = bk_clipped_sum(tm.apply, tp, tb, pol)
    monkeypatch.setenv("REPRO_STREAM", "0")
    two, _ = bk_clipped_sum(tm.apply, tp, tb, pol)
    for k in two:
        torch.testing.assert_close(got[k], two[k], rtol=1e-5, atol=1e-6,
                                   msg=k)


# ------------------------------------------------------------- fused_plan
FULL = dict(qkv=((28, 8, 512, 1536), (28, 8, 512, 2048)),
            o=((28, 8, 512, 1536), (28, 8, 512, 1536)),
            up=((28, 8, 512, 1536), (28, 8, 512, 17920)),
            down=((28, 8, 512, 8960), (28, 8, 512, 1536)),
            head=((8, 512, 1536), (8, 512, 151936)))


@pytest.mark.parametrize("mode,method,want", [
    ("bk-mixopt", "", "fused"), ("bk-mixghost", "", "fused"),
    ("bk-mixopt", "direct", "fused"), ("bk", "", "split"),
    ("bk-mixopt", "ghost", "split")])
def test_fused_plan_routes(mode, method, want):
    """The reference's capacity gate: qwen2-1.5b's five full-width mm units
    (B=8, T=512) hold far more than 6 MiB a sample, so every one splits; a
    unit small enough to fit fuses unless mode 'bk' or a ghost override
    (``want``); emb and moe units always split."""
    for a, ds in FULL.values():
        assert dispatch.fused_plan("mm", a, ds, mode, method).method == \
            "split"
    assert dispatch.fused_plan("mm", (2, 8, 64, 32), (2, 8, 64, 48), mode,
                               method).method == want
    assert dispatch.fused_plan("emb", (8, 512), (8, 512, 1536), mode,
                               method).method == "split"
    assert dispatch.fused_plan("moe", (5, 8, 64, 128, 2048),
                               (5, 8, 64, 128, 1408), mode,
                               method).method == "split"


# (records, cotangent): one sample's 4 (L T (d+p) + 2 L d p) bytes against
# the reference's 6 MiB (src/repro/kernels/dispatch.py:37,207)
GATE_SHAPES = [((2, 16, 32), (2, 16, 48)),               # smoke-sized
               ((4, 1024, 512), (4, 1024, 512)),         # exactly 6 MiB
               ((4, 1025, 512), (4, 1025, 512)),         # one row over
               ((2, 4, 1024, 256), (2, 4, 1024, 256)),   # stacked, 5 MiB
               ((3, 4, 1024, 256), (3, 4, 1024, 256)),   # stacked, 7.5 MiB
               *FULL.values()]                           # full width


@pytest.mark.parametrize("act,ds", GATE_SHAPES)
@pytest.mark.parametrize("mode", MODES)
def test_fused_plan_matches_jax(act, ds, mode):
    """The port plans every streamed unit as the JAX package does, for
    every tap kind and group override."""
    for kind in ("mm", "emb", "moe"):
        for method in ("", "ghost", "direct"):
            want = jdispatch.fused_plan(kind, act, ds, mode, method).method
            got = dispatch.fused_plan(kind, act, ds, mode, method).method
            assert got == want, (kind, method)


def test_plan_report_layer_scope_routes():
    """Under the layer-scoped preset every tap streams: the five mm taps
    run fused_clip_grad, the embedding the split route."""
    _, _, _, tm, tp, tb = _setup()
    pol = with_scope(get_policy("qwen2-1.5b", mode="bk-mixopt"), "layer")
    rep = plan_report(tm.apply, tp, tb, pol)
    assert len(rep) == 6
    for key, plans in rep.items():
        assert plans["tape"].store == "stream" and \
            plans["tape"].hold_bytes == 0, key
        want = "emb_clipped_grad" if "#emb" in key else "fused_clip_grad"
        assert plans["grad"] == want, key
