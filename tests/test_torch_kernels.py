"""The port's kernel modules on the CPU against the JAX package's Pallas
kernels (run in interpret mode through ``repro.kernels.ops``, as
tests/test_kernel_parity.py runs them): the same numpy inputs, the odd and
stacked shapes of that file, f32 and bf16. On a CPU tensor each wrapper runs
its plain version; the CUDA kernels themselves are held to those plain
versions on the card by chip_smoke.py."""
import ctypes
import re
import shutil

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro.kernels import ref
from repro.models.rwkv6 import wkv6_chunked as jwkv6_chunked
from repro_torch.core import bk as tbk
from repro_torch.core import ghost
from repro_torch.core.policy import ParamGroup, PrivacyPolicy, resolve_policy
from repro_torch.kernels import build, design_study, syntax_check
from repro_torch.kernels import clipped_grad as cg_mod
from repro_torch.kernels import emb_grad as eg_mod
from repro_torch.kernels import emb_norm as en_mod
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import fused_clip as fc_mod
from repro_torch.kernels import ghost_norm as gn_mod
from repro_torch.kernels import grad_norm_direct as gd_mod
from repro_torch.kernels import moe_ghost as moe_mod
from repro_torch.kernels import wkv6 as wkv_mod
from repro_torch.kernels.clipped_grad import clipped_grad
from repro_torch.kernels.emb_grad import emb_clipped_grad
from repro_torch.kernels.emb_norm import emb_ghost_norm
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.fused_clip import fused_clip_grad
from repro_torch.kernels.ghost_norm import ghost_norm
from repro_torch.kernels.grad_norm_direct import grad_norm_direct
from repro_torch.kernels.moe_ghost import (moe_clipped_grad, moe_direct_norm,
                                           moe_ghost_norm)
from repro_torch.kernels.wkv6 import wkv6
from repro_torch.models.rwkv6 import wkv6_chunked

TOL = dict(rtol=1e-3, atol=1e-4)        # tests/test_kernel_parity.py:15
TOL_BF16 = dict(rtol=5e-2, atol=2e-2)   # tests/test_kernel_parity.py:18
MM_SHAPES = [(1, 2, 7, 5, 9), (1, 3, 33, 17, 23), (2, 2, 50, 24, 40),
             (3, 2, 64, 31, 13)]        # tests/test_kernel_parity.py:31-36
EMB_SHAPES = [(1, 2, 9, 6, 11), (2, 3, 33, 16, 50), (3, 2, 50, 24, 37)]
MOE_SHAPES = [(1, 2, 3, 5, 12, 20), (2, 2, 4, 7, 9, 13),
              (2, 3, 2, 16, 24, 8)]     # tests/test_kernel_parity.py:140
DTYPES = ["float32", "bfloat16"]
FLASH_SHAPES = [(1, 64, 64, 4, 2, 16),
                (2, 128, 128, 4, 4, 32)]   # tests/test_kernels.py:68-69
FLASH_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=3e-2, atol=3e-2)}  # test_kernels.py:78
WKV_SHAPES = [(1, 16, 2, 8), (2, 50, 3, 16),
              (1, 64, 2, 64)]              # tests/test_kernels.py:82
WKV_TOL = dict(rtol=2e-4, atol=2e-4)      # tests/test_kernels.py:93


def _np(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return x.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else x


def _pair(x):
    """numpy -> (jax array, torch CPU tensor) holding the same values."""
    t = torch.from_numpy(np.ascontiguousarray(x.astype(np.float32)))
    if x.dtype == ml_dtypes.bfloat16:
        t = t.to(torch.bfloat16)
    elif x.dtype == np.int32:
        t = torch.from_numpy(x)
    return jnp.asarray(x), t


def _tol(dtype):
    return TOL if dtype == "float32" else TOL_BF16


def _c(B):
    return (np.abs(np.random.default_rng(2).standard_normal(B)) + 0.1
            ).astype(np.float32)


@pytest.mark.parametrize("L,B,T,d,p", MM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_ghost_norm_matches_pallas(L, B, T, d, p, dtype):
    (ja, ta), (jd, td) = _pair(_np((L, B, T, d), dtype, 0)), \
        _pair(_np((L, B, T, p), dtype, 1))
    want = np.asarray(ops.ghost_norm_mm(ja, jd, block_t=16))
    np.testing.assert_allclose(ghost_norm(ta, td).numpy(), want,
                               **_tol(dtype))


@pytest.mark.parametrize("L,B,T,d,p", MM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_clipped_grad_matches_pallas(L, B, T, d, p, dtype):
    (ja, ta), (jd, td) = _pair(_np((L, B, T, d), dtype, 0)), \
        _pair(_np((L, B, T, p), dtype, 1))
    jc, tc = _pair(_c(B))
    want = np.asarray(ops.clipped_grad_mm(ja, jc, jd, block_d=16, block_p=16))
    got = clipped_grad(ta, tc, td)
    assert got.shape == (L, d, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))


@pytest.mark.parametrize("L,B,T,d,p", MM_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_grad_norm_direct_matches_pallas(L, B, T, d, p, dtype):
    (ja, ta), (jd, td) = _pair(_np((L, B, T, d), dtype, 0)), \
        _pair(_np((L, B, T, p), dtype, 1))
    want = np.asarray(ops.direct_norm_mm(ja, jd, block_d=16, block_p=16))
    np.testing.assert_allclose(grad_norm_direct(ta, td).numpy(), want,
                               **_tol(dtype))


def _moe(L, B, E, C, d, p, dtype):
    """-> (jax rec, jax ds), (torch a, mask, ds); a third of the slots
    masked off."""
    (ja, ta), (jd, td) = _pair(_np((L, B, E, C, d), dtype, 0)), \
        _pair(_np((L, B, E, C, p), dtype, 1))
    mask = (np.random.default_rng(4).random((L, B, E, C)) > 0.3).astype(
        np.float32)
    jm, tm = _pair(mask)
    return ({"a": ja, "mask": jm}, jd), (ta, tm, td)


@pytest.mark.parametrize("L,B,E,C,d,p", MOE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_ghost_norm_matches_pallas(L, B, E, C, d, p, dtype):
    (jrec, jd), (ta, tm, td) = _moe(L, B, E, C, d, p, dtype)
    want = np.asarray(ops.ghost_norm_moe(jrec, jd))
    np.testing.assert_allclose(moe_ghost_norm(ta, tm, td).numpy(), want,
                               **_tol(dtype))


@pytest.mark.parametrize("L,B,E,C,d,p", MOE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_direct_norm_matches_pallas(L, B, E, C, d, p, dtype):
    (jrec, jd), (ta, tm, td) = _moe(L, B, E, C, d, p, dtype)
    want = np.asarray(ops.direct_norm_moe(jrec, jd, block_d=8, block_p=8))
    np.testing.assert_allclose(moe_direct_norm(ta, tm, td).numpy(), want,
                               **_tol(dtype))


@pytest.mark.parametrize("L,B,E,C,d,p", MOE_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_moe_clipped_grad_matches_pallas(L, B, E, C, d, p, dtype):
    (jrec, jd), (ta, tm, td) = _moe(L, B, E, C, d, p, dtype)
    jc, tc = _pair(_c(B))
    want = np.asarray(ops.clipped_grad_moe(jrec, jc, jd, block_d=8,
                                           block_p=8))
    got = moe_clipped_grad(ta, tm, tc, td)
    assert got.shape == (L, E, d, p) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))


def test_moe_unstacked_records_equal_stacked():
    _, (a, m, ds) = _moe(1, 2, 3, 5, 12, 20, "float32")
    C = torch.tensor([0.5, 1.5])
    for fn in (moe_ghost_norm, moe_direct_norm):
        torch.testing.assert_close(fn(a[0], m[0], ds[0]), fn(a, m, ds))
    torch.testing.assert_close(moe_clipped_grad(a[0], m[0], C, ds[0]),
                               moe_clipped_grad(a, m, C, ds)[0])


@pytest.mark.parametrize("L,B,T,d,V", EMB_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_emb_ghost_norm_matches_pallas(L, B, T, d, V, dtype):
    ids = np.random.default_rng(3).integers(0, V, (L, B, T)).astype(np.int32)
    (ji, ti), (jd, td) = _pair(ids), _pair(_np((L, B, T, d), dtype, 1))
    want = np.asarray(ops.ghost_norm_emb(ji, jd, block_t=16))
    np.testing.assert_allclose(emb_ghost_norm(ti, td).numpy(), want,
                               **_tol(dtype))


def _moe_mask(kind, L, B, E, C):
    """A slot mask: 'binary' (0/1, a third off), with an expert no sample
    reached and a sample with no kept slot (all-empty items); 'general'
    (non-binary: 0, or in [0.5, 2)) with the same empty items."""
    rng = np.random.default_rng(5)
    m = rng.random((L, B, E, C))
    m = (m > 0.3).astype(np.float32) if kind == "binary" else \
        np.where(m < 0.25, 0.0, 0.5 + 1.5 * m).astype(np.float32)
    m[:, :, 0] = 0.0
    m[:, 1] = 0.0
    return m


@pytest.mark.parametrize("C", [60, 64, 130])
@pytest.mark.parametrize("kind", ["binary", "general"])
def test_moe_ghost_model_matches_pallas(C, kind):
    """The wgmma kernel's form of the MoE ghost norm (64-slot tile pairs,
    the mask weighting the unmasked Grams' entries by (m_i m_j)^2; float64)
    against the Pallas kernel, which masks the records first: one tile
    (C = 60, 64) and three (C = 130: off-diagonal pairs), 0/1 and
    non-binary masks, all-empty items. f32 inputs; the Pallas sums are f32
    (rtol 1e-5, atol 1e-6 of the norms' scale)."""
    L, B, E, d, p = 2, 3, 3, 24, 40
    mask = _moe_mask(kind, L, B, E, C)
    a, ds = _np((L, B, E, C, d), "float32", 0), _np((L, B, E, C, p),
                                                   "float32", 1)
    want = np.asarray(ops.ghost_norm_moe({"a": jnp.asarray(a),
                                          "mask": jnp.asarray(mask)},
                                         jnp.asarray(ds)))
    got = moe_mod.ghost_model(torch.from_numpy(a), torch.from_numpy(mask),
                              torch.from_numpy(ds))
    assert got.dtype == torch.float64 and got.shape == (B,)
    assert float(got[1]) == 0.0 and want[1] == 0.0   # no kept slot
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))
    # the port's plain version (masked records, f32) agrees as well
    plain = ghost.sq_norm_moe_ghost(torch.from_numpy(a),
                                    torch.from_numpy(mask),
                                    torch.from_numpy(ds))
    np.testing.assert_allclose(plain.numpy(), got.numpy(), rtol=1e-5,
                               atol=1e-6 * float(np.abs(want).max()))


@pytest.mark.parametrize("case", ["4 values", "-1 and >= V", "one id"])
@pytest.mark.parametrize("stacked", [True, False])
def test_emb_run_model_matches_pallas(case, stacked):
    """The run-sum form of the embedding norm (each run of equal ids summed
    in t order, its squared norm added; float64) against the Pallas kernel's
    id-masked Gram: heavy duplicates (ids of 4 values), ids -1 and >= V
    (compared by value, not dropped), one id at every position. f32
    inputs; the Pallas sums are f32 (rtol 1e-5)."""
    L, B, T, d, V = 2, 3, 50, 24, 37
    rng = np.random.default_rng(7)
    if case == "4 values":
        ids = rng.integers(0, 4, (L, B, T)) * 9
    elif case == "-1 and >= V":
        ids = rng.integers(0, V, (L, B, T))
        ids[..., ::7] = -1
        ids[..., 3::11] = V + 5
    else:
        ids = np.full((L, B, T), 3)
    ids = ids.astype(np.int32)
    ds = _np((L, B, T, d), "float32", 1)
    if not stacked:
        ids, ds = ids[0], ds[0]
    want = np.asarray(ops.ghost_norm_emb(jnp.asarray(ids), jnp.asarray(ds),
                                         block_t=16))
    got = en_mod.run_model(torch.from_numpy(ids), torch.from_numpy(ds))
    assert got.dtype == torch.float64 and got.shape == (B,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5)
    np.testing.assert_allclose(
        emb_ghost_norm(torch.from_numpy(ids), torch.from_numpy(ds)).numpy(),
        got.numpy(), rtol=1e-5)


@pytest.mark.parametrize("L,B,T,d,V", EMB_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_emb_clipped_grad_matches_pallas(L, B, T, d, V, dtype):
    ids = np.random.default_rng(3).integers(0, V, (L, B, T)).astype(np.int32)
    (ji, ti), (jd, td) = _pair(ids), _pair(_np((L, B, T, d), dtype, 1))
    jc, tc = _pair(_c(B))
    want = np.asarray(ops.clipped_grad_emb(ji, jc, jd, V, block_v=16))
    got = emb_clipped_grad(ti, tc, td, V)
    assert got.shape == (L, V, d) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, **_tol(dtype))


def test_emb_clipped_grad_drops_out_of_range_ids():
    """Ids outside [0, V) match no row (the stacked JAX kernel's rule)."""
    L, B, T, d, V = 2, 2, 5, 4, 4
    ids = np.array([[[0, 4, 1, -1, 2]] * B, [[1, 2, 0, 3, 4]] * B], np.int32)
    (ji, ti), (jd, td) = _pair(ids), _pair(_np((L, B, T, d), "float32", 1))
    jc, tc = _pair(np.ones(B, np.float32))
    want = np.asarray(ops.clipped_grad_emb(ji, jc, jd, V, block_v=4))
    np.testing.assert_allclose(emb_clipped_grad(ti, tc, td, V).numpy(), want,
                               **TOL)


def test_unstacked_records_equal_stacked():
    a = torch.randn(1, 2, 33, 17, generator=torch.Generator().manual_seed(0))
    ds = torch.randn(1, 2, 33, 23, generator=torch.Generator().manual_seed(1))
    C = torch.tensor([0.5, 1.5])
    torch.testing.assert_close(ghost_norm(a[0], ds[0]), ghost_norm(a, ds))
    torch.testing.assert_close(clipped_grad(a[0], C, ds[0]),
                               clipped_grad(a, C, ds)[0])


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


@pytest.mark.parametrize("call", [
    lambda: ghost_norm(_meta(2, 3, 4), _meta(2, 3, 5)),
    lambda: fused_clip_grad(_meta(2, 3, 4), _meta(2, 3, 5), _meta(2),
                            "automatic", 1.0, 0.01),
    lambda: clipped_grad(_meta(2, 3, 4), _meta(2), _meta(2, 3, 5)),
    lambda: emb_ghost_norm(_meta(2, 3, dtype=torch.int32), _meta(2, 3, 4)),
    lambda: emb_clipped_grad(_meta(2, 3, dtype=torch.int32), _meta(2),
                             _meta(2, 3, 4), 7),
    lambda: grad_norm_direct(_meta(2, 3, 4), _meta(2, 3, 5)),
    lambda: moe_ghost_norm(_meta(2, 3, 4, 5), _meta(2, 3, 4),
                           _meta(2, 3, 4, 6)),
    lambda: moe_direct_norm(_meta(2, 3, 4, 5), _meta(2, 3, 4),
                            _meta(2, 3, 4, 6)),
    lambda: moe_clipped_grad(_meta(2, 3, 4, 5), _meta(2, 3, 4), _meta(2),
                             _meta(2, 3, 4, 6)),
    lambda: flash_attention(_meta(2, 3, 4, 8), _meta(2, 3, 2, 8),
                            _meta(2, 3, 2, 8)),
    # bf16 inputs that the wgmma routes take
    lambda: ghost_norm(_meta(2, 3, 8, dtype=torch.bfloat16),
                       _meta(2, 3, 16, dtype=torch.bfloat16)),
    lambda: ghost_norm(_meta(2, 2, 3, 64, dtype=torch.bfloat16),
                       _meta(2, 2, 3, 128, dtype=torch.bfloat16)),
    lambda: clipped_grad(_meta(2, 3, 8, dtype=torch.bfloat16), _meta(2),
                         _meta(2, 3, 16, dtype=torch.bfloat16)),
    lambda: clipped_grad(_meta(2, 2, 3, 64, dtype=torch.bfloat16), _meta(2),
                         _meta(2, 2, 3, 128, dtype=torch.bfloat16)),
    lambda: flash_attention(*(_meta(2, 3, 4, 128, dtype=torch.bfloat16),
                              _meta(2, 3, 2, 128, dtype=torch.bfloat16),
                              _meta(2, 3, 2, 128, dtype=torch.bfloat16))),
    lambda: flash_attention(*(_meta(2, 3, 4, 64, dtype=torch.bfloat16),
                              _meta(2, 3, 2, 64, dtype=torch.bfloat16),
                              _meta(2, 3, 2, 64, dtype=torch.bfloat16)),
                            causal=False),
    lambda: moe_direct_norm(_meta(2, 3, 4, 8, dtype=torch.bfloat16),
                            _meta(2, 3, 4),
                            _meta(2, 3, 4, 16, dtype=torch.bfloat16)),
    lambda: moe_ghost_norm(_meta(2, 3, 4, 8, dtype=torch.bfloat16),
                           _meta(2, 3, 4),
                           _meta(2, 3, 4, 16, dtype=torch.bfloat16)),
    lambda: emb_ghost_norm(_meta(2, 3, 4, dtype=torch.int32),
                           _meta(2, 3, 4, 8, dtype=torch.bfloat16)),
    lambda: moe_clipped_grad(_meta(2, 3, 4, 8, dtype=torch.bfloat16),
                             _meta(2, 3, 4), _meta(2),
                             _meta(2, 3, 4, 16, dtype=torch.bfloat16)),
    lambda: wkv6(*(_meta(2, 3, 4, 8),) * 4, _meta(4, 8)),
    # the inputs that the chunked and wgmma routes take, and those routes
    # forced
    lambda: wkv6(*(_meta(2, 3, 4, 64, dtype=torch.bfloat16),) * 4,
                 _meta(4, 64)),
    lambda: wkv6(*(_meta(2, 3, 4, 64),) * 4, _meta(4, 64), kernel="chunked"),
    lambda: grad_norm_direct(_meta(2, 2, 3, 64, dtype=torch.bfloat16),
                             _meta(2, 2, 3, 128, dtype=torch.bfloat16)),
    lambda: grad_norm_direct(_meta(2, 3, 64, dtype=torch.bfloat16),
                             _meta(2, 3, 128, dtype=torch.bfloat16),
                             kernel="wgmma"),
    lambda: fused_clip_grad(_meta(2, 2, 3, 64, dtype=torch.bfloat16),
                            _meta(2, 2, 3, 128, dtype=torch.bfloat16),
                            _meta(2), "abadi", 1.0, 0.01),
    lambda: fused_clip_grad(_meta(2, 3, 64, dtype=torch.bfloat16),
                            _meta(2, 3, 128, dtype=torch.bfloat16),
                            _meta(2), "flat", 1.0, 0.01, kernel="wgmma"),
    lambda: fused_clip_grad(_meta(2, 3, 64, dtype=torch.bfloat16),
                            _meta(2, 3, 128, dtype=torch.bfloat16),
                            _meta(2), "normalize", 1.0, 0.01, kernel="simt"),
])
def test_wrappers_take_the_plain_version_only_on_cpu(call):
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper validates it for its kernel and refuses what is not CUDA."""
    with pytest.raises(ValueError, match="CUDA device"):
        call()


def test_unported_direct_norm_raises_off_cpu():
    """A direct-norm plan with the mixopt cache off now reaches the
    grad_norm_direct wrapper (which refuses a tensor that is neither CPU nor
    CUDA); scope='layer' (once unported too) resolves to one unit per
    path."""
    a, ds = _meta(2, 3, 40, 4), _meta(2, 3, 40, 5)   # 2T^2 >= pd: direct
    with pytest.raises(ValueError, match="grad_norm_direct.*CUDA device"):
        tbk.record_sq_norm("blocks/x#mm.s", a, ds, "bk-mixghost", True)
    # the same plan on the CPU runs the plain direct norm
    a = torch.randn(2, 3, 40, 4)
    ds = torch.randn(2, 3, 40, 5)
    n, cached = tbk.record_sq_norm("blocks/x#mm.s", a, ds, "bk-mixghost", True)
    assert n.shape == (3,) and cached is None
    torch.testing.assert_close(n, ghost.sq_norm_mm_direct(a, ds))
    # scope='layer' resolves now: one unit per path, for fused_clip_grad
    res = resolve_policy(PrivacyPolicy((ParamGroup("all", ".*",
                                                   scope="layer"),)),
                         ["blocks/x/w", "head/w"])
    assert [u.paths for u in res.units] == [("blocks/x/w",), ("head/w",)]


@pytest.mark.parametrize("kind,a_shape,ds_shape,mode,method,want", [
    # qwen2-1.5b, 28 layers, B=8, T=512: 2T^2 < pd, ghost
    ("mm", (28, 8, 512, 1536), (28, 8, 512, 2048), "bk-mixopt", "", "ghost"),
    # the same at B=2, T=2048: direct, and 28*2*1536*2048 > 2^24, no cache
    ("mm", (28, 2, 2048, 1536), (28, 2, 2048, 2048), "bk-mixopt", "",
     "direct"),
    # deepseek-moe router (2048->64), 5 stacked layers: direct, cached
    ("mm", (5, 8, 512, 2048), (5, 8, 512, 64), "bk-mixopt", "", "cache"),
    # the cache is bk-mixopt's alone; mode 'bk' forces ghost
    ("mm", (5, 8, 512, 2048), (5, 8, 512, 64), "bk-mixghost", "", "direct"),
    ("mm", (5, 8, 512, 2048), (5, 8, 512, 64), "bk", "", "ghost"),
    # unstacked, and a group override that wins over the rule
    ("mm", (8, 512, 2048), (8, 512, 64), "bk-mixopt", "", "cache"),
    ("mm", (8, 512, 2048), (8, 512, 6144), "bk-mixopt", "direct", "direct"),
    # MoE experts: C=60 slots, ghost by the rule, direct by override (no
    # cache for moe taps)
    ("moe", (5, 8, 64, 60, 2048), (5, 8, 64, 60, 2816), "bk-mixopt", "",
     "ghost"),
    ("moe", (5, 8, 64, 60, 2048), (5, 8, 64, 60, 2816), "bk-mixopt",
     "direct", "direct"),
])
def test_norm_route(kind, a_shape, ds_shape, mode, method, want):
    """The route record_sq_norm takes for a tap, at the train paths' shapes."""
    assert tbk.norm_route(kind, a_shape, ds_shape, mode, method) == want


# ------------------------------------------------------- serving kernels
def _flash_inputs(B, T, S, H, K, h, dtype):
    return [_pair(_np(shape, dtype, i)) for i, shape in
            enumerate(((B, T, H, h), (B, S, K, h), (B, S, K, h)))]


def _f32(x):
    return np.asarray(x.float() if isinstance(x, torch.Tensor) else x,
                      np.float32)


@pytest.mark.parametrize("B,T,S,H,K,h", FLASH_SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", DTYPES)
def test_flash_attention_matches_pallas(B, T, S, H, K, h, causal, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(B, T, S, H, K, h, dtype)
    got = flash_attention(tq, tk, tv, causal=causal)
    assert got.shape == (B, T, H, h) and got.dtype == tq.dtype
    for want in (ops.flash_attention(jq, jk, jv, causal=causal, block_q=32,
                                     block_k=32),
                 ref.flash_attention_ref(jq, jk, jv, causal=causal)):
        np.testing.assert_allclose(_f32(got), _f32(want), **FLASH_TOL[dtype])


@pytest.mark.parametrize("B,T,S,H,K,h", [(2, 37, 37, 6, 1, 24),
                                         (1, 50, 61, 4, 2, 16),
                                         (1, 61, 50, 6, 6, 8)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_ragged_matches_ref(B, T, S, H, K, h, causal):
    """T, S not block multiples (the Pallas kernel asserts them; the port's
    prefill takes any prompt length): against the JAX oracle."""
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(B, T, S, H, K, h, "float32")
    np.testing.assert_allclose(
        flash_attention(tq, tk, tv, causal=causal).numpy(),
        np.asarray(ref.flash_attention_ref(jq, jk, jv, causal=causal)),
        **FLASH_TOL["float32"])


def _wkv_inputs(B, T, H, h, w=None):
    """r, k, v standard normal, w uniform in [0.5, 0.999] (the JAX kernel
    test's range) or the constant ``w``, u normal * 0.5 -> [(jax, torch)]."""
    rng = np.random.default_rng(0)
    x = [rng.standard_normal((B, T, H, h)).astype(np.float32)
         for _ in range(3)]
    x.append(rng.uniform(0.5, 0.999, (B, T, H, h)).astype(np.float32)
             if w is None else np.full((B, T, H, h), w, np.float32))
    x.append((rng.standard_normal((H, h)) * 0.5).astype(np.float32))
    return [_pair(a) for a in x]


@pytest.mark.parametrize("B,T,H,h", WKV_SHAPES)
def test_wkv6_matches_pallas_and_the_chunked_forms(B, T, H, h):
    pairs = _wkv_inputs(B, T, H, h)
    j, t = [p[0] for p in pairs], [p[1] for p in pairs]
    got = wkv6(*t)
    assert got.shape == (B, T, H, h) and got.dtype == torch.float32
    for want in (ref.wkv6_ref(*j), ops.wkv6(*j, chunk=16),
                 jwkv6_chunked(*j, chunk=32)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **WKV_TOL)
    # the port's chunked form is the JAX package's, step for step
    np.testing.assert_allclose(wkv6_chunked(*t, chunk=16).numpy(),
                               np.asarray(jwkv6_chunked(*j, chunk=16)),
                               **WKV_TOL)


@pytest.mark.parametrize("w", [0.1, 0.01])
def test_wkv6_strong_decay_matches_the_recurrence(w):
    """Constant strong decay, where the chunked forms' k / P underflows f32:
    the port's wkv6 is the recurrence (JAX's ``wkv6_ref``)."""
    pairs = _wkv_inputs(1, 64, 2, 64, w=w)
    j, t = [p[0] for p in pairs], [p[1] for p in pairs]
    np.testing.assert_allclose(wkv6(*t).numpy(), np.asarray(ref.wkv6_ref(*j)),
                               **WKV_TOL)


def _decay(shape, w, seed=1):
    """w: the constant ``w``, or 'mixed': log-uniform in [1e-6, 1] per
    element, 5% of them exactly 0 and 5% exactly 1 (float64)."""
    if w != "mixed":
        return np.full(shape, w)
    rng = np.random.default_rng(seed)
    x = np.exp(rng.uniform(np.log(1e-6), 0.0, shape))
    m = rng.uniform(size=shape)
    return np.where(m < 0.05, 0.0, np.where(m > 0.95, 1.0, x))


@pytest.mark.parametrize("chunk,sub", [(32, 16), (64, 16)])
@pytest.mark.parametrize("w", [None, 0.1, 0.01, "mixed"])
@pytest.mark.parametrize("B,T,H,h", WKV_SHAPES + [(2, 130, 2, 16)])
def test_wkv6_chunked_model_is_the_recurrence(B, T, H, h, w, chunk, sub):
    """The chunked kernel's decomposition (``kernels.wkv6.chunked_model``),
    run in float64, against JAX's ``wkv6_ref``: under the JAX kernel test's
    decay, the strong constant ones, and log-uniform decays with exact
    zeros and ones, at T below, at and not a multiple of the chunk."""
    pairs = _wkv_inputs(B, T, H, h, w=None if w == "mixed" else w)
    j = [p[0] for p in pairs]
    if w == "mixed":
        j[3] = jnp.asarray(_decay((B, T, H, h), w).astype(np.float32))
    x64 = [torch.from_numpy(np.asarray(a, np.float64)) for a in j]
    got = wkv_mod.chunked_model(*x64, chunk=chunk, sub=sub)
    assert got.shape == (B, T, H, h) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), np.asarray(ref.wkv6_ref(*j)),
                               **WKV_TOL)


# ------------------------------------------------- the tensor-core routes
@pytest.mark.parametrize("dtype,d,p,want", [
    # the mm taps of the train paths: qwen2-1.5b (qkv, o, gate+up, down,
    # head) and deepseek-moe-16b (dense and shared widths, head)
    (torch.bfloat16, 1536, 2048, "wgmma"),
    (torch.bfloat16, 1536, 1536, "wgmma"),
    (torch.bfloat16, 1536, 17920, "wgmma"),
    (torch.bfloat16, 8960, 1536, "wgmma"),
    (torch.bfloat16, 1536, 151936, "wgmma"),
    (torch.bfloat16, 2048, 2816, "wgmma"),
    (torch.bfloat16, 1408, 2048, "wgmma"),
    (torch.bfloat16, 2048, 102400, "wgmma"),
    (torch.bfloat16, 136, 264, "wgmma"),      # multiples of 8, of no tile
    # unaligned widths and f32 records keep the SIMT kernel
    (torch.bfloat16, 37, 53, "simt"),
    (torch.bfloat16, 1536, 2044, "simt"),
    (torch.bfloat16, 1532, 2048, "simt"),
    (torch.float32, 1536, 2048, "simt"),
    (torch.float32, 165, 301, "simt"),
])
def test_clipped_grad_route(dtype, d, p, want):
    assert cg_mod.route(dtype, d, p) == want


@pytest.mark.parametrize("dtype,d,p,want", [
    # the ghost-norm taps of the train paths: qwen2-1.5b (qkv, o, gate+up,
    # down, head) and deepseek-moe-16b (qkv, dense gate+up and down, shared
    # gate+up and down, head)
    (torch.bfloat16, 1536, 2048, "wgmma"),
    (torch.bfloat16, 1536, 1536, "wgmma"),
    (torch.bfloat16, 1536, 17920, "wgmma"),
    (torch.bfloat16, 8960, 1536, "wgmma"),
    (torch.bfloat16, 1536, 151936, "wgmma"),
    (torch.bfloat16, 2048, 6144, "wgmma"),
    (torch.bfloat16, 2048, 21888, "wgmma"),
    (torch.bfloat16, 10944, 2048, "wgmma"),
    (torch.bfloat16, 2048, 5632, "wgmma"),
    (torch.bfloat16, 2816, 2048, "wgmma"),
    (torch.bfloat16, 2048, 102400, "wgmma"),
    (torch.bfloat16, 136, 264, "wgmma"),      # multiples of 8, of no tile
    (torch.bfloat16, 8, 8, "wgmma"),
    # unaligned widths and f32 records (every parity step) keep the SIMT
    # kernel
    (torch.bfloat16, 37, 53, "simt"),
    (torch.bfloat16, 1536, 2044, "simt"),
    (torch.bfloat16, 1532, 2048, "simt"),
    (torch.float32, 1536, 2048, "simt"),
    (torch.float32, 165, 301, "simt"),
    (torch.float32, 32, 64, "simt"),
])
def test_ghost_norm_route(dtype, d, p, want):
    assert gn_mod.route(dtype, d, p) == want


@pytest.mark.parametrize("dtype,h,want", [
    (torch.bfloat16, 128, "wgmma"),    # qwen2-1.5b's prefill
    (torch.bfloat16, 64, "wgmma"),
    (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 96, "simt"),
    (torch.float32, 128, "simt"),      # the f32 parity prefill
    (torch.float32, 64, "simt"),
    (torch.float32, 16, "simt"),
])
def test_flash_attention_route(dtype, h, want):
    assert fa_mod.route(dtype, h) == want


@pytest.mark.parametrize("dtype,d,p,want", [
    # deepseek-moe-16b's expert taps: up (d_model -> 2 moe_d_ff), down
    (torch.bfloat16, 2048, 2816, "wgmma"),
    (torch.bfloat16, 1408, 2048, "wgmma"),
    (torch.bfloat16, 136, 264, "wgmma"),      # multiples of 8, of no tile
    (torch.bfloat16, 8, 8, "wgmma"),
    # unaligned widths and f32 records keep the SIMT kernels
    (torch.bfloat16, 37, 53, "simt"),
    (torch.bfloat16, 2048, 2812, "simt"),
    (torch.bfloat16, 1404, 2048, "simt"),
    (torch.float32, 2048, 2816, "simt"),
    (torch.float32, 165, 301, "simt"),
])
def test_moe_route(dtype, d, p, want):
    assert moe_mod.route(dtype, d, p) == want
    assert moe_mod.route(dtype, d, p, aligned=False) == "simt"


@pytest.mark.parametrize("dtype,d,p,want", [
    # the direct-norm taps of train_long and train_tape: qwen2-1.5b's qkv
    # and o at T=2048
    (torch.bfloat16, 1536, 2048, "wgmma"),
    (torch.bfloat16, 1536, 1536, "wgmma"),
    (torch.bfloat16, 136, 264, "wgmma"),      # multiples of 8, of no tile
    (torch.bfloat16, 8, 8, "wgmma"),
    # unaligned widths and f32 records (parity_long) keep the SIMT kernel
    (torch.bfloat16, 37, 53, "simt"),
    (torch.bfloat16, 1536, 2044, "simt"),
    (torch.bfloat16, 1532, 2048, "simt"),
    (torch.float32, 1536, 2048, "simt"),
    (torch.float32, 165, 301, "simt"),
])
def test_grad_norm_direct_route(dtype, d, p, want):
    assert gd_mod.route(dtype, d, p) == want
    assert gd_mod.route(dtype, d, p, aligned=False) == "simt"


@pytest.mark.parametrize("dtype,h,want", [
    (torch.bfloat16, 64, "chunked"),   # rwkv6-3b's prefill
    (torch.float32, 64, "chunked"),    # the f32 parity prefill
    (torch.bfloat16, 16, "chunked"),
    (torch.float32, 48, "chunked"),
    (torch.bfloat16, 128, "chunked"),
    (torch.float32, 128, "chunked"),
    # other head sizes keep the scan kernel
    (torch.bfloat16, 8, "scan"),
    (torch.float32, 40, "scan"),
    (torch.bfloat16, 72, "scan"),
    (torch.float32, 127, "scan"),
])
def test_wkv6_route(dtype, h, want):
    assert wkv_mod.route(dtype, h) == want
    assert wkv_mod.route(dtype, h, aligned=False) == "scan"


class _FakeLib:
    """Stands in for the kernel library: records each launching C entry's
    name and argument count (and the last call's arguments) and returns
    success; a sizing entry (``_nparts``, ``_bytes``, ``_ints``, ``_split``)
    returns ``sizes.get(name, 1)`` and is recorded in ``asked`` with its
    arguments."""

    SIZING = ("_nparts", "_bytes", "_ints", "_split")

    def __init__(self):
        self.calls = []
        self.last_args = ()
        self.sizes = {}
        self.asked = []

    def __getattr__(self, name):
        if not name.startswith("dp_"):
            raise AttributeError(name)
        if name.endswith(self.SIZING):
            def size(*args):
                self.asked.append((name, args))
                return self.sizes.get(name, 1)
            return size

        def call(*args):
            self.calls.append((name, len(args)))
            self.last_args = args
            return 0
        return call


@pytest.fixture
def fake_lib(monkeypatch):
    """Wrappers on meta tensors reach a fake library: the routing, the
    checks and the launch counts run as on the card."""
    lib = _FakeLib()
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(build, "check_inputs",
                        lambda name, floats, ints=(), f32=():
                        floats[0].dtype == torch.bfloat16)
    return lib


@pytest.mark.parametrize("dtype,d,p,kernel,entry", [
    (torch.bfloat16, 64, 128, None, "dp_clipped_grad_wgmma"),
    (torch.bfloat16, 37, 53, None, "dp_clipped_grad"),
    (torch.float32, 64, 128, None, "dp_clipped_grad"),
    (torch.bfloat16, 64, 128, "simt", "dp_clipped_grad"),
])
def test_clipped_grad_launches_its_route(fake_lib, dtype, d, p, kernel,
                                         entry):
    """The wrapper launches the C entry its route names, with the argument
    count of its signature, and counts every launch and the wgmma ones."""
    n0, w0 = clipped_grad.launches, clipped_grad.wgmma_launches
    out = clipped_grad(_meta(2, 3, 5, d, dtype=dtype), _meta(3),
                       _meta(2, 3, 5, p, dtype=dtype), kernel=kernel)
    assert out.shape == (2, d, p) and out.dtype == torch.float32
    assert fake_lib.calls == [(entry, len(build.SIGNATURES[entry]))]
    assert clipped_grad.launches == n0 + 1
    assert clipped_grad.wgmma_launches == w0 + (entry.endswith("wgmma"))


@pytest.fixture
def empty_shapes(monkeypatch):
    """The shapes of the tensors that ``torch.empty`` makes from here on (a
    wrapper's outputs and scratch)."""
    shapes, real = [], torch.empty

    def spy(*size, **kw):
        t = real(*size, **kw)
        shapes.append((tuple(t.shape), t.dtype))
        return t
    monkeypatch.setattr(torch, "empty", spy)
    return shapes


@pytest.mark.parametrize("dtype,d,p,kernel,entry", [
    (torch.bfloat16, 1536, 151936, None, "dp_ghost_norm_wgmma"),
    (torch.bfloat16, 136, 264, None, "dp_ghost_norm_wgmma"),
    (torch.bfloat16, 37, 53, None, "dp_ghost_norm"),
    (torch.float32, 64, 128, None, "dp_ghost_norm"),
    (torch.bfloat16, 64, 128, "simt", "dp_ghost_norm"),
])
@pytest.mark.parametrize("stacked", [True, False])
def test_ghost_norm_launches_its_route(fake_lib, empty_shapes, dtype, d, p,
                                       kernel, entry, stacked):
    """The wrapper launches the C entry its route names, with the argument
    count of its signature and the records' (L, B, T, d, p), sizes the
    partial sums as the C side asks (the wgmma kernel's count holds its
    split of the wider record: 640 is the head of ``train``, L=1, B=8,
    T=512, split 8 ways), and counts every launch and the wgmma ones;
    unstacked records launch as L = 1."""
    L, B, T = 2, 8, 512
    lead = (L,) if stacked else ()
    a, ds = (_meta(*lead, B, T, w, dtype=dtype) for w in (d, p))
    nparts = f"{entry}_nparts"
    fake_lib.sizes[nparts] = 640
    n0, w0 = ghost_norm.launches, ghost_norm.wgmma_launches
    out = ghost_norm(a, ds, kernel=kernel)
    L1 = L if stacked else 1
    assert out.shape == (B,) and out.dtype == torch.float32
    assert fake_lib.calls == [(entry, len(build.SIGNATURES[entry]))]
    wgmma = entry.endswith("wgmma")
    assert fake_lib.asked == [(nparts, (L1, B, T, d, p) if wgmma else (T,))]
    assert ((B, 640 if wgmma else L1 * 640), torch.float32) in empty_shapes
    # the pointers (0 on meta tensors), then L, B, T, d, p (and the SIMT
    # kernel's bf16 flag), then the stream
    dims = fake_lib.last_args[4:9]
    assert list(dims) == [L1, B, T, d, p]
    assert ghost_norm.launches == n0 + 1
    assert ghost_norm.wgmma_launches == w0 + wgmma


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stacked", [True, False])
def test_emb_clipped_grad_passes_the_scratch_the_c_side_asks_for(
        fake_lib, empty_shapes, monkeypatch, dtype, stacked):
    """The wrapper asks the C side for the pre-pass's shared memory and the
    scratch's int32 elements a layer (by vocabulary), holds a scratch of L
    of those, and makes one call of the C side with (L, B, T, d, V, bf16);
    unstacked ids launch as L = 1 into a (V, d) output, with no view in
    between."""
    monkeypatch.setattr(eg_mod, "_SCRATCH", {})
    L, B, T, d, V = 3, 8, 512, 1536, 151936
    lead = (L,) if stacked else ()
    fake_lib.sizes["dp_emb_grad_scratch_ints"] = 4748
    fake_lib.sizes["dp_emb_grad_smem_bytes"] = eg_mod.MAX_SMEM_BYTES
    n0 = emb_clipped_grad.launches
    out = emb_clipped_grad(_meta(*lead, B, T, dtype=torch.int32), _meta(B),
                           _meta(*lead, B, T, d, dtype=dtype), V)
    L1 = L if stacked else 1
    assert out.shape == (*lead, V, d) and out.dtype == torch.float32
    assert sorted(n for n, _ in fake_lib.asked) == [
        "dp_emb_grad_scratch_ints", "dp_emb_grad_smem_bytes"]
    assert all(args == (V,) for _, args in fake_lib.asked)
    assert ((L1 * 4748,), torch.int32) in empty_shapes
    assert fake_lib.calls == [("dp_emb_grad",
                               len(build.SIGNATURES["dp_emb_grad"]))]
    assert list(fake_lib.last_args[5:11]) == [L1, B, T, d, V,
                                              int(dtype == torch.bfloat16)]
    assert emb_clipped_grad.launches == n0 + 1


def test_emb_clipped_grad_keeps_its_scratch(fake_lib, empty_shapes,
                                            monkeypatch):
    """One scratch serves the calls on a stream: a second call of the same
    size allocates only its output, a call with more layers a larger
    scratch."""
    monkeypatch.setattr(eg_mod, "_SCRATCH", {})
    fake_lib.sizes["dp_emb_grad_scratch_ints"] = 10

    args = {L: (_meta(L, 2, 5, dtype=torch.int32), _meta(2),
                _meta(L, 2, 5, 4, dtype=torch.bfloat16), 300) for L in (2, 3)}
    empty_shapes.clear()
    for L in (2, 2, 3):
        emb_clipped_grad(*args[L])
    scratch = [s for s, dt in empty_shapes if dt == torch.int32]
    assert scratch == [(20,), (30,)]
    assert len(fake_lib.calls) == 3


def test_emb_clipped_grad_raises_past_its_shared_memory(fake_lib):
    """A vocabulary whose bitmap the pre-pass cannot hold in one block is
    refused before anything is allocated or launched."""
    fake_lib.sizes["dp_emb_grad_smem_bytes"] = eg_mod.MAX_SMEM_BYTES + 4
    with pytest.raises(ValueError, match="shared memory"):
        emb_clipped_grad(_meta(8, 512, dtype=torch.int32), _meta(8),
                         _meta(8, 512, 64, dtype=torch.bfloat16), 1 << 21)
    assert fake_lib.calls == []


@pytest.mark.parametrize("dtype,h,kernel,entry", [
    (torch.bfloat16, 128, None, "dp_flash_attention_wgmma"),
    (torch.bfloat16, 64, None, "dp_flash_attention_wgmma"),
    (torch.bfloat16, 16, None, "dp_flash_attention"),
    (torch.float32, 128, None, "dp_flash_attention"),
    (torch.bfloat16, 128, "simt", "dp_flash_attention"),
])
def test_flash_attention_launches_its_route(fake_lib, dtype, h, kernel,
                                            entry):
    n0, w0 = flash_attention.launches, flash_attention.wgmma_launches
    out = flash_attention(_meta(2, 5, 6, h, dtype=dtype),
                          _meta(2, 5, 2, h, dtype=dtype),
                          _meta(2, 5, 2, h, dtype=dtype), kernel=kernel)
    assert out.shape == (2, 5, 6, h) and out.dtype == dtype
    assert fake_lib.calls == [(entry, len(build.SIGNATURES[entry]))]
    assert flash_attention.launches == n0 + 1
    assert flash_attention.wgmma_launches == w0 + (entry.endswith("wgmma"))


@pytest.mark.parametrize("dtype,d,p,kernel,entry", [
    (torch.bfloat16, 2048, 2816, None, "wgmma"),
    (torch.bfloat16, 136, 264, None, "wgmma"),
    (torch.bfloat16, 37, 53, None, ""),
    (torch.float32, 2048, 2816, None, ""),
    (torch.bfloat16, 2048, 2816, "simt", ""),
])
@pytest.mark.parametrize("name", ["moe_direct_norm", "moe_clipped_grad"])
def test_moe_launches_its_route(fake_lib, name, dtype, d, p, kernel, entry):
    """Each MoE wrapper launches the C entry its route names, with the
    argument count of its signature and the record shape (L, B, E, C, d, p)
    that its 3-D tensor maps are built from, and counts every launch and
    the wgmma ones; unstacked records launch as L = 1."""
    L, B, E, C = 2, 3, 4, 5
    fn = getattr(moe_mod, name)
    for stacked in (True, False):
        lead = (L,) if stacked else ()
        a, ds = (_meta(*lead, B, E, C, w, dtype=dtype) for w in (d, p))
        mask = _meta(*lead, B, E, C)
        n0, w0 = fn.launches, fn.wgmma_launches
        fake_lib.calls.clear()
        out = (fn(a, mask, ds, kernel=kernel) if name == "moe_direct_norm"
               else fn(a, mask, _meta(B), ds, kernel=kernel))
        want_shape = (B,) if name == "moe_direct_norm" else (*lead, E, d, p)
        assert tuple(out.shape) == want_shape and out.dtype == torch.float32
        c_entry = f"dp_{name}_{entry}" if entry else f"dp_{name}"
        assert fake_lib.calls == [(c_entry,
                                   len(build.SIGNATURES[c_entry]))]
        # the pointers (0 on meta tensors), then L, B, E, C, d, p (and the
        # SIMT kernels' bf16 flag), then the stream
        dims = fake_lib.last_args[-7 if entry else -8:][:6]
        assert list(dims) == [L if stacked else 1, B, E, C, d, p]
        assert fn.launches == n0 + 1
        assert fn.wgmma_launches == w0 + (entry == "wgmma")


@pytest.mark.parametrize("dtype,d,p,kernel,entry", [
    (torch.bfloat16, 2048, 2816, None, "dp_moe_ghost_norm_wgmma"),
    (torch.bfloat16, 136, 264, None, "dp_moe_ghost_norm_wgmma"),
    (torch.bfloat16, 37, 53, None, "dp_moe_ghost_norm"),
    (torch.bfloat16, 2048, 2812, None, "dp_moe_ghost_norm"),
    (torch.float32, 2048, 2816, None, "dp_moe_ghost_norm"),
    (torch.bfloat16, 2048, 2816, "simt", "dp_moe_ghost_norm"),
])
@pytest.mark.parametrize("stacked", [True, False])
def test_moe_ghost_norm_launches_its_route(fake_lib, empty_shapes, dtype, d,
                                           p, kernel, entry, stacked):
    """The wrapper launches the C entry its route names (wgmma for bf16
    with d, p multiples of 8; simt for f32, unaligned widths or when
    forced), with the argument count of its signature and the records'
    (L, B, E, C, d, p), sizes the wgmma kernel's partials as the C side
    asks (by capacity: its tile pairs), and counts every launch and the
    wgmma ones; unstacked records launch as L = 1."""
    L, B, E, C = 2, 3, 4, 130
    lead = (L,) if stacked else ()
    a, ds = (_meta(*lead, B, E, C, w, dtype=dtype) for w in (d, p))
    fake_lib.sizes["dp_moe_ghost_norm_wgmma_nparts"] = 24
    n0, w0 = moe_ghost_norm.launches, moe_ghost_norm.wgmma_launches
    out = moe_ghost_norm(a, _meta(*lead, B, E, C), ds, kernel=kernel)
    L1 = L if stacked else 1
    assert out.shape == (B,) and out.dtype == torch.float32
    assert fake_lib.calls == [(entry, len(build.SIGNATURES[entry]))]
    wgmma = entry.endswith("wgmma")
    assert fake_lib.asked == ([("dp_moe_ghost_norm_wgmma_nparts", (C,))]
                              if wgmma else [])
    assert ((B, L1 * E * (24 if wgmma else 1)), torch.float32) in \
        empty_shapes
    # the pointers (0 on meta tensors), then L, B, E, C, d, p (and the SIMT
    # kernel's bf16 flag), then the stream
    assert list(fake_lib.last_args[5:11]) == [L1, B, E, C, d, p]
    if not wgmma:
        assert fake_lib.last_args[11] == int(dtype == torch.bfloat16)
    assert moe_ghost_norm.launches == n0 + 1
    assert moe_ghost_norm.wgmma_launches == w0 + wgmma


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("stacked", [True, False])
def test_emb_ghost_norm_launches_its_kernel(fake_lib, empty_shapes, dtype,
                                            stacked):
    """The wrapper asks the C side for the partials of a sample a layer (by
    T), holds (B, L x those) f32 partials, and makes one call of the C side
    with (L, B, T, d, bf16); unstacked ids launch as L = 1."""
    L, B, T, d = 3, 8, 512, 1536
    lead = (L,) if stacked else ()
    fake_lib.sizes["dp_emb_norm_nparts"] = 64
    n0 = emb_ghost_norm.launches
    out = emb_ghost_norm(_meta(*lead, B, T, dtype=torch.int32),
                         _meta(*lead, B, T, d, dtype=dtype))
    L1 = L if stacked else 1
    assert out.shape == (B,) and out.dtype == torch.float32
    assert fake_lib.asked == [("dp_emb_norm_nparts", (T,))]
    assert ((B, L1 * 64), torch.float32) in empty_shapes
    assert fake_lib.calls == [("dp_emb_norm",
                               len(build.SIGNATURES["dp_emb_norm"]))]
    # the pointers (0 on meta tensors), then L, B, T, d, bf16, the stream
    assert list(fake_lib.last_args[4:9]) == [L1, B, T, d,
                                             int(dtype == torch.bfloat16)]
    assert emb_ghost_norm.launches == n0 + 1


@pytest.mark.parametrize("dtype,d,p,kernel,entry", [
    (torch.bfloat16, 1536, 2048, None, "dp_grad_norm_direct_wgmma"),
    (torch.bfloat16, 136, 264, None, "dp_grad_norm_direct_wgmma"),
    (torch.bfloat16, 37, 53, None, "dp_grad_norm_direct"),
    (torch.float32, 1536, 2048, None, "dp_grad_norm_direct"),
    (torch.bfloat16, 1536, 2048, "simt", "dp_grad_norm_direct"),
])
@pytest.mark.parametrize("stacked", [True, False])
def test_grad_norm_direct_launches_its_route(fake_lib, empty_shapes, dtype,
                                             d, p, kernel, entry, stacked):
    """The wrapper launches the C entry its route names, with the argument
    count of its signature and the records' (L, B, T, d, p), sizes the
    partial sums as the C side asks, and counts every launch and the wgmma
    ones; unstacked records launch as L = 1."""
    L, B, T = 2, 2, 48
    lead = (L,) if stacked else ()
    a, ds = (_meta(*lead, B, T, w, dtype=dtype) for w in (d, p))
    nparts = f"{entry}_nparts"
    fake_lib.sizes[nparts] = 96
    n0, w0 = grad_norm_direct.launches, grad_norm_direct.wgmma_launches
    out = grad_norm_direct(a, ds, kernel=kernel)
    L1 = L if stacked else 1
    assert out.shape == (B,) and out.dtype == torch.float32
    assert fake_lib.calls == [(entry, len(build.SIGNATURES[entry]))]
    wgmma = entry.endswith("wgmma")
    assert fake_lib.asked == [(nparts, (d,) if wgmma else (d, p))]
    assert ((B, L1 * 96), torch.float32) in empty_shapes
    # the pointers (0 on meta tensors), then L, B, T, d, p
    assert list(fake_lib.last_args[4:9]) == [L1, B, T, d, p]
    assert grad_norm_direct.launches == n0 + 1
    assert grad_norm_direct.wgmma_launches == w0 + wgmma


@pytest.mark.parametrize("per_sample_u", [False, True])
@pytest.mark.parametrize("dtype,h,kernel,entry", [
    (torch.bfloat16, 64, None, "dp_wkv6_chunked"),
    (torch.float32, 64, None, "dp_wkv6_chunked"),
    (torch.float32, 16, None, "dp_wkv6_chunked"),
    (torch.bfloat16, 8, None, "dp_wkv6"),
    (torch.bfloat16, 64, "scan", "dp_wkv6"),
])
def test_wkv6_launches_its_route(fake_lib, empty_shapes, dtype, h, kernel,
                                 entry, per_sample_u):
    """The wrapper launches the C entry its route names, with the argument
    count of its signature, u's batch stride (0 for (H,h), H h for the
    per-sample (B,H,h)) and (B, T, H, h), gives the chunked kernel the
    (B, H, chunks, h, h) f32 state scratch the C side asks for, and counts
    every launch and the chunked ones."""
    B, T, H = 2, 100, 3
    fake_lib.sizes["dp_wkv6_chunked_nparts"] = 2
    n0, c0 = wkv6.launches, wkv6.chunked_launches
    u = _meta(B, H, h) if per_sample_u else _meta(H, h)
    out = wkv6(*(_meta(B, T, H, h, dtype=dtype),) * 4, u, kernel=kernel)
    assert out.shape == (B, T, H, h) and out.dtype == torch.float32
    assert fake_lib.calls == [(entry, len(build.SIGNATURES[entry]))]
    assert fake_lib.last_args[5] == (H * h if per_sample_u else 0)
    chunked = entry == "dp_wkv6_chunked"
    if chunked:
        assert fake_lib.asked == [("dp_wkv6_chunked_nparts", (T, h))]
        assert ((B, H, 2, h, h), torch.float32) in empty_shapes
    dims = fake_lib.last_args[-6:-2]
    assert list(dims) == [B, T, H, h]
    assert wkv6.launches == n0 + 1
    assert wkv6.chunked_launches == c0 + chunked


@pytest.mark.parametrize("call", [
    # f32 records, unaligned widths, other head sizes: no wgmma kernel
    lambda: clipped_grad(_meta(2, 3, 8), _meta(2), _meta(2, 3, 16),
                         kernel="wgmma"),
    lambda: clipped_grad(_meta(2, 3, 12, dtype=torch.bfloat16), _meta(2),
                         _meta(2, 3, 16, dtype=torch.bfloat16),
                         kernel="wgmma"),
    lambda: flash_attention(*(_meta(2, 3, 2, 32, dtype=torch.bfloat16),) * 3,
                            kernel="wgmma"),
    lambda: flash_attention(*(_meta(2, 3, 2, 128),) * 3, kernel="wgmma"),
    lambda: clipped_grad(_meta(2, 3, 8), _meta(2), _meta(2, 3, 16),
                         kernel="tensor"),
    # ghost_norm's wgmma kernel: f32 records, unaligned widths, other routes
    lambda: ghost_norm(_meta(2, 3, 8), _meta(2, 3, 16), kernel="wgmma"),
    lambda: ghost_norm(_meta(2, 3, 12, dtype=torch.bfloat16),
                       _meta(2, 3, 16, dtype=torch.bfloat16), kernel="wgmma"),
    lambda: ghost_norm(_meta(2, 3, 8, dtype=torch.bfloat16),
                       _meta(2, 3, 20, dtype=torch.bfloat16), kernel="wgmma"),
    lambda: ghost_norm(_meta(2, 3, 8, dtype=torch.bfloat16),
                       _meta(2, 3, 16, dtype=torch.bfloat16),
                       kernel="tensor"),
    # the MoE wgmma kernels: f32 records, unaligned widths, other routes
    lambda: moe_direct_norm(_meta(2, 3, 4, 8), _meta(2, 3, 4),
                            _meta(2, 3, 4, 16), kernel="wgmma"),
    lambda: moe_direct_norm(_meta(2, 3, 4, 12, dtype=torch.bfloat16),
                            _meta(2, 3, 4),
                            _meta(2, 3, 4, 16, dtype=torch.bfloat16),
                            kernel="wgmma"),
    lambda: moe_clipped_grad(_meta(2, 3, 4, 8), _meta(2, 3, 4), _meta(2),
                             _meta(2, 3, 4, 16), kernel="wgmma"),
    lambda: moe_clipped_grad(_meta(2, 3, 4, 8, dtype=torch.bfloat16),
                             _meta(2, 3, 4), _meta(2),
                             _meta(2, 3, 4, 20, dtype=torch.bfloat16),
                             kernel="wgmma"),
    lambda: moe_clipped_grad(_meta(2, 3, 4, 8, dtype=torch.bfloat16),
                             _meta(2, 3, 4), _meta(2),
                             _meta(2, 3, 4, 16, dtype=torch.bfloat16),
                             kernel="tensor"),
    lambda: moe_ghost_norm(_meta(2, 3, 4, 8), _meta(2, 3, 4),
                           _meta(2, 3, 4, 16), kernel="wgmma"),
    lambda: moe_ghost_norm(_meta(2, 3, 4, 8, dtype=torch.bfloat16),
                           _meta(2, 3, 4),
                           _meta(2, 3, 4, 20, dtype=torch.bfloat16),
                           kernel="wgmma"),
    lambda: moe_ghost_norm(_meta(2, 3, 4, 8, dtype=torch.bfloat16),
                           _meta(2, 3, 4),
                           _meta(2, 3, 4, 16, dtype=torch.bfloat16),
                           kernel="tensor"),
    # grad_norm_direct's wgmma kernel: f32 records, unaligned widths
    lambda: grad_norm_direct(_meta(2, 3, 8), _meta(2, 3, 16), kernel="wgmma"),
    lambda: grad_norm_direct(_meta(2, 3, 12, dtype=torch.bfloat16),
                             _meta(2, 3, 16, dtype=torch.bfloat16),
                             kernel="wgmma"),
    lambda: grad_norm_direct(_meta(2, 3, 8, dtype=torch.bfloat16),
                             _meta(2, 3, 16, dtype=torch.bfloat16),
                             kernel="tensor"),
    # wkv6's chunked kernel: other head sizes, other routes
    lambda: wkv6(*(_meta(2, 3, 4, 8),) * 4, _meta(4, 8), kernel="chunked"),
    lambda: wkv6(*(_meta(2, 3, 4, 72, dtype=torch.bfloat16),) * 4,
                 _meta(4, 72), kernel="chunked"),
    lambda: wkv6(*(_meta(2, 3, 4, 64),) * 4, _meta(4, 64), kernel="wgmma"),
    # fused_clip_grad's wgmma kernel: f32 records, unaligned widths, other
    # routes
    lambda: fused_clip_grad(_meta(2, 3, 8), _meta(2, 3, 16), _meta(2),
                            "automatic", 1.0, 0.01, kernel="wgmma"),
    lambda: fused_clip_grad(_meta(2, 3, 12, dtype=torch.bfloat16),
                            _meta(2, 3, 16, dtype=torch.bfloat16), _meta(2),
                            "automatic", 1.0, 0.01, kernel="wgmma"),
    lambda: fused_clip_grad(_meta(2, 3, 16, dtype=torch.bfloat16),
                            _meta(2, 3, 1532, dtype=torch.bfloat16),
                            _meta(2), "abadi", 1.0, 0.01, kernel="wgmma"),
    lambda: fused_clip_grad(_meta(2, 3, 8, dtype=torch.bfloat16),
                            _meta(2, 3, 16, dtype=torch.bfloat16), _meta(2),
                            "abadi", 1.0, 0.01, kernel="tensor"),
])
def test_forced_wgmma_route_raises_on_inputs_it_does_not_take(fake_lib,
                                                              call):
    with pytest.raises(ValueError, match="kernel"):
        call()
    assert fake_lib.calls == []


@pytest.mark.parametrize("dtype,d,p,want", [
    # parity_layer's smoke-width units (f32): qkv, o, gate+up, down, head
    (torch.float32, 32, 64, "simt"),
    (torch.float32, 32, 32, "simt"),
    (torch.float32, 32, 96, "simt"),
    (torch.float32, 48, 32, "simt"),
    # the gate-edge cases (bf16): edge_square, edge_stacked, the rank-16
    # adapter's A and B at qwen2-1.5b's width, and the smoke widths in bf16
    (torch.bfloat16, 512, 512, "wgmma"),
    (torch.bfloat16, 256, 256, "wgmma"),
    (torch.bfloat16, 1536, 16, "wgmma"),
    (torch.bfloat16, 16, 1536, "wgmma"),
    (torch.bfloat16, 32, 96, "wgmma"),
    (torch.bfloat16, 136, 264, "wgmma"),      # multiples of 8, of no tile
    # unaligned widths and f32 records take the SIMT route
    (torch.bfloat16, 37, 53, "simt"),
    (torch.bfloat16, 512, 508, "simt"),
    (torch.bfloat16, 20, 16, "simt"),
    (torch.float32, 512, 512, "simt"),
    (torch.float32, 165, 301, "simt"),
])
def test_fused_clip_route(dtype, d, p, want):
    assert fc_mod.route(dtype, d, p) == want


@pytest.mark.parametrize("dtype,d,p,kernel,want", [
    (torch.bfloat16, 512, 512, None, "wgmma"),
    (torch.bfloat16, 16, 1536, None, "wgmma"),
    (torch.bfloat16, 37, 53, None, "simt"),
    (torch.float32, 32, 96, None, "simt"),
    (torch.bfloat16, 512, 512, "simt", "simt"),
])
@pytest.mark.parametrize("stacked", [True, False])
def test_fused_clip_launches_its_route(fake_lib, empty_shapes, dtype, d, p,
                                       kernel, want, stacked):
    """One C call a wrapper call (the one launch), with its signature's
    argument count and the unit's (L, B, T, d, p), bf16 flag, route and
    clip function; one allocation, of G, sq and the partials sized as the
    C side asks, (B, CTAs): no L*d*p scratch; every launch and the wgmma
    ones counted. Unstacked records launch as L = 1."""
    L, B, T = 2, 8, 512
    lead = (L,) if stacked else ()
    a, ds, w = (*(_meta(*lead, B, T, n, dtype=dtype) for n in (d, p)),
                _meta(B))
    made = len(empty_shapes)      # the inputs' own
    fake_lib.sizes["dp_fused_clip_nparts"] = 64
    fake_lib.sizes["dp_fused_clip_scratch_bytes"] = 0
    n0, w0 = fused_clip_grad.launches, fused_clip_grad.wgmma_launches
    G, sq = fused_clip_grad(a, ds, w, "normalize", 1.0, 0.01, kernel=kernel)
    L1, bf16, wgmma = (L if stacked else 1), dtype == torch.bfloat16, \
        want == "wgmma"
    assert G.shape == (*lead, d, p) and G.dtype == torch.float32
    assert sq.shape == (B,) and sq.dtype == torch.float32
    entry = "dp_fused_clip_grad"
    assert fake_lib.calls == [(entry, len(build.SIGNATURES[entry]))]
    unit = (L1, B, T, d, p, int(bf16), int(wgmma))
    assert fake_lib.asked == [("dp_fused_clip_nparts", unit),
                              ("dp_fused_clip_scratch_bytes", unit)]
    assert empty_shapes[made:] == [((L1 * d * p + B + B * 64,),
                                    torch.float32)]
    # the seven pointers (no scratch: null), then L, B, T, d, p, bf16,
    # wgmma, clip, R, gamma
    assert not fake_lib.last_args[4]
    assert list(fake_lib.last_args[7:15]) == [
        L1, B, T, d, p, int(bf16), int(wgmma),
        fc_mod.CLIPS.index("normalize")]
    assert fused_clip_grad.launches == n0 + 1
    assert fused_clip_grad.wgmma_launches == w0 + wgmma


@pytest.mark.parametrize("nparts,scratch,error,match", [
    (0, 0, RuntimeError, r"\(186, 8, 1, 65\).*has no CTAs"),
    (-2, 0, RuntimeError, "CUDA error 2 while planning"),
    (64, -2, RuntimeError, "CUDA error 2 while planning"),
])
def test_fused_clip_raises_where_its_grid_cannot_be_resident(
        fake_lib, empty_shapes, nparts, scratch, error, match):
    """A plan of no CTAs (the C side walks any number of tiles with the
    CTAs the card holds at once, so only a card that holds not one makes
    it) raises with the unit's shape before anything is allocated or
    launched, never sent to the plain version; so does a failed query."""
    fake_lib.sizes["dp_fused_clip_nparts"] = nparts
    fake_lib.sizes["dp_fused_clip_scratch_bytes"] = scratch
    a, ds, w = _meta(186, 8, 1, 65), _meta(186, 8, 1, 65), _meta(8)
    made = len(empty_shapes)
    with pytest.raises(error, match=match):
        fused_clip_grad(a, ds, w, "automatic", 1.0, 0.01)
    assert fake_lib.calls == [] and empty_shapes[made:] == []



# units the gate fuses whose tiles outnumber the card's resident CTAs (the
# walk; chip_smoke's FUSED_WALKS): (L, B, T, d, p)
WALK_EDGES = {"edge_adapter_stacked": (28, 8, 2, 1536, 16),
              "many_tiles": (8192, 8, 1, 8, 8)}


@pytest.mark.parametrize("name", sorted(WALK_EDGES))
@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "wgmma"),
                                        (torch.float32, "simt")])
def test_fused_walk_edges_are_fused_and_launch_once(fake_lib, empty_shapes,
                                                    name, dtype, want):
    """The two walking edge units: the reference's gate fuses them (and the
    port's plan agrees), bf16 takes the wgmma route and f32 the SIMT one,
    and the wrapper makes one C call with the unit's shape whatever the
    CTAs the C side plans (here 132, far fewer than the tiles), its one
    allocation holding the scratch the C side asks for (the SIMT walk's
    first sweep's tiles) and passing it, or null where none is asked."""
    from repro.kernels import dispatch as jdispatch
    from repro_torch.kernels import dispatch
    L, B, T, d, p = WALK_EDGES[name]
    a_shape, ds_shape = (L, B, T, d), (L, B, T, p)
    for mode in ("bk-mixopt", "bk-mixghost"):
        assert dispatch.fused_plan("mm", a_shape, ds_shape, mode).method == \
            jdispatch.fused_plan("mm", a_shape, ds_shape, mode).method == \
            "fused"
    assert fc_mod.route(dtype, d, p) == want
    # the SIMT walk spills its first sweep's tiles, 8 samples' at most
    spill = 8 * L * d * p * 4 if want == "simt" else 0
    fake_lib.sizes["dp_fused_clip_nparts"] = 132
    fake_lib.sizes["dp_fused_clip_scratch_bytes"] = spill
    a, ds, w = (_meta(*a_shape, dtype=dtype), _meta(*ds_shape, dtype=dtype),
                _meta(B))
    made = len(empty_shapes)      # the inputs' own
    G, sq = fused_clip_grad(a, ds, w, "automatic", 1.0, 0.01)
    assert G.shape == (L, d, p) and sq.shape == (B,)
    assert fake_lib.calls == [("dp_fused_clip_grad",
                               len(build.SIGNATURES["dp_fused_clip_grad"]))]
    assert list(fake_lib.last_args[7:14]) == [L, B, T, d, p,
                                              int(dtype == torch.bfloat16),
                                              int(want == "wgmma")]
    assert bool(fake_lib.last_args[4]) == bool(spill)
    assert empty_shapes[made:] == [((L * d * p + B + B * 132 + spill // 4,),
                                    torch.float32)]


# (route, tile, sample slots a group, walking CTAs) of the walk's
# decomposition, at a unit cut small: 6 layers of d = 40, p = 24 are 36
# SIMT tiles of 16 and 6 wgmma tiles of 64; walks that do not divide the
# tiles, and groups of fewer samples than B (several barriers)
WALK_PLANS = [("simt", 16, 8, 5), ("simt", 16, 2, 7), ("simt", 32, 3, 4),
              ("wgmma", 64, 2, 4)]


@pytest.mark.parametrize("clipping", fc_mod.CLIPS)
def test_fused_model_walk_matches_pallas(clipping):
    """The walk's decomposition (``fused_model(..., walk=n)``: n CTAs, CTA
    c taking the tiles c, c + n, ..; its partial of sq_b the squares of its
    tiles in that order; C_b after each group; the second sweep's tiles of
    g_b contracted again) against the Pallas kernel in interpret mode, at a
    tile-walking unit cut small (L = 6, B = 5, T = 3, d = 40, p = 24), with
    a masked sample, R at the median norm (flat: midway in the widest gap);
    and against the one-pass decomposition of the same tiles (float64: the
    sums' orders differ, rtol 1e-12)."""
    from repro.kernels.fused_clip import fused_clip_grad as jfused_clip_grad
    L, B, T, d, p = 6, 5, 3, 40, 24
    a, ds = _np((L, B, T, d), "float32", 0), _np((L, B, T, p), "float32", 1)
    w = np.abs(np.random.default_rng(2).standard_normal(B)).astype(
        np.float32) + 0.5
    w[1] = 0.0
    ta, tds, tw = (torch.from_numpy(x) for x in (a, ds, w))
    gamma = 0.05
    n = np.sort(np.sqrt(fc_mod.plain(ta, tds, tw, "automatic", 1.0,
                                     gamma)[1].double().numpy()))
    i = int(np.argmax(np.diff(n)))
    R = float((n[i] + n[i + 1]) / 2) if clipping == "flat" else \
        float(np.median(n))
    jG, jsq = (np.asarray(x) for x in jfused_clip_grad(
        jnp.asarray(a), jnp.asarray(ds), jnp.asarray(w), clipping, R, gamma,
        interpret=True))
    for kernel, tile, group, walk in WALK_PLANS:
        G, sq = fc_mod.fused_model(ta, tds, tw, clipping, R, gamma, kernel,
                                   tile, group, 1, walk)
        np.testing.assert_allclose(sq.numpy(), jsq, rtol=1e-5,
                                   err_msg=f"{kernel} {tile} {walk}")
        np.testing.assert_allclose(G.numpy(), jG, rtol=1e-5,
                                   atol=1e-6 * float(np.abs(jG).max()),
                                   err_msg=f"{kernel} {tile} {walk}")
        G1, sq1 = fc_mod.fused_model(ta, tds, tw, clipping, R, gamma, kernel,
                                     tile, group, 1)
        torch.testing.assert_close(sq, sq1, rtol=1e-12, atol=0)
        torch.testing.assert_close(G, G1, rtol=1e-12,
                                   atol=1e-12 * float(G1.abs().max()))


def test_fused_model_walk_splits_no_rows():
    x = torch.zeros(2, 2, 3, 8)
    with pytest.raises(ValueError, match="walk splits no tile"):
        fc_mod.fused_model(x, x, torch.ones(2), "automatic", 1.0, 0.01,
                           "simt", 16, 8, 2, 3)

def _kind(decl: str) -> str:
    decl = decl.strip()
    if "*" in decl:
        return "P"
    if "long long" in decl:
        return "L"
    return {"int": "I", "float": "F"}[decl.split()[0]]


def _c_entries() -> dict:
    """Every ``extern "C" int dp_...(`` under csrc/ -> its argument kinds
    (P pointer, I int, F float, L 64-bit int)."""
    entries = {}
    for cu in sorted(build.CSRC.glob("*.cu")):
        for m in re.finditer(r'extern "C" int (dp_\w+)\((.*?)\)',
                             cu.read_text(), re.S):
            args = [a for a in m.group(2).split(",") if a.strip()]
            entries[m.group(1)] = [_kind(a) for a in args]
    return entries


_CTYPES = {ctypes.c_void_p: "P", ctypes.c_int: "I", ctypes.c_float: "F",
           ctypes.c_longlong: "L", ctypes.c_ulonglong: "L"}


def test_every_c_entry_has_a_signature():
    assert sorted(_c_entries()) == sorted(build.SIGNATURES)


@pytest.mark.parametrize("name", sorted(build.SIGNATURES))
def test_c_entry_signature_matches_ctypes(name):
    """The argument count and pointer / int / float kinds that ctypes
    declares are the C entry's: a mismatch would pass a cut pointer."""
    assert [_CTYPES[t] for t in build.SIGNATURES[name]] == _c_entries()[name]


@pytest.mark.parametrize("cu", sorted(p.name for p in build.CSRC.glob("*.cu")))
def test_cuda_source_parses_against_the_stub_headers(cu):
    """g++ -fsyntax-only over each kernel source with the stub CUDA headers
    (launch configurations stripped): C++ errors show here, before a build
    on the card."""
    ok, out = syntax_check.check(build.CSRC / cu)
    assert ok, out


def _design_sources():
    for table in ("EMB_PATCHES", "GHOST_PATCHES", "WKV_PATCHES",
                  "WKV_ABLATIONS", "MOE_PATCHES", "EMB_NORM_PATCHES",
                  "FUSED_PATCHES", "NOISE_PATCHES", "NOISE_ABLATIONS",
                  "NOISE_BLOCKS", "NOISE_UPDATE_PATCHES"):
        for name in getattr(design_study, table):
            yield f"{table}:{name}"
    for cu in sorted(design_study.DESIGNS.glob("*.cu")):
        yield f"designs/{cu.name}"


@pytest.mark.parametrize("which", list(_design_sources()))
def test_design_study_source_parses(which, tmp_path):
    """Every design that design_study.py times beside a kept kernel: its
    replacements still match the kept source once each, and the result (or
    the source of its own under designs/) parses against the stub headers,
    so the comparison can be run again on the card."""
    if which.startswith("designs/"):
        cu = design_study.DESIGNS / which.split("/", 1)[1]
    else:
        table, name = which.split(":")
        for h in build.CSRC.glob("*.cuh"):
            shutil.copy(h, tmp_path)
        cu = tmp_path / f"{name}.cu"
        if table == "NOISE_UPDATE_PATCHES":   # (source, its patches)
            cu.write_text(design_study.noise_source(
                [], *design_study.NOISE_UPDATE_PATCHES[name]))
        elif table == "NOISE_BLOCKS":    # the kernels' own sources
            for src in ("counter_noise.cu", "noise_update.cu"):
                cu.write_text(design_study.noise_source(
                    [], src, design_study.blocks_patches(src, int(name))))
                ok, out = syntax_check.check(cu)
                assert ok, out
        elif table.startswith("NOISE"):  # counter_normal.cuh's patches
            for src in ("counter_noise.cu", "noise_update.cu"):
                cu.write_text(design_study.noise_source(
                    getattr(design_study, table)[name], src))
                ok, out = syntax_check.check(cu)
                assert ok, out
        else:
            src, patches = getattr(design_study, table)[name]
            cu.write_text(design_study.patched(build.CSRC / src, patches))
    ok, out = syntax_check.check(cu)
    assert ok, out
