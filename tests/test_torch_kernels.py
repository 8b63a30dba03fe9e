"""The port's four kernel modules on the CPU against the JAX package's Pallas
kernels (run in interpret mode through ``repro.kernels.ops``, as
tests/test_kernel_parity.py runs them): the same numpy inputs, the odd and
stacked shapes of that file, f32 and bf16. On a CPU tensor each wrapper runs
its plain version; the CUDA kernels themselves are held to those plain
versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import ops
from repro_torch.core import bk as tbk
from repro_torch.kernels.clipped_grad import clipped_grad
from repro_torch.kernels.emb_grad import emb_clipped_grad
from repro_torch.kernels.emb_norm import emb_ghost_norm
from repro_torch.kernels.ghost_norm import ghost_norm

TOL = dict(rtol=1e-3, atol=1e-4)        # tests/test_kernel_parity.py:15
TOL_BF16 = dict(rtol=5e-2, atol=2e-2)   # tests/test_kernel_parity.py:18
MM_SHAPES = [(1, 2, 7, 5, 9), (1, 3, 33, 17, 23), (2, 2, 50, 24, 40),
             (3, 2, 64, 31, 13)]        # tests/test_kernel_parity.py:31-36
EMB_SHAPES = [(1, 2, 9, 6, 11), (2, 3, 33, 16, 50), (3, 2, 50, 24, 37)]
DTYPES = ["float32", "bfloat16"]


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


@pytest.mark.parametrize("L,B,T,d,V", EMB_SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_emb_ghost_norm_matches_pallas(L, B, T, d, V, dtype):
    ids = np.random.default_rng(3).integers(0, V, (L, B, T)).astype(np.int32)
    (ji, ti), (jd, td) = _pair(ids), _pair(_np((L, B, T, d), dtype, 1))
    want = np.asarray(ops.ghost_norm_emb(ji, jd, block_t=16))
    np.testing.assert_allclose(emb_ghost_norm(ti, td).numpy(), want,
                               **_tol(dtype))


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
    lambda: clipped_grad(_meta(2, 3, 4), _meta(2), _meta(2, 3, 5)),
    lambda: emb_ghost_norm(_meta(2, 3, dtype=torch.int32), _meta(2, 3, 4)),
    lambda: emb_clipped_grad(_meta(2, 3, dtype=torch.int32), _meta(2),
                             _meta(2, 3, 4), 7),
])
def test_wrappers_take_the_plain_version_only_on_cpu(call):
    """A tensor that is not on the CPU never reaches the plain version: the
    wrapper validates it for its kernel and refuses what is not CUDA."""
    with pytest.raises(ValueError, match="CUDA device"):
        call()


def test_unported_direct_norm_raises_off_cpu():
    """A direct-norm plan with the mixopt cache off needs grad_norm_direct,
    which has no CUDA kernel yet: off the CPU it raises, naming it."""
    a, ds = _meta(2, 3, 40, 4), _meta(2, 3, 40, 5)   # 2T^2 >= pd: direct
    with pytest.raises(NotImplementedError, match="grad_norm_direct"):
        tbk.record_sq_norm("blocks/x#mm.s", a, ds, "bk-mixghost", True)
    # the same plan on the CPU runs the plain direct norm
    a = torch.randn(2, 3, 40, 4)
    ds = torch.randn(2, 3, 40, 5)
    n, cached = tbk.record_sq_norm("blocks/x#mm.s", a, ds, "bk-mixghost", True)
    assert n.shape == (3,) and cached is None
