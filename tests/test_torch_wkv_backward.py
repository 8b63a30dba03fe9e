"""The gradients of the rwkv6 recurrence in the port, on the CPU: the port's
``wkv6_ref`` and ``wkv6_chunked`` differentiated by autograd against
``jax.grad`` of the JAX package's (both u layouts, as
tests/test_rwkv_chunked.py:33-41 holds the reference's two forms to each
other); the backward kernel's decomposition (``kernels.wkv6.
backward_model``, float64) against float64 autograd through the recurrence
at ragged T and under strong and mixed decay, where the reference's chunked
form divides by an underflowed decay product and the kernel must not;
``Wkv6Fn`` under ``gradcheck`` and under ``torch.func.vmap(torch.func.
grad(...))``; the backward wrapper's launch through a fake library."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.rwkv6 import wkv6_chunked as jwkv6_chunked
from repro.models.rwkv6 import wkv6_ref as jwkv6_ref
from repro_torch.kernels import build
from repro_torch.kernels import wkv6 as wk
from repro_torch.models.rwkv6 import wkv6_chunked, wkv6_ref

GRAD_TOL = dict(rtol=2e-3, atol=2e-3)      # tests/test_rwkv_chunked.py:41
F64_TOL = dict(rtol=1e-9, atol=1e-10)      # float64 against float64


def _inputs(B, T, H, h, w=None, per_sample_u=False, seed=0):
    """r, k, v standard normal; w uniform in [0.6, 0.99] (the reference's
    grad test), the constant ``w``, or 'mixed': log-uniform in [1e-6, 1]
    with 5% exact zeros and 5% exact ones; u normal * 0.5, (H,h) or
    (B,H,h); do standard normal -> float64 numpy arrays."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, h)) for _ in range(3))
    if w is None:
        w = rng.uniform(0.6, 0.99, (B, T, H, h))
    elif w == "mixed":
        x = np.exp(rng.uniform(np.log(1e-6), 0.0, (B, T, H, h)))
        m = rng.uniform(size=(B, T, H, h))
        w = np.where(m < 0.05, 0.0, np.where(m > 0.95, 1.0, x))
    else:
        w = np.full((B, T, H, h), w)
    u = rng.standard_normal((B, H, h) if per_sample_u else (H, h)) * 0.5
    do = rng.standard_normal((B, T, H, h))
    return r, k, v, w, u, do


def _autograd(fn, xs, do):
    """Grads of sum(fn(*xs) * do) with respect to every x, by torch
    autograd."""
    ts = [torch.from_numpy(x).requires_grad_() for x in xs]
    out = fn(*ts)
    return [g.numpy() for g in torch.autograd.grad(
        out, ts, torch.from_numpy(do).to(out.dtype))]


@pytest.mark.parametrize("per_sample_u", [False, True])
@pytest.mark.parametrize("form", ["ref", "chunked"])
def test_port_grads_match_jax_grad(form, per_sample_u):
    """The port's two CPU forms, differentiated by autograd, against
    jax.grad of the JAX package's same form (f32, chunk 16 over T = 48)."""
    r, k, v, w, u, do = (x.astype(np.float32) for x in _inputs(
        2, 48, 2, 8, per_sample_u=per_sample_u))
    port = wkv6_ref if form == "ref" else (
        lambda *a: wkv6_chunked(*a, chunk=16))
    ref = jwkv6_ref if form == "ref" else (
        lambda *a: jwkv6_chunked(*a, chunk=16))
    got = _autograd(port, (r, k, v, w, u), do)
    want = jax.grad(lambda *a: jnp.sum(ref(*a) * do),
                    argnums=(0, 1, 2, 3, 4))(r, k, v, w, u)
    for name, g, x in zip("rkvwu", got, want):
        np.testing.assert_allclose(g, np.asarray(x), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize("chunk,sub", [(64, 8), (16, 4)])
@pytest.mark.parametrize("w", [None, 0.1, 0.01, "mixed"])
@pytest.mark.parametrize("B,T,H,h,per_sample_u", [(2, 100, 2, 16, False),
                                                  (1, 37, 3, 8, True),
                                                  (2, 64, 1, 16, True)])
def test_backward_model_is_autograd_of_the_recurrence(B, T, H, h,
                                                      per_sample_u, w,
                                                      chunk, sub):
    """``backward_model`` in float64, from the chunk states the forward
    saves, against float64 autograd through ``wkv6_ref``: T below, at and
    not a multiple of the chunk; strong constant decays and log-uniform
    decays with exact 0s and 1s; du per sample for both u layouts."""
    r, k, v, w_, u, do = _inputs(B, T, H, h, w=w, per_sample_u=per_sample_u)
    t = [torch.from_numpy(x) for x in (r, k, v, w_, u, do)]
    states = wk.chunk_states(t[1], t[2], t[3], chunk=chunk)
    assert states.shape == (B, H, -(-T // chunk), h, h)
    got = wk.backward_model(*t, states, chunk=chunk, sub=sub)
    u_b = u if per_sample_u else np.broadcast_to(u, (B, H, h)).copy()
    want = _autograd(wkv6_ref, (r, k, v, w_, u_b), do)
    for name, g, x in zip("rkvwu", got, want):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(g.numpy(), x, err_msg=name, **F64_TOL)


@pytest.mark.parametrize("w", [None, "mixed"])
def test_plain_backward_is_autograd_of_the_recurrence(w):
    """``plain_backward`` (what the kernel is held to on the card) is
    autograd through ``wkv6_ref``, du per sample from a shared u."""
    r, k, v, w_, u, do = _inputs(2, 20, 2, 8, w=w)
    got = wk.plain_backward(*(torch.from_numpy(x) for x in
                              (r, k, v, w_, u, do)))
    want = _autograd(wkv6_ref, (r, k, v, w_,
                                np.broadcast_to(u, (2, 2, 8)).copy()), do)
    for name, g, x in zip("rkvwu", got, want):
        np.testing.assert_allclose(g.numpy(), x, err_msg=name, **F64_TOL)


@pytest.mark.parametrize("per_sample_u", [False, True])
def test_wkv6fn_gradcheck(per_sample_u):
    """Wkv6Fn on the CPU (the plain forward, its chunk states and
    backward_model) under gradcheck, float64, with a decay that reaches 0
    and 1."""
    r, k, v, w, u, _ = _inputs(2, 5, 2, 3, per_sample_u=per_sample_u)
    w[0, 1, 0, 0], w[1, 2, 1, 2] = 0.0, 1.0
    xs = [torch.from_numpy(x).requires_grad_() for x in (r, k, v, w, u)]
    assert torch.autograd.gradcheck(lambda *a: wk.Wkv6Fn.apply(*a)[0], xs)


@pytest.mark.parametrize("per_sample_u", [False, True])
def test_wkv6fn_under_vmap_of_grad(per_sample_u):
    """torch.func.vmap(torch.func.grad(...)) through Wkv6Fn (the opacus
    route): each sample's grads of sum(out * do) against autograd through
    ``wkv6_ref`` on that sample alone; u shared (not vmapped) or one a
    sample."""
    B, T, H, h = 3, 9, 2, 4
    r, k, v, w, u, do = _inputs(B, T, H, h, per_sample_u=per_sample_u)
    t = [torch.from_numpy(x) for x in (r, k, v, w, u, do)]

    def loss(r1, k1, v1, w1, u1, do1):
        out = wk.Wkv6Fn.apply(r1[None], k1[None], v1[None], w1[None], u1)[0]
        return (out[0] * do1).sum()

    grads = torch.func.vmap(torch.func.grad(loss, argnums=(0, 1, 2, 3, 4)),
                            in_dims=(0, 0, 0, 0, 0 if per_sample_u else None,
                                     0))(*t)
    for b in range(B):
        ub = u[b] if per_sample_u else u
        want = _autograd(wkv6_ref, (r[b:b + 1], k[b:b + 1], v[b:b + 1],
                                    w[b:b + 1], ub), do[b:b + 1])
        for name, g, x in zip("rkvwu", grads, want):
            x = x if name == "u" else x[0]
            np.testing.assert_allclose(g[b].numpy(), x,
                                       err_msg=f"{name}[{b}]", **F64_TOL)


def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


class _FakeLib:
    """Records the backward's C calls; ``dp_wkv6_backward_nparts`` answers
    ``nparts``."""

    def __init__(self, nparts):
        self.nparts, self.calls = nparts, []

    def dp_wkv6_backward_nparts(self, h):
        self.calls.append(("dp_wkv6_backward_nparts", (h,)))
        return self.nparts

    def dp_wkv6_backward(self, *args):
        self.calls.append(("dp_wkv6_backward", args))
        return 0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("per_sample_u", [False, True])
def test_backward_wrapper_launches_its_kernel(monkeypatch, dtype,
                                              per_sample_u):
    """On non-CPU tensors (meta, through a fake library) the backward
    wrapper launches dp_wkv6_backward once with the argument count of its
    signature, u's batch stride, (B, T, H, h) and the bf16 flag, gives it
    (nparts - 1) column blocks of partials, and counts the launch."""
    B, T, H, h = 2, 100, 3, 64
    lib = _FakeLib(nparts=2)
    monkeypatch.setattr(build, "load", lambda: lib)
    monkeypatch.setattr(build, "stream_ptr", lambda t: 0)
    monkeypatch.setattr(build, "check_inputs",
                        lambda name, floats, ints=(), f32=():
                        floats[0].dtype == torch.bfloat16)
    sizes, real = [], torch.empty

    def spy(*size, **kw):
        t = real(*size, **kw)
        sizes.append(tuple(t.shape))
        return t
    monkeypatch.setattr(torch, "empty", spy)
    n0 = wk.wkv6_backward.launches
    u = _meta(B, H, h) if per_sample_u else _meta(H, h)
    out = wk.wkv6_backward(_meta(B, T, H, h),
                           *(_meta(B, T, H, h, dtype=dtype),) * 4, u,
                           _meta(B, H, 2, h, h))
    assert [tuple(g.shape) for g in out] == [(B, T, H, h)] * 4 + [(B, H, h)]
    assert all(g.dtype == torch.float32 for g in out)
    name, args = lib.calls[-1]
    assert name == "dp_wkv6_backward"
    assert len(args) == len(build.SIGNATURES[name])
    assert args[5] == (H * h if per_sample_u else 0)
    assert list(args[-6:-1]) == [B, T, H, h, int(dtype == torch.bfloat16)]
    assert (3 * B * T * H * h + B * H * h,) in sizes
    assert wk.wkv6_backward.launches == n0 + 1


@pytest.mark.parametrize("call", [
    # h past the backward's 64 rows, and a head size the chunked route
    # refuses
    lambda: wk.wkv6_backward(_meta(1, 4, 2, 128), *(_meta(1, 4, 2, 128),) * 4,
                             _meta(2, 128), _meta(1, 2, 1, 128, 128)),
    lambda: wk.wkv6_backward(_meta(1, 4, 2, 8), *(_meta(1, 4, 2, 8),) * 4,
                             _meta(2, 8), _meta(1, 2, 1, 8, 8)),
    lambda: wk.Wkv6Fn.apply(*(_meta(1, 4, 2, 8),) * 4, _meta(2, 8)),
])
def test_training_refuses_what_the_chunked_route_does_not_take(monkeypatch,
                                                               call):
    monkeypatch.setattr(build, "check_inputs",
                        lambda name, floats, ints=(), f32=(): False)
    with pytest.raises(NotImplementedError, match="wkv6"):
        call()
