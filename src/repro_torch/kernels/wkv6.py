"""wkv6: the RWKV6 time-mix recurrence as CUDA kernels, forward (the rwkv6
serving prefill's state scan, and the training forward) and backward.

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

u is (H,h), or (B,H,h) per sample (the BK step's psp route). The forward
replaces the TPU kernel ``repro/kernels/wkv6.py::wkv6``. Two kernels, chosen
by :func:`route`; each source says what bounds it on the H100:

- ``chunked`` (``csrc/wkv6_chunked.cu``): f32 or bf16 inputs, h a multiple
  of 16 up to 128 (rwkv6's 64: the prefill, the f32 parity prefill and the
  training forward). A state pass over chunks, then every chunk's outputs in
  parallel, the products on the tensor cores in split TF32. The state pass
  writes the state at each chunk start to an f32 scratch, which training
  keeps as the backward's saved tensor. :func:`chunked_model` is its
  decomposition in plain torch, which the CPU tests hold to the recurrence.
- ``scan`` (``csrc/wkv6.cu``): any h up to 128; token by token, the state in
  registers.

The backward, :func:`wkv6_backward` (``csrc/wkv6_backward.cu``, no TPU
counterpart: the JAX package differentiates its recurrence with jnp
autodiff), takes the chunked kernel's saved states and walks each chunk in
reverse, h a multiple of 16 up to 64. :class:`Wkv6Fn` binds the two as one
``torch.autograd.Function``; :func:`backward_model` is the backward's
decomposition in plain torch and :func:`plain_backward` autograd through the
recurrence, what the kernel is held to.

Nothing divides by a cumulative decay: every decay factor is a product of
w's over its own interval, or the decay applied token by token, so the
kernels compute the recurrence and its gradients exactly under any decay,
w = 0 and 1 included (the Pallas kernel's chunked form, and
``models.rwkv6.wkv6_chunked``, divide k by the in-chunk product of the
decays and lose it once that product underflows f32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

F32 = torch.float32
ROUTES = ("chunked", "scan")
CHUNK = 64         # tokens between saved states (the chunked kernel's chunk
                   # at h <= 64)
SUB = 8            # tokens of the backward's sub-chunks


def plain(r, k, v, w, u) -> torch.Tensor:
    """The plain version, the sequential recurrence ``models.rwkv6.wkv6_ref``
    (imported here: that module launches this one's kernel). What a CPU
    tensor runs, and what the kernels are held to."""
    from repro_torch.models.rwkv6 import wkv6_ref
    return wkv6_ref(r, k, v, w, u)


def route(dtype: torch.dtype, h: int, aligned: bool = True) -> str:
    """The kernel a CUDA call takes: 'chunked' for f32 or bf16 inputs with
    h a multiple of 16 up to 128 and 16-byte aligned bases (its cp.async
    copies), else 'scan'."""
    return ("chunked" if dtype in (torch.float32, torch.bfloat16)
            and h % 16 == 0 and 16 <= h <= 128 and aligned else "scan")


def trains(dtype: torch.dtype, h: int, aligned: bool = True) -> bool:
    """Whether :class:`Wkv6Fn` takes these inputs on the card: the chunked
    route (its saved states) with h up to 64 (the backward's rows)."""
    return route(dtype, h, aligned) == "chunked" and h <= 64


def _shapes(name, r, k, v, w, u):
    """-> (B, T, H, h, u's batch stride: 0 for (H,h), H h for (B,H,h))."""
    B, T, H, h = r.shape
    shapes = [tuple(t.shape) for t in (r, k, v, w)]
    if shapes != [(B, T, H, h)] * 4 or tuple(u.shape) not in ((H, h),
                                                               (B, H, h)):
        raise ValueError(f"{name}: r, k, v, w must share one (B,T,H,h) "
                         f"shape and u be (H,h) or (B,H,h), got "
                         f"{shapes + [tuple(u.shape)]}")
    if not 1 <= h <= 128:
        raise ValueError(f"{name}: head size {h} is not in [1, 128]")
    return B, T, H, h, H * h if u.dim() == 3 else 0


def _forward(r, k, v, w, u, kernel: str | None = None):
    """One launch of the kernel :func:`route` names (``kernel`` forces one)
    on CUDA tensors -> (out (B,T,H,h) f32, the chunked kernel's state
    scratch (B, H, chunks, h, h) f32, or None on the scan)."""
    u32 = u.to(F32).contiguous()
    bf16 = build.check_inputs("wkv6", (r, k, v, w), f32=(u32,))
    B, T, H, h, ub = _shapes("wkv6", r, k, v, w, u)
    aligned = all(t.data_ptr() % 16 == 0 for t in (r, k, v, w))
    want = route(r.dtype, h, aligned)
    kernel = kernel or want
    if kernel not in ROUTES:
        raise ValueError(f"wkv6: kernel {kernel!r} not in {ROUTES}")
    if kernel == "chunked" and want != "chunked":
        raise ValueError(f"wkv6: the chunked kernel takes f32 or bf16 inputs "
                         f"with h a multiple of 16 up to 128 and 16-byte "
                         f"aligned bases, got {r.dtype}, h={h}, "
                         f"aligned={aligned}")
    out = torch.empty(B, T, H, h, dtype=F32, device=r.device)
    state = None
    if T == 0:
        return out, state
    lib = build.load()
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr(), ub)
    if kernel == "chunked":
        state = torch.empty(B, H, lib.dp_wkv6_chunked_nparts(T, h), h, h,
                            dtype=F32, device=r.device)
        build.check(lib.dp_wkv6_chunked(
            *args, state.data_ptr(), out.data_ptr(), B, T, H, h, int(bf16),
            build.stream_ptr(r)), "wkv6 (chunked)")
        wkv6.chunked_launches += 1
    else:
        build.check(lib.dp_wkv6(*args, out.data_ptr(), B, T, H, h, int(bf16),
                                build.stream_ptr(r)), "wkv6")
    wkv6.launches += 1
    return out, state


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, kernel: str | None = None) -> torch.Tensor:
    """r, k, v, w (B,T,H,h); u (H,h) or (B,H,h) -> (B,T,H,h) f32. One
    launch of the kernel :func:`route` names; ``kernel`` forces one."""
    if r.device.type == "cpu":
        return plain(r, k, v, w, u)
    return _forward(r, k, v, w, u, kernel)[0]


wkv6.launches = 0           # every launch, either kernel
wkv6.chunked_launches = 0   # launches of the chunked kernel


def wkv6_backward(do, r, k, v, w, u, state):
    """The gradients of :func:`wkv6`'s output with cotangent ``do`` (B,T,H,h)
    -> (dr, dk, dv, dw (B,T,H,h), du (B,H,h) per sample, whatever u's
    layout), in f32 (float64 for float64 inputs). ``state`` is the
    chunked forward's scratch on the same inputs (:func:`chunk_states` on
    the CPU). One launch of ``csrc/wkv6_backward.cu`` (and its pass adding
    the column blocks' partials); :func:`backward_model` on CPU tensors."""
    if r.device.type == "cpu":
        return backward_model(r, k, v, w, u, do, state)
    u32 = u.to(F32).contiguous()
    bf16 = build.check_inputs("wkv6_backward", (r, k, v, w),
                              f32=(u32, do, state))
    B, T, H, h, ub = _shapes("wkv6_backward", r, k, v, w, u)
    aligned = all(t.data_ptr() % 16 == 0 for t in (r, k, v, w))
    if not trains(r.dtype, h, aligned):
        raise NotImplementedError(
            f"wkv6_backward takes the chunked forward's saved states: f32 or "
            f"bf16 inputs with h a multiple of 16 up to 64 and 16-byte "
            f"aligned bases, got {r.dtype}, h={h}, aligned={aligned}")
    nc = -(-T // CHUNK)
    if tuple(do.shape) != (B, T, H, h) or \
            tuple(state.shape) != (B, H, nc, h, h):
        raise ValueError(f"wkv6_backward: do must be (B,T,H,h) and state "
                         f"(B,H,{nc},h,h), got {tuple(do.shape)}, "
                         f"{tuple(state.shape)}")
    dev = r.device
    grads = [torch.empty(B, T, H, h, dtype=F32, device=dev)
             for _ in range(4)]
    du = torch.empty(B, H, h, dtype=F32, device=dev)
    if T == 0:
        return (*grads, du.zero_())
    lib = build.load()
    parts = lib.dp_wkv6_backward_nparts(h) - 1
    part = torch.empty(parts * (3 * B * T * H * h + B * H * h), dtype=F32,
                       device=dev)
    build.check(lib.dp_wkv6_backward(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
        u32.data_ptr(), ub, do.data_ptr(), state.data_ptr(),
        *(g.data_ptr() for g in grads), du.data_ptr(), part.data_ptr(), B, T,
        H, h, int(bf16), build.stream_ptr(r)), "wkv6_backward")
    wkv6_backward.launches += 1
    return (*grads, du)


wkv6_backward.launches = 0


def plain_backward(r, k, v, w, u, do):
    """The backward's plain version: torch autograd through the recurrence
    (``models.rwkv6.wkv6_ref``) with cotangent ``do`` -> (dr, dk, dv, dw,
    du (B,H,h) per sample), f32 (float64 for float64 inputs): the inputs
    are differentiated as f32 copies, so that bf16 inputs get f32 grads, as
    the kernel's. What the kernel is held to on the card."""
    from repro_torch.models.rwkv6 import wkv6_ref
    B = r.shape[0]
    dt = torch.promote_types(r.dtype, F32)
    u_b = u if u.dim() == 3 else u.expand(B, *u.shape)
    with torch.enable_grad():
        xs = [t.detach().to(dt, copy=True).requires_grad_()
              for t in (r, k, v, w, u_b)]
        out = wkv6_ref(*xs)
        return torch.autograd.grad(out, xs, do.to(dt))


def chunk_states(k, v, w, chunk: int = CHUNK) -> torch.Tensor:
    """The state before each chunk of ``chunk`` tokens, (B, H, chunks, h,
    h), as the chunked kernel's state pass leaves its scratch (chunk 0, which
    it does not write, zero), in f32 (float64 for float64 inputs). What
    :class:`Wkv6Fn` saves on the CPU."""
    B, T, H, h = k.shape
    dt = torch.promote_types(k.dtype, F32)
    k, v, w = (x.to(dt) for x in (k, v, w))
    S = torch.zeros(B, H, h, h, dtype=dt, device=k.device)
    out = []
    for t in range(-(-T // chunk) * chunk):
        if t % chunk == 0:
            out.append(S)
        if t < T:
            S = (w[:, t, :, :, None] * S
                 + k[:, t, :, :, None] * v[:, t, :, None, :])
    return torch.stack(out, 2) if out else S.new_zeros(B, H, 0, h, h)


def backward_model(r, k, v, w, u, do, states, chunk: int = CHUNK,
                   sub: int = SUB):
    """The backward kernel's decomposition (``csrc/wkv6_backward.cu``) in
    plain torch, in the inputs' dtype promoted to f32 (float64 shows that it
    is exact; what a CPU tensor runs). Per chunk of ``chunk`` tokens from
    the last, S0 the saved state before it (``states[:, :, c]``, zero for
    c = 0): a walk forward keeps the state at each sub-chunk start; then per
    sub-chunk of ``sub`` tokens from the last, its states S_{t-1} recomputed
    from its start, and a reverse walk with G = dS_t:
    dr_t = sum_j do_j (S_{t-1} + u k_t v_t^T), E = G + (u r_t) do_t^T,
    dk_t = E v_t, dv_t = k_t E, dw_t = sum_j G S_{t-1}, du += r k (v . do),
    then G = w_t G + r_t^T do_t. Tokens past T are zero, w one (they leave S
    and G as they are). No division: the decay is applied token by token.
    -> (dr, dk, dv, dw (B,T,H,h), du (B,H,h) per sample)."""
    B, T, H, h = r.shape
    dt = torch.promote_types(r.dtype, F32)
    nc = -(-T // chunk)
    Tp = nc * chunk

    def heads(x, fill=0.0):           # (B, H, Tp, h), rows past T ``fill``
        x = x.to(dt).permute(0, 2, 1, 3)
        return torch.cat([x, x.new_full((B, H, Tp - T, h), fill)], 2)

    r, k, v, do = map(heads, (r, k, v, do))
    w = heads(w, 1.0)
    u = u.to(dt).expand(B, H, h)
    G = torch.zeros(B, H, h, h, dtype=dt, device=r.device)
    dr, dk, dv, dw = (torch.zeros_like(r) for _ in range(4))
    du = torch.zeros(B, H, h, dtype=dt, device=r.device)

    def step(S, t):
        return w[:, :, t, :, None] * S + k[:, :, t, :, None] * v[:, :, t, None]

    for c in reversed(range(nc)):
        S = states[:, :, c].to(dt) if c > 0 else torch.zeros_like(G)
        starts = []
        for q in range(0, chunk, sub):
            starts.append(S)
            for t in range(c * chunk + q, c * chunk + q + sub):
                S = step(S, t)
        for qi in reversed(range(chunk // sub)):
            t0 = c * chunk + qi * sub
            S, subs = starts[qi], []
            for t in range(t0, t0 + sub):
                subs.append(S)
                S = step(S, t)
            for t in reversed(range(t0, t0 + sub)):
                sp = subs[t - t0]
                rt, kt, vt, dot, wt = (x[:, :, t] for x in (r, k, v, do, w))
                E = G + (u * rt)[..., None] * dot[..., None, :]
                dr[:, :, t] = ((sp + (u * kt)[..., None] * vt[..., None, :])
                               * dot[..., None, :]).sum(-1)
                dk[:, :, t] = (E * vt[..., None, :]).sum(-1)
                dv[:, :, t] = (E * kt[..., None]).sum(-2)
                dw[:, :, t] = (G * sp).sum(-1)
                du = du + rt * kt * (vt * dot).sum(-1, keepdim=True)
                G = wt[..., None] * G + rt[..., None] * dot[..., None, :]
    grads = (x[:, :, :T].permute(0, 2, 1, 3) for x in (dr, dk, dv, dw))
    return (*grads, du)


def _fold(n, x, d):
    """A vmapped input (vmapped axis ``d``, None if unbatched) with the
    vmapped axis folded into its leading batch axis: (n, B, ...) -> (n B,
    ...); an unbatched one broadcast over the n first."""
    if d is None:
        x = x.expand(n, *x.shape)
    else:
        x = x.movedim(d, 0)
    return x.reshape(n * x.shape[1], *x.shape[2:])


def _fold_u(n, u, d, B):
    """u under vmap: shared (H,h) and unbatched stays shared; any other is
    folded to per-sample (n B, H, h)."""
    if d is None and u.dim() == 2:
        return u
    if d is not None:
        u = u.movedim(d, 0)
        if u.dim() == 3:                       # (n, H, h): shared per row
            u = u[:, None].expand(n, B, *u.shape[1:])
    else:
        u = u.expand(n, *u.shape)              # (n, B, H, h)
    return u.reshape(n * B, *u.shape[2:])


def _unfold(n, x):
    return x.reshape(n, x.shape[0] // n, *x.shape[1:])


class Wkv6Fn(torch.autograd.Function):
    """:func:`wkv6` with its gradient: ``Wkv6Fn.apply(r, k, v, w, u)`` ->
    (out (B,T,H,h) f32, the saved chunk states, not differentiable). On the
    card the chunked kernel, whose state scratch is saved, then
    :func:`wkv6_backward`; inputs that route does not take raise
    ``NotImplementedError``. On the CPU the plain recurrence (in float64 for
    float64 inputs), :func:`chunk_states` and :func:`backward_model`. Each
    grad is cast to its input's dtype; du is summed over B where u was
    (H,h). Composes with ``torch.func`` (``setup_context``; a vmap rule that
    folds the vmapped axis into B, also for the backward, which runs as
    :class:`Wkv6BackwardFn` so that its kernel sees plain tensors)."""

    @staticmethod
    def forward(r, k, v, w, u):
        if r.device.type == "cpu":
            return plain(r, k, v, w, u), chunk_states(k, v, w)
        r, k, v, w = (t.contiguous() for t in (r, k, v, w))
        h = r.shape[-1]
        aligned = all(t.data_ptr() % 16 == 0 for t in (r, k, v, w))
        if not trains(r.dtype, h, aligned):
            raise NotImplementedError(
                f"wkv6 training takes the chunked kernel (its saved states) "
                f"and wkv6_backward: f32 or bf16 inputs with h a multiple of "
                f"16 up to 64 and 16-byte aligned bases, got {r.dtype}, "
                f"h={h}, aligned={aligned}")
        out, state = _forward(r, k, v, w, u, "chunked")
        if state is None:                      # T == 0
            state = out.new_empty(r.shape[0], r.shape[2], 0, h, h)
        return out, state

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.mark_non_differentiable(output[1])
        ctx.save_for_backward(*inputs, output[1])

    @staticmethod
    def backward(ctx, do, _):
        r, k, v, w, u, state = ctx.saved_tensors
        dr, dk, dv, dw, du = Wkv6BackwardFn.apply(do, r, k, v, w, u, state)
        if u.dim() == 2:
            du = du.sum(0)
        return tuple(g.to(x.dtype)
                     for g, x in zip((dr, dk, dv, dw, du), (r, k, v, w, u)))

    @staticmethod
    def vmap(info, in_dims, r, k, v, w, u):
        n = info.batch_size
        xs = [_fold(n, x, d) for x, d in zip((r, k, v, w), in_dims)]
        B = xs[0].shape[0] // n
        out, state = Wkv6Fn.apply(*xs, _fold_u(n, u, in_dims[4], B))
        return (_unfold(n, out), _unfold(n, state)), (0, 0)


class Wkv6BackwardFn(torch.autograd.Function):
    """:func:`wkv6_backward` as a Function (not differentiable again), so
    that under ``torch.func.vmap`` its vmap rule hands the kernel plain
    tensors: ``apply(do, r, k, v, w, u, state)`` -> (dr, dk, dv, dw, du)."""

    @staticmethod
    def forward(do, r, k, v, w, u, state):
        return wkv6_backward(do.contiguous(), r.contiguous(), k.contiguous(),
                             v.contiguous(), w.contiguous(), u,
                             state.contiguous())

    @staticmethod
    def setup_context(ctx, inputs, output):
        pass

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError("wkv6's backward is not differentiable")

    @staticmethod
    def vmap(info, in_dims, do, r, k, v, w, u, state):
        n = info.batch_size
        xs = [_fold(n, x, d) for x, d in zip((do, r, k, v, w), in_dims)]
        B = xs[0].shape[0] // n
        grads = Wkv6BackwardFn.apply(*xs, _fold_u(n, u, in_dims[5], B),
                                     _fold(n, state, in_dims[6]))
        return tuple(_unfold(n, g) for g in grads), (0,) * 5


def chunked_model(r, k, v, w, u, chunk: int = 64, sub: int = 16):
    """The chunked kernel's decomposition (``csrc/wkv6_chunked.cu``) in
    plain torch, in the inputs' dtype (float64 shows that it is exact;
    nothing but the tests runs it). Per chunk of ``chunk`` tokens, S0 the
    state before it, pass 2's outputs through sub-chunks of ``sub`` tokens,
    each cut in two halves [h0, h1]: r' = r D(h0..t-1) and k' = k D(s+1..h1)
    over each half, G8a, G8b the halves' whole products, G their product; a
    half's diagonal block by running products from s = t-1 down, with the
    bonus on its diagonal; the second half's rows against the first half's
    columns as r' k'^T; an off-diagonal block as r^ (k^ times the G's
    between)^T, with r^ = r' (first half) or r' G8a (second) and k^ = k' G8b
    (first half) or k' (second); then A V + (r^ times the G's before) S0.
    Then pass 1's state update over the chunk's two halves: K~ = k D(s+1..
    end of its half), P_x = K~^T V over half x, S = D(chunk) S0 + (G1 P_0 +
    P_1), G1 the second half's D. Every decay factor is a product of w's
    over its own interval, from 1: no division, no difference of prefix
    sums. r, k, v, w (B,T,H,h); u (H,h) -> (B,T,H,h)."""
    B, T, H, h = r.shape
    dt, dev = r.dtype, r.device
    nc, hs, hc = -(-T // chunk), sub // 2, chunk // 2

    def heads(x):      # (B, H, nc * chunk, h), rows past T zero
        x = x.to(dt).permute(0, 2, 1, 3)
        return torch.cat([x, x.new_zeros(B, H, nc * chunk - T, h)], 2)

    def walk(x, wc, lo, hi, forward):
        """x_t D(lo..t-1) (forward) or x_t D(t+1..hi-1) over [lo, hi) ->
        (the scaled rows, D(lo..hi-1))."""
        P, y = one, torch.empty_like(x[:, :, lo:hi])
        order = range(lo, hi) if forward else reversed(range(lo, hi))
        for t in order:
            y[:, :, t - lo] = x[:, :, t] * P
            P = P * wc[:, :, t]
        return y, P

    r, k, v, w = map(heads, (r, k, v, w))
    u = u.to(dt)
    one = torch.ones(B, H, h, dtype=dt, device=dev)
    out = torch.empty_like(r)
    S = torch.zeros(B, H, h, h, dtype=dt, device=dev)
    for c0 in range(0, nc * chunk, chunk):
        rc, kc, vc, wc = (x[:, :, c0:c0 + chunk] for x in (r, k, v, w))
        rp, kp = torch.empty_like(rc), torch.empty_like(kc)
        A = torch.zeros(B, H, chunk, chunk, dtype=dt, device=dev)
        G, G8a, G8b = [], [], []
        for b0 in range(0, chunk, sub):
            for h0 in (b0, b0 + hs):
                rp[:, :, h0:h0 + hs], P = walk(rc, wc, h0, h0 + hs, True)
                kp[:, :, h0:h0 + hs], _ = walk(kc, wc, h0, h0 + hs, False)
                (G8a if h0 == b0 else G8b).append(P)
                for t in range(h0, h0 + hs):
                    A[..., t, t] = (rc[:, :, t] * u * kc[:, :, t]).sum(-1)
                    P = one
                    for s in range(t - 1, h0 - 1, -1):
                        A[..., t, s] = (rc[:, :, t] * P * kc[:, :, s]).sum(-1)
                        P = P * wc[:, :, s]
            G.append(G8a[-1] * G8b[-1])
            A[..., b0 + hs:b0 + sub, b0:b0 + hs] = \
                rp[:, :, b0 + hs:b0 + sub] @ kp[:, :, b0:b0 + hs].transpose(-1, -2)
        Rt = torch.empty_like(rc)
        for q in range(chunk // sub):
            a, m, e = q * sub, q * sub + hs, (q + 1) * sub
            rhat = torch.cat([rp[:, :, a:m], rp[:, :, m:e] * G8a[q][:, :, None]],
                             2)
            f = one       # G_{p+1} ... G_{q-1}, from q - 1 down
            for p in reversed(range(q)):
                pa, pm, pe = p * sub, p * sub + hs, (p + 1) * sub
                khat = torch.cat([kp[:, :, pa:pm] * (f * G8b[p])[:, :, None],
                                  kp[:, :, pm:pe] * f[:, :, None]], 2)
                A[..., a:e, pa:pe] = rhat @ khat.transpose(-1, -2)
                f = f * G[p]
            Rt[:, :, a:m] = rp[:, :, a:m] * f[:, :, None]
            Rt[:, :, m:e] = rp[:, :, m:e] * (f * G8a[q])[:, :, None]
        out[:, :, c0:c0 + chunk] = A @ vc + Rt @ S
        K0, G0 = walk(kc, wc, 0, hc, False)
        K1, G1 = walk(kc, wc, hc, chunk, False)
        P0 = K0.transpose(-1, -2) @ vc[:, :, :hc]
        P1 = K1.transpose(-1, -2) @ vc[:, :, hc:]
        S = (G0 * G1)[..., None] * S + (G1[..., None] * P0 + P1)
    return out[:, :, :T].permute(0, 2, 1, 3)
