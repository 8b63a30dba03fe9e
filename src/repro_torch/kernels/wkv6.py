"""wkv6: the RWKV6 time-mix recurrence as CUDA kernels (the rwkv6 serving
prefill's state scan).

    o_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
    S_t = diag(w_t) S_{t-1} + k_t^T v_t

Replaces the TPU kernel ``repro/kernels/wkv6.py::wkv6``. Two kernels, chosen
by :func:`route`; each source says what bounds it on the H100:

- ``chunked`` (``csrc/wkv6_chunked.cu``): f32 or bf16 inputs, h a multiple
  of 16 up to 128 (rwkv6's 64: the prefill and the f32 parity prefill). A
  state pass over chunks, then every chunk's outputs in parallel, the
  products on the tensor cores in split TF32. :func:`chunked_model` is its
  decomposition in plain torch, which the CPU tests hold to the recurrence.
- ``scan`` (``csrc/wkv6.cu``): any h up to 128; token by token, the state in
  registers.

Neither divides by a cumulative decay: every decay factor is a product of
w's over its own interval, so both compute the recurrence exactly under any
decay, w = 0 and 1 included (the Pallas kernel's chunked form, and
``models.rwkv6.wkv6_chunked``, divide k by the in-chunk product of the
decays and lose it once that product underflows f32).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

F32 = torch.float32
ROUTES = ("chunked", "scan")


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


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
         u: torch.Tensor, kernel: str | None = None) -> torch.Tensor:
    """r, k, v, w (B,T,H,h); u (H,h) -> (B,T,H,h) f32. One launch of the
    kernel :func:`route` names; ``kernel`` forces one."""
    if r.device.type == "cpu":
        return plain(r, k, v, w, u)
    u32 = u.to(F32).contiguous()
    bf16 = build.check_inputs("wkv6", (r, k, v, w), f32=(u32,))
    B, T, H, h = r.shape
    shapes = [tuple(t.shape) for t in (r, k, v, w, u)]
    if shapes != [(B, T, H, h)] * 4 + [(H, h)]:
        raise ValueError(f"wkv6: r, k, v, w must share one (B,T,H,h) shape "
                         f"and u be (H,h), got {shapes}")
    if not 1 <= h <= 128:
        raise ValueError(f"wkv6: head size {h} is not in [1, 128]")
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
    if T == 0:
        return out
    lib = build.load()
    args = (r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
            u32.data_ptr())
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
    return out


wkv6.launches = 0           # every launch, either kernel
wkv6.chunked_launches = 0   # launches of the chunked kernel


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
