// emb_ghost_norm: per-sample squared gradient norms of an embedding lookup,
//
//     n_b = sum_l sum_{t,t'} 1[id_lbt == id_lbt'] (g_lbt . g_lbt')
//
// Replaces the TPU kernel repro/kernels/emb_norm.py::emb_ghost_norm. The
// Pallas kernel forms the (T,T) cotangent Gram on the MXU and masks it by id
// equality; only pairs with equal ids contribute, so here a warp takes one t,
// finds the t' <= t with the same id by a ballot over 32 ids at a time, and
// dots only the matching rows (x2 off the diagonal). One CTA covers 32 t of
// one (l, b) and writes one partial; a second pass sums the partials of each
// b in a fixed order. No atomics.
//
// Bound on the H100: every cotangent row is read once for its diagonal term
// and the id-matching pairs are few, so it is bound by the bytes of ds.
#include "common.cuh"

namespace {

constexpr int TCHUNK = 32;    // t values per CTA
constexpr int THREADS = 256;  // 8 warps, 4 t each

template <typename T>
__global__ void __launch_bounds__(THREADS)
    emb_norm_kernel(const int* __restrict__ ids, const T* __restrict__ ds,
                    float* __restrict__ partial, int L, int B, int Tn, int d,
                    int nchunks) {
  const int chunk = blockIdx.x, l = blockIdx.y, b = blockIdx.z;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const long long row0 = ((long long)l * B + b) * Tn;
  const int* id = ids + row0;
  const T* g = ds + row0 * d;

  float acc = 0.f;  // identical in every lane of the warp
  for (int q = w; q < TCHUNK; q += THREADS / 32) {
    const int t = chunk * TCHUNK + q;
    if (t >= Tn) break;
    const int idt = id[t];
    const T* gt = g + (long long)t * d;
    for (int s0 = 0; s0 <= t; s0 += 32) {
      const int s = s0 + lane;
      unsigned hit = __ballot_sync(0xffffffffu, s <= t && id[s] == idt);
      while (hit) {
        const int sp = s0 + __ffs(hit) - 1;
        hit &= hit - 1;
        const T* gs = g + (long long)sp * d;
        float dot = 0.f;
        for (int c = lane; c < d; c += 32)
          dot = fmaf(to_f32(gt[c]), to_f32(gs[c]), dot);
        acc += (sp == t ? 1.f : 2.f) * warp_sum(dot);
      }
    }
  }
  // every lane holds the warp's total: count it once per warp
  const float s = block_sum(lane == 0 ? acc : 0.f);
  if (threadIdx.x == 0)
    partial[((long long)b * L + l) * nchunks + chunk] = s;
}

}  // namespace

extern "C" int dp_emb_norm_nparts(int T) { return (T + TCHUNK - 1) / TCHUNK; }

// ids (L,B,T) int32, ds (L,B,T,d) f32 (bf16 == 0) or bf16, contiguous;
// partial (B, L * nchunks) f32 scratch; out (B,) f32.
extern "C" int dp_emb_norm(const int* ids, const void* ds, float* partial,
                           float* out, int L, int B, int T, int d, int bf16,
                           void* stream) {
  const int nch = dp_emb_norm_nparts(T);
  cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(nch, L, B);
  if (bf16)
    emb_norm_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        ids, (const __nv_bfloat16*)ds, partial, L, B, T, d, nch);
  else
    emb_norm_kernel<float><<<grid, THREADS, 0, st>>>(
        ids, (const float*)ds, partial, L, B, T, d, nch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, L * nch);
  return (int)cudaGetLastError();
}
