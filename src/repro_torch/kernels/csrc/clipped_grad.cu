// clipped_grad: the clip-weighted gradient of a matmul tap (BK Algorithm 1
// line 9),
//
//     G_l = sum_b C_b a_lb^T g_lb          a (L,B,T,d), g (L,B,T,p) -> (L,d,p)
//
// Replaces the TPU kernel repro/kernels/clipped_grad.py::clipped_grad. One
// CTA owns one (l, 128-row d tile, 128-column p tile) of the output and one
// part of the (b, t) rows, which it walks inside the block (the TPU's
// innermost B grid axis): each 16-row chunk of a is scaled by C_b in
// registers on its way into shared memory, so the (B,T,p) weighted copy
// never exists. Where the output has too few tiles to fill the card (a
// narrow tap over many rows: a CNN's first conv, d = 147, p = 64, T = 112^2)
// the rows split into ``dp_clipped_grad_split`` parts, each CTA writes its
// part's tile to a scratch slice and a second pass sums the parts in order;
// otherwise one part, and each tile is written once. No atomics: the sum
// over (b, t) runs in one fixed order.
//
// Bound on the H100: 2 L B T d p operations against (L B T (d+p)) inputs and
// L d p outputs — about 12.6 TFLOP per step summed over the five taps at
// B=8, T=512 — so it is compute-bound. This kernel runs on the f32 SIMT
// cores with an 8 x 8 register tile per thread; it serves f32 records and
// bf16 records with unaligned widths. bf16 records with d, p multiples of 8
// (every train path's taps) take clipped_grad_wgmma.cu (tensor cores).
#include <algorithm>

#include "common.cuh"

namespace {

using atb::BK;
using atb::BM;
using atb::BN;
using atb::THREADS;

// the fewest rows a part takes
constexpr long long MIN_PART_ROWS = 512;

template <typename T>
__global__ void __launch_bounds__(THREADS)
    clipped_grad_kernel(const T* __restrict__ a, const float* __restrict__ C,
                        const T* __restrict__ g, float* __restrict__ out,
                        int L, int B, int Tn, int d, int p, int splits) {
  __shared__ float sa[BK][BM];
  __shared__ float sg[BK][BN];
  const int p0 = blockIdx.x * BN, d0 = blockIdx.y * BM;
  const int l = blockIdx.z % L, part = blockIdx.z / L;
  // this CTA's rows of the layer's (b, t) walk: the part-th of ``splits``
  const long long rows = (long long)B * Tn;
  const long long r1 = rows * (part + 1) / splits;

  float acc[8][8];
  atb::zero(acc);
  for (long long r = rows * part / splits; r < r1;) {
    const int b = (int)(r / Tn);
    const long long end = min(r1, (long long)(b + 1) * Tn);
    const long long row = (long long)l * rows + r;
    atb::accumulate<T>(acc, a + row * d, g + row * p, (int)(end - r), d, p,
                       d0, p0, RowScale{nullptr, C[b]}, sa, sg);
    r = end;
  }
  atb::store(out + ((long long)part * L + l) * d * p, acc, d, p, d0, p0);
}

// out[i] = sum over the parts of part[k][i], in order
__global__ void sum_parts_kernel(const float* __restrict__ part,
                                 float* __restrict__ out, long long n,
                                 int splits) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * n + i];
    out[i] = s;
  }
}

}  // namespace

// The parts the (b, t) rows split into: 1 where the L x tiles CTAs fill
// the card's SMs twice over, else enough parts to, each of at least
// MIN_PART_ROWS rows (and L x parts within the grid's z limit).
extern "C" int dp_clipped_grad_split(int L, int B, int T, int d, int p) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    sms = 132;
  const long long ctas = (long long)atb::ntiles(d, p) * L, want = 2LL * sms;
  if (ctas >= want) return 1;
  long long s = (want + ctas - 1) / ctas;
  s = std::min(s, (long long)B * T / MIN_PART_ROWS);
  s = std::min(s, 65535LL / L);
  return (int)std::max(s, 1LL);
}

// a (L,B,T,d), g (L,B,T,p) contiguous, both f32 (bf16 == 0) or bf16;
// C (B,) f32; out (L,d,p) f32; parts (splits, L, d, p) f32 scratch where
// splits > 1 (``dp_clipped_grad_split``), else unread.
extern "C" int dp_clipped_grad(const void* a, const float* C, const void* g,
                               float* parts, float* out, int L, int B, int T,
                               int d, int p, int bf16, int splits,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  float* dst = splits > 1 ? parts : out;
  dim3 grid((p + BN - 1) / BN, (d + BM - 1) / BM, L * splits);
  if (bf16)
    clipped_grad_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        (const __nv_bfloat16*)a, C, (const __nv_bfloat16*)g, dst, L, B, T, d,
        p, splits);
  else
    clipped_grad_kernel<float><<<grid, THREADS, 0, st>>>(
        (const float*)a, C, (const float*)g, dst, L, B, T, d, p, splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits <= 1) return (int)err;
  const long long n = (long long)L * d * p;
  const int blocks = (int)std::min((n + 255) / 256, 2048LL);
  sum_parts_kernel<<<blocks, 256, 0, st>>>(parts, out, n, splits);
  return (int)cudaGetLastError();
}
