// flash_attention on the tensor cores: causal or bidirectional GQA attention
// with an online softmax for bf16 q/k/v with head size 64 or 128,
//
//   o[b,t,n] = sum_s softmax_s(q[b,t,n] . k[b,s,n/G] / sqrt(h)) v[b,s,n/G]
//
// q (B,T,H,h), k/v (B,S,K,h) with H = K*G -> o (B,T,H,h) bf16. Replaces the
// TPU kernel repro/kernels/flash_attention.py::flash_attention on the
// serving prefill (f32 inputs and other head sizes keep
// flash_attention.cu, the SIMT kernel). Bound on the H100: 4 B H T S h / 2
// operations (causal) against the bytes of q, k, v and o, 206 GFLOP against
// 151 MB a layer at qwen2-1.5b's prefill (B=4, T=S=4096, H=12, K=2, h=128),
// so it is compute-bound; the SIMT kernel ran at 23 TFLOP/s.
//
// One CTA per SM walks (b, head, 128-query tile) items, longest first: two
// consumer warpgroups of 64 query rows and a producer warpgroup (one
// thread issues, the warpgroup hands its registers to the consumers). TMA
// loads an item's Q tile once and 128-key tiles of K and V into 2-stage
// rings that run on across items; the tensor maps are 4-D over the model's
// own (B,T,H,h) / (B,S,K,h) layout (no transposed copies), and the KV head
// is head / G (nothing replicated). Per key tile a warpgroup runs
//   S = Q K^T     m64n128k16, both operands from shared memory, K-major;
//   the online softmax on S's accumulator fragment: row max and sum over
//                 the quad of threads sharing a row, exp2 with log2(e)
//                 folded into the scale 1/sqrt(h);
//   O += P V      m64n{h}k16, P rounded to bf16 in registers as the A
//                 operand, V from shared memory, MN-major (transposed).
// Tile j's S product is issued with tile j-1's P V, and its softmax runs
// while that P V does; the two warpgroups take turns at issuing, so one's
// softmax (a special-function exp per score) overlaps the other's products.
// P is rounded to bf16 before P V, as the JAX model's own attention
// (repro/models/attention.py) rounds its probabilities; the Pallas kernel
// and the SIMT kernel keep them f32 (all within the bf16 tolerance).
//
// Masking as the SIMT kernel: scale 1/sqrt(h), masked logits -1e30, causal
// qpos >= kpos with both counted from 0, output divided by max(l, 1e-30).
// Only the tiles that reach the diagonal or past S take the mask; keys past
// S (zero-filled by TMA, which would otherwise score 0) take probability 0;
// rows past T are not written. Causal items stop at the diagonal. The
// reduction order is fixed: bitwise equal run to run.
#include "hopper.cuh"

namespace {

constexpr int BQ = 128;        // queries per CTA (64 per warpgroup)
constexpr int BKV = 128;       // keys per tile
constexpr int STAGES = 2;
constexpr int BOX = 64;        // elements of one 128-byte swizzled row
constexpr int THREADS = 384;   // two consumer warpgroups + a producer's
constexpr int CONSUMER_WARPS = 8;
// registers a thread: the producer warpgroup gives up all but 24, so that
// the consumers hold S, O and P (64 + h/2 + 32) without spilling
constexpr int PRODUCER_REGS = 24, CONSUMER_REGS = 240;
constexpr int KSTEP_BYTES = 16 * hopper::ROW_BYTES;  // 16 keys of V
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;

template <int HD>
struct Smem {
  static constexpr int Q_BYTES = HD / BOX * BQ * hopper::ROW_BYTES;
  static constexpr int KV_BYTES = HD / BOX * BKV * hopper::ROW_BYTES;
  static constexpr size_t TOTAL = Q_BYTES + 2 * STAGES * KV_BYTES +
                                  (2 + 4 * STAGES) * sizeof(uint64_t) +
                                  hopper::ATOM_BYTES;  // + alignment slack
};

// 2^x on the special-function unit (inputs of -inf and far below give +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The online softmax of one key tile on S's accumulator fragment, in place:
// s -> p = 2^(s scale - m) (f32), with the running row max m (in units of
// scale), the rescale alpha of what came before, and this thread's share of
// the row sums l. Rows r0 and r0 + 8 (entry 4n + e is row r0 + 8(e/2));
// masked logits -1e30, keys past S no probability at all. The maxes and
// sums run in four interleaved partials a row (two warps a scheduler leave
// a dependent chain of 32 unhidden), combined in a fixed order.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m)[2],
                                             float (&l)[2], float (&alpha)[2],
                                             bool edge, int causal, int k0,
                                             int S, int r0, int cq,
                                             float scale) {
  if (edge) {
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kpos = k0 + 8 * n + cq + (e & 1);
        if (causal && kpos > r0 + 8 * (e >> 1)) s[4 * n + e] = NEG_INF;
        if (kpos >= S) s[4 * n + e] = -INFINITY;
      }
  }
  float part[2][4];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) part[r][k] = s[4 * k + 2 * r];
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      part[e >> 1][n % 4] = fmaxf(part[e >> 1][n % 4], s[4 * n + e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = fmaxf(fmaxf(part[r][0], part[r][1]),
                     fmaxf(part[r][2], part[r][3]));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale);
    alpha[r] = ex2(m[r] - m_new);
    m[r] = m_new;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int k = 0; k < 4; ++k) part[r][k] = 0.f;
#pragma unroll
  for (int n = 0; n < 16; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = e >> 1;
      s[4 * n + e] = ex2(fmaf(s[4 * n + e], scale, -m[r]));
      part[r][n % 4] += s[4 * n + e];
    }
#pragma unroll
  for (int r = 0; r < 2; ++r)
    l[r] = l[r] * alpha[r] +
           ((part[r][0] + part[r][1]) + (part[r][2] + part[r][3]));
}

// The (b, head, 128-query tile) work items, longest first: a causal item's
// key tiles grow with its query tile, so the last query tiles of every
// (b, head) come first and the short ones fill the end.
struct Items {
  int nq, H, B, causal;
  __device__ __forceinline__ int count() const { return nq * H * B; }
  __device__ __forceinline__ void at(int w, int& q0, int& head,
                                     int& b) const {
    const int qt = w / (H * B);
    head = w % H;
    b = (w / H) % B;
    q0 = (causal ? nq - 1 - qt : qt) * BQ;
  }
};

// A persistent CTA walks items blockIdx.x, + gridDim.x, ...: the producer
// loads the next item's Q as soon as the last S product of the current one
// has read it, and the K/V rings run on across items.
template <int HD>
__global__ void __launch_bounds__(THREADS, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       __nv_bfloat16* __restrict__ o, int Tq, int S, int K,
                       Items items, float scale_log2) {
  using L = Smem<HD>;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = hopper::align_atom(smem_raw);
  uint8_t* sq = smem;
  uint8_t* sk = smem + L::Q_BYTES;               // K ring, then the V ring
  uint8_t* sv = sk + STAGES * L::KV_BYTES;
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sv + STAGES * L::KV_BYTES);
  uint64_t* qempty = qfull + 1;
  uint64_t* kfull = qempty + 1;
  uint64_t* kempty = kfull + STAGES;
  uint64_t* vfull = kempty + STAGES;
  uint64_t* vempty = vfull + STAGES;

  const int H = items.H, causal = items.causal, G = H / K;
  const int wg = hopper::warpgroup(), lane = threadIdx.x % 32;
  // key tiles of the item whose query tile starts at q0
  auto tiles_of = [&](int q0) {
    return ((causal ? min(S, q0 + BQ) : S) + BKV - 1) / BKV;
  };

  if (threadIdx.x == 0) {
    hopper::mbar_init(qfull, 1);
    hopper::mbar_init(qempty, CONSUMER_WARPS);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&kfull[s], 1);
      hopper::mbar_init(&kempty[s], CONSUMER_WARPS);
      hopper::mbar_init(&vfull[s], 1);
      hopper::mbar_init(&vempty[s], CONSUMER_WARPS);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {
    // producer: one thread loads each item's Q, then its K_j and V_j into
    // their rings (g counts key tiles over the CTA's items)
    hopper::regs_dealloc<PRODUCER_REGS>();
    if (threadIdx.x == 256) {
      int g = 0, k = 0;
      for (int w = blockIdx.x; w < items.count(); w += gridDim.x, ++k) {
        int q0, head, b;
        items.at(w, q0, head, b);
        const int kvh = head / G, nkv = tiles_of(q0);
        hopper::mbar_wait(qempty, (k & 1) ^ 1);
        hopper::mbar_expect_tx(qfull, L::Q_BYTES);
        for (int c = 0; c < HD / BOX; ++c)
          hopper::tma_load_4d(sq + c * BQ * hopper::ROW_BYTES, &mq, qfull,
                              c * BOX, head, q0, b);
        for (int j = 0; j < nkv; ++j, ++g) {
          const int s = g % STAGES, ph = ((g / STAGES) & 1) ^ 1;
          hopper::mbar_wait(&kempty[s], ph);
          hopper::mbar_expect_tx(&kfull[s], L::KV_BYTES);
          for (int c = 0; c < HD / BOX; ++c)
            hopper::tma_load_4d(sk + s * L::KV_BYTES + c * BKV *
                                hopper::ROW_BYTES, &mk, &kfull[s], c * BOX,
                                kvh, j * BKV, b);
          hopper::mbar_wait(&vempty[s], ph);
          hopper::mbar_expect_tx(&vfull[s], L::KV_BYTES);
          for (int c = 0; c < HD / BOX; ++c)
            hopper::tma_load_4d(sv + s * L::KV_BYTES + c * BKV *
                                hopper::ROW_BYTES, &mv, &vfull[s], c * BOX,
                                kvh, j * BKV, b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. +63 of an item;
  // this thread rows r0 and r0 + 8, key / column pairs 8n + 2(lane%4) of
  // every n8 block
  hopper::regs_alloc<CONSUMER_REGS>();
  const int warp = threadIdx.x / 32;
  const int rw = 64 * wg + 16 * (warp % 4) + lane / 4;   // r0 - q0
  const int cq = 2 * (lane % 4);
  const uint8_t* sqw = sq + 64 * wg * hopper::ROW_BYTES;

  float sacc[64], oacc[HD / 2], alpha[2], m[2], l[2];
  uint32_t pa[BKV / 16][4];  // P of the previous tile: the A operand of P V

  // S = Q K^T of ring slot s over h in k16 steps (32 bytes inside a
  // 128-byte row; a new box every 64 columns of h), committed as one group
  auto issue_s = [&](int s) {
    const uint8_t* kt = sk + s * L::KV_BYTES;
    hopper::fence_regs(sacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int off = (kk % 4) * 32;
      hopper::mma_ss<0, 0>(
          sacc,
          hopper::desc(sqw + (kk / 4) * BQ * hopper::ROW_BYTES + off, 16,
                       hopper::ATOM_BYTES),
          hopper::desc(kt + (kk / 4) * BKV * hopper::ROW_BYTES + off, 16,
                       hopper::ATOM_BYTES),
          kk > 0 ? 1 : 0);
    }
    hopper::wgmma_commit();
  };
  // O += P V of ring slot s over the tile's keys in k16 steps (16 rows of V
  // each)
  auto issue_pv = [&](int s) {
    const uint8_t* vt = sv + s * L::KV_BYTES;
    hopper::fence_regs(oacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
      hopper::mma_rs<1>(oacc, pa[kk],
                        hopper::desc(vt + kk * KSTEP_BYTES,
                                     BKV * hopper::ROW_BYTES,
                                     hopper::ATOM_BYTES),
                        1);
    hopper::wgmma_commit();
  };
  auto release = [&](uint64_t* bar) {
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(bar);
  };
  auto pack_p = [&]() {
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = hopper::pack_bf16(sacc[8 * kk + 2 * i],
                                      sacc[8 * kk + 2 * i + 1]);
  };
  // The two warpgroups take turns at issuing (ping-pong, named barriers 1
  // and 2), so that one's softmax runs while the other's products do.
  auto my_turn = [&]() { hopper::bar_sync(1 + wg, 256); };
  auto your_turn = [&]() { hopper::bar_arrive(2 - wg, 256); };
  if (wg == 1) your_turn();   // warpgroup 0 issues first

  // Per item: tile j's S product runs while tile j-1's P V does, and tile
  // j's softmax while P V is still in flight; O is rescaled by alpha_j only
  // once P V_j-1 is done, and P_j is packed only then (P V_j-1 reads
  // P_j-1's registers). g counts key tiles over the CTA's items.
  int g = 0, k = 0;
  for (int w = blockIdx.x; w < items.count(); w += gridDim.x, ++k) {
    int q0, head, b;
    items.at(w, q0, head, b);
    const int nkv = tiles_of(q0), qw = q0 + 64 * wg, r0 = q0 + rw;
    const bool last_item = w + (int)gridDim.x >= items.count();
    m[0] = m[1] = NEG_INF;
    l[0] = l[1] = 0.f;
#pragma unroll
    for (int j = 0; j < HD / 2; ++j) oacc[j] = 0.f;
    auto softmax = [&](int j) {
      const int k0 = j * BKV;
      const bool edge = k0 + BKV > S || (causal && k0 + BKV - 1 > qw);
      softmax_tile(sacc, m, l, alpha, edge, causal, k0, S, r0, cq,
                   scale_log2);
    };

    hopper::mbar_wait(qfull, k & 1);
    hopper::mbar_wait(&kfull[g % STAGES], (g / STAGES) & 1);
    my_turn();
    issue_s(g % STAGES);
    your_turn();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sacc);
    release(&kempty[g % STAGES]);
    if (nkv == 1) release(qempty);
    softmax(0);
    pack_p();
    for (int j = 1; j < nkv; ++j) {
      const int s = (g + j) % STAGES, sp = (g + j - 1) % STAGES;
      hopper::mbar_wait(&kfull[s], ((g + j) / STAGES) & 1);
      hopper::mbar_wait(&vfull[sp], ((g + j - 1) / STAGES) & 1);
      my_turn();
      issue_s(s);
      issue_pv(sp);
      your_turn();
      hopper::wgmma_wait<1>();   // S_j is done (P V_j-1 may still run)
      hopper::fence_regs(sacc);
      release(&kempty[s]);
      if (j == nkv - 1) release(qempty);   // Q is read for the last time
      softmax(j);
      hopper::wgmma_wait<0>();   // P V_j-1 is done
      hopper::fence_regs(oacc);
      release(&vempty[sp]);
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) oacc[4 * n + e] *= alpha[e >> 1];
      pack_p();
    }
    const int sl = (g + nkv - 1) % STAGES;
    hopper::mbar_wait(&vfull[sl], ((g + nkv - 1) / STAGES) & 1);
    my_turn();
    issue_pv(sl);
    if (!(last_item && wg == 1)) your_turn();   // the turns balance
    hopper::wgmma_wait<0>();
    hopper::fence_regs(oacc);
    release(&vempty[sl]);
    g += nkv;

    // o = O / max(l, 1e-30) in bf16; rows past T are not written
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int t = r0 + 8 * r;
      if (t >= Tq) continue;
      const float inv = 1.f / fmaxf(l[r], 1e-30f);
      __nv_bfloat16* orow =
          o + (((long long)b * Tq + t) * H + head) * HD + cq;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
            __floats2bfloat162_rn(oacc[4 * n + 2 * r] * inv,
                                  oacc[4 * n + 2 * r + 1] * inv);
    }
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Tq, int S, int H, int K, int causal, cudaStream_t st) {
  CUtensorMap mq, mk, mv;
  const cuuint64_t qdims[4] = {HD, (cuuint64_t)H, (cuuint64_t)Tq,
                               (cuuint64_t)B};
  const cuuint64_t qstr[3] = {HD * 2, (cuuint64_t)H * HD * 2,
                              (cuuint64_t)Tq * H * HD * 2};
  const cuuint64_t kdims[4] = {HD, (cuuint64_t)K, (cuuint64_t)S,
                               (cuuint64_t)B};
  const cuuint64_t kstr[3] = {HD * 2, (cuuint64_t)K * HD * 2,
                              (cuuint64_t)S * K * HD * 2};
  const cuuint32_t qbox[4] = {BOX, 1, BQ, 1};
  const cuuint32_t kbox[4] = {BOX, 1, BKV, 1};
  int dev = 0, sms = 0;
  int err = hopper::make_map(&mq, q, 4, qdims, qstr, qbox);
  if (!err) err = hopper::make_map(&mk, k, 4, kdims, kstr, kbox);
  if (!err) err = hopper::make_map(&mv, v, 4, kdims, kstr, kbox);
  if (!err) err = hopper::allow_smem(flash_wgmma_kernel<HD>, Smem<HD>::TOTAL);
  if (!err) err = (int)cudaGetDevice(&dev);
  if (!err)
    err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      dev);
  if (err) return err;
  const Items items{(Tq + BQ - 1) / BQ, H, B, causal};
  const int n = items.nq * H * B;
  flash_wgmma_kernel<HD><<<n < sms ? n : sms, THREADS, Smem<HD>::TOTAL, st>>>(
      mq, mk, mv, (__nv_bfloat16*)o, Tq, S, K, items,
      LOG2E / sqrtf((float)HD));
  return (int)cudaGetLastError();
}

}  // namespace

// q (B,T,H,h), k/v (B,S,K,h), o (B,T,H,h): contiguous bf16, 16-byte
// aligned; H a multiple of K; h = 64 or 128 (the wrapper checks).
extern "C" int dp_flash_attention_wgmma(const void* q, const void* k,
                                        const void* v, void* o, int B, int T,
                                        int S, int H, int K, int h,
                                        int causal, void* stream) {
  if (H % K) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (h == 64) return launch<64>(q, k, v, o, B, T, S, H, K, causal, st);
  if (h == 128) return launch<128>(q, k, v, o, B, T, S, H, K, causal, st);
  return (int)cudaErrorInvalidValue;
}
