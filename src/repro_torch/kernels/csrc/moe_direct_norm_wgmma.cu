// moe_direct_norm on the tensor cores: per-sample squared gradient norms of
// an MoE expert tap by instantiation over the per-(sample, expert) capacity
// layout, for bf16 records whose widths d and p are multiples of 8,
//
//     n_b = sum_{l,e} || a_lbe^T diag(m_lbe) g_lbe ||_F^2
//
//     a (L,B,E,C,d), mask m (L,B,E,C) f32, g (L,B,E,C,p) -> (B,) f32
//
// Replaces the TPU kernel repro/kernels/moe_ghost.py::moe_direct_norm on the
// MoE train paths (f32 records and unaligned widths keep
// moe_direct_norm.cu, the SIMT kernel). Bound on the H100: 2 L B E C d p
// operations against L B E C (d+p) bf16 inputs, ~2 TFLOP of kept slots
// against ~1.5 GB at deepseek-moe-16b (L=5, B=8, E=64, C=60), so it is
// compute-bound and only wgmma reaches the bf16 rate; the SIMT kernel ran
// at ~21 TFLOP/s.
//
// The loop is wgmma_grad.cuh's direct_norm<true> (its producer, tile walk,
// slot flags and mask warp); each (l, b, e) is its own problem q = (l B +
// b) E + e, at depth q of 3-D maps (width, C, L*B*E) whose TMA zero-fill
// past C reads a sample's 60 slots as 64 rows. One CTA per SM walks the
// items (q, a 128-wide d strip), q slowest (neighbouring strips of one
// (l, b, e) share its g rows in L2), and streams the item's p tiles of 128
// columns through the ring, each stage holding the strip's a rows beside
// the tile's g rows: one ring for any C. (Loading the strip once per item,
// in a ring of its own, halves the stages' bytes and measured no faster on
// the H100: the bytes do not bound this loop.) For each p tile a consumer
// warpgroup issues the k16 steps of its 64 x 128 product that hold a kept
// slot (the stage's flags), and squares and sums the last tile's
// accumulator while this tile's products run. The records of the model
// are zero at empty slots, so no stage of theirs is flagged for masking;
// other records wait for the mask warp (exact for 0/1 masks; a general f32
// mask adds one bf16 rounding of m a_r, inside the bf16 tolerance).
//
// Each item writes one partial a warp, and a second pass sums each b's
// partials in a fixed order (no float atomics): bitwise equal run to run.
// With E = 1 and no mask this is grad_norm_direct's function:
// grad_norm_direct_wgmma.cu runs the same loop unmasked (direct_norm<false>).
#include "common.cuh"
#include "slot_flags.cuh"

namespace {

using namespace wgmma_grad;

constexpr int BN = 128;   // p columns of a tile (direct_norm's)
constexpr size_t SMEM = Cfg<BN, true>::SMEM;

// np: p tiles of an item; row_len: partials of one b
__global__ void __launch_bounds__(THREADS, 1)
    moe_norm_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                          const __grid_constant__ CUtensorMap mg,
                          const __grid_constant__ CUtensorMap mf,
                          const float* __restrict__ mask,
                          float* __restrict__ partial, int B, int E, int C,
                          int np, int row_len, Tiles tiles) {
  direct_norm<true>(&ma, &mg, &mf, mask, partial, B, E, C, np, row_len,
                    tiles);
}

}  // namespace

// Partials of one sample per (layer, expert): a warp's per d strip.
extern "C" int dp_moe_direct_norm_wgmma_nparts(int d) {
  return (d + BM - 1) / BM * CONSUMER_WARPS;
}

// a (L,B,E,C,d), ds (L,B,E,C,p) contiguous bf16, 16-byte aligned, d and p
// multiples of 8 (the wrapper checks); mask (L,B,E,C) f32; flags: scratch
// of 16 L B E ceil(C / 64) bytes, 16-byte aligned; partial
// (B, L * E * nparts(d)) f32 scratch; out (B,) f32.
extern "C" int dp_moe_direct_norm_wgmma(const void* a, const float* mask,
                                        const void* ds, void* flags,
                                        float* partial, float* out, int L,
                                        int B, int E, int C, int d, int p,
                                        void* stream) {
  if (d % 8 || p % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mg, mf;
  const cuuint64_t Z = (cuuint64_t)L * B * E;
  const cuuint32_t box[3] = {BOX, BK, 1};
  const cuuint64_t adims[3] = {(cuuint64_t)d, (cuuint64_t)C, Z};
  const cuuint64_t astr[2] = {(cuuint64_t)d * 2, (cuuint64_t)C * d * 2};
  const cuuint64_t gdims[3] = {(cuuint64_t)p, (cuuint64_t)C, Z};
  const cuuint64_t gstr[2] = {(cuuint64_t)p * 2, (cuuint64_t)C * p * 2};
  int err = hopper::make_map(&ma, a, 3, adims, astr, box);
  if (!err) err = hopper::make_map(&mg, ds, 3, gdims, gstr, box);
  cudaStream_t st = (cudaStream_t)stream;
  if (!err) err = slot_flags(&mf, a, mask, flags, (int)Z, C, d, st);
  if (err) return err;
  const int nd = (d + BM - 1) / BM, np = (p + BN - 1) / BN;
  const Tiles tiles{nd, 1, L * B * E, 1, BN};
  const int row_len = L * E * nd * CONSUMER_WARPS;
  int grid = 0;
  err = hopper::allow_smem(moe_norm_wgmma_kernel, SMEM);
  if (!err) err = persistent_grid(nd * L * B * E, &grid);
  if (err) return err;
  moe_norm_wgmma_kernel<<<grid, THREADS, SMEM, st>>>(ma, mg, mf, mask, partial,
                                                     B, E, C, np, row_len,
                                                     tiles);
  err = (int)cudaGetLastError();
  if (err) return err;
  reduce_rows_kernel<<<B, 256, 0, st>>>(partial, out, row_len);
  return (int)cudaGetLastError();
}
