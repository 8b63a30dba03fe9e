// moe_clipped_grad on the tensor cores: the clip-weighted gradient of an MoE
// expert tap over the per-(sample, expert) capacity layout, for bf16 records
// whose widths d and p are multiples of 8,
//
//     G_le = sum_b C_b a_lbe^T diag(m_lbe) g_lbe
//
//     a (L,B,E,C,d), mask m (L,B,E,C) f32, C (B,) f32, g (L,B,E,C,p)
//     -> (L,E,d,p) f32
//
// Replaces the TPU kernel repro/kernels/moe_ghost.py::moe_clipped_grad on
// the MoE train paths (f32 records and unaligned widths keep
// moe_clipped_grad.cu, the SIMT kernel). Bound on the H100: at
// deepseek-moe-16b (L=5, B=8, E=64, C=60; up d=2048, p=2816; down d=1408,
// p=2048) the f32 output alone is ~11 GB, ~3.3 ms of writes, and the
// products of the kept slots ~2 TFLOP, ~2 ms at the bf16 rate: the output
// bytes and the products are on a par, so the two must overlap. The SIMT
// kernel ran at ~22 TFLOP/s.
//
// It is clipped_grad_wgmma.cu's loop (wgmma_grad.cuh) with three changes:
// - a problem is a (layer, expert) pair: the records of (l, e, b) are box
//   z = (l B + b) E + e of 3-D maps (width, C, L*B*E), and TMA zero-fills
//   the rows past C in each (l, b, e), so a sample's 60 slots are read as
//   64 rows (one stage). Problems run slowest, so one (l, e)'s records
//   (~5 MB at the up tap) stay in L2 across its d x p tiles;
// - the slot mask: a pre-pass flags each sample's 64-row stage with its
//   k16 steps that hold a kept slot (the others are not issued: exact for
//   any mask; the router fills ~3/4 of the slots, kept ones first) and
//   with whether the mask must still be written on a; the model's records
//   are zero at empty slots, so none of theirs is, and other records wait
//   for a mask warp that masks the stage in shared memory (exact for 0/1
//   masks; a general f32 mask adds one bf16 rounding of m a_r, inside the
//   bf16 tolerance). With one stage a sample, two per-sample accumulators
//   keep sample b's products running while sample b - 1's are folded in;
// - the epilogue writes the f32 tile into shared memory and TMA-stores it
//   (cp.async.bulk.tensor), so the consumers start the next tile while the
//   last one drains. Ring (5 stages x 32 KB) + staging (64 KB) ~ 226 KB.
// C_b stays f32 and exact (total = fmaf(C_b, acc_b, total)); every output
// tile is written once, zeros included for an expert no sample reached; no
// atomics, one fixed order: bitwise equal run to run.
#include "slot_flags.cuh"

namespace {

using namespace wgmma_grad;

constexpr int BN = 128;

__global__ void __launch_bounds__(THREADS, 1)
    moe_grad_wgmma_kernel(const __grid_constant__ CUtensorMap ma,
                          const __grid_constant__ CUtensorMap mg,
                          const __grid_constant__ CUtensorMap mf,
                          const __grid_constant__ CUtensorMap mo,
                          const float* __restrict__ C,
                          const float* __restrict__ mask, int B, int E,
                          int Cap, int d, int p, Tiles tiles) {
  weighted_grad<BN, true>(&ma, &mg, &mf, &mo, C, mask, nullptr, B, E, Cap, d,
                          p, tiles);
}

}  // namespace

// a (L,B,E,C,d), ds (L,B,E,C,p) contiguous bf16, 16-byte aligned, d and p
// multiples of 8 (the wrapper checks); mask (L,B,E,C) f32; Cw (B,) f32;
// flags: scratch of 16 L B E ceil(C / 64) bytes, 16-byte aligned; out
// (L,E,d,p) f32.
extern "C" int dp_moe_clipped_grad_wgmma(const void* a, const float* mask,
                                         const float* Cw, const void* ds,
                                         void* flags, float* out, int L,
                                         int B, int E, int C, int d, int p,
                                         void* stream) {
  if (d % 8 || p % 8) return (int)cudaErrorInvalidValue;
  CUtensorMap ma, mg, mf, mo;
  const cuuint64_t Z = (cuuint64_t)L * B * E;
  const cuuint32_t box[3] = {BOX, BK, 1};
  const cuuint64_t adims[3] = {(cuuint64_t)d, (cuuint64_t)C, Z};
  const cuuint64_t astr[2] = {(cuuint64_t)d * 2, (cuuint64_t)C * d * 2};
  const cuuint64_t gdims[3] = {(cuuint64_t)p, (cuuint64_t)C, Z};
  const cuuint64_t gstr[2] = {(cuuint64_t)p * 2, (cuuint64_t)C * p * 2};
  // the output as (p, d, L*E) f32 in boxes of 32 columns x 64 rows: one
  // warpgroup's half of a tile is BN / 32 of them
  const cuuint32_t obox[3] = {OUT_BOX, 64, 1};
  const cuuint64_t odims[3] = {(cuuint64_t)p, (cuuint64_t)d,
                               (cuuint64_t)L * E};
  const cuuint64_t ostr[2] = {(cuuint64_t)p * 4, (cuuint64_t)d * p * 4};
  int err = hopper::make_map(&ma, a, 3, adims, astr, box);
  if (!err) err = hopper::make_map(&mg, ds, 3, gdims, gstr, box);
  if (!err)
    err = hopper::make_map(&mo, out, 3, odims, ostr, obox,
                           CU_TENSOR_MAP_DATA_TYPE_FLOAT32);
  cudaStream_t st = (cudaStream_t)stream;
  if (!err) err = slot_flags(&mf, a, mask, flags, (int)Z, C, d, st);
  if (err) return err;
  using Cf = Cfg<BN, true, BM * BN * 4>;
  const Tiles tiles{(d + BM - 1) / BM, (p + BN - 1) / BN, L * E, d <= p, BN};
  int grid = 0;
  err = hopper::allow_smem(moe_grad_wgmma_kernel, Cf::SMEM);
  if (!err) err = persistent_grid(tiles.nd * tiles.np * L * E, &grid);
  if (err) return err;
  moe_grad_wgmma_kernel<<<grid, THREADS, Cf::SMEM, st>>>(
      ma, mg, mf, mo, Cw, mask, B, E, C, d, p, tiles);
  return (int)cudaGetLastError();
}
