// K6 and K7 — the block-diagonal grouped matmul of dropless MoE and its
// weight gradient, for Hopper (sm_90a).
//
// Replace the Pallas TPU kernels
//   kubeflow_tpu/compute/ops/grouped_matmul.py::_gmm_kernel   (K6, via _gmm_raw)
//   kubeflow_tpu/compute/ops/grouped_matmul.py::_tgmm_kernel  (K7, via _tgmm)
// which JAX joins with the custom VJP ``gmm``. Wrappers, plain PyTorch
// versions, launch counters and the autograd Function:
// ../grouped_matmul.py.
//
// What they compute. padded_group_layout lays the routed rows out so that
// every block_m-row tile belongs to ONE expert, block_expert[tile]:
//   K6  out[i] = x[i] @ w[block_expert[i / block_m]]     [m,k] x [e,k,n] -> [m,n]
//       fp32 sums rounded once to x's dtype (_gmm_kernel's
//       preferred_element_type=float32, then astype);
//   K7  dw[g] = sum over g's tiles of x_tile^T @ dy_tile  -> [e,k,n] fp32.
// The backward's dx is K6 on dout with the weights read transposed
// (TRANS_W: w is [e, n, k] in memory). That flag reads w^T through its
// strides instead of copying w.transpose(1, 2) (92 MB in bf16 for the
// flagship's gate|up weights, every layer, every backward).
//
// Bound on this card: operations. At the MoE flagship (8 experts, d 1024,
// ff 2816, 8 x 1024 tokens top-2 -> 17408 padded rows) a gate|up call is
// 200.8 GFLOP over 324 MB of x, w and out, ~620 FLOPs a byte, above the
// ~295 where an H100 leaves the memory roof: the least time is 0.203 ms at
// 989 TFLOP/s (bf16); a down call is half of that.
//
// fp32, K6 and K7 (the conformance path; TF32 off, exact products): one
// block of 256 threads owns a 64 x 128 output tile on the CUDA cores, 4 x
// 8 outputs a thread, and walks the reduction in steps of 16 through two
// shared-memory stages filled by cp.async (16-byte copies when every row
// starts on 16 bytes, element copies otherwise), so the next step's copy
// is in flight while this one is multiplied.
// bf16, K6 and K7: Hopper's warpgroup MMA (wgmma.cuh), m64n128k16 with
// fp32 accumulators, operands in 128-byte-swizzled shared memory, fed by
// a 4-stage cp.async ring (loads two steps ahead, one wgmma group in
// flight, one barrier a step, the proxy fence between). The walk's first
// product overwrites the accumulators (scale-d 0): zero-filling them
// instead is a non-wgmma write inside the pipeline, and ptxas then
// serializes every wgmma (its warning C7515, which chip_smoke.py's build
// phase refuses). 192 KB of shared memory: one block an SM.
// - K7 (gmm_dw_wgmma_kernel): dw = x^T dy reduces over the rows of both
//   operands, so both enter MN-major: each 64-row step of x (256 k
//   columns) and dy (128 n columns) lands as it sits in memory. Two
//   warpgroups, each owning 128 dw rows as two accumulators (2 x 64 fp32
//   a thread). The fp32 dw tile goes from the accumulators to memory in
//   8-byte stores. What bounds it now is most likely the L2 (not
//   confirmed: no profiler of stall reasons here): every 256 x 128 tile
//   reads 48 KB a step, so each of an expert's rows is read once by each
//   of its 8-44 column tiles and 4-11 row tiles, about 2.3 GB a call at
//   the MoE flagship's dw gate|up (≈ 5.8 TB/s at 0.40 ms); one expert's
//   28 MB of x and dy stay resident in the 50 MB L2 while its blocks run.
// - K6 (gmm_fwd_wgmma_kernel): the ordinary GEMM layout. A = x is
//   K-major (each step 128 rows x 64 k, one 128-byte row a row), B = w is
//   MN-major (64 k rows x 256 n, as K7's operands) or, for the dx sites
//   (TRANS_W: w stored [e, n, k]), K-major (256 n rows x 64 k). A 128 x
//   256 output tile, two warpgroups, each owning 64 rows as two
//   accumulators (the two 128-column halves). The row tile never crosses
//   a block_m boundary, so block_expert[row0 / block_m] names its only
//   expert: 128-row tiles where block_m is a multiple of 128, else 64-row
//   tiles (each warpgroup then owns one 128-column half). The fp32 sums
//   are rounded once to bf16 straight from the accumulators, staged in
//   shared memory and stored 16 bytes a thread (4-byte bf16x2 stores
//   straight from registers where a row is not a whole number of 16-byte
//   words). On an H100 it reaches about 430 TFLOP/s at the MoE
//   flagship's sites, 2.3x its bound; what holds it there is most likely
//   the ring itself (every thread issues 12 cp.async a step and waits at
//   one barrier; no TMA, no producer warp), not confirmed: no profiler of
//   stall reasons here.
// No TMA, no multicast across a cluster, no warp specialisation, no
// persistent blocks yet. Ragged k and n are masked here (zero-filled
// element copies into the same layouts, masked stores), so any width
// runs; Mosaic's 128-lane rule does not apply.
//   The TPU grid is (n, m) with m innermost so that a run of row tiles of
// one expert reuses the weight tile resident in VMEM (K6), and K7 carries
// an fp32 accumulator across sequential grid steps keyed by first/last.
// Blocks here run in parallel in no order, so: K6 orders its grid with the
// row tile fastest (blockIdx.x) — consecutive blocks then read the same
// expert's weight column tile out of the 50 MB L2, which is what the
// resident VMEM tile becomes; K7 gives each block one (k tile, n tile,
// expert) and a loop over that expert's contiguous row tiles inside the
// block, writing its dw tile once: no atomics, deterministic, an empty
// expert (one zero tile) writes zeros. Under skew one expert's blocks walk
// most of the rows; splitting the row loop over blocks with a second
// reduction pass is later work, as is fusing SiLU*up into the gate|up
// epilogue.

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace kubeflow;
using bf16 = __nv_bfloat16;

// ------------------------------------------------ fp32, CUDA cores

constexpr int kThreads = 256;          // 8 warps
constexpr int kBM = 64;                // tile rows: output rows (K6), k (K7)
constexpr int kBN = 128;               // tile columns
constexpr int kDepth = 16;             // reduction depth of a staged step
constexpr int kPad = 4;                // row padding of the staged tiles
constexpr int kLdC = kBN + 4;          // fp32 staging tile row stride
constexpr int kSmemBytes = 34 * 1024;  // the two stages, or the staging tile
static_assert(kBM * kLdC * sizeof(float) <= kSmemBytes, "staging tile fits");

// Copy the R x C window at (r0, c0) of a row-major global matrix with row
// stride ld into shared memory with row stride lds; entries at rows >= r_lim
// or columns >= c_lim read as 0. VEC: 16-byte cp.async copies (ld, c0 and
// c_lim multiples of 4, the base 16-byte aligned); otherwise element
// copies through registers.
template <int R, int C, bool VEC>
__device__ __forceinline__ void load_tile(float* dst, int lds,
                                          const float* src, size_t ld,
                                          int r0, int c0, int r_lim,
                                          int c_lim) {
  if constexpr (VEC) {
    constexpr int V = vec_width<float>();
    static_assert(C % V == 0, "rows split into 16-byte words");
    for (int u = threadIdx.x; u < R * C / V; u += kThreads) {
      const int r = u / (C / V);
      const int c = (u % (C / V)) * V;
      const bool ok = r0 + r < r_lim && c0 + c < c_lim;
      const float* g =
          ok ? src + static_cast<size_t>(r0 + r) * ld + (c0 + c) : src;
      cp_async16(smem_u32(dst + r * lds + c), g, ok);
    }
  } else {
    for (int u = threadIdx.x; u < R * C; u += kThreads) {
      const int r = u / C;
      const int c = u % C;
      const bool ok = r0 + r < r_lim && c0 + c < c_lim;
      dst[r * lds + c] =
          ok ? src[static_cast<size_t>(r0 + r) * ld + (c0 + c)] : 0.f;
    }
  }
}

// One block's kBM x kBN fp32 product, accumulated one staged step at a
// time. A (row i, reduction index p) sits in shared memory as As[i*lda + p]
// when A_ROW, else As[p*lda + i]; B (p, column j) as Bs[p*ldb + j] when
// B_ROW, else Bs[j*ldb + p]. Thread (ty, tx) owns rows ty + 16 s (s < 4)
// and columns tx + 16 t (t < 8); store() writes the tile to
// Cs[i*kLdC + j].
template <bool A_ROW, bool B_ROW> struct BlockGemm {
  float acc[4][8];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int t = 0; t < 8; ++t) acc[s][t] = 0.f;
  }

  __device__ __forceinline__ void step(const float* As, int lda,
                                       const float* Bs, int ldb) {
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int p = 0; p < kDepth; ++p) {
      float a[4], b[8];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        const int i = ty + 16 * s;
        a[s] = A_ROW ? As[i * lda + p] : As[p * lda + i];
      }
#pragma unroll
      for (int t = 0; t < 8; ++t) {
        const int j = tx + 16 * t;
        b[t] = B_ROW ? Bs[p * ldb + j] : Bs[j * ldb + p];
      }
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int t = 0; t < 8; ++t) acc[s][t] = fmaf(a[s], b[t], acc[s][t]);
    }
  }

  __device__ __forceinline__ void store(float* Cs) {
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int s = 0; s < 4; ++s)
#pragma unroll
      for (int t = 0; t < 8; ++t)
        Cs[(ty + 16 * s) * kLdC + tx + 16 * t] = acc[s][t];
  }
};

// The staged fp32 tile to out (row stride ldo) at (r0, c0); rows >= r_lim
// and columns >= c_lim are not written.
__device__ __forceinline__ void write_tile(const float* Cs, float* out,
                                           size_t ldo, int r0, int c0,
                                           int r_lim, int c_lim) {
  for (int u = threadIdx.x; u < kBM * kBN; u += kThreads) {
    const int r = u / kBN;
    const int c = u % kBN;
    if (r0 + r < r_lim && c0 + c < c_lim)
      out[static_cast<size_t>(r0 + r) * ldo + (c0 + c)] = Cs[r * kLdC + c];
  }
}

// K6 in fp32: one block per (64-row tile, 128-column tile), row tiles
// fastest.
template <bool TRANS_W, bool VEC>
__global__ void __launch_bounds__(kThreads)
gmm_fwd_kernel(const float* __restrict__ x,            // [m, k]
               const float* __restrict__ w,            // [e, k, n]; [e, n, k] if TRANS_W
               const int* __restrict__ block_expert,   // [m / block_m]
               float* __restrict__ out,                // [m, n]
               int m, int k, int n, int n_experts, int block_m) {
  constexpr int kLdA = kDepth + kPad;                        // As[kBM][kLdA]
  constexpr int kLdB = TRANS_W ? kDepth + kPad : kBN + kPad;
  constexpr int kStageA = kBM * kLdA;
  constexpr int kStageB = TRANS_W ? kBN * kLdB : kDepth * kLdB;
  static_assert(2 * (kStageA + kStageB) * sizeof(float) <= kSmemBytes,
                "two stages fit");
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + 2 * kStageA;

  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  // the tile's expert: scalar prefetch on the TPU, read by the block here
  const int g = block_expert[row0 / block_m];
  BlockGemm<true, !TRANS_W> gemm;
  gemm.zero();
  if (g >= 0 && g < n_experts) {
    const float* wg = w + static_cast<size_t>(g) * k * n;
    auto load = [&](int stage, int p0) {
      load_tile<kBM, kDepth, VEC>(As + stage * kStageA, kLdA, x, k, row0,
                                  p0, m, k);
      if constexpr (TRANS_W)
        load_tile<kBN, kDepth, VEC>(Bs + stage * kStageB, kLdB, wg, k, col0,
                                    p0, n, k);
      else
        load_tile<kDepth, kBN, VEC>(Bs + stage * kStageB, kLdB, wg, n, p0,
                                    col0, k, n);
    };
    const int steps = (k + kDepth - 1) / kDepth;
    load(0, 0);
    cp_async_commit();
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) load((s + 1) & 1, (s + 1) * kDepth);
      cp_async_commit();
      cp_async_wait<1>();   // step s's copies have landed
      __syncthreads();
      gemm.step(As + (s & 1) * kStageA, kLdA, Bs + (s & 1) * kStageB, kLdB);
      __syncthreads();       // step s's stage may be overwritten
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  gemm.store(Cs);
  __syncthreads();
  write_tile(Cs, out, n, row0, col0, m, n);
}

// K7 in fp32: one block per (64-row k tile, 128-column n tile, expert),
// walking the expert's row tiles [tiles[2g], tiles[2g+1]) in steps of
// kDepth rows.
template <bool VEC>
__global__ void __launch_bounds__(kThreads)
gmm_dw_kernel(const float* __restrict__ x,    // [m, k]
              const float* __restrict__ dy,   // [m, n]
              const int* __restrict__ tiles,  // [e, 2] row-tile range
              float* __restrict__ dw,         // [e, k, n]
              int m, int k, int n, int block_m) {
  // A = x^T: its reduction index is x's row, so the x tile is kept as it
  // sits in memory (As[row][k], k contiguous) and read as a column-major A
  constexpr int kLdA = kBM + kPad;
  constexpr int kLdB = kBN + kPad;
  constexpr int kStageA = kDepth * kLdA;
  constexpr int kStageB = kDepth * kLdB;
  static_assert(2 * (kStageA + kStageB) * sizeof(float) <= kSmemBytes,
                "two stages fit");
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  float* As = reinterpret_cast<float*>(smem);
  float* Bs = As + 2 * kStageA;

  const int k0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int g = blockIdx.z;
  const int r_begin = tiles[2 * g] * block_m;
  const int r_end = min(m, tiles[2 * g + 1] * block_m);
  BlockGemm<false, true> gemm;
  gemm.zero();
  if (r_end > r_begin) {
    auto load = [&](int stage, int r0) {
      load_tile<kDepth, kBM, VEC>(As + stage * kStageA, kLdA, x, k, r0, k0,
                                  r_end, k);
      load_tile<kDepth, kBN, VEC>(Bs + stage * kStageB, kLdB, dy, n, r0, n0,
                                  r_end, n);
    };
    const int steps = (r_end - r_begin + kDepth - 1) / kDepth;
    load(0, r_begin);
    cp_async_commit();
    for (int s = 0; s < steps; ++s) {
      if (s + 1 < steps) load((s + 1) & 1, r_begin + (s + 1) * kDepth);
      cp_async_commit();
      cp_async_wait<1>();
      __syncthreads();
      gemm.step(As + (s & 1) * kStageA, kLdA, Bs + (s & 1) * kStageB, kLdB);
      __syncthreads();
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  gemm.store(Cs);
  __syncthreads();
  write_tile(Cs, dw + static_cast<size_t>(g) * k * n, n, k0, n0, k, n);
}

// ------------------------------------------------ bf16, wgmma (K7, K6)

constexpr int kWgThreads = 256;   // 2 warpgroups
constexpr int kWgDepth = 64;      // reduction indices a step: a 128-byte row
constexpr int kWgStages = 4;      // loads run 2 steps ahead, 1 wgmma group
constexpr int kAtomBytes = kWgDepth * 128;   // an MN-major atom column
constexpr int kStageBytes = 48 * 1024;       // one stage of either kernel
constexpr size_t kWgSmemBytes = kWgStages * kStageBytes + 1024;  // + align

// Rows [r0, r0 + R) x columns [c0, c0 + C) of a row-major bf16 matrix
// (row stride ld) into C / 64 swizzled atom columns at smem (wgmma.cuh),
// each R rows of 128 bytes: column c0 + 64 a + 8 q + i of row r at byte
// a * 128 R + 128 r + 16 (q ^ r % 8) + 2 i. MN-major when a row is one
// reduction index, K-major when C is 64 and a row is one M or N index.
// Rows >= r_lim and columns >= c_lim land as 0. VEC: 16-byte cp.async
// copies (ld, c0 and c_lim multiples of 8, the base 16-byte aligned);
// otherwise element copies through registers.
template <int R, int C, bool VEC>
__device__ __forceinline__ void load_swizzled(unsigned char* smem,
                                              const bf16* src, size_t ld,
                                              int r0, int c0, int r_lim,
                                              int c_lim) {
  auto at = [](int r, int c16) {   // byte offset of chunk c16 of row r
    return (c16 / 8) * (R * 128) + r * 128 + (((c16 % 8) ^ (r % 8)) << 4);
  };
  if constexpr (VEC) {
    constexpr int kChunks = C / 8;
    static_assert(R * kChunks % kWgThreads == 0, "whole rounds");
#pragma unroll
    for (int i = 0; i < R * kChunks / kWgThreads; ++i) {
      const int u = threadIdx.x + i * kWgThreads;
      const int r = u / kChunks;
      const int c16 = u % kChunks;
      const bool ok = r0 + r < r_lim && c0 + c16 * 8 < c_lim;
      const bf16* g =
          ok ? src + static_cast<size_t>(r0 + r) * ld + c0 + c16 * 8 : src;
      cp_async16(smem_u32(smem + at(r, c16)), g, ok);
    }
  } else {
    for (int u = threadIdx.x; u < R * C; u += kWgThreads) {
      const int r = u / C;
      const int c = u % C;
      const bool ok = r0 + r < r_lim && c0 + c < c_lim;
      *reinterpret_cast<bf16*>(smem + at(r, c / 8) + (c % 8) * 2) =
          ok ? src[static_cast<size_t>(r0 + r) * ld + c0 + c]
             : from_f32<bf16>(0.f);
    }
  }
}

// ----- K7

constexpr int kDwBM = 256;        // dw rows (k) a block: 4 atoms of 64
constexpr int kDwBN = 128;        // dw columns (n) a block: 2 atoms of 64
constexpr int kDwStageA = kDwBM / 64 * kAtomBytes;     // x tile, 32 KB
static_assert(kDwStageA + kDwBN / 64 * kAtomBytes == kStageBytes, "48 KB");

// K7 in bf16: one block per (256-row k tile, 128-column n tile, expert),
// walking the expert's row tiles [tiles[2g], tiles[2g+1]) 64 rows a step.
// dw = x^T dy is an MN-major product on both sides: the step's x rows are
// A's K rows (A = x^T, its M = k contiguous in memory) and its dy rows
// are B's K rows (its N = n contiguous). Warpgroup w owns dw rows
// 128 w .. 128 w + 127 of the tile: two m64n128k16 a 16-row slice.
template <bool VEC>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_dw_wgmma_kernel(const bf16* __restrict__ x,     // [m, k]
                    const bf16* __restrict__ dy,    // [m, n]
                    const int* __restrict__ tiles,  // [e, 2] row-tile range
                    float* __restrict__ dw,         // [e, k, n]
                    int m, int k, int n, int block_m) {
  extern __shared__ unsigned char dw_smem_raw[];
  // the atoms' swizzle is keyed to address bits [7, 10): align to 1024
  // (written out here: through a helper function, ptxas scheduled this
  // kernel's loads otherwise and it ran 3 % slower)
  unsigned char* smem =
      dw_smem_raw + ((1024 - (smem_u32(dw_smem_raw) & 1023)) & 1023);

  const int k0 = blockIdx.x * kDwBM;
  const int n0 = blockIdx.y * kDwBN;
  const int g = blockIdx.z;
  const int r_begin = tiles[2 * g] * block_m;
  const int r_end = min(m, tiles[2 * g + 1] * block_m);
  const int steps =
      r_end > r_begin ? (r_end - r_begin + kWgDepth - 1) / kWgDepth : 0;
  const int wg = threadIdx.x / 128;

  auto load = [&](int step) {
    if (step < steps) {
      unsigned char* stage = smem + (step % kWgStages) * kStageBytes;
      const int r0 = r_begin + step * kWgDepth;
      load_swizzled<kWgDepth, kDwBM, VEC>(stage, x, k, r0, k0, r_end, k);
      load_swizzled<kWgDepth, kDwBN, VEC>(stage + kDwStageA, dy, n, r0, n0,
                                          r_end, n);
    }
    cp_async_commit();   // an empty group past the last step keeps the count
  };
  load(0);
  load(1);

  // step 0's descriptors: this warpgroup's first A atom, B's two atoms
  // LBO apart; groups of 8 rows are 1024 bytes apart (SBO)
  const uint32_t base = smem_u32(smem);
  const uint64_t a_desc =
      wgmma_desc_sw128(base + 2 * wg * kAtomBytes, kAtomBytes, 1024);
  const uint64_t b_desc =
      wgmma_desc_sw128(base + kDwStageA, kAtomBytes, 1024);

  // no zero fill: the first product of the walk overwrites (scale-d 0)
  float acc[2][64];
  for (int s = 0; s < steps; ++s) {
    // one barrier a step: step s has landed for every thread (and is
    // visible to wgmma), every warpgroup's wgmma of step s - 2 is done,
    // so its stage takes step s + 2's copies
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    load(s + 2);
    const uint64_t stage = (s % kWgStages) * (kStageBytes >> 4);
    wgmma_fence_operand(acc[0]);
    wgmma_fence_operand(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgDepth / 16; ++kk) {
      const uint64_t off = stage + kk * (2048 >> 4);   // 16 rows further
      const bool accumulate = s > 0 || kk > 0;
      wgmma_m64n128k16<1, 1>(acc[0], a_desc + off, b_desc + off, accumulate);
      wgmma_m64n128k16<1, 1>(acc[1], a_desc + off + (kAtomBytes >> 4),
                             b_desc + off, accumulate);
    }
    wgmma_commit();
    wgmma_fence_operand(acc[0]);
    wgmma_fence_operand(acc[1]);
    wgmma_wait<1>();   // step s - 1's products are done
  }
  wgmma_wait<0>();
  wgmma_fence_operand(acc[0]);
  wgmma_fence_operand(acc[1]);
  cp_async_wait<0>();
  if (steps == 0) {   // an expert with no rows: its dw is 0
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[i][j] = 0.f;
  }

  // fp32 straight from the accumulators, 8 bytes a store where n is even
  const int lane = threadIdx.x % 32;
  const int row0 = k0 + 128 * wg + 16 * (threadIdx.x % 128 / 32) + lane / 4;
  const int col0 = n0 + 2 * (lane % 4);
  float* dwg = dw + static_cast<size_t>(g) * k * n;
  const bool pairs = n % 2 == 0;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row0 + 64 * i + 8 * half;
      if (row >= k) continue;
      float* dst = dwg + static_cast<size_t>(row) * n;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int col = col0 + 8 * j;
        const float v0 = acc[i][4 * j + 2 * half];
        const float v1 = acc[i][4 * j + 2 * half + 1];
        if (pairs && col + 1 < n) {
          *reinterpret_cast<float2*>(dst + col) = make_float2(v0, v1);
        } else {
          if (col < n) dst[col] = v0;
          if (col + 1 < n) dst[col + 1] = v1;
        }
      }
    }
}

// ----- K6

constexpr int kFwBN = 256;              // output columns a block: 2 halves
constexpr int kFwStageA = 128 * 128;    // x tile: up to 128 rows x 128 bytes
static_assert(kFwStageA + kWgDepth * kFwBN * 2 == kStageBytes, "48 KB");
constexpr int kFwLdS = kFwBN + 8;       // bf16 staging tile row stride

// K6 in bf16: one block per (BM-row tile, 256-column tile), row tiles
// fastest (blockIdx.x), walking k 64 a step. BM = 128: warpgroup w owns
// rows 64 w .. 64 w + 63 and both 128-column halves (two accumulators);
// BM = 64: warpgroup w owns the 64 rows and the half w. A = x K-major; B
// = w[g] MN-major ([k, n], n contiguous) or, TRANS_W, K-major ([n, k]).
template <int BM, bool TRANS_W, bool VEC>
__global__ void __launch_bounds__(kWgThreads, 1)
gmm_fwd_wgmma_kernel(const bf16* __restrict__ x,             // [m, k]
                     const bf16* __restrict__ w,             // [e, k, n]; [e, n, k] if TRANS_W
                     const int* __restrict__ block_expert,   // [m / block_m]
                     bf16* __restrict__ out,                 // [m, n]
                     int m, int k, int n, int n_experts, int block_m) {
  static_assert(BM == 64 || BM == 128, "one or two 64-row slices");
  constexpr int kAcc = BM / 64;   // accumulators a warpgroup
  extern __shared__ unsigned char fw_smem_raw[];
  // aligned to 1024, as K7's
  unsigned char* smem =
      fw_smem_raw + ((1024 - (smem_u32(fw_smem_raw) & 1023)) & 1023);

  const int row0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * kFwBN;
  const int wg = threadIdx.x / 128;
  // the tile's expert: scalar prefetch on the TPU, read by the block here;
  // a padding tile's (out of range) output is 0
  const int g = block_expert[row0 / block_m];
  const bool live = g >= 0 && g < n_experts;
  const int steps = live ? (k + kWgDepth - 1) / kWgDepth : 0;
  const bf16* wg_w = w + static_cast<size_t>(live ? g : 0) * k * n;

  auto load = [&](int step) {
    if (step < steps) {
      unsigned char* stage = smem + (step % kWgStages) * kStageBytes;
      const int p0 = step * kWgDepth;
      load_swizzled<BM, kWgDepth, VEC>(stage, x, k, row0, p0, m, k);
      if constexpr (TRANS_W)
        load_swizzled<kFwBN, kWgDepth, VEC>(stage + kFwStageA, wg_w, k,
                                            col0, p0, n, k);
      else
        load_swizzled<kWgDepth, kFwBN, VEC>(stage + kFwStageA, wg_w, n, p0,
                                            col0, k, n);
    }
    cp_async_commit();   // an empty group past the last step keeps the count
  };
  load(0);
  load(1);

  // step 0's descriptors. A (K-major): this warpgroup's 64 rows, groups
  // of 8 rows 1024 bytes apart. B: MN-major atoms of 64 columns LBO apart,
  // or K-major rows like A's; either way the second 128-column half is
  // 16 KB further on. The next k16 slice: 32 bytes along a K-major row,
  // 16 rows (2048 bytes) down an MN-major atom.
  const uint32_t base = smem_u32(smem);
  const uint64_t a_desc = wgmma_desc_sw128(
      base + (kAcc == 2 ? wg * 64 * 128 : 0), 16, 1024);
  const uint64_t b_desc = wgmma_desc_sw128(base + kFwStageA,
                                           TRANS_W ? 16 : kAtomBytes, 1024);
  constexpr uint64_t kBk16 = TRANS_W ? 32 >> 4 : 2048 >> 4;
  constexpr uint64_t kHalf = (128 * 128) >> 4;
  uint64_t b_half[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) b_half[i] = (kAcc == 2 ? i : wg) * kHalf;

  // no zero fill: the first product of the walk overwrites (scale-d 0)
  float acc[kAcc][64];
  for (int s = 0; s < steps; ++s) {
    // one barrier a step, as K7's
    cp_async_wait<1>();
    fence_proxy_async();
    __syncthreads();
    load(s + 2);
    const uint64_t stage = (s % kWgStages) * (kStageBytes >> 4);
#pragma unroll
    for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(acc[i]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kWgDepth / 16; ++kk) {
      const bool accumulate = s > 0 || kk > 0;
#pragma unroll
      for (int i = 0; i < kAcc; ++i)
        wgmma_m64n128k16<0, TRANS_W ? 0 : 1>(
            acc[i], a_desc + stage + kk * (32 >> 4),
            b_desc + stage + b_half[i] + kk * kBk16, accumulate);
    }
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(acc[i]);
    wgmma_wait<1>();   // step s - 1's products are done
  }
  wgmma_wait<0>();
#pragma unroll
  for (int i = 0; i < kAcc; ++i) wgmma_fence_operand(acc[i]);
  cp_async_wait<0>();
  if (steps == 0) {   // a padding tile, or k = 0: the output is 0
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int j = 0; j < 64; ++j) acc[i][j] = 0.f;
  }

  // thread (warp v of warpgroup wg, lane 4 q + t) holds rows r_loc and
  // r_loc + 8, columns c_loc[i] + 8 j + {0, 1} of accumulator i
  const int lane = threadIdx.x % 32;
  const int r_loc = (kAcc == 2 ? 64 * wg : 0) +
                    16 * (threadIdx.x % 128 / 32) + lane / 4;
  int c_loc[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i)
    c_loc[i] = 128 * (kAcc == 2 ? i : wg) + 2 * (lane % 4);

  if constexpr (VEC) {
    // the rounded tile through shared memory, then 16-byte stores: 9 %
    // faster at gate|up than 4-byte stores straight from the accumulators
    // (hack/gmm_ab.py); every warpgroup's products are done before the
    // stages are reused
    __syncthreads();
    bf16* tile = reinterpret_cast<bf16*>(smem);   // [BM][kFwLdS]
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int j = 0; j < 16; ++j)
          *reinterpret_cast<__nv_bfloat162*>(
              tile + (r_loc + 8 * half) * kFwLdS + c_loc[i] + 8 * j) =
              __floats2bfloat162_rn(acc[i][4 * j + 2 * half],
                                    acc[i][4 * j + 2 * half + 1]);
    __syncthreads();
    constexpr int kChunks = kFwBN / 8;   // 16-byte words a row
    for (int u = threadIdx.x; u < BM * kChunks; u += kWgThreads) {
      const int r = u / kChunks;
      const int c = (u % kChunks) * 8;
      if (row0 + r < m && col0 + c < n)   // n % 8 == 0: whole words
        *reinterpret_cast<uint4*>(out + static_cast<size_t>(row0 + r) * n +
                                  col0 + c) =
            *reinterpret_cast<const uint4*>(tile + r * kFwLdS + c);
    }
  } else {
    // rows not a whole number of 16-byte words: 4-byte bf16x2 stores where
    // n is even, else one value at a time
    const bool pairs = n % 2 == 0;
#pragma unroll
    for (int i = 0; i < kAcc; ++i)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = row0 + r_loc + 8 * half;
        if (row >= m) continue;
        bf16* dst = out + static_cast<size_t>(row) * n;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int col = col0 + c_loc[i] + 8 * j;
          const float v0 = acc[i][4 * j + 2 * half];
          const float v1 = acc[i][4 * j + 2 * half + 1];
          if (pairs && col + 1 < n) {
            *reinterpret_cast<__nv_bfloat162*>(dst + col) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            if (col < n) dst[col] = from_f32<bf16>(v0);
            if (col + 1 < n) dst[col + 1] = from_f32<bf16>(v1);
          }
        }
      }
  }
}

// ------------------------------------------------ launches, dispatch

// the kernel's dynamic shared memory limit, raised once per instantiation
template <typename Kernel>
int allow_smem(Kernel kernel, bool& attribute_set) {
  if (attribute_set) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kWgSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  attribute_set = true;
  return 0;
}

template <bool TRANS_W, bool VEC>
int launch_fwd(const void* x, const void* w, const void* block_expert,
               void* out, int m, int k, int n, int n_experts, int block_m,
               cudaStream_t stream) {
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  gmm_fwd_kernel<TRANS_W, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const int*>(block_expert), static_cast<float*>(out), m, k,
      n, n_experts, block_m);
  return static_cast<int>(cudaGetLastError());
}

template <int BM, bool TRANS_W, bool VEC>
int launch_fwd_wgmma(const void* x, const void* w, const void* block_expert,
                     void* out, int m, int k, int n, int n_experts,
                     int block_m, cudaStream_t stream) {
  static bool attribute_set = false;
  if (int err = allow_smem(gmm_fwd_wgmma_kernel<BM, TRANS_W, VEC>,
                           attribute_set))
    return err;
  const dim3 grid(m / BM, (n + kFwBN - 1) / kFwBN);
  gmm_fwd_wgmma_kernel<BM, TRANS_W, VEC>
      <<<grid, kWgThreads, kWgSmemBytes, stream>>>(
          static_cast<const bf16*>(x), static_cast<const bf16*>(w),
          static_cast<const int*>(block_expert), static_cast<bf16*>(out), m,
          k, n, n_experts, block_m);
  return static_cast<int>(cudaGetLastError());
}

// K6 in bf16: 128-row tiles where block_m allows them, else 64
template <int BM>
int dispatch_fwd_wgmma(bool trans_w, bool vec, const void* x, const void* w,
                       const void* block_expert, void* out, int m, int k,
                       int n, int n_experts, int block_m, cudaStream_t s) {
  if (trans_w)
    return vec ? launch_fwd_wgmma<BM, true, true>(x, w, block_expert, out, m,
                                                  k, n, n_experts, block_m, s)
               : launch_fwd_wgmma<BM, true, false>(x, w, block_expert, out,
                                                   m, k, n, n_experts,
                                                   block_m, s);
  return vec ? launch_fwd_wgmma<BM, false, true>(x, w, block_expert, out, m,
                                                 k, n, n_experts, block_m, s)
             : launch_fwd_wgmma<BM, false, false>(x, w, block_expert, out, m,
                                                  k, n, n_experts, block_m,
                                                  s);
}

template <bool VEC>
int launch_dw_wgmma(const void* x, const void* dy, const void* tiles,
                    void* dw, int m, int k, int n, int n_experts,
                    int block_m, cudaStream_t stream) {
  static bool attribute_set = false;
  if (int err = allow_smem(gmm_dw_wgmma_kernel<VEC>, attribute_set))
    return err;
  const dim3 grid((k + kDwBM - 1) / kDwBM, (n + kDwBN - 1) / kDwBN,
                  n_experts);
  gmm_dw_wgmma_kernel<VEC><<<grid, kWgThreads, kWgSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const int*>(tiles), static_cast<float*>(dw), m, k, n,
      block_m);
  return static_cast<int>(cudaGetLastError());
}

template <bool VEC>
int launch_dw(const void* x, const void* dy, const void* tiles, void* dw,
              int m, int k, int n, int n_experts, int block_m,
              cudaStream_t stream) {
  const dim3 grid((k + kBM - 1) / kBM, (n + kBN - 1) / kBN, n_experts);
  gmm_dw_kernel<VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(dy),
      static_cast<const int*>(tiles), static_cast<float*>(dw), m, k, n,
      block_m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
bool vectorizable(int k, int n) {
  return k % vec_width<T>() == 0 && n % vec_width<T>() == 0;
}

bool bad_layout(int m, int k, int n, int n_experts, int block_m) {
  return m < 0 || k < 0 || n < 0 || n_experts < 1 || n_experts > 65535 ||
         block_m < kBM || block_m % kBM != 0 || m % block_m != 0 ||
         (n + kBN - 1) / kBN > 65535;
}

}  // namespace

// K6. dtype: 0 = float32, 1 = bfloat16; trans_w: w is [e, n, k] in memory.
// Operands 16-byte aligned; block_m a multiple of 64 dividing m. Returns a
// cudaError_t (0 = launched).
extern "C" int kubeflow_gmm(const void* x, const void* w,
                            const void* block_expert, void* out, int m, int k,
                            int n, int n_experts, int block_m, int trans_w,
                            int dtype, void* stream) {
  if (bad_layout(m, k, n, n_experts, block_m))
    return static_cast<int>(cudaErrorInvalidValue);
  if (m == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool trans = trans_w != 0;
  if (dtype == 0) {
    const bool vec = vectorizable<float>(k, n);
    if (trans)
      return vec ? launch_fwd<true, true>(x, w, block_expert, out, m, k, n,
                                          n_experts, block_m, s)
                 : launch_fwd<true, false>(x, w, block_expert, out, m, k, n,
                                           n_experts, block_m, s);
    return vec ? launch_fwd<false, true>(x, w, block_expert, out, m, k, n,
                                         n_experts, block_m, s)
               : launch_fwd<false, false>(x, w, block_expert, out, m, k, n,
                                          n_experts, block_m, s);
  }
  if (dtype == 1) {
    const bool vec = vectorizable<bf16>(k, n);
    return block_m % 128 == 0
               ? dispatch_fwd_wgmma<128>(trans, vec, x, w, block_expert, out,
                                         m, k, n, n_experts, block_m, s)
               : dispatch_fwd_wgmma<64>(trans, vec, x, w, block_expert, out,
                                        m, k, n, n_experts, block_m, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7. tiles: int32 [e, 2], each expert's first row tile and one past its
// last. dw: fp32 [e, k, n]. Returns a cudaError_t (0 = launched).
extern "C" int kubeflow_gmm_dw(const void* x, const void* dy,
                               const void* tiles, void* dw, int m, int k,
                               int n, int n_experts, int block_m, int dtype,
                               void* stream) {
  if (bad_layout(m, k, n, n_experts, block_m))
    return static_cast<int>(cudaErrorInvalidValue);
  if (k == 0 || n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return vectorizable<float>(k, n)
               ? launch_dw<true>(x, dy, tiles, dw, m, k, n, n_experts,
                                 block_m, s)
               : launch_dw<false>(x, dy, tiles, dw, m, k, n, n_experts,
                                  block_m, s);
  if (dtype == 1)
    return vectorizable<bf16>(k, n)
               ? launch_dw_wgmma<true>(x, dy, tiles, dw, m, k, n, n_experts,
                                       block_m, s)
               : launch_dw_wgmma<false>(x, dy, tiles, dw, m, k, n,
                                        n_experts, block_m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
