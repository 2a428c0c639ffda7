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
// K6, and K7 in fp32. One block of 256 threads owns a 64 x 128 output
// tile and walks the reduction in steps of 32 (bf16) or 16 (fp32) through
// two shared-memory stages filled by cp.async (16-byte copies when every
// row starts on 16 bytes, element copies otherwise), so the next step's
// copy is in flight while this one is multiplied. K6 in bf16 runs on the
// tensor cores through wmma (mma.sync 16x16x16, fp32 accumulators; each
// of the 8 warps holds 32 x 32 of the tile); fp32 runs on the CUDA cores
// (the conformance path; TF32 off, exact products), 4 x 8 outputs a
// thread. Bound by the issue of wmma fragment loads, which take as many
// slots as the products, and of the staging tile's 4-byte stores.
// K7 in bf16 (gmm_dw_wgmma_kernel): Hopper's warpgroup MMA (wgmma.cuh).
// dw = x^T dy reduces over the rows of both operands, so both enter
// MN-major: each 64-row step of x (256 k columns) and dy (128 n
// columns) lands as it sits in memory, in atoms of 64 columns x 64 rows
// with the 128-byte swizzle, through a 4-stage cp.async ring (loads two
// steps ahead, one wgmma group in flight, one barrier a step, the proxy
// fence between). Two warpgroups, each owning 128 dw rows as two
// m64n128k16 accumulators (2 x 64 fp32 a thread); the walk's first
// product overwrites them (scale-d 0): zero-filling them instead is a
// non-wgmma write inside the pipeline, and ptxas then serializes every
// wgmma. The fp32 dw tile goes from the accumulators to memory in 8-byte
// stores. 192 KB of shared
// memory: one block an SM. What bounds it now is most likely the L2
// (not confirmed: no profiler of stall reasons here): every 256 x 128
// tile reads 48 KB a step, so each of an expert's rows is read once by
// each of its 8-44 column tiles and 4-11 row tiles, about 2.3 GB a call
// at the MoE flagship's dw gate|up (≈ 5.8 TB/s at 0.40 ms); one expert's
// 28 MB of x and dy stay resident in the 50 MB L2 while its blocks run.
// No TMA, no multicast across a cluster, no warp specialisation yet. Ragged k and n are masked here (zero-filled
// copies, masked stores), so any width runs; Mosaic's 128-lane rule does
// not apply.
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
// reduction pass is later work, as are K6 on wgmma and fusing SiLU*up
// into the gate|up epilogue.

#include <mma.h>

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using namespace kubeflow;
namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;          // 8 warps
constexpr int kBM = 64;                // tile rows: output rows (K6), k (K7)
constexpr int kBN = 128;               // tile columns
constexpr int kLdC = kBN + 4;          // fp32 staging tile row stride
constexpr int kSmemBytes = 34 * 1024;  // the two stages, or the staging tile
static_assert(kBM * kLdC * sizeof(float) <= kSmemBytes, "staging tile fits");

// reduction depth of one staged step and the row padding of its tiles
template <typename T> struct Step;
template <> struct Step<bf16> { static constexpr int kDepth = 32, kPad = 8; };
template <> struct Step<float> { static constexpr int kDepth = 16, kPad = 4; };

// Copy the R x C window at (r0, c0) of a row-major global matrix with row
// stride ld into shared memory with row stride lds; entries at rows >= r_lim
// or columns >= c_lim read as 0. VEC: 16-byte cp.async copies (ld, c0 and
// c_lim multiples of the vector width, the base 16-byte aligned); otherwise
// element copies through registers.
template <typename T, int R, int C, bool VEC>
__device__ __forceinline__ void load_tile(T* dst, int lds, const T* src,
                                          size_t ld, int r0, int c0,
                                          int r_lim, int c_lim) {
  if constexpr (VEC) {
    constexpr int V = vec_width<T>();
    static_assert(C % V == 0, "rows split into 16-byte words");
    for (int u = threadIdx.x; u < R * C / V; u += kThreads) {
      const int r = u / (C / V);
      const int c = (u % (C / V)) * V;
      const bool ok = r0 + r < r_lim && c0 + c < c_lim;
      const T* g = ok ? src + static_cast<size_t>(r0 + r) * ld + (c0 + c)
                      : src;
      cp_async16(smem_u32(dst + r * lds + c), g, ok);
    }
  } else {
    for (int u = threadIdx.x; u < R * C; u += kThreads) {
      const int r = u / C;
      const int c = u % C;
      const bool ok = r0 + r < r_lim && c0 + c < c_lim;
      dst[r * lds + c] = ok ? src[static_cast<size_t>(r0 + r) * ld + (c0 + c)]
                            : from_f32<T>(0.f);
    }
  }
}

// One block's kBM x kBN fp32 product, accumulated one staged step at a
// time. A (row i, reduction index p) sits in shared memory as As[i*lda + p]
// when A_ROW, else As[p*lda + i]; B (p, column j) as Bs[p*ldb + j] when
// B_ROW, else Bs[j*ldb + p]. store() writes the tile to Cs[i*kLdC + j].
template <typename T, bool A_ROW, bool B_ROW> struct BlockGemm;

// bf16 on the tensor cores: warp w owns rows 32*(w/4) and columns 32*(w%4)
// as 2 x 2 wmma fragments of 16 x 16, fp32 accumulators.
template <bool A_ROW, bool B_ROW> struct BlockGemm<bf16, A_ROW, B_ROW> {
  using ALayout = std::conditional_t<A_ROW, wmma::row_major, wmma::col_major>;
  using BLayout = std::conditional_t<B_ROW, wmma::row_major, wmma::col_major>;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
  }

  __device__ __forceinline__ void step(const bf16* As, int lda, const bf16* Bs,
                                       int ldb) {
    const int warp = threadIdx.x / 32;
    const int i0 = (warp / 4) * 32;
    const int j0 = (warp % 4) * 32;
#pragma unroll
    for (int p = 0; p < Step<bf16>::kDepth; p += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALayout> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLayout> b[2];
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int i = i0 + 16 * t;
        wmma::load_matrix_sync(a[t], A_ROW ? As + i * lda + p : As + p * lda + i,
                               lda);
        const int j = j0 + 16 * t;
        wmma::load_matrix_sync(b[t], B_ROW ? Bs + p * ldb + j : Bs + j * ldb + p,
                               ldb);
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)
#pragma unroll
        for (int t = 0; t < 2; ++t)
          wmma::mma_sync(acc[s][t], a[s], b[t], acc[s][t]);
    }
  }

  __device__ __forceinline__ void store(float* Cs) {
    const int warp = threadIdx.x / 32;
    const int i0 = (warp / 4) * 32;
    const int j0 = (warp % 4) * 32;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int t = 0; t < 2; ++t)
        wmma::store_matrix_sync(Cs + (i0 + 16 * s) * kLdC + j0 + 16 * t,
                                acc[s][t], kLdC, wmma::mem_row_major);
  }
};

// fp32 on the CUDA cores: thread (ty, tx) owns rows ty + 16 s (s < 4) and
// columns tx + 16 t (t < 8).
template <bool A_ROW, bool B_ROW> struct BlockGemm<float, A_ROW, B_ROW> {
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
    for (int p = 0; p < Step<float>::kDepth; ++p) {
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

// The staged fp32 tile to out (row stride ldo) at (r0, c0), rounded once
// to OutT; rows >= r_lim and columns >= c_lim are not written.
template <typename OutT>
__device__ __forceinline__ void write_tile(const float* Cs, OutT* out,
                                           size_t ldo, int r0, int c0,
                                           int r_lim, int c_lim) {
  for (int u = threadIdx.x; u < kBM * kBN; u += kThreads) {
    const int r = u / kBN;
    const int c = u % kBN;
    if (r0 + r < r_lim && c0 + c < c_lim)
      out[static_cast<size_t>(r0 + r) * ldo + (c0 + c)] =
          from_f32<OutT>(Cs[r * kLdC + c]);
  }
}

// K6: one block per (64-row tile, 128-column tile), row tiles fastest.
template <typename T, bool TRANS_W, bool VEC>
__global__ void __launch_bounds__(kThreads)
gmm_fwd_kernel(const T* __restrict__ x,                // [m, k]
               const T* __restrict__ w,                // [e, k, n]; [e, n, k] if TRANS_W
               const int* __restrict__ block_expert,   // [m / block_m]
               T* __restrict__ out,                    // [m, n]
               int m, int k, int n, int n_experts, int block_m) {
  constexpr int kDepth = Step<T>::kDepth;
  constexpr int kPad = Step<T>::kPad;
  constexpr int kLdA = kDepth + kPad;                        // As[kBM][kLdA]
  constexpr int kLdB = TRANS_W ? kDepth + kPad : kBN + kPad;
  constexpr int kStageA = kBM * kLdA;
  constexpr int kStageB = TRANS_W ? kBN * kLdB : kDepth * kLdB;
  static_assert(2 * (kStageA + kStageB) * sizeof(T) <= kSmemBytes,
                "two stages fit");
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + 2 * kStageA;

  const int row0 = blockIdx.x * kBM;
  const int col0 = blockIdx.y * kBN;
  // the tile's expert: scalar prefetch on the TPU, read by the block here
  const int g = block_expert[row0 / block_m];
  BlockGemm<T, true, !TRANS_W> gemm;
  gemm.zero();
  if (g >= 0 && g < n_experts) {
    const T* wg = w + static_cast<size_t>(g) * k * n;
    auto load = [&](int stage, int p0) {
      load_tile<T, kBM, kDepth, VEC>(As + stage * kStageA, kLdA, x, k, row0,
                                     p0, m, k);
      if constexpr (TRANS_W)
        load_tile<T, kBN, kDepth, VEC>(Bs + stage * kStageB, kLdB, wg, k, col0,
                                       p0, n, k);
      else
        load_tile<T, kDepth, kBN, VEC>(Bs + stage * kStageB, kLdB, wg, n, p0,
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

// K7: one block per (64-row k tile, 128-column n tile, expert), walking the
// expert's row tiles [tiles[2g], tiles[2g+1]) in steps of kDepth rows.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
gmm_dw_kernel(const T* __restrict__ x,        // [m, k]
              const T* __restrict__ dy,       // [m, n]
              const int* __restrict__ tiles,  // [e, 2] row-tile range
              float* __restrict__ dw,         // [e, k, n]
              int m, int k, int n, int block_m) {
  constexpr int kDepth = Step<T>::kDepth;
  constexpr int kPad = Step<T>::kPad;
  // A = x^T: its reduction index is x's row, so the x tile is kept as it
  // sits in memory (As[row][k], k contiguous) and read as a column-major A
  constexpr int kLdA = kBM + kPad;
  constexpr int kLdB = kBN + kPad;
  constexpr int kStageA = kDepth * kLdA;
  constexpr int kStageB = kDepth * kLdB;
  static_assert(2 * (kStageA + kStageB) * sizeof(T) <= kSmemBytes,
                "two stages fit");
  __shared__ __align__(128) unsigned char smem[kSmemBytes];
  T* As = reinterpret_cast<T*>(smem);
  T* Bs = As + 2 * kStageA;

  const int k0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * kBN;
  const int g = blockIdx.z;
  const int r_begin = tiles[2 * g] * block_m;
  const int r_end = min(m, tiles[2 * g + 1] * block_m);
  BlockGemm<T, false, true> gemm;
  gemm.zero();
  if (r_end > r_begin) {
    auto load = [&](int stage, int r0) {
      load_tile<T, kDepth, kBM, VEC>(As + stage * kStageA, kLdA, x, k, r0, k0,
                                     r_end, k);
      load_tile<T, kDepth, kBN, VEC>(Bs + stage * kStageB, kLdB, dy, n, r0, n0,
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

// ------------------------------------------------ K7, bf16, wgmma

constexpr int kDwThreads = 256;   // 2 warpgroups, each 128 dw rows
constexpr int kDwBM = 256;        // dw rows (k) a block: 4 atoms of 64
constexpr int kDwBN = 128;        // dw columns (n) a block: 2 atoms of 64
constexpr int kDwDepth = 64;      // x / dy rows a reduction step
constexpr int kDwStages = 4;      // loads run 2 steps ahead, 1 wgmma group
constexpr int kAtomBytes = kDwDepth * 128;             // 64 rows x 128 bytes
constexpr int kDwStageA = kDwBM / 64 * kAtomBytes;     // x tile, 32 KB
constexpr int kDwStageBytes = kDwStageA + kDwBN / 64 * kAtomBytes;  // 48 KB
constexpr size_t kDwSmemBytes = kDwStages * kDwStageBytes + 1024;  // + align

// Rows [r0, r0 + 64) x columns [c0, c0 + C) of a row-major bf16 matrix
// (row stride ld) into C / 64 swizzled atoms at smem (wgmma.cuh): column
// c0 + 64 a + 8 q + i of row r at byte a * kAtomBytes + 128 r +
// 16 (q ^ r % 8) + 2 i. Rows >= r_lim and columns >= c_lim land as 0.
// VEC: 16-byte cp.async copies (ld, c0 and c_lim multiples of 8, the base
// 16-byte aligned); otherwise element copies through registers.
template <int C, bool VEC>
__device__ __forceinline__ void load_atoms(unsigned char* smem,
                                           const bf16* src, size_t ld,
                                           int r0, int c0, int r_lim,
                                           int c_lim) {
  auto at = [](int r, int c16) {   // byte offset of chunk c16 of row r
    return (c16 / 8) * kAtomBytes + r * 128 + (((c16 % 8) ^ (r % 8)) << 4);
  };
  if constexpr (VEC) {
    constexpr int kChunks = C / 8;
    static_assert(kDwDepth * kChunks % kDwThreads == 0, "whole rounds");
#pragma unroll
    for (int i = 0; i < kDwDepth * kChunks / kDwThreads; ++i) {
      const int u = threadIdx.x + i * kDwThreads;
      const int r = u / kChunks;
      const int c16 = u % kChunks;
      const bool ok = r0 + r < r_lim && c0 + c16 * 8 < c_lim;
      const bf16* g =
          ok ? src + static_cast<size_t>(r0 + r) * ld + c0 + c16 * 8 : src;
      cp_async16(smem_u32(smem + at(r, c16)), g, ok);
    }
  } else {
    for (int u = threadIdx.x; u < kDwDepth * C; u += kDwThreads) {
      const int r = u / C;
      const int c = u % C;
      const bool ok = r0 + r < r_lim && c0 + c < c_lim;
      *reinterpret_cast<bf16*>(smem + at(r, c / 8) + (c % 8) * 2) =
          ok ? src[static_cast<size_t>(r0 + r) * ld + c0 + c]
             : from_f32<bf16>(0.f);
    }
  }
}

// K7 in bf16: one block per (256-row k tile, 128-column n tile, expert),
// walking the expert's row tiles [tiles[2g], tiles[2g+1]) 64 rows a step.
// dw = x^T dy is an MN-major product on both sides: the step's x rows are
// A's K rows (A = x^T, its M = k contiguous in memory) and its dy rows
// are B's K rows (its N = n contiguous). Warpgroup w owns dw rows
// 128 w .. 128 w + 127 of the tile: two m64n128k16 a 16-row slice.
template <bool VEC>
__global__ void __launch_bounds__(kDwThreads, 1)
gmm_dw_wgmma_kernel(const bf16* __restrict__ x,     // [m, k]
                    const bf16* __restrict__ dy,    // [m, n]
                    const int* __restrict__ tiles,  // [e, 2] row-tile range
                    float* __restrict__ dw,         // [e, k, n]
                    int m, int k, int n, int block_m) {
  extern __shared__ unsigned char dw_smem_raw[];
  // the atoms' swizzle is keyed to address bits [7, 10): align to 1024
  unsigned char* smem =
      dw_smem_raw + ((1024 - (smem_u32(dw_smem_raw) & 1023)) & 1023);

  const int k0 = blockIdx.x * kDwBM;
  const int n0 = blockIdx.y * kDwBN;
  const int g = blockIdx.z;
  const int r_begin = tiles[2 * g] * block_m;
  const int r_end = min(m, tiles[2 * g + 1] * block_m);
  const int steps =
      r_end > r_begin ? (r_end - r_begin + kDwDepth - 1) / kDwDepth : 0;
  const int wg = threadIdx.x / 128;

  auto load = [&](int step) {
    if (step < steps) {
      unsigned char* stage = smem + (step % kDwStages) * kDwStageBytes;
      const int r0 = r_begin + step * kDwDepth;
      load_atoms<kDwBM, VEC>(stage, x, k, r0, k0, r_end, k);
      load_atoms<kDwBN, VEC>(stage + kDwStageA, dy, n, r0, n0, r_end, n);
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
    const uint64_t stage = (s % kDwStages) * (kDwStageBytes >> 4);
    wgmma_fence_operand(acc[0]);
    wgmma_fence_operand(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDwDepth / 16; ++kk) {
      const uint64_t off = stage + kk * (2048 >> 4);   // 16 rows further
      const bool accumulate = s > 0 || kk > 0;
      wgmma_m64n128k16_mn(acc[0], a_desc + off, b_desc + off, accumulate);
      wgmma_m64n128k16_mn(acc[1], a_desc + off + (kAtomBytes >> 4),
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

template <typename T, bool TRANS_W, bool VEC>
int launch_fwd(const void* x, const void* w, const void* block_expert,
               void* out, int m, int k, int n, int n_experts, int block_m,
               cudaStream_t stream) {
  const dim3 grid((m + kBM - 1) / kBM, (n + kBN - 1) / kBN);
  gmm_fwd_kernel<T, TRANS_W, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w),
      static_cast<const int*>(block_expert), static_cast<T*>(out), m, k, n,
      n_experts, block_m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_fwd(bool trans_w, bool vec, const void* x, const void* w,
                 const void* block_expert, void* out, int m, int k, int n,
                 int n_experts, int block_m, cudaStream_t s) {
  if (trans_w)
    return vec ? launch_fwd<T, true, true>(x, w, block_expert, out, m, k, n,
                                           n_experts, block_m, s)
               : launch_fwd<T, true, false>(x, w, block_expert, out, m, k, n,
                                            n_experts, block_m, s);
  return vec ? launch_fwd<T, false, true>(x, w, block_expert, out, m, k, n,
                                          n_experts, block_m, s)
             : launch_fwd<T, false, false>(x, w, block_expert, out, m, k, n,
                                           n_experts, block_m, s);
}

template <bool VEC>
int launch_dw_wgmma(const void* x, const void* dy, const void* tiles,
                    void* dw, int m, int k, int n, int n_experts,
                    int block_m, cudaStream_t stream) {
  static bool attribute_set = false;   // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        gmm_dw_wgmma_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(kDwSmemBytes));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const dim3 grid((k + kDwBM - 1) / kDwBM, (n + kDwBN - 1) / kDwBN,
                  n_experts);
  gmm_dw_wgmma_kernel<VEC><<<grid, kDwThreads, kDwSmemBytes, stream>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(dy),
      static_cast<const int*>(tiles), static_cast<float*>(dw), m, k, n,
      block_m);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_dw(const void* x, const void* dy, const void* tiles, void* dw,
              int m, int k, int n, int n_experts, int block_m,
              cudaStream_t stream) {
  const dim3 grid((k + kBM - 1) / kBM, (n + kBN - 1) / kBN, n_experts);
  gmm_dw_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dy),
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
  if (dtype == 0)
    return dispatch_fwd<float>(trans_w != 0, vectorizable<float>(k, n), x, w,
                               block_expert, out, m, k, n, n_experts, block_m,
                               s);
  if (dtype == 1)
    return dispatch_fwd<bf16>(trans_w != 0, vectorizable<bf16>(k, n), x, w,
                              block_expert, out, m, k, n, n_experts, block_m,
                              s);
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
               ? launch_dw<float, true>(x, dy, tiles, dw, m, k, n, n_experts,
                                        block_m, s)
               : launch_dw<float, false>(x, dy, tiles, dw, m, k, n, n_experts,
                                         block_m, s);
  if (dtype == 1)
    return vectorizable<bf16>(k, n)
               ? launch_dw_wgmma<true>(x, dy, tiles, dw, m, k, n, n_experts,
                                       block_m, s)
               : launch_dw_wgmma<false>(x, dy, tiles, dw, m, k, n,
                                        n_experts, block_m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
