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
// Design, right and simple first. One block of 256 threads owns a 64 x 128
// output tile and walks the reduction in steps of 32 (bf16) or 16 (fp32)
// through two shared-memory stages filled by cp.async (16-byte copies when
// every row starts on 16 bytes, element copies otherwise), so the next
// step's copy is in flight while this one is multiplied. bf16 runs on the
// tensor cores through wmma (mma.sync 16x16x16, fp32 accumulators; each of
// the 8 warps holds 32 x 32 of the tile); fp32 runs on the CUDA cores (the
// conformance path), 4 x 8 outputs a thread. Ragged k and n are masked
// here (zero-filled copies, masked stores), so any width runs; Mosaic's
// 128-lane rule does not apply.
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
// reduction pass is later work, as are wgmma fed by TMA and fusing SiLU*up
// into the gate|up epilogue.

#include <mma.h>

#include <type_traits>

#include "common.cuh"

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

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  const int n = valid ? 16 : 0;   // 0 bytes read: the 16 are filled with 0
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

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
      cp_async16(dst + r * lds + c, g, ok);
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
      cp_async_wait_one();   // step s's copies have landed
      __syncthreads();
      gemm.step(As + (s & 1) * kStageA, kLdA, Bs + (s & 1) * kStageB, kLdB);
      __syncthreads();       // step s's stage may be overwritten
    }
  }
  cp_async_wait_all();
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
      cp_async_wait_one();
      __syncthreads();
      gemm.step(As + (s & 1) * kStageA, kLdA, Bs + (s & 1) * kStageB, kLdB);
      __syncthreads();
    }
  }
  cp_async_wait_all();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
  gemm.store(Cs);
  __syncthreads();
  write_tile(Cs, dw + static_cast<size_t>(g) * k * n, n, k0, n0, k, n);
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
               ? launch_dw<bf16, true>(x, dy, tiles, dw, m, k, n, n_experts,
                                       block_m, s)
               : launch_dw<bf16, false>(x, dy, tiles, dw, m, k, n, n_experts,
                                        block_m, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
