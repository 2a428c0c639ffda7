// K8 — one identity ResNet bottleneck block in eval mode as ONE kernel, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   kubeflow_tpu/compute/ops/fused_block.py::_kernel  (via _run and
//   fused_bottleneck_eval).
// Wrapper, plain PyTorch version, BN folding and the launch counter:
// ../fused_block.py.
//
// What it computes. Eval-mode batch norm is affine and folds into the conv
// weights and a bias (fold_bn), so the block is a chain of three matrix
// products over the pixels of an NHWC activation x [N, H, W, C]:
//   c1 = relu(x . W1 + b1)                 W1 [C, M]
//   c2 = relu(im2col3x3(c1) . W2 + b2)     W2 [9M, M], taps dy major, dx minor,
//                                          c1 zero-padded by one pixel
//   y  = relu(c2 . W3 + b3 + x)            W3 [M, C]
// with fp32 sums, the biases and the residual added in fp32, and c1, c2 and y
// each rounded once to x's dtype. c1 and c2 never touch device memory: the
// block reads x and writes y, which is the kernel's whole point.
//
// Bound on this card. Per pixel the block does 2 (2 C M + 9 M^2) FLOPs and
// moves 2 C values. At ResNet-50's four stages (C = 4M) that is 34 M FLOPs
// for 16 M bytes in bf16, about 2.1 M FLOPs a byte: bytes bound the 56x56x256
// (M 64) and 28x28x512 (M 128) blocks, operations the 14x14x1024 (M 256) and
// 7x7x2048 (M 512) ones, on a card that leaves the memory roof near 295
// FLOPs a byte.
//
// Design, right and simple first. The TPU kernel keeps a whole image's c1
// plane with its halo in VMEM, one grid step per image; at 56x56x64 that
// plane is 430 KB in bf16 and a block here has 227 KB of shared memory. So
// the tile space is (image, band of R output rows):
//   phase A  c1 for the band's R + 2 rows (the two halo rows are recomputed
//            by the neighbouring bands; rows outside the image and the two
//            halo columns stay zero) into a shared plane, x staged from device
//            memory by cp.async;
//   phase B  the 3x3 as an implicit im2col: pixels are indexed over the
//            PADDED width, p = y (W + 2) + x, so that tap (dy, dx) of pixel p
//            is plane row p + dy (W + 2) + dx and the A operand of
//            [R (W+2), 9M] x [9M, M] is read straight from the plane at nine
//            row offsets, never materialised; the two extra columns a row
//            cost are computed and thrown away. Result into a second shared
//            buffer;
//   phase C  [R (W+2), M] x [M, C] read straight from that buffer, plus b3
//            plus the residual x (re-read, mostly from L2), relu, one store.
// Weights do not fit beside the planes at the deep stages (W2 at M 512 is
// 4.7 MB): every product streams its weight tiles from device memory through
// kStages cp.async stages; all blocks read the same weights, so the 50 MB L2
// serves them. A phase is ONE stream of (output tile, reduction step) pairs:
// the copies of the next tile's first steps are in flight while this tile's
// last steps and its epilogue run, so a tile start costs no round trip to L2,
// and a step costs one __syncthreads. What a block waits for is L2: every
// staged step pulls a weight tile that all blocks read, so the time follows
// the number of staged steps. Hence (a) bf16 blocks have 16 warps, whose
// 128 x 128 (or 256 x 64) output tile puts twice the pixel rows on every
// weight tile (and whose warps hide each other's barriers, one block an SM),
// and (b) R is, of the bands that fit a block's shared memory, the one with
// the fewest staged steps over the image, halo rows and ragged tiles
// counted (fp32 planes are twice as large, so their bands are shorter).
// Pixels are tiled by the flattened index, so W = 7 and 14 fill 16-row
// fragments across image rows; at 7 x 7 the whole padded image is 63 rows,
// and a block of 8 warps (a 64-row tile) takes it. bf16 runs on the tensor
// cores through wmma (mma.sync 16x16x16, fp32 accumulators, 32 x 32 a warp)
// and moves its epilogues 8 values (16 bytes) a lane; fp32 runs on the CUDA
// cores (the conformance path). Where one image's pixels are few (7 x 7,
// 14 x 14) every block still streams all the weights: TMA multicast across a
// cluster, wgmma, and a persistent grid are later work.

#include <mma.h>

#include "common.cuh"

namespace {

using namespace kubeflow;
namespace wmma = nvcuda::wmma;
using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;         // 227 KB a block on sm_90
// Staged copies a phase keeps (>= 2). Depths 2, 3 and 4 measured alike on an
// H100 (the stream is bound by L2's rate, not its latency); 2 leaves the
// planes the most room.
constexpr int kStages = 2;

// Reduction depth of one staged step; row paddings of the staged x tile
// (kPadA), the staged weight tile (kPadB) and the shared planes (kPadM: the
// bf16 planes keep every row on a 32-byte boundary, which wmma needs at the
// odd row offsets of the taps).
template <typename T> struct Step;
template <> struct Step<bf16> {
  static constexpr int kDepth = 32, kPadA = 16, kPadB = 8, kPadM = 16;
};
template <> struct Step<float> {
  static constexpr int kDepth = 16, kPadA = 4, kPadB = 4, kPadM = 4;
};

// A block of `threads` threads computes output tiles of BM x BN = 32 threads
// values (32 x 32 a warp in bf16, 32 a thread in fp32): the more threads, the
// more pixel rows share one staged weight tile, and the fewer bytes the block
// pulls from L2 for the same work.
__host__ __device__ constexpr int tile_rows(int threads, int bn) {
  return 32 * threads / bn;
}

__host__ __device__ constexpr int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// Shared-memory layout of one block, the same on the host (to size the
// launch) and on the device: [c1 plane][c2 | staged x][staged weights]
// [per-warp fp32 scratch (bf16 only)]. Offsets in bytes.
struct Layout {
  int wp, mp, pixels, rows, plane_rows;
  int c2_off, b_off, scratch_off, bytes;
};

template <typename T>
__host__ __device__ Layout make_layout(int w, int m, int band, int bn,
                                       int threads) {
  using S = Step<T>;
  constexpr bool kWmma = sizeof(T) == 2;
  const int bm = tile_rows(threads, bn);
  Layout l;
  l.wp = w + 2;
  l.mp = m + S::kPadM;
  l.pixels = band * l.wp;                       // padded-width pixels of the band
  l.rows = kWmma ? align_up(l.pixels, 16) : l.pixels;   // rows of c2
  l.plane_rows = l.rows + 2 * l.wp + 2;         // the furthest tap of the last row
  const int sz = static_cast<int>(sizeof(T));
  const int plane = align_up(l.plane_rows * l.mp * sz, 128);
  const int staged_x = kStages * bm * (S::kDepth + S::kPadA) * sz;
  int c2 = l.rows * l.mp * sz;
  if (c2 < staged_x) c2 = staged_x;             // phase A stages x where c2 goes
  l.c2_off = plane;
  l.b_off = l.c2_off + align_up(c2, 128);
  l.scratch_off =
      l.b_off + align_up(kStages * S::kDepth * (bn + S::kPadB) * sz, 128);
  l.bytes = l.scratch_off + (kWmma ? (threads / 32) * 16 * 20 * 4 : 0);
  return l;
}

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
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// What an epilogue hands its caller at once: N sums of one output row at N
// consecutive columns (8 = 16 bytes of bf16 a lane, 1 on the fp32 path).
template <int N> struct Vals {
  static constexpr int n = N;
  float v[N];
};

__device__ __forceinline__ void store_vals(float* dst, const Vals<1>& o) {
  *dst = o.v[0];
}
__device__ __forceinline__ void store_vals(bf16* dst, const Vals<8>& o) {
  uint4 w;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    h[i] = __floats2bfloat162_rn(o.v[2 * i], o.v[2 * i + 1]);
  *reinterpret_cast<uint4*>(dst) = w;      // dst is 16-byte aligned
}
__device__ __forceinline__ void add_vals(const float* src, Vals<1>& o) {
  o.v[0] += *src;
}
__device__ __forceinline__ void add_vals(const bf16* src, Vals<8>& o) {
  float x[8];
  unpack16<bf16>(load16(src), x);
#pragma unroll
  for (int i = 0; i < 8; ++i) o.v[i] += x[i];
}
template <int N>
__device__ __forceinline__ void add_bias(const float* bias, Vals<N>& o) {
#pragma unroll
  for (int i = 0; i < N; ++i) o.v[i] += bias[i];
}
template <int N> __device__ __forceinline__ void relu(Vals<N>& o) {
#pragma unroll
  for (int i = 0; i < N; ++i) o.v[i] = fmaxf(o.v[i], 0.f);
}

// One block's BM x BN fp32 product (BM = 8192 / BN), accumulated one staged
// step at a time. A (tile row i, reduction index p of the step) is read at
// a[i * lda + p], B (p, column j) at Bs[p * ldb + j]. Rows at or beyond
// rows_lim hold nothing: the bf16 version skips their fragments (rows_lim a
// multiple of 16), the fp32 version reads row rows_lim - 1 in their place and
// the caller drops the result.
template <typename T, int BN, int THREADS> struct BlockGemm;

// bf16 on the tensor cores: warp w owns rows 32 (w / (BN/32)) and columns
// 32 (w % (BN/32)) as 2 x 2 wmma fragments of 16 x 16.
template <int BN, int THREADS> struct BlockGemm<bf16, BN, THREADS> {
  static constexpr int kBM = tile_rows(THREADS, BN);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];

  __device__ __forceinline__ int i0() const {
    return (threadIdx.x / 32) / (BN / 32) * 32;
  }
  __device__ __forceinline__ int j0() const {
    return (threadIdx.x / 32) % (BN / 32) * 32;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int t = 0; t < 2; ++t) wmma::fill_fragment(acc[s][t], 0.f);
  }

  __device__ __forceinline__ void step(const bf16* a, int lda, const bf16* Bs,
                                       int ldb, int rows_lim) {
    const int i = i0();
    const int j = j0();
#pragma unroll
    for (int p = 0; p < Step<bf16>::kDepth; p += 16) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b[2];
#pragma unroll
      for (int t = 0; t < 2; ++t)
        wmma::load_matrix_sync(b[t], Bs + p * ldb + j + 16 * t, ldb);
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (i + 16 * s < rows_lim) {        // the same for the whole warp
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> af;
          wmma::load_matrix_sync(af, a + (i + 16 * s) * lda + p, lda);
#pragma unroll
          for (int t = 0; t < 2; ++t)
            wmma::mma_sync(acc[s][t], af, b[t], acc[s][t]);
        }
      }
    }
  }

  // f(tile row, first tile column, 8 sums) for every output the warp
  // holds, one 16 x 16 fragment at a time through the warp's own scratch:
  // lane l takes row l / 2, columns 8 (l % 2) .. + 8.
  template <typename F>
  __device__ __forceinline__ void epilogue(float* scratch, F f) {
    float* mine = scratch + (threadIdx.x / 32) * 16 * 20;
    const int lane = threadIdx.x % 32;
    const int r = lane / 2;
    const int c = (lane % 2) * 8;
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        wmma::store_matrix_sync(mine, acc[s][t], 20, wmma::mem_row_major);
        __syncwarp();
        Vals<8> o;
        const float4 lo = *reinterpret_cast<const float4*>(mine + r * 20 + c);
        const float4 hi =
            *reinterpret_cast<const float4*>(mine + r * 20 + c + 4);
        o.v[0] = lo.x, o.v[1] = lo.y, o.v[2] = lo.z, o.v[3] = lo.w;
        o.v[4] = hi.x, o.v[5] = hi.y, o.v[6] = hi.z, o.v[7] = hi.w;
        f(i0() + 16 * s + r, j0() + 16 * t + c, o);
        __syncwarp();
      }
  }
};

// fp32 on the CUDA cores: thread (ty, tx) of 16 x 16 owns rows ty + 16 s and
// columns tx + 16 t.
template <int BN, int THREADS> struct BlockGemm<float, BN, THREADS> {
  static_assert(THREADS == 256, "the fp32 path maps 16 x 16 threads");
  static constexpr int kBM = tile_rows(THREADS, BN);
  static constexpr int kS = kBM / 16;
  static constexpr int kT = BN / 16;
  float acc[kS][kT];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int t = 0; t < kT; ++t) acc[s][t] = 0.f;
  }

  __device__ __forceinline__ void step(const float* a, int lda,
                                       const float* Bs, int ldb,
                                       int rows_lim) {
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    const float* rows[kS];
#pragma unroll
    for (int s = 0; s < kS; ++s)
      rows[s] = a + min(ty + 16 * s, rows_lim - 1) * lda;
#pragma unroll
    for (int p = 0; p < Step<float>::kDepth; ++p) {
      float av[kS], bv[kT];
#pragma unroll
      for (int s = 0; s < kS; ++s) av[s] = rows[s][p];
#pragma unroll
      for (int t = 0; t < kT; ++t) bv[t] = Bs[p * ldb + tx + 16 * t];
#pragma unroll
      for (int s = 0; s < kS; ++s)
#pragma unroll
        for (int t = 0; t < kT; ++t) acc[s][t] = fmaf(av[s], bv[t], acc[s][t]);
    }
  }

  template <typename F>
  __device__ __forceinline__ void epilogue(float*, F f) {
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int t = 0; t < kT; ++t) {
        Vals<1> o;
        o.v[0] = acc[s][t];
        f(ty + 16 * s, tx + 16 * t, o);
      }
  }
};

// The kDepth x BN window at (k0, n0) of a row-major [K, n_cols] weight
// matrix into a staged tile with row stride ldb, 16 bytes a copy; columns at
// or beyond n_cols read as 0 (rows never leave K: K is a multiple of kDepth).
template <typename T, int BN, int THREADS>
__device__ __forceinline__ void load_weights(T* dst, int ldb, const T* w,
                                             int n_cols, int k0, int n0) {
  constexpr int V = vec_width<T>();
  constexpr int kDepth = Step<T>::kDepth;
  for (int u = threadIdx.x; u < kDepth * BN / V; u += THREADS) {
    const int r = u / (BN / V);
    const int c = (u % (BN / V)) * V;
    const bool ok = n0 + c < n_cols;
    const T* g = ok ? w + static_cast<size_t>(k0 + r) * n_cols + (n0 + c) : w;
    cp_async16(dst + r * ldb + c, g, ok);
  }
}

// Where a phase's stream stands: row tile, column tile, reduction step.
// Advanced by one step at a time, so that no thread divides.
struct Cursor {
  int rt = 0, nt = 0, s = 0;
  __device__ __forceinline__ void advance(int n_tiles, int steps) {
    if (++s == steps) {
      s = 0;
      if (++nt == n_tiles) nt = 0, ++rt;
    }
  }
};

// One phase of the block: row_tiles x n_tiles output tiles (column tiles
// fastest) of `steps` reduction steps each, run as one stream through kStages
// staged copies. load(stage, cursor) issues the cp.async copies of one step,
// compute(stage, cursor) multiplies it into the accumulators, done(cursor) is
// the tile's epilogue. The copies of step g + kStages - 1 are issued before
// step g is computed, into the stage that step g - 1 has just left (every
// thread has passed this step's barrier, so none still reads it); one
// barrier a step.
template <typename Gemm, typename Load, typename Compute, typename Done>
__device__ __forceinline__ void run_phase(Gemm& gemm, int row_tiles,
                                          int n_tiles, int steps, Load load,
                                          Compute compute, Done done) {
  const int total = row_tiles * n_tiles * steps;
  Cursor ahead;                         // the step whose copies go out next
  int ahead_stage = 0;
  for (int g = 0; g < kStages - 1; ++g) {
    if (g < total) load(ahead_stage, ahead);
    cp_async_commit();
    ahead.advance(n_tiles, steps);
    ahead_stage = ahead_stage + 1 == kStages ? 0 : ahead_stage + 1;
  }
  Cursor at;                            // the step being computed
  int stage = 0;
  for (int g = 0; g < total; ++g) {
    cp_async_wait<kStages - 2>();      // step g's copies have landed
    __syncthreads();
    if (g + kStages - 1 < total) load(ahead_stage, ahead);
    cp_async_commit();
    ahead.advance(n_tiles, steps);
    ahead_stage = ahead_stage + 1 == kStages ? 0 : ahead_stage + 1;
    if (at.s == 0) gemm.zero();
    compute(stage, at);
    if (at.s == steps - 1) done(at);
    at.advance(n_tiles, steps);
    stage = stage + 1 == kStages ? 0 : stage + 1;
  }
  cp_async_wait<0>();
  __syncthreads();     // what the phase wrote is complete; the stages are dead
}

// One block of THREADS threads per (band of `band` output rows, image).
template <typename T, int BN, int THREADS>
__global__ void __launch_bounds__(THREADS)
fused_block_kernel(const T* __restrict__ x,        // [N, H, W, C]
                   const T* __restrict__ w1,       // [C, M]
                   const float* __restrict__ b1,   // [M]
                   const T* __restrict__ w2,       // [9M, M]
                   const float* __restrict__ b2,   // [M]
                   const T* __restrict__ w3,       // [M, C]
                   const float* __restrict__ b3,   // [C]
                   T* __restrict__ out,            // [N, H, W, C]
                   int H, int W, int C, int M, int band) {
  using S = Step<T>;
  using Gemm = BlockGemm<T, BN, THREADS>;
  constexpr int kDepth = S::kDepth;
  constexpr int kBM = Gemm::kBM;
  constexpr int kLdA = kDepth + S::kPadA;
  constexpr int kLdB = BN + S::kPadB;
  constexpr int kStageA = kBM * kLdA;
  constexpr int kStageB = kDepth * kLdB;
  constexpr int V = vec_width<T>();
  constexpr int kThreads = THREADS;

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = make_layout<T>(W, M, band, BN, THREADS);
  T* plane = reinterpret_cast<T*>(smem);
  T* c2 = reinterpret_cast<T*>(smem + l.c2_off);
  T* As = c2;                                    // phase A only
  T* Bs = reinterpret_cast<T*>(smem + l.b_off);
  float* scratch = reinterpret_cast<float*>(smem + l.scratch_off);
  const int wp = l.wp;
  const int mp = l.mp;

  const int r0 = blockIdx.x * band;              // the band's first image row
  const size_t image = static_cast<size_t>(blockIdx.y) * H * W * C;
  const T* xin = x + image;
  Gemm gemm;

  // the plane starts as zeros: halo columns, rows outside the image, the tail
  {
    uint4* z = reinterpret_cast<uint4*>(plane);
    const int words = l.c2_off / 16;
    for (int u = threadIdx.x; u < words; u += kThreads)
      z[u] = make_uint4(0u, 0u, 0u, 0u);
  }
  __syncthreads();

  const int m_tiles = (M + BN - 1) / BN;         // column tiles of c1 and c2

  // ---- phase A: c1 = relu(x . W1 + b1) on image rows r0 - 1 .. r0 + band
  {
    const int q_rows = (band + 2) * W;           // unpadded pixels, halo rows in
    const long g0 = static_cast<long>(r0 - 1) * W;   // image pixel of q = 0
    const long g_end = static_cast<long>(H) * W;
    run_phase(
        gemm, (q_rows + kBM - 1) / kBM, m_tiles, C / kDepth,
        [&](int stage, const Cursor& at) {
          const int row0 = at.rt * kBM;
          const int k0 = at.s * kDepth;
          T* a = As + stage * kStageA;
          for (int u = threadIdx.x; u < kBM * kDepth / V; u += kThreads) {
            const int r = u / (kDepth / V);
            const int c = (u % (kDepth / V)) * V;
            const long g = g0 + row0 + r;
            const bool ok = row0 + r < q_rows && g >= 0 && g < g_end;
            cp_async16(a + r * kLdA + c,
                       ok ? xin + static_cast<size_t>(g) * C + (k0 + c) : xin,
                       ok);
          }
          load_weights<T, BN, THREADS>(Bs + stage * kStageB, kLdB, w1, M, k0,
                                       at.nt * BN);
        },
        [&](int stage, const Cursor&) {
          gemm.step(As + stage * kStageA, kLdA, Bs + stage * kStageB, kLdB,
                    kBM);
        },
        [&](const Cursor& at) {
          const int row0 = at.rt * kBM;
          const int n0 = at.nt * BN;
          gemm.epilogue(scratch, [&](int r, int c, auto o) {
            const int q = row0 + r;
            const int col = n0 + c;
            const long g = g0 + q;
            if (q < q_rows && col < M && g >= 0 && g < g_end) {
              const int y = q / W;
              const int xx = q - y * W;
              add_bias(b1 + col, o);
              relu(o);
              store_vals(plane + (y * wp + xx + 1) * mp + col, o);
            }
          });
        });
  }

  // ---- phase B: c2 = relu(im2col(c1) . W2 + b2), A read from the plane
  run_phase(
      gemm, (l.rows + kBM - 1) / kBM, m_tiles, 9 * M / kDepth,
      [&](int stage, const Cursor& at) {
        load_weights<T, BN, THREADS>(Bs + stage * kStageB, kLdB, w2, M,
                                     at.s * kDepth, at.nt * BN);
      },
      [&](int stage, const Cursor& at) {
        const int row0 = at.rt * kBM;
        const int kk = at.s * kDepth;
        const int tap = kk / M;                  // kDepth divides M
        const int shift = (tap / 3) * wp + tap % 3;
        gemm.step(plane + (row0 + shift) * mp + (kk - tap * M), mp,
                  Bs + stage * kStageB, kLdB, l.rows - row0);
      },
      [&](const Cursor& at) {
        const int row0 = at.rt * kBM;
        const int n0 = at.nt * BN;
        gemm.epilogue(scratch, [&](int r, int c, auto o) {
          const int p = row0 + r;
          const int col = n0 + c;
          if (p < l.rows && col < M) {
            add_bias(b2 + col, o);
            relu(o);
            store_vals(c2 + p * mp + col, o);
          }
        });
      });

  // ---- phase C: y = relu(c2 . W3 + b3 + x), A read from c2
  {
    const int c_tiles = (C + BN - 1) / BN;
    T* yout = out + image;
    run_phase(
        gemm, (l.rows + kBM - 1) / kBM, c_tiles, M / kDepth,
        [&](int stage, const Cursor& at) {
          load_weights<T, BN, THREADS>(Bs + stage * kStageB, kLdB, w3, C,
                                       at.s * kDepth, at.nt * BN);
        },
        [&](int stage, const Cursor& at) {
          const int row0 = at.rt * kBM;
          gemm.step(c2 + row0 * mp + at.s * kDepth, mp, Bs + stage * kStageB,
                    kLdB, l.rows - row0);
        },
        [&](const Cursor& at) {
          const int row0 = at.rt * kBM;
          const int n0 = at.nt * BN;
          gemm.epilogue(scratch, [&](int r, int c, auto o) {
            const int p = row0 + r;
            const int col = n0 + c;
            const int y = p / wp;
            const int xx = p - y * wp;
            if (p < l.pixels && xx < W && r0 + y < H && col < C) {
              const size_t at =
                  (static_cast<size_t>(r0 + y) * W + xx) * C + col;
              add_bias(b3 + col, o);
              add_vals(xin + at, o);             // the residual, in fp32
              relu(o);
              store_vals(yout + at, o);
            }
          });
        });
  }
}

// The staged reduction steps one block runs for a band of `band` rows: what
// its time follows, since every step pulls one weight tile from L2.
template <typename T>
long block_steps(int w, int c, int m, int bn, int threads, int band) {
  const int bm = tile_rows(threads, bn);
  const int depth = Step<T>::kDepth;
  const Layout l = make_layout<T>(w, m, band, bn, threads);
  const long m_tiles = (m + bn - 1) / bn;
  const long c_tiles = (c + bn - 1) / bn;
  const long a_tiles = ((band + 2) * w + bm - 1) / bm;
  const long b_tiles = (l.rows + bm - 1) / bm;
  return a_tiles * m_tiles * (c / depth) + b_tiles * m_tiles * (9 * m / depth) +
         b_tiles * c_tiles * (m / depth);
}

// The band the launch uses: `asked` rows when given (> 0), else of the bands
// that fit a block's shared memory the one with the fewest staged steps over
// the image (ties to the taller band). 0 when nothing fits.
template <typename T>
int plan_band(int h, int w, int c, int m, int bn, int threads, int asked) {
  if (asked > 0)
    return make_layout<T>(w, m, asked, bn, threads).bytes <= kMaxSmem ? asked
                                                                      : 0;
  int best = 0;
  long best_cost = 0;
  for (int r = h; r >= 1; --r) {
    if (make_layout<T>(w, m, r, bn, threads).bytes > kMaxSmem) continue;
    const long cost =
        (h + r - 1) / r * block_steps<T>(w, c, m, bn, threads, r);
    if (!best || cost < best_cost) best = r, best_cost = cost;
  }
  return best;
}

template <typename T, int BN, int THREADS>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out, int n,
           int h, int w, int c, int m, int band, cudaStream_t stream) {
  const int bytes = make_layout<T>(w, m, band, BN, THREADS).bytes;
  auto kernel = fused_block_kernel<T, BN, THREADS>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + band - 1) / band, n);
  kernel<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<T*>(out), h, w, c, m, band);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int n, int h, int w, int c, int m) {
  return n < 1 || n > 65535 || h < 1 || w < 1 || m < 32 || m % 32 != 0 ||
         c < 32 || c % 32 != 0 ||
         static_cast<long>(h) * w * c > 0x7fffffffL;
}

int column_tile(int m) { return m < 128 ? 64 : 128; }

// The block's threads: fp32 256; bf16 512 (16 warps: twice the rows on every
// weight tile), unless the whole padded image fits the row tile of 256.
int block_threads(int dtype, int h, int w, int bn) {
  if (dtype == 0) return 256;
  return h * (w + 2) <= tile_rows(256, bn) ? 256 : 512;
}

}  // namespace

// What a launch at this shape would use: plan[0] = the band's rows, plan[1] =
// its dynamic shared memory in bytes, plan[2] = the block's threads.
// band_rows 0 = choose. dtype: 0 = float32, 1 = bfloat16. Returns 0, or
// cudaErrorInvalidValue when the shape is not taken or no band fits.
extern "C" int kubeflow_fused_block_plan(int h, int w, int c, int m,
                                         int band_rows, int dtype, int* plan) {
  if (bad_shape(1, h, w, c, m) || band_rows < 0 || band_rows > h ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int bn = column_tile(m);
  const int threads = block_threads(dtype, h, w, bn);
  const int band =
      dtype == 0 ? plan_band<float>(h, w, c, m, bn, threads, band_rows)
                 : plan_band<bf16>(h, w, c, m, bn, threads, band_rows);
  if (!band) return static_cast<int>(cudaErrorInvalidValue);
  plan[0] = band;
  plan[1] = dtype == 0 ? make_layout<float>(w, m, band, bn, threads).bytes
                       : make_layout<bf16>(w, m, band, bn, threads).bytes;
  plan[2] = threads;
  return 0;
}

// K8. x, out [n, h, w, c]; w1 [c, m]; w2 [9m, m]; w3 [m, c] in x's dtype
// (0 = float32, 1 = bfloat16), biases fp32; m and c multiples of 32; operands
// 16-byte aligned. band_rows 0 = the plan's choice. Returns a cudaError_t
// (0 = launched).
extern "C" int kubeflow_fused_block(const void* x, const void* w1,
                                    const void* b1, const void* w2,
                                    const void* b2, const void* w3,
                                    const void* b3, void* out, int n, int h,
                                    int w, int c, int m, int band_rows,
                                    int dtype, void* stream) {
  int plan[3];
  const int err = kubeflow_fused_block_plan(h, w, c, m, band_rows, dtype, plan);
  if (err || bad_shape(n, h, w, c, m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool narrow = column_tile(m) == 64;
#define KF_LAUNCH(T, BN, THREADS)                                            \
  launch<T, BN, THREADS>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, m,      \
                         plan[0], s)
  if (dtype == 0)
    return narrow ? KF_LAUNCH(float, 64, 256) : KF_LAUNCH(float, 128, 256);
  if (plan[2] == 256)
    return narrow ? KF_LAUNCH(bf16, 64, 256) : KF_LAUNCH(bf16, 128, 256);
  return narrow ? KF_LAUNCH(bf16, 64, 512) : KF_LAUNCH(bf16, 128, 512);
#undef KF_LAUNCH
}
