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
// Tiling. The TPU kernel keeps a whole image's c1 plane with its halo in
// VMEM, one grid step per image; at 56x56x64 that plane is 430 KB in bf16 and
// a block here has 227 KB of shared memory. So the tile space is (image,
// band of R output rows):
//   phase A  c1 for the image rows r0 - 1 .. r0 + R that lie inside the
//            image (the halo rows are recomputed by the neighbouring bands;
//            rows outside the image are not computed and stay zero, as do the
//            two halo columns) into a shared plane, x staged by cp.async;
//   phase B  the 3x3 as an implicit im2col: pixels are indexed over the
//            PADDED width, p = y (W + 2) + x, so that tap (dy, dx) of pixel p
//            is plane row p + dy (W + 2) + dx and the A operand of
//            [R (W+2), 9M] x [9M, M] is read straight from the plane at nine
//            row offsets, never materialised. Result into a second buffer;
//   phase C  [R (W+2), M] x [M, C] read straight from that buffer, plus b3
//            plus the residual x, relu, one store.
// Weights do not fit beside the planes at the deep stages (W2 at M 512 is
// 4.7 MB): every product streams its weight tiles from device memory through
// kStages cp.async stages; all blocks read the same weights, so the 50 MB L2
// serves them. A phase is ONE stream of (output tile, reduction step) pairs:
// the copies of the next tile's first steps are in flight while this tile's
// last steps and its epilogue run, and a step costs one __syncthreads. R is,
// of the bands that fit, the one with the fewest staged steps over the image
// (the halo rows and ragged tiles counted).
//
// The bf16 core: mma.sync m16n8k16 (bf16 operands, fp32 sums) from ldmatrix,
// csrc/mma.cuh. Eight warps a block; a warp owns a WM x 64 output tile, its
// WM / 16 x 8 C fragments in registers (64 or 128 fp32 a thread). The A
// operand comes in through ldmatrix.x4 with one row address a lane, so the
// nine taps' shifts, which are not multiples of 8 rows, cost nothing (a
// wgmma descriptor's 8-row swizzle atoms cannot express them); B through
// ldmatrix.x4.trans from the row-major [K, N] weight stage; 16-row fragments
// past a tile's last real row are skipped. A staged step is 64 deep (4 k16
// slices a barrier) where 64 divides C and M, else 32. Shared rows are
// padded by 8 bf16 (16 bytes): every row starts on a 16-byte boundary, and 8
// consecutive rows of a fragment fall in distinct 16-byte bank groups. The
// epilogues of phases A and B run on the C fragments in registers: lane
// (g, t) of a fragment holds rows g and g + 8 at columns 2t, 2t + 1, adds the
// bias in fp32, applies relu and writes bf16x2 words into the plane or c2.
// Phase C stages its output tile where the plane was (dead by then): the
// tile's residual x comes in by cp.async with its last step's weights, each
// lane adds it to its pairs in fp32 and writes y back in place, and each warp
// then stores its part 16 bytes a lane (with 4-byte loads of x and stores
// of y straight from the registers, phase C took 1.2 of 2.0 ms at 56x56 on
// an H100). The block's tile BM x BN follows from M:
//   M <= 64   256 x 64   (8 x 1 warps of 32 x 64)
//   M <= 128  256 x 128  (4 x 2 warps of 64 x 64)
//   M <= 256  128 x 256  (2 x 4 warps of 64 x 64)
//   M >  256   64 x 256  (2 x 4 warps of 32 x 64: the 7x7 image is 63 rows)
// Rows computed and thrown away at ResNet-50's stages (bands of 8, 7, 8
// and 7 rows): in phases B and C the padded-width columns and the 16-row
// rounding of each band's in-image pixels, 3248 rows for 3136 pixels at
// 56x56 (3.4 %), 896 for 784 at 28x28 (12.5 %), 224 for 196 at 14x14
// (12.5 %), 64 for 49 at 7x7 (23 %); in phase A the halo rows each band
// recomputes and the rounding, 3824 rows of c1 for 3136 (18 %), 960 for 784
// (18 %), 240 for 196 (18 %) and 64 for 49 (23 %).
// What bounds it: one block of 8 warps an SM (the planes take the shared
// memory), so a step's copies hide only behind one step's products, and
// every block streams all of W1, W2 and W3 from L2 for each row tile (8.7 MB
// an image at 7x7). fp32 runs on the CUDA cores (the conformance path): 16 x
// 16 threads, 16-deep steps. TMA multicast of the weight tiles across a
// cluster, wgmma and a persistent grid are later work.

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace kubeflow;
using bf16 = __nv_bfloat16;

constexpr int kMaxSmem = 232448;   // 227 KB a block on sm_90
constexpr int kThreads = 256;      // a block, both paths: 8 warps
constexpr int kWarps = kThreads / 32;
// Staged copies a phase keeps. 2, 3 and 4 measured alike on an H100 with
// this core (3 and 4 fit only at 56x56 and 28x28); 2 leaves the planes the
// most room.
constexpr int kStages = 2;

// Row paddings of the staged x tile (kA), the staged weight tile (kB) and
// the shared planes (kM), in elements: 16 bytes in bf16 (ldmatrix needs rows
// on 16-byte boundaries, and a 16-byte pad keeps its rows free of bank
// conflicts), 4 floats in fp32.
template <typename T> struct Pad;
template <> struct Pad<bf16> {
  static constexpr int kA = 8, kB = 8, kM = 8;
};
template <> struct Pad<float> {
  static constexpr int kA = 4, kB = 4, kM = 4;
};

// Reduction depth of phase A's staged steps: its x tile is BM rows tall, so
// a step deeper than 64 would not leave the planes room.
__host__ __device__ constexpr int depth_a(int depth) {
  return depth < 64 ? depth : 64;
}

__host__ __device__ constexpr int align_up(int x, int a) {
  return (x + a - 1) / a * a;
}

// Phase C's output tiles in bf16 (the residual x staged in, y written back
// in place, then stored 16 bytes a lane) live where the c1 plane was: so
// many that the copy of a tile's residual, issued kStages - 1 steps ahead,
// never lands in a buffer whose tile is still being stored.
__host__ __device__ constexpr int residual_buffers(int steps) {
  return (kStages + steps - 1) / steps;
}

// Shared-memory layout of one block, the same on the host (to size the
// launch) and on the device: [c1 plane | phase C's output tiles]
// [c2 | staged x][staged weights]. Offsets in bytes.
struct Layout {
  int wp, mp, pixels, rows, plane_rows;
  int c2_off, b_off, bytes;
};

template <typename T>
__host__ __device__ Layout make_layout(int w, int m, int band, int bm, int bn,
                                       int depth) {
  constexpr bool kMma = sizeof(T) == 2;
  Layout l;
  l.wp = w + 2;
  l.mp = m + Pad<T>::kM;
  l.pixels = band * l.wp;                       // padded-width pixels of the band
  l.rows = kMma ? align_up(l.pixels, 16) : l.pixels;   // rows of c2
  l.plane_rows = l.rows + 2 * l.wp + 2;         // the furthest tap of the last row
  const int sz = static_cast<int>(sizeof(T));
  int plane = align_up(l.plane_rows * l.mp * sz, 128);
  if (kMma) {
    const int tiles = residual_buffers(m / depth) * bm * (bn + 8) * sz;
    if (plane < tiles) plane = align_up(tiles, 128);
  }
  const int staged_x = kStages * bm * (depth_a(depth) + Pad<T>::kA) * sz;
  int c2 = l.rows * l.mp * sz;
  if (c2 < staged_x) c2 = staged_x;             // phase A stages x where c2 goes
  l.c2_off = plane;
  l.b_off = l.c2_off + align_up(c2, 128);
  l.bytes = l.b_off + align_up(kStages * depth * (bn + Pad<T>::kB) * sz, 128);
  return l;
}

// The rows of c2 phases B and C compute for a band with `real` rows inside
// the image: in bf16 their padded-width pixels rounded up to whole 16-row
// fragments; the fp32 path computes the whole band.
template <typename T>
__host__ __device__ int band_rows(const Layout& l, int real) {
  return sizeof(T) == 2 ? align_up(real * l.wp, 16) : l.rows;
}

// What an epilogue hands its caller at once: N sums of one output row at N
// consecutive columns (a bf16x2 pair of a C fragment, 1 on the fp32 path).
template <int N> struct Vals {
  float v[N];
};

__device__ __forceinline__ void store_vals(float* dst, const Vals<1>& o) {
  *dst = o.v[0];
}
__device__ __forceinline__ void store_vals(bf16* dst, const Vals<2>& o) {
  // dst is 4-byte aligned: the column is even
  *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(o.v[0],
                                                                  o.v[1]);
}
__device__ __forceinline__ void add_vals(const float* src, Vals<1>& o) {
  o.v[0] += *src;
}
__device__ __forceinline__ void add_vals(const bf16* src, Vals<2>& o) {
  const float2 x =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(src));
  o.v[0] += x.x;
  o.v[1] += x.y;
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

// One block's BM x BN fp32 product, accumulated one staged step at a time.
// A (tile row i, reduction index p of the step) is read at a[i * lda + p],
// B (p, column j) at Bs[p * ldb + j]. Rows at or beyond rows_lim hold
// nothing: the bf16 version skips their 16-row fragments, the fp32 version
// reads row rows_lim - 1 in their place; the caller drops the result.
template <typename T, int BM, int BN> struct BlockGemm;

// bf16 on the tensor cores: warp w owns rows WM (w / (BN / 64)) and
// columns 64 (w % (BN / 64)) as WM / 16 x 8 C fragments of m16n8.
template <int BM, int BN> struct BlockGemm<bf16, BM, BN> {
  static constexpr int kWarpsN = BN / 64;
  static constexpr int kWarpsM = kWarps / kWarpsN;
  static constexpr int kWM = BM / kWarpsM;
  static constexpr int kFm = kWM / 16;          // 16-row fragments a warp
  static_assert(kWarpsM * kWarpsN == kWarps && (kWM == 32 || kWM == 64),
                "a warp tile is 32 x 64 or 64 x 64");
  float acc[kFm][8][4];

  __device__ __forceinline__ int i0() const {
    return (threadIdx.x / 32) / kWarpsN * kWM;
  }
  __device__ __forceinline__ int j0() const {
    return (threadIdx.x / 32) % kWarpsN * 64;
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int s = 0; s < kFm; ++s)
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc[s][n][r] = 0.f;
  }

  // ldmatrix row addresses (mma.cuh): A lane l gives row l % 16 at column
  // 8 (l / 16); B (ldmatrix.trans of the [K, N] stage) lane l gives k row
  // l % 8 + 8 ((l / 8) % 2) at column 8 (l / 16), so that registers 0, 1
  // are the b0, b1 of n-block 0 and registers 2, 3 those of n-block 1.
  template <int DEPTH>
  __device__ __forceinline__ void step(const bf16* a, int lda, const bf16* Bs,
                                       int ldb, int rows_lim) {
    const int lane = threadIdx.x % 32;
    const int i = i0();
    const uint32_t a_addr =
        smem_u32(a + (i + lane % 16) * lda + (lane / 16) * 8);
    const uint32_t b_addr = smem_u32(
        Bs + (lane % 8 + ((lane / 8) % 2) * 8) * ldb + j0() + (lane / 16) * 8);
#pragma unroll
    for (int p = 0; p < DEPTH / 16; ++p) {
      uint32_t b[4][4];
#pragma unroll
      for (int nb = 0; nb < 4; ++nb)
        ldmatrix_x4_trans(b[nb], b_addr + (p * 16 * ldb + nb * 16) * 2);
#pragma unroll
      for (int s = 0; s < kFm; ++s) {
        if (i + 16 * s < rows_lim) {        // the same for the whole warp
          uint32_t af[4];
          ldmatrix_x4(af, a_addr + (s * 16 * lda + p * 16) * 2);
#pragma unroll
          for (int nb = 0; nb < 4; ++nb) {
            mma_bf16(acc[s][2 * nb], af, b[nb][0], b[nb][1]);
            mma_bf16(acc[s][2 * nb + 1], af, b[nb][2], b[nb][3]);
          }
        }
      }
    }
  }

  // f(tile row, tile column) of each 8-column (16-byte) chunk of the
  // warp's WM x 64 tile that the lane moves: a warp instruction covers 4
  // rows of 128 bytes.
  template <typename F> __device__ __forceinline__ void warp_chunks(F f) {
    const int lane = threadIdx.x % 32;
#pragma unroll
    for (int i = 0; i < kWM / 4; ++i) {
      const int k = lane + 32 * i;
      f(i0() + k / 8, j0() + (k % 8) * 8);
    }
  }

  // f(tile row, tile column, 2 sums) for every pair the lane holds: lane
  // (g, t) = (l / 4, l % 4) has rows g and g + 8 of each fragment at
  // columns 2t, 2t + 1 of each n-block.
  template <typename F> __device__ __forceinline__ void epilogue(F f) {
    const int lane = threadIdx.x % 32;
    const int r = i0() + lane / 4;
    const int c = j0() + (lane % 4) * 2;
#pragma unroll
    for (int s = 0; s < kFm; ++s)
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        f(r + 16 * s, c + 8 * n, Vals<2>{{acc[s][n][0], acc[s][n][1]}});
        f(r + 16 * s + 8, c + 8 * n, Vals<2>{{acc[s][n][2], acc[s][n][3]}});
      }
  }
};

// fp32 on the CUDA cores: thread (ty, tx) of 16 x 16 owns rows ty + 16 s and
// columns tx + 16 t.
template <int BM, int BN> struct BlockGemm<float, BM, BN> {
  static_assert(BM * BN == 32 * kThreads, "the fp32 path maps 16 x 16 threads");
  static constexpr int kS = BM / 16;
  static constexpr int kT = BN / 16;
  float acc[kS][kT];

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int t = 0; t < kT; ++t) acc[s][t] = 0.f;
  }

  template <int DEPTH>
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
    for (int p = 0; p < DEPTH; ++p) {
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

  template <typename F> __device__ __forceinline__ void epilogue(F f) {
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
#pragma unroll
    for (int s = 0; s < kS; ++s)
#pragma unroll
      for (int t = 0; t < kT; ++t) f(ty + 16 * s, tx + 16 * t, Vals<1>{{acc[s][t]}});
  }
};

// The ROWS x BN window at (k0, n0) of a row-major [K, n_cols] weight matrix
// into a staged tile with row stride ldb, 16 bytes a copy; columns at or
// beyond n_cols read as 0 (rows never leave K: K is a multiple of ROWS).
template <typename T, int BN, int ROWS>
__device__ __forceinline__ void load_weights(T* dst, int ldb, const T* w,
                                             int n_cols, int k0, int n0) {
  constexpr int V = vec_width<T>();
  for (int u = threadIdx.x; u < ROWS * BN / V; u += kThreads) {
    const int r = u / (BN / V);
    const int c = (u % (BN / V)) * V;
    const bool ok = n0 + c < n_cols;
    const T* g = ok ? w + static_cast<size_t>(k0 + r) * n_cols + (n0 + c) : w;
    cp_async16(smem_u32(dst + r * ldb + c), g, ok);
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
// fastest) of `steps` reduction steps each, run as one stream through
// kStages staged copies. load(stage, cursor) issues the cp.async copies of
// one step, compute(stage, cursor) multiplies it into the accumulators,
// done(cursor) is the tile's epilogue. The copies of step g + kStages - 1
// are issued before step g is computed, into the stage that step g - 1 has
// just left (every thread has passed this step's barrier, so none still
// reads it); one barrier a step.
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

// One block of kThreads threads per (band of `band` output rows, image):
// BM x BN output tiles, weight steps DEPTH deep (phase A's depth_a(DEPTH)).
template <typename T, int BM, int BN, int DEPTH>
__global__ void __launch_bounds__(kThreads, 1)
fused_block_kernel(const T* __restrict__ x,        // [N, H, W, C]
                   const T* __restrict__ w1,       // [C, M]
                   const float* __restrict__ b1,   // [M]
                   const T* __restrict__ w2,       // [9M, M]
                   const float* __restrict__ b2,   // [M]
                   const T* __restrict__ w3,       // [M, C]
                   const float* __restrict__ b3,   // [C]
                   T* __restrict__ out,            // [N, H, W, C]
                   int H, int W, int C, int M, int band) {
  using Gemm = BlockGemm<T, BM, BN>;
  constexpr int kDepthA = depth_a(DEPTH);
  constexpr int kLdA = kDepthA + Pad<T>::kA;
  constexpr int kLdB = BN + Pad<T>::kB;
  constexpr int kStageA = BM * kLdA;
  constexpr int kStageB = DEPTH * kLdB;
  constexpr int V = vec_width<T>();

  extern __shared__ __align__(128) unsigned char smem[];
  const Layout l = make_layout<T>(W, M, band, BM, BN, DEPTH);
  T* plane = reinterpret_cast<T*>(smem);
  T* c2 = reinterpret_cast<T*>(smem + l.c2_off);
  T* As = c2;                                    // phase A only
  T* Bs = reinterpret_cast<T*>(smem + l.b_off);
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
  // rows of c2 phases B and C compute: the band's rows inside the image
  const int rows = band_rows<T>(l, min(band, H - r0));

  // ---- phase A: c1 = relu(x . W1 + b1) on the image rows lo .. hi - 1 of
  // r0 - 1 .. r0 + band; q counts their pixels, unpadded
  {
    const int lo = max(r0 - 1, 0);
    const int hi = min(r0 + band + 1, H);
    const int q_rows = (hi - lo) * W;
    const int y0 = lo - (r0 - 1);                // plane row of q = 0
    const T* xa = xin + static_cast<size_t>(lo) * W * C;
    run_phase(
        gemm, (q_rows + BM - 1) / BM, m_tiles, C / kDepthA,
        [&](int stage, const Cursor& at) {
          const int row0 = at.rt * BM;
          const int k0 = at.s * kDepthA;
          T* a = As + stage * kStageA;
          for (int u = threadIdx.x; u < BM * kDepthA / V; u += kThreads) {
            const int r = u / (kDepthA / V);
            const int c = (u % (kDepthA / V)) * V;
            const bool ok = row0 + r < q_rows;
            cp_async16(smem_u32(a + r * kLdA + c),
                       ok ? xa + static_cast<size_t>(row0 + r) * C + (k0 + c)
                          : xa,
                       ok);
          }
          load_weights<T, BN, kDepthA>(Bs + stage * kStageB, kLdB, w1, M, k0,
                                       at.nt * BN);
        },
        [&](int stage, const Cursor& at) {
          gemm.template step<kDepthA>(As + stage * kStageA, kLdA,
                                      Bs + stage * kStageB, kLdB,
                                      q_rows - at.rt * BM);
        },
        [&](const Cursor& at) {
          const int row0 = at.rt * BM;
          const int n0 = at.nt * BN;
          gemm.epilogue([&](int r, int c, auto o) {
            const int q = row0 + r;
            const int col = n0 + c;
            if (q < q_rows && col < M) {
              const int y = q / W;
              const int xx = q - y * W;
              add_bias(b1 + col, o);
              relu(o);
              store_vals(plane + ((y0 + y) * wp + xx + 1) * mp + col, o);
            }
          });
        });
  }

  // ---- phase B: c2 = relu(im2col(c1) . W2 + b2), A read from the plane
  run_phase(
      gemm, (rows + BM - 1) / BM, m_tiles, 9 * M / DEPTH,
      [&](int stage, const Cursor& at) {
        load_weights<T, BN, DEPTH>(Bs + stage * kStageB, kLdB, w2, M,
                                   at.s * DEPTH, at.nt * BN);
      },
      [&](int stage, const Cursor& at) {
        const int row0 = at.rt * BM;
        const int kk = at.s * DEPTH;
        const int tap = kk / M;                  // DEPTH divides M
        const int shift = (tap / 3) * wp + tap % 3;
        gemm.template step<DEPTH>(plane + (row0 + shift) * mp + (kk - tap * M),
                                  mp, Bs + stage * kStageB, kLdB,
                                  rows - row0);
      },
      [&](const Cursor& at) {
        const int row0 = at.rt * BM;
        const int n0 = at.nt * BN;
        gemm.epilogue([&](int r, int c, auto o) {
          const int p = row0 + r;
          const int col = n0 + c;
          if (p < rows && col < M) {
            add_bias(b2 + col, o);
            relu(o);
            store_vals(c2 + p * mp + col, o);
          }
        });
      });

  // ---- phase C: y = relu(c2 . W3 + b3 + x), A read from c2. bf16: the
  // tile's residual comes in with its last step's copies, into one of the
  // output tiles where the plane was
  {
    const int c_tiles = (C + BN - 1) / BN;
    const int steps = M / DEPTH;
    T* yout = out + image;
    constexpr int kLdR = BN + 8;
    const int n_res = residual_buffers(steps);
    // the output tile of cursor at, and where its rows lie in the image
    auto tile_of = [&](const Cursor& at) {
      return plane + (at.rt * c_tiles + at.nt) % n_res * (BM * kLdR);
    };
    auto image_at = [&](int p, int col, bool& ok) {
      const int y = p / wp;
      const int xx = p - y * wp;
      ok = p < l.pixels && xx < W && r0 + y < H && col < C;
      return (static_cast<size_t>(r0 + y) * W + xx) * C + col;
    };
    run_phase(
        gemm, (rows + BM - 1) / BM, c_tiles, steps,
        [&](int stage, const Cursor& at) {
          load_weights<T, BN, DEPTH>(Bs + stage * kStageB, kLdB, w3, C,
                                     at.s * DEPTH, at.nt * BN);
          if constexpr (sizeof(T) == 2) {
            if (at.s == steps - 1) {
              T* res = tile_of(at);
              for (int u = threadIdx.x; u < BM * BN / V; u += kThreads) {
                const int r = u / (BN / V);
                const int c = (u % (BN / V)) * V;
                bool ok;
                const size_t g =
                    image_at(at.rt * BM + r, at.nt * BN + c, ok);
                cp_async16(smem_u32(res + r * kLdR + c), ok ? xin + g : xin,
                           ok);
              }
            }
          }
        },
        [&](int stage, const Cursor& at) {
          const int row0 = at.rt * BM;
          gemm.template step<DEPTH>(c2 + row0 * mp + at.s * DEPTH, mp,
                                    Bs + stage * kStageB, kLdB,
                                    rows - row0);
        },
        [&](const Cursor& at) {
          const int row0 = at.rt * BM;
          const int n0 = at.nt * BN;
          if constexpr (sizeof(T) == 2) {
            // y in place of the residual in the warp's part of the tile,
            // then that part to memory
            T* res = tile_of(at);
            gemm.epilogue([&](int r, int c, auto o) {
              if (n0 + c < C) {
                add_bias(b3 + n0 + c, o);
                add_vals(res + r * kLdR + c, o);   // the residual, in fp32
                relu(o);
                store_vals(res + r * kLdR + c, o);
              }
            });
            __syncwarp();
            gemm.warp_chunks([&](int r, int c) {
              bool ok;
              const size_t g = image_at(row0 + r, n0 + c, ok);
              if (ok)
                *reinterpret_cast<uint4*>(yout + g) =
                    *reinterpret_cast<const uint4*>(res + r * kLdR + c);
            });
          } else {
            gemm.epilogue([&](int r, int c, auto o) {
              bool ok;
              const size_t g = image_at(row0 + r, n0 + c, ok);
              if (ok) {
                add_bias(b3 + n0 + c, o);
                add_vals(xin + g, o);              // the residual, in fp32
                relu(o);
                store_vals(yout + g, o);
              }
            });
          }
        });
  }
}

// What one launch uses.
struct Plan {
  int band, bytes, threads, bm, bn, depth;
};

// The block's output tile and step depth: fp32 BN 64 (M < 128) or 128 and
// BM x BN = 32 values a thread, 16 deep; bf16 the tile by M (see the
// header), 64 deep where 64 divides C and M, else 32.
void tiles(int dtype, int c, int m, Plan& p) {
  p.threads = kThreads;
  if (dtype == 0) {
    p.bn = m < 128 ? 64 : 128;
    p.bm = 32 * kThreads / p.bn;
    p.depth = 16;
    return;
  }
  p.bn = m <= 64 ? 64 : m <= 128 ? 128 : 256;
  p.bm = m <= 128 ? 256 : m <= 256 ? 128 : 64;
  p.depth = c % 64 == 0 && m % 64 == 0 ? 64 : 32;
}

template <typename T>
Layout plan_layout(int w, int m, int band, const Plan& p) {
  return make_layout<T>(w, m, band, p.bm, p.bn, p.depth);
}

// The staged reduction steps all blocks of one image run with bands of
// `band` rows: what the time follows, since every step pulls one weight tile
// from L2. Phase A's row tiles cover the band's in-image rows only.
template <typename T>
long image_steps(int h, int w, int c, int m, const Plan& p, int band) {
  const Layout l = plan_layout<T>(w, m, band, p);
  const long m_tiles = (m + p.bn - 1) / p.bn;
  const long c_tiles = (c + p.bn - 1) / p.bn;
  long steps = 0;
  for (int r0 = 0; r0 < h; r0 += band) {
    const int lo = r0 > 0 ? r0 - 1 : 0;
    const int hi = r0 + band + 1 < h ? r0 + band + 1 : h;
    const long a_tiles = ((hi - lo) * w + p.bm - 1) / p.bm;
    const long b_tiles =
        (band_rows<T>(l, band < h - r0 ? band : h - r0) + p.bm - 1) / p.bm;
    steps += a_tiles * m_tiles * (c / depth_a(p.depth)) +
             b_tiles * m_tiles * (9 * m / p.depth) +
             b_tiles * c_tiles * (m / p.depth);
  }
  return steps;
}

// The band the launch uses: `asked` rows when given (> 0), else of the bands
// that fit a block's shared memory the one with the fewest staged steps over
// the image (ties to the taller band). False when nothing fits.
template <typename T>
bool plan_band(int h, int w, int c, int m, int asked, Plan& p) {
  int best = 0;
  if (asked > 0) {
    if (plan_layout<T>(w, m, asked, p).bytes <= kMaxSmem) best = asked;
  } else {
    long best_cost = 0;
    for (int r = h; r >= 1; --r) {
      if (plan_layout<T>(w, m, r, p).bytes > kMaxSmem) continue;
      const long cost = image_steps<T>(h, w, c, m, p, r);
      if (!best || cost < best_cost) best = r, best_cost = cost;
    }
  }
  if (!best) return false;
  p.band = best;
  p.bytes = plan_layout<T>(w, m, best, p).bytes;
  return true;
}

template <typename T, int BM, int BN, int DEPTH>
int launch(const void* x, const void* w1, const void* b1, const void* w2,
           const void* b2, const void* w3, const void* b3, void* out, int n,
           int h, int w, int c, int m, const Plan& p, cudaStream_t stream) {
  auto kernel = fused_block_kernel<T, BM, BN, DEPTH>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((h + p.band - 1) / p.band, n);
  kernel<<<grid, kThreads, p.bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1),
      static_cast<const float*>(b1), static_cast<const T*>(w2),
      static_cast<const float*>(b2), static_cast<const T*>(w3),
      static_cast<const float*>(b3), static_cast<T*>(out), h, w, c, m,
      p.band);
  return static_cast<int>(cudaGetLastError());
}

bool bad_shape(int n, int h, int w, int c, int m) {
  return n < 1 || n > 65535 || h < 1 || w < 1 || m < 32 || m % 32 != 0 ||
         c < 32 || c % 32 != 0 ||
         static_cast<long>(h) * w * c > 0x7fffffffL;
}

int make_plan(int h, int w, int c, int m, int band_rows, int dtype, Plan& p) {
  if (bad_shape(1, h, w, c, m) || band_rows < 0 || band_rows > h ||
      (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  tiles(dtype, c, m, p);
  const bool ok = dtype == 0 ? plan_band<float>(h, w, c, m, band_rows, p)
                             : plan_band<bf16>(h, w, c, m, band_rows, p);
  return ok ? 0 : static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// What a launch at this shape would use: plan[0] = the band's rows, plan[1] =
// its dynamic shared memory in bytes, plan[2] = the block's threads.
// band_rows 0 = choose. dtype: 0 = float32, 1 = bfloat16. Returns 0, or
// cudaErrorInvalidValue when the shape is not taken or no band fits.
extern "C" int kubeflow_fused_block_plan(int h, int w, int c, int m,
                                         int band_rows, int dtype, int* plan) {
  Plan p;
  const int err = make_plan(h, w, c, m, band_rows, dtype, p);
  if (err) return err;
  plan[0] = p.band;
  plan[1] = p.bytes;
  plan[2] = p.threads;
  return 0;
}

// The rest of the plan, for measurement: tiles[0] = the block's output
// rows BM, tiles[1] = its columns BN, tiles[2] = the staged step's depth.
// Arguments and result as kubeflow_fused_block_plan.
extern "C" int kubeflow_fused_block_tiles(int h, int w, int c, int m,
                                          int band_rows, int dtype,
                                          int* tiles) {
  Plan p;
  const int err = make_plan(h, w, c, m, band_rows, dtype, p);
  if (err) return err;
  tiles[0] = p.bm;
  tiles[1] = p.bn;
  tiles[2] = p.depth;
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
  Plan p;
  if (make_plan(h, w, c, m, band_rows, dtype, p) || bad_shape(n, h, w, c, m))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define KF_LAUNCH(T, BM, BN, DEPTH)                                          \
  launch<T, BM, BN, DEPTH>(x, w1, b1, w2, b2, w3, b3, out, n, h, w, c, m, p, \
                           s)
#define KF_TILE(BM, BN, DEPTH)                                \
  if (p.bm == BM && p.bn == BN && p.depth == DEPTH)          \
    return KF_LAUNCH(bf16, BM, BN, DEPTH);
  if (dtype == 0)
    return p.bn == 64 ? KF_LAUNCH(float, 128, 64, 16)
                      : KF_LAUNCH(float, 64, 128, 16);
  KF_TILE(256, 64, 64) KF_TILE(256, 64, 32)
  KF_TILE(256, 128, 64) KF_TILE(256, 128, 32)
  KF_TILE(128, 256, 64) KF_TILE(128, 256, 32)
  KF_TILE(64, 256, 64) KF_TILE(64, 256, 32)
  return static_cast<int>(cudaErrorInvalidValue);
#undef KF_TILE
#undef KF_LAUNCH
}
