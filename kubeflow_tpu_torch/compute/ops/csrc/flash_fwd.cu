// K3 — tiled attention forward (causal or full), for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   kubeflow_tpu/compute/ops/flash_attention.py::_fwd_kernel
// (called through _fwd / flash_attention, same file). Wrapper, plain
// PyTorch version and launch counter: ../flash_attention.py.
//
// What it computes, per batch row b and query head h:
//   out = softmax(q k^T) v,  lse = m + log(l)      (fp32 row statistics)
// q arrives pre-scaled (softmax scale folded in fp32 and rounded once to
// the input dtype by the wrapper). Scores and the online-softmax state
// (m, l, the output accumulator) are fp32; p is rounded to the input
// dtype before the p.V product while l sums the unrounded p — the TPU
// kernel's numerics (flash_attention.py:60-66). No l guard: with the
// causal mask every row keeps at least its diagonal.
// GQA is native: query head h reads kv head h / (H / kv_heads), so the
// callers never materialize repeated K/V. A ragged last tile (query or
// key) is masked here, so any sequence length is served — the JAX
// package falls back to XLA dense attention when S does not tile.
//
// Bound on this card: operations for the long prompts. At S = 1024,
// 8 heads, head_dim 128, causal, the forward does ~2.15 GFLOP over
// ~5.3 MB of q/k/v/out in bf16 — ~400 FLOPs per byte, above the ~295
// where an H100 leaves the memory roof; the least time is the FLOPs
// over the tensor cores' 989 TFLOP/s (bf16). Short prompts (S = 8) are
// bytes- and launch-bound.
//
// Two designs, chosen by dtype:
// bf16 (flash_fwd_tc_kernel) — the FlashAttention-2 form on the tensor
//   cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators; helpers
//   in mma.cuh). One block of 4 warps per (64-row query tile, b x h),
//   each warp owning 16 query rows; its pre-scaled q rows are loaded
//   once into A fragments. K/V tiles of 64 keys stream through bf16
//   shared memory, double-buffered by cp.async (rows past Sk land as
//   zeros), rows padded to D + 8 elements so that ldmatrix is free of
//   bank conflicts. S = q K^T takes K through ldmatrix; the row max and
//   sum stay in registers, reduced over the 4 lanes of a quad; p is
//   rounded into bf16 A fragments in registers (the TPU kernel's
//   p.astype(dt)) while l sums the fp32 p; O += p V takes V through
//   ldmatrix.trans. Causal: tiles past the diagonal are never loaded,
//   and blockIdx.x runs the query tiles with the most key tiles first.
//   The operations are on the tensor cores; what bounds it now is the
//   issue of mma.sync and ldmatrix from 4-warp blocks (no wgmma, no
//   TMA, no warp specialisation) and, at B = 1, the fill of 132 SMs.
// fp32 (flash_fwd_kernel) — every product on the CUDA cores in fp32
//   (the port runs with TF32 off, and the fp32 tolerance of 1e-4 needs
//   exact products): one block per (64-row query tile, b x h), K/V
//   tiles of 32 rows through fp32 shared memory, each thread a 4 x 4
//   score tile and a 4 x D/8 slice of the output accumulator.

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace kubeflow;

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kBq = 64;        // query rows per block
constexpr int kBk = 32;        // key rows per streamed tile
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = kBk / 8; // key columns per thread

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBq) * (D + 1) + kBk * (D + 1) + kBk * D +
         kBq * (kBk + 1);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q,   // [B, S, H, D], pre-scaled
                 const T* __restrict__ k,   // [B, Sk, kv_heads, D]
                 const T* __restrict__ v,   // [B, Sk, kv_heads, D]
                 T* __restrict__ out,       // [B, S, H, D]
                 float* __restrict__ lse,   // [B, H, S]
                 int S, int Sk, int H, int kv_heads, int causal) {
  constexpr int kVec = vec_width<T>();
  constexpr int kRowUnits = D / kVec;                  // 16-byte words a row
  constexpr int kLoads = kBk * kRowUnits / kThreads;   // per thread, per tile
  static_assert(kBk * kRowUnits % kThreads == 0, "tile splits over threads");

  extern __shared__ float smem[];
  float* q_s = smem;                   // [kBq][D + 1]
  float* k_s = q_s + kBq * (D + 1);    // [kBk][D + 1]
  float* v_s = k_s + kBk * (D + 1);    // [kBk][D]
  float* p_s = v_s + kBk * D;          // [kBq][kBk + 1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / kv_heads);
  const int q0 = blockIdx.x * kBq;
  const int tid = threadIdx.x;
  const int ty = tid / 8;   // rows ty*4 .. ty*4+3 of the query tile
  const int tx = tid % 8;   // key columns tx + 8j, value columns tx + 8j

  for (int u = tid; u < kBq * kRowUnits; u += kThreads) {
    const int r = u / kRowUnits;
    const int c = (u % kRowUnits) * kVec;
    const int s = q0 + r;
    float x[kVec];
    if (s < S) {
      unpack16<T>(load16(q + ((static_cast<size_t>(b) * S + s) * H + h) * D
                         + c), x);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) q_s[r * (D + 1) + c + i] = x[i];
  }

  // one K/V tile's words in registers: rows past Sk are 0
  uint4 kr[kLoads], vr[kLoads];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = tid + j * kThreads;
      const int s = k0 + u / kRowUnits;
      if (s < Sk) {
        const size_t off = ((static_cast<size_t>(b) * Sk + s) * kv_heads + kvh)
                           * D + (u % kRowUnits) * kVec;
        kr[j] = load16(k + off);
        vr[j] = load16(v + off);
      } else {
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = kr[j];
      }
    }
  };

  float m[kRows], l[kRows], o[kRows][D / 8];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[r][j] = 0.f;
  }

  // causal: keys past the tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + kBq) : Sk;
  load_tile(0);
  for (int k0 = 0; k0 < k_end; k0 += kBk) {
    __syncthreads();   // q_s is loaded; the last tile's readers are done
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = tid + j * kThreads;
      const int c = u / kRowUnits;
      const int d = (u % kRowUnits) * kVec;
      float kx[kVec], vx[kVec];
      unpack16<T>(kr[j], kx);
      unpack16<T>(vr[j], vx);
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        k_s[c * (D + 1) + d + i] = kx[i];
        v_s[c * D + d + i] = vx[i];
      }
    }
    __syncthreads();
    if (k0 + kBk < k_end) load_tile(k0 + kBk);   // in flight now

    float sc[kRows][kCols];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[r][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[kRows], ka[kCols];
#pragma unroll
      for (int r = 0; r < kRows; ++r) qa[r] = q_s[(ty * kRows + r) * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kCols; ++j) ka[j] = k_s[(tx + 8 * j) * (D + 1) + d];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kCols; ++j) sc[r][j] += qa[r] * ka[j];
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + ty * kRows + r;
      bool valid[kCols];
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int kpos = k0 + tx + 8 * j;
        valid[j] = kpos < Sk && (!causal || kpos <= qpos);
        if (!valid[j]) sc[r][j] = kNegInf;
        mx = fmaxf(mx, sc[r][j]);
      }
      // the 8 threads of one row group are adjacent lanes of one warp
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float corr = expf(m[r] - mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = valid[j] ? expf(sc[r][j] - mx) : 0.f;
        sum += p;
        p_s[(ty * kRows + r) * (kBk + 1) + tx + 8 * j] = round_to<T>(p);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[r] = l[r] * corr + sum;
      m[r] = mx;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) o[r][j] *= corr;
    }
    __syncthreads();

    const int n_c = min(kBk, k_end - k0);
    for (int c = 0; c < n_c; ++c) {
      float va[D / 8];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) va[j] = v_s[c * D + tx + 8 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = p_s[(ty * kRows + r) * (kBk + 1) + c];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) o[r][j] += p * va[j];
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + ty * kRows + r;
    if (qpos < S) {
      const size_t base = ((static_cast<size_t>(b) * S + qpos) * H + h) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        out[base + tx + 8 * j] = from_f32<T>(o[r][j] / l[r]);
      if (tx == 0)
        lse[(static_cast<size_t>(b) * H + h) * S + qpos] = m[r] + logf(l[r]);
    }
  }
}

// ------------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;   // 4 warps x 16 query rows
constexpr int kTcBq = 64;         // query rows per block
constexpr int kTcBk = 64;         // keys per streamed tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
__host__ __device__ constexpr int tc_stride() {   // bf16 elements a row
  return D + 8;
}

template <int D>
constexpr size_t tc_smem_bytes() {   // q, then 2 stages of K and of V
  return static_cast<size_t>(kTcBq + 4 * kTcBk) * tc_stride<D>() *
         sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_tc_kernel(const bf16* __restrict__ q,   // [B, S, H, D], pre-scaled
                    const bf16* __restrict__ k,   // [B, Sk, kv_heads, D]
                    const bf16* __restrict__ v,   // [B, Sk, kv_heads, D]
                    bf16* __restrict__ out,       // [B, S, H, D]
                    float* __restrict__ lse,      // [B, H, S]
                    int B, int S, int Sk, int H, int kv_heads, int causal) {
  constexpr int kStride = tc_stride<D>();
  constexpr int kChunks = D / 8;     // 16-byte chunks a row
  constexpr int kKs = D / 16;        // k-slices of q.K^T
  constexpr int kNb = kTcBk / 8;     // n-blocks of S (8 keys each)
  constexpr int kDb = D / 8;         // n-blocks of O

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [kTcBq][kStride]
  bf16* k_s = q_s + kTcBq * kStride;               // [2][kTcBk][kStride]
  bf16* v_s = k_s + 2 * kTcBk * kStride;           // [2][kTcBk][kStride]

  // the query tiles with the most key tiles (causal: the last) first
  const int BH = B * H;
  const int n_qt = (S + kTcBq - 1) / kTcBq;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kTcBq;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / kv_heads);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8
  const int t = lane % 4;   // accumulator columns 2t, 2t + 1

  for (int c = tid; c < kTcBq * kChunks; c += kTcThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int s = q0 + r;
    const bf16* src =
        q + ((static_cast<size_t>(b) * S + min(s, S - 1)) * H + h) * D + col;
    cp_async16(smem_u32(q_s + r * kStride + col), src, s < S);
  }
  // this thread's 16-byte chunks of a K/V tile: rows r0 + i * kRowStep,
  // columns col0..col0 + 7; offsets computed once
  constexpr int kRowStep = kTcThreads / kChunks;
  constexpr int kLoads = kTcBk / kRowStep;
  const int r0 = tid / kChunks;
  const int col0 = (tid % kChunks) * 8;
  const size_t kv_row = static_cast<size_t>(kv_heads) * D;   // between keys
  const size_t kv_base =
      (static_cast<size_t>(b) * Sk * kv_heads + kvh) * D + col0;
  const uint32_t k_dst = smem_u32(k_s + r0 * kStride + col0);
  const uint32_t v_dst = smem_u32(v_s + r0 * kStride + col0);
  auto load_kv = [&](int k0, int stage) {
    const uint32_t dst0 = stage * kTcBk * kStride * sizeof(bf16);
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int s = k0 + r0 + i * kRowStep;
      const size_t off = kv_base + min(s, Sk - 1) * kv_row;
      const uint32_t dst = dst0 + i * kRowStep * kStride * sizeof(bf16);
      cp_async16(k_dst + dst, k + off, s < Sk);
      cp_async16(v_dst + dst, v + off, s < Sk);
    }
  };
  load_kv(0, 0);
  cp_async_commit();   // group 0: the q tile and the first K/V tile

  // causal: keys past the tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + kTcBq) : Sk;
  const int n_kt = (k_end + kTcBk - 1) / kTcBk;
  const int row0 = q0 + warp * 16 + g;   // this lane's rows: row0, row0 + 8

  // ldmatrix row addresses of this lane (see mma.cuh): A from q rows,
  // B (non-transposed) from K rows, B (transposed) from V rows
  const uint32_t q_addr = smem_u32(q_s + (warp * 16 + (lane % 16)) * kStride +
                                   (lane / 16) * 8);
  const int kb_row = (lane % 8) + (lane / 16) * 8;
  const int kb_col = ((lane / 8) % 2) * 8;
  const int vb_row = (lane % 8) + ((lane / 8) % 2) * 8;
  const int vb_col = (lane / 16) * 8;

  uint32_t qf[kKs][4];
  float o[kDb][4];
#pragma unroll
  for (int j = 0; j < kDb; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this lane's partial sums; the quad's at the end

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % 2;
    // one barrier a tile: tile kt has landed for every thread, and every
    // warp is done with tile kt - 1, whose buffer the next load reuses
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < n_kt) {
      load_kv((kt + 1) * kTcBk, stage ^ 1);
      cp_async_commit();
    }
    if (kt == 0) {
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks)
        ldmatrix_x4(qf[ks], q_addr + ks * 16 * sizeof(bf16));
    }
    const bf16* kst = k_s + stage * kTcBk * kStride;
    const bf16* vst = v_s + stage * kTcBk * kStride;

    float sc[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
#pragma unroll
      for (int nb = 0; nb < kNb / 2; ++nb) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(kst + (nb * 16 + kb_row) * kStride +
                                 ks * 16 + kb_col));
        mma_bf16(sc[2 * nb], qf[ks], kb[0], kb[1]);
        mma_bf16(sc[2 * nb + 1], qf[ks], kb[2], kb[3]);
      }
    }

    // mask (only the diagonal tile and a ragged last one have masked
    // entries), then the online softmax of rows row0 (i = 0, 1) and
    // row0 + 8 (i = 2, 3)
    const int k0 = kt * kTcBk;
    const bool masked = k0 + kTcBk > Sk || (causal && k0 + kTcBk - 1 > q0);
    if (masked) {
#pragma unroll
      for (int j = 0; j < kNb; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int kpos = k0 + j * 8 + 2 * t + (i % 2);
          const int qpos = row0 + (i / 2) * 8;
          if (kpos >= Sk || (causal && kpos > qpos)) sc[j][i] = kNegInf;
        }
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) mx[i / 2] = fmaxf(mx[i / 2], sc[j][i]);
    float corr[2], m_log2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      corr[r] = exp2f((m[r] - mx[r]) * kLog2e);
      m[r] = mx[r];
      m_log2[r] = mx[r] * kLog2e;
      l[r] *= corr[r];
    }
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float p = exp2f(fmaf(sc[j][i], kLog2e, -m_log2[i / 2]));
        if (masked && sc[j][i] == kNegInf) p = 0.f;   // explicit p = 0
        l[i / 2] += p;
        sc[j][i] = p;
      }
#pragma unroll
    for (int j = 0; j < kDb; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }

    // O += round(p) V, p straight from the S accumulators
#pragma unroll
    for (int kk = 0; kk < kTcBk / 16; ++kk) {
      uint32_t pa[4];
      pack_a(pa, sc[2 * kk], sc[2 * kk + 1]);
#pragma unroll
      for (int db = 0; db < kDb / 2; ++db) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vst + (kk * 16 + vb_row) * kStride +
                                       db * 16 + vb_col));
        mma_bf16(o[2 * db], pa, vb[0], vb[1]);
        mma_bf16(o[2 * db + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= S) continue;
    // one reciprocal a row: 64 IEEE divisions a thread cost 4-8 % of
    // the kernel, for a difference of an fp32 ulp before the bf16 rounding
    const float inv = 1.f / l[r];
    bf16* dst =
        out + ((static_cast<size_t>(b) * S + qpos) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDb; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    if (t == 0)
      lse[(static_cast<size_t>(b) * H + h) * S + qpos] = m[r] + logf(l[r]);
  }
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* out,
              void* lse, int B, int S, int Sk, int H, int kv_heads,
              int causal, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  static bool attribute_set = false;   // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_tc_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const int blocks = (S + kTcBq - 1) / kTcBq * B * H;
  flash_fwd_tc_kernel<D><<<blocks, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(out),
      static_cast<float*>(lse), B, S, Sk, H, kv_heads, causal);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------- launches, dispatch

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, void* lse,
           int B, int S, int Sk, int H, int kv_heads, int causal,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  static bool attribute_set = false;   // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const dim3 grid((S + kBq - 1) / kBq, B * H);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), static_cast<float*>(lse),
      S, Sk, H, kv_heads, causal);
  return static_cast<int>(cudaGetLastError());
}

// fp32 on the CUDA cores, bf16 on the tensor cores
int dispatch_dim(int head_dim, int dtype, const void* q, const void* k,
                 const void* v, void* out, void* lse, int B, int S, int Sk,
                 int H, int kv_heads, int causal, cudaStream_t s) {
  const bool tc = dtype == 1;
  switch (head_dim) {
    case 32:
      return tc ? launch_tc<32>(q, k, v, out, lse, B, S, Sk, H, kv_heads,
                                causal, s)
                : launch<float, 32>(q, k, v, out, lse, B, S, Sk, H, kv_heads,
                                    causal, s);
    case 64:
      return tc ? launch_tc<64>(q, k, v, out, lse, B, S, Sk, H, kv_heads,
                                causal, s)
                : launch<float, 64>(q, k, v, out, lse, B, S, Sk, H, kv_heads,
                                    causal, s);
    case 128:
      return tc ? launch_tc<128>(q, k, v, out, lse, B, S, Sk, H, kv_heads,
                                 causal, s)
                : launch<float, 128>(q, k, v, out, lse, B, S, Sk, H,
                                     kv_heads, causal, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers must be 16-byte aligned.
// Returns a cudaError_t (0 = launched).
extern "C" int kubeflow_flash_fwd(const void* q, const void* k, const void* v,
                                  void* out, void* lse, int batch, int seq_q,
                                  int seq_k, int heads, int kv_heads,
                                  int head_dim, int causal, int dtype,
                                  void* stream) {
  if (batch < 0 || seq_q < 0 || seq_k < 1 || heads < 1 || kv_heads < 1 ||
      heads % kv_heads != 0 || (causal && seq_q != seq_k))
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq_q == 0) return 0;
  if (dtype != 0 && dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  return dispatch_dim(head_dim, dtype, q, k, v, out, lse, batch, seq_q, seq_k,
                      heads, kv_heads, causal,
                      static_cast<cudaStream_t>(stream));
}
