// K4 and K5 — the tiled attention backward (causal or full), for Hopper
// (sm_90a).
//
// Replace the Pallas TPU kernels
//   kubeflow_tpu/compute/ops/flash_attention.py::_bwd_dq_kernel   (K4)
//   kubeflow_tpu/compute/ops/flash_attention.py::_bwd_dkv_kernel  (K5)
// (launched from _bwd under the custom_vjp, same file). Wrappers, plain
// PyTorch version and launch counters: ../flash_attention.py.
//
// What they compute, per batch row b and query head h (kv head h / n_rep):
//   p  = exp(qs k^T - lse)      recomputed from the forward's lse (K3)
//   dp = dO v^T,  ds = p (dp - delta), rounded ONCE to the input dtype
//   K4: dq = scale * sum over keys of ds k
//   K5: dv = sum over the group's heads and queries of p^T dO (p rounded)
//       dk = scale * sum over the group's heads and queries of ds^T q
// qs = q * scale in fp32 rounded once to the input dtype — the forward's
// rounding exactly, or exp(s - lse) would not renormalise; dk takes the
// RAW q (flash_attention.py:163-165). delta = rowsum(dO * O) in fp32 from
// the rounded O comes from the wrapper. Masked and ragged entries get an
// explicit p = 0, as the TPU kernel's NEG_INF scores give exp() = 0.
//
// GQA: K3 reads kv head h / n_rep without repeating K/V, so K5 sums the
// n_rep query heads of one kv head itself, in fp32 with one rounding and
// no atomics (each block owns its dK/dV rows): deterministic. The JAX
// package repeats K/V before its kernels and sums the rounded per-head
// dK/dV in repeat's VJP.
//
// Bound on this card (bf16, the train step's B 16, S 1024, 8 q / 2 kv
// heads, D 128, causal, S(S+1)/2 live pairs per (b, h)): operations. K4
// does 3 products (s, dp, dq) — 51.6 GFLOP, 0.052 ms at 989 TFLOP/s; its
// ~117 MB of bytes take 0.035 ms. K5 does 4 (s, dp, dv, dk) — 68.8 GFLOP,
// 0.070 ms.
//
// Two designs, chosen by dtype.
// fp32 (flash_bwd_dq_kernel, flash_bwd_dkv_kernel): every product on the
//   CUDA cores in fp32 (exact products, fp32 sums; the port runs with
//   TF32 off and the fp32 tolerance of 1e-4 needs them), tiles in shared
//   memory as fp32 rows padded by one word against bank conflicts. Bound
//   by the issue of shared-memory loads (two for every two FMAs).
//   K4: one block per (64-row query tile, b x h): K/V tiles of 32 keys
//   stream through shared memory up to the query tile's causal limit
//   (tiles past it are never loaded); each thread holds a 4 x 4 tile of
//   s and dp and a 4 x D/8 slice of the dq accumulator.
//   K5: one block per (64-row key tile, b x kv head). K/V stay in shared
//   memory while the block walks the n_rep heads of its group and, for
//   each, the 32-row query tiles from the one holding its first key to
//   the end (causal); dK and dV (4 x D/16 each per thread) accumulate in
//   registers across all of them and are rounded once.
// bf16: the FlashAttention-2 backward on the tensor cores (mma.sync
//   m16n8k16, bf16 operands, fp32 accumulators; mma.cuh), 4 warps a
//   block, tiles in bf16 shared memory with rows padded to D + 8 elements
//   (free of ldmatrix bank conflicts) and filled by cp.async.
//   K4 (flash_bwd_dq_tc_kernel) — K3's form: one block per (64-row query
//   tile, b x h), the query tiles with the longest causal walk first,
//   each warp owning 16 query rows. qs = round(q * scale) is made once in
//   shared memory and held in A fragments for the whole walk; K/V tiles
//   of 64 keys stream in double-buffered, one barrier a tile, tiles past
//   the causal limit never loaded. Per tile and warp: S = qs K^T and
//   dP = dO V^T (K and V as B through ldmatrix; dO's A fragments read
//   again from shared memory each tile, so that the dq accumulators (16
//   x D / 32 fp32 a thread), qs and the two 16 x 64 score tiles stay in
//   registers), P = exp(S - lse) with an explicit 0 where masked, dS =
//   round(P (dP - delta)) repacked from the accumulators into A
//   fragments, dq += dS K with K through ldmatrix.trans. dq is scaled and
//   rounded once; no atomics.
//   K5 (flash_bwd_dkv_tc_kernel) — the same backward computed transposed.
//   The same grid as the fp32 K5 — one block per (64-key tile, b x kv
//   head), the key tiles with the longest causal walk first — each warp
//   owning 16 keys. K and V stay in shared memory; the q and dO tiles of
//   the walk (32 rows at D 128, 64 below) and their lse/delta come in
//   double-buffered, and one pass over the q tile makes qs. Per tile and
//   warp: S^T = K qs^T, P^T = exp(S^T - lse) (0 where masked), dV +=
//   round(P^T) dO, dP^T = V dO^T, dS^T = round(P^T (dP^T - delta)), dK +=
//   dS^T q; P^T and dS^T go from the accumulators into A fragments, dO
//   and q enter the last two products through ldmatrix.trans. dK and dV
//   stay in fp32 registers across all heads and tiles (2 x 16 x D / 32 a
//   thread) and are rounded once.
//   Both are bound now by the issue rate of mma.sync and ldmatrix from
//   4-warp blocks (no wgmma, no TMA, no warp specialisation; every warp
//   reads each K/V or q/dO tile whole), and K5 at B = 1 by the fill: 32
//   blocks for 132 SMs.

#include <type_traits>

#include "common.cuh"
#include "mma.cuh"

namespace {

using namespace kubeflow;

constexpr int kRows = 4;   // score-tile rows per thread (both kernels)

// ------------------------------------------------------------------ K4

constexpr int kThreadsQ = 128;  // 16 row groups x 8 column groups
constexpr int kBqQ = 64;        // query rows per block
constexpr int kBkQ = 32;        // key rows per streamed tile
constexpr int kColsQ = kBkQ / 8;

template <int D>
constexpr size_t dq_smem_floats() {
  return 2 * static_cast<size_t>(kBqQ) * (D + 1) +   // qs, dO
         2 * static_cast<size_t>(kBkQ) * (D + 1) +   // K, V
         static_cast<size_t>(kBqQ) * (kBkQ + 1);     // ds
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsQ)
flash_bwd_dq_kernel(const T* __restrict__ q,      // [B, S, H, D], raw
                    const T* __restrict__ k,      // [B, Sk, kv_heads, D]
                    const T* __restrict__ v,      // [B, Sk, kv_heads, D]
                    const T* __restrict__ dout,   // [B, S, H, D]
                    const float* __restrict__ lse,    // [B, H, S]
                    const float* __restrict__ delta,  // [B, H, S]
                    T* __restrict__ dq,           // [B, S, H, D]
                    int S, int Sk, int H, int kv_heads, int causal,
                    float scale) {
  constexpr int kVec = vec_width<T>();
  constexpr int kRowUnits = D / kVec;   // 16-byte words a row

  extern __shared__ float smem[];
  float* q_s = smem;                    // [kBqQ][D + 1], pre-scaled
  float* do_s = q_s + kBqQ * (D + 1);   // [kBqQ][D + 1]
  float* k_s = do_s + kBqQ * (D + 1);   // [kBkQ][D + 1]
  float* v_s = k_s + kBkQ * (D + 1);    // [kBkQ][D + 1]
  float* ds_s = v_s + kBkQ * (D + 1);   // [kBqQ][kBkQ + 1]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / kv_heads);
  const int q0 = blockIdx.x * kBqQ;
  const int tid = threadIdx.x;
  const int ty = tid / 8;   // rows ty*4 .. ty*4+3 of the query tile
  const int tx = tid % 8;   // key columns tx + 8j, dq columns tx + 8j

  for (int u = tid; u < kBqQ * kRowUnits; u += kThreadsQ) {
    const int r = u / kRowUnits;
    const int c = (u % kRowUnits) * kVec;
    const int s = q0 + r;
    float x[kVec], g[kVec];
    if (s < S) {
      const size_t off = ((static_cast<size_t>(b) * S + s) * H + h) * D + c;
      unpack16<T>(load16(q + off), x);
      unpack16<T>(load16(dout + off), g);
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = round_to<T>(x[i] * scale);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = g[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      q_s[r * (D + 1) + c + i] = x[i];
      do_s[r * (D + 1) + c + i] = g[i];
    }
  }

  float lse_r[kRows], delta_r[kRows];
  const size_t stat = (static_cast<size_t>(b) * H + h) * S;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int qpos = q0 + ty * kRows + r;
    lse_r[r] = qpos < S ? lse[stat + qpos] : 0.f;
    delta_r[r] = qpos < S ? delta[stat + qpos] : 0.f;
  }

  float acc[kRows][D / 8];
#pragma unroll
  for (int r = 0; r < kRows; ++r)
#pragma unroll
    for (int j = 0; j < D / 8; ++j) acc[r][j] = 0.f;

  // causal: keys past the tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + kBqQ) : Sk;
  for (int k0 = 0; k0 < k_end; k0 += kBkQ) {
    __syncthreads();   // q/dO are stored; the last tile's readers are done
    for (int u = tid; u < kBkQ * kRowUnits; u += kThreadsQ) {
      const int c = u / kRowUnits;
      const int d = (u % kRowUnits) * kVec;
      const int s = k0 + c;
      float kx[kVec], vx[kVec];
      if (s < Sk) {
        const size_t off = ((static_cast<size_t>(b) * Sk + s) * kv_heads + kvh)
                           * D + d;
        unpack16<T>(load16(k + off), kx);
        unpack16<T>(load16(v + off), vx);
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) kx[i] = vx[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        k_s[c * (D + 1) + d + i] = kx[i];
        v_s[c * (D + 1) + d + i] = vx[i];
      }
    }
    __syncthreads();

    float sc[kRows][kColsQ], dp[kRows][kColsQ];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int j = 0; j < kColsQ; ++j) sc[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qa[kRows], ga[kRows], ka[kColsQ], va[kColsQ];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        qa[r] = q_s[(ty * kRows + r) * (D + 1) + d];
        ga[r] = do_s[(ty * kRows + r) * (D + 1) + d];
      }
#pragma unroll
      for (int j = 0; j < kColsQ; ++j) {
        ka[j] = k_s[(tx + 8 * j) * (D + 1) + d];
        va[j] = v_s[(tx + 8 * j) * (D + 1) + d];
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < kColsQ; ++j) {
          sc[r][j] += qa[r] * ka[j];
          dp[r][j] += ga[r] * va[j];
        }
    }

#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int qpos = q0 + ty * kRows + r;
#pragma unroll
      for (int j = 0; j < kColsQ; ++j) {
        const int kpos = k0 + tx + 8 * j;
        const bool valid = qpos < S && kpos < Sk && (!causal || kpos <= qpos);
        const float p = valid ? expf(sc[r][j] - lse_r[r]) : 0.f;
        ds_s[(ty * kRows + r) * (kBkQ + 1) + tx + 8 * j] =
            round_to<T>(p * (dp[r][j] - delta_r[r]));
      }
    }
    __syncthreads();

    const int n_c = min(kBkQ, k_end - k0);
    for (int c = 0; c < n_c; ++c) {
      float ka[D / 8];
#pragma unroll
      for (int j = 0; j < D / 8; ++j) ka[j] = k_s[c * (D + 1) + tx + 8 * j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float dsv = ds_s[(ty * kRows + r) * (kBkQ + 1) + c];
#pragma unroll
        for (int j = 0; j < D / 8; ++j) acc[r][j] += dsv * ka[j];
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
        dq[base + tx + 8 * j] = from_f32<T>(scale * acc[r][j]);
    }
  }
}

// ------------------------------------------------------------------ K5

constexpr int kThreadsKV = 256;  // 8 warps
constexpr int kBkKV = 64;        // key rows per block
constexpr int kBqKV = 32;        // query rows per walked tile

template <int D>
constexpr size_t dkv_smem_floats() {
  return 2 * static_cast<size_t>(kBkKV) * (D + 1) +     // K, V
         3 * static_cast<size_t>(kBqKV) * (D + 1) +     // qs, q, dO
         2 * static_cast<size_t>(kBqKV) * (kBkKV + 1) + // p, ds
         2 * kBqKV;                                     // lse, delta
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreadsKV)
flash_bwd_dkv_kernel(const T* __restrict__ q,      // [B, S, H, D], raw
                     const T* __restrict__ k,      // [B, Sk, kv_heads, D]
                     const T* __restrict__ v,      // [B, Sk, kv_heads, D]
                     const T* __restrict__ dout,   // [B, S, H, D]
                     const float* __restrict__ lse,    // [B, H, S]
                     const float* __restrict__ delta,  // [B, H, S]
                     T* __restrict__ dk,           // [B, Sk, kv_heads, D]
                     T* __restrict__ dv,           // [B, Sk, kv_heads, D]
                     int S, int Sk, int H, int kv_heads, int causal,
                     float scale) {
  constexpr int kVec = vec_width<T>();
  constexpr int kRowUnits = D / kVec;
  constexpr int kDc = D / 16;   // dK/dV columns per thread

  extern __shared__ float smem[];
  float* k_s = smem;                        // [kBkKV][D + 1]
  float* v_s = k_s + kBkKV * (D + 1);       // [kBkKV][D + 1]
  float* qs_s = v_s + kBkKV * (D + 1);      // [kBqKV][D + 1], pre-scaled
  float* q_s = qs_s + kBqKV * (D + 1);      // [kBqKV][D + 1], raw
  float* do_s = q_s + kBqKV * (D + 1);      // [kBqKV][D + 1]
  float* p_s = do_s + kBqKV * (D + 1);      // [kBqKV][kBkKV + 1], rounded
  float* ds_s = p_s + kBqKV * (kBkKV + 1);  // [kBqKV][kBkKV + 1], rounded
  float* lse_s = ds_s + kBqKV * (kBkKV + 1);
  float* delta_s = lse_s + kBqKV;

  const int bk = blockIdx.y;
  const int b = bk / kv_heads;
  const int kvh = bk % kv_heads;
  const int n_rep = H / kv_heads;
  const int k0 = blockIdx.x * kBkKV;
  const int tid = threadIdx.x;
  // score tile [kBqKV x kBkKV]: warp sr owns query rows sr*4 .. sr*4+3,
  // lane sl key columns sl and sl + 32
  const int sr = tid / 32;
  const int sl = tid % 32;
  // dK/dV tile [kBkKV x D]: key rows ar*4 .. ar*4+3, columns ac + 16j
  const int ar = tid / 16;
  const int ac = tid % 16;

  for (int u = tid; u < kBkKV * kRowUnits; u += kThreadsKV) {
    const int r = u / kRowUnits;
    const int c = (u % kRowUnits) * kVec;
    const int s = k0 + r;
    float kx[kVec], vx[kVec];
    if (s < Sk) {
      const size_t off = ((static_cast<size_t>(b) * Sk + s) * kv_heads + kvh)
                         * D + c;
      unpack16<T>(load16(k + off), kx);
      unpack16<T>(load16(v + off), vx);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) kx[i] = vx[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      k_s[r * (D + 1) + c + i] = kx[i];
      v_s[r * (D + 1) + c + i] = vx[i];
    }
  }

  float dk_acc[kRows][kDc], dv_acc[kRows][kDc];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kDc; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;

  // causal: query tiles wholly before the first key are masked
  const int q_begin = causal ? (k0 / kBqKV) * kBqKV : 0;
  for (int hh = 0; hh < n_rep; ++hh) {
    const int h = kvh * n_rep + hh;
    const size_t stat = (static_cast<size_t>(b) * H + h) * S;
    for (int q0 = q_begin; q0 < S; q0 += kBqKV) {
      __syncthreads();   // K/V are stored; the last tile's readers are done
      for (int u = tid; u < kBqKV * kRowUnits; u += kThreadsKV) {
        const int r = u / kRowUnits;
        const int c = (u % kRowUnits) * kVec;
        const int s = q0 + r;
        float x[kVec], g[kVec];
        if (s < S) {
          const size_t off = ((static_cast<size_t>(b) * S + s) * H + h) * D
                             + c;
          unpack16<T>(load16(q + off), x);
          unpack16<T>(load16(dout + off), g);
        } else {
#pragma unroll
          for (int i = 0; i < kVec; ++i) x[i] = g[i] = 0.f;
        }
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          q_s[r * (D + 1) + c + i] = x[i];
          qs_s[r * (D + 1) + c + i] = round_to<T>(x[i] * scale);
          do_s[r * (D + 1) + c + i] = g[i];
        }
      }
      if (tid < kBqKV) {
        const int s = q0 + tid;
        lse_s[tid] = s < S ? lse[stat + s] : 0.f;
        delta_s[tid] = s < S ? delta[stat + s] : 0.f;
      }
      __syncthreads();

      float st[kRows][2], dp[kRows][2];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int j = 0; j < 2; ++j) st[r][j] = dp[r][j] = 0.f;
#pragma unroll 4
      for (int d = 0; d < D; ++d) {
        float qa[kRows], ga[kRows], ka[2], va[2];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          qa[r] = qs_s[(sr * kRows + r) * (D + 1) + d];
          ga[r] = do_s[(sr * kRows + r) * (D + 1) + d];
        }
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          ka[j] = k_s[(sl + 32 * j) * (D + 1) + d];
          va[j] = v_s[(sl + 32 * j) * (D + 1) + d];
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r)
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            st[r][j] += qa[r] * ka[j];
            dp[r][j] += ga[r] * va[j];
          }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int row = sr * kRows + r;
        const int qpos = q0 + row;
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int col = sl + 32 * j;
          const int kpos = k0 + col;
          const bool valid =
              qpos < S && kpos < Sk && (!causal || kpos <= qpos);
          const float p = valid ? expf(st[r][j] - lse_s[row]) : 0.f;
          p_s[row * (kBkKV + 1) + col] = round_to<T>(p);
          ds_s[row * (kBkKV + 1) + col] =
              round_to<T>(p * (dp[r][j] - delta_s[row]));
        }
      }
      __syncthreads();

      const int n_r = min(kBqKV, S - q0);
      for (int r = 0; r < n_r; ++r) {
        float pa[kRows], sa[kRows], ga[kDc], qa[kDc];
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          pa[i] = p_s[r * (kBkKV + 1) + ar * kRows + i];
          sa[i] = ds_s[r * (kBkKV + 1) + ar * kRows + i];
        }
#pragma unroll
        for (int j = 0; j < kDc; ++j) {
          ga[j] = do_s[r * (D + 1) + ac + 16 * j];
          qa[j] = q_s[r * (D + 1) + ac + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < kRows; ++i)
#pragma unroll
          for (int j = 0; j < kDc; ++j) {
            dv_acc[i][j] += pa[i] * ga[j];
            dk_acc[i][j] += sa[i] * qa[j];
          }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kpos = k0 + ar * kRows + i;
    if (kpos < Sk) {
      const size_t base = ((static_cast<size_t>(b) * Sk + kpos) * kv_heads
                           + kvh) * D;
#pragma unroll
      for (int j = 0; j < kDc; ++j) {
        dk[base + ac + 16 * j] = from_f32<T>(scale * dk_acc[i][j]);
        dv[base + ac + 16 * j] = from_f32<T>(dv_acc[i][j]);
      }
    }
  }
}

// ------------------------------------------------ K5, bf16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;   // 4 warps x 16 keys
constexpr int kTcBk = 64;         // keys per block
constexpr float kLog2e = 1.4426950408889634f;

// query rows per walked tile: 32 at D 128 keeps the dK/dV accumulators
// (2 x 16 x D / 32 fp32 a thread) and the two 16 x Bq score tiles in
// registers; 64 where D is smaller
template <int D>
__host__ __device__ constexpr int tc_bq() { return D == 128 ? 32 : 64; }

template <int D>
__host__ __device__ constexpr int tc_stride() {   // bf16 elements a row
  return D + 8;
}

template <int D>
constexpr size_t dkv_tc_smem_bytes() {
  // K, V; q and dO in 2 stages; qs; lse and delta in 2 stages
  return static_cast<size_t>(2 * kTcBk + 5 * tc_bq<D>()) * tc_stride<D>() *
             sizeof(bf16) +
         4 * static_cast<size_t>(tc_bq<D>()) * sizeof(float);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q,      // [B, S, H, D], raw
                        const bf16* __restrict__ k,      // [B, Sk, kv_heads, D]
                        const bf16* __restrict__ v,      // [B, Sk, kv_heads, D]
                        const bf16* __restrict__ dout,   // [B, S, H, D]
                        const float* __restrict__ lse,    // [B, H, S]
                        const float* __restrict__ delta,  // [B, H, S]
                        bf16* __restrict__ dk,           // [B, Sk, kv_heads, D]
                        bf16* __restrict__ dv,           // [B, Sk, kv_heads, D]
                        int B, int S, int Sk, int H, int kv_heads,
                        int causal, float scale) {
  constexpr int kBq = tc_bq<D>();
  constexpr int kStride = tc_stride<D>();
  constexpr int kChunks = D / 8;    // 16-byte chunks a row
  constexpr int kKs = D / 16;       // k-slices of K.qs^T and V.dO^T
  constexpr int kNb = kBq / 8;      // n-blocks of S^T and dP^T
  constexpr int kDb = D / 8;        // n-blocks of dK and dV

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);   // [kTcBk][kStride]
  bf16* v_s = k_s + kTcBk * kStride;               // [kTcBk][kStride]
  bf16* q_s = v_s + kTcBk * kStride;               // [2][kBq][kStride], raw
  bf16* do_s = q_s + 2 * kBq * kStride;            // [2][kBq][kStride]
  bf16* qs_s = do_s + 2 * kBq * kStride;           // [kBq][kStride], scaled
  float* lse_s = reinterpret_cast<float*>(qs_s + kBq * kStride);  // [2][kBq]
  float* delta_s = lse_s + 2 * kBq;                               // [2][kBq]

  // the key tiles with the most query tiles (causal: the first) first
  const int BK = B * kv_heads;
  const int k0 = static_cast<int>(blockIdx.x) / BK * kTcBk;
  const int bk = static_cast<int>(blockIdx.x) % BK;
  const int b = bk / kv_heads;
  const int kvh = bk % kv_heads;
  const int n_rep = H / kv_heads;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator rows (keys) g and g + 8
  const int t = lane % 4;   // accumulator columns 2t, 2t + 1

  for (int c = tid; c < kTcBk * kChunks; c += kTcThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int s = k0 + r;
    const size_t off =
        ((static_cast<size_t>(b) * Sk + min(s, Sk - 1)) * kv_heads + kvh) * D +
        col;
    cp_async16(smem_u32(k_s + r * kStride + col), k + off, s < Sk);
    cp_async16(smem_u32(v_s + r * kStride + col), v + off, s < Sk);
  }

  // the walk: the group's n_rep heads, each over its query tiles from
  // the one holding the block's first key (causal) to the end
  const int q_begin = causal ? k0 / kBq * kBq : 0;
  const int n_qt = (S - q_begin + kBq - 1) / kBq;
  const int n_steps = n_rep * n_qt;
  auto load_q = [&](int step, int stage) {
    const int h = kvh * n_rep + step / n_qt;
    const int q0 = q_begin + step % n_qt * kBq;
    bf16* qd = q_s + stage * kBq * kStride;
    bf16* gd = do_s + stage * kBq * kStride;
    for (int c = tid; c < kBq * kChunks; c += kTcThreads) {
      const int r = c / kChunks;
      const int col = (c % kChunks) * 8;
      const int s = q0 + r;
      const size_t off =
          ((static_cast<size_t>(b) * S + min(s, S - 1)) * H + h) * D + col;
      cp_async16(smem_u32(qd + r * kStride + col), q + off, s < S);
      cp_async16(smem_u32(gd + r * kStride + col), dout + off, s < S);
    }
    if (tid < kBq) {
      const int s = q0 + tid;
      const size_t off = (static_cast<size_t>(b) * H + h) * S + min(s, S - 1);
      cp_async4(smem_u32(lse_s + stage * kBq + tid), lse + off, s < S);
      cp_async4(smem_u32(delta_s + stage * kBq + tid), delta + off, s < S);
    }
  };
  load_q(0, 0);        // S >= 1 (the entry returns at S == 0): a step
  cp_async_commit();   // group 0: K, V and the first q / dO tile

  // ldmatrix row addresses of this lane (see mma.cuh): A from K/V rows;
  // B (non-transposed) from qs / dO rows; B (transposed) from dO / q rows
  const int a_off = (warp * 16 + lane % 16) * kStride + (lane / 16) * 8;
  const int nb_off = ((lane % 8) + (lane / 16) * 8) * kStride +
                     ((lane / 8) % 2) * 8;
  const int tb_off = ((lane % 8) + ((lane / 8) % 2) * 8) * kStride +
                     (lane / 16) * 8;
  const int key0 = k0 + warp * 16 + g;   // this lane's keys: key0, key0 + 8

  float dk_acc[kDb][4], dv_acc[kDb][4];
#pragma unroll
  for (int j = 0; j < kDb; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) dk_acc[j][i] = dv_acc[j][i] = 0.f;

  for (int step = 0; step < n_steps; ++step) {
    const int stage = step % 2;
    const int q0 = q_begin + step % n_qt * kBq;
    // tile `step` has landed for every thread, and every warp is done
    // with step - 1: its q/dO buffer and qs may be rewritten
    cp_async_wait<0>();
    __syncthreads();
    if (step + 1 < n_steps) {
      load_q(step + 1, stage ^ 1);
      cp_async_commit();
    }
    const bf16* qst = q_s + stage * kBq * kStride;
    const bf16* dost = do_s + stage * kBq * kStride;
    const float* lse_t = lse_s + stage * kBq;
    const float* delta_t = delta_s + stage * kBq;

    // qs = q * scale in fp32, rounded once to bf16: the forward's q
    for (int c = tid; c < kBq * kChunks; c += kTcThreads) {
      const int off = c / kChunks * kStride + (c % kChunks) * 8;
      uint4 w = *reinterpret_cast<const uint4*>(qst + off);
      __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(x[i]);
        x[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(qs_s + off) = w;
    }
    __syncthreads();

    // S^T = K qs^T and dP^T = V dO^T: 16 keys x kBq queries a warp
    float st[kNb][4], dpt[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) st[j][i] = dpt[j][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      uint32_t ka[4], va[4];
      ldmatrix_x4(ka, smem_u32(k_s + a_off + ks * 16));
      ldmatrix_x4(va, smem_u32(v_s + a_off + ks * 16));
#pragma unroll
      for (int nb = 0; nb < kNb / 2; ++nb) {
        uint32_t qb[4], gb[4];
        ldmatrix_x4(qb, smem_u32(qs_s + nb * 16 * kStride + nb_off + ks * 16));
        ldmatrix_x4(gb, smem_u32(dost + nb * 16 * kStride + nb_off + ks * 16));
        mma_bf16(st[2 * nb], ka, qb[0], qb[1]);
        mma_bf16(st[2 * nb + 1], ka, qb[2], qb[3]);
        mma_bf16(dpt[2 * nb], va, gb[0], gb[1]);
        mma_bf16(dpt[2 * nb + 1], va, gb[2], gb[3]);
      }
    }

    // P^T = exp(S^T - lse), 0 where masked; dS^T = P^T (dP^T - delta)
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j * 8 + 2 * t + e;
        const int qpos = q0 + col;
        const float lse_q = lse_t[col];
        const float delta_q = delta_t[col];
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half * 2 + e;
          const int kpos = key0 + half * 8;
          const bool valid =
              qpos < S && kpos < Sk && (!causal || kpos <= qpos);
          const float p =
              valid ? exp2f((st[j][i] - lse_q) * kLog2e) : 0.f;
          dpt[j][i] = p * (dpt[j][i] - delta_q);
          st[j][i] = p;
        }
      }

    // dV += round(P^T) dO and dK += round(dS^T) q, the A fragments
    // straight from the accumulators
#pragma unroll
    for (int kk = 0; kk < kNb / 2; ++kk) {
      uint32_t pa[4], sa[4];
      pack_a(pa, st[2 * kk], st[2 * kk + 1]);
      pack_a(sa, dpt[2 * kk], dpt[2 * kk + 1]);
#pragma unroll
      for (int db = 0; db < kDb / 2; ++db) {
        uint32_t gb[4], qb[4];
        const int off = kk * 16 * kStride + tb_off + db * 16;
        ldmatrix_x4_trans(gb, smem_u32(dost + off));
        ldmatrix_x4_trans(qb, smem_u32(qst + off));
        mma_bf16(dv_acc[2 * db], pa, gb[0], gb[1]);
        mma_bf16(dv_acc[2 * db + 1], pa, gb[2], gb[3]);
        mma_bf16(dk_acc[2 * db], sa, qb[0], qb[1]);
        mma_bf16(dk_acc[2 * db + 1], sa, qb[2], qb[3]);
      }
    }
  }

  // one rounding each, deterministic: this block owns these rows
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int kpos = key0 + half * 8;
    if (kpos >= Sk) continue;
    const size_t base =
        ((static_cast<size_t>(b) * Sk + kpos) * kv_heads + kvh) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDb; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + base + j * 8) =
          __floats2bfloat162_rn(scale * dk_acc[j][2 * half],
                                scale * dk_acc[j][2 * half + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dv + base + j * 8) =
          __floats2bfloat162_rn(dv_acc[j][2 * half], dv_acc[j][2 * half + 1]);
    }
  }
}

// ------------------------------------------------ K4, bf16, tensor cores

constexpr int kDqBq = 64;   // query rows per block: 4 warps x 16
constexpr int kDqBk = 64;   // keys per streamed tile

template <int D>
constexpr size_t dq_tc_smem_bytes() {   // qs, dO, 2 stages of K and of V
  return static_cast<size_t>(2 * kDqBq + 4 * kDqBk) * tc_stride<D>() *
         sizeof(bf16);
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q,      // [B, S, H, D], raw
                       const bf16* __restrict__ k,      // [B, Sk, kv_heads, D]
                       const bf16* __restrict__ v,      // [B, Sk, kv_heads, D]
                       const bf16* __restrict__ dout,   // [B, S, H, D]
                       const float* __restrict__ lse,    // [B, H, S]
                       const float* __restrict__ delta,  // [B, H, S]
                       bf16* __restrict__ dq,           // [B, S, H, D]
                       int B, int S, int Sk, int H, int kv_heads, int causal,
                       float scale) {
  constexpr int kStride = tc_stride<D>();
  constexpr int kChunks = D / 8;    // 16-byte chunks a row
  constexpr int kKs = D / 16;       // k-slices of qs.K^T and dO.V^T
  constexpr int kNb = kDqBk / 8;    // n-blocks of S and dP (8 keys each)
  constexpr int kDb = D / 8;        // n-blocks of dq

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [kDqBq][kStride]
  bf16* do_s = q_s + kDqBq * kStride;              // [kDqBq][kStride]
  bf16* k_s = do_s + kDqBq * kStride;              // [2][kDqBk][kStride]
  bf16* v_s = k_s + 2 * kDqBk * kStride;           // [2][kDqBk][kStride]

  // the query tiles with the most key tiles (causal: the last) first
  const int BH = B * H;
  const int n_qt = (S + kDqBq - 1) / kDqBq;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.x) / BH) * kDqBq;
  const int bh = static_cast<int>(blockIdx.x) % BH;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = h / (H / kv_heads);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8
  const int t = lane % 4;   // accumulator columns 2t, 2t + 1

  for (int c = tid; c < kDqBq * kChunks; c += kTcThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int s = q0 + r;
    const size_t off =
        ((static_cast<size_t>(b) * S + min(s, S - 1)) * H + h) * D + col;
    cp_async16(smem_u32(q_s + r * kStride + col), q + off, s < S);
    cp_async16(smem_u32(do_s + r * kStride + col), dout + off, s < S);
  }
  // this thread's 16-byte chunks of a K/V tile, as K3's
  constexpr int kRowStep = kTcThreads / kChunks;
  constexpr int kLoads = kDqBk / kRowStep;
  const int r0 = tid / kChunks;
  const int col0 = (tid % kChunks) * 8;
  const size_t kv_row = static_cast<size_t>(kv_heads) * D;   // between keys
  const size_t kv_base =
      (static_cast<size_t>(b) * Sk * kv_heads + kvh) * D + col0;
  const uint32_t k_dst = smem_u32(k_s + r0 * kStride + col0);
  const uint32_t v_dst = smem_u32(v_s + r0 * kStride + col0);
  auto load_kv = [&](int k0, int stage) {
    const uint32_t dst0 = stage * kDqBk * kStride * sizeof(bf16);
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
  cp_async_commit();   // group 0: the q and dO tiles and the first K/V tile

  // causal: keys past the tile's last row are masked for every row
  const int k_end = causal ? min(Sk, q0 + kDqBq) : Sk;
  const int n_kt = (k_end + kDqBk - 1) / kDqBk;
  const int row0 = q0 + warp * 16 + g;   // this lane's rows: row0, row0 + 8
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    const size_t off = (static_cast<size_t>(b) * H + h) * S + min(qpos, S - 1);
    lse_r[r] = qpos < S ? lse[off] * kLog2e : 0.f;
    delta_r[r] = qpos < S ? delta[off] : 0.f;
  }

  // ldmatrix row addresses of this lane (see mma.cuh): A from qs / dO
  // rows, B (non-transposed) from K / V rows, B (transposed) from K rows
  const int a_off = (warp * 16 + lane % 16) * kStride + (lane / 16) * 8;
  const int nb_off = ((lane % 8) + (lane / 16) * 8) * kStride +
                     ((lane / 8) % 2) * 8;
  const int tb_off = ((lane % 8) + ((lane / 8) % 2) * 8) * kStride +
                     (lane / 16) * 8;

  uint32_t qf[kKs][4];
  float acc[kDb][4];
#pragma unroll
  for (int j = 0; j < kDb; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int stage = kt % 2;
    // one barrier a tile: tile kt has landed for every thread, and every
    // warp is done with tile kt - 1, whose buffer the next load reuses
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < n_kt) {
      load_kv((kt + 1) * kDqBk, stage ^ 1);
      cp_async_commit();
    }
    if (kt == 0) {
      // qs = q * scale in fp32, rounded once to bf16 (the forward's q),
      // in place: each warp its own 16 rows, then into A fragments
      for (int c = lane; c < 16 * kChunks; c += 32) {
        const int off = (warp * 16 + c / kChunks) * kStride + (c % kChunks) * 8;
        uint4 w = *reinterpret_cast<const uint4*>(q_s + off);
        __nv_bfloat162* x = reinterpret_cast<__nv_bfloat162*>(&w);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float2 f = __bfloat1622float2(x[i]);
          x[i] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
        }
        *reinterpret_cast<uint4*>(q_s + off) = w;
      }
      __syncwarp();
#pragma unroll
      for (int ks = 0; ks < kKs; ++ks)
        ldmatrix_x4(qf[ks], smem_u32(q_s + a_off + ks * 16));
    }
    const bf16* kst = k_s + stage * kDqBk * kStride;
    const bf16* vst = v_s + stage * kDqBk * kStride;

    // S = qs K^T and dP = dO V^T: 16 queries x kDqBk keys a warp; dO's A
    // fragments are read again each tile (registers go to dq and S/dP)
    float sc[kNb][4], dp[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = dp[j][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      uint32_t ga[4];
      ldmatrix_x4(ga, smem_u32(do_s + a_off + ks * 16));
#pragma unroll
      for (int nb = 0; nb < kNb / 2; ++nb) {
        uint32_t kb[4], vb[4];
        const int off = nb * 16 * kStride + nb_off + ks * 16;
        ldmatrix_x4(kb, smem_u32(kst + off));
        ldmatrix_x4(vb, smem_u32(vst + off));
        mma_bf16(sc[2 * nb], qf[ks], kb[0], kb[1]);
        mma_bf16(sc[2 * nb + 1], qf[ks], kb[2], kb[3]);
        mma_bf16(dp[2 * nb], ga, vb[0], vb[1]);
        mma_bf16(dp[2 * nb + 1], ga, vb[2], vb[3]);
      }
    }

    // P = exp(S - lse), an explicit 0 where masked (only the diagonal
    // tile and a ragged last one have masked entries); dS = P (dP - delta)
    const int k0 = kt * kDqBk;
    const bool masked = k0 + kDqBk > Sk || (causal && k0 + kDqBk - 1 > q0);
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + j * 8 + 2 * t + (i % 2);
        const int qpos = row0 + (i / 2) * 8;
        const bool valid =
            !masked || (kpos < Sk && (!causal || kpos <= qpos));
        const float p =
            valid ? exp2f(fmaf(sc[j][i], kLog2e, -lse_r[i / 2])) : 0.f;
        dp[j][i] = p * (dp[j][i] - delta_r[i / 2]);
      }

    // dq += round(dS) K: dS straight from the accumulators, K through
    // ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kDqBk / 16; ++kk) {
      uint32_t sa[4];
      pack_a(sa, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int db = 0; db < kDb / 2; ++db) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, smem_u32(kst + kk * 16 * kStride + tb_off +
                                       db * 16));
        mma_bf16(acc[2 * db], sa, kb[0], kb[1]);
        mma_bf16(acc[2 * db + 1], sa, kb[2], kb[3]);
      }
    }
  }

  // one rounding, no atomics: this block owns these rows
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= S) continue;
    bf16* dst = dq + ((static_cast<size_t>(b) * S + qpos) * H + h) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < kDb; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
          __floats2bfloat162_rn(scale * acc[j][2 * r], scale * acc[j][2 * r + 1]);
  }
}

// ------------------------------------------------------------ launches

struct Args {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const void* lse;
  const void* delta;
  void* out0;   // dq (K4) or dk (K5)
  void* out1;   // dv (K5)
  int B, S, Sk, H, kv_heads, causal;
  float scale;
  cudaStream_t stream;
};

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem, bool* done) {
  if (*done) return 0;   // once per instantiation
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  *done = true;
  return 0;
}

template <typename T, int D>
int launch_dq(const Args& a) {
  const size_t smem = dq_smem_floats<D>() * sizeof(float);
  static bool attribute_set = false;
  if (int err = set_smem(flash_bwd_dq_kernel<T, D>, smem, &attribute_set))
    return err;
  const dim3 grid((a.S + kBqQ - 1) / kBqQ, a.B * a.H);
  flash_bwd_dq_kernel<T, D><<<grid, kThreadsQ, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), a.S, a.Sk, a.H, a.kv_heads, a.causal,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_dkv(const Args& a) {
  const size_t smem = dkv_smem_floats<D>() * sizeof(float);
  static bool attribute_set = false;
  if (int err = set_smem(flash_bwd_dkv_kernel<T, D>, smem, &attribute_set))
    return err;
  const dim3 grid((a.Sk + kBkKV - 1) / kBkKV, a.B * a.kv_heads);
  flash_bwd_dkv_kernel<T, D><<<grid, kThreadsKV, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.out0), static_cast<T*>(a.out1), a.S, a.Sk, a.H,
      a.kv_heads, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv_tc(const Args& a) {
  const size_t smem = dkv_tc_smem_bytes<D>();
  static bool attribute_set = false;
  if (int err = set_smem(flash_bwd_dkv_tc_kernel<D>, smem, &attribute_set))
    return err;
  const int blocks = (a.Sk + kTcBk - 1) / kTcBk * a.B * a.kv_heads;
  flash_bwd_dkv_tc_kernel<D><<<blocks, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), static_cast<bf16*>(a.out1), a.B, a.S, a.Sk,
      a.H, a.kv_heads, a.causal, a.scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq_tc(const Args& a) {
  const size_t smem = dq_tc_smem_bytes<D>();
  static bool attribute_set = false;
  if (int err = set_smem(flash_bwd_dq_tc_kernel<D>, smem, &attribute_set))
    return err;
  const int blocks = (a.S + kDqBq - 1) / kDqBq * a.B * a.H;
  flash_bwd_dq_tc_kernel<D><<<blocks, kTcThreads, smem, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<bf16*>(a.out0), a.B, a.S, a.Sk, a.H, a.kv_heads, a.causal,
      a.scale);
  return static_cast<int>(cudaGetLastError());
}

// K4 and K5: fp32 on the CUDA cores, bf16 on the tensor cores
template <typename T, int D>
int launch_k4(const Args& a) {
  if constexpr (std::is_same_v<T, float>) {
    return launch_dq<float, D>(a);
  } else {
    return launch_dq_tc<D>(a);
  }
}

template <typename T, int D>
int launch_k5(const Args& a) {
  if constexpr (std::is_same_v<T, float>) {
    return launch_dkv<float, D>(a);
  } else {
    return launch_dkv_tc<D>(a);
  }
}

template <bool kDq, typename T>
int dispatch_dim(int head_dim, const Args& a) {
  switch (head_dim) {
    case 32:
      return kDq ? launch_k4<T, 32>(a) : launch_k5<T, 32>(a);
    case 64:
      return kDq ? launch_k4<T, 64>(a) : launch_k5<T, 64>(a);
    case 128:
      return kDq ? launch_k4<T, 128>(a) : launch_k5<T, 128>(a);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kDq>
int run(const Args& a, int head_dim, int dtype) {
  if (a.B < 0 || a.S < 0 || a.Sk < 1 || a.H < 1 || a.kv_heads < 1 ||
      a.H % a.kv_heads != 0 || (a.causal && a.S != a.Sk))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B == 0 || a.S == 0) return 0;
  if (dtype == 0) return dispatch_dim<kDq, float>(head_dim, a);
  if (dtype == 1) return dispatch_dim<kDq, __nv_bfloat16>(head_dim, a);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q/dout/dq are [B, S, H, D]; k/v/dk/dv
// [B, Sk, kv_heads, D]; lse/delta fp32 [B, H, S]. Pointers must be 16-byte
// aligned. Each returns a cudaError_t (0 = launched). With S == 0, K5
// launches nothing and leaves dk/dv as they are: the caller zeroes them.
extern "C" int kubeflow_flash_bwd_dq(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dq, int batch, int seq_q,
                                     int seq_k, int heads, int kv_heads,
                                     int head_dim, int causal, int dtype,
                                     float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dq, nullptr, batch, seq_q, seq_k,
               heads, kv_heads, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return run<true>(a, head_dim, dtype);
}

extern "C" int kubeflow_flash_bwd_dkv(const void* q, const void* k,
                                      const void* v, const void* dout,
                                      const void* lse, const void* delta,
                                      void* dk, void* dv, int batch,
                                      int seq_q, int seq_k, int heads,
                                      int kv_heads, int head_dim, int causal,
                                      int dtype, float scale, void* stream) {
  const Args a{q, k, v, dout, lse, delta, dk, dv, batch, seq_q, seq_k,
               heads, kv_heads, causal, scale,
               static_cast<cudaStream_t>(stream)};
  return run<false>(a, head_dim, dtype);
}
