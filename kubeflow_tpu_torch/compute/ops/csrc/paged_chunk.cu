// K2 — chunk-after-prefix read over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   kubeflow_tpu/compute/ops/paged_attention.py::_chunk_kernel
// (called through paged_chunk_attention, same file), both its float
// pages and its int8_pages branch (:236-240): kubeflow_paged_chunk takes
// pages in q's dtype, kubeflow_paged_chunk_i8 (K2-i8) int8 pages with one
// fp32 scale per (position, kv head). Wrapper, plain PyTorch version and
// launch counters: ../paged_attention.py.
//
// What it computes: for every batch row b, chunk position s and query
// head h (kv head h / n_rep), over the key sequence
//   [ prefix positions 0 .. plen[b]-1 through the block table ]
//   ++ [ the chunk's own keys 0 .. s (causal within the chunk) ]
//   out[b, s, h] = softmax(q . K^T) V
// The prefix K/V lives in the pool (position p of row b at page
// tables[b, p / bs], row p % bs); the chunk's K/V come in as their own
// tensors. q arrives pre-scaled (softmax scale folded in fp32 and
// rounded once by the wrapper). Scores, m, l and the accumulator are
// fp32; p stays fp32 in the p.V product, which widens V to fp32 (the
// TPU kernel's `v.astype(float32)`, unlike the flash forward, which
// rounds p). Masked keys carry -1e30 and an explicit zero p, so a fold
// that is masked for a row adds no mass; a row that saw no key divides
// by 1. A zero prefix reads no page, whatever the table holds.
//
// Bound on this card, at the serving path's shapes: bytes for the verify
// (8 slots x 5 rows: ~40 FLOPs per K/V byte) and for short chunks;
// operations for a 256-row chunk behind a long prefix (~1000 rows x n_rep
// per K/V byte read once). The least time is the larger of the two.
//
// Two designs, chosen by dtype:
// bf16 (paged_chunk_tc_kernel, both page types) — the products on the
//   tensor cores (mma.sync m16n8k16 through mma.cuh, as K3), the key walk
//   split over blocks (flash-decoding) so that the grid fills the card:
//   - rows: the TPU kernel keeps all S * n_rep query rows of one (slot,
//     kv head) in VMEM and walks the pages as a sequential grid axis;
//     here the rows (position-major, the n_rep heads of one GQA group
//     adjacent) split into tiles of 64, 4 warps of 16 rows each; a warp
//     whose rows are all past the chunk skips its products;
//   - keys: one virtual key sequence, the prefix positions through the
//     table, then the chunk's columns only up to the tile's last position
//     (the causal mask hides the rest), streamed in tiles of 64 keys
//     gathered row by row with 16-byte cp.async (any block size), double
//     buffered in bf16 shared memory whose rows are padded to D + 8
//     elements (ldmatrix is then free of bank conflicts);
//   - the split: the grid is (split x row tile, kv head, slot); split i of
//     a row tile takes its key tiles [i n / splits, (i + 1) n / splits)
//     and, when there is more than one, writes its partial (m, l, acc) in
//     fp32 to a workspace (a split with no key writes m = -1e30, l = 0,
//     acc = 0); paged_chunk_combine_kernel then merges the partials in
//     split order (deterministic), each scaled by exp(m_i - m_max), divides
//     once and rounds once to bf16 (split_combine.cuh, shared with K1).
//     The wrapper picks the split count from the shapes
//     (../paged_attention.py, chunk_splits); one split writes the output
//     directly;
//   - numerics: S = q K^T from bf16 operands with fp32 sums (the TPU
//     kernel's preferred_element_type=float32); p stays fp32 in p.V as
//     the TPU kernel's `p @ v.astype(float32)`: p is split into
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi) and both products go into
//     the same fp32 accumulator (V in bf16 is exact), so p.V holds to
//     about 2^-17 relative; l sums the fp32 p;
//   - int8 pages: a prefix key's 16 codes come in one 16-byte load into
//     registers with its position's fp32 scale, issued before the current
//     tile's products; they are widened as the TPU kernel does, code x
//     scale in fp32 rounded once to bf16, and stored into the same smem
//     tile the float path fills with cp.async; the chunk's own K/V stay
//     in bf16 and take cp.async. Everything after that is the float
//     kernel's.
//   What bounds it now: the latency of each block's short walk (2-3 key
//   tiles at the serving sites) and of the combine, not the card's rates.
// fp32 (paged_chunk_kernel, the conformance path: TF32 off, exact
//   products) — every product on the CUDA cores, one block per (row tile,
//   kv head, slot) walking the whole key sequence in tiles of 32: the
//   next tile's 16-byte loads issued into registers before the current
//   one is computed, a 4 x 4 score tile and a 4 x D/8 slice of the
//   accumulator a thread. int8 pages: one kernel template, the page type
//   a parameter; a prefix code is widened on its way into the fp32 shared
//   tile (code x scale in fp32 rounded once to q's dtype), the chunk's own
//   K/V stay in q's dtype.

#include "common.cuh"
#include "mma.cuh"
#include "split_combine.cuh"

#include <type_traits>

namespace {

using namespace kubeflow;

constexpr int kThreads = 128;  // 16 row groups x 8 column groups
constexpr int kBr = 64;        // query rows (position x GQA head) per block
constexpr int kBk = 32;        // keys per streamed tile
constexpr int kRows = 4;       // query rows per thread
constexpr int kCols = kBk / 8; // key columns per thread
constexpr int kMaxRep = 16;    // largest GQA group (query heads per kv head)

template <int D>
constexpr size_t smem_floats() {
  return static_cast<size_t>(kBr) * (D + 1) + kBk * (D + 1) + kBk * D +
         kBr * (kBk + 1);
}

// T: q, the chunk's K/V and out (float or bf16); P: the pages (T, or
// int8_t with scales)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const T* __restrict__ q,        // [B, S, H, D], pre-scaled
                   const P* __restrict__ k_pages,  // [N, bs, kv_heads, D]
                   const P* __restrict__ v_pages,  // [N, bs, kv_heads, D]
                   const float* __restrict__ k_scales,  // [N, bs, kv_heads]
                   const float* __restrict__ v_scales,  // (int8 pages only)
                   const int* __restrict__ tables, // [B, bps]
                   const int* __restrict__ plens,  // [B]
                   const T* __restrict__ k_chunk,  // [B, S, kv_heads, D]
                   const T* __restrict__ v_chunk,  // [B, S, kv_heads, D]
                   T* __restrict__ out,            // [B, S, H, D]
                   int S, int kv_heads, int n_rep, int bs, int bps) {
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  constexpr int kVec = vec_width<T>();
  constexpr int kUnitCols = vec_width<P>();            // columns a unit
  constexpr int kWords = kUnitCols / kVec;             // chunk loads a unit
  constexpr int kRowUnits = D / kUnitCols;             // units a key row
  constexpr int kUnits = kBk * kRowUnits;              // units a tile
  constexpr int kLoads = (kUnits + kThreads - 1) / kThreads;  // per thread
  constexpr bool kEven = kUnits % kThreads == 0;

  extern __shared__ float smem[];
  float* q_s = smem;                   // [kBr][D + 1]
  float* k_s = q_s + kBr * (D + 1);    // [kBk][D + 1]
  float* v_s = k_s + kBk * (D + 1);    // [kBk][D]
  float* p_s = v_s + kBk * D;          // [kBr][kBk + 1]

  const int b = blockIdx.z;
  const int kvh = blockIdx.y;
  const int per_tile = kBr / n_rep;            // chunk positions per block
  const int live = per_tile * n_rep;           // rows of the tile in use
  const int s0 = blockIdx.x * per_tile;        // first chunk position
  const int H = kv_heads * n_rep;
  const int tid = threadIdx.x;
  const int ty = tid / 8;   // rows ty*4 .. ty*4+3 of the tile
  const int tx = tid % 8;   // key columns tx + 8j, value columns tx + 8j
  const int plen = min(max(plens[b], 0), bps * bs);
  const int* table = tables + static_cast<size_t>(b) * bps;
  // the virtual key sequence: plen prefix positions, then the chunk's
  // columns up to this tile's last position
  const int n_keys = plen + min(S, s0 + per_tile);

  // row f of the tile is position s0 + f / n_rep, head kvh*n_rep + f % n_rep
  constexpr int kQUnits = D / kVec;
  for (int u = tid; u < kBr * kQUnits; u += kThreads) {
    const int f = u / kQUnits;
    const int c = (u % kQUnits) * kVec;
    const int s = s0 + f / n_rep;
    float x[kVec];
    if (f < live && s < S) {
      const int h = kvh * n_rep + f % n_rep;
      unpack16<T>(load16(q + ((static_cast<size_t>(b) * S + s) * H + h) * D
                         + c), x);
    } else {
#pragma unroll
      for (int i = 0; i < kVec; ++i) x[i] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < kVec; ++i) q_s[f * (D + 1) + c + i] = x[i];
  }

  // one tile's K/V units in registers (a prefix unit in word 0, with its
  // position's scales for int8 pages): keys past n_keys are 0
  uint4 kr[kLoads][kWords], vr[kLoads][kWords];
  float ksr[kLoads], vsr[kLoads];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = tid + j * kThreads;
      const int t = k0 + u / kRowUnits;
      const int c = (u % kRowUnits) * kUnitCols;
      if (!kEven && u >= kUnits) continue;
      if (t < plen) {
        const size_t page = static_cast<size_t>(table[t / bs]);
        const size_t row = (page * bs + t % bs) * kv_heads + kvh;
        kr[j][0] = load16(k_pages + row * D + c);
        vr[j][0] = load16(v_pages + row * D + c);
        if constexpr (kInt8) {
          ksr[j] = k_scales[row];
          vsr[j] = v_scales[row];
        }
      } else if (t < n_keys) {
        const size_t off =
            ((static_cast<size_t>(b) * S + (t - plen)) * kv_heads + kvh) * D +
            c;
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          kr[j][w] = load16(k_chunk + off + w * kVec);
          vr[j][w] = load16(v_chunk + off + w * kVec);
        }
      } else {
#pragma unroll
        for (int w = 0; w < kWords; ++w) {
          kr[j][w] = make_uint4(0u, 0u, 0u, 0u);
          vr[j][w] = kr[j][w];
        }
      }
    }
  };

  float m[kRows], l[kRows], o[kRows][D / 8];
  int qpos[kRows];   // each row's chunk position, for the causal mask
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
    qpos[r] = s0 + (ty * kRows + r) / n_rep;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) o[r][j] = 0.f;
  }

  load_tile(0);
  for (int k0 = 0; k0 < n_keys; k0 += kBk) {
    __syncthreads();   // q_s is loaded; the last tile's readers are done
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = tid + j * kThreads;
      if (!kEven && u >= kUnits) continue;
      const int c = u / kRowUnits;
      const int d = (u % kRowUnits) * kUnitCols;
      float kx[kUnitCols], vx[kUnitCols];
      if constexpr (kInt8) {
        if (k0 + c < plen) {
          // the TPU kernel's (k.astype(f32) * ks).astype(q.dtype)
          unpack16<P>(kr[j][0], kx);
          unpack16<P>(vr[j][0], vx);
#pragma unroll
          for (int i = 0; i < kUnitCols; ++i) {
            kx[i] = round_to<T>(kx[i] * ksr[j]);
            vx[i] = round_to<T>(vx[i] * vsr[j]);
          }
        } else {   // the chunk's own keys, in q's dtype
#pragma unroll
          for (int w = 0; w < kWords; ++w) {
            unpack16<T>(kr[j][w], kx + w * kVec);
            unpack16<T>(vr[j][w], vx + w * kVec);
          }
        }
      } else {
        unpack16<T>(kr[j][0], kx);
        unpack16<T>(vr[j][0], vx);
      }
#pragma unroll
      for (int i = 0; i < kUnitCols; ++i) {
        k_s[c * (D + 1) + d + i] = kx[i];
        v_s[c * D + d + i] = vx[i];
      }
    }
    __syncthreads();
    if (k0 + kBk < n_keys) load_tile(k0 + kBk);   // in flight now

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
      bool valid[kCols];
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int t = k0 + tx + 8 * j;
        valid[j] = t < plen || (t < n_keys && t - plen <= qpos[r]);
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
        p_s[(ty * kRows + r) * (kBk + 1) + tx + 8 * j] = p;
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

    const int n_c = min(kBk, n_keys - k0);
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
    const int f = ty * kRows + r;
    const int s = qpos[r];
    if (f < live && s < S) {
      const int h = kvh * n_rep + f % n_rep;
      const size_t base = ((static_cast<size_t>(b) * S + s) * H + h) * D;
      const float lr = l[r] == 0.f ? 1.f : l[r];
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        out[base + tx + 8 * j] = from_f32<T>(o[r][j] / lr);
    }
  }
}

// ------------------------------------------------- bf16, tensor cores

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 128;   // 4 warps x 16 query rows
constexpr int kTcBr = 64;         // query rows per block
constexpr int kTcBk = 64;         // keys per streamed tile
constexpr float kLog2e = 1.4426950408889634f;

template <int D>
constexpr size_t tc_smem_bytes() {   // q, then 2 stages of K and of V
  return static_cast<size_t>(kTcBr + 4 * kTcBk) * (D + 8) * sizeof(bf16);
}

// P: the pages, bf16 (K2) or int8_t with fp32 scales (K2-i8); q, the
// chunk's K/V and out are bf16. ws: the splits' partials when splits > 1
// (acc [splits][rows][D], then (m, l) [splits][rows][2], rows = B x
// kv_heads x S x n_rep, row (b, kvh, s n_rep + h % n_rep)).
template <typename P, int D>
__global__ void __launch_bounds__(kTcThreads)
paged_chunk_tc_kernel(const bf16* __restrict__ q,       // [B, S, H, D], pre-scaled
                      const P* __restrict__ k_pages,    // [N, bs, kv_heads, D]
                      const P* __restrict__ v_pages,    // [N, bs, kv_heads, D]
                      const float* __restrict__ k_scales,  // [N, bs, kv_heads]
                      const float* __restrict__ v_scales,  // (int8 pages only)
                      const int* __restrict__ tables,   // [B, bps]
                      const int* __restrict__ plens,    // [B]
                      const bf16* __restrict__ k_chunk, // [B, S, kv_heads, D]
                      const bf16* __restrict__ v_chunk, // [B, S, kv_heads, D]
                      bf16* __restrict__ out,           // [B, S, H, D]
                      float* __restrict__ ws,
                      int B, int S, int kv_heads, int n_rep, int bs, int bps,
                      int splits) {
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  constexpr int kStride = D + 8;     // bf16 elements a shared row
  constexpr int kChunks = D / 8;     // 16-byte chunks a bf16 row
  constexpr int kKs = D / 16;        // k-slices of q.K^T
  constexpr int kNb = kTcBk / 8;     // n-blocks of S (8 keys each)
  constexpr int kDb = D / 8;         // n-blocks of O
  // a thread's load units of a key tile: 16-byte chunks of bf16 rows, or
  // 16 int8 codes (two bf16 chunks of shared memory) of a prefix row
  constexpr int kUnitCols = kInt8 ? 16 : 8;
  constexpr int kUnits = D / kUnitCols;         // units a key row
  constexpr int kRowStep = kTcThreads / kUnits;
  constexpr int kLoads = kTcBk / kRowStep;      // units a thread a tile
  static_assert(kTcThreads % kUnits == 0 && kTcBk % kRowStep == 0,
                "a tile splits over the threads");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);   // [kTcBr][kStride]
  bf16* k_s = q_s + kTcBr * kStride;               // [2][kTcBk][kStride]
  bf16* v_s = k_s + 2 * kTcBk * kStride;           // [2][kTcBk][kStride]

  const int n_rt = gridDim.x / splits;   // row tiles
  const int split = blockIdx.x / n_rt;   // the splits of one key range
  const int rt = blockIdx.x % n_rt;      // are adjacent blocks
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int per_tile = kTcBr / n_rep;    // chunk positions per block
  const int live = per_tile * n_rep;     // rows of the tile in use
  const int s0 = rt * per_tile;          // first chunk position
  const int H = kv_heads * n_rep;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator rows g and g + 8
  const int t = lane % 4;   // accumulator columns 2t, 2t + 1
  const int plen = min(max(plens[b], 0), bps * bs);
  const int* table = tables + static_cast<size_t>(b) * bps;
  // the virtual key sequence: plen prefix positions, then the chunk's
  // columns up to this tile's last position; this split's key tiles
  const int n_keys = plen + min(S, s0 + per_tile);
  const int n_kt = (n_keys + kTcBk - 1) / kTcBk;
  const int kt0 = split * n_kt / splits;
  const int kt1 = (split + 1) * n_kt / splits;

  // row f of the tile is position s0 + f / n_rep, head kvh*n_rep + f % n_rep
  for (int c = tid; c < kTcBr * kChunks; c += kTcThreads) {
    const int f = c / kChunks;
    const int col = (c % kChunks) * 8;
    const int s = s0 + f / n_rep;
    const bool ok = f < live && s < S;
    const int h = kvh * n_rep + f % n_rep;
    const bf16* src =
        ok ? q + ((static_cast<size_t>(b) * S + s) * H + h) * D + col : q;
    cp_async16(smem_u32(q_s + f * kStride + col), src, ok);
  }

  // this thread's units: key rows r0 + i * kRowStep, columns col0 ..
  const int r0 = tid / kUnits;
  const int col0 = (tid % kUnits) * kUnitCols;
  const uint32_t k_dst = smem_u32(k_s + r0 * kStride + col0);
  const uint32_t v_dst = smem_u32(v_s + r0 * kStride + col0);
  constexpr uint32_t kStageBytes = kTcBk * kStride * sizeof(bf16);
  constexpr uint32_t kStepBytes = kRowStep * kStride * sizeof(bf16);
  // an int8 prefix unit's codes and scales, from its load to its store
  uint4 kr[kInt8 ? kLoads : 1], vr[kInt8 ? kLoads : 1];
  float ksr[kInt8 ? kLoads : 1], vsr[kInt8 ? kLoads : 1];

  // the key tile kt into stage: cp.async for bf16 rows (keys past n_keys
  // land as zeros), registers for int8 prefix rows
  auto load = [&](int kt, int stage) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int key = kt * kTcBk + r0 + i * kRowStep;
      const uint32_t dst = stage * kStageBytes + i * kStepBytes;
      if (key < plen) {
        const size_t row =
            (static_cast<size_t>(table[key / bs]) * bs + key % bs) *
                kv_heads + kvh;
        if constexpr (kInt8) {
          kr[i] = load16(k_pages + row * D + col0);
          vr[i] = load16(v_pages + row * D + col0);
          ksr[i] = k_scales[row];
          vsr[i] = v_scales[row];
        } else {
          cp_async16(k_dst + dst, k_pages + row * D + col0, true);
          cp_async16(v_dst + dst, v_pages + row * D + col0, true);
        }
      } else {
        const bool ok = key < n_keys;
        const size_t off =
            ok ? ((static_cast<size_t>(b) * S + (key - plen)) * kv_heads +
                  kvh) * D + col0
               : 0;
#pragma unroll
        for (int w = 0; w < kUnitCols / 8; ++w) {
          cp_async16(k_dst + dst + 16 * w, k_chunk + off + 8 * w, ok);
          cp_async16(v_dst + dst + 16 * w, v_chunk + off + 8 * w, ok);
        }
      }
    }
  };
  // int8: the tile kt's prefix codes, widened as the TPU kernel does
  // ((code . f32) x scale, rounded once to bf16), into stage
  auto store_codes = [&](int kt, int stage) {
    if constexpr (kInt8) {
#pragma unroll
      for (int i = 0; i < kLoads; ++i) {
        const int key = kt * kTcBk + r0 + i * kRowStep;
        if (key >= plen) continue;
        const uint32_t dst = stage * kStageBytes + i * kStepBytes;
        const int8_t* kc = reinterpret_cast<const int8_t*>(&kr[i]);
        const int8_t* vc = reinterpret_cast<const int8_t*>(&vr[i]);
        uint32_t kw[8], vw[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          kw[e] = pack_bf16(to_f32(kc[2 * e]) * ksr[i],
                            to_f32(kc[2 * e + 1]) * ksr[i]);
          vw[e] = pack_bf16(to_f32(vc[2 * e]) * vsr[i],
                            to_f32(vc[2 * e + 1]) * vsr[i]);
        }
        asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n"
                     "st.shared.v4.b32 [%5], {%6, %7, %8, %9};\n"
                     "st.shared.v4.b32 [%10], {%11, %12, %13, %14};\n"
                     "st.shared.v4.b32 [%15], {%16, %17, %18, %19};\n"
                     ::"r"(k_dst + dst), "r"(kw[0]), "r"(kw[1]), "r"(kw[2]),
                     "r"(kw[3]), "r"(k_dst + dst + 16), "r"(kw[4]),
                     "r"(kw[5]), "r"(kw[6]), "r"(kw[7]), "r"(v_dst + dst),
                     "r"(vw[0]), "r"(vw[1]), "r"(vw[2]), "r"(vw[3]),
                     "r"(v_dst + dst + 16), "r"(vw[4]), "r"(vw[5]),
                     "r"(vw[6]), "r"(vw[7])
                     : "memory");
      }
    }
  };

  if (kt0 < kt1) load(kt0, 0);
  cp_async_commit();   // group 0: the q tile and the first K/V tile

  // a warp whose rows are all past the chunk (or the tile) computes nothing
  const bool warp_live = warp * 16 < live && s0 + warp * 16 / n_rep < S;
  int qpos[2];   // this lane's rows' chunk positions, for the causal mask
#pragma unroll
  for (int r = 0; r < 2; ++r) qpos[r] = s0 + (warp * 16 + g + 8 * r) / n_rep;

  // ldmatrix row addresses of this lane (mma.cuh): A from q rows, B
  // (non-transposed) from K rows, B (transposed) from V rows
  const uint32_t q_addr = smem_u32(q_s + (warp * 16 + (lane % 16)) * kStride +
                                   (lane / 16) * 8);
  const int kb_row = (lane % 8) + (lane / 16) * 8;
  const int kb_col = ((lane / 8) % 2) * 8;
  const int vb_row = (lane % 8) + ((lane / 8) % 2) * 8;
  const int vb_col = (lane / 16) * 8;

  float o[kDb][4];
#pragma unroll
  for (int j = 0; j < kDb; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) o[j][i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this lane's partial sums; the quad's at the end

  for (int kt = kt0; kt < kt1; ++kt) {
    const int stage = (kt - kt0) % 2;
    if constexpr (kInt8) store_codes(kt, stage);
    // one barrier a tile: tile kt has landed for every thread, and every
    // warp is done with tile kt - 1, whose buffer the next load reuses
    cp_async_wait<0>();
    __syncthreads();
    if (kt + 1 < kt1) {
      load(kt + 1, stage ^ 1);
      cp_async_commit();
    }
    if (!warp_live) continue;
    const bf16* kst = k_s + stage * kTcBk * kStride;
    const bf16* vst = v_s + stage * kTcBk * kStride;

    float sc[kNb][4];
#pragma unroll
    for (int j = 0; j < kNb; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[j][i] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKs; ++ks) {
      uint32_t qf[4];
      ldmatrix_x4(qf, q_addr + ks * 16 * sizeof(bf16));
#pragma unroll
      for (int nb = 0; nb < kNb / 2; ++nb) {
        uint32_t kb[4];
        ldmatrix_x4(kb, smem_u32(kst + (nb * 16 + kb_row) * kStride +
                                 ks * 16 + kb_col));
        mma_bf16(sc[2 * nb], qf, kb[0], kb[1]);
        mma_bf16(sc[2 * nb + 1], qf, kb[2], kb[3]);
      }
    }

    // mask (a tile wholly inside the prefix has none), then the online
    // softmax of rows g (i = 0, 1) and g + 8 (i = 2, 3)
    const int k0 = kt * kTcBk;
    const bool masked = k0 + kTcBk > plen;
    if (masked) {
#pragma unroll
      for (int j = 0; j < kNb; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = k0 + j * 8 + 2 * t + (i % 2);
          const bool valid = key < plen || (key < n_keys &&
                                            key - plen <= qpos[i / 2]);
          if (!valid) sc[j][i] = kNegInf;
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

    // O += p V with p in fp32: p_hi = bf16(p) and p_lo = bf16(p - p_hi)
    // into the same accumulator, V through ldmatrix.trans
#pragma unroll
    for (int kk = 0; kk < kTcBk / 16; ++kk) {
      float lo0[4], lo1[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lo0[i] = sc[2 * kk][i] - round_to<bf16>(sc[2 * kk][i]);
        lo1[i] = sc[2 * kk + 1][i] - round_to<bf16>(sc[2 * kk + 1][i]);
      }
      uint32_t ph[4], pl[4];
      pack_a(ph, sc[2 * kk], sc[2 * kk + 1]);
      pack_a(pl, lo0, lo1);
#pragma unroll
      for (int db = 0; db < kDb / 2; ++db) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, smem_u32(vst + (kk * 16 + vb_row) * kStride +
                                       db * 16 + vb_col));
        mma_bf16(o[2 * db], ph, vb[0], vb[1]);
        mma_bf16(o[2 * db + 1], ph, vb[2], vb[3]);
        mma_bf16(o[2 * db], pl, vb[0], vb[1]);
        mma_bf16(o[2 * db + 1], pl, vb[2], vb[3]);
      }
    }
  }
  cp_async_wait<0>();   // an empty split's q copies

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const size_t n_rows = static_cast<size_t>(B) * kv_heads * S * n_rep;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int f = warp * 16 + g + 8 * r;
    const int s = qpos[r];
    if (f >= live || s >= S) continue;
    if (splits == 1) {   // the whole walk: normalise, round once, store
      const int h = kvh * n_rep + f % n_rep;
      const float inv = 1.f / (l[r] == 0.f ? 1.f : l[r]);
      bf16* dst =
          out + ((static_cast<size_t>(b) * S + s) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < kDb; ++j)
        *reinterpret_cast<__nv_bfloat162*>(dst + j * 8) =
            __floats2bfloat162_rn(o[j][2 * r] * inv, o[j][2 * r + 1] * inv);
    } else {             // this split's partial, for the combine
      const size_t row =
          split * n_rows +
          (static_cast<size_t>(b) * kv_heads + kvh) * S * n_rep +
          s0 * n_rep + f;
      float* acc = ws + row * D + 2 * t;
#pragma unroll
      for (int j = 0; j < kDb; ++j)
        *reinterpret_cast<float2*>(acc + j * 8) =
            make_float2(o[j][2 * r], o[j][2 * r + 1]);
      if (t == 0)
        *reinterpret_cast<float2*>(ws + splits * n_rows * D + 2 * row) =
            make_float2(m[r], l[r]);
    }
  }
}

// The splits' partials of every row → out, one warp a row
// (split_combine.cuh: in split order, one division, one rounding to bf16).
template <int D>
__global__ void __launch_bounds__(128)
paged_chunk_combine_kernel(const float* __restrict__ ws,
                           bf16* __restrict__ out,   // [B, S, H, D]
                           int n_rows, int S, int kv_heads, int n_rep,
                           int splits) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_rows) return;
  const int R = S * n_rep;
  const int bkv = row / R;
  const int f = row % R;   // s n_rep + h % n_rep
  const int b = bkv / kv_heads;
  const int h = (bkv % kv_heads) * n_rep + f % n_rep;
  combine_split_row<bf16, D>(
      ws, n_rows, row, splits, lane,
      out + ((static_cast<size_t>(b) * S + f / n_rep) * kv_heads * n_rep +
             h) * D);
}

// ------------------------------------------------- launches, dispatch

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *plens, *kch, *vch;
  void *out, *ws;
  int B, S, kv_heads, n_rep, bs, bps, splits;
};

template <typename Kernel>
int allow_smem(Kernel kernel, size_t bytes, bool& attribute_set) {
  if (attribute_set) return 0;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  attribute_set = true;
  return 0;
}

template <typename P, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  static bool attribute_set = false;   // once per instantiation
  if (int err = allow_smem(paged_chunk_kernel<float, P, D>, smem,
                           attribute_set))
    return err;
  const int per_tile = kBr / a.n_rep;
  const dim3 grid((a.S + per_tile - 1) / per_tile, a.kv_heads, a.B);
  paged_chunk_kernel<float, P, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.plens), static_cast<const float*>(a.kch),
      static_cast<const float*>(a.vch), static_cast<float*>(a.out), a.S,
      a.kv_heads, a.n_rep, a.bs, a.bps);
  return static_cast<int>(cudaGetLastError());
}

template <typename P, int D>
int launch_tc(const Args& a, cudaStream_t stream) {
  const size_t smem = tc_smem_bytes<D>();
  static bool attribute_set = false;   // once per instantiation
  if (int err = allow_smem(paged_chunk_tc_kernel<P, D>, smem, attribute_set))
    return err;
  const int per_tile = kTcBr / a.n_rep;
  const int n_rt = (a.S + per_tile - 1) / per_tile;
  const dim3 grid(n_rt * a.splits, a.kv_heads, a.B);
  paged_chunk_tc_kernel<P, D><<<grid, kTcThreads, smem, stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.plens), static_cast<const bf16*>(a.kch),
      static_cast<const bf16*>(a.vch), static_cast<bf16*>(a.out),
      static_cast<float*>(a.ws), a.B, a.S, a.kv_heads, a.n_rep, a.bs, a.bps,
      a.splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  const int n_rows = a.B * a.kv_heads * a.S * a.n_rep;
  paged_chunk_combine_kernel<D><<<(n_rows + 3) / 4, 128, 0, stream>>>(
      static_cast<const float*>(a.ws), static_cast<bf16*>(a.out), n_rows,
      a.S, a.kv_heads, a.n_rep, a.splits);
  return static_cast<int>(cudaGetLastError());
}

// fp32 on the CUDA cores, bf16 on the tensor cores
template <typename P, int D>
int launch_dtype(int dtype, const Args& a, cudaStream_t stream) {
  if (dtype == 0) return a.splits == 1 ? launch<P, D>(a, stream)
                                       : static_cast<int>(cudaErrorInvalidValue);
  using TcP = std::conditional_t<std::is_same<P, float>::value, bf16, P>;
  return launch_tc<TcP, D>(a, stream);
}

template <typename P>
int dispatch_dim(int head_dim, int dtype, const Args& a,
                 cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch_dtype<P, 32>(dtype, a, stream);
    case 64:
      return launch_dtype<P, 64>(dtype, a, stream);
    case 128:
      return launch_dtype<P, 128>(dtype, a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// int8 = false: pages in q's dtype; true: int8 pages with fp32 scales
int run(bool int8, const Args& a, int head_dim, int dtype, void* stream) {
  if (a.n_rep < 1 || a.n_rep > kMaxRep || a.kv_heads < 1 || a.bs < 1 ||
      a.bps < 1 || a.B < 0 || a.S < 0 || a.B > 65535 ||
      a.kv_heads > 65535 || a.splits < 1 ||
      (a.splits > 1 && a.ws == nullptr) || (dtype != 0 && dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B == 0 || a.S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // P = float stands for "pages in q's dtype"
  return int8 ? dispatch_dim<int8_t>(head_dim, dtype, a, s)
              : dispatch_dim<float>(head_dim, dtype, a, s);
}

}  // namespace

// dtype (of q, the chunk K/V and out): 0 = float32, 1 = bfloat16. q,
// the pages, the chunk K/V and out must be 16-byte aligned. splits: the
// key walk's splits (1 for float32); ws: the workspace of the splits'
// partials, fp32 [splits x rows x (head_dim + 2)] with rows = batch x
// kv_heads x seq x n_rep (null for one split); nothing in it needs to be
// zeroed. Returns a cudaError_t (0 = launched).
extern "C" int kubeflow_paged_chunk(const void* q, const void* k_pages,
                                    const void* v_pages, const void* tables,
                                    const void* plens, const void* k_chunk,
                                    const void* v_chunk, void* out, void* ws,
                                    int batch, int seq, int kv_heads,
                                    int n_rep, int head_dim, int block_size,
                                    int bps, int splits, int dtype,
                                    void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, tables, plens,
               k_chunk, v_chunk, out, ws, batch, seq, kv_heads, n_rep,
               block_size, bps, splits};
  return run(false, a, head_dim, dtype, stream);
}

// K2-i8: int8 prefix pages [N, bs, kv_heads, D] with fp32 scales
// [N, bs, kv_heads, 1]; the chunk's K/V in q's dtype; otherwise as
// kubeflow_paged_chunk.
extern "C" int kubeflow_paged_chunk_i8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* plens, const void* k_chunk, const void* v_chunk, void* out,
    void* ws, int batch, int seq, int kv_heads, int n_rep, int head_dim,
    int block_size, int bps, int splits, int dtype, void* stream) {
  const Args a{q, k_pages, v_pages, k_scales, v_scales, tables, plens,
               k_chunk, v_chunk, out, ws, batch, seq, kv_heads, n_rep,
               block_size, bps, splits};
  return run(true, a, head_dim, dtype, stream);
}
