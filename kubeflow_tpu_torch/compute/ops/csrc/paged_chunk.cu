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
// Design, right and simple first, built on the flash forward's tiles:
// - the TPU kernel keeps all S * n_rep query rows of one (slot, kv head)
//   in VMEM and walks the pages as a sequential grid axis; here the rows
//   (position-major, the n_rep heads of one GQA group adjacent) split
//   into tiles of 64, one thread block per (row tile, kv head, slot), and
//   the page walk is a loop inside the block (grid order is free on the
//   card, so nothing carries between blocks);
// - a block streams one virtual key sequence in tiles of 32: the prefix
//   positions through the table, then the chunk's columns only up to its
//   own last position (the causal mask hides the rest). Each block loads
//   its own table row and prefix length (the TPU kernel scalar-
//   prefetched them);
// - K/V move in 16-byte loads, the next tile's loads issued into
//   registers before the current one is computed; each thread holds a
//   4 x 4 score tile and a 4 x D/8 slice of the accumulator. The products
//   run on the CUDA cores in fp32. Every row tile of a slot reads the
//   slot's whole prefix (from L2 after the first); tensor cores and
//   sharing the prefix across row tiles are later changes;
// - int8 pages (one kernel template, the page type a parameter): a key's
//   columns move in units of 16, one 16-byte load of int8 codes for a
//   prefix key, 2 (bf16) or 4 (fp32) loads of the chunk's own K/V, which
//   stay in q's dtype (the TPU kernel's :249-254). A prefix code is
//   widened on its way into the fp32 shared tile as the TPU kernel
//   does, code x scale in fp32 rounded once to q's dtype; the thread
//   that loads a word loads its position's two fp32 scales with it.
//   The shared layout and everything after it are the float kernel's.

#include "common.cuh"

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

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *plens, *kch, *vch;
  void* out;
  int B, S, kv_heads, n_rep, bs, bps;
};

template <typename T, typename P, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  static bool attribute_set = false;   // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_chunk_kernel<T, P, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const int per_tile = kBr / a.n_rep;
  const dim3 grid((a.S + per_tile - 1) / per_tile, a.kv_heads, a.B);
  paged_chunk_kernel<T, P, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const P*>(a.k),
      static_cast<const P*>(a.v), static_cast<const float*>(a.ks),
      static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
      static_cast<const int*>(a.plens), static_cast<const T*>(a.kch),
      static_cast<const T*>(a.vch), static_cast<T*>(a.out), a.S, a.kv_heads,
      a.n_rep, a.bs, a.bps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename P>
int dispatch_dim(int head_dim, const Args& a, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, P, 32>(a, stream);
    case 64:
      return launch<T, P, 64>(a, stream);
    case 128:
      return launch<T, P, 128>(a, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// int8 = false: pages in q's dtype; true: int8 pages with fp32 scales
int run(bool int8, const Args& a, int head_dim, int dtype, void* stream) {
  if (a.n_rep < 1 || a.n_rep > kMaxRep || a.kv_heads < 1 || a.bs < 1 ||
      a.bps < 1 || a.B < 0 || a.S < 0 || a.B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.B == 0 || a.S == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int8 ? dispatch_dim<float, int8_t>(head_dim, a, s)
                : dispatch_dim<float, float>(head_dim, a, s);
  if (dtype == 1)
    return int8 ? dispatch_dim<__nv_bfloat16, int8_t>(head_dim, a, s)
                : dispatch_dim<__nv_bfloat16, __nv_bfloat16>(head_dim, a, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// dtype (of q, the chunk K/V and out): 0 = float32, 1 = bfloat16. q,
// the pages, the chunk K/V and out must be 16-byte aligned. Returns a
// cudaError_t (0 = launched).
extern "C" int kubeflow_paged_chunk(const void* q, const void* k_pages,
                                    const void* v_pages, const void* tables,
                                    const void* plens, const void* k_chunk,
                                    const void* v_chunk, void* out, int batch,
                                    int seq, int kv_heads, int n_rep,
                                    int head_dim, int block_size, int bps,
                                    int dtype, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, tables, plens,
               k_chunk, v_chunk, out, batch, seq, kv_heads, n_rep,
               block_size, bps};
  return run(false, a, head_dim, dtype, stream);
}

// K2-i8: int8 prefix pages [N, bs, kv_heads, D] with fp32 scales
// [N, bs, kv_heads, 1]; the chunk's K/V in q's dtype; otherwise as
// kubeflow_paged_chunk.
extern "C" int kubeflow_paged_chunk_i8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* plens, const void* k_chunk, const void* v_chunk, void* out,
    int batch, int seq, int kv_heads, int n_rep, int head_dim, int block_size,
    int bps, int dtype, void* stream) {
  const Args a{q, k_pages, v_pages, k_scales, v_scales, tables, plens,
               k_chunk, v_chunk, out, batch, seq, kv_heads, n_rep,
               block_size, bps};
  return run(true, a, head_dim, dtype, stream);
}
