// K2 — chunk-after-prefix read over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   kubeflow_tpu/compute/ops/paged_attention.py::_chunk_kernel
// (called through paged_chunk_attention, same file). Wrapper, plain
// PyTorch version and launch counter: ../paged_attention.py.
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
//   sharing the prefix across row tiles are later changes.

#include "common.cuh"

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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
paged_chunk_kernel(const T* __restrict__ q,        // [B, S, H, D], pre-scaled
                   const T* __restrict__ k_pages,  // [N, bs, kv_heads, D]
                   const T* __restrict__ v_pages,  // [N, bs, kv_heads, D]
                   const int* __restrict__ tables, // [B, bps]
                   const int* __restrict__ plens,  // [B]
                   const T* __restrict__ k_chunk,  // [B, S, kv_heads, D]
                   const T* __restrict__ v_chunk,  // [B, S, kv_heads, D]
                   T* __restrict__ out,            // [B, S, H, D]
                   int S, int kv_heads, int n_rep, int bs, int bps) {
  constexpr int kVec = vec_width<T>();
  constexpr int kRowUnits = D / kVec;                  // 16-byte words a row
  constexpr int kLoads = kBk * kRowUnits / kThreads;   // per thread, per tile
  static_assert(kBk * kRowUnits % kThreads == 0, "tile splits over threads");

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
  for (int u = tid; u < kBr * kRowUnits; u += kThreads) {
    const int f = u / kRowUnits;
    const int c = (u % kRowUnits) * kVec;
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

  // one tile's K/V words in registers: keys past n_keys are 0
  uint4 kr[kLoads], vr[kLoads];
  auto load_tile = [&](int k0) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = tid + j * kThreads;
      const int t = k0 + u / kRowUnits;
      const int c = (u % kRowUnits) * kVec;
      if (t < plen) {
        const size_t page = static_cast<size_t>(table[t / bs]);
        const size_t off = ((page * bs + t % bs) * kv_heads + kvh) * D + c;
        kr[j] = load16(k_pages + off);
        vr[j] = load16(v_pages + off);
      } else if (t < n_keys) {
        const size_t off =
            ((static_cast<size_t>(b) * S + (t - plen)) * kv_heads + kvh) * D +
            c;
        kr[j] = load16(k_chunk + off);
        vr[j] = load16(v_chunk + off);
      } else {
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = kr[j];
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

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* tables,
           const void* plens, const void* kch, const void* vch, void* out,
           int B, int S, int kv_heads, int n_rep, int bs, int bps,
           cudaStream_t stream) {
  const size_t smem = smem_floats<D>() * sizeof(float);
  static bool attribute_set = false;   // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_chunk_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  const int per_tile = kBr / n_rep;
  const dim3 grid((S + per_tile - 1) / per_tile, kv_heads, B);
  paged_chunk_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const int*>(tables),
      static_cast<const int*>(plens), static_cast<const T*>(kch),
      static_cast<const T*>(vch), static_cast<T*>(out), S, kv_heads, n_rep,
      bs, bps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(int head_dim, const void* q, const void* k, const void* v,
                 const void* tables, const void* plens, const void* kch,
                 const void* vch, void* out, int B, int S, int kv_heads,
                 int n_rep, int bs, int bps, cudaStream_t stream) {
  switch (head_dim) {
    case 32:
      return launch<T, 32>(q, k, v, tables, plens, kch, vch, out, B, S,
                           kv_heads, n_rep, bs, bps, stream);
    case 64:
      return launch<T, 64>(q, k, v, tables, plens, kch, vch, out, B, S,
                           kv_heads, n_rep, bs, bps, stream);
    case 128:
      return launch<T, 128>(q, k, v, tables, plens, kch, vch, out, B, S,
                            kv_heads, n_rep, bs, bps, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Pointers must be 16-byte aligned.
// Returns a cudaError_t (0 = launched).
extern "C" int kubeflow_paged_chunk(const void* q, const void* k_pages,
                                    const void* v_pages, const void* tables,
                                    const void* plens, const void* k_chunk,
                                    const void* v_chunk, void* out, int batch,
                                    int seq, int kv_heads, int n_rep,
                                    int head_dim, int block_size, int bps,
                                    int dtype, void* stream) {
  if (n_rep < 1 || n_rep > kMaxRep || kv_heads < 1 || block_size < 1 ||
      bps < 1 || batch < 0 || seq < 0 || batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || seq == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_dim<float>(head_dim, q, k_pages, v_pages, tables, plens,
                               k_chunk, v_chunk, out, batch, seq, kv_heads,
                               n_rep, block_size, bps, s);
  if (dtype == 1)
    return dispatch_dim<__nv_bfloat16>(head_dim, q, k_pages, v_pages, tables,
                                       plens, k_chunk, v_chunk, out, batch,
                                       seq, kv_heads, n_rep, block_size, bps,
                                       s);
  return static_cast<int>(cudaErrorInvalidValue);
}
