// K1 — one-token decode read over the paged KV pool, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
//   kubeflow_tpu/compute/ops/paged_attention.py::_decode_kernel
// (called through paged_decode_attention, same file), both its float
// pages and its int8_pages branch (:75-81): kubeflow_paged_decode takes
// pages in q's dtype, kubeflow_paged_decode_i8 (K1-i8) int8 pages with
// one fp32 scale per (position, kv head). Wrapper, plain PyTorch version
// and launch counters: ../paged_attention.py.
//
// What it computes: for every slot i and query head h,
//   out[i, h] = softmax(q[i, h] . K[i, :len_i, h / n_rep]^T) V[i, :len_i, h / n_rep]
// where K/V rows are gathered through the slot's block table
// (logical position p lives at page tables[i, p / bs], row p % bs).
// q arrives pre-scaled (softmax scale folded in fp32 and rounded once by
// the wrapper). Scores, the running max m, the sum l and the output
// accumulator are fp32; the p.V product widens V to fp32 (the JAX
// kernel's `v.astype(float32)`); rows with no valid position (length 0,
// an inactive slot) divide by 1 and stay finite.
//
// Bound on this card: bytes. Each K/V element read is used by the n_rep
// query rows of its GQA group only — 2 * n_rep FLOPs per element, about
// 4 FLOPs per byte in bf16 at n_rep 4, two orders below the ~295
// FLOPs/byte where an H100 (3.35 TB/s, 989 TFLOP/s bf16) stops being
// memory-bound. The least time is the occupied pages' bytes over
// 3.35 TB/s.
//
// Design against that bound:
// - one thread block per (slot, kv head): the block reads each of its
//   pages once and serves all n_rep query heads of the group from
//   shared memory (GQA is native; K/V are never repeated);
// - the block loads its own block-table row and length (the TPU kernel
//   scalar-prefetched them) and walks only ceil(length / 32) tiles of 32
//   positions — nothing past the slot's length is read, whatever the
//   table's width; a tile may span pages of any block size;
// - K/V move in 16-byte loads, and the next tile's loads are issued
//   into registers before the current tile is computed, so device
//   memory latency overlaps the arithmetic;
// - one warp per query row scores the tile (lane = position) and folds
//   it into the online softmax with warp shuffles;
// - int8 pages (one kernel template, the page type a parameter): a
//   16-byte load carries 16 int8 codes, so a D-128 row is 8 loads where
//   bf16 takes 16 and the page bytes halve; the thread that loads a
//   word also loads its position's two fp32 scales (the threads of one
//   position, 8 at D 128, read the same word: one transaction). Each
//   code is widened as the TPU kernel does, code x scale in fp32 rounded
//   once to q's dtype, then to fp32 for the dot and for p.V, on its way
//   into the fp32 shared tiles, so the shared layout and everything
//   after it are the float kernel's.
// Known limit, left for a later change: a decode batch has only
// slots * kv_heads blocks (16 for 8 slots x 2 kv heads), far fewer
// than the 132 SMs, and a long slot's tiles run in sequence in one
// block, so the kernel cannot reach the memory rate. Splitting a slot's
// pages over several blocks with a second reduction pass
// (flash-decoding) is the fix.

#include "common.cuh"

#include <type_traits>

namespace {

using namespace kubeflow;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // positions per tile: one per lane
constexpr int kMaxRep = 16;    // largest GQA group (query heads per kv head)

// T: q and out (float or bf16); P: the pages (T, or int8_t with scales)
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q,        // [S, H, D], pre-scaled
                    const P* __restrict__ k_pages,  // [N, bs, kv_heads, D]
                    const P* __restrict__ v_pages,  // [N, bs, kv_heads, D]
                    const float* __restrict__ k_scales,  // [N, bs, kv_heads]
                    const float* __restrict__ v_scales,  // (int8 pages only)
                    const int* __restrict__ tables, // [S, bps]
                    const int* __restrict__ lengths,// [S]
                    T* __restrict__ out,            // [S, H, D]
                    int kv_heads, int n_rep, int bs, int bps) {
  constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  constexpr int kVec = vec_width<P>();          // page values a 16-byte load
  constexpr int kUnits = kTile * D / kVec;      // 16-byte loads per tile
  constexpr int kLoads = (kUnits + kThreads - 1) / kThreads;  // per thread
  constexpr bool kEven = kUnits % kThreads == 0;
  static_assert(kThreads % D == 0, "a thread keeps one output column");
  constexpr int kKs = D + 1;                    // padded k_s row stride

  extern __shared__ float smem[];
  float* q_s = smem;                    // [n_rep][D]
  float* k_s = q_s + n_rep * D;         // [kTile][D + 1]
  float* v_s = k_s + kTile * kKs;       // [kTile][D]
  float* p_s = v_s + kTile * D;         // [n_rep][kTile]
  float* m_s = p_s + n_rep * kTile;     // [n_rep] running max
  float* l_s = m_s + n_rep;             // [n_rep] running sum
  float* c_s = l_s + n_rep;             // [n_rep] rescale of this tile

  const int slot = blockIdx.x;
  const int kvh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int H = kv_heads * n_rep;
  const int length = min(max(lengths[slot], 0), bps * bs);
  const int* table = tables + static_cast<size_t>(slot) * bps;

  const size_t q_base =
      (static_cast<size_t>(slot) * H + static_cast<size_t>(kvh) * n_rep) * D;
  for (int e = tid; e < n_rep * D; e += kThreads) q_s[e] = to_f32(q[q_base + e]);
  for (int r = tid; r < n_rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  // this tile's K/V words in registers (int8: with their positions'
  // scales): positions past the length are 0
  uint4 kr[kLoads], vr[kLoads];
  float ksr[kLoads], vsr[kLoads];
  auto load_tile = [&](int base) {
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = tid + j * kThreads;
      const int t = u / (D / kVec);
      const int c = (u % (D / kVec)) * kVec;
      const int pos = base + t;
      if ((kEven || u < kUnits) && pos < length) {
        const size_t page = static_cast<size_t>(table[pos / bs]);
        const size_t row = (page * bs + pos % bs) * kv_heads + kvh;
        kr[j] = load16(k_pages + row * D + c);
        vr[j] = load16(v_pages + row * D + c);
        if constexpr (kInt8) {
          ksr[j] = k_scales[row];
          vsr[j] = v_scales[row];
        }
      } else {
        kr[j] = make_uint4(0u, 0u, 0u, 0u);
        vr[j] = kr[j];
        if constexpr (kInt8) {
          ksr[j] = 0.f;
          vsr[j] = 0.f;
        }
      }
    }
  };

  // output elements e = tid + j * kThreads of the group's [n_rep, D]
  // block: column tid % D, row e / D
  constexpr int kPer = (kMaxRep * D + kThreads - 1) / kThreads;
  const int d_own = tid % D;
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;

  if (length > 0) load_tile(0);
  for (int base = 0; base < length; base += kTile) {
    const int n_tok = min(kTile, length - base);
    __syncthreads();   // q_s is loaded; the last tile's readers are done
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = tid + j * kThreads;
      if (!kEven && u >= kUnits) continue;
      const int t = u / (D / kVec);
      const int c = (u % (D / kVec)) * kVec;
      float kx[kVec], vx[kVec];
      unpack16<P>(kr[j], kx);
      unpack16<P>(vr[j], vx);
      if constexpr (kInt8) {
        // the TPU kernel's (k.astype(f32) * ks).astype(q.dtype)
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          kx[i] = round_to<T>(kx[i] * ksr[j]);
          vx[i] = round_to<T>(vx[i] * vsr[j]);
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        k_s[t * kKs + c + i] = kx[i];
        v_s[t * D + c + i] = vx[i];
      }
    }
    __syncthreads();
    if (base + kTile < length) load_tile(base + kTile);   // in flight now

    // one warp per query row: lane t scores position base + t, then
    // the row's online-softmax fold; p is masked explicitly so a masked
    // position adds no mass even while m is still -inf
    for (int r = warp; r < n_rep; r += kWarps) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      const float* qr = q_s + r * D;
      const float* kt = k_s + lane * kKs;
#pragma unroll
      for (int d = 0; d < D; d += 4) {
        s0 += qr[d] * kt[d];
        s1 += qr[d + 1] * kt[d + 1];
        s2 += qr[d + 2] * kt[d + 2];
        s3 += qr[d + 3] * kt[d + 3];
      }
      const bool valid = lane < n_tok;
      const float s = valid ? (s0 + s1) + (s2 + s3) : kNegInf;
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = valid ? expf(s - m_new) : 0.f;
      float sum = p;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r * kTile + lane] = p;
      if (lane == 0) {
        const float corr = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * corr + sum;
        c_s[r] = corr;
      }
    }
    __syncthreads();

#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int e = tid + j * kThreads;
      if (e < n_rep * D) acc[j] *= c_s[e / D];
    }
    for (int t = 0; t < n_tok; ++t) {
      const float vv = v_s[t * D + d_own];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int e = tid + j * kThreads;
        if (e < n_rep * D) acc[j] += p_s[(e / D) * kTile + t] * vv;
      }
    }
  }
  __syncthreads();   // l_s of the last tile

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int e = tid + j * kThreads;
    if (e < n_rep * D) {
      const float l = l_s[e / D];
      out[q_base + e] = from_f32<T>(acc[j] / (l == 0.f ? 1.f : l));
    }
  }
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *lengths;
  void* out;
  int slots, kv_heads, n_rep, bs, bps;
};

template <typename T, typename P, int D>
int launch(const Args& a, cudaStream_t stream) {
  const size_t floats = static_cast<size_t>(a.n_rep) * D + kTile * (D + 1) +
                        kTile * D + static_cast<size_t>(a.n_rep) * kTile +
                        3 * a.n_rep;
  const size_t smem = floats * sizeof(float);
  paged_decode_kernel<T, P, D>
      <<<dim3(a.slots, a.kv_heads), kThreads, smem, stream>>>(
          static_cast<const T*>(a.q), static_cast<const P*>(a.k),
          static_cast<const P*>(a.v), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
          static_cast<const int*>(a.lengths), static_cast<T*>(a.out),
          a.kv_heads, a.n_rep, a.bs, a.bps);
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
      a.bps < 1 || a.slots < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.slots == 0) return 0;
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

// dtype (of q and out): 0 = float32, 1 = bfloat16. q, the pages and out
// must be 16-byte aligned. Returns a cudaError_t (0 = launched).
extern "C" int kubeflow_paged_decode(const void* q, const void* k_pages,
                                     const void* v_pages, const void* tables,
                                     const void* lengths, void* out, int slots,
                                     int kv_heads, int n_rep, int head_dim,
                                     int block_size, int bps, int dtype,
                                     void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, tables, lengths, out,
               slots, kv_heads, n_rep, block_size, bps};
  return run(false, a, head_dim, dtype, stream);
}

// K1-i8: int8 k/v pages [N, bs, kv_heads, D] with fp32 scales
// [N, bs, kv_heads, 1]; otherwise as kubeflow_paged_decode.
extern "C" int kubeflow_paged_decode_i8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, int slots, int kv_heads, int n_rep,
    int head_dim, int block_size, int bps, int dtype, void* stream) {
  const Args a{q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out,
               slots, kv_heads, n_rep, block_size, bps};
  return run(true, a, head_dim, dtype, stream);
}
