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
// kernel's `v.astype(float32)`); masked positions score -1e30 and take an
// explicit zero p; rows with no valid position (length 0, an inactive
// slot) divide by 1 and stay finite.
//
// What bounds it. Each K/V element read serves the n_rep query rows of
// its GQA group only: 2 * n_rep FLOPs an element, about 4 FLOPs a byte in
// bf16 at n_rep 4, two orders below the ~295 FLOPs/byte where an H100
// (3.35 TB/s, 989 TFLOP/s bf16) stops being memory-bound, so the least
// time is the occupied pages' bytes over 3.35 TB/s and the tensor cores
// would buy nothing: the products stay on the CUDA cores. At the serving
// shape (8 slots x 2 kv heads, up to 1024 positions) those bytes take
// under a microsecond; what the kernel pays is latency: the chain of
// dependent reads (length, table, pages) and, with one block per (slot,
// kv head), 16 blocks on 132 SMs and a long slot's tiles one after
// another in one block. The design attacks the latency:
//
// - the split key walk (flash-decoding): the grid is (split, kv head,
//   slot). The table's n = ceil(bps * bs / 32) tiles of 32 positions are
//   cut into `splits` spans, split i taking tiles [i n / splits,
//   (i + 1) n / splits) (K2's rule). The wrapper picks the split count on
//   the host from the shapes alone (../paged_attention.py, decode_splits:
//   about 2 x the SMs' worth of blocks, never more splits than tiles), so
//   no device sync is needed; a split whose span starts at or past its
//   slot's length reads no page and writes the empty partial m = -1e30,
//   l = 0, acc = 0;
// - in a split the block keeps the group's n_rep query rows in shared
//   memory (GQA is native, K/V are never repeated) and gathers its tiles
//   with 16-byte cp.async into a ring of kStages tiles in shared memory,
//   every tile of the ring issued before the first is computed: a span
//   of up to kStages tiles (1-2 at the serving shape) is in flight at
//   once. The tiles stay in the pages' own type in shared memory (bf16,
//   fp32, or int8 codes with their positions' fp32 scales) and are
//   widened where they are read; a longer span (one split, when the grid
//   already fills the card) streams through the ring;
// - one warp per query row scores a tile (lane = position, 16-byte reads
//   of its K row; the K rows are padded by one 16-byte unit, so the 8
//   lanes of each phase hit distinct banks) and folds it into the online
//   softmax with warp shuffles; for p.V a thread owns one output column
//   of every row of the group;
// - with more than one split each block writes its fp32 partial (acc, m,
//   l) to a workspace from torch.empty (split_combine.cuh has the
//   layout), and paged_decode_combine_kernel, launched by the same C
//   call, merges every row's partials in split order (the result does not
//   depend on the order in which blocks finish, and is the same bits run
//   after run), divides once with the l == 0 → 1 guard and rounds once to
//   q's dtype. The combine is launched as a programmatic dependent of the
//   walk (griddepcontrol.wait before its first read), so its launch
//   overlaps the walk's tail. One split writes the output directly. Both dtypes and
//   both page types take the split; in fp32 it changes only the order of
//   the sums;
// - int8 pages (one kernel template, the page type a parameter): a
//   16-byte copy carries 16 int8 codes, so a D-128 row is 8 copies where
//   bf16 takes 16; each position's two fp32 scales come with 4-byte
//   copies. A code is widened as the TPU kernel does, code x scale in
//   fp32 rounded once to q's dtype, then to fp32 for the dot and p.V:
//   a tile's K codes once, by all the block's threads, into a K tile in
//   q's dtype that the scores then read as the float path reads its
//   pages (widened per query row instead, the scores cost the int8 read
//   a quarter more time); each V code by the thread that owns its
//   column.

#include "common.cuh"
#include "mma.cuh"
#include "split_combine.cuh"

#include <type_traits>

namespace {

using namespace kubeflow;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;      // positions per tile: one per lane
constexpr int kMaxRep = 16;    // largest GQA group (query heads per kv head)

// The dynamic shared memory of one block, byte offsets: the ring of K
// tiles (rows padded by one 16-byte unit), the ring of V tiles, the int8
// scales [stage][k | v][position], the pool row of every ring position,
// the K tile the scores read (int8 pages only: the codes widened to T,
// rows padded likewise), then the fp32 q rows, p, m, l and each tile's
// rescale.
template <typename T, typename P, int D>
struct Smem {
  static constexpr bool kInt8 = std::is_same<P, int8_t>::value;
  using KT = std::conditional_t<kInt8, T, P>;   // the K the scores read
  static constexpr int kVec = vec_width<P>();      // page values a 16-byte unit
  static constexpr int kRowUnits = D / kVec;       // units a K or V row
  static constexpr int kKStride = D + kVec;        // K row stride, elements
  static constexpr int kWStride = D + vec_width<KT>();   // widened K's
  // tiles in flight: a split's whole span at the serving shape (fp32
  // pages take twice the bytes a tile)
  static constexpr int kStages = sizeof(P) == 4 ? 2 : 4;
  static constexpr size_t kKTile = static_cast<size_t>(kTile) * kKStride *
                                   sizeof(P);
  static constexpr size_t kVTile = static_cast<size_t>(kTile) * D *
                                   sizeof(P);
  static constexpr size_t k = 0;
  static constexpr size_t v = k + kStages * kKTile;
  static constexpr size_t scales = v + kStages * kVTile;
  static constexpr size_t rows = scales + kStages * 2 * kTile * sizeof(float);
  static constexpr size_t kw = rows + kStages * kTile * sizeof(int);
  static constexpr size_t q =
      kw + (kInt8 ? static_cast<size_t>(kTile) * kWStride * sizeof(KT) : 0);
  static size_t bytes(int n_rep) {
    return q + (static_cast<size_t>(n_rep) * D + n_rep * kTile + 3 * n_rep) *
                   sizeof(float);
  }
};

// n (a multiple of 4) fp32 values, each exactly a T, stored as T in
// 16-byte words
template <typename T, int n>
__device__ __forceinline__ void store16(T* dst, const float* x) {
  if constexpr (std::is_same<T, float>::value) {
#pragma unroll
    for (int i = 0; i < n; i += 4)
      *reinterpret_cast<float4*>(dst + i) =
          make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
  } else {
#pragma unroll
    for (int i = 0; i < n; i += 8)
      *reinterpret_cast<uint4*>(dst + i) = make_uint4(
          pack_bf16(x[i], x[i + 1]), pack_bf16(x[i + 2], x[i + 3]),
          pack_bf16(x[i + 4], x[i + 5]), pack_bf16(x[i + 6], x[i + 7]));
  }
}

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
                    float* __restrict__ ws,         // splits' partials
                    int kv_heads, int n_rep, int bs, int bps, int splits) {
  using L = Smem<T, P, D>;
  using KT = typename L::KT;
  constexpr bool kInt8 = L::kInt8;
  constexpr int kVec = L::kVec;
  constexpr int kRowUnits = L::kRowUnits;
  constexpr int kKStride = L::kKStride;
  constexpr int kWStride = L::kWStride;
  constexpr int kKtVec = vec_width<KT>();
  constexpr int kStages = L::kStages;
  constexpr int kUnits = kTile * kRowUnits;     // 16-byte units a K tile
  constexpr int kLoads = (kUnits + kThreads - 1) / kThreads;  // per thread
  constexpr bool kEven = kUnits % kThreads == 0;
  // output elements e = tid + j * kThreads of the group's [n_rep, D]
  // block: column tid % D, row e / D
  constexpr int kPer = (kMaxRep * D + kThreads - 1) / kThreads;
  static_assert(kThreads % D == 0, "a thread keeps one output column");
  static_assert(kStages * kTile <= kThreads,
                "one thread looks up one position of the ring");

  extern __shared__ __align__(16) unsigned char smem[];
  P* k_s = reinterpret_cast<P*>(smem + L::k);         // [stage][kTile][kKStride]
  P* v_s = reinterpret_cast<P*>(smem + L::v);         // [stage][kTile][D]
  float* sc_s = reinterpret_cast<float*>(smem + L::scales);
  int* row_s = reinterpret_cast<int*>(smem + L::rows);  // [stage][kTile]
  KT* kw_s = reinterpret_cast<KT*>(smem + L::kw);       // [kTile][kWStride]
  float* q_s = reinterpret_cast<float*>(smem + L::q);   // [n_rep][D]
  float* p_s = q_s + n_rep * D;         // [n_rep][kTile]
  float* m_s = p_s + n_rep * kTile;     // [n_rep] running max
  float* l_s = m_s + n_rep;             // [n_rep] running sum
  float* c_s = l_s + n_rep;             // [n_rep] rescale of this tile

  const int split = blockIdx.x;
  const int kvh = blockIdx.y;
  const int slot = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int H = kv_heads * n_rep;
  const int n_pos = bps * bs;
  const int n_tiles = (n_pos + kTile - 1) / kTile;
  const int t0 = static_cast<int>(static_cast<long long>(split) * n_tiles /
                                  splits);
  const int t1 = static_cast<int>(static_cast<long long>(split + 1) *
                                  n_tiles / splits);
  const int* table = tables + static_cast<size_t>(slot) * bps;
  // ring position tid → its pool row, for the tile `first + tid / kTile`
  // of the span. The table row is readable up to bps whatever the
  // length, so the first lookups go out beside the length's read; only
  // the copies wait for the length (an entry past it may name no page)
  auto lookup = [&](int first, int n_stage) {
    const int i = first + tid / kTile;
    const int pos = (t0 + i) * kTile + tid % kTile;
    if (tid < n_stage * kTile && t0 + i < t1 && pos < n_pos)
      row_s[(i % kStages) * kTile + tid % kTile] = static_cast<int>(
          (static_cast<unsigned>(table[pos / bs]) * bs + pos % bs) *
              kv_heads + kvh);   // unsigned: an entry past the length may
                                 // hold anything
  };
  lookup(0, kStages);
  const int length = min(max(lengths[slot], 0), n_pos);
  const int n_live = max(min(t1, (length + kTile - 1) / kTile) - t0, 0);
  const size_t n_rows = static_cast<size_t>(gridDim.z) * H;
  const size_t row0 = static_cast<size_t>(slot) * H +
                      static_cast<size_t>(kvh) * n_rep;   // the group's first
  // with more than one split: this block's partial in the workspace
  float* part = nullptr;
  float2* part_ml = nullptr;
  if (splits > 1) {
    part = ws + (static_cast<size_t>(split) * n_rows + row0) * D;
    part_ml = reinterpret_cast<float2*>(
                  ws + static_cast<size_t>(splits) * n_rows * D) +
              static_cast<size_t>(split) * n_rows + row0;
  }

  if (n_live == 0) {   // nothing of this slot in the span: read no page
    for (int e = tid; e < n_rep * D; e += kThreads) {
      if (splits == 1)
        out[row0 * D + e] = from_f32<T>(0.f);
      else
        part[e] = 0.f;
    }
    if (splits > 1 && tid < n_rep) part_ml[tid] = make_float2(kNegInf, 0.f);
    return;
  }

  // tile i of the span → ring stage i % kStages, 16-byte copies (int8: and
  // the positions' scales); positions past the length are not read but
  // zero-filled, so p.V may run over them with p = 0
  auto issue = [&](int i) {
    const int st = i % kStages;
    const int base = (t0 + i) * kTile;
    P* kst = k_s + static_cast<size_t>(st) * kTile * kKStride;
    P* vst = v_s + static_cast<size_t>(st) * kTile * D;
#pragma unroll
    for (int j = 0; j < kLoads; ++j) {
      const int u = tid + j * kThreads;
      if (!kEven && u >= kUnits) continue;
      const int t = u / kRowUnits;
      const int c = (u % kRowUnits) * kVec;
      const bool live = base + t < length;
      const size_t at =
          live ? static_cast<size_t>(row_s[st * kTile + t]) * D + c : 0;
      cp_async16(smem_u32(kst + t * kKStride + c), k_pages + at, live);
      cp_async16(smem_u32(vst + t * D + c), v_pages + at, live);
    }
    if constexpr (kInt8) {
      if (tid < kTile) {
        const bool live = base + tid < length;
        const size_t row =
            live ? static_cast<size_t>(row_s[st * kTile + tid]) : 0;
        float* sc = sc_s + st * 2 * kTile;
        cp_async4(smem_u32(sc + tid), k_scales + row, live);
        cp_async4(smem_u32(sc + kTile + tid), v_scales + row, live);
      }
    }
  };

  __syncthreads();   // the first lookups
#pragma unroll
  for (int i = 0; i < kStages; ++i) {   // the whole ring in flight
    if (i < n_live) issue(i);
    cp_async_commit();
  }
  const size_t q_base = row0 * D;
  for (int e = tid; e < n_rep * D; e += kThreads) q_s[e] = to_f32(q[q_base + e]);
  for (int r = tid; r < n_rep; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  const int d_own = tid % D;
  // this thread's output elements: the first n_mine of kPer
  const int n_mine = (n_rep * D - tid + kThreads - 1) / kThreads;
  float acc[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) acc[j] = 0.f;

  for (int i = 0; i < n_live; ++i) {
    const int st = i % kStages;
    const int n_tok = min(kTile, length - (t0 + i) * kTile);
    const P* kst = k_s + static_cast<size_t>(st) * kTile * kKStride;
    const P* vst = v_s + static_cast<size_t>(st) * kTile * D;
    const float* sc = sc_s + st * 2 * kTile;
    cp_async_wait<kStages - 1>();   // tile i has landed (this thread's copies)
    __syncthreads();                // ... and every thread's; q_s is loaded

    const KT* kread = reinterpret_cast<const KT*>(kst);
    int kread_stride = kKStride;
    if constexpr (kInt8) {
      // the tile's K codes widened once, by every thread, as the TPU
      // kernel does: (k.astype(f32) * ks).astype(q.dtype)
#pragma unroll
      for (int j = 0; j < kLoads; ++j) {
        const int u = tid + j * kThreads;
        if (!kEven && u >= kUnits) continue;
        const int t = u / kRowUnits;
        const int c = (u % kRowUnits) * kVec;
        float kx[kVec];
        unpack16<P>(load16(kst + t * kKStride + c), kx);
        const float k_scale = sc[t];
#pragma unroll
        for (int x = 0; x < kVec; ++x) kx[x] = round_to<T>(kx[x] * k_scale);
        store16<T, kVec>(kw_s + t * kWStride + c, kx);
      }
      __syncthreads();
      kread = kw_s;
      kread_stride = kWStride;
    }

    // one warp per query row: lane t scores position t of the tile, then
    // the row's online-softmax fold; p is masked explicitly so a masked
    // position adds no mass even while m is still -1e30
    for (int r = warp; r < n_rep; r += kWarps) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
      const float* qr = q_s + r * D;
      const KT* kt = kread + lane * kread_stride;
#pragma unroll
      for (int c = 0; c < D; c += kKtVec) {
        float kx[kKtVec];
        unpack16<KT>(load16(kt + c), kx);
#pragma unroll
        for (int x = 0; x < kKtVec; x += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + c + x);
          s0 += qv.x * kx[x];
          s1 += qv.y * kx[x + 1];
          s2 += qv.z * kx[x + 2];
          s3 += qv.w * kx[x + 3];
        }
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
      if (j >= n_mine) break;
      acc[j] *= c_s[(tid + j * kThreads) / D];
    }
    // four positions a step (p of a position past the length is 0, its
    // V row zero-filled), the positions folded in order
    for (int t = 0; t < n_tok; t += 4) {
      float vv[4];
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        vv[y] = to_f32(vst[(t + y) * D + d_own]);
        if constexpr (kInt8) vv[y] = round_to<T>(vv[y] * sc[kTile + t + y]);
      }
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        if (j >= n_mine) break;
        const float4 p = *reinterpret_cast<const float4*>(
            p_s + ((tid + j * kThreads) / D) * kTile + t);
        acc[j] += p.x * vv[0];
        acc[j] += p.y * vv[1];
        acc[j] += p.z * vv[2];
        acc[j] += p.w * vv[3];
      }
    }
    __syncthreads();   // stage st, p_s and c_s are free again

    if (i + kStages < n_live) {   // a long span: refill the stage just read
      lookup(i + kStages, 1);
      __syncthreads();
      issue(i + kStages);
    }
    cp_async_commit();
  }

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j >= n_mine) break;
    const int e = tid + j * kThreads;
    if (splits == 1) {   // the whole walk: normalise, round once, store
      const float l = l_s[e / D];
      out[q_base + e] = from_f32<T>(acc[j] / (l == 0.f ? 1.f : l));
    } else {             // this split's partial, for the combine
      part[e] = acc[j];
    }
  }
  if (splits > 1 && tid < n_rep)
    part_ml[tid] = make_float2(m_s[tid], l_s[tid]);
}

// The splits' partials of every row (slot, head) → out, one warp a row
// (split_combine.cuh: in split order, one division, one rounding to T).
// K1's rows are K2's combine rows with one chunk position. Launched as a
// programmatic dependent of the walk: it first waits for the walk to end.
template <typename T, int D>
__global__ void __launch_bounds__(128)
paged_decode_combine_kernel(const float* __restrict__ ws,
                            T* __restrict__ out,   // [S, H, D]
                            int n_rows, int splits) {
  asm volatile("griddepcontrol.wait;" ::: "memory");
  const int row = blockIdx.x * 4 + threadIdx.x / 32;
  if (row >= n_rows) return;
  combine_split_row<T, D>(ws, n_rows, row, splits, threadIdx.x % 32,
                          out + static_cast<size_t>(row) * D);
}

struct Args {
  const void *q, *k, *v, *ks, *vs, *tables, *lengths;
  void *out, *ws;
  int slots, kv_heads, n_rep, bs, bps, splits;
};

template <typename T, typename P, int D>
int launch(const Args& a, cudaStream_t stream) {
  using L = Smem<T, P, D>;
  static bool attribute_set = false;   // once per instantiation
  if (!attribute_set) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel<T, P, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(L::bytes(kMaxRep)));
    if (err != cudaSuccess) return static_cast<int>(err);
    attribute_set = true;
  }
  paged_decode_kernel<T, P, D>
      <<<dim3(a.splits, a.kv_heads, a.slots), kThreads, L::bytes(a.n_rep),
         stream>>>(
          static_cast<const T*>(a.q), static_cast<const P*>(a.k),
          static_cast<const P*>(a.v), static_cast<const float*>(a.ks),
          static_cast<const float*>(a.vs), static_cast<const int*>(a.tables),
          static_cast<const int*>(a.lengths), static_cast<T*>(a.out),
          static_cast<float*>(a.ws), a.kv_heads, a.n_rep, a.bs, a.bps,
          a.splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || a.splits == 1) return static_cast<int>(err);
  // the combine, launched as a programmatic dependent of the walk: its
  // launch overlaps the walk's tail, and it waits for the walk's end
  // (and its partials) before it reads the workspace
  const int n_rows = a.slots * a.kv_heads * a.n_rep;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((n_rows + 3) / 4);
  cfg.blockDim = dim3(128);
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaLaunchKernelEx(
      &cfg, paged_decode_combine_kernel<T, D>,
      static_cast<const float*>(a.ws), static_cast<T*>(a.out), n_rows,
      a.splits));
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
      a.bps < 1 || a.slots < 0 || a.slots > 65535 || a.kv_heads > 65535 ||
      a.splits < 1 || (a.splits > 1 && a.ws == nullptr))
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
// must be 16-byte aligned. splits: the key walk's splits; ws: the
// workspace of their partials, fp32 [splits x rows x (head_dim + 2)]
// with rows = slots x kv_heads x n_rep (null for one split); nothing in
// it needs to be zeroed. Returns a cudaError_t (0 = launched).
extern "C" int kubeflow_paged_decode(const void* q, const void* k_pages,
                                     const void* v_pages, const void* tables,
                                     const void* lengths, void* out, void* ws,
                                     int slots, int kv_heads, int n_rep,
                                     int head_dim, int block_size, int bps,
                                     int splits, int dtype, void* stream) {
  const Args a{q, k_pages, v_pages, nullptr, nullptr, tables, lengths, out,
               ws, slots, kv_heads, n_rep, block_size, bps, splits};
  return run(false, a, head_dim, dtype, stream);
}

// K1-i8: int8 k/v pages [N, bs, kv_heads, D] with fp32 scales
// [N, bs, kv_heads, 1]; otherwise as kubeflow_paged_decode.
extern "C" int kubeflow_paged_decode_i8(
    const void* q, const void* k_pages, const void* v_pages,
    const void* k_scales, const void* v_scales, const void* tables,
    const void* lengths, void* out, void* ws, int slots, int kv_heads,
    int n_rep, int head_dim, int block_size, int bps, int splits, int dtype,
    void* stream) {
  const Args a{q, k_pages, v_pages, k_scales, v_scales, tables, lengths, out,
               ws, slots, kv_heads, n_rep, block_size, bps, splits};
  return run(true, a, head_dim, dtype, stream);
}
