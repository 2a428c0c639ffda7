// Tensor-core building blocks of the port's bf16 kernels (sm_80 and up,
// built for sm_90a): ldmatrix, mma.sync m16n8k16 with bf16 operands and
// fp32 accumulators, cp.async with zero fill, and the repack of fp32
// accumulators into bf16 A fragments.
//
// Fragment layout of mma.m16n8k16 (lane = 4 * g + t, g = lane / 4,
// t = lane % 4), each register two bf16 with the lower index in the low
// half:
//   A (16 x 16, row-major)  a0 (g, 2t..2t+1)      a1 (g + 8, 2t..2t+1)
//                           a2 (g, 2t+8..2t+9)    a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, k x n)       b0 (k 2t..2t+1, n g)  b1 (k 2t+8..2t+9, n g)
//   C (16 x 8, fp32)        c0, c1 (g, 2t..2t+1)  c2, c3 (g + 8, 2t..2t+1)
// A C fragment of columns 16i..16i+15 (two n-blocks) is therefore, once
// rounded pairwise to bf16, the A fragment of the k-slice i of the next
// product (pack_a): P = softmax(S) goes from the S accumulators into
// P.V without leaving the registers.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace kubeflow {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of
// matrix i (16 bytes each, 16-byte aligned); register i holds matrix i,
// lane l its row l / 4, elements 2(l % 4) and 2(l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// The same, each matrix transposed: lane l holds column l / 4, rows
// 2(l % 4) and 2(l % 4) + 1.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
      "{%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a b on the tensor cores: bf16 operands, exact products, fp32 sums.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16 bytes global -> shared, bypassing L1; with valid false nothing is
// read and the 16 bytes land as zeros (src must still be a mapped
// address: pass a clamped one).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

// 4 bytes global -> shared (for rows of fp32 statistics, which need not
// be 16-byte aligned), zero when not valid.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  const int n = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// two fp32 rounded to nearest even into one bf16x2 word, lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of k-slice i from the C fragments c[2i] and c[2i + 1]
// of a 16-row product, each value rounded once to bf16.
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&lo)[4],
                                       const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

}  // namespace kubeflow
