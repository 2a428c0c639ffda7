// Hopper's warpgroup matrix multiply (wgmma, sm_90a only): the shared-
// memory matrix descriptor for bf16 tiles in the 128-byte swizzle, the
// fences and groups around wgmma.mma_async, and m64n128k16 with bf16
// operands, fp32 accumulators and each operand K-major or MN-major
// ("transposed", which bf16 allows). K7 takes both operands MN-major, K6
// takes A K-major and B MN-major (or K-major when it reads w^T).
//
// Both layouts store a tile as 1024-byte aligned atoms of 8 rows of 128
// bytes, the 16-byte chunk c of row r at chunk c ^ (r % 8) of the row (the
// swizzle the hardware undoes from the address bits [7, 10)).
// - MN-major: a row holds 64 MN-elements of one K index; an atom column
//   is 64 MN-elements wide and as many rows deep as the tile has K
//   indices. In the descriptor, LBO is the byte step between atoms along
//   MN and SBO the byte step between groups of 8 K rows (1024 bytes); an
//   m64n128k16 reads 2 such groups, and the next k16 slice starts 2048
//   bytes further on.
// - K-major: a row holds 64 K-elements of one MN index, rows stacked
//   along MN. SBO is the byte step between groups of 8 MN rows (1024
//   bytes); LBO is unused for a swizzled K-major operand (encoded as 1).
//   The next k16 slice starts 32 bytes further along the row.
//
// Accumulators of m64nNk16 (fp32), thread i of the warpgroup, warp
// w = i / 32, lane = 4 g + t: d[4 j + e] is row 16 w + g (e < 2) or
// 16 w + g + 8 (e >= 2), column 8 j + 2 t + (e % 2) — mma.sync's C
// fragment (mma.cuh), one per n-block of 8 columns.
#pragma once

#include <cstdint>

namespace kubeflow {

// the descriptor of an operand tile at shared address addr (1024-byte
// aligned atoms), 128-byte swizzle; lbo and sbo in bytes
__device__ __forceinline__ uint64_t wgmma_desc_sw128(uint32_t addr,
                                                     uint32_t lbo,
                                                     uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         static_cast<uint64_t>(lbo >> 4) << 16 |
         static_cast<uint64_t>(sbo >> 4) << 32 |
         static_cast<uint64_t>(1) << 62;   // layout type 1: 128-byte swizzle
}

// shared-memory writes of this thread (st.shared, cp.async) made visible
// to the async proxy that wgmma reads through; then a barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// the compiler may not move reads or writes of d across this point (nor
// copy the accumulators to other registers between products, which would
// serialize them)
template <int N>
__device__ __forceinline__ void wgmma_fence_operand(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d = A B + (accumulate ? d : 0) on the tensor cores, A 64 x 16 and B
// 16 x 128, both bf16 in shared memory (descriptors a, b), d fp32 (64 a
// thread). TRANS_A / TRANS_B: 1 when that operand is MN-major, 0 when it
// is K-major.
template <int TRANS_A, int TRANS_B>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b,
                                                 bool accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(static_cast<int>(accumulate)), "n"(TRANS_A),
        "n"(TRANS_B));
}

}  // namespace kubeflow
