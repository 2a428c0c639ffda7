// The merge of a split key walk's partials (flash-decoding), shared by K1
// (paged_decode.cu) and K2 (paged_chunk.cu). Each keeps its own
// __global__ wrapper, named after its kernel, so a profile tells the two
// apart; the arithmetic is this one function.
//
// Workspace (fp32, from torch.empty, nothing zeroed): for split i and
// query row r of n_rows, the unnormalised accumulator at
// ws[(i * n_rows + r) * D], D values, and after all splits' accumulators
// the pair (m, l) at ws[splits * n_rows * D + 2 * (i * n_rows + r)]. A
// split that saw no key leaves m = -1e30, l = 0 and a zero accumulator.
#pragma once

#include "common.cuh"

namespace kubeflow {

// Row `row` of the workspace → dst[0, D), by one warp (lane owns D / 32
// consecutive values): the splits in split order (the result does not
// depend on which block finished first), each scaled by
// exp(m_i - m_max), one division with the l == 0 → 1 guard, one rounding
// to T.
template <typename T, int D>
__device__ __forceinline__ void combine_split_row(const float* __restrict__ ws,
                                                  int n_rows, int row,
                                                  int splits, int lane,
                                                  T* __restrict__ dst) {
  constexpr int kPer = D / 32;   // values a lane
  const float2* ml =
      reinterpret_cast<const float2*>(ws + static_cast<size_t>(splits) *
                                               n_rows * D);
  float m_max = kNegInf;
  for (int i = 0; i < splits; ++i)
    m_max = fmaxf(m_max, ml[static_cast<size_t>(i) * n_rows + row].x);
  float acc[kPer], l = 0.f;
#pragma unroll
  for (int e = 0; e < kPer; ++e) acc[e] = 0.f;
  for (int i = 0; i < splits; ++i) {
    const size_t at = static_cast<size_t>(i) * n_rows + row;
    const float2 part = ml[at];
    const float w = expf(part.x - m_max);
    l += w * part.y;
    const float* a = ws + at * D + lane * kPer;
#pragma unroll
    for (int e = 0; e < kPer; ++e) acc[e] += w * a[e];
  }
  const float inv = 1.f / (l == 0.f ? 1.f : l);
  dst += lane * kPer;
#pragma unroll
  for (int e = 0; e < kPer; ++e) dst[e] = from_f32<T>(acc[e] * inv);
}

}  // namespace kubeflow
