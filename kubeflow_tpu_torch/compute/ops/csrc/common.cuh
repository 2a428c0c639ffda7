// Shared helpers of the port's kernels: dtype conversion and 16-byte
// vector loads (4 floats, 8 bfloat16 values or 16 int8 codes per load).
#pragma once

#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace kubeflow {

constexpr float kNegInf = -1e30f;   // the JAX package's NEG_INF

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {   // exact
  return static_cast<float>(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

// x rounded to T and widened back (the TPU kernels' p.astype(dt))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// elements of T in one 16-byte load
template <typename T> __host__ __device__ constexpr int vec_width() {
  return 16 / static_cast<int>(sizeof(T));
}

__device__ __forceinline__ uint4 load16(const void* p) {
  return *static_cast<const uint4*>(p);
}

// the vec_width<T>() values held in a 16-byte word, widened to fp32
template <typename T>
__device__ __forceinline__ void unpack16(const uint4& w, float* out) {
  const T* v = reinterpret_cast<const T*>(&w);
#pragma unroll
  for (int i = 0; i < vec_width<T>(); ++i) out[i] = to_f32(v[i]);
}

}  // namespace kubeflow
