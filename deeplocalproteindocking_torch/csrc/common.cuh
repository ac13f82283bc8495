// Shared helpers for the hand-written Hopper kernels of the torch port.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace dlpd {

// Operand element types the kernels take, as passed from Python.
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// One element read through the read-only data cache, as float32.
__device__ __forceinline__ float ldg_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float ldg_f32(const __nv_bfloat16* p) {
  return __bfloat162float(
      __ushort_as_bfloat16(__ldg(reinterpret_cast<const unsigned short*>(p))));
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
// Round to nearest even, as torch's .to(bfloat16) and XLA's astype do.
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

}  // namespace dlpd
