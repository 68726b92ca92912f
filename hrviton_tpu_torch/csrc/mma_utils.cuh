// Small device helpers shared by the package's kernels: conversions and
// rounding through the compute dtype.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hv {

typedef __nv_bfloat16 bf;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// round through the compute dtype
template <typename T> __device__ __forceinline__ float rt(float v) { return to_f(from_f<T>(v)); }

}  // namespace hv
