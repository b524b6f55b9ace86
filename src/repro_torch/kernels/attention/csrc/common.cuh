// Helpers shared by the port's CUDA sources: f32 <-> element conversions
// for the two dtypes the kernels take, and the dtype x head_dim dispatch
// of a templated launcher from a plain C entry point.
#pragma once

#include <cuda_bf16.h>

namespace repro {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace repro

// dtype 0 = float32, 1 = bfloat16; head dims 32/64/128/256.  Returns
// FN<T, D>(...)'s cudaError_t as an int, or -1 for anything else (the
// Python wrappers reject those before calling).
#define REPRO_DISPATCH(DTYPE, D, FN, ...)                                     \
  do {                                                                        \
    if (DTYPE == 0) {                                                         \
      switch (D) {                                                            \
        case 32: return (int)FN<float, 32>(__VA_ARGS__);                      \
        case 64: return (int)FN<float, 64>(__VA_ARGS__);                      \
        case 128: return (int)FN<float, 128>(__VA_ARGS__);                    \
        case 256: return (int)FN<float, 256>(__VA_ARGS__);                    \
      }                                                                       \
    } else if (DTYPE == 1) {                                                  \
      switch (D) {                                                            \
        case 32: return (int)FN<__nv_bfloat16, 32>(__VA_ARGS__);              \
        case 64: return (int)FN<__nv_bfloat16, 64>(__VA_ARGS__);              \
        case 128: return (int)FN<__nv_bfloat16, 128>(__VA_ARGS__);            \
        case 256: return (int)FN<__nv_bfloat16, 256>(__VA_ARGS__);            \
      }                                                                       \
    }                                                                         \
    return -1;                                                                \
  } while (0)
