// Helpers shared by the port's CUDA sources: f32 <-> element conversions
// for the two dtypes the kernels take (and the quantized KV pool's int8 /
// fp8 e4m3 codes, read only); the cp.async copies, the ldmatrix loads,
// the bf16 mma.sync and the hi/lo bf16 split of the tensor-core bodies
// (paged span, flash); the SFU's exp2; programmatic dependent launch; the
// dynamic shared-memory opt-in of a launcher; and the dtype x head_dim
// dispatch of a templated launcher from a plain C entry point.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace repro {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }
// e4m3 -> f32 through the hardware cvt (e4m3 -> f16, exact) on sm_89+
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 x) { return static_cast<float>(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// asynchronous global -> shared copies (cp.async), committed and waited
// on in groups: wait<N> returns once at most N groups are in flight
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the tensor-core path: ldmatrix of 8x8 b16 tiles from shared memory and
// the bf16 mma.sync with f32 accumulation
__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void ldsm_x4(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(const void* p, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}
// (x, y) = hi + lo as two bf16 pairs, |x - hi - lo| <= 2^-16 |x|
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = as_u32(h);
  lo = as_u32(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// 2^x on the SFU: ex2.approx.ftz, ~2^-22 relative error, 2^-inf = 0 (a
// result below 2^-126 flushes to 0: a weight that adds nothing to l)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// programmatic dependent launch (sm_90): a grid lets the kernel launched
// after it with programmatic stream serialization be scheduled early, and
// that kernel waits for the earlier grid's completion and memory
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// lets `kernel` take `smem` bytes of dynamic shared memory (above 48 KB
// only when asked for); call before its first launch
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
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
