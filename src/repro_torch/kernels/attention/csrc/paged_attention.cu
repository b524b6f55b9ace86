// Paged attention over the serve engine's block pool, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package:
//   paged_decode  <- src/repro/kernels/attention/paged.py: paged_decode_fwd
//                    (_paged_decode_kernel): one query token per slot.
//   paged_span    <- src/repro/kernels/attention/paged.py: paged_span_fwd
//                    (_paged_span_kernel): ragged multi-query rows (the
//                    unified serve step's prefill chunks), GQA folded as
//                    row j*G+g.
//
// Bound.  Both are memory-bound at the serve shapes (G = 4 query rows per
// kv head for decode, 32*4 folded rows for a 32-token chunk, D = 128,
// block size 16): every K/V block a row attends is read once per kv head,
// ~2*D*4 flops per folded row per key against 2*D*2 bytes of bf16 K+V per
// key, far below the ~295 flop/byte the H100 needs before compute binds.
// The least time is (K/V bytes of the attended blocks + q + out) /
// 3.35 TB/s.
//
// Design.
//   * The pool is read IN PLACE in the engine layout [NB, bs, Hkv, D]
//     through its strides: no head-major copy of the pool per call (the
//     JAX wrapper transposes the whole pool; on the card that would cost
//     the pool's size, not the tokens attended, on every call).
//   * One CTA per (slot|row, kv head[, tile of 16 folded query rows]).  The
//     CTA loads its own block-table row and index/start/len (the TPU's
//     scalar-prefetched SMEM tables), and walks the table in a loop that
//     replaces the TPU's sequential W grid axis.  Only the table entries
//     between the first in-window block and the block of the row's last
//     query position are visited, and NULL entries (block 0) among them
//     are skipped, so no byte of a future, out-of-window or NULL block is
//     read.  Culling is per ROW: a row's result does not depend on the
//     tile it lands in.
//   * A CTA has few blocks of its own to walk (a decode slot owns one
//     (slot, kv head) chain), so what bounds it is memory latency, not
//     bandwidth: a 4-stage ring of cp.async copies keeps the next three
//     K/V blocks in flight while the current one is scored from shared
//     memory.
//   * Each warp keeps the online softmax (m, l, acc) of its query rows in
//     registers, a lane owning D/32 head dims, and scores 8 keys at a
//     time so their warp reductions overlap instead of serialising.
//   * f32 math throughout; q is scaled by 1/sqrt(D) in f32 before the
//     dot; the output is written in q's dtype after acc / max(l, 1e-30).
//   * A span row with row_len == 0 writes zeros.
// Not yet: split-K over long tables (decode has only B*Hkv CTAs), tensor
// cores (wgmma) for the span's 16-row tiles, TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "common.cuh"

namespace {

constexpr int kKeys = 8;     // keys scored together; block_size % kKeys == 0
constexpr int kStages = 4;   // K/V blocks in flight per CTA

using repro::from_f;
using repro::to_f;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

struct Pool {
  long long k_blk, k_pos, k_head;  // element strides of the K leaf
  long long v_blk, v_pos, v_head;  // element strides of the V leaf
};

// Online-softmax attention of folded query rows [r0, r1) of row b, kv head
// kh.  Folded row r is query j = r / G of the row, q head kh*G + r % G, at
// absolute position start + j.  q/out are [B, Q, Hq, D] contiguous.  Warp
// w owns rows r0 + w + i*WARPS, i < RPW.
template <typename T, int D, int WARPS, int RPW>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            const T* __restrict__ kp, const T* __restrict__ vp,
                            const Pool pool, const int* __restrict__ bt_row,
                            int W, int bs, int b, int kh, int Q, int Hq, int G,
                            int r0, int r1, int start, int len, int window,
                            float scale) {
  constexpr int EPT = D / 32;
  constexpr int THREADS = WARPS * 32;
  constexpr int CHUNK = 16 / sizeof(T);  // elements per 16-byte copy
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);  // kStages x {K[bs][D], V[bs][D]}
  const int stage_elems = 2 * bs * D;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;

  float qv[RPW][EPT];
  float acc[RPW][EPT];
  float m[RPW], l[RPW];
  int qpos[RPW];
  long long orow[RPW];
  bool live[RPW];
#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    const int r = r0 + warp + i * WARPS;
    live[i] = r < r1;
    const int j = live[i] ? r / G : 0;
    const int g = live[i] ? r % G : 0;
    orow[i] = ((long long)(b * Q + j) * Hq + kh * G + g) * D;
    qpos[i] = start + j;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) {
      qv[i][e] = live[i] ? to_f(q[orow[i] + e * 32 + lane]) * scale : 0.f;
      acc[i][e] = 0.f;
    }
  }

  // table entries [w_lo, w_hi]: in the window of the row's first query,
  // at or before the row's last query position
  const int last = start + len - 1;
  const int w_hi = min(W - 1, last / bs);
  int w_lo = 0;
  if (window > 0 && start - window - bs + 1 >= 0) w_lo = (start - window - bs + 1) / bs + 1;
  const int n = w_hi - w_lo + 1;

  auto issue = [&](int it) {  // stage the it-th visited block (async)
    if (it < n) {
      const int blk = bt_row[w_lo + it];
      if (blk != 0) {
        T* ks = smem + (it % kStages) * stage_elems;
        T* vs = ks + bs * D;
        const T* kb = kp + (long long)blk * pool.k_blk + (long long)kh * pool.k_head;
        const T* vb = vp + (long long)blk * pool.v_blk + (long long)kh * pool.v_head;
        for (int c = threadIdx.x * CHUNK; c < bs * D; c += THREADS * CHUNK) {
          const int t = c / D, d = c % D;
          cp_async16(ks + c, kb + t * pool.k_pos + d);
          cp_async16(vs + c, vb + t * pool.v_pos + d);
        }
      }
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < n; ++it) {
    issue(it + kStages - 1);
    cp_async_wait<kStages - 1>();  // block `it` has landed
    __syncthreads();
    const int w = w_lo + it;
    if (bt_row[w] != 0) {  // NULL block: padding, never attended
      const T* ks = smem + (it % kStages) * stage_elems;
      const T* vs = ks + bs * D;
      const int k_lo = w * bs;
#pragma unroll
      for (int i = 0; i < RPW; ++i) {
        if (!live[i]) continue;  // warp-uniform
        for (int t0 = 0; t0 < bs; t0 += kKeys) {
          float s[kKeys];
#pragma unroll
          for (int u = 0; u < kKeys; ++u) {
            float part = 0.f;
#pragma unroll
            for (int e = 0; e < EPT; ++e)
              part += qv[i][e] * to_f(ks[(t0 + u) * D + e * 32 + lane]);
            s[u] = part;
          }
#pragma unroll
          for (int o = 16; o > 0; o >>= 1) {
#pragma unroll
            for (int u = 0; u < kKeys; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], o);
          }
          float mx = m[i];
#pragma unroll
          for (int u = 0; u < kKeys; ++u) {
            const int kpos = k_lo + t0 + u;
            const bool ok = kpos <= qpos[i] && (window <= 0 || kpos > qpos[i] - window);
            s[u] = ok ? s[u] : -INFINITY;
            mx = fmaxf(mx, s[u]);
          }
          if (mx == -INFINITY) continue;  // no valid key yet (warp-uniform)
          const float corr = expf(m[i] - mx);  // 0 while m is still -inf
          float psum = 0.f;
#pragma unroll
          for (int u = 0; u < kKeys; ++u) {
            s[u] = expf(s[u] - mx);  // masked keys: exp(-inf) = 0
            psum += s[u];
          }
          l[i] = l[i] * corr + psum;
#pragma unroll
          for (int e = 0; e < EPT; ++e) {
            float a = acc[i][e] * corr;
#pragma unroll
            for (int u = 0; u < kKeys; ++u)
              a += s[u] * to_f(vs[(t0 + u) * D + e * 32 + lane]);
            acc[i][e] = a;
          }
          m[i] = mx;
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < RPW; ++i) {
    if (!live[i]) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPT; ++e) out[orow[i] + e * 32 + lane] = from_f<T>(acc[i][e] * inv);
  }
}

// decode: 4 warps x 4 rows covers a GQA group of up to 16 q heads
constexpr int kDecodeWarps = 4, kDecodeRows = 4;
// span: 8 warps x 2 rows = 16 folded query rows per CTA
constexpr int kSpanWarps = 8, kSpanRows = 2;
constexpr int kSpanTile = kSpanWarps * kSpanRows;

template <typename T, int D>
__global__ void __launch_bounds__(kDecodeWarps * 32)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                    const T* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ index, T* __restrict__ out,
                    int Hq, int G, int W, int bs, Pool pool, int window,
                    float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  attend_rows<T, D, kDecodeWarps, kDecodeRows>(
      q, out, kp, vp, pool, bt + (long long)b * W, W, bs, b, kh, /*Q=*/1, Hq,
      G, 0, G, index[b], /*len=*/1, window, scale);
}

template <typename T, int D>
__global__ void __launch_bounds__(kSpanWarps * 32)
paged_span_kernel(const T* __restrict__ q, const T* __restrict__ kp,
                  const T* __restrict__ vp, const int* __restrict__ bt,
                  const int* __restrict__ row_start, const int* __restrict__ row_len,
                  T* __restrict__ out, int Q, int Hq, int G, int W, int bs,
                  Pool pool, int window, float scale) {
  const int b = blockIdx.x, kh = blockIdx.y;
  const int r0 = blockIdx.z * kSpanTile;
  const int r1 = min(r0 + kSpanTile, Q * G);
  const int len = row_len[b];
  if (len <= 0) {  // empty row: zeros, never NaN
    for (int r = r0 + (threadIdx.x >> 5); r < r1; r += kSpanWarps) {
      const long long o = ((long long)(b * Q + r / G) * Hq + kh * G + r % G) * D;
      for (int d = threadIdx.x & 31; d < D; d += 32) out[o + d] = from_f<T>(0.f);
    }
    return;
  }
  attend_rows<T, D, kSpanWarps, kSpanRows>(
      q, out, kp, vp, pool, bt + (long long)b * W, W, bs, b, kh, Q, Hq, G, r0,
      r1, row_start[b], len, window, scale);
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

template <typename T, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* bt, const int* index, void* out, int B,
                          int Hq, int Hkv, int W, int bs, Pool pool, int window,
                          float scale, cudaStream_t s) {
  const size_t smem = (size_t)kStages * 2 * bs * D * sizeof(T);
  const cudaError_t err = allow_smem(paged_decode_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, D><<<dim3(B, Hkv), kDecodeWarps * 32, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, bt, index, (T*)out, Hq, Hq / Hkv,
      W, bs, pool, window, scale);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_span(const void* q, const void* k, const void* v,
                        const int* bt, const int* row_start, const int* row_len,
                        void* out, int B, int Q, int Hq, int Hkv, int W, int bs,
                        Pool pool, int window, float scale, cudaStream_t s) {
  const int G = Hq / Hkv;
  const size_t smem = (size_t)kStages * 2 * bs * D * sizeof(T);
  const cudaError_t err = allow_smem(paged_span_kernel<T, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, Hkv, (Q * G + kSpanTile - 1) / kSpanTile);
  paged_span_kernel<T, D><<<grid, kSpanWarps * 32, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, bt, row_start, row_len, (T*)out,
      Q, Hq, G, W, bs, pool, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0: no sliding window.
// Strides are in elements.  Returns the launch's cudaError_t (0 = ok; -1
// for an unsupported dtype/head_dim, which the Python wrapper rejects
// before calling).
extern "C" int paged_decode_launch(const void* q, const void* k, const void* v,
                                   const int* bt, const int* index, void* out,
                                   int dtype, int B, int Hq, int Hkv, int D,
                                   int W, int bs, long long k_blk,
                                   long long k_pos, long long k_head,
                                   long long v_blk, long long v_pos,
                                   long long v_head, int window, float scale,
                                   void* stream) {
  const Pool pool{k_blk, k_pos, k_head, v_blk, v_pos, v_head};
  REPRO_DISPATCH(dtype, D, launch_decode, q, k, v, bt, index, out, B, Hq, Hkv,
                 W, bs, pool, window, scale, (cudaStream_t)stream);
}

extern "C" int paged_span_launch(const void* q, const void* k, const void* v,
                                 const int* bt, const int* row_start,
                                 const int* row_len, void* out, int dtype,
                                 int B, int Q, int Hq, int Hkv, int D, int W,
                                 int bs, long long k_blk, long long k_pos,
                                 long long k_head, long long v_blk,
                                 long long v_pos, long long v_head, int window,
                                 float scale, void* stream) {
  const Pool pool{k_blk, k_pos, k_head, v_blk, v_pos, v_head};
  REPRO_DISPATCH(dtype, D, launch_span, q, k, v, bt, row_start, row_len, out,
                 B, Q, Hq, Hkv, W, bs, pool, window, scale, (cudaStream_t)stream);
}
