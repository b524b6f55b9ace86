// Dense flash-attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   flash_attention  <- src/repro/kernels/attention/flash.py:
//                       flash_attention_fwd (_flash_fwd_kernel): causal /
//                       sliding-window / bidirectional GQA attention with an
//                       online softmax and a query offset (prefix-hit tail
//                       prefill: queries sit at q_offset + i, keys at j).
//
// Bound.  At the serve shapes (granite-8b prefill: Hq 32, Hkv 8, D 128,
// bf16, a few hundred tokens) the least time is set by bytes: q, k, v and
// out are read or written once (~2 MiB for a 512-token prompt), while the
// causal products are ~4 GFLOP, under 5 us at the bf16 tensor-core peak.
// This first version multiplies with f32 FMAs on the CUDA cores, so what
// bounds it in practice is the FMA and shared-memory issue rate, not the
// memory: tensor cores (mma.sync / wgmma) and TMA are later work.
//
// Design.
//   * q, k, v are read IN PLACE in the model layout [B, S, H, D] through
//     their strides (unit stride on D): no head-major transpose or padded
//     copy per call, unlike the JAX wrapper (ops.py swapaxes + pad).
//   * One CTA per (q tile of 64 rows, q head, batch).  GQA is the kernel's
//     own indexing: kv head = h / G, as in the TPU kernel's index map; K/V
//     are never repeated in memory.  Tiles are launched longest-first
//     (the last causal tile attends the most keys).
//   * True lengths: Sq and Skv are the real lengths and the ragged tails
//     are masked in the kernel (the JAX kernel is handed lengths padded to
//     its 128 block, which differs for a non-causal call with a ragged Skv).
//   * Culling: the CTA loops only over the 64-key tiles between the first
//     key in the window of its first query and the last key its last query
//     may see (causal) or Skv, the bounds of flash.py's block culling.
//   * Numerics as the TPU kernel: q, k, v upcast to f32, q scaled by
//     1/sqrt(D) before the dot, online softmax (m, l, acc) in f32, p not
//     rounded before P.V, out = acc / max(l, 1e-30) cast to q's dtype.  A
//     different key-tile size changes the summation order, so agreement
//     with the TPU kernel is a tolerance, not bit equality.
//   * Shared memory per CTA: q tile as f32 (pre-scaled, transposed), the K
//     tile transposed and the V tile natural in the input dtype, and the
//     64x64 softmax weights transposed; each thread owns 4 query rows
//     (ty + 16 i) x 8 keys (tx * 8 + j) of the scores and 4 rows x D/8
//     output columns, so the inner loops read shared memory with 16-byte
//     loads that are broadcast across the rows of a warp.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 16 row groups (ty) x 8 column lanes (tx)
constexpr int kBM = 64;        // query rows per CTA
constexpr int kBN = 64;        // keys per tile
constexpr int kRM = kBM / 16;  // query rows per thread: ty + 16 i

using repro::from_f;
using repro::to_f;

// N consecutive elements of type T from shared memory aligned to their
// size (16 or 8 bytes a load), widened to f32
template <typename T, int N>
__device__ __forceinline__ void load_f32(const T* p, float (&o)[N]) {
  using V = typename std::conditional<(N * sizeof(T)) % 16 == 0, uint4, uint2>::type;
  constexpr int CH = sizeof(V) / sizeof(T);
  static_assert(N % CH == 0, "whole vector loads");
#pragma unroll
  for (int c = 0; c < N / CH; ++c) {
    const V raw = reinterpret_cast<const V*>(p)[c];
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < CH; ++i) o[c * CH + i] = to_f(e[i]);
  }
}

struct Strides {
  long long b, s, h;  // element strides of a [B, S, H, D] view (d stride 1)
};

template <typename T, int D>
struct Tile {
  static constexpr int CH = 16 / sizeof(T);  // elements per 16-byte copy
  static constexpr int CD = D / 8;           // output columns per thread
  static constexpr int QP = kBM;             // Qt pitch (f32)
  static constexpr int KP = kBN + CH;        // Kt pitch (T), 16-byte rows
  static constexpr int PP = kBM + 1;         // Pt pitch (f32)
  static constexpr size_t q_bytes = sizeof(float) * D * QP;
  static constexpr size_t k_bytes = sizeof(T) * D * KP;
  static constexpr size_t v_bytes = sizeof(T) * kBN * D;
  static constexpr size_t p_bytes = sizeof(float) * kBN * PP;
  static constexpr size_t smem = q_bytes + k_bytes + v_bytes + p_bytes;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, Strides sq,
                 Strides sk, Strides sv, int Sq, int Skv, int Hq, int G,
                 int q_offset, int causal, int window, float scale) {
  using C = Tile<T, D>;
  constexpr int CH = C::CH, CD = C::CD, QP = C::QP, KP = C::KP, PP = C::PP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* Qt = reinterpret_cast<float*>(smem_raw);                    // [D][QP]
  T* Kt = reinterpret_cast<T*>(smem_raw + C::q_bytes);               // [D][KP]
  T* Vs = reinterpret_cast<T*>(smem_raw + C::q_bytes + C::k_bytes);  // [BN][D]
  float* Pt = reinterpret_cast<float*>(smem_raw + C::q_bytes + C::k_bytes +
                                       C::v_bytes);                  // [BN][PP]

  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int h = blockIdx.y, b = blockIdx.z, kh = h / G;
  const int m0 = tile * kBM;
  const int rows = min(kBM, Sq - m0);
  const int t = threadIdx.x, tx = t & 7, ty = t >> 3;

  // keys this tile may attend: [kv_begin, kv_end)
  const int q_lo = q_offset + m0, q_hi = q_offset + m0 + rows - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;

  // stage the q tile: f32, scaled, transposed (consecutive threads take
  // consecutive rows, so the transposed stores do not collide)
  const T* qb = q + b * sq.b + (long long)h * sq.h;
  for (int c = t; c < kBM * (D / CH); c += kThreads) {
    const int m = c % kBM, dc = c / kBM;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (m < rows) raw = __ldg(reinterpret_cast<const uint4*>(qb + (m0 + m) * sq.s + dc * CH));
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < CH; ++i) Qt[(dc * CH + i) * QP + m] = to_f(e[i]) * scale;
  }

  float acc[kRM][CD];
  float m_run[kRM], l_run[kRM];
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  }

  const T* kb = k + b * sk.b + (long long)kh * sk.h;
  const T* vb = v + b * sv.b + (long long)kh * sv.h;
  for (int n0 = kv_begin / kBN * kBN; n0 < kv_end; n0 += kBN) {
    __syncthreads();  // the previous tile's K/V/P reads are done
    const int keys = min(kBN, Skv - n0);
    // K transposed; keys past Skv are zeros (masked below)
    for (int c = t; c < kBN * (D / CH); c += kThreads) {
      const int n = c % kBN, dc = c / kBN;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (n < keys) raw = __ldg(reinterpret_cast<const uint4*>(kb + (n0 + n) * sk.s + dc * CH));
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < CH; ++i) Kt[(dc * CH + i) * KP + n] = e[i];
    }
    // V natural; zero rows past Skv keep p * v finite
    for (int c = t; c < kBN * (D / CH); c += kThreads) {
      const int n = c / (D / CH), dc = c % (D / CH);
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (n < keys) raw = __ldg(reinterpret_cast<const uint4*>(vb + (n0 + n) * sv.s + dc * CH));
      *reinterpret_cast<uint4*>(Vs + n * D + dc * CH) = raw;
    }
    __syncthreads();

    // scores: rows ty + 16 i, keys tx * 8 + j
    float s[kRM][8];
#pragma unroll
    for (int i = 0; i < kRM; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float kv[8];
      load_f32<T, 8>(Kt + d * KP + tx * 8, kv);
      float qv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) qv[i] = Qt[d * QP + ty + 16 * i];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // mask, online softmax; the 8 lanes of a row group share its rows
#pragma unroll
    for (int i = 0; i < kRM; ++i) {
      const int qpos = q_offset + m0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kpos = n0 + tx * 8 + j;
        const bool ok = kpos < Skv && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m_run[i], mx);
      const bool none = m_new == -INFINITY;  // no valid key for this row yet
      const float corr = none ? 1.f : expf(m_run[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = none ? 0.f : expf(s[i][j] - m_new);  // masked: 0
        psum += p;
        Pt[(tx * 8 + j) * PP + ty + 16 * i] = p;
      }
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) psum += __shfl_xor_sync(0xffffffffu, psum, o);
      l_run[i] = l_run[i] * corr + psum;
      m_run[i] = m_new;
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P . V: rows ty + 16 i, output columns tx * CD + c
#pragma unroll 4
    for (int j = 0; j < kBN; ++j) {
      float vv[CD];
      load_f32<T, CD>(Vs + j * D + tx * CD, vv);
      float pv[kRM];
#pragma unroll
      for (int i = 0; i < kRM; ++i) pv[i] = Pt[j * PP + ty + 16 * i];
#pragma unroll
      for (int i = 0; i < kRM; ++i)
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(pv[i], vv[c], acc[i][c]);
    }
  }

  // out is a contiguous [B, Sq, Hq, D] tensor
#pragma unroll
  for (int i = 0; i < kRM; ++i) {
    const int m = ty + 16 * i;
    if (m >= rows) continue;
    const float inv = 1.f / fmaxf(l_run[i], 1e-30f);
    T* o = out + (((long long)b * Sq + m0 + m) * Hq + h) * D + tx * CD;
#pragma unroll
    for (int c = 0; c < CD; ++c) o[c] = from_f<T>(acc[i][c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out,
                         int B, int Sq, int Skv, int Hq, int Hkv, Strides sq,
                         Strides sk, Strides sv, int q_offset, int causal,
                         int window, float scale, cudaStream_t s) {
  const size_t smem = Tile<T, D>::smem;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (B == 0 || Sq == 0) return cudaSuccess;
  const dim3 grid((Sq + kBM - 1) / kBM, Hq, B);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, sv, Sq, Skv, Hq,
      Hq / Hkv, q_offset, causal, window, scale);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  causal: 0/1.  window <= 0: no sliding
// window.  Strides are in elements.  Returns the launch's cudaError_t (0 =
// ok; -1 for an unsupported dtype/head_dim, which the Python wrapper
// rejects before calling).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int Sq, int Skv, int Hq, int Hkv, int D, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int q_offset, int causal,
    int window, float scale, void* stream) {
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh};
  REPRO_DISPATCH(dtype, D, launch_flash, q, k, v, out, B, Sq, Skv, Hq, Hkv, sq,
                 sk, sv, q_offset, causal, window, scale, (cudaStream_t)stream);
}
