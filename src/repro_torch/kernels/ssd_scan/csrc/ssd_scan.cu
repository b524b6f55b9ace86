// Mamba-2 SSD chunked scan forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of the JAX package:
//   ssd_scan  <- src/repro/kernels/ssd_scan/kernel.py: ssd_scan_fwd
//                (_ssd_kernel): for one (batch, head), the chunked SSD
//                algorithm of arXiv:2405.21060 with the f32 state [N, P]
//                carried across the chunks of the sequence:
//                  y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//                         + exp(cum_i) C_i . state
//                  state <- exp(cum_L) state + sum_j exp(cum_L - cum_j) B_j^T dt_j x_j
//                with cum the in-chunk inclusive sum of dt * a, a = -exp(a_log).
//   It computes what the model calls (models/ssm.py ssd_chunked, no
//   initial state): y [B, S, H, P] in x's dtype and the final state
//   [B, H, N, P] in f32.
//
// Bound.  For one prefill prompt at mamba2-370m's widths (H 32, P 64,
// N 128, G 1, bf16, S 512) the least time is set by bytes: x, dt, B, C
// read once and y, the state written once are ~5.4 MB (1.6 us at
// 3.35 TB/s), against ~1.1 GFLOP of the SSD algorithm at chunk 256
// (1.1 us at the bf16 tensor-core peak).  This first version multiplies
// with f32 FMAs on the CUDA cores, so what bounds it in practice is the
// FMA and shared-memory issue rate; tensor cores (mma.sync / wgmma) and
// TMA are later work.
//
// Design.
//   * The TPU grid's sequential chunk axis becomes a loop inside the CTA;
//     the f32 state [N, 16] stays in shared memory across it.
//   * One CTA per (16 columns of P, head, batch): the recurrence is
//     independent per column p, so splitting P gives H * P / 16 CTAs for
//     one prompt (128 at mamba2-370m's widths) instead of H (32) for 132
//     SMs.  Each P tile recomputes the chunk's C B^T.
//   * The kernel picks its own chunk length, kL = 64.  The chunked
//     algorithm computes the same function for every chunk length up to
//     f32 rounding; the config's chunk of 256 would need a 256 x 256 f32
//     score tile alone (256 KB), over the 227 KB a block may use.
//   * Inputs are read IN PLACE in the model layout through their strides:
//     x [B, S, H, P], dt [B, S, H], B and C [B, S, G, N] (unit stride on
//     P and N, 16-byte aligned rows).  Head h reads group h / (H / G) by
//     index; unlike the JAX wrapper (ops.py repeat + pad + transpose)
//     nothing is expanded, padded or transposed in memory.  A chunk's dt,
//     x, B and C are fetched with 16-byte loads, all issued before any is
//     converted: one memory round trip a chunk.
//   * Ragged length: rows past S in the last chunk are dt = 0 identity
//     steps (zero B, C, x, dt; cum stays flat), the semantics of the JAX
//     wrapper's zero padding, without copying padded inputs; their y rows
//     are not stored.
//   * Overflow: on the upper triangle cum_i - cum_j > 0, and at the init's
//     dt * a ~ -1.6 a token, exp of it overflows f32 within a chunk.  The
//     decay is built only where j <= i, by selection (as jnp.where does),
//     never by multiplying an inf with a mask, and exp(cum_i - cum_j) is
//     never factored into exp(cum_i) * exp(-cum_j).  Every other exp has a
//     non-positive argument.
//   * Shared memory per CTA at N = 128 (floats): B and C rows of the chunk
//     2 x 64 x 132 (row stride N + 4 keeps float4 loads aligned and
//     conflict-free), the decay-masked scores 64 x 68, x * dt and
//     x * dt * exp(cum_L - cum_j) 2 x 64 x 16, the state 128 x 16, dt and
//     the two decay vectors 3 x 64: 102,144 bytes (N = 256: 175,872).
//   * Threads: 256 as a 16 x 16 grid.  Scores: rows ty + 16 i x columns
//     tx + 16 j, a 4 x 4 register tile over float4 loads of C and B.  y:
//     column tx, rows ty + 16 i, four independent sums over float4 loads
//     of the scores and of C.  State: column tx, rows 8 ty .. 8 ty + 7
//     (+ 128 k).
//   * Numerics as the TPU kernel: inputs upcast to f32, every product and
//     sum in f32, y rounded once to x's dtype.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kL = 64;         // chunk length the kernel picks
constexpr int kPT = 16;        // state / output columns per CTA
constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxN = 256;
constexpr int kLdS = kL + 4;   // score row stride: float4-aligned rows
constexpr int kLoads = 4;      // 16-byte global loads in flight a thread

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes of T (8 bf16 or 4 f32) widened to f32
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&v);
#pragma unroll
  for (int k = 0; k < 8; ++k) f[k] = __bfloat162float(e[k]);
}
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[4]) {
  f[0] = __uint_as_float(v.x);
  f[1] = __uint_as_float(v.y);
  f[2] = __uint_as_float(v.z);
  f[3] = __uint_as_float(v.w);
}
// 16 bytes of T to 16-byte-aligned shared memory as f32
template <int V>
__device__ __forceinline__ void store_f32(float* dst, const uint4& v) {
  float f[V];
  unpack(v, f);
#pragma unroll
  for (int k = 0; k < V; k += 4)
    *reinterpret_cast<float4*>(dst + k) = make_float4(f[k], f[k + 1], f[k + 2], f[k + 3]);
}

struct Strides {
  long long b, s, h;  // element strides of a [B, S, H(, last)] view, last unit
};

__host__ __device__ constexpr int row_stride(int n) { return n + 4; }

size_t smem_bytes(int n) {
  return sizeof(float) * (2 * kL * row_stride(n) + kL * kLdS + 2 * kL * kPT
                          + n * kPT + 3 * kL);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a_log, const T* __restrict__ bm,
                const T* __restrict__ cm, T* __restrict__ y,
                float* __restrict__ state_out, int S, int H, int P, int G, int N,
                Strides sx, Strides sdt, Strides sb, Strides sc) {
  constexpr int kVec = 16 / sizeof(T);  // elements a 16-byte load
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = row_stride(N);
  float* bs = smem;                    // [kL][ld]   B rows
  float* cs = bs + kL * ld;            // [kL][ld]   C rows
  float* scr = cs + kL * ld;           // [kL][kLdS] decay-masked C B^T
  float* xs = scr + kL * kLdS;         // [kL][kPT]  x * dt
  float* xw = xs + kL * kPT;           // [kL][kPT]  x * dt * exp(cum_L - cum_j)
  float* st = xw + kL * kPT;           // [N][kPT]   state
  float* dts = st + N * kPT;           // [kL]
  float* cum = dts + kL;               // [kL]
  float* wl = cum + kL;                // [kL]       exp(cum_L - cum_j)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int g = h / (H / G);
  const float a = -expf(a_log[h]);

  for (int i = tid; i < N * kPT; i += kThreads) st[i] = 0.f;

  const int nchunks = (S + kL - 1) / kL;
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = c * kL;
    const int lc = min(kL, S - s0);  // rows past lc: dt = 0 identity steps
    __syncthreads();  // the previous chunk is done with every buffer

    // 1. dt, x, B and C of the chunk: every global load issued before any
    //    conversion, 16 bytes a load (a round trip per chunk, not one per
    //    element); x * dt and the B, C rows land in shared memory as f32
    if (tid < kL)
      dts[tid] = tid < lc ? dt[b * sdt.b + (long long)(s0 + tid) * sdt.s + h * sdt.h]
                          : 0.f;
    {
      constexpr int kXV = kPT / kVec;  // x vectors a row
      const int xr = tid / kXV, xv = tid % kXV;
      const bool xl = tid < kL * kXV && xr < lc;
      uint4 xraw = make_uint4(0, 0, 0, 0);
      float xdt = 0.f;
      if (xl) {
        const long long s = s0 + xr;
        xraw = *reinterpret_cast<const uint4*>(
            x + b * sx.b + s * sx.s + h * sx.h + p0 + xv * kVec);
        xdt = dt[b * sdt.b + s * sdt.s + h * sdt.h];
      }
      const int nv = N / kVec;  // B / C vectors a row
      for (int base = tid; base < kL * nv; base += kLoads * kThreads) {
        uint4 rb[kLoads], rc[kLoads];
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int i = base + u * kThreads, r = i / nv;
          rb[u] = rc[u] = make_uint4(0, 0, 0, 0);
          if (i < kL * nv && r < lc) {
            const long long s = s0 + r;
            const int n = (i % nv) * kVec;
            rb[u] = *reinterpret_cast<const uint4*>(bm + b * sb.b + s * sb.s + g * sb.h + n);
            rc[u] = *reinterpret_cast<const uint4*>(cm + b * sc.b + s * sc.s + g * sc.h + n);
          }
        }
#pragma unroll
        for (int u = 0; u < kLoads; ++u) {
          const int i = base + u * kThreads;
          if (i < kL * nv) {
            const int off = (i / nv) * ld + (i % nv) * kVec;
            store_f32<kVec>(bs + off, rb[u]);
            store_f32<kVec>(cs + off, rc[u]);
          }
        }
      }
      if (tid < kL * kXV) {
        float f[kVec];
        unpack(xraw, f);
#pragma unroll
        for (int k = 0; k < kVec; ++k) xs[xr * kPT + xv * kVec + k] = f[k] * xdt;
      }
    }
    __syncthreads();

    // 2. cum = inclusive sum of dt * a (warp 0, two rows a lane) and the
    //    decay to the chunk's end
    if (tid < 32) {
      const int r0 = 2 * tid;
      const float v0 = dts[r0] * a, v1 = dts[r0 + 1] * a;
      const float pair = v0 + v1;
      float inc = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, inc, off);
        if (tid >= off) inc += t;
      }
      const float c0 = (inc - pair) + v0;
      const float last = __shfl_sync(0xffffffffu, inc, 31);
      cum[r0] = c0;
      cum[r0 + 1] = inc;
      wl[r0] = expf(fminf(last - c0, 0.f));
      wl[r0 + 1] = expf(fminf(last - inc, 0.f));
    }
    __syncthreads();

    // 3. scores C_i . B_j, decayed on the lower triangle only (selection:
    //    exp(cum_i - cum_j) may be inf where j > i)
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      for (int n = 0; n < N; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          cv[i] = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * ld + n);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          bv[j] = *reinterpret_cast<const float4*>(bs + (tx + 16 * j) * ld + n);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            acc[i][j] = fmaf(cv[i].x, bv[j].x, acc[i][j]);
            acc[i][j] = fmaf(cv[i].y, bv[j].y, acc[i][j]);
            acc[i][j] = fmaf(cv[i].z, bv[j].z, acc[i][j]);
            acc[i][j] = fmaf(cv[i].w, bv[j].w, acc[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int col = tx + 16 * j;
          scr[r * kLdS + col] =
              col <= r ? acc[i][j] * expf(cum[r] - cum[col]) : 0.f;
        }
      }
    }
    __syncthreads();

    // 4. y = scores . (x dt) + exp(cum_i) C_i . state (the state entering
    //    the chunk), four independent rows a thread; x dt decayed to the
    //    chunk's end for step 5.  Scores are zero above the diagonal, so
    //    the j loop runs to the warp's last row (ty | 1) + 48.
    {
      float yd[4] = {0.f, 0.f, 0.f, 0.f}, yo[4] = {0.f, 0.f, 0.f, 0.f};
      const int jend = ((ty | 1) + 48 + 4) & ~3;
      for (int j = 0; j < jend; j += 4) {
        const float x0 = xs[j * kPT + tx], x1 = xs[(j + 1) * kPT + tx];
        const float x2 = xs[(j + 2) * kPT + tx], x3 = xs[(j + 3) * kPT + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 sv = *reinterpret_cast<const float4*>(scr + (ty + 16 * i) * kLdS + j);
          yd[i] = fmaf(sv.x, x0, fmaf(sv.y, x1, fmaf(sv.z, x2, fmaf(sv.w, x3, yd[i]))));
        }
      }
      for (int n = 0; n < N; n += 4) {
        const float s0v = st[n * kPT + tx], s1v = st[(n + 1) * kPT + tx];
        const float s2v = st[(n + 2) * kPT + tx], s3v = st[(n + 3) * kPT + tx];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 cv = *reinterpret_cast<const float4*>(cs + (ty + 16 * i) * ld + n);
          yo[i] = fmaf(cv.x, s0v, fmaf(cv.y, s1v, fmaf(cv.z, s2v, fmaf(cv.w, s3v, yo[i]))));
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty + 16 * i;
        if (r < lc)
          y[((b * S + s0 + r) * H + h) * P + p0 + tx] = from_f<T>(yd[i] + expf(cum[r]) * yo[i]);
        xw[r * kPT + tx] = xs[r * kPT + tx] * wl[r];
      }
    }
    __syncthreads();

    // 5. state <- exp(cum_L) state + B^T (x dt exp(cum_L - cum_j))
    {
      const float decay = expf(fminf(cum[kL - 1], 0.f));
      for (int n0 = 8 * ty; n0 < N; n0 += 128) {
        float acc[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) acc[k] = decay * st[(n0 + k) * kPT + tx];
        for (int j = 0; j < lc; ++j) {
          const float w = xw[j * kPT + tx];
          const float4 b0 = *reinterpret_cast<const float4*>(bs + j * ld + n0);
          const float4 b1 = *reinterpret_cast<const float4*>(bs + j * ld + n0 + 4);
          acc[0] = fmaf(b0.x, w, acc[0]);
          acc[1] = fmaf(b0.y, w, acc[1]);
          acc[2] = fmaf(b0.z, w, acc[2]);
          acc[3] = fmaf(b0.w, w, acc[3]);
          acc[4] = fmaf(b1.x, w, acc[4]);
          acc[5] = fmaf(b1.y, w, acc[5]);
          acc[6] = fmaf(b1.z, w, acc[6]);
          acc[7] = fmaf(b1.w, w, acc[7]);
        }
#pragma unroll
        for (int k = 0; k < 8; ++k) st[(n0 + k) * kPT + tx] = acc[k];
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < N * kPT; i += kThreads) {
    const int n = i / kPT, p = i % kPT;
    state_out[((b * H + h) * N + n) * P + p0 + p] = st[i];
  }
}

template <typename T>
cudaError_t launch_ssd(const void* x, const void* dt, const void* a_log,
                       const void* bm, const void* cm, void* y, void* state,
                       int B, int S, int H, int P, int G, int N, Strides sx,
                       Strides sdt, Strides sb, Strides sc, cudaStream_t s) {
  const size_t smem = smem_bytes(N);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  if (B == 0 || H == 0) return cudaSuccess;
  const dim3 grid(P / kPT, H, B);
  ssd_scan_kernel<T><<<grid, kThreads, smem, s>>>(
      (const T*)x, (const float*)dt, (const float*)a_log, (const T*)bm,
      (const T*)cm, (T*)y, (float*)state, S, H, P, G, N, sx, sdt, sb, sc);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and a_log are f32,
// the state f32.  Strides are in elements; y [B, S, H, P] and the state
// [B, H, N, P] are contiguous.  Needs P % 16 == 0, N % 8 == 0, N <= 256,
// H % G == 0 (the Python wrapper checks them).  Returns the launch's
// cudaError_t (0 = ok; -1 for what the kernel does not take).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* a_log, const void* bm,
    const void* cm, void* y, void* state, int dtype, int B, int S, int H, int P,
    int G, int N, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, void* stream) {
  if (P % kPT || N % 8 || N > kMaxN || N < 8 || G < 1 || H % G) return -1;
  const Strides sx{x_sb, x_ss, x_sh}, sdt{dt_sb, dt_ss, dt_sh},
      sb{b_sb, b_ss, b_sg}, sc{c_sb, c_ss, c_sg};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_ssd<float>(x, dt, a_log, bm, cm, y, state, B, S, H, P, G,
                                  N, sx, sdt, sb, sc, s);
  if (dtype == 1)
    return (int)launch_ssd<__nv_bfloat16>(x, dt, a_log, bm, cm, y, state, B, S,
                                          H, P, G, N, sx, sdt, sb, sc, s);
  return -1;
}
