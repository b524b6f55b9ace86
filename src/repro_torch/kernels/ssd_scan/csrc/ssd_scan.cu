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
// (1.1 us at the bf16 tensor-core peak).
//
// Two bodies, chosen by dtype in ssd_scan_launch:
//   * bf16: the chunks in parallel across the SMs and the products on the
//     tensor cores, in three kernels (below, "bf16 body");
//   * f32: ssd_scan_kernel<float>, one CTA walking the chunks in sequence
//     with f32 FMAs on the CUDA cores (f32 stays off the tensor cores:
//     their f32 input is TF32).
//
// bf16 body.  The SSD algorithm's chunk / state-pass / output
// decomposition (arXiv:2405.21060), chunk kL = 64, one ctypes call
// enqueueing three kernels, the last two as programmatic dependents of
// the one before (PDL), so each one's prologue overlaps the last one's
// tail:
//   A. ssd_chunk_state_kernel, grid (chunk, head x P tile, batch), 4
//      warps: stages the chunk's B rows (cp.async) and x, warp 0 sums
//      dt * a into cum while the copies are in flight, forms
//      Z = x dt exp(cum_L - cum_j) in f32 and splits it into bf16 hi +
//      lo, then s_local [N, PT] = B^T Z_hi + B^T Z_lo (mma.sync
//      m16n8k16, f32 accumulation; a warp per 16 state rows) into an f32
//      workspace [B, nc, H, N, P], and exp(cum_L) into [B, H, nc].
//   B. ssd_state_pass_kernel, grid (N P / 1024, head, batch), parallel
//      over (batch, head, 4 state elements a thread) and serial over the
//      chunks: entering[c] = exp(cum_L[c-1]) entering[c-1] +
//      s_local[c-1] in f32, in the order of the sequential recurrence,
//      written over s_local[c]; the last sum is the final state.
//   C. ssd_chunk_out_kernel, grid (chunk, head x P tile, batch), 8 warps,
//      two a 16-row tile, each taking half the depth of both products:
//      S = C B^T once per CTA (exact bf16 operands, one pass, only the
//      column tiles at or below the diagonal), M = S exp(cum_i - cum_j)
//      dt_j on the lower triangle by selection, y = M_hi x + M_lo x +
//      exp(cum_i) (C state_hi + C state_lo); the two halves' f32 sums
//      meet in shared memory and y is rounded once to bf16; rows past S
//      are not stored.  Everything before the entering state is read
//      runs before griddepcontrol.wait.
//   Three of the four products have an f32 factor (Z, M, the state),
//   split into bf16 hi + lo (|v - hi - lo| <= 2^-16 |v|), both halves
//   into one f32 accumulator: one bf16 pass alone fails the f64 check
//   (ref.py); C B^T has exact bf16 operands.  N is zero-padded to the
//   mma depth (16) in shared memory; a P tile PT is 64, 32 or 16 (the
//   largest dividing P, from the host plan in scan.py).  bf16 rows are
//   padded by kPad elements so the 8 rows of an ldmatrix fall on 8
//   distinct 16-byte bank groups.
//   What bounds it (tools/ssd_timing.py, PERF.md): each phase is a chain
//   of dependent memory round trips a few microseconds long, on top of
//   the fixed cost of an L2-flushed launch; the f32 chunk states (8 MB
//   at S 512, written by A, read and rewritten by B, read by C) set the
//   slope in S.  4-warp A CTAs and 8-warp C CTAs timed fastest.

// f32 body (ssd_scan_kernel<float>).
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

#include "../../attention/csrc/common.cuh"

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

// 16 bytes of T (4 f32) widened to f32
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

// ---------------------------------------------------------------------
// bf16 body: phases A (chunk states), B (state pass), C (outputs)
// ---------------------------------------------------------------------
using bf16 = __nv_bfloat16;
using repro::allow_smem;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::grid_dependency_wait;
using repro::launch_dependents;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;
using repro::split_bf16;

constexpr int kPad = 8;              // bf16 row padding (ldmatrix banks)
constexpr int kStateThreads = 128;   // phase A: 4 warps
constexpr int kPassThreads = 256;    // phase B
constexpr int kOutThreads = 256;     // phase C: kHalves warps a 16-row tile
constexpr int kHalves = kOutThreads / 32 / (kL / 16);
constexpr int kPassChunks = 8;       // phase B and C: loads in flight

__host__ __device__ constexpr int n_pad(int n) { return (n + 15) / 16 * 16; }

// dynamic shared memory of a phase-A and a phase-C CTA (bytes); the
// Python plan (scan.scan_plan) computes the same
size_t chunk_state_smem(int n, int pt) {
  return 2 * (kL * (n_pad(n) + kPad) + 2 * kL * (pt + kPad)) + 2 * 4 * kL;
}
size_t chunk_out_smem(int n, int pt) {
  return 2 * (2 * kL * (n_pad(n) + kPad) + kL * (pt + kPad)
              + 2 * n_pad(n) * (pt + kPad)) + 4 * kL * (pt + kPad) + 2 * 4 * kL;
}

// warp 0: the chunk's dt (0 past lc: identity steps) and cum, the
// inclusive sum of dt * a, two rows a lane, into shared memory
__device__ __forceinline__ void chunk_cumsum(const float* __restrict__ dt,
                                             long long ds, int lc, float a,
                                             float* dts, float* cum) {
  const int lane = threadIdx.x & 31, r0 = 2 * lane;
  const float d0 = r0 < lc ? dt[r0 * ds] : 0.f;
  const float d1 = r0 + 1 < lc ? dt[(r0 + 1) * ds] : 0.f;
  const float v0 = d0 * a, v1 = d1 * a, pair = v0 + v1;
  float inc = pair;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, inc, off);
    if (lane >= off) inc += t;
  }
  dts[r0] = d0;
  dts[r0 + 1] = d1;
  cum[r0] = (inc - pair) + v0;
  cum[r0 + 1] = inc;
}

// cp.async of `rows` x `cols` bf16 (cols % 8 == 0) from a strided source
// into a [kL][ld] tile; rows past `live` and columns past `cols_live` are
// zeros
__device__ __forceinline__ void stage_rows(bf16* dst, int ld, const bf16* src,
                                           long long rs, int cols, int cols_live,
                                           int live, int threads) {
  const int nv = cols / 8;
  for (int i = threadIdx.x; i < kL * nv; i += threads) {
    const int r = i / nv, c = i % nv * 8;
    bf16* d = dst + r * ld + c;
    if (r < live && c < cols_live)
      cp_async16(d, src + r * rs + c);
    else
      *reinterpret_cast<uint4*>(d) = make_uint4(0, 0, 0, 0);
  }
}

template <int PT>
__global__ void __launch_bounds__(kStateThreads)
ssd_chunk_state_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                       const float* __restrict__ a_log, const bf16* __restrict__ bm,
                       float* __restrict__ ws, float* __restrict__ decay, int S,
                       int H, int P, int G, int N, Strides sx, Strides sdt,
                       Strides sb) {
  constexpr int LDZ = PT + kPad, kXV = PT / 8;  // x vectors a row
  constexpr int kXPer = (kL * kXV + kStateThreads - 1) / kStateThreads;
  extern __shared__ float4 smem4[];
  const int NP = n_pad(N), LDB = NP + kPad;
  bf16* bs = reinterpret_cast<bf16*>(smem4);  // [kL][LDB]  B rows
  bf16* zh = bs + kL * LDB;                   // [kL][LDZ]  Z hi
  bf16* zl = zh + kL * LDZ;                   // [kL][LDZ]  Z lo
  float* dts = reinterpret_cast<float*>(zl + kL * LDZ);  // [kL]
  float* cum = dts + kL;                                 // [kL]

  const int c = blockIdx.x, nc = gridDim.x, ptiles = P / PT;
  const int h = blockIdx.y / ptiles, p0 = blockIdx.y % ptiles * PT;
  const long long b = blockIdx.z;
  const int g = h / (H / G), s0 = c * kL, lc = min(kL, S - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_rows(bs, LDB, bm + b * sb.b + s0 * sb.s + g * sb.h, sb.s, NP, N, lc,
             kStateThreads);
  cp_async_commit();
  uint4 xr[kXPer];
#pragma unroll
  for (int u = 0; u < kXPer; ++u) {
    const int i = tid + u * kStateThreads, r = i / kXV;
    xr[u] = make_uint4(0, 0, 0, 0);
    if (i < kL * kXV && r < lc)
      xr[u] = *reinterpret_cast<const uint4*>(
          x + b * sx.b + (s0 + r) * sx.s + h * sx.h + p0 + i % kXV * 8);
  }
  if (warp == 0)
    chunk_cumsum(dt + b * sdt.b + s0 * sdt.s + h * sdt.h, sdt.s, lc,
                 -expf(a_log[h]), dts, cum);
  launch_dependents();  // phase B may be scheduled (it waits for this grid)
  __syncthreads();

  // Z = x dt exp(cum_L - cum_j) in f32, split into bf16 hi + lo
  const float cl = cum[kL - 1];
  if (tid == 0 && p0 == 0) decay[(b * H + h) * nc + c] = expf(fminf(cl, 0.f));
#pragma unroll
  for (int u = 0; u < kXPer; ++u) {
    const int i = tid + u * kStateThreads, r = i / kXV;
    if (i < kL * kXV) {
      const float w = dts[r] * expf(fminf(cl - cum[r], 0.f));
      const bf16* e = reinterpret_cast<const bf16*>(&xr[u]);
      uint4 hi, lo;
      uint32_t* hv = &hi.x;
      uint32_t* lv = &lo.x;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        split_bf16(__bfloat162float(e[2 * k]) * w, __bfloat162float(e[2 * k + 1]) * w,
                   hv[k], lv[k]);
      *reinterpret_cast<uint4*>(zh + r * LDZ + i % kXV * 8) = hi;
      *reinterpret_cast<uint4*>(zl + r * LDZ + i % kXV * 8) = lo;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // s_local [N, PT] = B^T Z_hi + B^T Z_lo: a warp per 16 state rows (A =
  // B^T through ldmatrix.trans of the [j][n] tile), the chunk's live
  // 16-row k steps
  const int ksteps = (lc + 15) / 16;
  const int gq = lane >> 2, c2 = (lane & 3) * 2;
  float* out = ws + (((b * nc + c) * H + h) * (long long)N) * P + p0;
  for (int mt = warp; mt < NP / 16; mt += kStateThreads / 32) {
    float acc[PT / 8][4];
#pragma unroll
    for (int t = 0; t < PT / 8; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kL / 16; ++kk) {
      if (kk >= ksteps) break;
      uint32_t af[4];
      ldsm_x4_t(bs + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * LDB + mt * 16 +
                    ((lane >> 3) & 1) * 8, af);
#pragma unroll
      for (int np = 0; np < PT / 16; ++np) {
        const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDZ +
                        np * 16 + (lane >> 4) * 8;
        uint32_t hf[4], lf[4];
        ldsm_x4_t(zh + off, hf);
        ldsm_x4_t(zl + off, lf);
        mma_bf16(acc[2 * np], af, hf[0], hf[1]);
        mma_bf16(acc[2 * np], af, lf[0], lf[1]);
        mma_bf16(acc[2 * np + 1], af, hf[2], hf[3]);
        mma_bf16(acc[2 * np + 1], af, lf[2], lf[3]);
      }
    }
    const int na = mt * 16 + gq, nb = na + 8;
#pragma unroll
    for (int t = 0; t < PT / 8; ++t) {
      const int p = t * 8 + c2;
      if (na < N)
        *reinterpret_cast<float2*>(out + (long long)na * P + p) = make_float2(acc[t][0], acc[t][1]);
      if (nb < N)
        *reinterpret_cast<float2*>(out + (long long)nb * P + p) = make_float2(acc[t][2], acc[t][3]);
    }
  }
}

// NPq = N * P / 4 float4s of one (batch, chunk, head) state
__global__ void __launch_bounds__(kPassThreads)
ssd_state_pass_kernel(float* __restrict__ ws, const float* __restrict__ decay,
                      float* __restrict__ state_out, int nc, int H, int NPq) {
  launch_dependents();     // phase C's prologue needs nothing from here
  grid_dependency_wait();  // phase A's s_local and decays are visible
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  if (e >= NPq) return;
  float4* w = reinterpret_cast<float4*>(ws) + (b * nc * H + h) * (long long)NPq + e;
  const long long cs = (long long)H * NPq;  // float4s between chunks
  const float* dec = decay + (b * H + h) * nc;
  float4 st = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += kPassChunks) {
    float4 sl[kPassChunks];
    float dk[kPassChunks];
#pragma unroll
    for (int u = 0; u < kPassChunks; ++u)
      if (c0 + u < nc) {
        sl[u] = w[(c0 + u) * cs];
        dk[u] = dec[c0 + u];
      }
#pragma unroll
    for (int u = 0; u < kPassChunks; ++u)
      if (c0 + u < nc) {
        w[(c0 + u) * cs] = st;  // the state entering chunk c0 + u
        st.x = fmaf(dk[u], st.x, sl[u].x);
        st.y = fmaf(dk[u], st.y, sl[u].y);
        st.z = fmaf(dk[u], st.z, sl[u].z);
        st.w = fmaf(dk[u], st.w, sl[u].w);
      }
  }
  reinterpret_cast<float4*>(state_out)[(b * H + h) * (long long)NPq + e] = st;
}

template <int PT>
__global__ void __launch_bounds__(kOutThreads)
ssd_chunk_out_kernel(const bf16* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ a_log, const bf16* __restrict__ bm,
                     const bf16* __restrict__ cm, const float* __restrict__ ws,
                     bf16* __restrict__ y, int S, int H, int P, int G, int N,
                     Strides sx, Strides sdt, Strides sb, Strides sc) {
  constexpr int LDX = PT + kPad, LDY = PT + kPad, NT = PT / 8;
  extern __shared__ float4 smem4[];
  const int NP = n_pad(N), LDN = NP + kPad;
  bf16* cs = reinterpret_cast<bf16*>(smem4);  // [kL][LDN]  C rows
  bf16* bs = cs + kL * LDN;                   // [kL][LDN]  B rows
  bf16* xs = bs + kL * LDN;                   // [kL][LDX]  x rows
  bf16* sth = xs + kL * LDX;                  // [NP][LDX]  entering state hi
  bf16* stl = sth + NP * LDX;                 // [NP][LDX]  entering state lo
  float* ypart = reinterpret_cast<float*>(stl + NP * LDX);  // [kL][LDY]
  float* dts = ypart + kL * LDY;                            // [kL]
  float* cum = dts + kL;                                    // [kL]

  const int c = blockIdx.x, nc = gridDim.x, ptiles = P / PT;
  const int h = blockIdx.y / ptiles, p0 = blockIdx.y % ptiles * PT;
  const long long b = blockIdx.z;
  const int g = h / (H / G), s0 = c * kL, lc = min(kL, S - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  stage_rows(cs, LDN, cm + b * sc.b + s0 * sc.s + g * sc.h, sc.s, NP, N, lc,
             kOutThreads);
  stage_rows(bs, LDN, bm + b * sb.b + s0 * sb.s + g * sb.h, sb.s, NP, N, lc,
             kOutThreads);
  stage_rows(xs, LDX, x + b * sx.b + s0 * sx.s + h * sx.h + p0, sx.s, PT, PT,
             lc, kOutThreads);
  cp_async_commit();
  if (warp == 0)
    chunk_cumsum(dt + b * sdt.b + s0 * sdt.s + h * sdt.h, sdt.s, lc,
                 -expf(a_log[h]), dts, cum);
  cp_async_wait<0>();
  __syncthreads();

  // kHalves warps a 16-row tile mt, splitting the depth of both
  // products: with two, half 0 takes the even 16-column (j) tiles of the
  // diagonal block and the even 16-deep (n) steps of the state product,
  // half 1 the odd ones, and the halves' sums meet in shared memory at
  // the end.  S = C B^T is computed once, each half forming the column
  // tiles it multiplies.
  const int mt = warp % (kL / 16), half = warp / (kL / 16);
  const int gq = lane >> 2, c2 = (lane & 3) * 2;
  const int ia = mt * 16 + gq, ib = ia + 8;
  float sacc[8][4];
#pragma unroll
  for (int t = 0; t < 8; ++t) sacc[t][0] = sacc[t][1] = sacc[t][2] = sacc[t][3] = 0.f;
#pragma unroll 4
  for (int kk = 0; kk < NP / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(cs + (mt * 16 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8, af);
#pragma unroll
    for (int jp = 0; jp < 4; ++jp) {
      if (jp > mt) break;  // above the diagonal (warp-uniform)
      if (jp % kHalves != half) continue;
      uint32_t bf[4];
      ldsm_x4(bs + (jp * 16 + (lane & 7) + (lane >> 4) * 8) * LDN + kk * 16 +
                  ((lane >> 3) & 1) * 8, bf);
      mma_bf16(sacc[2 * jp], af, bf[0], bf[1]);
      mma_bf16(sacc[2 * jp + 1], af, bf[2], bf[3]);
    }
  }
  // M = S exp(cum_i - cum_j) dt_j where j <= i, by selection: above the
  // diagonal cum_i - cum_j > 0 and exp may be inf, which is never
  // multiplied into a kept value
  const float cia = cum[ia], cib = cum[ib];
#pragma unroll
  for (int t = 0; t < 8; ++t) {
    if (t / 2 > mt) break;
    if (t / 2 % kHalves != half) continue;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = t * 8 + c2 + e;
      const float cj = cum[j], dj = dts[j];
      sacc[t][e] = j <= ia ? sacc[t][e] * expf(cia - cj) * dj : 0.f;
      sacc[t][2 + e] = j <= ib ? sacc[t][2 + e] * expf(cib - cj) * dj : 0.f;
    }
  }
  // y_diag = M_hi x + M_lo x: the C fragments of M are the A fragments
  float yd[NT][4];
#pragma unroll
  for (int t = 0; t < NT; ++t) yd[t][0] = yd[t][1] = yd[t][2] = yd[t][3] = 0.f;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    if (jp > mt) break;
    if (jp % kHalves != half) continue;
    uint32_t hi[4], lo[4];
    split_bf16(sacc[2 * jp][0], sacc[2 * jp][1], hi[0], lo[0]);
    split_bf16(sacc[2 * jp][2], sacc[2 * jp][3], hi[1], lo[1]);
    split_bf16(sacc[2 * jp + 1][0], sacc[2 * jp + 1][1], hi[2], lo[2]);
    split_bf16(sacc[2 * jp + 1][2], sacc[2 * jp + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int n1 = 0; n1 < PT; n1 += 16) {
      uint32_t xf[4];
      ldsm_x4_t(xs + (jp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX + n1 +
                    (lane >> 4) * 8, xf);
      mma_bf16(yd[n1 / 8], hi, xf[0], xf[1]);
      mma_bf16(yd[n1 / 8], lo, xf[0], xf[1]);
      mma_bf16(yd[n1 / 8 + 1], hi, xf[2], xf[3]);
      mma_bf16(yd[n1 / 8 + 1], lo, xf[2], xf[3]);
    }
  }

  grid_dependency_wait();  // phase B's entering states are visible
  if (c > 0) {  // CTA-uniform: chunk 0 enters from the zero state
    // the entering state [N, PT] f32 split into bf16 hi + lo (rows past
    // N zeros), kPassChunks float4 loads in flight a thread
    const float* st = ws + (((b * nc + c) * H + h) * (long long)N) * P + p0;
    constexpr int kQ = PT / 4;  // float4s a state row
    for (int i0 = tid; i0 < NP * kQ; i0 += kPassChunks * kOutThreads) {
      float4 v[kPassChunks];
#pragma unroll
      for (int u = 0; u < kPassChunks; ++u) {
        const int i = i0 + u * kOutThreads, n = i / kQ;
        v[u] = i < NP * kQ && n < N
                   ? *reinterpret_cast<const float4*>(st + (long long)n * P + i % kQ * 4)
                   : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < kPassChunks; ++u) {
        const int i = i0 + u * kOutThreads;
        if (i < NP * kQ) {
          uint32_t h0, l0, h1, l1;
          split_bf16(v[u].x, v[u].y, h0, l0);
          split_bf16(v[u].z, v[u].w, h1, l1);
          const int off = i / kQ * LDX + i % kQ * 4;
          *reinterpret_cast<uint2*>(sth + off) = make_uint2(h0, h1);
          *reinterpret_cast<uint2*>(stl + off) = make_uint2(l0, l1);
        }
      }
    }
    __syncthreads();
    // y_off = C state_hi + C state_lo over this half's n steps, then
    // y = y_diag + exp(cum_i) y_off
    float yo[NT][4];
#pragma unroll
    for (int t = 0; t < NT; ++t) yo[t][0] = yo[t][1] = yo[t][2] = yo[t][3] = 0.f;
#pragma unroll 4
    for (int kk = half; kk < NP / 16; kk += kHalves) {
      uint32_t af[4];
      ldsm_x4(cs + (mt * 16 + (lane & 15)) * LDN + kk * 16 + (lane >> 4) * 8, af);
#pragma unroll
      for (int n1 = 0; n1 < PT; n1 += 16) {
        const int off = (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LDX + n1 +
                        (lane >> 4) * 8;
        uint32_t hf[4], lf[4];
        ldsm_x4_t(sth + off, hf);
        ldsm_x4_t(stl + off, lf);
        mma_bf16(yo[n1 / 8], af, hf[0], hf[1]);
        mma_bf16(yo[n1 / 8], af, lf[0], lf[1]);
        mma_bf16(yo[n1 / 8 + 1], af, hf[2], hf[3]);
        mma_bf16(yo[n1 / 8 + 1], af, lf[2], lf[3]);
      }
    }
    const float ea = expf(cia), eb = expf(cib);
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      yd[t][0] = fmaf(ea, yo[t][0], yd[t][0]);
      yd[t][1] = fmaf(ea, yo[t][1], yd[t][1]);
      yd[t][2] = fmaf(eb, yo[t][2], yd[t][2]);
      yd[t][3] = fmaf(eb, yo[t][3], yd[t][3]);
    }
  }
  // half 1 hands its sums to half 0, which adds them and stores y (a
  // contiguous [B, S, H, P] tensor; rows past lc are not stored)
  if (kHalves == 2 && half == 1) {
#pragma unroll
    for (int t = 0; t < NT; ++t) {
      const int p = t * 8 + c2;
      *reinterpret_cast<float2*>(ypart + ia * LDY + p) = make_float2(yd[t][0], yd[t][1]);
      *reinterpret_cast<float2*>(ypart + ib * LDY + p) = make_float2(yd[t][2], yd[t][3]);
    }
  }
  if (kHalves == 2) __syncthreads();
  if (half == 1) return;
  bf16* ya = y + ((b * S + s0 + ia) * H + h) * (long long)P + p0;
  bf16* yb = ya + 8LL * H * P;
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    const int p = t * 8 + c2;
    float2 pa = make_float2(0.f, 0.f), pb = pa;
    if (kHalves == 2) {
      pa = *reinterpret_cast<const float2*>(ypart + ia * LDY + p);
      pb = *reinterpret_cast<const float2*>(ypart + ib * LDY + p);
    }
    if (ia < lc)
      *reinterpret_cast<__nv_bfloat162*>(ya + p) =
          __floats2bfloat162_rn(yd[t][0] + pa.x, yd[t][1] + pa.y);
    if (ib < lc)
      *reinterpret_cast<__nv_bfloat162*>(yb + p) =
          __floats2bfloat162_rn(yd[t][2] + pb.x, yd[t][3] + pb.y);
  }
}

// a launch that may start before the kernel ahead of it on the stream has
// finished: the kernel waits for it in grid_dependency_wait
template <typename K, typename... Args>
cudaError_t launch_dependent(K kernel, dim3 grid, int threads, size_t smem,
                             cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

// ws: B * nc * H * N * P f32 (the chunk states, then the entering
// states) followed by B * H * nc f32 (the chunk decays)
template <int PT>
cudaError_t launch_ssd_bf16(const void* x, const void* dt, const void* a_log,
                            const void* bm, const void* cm, void* y, void* state,
                            float* ws, int B, int S, int H, int P, int G, int N,
                            Strides sx, Strides sdt, Strides sb, Strides sc,
                            cudaStream_t s) {
  const size_t smem_a = chunk_state_smem(N, PT), smem_c = chunk_out_smem(N, PT);
  cudaError_t err = allow_smem(ssd_chunk_state_kernel<PT>, smem_a);
  if (err == cudaSuccess) err = allow_smem(ssd_chunk_out_kernel<PT>, smem_c);
  if (err != cudaSuccess) return err;
  if (B == 0 || H == 0) return cudaSuccess;
  const int nc = (S + kL - 1) / kL;
  float* decay = ws + (size_t)B * nc * H * N * P;
  const dim3 chunks(nc, H * (P / PT), B);
  if (nc > 0) {
    ssd_chunk_state_kernel<PT><<<chunks, kStateThreads, smem_a, s>>>(
        (const bf16*)x, (const float*)dt, (const float*)a_log, (const bf16*)bm,
        ws, decay, S, H, P, G, N, sx, sdt, sb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  const int npq = N * P / 4;
  err = launch_dependent(ssd_state_pass_kernel,
                         dim3((npq + kPassThreads - 1) / kPassThreads, H, B),
                         kPassThreads, 0, s, ws, (const float*)decay,
                         (float*)state, nc, H, npq);
  if (err != cudaSuccess || nc == 0) return err;
  return launch_dependent(ssd_chunk_out_kernel<PT>, chunks, kOutThreads, smem_c,
                          s, (const bf16*)x, (const float*)dt,
                          (const float*)a_log, (const bf16*)bm, (const bf16*)cm,
                          (const float*)ws, (bf16*)y, S, H, P, G, N, sx, sdt,
                          sb, sc);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, B, C and y); dt and a_log are f32,
// the state f32.  Strides are in elements; y [B, S, H, P] and the state
// [B, H, N, P] are contiguous.  Needs P % 16 == 0, N % 8 == 0, N <= 256,
// H % G == 0 (the Python wrapper checks them).  bf16 also takes the f32
// workspace (B * nc * H * N * P + B * H * nc elements, nc = ceil(S / 64))
// and the P tile (16, 32 or 64, dividing P) of the host plan
// (scan.scan_plan); f32 takes neither.  Returns the launches'
// cudaError_t (0 = ok; -1 for what the kernels do not take).
extern "C" int ssd_scan_launch(
    const void* x, const void* dt, const void* a_log, const void* bm,
    const void* cm, void* y, void* state, int dtype, int B, int S, int H, int P,
    int G, int N, long long x_sb, long long x_ss, long long x_sh,
    long long dt_sb, long long dt_ss, long long dt_sh, long long b_sb,
    long long b_ss, long long b_sg, long long c_sb, long long c_ss,
    long long c_sg, void* workspace, int p_tile, void* stream) {
  if (P % kPT || N % 8 || N > kMaxN || N < 8 || G < 1 || H % G) return -1;
  const Strides sx{x_sb, x_ss, x_sh}, sdt{dt_sb, dt_ss, dt_sh},
      sb{b_sb, b_ss, b_sg}, sc{c_sb, c_ss, c_sg};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_ssd<float>(x, dt, a_log, bm, cm, y, state, B, S, H, P, G,
                                  N, sx, sdt, sb, sc, s);
  if (dtype != 1 || (p_tile != 16 && p_tile != 32 && p_tile != 64) || P % p_tile)
    return -1;
  float* ws = (float*)workspace;
  switch (p_tile) {
    case 16:
      return (int)launch_ssd_bf16<16>(x, dt, a_log, bm, cm, y, state, ws, B, S,
                                      H, P, G, N, sx, sdt, sb, sc, s);
    case 32:
      return (int)launch_ssd_bf16<32>(x, dt, a_log, bm, cm, y, state, ws, B, S,
                                      H, P, G, N, sx, sdt, sb, sc, s);
    case 64:
      return (int)launch_ssd_bf16<64>(x, dt, a_log, bm, cm, y, state, ws, B, S,
                                      H, P, G, N, sx, sdt, sb, sc, s);
  }
  return -1;
}
