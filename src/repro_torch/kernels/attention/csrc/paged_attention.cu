// Paged attention over the serve engine's block pool, for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of the JAX package, each with its
// native and its quantized (quant=True) body:
//   paged_decode  <- src/repro/kernels/attention/paged.py: paged_decode_fwd
//                    (_paged_decode_kernel): one query token per slot.
//   paged_span    <- src/repro/kernels/attention/paged.py: paged_span_fwd
//                    (_paged_span_kernel): ragged multi-query rows (the
//                    unified serve step's prefill chunks), GQA folded as
//                    row j*G+g.
// Every kernel is templated on the pool's storage type P: the model dtype
// (native pool), int8_t or __nv_fp8_e4m3 (quantized pool: codes plus
// per-(position, kv head) f32 scales in the engine layout [NB, bs, Hkv]).
//
// Bound.  Both are memory-bound at the serve shapes (G = 4 query rows per
// kv head for decode, 32*4 folded rows for a 32-token chunk, D = 128,
// block size 16): every K/V block a row attends is read once per kv head,
// ~4*D flops per folded row per key against 2*D*2 bytes of bf16 K+V per
// key, far below the ~295 flop/byte the H100 needs before compute binds.
// The least time is (K/V bytes of the attended blocks + q + out) /
// 3.35 TB/s.  A quantized pool halves the K/V bytes (1-byte codes) and
// adds 2 * 4 bytes of scales per key and kv head.
//
// Shared by every body.
//   * The pool is read IN PLACE in the engine layout [NB, bs, Hkv, D]
//     through its strides: no head-major copy of the pool per call (the
//     JAX wrapper transposes the whole pool; on the card that would cost
//     the pool's size, not the tokens attended, on every call).
//   * A CTA loads its own block-table row and index/start/len (the TPU's
//     scalar-prefetched SMEM tables) and walks the table in a loop that
//     replaces the TPU's sequential W grid axis.  Only the table entries
//     between the first in-window block and the block of the row's last
//     query position are visited, and NULL entries (block 0) among them
//     are skipped, so no byte of a future, out-of-window or NULL block is
//     read.  Culling is per ROW: a row's result does not depend on the
//     tile or key split it lands in.
//   * A 4-stage ring of cp.async copies keeps the next three K/V blocks
//     in flight while the current one is consumed from shared memory.
//   * f32 scores, an f32 online softmax (m, l, acc) and f32 accumulation;
//     the output is written in q's dtype after acc / max(l, 1e-30); a span
//     row with row_len == 0 writes zeros.
//   * Quantized pools: codes are staged in their storage type (16 codes
//     per 16-byte copy) with the block's bs K and bs V scales of the CTA's
//     kv head (4-byte copies into the same ring stage).  The K scale
//     multiplies the f32 score of its key (q . (k * ks) == (q . k) * ks)
//     and the V scale the softmax weight before it meets V
//     (p * (v * vs) == (p * vs) * v): one multiply per key, not per
//     element.  fp8 codes convert through the hardware e4m3 cvt.
//
// Three bodies, chosen statically by q's dtype and the call; the key
// splits of decode and of the bf16 span share split_range (a row's
// visited table range cut into `splits` contiguous parts, one CTA each,
// grid x, so a batch of a few rows still fills the 132 SMs) and one merge,
// paged_merge_kernel: each split writes its f32 (m, l, acc), in log2
// units, to a workspace, and the merge rescales and sums them; with one
// split the CTA writes the output itself.  The host plans
// (kernels/attention/paged.py: decode_split_plan, span_split_plan) pick
// the count from the shapes alone.
//   * decode (f32 and bf16 q): paged_decode_kernel, on the CUDA cores.
//     One CTA per (key split, kv head, slot), 4 warps that divide each
//     staged block's keys among themselves (G <= 4; a larger G also
//     splits the rows, 4 a warp), so a K/V element is read from shared
//     memory and converted once per CTA, not once per q head.  A lane
//     owns D/32 consecutive head dims of its warp's 4 rows; a pass scores
//     4 rows x 4 keys, sums the 16 dot products over the warp in 16
//     shuffles (a transposed reduction) and gathers the 16 weights back
//     for P.V; the warps' online softmax states meet in shared memory.
//   * span with f32 q: attend_rows, on the CUDA cores.  One CTA per
//     (row, kv head, tile of 16 folded rows); each warp keeps the online
//     softmax of its rows in registers, a lane owning D/32 head dims, and
//     scores 8 keys at a time so their warp reductions overlap.  q is
//     scaled by 1/sqrt(D) in f32.  f32 q stays on the CUDA cores (span
//     and decode) because the tensor cores would round its inputs (TF32)
//     past the f32 check.
//   * span with bf16 q: paged_span_tc_kernel, on the tensor cores
//     (mma.sync.m16n8k16, bf16 in, f32 accumulate).
//       - One CTA covers up to 128 folded rows (8 warps x one 16-row m
//         tile) of a (row, kv head, key split): the main path's 32-token
//         chunk at G = 4 is exactly 128 rows, so each attended block is
//         staged once per (row, kv head, key split), not once per 16
//         rows.  A ragged Q*G masks its tail rows and reads nothing past
//         q; a larger Q*G takes ceil(Q*G / 128) row tiles, each staging
//         the blocks.
//       - S = Q.K^T from bf16 fragments (ldmatrix from padded shared
//         tiles, exact products) into f32; 1/sqrt(D) (times log2 e, for
//         exp2) and the K scale multiply the f32 score, never a bf16 q.
//       - P.V keeps p at f32 precision: p (times the V scale) is split
//         into hi = bf16(p) and lo = bf16(p - hi), and both products go
//         into the same f32 accumulator (|p - hi - lo| <= 2^-16 |p|).
//       - Quantized pools: each staged block's codes are converted to
//         bf16 in shared memory (exact for int8 and e4m3) before the
//         same products.
// Not yet: wgmma and TMA, one CTA (or a cluster) for Q*G > 128, a decode
// G > 4 that reads each element once per CTA.
#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kKeys = 8;     // keys scored together; block_size % kKeys == 0
constexpr int kStages = 4;   // K/V blocks in flight per CTA

using repro::allow_smem;
using repro::as_u32;
using repro::cp_async16;
using repro::cp_async4;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::fast_exp2;
using repro::from_f;
using repro::grid_dependency_wait;
using repro::launch_dependents;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;
using repro::split_bf16;
using repro::to_f;

struct Pool {
  long long k_blk, k_pos, k_head;  // element strides of the K leaf
  long long v_blk, v_pos, v_head;  // element strides of the V leaf
  const float* ks;                 // K scales (quantized pools; else null)
  const float* vs;                 // V scales
  long long ks_blk, ks_pos, ks_head;  // element strides of the K scales
  long long vs_blk, vs_pos, vs_head;  // element strides of the V scales
};

template <typename T, typename P>
constexpr bool kQuant = !std::is_same<T, P>::value;

// bytes of one ring stage: K and V codes of one block (+ their scales)
template <typename T, typename P>
__host__ __device__ constexpr size_t stage_bytes(int bs, int D) {
  return (size_t)2 * bs * D * sizeof(P) + (kQuant<T, P> ? (size_t)2 * bs * sizeof(float) : 0);
}

// This split's share [s_lo, s_lo + n) of a row's visited table entries
// [w_lo, w_hi] (in the window of the row's first query, at or before its
// last query position): the range is cut into `splits` contiguous parts of
// ceil((w_hi - w_lo + 1) / splits) entries, so a row's result depends on
// the split count only through f32 summation order.  Shared by the span
// and decode bodies.
__device__ __forceinline__ void split_range(int start, int len, int W, int bs,
                                            int window, int split, int splits,
                                            int& s_lo, int& n) {
  const int last = start + len - 1;
  const int w_hi = min(W - 1, last / bs);
  int w_lo = 0;
  if (window > 0 && start - window - bs + 1 >= 0) w_lo = (start - window - bs + 1) / bs + 1;
  const int per = (w_hi - w_lo + splits) / splits;
  s_lo = w_lo + split * per;
  n = max(0, min(w_hi + 1, s_lo + per) - s_lo);
}

// Stage block `blk` of kv head kh into one ring stage (async, all THREADS
// threads): K[bs][D] and V[bs][D] in P, then (quantized) the block's bs K
// and bs V f32 scales (stage_bytes).
template <typename T, typename P, int D, int THREADS>
__device__ __forceinline__ void stage_block(unsigned char* st, const P* __restrict__ kp,
                                            const P* __restrict__ vp, const Pool pool,
                                            int blk, int kh, int bs) {
  constexpr int CHUNK = 16 / sizeof(P);  // elements per 16-byte copy
  P* ks = reinterpret_cast<P*>(st);
  P* vs = ks + bs * D;
  const P* kb = kp + (long long)blk * pool.k_blk + (long long)kh * pool.k_head;
  const P* vb = vp + (long long)blk * pool.v_blk + (long long)kh * pool.v_head;
  for (int c = threadIdx.x * CHUNK; c < bs * D; c += THREADS * CHUNK) {
    const int t = c / D, d = c % D;
    cp_async16(ks + c, kb + t * pool.k_pos + d);
    cp_async16(vs + c, vb + t * pool.v_pos + d);
  }
  if constexpr (kQuant<T, P>) {
    float* kss = reinterpret_cast<float*>(vs + bs * D);
    float* vss = kss + bs;
    const float* ksb = pool.ks + (long long)blk * pool.ks_blk + (long long)kh * pool.ks_head;
    const float* vsb = pool.vs + (long long)blk * pool.vs_blk + (long long)kh * pool.vs_head;
    for (int t = threadIdx.x; t < bs; t += THREADS) {
      cp_async4(kss + t, ksb + t * pool.ks_pos);
      cp_async4(vss + t, vsb + t * pool.vs_pos);
    }
  }
}

// Online-softmax attention of folded query rows [r0, r1) of row b, kv head
// kh.  Folded row r is query j = r / G of the row, q head kh*G + r % G, at
// absolute position start + j.  q/out are [B, Q, Hq, D] contiguous (type
// T); the pool holds P.  Warp w owns rows r0 + w + i*WARPS, i < RPW.
template <typename T, typename P, int D, int WARPS, int RPW>
__device__ void attend_rows(const T* __restrict__ q, T* __restrict__ out,
                            const P* __restrict__ kp, const P* __restrict__ vp,
                            const Pool pool, const int* __restrict__ bt_row,
                            int W, int bs, int b, int kh, int Q, int Hq, int G,
                            int r0, int r1, int start, int len, int window,
                            float scale) {
  constexpr int EPT = D / 32;
  constexpr int THREADS = WARPS * 32;
  constexpr bool QUANT = kQuant<T, P>;
  // kStages x {K[bs][D], V[bs][D] in P, then (quantized) ks[bs], vs[bs] f32}
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const size_t stage = stage_bytes<T, P>(bs, D);
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

  int w_lo, n;  // the row's visited table entries, one split
  split_range(start, len, W, bs, window, 0, 1, w_lo, n);

  auto issue = [&](int it) {  // stage the it-th visited block (async)
    const int blk = it < n ? bt_row[w_lo + it] : 0;
    if (blk != 0)
      stage_block<T, P, D, THREADS>(smem_raw + (it % kStages) * stage, kp, vp, pool, blk, kh, bs);
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
      const P* ks = reinterpret_cast<const P*>(smem_raw + (it % kStages) * stage);
      const P* vs = ks + bs * D;
      const float* kss = reinterpret_cast<const float*>(vs + bs * D);
      const float* vss = kss + bs;
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
          if constexpr (QUANT) {
#pragma unroll
            for (int u = 0; u < kKeys; ++u) s[u] *= kss[t0 + u];  // K dequant
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
          if constexpr (QUANT) {
#pragma unroll
            for (int u = 0; u < kKeys; ++u) s[u] *= vss[t0 + u];  // V dequant
          }
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

// decode: 4 warps, each scoring 4 q heads x 4 keys a pass; up to 4 row
// groups cover a GQA group of 16 q heads
constexpr int kDecodeWarps = 4, kDecodeRows = 4, kDecodeKeys = 4;

// the decode CTA: the ring, whose bytes then hold each warp's f32 (acc,
// (m, l)) for its 4 rows (never more than the ring for bs >= 8)
template <typename T, typename P, int D>
__host__ __device__ constexpr size_t decode_smem_bytes(int bs) {
  const size_t ring = kStages * stage_bytes<T, P>(bs, D);
  const size_t states = (size_t)kDecodeWarps * kDecodeRows * (D + 2) * sizeof(float);
  return ring > states ? ring : states;
}
// span: 8 warps x 2 rows = 16 folded query rows per CTA
constexpr int kSpanWarps = 8, kSpanRows = 2;
constexpr int kSpanTile = kSpanWarps * kSpanRows;

// N consecutive elements of type E as floats, in 16-byte (or one
// smaller, for N * sizeof(E) < 16) vector loads; src aligned to that size
template <typename E, int N>
__device__ __forceinline__ void load_f(const E* __restrict__ src, float (&dst)[N]) {
  constexpr int BYTES = N * (int)sizeof(E);
  if constexpr (BYTES >= 16) {
    constexpr int PER = 16 / sizeof(E);
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[c];
      const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) dst[c * PER + i] = to_f(e[i]);
    }
  } else {
    using V = typename std::conditional<
        BYTES == 8, uint2,
        typename std::conditional<BYTES == 4, uint32_t,
                                  typename std::conditional<BYTES == 2, uint16_t,
                                                            uint8_t>::type>::type>::type;
    const V raw = *reinterpret_cast<const V*>(src);
    const E* e = reinterpret_cast<const E*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) dst[i] = to_f(e[i]);
  }
}

// N floats stored as N consecutive elements of type E (float or bf16)
template <typename E, int N>
__device__ __forceinline__ void store_f(E* __restrict__ dst, const float (&src)[N]) {
  constexpr int BYTES = N * (int)sizeof(E);
  if constexpr (BYTES >= 16) {
    constexpr int PER = 16 / sizeof(E);
#pragma unroll
    for (int c = 0; c < BYTES / 16; ++c) {
      uint4 raw;
      E* e = reinterpret_cast<E*>(&raw);
#pragma unroll
      for (int i = 0; i < PER; ++i) e[i] = from_f<E>(src[c * PER + i]);
      reinterpret_cast<uint4*>(dst)[c] = raw;
    }
  } else {
    using V = typename std::conditional<
        BYTES == 8, uint2, typename std::conditional<BYTES == 4, uint32_t, uint16_t>::type>::type;
    V raw;
    E* e = reinterpret_cast<E*>(&raw);
#pragma unroll
    for (int i = 0; i < N; ++i) e[i] = from_f<E>(src[i]);
    *reinterpret_cast<V*>(dst) = raw;
  }
}

// One round of reduce_scatter16: lanes that differ in bit 2H swap halves
// of their first 2H values; each keeps (and sums) the half its bit picks.
template <int H>
__device__ __forceinline__ void scatter_round(float (&v)[16], int lane) {
  const bool up = lane & (2 * H);
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = up ? v[i] : v[i + H];
    const float keep = up ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, 2 * H);
  }
}

// The 16 partial scores v[j] of (row j / 4, key j % 4), each lane's over
// its slice of the head dims, summed over the warp: four rounds halve the
// set a lane holds (15 shuffles), one more adds the last lane bit (a
// butterfly of every score would take 80).  Returns the sum of score
// j = lane >> 1.
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
  scatter_round<8>(v, lane);
  scatter_round<4>(v, lane);
  scatter_round<2>(v, lane);
  scatter_round<1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// One CTA per (key split, kv head, slot), 4 warps.  The slot's G q heads
// (rows) fall into groups of 4, and each group's key groups (4 keys of a
// block) are dealt out among its warps: G <= 4 gives 4 warps on every 4th
// key group, so each staged K/V element is read from shared memory, and
// each int8/e4m3 code converted, once per CTA; G <= 8 gives 2 row groups
// x 2 warps, a larger G 4 x 1 (each element read once per row group).
// A lane owns head dims [lane * D/32, (lane + 1) * D/32) of its warp's 4
// rows: q and the accumulators stay in registers (2 x 4 x D/32 floats).
// A pass scores the warp's 4 rows x 4 keys (16 dot products of D/32 terms
// a lane, reduce_scatter16), keeps an online softmax per row in every lane
// (scores in log2 units: scale_log2 = log2(e) / sqrt(D); the K scale on
// the f32 score, the V scale on the weight), then gathers the 16 weights
// to every lane for P.V.  The warps' (m, l, acc) meet in shared memory
// (the ring's bytes, once it is drained); one split writes the output,
// more write unnormalised f32 partials for paged_merge_kernel.
template <typename T, typename P, int D>
__global__ void __launch_bounds__(kDecodeWarps * 32, 1)
paged_decode_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                    const P* __restrict__ vp, const int* __restrict__ bt,
                    const int* __restrict__ index, T* __restrict__ out,
                    float* __restrict__ part_acc, float* __restrict__ part_ml,
                    int B, int Hq, int Hkv, int W, int bs, Pool pool,
                    int window, float scale_log2) {
  constexpr int EPT = D / 32;
  constexpr int THREADS = kDecodeWarps * 32;
  constexpr bool QUANT = kQuant<T, P>;
  constexpr int RW = kDecodeRows, KW = kDecodeKeys;
  static_assert(RW * KW == 16, "a pass is reduce_scatter16's 16 scores");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int splits = gridDim.x, split = blockIdx.x, kh = blockIdx.y, b = blockIdx.z;
  const int G = Hq / Hkv;
  const size_t stage = stage_bytes<T, P>(bs, D);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = G <= RW ? 1 : G <= 2 * RW ? 2 : 4;
  const int shares = kDecodeWarps / groups;  // warps splitting a group's keys
  const int share = warp % shares, g0 = warp / shares * RW;
  const bool warp_live = g0 < G;
  const int my_row = lane >> 3, my_key = (lane >> 1) & 3;  // reduce_scatter16
  const int pos = index[b];
  const int* bt_row = bt + (long long)b * W;

  float qv[RW][EPT], acc[RW][EPT], m[RW], l[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    if (g0 + r < G) {
      load_f<T, EPT>(q + ((long long)b * Hq + kh * G + g0 + r) * D + lane * EPT, qv[r]);
    } else {
#pragma unroll
      for (int e = 0; e < EPT; ++e) qv[r][e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPT; ++e) acc[r][e] = 0.f;
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  int s_lo, n;
  split_range(pos, 1, W, bs, window, split, splits, s_lo, n);

  auto issue = [&](int it) {  // stage the it-th block of the split (async)
    const int blk = it < n ? bt_row[s_lo + it] : 0;
    if (blk != 0)
      stage_block<T, P, D, THREADS>(smem_raw + (it % kStages) * stage, kp, vp, pool, blk, kh, bs);
    cp_async_commit();  // empty groups keep the wait count uniform
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);
  for (int it = 0; it < n; ++it) {
    cp_async_wait<kStages - 2>();  // block `it` has landed
    __syncthreads();               // ... and every warp is done with it - 1
    issue(it + kStages - 1);       // into the stage block it - 1 used
    const int w = s_lo + it;
    if (!warp_live || bt_row[w] == 0) continue;  // NULL block: never attended
    const P* ks = reinterpret_cast<const P*>(smem_raw + (it % kStages) * stage);
    const P* vs = ks + bs * D;
    const float* kss = reinterpret_cast<const float*>(vs + bs * D);
    const float* vss = kss + bs;
    for (int t0 = share * KW; t0 < bs; t0 += shares * KW) {
      int ok = 0;  // bit u: key t0 + u is causal and in the window
#pragma unroll
      for (int u = 0; u < KW; ++u) {
        const int kpos = w * bs + t0 + u;
        ok |= (kpos <= pos && (window <= 0 || kpos > pos - window)) << u;
      }
      if (!ok) continue;  // warp-uniform
      float v[RW * KW];
#pragma unroll
      for (int u = 0; u < KW; ++u) {
        float kf[EPT];
        load_f<P, EPT>(ks + (t0 + u) * D + lane * EPT, kf);
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          float dot = 0.f;
#pragma unroll
          for (int e = 0; e < EPT; ++e) dot += qv[r][e] * kf[e];
          v[r * KW + u] = dot;
        }
      }
      float sc = reduce_scatter16(v, lane);
      float f = scale_log2;
      if constexpr (QUANT) f *= kss[t0 + my_key];  // K dequant
      sc = ((ok >> my_key) & 1) && g0 + my_row < G ? sc * f : -INFINITY;
      float mx = fmaxf(sc, __shfl_xor_sync(0xffffffffu, sc, 2));  // over the keys
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      float corr[RW], mine = 0.f;
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        const float mn = fmaxf(m[r], __shfl_sync(0xffffffffu, mx, r * 8));
        const float u = mn == -INFINITY ? 0.f : mn;  // no key yet: p = 0
        corr[r] = fast_exp2(m[r] - u);
        m[r] = mn;
        if (r == my_row) mine = u;
      }
      const float p = fast_exp2(sc - mine);  // masked: exp2(-inf) = 0
      float pw[RW * KW];
#pragma unroll
      for (int j = 0; j < RW * KW; ++j) pw[j] = __shfl_sync(0xffffffffu, p, 2 * j);
#pragma unroll
      for (int r = 0; r < RW; ++r) {
        float ps = 0.f;
#pragma unroll
        for (int u = 0; u < KW; ++u) ps += pw[r * KW + u];
        l[r] = l[r] * corr[r] + ps;
#pragma unroll
        for (int e = 0; e < EPT; ++e) acc[r][e] *= corr[r];
      }
#pragma unroll
      for (int u = 0; u < KW; ++u) {
        float vf[EPT];
        load_f<P, EPT>(vs + (t0 + u) * D + lane * EPT, vf);
        float vsc = 1.f;
        if constexpr (QUANT) vsc = vss[t0 + u];  // V dequant on the weight
#pragma unroll
        for (int r = 0; r < RW; ++r) {
          const float pr = pw[r * KW + u] * vsc;
#pragma unroll
          for (int e = 0; e < EPT; ++e) acc[r][e] += pr * vf[e];
        }
      }
    }
  }
  cp_async_wait<0>();
  launch_dependents();  // the merge (splits > 1) may be scheduled now
  __syncthreads();      // the ring is free: it holds the warps' states now

  // [warp][row] x acc[D], then [warp][row] x (m, l)
  float* st_acc = reinterpret_cast<float*>(smem_raw);
  float* st_ml = st_acc + kDecodeWarps * RW * D;
  if (warp_live) {
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      store_f<float, EPT>(st_acc + (warp * RW + r) * D + lane * EPT, acc[r]);
      if (lane == 0) *reinterpret_cast<float2*>(st_ml + (warp * RW + r) * 2) = make_float2(m[r], l[r]);
    }
  }
  __syncthreads();
  // warp `share` of a row group finishes its rows share, share + shares, ...
  const int first = warp - share;  // the group's first warp
  for (int r = share; r < RW; r += shares) {
    const int g = g0 + r;
    if (g >= G) break;  // warp-uniform
    float mx = -INFINITY;
    for (int i = 0; i < shares; ++i) mx = fmaxf(mx, st_ml[((first + i) * RW + r) * 2]);
    float o[EPT], lsum = 0.f;
#pragma unroll
    for (int e = 0; e < EPT; ++e) o[e] = 0.f;
    for (int i = 0; i < shares; ++i) {
      const float2 ml = *reinterpret_cast<const float2*>(st_ml + ((first + i) * RW + r) * 2);
      if (ml.x == -INFINITY) continue;  // saw no key: adds nothing
      const float wgt = fast_exp2(ml.x - mx);
      lsum += wgt * ml.y;
      float a[EPT];
      load_f<float, EPT>(st_acc + ((first + i) * RW + r) * D + lane * EPT, a);
#pragma unroll
      for (int e = 0; e < EPT; ++e) o[e] += wgt * a[e];
    }
    if (splits == 1) {
      const float inv = 1.f / fmaxf(lsum, 1e-30f);
#pragma unroll
      for (int e = 0; e < EPT; ++e) o[e] *= inv;
      store_f<T, EPT>(out + ((long long)b * Hq + kh * G + g) * D + lane * EPT, o);
    } else {  // partials [split][B][Hkv][G] x (acc[D], (m, l))
      const long long row = ((long long)(split * B + b) * Hkv + kh) * G + g;
      store_f<float, EPT>(part_acc + row * D + lane * EPT, o);
      if (lane == 0) *reinterpret_cast<float2*>(part_ml + row * 2) = make_float2(mx, lsum);
    }
  }
}

template <typename T, typename P, int D>
__global__ void __launch_bounds__(kSpanWarps * 32)
paged_span_kernel(const T* __restrict__ q, const P* __restrict__ kp,
                  const P* __restrict__ vp, const int* __restrict__ bt,
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
  attend_rows<T, P, D, kSpanWarps, kSpanRows>(
      q, out, kp, vp, pool, bt + (long long)b * W, W, bs, b, kh, Q, Hq, G, r0,
      r1, row_start[b], len, window, scale);
}

// ---------------------------------------------------------------------
// paged_span with bf16 q: the tensor-core body and its split merge
// ---------------------------------------------------------------------
constexpr int kTcWarps = 8;
constexpr int kTcRows = kTcWarps * 16;  // folded rows per CTA: one m16 tile a warp

__host__ __device__ constexpr int round16(int x) { return (x + 15) / 16 * 16; }

// bf16 tiles keep rows of D + 8 elements (16 bytes of padding), so the 8
// row addresses of one ldmatrix fall in 8 different bank groups
template <typename P, int D>
__host__ __device__ constexpr size_t tc_stage_bytes(int bs) {
  return kQuant<__nv_bfloat16, P>
             ? (size_t)2 * bs * D * sizeof(P) + (size_t)2 * bs * sizeof(float)
             : (size_t)2 * round16(bs) * (D + 8) * sizeof(__nv_bfloat16);
}

// the q tile, the ring, and (quantized) one K/V block converted to bf16
template <typename P, int D>
__host__ __device__ constexpr size_t tc_smem_bytes(int bs) {
  return (size_t)kTcRows * (D + 8) * sizeof(__nv_bfloat16) +
         kStages * tc_stage_bytes<P, D>(bs) +
         (kQuant<__nv_bfloat16, P>
              ? (size_t)2 * round16(bs) * (D + 8) * sizeof(__nv_bfloat16) : 0);
}

// One CTA per (key split, kv head x row tile, row).  Warp w owns folded
// rows r0 + 16w .. r0 + 16w + 15; lane (g = lane / 4, c = lane % 4) holds
// rows 16w + g and 16w + g + 8 of the m16n8 fragments, output columns
// 8n + 2c and 8n + 2c + 1.  Scores and the softmax run in log2 units
// (scale_log2 = log2(e) / sqrt(D)).
template <typename P, int D>
__global__ void __launch_bounds__(kTcWarps * 32, 1)
paged_span_tc_kernel(const __nv_bfloat16* __restrict__ q, const P* __restrict__ kp,
                     const P* __restrict__ vp, const int* __restrict__ bt,
                     const int* __restrict__ row_start,
                     const int* __restrict__ row_len, __nv_bfloat16* __restrict__ out,
                     float* __restrict__ part_acc, float* __restrict__ part_ml,
                     int B, int Q, int Hq, int Hkv, int W, int bs, Pool pool,
                     int window, float scale_log2) {
  using bf16 = __nv_bfloat16;
  constexpr bool QUANT = kQuant<bf16, P>;
  constexpr int LD = D + 8;
  constexpr int NT = D / 8;  // n8 tiles of a row's output
  constexpr int THREADS = kTcWarps * 32;
  constexpr int CHUNK = 16 / sizeof(P);  // elements per 16-byte copy
  const int splits = gridDim.x, split = blockIdx.x;
  const int tiles = gridDim.y / Hkv;
  const int kh = blockIdx.y / tiles, r0 = (blockIdx.y % tiles) * kTcRows;
  const int b = blockIdx.z;
  const int G = Hq / Hkv, R = Q * G;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  auto orow = [&](int r) {  // element offset of folded row r in q and out
    return ((long long)(b * Q + r / G) * Hq + kh * G + r % G) * D;
  };
  const int len = row_len[b];
  if (len <= 0) {  // empty row: zeros, never NaN (with splits, the merge's)
    if (splits == 1) {
      for (int i = threadIdx.x; i < kTcRows * (D / 8); i += THREADS) {
        const int r = r0 + i / (D / 8);
        if (r < R)
          *reinterpret_cast<uint4*>(out + orow(r) + i % (D / 8) * 8) = make_uint4(0, 0, 0, 0);
      }
    }
    return;
  }

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);
  unsigned char* ring = smem_raw + (size_t)kTcRows * LD * sizeof(bf16);
  const size_t stage = tc_stage_bytes<P, D>(bs);
  bf16* conv = reinterpret_cast<bf16*>(ring + kStages * stage);  // quantized
  const int bs16 = round16(bs);

  // pad key rows [bs, bs16) of every bf16 K/V tile stay zero (never copied)
  for (int i = threadIdx.x; i < (bs16 - bs) * (D / 8); i += THREADS) {
    const int t = bs + i / (D / 8), d = i % (D / 8) * 8;
    for (int s = 0; s < (QUANT ? 1 : kStages); ++s) {
      bf16* kt = QUANT ? conv : reinterpret_cast<bf16*>(ring + s * stage);
      *reinterpret_cast<uint4*>(kt + t * LD + d) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(kt + (bs16 + t) * LD + d) = make_uint4(0, 0, 0, 0);
    }
  }
  // the q tile; rows past Q*G are zeros, never read from q
  for (int i = threadIdx.x; i < kTcRows * (D / 8); i += THREADS) {
    const int rl = i / (D / 8), d = i % (D / 8) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + rl < R) v = *reinterpret_cast<const uint4*>(q + orow(r0 + rl) + d);
    *reinterpret_cast<uint4*>(qs + rl * LD + d) = v;
  }

  // this split's share of the row's visited table entries
  const int start = row_start[b];
  int s_lo, n;
  split_range(start, len, W, bs, window, split, splits, s_lo, n);
  const int* bt_row = bt + (long long)b * W;

  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  const int qpa = ra < R ? start + ra / G : -1;  // -1: a dead row sees no key
  const int qpb = rb < R ? start + rb / G : -1;
  const bool warp_live = r0 + warp * 16 < R;

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  auto issue = [&](int it) {  // stage the it-th block of the split (async)
    if (it < n) {
      const int blk = bt_row[s_lo + it];
      if (blk != 0) {
        unsigned char* st = ring + (it % kStages) * stage;
        const P* kb = kp + (long long)blk * pool.k_blk + (long long)kh * pool.k_head;
        const P* vb = vp + (long long)blk * pool.v_blk + (long long)kh * pool.v_head;
        // codes land unpadded; native bf16 rows land at the padded stride
        P* kt = reinterpret_cast<P*>(st);
        P* vt = kt + (QUANT ? bs * D : bs16 * LD);
        for (int c = threadIdx.x * CHUNK; c < bs * D; c += THREADS * CHUNK) {
          const int t = c / D, d = c % D;
          const int o = QUANT ? c : t * LD + d;
          cp_async16(kt + o, kb + t * pool.k_pos + d);
          cp_async16(vt + o, vb + t * pool.v_pos + d);
        }
        if constexpr (QUANT) {
          float* kss = reinterpret_cast<float*>(vt + bs * D);
          float* vss = kss + bs;
          const float* ksb = pool.ks + (long long)blk * pool.ks_blk + (long long)kh * pool.ks_head;
          const float* vsb = pool.vs + (long long)blk * pool.vs_blk + (long long)kh * pool.vs_head;
          for (int t = threadIdx.x; t < bs; t += THREADS) {
            cp_async4(kss + t, ksb + t * pool.ks_pos);
            cp_async4(vss + t, vsb + t * pool.vs_pos);
          }
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
    const int w = s_lo + it;
    if (bt_row[w] != 0) {  // CTA-uniform; NULL blocks are never attended
      const unsigned char* st = ring + (it % kStages) * stage;
      const bf16* kt = reinterpret_cast<const bf16*>(st);
      const float* kss = nullptr;
      const float* vss = nullptr;
      if constexpr (QUANT) {  // codes -> bf16 (exact), 8 a thread a step
        const P* kc = reinterpret_cast<const P*>(st);
        kss = reinterpret_cast<const float*>(kc + 2 * bs * D);
        vss = kss + bs;
        for (int c = threadIdx.x * 8; c < 2 * bs * D; c += THREADS * 8) {
          const int half = c >= bs * D, e0 = c - half * bs * D;
          const uint2 raw = *reinterpret_cast<const uint2*>(kc + c);
          const P* code = reinterpret_cast<const P*>(&raw);
          uint4 o;
          uint32_t* ov = reinterpret_cast<uint32_t*>(&o);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ov[e] = as_u32(__floats2bfloat162_rn(to_f(code[2 * e]), to_f(code[2 * e + 1])));
          *reinterpret_cast<uint4*>(conv + (half * bs16 + e0 / D) * LD + e0 % D) = o;
        }
        __syncthreads();
        kt = conv;
      }
      const bf16* vt = kt + bs16 * LD;
      if (warp_live) {  // warp-uniform
        for (int t0 = 0; t0 < bs; t0 += 16) {
          // S = q . k^T for 16 rows x 16 keys (two n8 tiles), f32
          float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int k0 = 0; k0 < D; k0 += 16) {
            uint32_t a[4], kf[4];
            ldsm_x4(qs + (warp * 16 + (lane & 15)) * LD + k0 + (lane >> 4) * 8, a);
            ldsm_x4(kt + (t0 + (lane & 7) + (lane >> 4) * 8) * LD + k0 + ((lane >> 3) & 1) * 8, kf);
            mma_bf16(sc[0], a, kf[0], kf[1]);
            mma_bf16(sc[1], a, kf[2], kf[3]);
          }
          // scale (and K dequant) the f32 score; causal, window, pad mask
          float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int t = t0 + nt * 8 + c2 + e;
              const int kpos = w * bs + t;
              float f = scale_log2;
              if constexpr (QUANT) f *= t < bs ? kss[t] : 0.f;
              const bool ok_a = t < bs && kpos <= qpa && (window <= 0 || kpos > qpa - window);
              const bool ok_b = t < bs && kpos <= qpb && (window <= 0 || kpos > qpb - window);
              sc[nt][e] = ok_a ? sc[nt][e] * f : -INFINITY;
              sc[nt][2 + e] = ok_b ? sc[nt][2 + e] * f : -INFINITY;
              mx_a = fmaxf(mx_a, sc[nt][e]);
              mx_b = fmaxf(mx_b, sc[nt][2 + e]);
            }
          }
#pragma unroll
          for (int o = 1; o <= 2; o <<= 1) {  // over the 4 lanes of a row
            mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
            mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
          }
          if (!__any_sync(0xffffffffu, mx_a != -INFINITY || mx_b != -INFINITY))
            continue;  // no row of the warp sees a key of this tile
          const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
          const float u_a = mn_a == -INFINITY ? 0.f : mn_a;  // no key yet: p = 0
          const float u_b = mn_b == -INFINITY ? 0.f : mn_b;
          const float corr_a = exp2f(m_a - u_a), corr_b = exp2f(m_b - u_b);
          m_a = mn_a;
          m_b = mn_b;
          float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              sc[nt][e] = exp2f(sc[nt][e] - u_a);  // masked: exp2(-inf) = 0
              sc[nt][2 + e] = exp2f(sc[nt][2 + e] - u_b);
              ps_a += sc[nt][e];
              ps_b += sc[nt][2 + e];
            }
          }
          l_a = l_a * corr_a + ps_a;
          l_b = l_b * corr_b + ps_b;
#pragma unroll
          for (int i = 0; i < NT; ++i) {
            acc[i][0] *= corr_a;
            acc[i][1] *= corr_a;
            acc[i][2] *= corr_b;
            acc[i][3] *= corr_b;
          }
          if constexpr (QUANT) {  // V dequant on the weight, before the split
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const int t = t0 + nt * 8 + c2 + e;
                const float vsc = t < bs ? vss[t] : 0.f;
                sc[nt][e] *= vsc;
                sc[nt][2 + e] *= vsc;
              }
            }
          }
          // the C fragments of S are the A fragment of P (16 rows x 16 keys)
          uint32_t hi[4], lo[4];
          split_bf16(sc[0][0], sc[0][1], hi[0], lo[0]);
          split_bf16(sc[0][2], sc[0][3], hi[1], lo[1]);
          split_bf16(sc[1][0], sc[1][1], hi[2], lo[2]);
          split_bf16(sc[1][2], sc[1][3], hi[3], lo[3]);
#pragma unroll
          for (int n0 = 0; n0 < D; n0 += 16) {
            uint32_t vf[4];
            ldsm_x4_t(vt + (t0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n0 + (lane >> 4) * 8, vf);
            mma_bf16(acc[n0 / 8], hi, vf[0], vf[1]);
            mma_bf16(acc[n0 / 8], lo, vf[0], vf[1]);
            mma_bf16(acc[n0 / 8 + 1], hi, vf[2], vf[3]);
            mma_bf16(acc[n0 / 8 + 1], lo, vf[2], vf[3]);
          }
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }
  cp_async_wait<0>();
  launch_dependents();  // the merge (splits > 1) may be scheduled now
  if (!warp_live) return;

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  if (splits == 1) {
    const float ia = 1.f / fmaxf(l_a, 1e-30f), ib = 1.f / fmaxf(l_b, 1e-30f);
#pragma unroll
    for (int i = 0; i < NT; ++i) {
      const int d = i * 8 + c2;
      if (ra < R)
        *reinterpret_cast<__nv_bfloat162*>(out + orow(ra) + d) =
            __floats2bfloat162_rn(acc[i][0] * ia, acc[i][1] * ia);
      if (rb < R)
        *reinterpret_cast<__nv_bfloat162*>(out + orow(rb) + d) =
            __floats2bfloat162_rn(acc[i][2] * ib, acc[i][3] * ib);
    }
    return;
  }
  // partials [split][B][Hkv][R] x (acc[D], (m, l)), unnormalised
  const long long base = ((long long)(split * B + b) * Hkv + kh) * R;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int d = i * 8 + c2;
    if (ra < R)
      *reinterpret_cast<float2*>(part_acc + (base + ra) * D + d) = make_float2(acc[i][0], acc[i][1]);
    if (rb < R)
      *reinterpret_cast<float2*>(part_acc + (base + rb) * D + d) = make_float2(acc[i][2], acc[i][3]);
  }
  if ((lane & 3) == 0) {
    if (ra < R) *reinterpret_cast<float2*>(part_ml + (base + ra) * 2) = make_float2(m_a, l_a);
    if (rb < R) *reinterpret_cast<float2*>(part_ml + (base + rb) * 2) = make_float2(m_b, l_b);
  }
}

// Merge of the key splits of the span (bf16 q) and decode bodies: one
// warp per folded row, a lane owning D/32 head dims.  out = sum_s
// 2^(m_s - M) acc_s / max(sum_s 2^(m_s - M) l_s, 1e-30), M = max_s m_s.  A
// split that saw no key (m_s = -inf) adds nothing; a row that saw none, or
// a span row with row_len == 0, gets zeros.  Decode passes no row_len
// (every slot has its token).
constexpr int kMergeWarps = 8;

template <typename T, int D>
__global__ void __launch_bounds__(kMergeWarps * 32)
paged_merge_kernel(const float* __restrict__ part_acc,
                   const float* __restrict__ part_ml,
                   const int* __restrict__ row_len, T* __restrict__ out, int B,
                   int Q, int Hq, int Hkv, int splits) {
  constexpr int EPT = D / 32;
  grid_dependency_wait();  // the splits' partials are written and visible
  const int G = Hq / Hkv, R = Q * G;
  const int b = blockIdx.z, kh = blockIdx.y;
  const int r = blockIdx.x * kMergeWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= R) return;
  float o[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) o[e] = 0.f;
  if (row_len == nullptr || row_len[b] > 0) {
    const long long stride = (long long)B * Hkv * R;  // rows between splits
    const long long row0 = ((long long)b * Hkv + kh) * R + r;
    float ms = -INFINITY, ls = 0.f;
    if (lane < splits) {
      const float2 ml = *reinterpret_cast<const float2*>(part_ml + (row0 + lane * stride) * 2);
      ms = ml.x;
      ls = ml.y;
    }
    float mx = ms;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (mx != -INFINITY) {  // warp-uniform
      const float wgt = ms == -INFINITY ? 0.f : exp2f(ms - mx);
      float l = wgt * ls;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
      for (int s = 0; s < splits; ++s) {
        const float ws = __shfl_sync(0xffffffffu, wgt, s);
        if (ws == 0.f) continue;  // warp-uniform
        const float* a = part_acc + (row0 + s * stride) * D;
#pragma unroll
        for (int e = 0; e < EPT; ++e) o[e] += ws * a[e * 32 + lane];
      }
      const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
      for (int e = 0; e < EPT; ++e) o[e] *= inv;
    }
  }
  const long long orow = ((long long)(b * Q + r / G) * Hq + kh * G + r % G) * D;
#pragma unroll
  for (int e = 0; e < EPT; ++e) out[orow + e * 32 + lane] = from_f<T>(o[e]);
}

// the merge of `splits` partials of R = Q*G folded rows per (row, kv head),
// launched as a programmatic dependent of the split kernel just before it
// on the stream: its CTAs are scheduled once every split CTA has left its
// key loop (launch_dependents; earlier, at a CTA's start, the waiting
// merge CTAs slowed the span body 5-10 %) and wait in grid_dependency_wait
// for the split grid to finish, so the merge's launch latency hides
// behind the splits' epilogues
template <typename T, int D>
cudaError_t launch_merge(const float* part_acc, const float* part_ml,
                         const int* row_len, void* out, int B, int Q, int Hq,
                         int Hkv, int splits, cudaStream_t s) {
  const int R = Q * (Hq / Hkv);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((R + kMergeWarps - 1) / kMergeWarps, Hkv, B);
  cfg.blockDim = dim3(kMergeWarps * 32);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, paged_merge_kernel<T, D>, part_acc, part_ml,
                            row_len, (T*)out, B, Q, Hq, Hkv, splits);
}

template <typename T, typename P, int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v,
                          const int* bt, const int* index, void* out,
                          float* part_acc, float* part_ml, int B, int Hq,
                          int Hkv, int W, int bs, Pool pool, int window,
                          float scale, int splits, cudaStream_t s) {
  const size_t smem = decode_smem_bytes<T, P, D>(bs);
  cudaError_t err = allow_smem(paged_decode_kernel<T, P, D>, smem);
  if (err != cudaSuccess) return err;
  paged_decode_kernel<T, P, D><<<dim3(splits, Hkv, B), kDecodeWarps * 32, smem, s>>>(
      (const T*)q, (const P*)k, (const P*)v, bt, index, (T*)out, part_acc,
      part_ml, B, Hq, Hkv, W, bs, pool, window, scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_merge<T, D>(part_acc, part_ml, nullptr, out, B, 1, Hq, Hkv, splits, s);
}

template <typename T, typename P, int D>
cudaError_t launch_span(const void* q, const void* k, const void* v,
                        const int* bt, const int* row_start, const int* row_len,
                        void* out, int B, int Q, int Hq, int Hkv, int W, int bs,
                        Pool pool, int window, float scale, cudaStream_t s) {
  const int G = Hq / Hkv;
  const size_t smem = kStages * stage_bytes<T, P>(bs, D);
  const cudaError_t err = allow_smem(paged_span_kernel<T, P, D>, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(B, Hkv, (Q * G + kSpanTile - 1) / kSpanTile);
  paged_span_kernel<T, P, D><<<grid, kSpanWarps * 32, smem, s>>>(
      (const T*)q, (const P*)k, (const P*)v, bt, row_start, row_len, (T*)out,
      Q, Hq, G, W, bs, pool, window, scale);
  return cudaGetLastError();
}

// Pool storage dispatch: kv 0 = the model dtype T, 1 = int8, 2 = fp8 e4m3.
template <typename T, int D>
cudaError_t decode_kv(int kv, const void* q, const void* k, const void* v,
                      const int* bt, const int* index, void* out,
                      float* part_acc, float* part_ml, int B, int Hq, int Hkv,
                      int W, int bs, Pool pool, int window, float scale,
                      int splits, cudaStream_t s) {
  switch (kv) {
    case 0: return launch_decode<T, T, D>(q, k, v, bt, index, out, part_acc, part_ml, B, Hq, Hkv, W, bs, pool, window, scale, splits, s);
    case 1: return launch_decode<T, int8_t, D>(q, k, v, bt, index, out, part_acc, part_ml, B, Hq, Hkv, W, bs, pool, window, scale, splits, s);
    case 2: return launch_decode<T, __nv_fp8_e4m3, D>(q, k, v, bt, index, out, part_acc, part_ml, B, Hq, Hkv, W, bs, pool, window, scale, splits, s);
  }
  return cudaErrorInvalidValue;
}

template <typename P, int D>
cudaError_t launch_span_tc(const void* q, const void* k, const void* v,
                           const int* bt, const int* row_start, const int* row_len,
                           void* out, float* part_acc, float* part_ml, int B,
                           int Q, int Hq, int Hkv, int W, int bs, Pool pool,
                           int window, float scale, int splits, cudaStream_t s) {
  const size_t smem = tc_smem_bytes<P, D>(bs);
  cudaError_t err = allow_smem(paged_span_tc_kernel<P, D>, smem);
  if (err != cudaSuccess) return err;
  const int R = Q * (Hq / Hkv);
  const dim3 grid(splits, Hkv * ((R + kTcRows - 1) / kTcRows), B);
  paged_span_tc_kernel<P, D><<<grid, kTcWarps * 32, smem, s>>>(
      (const __nv_bfloat16*)q, (const P*)k, (const P*)v, bt, row_start, row_len,
      (__nv_bfloat16*)out, part_acc, part_ml, B, Q, Hq, Hkv, W, bs, pool, window,
      scale * 1.4426950408889634f);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  return launch_merge<__nv_bfloat16, D>(part_acc, part_ml, row_len, out, B, Q,
                                        Hq, Hkv, splits, s);
}

// The span body is chosen by q's dtype T: f32 q runs attend_rows on the
// CUDA cores, bf16 q the tensor-core body (with its key splits).
template <typename T, int D>
cudaError_t span_kv(int kv, const void* q, const void* k, const void* v,
                    const int* bt, const int* row_start, const int* row_len,
                    void* out, float* part_acc, float* part_ml, int B, int Q,
                    int Hq, int Hkv, int W, int bs, Pool pool, int window,
                    float scale, int splits, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    switch (kv) {
      case 0: return launch_span<T, T, D>(q, k, v, bt, row_start, row_len, out, B, Q, Hq, Hkv, W, bs, pool, window, scale, s);
      case 1: return launch_span<T, int8_t, D>(q, k, v, bt, row_start, row_len, out, B, Q, Hq, Hkv, W, bs, pool, window, scale, s);
      case 2: return launch_span<T, __nv_fp8_e4m3, D>(q, k, v, bt, row_start, row_len, out, B, Q, Hq, Hkv, W, bs, pool, window, scale, s);
    }
  } else {
    switch (kv) {
      case 0: return launch_span_tc<T, D>(q, k, v, bt, row_start, row_len, out, part_acc, part_ml, B, Q, Hq, Hkv, W, bs, pool, window, scale, splits, s);
      case 1: return launch_span_tc<int8_t, D>(q, k, v, bt, row_start, row_len, out, part_acc, part_ml, B, Q, Hq, Hkv, W, bs, pool, window, scale, splits, s);
      case 2: return launch_span_tc<__nv_fp8_e4m3, D>(q, k, v, bt, row_start, row_len, out, part_acc, part_ml, B, Q, Hq, Hkv, W, bs, pool, window, scale, splits, s);
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q and out).  kv: the pool's storage,
// 0 = q's dtype, 1 = int8, 2 = fp8 e4m3 (ks/vs then point at the f32
// scales, else null).  window <= 0: no sliding window.  Strides are in
// elements.  Returns the launch's cudaError_t (0 = ok; -1 for an
// unsupported dtype/head_dim, which the Python wrapper rejects before
// calling).  paged_decode_launch (Q = 1) and paged_span_launch with bf16
// q split each row's keys over `splits` CTAs (1..16); with splits > 1,
// part_acc (f32 [splits, B, Hkv, Q*G, D]) and part_ml (f32 [splits, B,
// Hkv, Q*G, 2]) are the workspace.  The span with f32 q ignores splits
// and the workspace.
extern "C" int paged_decode_launch(const void* q, const void* k, const void* v,
                                   const float* ks, const float* vs,
                                   const int* bt, const int* index, void* out,
                                   float* part_acc, float* part_ml,
                                   int dtype, int kv, int B, int Hq, int Hkv,
                                   int D, int W, int bs, long long k_blk,
                                   long long k_pos, long long k_head,
                                   long long v_blk, long long v_pos,
                                   long long v_head, long long ks_blk,
                                   long long ks_pos, long long ks_head,
                                   long long vs_blk, long long vs_pos,
                                   long long vs_head, int window, float scale,
                                   int splits, void* stream) {
  const Pool pool{k_blk,  k_pos,  k_head,  v_blk,  v_pos,  v_head, ks,
                  vs,     ks_blk, ks_pos, ks_head, vs_blk, vs_pos, vs_head};
  REPRO_DISPATCH(dtype, D, decode_kv, kv, q, k, v, bt, index, out, part_acc,
                 part_ml, B, Hq, Hkv, W, bs, pool, window, scale, splits,
                 (cudaStream_t)stream);
}

extern "C" int paged_span_launch(const void* q, const void* k, const void* v,
                                 const float* ks, const float* vs,
                                 const int* bt, const int* row_start,
                                 const int* row_len, void* out, float* part_acc,
                                 float* part_ml, int dtype, int kv, int B, int Q,
                                 int Hq, int Hkv, int D, int W, int bs,
                                 long long k_blk, long long k_pos,
                                 long long k_head, long long v_blk,
                                 long long v_pos, long long v_head,
                                 long long ks_blk, long long ks_pos,
                                 long long ks_head, long long vs_blk,
                                 long long vs_pos, long long vs_head, int window,
                                 float scale, int splits, void* stream) {
  const Pool pool{k_blk,  k_pos,  k_head,  v_blk,  v_pos,  v_head, ks,
                  vs,     ks_blk, ks_pos, ks_head, vs_blk, vs_pos, vs_head};
  REPRO_DISPATCH(dtype, D, span_kv, kv, q, k, v, bt, row_start, row_len, out,
                 part_acc, part_ml, B, Q, Hq, Hkv, W, bs, pool, window, scale,
                 splits, (cudaStream_t)stream);
}
