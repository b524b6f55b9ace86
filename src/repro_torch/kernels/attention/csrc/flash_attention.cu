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
// out are read or written once (~10 MB for a 512-token prompt, 3.1 us at
// 3.35 TB/s), while the causal products are ~2.2 GFLOP, 2.2 us at the
// bf16 tensor-core peak.  On the CUDA cores (f32 FMA, ~67 TFLOP/s) the
// same products take ~32 us, so bf16 q runs on the tensor cores.
//
// Shared by both bodies.
//   * q, k, v are read IN PLACE in the model layout [B, S, H, D] through
//     their strides (unit stride on D): no head-major transpose or padded
//     copy per call, unlike the JAX wrapper (ops.py swapaxes + pad).
//   * GQA is the kernel's own indexing: kv head = h / G, as in the TPU
//     kernel's index map; K/V are never repeated in memory.  Query tiles
//     are launched longest-first (the last causal tile attends the most
//     keys).
//   * True lengths: Sq and Skv are the real lengths and the ragged tails
//     are masked in the kernel (the JAX kernel is handed lengths padded to
//     its 128 block, which differs for a non-causal call with a ragged Skv).
//   * Culling: a CTA loops only over the key tiles between the first key
//     in the window of its first query and the last key its last query may
//     see (causal) or Skv, the bounds of flash.py's block culling.
//   * Numerics as the TPU kernel: f32 scores q.k / sqrt(D), an f32 online
//     softmax (m, l, acc), p kept at f32 precision for P.V, out = acc /
//     max(l, 1e-30) in q's dtype; a query that sees no key writes zeros.
//     Another key-tile size changes the summation order, so agreement with
//     the TPU kernel is a tolerance, not bit equality.
//
// Two bodies, chosen statically by q's dtype (not a fallback: each dtype
// has exactly one body).
//   * bf16 q: flash_fwd_tc_kernel, on the tensor cores (mma.sync.m16n8k16,
//     bf16 in, f32 accumulate).
//       - One CTA per (query tile, kv head, batch) covers 64 folded rows
//         (4 warps x one m16 tile): row r is query m0 + r / G of q head
//         kv_head * G + r % G, so each K/V tile is staged once per (query
//         tile, kv head) and not G times; floor(64 / G) queries a tile
//         (G 12: 5 queries, 60 rows, the tail rows masked).  A G above 64
//         is refused.  64 rows rather than 128 (8 warps): the card
//         measured the same time at a 512-token prompt and less at a
//         256-token tail, whose 128-row tiles fill only 64 SMs; one q head
//         a CTA measured no faster than the fold (PERF.md).
//       - A 2-stage cp.async ring of K/V tiles (64 keys; 32 at D = 256)
//         keeps the next tile in flight while the current one is
//         multiplied, and two CTAs share an SM (< 114 KB of shared memory
//         and <= 255 registers a thread each), so one CTA's softmax and
//         loads overlap the other's products.  Tiles keep rows of D + 8
//         bf16 (16 bytes of padding)
//         so the 8 rows of one ldmatrix fall in different bank groups; K
//         stays in its natural layout (the col-major B operand of Q.K^T),
//         V is read with ldmatrix.trans.  Keys past Skv are zeros.
//       - Q fragments are loaded once per CTA with ldmatrix and stay in
//         registers for the whole key loop (D <= 128; at D = 256 they are
//         reloaded from the shared q tile, which registers cannot hold
//         beside the 128-float accumulator).
//       - S = Q.K^T in f32; 1/sqrt(D) times log2(e) multiplies the f32
//         score (never a bf16 q) inside the exponent, p = 2^(s * scale -
//         m) by one FMA and the SFU's ex2.approx.  Row max and sum reduce
//         over the 4 lanes of a row with shuffles; masked scores are -inf
//         and a row that has seen no key uses 0 as its max.  A tile that
//         every row of a warp sees whole skips the per-element mask.
//       - P.V keeps p at f32 precision: the S accumulator fragments are the
//         A operand of P.V in registers (no trip through shared memory);
//         p is split into hi = bf16(p) and lo = bf16(p - hi), and both
//         products go into the same f32 accumulator (|p - hi - lo| <=
//         2^-16 |p|), as the TPU kernel keeps p in f32.
//   * f32 q: flash_fwd_kernel, on the CUDA cores (unchanged since its
//     first version).  TF32 tensor cores would round the inputs past the
//     f32 check.  One CTA per (64-row q tile, q head, batch); q staged as
//     f32, pre-scaled by 1/sqrt(D) and transposed, the K tile transposed
//     and the V tile natural in shared memory, and the 64x64 softmax
//     weights transposed; each thread owns 4 query rows (ty + 16 i) x 8
//     keys (tx * 8 + j) of the scores and 4 rows x D/8 output columns.
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

using repro::allow_smem;
using repro::cp_async16;
using repro::cp_async_commit;
using repro::cp_async_wait;
using repro::fast_exp2;
using repro::from_f;
using repro::ldsm_x4;
using repro::ldsm_x4_t;
using repro::mma_bf16;
using repro::split_bf16;
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

// ---------------------------------------------------------------------
// bf16 q: the tensor-core body
// ---------------------------------------------------------------------
constexpr int kTcWarps = 4;
constexpr int kTcRows = kTcWarps * 16;  // folded rows per CTA: one m16 tile a warp
constexpr int kTcStages = 2;            // K/V tiles in the cp.async ring

template <int D>
struct TcTile {
  static constexpr int BN = D <= 128 ? 64 : 32;  // keys per tile
  static constexpr int LD = D + 8;               // padded bf16 row
  static constexpr bool QREGS = D <= 128;        // Q fragments in registers
  static constexpr size_t q_bytes = sizeof(__nv_bfloat16) * kTcRows * LD;
  static constexpr size_t stage_bytes = sizeof(__nv_bfloat16) * 2 * BN * LD;
  static constexpr size_t smem = q_bytes + kTcStages * stage_bytes;
};

// One CTA per (query tile, kv head, batch).  Warp w owns
// folded rows 16w .. 16w + 15; lane (g = lane / 4, c = lane % 4) holds
// rows 16w + g and 16w + g + 8 of the m16n8 fragments, key or output
// columns 8n + 2c and 8n + 2c + 1.  Scores and the softmax run in log2
// units (scale_log2 = log2(e) / sqrt(D)).
template <int D>
__global__ void __launch_bounds__(kTcWarps * 32, 1)
flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                    const __nv_bfloat16* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v,
                    __nv_bfloat16* __restrict__ out, Strides sq, Strides sk,
                    Strides sv, int Sq, int Skv, int Hq, int G,
                    int q_offset, int causal, int window, float scale_log2) {
  using bf16 = __nv_bfloat16;
  using C = TcTile<D>;
  constexpr int BN = C::BN, LD = C::LD, NT = D / 8, KT = D / 16;
  constexpr int THREADS = kTcWarps * 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);               // [kTcRows][LD]
  bf16* ring = reinterpret_cast<bf16*>(smem_raw + C::q_bytes);  // stages x {K, V} [BN][LD]

  const int QT = kTcRows / G;                   // queries a tile
  const int tile = gridDim.x - 1 - blockIdx.x;  // longest causal tiles first
  const int kh = blockIdx.y, h0 = kh * G;
  const int b = blockIdx.z;
  const int m0 = tile * QT;
  const int nq = min(QT, Sq - m0);
  const int R = nq * G;  // live folded rows
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  // keys this tile may attend: [kv_begin, kv_end), in n key tiles
  const int q_lo = q_offset + m0, q_hi = q_lo + nq - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int kv_begin = window > 0 ? max(0, q_lo - window + 1) : 0;
  const int t0 = kv_begin / BN;
  const int n = kv_end > t0 * BN ? (kv_end - 1) / BN - t0 + 1 : 0;

  // the q tile; rows past R are zeros, never read from q
  const bf16* qb = q + b * sq.b;
  for (int i = threadIdx.x; i < kTcRows * (D / 8); i += THREADS) {
    const int r = i / (D / 8), d = i % (D / 8) * 8;
    bf16* dst = qs + r * LD + d;
    if (r < R)
      cp_async16(dst, qb + (long long)(m0 + r / G) * sq.s +
                          (long long)(h0 + r % G) * sq.h + d);
    else
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
  }
  cp_async_commit();

  const bf16* kb = k + b * sk.b + (long long)kh * sk.h;
  const bf16* vb = v + b * sv.b + (long long)kh * sv.h;
  auto issue = [&](int it) {  // stage the it-th key tile (async)
    if (it < n) {
      const int n0 = (t0 + it) * BN;
      bf16* kt = ring + (it % kTcStages) * 2 * BN * LD;
      bf16* vt = kt + BN * LD;
      for (int c = threadIdx.x; c < BN * (D / 8); c += THREADS) {
        const int t = c / (D / 8), d = c % (D / 8) * 8;
        if (n0 + t < Skv) {
          cp_async16(kt + t * LD + d, kb + (long long)(n0 + t) * sk.s + d);
          cp_async16(vt + t * LD + d, vb + (long long)(n0 + t) * sv.s + d);
        } else {  // past Skv: zeros, so a masked p = 0 meets a finite v
          *reinterpret_cast<uint4*>(kt + t * LD + d) = make_uint4(0, 0, 0, 0);
          *reinterpret_cast<uint4*>(vt + t * LD + d) = make_uint4(0, 0, 0, 0);
        }
      }
    }
    cp_async_commit();  // empty groups keep the wait count uniform
  };
#pragma unroll
  for (int s = 0; s < kTcStages - 1; ++s) issue(s);
  cp_async_wait<kTcStages - 1>();  // the q tile (the oldest group) has landed
  __syncthreads();

  uint32_t qf[C::QREGS ? KT : 1][4];
  if constexpr (C::QREGS) {
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
      ldsm_x4(qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8, qf[kk]);
  }

  const int g = lane >> 2, c2 = (lane & 3) * 2;
  const int ra = warp * 16 + g, rb = ra + 8;
  const bool live_a = ra < R, live_b = rb < R;
  const int qpa = q_lo + ra / G, qpb = q_lo + rb / G;
  // the warp's live rows and their query positions (warp-uniform)
  const bool warp_live = warp * 16 < R;
  const int wq_lo = q_lo + warp * 16 / G;
  const int wq_hi = q_lo + min(warp * 16 + 15, R - 1) / G;

  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;

  for (int it = 0; it < n; ++it) {
    issue(it + kTcStages - 1);
    cp_async_wait<kTcStages - 1>();  // key tile `it` has landed
    __syncthreads();
    const int n0 = (t0 + it) * BN;
    const bf16* kt = ring + (it % kTcStages) * 2 * BN * LD;
    const bf16* vt = kt + BN * LD;
    // does any row of the warp see a key of this tile? (warp-uniform)
    const bool sees = warp_live && (!causal || n0 <= wq_hi) &&
                      (window <= 0 || n0 + BN - 1 > wq_lo - window);
    if (sees) {
      // S = q . k^T for 16 rows x BN keys, f32
      float sc[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t a[4];
        if constexpr (C::QREGS) {
#pragma unroll
          for (int e = 0; e < 4; ++e) a[e] = qf[kk][e];
        } else {
          ldsm_x4(qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8, a);
        }
#pragma unroll
        for (int j = 0; j < BN / 16; ++j) {
          uint32_t kf[4];
          ldsm_x4(kt + (j * 16 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                      ((lane >> 3) & 1) * 8, kf);
          mma_bf16(sc[2 * j], a, kf[0], kf[1]);
          mma_bf16(sc[2 * j + 1], a, kf[2], kf[3]);
        }
      }
      // causal, window, Skv and dead-row mask, unless every row of the
      // warp sees every key of the tile (warp-uniform)
      const bool full = warp * 16 + 16 <= R && n0 + BN <= Skv &&
                        (!causal || n0 + BN - 1 <= wq_lo) &&
                        (window <= 0 || n0 > wq_hi - window);
      if (!full) {
#pragma unroll
        for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kpos = n0 + j * 8 + c2 + e;
            const bool in = kpos < Skv;
            const bool ok_a = live_a && in && (!causal || kpos <= qpa) &&
                              (window <= 0 || kpos > qpa - window);
            const bool ok_b = live_b && in && (!causal || kpos <= qpb) &&
                              (window <= 0 || kpos > qpb - window);
            if (!ok_a) sc[j][e] = -INFINITY;
            if (!ok_b) sc[j][2 + e] = -INFINITY;
          }
        }
      }
      // the row max of the raw scores (the scale is positive), over the 4
      // lanes of a row; scores scale to log2 units inside the exponent
      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx_a = fmaxf(mx_a, fmaxf(sc[j][0], sc[j][1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[j][2], sc[j][3]));
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a * scale_log2);
      const float mn_b = fmaxf(m_b, mx_b * scale_log2);
      const float u_a = mn_a == -INFINITY ? 0.f : mn_a;  // no key yet: p = 0
      const float u_b = mn_b == -INFINITY ? 0.f : mn_b;
      const float corr_a = fast_exp2(m_a - u_a), corr_b = fast_exp2(m_b - u_b);
      m_a = mn_a;
      m_b = mn_b;
      float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {  // masked: 2^-inf = 0
          sc[j][e] = fast_exp2(fmaf(sc[j][e], scale_log2, -u_a));
          sc[j][2 + e] = fast_exp2(fmaf(sc[j][2 + e], scale_log2, -u_b));
          ps_a += sc[j][e];
          ps_b += sc[j][2 + e];
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
      // acc += P . V, 16 keys a step: the C fragments of S are the A
      // fragment of P, split into bf16 hi + lo
#pragma unroll
      for (int j = 0; j < BN / 16; ++j) {
        uint32_t hi[4], lo[4];
        split_bf16(sc[2 * j][0], sc[2 * j][1], hi[0], lo[0]);
        split_bf16(sc[2 * j][2], sc[2 * j][3], hi[1], lo[1]);
        split_bf16(sc[2 * j + 1][0], sc[2 * j + 1][1], hi[2], lo[2]);
        split_bf16(sc[2 * j + 1][2], sc[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
        for (int n1 = 0; n1 < D; n1 += 16) {
          uint32_t vf[4];
          ldsm_x4_t(vt + (j * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + n1 +
                        (lane >> 4) * 8, vf);
          mma_bf16(acc[n1 / 8], hi, vf[0], vf[1]);
          mma_bf16(acc[n1 / 8], lo, vf[0], vf[1]);
          mma_bf16(acc[n1 / 8 + 1], hi, vf[2], vf[3]);
          mma_bf16(acc[n1 / 8 + 1], lo, vf[2], vf[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this stage before reuse
  }
  cp_async_wait<0>();
  if (!warp_live) return;

#pragma unroll
  for (int o = 1; o <= 2; o <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, o);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, o);
  }
  // out is a contiguous [B, Sq, Hq, D] tensor
  const float ia = 1.f / fmaxf(l_a, 1e-30f), ib = 1.f / fmaxf(l_b, 1e-30f);
  bf16* oa = out + (((long long)b * Sq + m0 + ra / G) * Hq + h0 + ra % G) * D;
  bf16* ob = out + (((long long)b * Sq + m0 + rb / G) * Hq + h0 + rb % G) * D;
#pragma unroll
  for (int i = 0; i < NT; ++i) {
    const int d = i * 8 + c2;
    if (live_a)
      *reinterpret_cast<__nv_bfloat162*>(oa + d) =
          __floats2bfloat162_rn(acc[i][0] * ia, acc[i][1] * ia);
    if (live_b)
      *reinterpret_cast<__nv_bfloat162*>(ob + d) =
          __floats2bfloat162_rn(acc[i][2] * ib, acc[i][3] * ib);
  }
}

// The body is chosen by q's dtype T: bf16 q runs the tensor-core body (the
// G q heads of a kv head folded into a CTA), f32 q the CUDA-core body.
template <typename T, int D>
cudaError_t launch_flash(const void* q, const void* k, const void* v, void* out,
                         int B, int Sq, int Skv, int Hq, int Hkv,
                         Strides sq, Strides sk, Strides sv, int q_offset,
                         int causal, int window, float scale, cudaStream_t s) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    const int G = Hq / Hkv;
    if (G > kTcRows) return cudaErrorInvalidValue;
    const cudaError_t err = allow_smem(flash_fwd_tc_kernel<D>, TcTile<D>::smem);
    if (err != cudaSuccess) return err;
    if (B == 0 || Sq == 0) return cudaSuccess;
    const int QT = kTcRows / G;
    const dim3 grid((Sq + QT - 1) / QT, Hkv, B);
    flash_fwd_tc_kernel<D><<<grid, kTcWarps * 32, TcTile<D>::smem, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, sv, Sq, Skv, Hq,
        G, q_offset, causal, window, scale * 1.4426950408889634f);
    return cudaGetLastError();
  } else {
    const size_t smem = Tile<T, D>::smem;
    const cudaError_t err = allow_smem(flash_fwd_kernel<T, D>, smem);
    if (err != cudaSuccess) return err;
    if (B == 0 || Sq == 0) return cudaSuccess;
    const dim3 grid((Sq + kBM - 1) / kBM, Hq, B);
    flash_fwd_kernel<T, D><<<grid, kThreads, smem, s>>>(
        (const T*)q, (const T*)k, (const T*)v, (T*)out, sq, sk, sv, Sq, Skv, Hq,
        Hq / Hkv, q_offset, causal, window, scale);
    return cudaGetLastError();
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  causal: 0/1.  window <= 0: no sliding
// window.  The bf16 body takes at most 64 q heads a kv head.  Strides are
// in elements.  Returns the launch's cudaError_t (0 = ok; -1 for an
// unsupported dtype/head_dim, which the Python wrapper rejects before
// calling).
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, int dtype, int B,
    int Sq, int Skv, int Hq, int Hkv, int D, long long q_sb,
    long long q_ss, long long q_sh, long long k_sb, long long k_ss,
    long long k_sh, long long v_sb, long long v_ss, long long v_sh,
    int q_offset, int causal, int window, float scale, void* stream) {
  const Strides sq{q_sb, q_ss, q_sh}, sk{k_sb, k_ss, k_sh}, sv{v_sb, v_ss, v_sh};
  REPRO_DISPATCH(dtype, D, launch_flash, q, k, v, out, B, Sq, Skv, Hq, Hkv,
                 sq, sk, sv, q_offset, causal, window, scale,
                 (cudaStream_t)stream);
}
