// Flash-attention backward (K4b), causal or local-window, GQA: given q, k, v,
// the forward's output o, its row log-sum-exp lse and the cotangent
// g = dL/do, returns dq, dk and dv.
//
// The reference has no Pallas backward: it trains through its XLA chunked
// attention (src/repro/modeling/attention.py:50, chunked_attention) and lets
// XLA differentiate it. The port's attention is K4 (flash_attention.cu) on
// the card, so its training step needs this kernel; it is K4's gradient,
// with K4's mask: q (B, H, Sq, D), k/v (B, Hkv, Skv, D), any strides with a
// contiguous last dimension, 1 <= D <= 256, query head h reads K/V head
// h / (H / Hkv), query i sees key j when j <= i (causal) and j > i - window
// (window > 0). Masked pairs contribute exactly 0 and a row with no visible
// key gets a zero gradient, as its forward gives 0.
//
// lse is K4's (float32 (B, H, Sq), element (b, h, i) at b * lse_sb +
// h * lse_sh + i): the natural-log log-sum-exp of the row's visible scaled
// scores, +inf for a row with no visible key, so P = exp(scale * s - lse)
// is the forward's normalised probability and exactly 0 on such a row. The
// kernels never recompute it.
//
// Launches, in order on one stream:
//  1. delta: one block per (b, h, 64-row query tile), delta = rowsum(g * o)
//     in float32 (8 lanes a row, 16-byte loads). It moves bytes only.
//  2. dk/dv: one block per (b, kv head, key tile, head split). It loops over
//     its query heads of the group and over the query tiles that can see
//     the key tile (the rest are skipped, as K4 skips dead tiles) and
//     accumulates dv += P^T g and dk += dS^T q with dS = P (g v^T - delta).
//  3. reduce (only when the heads were split): sums the float32 partials of
//     the splits in split order and writes dk and dv.
//  4. dq: one block per (b, h, 64-row query tile) loops over the key tiles
//     its rows can see and accumulates dq += dS k.
// No atomics: each output element is written by exactly one thread of one
// block, after a fixed loop order, so the backward is deterministic (a
// resumed training run matches an uninterrupted one bit for bit). That
// costs two products: S and g v^T are computed in both pass 2 and pass 4
// (7 products where 5 suffice); per-key-tile dq partials would instead
// write and read ~0.55 GB at llama3.2-1b's training shape, more than the
// two products cost.
//
// bf16: tensor cores. Every product is mma.sync.m16n8k16 (bf16 in, float32
// accumulate) on fragments read with ldmatrix from cp.async-staged,
// XOR-swizzled shared memory (fa_mma.cuh, shared with K4).
//  - dk/dv: 8 warps, 64 keys; query tiles TQ of 64, double-buffered with
//    their lse and delta (208 KB of shared memory at D = 256). A tile pair
//    runs in two steps. First S^T = K Q^T and dP^T = V g^T, each warp 16
//    keys x half the queries (K and V fragments held in registers at
//    64 < D <= 128); then
//    P^T = exp2(S^T * scale * log2(e) - lse * log2(e)) and dS^T = P^T (dP^T
//    - delta) in float32 registers, rounded to bf16 (as K4 rounds P before
//    P V, and the reference's XLA attention does) into shared memory. Then
//    dV += P^T g and dK += dS^T Q, each warp 16 keys x half the head dims,
//    their float32 accumulators in registers (D / 2 a thread at 256
//    threads: 128 at D = 256) across all of the block's tile pairs; dk is
//    scaled once and written once. At D <= 64 two blocks share an SM (128
//    registers a thread).
//  - head split: when B x Hkv x key tiles falls short of the SM count (one
//    KV head: recurrentgemma-9b's 16 query heads on one), the G query heads
//    are split over blocks (flash_attention_bwd_splits), each writing a
//    float32 dk/dv partial, and pass 3 sums them in a fixed order.
//  - dq: 4 warps, 16 query rows each, key tiles of 64 (16 at D > 128, so
//    that two blocks fit an SM's shared memory; four at D <= 64)
//    double-buffered. S = Q K^T and dP = g V^T run on the tensor cores, P
//    and dS stay in registers and are repacked as bf16 A fragments for
//    dQ += dS K, with K read through ldmatrix.trans. The mask is applied
//    only on tiles that cross a row's diagonal or window edge.
//  - head dims below 16 (SPLIT; no model of the repo has one): a row holds
//    too few gradients for bf16 rounding of P and dS (2^-9 of each term) to
//    stay small against its own scale, since sum_j dS_ij = 0 makes its sums
//    cancel. There P and dS go in as two bf16 terms, x = hi + lo with
//    hi = bf16(x) and lo = bf16(x - hi) (~16 bits), and each of the three
//    accumulating products runs once per term.
//  What bounds it: the issue of mma.sync and ldmatrix (every warp reads its
//  operands from shared memory for 16 rows, about one ldmatrix per two
//  products), and few warps an SM (8 in the dk/dv pass at D = 256, whose
//  accumulators take 128 registers a thread). Hopper's wgmma on the dk/dv
//  pass's 64-row products, with operands read by the tensor cores from
//  shared memory, is the next step.
//
// float32: CUDA cores (TF32 would break its 5e-5 parity with the plain
// version). dk/dv: one block per (b, kv head, 32-key tile), lane j owning
// key j of the tile and each warp 32 / NW query rows; a score is one lane's
// full-width dot product over K^T (or V^T) staged transposed with a
// 33-float pitch, Q (or g) rows read as float4 broadcasts, P and dS through
// shared memory, and each pair's 32 terms summed apart before they join the
// running sums (a shorter float32 chain for a key seen by thousands of
// rows). dq: one block per (b, h, 32-row query tile). Head dims are
// zero-padded to NW * 16. What bounds it: the float32 rate and the
// shared-memory broadcasts that feed it.
//
// Built without -fmad=false, as flash_attention.cu: the dot products are
// chains of FMAs by design and the parity with the plain version is a
// tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fa_mma.cuh"

namespace {

constexpr float LOG2E = 1.4426950408889634f;

struct Strides {  // (batch, head, seq) element strides; lse: (batch, head)
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3], lse[2];
};

struct Args {
  int H, Hkv, Sq, Skv, D, causal, window;
  float scale, scale_log2;
  Strides st;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const bf16* p) { return __bfloat162float(*p); }

// butterfly sum over the `width` lanes of a group: every lane ends with the
// same bits
template <int WIDTH = 32>
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = WIDTH / 2; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// query position i sees key j
__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return i < a.Sq && j < a.Skv && (!a.causal || j <= i) && (a.window <= 0 || j > i - a.window);
}

__device__ __forceinline__ long long lse_at(const Args& a, int b, int h) {
  return b * a.st.lse[0] + h * a.st.lse[1];
}

// what rounding x to bf16 leaves out (exact in float32)
__device__ __forceinline__ float bf16_rest(float x) {
  return x - __bfloat162float(__float2bfloat16_rn(x));
}

// the hi (bf16(x)) or lo (bf16(x - hi)) terms of two floats, packed
template <bool LO>
__device__ __forceinline__ uint32_t pack_term(float x0, float x1) {
  if constexpr (LO) {
    return pack_bf16(bf16_rest(x0), bf16_rest(x1));
  } else {
    return pack_bf16(x0, x1);
  }
}

// ---------------------------------------------------------------- 1. delta
constexpr int DELTA_ROWS = 64, DELTA_THREADS = 256;

// 16 bytes of each operand: their dot product in float32
__device__ __forceinline__ float dot16(const float* x, const float* y) {
  const float4 a = *reinterpret_cast<const float4*>(x), b = *reinterpret_cast<const float4*>(y);
  return fmaf(a.w, b.w, fmaf(a.z, b.z, fmaf(a.y, b.y, a.x * b.x)));
}

__device__ __forceinline__ float dot16(const bf16* x, const bf16* y) {
  const uint4 a = *reinterpret_cast<const uint4*>(x), b = *reinterpret_cast<const uint4*>(y);
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, bw[4] = {b.x, b.y, b.z, b.w};
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 af = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&aw[i]));
    const float2 bf = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bw[i]));
    s = fmaf(af.y, bf.y, fmaf(af.x, bf.x, s));
  }
  return s;
}

// delta[b, h, i] = sum_d g[b, h, i, d] * o[b, h, i, d]: 8 lanes a row, each
// summing every eighth 16-byte chunk (vec) or element, then a butterfly
template <typename T>
__global__ void __launch_bounds__(DELTA_THREADS)
fa_bwd_delta(const T* __restrict__ o, const T* __restrict__ g, float* __restrict__ delta,
             Args a, int vec) {
  constexpr int CE = 16 / sizeof(T);  // elements per 16-byte chunk
  const int sub = threadIdx.x & 7, h = blockIdx.y, b = blockIdx.z;
  const Strides& st = a.st;
  const T* op = o + b * st.o[0] + h * st.o[1];
  const T* gp = g + b * st.g[0] + h * st.g[1];
  for (int r = threadIdx.x >> 3; r < DELTA_ROWS; r += DELTA_THREADS / 8) {
    const int i = blockIdx.x * DELTA_ROWS + r;
    float dot = 0.f;
    if (i < a.Sq) {
      const T* orow = op + i * st.o[2];
      const T* grow = gp + i * st.g[2];
      if (vec) {
        for (int d = sub * CE; d < a.D; d += 8 * CE) dot += dot16(grow + d, orow + d);
      } else {
        for (int d = sub; d < a.D; d += 8) dot = fmaf(ld(grow + d), ld(orow + d), dot);
      }
    }
    dot = warp_sum<8>(dot);
    if (sub == 0 && i < a.Sq) delta[((long long)b * a.H + h) * a.Sq + i] = dot;
  }
}

// ------------------------------------------------- 2. dk and dv, bf16 (TC)
constexpr int KV_WARPS = 8, KV_THREADS = KV_WARPS * 32;
constexpr int BKV = 64;  // keys per block: 4 m-tiles of 16

template <int DP, int TQ, bool SPLIT>
constexpr size_t kv_smem() {  // K, V; Q and g double-buffered; P^T, dS^T (twice
                              // with SPLIT: hi and lo); lse, delta
  return sizeof(bf16) * (2 * BKV * DP + 4 * TQ * DP + (SPLIT ? 4 : 2) * BKV * TQ) +
         sizeof(float) * 4 * TQ;
}

template <int DP, int TQ, bool SPLIT>
__global__ void __launch_bounds__(KV_THREADS, DP <= 64 ? 2 : 1)
fa_bwd_dkdv_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
               const bf16* __restrict__ v, const bf16* __restrict__ g,
               const float* __restrict__ lse, const float* __restrict__ delta,
               bf16* __restrict__ dk, bf16* __restrict__ dv, float* __restrict__ work,
               int nsplit, int B, Args a, int vec) {
  constexpr bool KREG = DP == 128;  // K and V fragments held in registers
  constexpr int NQW = TQ / 2;       // queries per warp in S^T and dP^T
  constexpr int DW = DP / 2;        // head dims per warp in dK and dV
  extern __shared__ uint4 smem_kv[];
  bf16* ks = reinterpret_cast<bf16*>(smem_kv);  // BKV x DP
  bf16* vs = ks + BKV * DP;                     // BKV x DP
  bf16* qs = vs + BKV * DP;                     // 2 x TQ x DP
  bf16* gs = qs + 2 * TQ * DP;                  // 2 x TQ x DP
  bf16* ps = gs + 2 * TQ * DP;                  // BKV x TQ: P^T
  bf16* dss = ps + BKV * TQ;                    // BKV x TQ: dS^T
  bf16* pls = dss + BKV * TQ;                   // SPLIT: BKV x TQ, P^T's lo term
  bf16* dls = pls + (SPLIT ? BKV * TQ : 0);     // SPLIT: BKV x TQ, dS^T's lo term
  float* ls = reinterpret_cast<float*>(dls + (SPLIT ? BKV * TQ : 0));  // 2 x TQ: lse log2(e)
  float* dl = ls + 2 * TQ;                               // 2 x TQ: delta

  // grid (Hkv * nsplit, B, key tiles): the causal first tiles, which the
  // most query tiles see, start first
  const int hk = blockIdx.x % a.Hkv, split = blockIdx.x / a.Hkv, b = blockIdx.y;
  const int k0 = blockIdx.z * BKV;
  const int G = a.H / a.Hkv;
  const int h_lo = hk * G + split * G / nsplit, h_hi = hk * G + (split + 1) * G / nsplit;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int km = (warp & 3) * 16;    // the warp's 16 keys (rows of S^T, dK, dV)
  const int qn = (warp >> 2) * NQW;  // its queries in S^T and dP^T
  const int dn = (warp >> 2) * DW;   // its head dims in dK and dV
  const Strides& st = a.st;

  // query rows that can see a key of the tile, as tiles of TQ
  const int k_last = min(k0 + BKV, a.Skv) - 1;
  const int i_lo = a.causal ? k0 : 0;
  const int i_hi = a.window > 0 ? min(a.Sq - 1, k_last + a.window - 1) : a.Sq - 1;
  const int t0 = i_lo / TQ, nt = i_lo <= i_hi ? i_hi / TQ - t0 + 1 : 0;
  const int n_it = nt * (h_hi - h_lo);

  auto stage_q = [&](int it, int buf) {
    const int h = h_lo + it / nt, q0 = (t0 + it % nt) * TQ;
    const bf16* qp = q + b * st.q[0] + h * st.q[1];
    const bf16* gp = g + b * st.g[0] + h * st.g[1];
    stage_rows<DP, KV_THREADS>(
        qs + buf * TQ * DP, TQ, a.D, vec,
        [&](int r) -> const bf16* {
          return q0 + r < a.Sq ? qp + (long long)(q0 + r) * st.q[2] : nullptr;
        },
        q);
    stage_rows<DP, KV_THREADS>(
        gs + buf * TQ * DP, TQ, a.D, vec,
        [&](int r) -> const bf16* {
          return q0 + r < a.Sq ? gp + (long long)(q0 + r) * st.g[2] : nullptr;
        },
        g);
    cp_commit();
    if (tid < TQ) {  // a row past Sq: lse +inf, so its P is 0
      const int i = q0 + tid;
      ls[buf * TQ + tid] = i < a.Sq ? lse[lse_at(a, b, h) + i] * LOG2E : CUDART_INF_F;
      dl[buf * TQ + tid] = i < a.Sq ? delta[((long long)b * a.H + h) * a.Sq + i] : 0.f;
    }
  };

  float acck[DW / 8][4], accv[DW / 8][4];
#pragma unroll
  for (int n = 0; n < DW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acck[n][e] = accv[n][e] = 0.f;
  uint32_t kf[KREG ? DP / 16 : 1][4], vf[KREG ? DP / 16 : 1][4];

  if (n_it > 0) {
    const bf16* kp = k + b * st.k[0] + hk * st.k[1];
    const bf16* vp = v + b * st.v[0] + hk * st.v[1];
    stage_rows<DP, KV_THREADS>(
        ks, BKV, a.D, vec,
        [&](int r) -> const bf16* {
          return k0 + r < a.Skv ? kp + (long long)(k0 + r) * st.k[2] : nullptr;
        },
        k);
    stage_rows<DP, KV_THREADS>(
        vs, BKV, a.D, vec,
        [&](int r) -> const bf16* {
          return k0 + r < a.Skv ? vp + (long long)(k0 + r) * st.v[2] : nullptr;
        },
        v);
    stage_q(0, 0);  // one cp.async group with K and V
  }
  const uint32_t k_base = smem_u32(ks), v_base = smem_u32(vs);
  const uint32_t p_base = smem_u32(ps), ds_base = smem_u32(dss);
  const uint32_t pl_base = smem_u32(pls), dl_base = smem_u32(dls);

  for (int it = 0; it < n_it; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_it) {
      stage_q(it + 1, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if constexpr (KREG) {
      if (it == 0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk) {
          ldsm_x4(kf[kk], frag_a<DP>(k_base, km, kk, lane));
          ldsm_x4(vf[kk], frag_a<DP>(v_base, km, kk, lane));
        }
      }
    }
    const int q0 = (t0 + it % nt) * TQ;
    const uint32_t q_base = smem_u32(qs + buf * TQ * DP), g_base = smem_u32(gs + buf * TQ * DP);
    const float* lsb = ls + buf * TQ;
    const float* dlb = dl + buf * TQ;

    // S^T = K Q^T and dP^T = V g^T: the warp's 16 keys x NQW queries
    float s[NQW / 8][4], dp[NQW / 8][4];
#pragma unroll
    for (int n = 0; n < NQW / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t ak[4], av[4];
      if constexpr (KREG) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ak[j] = kf[kk][j];
          av[j] = vf[kk][j];
        }
      } else {
        ldsm_x4(ak, frag_a<DP>(k_base, km, kk, lane));
        ldsm_x4(av, frag_a<DP>(v_base, km, kk, lane));
      }
#pragma unroll
      for (int n2 = 0; n2 < NQW / 16; ++n2) {
        uint32_t bq[4], bg[4];
        ldsm_x4(bq, frag_b<DP>(q_base, qn + n2 * 16, kk, lane));
        mma_bf16(s[2 * n2], ak, bq[0], bq[1]);
        mma_bf16(s[2 * n2 + 1], ak, bq[2], bq[3]);
        ldsm_x4(bg, frag_b<DP>(g_base, qn + n2 * 16, kk, lane));
        mma_bf16(dp[2 * n2], av, bg[0], bg[1]);
        mma_bf16(dp[2 * n2 + 1], av, bg[2], bg[3]);
      }
    }
    // P^T and dS^T; element e of n-block n: key km + gq + 8 (e >> 1), query
    // qn + 8 n + 2 tq + (e & 1). The mask only where the tile pair is not
    // wholly live (block-uniform)
    const bool full = q0 + TQ <= a.Sq && k0 + BKV <= a.Skv &&
                      (!a.causal || k0 + BKV - 1 <= q0) &&
                      (a.window <= 0 || k0 > q0 + TQ - 1 - a.window);
#pragma unroll
    for (int n = 0; n < NQW / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = qn + 8 * n + 2 * tq + (e & 1), key = k0 + km + gq + 8 * (e >> 1);
        float p = exp2_ftz(fmaf(s[n][e], a.scale_log2, -lsb[c]));
        if (!full && !visible(a, q0 + c, key)) p = 0.f;
        s[n][e] = p;
        dp[n][e] = p * (dp[n][e] - dlb[c]);
      }
      const int c = (qn + 8 * n) / 8;
      const int at0 = swz<TQ>(km + gq, c) + 2 * tq, at1 = swz<TQ>(km + gq + 8, c) + 2 * tq;
      *reinterpret_cast<uint32_t*>(ps + at0) = pack_term<false>(s[n][0], s[n][1]);
      *reinterpret_cast<uint32_t*>(ps + at1) = pack_term<false>(s[n][2], s[n][3]);
      *reinterpret_cast<uint32_t*>(dss + at0) = pack_term<false>(dp[n][0], dp[n][1]);
      *reinterpret_cast<uint32_t*>(dss + at1) = pack_term<false>(dp[n][2], dp[n][3]);
      if constexpr (SPLIT) {
        *reinterpret_cast<uint32_t*>(pls + at0) = pack_term<true>(s[n][0], s[n][1]);
        *reinterpret_cast<uint32_t*>(pls + at1) = pack_term<true>(s[n][2], s[n][3]);
        *reinterpret_cast<uint32_t*>(dls + at0) = pack_term<true>(dp[n][0], dp[n][1]);
        *reinterpret_cast<uint32_t*>(dls + at1) = pack_term<true>(dp[n][2], dp[n][3]);
      }
    }
    __syncthreads();

    // dV += P^T g and dK += dS^T Q: the warp's 16 keys x DW head dims
#pragma unroll
    for (int kq = 0; kq < TQ / 16; ++kq) {
      uint32_t ap[4], ad[4], apl[4], adl[4];
      ldsm_x4(ap, frag_a<TQ>(p_base, km, kq, lane));
      ldsm_x4(ad, frag_a<TQ>(ds_base, km, kq, lane));
      if constexpr (SPLIT) {
        ldsm_x4(apl, frag_a<TQ>(pl_base, km, kq, lane));
        ldsm_x4(adl, frag_a<TQ>(dl_base, km, kq, lane));
      }
#pragma unroll
      for (int n2 = 0; n2 < DW / 16; ++n2) {
        uint32_t bg[4], bq[4];
        ldsm_x4_t(bg, frag_bt<DP>(g_base, kq, dn / 16 + n2, lane));
        mma_bf16(accv[2 * n2], ap, bg[0], bg[1]);
        mma_bf16(accv[2 * n2 + 1], ap, bg[2], bg[3]);
        ldsm_x4_t(bq, frag_bt<DP>(q_base, kq, dn / 16 + n2, lane));
        mma_bf16(acck[2 * n2], ad, bq[0], bq[1]);
        mma_bf16(acck[2 * n2 + 1], ad, bq[2], bq[3]);
        if constexpr (SPLIT) {
          mma_bf16(accv[2 * n2], apl, bg[0], bg[1]);
          mma_bf16(accv[2 * n2 + 1], apl, bg[2], bg[3]);
          mma_bf16(acck[2 * n2], adl, bq[0], bq[1]);
          mma_bf16(acck[2 * n2 + 1], adl, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();  // Q, g, P^T and dS^T consumed before they are staged again
  }

  // element e of n-block n: key k0 + km + gq + 8 (e >> 1), dim dn + 8 n +
  // 2 tq + (e & 1); one split writes dk and dv, several their partials
  const long long part = (long long)B * a.Hkv * a.Skv * a.D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + km + gq + 8 * i;
    if (key >= a.Skv) continue;
    bf16* dkp = dk + b * st.dk[0] + hk * st.dk[1] + key * st.dk[2];
    bf16* dvp = dv + b * st.dv[0] + hk * st.dv[1] + key * st.dv[2];
    const long long w0 = (((long long)b * a.Hkv + hk) * a.Skv + key) * a.D;
#pragma unroll
    for (int n = 0; n < DW / 8; ++n) {
      const int d = dn + 8 * n + 2 * tq;
      if (d >= a.D) break;
      const float xk0 = acck[n][2 * i], xk1 = acck[n][2 * i + 1];
      const float xv0 = accv[n][2 * i], xv1 = accv[n][2 * i + 1];
      if (nsplit > 1) {
        float* wk = work + (2LL * split) * part + w0 + d;
        float* wv = wk + part;
        wk[0] = xk0;
        wv[0] = xv0;
        if (d + 1 < a.D) {
          wk[1] = xk1;
          wv[1] = xv1;
        }
      } else if (vec) {
        *reinterpret_cast<__nv_bfloat162*>(dkp + d) =
            __floats2bfloat162_rn(xk0 * a.scale, xk1 * a.scale);
        *reinterpret_cast<__nv_bfloat162*>(dvp + d) = __floats2bfloat162_rn(xv0, xv1);
      } else {
        dkp[d] = __float2bfloat16_rn(xk0 * a.scale);
        dvp[d] = __float2bfloat16_rn(xv0);
        if (d + 1 < a.D) {
          dkp[d + 1] = __float2bfloat16_rn(xk1 * a.scale);
          dvp[d + 1] = __float2bfloat16_rn(xv1);
        }
      }
    }
  }
}

// ---------------------------------------------- 3. the splits' partials
// dk = scale * sum_s dk_s, dv = sum_s dv_s, the splits added in order
__global__ void __launch_bounds__(256)
fa_bwd_reduce(const float* __restrict__ work, bf16* __restrict__ dk, bf16* __restrict__ dv,
              int nsplit, int B, Args a) {
  const long long part = (long long)B * a.Hkv * a.Skv * a.D;
  for (long long x = blockIdx.x * 256LL + threadIdx.x; x < part; x += (long long)gridDim.x * 256) {
    const int d = (int)(x % a.D);
    const long long row = x / a.D;
    const int key = (int)(row % a.Skv);
    const int hk = (int)((row / a.Skv) % a.Hkv), b = (int)(row / ((long long)a.Skv * a.Hkv));
    float sk = 0.f, sv = 0.f;
    for (int s = 0; s < nsplit; ++s) {
      sk += work[2LL * s * part + x];
      sv += work[(2LL * s + 1) * part + x];
    }
    dk[b * a.st.dk[0] + hk * a.st.dk[1] + key * a.st.dk[2] + d] = __float2bfloat16_rn(sk * a.scale);
    dv[b * a.st.dv[0] + hk * a.st.dv[1] + key * a.st.dv[2] + d] = __float2bfloat16_rn(sv);
  }
}

// ------------------------------------------------------ 4. dq, bf16 (TC)
constexpr int DQ_WARPS = 4, DQ_THREADS = DQ_WARPS * 32;
constexpr int DQ_M = DQ_WARPS * 16;  // query rows per block

template <int DP, int TK>
constexpr size_t dq_tc_smem() {  // Q, g; K and V double-buffered
  return sizeof(bf16) * (2 * DQ_M * DP + 4 * TK * DP);
}

template <int DP, int TK, bool SPLIT>
__global__ void __launch_bounds__(DQ_THREADS, DP <= 64 ? 4 : 2)
fa_bwd_dq_tc(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
             const bf16* __restrict__ g, const float* __restrict__ lse,
             const float* __restrict__ delta, bf16* __restrict__ dq, Args a, int vec) {
  extern __shared__ uint4 smem_dq[];
  bf16* qs = reinterpret_cast<bf16*>(smem_dq);  // DQ_M x DP
  bf16* gs = qs + DQ_M * DP;                    // DQ_M x DP
  bf16* ks = gs + DQ_M * DP;                    // 2 x TK x DP
  bf16* vs = ks + 2 * TK * DP;                  // 2 x TK x DP

  // grid (H, B, query tiles), the longest rows first
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * DQ_M;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const Strides& st = a.st;
  const bf16* qp = q + b * st.q[0] + h * st.q[1];
  const bf16* gp = g + b * st.g[0] + h * st.g[1];
  const bf16* kp = k + b * st.k[0] + hk * st.k[1];
  const bf16* vp = v + b * st.v[0] + hk * st.v[1];

  stage_rows<DP, DQ_THREADS>(
      qs, DQ_M, a.D, vec,
      [&](int r) -> const bf16* {
        return q0 + r < a.Sq ? qp + (long long)(q0 + r) * st.q[2] : nullptr;
      },
      q);
  stage_rows<DP, DQ_THREADS>(
      gs, DQ_M, a.D, vec,
      [&](int r) -> const bf16* {
        return q0 + r < a.Sq ? gp + (long long)(q0 + r) * st.g[2] : nullptr;
      },
      g);
  cp_commit();

  // this thread's rows gq and gq + 8 of the warp's 16: lse (log2 units),
  // delta and the live key range
  float l2[2], dlt[2];
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + warp * 16 + gq + 8 * i;
    if (qpos < a.Sq) {
      l2[i] = lse[lse_at(a, b, h) + qpos] * LOG2E;
      dlt[i] = delta[((long long)b * a.H + h) * a.Sq + qpos];
      lo[i] = a.window > 0 ? max(qpos - a.window + 1, 0) : 0;
      hi[i] = a.causal ? min(qpos, a.Skv - 1) : a.Skv - 1;
    } else {
      l2[i] = CUDART_INF_F;
      dlt[i] = 0.f;
      lo[i] = 1 << 30;
      hi[i] = -1;
    }
  }
  // the warp's union of ranges (tiles outside it are skipped) and their
  // intersection (tiles inside it need no mask)
  int u_lo = min(lo[0], lo[1]), u_hi = max(hi[0], hi[1]);
  int i_lo = max(lo[0], lo[1]), i_hi = min(hi[0], hi[1]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    u_lo = min(u_lo, __shfl_xor_sync(FULL, u_lo, off));
    u_hi = max(u_hi, __shfl_xor_sync(FULL, u_hi, off));
    i_lo = max(i_lo, __shfl_xor_sync(FULL, i_lo, off));
    i_hi = min(i_hi, __shfl_xor_sync(FULL, i_hi, off));
  }

  // keys any row of the block can see
  const int q_last = min(q0 + DQ_M, a.Sq) - 1;
  const int k_hi = a.causal ? min(q_last, a.Skv - 1) : a.Skv - 1;
  const int k_lo = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;

  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  auto stage_kv = [&](int t, int buf) {
    const int k0 = t * TK;
    stage_rows<DP, DQ_THREADS>(
        ks + buf * TK * DP, TK, a.D, vec,
        [&](int r) -> const bf16* {
          return k0 + r < a.Skv ? kp + (long long)(k0 + r) * st.k[2] : nullptr;
        },
        k);
    stage_rows<DP, DQ_THREADS>(
        vs + buf * TK * DP, TK, a.D, vec,
        [&](int r) -> const bf16* {
          return k0 + r < a.Skv ? vp + (long long)(k0 + r) * st.v[2] : nullptr;
        },
        v);
    cp_commit();
  };

  const int t0 = k_lo / TK, t1 = k_hi >= k_lo ? k_hi / TK : t0 - 1;
  if (t0 <= t1) stage_kv(t0, 0);
  const uint32_t q_base = smem_u32(qs), g_base = smem_u32(gs);
  for (int t = t0; t <= t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t < t1) {
      stage_kv(t + 1, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = t * TK;
    if (k0 <= u_hi && k0 + TK - 1 >= u_lo) {  // warp-uniform
      const uint32_t k_base = smem_u32(ks + buf * TK * DP);
      const uint32_t v_base = smem_u32(vs + buf * TK * DP);
      // S = Q K^T and dP = g V^T: 16 rows x TK keys
      float s[TK / 8][4], dp[TK / 8][4];
#pragma unroll
      for (int n = 0; n < TK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        // Q and g fragments from shared memory (held in registers they
        // would leave too few for four blocks an SM at D = 64)
        uint32_t aq[4], ag[4];
        ldsm_x4(aq, frag_a<DP>(q_base, warp * 16, kk, lane));
        ldsm_x4(ag, frag_a<DP>(g_base, warp * 16, kk, lane));
#pragma unroll
        for (int n2 = 0; n2 < TK / 16; ++n2) {
          uint32_t bk[4], bv[4];
          ldsm_x4(bk, frag_b<DP>(k_base, n2 * 16, kk, lane));
          mma_bf16(s[2 * n2], aq, bk[0], bk[1]);
          mma_bf16(s[2 * n2 + 1], aq, bk[2], bk[3]);
          ldsm_x4(bv, frag_b<DP>(v_base, n2 * 16, kk, lane));
          mma_bf16(dp[2 * n2], ag, bv[0], bv[1]);
          mma_bf16(dp[2 * n2 + 1], ag, bv[2], bv[3]);
        }
      }
      // P and dS; element e of n-block n is key k0 + 8n + 2tq + (e & 1) of
      // row gq (e < 2) or gq + 8
      const bool masked = !(k0 >= i_lo && k0 + TK - 1 <= i_hi);  // warp-uniform
#pragma unroll
      for (int n = 0; n < TK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1, key = k0 + 8 * n + 2 * tq + (e & 1);
          float p = exp2_ftz(fmaf(s[n][e], a.scale_log2, -l2[i]));
          if (masked && (key < lo[i] || key > hi[i])) p = 0.f;
          s[n][e] = p * (dp[n][e] - dlt[i]);
        }
      // dQ += dS K: dS's accumulator fragments repacked as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint32_t ad[4] = {pack_term<false>(s[2 * kk][0], s[2 * kk][1]),
                                pack_term<false>(s[2 * kk][2], s[2 * kk][3]),
                                pack_term<false>(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_term<false>(s[2 * kk + 1][2], s[2 * kk + 1][3])};
        uint32_t adl[4];
        if constexpr (SPLIT) {
          adl[0] = pack_term<true>(s[2 * kk][0], s[2 * kk][1]);
          adl[1] = pack_term<true>(s[2 * kk][2], s[2 * kk][3]);
          adl[2] = pack_term<true>(s[2 * kk + 1][0], s[2 * kk + 1][1]);
          adl[3] = pack_term<true>(s[2 * kk + 1][2], s[2 * kk + 1][3]);
        }
#pragma unroll
        for (int n2 = 0; n2 < DP / 16; ++n2) {
          uint32_t bk[4];
          ldsm_x4_t(bk, frag_bt<DP>(k_base, kk, n2, lane));
          mma_bf16(acc[2 * n2], ad, bk[0], bk[1]);
          mma_bf16(acc[2 * n2 + 1], ad, bk[2], bk[3]);
          if constexpr (SPLIT) {
            mma_bf16(acc[2 * n2], adl, bk[0], bk[1]);
            mma_bf16(acc[2 * n2 + 1], adl, bk[2], bk[3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed before it is staged again
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qpos = q0 + warp * 16 + gq + 8 * i;
    if (qpos >= a.Sq) continue;
    bf16* dqp = dq + b * st.dq[0] + h * st.dq[1] + qpos * st.dq[2];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d >= a.D) break;
      const float x0 = acc[n][2 * i] * a.scale, x1 = acc[n][2 * i + 1] * a.scale;
      if (vec) {
        *reinterpret_cast<__nv_bfloat162*>(dqp + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        dqp[d] = __float2bfloat16_rn(x0);
        if (d + 1 < a.D) dqp[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

// ---------------------------------------------------- float32: CUDA cores
constexpr int BQ = 32;      // query rows per tile
constexpr int BK = 32;      // keys per tile: one per lane
constexpr int DPT = 16;     // head dims per thread in the accumulations
constexpr int PS = BK + 1;  // pitch of the transposed and the P / dS tiles

// 32 rows from position r0 on, row-major with pitch DP: zero past S or D
template <int DP, int NT>
__device__ __forceinline__ void stage_rows_f32(float* dst, const float* src, long long stride,
                                               int r0, int S, int D) {
  for (int i = threadIdx.x; i < 32 * DP; i += NT) {
    const int r = i / DP, d = i - r * DP, pos = r0 + r;
    dst[i] = pos < S && d < D ? src[pos * stride + d] : 0.f;
  }
}

// the same 32 rows transposed, dst[d * PS + r]
template <int DP, int NT>
__device__ __forceinline__ void stage_cols_f32(float* dst, const float* src, long long stride,
                                               int r0, int S, int D) {
  for (int i = threadIdx.x; i < 32 * DP; i += NT) {
    const int r = i / DP, d = i - r * DP, pos = r0 + r;
    dst[d * PS + r] = pos < S && d < D ? src[pos * stride + d] : 0.f;
  }
}

// s[r] = sum_d A[(row0 + r) * DP + d] * Bt[d * PS + lane], d in order
template <int R, int DP>
__device__ __forceinline__ void dots(float (&s)[R], const float* A, int row0, const float* Bt,
                                     int lane) {
#pragma unroll
  for (int r = 0; r < R; ++r) s[r] = 0.f;
#pragma unroll 2
  for (int d = 0; d < DP; d += 4) {
    const float b0 = Bt[d * PS + lane], b1 = Bt[(d + 1) * PS + lane];
    const float b2 = Bt[(d + 2) * PS + lane], b3 = Bt[(d + 3) * PS + lane];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float4 x = *reinterpret_cast<const float4*>(A + (row0 + r) * DP + d);
      s[r] = fmaf(x.x, b0, s[r]);
      s[r] = fmaf(x.y, b1, s[r]);
      s[r] = fmaf(x.z, b2, s[r]);
      s[r] = fmaf(x.w, b3, s[r]);
    }
  }
}

// acc[e] += w * row[e] for this thread's 16 dims of one float4-aligned row
__device__ __forceinline__ void axpy16(float (&acc)[DPT], float w, const float* row) {
  const float4* r4 = reinterpret_cast<const float4*>(row);
#pragma unroll
  for (int c = 0; c < DPT / 4; ++c) {
    const float4 x = r4[c];
    acc[4 * c] = fmaf(w, x.x, acc[4 * c]);
    acc[4 * c + 1] = fmaf(w, x.y, acc[4 * c + 1]);
    acc[4 * c + 2] = fmaf(w, x.z, acc[4 * c + 2]);
    acc[4 * c + 3] = fmaf(w, x.w, acc[4 * c + 3]);
  }
}

template <int NW>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * BQ * NW * DPT + 2 * NW * DPT * PS + 2 * BQ * PS + 2 * BQ);
}

template <int NW>
__global__ void __launch_bounds__(NW * 32)
fa_bwd_dkdv(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ g,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, Args a) {
  constexpr int DP = NW * DPT, R = BQ / NW, NT = NW * 32;
  extern __shared__ float4 smem_dkdv[];
  float* qs = reinterpret_cast<float*>(smem_dkdv);  // BQ x DP
  float* gs = qs + BQ * DP;                         // BQ x DP
  float* kt = gs + BQ * DP;                         // DP x PS
  float* vt = kt + DP * PS;                         // DP x PS
  float* ps = vt + DP * PS;                         // BQ x PS: P
  float* dss = ps + BQ * PS;                        // BQ x PS: dS
  float* ls = dss + BQ * PS;                        // BQ: lse
  float* dl = ls + BQ;                              // BQ: delta

  const int k0 = blockIdx.x * BK, hk = blockIdx.y, b = blockIdx.z;
  const int G = a.H / a.Hkv;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, row0 = warp * R;
  const int d0 = warp * DPT, key = k0 + lane;
  const Strides& st = a.st;
  stage_cols_f32<DP, NT>(kt, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, a.Skv, a.D);
  stage_cols_f32<DP, NT>(vt, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, a.Skv, a.D);

  // query rows that can see a key of the tile
  const int k_last = min(k0 + BK, a.Skv) - 1;
  const int i_lo = a.causal ? k0 : 0;
  const int i_hi = a.window > 0 ? min(a.Sq - 1, k_last + a.window - 1) : a.Sq - 1;

  float acck[DPT], accv[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) acck[e] = accv[e] = 0.f;

  for (int gh = 0; gh < G && i_lo <= i_hi; ++gh) {
    const int h = hk * G + gh;
    const float* qp = q + b * st.q[0] + h * st.q[1];
    const float* gp = g + b * st.g[0] + h * st.g[1];
    const long long row_base = ((long long)b * a.H + h) * a.Sq;
    for (int t = i_lo / BQ; t <= i_hi / BQ; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous pair's tiles are consumed
      stage_rows_f32<DP, NT>(qs, qp, st.q[2], q0, a.Sq, a.D);
      stage_rows_f32<DP, NT>(gs, gp, st.g[2], q0, a.Sq, a.D);
      if (threadIdx.x < BQ) {
        const int qpos = q0 + threadIdx.x;
        ls[threadIdx.x] = qpos < a.Sq ? lse[lse_at(a, b, h) + qpos] : 0.f;
        dl[threadIdx.x] = qpos < a.Sq ? delta[row_base + qpos] : 0.f;
      }
      __syncthreads();
      float s[R], dp[R];
      dots<R, DP>(s, qs, row0, kt, lane);
      dots<R, DP>(dp, gs, row0, vt, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = row0 + r;
        const float p = visible(a, q0 + i, key) ? expf(s[r] * a.scale - ls[i]) : 0.f;
        ps[i * PS + lane] = p;
        dss[i * PS + lane] = p * (dp[r] - dl[i]);
      }
      __syncthreads();
      // the pair's 32 terms summed apart, then added to the running sums:
      // a chain of G * Sq / 32 adds instead of G * Sq (float32 error)
      float pk[DPT], pv[DPT];
#pragma unroll
      for (int e = 0; e < DPT; ++e) pk[e] = pv[e] = 0.f;
#pragma unroll 4
      for (int i = 0; i < BQ; ++i) {
        axpy16(pv, ps[i * PS + lane], gs + i * DP + d0);
        axpy16(pk, dss[i * PS + lane], qs + i * DP + d0);
      }
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        acck[e] += pk[e];
        accv[e] += pv[e];
      }
    }
  }

  if (key < a.Skv) {
    float* dkp = dk + b * st.dk[0] + hk * st.dk[1] + key * st.dk[2];
    float* dvp = dv + b * st.dv[0] + hk * st.dv[1] + key * st.dv[2];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = d0 + e;
      if (d < a.D) {
        dkp[d] = acck[e] * a.scale;
        dvp[d] = accv[e];
      }
    }
  }
}

template <int NW>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (2 * BQ * NW * DPT + 2 * NW * DPT * PS + BK * NW * DPT + BQ * PS + 2 * BQ);
}

template <int NW>
__global__ void __launch_bounds__(NW * 32)
fa_bwd_dq(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ g, const float* __restrict__ lse,
          const float* __restrict__ delta, float* __restrict__ dq, Args a) {
  constexpr int DP = NW * DPT, R = BQ / NW, NT = NW * 32;
  extern __shared__ float4 smem_dq_f32[];
  float* qs = reinterpret_cast<float*>(smem_dq_f32);  // BQ x DP
  float* gs = qs + BQ * DP;                           // BQ x DP
  float* ks = gs + BQ * DP;                           // BK x DP (row-major)
  float* kt = ks + BK * DP;                           // DP x PS
  float* vt = kt + DP * PS;                           // DP x PS
  float* dss = vt + DP * PS;                          // BQ x PS: dS
  float* ls = dss + BQ * PS;                          // BQ: lse
  float* dl = ls + BQ;                                // BQ: delta

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, row0 = warp * R;
  const int d0 = warp * DPT;
  const Strides& st = a.st;
  stage_rows_f32<DP, NT>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, a.Sq, a.D);
  stage_rows_f32<DP, NT>(gs, g + b * st.g[0] + h * st.g[1], st.g[2], q0, a.Sq, a.D);
  if (threadIdx.x < BQ) {
    const int qpos = q0 + threadIdx.x;
    ls[threadIdx.x] = qpos < a.Sq ? lse[lse_at(a, b, h) + qpos] : 0.f;
    dl[threadIdx.x] = qpos < a.Sq ? delta[((long long)b * a.H + h) * a.Sq + qpos] : 0.f;
  }
  const float* kp = k + b * st.k[0] + hk * st.k[1];
  const float* vp = v + b * st.v[0] + hk * st.v[1];

  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_hi = a.causal ? min(q_last, a.Skv - 1) : a.Skv - 1;
  const int k_lo = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;

  float accq[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) accq[e] = 0.f;
  if (k_hi >= k_lo) {
    for (int t = k_lo / BK; t <= k_hi / BK; ++t) {
      const int k0 = t * BK;
      __syncthreads();  // the previous tile is consumed (and Q, g are staged)
      stage_rows_f32<DP, NT>(ks, kp, st.k[2], k0, a.Skv, a.D);
      stage_cols_f32<DP, NT>(kt, kp, st.k[2], k0, a.Skv, a.D);
      stage_cols_f32<DP, NT>(vt, vp, st.v[2], k0, a.Skv, a.D);
      __syncthreads();
      float s[R], dp[R];
      dots<R, DP>(s, qs, row0, kt, lane);
      dots<R, DP>(dp, gs, row0, vt, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = row0 + r;
        const float p = visible(a, q0 + i, k0 + lane) ? expf(s[r] * a.scale - ls[i]) : 0.f;
        dss[i * PS + lane] = p * (dp[r] - dl[i]);
      }
      __syncthreads();
#pragma unroll 4
      for (int j = 0; j < BK; ++j) axpy16(accq, dss[lane * PS + j], ks + j * DP + d0);
    }
  }

  const int qpos = q0 + lane;
  if (qpos < a.Sq) {
    float* dqp = dq + b * st.dq[0] + h * st.dq[1] + qpos * st.dq[2];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = d0 + e;
      if (d < a.D) dqp[d] = accq[e] * a.scale;
    }
  }
}

// ------------------------------------------------------------------ host
template <typename T>
int launch_delta(const T* o, const T* g, float* delta, int B, const Args& a, cudaStream_t s) {
  constexpr int CE = 16 / sizeof(T);
  bool vec = a.D % CE == 0 && aligned16(o) && aligned16(g);
  for (int i = 0; i < 3; ++i) vec = vec && a.st.o[i] % CE == 0 && a.st.g[i] % CE == 0;
  const dim3 grid((unsigned)((a.Sq + DELTA_ROWS - 1) / DELTA_ROWS), a.H, B);
  fa_bwd_delta<T><<<grid, DELTA_THREADS, 0, s>>>(o, g, delta, a, vec);
  return (int)cudaGetLastError();
}

template <int NW>
int launch_f32(const float* q, const float* k, const float* v, const float* o, const float* g,
               float* dq, float* dk, float* dv, const float* lse, float* delta, int B,
               const Args& a, cudaStream_t stream) {
  static bool opted[2][MAX_DEVICES] = {};
  cudaError_t e = opt_in(fa_bwd_dkdv<NW>, dkdv_smem<NW>(), opted[0]);
  if (e == cudaSuccess) e = opt_in(fa_bwd_dq<NW>, dq_smem<NW>(), opted[1]);
  if (e != cudaSuccess) return (int)e;
  if (const int rc = launch_delta(o, g, delta, B, a, stream)) return rc;
  const unsigned q_tiles = (unsigned)((a.Sq + BQ - 1) / BQ);
  const unsigned k_tiles = (unsigned)((a.Skv + BK - 1) / BK);
  if (k_tiles > 0) {
    fa_bwd_dkdv<NW><<<dim3(k_tiles, a.Hkv, B), NW * 32, dkdv_smem<NW>(), stream>>>(
        q, k, v, g, lse, delta, dk, dv, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  fa_bwd_dq<NW><<<dim3(q_tiles, a.H, B), NW * 32, dq_smem<NW>(), stream>>>(
      q, k, v, g, lse, delta, dq, a);
  return (int)cudaGetLastError();
}

template <int DP, int BQT, int TK, bool SPLIT = false>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const bf16* o, const bf16* g,
              bf16* dq, bf16* dk, bf16* dv, const float* lse, float* delta, float* work,
              int nsplit, int B, const Args& a, int vec, cudaStream_t stream) {
  static bool opted[2][MAX_DEVICES] = {};
  cudaError_t e = opt_in(fa_bwd_dkdv_tc<DP, BQT, SPLIT>, kv_smem<DP, BQT, SPLIT>(), opted[0]);
  if (e == cudaSuccess)
    e = opt_in(fa_bwd_dq_tc<DP, TK, SPLIT>, dq_tc_smem<DP, TK>(), opted[1]);
  if (e != cudaSuccess) return (int)e;
  if (const int rc = launch_delta(o, g, delta, B, a, stream)) return rc;
  const unsigned k_tiles = (unsigned)((a.Skv + BKV - 1) / BKV);
  if (k_tiles > 0) {
    fa_bwd_dkdv_tc<DP, BQT, SPLIT>
        <<<dim3(a.Hkv * nsplit, B, k_tiles), KV_THREADS, kv_smem<DP, BQT, SPLIT>(), stream>>>(
            q, k, v, g, lse, delta, dk, dv, work, nsplit, B, a, vec);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    if (nsplit > 1) {
      const long long n = (long long)B * a.Hkv * a.Skv * a.D;
      const unsigned blocks = (unsigned)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
      fa_bwd_reduce<<<blocks, 256, 0, stream>>>(work, dk, dv, nsplit, B, a);
      if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
    }
  }
  const unsigned q_tiles = (unsigned)((a.Sq + DQ_M - 1) / DQ_M);
  fa_bwd_dq_tc<DP, TK, SPLIT><<<dim3(a.H, B, q_tiles), DQ_THREADS, dq_tc_smem<DP, TK>(), stream>>>(
      q, k, v, g, lse, delta, dq, a, vec);
  return (int)cudaGetLastError();
}

int make_args(int H, int Hkv, int Sq, int Skv, int D, const long long* strides, int causal,
              int window, float scale, Args& a) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  a = Args{H, Hkv, Sq, Skv, D, causal, window, scale, scale * LOG2E, {}};
  long long* dst[8] = {a.st.q, a.st.k, a.st.v, a.st.o, a.st.g, a.st.dq, a.st.dk, a.st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  a.st.lse[0] = strides[24];
  a.st.lse[1] = strides[25];
  return 0;
}

}  // namespace

extern "C" {

// The number of blocks the bf16 dk/dv pass splits each KV head's G query
// heads over: 1 while B x Hkv x key tiles fills the card's SMs, else the
// least power of two (at most G) that does. The caller allocates
// flash_attention_bwd_bf16's `work` for it.
int flash_attention_bwd_splits(int B, int Hkv, int Skv, int G) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  const long long blocks = (long long)B * Hkv * ((Skv + BKV - 1) / BKV);
  int n = 1;
  while (n < G && blocks * n < sms) n *= 2;
  return n < G ? n : G;
}

// strides: 26 element strides, (batch, head, seq) of q, k, v, o, g, dq, dk
// and dv in turn, then the (batch, head) strides of lse. lse: K4's float32
// (B, H, Sq) row statistics (see the header); delta: float32 (B, H, Sq)
// scratch; work: float32 (nsplit, 2, B, Hkv, Skv, D) scratch for the
// split heads' partials (null when nsplit is 1; the float32 kernel takes
// nsplit 1 only)
int flash_attention_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                            const float* g, float* dq, float* dk, float* dv, const float* lse,
                            float* delta, float* work, int B, int H, int Hkv, int Sq, int Skv,
                            int D, const long long* strides, int causal, int window,
                            float scale, int nsplit, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  Args a;
  if (const int rc = make_args(H, Hkv, Sq, Skv, D, strides, causal, window, scale, a)) return rc;
  if (nsplit != 1 || work != nullptr) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64) return launch_f32<4>(q, k, v, o, g, dq, dk, dv, lse, delta, B, a, s);
  if (D <= 128) return launch_f32<8>(q, k, v, o, g, dq, dk, dv, lse, delta, B, a, s);
  return launch_f32<16>(q, k, v, o, g, dq, dk, dv, lse, delta, B, a, s);
}

int flash_attention_bwd_bf16(const bf16* q, const bf16* k, const bf16* v, const bf16* o,
                             const bf16* g, bf16* dq, bf16* dk, bf16* dv, const float* lse,
                             float* delta, float* work, int B, int H, int Hkv, int Sq, int Skv,
                             int D, const long long* strides, int causal, int window,
                             float scale, int nsplit, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  Args a;
  if (const int rc = make_args(H, Hkv, Sq, Skv, D, strides, causal, window, scale, a)) return rc;
  if (nsplit < 1 || nsplit > H / Hkv || (nsplit > 1) != (work != nullptr))
    return (int)cudaErrorInvalidValue;
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(g) &&
             aligned16(dq) && aligned16(dk) && aligned16(dv);
  for (int i = 0; i < 24; ++i) vec = vec && strides[i] % 8 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (D < 16)
    return launch_tc<64, 64, 64, true>(q, k, v, o, g, dq, dk, dv, lse, delta, work, nsplit, B,
                                       a, vec, s);
  if (D <= 64)
    return launch_tc<64, 64, 64>(q, k, v, o, g, dq, dk, dv, lse, delta, work, nsplit, B, a, vec,
                                 s);
  if (D <= 128)
    return launch_tc<128, 64, 64>(q, k, v, o, g, dq, dk, dv, lse, delta, work, nsplit, B, a,
                                  vec, s);
  return launch_tc<256, 64, 16>(q, k, v, o, g, dq, dk, dv, lse, delta, work, nsplit, B, a, vec,
                                s);
}

}  // extern "C"
