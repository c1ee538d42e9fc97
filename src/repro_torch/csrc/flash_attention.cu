// Flash attention, causal or local-window, GQA: out = softmax(q k^T * scale) v.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (_fa_kernel), the Pallas TPU kernel behind modeling/attention.py's prefill
// path. q: (B, H, Sq, D), k/v: (B, Hkv, Skv, D), any strides with a
// contiguous last dimension, 1 <= D <= 256; query head h reads K/V head
// h / (H / Hkv). The output is written in q's dtype through its own strides,
// so the model's (B, S, H, D) tensors are read and written in place of a
// transpose. Query i sees key j when j <= i (causal) and j > i - window
// (window > 0). Masked (q, k) pairs contribute exactly 0, a row with no live
// key gives 0, the online softmax state (m, l) is float32 and the row is
// divided by max(l, 1e-30) at the end, as in the TPU kernel. Key tiles that
// no row of a block can see (beyond the causal diagonal or before the
// window) are never loaded, as in the TPU kernel's pl.when(live).
//
// Each dtype runs its own design:
//
// bf16 (the serving path): a tensor-core kernel in the FlashAttention-2
// structure. Queries are packed G = H / Hkv heads to a position, so one
// block's 128 rows are (position, head) pairs sharing one KV head, and K/V
// are read once per block rather than once per head. Each of the 8 warps
// owns 16 rows. Q K^T runs on mma.sync m16n8k16 (bf16 in, float32
// accumulate) with Q and K fragments from ldmatrix; the float32 score
// fragments stay in registers for the online softmax (the scale times
// log2(e) folded into one FMA before ex2.approx; the mask is applied only
// on tiles that cross a row's diagonal or window edge); they are then
// repacked as bf16 A fragments for P V, with V read through ldmatrix.trans,
// so P never goes through shared memory. Rounding P to bf16 before P V is
// what the reference's XLA attention does (src/repro/modeling/
// attention.py). K/V tiles of 64 keys (32 at D > 128) are double-buffered
// with cp.async in a shared-memory layout whose 16-byte chunks are
// XOR-swizzled by row, so ldmatrix reads 8 rows without a bank conflict. Head dims are zero-padded
// to 64, 128 or 256 in shared memory (zeros add nothing to either product;
// the loops run over the padded width, whose trip counts are compile-time
// constants, so loads and products interleave). What bounds it: at the
// serving shape (32 positions, 8 KV heads: 8 blocks) the latency of one
// launch; at long prefill the issue of mma.sync and of the softmax's
// per-score instructions, with every warp reading the whole K/V tile from
// shared memory for its 16 rows (32 rows a warp ran out of registers).
// Hopper's wgmma, with a warpgroup's 64 rows on one tile, is the next step.
//
// float32: CUDA cores, one block of 4 warps per (b, h, 32-row query block),
// 8 rows per warp; K and V tiles of 32 keys staged as float32 (K rows padded
// to D + 1 floats, so lane j reading key j's row walks 32 distinct banks);
// per row, 32 scores (one per lane), warp-shuffle max and sum, and P V with
// lane j owning output dims j, j + 32, .... It serves the full-width
// float32 parity of the models against their CPU copies (1e-4), which the
// tensor cores' TF32 would break. What bounds it: the shared-memory reads of
// the scalar dot products.
//
// Row statistics: given a non-null `lse` (float32, element (b, h, i) at
// b * lse_sb + h * lse_sh + i), both kernels also write each row's
// log-sum-exp of its visible scaled scores in natural-log units,
// lse = log(sum_j exp(scale * q_i . k_j)) (the plain version's
// `return_lse`; the bf16 kernel's log2-unit running max is converted at the
// end), and +inf for a row with no visible key, so that every
// exp(scale * s - lse) of such a row is exactly 0. K4b reads it for its P.
// With a null `lse` nothing else changes (the serving path passes null).
//
// The tensor-core helpers (staging, swizzle, ldmatrix, mma.sync) are in
// fa_mma.cuh, shared with the backward. This file is built without
// -fmad=false (as flash_attention_bwd.cu and decode_attention.cu are): the
// softmax's scale and shift are one FMA by design, and the float32 kernel's
// parity is a tolerance, not bit-equality.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fa_mma.cuh"

namespace {

constexpr float LN2 = 0.6931471805599453f;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (batch, head, seq) element strides
  long long lse[2];                  // (batch, head) of lse, when given
};

// ================================================== float32: CUDA cores
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 8;           // query rows per warp
constexpr int BQ = WARPS * ROWS;  // query rows per block
constexpr int BK = 32;            // keys per tile: one per lane

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// butterfly sum: lanes i and i ^ o add the same two values, so every lane
// ends with the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

size_t f32_smem(int D) {
  return sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D);
}

template <int DPL>
__global__ void __launch_bounds__(THREADS)
fa_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
              int H, int Hkv, int Sq, int Skv, int D, Strides st, int causal, int window,
              float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qs = smem;              // BQ x D
  float* ks = qs + BQ * D;       // BK x (D + 1)
  float* vs = ks + BK * DP;      // BK x D

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* qp = q + b * st.q[0] + h * st.q[1];
  const float* kp = k + b * st.k[0] + hk * st.k[1];
  const float* vp = v + b * st.v[0] + hk * st.v[1];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int qpos = q0 + r;
    qs[i] = qpos < Sq ? qp[qpos * st.q[2] + d] : 0.f;
  }

  // keys any row of the block can see
  const int q_last = min(q0 + BQ, Sq) - 1;
  const int k_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int k_lo = window > 0 ? max(q0 - window + 1, 0) : 0;

  float m[ROWS], l[ROWS], acc[ROWS][DPL];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  if (k_hi >= k_lo) {
    for (int t = k_lo / BK; t <= k_hi / BK; ++t) {
      const int k0 = t * BK;
      __syncthreads();  // the previous tile is consumed (and Q is staged)
      for (int i = tid; i < BK * D; i += THREADS) {
        const int r = i / D, d = i - r * D;
        const int kpos = k0 + r;
        const bool in = kpos < Skv;
        ks[r * DP + d] = in ? kp[kpos * st.k[2] + d] : 0.f;
        vs[i] = in ? vp[kpos * st.v[2] + d] : 0.f;
      }
      __syncthreads();
      const int kpos = k0 + lane;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int row = warp * ROWS + r;
        const int qpos = q0 + row;
        const int lo = window > 0 ? qpos - window + 1 : 0;
        const int hi = min(causal ? qpos : Skv - 1, Skv - 1);
        // warp-uniform: a padded row, or no live key of this row in the tile
        if (qpos >= Sq || k0 > hi || k0 + BK - 1 < lo) continue;
        const float* qr = qs + row * D;
        const float* kr = ks + lane * DP;
        float s = 0.f;
#pragma unroll 8
        for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
        s *= scale;
        const bool valid = kpos >= lo && kpos <= hi;
        s = valid ? s : NEG_INF;
        const float m_new = fmaxf(m[r], warp_max(s));
        const float p = valid ? expf(s - m_new) : 0.f;
        const float alpha = expf(m[r] - m_new);
        l[r] = alpha * l[r] + warp_sum(p);
        m[r] = m_new;
#pragma unroll
        for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll 4
        for (int j = 0; j < BK; ++j) {
          const float pj = __shfl_sync(FULL, p, j);
          const float* vr = vs + j * D;
#pragma unroll
          for (int i = 0; i < DPL; ++i) {
            const int d = lane + 32 * i;
            if (d < D) acc[r][i] = fmaf(pj, vr[d], acc[r][i]);
          }
        }
      }
    }
  }

  float* op = o + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= Sq) continue;
    if (lse != nullptr && lane == 0)  // m and l are the same in every lane
      lse[b * st.lse[0] + h * st.lse[1] + qpos] = l[r] > 0.f ? m[r] + logf(l[r]) : CUDART_INF_F;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) op[qpos * st.o[2] + d] = acc[r][i] / denom;
    }
  }
}

template <int DPL>
int launch_f32(const float* q, const float* k, const float* v, float* o, float* lse, int B,
               int H, int Hkv, int Sq, int Skv, int D, const Strides& st, int causal,
               int window, float scale, cudaStream_t stream) {
  static bool opted_in[MAX_DEVICES] = {};
  const cudaError_t e = opt_in(fa_f32_kernel<DPL>, f32_smem(32 * DPL), opted_in);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_f32_kernel<DPL><<<grid, THREADS, f32_smem(D), stream>>>(
      q, k, v, o, lse, H, Hkv, Sq, Skv, D, st, causal, window, scale);
  return (int)cudaGetLastError();
}

// ================================================ bf16: tensor cores
constexpr int TC_WARPS = 8;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_M = TC_WARPS * 16;  // packed (position, head) rows per block

template <int DP, int TK>
size_t tc_smem() {  // Q, then K and V double-buffered
  return sizeof(bf16) * ((size_t)TC_M * DP + 4 * (size_t)TK * DP);
}

// LSE: write the rows' log-sum-exp (its own instantiation, so the serving
// path's kernel, which writes none, carries none of its code or registers)
template <int DP, int TK, bool LSE>
__global__ void __launch_bounds__(TC_THREADS)
fa_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
             const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse, int H,
             int Hkv, int Sq, int Skv, int D, Strides st, int causal, int window,
             float scale_log2, int vec) {
  constexpr bool QREG = DP <= 128;  // Q fragments held in registers
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // TC_M x DP
  bf16* ks = qs + TC_M * DP;                    // 2 x TK x DP
  bf16* vs = ks + 2 * TK * DP;                  // 2 x TK x DP

  const int G = H / Hkv, rows_total = G * Sq;
  const int p0 = (gridDim.x - 1 - blockIdx.x) * TC_M;  // the longest rows first
  const int hk = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const bf16* kp = k + b * st.k[0] + hk * st.k[1];
  const bf16* vp = v + b * st.v[0] + hk * st.v[1];

  // packed row p: query head hk * G + p % G at position p / G
  stage_rows<DP, TC_THREADS>(
      qs, TC_M, D, vec,
      [&](int r) -> const bf16* {
        const int p = p0 + r;
        if (p >= rows_total) return nullptr;
        return q + b * st.q[0] + (long long)(hk * G + p % G) * st.q[1] +
               (long long)(p / G) * st.q[2];
      },
      q);
  cp_commit();

  // keys any row of the block can see
  const int q_first = p0 / G, q_last = (min(p0 + TC_M, rows_total) - 1) / G;
  const int k_hi = causal ? min(q_last, Skv - 1) : Skv - 1;
  const int k_lo = window > 0 ? max(q_first - window + 1, 0) : 0;

  // this thread's rows gq and gq + 8 of the warp's 16: their live key range
  int lo[2], hi[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = p0 + warp * 16 + gq + 8 * i;
    if (p < rows_total) {
      const int qpos = p / G;
      lo[i] = window > 0 ? max(qpos - window + 1, 0) : 0;
      hi[i] = causal ? min(qpos, Skv - 1) : Skv - 1;
    } else {
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

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[QREG ? DP / 16 : 1][4];

  auto stage_kv = [&](int t, int buf) {
    const int k0 = t * TK;
    stage_rows<DP, TC_THREADS>(
        ks + buf * TK * DP, TK, D, vec,
        [&](int r) -> const bf16* {
          return k0 + r < Skv ? kp + (long long)(k0 + r) * st.k[2] : nullptr;
        },
        k);
    stage_rows<DP, TC_THREADS>(
        vs + buf * TK * DP, TK, D, vec,
        [&](int r) -> const bf16* {
          return k0 + r < Skv ? vp + (long long)(k0 + r) * st.v[2] : nullptr;
        },
        v);
    cp_commit();
  };

  const int t0 = k_lo / TK, t1 = k_hi >= k_lo ? k_hi / TK : t0 - 1;
  if (t0 <= t1) stage_kv(t0, 0);
  const uint32_t q_base = smem_u32(qs);
  for (int t = t0; t <= t1; ++t) {
    const int buf = (t - t0) & 1;
    if (t < t1) {
      stage_kv(t + 1, buf ^ 1);
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if constexpr (QREG) {
      if (t == t0) {
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          ldsm_x4(qf[kk], frag_a<DP>(q_base, warp * 16, kk, lane));
      }
    }
    const int k0 = t * TK;
    if (k0 <= u_hi && k0 + TK - 1 >= u_lo) {  // warp-uniform
      const uint32_t k_base = smem_u32(ks + buf * TK * DP);
      const uint32_t v_base = smem_u32(vs + buf * TK * DP);
      // S = Q K^T: 16 rows x TK keys, 8 keys per n-block
      float s[TK / 8][4];
#pragma unroll
      for (int n = 0; n < TK / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk) {
        uint32_t a[4];
        if constexpr (QREG) {
#pragma unroll
          for (int j = 0; j < 4; ++j) a[j] = qf[kk][j];
        } else {
          ldsm_x4(a, frag_a<DP>(q_base, warp * 16, kk, lane));
        }
#pragma unroll
        for (int n2 = 0; n2 < TK / 16; ++n2) {
          uint32_t bk[4];
          ldsm_x4(bk, frag_b<DP>(k_base, n2 * 16, kk, lane));
          mma_bf16(s[2 * n2], a, bk[0], bk[1]);
          mma_bf16(s[2 * n2 + 1], a, bk[2], bk[3]);
        }
      }
      // online softmax; element e of n-block n is key k0 + 8n + 2tq + (e & 1)
      // of row gq (e < 2) or gq + 8
      const bool masked = !(k0 >= i_lo && k0 + TK - 1 <= i_hi);  // warp-uniform
      if (masked) {
#pragma unroll
        for (int n = 0; n < TK / 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = k0 + 8 * n + 2 * tq + (e & 1);
            const int i = e >> 1;
            if (key < lo[i] || key > hi[i]) s[n][e] = NEG_INF;
          }
      }
      float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
      for (int n = 0; n < TK / 8; ++n) {
        mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
      }
      float alpha[2], neg_m[2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {  // the 4 threads of a quad share a row
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
        mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
        // a masked score stays NEG_INF, not scaled: it never sets the max
        const float m_new = fmaxf(m[i], mx[i] == NEG_INF ? NEG_INF : mx[i] * scale_log2);
        alpha[i] = exp2_ftz(m[i] - m_new);
        m[i] = m_new;
        neg_m[i] = -m_new;
        l[i] *= alpha[i];
      }
#pragma unroll
      for (int n = 0; n < TK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          float p = exp2_ftz(fmaf(s[n][e], scale_log2, neg_m[i]));
          // a masked key gives 0, also in a row with no live key so far
          if (masked && s[n][e] == NEG_INF) p = 0.f;
          s[n][e] = p;
          l[i] += p;
        }
#pragma unroll
      for (int n = 0; n < DP / 8; ++n) {
        acc[n][0] *= alpha[0];
        acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1];
        acc[n][3] *= alpha[1];
      }
      // O += P V: P's accumulator fragments repacked as bf16 A fragments
#pragma unroll
      for (int kk = 0; kk < TK / 16; ++kk) {
        const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                               pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                               pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                               pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int n2 = 0; n2 < DP / 16; ++n2) {
          uint32_t bv[4];
          ldsm_x4_t(bv, frag_bt<DP>(v_base, kk, n2, lane));
          mma_bf16(acc[2 * n2], a, bv[0], bv[1]);
          mma_bf16(acc[2 * n2 + 1], a, bv[2], bv[3]);
        }
      }
    }
    __syncthreads();  // this buffer is consumed before it is staged again
  }
  cp_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(FULL, li, 1);
    li += __shfl_xor_sync(FULL, li, 2);
    const int p = p0 + warp * 16 + gq + 8 * i;
    if (p >= rows_total) continue;
    // m is in log2 units; the quad's 4 threads hold the same m and l
    if (LSE && tq == 0)
      lse[b * st.lse[0] + (long long)(hk * G + p % G) * st.lse[1] + p / G] =
          li > 0.f ? (m[i] + log2f(li)) * LN2 : CUDART_INF_F;
    const float inv = 1.f / fmaxf(li, 1e-30f);
    bf16* op = o + b * st.o[0] + (long long)(hk * G + p % G) * st.o[1] +
               (long long)(p / G) * st.o[2];
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      if (d >= D) break;
      const float x0 = acc[n][2 * i] * inv, x1 = acc[n][2 * i + 1] * inv;
      if (vec) {
        *reinterpret_cast<__nv_bfloat162*>(op + d) = __floats2bfloat162_rn(x0, x1);
      } else {
        op[d] = __float2bfloat16_rn(x0);
        if (d + 1 < D) op[d + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int DP, int TK, bool LSE>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B, int H,
              int Hkv, int Sq, int Skv, int D, const Strides& st, int causal, int window,
              float scale, int vec, cudaStream_t stream) {
  static bool opted_in[MAX_DEVICES] = {};
  const size_t smem = tc_smem<DP, TK>();
  const cudaError_t e = opt_in(fa_tc_kernel<DP, TK, LSE>, smem, opted_in);
  if (e != cudaSuccess) return (int)e;
  const long long rows = (long long)(H / Hkv) * Sq;
  const dim3 grid((unsigned)((rows + TC_M - 1) / TC_M), Hkv, B);
  const float scale_log2 = scale * 1.4426950408889634f;
  fa_tc_kernel<DP, TK, LSE><<<grid, TC_THREADS, smem, stream>>>(
      q, k, v, o, lse, H, Hkv, Sq, Skv, D, st, causal, window, scale_log2, vec);
  return (int)cudaGetLastError();
}

// the tensor-core kernel's tiles by head dim
template <bool LSE>
int launch_tc_dp(const bf16* q, const bf16* k, const bf16* v, bf16* o, float* lse, int B, int H,
                 int Hkv, int Sq, int Skv, int D, const Strides& st, int causal, int window,
                 float scale, int vec, cudaStream_t s) {
  if (D <= 64)
    return launch_tc<64, 64, LSE>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, causal, window,
                                  scale, vec, s);
  if (D <= 128)
    return launch_tc<128, 64, LSE>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, causal, window,
                                   scale, vec, s);
  return launch_tc<256, 32, LSE>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, causal, window,
                                 scale, vec, s);
}

int check_args(int B, int H, int Hkv, int Sq, int D, const long long* strides, bool has_lse,
               Strides& st) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  st.lse[0] = has_lse ? strides[12] : 0;
  st.lse[1] = has_lse ? strides[13] : 0;
  return 0;
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, seq) of q, k, v and o in turn,
// then, when lse is not null, its (batch, head) strides (14 in all). lse:
// null, or float32 (B, H, Sq) with a contiguous last dimension, written
// with each row's log-sum-exp (see the header)
int flash_attention_f32(const float* q, const float* k, const float* v, float* o, float* lse,
                        int B, int H, int Hkv, int Sq, int Skv, int D,
                        const long long* strides, int causal, int window, float scale,
                        void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  Strides st;
  if (const int rc = check_args(B, H, Hkv, Sq, D, strides, lse != nullptr, st)) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  const int dpl = (D + 31) / 32;
  if (dpl <= 1)
    return launch_f32<1>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, causal, window, scale, s);
  if (dpl <= 2)
    return launch_f32<2>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, causal, window, scale, s);
  if (dpl <= 4)
    return launch_f32<4>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, causal, window, scale, s);
  return launch_f32<8>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, causal, window, scale, s);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o, float* lse, int B, int H,
                         int Hkv, int Sq, int Skv, int D, const long long* strides, int causal,
                         int window, float scale, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  Strides st;
  if (const int rc = check_args(B, H, Hkv, Sq, D, strides, lse != nullptr, st)) return rc;
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v) && aligned16(o);
  for (int i = 0; i < 12; ++i) vec = vec && strides[i] % 8 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (lse != nullptr) return launch_tc_dp<true>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st,
                                                causal, window, scale, vec, s);
  return launch_tc_dp<false>(q, k, v, o, lse, B, H, Hkv, Sq, Skv, D, st, causal, window, scale,
                             vec, s);
}

}  // extern "C"
