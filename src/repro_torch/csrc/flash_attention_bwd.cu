// Flash-attention backward (K4b), causal or local-window, GQA: given q, k, v,
// the forward's output o and its cotangent g = dL/do, returns dq, dk and dv.
//
// The reference has no Pallas backward: it trains through its XLA chunked
// attention (src/repro/modeling/attention.py:50, chunked_attention) and lets
// XLA differentiate it. The port's attention is K4 (flash_attention.cu) on
// the card, so its training step needs this kernel; it is K4's gradient,
// with K4's mask: q (B, H, Sq, D), k/v (B, Hkv, Skv, D), any strides with a
// contiguous last dimension, 1 <= D <= 256, query head h reads K/V head
// h / (H / Hkv), query i sees key j when j <= i (causal) and j > i - window
// (window > 0). Masked pairs contribute exactly 0 and a row with no visible
// key gets a zero gradient, as its forward gives 0. Every value is computed
// in float32 (bf16 operands are widened as they are staged) and each
// gradient is rounded once, to the input dtype, when it is written.
//
// Three launches, in order on one stream:
//  1. rows: one block per (b, h, 32-row query tile) computes each row's
//     log-sum-exp lse = m + log(max(l, 1e-30)) over its visible keys (the
//     forward's NEG_INF and max(l, 1e-30)) and delta = rowsum(g * o). The
//     forward does not write lse out, so K4 and its C signature stay as
//     they are; writing lse from the forward is a later redesign.
//  2. dk/dv: one block per (b, kv head, 32-key tile). It loops over the G
//     query heads of the group and over the query tiles that can see the
//     tile, recomputes P = exp(s * scale - lse) and dS = P * (g v^T - delta)
//     for the (32 x 32) tile pair, and accumulates dv += P^T g and
//     dk += dS^T q in registers, each pair's 32 terms summed apart before
//     they join the running sums (a shorter float32 chain for a key seen by
//     thousands of rows); dk is scaled once at the end.
//  3. dq: one block per (b, h, 32-row query tile) loops over the key tiles
//     the rows can see and accumulates dq += dS k, scaled at the end.
// No atomics: each output element is written by exactly one thread of one
// block, after a fixed loop order, so the backward is deterministic (a
// resumed training run can match an uninterrupted one bit for bit).
//
// Inside a tile pair: lane j owns key j of the tile and each warp owns
// 32 / NW query rows, so a score is one lane's full-width dot product over
// K^T (or V^T) staged transposed with a 33-float pitch (conflict-free
// writes and reads) and Q (or g) rows read as float4 broadcasts. P and dS go
// through shared memory (33-float pitch); in the accumulations lane j (dk,
// dv) or lane i (dq) owns 16 contiguous head dims per warp, reading the
// other operand's rows as float4 broadcasts. Head dims are zero-padded to
// NW * 16 (64, 128 or 256).
//
// What bounds it: the CUDA cores' float32 rate and the shared-memory reads
// that feed them (one broadcast load per four FMAs at best). It does 8
// matrix products where the minimum is 5 (S is recomputed in every pass,
// g v^T in two), on CUDA cores at a fraction of the 67 TFLOP/s float32
// peak, where the bf16 tensor cores would give 989. Tensor cores (mma.sync
// or wgmma), lse from the forward and one fused dk/dv/dq pass are the
// redesign that comes later.
//
// Built without -fmad=false, as flash_attention.cu: the dot products are
// chains of FMAs by design and the parity with the plain version is a
// tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
constexpr int BQ = 32;      // query rows per tile
constexpr int BK = 32;      // keys per tile: one per lane
constexpr int DPT = 16;     // head dims per thread in the accumulations
constexpr int PS = BK + 1;  // pitch of the transposed and the P / dS tiles

struct Strides {  // (batch, head, seq) element strides
  long long q[3], k[3], v[3], o[3], g[3], dq[3], dk[3], dv[3];
};

struct Args {
  int H, Hkv, Sq, Skv, D, causal, window;
  float scale;
  Strides st;
};

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void put(float* p, float x) { *p = x; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(FULL, x, o));
  return x;
}

// butterfly sum: every lane ends with the same bits
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// query position i sees key j
__device__ __forceinline__ bool visible(const Args& a, int i, int j) {
  return i < a.Sq && j < a.Skv && (!a.causal || j <= i) && (a.window <= 0 || j > i - a.window);
}

// 32 rows from position r0 on, row-major with pitch DP: zero past S or D
template <int DP, int NT, typename T>
__device__ __forceinline__ void stage_rows(float* dst, const T* src, long long stride, int r0,
                                           int S, int D) {
  for (int i = threadIdx.x; i < 32 * DP; i += NT) {
    const int r = i / DP, d = i - r * DP, pos = r0 + r;
    dst[i] = pos < S && d < D ? ld(src + pos * stride + d) : 0.f;
  }
}

// the same 32 rows transposed, dst[d * PS + r]
template <int DP, int NT, typename T>
__device__ __forceinline__ void stage_cols(float* dst, const T* src, long long stride, int r0,
                                           int S, int D) {
  for (int i = threadIdx.x; i < 32 * DP; i += NT) {
    const int r = i / DP, d = i - r * DP, pos = r0 + r;
    dst[d * PS + r] = pos < S && d < D ? ld(src + pos * stride + d) : 0.f;
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

// ------------------------------------------------------------------ 1. rows
template <int NW>
constexpr size_t rows_smem() {
  return sizeof(float) * (BQ * NW * DPT + NW * DPT * PS);
}

template <typename T, int NW>
__global__ void __launch_bounds__(NW * 32)
fa_bwd_rows(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ o,
            const T* __restrict__ g, float* __restrict__ lse, float* __restrict__ delta, Args a) {
  constexpr int DP = NW * DPT, R = BQ / NW, NT = NW * 32;
  extern __shared__ float4 smem_rows[];
  float* qs = reinterpret_cast<float*>(smem_rows);  // BQ x DP
  float* kt = qs + BQ * DP;                         // DP x PS

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, row0 = warp * R;
  const Strides& st = a.st;
  stage_rows<DP, NT>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, a.Sq, a.D);
  const T* kp = k + b * st.k[0] + hk * st.k[1];

  // keys any row of the block can see
  const int q_last = min(q0 + BQ, a.Sq) - 1;
  const int k_hi = a.causal ? min(q_last, a.Skv - 1) : a.Skv - 1;
  const int k_lo = a.window > 0 ? max(q0 - a.window + 1, 0) : 0;

  float m[R], l[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
  }
  if (k_hi >= k_lo) {
    for (int t = k_lo / BK; t <= k_hi / BK; ++t) {
      const int k0 = t * BK;
      __syncthreads();  // the previous tile is consumed (and Q is staged)
      stage_cols<DP, NT>(kt, kp, st.k[2], k0, a.Skv, a.D);
      __syncthreads();
      float s[R];
      dots<R, DP>(s, qs, row0, kt, lane);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool valid = visible(a, q0 + row0 + r, k0 + lane);
        const float x = valid ? s[r] * a.scale : NEG_INF;
        const float m_new = fmaxf(m[r], warp_max(x));
        const float p = valid ? expf(x - m_new) : 0.f;
        l[r] = l[r] * expf(m[r] - m_new) + warp_sum(p);
        m[r] = m_new;
      }
    }
  }

  const long long row_base = ((long long)b * a.H + h) * a.Sq;
  const T* op = o + b * st.o[0] + h * st.o[1];
  const T* gp = g + b * st.g[0] + h * st.g[1];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int qpos = q0 + row0 + r;
    if (qpos >= a.Sq) continue;  // warp-uniform
    float dot = 0.f;
    for (int d = lane; d < a.D; d += 32)
      dot = fmaf(ld(gp + qpos * st.g[2] + d), ld(op + qpos * st.o[2] + d), dot);
    dot = warp_sum(dot);
    if (lane == 0) {
      lse[row_base + qpos] = m[r] + logf(fmaxf(l[r], 1e-30f));
      delta[row_base + qpos] = dot;
    }
  }
}

// ------------------------------------------------------------- 2. dk and dv
template <int NW>
constexpr size_t dkdv_smem() {
  return sizeof(float) * (2 * BQ * NW * DPT + 2 * NW * DPT * PS + 2 * BQ * PS + 2 * BQ);
}

template <typename T, int NW>
__global__ void __launch_bounds__(NW * 32)
fa_bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const T* __restrict__ g, const float* __restrict__ lse,
            const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv, Args a) {
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
  stage_cols<DP, NT>(kt, k + b * st.k[0] + hk * st.k[1], st.k[2], k0, a.Skv, a.D);
  stage_cols<DP, NT>(vt, v + b * st.v[0] + hk * st.v[1], st.v[2], k0, a.Skv, a.D);

  // query rows that can see a key of the tile
  const int k_last = min(k0 + BK, a.Skv) - 1;
  const int i_lo = a.causal ? k0 : 0;
  const int i_hi = a.window > 0 ? min(a.Sq - 1, k_last + a.window - 1) : a.Sq - 1;

  float acck[DPT], accv[DPT];
#pragma unroll
  for (int e = 0; e < DPT; ++e) acck[e] = accv[e] = 0.f;

  for (int gh = 0; gh < G && i_lo <= i_hi; ++gh) {
    const int h = hk * G + gh;
    const T* qp = q + b * st.q[0] + h * st.q[1];
    const T* gp = g + b * st.g[0] + h * st.g[1];
    const long long row_base = ((long long)b * a.H + h) * a.Sq;
    for (int t = i_lo / BQ; t <= i_hi / BQ; ++t) {
      const int q0 = t * BQ;
      __syncthreads();  // the previous pair's tiles are consumed
      stage_rows<DP, NT>(qs, qp, st.q[2], q0, a.Sq, a.D);
      stage_rows<DP, NT>(gs, gp, st.g[2], q0, a.Sq, a.D);
      if (threadIdx.x < BQ) {
        const int qpos = q0 + threadIdx.x;
        ls[threadIdx.x] = qpos < a.Sq ? lse[row_base + qpos] : 0.f;
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
    T* dkp = dk + b * st.dk[0] + hk * st.dk[1] + key * st.dk[2];
    T* dvp = dv + b * st.dv[0] + hk * st.dv[1] + key * st.dv[2];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = d0 + e;
      if (d < a.D) {
        put(dkp + d, acck[e] * a.scale);
        put(dvp + d, accv[e]);
      }
    }
  }
}

// ------------------------------------------------------------------- 3. dq
template <int NW>
constexpr size_t dq_smem() {
  return sizeof(float) *
         (2 * BQ * NW * DPT + 2 * NW * DPT * PS + BK * NW * DPT + BQ * PS + 2 * BQ);
}

template <typename T, int NW>
__global__ void __launch_bounds__(NW * 32)
fa_bwd_dq(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          const T* __restrict__ g, const float* __restrict__ lse,
          const float* __restrict__ delta, T* __restrict__ dq, Args a) {
  constexpr int DP = NW * DPT, R = BQ / NW, NT = NW * 32;
  extern __shared__ float4 smem_dq[];
  float* qs = reinterpret_cast<float*>(smem_dq);  // BQ x DP
  float* gs = qs + BQ * DP;                       // BQ x DP
  float* ks = gs + BQ * DP;                       // BK x DP (row-major)
  float* kt = ks + BK * DP;                       // DP x PS
  float* vt = kt + DP * PS;                       // DP x PS
  float* dss = vt + DP * PS;                      // BQ x PS: dS
  float* ls = dss + BQ * PS;                      // BQ: lse
  float* dl = ls + BQ;                            // BQ: delta

  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // the longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, row0 = warp * R;
  const int d0 = warp * DPT;
  const Strides& st = a.st;
  stage_rows<DP, NT>(qs, q + b * st.q[0] + h * st.q[1], st.q[2], q0, a.Sq, a.D);
  stage_rows<DP, NT>(gs, g + b * st.g[0] + h * st.g[1], st.g[2], q0, a.Sq, a.D);
  if (threadIdx.x < BQ) {
    const long long row_base = ((long long)b * a.H + h) * a.Sq;
    const int qpos = q0 + threadIdx.x;
    ls[threadIdx.x] = qpos < a.Sq ? lse[row_base + qpos] : 0.f;
    dl[threadIdx.x] = qpos < a.Sq ? delta[row_base + qpos] : 0.f;
  }
  const T* kp = k + b * st.k[0] + hk * st.k[1];
  const T* vp = v + b * st.v[0] + hk * st.v[1];

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
      stage_rows<DP, NT>(ks, kp, st.k[2], k0, a.Skv, a.D);
      stage_cols<DP, NT>(kt, kp, st.k[2], k0, a.Skv, a.D);
      stage_cols<DP, NT>(vt, vp, st.v[2], k0, a.Skv, a.D);
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
    T* dqp = dq + b * st.dq[0] + h * st.dq[1] + qpos * st.dq[2];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      const int d = d0 + e;
      if (d < a.D) put(dqp + d, accq[e] * a.scale);
    }
  }
}

// Dynamic shared memory above 48 KB needs an opt-in, which holds per device;
// each instantiation's size is fixed, so it is set once per device.
template <typename Kernel>
cudaError_t opt_in(Kernel* kernel, size_t smem, bool (&done)[MAX_DEVICES]) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

template <typename T, int NW>
int launch(const T* q, const T* k, const T* v, const T* o, const T* g, T* dq, T* dk, T* dv,
           float* lse, float* delta, int B, const Args& a, cudaStream_t stream) {
  static bool opted[3][MAX_DEVICES] = {};
  cudaError_t e = opt_in(fa_bwd_rows<T, NW>, rows_smem<NW>(), opted[0]);
  if (e == cudaSuccess) e = opt_in(fa_bwd_dkdv<T, NW>, dkdv_smem<NW>(), opted[1]);
  if (e == cudaSuccess) e = opt_in(fa_bwd_dq<T, NW>, dq_smem<NW>(), opted[2]);
  if (e != cudaSuccess) return (int)e;
  const unsigned q_tiles = (unsigned)((a.Sq + BQ - 1) / BQ);
  const unsigned k_tiles = (unsigned)((a.Skv + BK - 1) / BK);
  fa_bwd_rows<T, NW><<<dim3(q_tiles, a.H, B), NW * 32, rows_smem<NW>(), stream>>>(
      q, k, o, g, lse, delta, a);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (k_tiles > 0) {
    fa_bwd_dkdv<T, NW><<<dim3(k_tiles, a.Hkv, B), NW * 32, dkdv_smem<NW>(), stream>>>(
        q, k, v, g, lse, delta, dk, dv, a);
    if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  }
  fa_bwd_dq<T, NW><<<dim3(q_tiles, a.H, B), NW * 32, dq_smem<NW>(), stream>>>(
      q, k, v, g, lse, delta, dq, a);
  return (int)cudaGetLastError();
}

template <typename T>
int run(const T* q, const T* k, const T* v, const T* o, const T* g, T* dq, T* dk, T* dv,
        float* lse, float* delta, int B, int H, int Hkv, int Sq, int Skv, int D,
        const long long* strides, int causal, int window, float scale, void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  Args a{H, Hkv, Sq, Skv, D, causal, window, scale, {}};
  long long* dst[8] = {a.st.q, a.st.k, a.st.v, a.st.o, a.st.g, a.st.dq, a.st.dk, a.st.dv};
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) dst[t][i] = strides[3 * t + i];
  const cudaStream_t s = (cudaStream_t)stream;
  if (D <= 64) return launch<T, 4>(q, k, v, o, g, dq, dk, dv, lse, delta, B, a, s);
  if (D <= 128) return launch<T, 8>(q, k, v, o, g, dq, dk, dv, lse, delta, B, a, s);
  return launch<T, 16>(q, k, v, o, g, dq, dk, dv, lse, delta, B, a, s);
}

}  // namespace

extern "C" {

// strides: 24 element strides, (batch, head, seq) of q, k, v, o, g, dq, dk
// and dv in turn; lse and delta: float32 (B, H, Sq) scratch
int flash_attention_bwd_f32(const float* q, const float* k, const float* v, const float* o,
                            const float* g, float* dq, float* dk, float* dv, float* lse,
                            float* delta, int B, int H, int Hkv, int Sq, int Skv, int D,
                            const long long* strides, int causal, int window, float scale,
                            void* stream) {
  return run(q, k, v, o, g, dq, dk, dv, lse, delta, B, H, Hkv, Sq, Skv, D, strides, causal,
             window, scale, stream);
}

int flash_attention_bwd_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                             const __nv_bfloat16* v, const __nv_bfloat16* o,
                             const __nv_bfloat16* g, __nv_bfloat16* dq, __nv_bfloat16* dk,
                             __nv_bfloat16* dv, float* lse, float* delta, int B, int H, int Hkv,
                             int Sq, int Skv, int D, const long long* strides, int causal,
                             int window, float scale, void* stream) {
  return run(q, k, v, o, g, dq, dk, dv, lse, delta, B, H, Hkv, Sq, Skv, D, strides, causal,
             window, scale, stream);
}

}  // extern "C"
