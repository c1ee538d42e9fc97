// Mamba-2 SSD chunked scan, backward (K6b): the gradients of ssd_scan.cu's
// y and final state with respect to x, dt, A, B and C.
//
// Replaces no TPU kernel: the JAX package differentiates its XLA chunked SSD
// (src/repro/modeling/ssd.py:61, ssd_chunked) with jax.grad, and its Pallas
// kernel (src/repro/kernels/ssd_scan/kernel.py:87) has no backward. Added so
// that Mamba-2 trains on the card with a hand-written kernel on both sides
// of autograd (kernels/ssd_scan/ops.py::SSDScanFn).
//
// Operands as ssd_scan.cu's: x, dy and dx (b, H, S, hd), dt (b, H, S), B, C,
// dB and dC (b, S, ds); x, dy, B, C, dx, dB and dC in float32 or bf16 (any
// strides with a contiguous last dimension for x, dy, B, C and dx; dt any
// strides; dB and dC contiguous), dt, ddt (contiguous), A and dA float32.
// The forward's workspace gives the state entering each chunk (h_prev).
//
// Per chunk of Q rows (the last may be shorter), with cum the in-chunk
// cumsum of dt A (summed in float64 and rounded, as the forward sums it),
// total its last row, L_qs = exp(cum_q - cum_s) for s <= q, W_qs = L_qs dt_s,
// e_s = exp(total - cum_s) and dh_next the gradient of the state leaving
// the chunk (the last chunk's: the final state's cotangent):
//   dh_prev = exp(total) dh_next + sum_q exp(cum_q) dy_q (x) C_q
//   dx_s    = sum_q (C_q.B_s) W_qs dy_q + e_s dt_s dh_next B_s
//   dC_q    = sum_h [sum_s (dy_q.x_s) W_qs B_s + exp(cum_q) h_prev^T dy_q]
//   dB_s    = sum_h [sum_q (dy_q.x_s) W_qs C_q + e_s dt_s dh_next^T x_s]
//   ddt_s   = sum_q (dy_q.x_s)(C_q.B_s) L_qs + U_s + A da_s,
//             U_s = e_s x_s.(dh_next B_s)
//   dcum_r  = sum_s G_rs - sum_q G_qr + exp(cum_r) dy_r.(h_prev C_r) - dt_r U_r
//             (+ exp(total) <dh_next, h_prev> + sum_s dt_s U_s at the last
//             row), G_qs = (dy_q.x_s)(C_q.B_s) W_qs
//   da_r    = sum_{k >= r} dcum_k, dA = sum dt_r da_r
// in float32 from widened inputs, but for the sums of G and of dt's direct
// part, dcum, da, ddt's sum and dA, which are float64 (the plain version,
// kernels/ssd_scan/kernel.py::ssd_scan_bwd_plain, computes the same).
//
// Design: a simple kernel on the CUDA cores, seven launches, no atomics.
//   1. states (b, chunk, head): the chunk's cum (kept in the workspace for
//      the later passes) and sum_q exp(cum_q) dy_q (x) C_q;
//   2. carry (b, head): the reverse carry over the chunks, which leaves
//      each chunk's dh_next in place of its local sum (ssd_scan.cu's pass
//      2 run backwards);
//   3. scores (b, chunk, head group): C B^T once for the group in
//      registers, then per head dy x^T, and from them the decayed scores P
//      = (C B^T) W and R = (dy x^T) W into the workspace, the row and
//      column sums of G and dt's direct score part;
//   4. dx (b, chunk, head): P^T dy + e dt (dh_next B), U, exp(cum) dy.(h_prev
//      C), <dh_next, h_prev>, then dcum, its reverse sum, ddt and the
//      head's dA partial;
//   5, 6. dC and dB (b, chunk, head group): R B (R^T C) plus the state term
//      from prescaled rows, summed over the group's heads in order into
//      one partial per group;
//   7. reduce: dB and dC summed over the groups in order, dA over (batch,
//      chunk) in float64.
// Every sum runs in a fixed order, so two runs give the same bits. Limits:
// Q <= 128, head_dim <= 64, state <= 128 (the wrapper refuses others).
//
// What bounds it on the H100: the per-head products (about 3 Q^2 (hd + ds)
// + 4 Q hd ds multiply-adds per head and chunk, and Q^2 ds per group) in
// float32 on the CUDA cores, against a bound that reads each input and
// writes each output once.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int MAX_Q = 128, MAX_HD = 64, MAX_DS = 128, MAX_GROUP = 8;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct Strides {
  long long x[3], dt[3], b[2], c[2], dy[3], dx[3];  // (batch, head, seq) / (batch, seq)
};

struct Dims {
  int b, H, S, hd, ds, Q, nch, group, ngroups;
};

// the workspace's parts: float64 row sums first (8-byte aligned), then
// float32
struct Work {
  double *rowg, *colg, *ddtd;
  float *dstates, *totals, *cum, *P, *R, *dbp, *dcp, *dap;
};

// the workspace's parts in order; returns its length in floats
long long carve(float* w, const Dims& d, Work* k) {
  const long long bh = (long long)d.b * d.H, scores = bh * d.nch * d.Q * d.Q;
  const long long partial = (long long)d.ngroups * d.b * d.S * d.ds;
  Work t;
  double** wide[3] = {&t.rowg, &t.colg, &t.ddtd};
  long long o = 0;
  for (int i = 0; i < 3; ++i) {
    *wide[i] = w ? reinterpret_cast<double*>(w + o) : nullptr;
    o += 2 * bh * d.S;
  }
  float** parts[8] = {&t.dstates, &t.totals, &t.cum, &t.P, &t.R, &t.dbp, &t.dcp, &t.dap};
  const long long sizes[8] = {bh * d.nch * d.hd * d.ds, bh * d.nch, bh * d.S, scores, scores,
                              partial, partial, bh * d.nch};
  for (int i = 0; i < 8; ++i) {
    *parts[i] = w ? w + o : nullptr;
    o += sizes[i];
  }
  if (k) *k = t;
  return o;
}

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

// a chunk's cum of one head, by one warp: float64 sums of the float32
// products dt * a over n rows, rounded to float32 (ssd_scan.cu's cum)
__device__ __forceinline__ void warp_cum(const float* dts, float a, float* cum, int n, int lane) {
  double carry = 0.0;
  for (int base = 0; base < n; base += 32) {
    const int q = base + lane;
    double v = q < n ? (double)(dts[q] * a) : 0.0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(FULL, v, o);
      if (lane >= o) v += u;
    }
    v += carry;
    if (q < n) cum[q] = __double2float_rn(v);
    carry = __shfl_sync(FULL, v, 31);
  }
}

// the sum of v over the 16 lanes of a half warp (butterfly, fixed order)
template <typename V>
__device__ __forceinline__ V half_warp_sum(V v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

__device__ __forceinline__ long long rows_of(const Dims& d, int b, int h) {
  return ((long long)b * d.H + h) * d.S;  // (b, H, S) per-row buffers
}

__device__ __forceinline__ long long state_of(const Dims& d, int b, int c, int h) {
  return (((long long)b * d.nch + c) * d.H + h) * d.hd * d.ds;
}

__device__ __forceinline__ long long scores_of(const Dims& d, int b, int c, int h) {
  return (((long long)b * d.nch + c) * d.H + h) * d.Q * d.Q;
}

// ---------------------------------------------------------------- 1. states
// per (head, chunk, batch): cum into the workspace, the chunk's total, and
// (chunk > 0) sum_q exp(cum_q) dy_q (x) C_q. Threads: rows p = warp + 8 i,
// columns n = lane + 32 u.
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_states_kernel(const float* __restrict__ dt, const float* __restrict__ A, const T* __restrict__ C,
                  const T* __restrict__ dy, Work w, Dims d, Strides st) {
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int r0 = c * d.Q, qc = min(d.Q, d.S - r0);
  const int HS = d.hd + 1, CS = d.ds + 1;
  float* dts = sm;
  float* cum = dts + MAX_Q;
  float* dye = cum + MAX_Q;       // [qc][HS]: exp(cum_q) dy_q
  float* cs = dye + MAX_Q * HS;   // [qc][CS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int q = tid; q < qc; q += THREADS)
    dts[q] = dt[b * st.dt[0] + (long long)h * st.dt[1] + (long long)(r0 + q) * st.dt[2]];
  __syncthreads();
  if (warp == 0) warp_cum(dts, A[h], cum, qc, lane);
  __syncthreads();
  float* cg = w.cum + rows_of(d, b, h) + r0;
  for (int q = tid; q < qc; q += THREADS) cg[q] = cum[q];
  if (tid == 0) w.totals[((long long)b * d.H + h) * d.nch + c] = cum[qc - 1];
  if (c == 0) return;  // the state gradient into chunk 0 reaches no input
  const T* yp = dy + b * st.dy[0] + (long long)h * st.dy[1] + (long long)r0 * st.dy[2];
  for (int i = tid; i < qc * d.hd; i += THREADS) {
    const int q = i / d.hd, p = i - q * d.hd;
    dye[q * HS + p] = expf(cum[q]) * ld(yp + (long long)q * st.dy[2] + p);
  }
  const T* cp = C + b * st.c[0] + (long long)r0 * st.c[1];
  for (int i = tid; i < qc * d.ds; i += THREADS) {
    const int q = i / d.ds, n = i - q * d.ds;
    cs[q * CS + n] = ld(cp + (long long)q * st.c[1] + n);
  }
  __syncthreads();
  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) acc[i][u] = 0.f;
  for (int q = 0; q < qc; ++q) {
    float cv[4], dv[8];
#pragma unroll
    for (int u = 0; u < 4; ++u) cv[u] = lane + 32 * u < d.ds ? cs[q * CS + lane + 32 * u] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i) dv[i] = warp + 8 * i < d.hd ? dye[q * HS + warp + 8 * i] : 0.f;
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][u] = fmaf(dv[i], cv[u], acc[i][u]);
  }
  float* out = w.dstates + state_of(d, b, c, h);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int p = warp + 8 * i, n = lane + 32 * u;
      if (p < d.hd && n < d.ds) out[p * d.ds + n] = acc[i][u];
    }
}

// ----------------------------------------------------------------- 2. carry
// per (batch, head) and state element, over the chunks from the last: the
// local sum of chunk c becomes dh_next of chunk c
__global__ void __launch_bounds__(THREADS)
bwd_carry_kernel(const float* __restrict__ dstate, Work w, Dims d) {
  const int n_el = d.hd * d.ds;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int bh = blockIdx.y, b = bh / d.H, h = bh - b * d.H;
  if (e >= n_el) return;
  float g = dstate ? dstate[(long long)bh * n_el + e] : 0.f;
  for (int c = d.nch - 1; c >= 0; --c) {
    float* p = w.dstates + state_of(d, b, c, h) + e;
    const float local = c > 0 ? *p : 0.f;
    *p = g;
    if (c > 0) g = g * expf(w.totals[(long long)bh * d.nch + c]) + local;
  }
}

// ---------------------------------------------------------------- 3. scores
// per (head group, chunk, batch): CB = C B^T in registers once, then per
// head DX = dy x^T, P = CB W and R = DX W into the workspace (zero where
// masked), the row sums of G = P DX, its column sums, and the column sums
// of CB DX L (dt's direct part), those three summed in float64 (the
// reverse sum of dcum cancels the terms both sums hold, exactly in float64
// where float32 would leave their roundings behind). Threads: rows
// q = ty + 16 i, columns s = tx + 16 j.
template <typename T, int RT>
__global__ void __launch_bounds__(THREADS)
bwd_scores_kernel(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ B,
                  const T* __restrict__ C, const T* __restrict__ dy, Work w, Dims d, Strides st) {
  constexpr int QR = 16 * RT;
  extern __shared__ __align__(16) float sm[];
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = g * d.group, nh = min(d.group, d.H - h0);
  const int Q = d.Q, r0 = c * Q, qc = min(Q, d.S - r0);
  const int KS = d.ds + 1, XS = d.hd + 1;
  float* cumh = sm;                       // [MAX_GROUP][MAX_Q]
  float* dth = cumh + MAX_GROUP * MAX_Q;  // [MAX_GROUP][MAX_Q]
  double* red = reinterpret_cast<double*>(dth + MAX_GROUP * MAX_Q);  // [2][16][MAX_Q]
  float* un = reinterpret_cast<float*>(red + 2 * 16 * MAX_Q);  // B, C rows; then x, dy rows
  float* bs = un;
  float* cs = un + QR * KS;
  float* xs = un;
  float* ys = un + QR * XS;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* bp = B + b * st.b[0] + (long long)r0 * st.b[1];
  const T* cp = C + b * st.c[0] + (long long)r0 * st.c[1];
  for (int i = tid; i < QR * d.ds; i += THREADS) {
    const int q = i / d.ds, n = i - q * d.ds;
    bs[q * KS + n] = q < qc ? ld(bp + (long long)q * st.b[1] + n) : 0.f;
    cs[q * KS + n] = q < qc ? ld(cp + (long long)q * st.c[1] + n) : 0.f;
  }
  for (int i = tid; i < nh * MAX_Q; i += THREADS) {
    const int hh = i / MAX_Q, q = i - hh * MAX_Q;
    const bool in = q < qc;
    cumh[i] = in ? w.cum[rows_of(d, b, h0 + hh) + r0 + q] : 0.f;
    dth[i] = in ? dt[b * st.dt[0] + (long long)(h0 + hh) * st.dt[1] + (long long)(r0 + q) * st.dt[2]]
                : 0.f;
  }
  __syncthreads();
  float cb[RT][RT];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < RT; ++j) cb[i][j] = 0.f;
  for (int k = 0; k < d.ds; ++k) {
    float cv[RT], bv[RT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      cv[i] = cs[(ty + 16 * i) * KS + k];
      bv[i] = bs[(tx + 16 * i) * KS + k];
    }
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) cb[i][j] = fmaf(cv[i], bv[j], cb[i][j]);
  }

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    __syncthreads();  // B and C (or the last head's x, dy and sums) are read
    const T* xp = x + b * st.x[0] + (long long)h * st.x[1] + (long long)r0 * st.x[2];
    const T* yp = dy + b * st.dy[0] + (long long)h * st.dy[1] + (long long)r0 * st.dy[2];
    for (int i = tid; i < QR * d.hd; i += THREADS) {
      const int q = i / d.hd, p = i - q * d.hd;
      xs[q * XS + p] = q < qc ? ld(xp + (long long)q * st.x[2] + p) : 0.f;
      ys[q * XS + p] = q < qc ? ld(yp + (long long)q * st.dy[2] + p) : 0.f;
    }
    __syncthreads();
    float dm[RT][RT];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < RT; ++j) dm[i][j] = 0.f;
    for (int p = 0; p < d.hd; ++p) {
      float yv[RT], xv[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        yv[i] = ys[(ty + 16 * i) * XS + p];
        xv[i] = xs[(tx + 16 * i) * XS + p];
      }
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < RT; ++j) dm[i][j] = fmaf(yv[i], xv[j], dm[i][j]);
    }
    const float* cu = cumh + hh * MAX_Q;
    const float* dh = dth + hh * MAX_Q;
    float* Pg = w.P + scores_of(d, b, c, h);
    float* Rg = w.R + scores_of(d, b, c, h);
    double colg[RT], colm[RT];
#pragma unroll
    for (int j = 0; j < RT; ++j) colg[j] = colm[j] = 0.0;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int q = ty + 16 * i;
      double rowg = 0.0;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int s = tx + 16 * j;
        const bool live = s <= q && q < qc;
        const float L = live ? expf(cu[q] - cu[s]) : 0.f;
        const float W = L * dh[s];
        const float P = cb[i][j] * W, R = dm[i][j] * W, G = P * dm[i][j];
        if (q < Q && s < Q) {
          Pg[q * Q + s] = P;
          Rg[q * Q + s] = R;
        }
        rowg += G;
        colg[j] += G;
        colm[j] += (double)(cb[i][j] * dm[i][j] * L);
      }
      rowg = half_warp_sum(rowg);
      if (tx == 0 && q < qc) w.rowg[rows_of(d, b, h) + r0 + q] = rowg;
    }
#pragma unroll
    for (int j = 0; j < RT; ++j) {
      red[ty * MAX_Q + tx + 16 * j] = colg[j];
      red[(16 + ty) * MAX_Q + tx + 16 * j] = colm[j];
    }
    __syncthreads();
    for (int s = tid; s < qc; s += THREADS) {
      double a = 0.0, m = 0.0;
      for (int t = 0; t < 16; ++t) {
        a += red[t * MAX_Q + s];
        m += red[(16 + t) * MAX_Q + s];
      }
      w.colg[rows_of(d, b, h) + r0 + s] = a;
      w.ddtd[rows_of(d, b, h) + r0 + s] = m;
    }
  }
}

// -------------------------------------------------------------------- 4. dx
// per (head, chunk, batch): dx = P^T dy + e dt (dh_next B); U; Y =
// exp(cum) dy.(h_prev C); <dh_next, h_prev>; then dcum, its reverse sum,
// ddt and the head's dA partial. Threads: rows ty + 16 i, head-dim
// columns tx + 16 j.
template <typename T, int RT>
__global__ void __launch_bounds__(THREADS)
bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
              const T* __restrict__ B, const T* __restrict__ C, const T* __restrict__ dy,
              const float* __restrict__ hstates, T* __restrict__ dxo, float* __restrict__ ddt,
              Work w, Dims d, Strides st) {
  constexpr int QR = 16 * RT;
  extern __shared__ __align__(16) float sm[];
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int Q = d.Q, r0 = c * Q, qc = min(Q, d.S - r0);
  const int PT = cdiv(d.hd, 16), XS = 16 * PT + 1, KS = d.ds + 1;
  float* cu = sm;               // [MAX_Q]
  float* dts = cu + MAX_Q;      // [MAX_Q]
  float* us = dts + MAX_Q;      // [MAX_Q]: U
  float* yv = us + MAX_Q;       // [MAX_Q]: Y
  float* red = yv + MAX_Q;      // [THREADS]
  float* ys = red + THREADS;    // [QR][XS]: dy
  float* dhn = ys + QR * XS;    // [16 PT][KS]: dh_next
  float* hp = dhn + 16 * PT * KS;  // [16 PT][KS]: h_prev
  float* un = hp + 16 * PT * KS;   // P [QR][QR], then B rows, then C rows [QR][KS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, ty = tid >> 4, tx = tid & 15;
  const long long rb = rows_of(d, b, h) + r0;

  for (int q = tid; q < MAX_Q; q += THREADS) {
    const bool in = q < qc;
    cu[q] = in ? w.cum[rb + q] : 0.f;
    dts[q] = in ? dt[b * st.dt[0] + (long long)h * st.dt[1] + (long long)(r0 + q) * st.dt[2]] : 0.f;
  }
  const T* yp = dy + b * st.dy[0] + (long long)h * st.dy[1] + (long long)r0 * st.dy[2];
  for (int i = tid; i < QR * 16 * PT; i += THREADS) {
    const int q = i / (16 * PT), p = i - q * (16 * PT);
    ys[q * XS + p] = (q < qc && p < d.hd) ? ld(yp + (long long)q * st.dy[2] + p) : 0.f;
  }
  const float* dn = w.dstates + state_of(d, b, c, h);
  const float* hv = (hstates != nullptr && c > 0) ? hstates + state_of(d, b, c, h) : nullptr;
  for (int i = tid; i < 16 * PT * d.ds; i += THREADS) {
    const int p = i / d.ds, n = i - p * d.ds;
    const bool in = p < d.hd;
    dhn[p * KS + n] = in ? dn[p * d.ds + n] : 0.f;
    hp[p * KS + n] = (in && hv) ? hv[p * d.ds + n] : 0.f;
  }
  const float* Pg = w.P + scores_of(d, b, c, h);
  for (int i = tid; i < QR * QR; i += THREADS) {
    const int q = i / QR, s = i - q * QR;
    un[i] = (q < Q && s < Q) ? Pg[q * Q + s] : 0.f;
  }
  __syncthreads();
  const float total = cu[qc - 1];

  // phase 1: P^T dy
  float acc[RT][4];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int q = 0; q < qc; ++q) {
    float pv[RT], dv[4];
#pragma unroll
    for (int i = 0; i < RT; ++i) pv[i] = un[q * QR + ty + 16 * i];
#pragma unroll
    for (int j = 0; j < 4; ++j) dv[j] = j < PT ? ys[q * XS + tx + 16 * j] : 0.f;
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(pv[i], dv[j], acc[i][j]);
  }
  __syncthreads();  // P is read: its room takes B's rows
  const T* bp = B + b * st.b[0] + (long long)r0 * st.b[1];
  for (int i = tid; i < QR * d.ds; i += THREADS) {
    const int q = i / d.ds, n = i - q * d.ds;
    un[q * KS + n] = q < qc ? ld(bp + (long long)q * st.b[1] + n) : 0.f;
  }
  __syncthreads();

  // phase 2: V = dh_next B_s; dx += e dt V; U = e x.V
  {
    float v[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) v[i][j] = 0.f;
    for (int n = 0; n < d.ds; ++n) {
      float bv[RT], hn[4];
#pragma unroll
      for (int i = 0; i < RT; ++i) bv[i] = un[(ty + 16 * i) * KS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) hn[j] = j < PT ? dhn[(tx + 16 * j) * KS + n] : 0.f;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) v[i][j] = fmaf(bv[i], hn[j], v[i][j]);
    }
    const T* xp = x + b * st.x[0] + (long long)h * st.x[1] + (long long)r0 * st.x[2];
    T* dp = dxo + b * st.dx[0] + (long long)h * st.dx[1] + (long long)r0 * st.dx[2];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int s = ty + 16 * i;
      const bool in = s < qc;
      const float e = in ? expf(total - cu[s]) : 0.f;
      const float ew = e * dts[s];
      float xu = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int p = tx + 16 * j;
        if (in && p < d.hd) {
          const float xv = ld(xp + (long long)s * st.x[2] + p);
          xu = fmaf(xv, v[i][j], xu);
          put(dp + (long long)s * st.dx[2] + p, acc[i][j] + ew * v[i][j]);
        }
      }
      xu = half_warp_sum(xu);
      if (tx == 0 && in) us[s] = e * xu;
    }
  }
  __syncthreads();  // B is read: its room takes C's rows
  const T* cp = C + b * st.c[0] + (long long)r0 * st.c[1];
  for (int i = tid; i < QR * d.ds; i += THREADS) {
    const int q = i / d.ds, n = i - q * d.ds;
    un[q * KS + n] = q < qc ? ld(cp + (long long)q * st.c[1] + n) : 0.f;
  }
  __syncthreads();

  // phase 3: Y = exp(cum) dy.(h_prev C); <dh_next, h_prev>
  {
    float z[RT][4];
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) z[i][j] = 0.f;
    for (int n = 0; n < d.ds; ++n) {
      float cv[RT], hn[4];
#pragma unroll
      for (int i = 0; i < RT; ++i) cv[i] = un[(ty + 16 * i) * KS + n];
#pragma unroll
      for (int j = 0; j < 4; ++j) hn[j] = j < PT ? hp[(tx + 16 * j) * KS + n] : 0.f;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) z[i][j] = fmaf(cv[i], hn[j], z[i][j]);
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int q = ty + 16 * i;
      float yz = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (j < PT) yz = fmaf(ys[q * XS + tx + 16 * j], z[i][j], yz);
      yz = half_warp_sum(yz);
      if (tx == 0 && q < qc) yv[q] = expf(cu[q]) * yz;
    }
  }
  float f = 0.f;
  for (int i = tid; i < d.hd * d.ds; i += THREADS) {
    const int p = i / d.ds, n = i - p * d.ds;
    f = fmaf(dhn[p * KS + n], hp[p * KS + n], f);
  }
  red[tid] = f;
  __syncthreads();
  for (int o = THREADS / 2; o > 0; o >>= 1) {
    if (tid < o) red[tid] += red[tid + o];
    __syncthreads();
  }

  // phase 4: dcum, its reverse sum, ddt and dA's partial, in float64
  // (warp 0)
  if (warp == 0) {
    const float frob = red[0];
    double tsum = 0.0;
    for (int r = lane; r < qc; r += 32) tsum += (double)(dts[r] * us[r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(FULL, tsum, o);
    const double a = A[h];
    double carry = 0.0, da_dt = 0.0;
    for (int base = cdiv(qc, 32) * 32 - 32; base >= 0; base -= 32) {
      const int r = base + lane;
      double v = 0.0;
      if (r < qc) {
        v = w.rowg[rb + r] - w.colg[rb + r] + (double)yv[r] - (double)(dts[r] * us[r]);
        if (r == qc - 1) v += (double)(expf(total) * frob) + tsum;
      }
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_down_sync(FULL, v, o);
        if (lane + o < 32) v += u;
      }
      v += carry;
      carry = __shfl_sync(FULL, v, 0);
      if (r < qc) {
        ddt[rb + r] = __double2float_rn(w.ddtd[rb + r] + (double)us[r] + a * v);
        da_dt += (double)dts[r] * v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da_dt += __shfl_xor_sync(FULL, da_dt, o);
    if (lane == 0) w.dap[((long long)b * d.nch + c) * d.H + h] = (float)da_dt;
  }
}

// ------------------------------------------------------------ 5, 6. dC, dB
// per (head group, chunk, batch), summed over the group's heads in order:
// dC_q = R B + (exp(cum_q) dy_q) h_prev, dB_s = R^T C + (e_s dt_s x_s)
// dh_next, into the group's partial. Threads: rows ty + 16 i, state
// columns tx + 16 j.
template <typename T, int RT, bool DB>
__global__ void __launch_bounds__(THREADS)
bwd_dbc_kernel(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ B,
               const T* __restrict__ C, const T* __restrict__ dy, const float* __restrict__ hstates,
               Work w, Dims d, Strides st) {
  constexpr int QR = 16 * RT, RS = QR + 1;
  extern __shared__ __align__(16) float sm[];
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = g * d.group, nh = min(d.group, d.H - h0);
  const int Q = d.Q, r0 = c * Q, qc = min(Q, d.S - r0);
  const int NT = cdiv(d.ds, 16), KS = 16 * NT + 1, XS = d.hd + 1;
  float* cu = sm;               // [MAX_Q]
  float* dts = cu + MAX_Q;      // [MAX_Q]
  float* ms = dts + MAX_Q;      // [QR][KS]: B rows (dC) or C rows (dB)
  float* rs = ms + QR * KS;     // [QR][RS]: rs[k][r]
  float* vs = rs + QR * RS;     // [QR][XS]: prescaled dy (dC) or x (dB)
  float* ss = vs + QR * XS;     // [hd][KS]: h_prev (dC) or dh_next (dB)
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  const T* mp = DB ? C + b * st.c[0] + (long long)r0 * st.c[1] : B + b * st.b[0] + (long long)r0 * st.b[1];
  const long long mrow = DB ? st.c[1] : st.b[1];
  for (int i = tid; i < QR * 16 * NT; i += THREADS) {
    const int q = i / (16 * NT), n = i - q * (16 * NT);
    ms[q * KS + n] = (q < qc && n < d.ds) ? ld(mp + (long long)q * mrow + n) : 0.f;
  }
  float acc[RT][8];
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const long long rb = rows_of(d, b, h) + r0;
    __syncthreads();  // the last head's rows are read
    for (int q = tid; q < MAX_Q; q += THREADS) {
      const bool in = q < qc;
      cu[q] = in ? w.cum[rb + q] : 0.f;
      dts[q] = in ? dt[b * st.dt[0] + (long long)h * st.dt[1] + (long long)(r0 + q) * st.dt[2]] : 0.f;
    }
    const float* Rg = w.R + scores_of(d, b, c, h);
    for (int i = tid; i < QR * QR; i += THREADS) {
      // coalesced reads of R[q][s]: rs[k][r] = R[r][k] (dC) or R[k][r] (dB)
      const int q = i / QR, s = i - q * QR;
      const float v = (q < Q && s < Q) ? Rg[q * Q + s] : 0.f;
      if (DB)
        rs[q * RS + s] = v;
      else
        rs[s * RS + q] = v;
    }
    const float* sp = DB ? w.dstates + state_of(d, b, c, h)
                         : ((hstates != nullptr && c > 0) ? hstates + state_of(d, b, c, h) : nullptr);
    for (int i = tid; i < d.hd * 16 * NT; i += THREADS) {
      const int p = i / (16 * NT), n = i - p * (16 * NT);
      ss[p * KS + n] = (sp && n < d.ds) ? sp[p * d.ds + n] : 0.f;
    }
    __syncthreads();  // cum and dt are in
    const float total = cu[qc - 1];
    const T* vp = DB ? x + b * st.x[0] + (long long)h * st.x[1] + (long long)r0 * st.x[2]
                     : dy + b * st.dy[0] + (long long)h * st.dy[1] + (long long)r0 * st.dy[2];
    const long long vrow = DB ? st.x[2] : st.dy[2];
    for (int i = tid; i < QR * d.hd; i += THREADS) {
      const int q = i / d.hd, p = i - q * d.hd;
      float v = 0.f;
      if (q < qc) {
        const float f = DB ? expf(total - cu[q]) * dts[q] : expf(cu[q]);
        v = f * ld(vp + (long long)q * vrow + p);
      }
      vs[q * XS + p] = v;
    }
    __syncthreads();
    for (int k = 0; k < qc; ++k) {
      float rv[RT], mv[8];
#pragma unroll
      for (int i = 0; i < RT; ++i) rv[i] = rs[k * RS + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 8; ++j) mv[j] = j < NT ? ms[k * KS + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(rv[i], mv[j], acc[i][j]);
    }
    for (int p = 0; p < d.hd; ++p) {
      float vv[RT], sv[8];
#pragma unroll
      for (int i = 0; i < RT; ++i) vv[i] = vs[(ty + 16 * i) * XS + p];
#pragma unroll
      for (int j = 0; j < 8; ++j) sv[j] = j < NT ? ss[p * KS + tx + 16 * j] : 0.f;
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(vv[i], sv[j], acc[i][j]);
    }
  }
  float* out = (DB ? w.dbp : w.dcp) + (((long long)g * d.b + b) * d.S + r0) * d.ds;
#pragma unroll
  for (int i = 0; i < RT; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = ty + 16 * i, n = tx + 16 * j;
      if (r < qc && n < d.ds) out[(long long)r * d.ds + n] = acc[i][j];
    }
}

// --------------------------------------------------------------- 7. reduce
// dB and dC: the groups' partials summed in group order; dA: the (batch,
// chunk) partials summed in float64 (block 0)
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(Work w, Dims d, T* __restrict__ dB, T* __restrict__ dC, float* __restrict__ dA) {
  const long long n = (long long)d.b * d.S * d.ds;
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i < n) {
    float sb = 0.f, sc = 0.f;
    for (int g = 0; g < d.ngroups; ++g) {
      sb += w.dbp[g * n + i];
      sc += w.dcp[g * n + i];
    }
    put(dB + i, sb);
    put(dC + i, sc);
  }
  if (blockIdx.x == 0)
    for (int h = threadIdx.x; h < d.H; h += THREADS) {
      double s = 0.0;
      for (int bc = 0; bc < d.b * d.nch; ++bc) s += (double)w.dap[(long long)bc * d.H + h];
      dA[h] = (float)s;
    }
}

// ----------------------------------------------------------------- launch
// shared memory of each kernel, in bytes
size_t smem_states(const Dims& d) {
  return sizeof(float) * (2 * MAX_Q + (size_t)MAX_Q * (d.hd + 1) + (size_t)MAX_Q * (d.ds + 1));
}
size_t smem_scores(const Dims& d, int qr) {
  const size_t bc = 2 * (size_t)qr * (d.ds + 1), xy = 2 * (size_t)qr * (d.hd + 1);
  return sizeof(float) * (2 * MAX_GROUP * MAX_Q + (bc > xy ? bc : xy)) +
         sizeof(double) * 2 * 16 * MAX_Q;
}
size_t smem_dx(const Dims& d, int qr) {
  const size_t pt16 = 16 * (size_t)cdiv(d.hd, 16);
  const size_t p = (size_t)qr * qr, rows = (size_t)qr * (d.ds + 1);
  return sizeof(float) * (4 * MAX_Q + THREADS + (size_t)qr * (pt16 + 1) + 2 * pt16 * (d.ds + 1) +
                          (p > rows ? p : rows));
}
size_t smem_dbc(const Dims& d, int qr) {
  const size_t ks = 16 * (size_t)cdiv(d.ds, 16) + 1;
  return sizeof(float) * (2 * MAX_Q + (size_t)qr * ks + (size_t)qr * (qr + 1) +
                          (size_t)qr * (d.hd + 1) + (size_t)d.hd * ks);
}

int smem_optin() {
  static int cache[MAX_DEVICES] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < MAX_DEVICES && cache[dev]) return cache[dev];
  int v = 0;
  e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < MAX_DEVICES) cache[dev] = v;
  return v;
}

// launch `kernel` with `smem` bytes of dynamic shared memory, raising its
// limit to the device's opt-in once (the same value from every thread)
template <typename K, typename... Args>
int launch_k(K kernel, dim3 grid, size_t smem, int optin, cudaStream_t s, Args... args) {
  if (smem > (size_t)optin) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e != cudaSuccess) return (int)e;
  }
  kernel<<<grid, THREADS, smem, s>>>(args...);
  return (int)cudaGetLastError();
}

template <typename T, int RT>
int launch_rt(const T* x, const float* dt, const float* A, const T* B, const T* C, const T* dy,
              const float* dstate, const float* hstates, T* dx, float* ddt, float* dA, T* dB,
              T* dC, const Work& w, const Dims& d, const Strides& st, int optin, cudaStream_t s) {
  const int qr = 16 * RT;
  int e = launch_k(bwd_states_kernel<T>, dim3(d.H, d.nch, d.b), smem_states(d), optin, s, dt, A,
                   C, dy, w, d, st);
  if (e) return e;
  bwd_carry_kernel<<<dim3(cdiv(d.hd * d.ds, THREADS), d.b * d.H), THREADS, 0, s>>>(dstate, w, d);
  e = (int)cudaGetLastError();
  if (e) return e;
  const dim3 groups(d.ngroups, d.nch, d.b), heads(d.H, d.nch, d.b);
  e = launch_k(bwd_scores_kernel<T, RT>, groups, smem_scores(d, qr), optin, s, x, dt, B, C, dy, w,
               d, st);
  if (e) return e;
  e = launch_k(bwd_dx_kernel<T, RT>, heads, smem_dx(d, qr), optin, s, x, dt, A, B, C, dy, hstates,
               dx, ddt, w, d, st);
  if (e) return e;
  e = launch_k(bwd_dbc_kernel<T, RT, false>, groups, smem_dbc(d, qr), optin, s, x, dt, B, C, dy,
               hstates, w, d, st);
  if (e) return e;
  e = launch_k(bwd_dbc_kernel<T, RT, true>, groups, smem_dbc(d, qr), optin, s, x, dt, B, C, dy,
               hstates, w, d, st);
  if (e) return e;
  const long long n = (long long)d.b * d.S * d.ds;
  bwd_reduce_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(w, d, dB, dC,
                                                                                   dA);
  return (int)cudaGetLastError();
}

Dims dims(int b, int H, int S, int hd, int ds, int Q, int group) {
  Dims d;
  d.b = b;
  d.H = H;
  d.S = S;
  d.hd = hd;
  d.ds = ds;
  d.Q = Q;
  d.nch = cdiv(S, Q);
  d.group = group;
  d.ngroups = cdiv(H, group);
  return d;
}

bool valid(int b, int H, int S, int hd, int ds, int Q, int group) {
  return b >= 1 && H >= 1 && S >= 1 && Q >= 1 && Q <= MAX_Q && Q <= S && hd >= 1 &&
         hd <= MAX_HD && ds >= 1 && ds <= MAX_DS && group >= 1 && group <= MAX_GROUP;
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* B, const T* C, const T* dy,
           const float* dstate, const float* hstates, T* dx, float* ddt, float* dA, T* dB, T* dC,
           float* work, int b, int H, int S, int hd, int ds, int Q, int group,
           const long long* strides, void* stream) {
  if (!valid(b, H, S, hd, ds, Q, group) || work == nullptr) return (int)cudaErrorInvalidValue;
  const Dims d = dims(b, H, S, hd, ds, Q, group);
  if (d.nch > 1 && hstates == nullptr) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.dt[i] = strides[3 + i];
    st.dy[i] = strides[10 + i];
    st.dx[i] = strides[13 + i];
  }
  for (int i = 0; i < 2; ++i) {
    st.b[i] = strides[6 + i];
    st.c[i] = strides[8 + i];
  }
  Work w;
  carve(work, d, &w);
  const int optin = smem_optin();
  if (optin < 0) return -optin;
  const cudaStream_t s = (cudaStream_t)stream;
  if (Q <= 16)
    return launch_rt<T, 1>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, w, d, st,
                           optin, s);
  if (Q <= 32)
    return launch_rt<T, 2>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, w, d, st,
                           optin, s);
  if (Q <= 64)
    return launch_rt<T, 4>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, w, d, st,
                           optin, s);
  return launch_rt<T, 8>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, w, d, st,
                         optin, s);
}

}  // namespace

extern "C" {

// Floats of K6b's workspace at these sizes and head group (the host
// mirrors it as kernel.py::bwd_work_floats); -1 for sizes it refuses.
long long ssd_scan_bwd_work_floats(int b, int H, int S, int hd, int ds, int Q, int group) {
  if (!valid(b, H, S, hd, ds, Q, group)) return -1;
  return carve(nullptr, dims(b, H, S, hd, ds, Q, group), nullptr);
}

// strides: 16 element strides: x, dt (batch, head, seq), B, C (batch,
// seq), dy, dx (batch, head, seq). dstate: the final state's cotangent
// (b, H, hd, ds) contiguous, or NULL (zero). hstates: the forward's
// workspace (the state entering each chunk first), NULL for one chunk.
// dB, dC, ddt contiguous; work: ssd_scan_bwd_work_floats floats.
int ssd_scan_bwd_f32(const float* x, const float* dt, const float* A, const float* B,
                     const float* C, const float* dy, const float* dstate, const float* hstates,
                     float* dx, float* ddt, float* dA, float* dB, float* dC, float* work, int b,
                     int H, int S, int hd, int ds, int Q, int group, const long long* strides,
                     void* stream) {
  return launch<float>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, work, b, H, S,
                       hd, ds, Q, group, strides, stream);
}

int ssd_scan_bwd_bf16(const __nv_bfloat16* x, const float* dt, const float* A,
                      const __nv_bfloat16* B, const __nv_bfloat16* C, const __nv_bfloat16* dy,
                      const float* dstate, const float* hstates, __nv_bfloat16* dx, float* ddt,
                      float* dA, __nv_bfloat16* dB, __nv_bfloat16* dC, float* work, int b, int H,
                      int S, int hd, int ds, int Q, int group, const long long* strides,
                      void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, work, b,
                               H, S, hd, ds, Q, group, strides, stream);
}

}  // extern "C"
