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
// kernels/ssd_scan/kernel.py::ssd_scan_bwd_plain, computes the same): the
// reverse sum of dcum cancels the terms that a row's and a column's sum of
// G both hold, exactly in float64, where float32 would leave their
// roundings behind. No atomics: every output element is written by one
// thread after a fixed order of sums, so two runs give the same bits.
// Limits: Q <= 128, head_dim <= 64, state <= 128 (the wrapper refuses
// others).
//
// bf16 (the training path): every product on the tensor cores, mma.sync
// m16n8k16 (bf16 in, float32 accumulate) on fragments read with ldmatrix
// from XOR-swizzled shared memory (fa_mma.cuh). C B^T and dy x^T come from
// the exact bf16 rows. The products with a float32 operand split it into
// three bf16 terms, hi + mid + lo (24 bits of mantissa, as ssd_scan.cu's
// bf16 kernel does), each against the exact bf16 other operand, so they
// keep float32 accuracy: P^T dy and dh_next B (dx), R^T C and x dh_next
// (dB), R B and dy h_prev (dC), (exp(cum) dy)^T C (the state gradient).
// Three terms, not two: two (16 bits) would hold the bf16 row limit with
// room on the CPU emulation (tests/test_torch_scan_grads.py), but on the
// card the bf16 rounding of dx, dB and dC already takes half of that limit,
// and the float64 sums of dcum and ddt take U and exp(cum) dy.(h_prev C)
// from these products, which three terms keep at the float32 route's
// accuracy. The decayed scores P = (C B^T) W and R = (dy x^T) W never reach
// device memory: each warp decays and masks its 16 x 16 score tiles in
// registers and feeds them as A fragments. Five launches:
//   1. states (b, chunk, head group): each head's cum into the workspace
//      (one warp per head), its total, and (chunk > 0) the chunk's local
//      state gradient (exp(cum) dy)^T C;
//   2. carry (b, head): the reverse carry over the chunks, which leaves each
//      chunk's dh_next in place of its local sum (ssd_scan.cu's pass 2 run
//      backwards, the loads of 8 chunks started ahead of the chain);
//   3. dx and dB (b, chunk, head group): each warp owns the rows s of one
//      16-row block and sweeps the column blocks q >= s: C B^T and dy x^T
//      tiles transposed (rows s), decayed into P^T and R^T, then dx += P^T
//      dy and dB += R^T C; with dh_next B (dx's state part and U) and x
//      dh_next (dB's) from split dh_next. G's row sums (the blocks'
//      partials through shared memory, summed in block order), its column
//      sums and dt's direct part go to the workspace in float64; dB is
//      summed over the group's heads in order into one partial per group;
//   4. dC (b, chunk, head group): each warp owns the rows q of one block
//      and sweeps the blocks s <= q: dy x^T decayed into R, dC += R B, plus
//      exp(cum) dy h_prev (whose dot with C gives exp(cum) dy.(h_prev C));
//      then per head dcum, its reverse sum, ddt and the head's dA partial
//      (warp 0, float64, while the others compute the next head); dC summed
//      over the heads into one partial per group;
//   5. reduce: dB and dC summed over the groups in order, dA over (batch,
//      chunk) in float64.
// The rows past a short last chunk and the widths past hd and ds are zeros
// in shared memory (dt = 0 there). Passes 3 and 4 hold B and C rows of the
// chunk (64 KB), two heads' x and dy (64 KB: the next head's load while
// this one computes, with its float32 state, 32 KB) and a split state (48
// KB): one block of 8 warps an SM. The warps of a tensor-core sub-partition
// (w and w + 4) own row blocks w and 11 - w (row_block), so each
// sub-partition sweeps a quarter of the triangle; the head group
// (kernel.py::bwd_group) fills whole waves of such blocks. At head_dim 64
// and state 128 (mamba2-780m's) the passes are compiled with every loop's
// count known. What bounds it: dispatching mma.sync and ldmatrix at 8
// warps an SM (the products with a float32 operand three times over);
// Hopper's wgmma, with operands read by the tensor cores from shared
// memory, is the next step.
//
// float32: CUDA cores, seven launches (states, carry, scores, dx, dC, dB,
// reduce) over a workspace that holds the decayed scores P and R (Q x Q per
// head and chunk): float32 FMAs, register-blocked from shared memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "fa_mma.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_Q = 128, MAX_HD = 64, MAX_DS = 128, MAX_GROUP = 8;
constexpr int TERMS = 3;  // bf16 terms of a split float32 operand
constexpr float LOG2E = 1.4426950408889634f;
// 16-byte pieces: rows of B and C, of x and dy, the float32 states
constexpr int VEC_BC = 1, VEC_XY = 2, VEC_ST = 4;

struct Strides {
  long long x[3], dt[3], b[2], c[2], dy[3], dx[3];  // (batch, head, seq) / (batch, seq)
  int vec;  // VEC_BC | VEC_XY | VEC_ST
};

struct Dims {
  int b, H, S, hd, ds, Q, nch, group, ngroups;
};

// the workspace's parts: float64 row sums first (8-byte aligned), then
// float32; the decayed scores P and R only on the float32 route
struct Work {
  double *rowg, *colg, *ddtd;
  float *dstates, *totals, *cum, *U, *P, *R, *dbp, *dcp, *dap;
};

// the workspace's parts in order; returns its length in floats
long long carve(float* w, const Dims& d, bool f32, Work* k) {
  const long long bh = (long long)d.b * d.H;
  const long long scores = f32 ? bh * d.nch * d.Q * d.Q : 0;
  const long long partial = (long long)d.ngroups * d.b * d.S * d.ds;
  Work t;
  double** wide[3] = {&t.rowg, &t.colg, &t.ddtd};
  long long o = 0;
  for (int i = 0; i < 3; ++i) {
    *wide[i] = w ? reinterpret_cast<double*>(w + o) : nullptr;
    o += 2 * bh * d.S;
  }
  float** parts[9] = {&t.dstates, &t.totals, &t.cum, &t.U, &t.P, &t.R, &t.dbp, &t.dcp, &t.dap};
  const long long sizes[9] = {bh * d.nch * d.hd * d.ds, bh * d.nch, bh * d.S, bh * d.S, scores,
                              scores, partial, partial, bh * d.nch};
  for (int i = 0; i < 9; ++i) {
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

// the sum of v over the 4 lanes of a quad (the lanes that hold one row of
// an mma fragment)
template <typename V>
__device__ __forceinline__ V quad_sum(V v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v;
}

// the 16-row block of a chunk that warp w owns in the passes over score
// tiles: w for w < 4, 11 - w above, so that the two warps of each tensor-core
// sub-partition (w and w + 4) sweep 9 of the triangle's 36 tiles between
// them at a full chunk of 128 rows
__device__ __forceinline__ int row_block(int warp) { return warp < 4 ? warp : 11 - warp; }

__device__ __forceinline__ long long rows_of(const Dims& d, int b, int h) {
  return ((long long)b * d.H + h) * d.S;  // (b, H, S) per-row buffers
}

__device__ __forceinline__ long long state_of(const Dims& d, int b, int c, int h) {
  return (((long long)b * d.nch + c) * d.H + h) * d.hd * d.ds;
}

__device__ __forceinline__ long long scores_of(const Dims& d, int b, int c, int h) {
  return (((long long)b * d.nch + c) * d.H + h) * d.Q * d.Q;
}

// ------------------------------------------------- bf16: the tensor cores
// two packed bf16 (the lower column in the low half) as floats
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t v) {
  return make_float2(__uint_as_float(v << 16), __uint_as_float(v & 0xffff0000u));
}

// Two float32 values as TERMS packed bf16 pairs, hi + mid + lo (ssd_scan.cu's
// split: each term the bf16 rounding of what the earlier ones leave, 24 bits
// of mantissa in all), so a product with an exact bf16 operand keeps float32
// accuracy; one cvt.rn.bf16x2 a term
__device__ __forceinline__ void split3x2(float lo, float hi, uint32_t (&r)[TERMS]) {
#pragma unroll
  for (int k = 0; k < TERMS; ++k) {
    r[k] = pack_bf16(lo, hi);
    if (k + 1 < TERMS) {
      const float2 t = bf16x2_to_float2(r[k]);
      lo -= t.x;
      hi -= t.y;
    }
  }
}

// a 16 x 16 float32 tile held as two 16 x 8 accumulator fragments (n-tiles
// j = 0, 1), split into the TERMS A fragments of an mma: a0 row gr, a1 row
// gr + 8, columns gc of n-tile 0; a2, a3 the same of n-tile 1
__device__ __forceinline__ void split_frag(const float (&v)[2][4], uint32_t (&a)[TERMS][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t t[TERMS];
    split3x2(v[i >> 1][2 * (i & 1)], v[i >> 1][2 * (i & 1) + 1], t);
#pragma unroll
    for (int k = 0; k < TERMS; ++k) a[k][i] = t[k];
  }
}

// ldmatrix (.trans) address of an A operand (rows m0.. of M, columns 16 kk..
// of K) from a tile stored K x M
template <int W>
__device__ __forceinline__ uint32_t frag_at(uint32_t base, int m0, int kk, int lane) {
  return base + 2 * swz<W>(kk * 16 + (lane & 7) + ((lane >> 4) << 3), m0 / 8 + ((lane >> 3) & 1));
}

__device__ __forceinline__ float2 ld_bf16x2(const bf16* p) {
  return bf16x2_to_float2(*reinterpret_cast<const uint32_t*>(p));
}

// columns n and n + 1 of a float32 row of width ds: one 8-byte store where
// the pair is whole and aligned
__device__ __forceinline__ void put2(float* p, float a, float b, int n, int ds) {
  if (n + 1 < ds && ((uintptr_t)p & 7) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    if (n < ds) p[0] = a;
    if (n + 1 < ds) p[1] = b;
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// staged widths: head dim (x, dy rows; a state's rows), state (B, C rows;
// a state's columns)
constexpr int HW = MAX_HD, DW = MAX_DS;
constexpr int ROWS_BYTES = MAX_Q * DW * 2;   // B or C rows of a chunk
constexpr int XY_BYTES = MAX_Q * HW * 2;     // x or dy rows of a head
constexpr int XY_ELEMS = XY_BYTES / 2;
constexpr int STATE_BYTES = HW * DW * 2;     // one bf16 term of a state
constexpr int STATE_F32_BYTES = HW * DW * 4;

// a float32 (hd, ds) state, row-major, copied as it is into shared memory
// by asynchronous copies (16 bytes each where vec)
__device__ __forceinline__ void fetch_state(float* dst, const float* src, int n, bool vec) {
  if (vec) {
    for (int i = threadIdx.x; i < n / 4; i += THREADS)
      cp_async16(smem_u32(dst + 4 * i), src + 4 * i, 16);
  } else {
    for (int i = threadIdx.x; i < n; i += THREADS) cp_async4(dst + i, src + i);
  }
}

// a float32 (hd, ds) state staged by fetch_state (src NULL: zeros) as
// TERMS swizzled bf16 tiles of HW rows x DW columns (zeros past hd and ds);
// returns sum_i src_i * with_i over the thread's elements when `with` (in
// device memory) is given
__device__ __forceinline__ float stage_state(bf16* dst, const float* src, const float* with,
                                             const Dims& d) {
  constexpr int CH = DW / 8;
  float f = 0.f;
#pragma unroll
  for (int it = 0; it < HW * CH / THREADS; ++it) {
    const int i = threadIdx.x + it * THREADS, p = i / CH, ch = i - p * CH;
    float v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int n = ch * 8 + u;
      const bool in = src != nullptr && p < d.hd && n < d.ds;
      v[u] = in ? src[p * d.ds + n] : 0.f;
      if (in && with != nullptr) f = fmaf(with[p * d.ds + n], v[u], f);
    }
    uint32_t t[4][TERMS];
#pragma unroll
    for (int u = 0; u < 4; ++u) split3x2(v[2 * u], v[2 * u + 1], t[u]);
#pragma unroll
    for (int k = 0; k < TERMS; ++k)
      *reinterpret_cast<uint4*>(dst + k * (STATE_BYTES / 2) + swz<DW>(p, ch)) =
          make_uint4(t[0][k], t[1][k], t[2][k], t[3][k]);
  }
  return f;
}

// the rows of a chunk of one head (x or dy) or of B / C into a swizzled
// tile by asynchronous copies: `rows` rows (16 per row block; zeros past
// qc)
template <int W>
__device__ __forceinline__ void stage_chunk(bf16* dst, const bf16* base, long long row_stride,
                                            int rows, int qc, int width, bool vec) {
  stage_rows<W, THREADS>(
      dst, rows, width, vec,
      [&](int r) -> const bf16* { return r < qc ? base + (long long)r * row_stride : nullptr; },
      base);
}

// cum and dt of rows 0 .. qc - 1 of a head into shared memory, by 4-byte
// asynchronous copies (dt has any strides)
__device__ __forceinline__ void fetch_rows(float* cum, float* dtv, const float* cum_g,
                                           const float* dt_g, long long dt_stride, int qc) {
  for (int q = threadIdx.x; q < qc; q += THREADS) {
    cp_async4(cum + q, cum_g + q);
    cp_async4(dtv + q, dt_g + (long long)q * dt_stride);
  }
}

// ------------------------------------------------------ bf16: 1. states
// per (head group, chunk, batch): each head's cum (warp hh: head hh) into
// the workspace and its total; for chunk > 0 each head's local state
// gradient (exp(cum) dy)^T C: M = head dim, N = state, K = the chunk's rows,
// the split exp(cum) dy staged row-major and read transposed. Warp w: the
// rows 16 (w % 4) of the head dim, the columns 64 (w / 4) of the state.
// The next head's dy rows load while this head's products run.
constexpr int ST_C = 0, ST_EY = ST_C + ROWS_BYTES, ST_DY = ST_EY + TERMS * XY_BYTES,
              ST_CUM = ST_DY + XY_BYTES, ST_DT = ST_CUM + MAX_GROUP * MAX_Q * 4,
              ST_BYTES = ST_DT + MAX_GROUP * MAX_Q * 4;

__global__ void __launch_bounds__(THREADS)
ssd_bwd_tc_states(const float* __restrict__ dt, const float* __restrict__ A,
                  const bf16* __restrict__ C, const bf16* __restrict__ dy, Work w, Dims d,
                  Strides st) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* cs = reinterpret_cast<bf16*>(smem + ST_C);
  bf16* ey = reinterpret_cast<bf16*>(smem + ST_EY);
  bf16* dys = reinterpret_cast<bf16*>(smem + ST_DY);
  float* cumh = reinterpret_cast<float*>(smem + ST_CUM);
  float* dth = reinterpret_cast<float*>(smem + ST_DT);
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = g * d.group, nh = min(d.group, d.H - h0);
  const int r0 = c * d.Q, qc = min(d.Q, d.S - r0), nqb = cdiv(qc, 16);
  const int nkh = cdiv(d.hd, 16), nkd = cdiv(d.ds, 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  auto fetch_dy = [&](int hh) {
    stage_chunk<HW>(dys, dy + b * st.dy[0] + (long long)(h0 + hh) * st.dy[1] +
                             (long long)r0 * st.dy[2],
                    st.dy[2], 16 * nqb, qc, d.hd, st.vec & VEC_XY);
    cp_commit();
  };

  if (c > 0) {
    stage_chunk<DW>(cs, C + b * st.c[0] + (long long)r0 * st.c[1], st.c[1], 16 * nqb, qc, d.ds,
                    st.vec & VEC_BC);
    fetch_dy(0);
  }
  for (int i = tid; i < nh * MAX_Q; i += THREADS) {
    const int hh = i / MAX_Q, q = i - hh * MAX_Q;
    dth[i] = q < qc ? dt[b * st.dt[0] + (long long)(h0 + hh) * st.dt[1] +
                         (long long)(r0 + q) * st.dt[2]]
                    : 0.f;
  }
  __syncthreads();
  if (warp < nh) warp_cum(dth + warp * MAX_Q, A[h0 + warp], cumh + warp * MAX_Q, qc, lane);
  __syncthreads();
  for (int i = tid; i < nh * MAX_Q; i += THREADS) {
    const int hh = i / MAX_Q, q = i - hh * MAX_Q;
    if (q < qc) w.cum[rows_of(d, b, h0 + hh) + r0 + q] = cumh[i];
    if (q == qc - 1) w.totals[((long long)b * d.H + h0 + hh) * d.nch + c] = cumh[i];
  }
  if (c == 0) return;  // the state gradient into chunk 0 reaches no input
  const uint32_t cb = smem_u32(cs), eb = smem_u32(ey);
  const int mt = warp & 3, nb = warp >> 2;
  const bool active = mt < nkh && 4 * nb < nkd;
  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    cp_wait<0>();
    __syncthreads();  // C and this head's dy are staged; the previous head is done with ey
    // exp(cum_q) dy_q in TERMS bf16 terms, rows q, 8 columns a thread
    const float* cu = cumh + hh * MAX_Q;
    for (int i = tid; i < 16 * nqb * (HW / 8); i += THREADS) {
      const int q = i / (HW / 8), ch = i - q * (HW / 8);
      const float e = q < qc ? expf(cu[q]) : 0.f;
      const uint4 raw = *reinterpret_cast<const uint4*>(dys + swz<HW>(q, ch));
      const float2 v[4] = {bf16x2_to_float2(raw.x), bf16x2_to_float2(raw.y),
                           bf16x2_to_float2(raw.z), bf16x2_to_float2(raw.w)};
      uint32_t t[4][TERMS];
#pragma unroll
      for (int u = 0; u < 4; ++u) split3x2(e * v[u].x, e * v[u].y, t[u]);
#pragma unroll
      for (int k = 0; k < TERMS; ++k)
        *reinterpret_cast<uint4*>(ey + k * XY_ELEMS + swz<HW>(q, ch)) =
            make_uint4(t[0][k], t[1][k], t[2][k], t[3][k]);
    }
    __syncthreads();  // ey is written; dys is free
    if (hh + 1 < nh) fetch_dy(hh + 1);
    if (!active) continue;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int kk = 0; kk < nqb; ++kk) {
      uint32_t bb[4][4];
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2)
        if (4 * nb + n2 < nkd) ldsm_x4_t(bb[n2], frag_bt<DW>(cb, kk, 4 * nb + n2, lane));
#pragma unroll
      for (int k = 0; k < TERMS; ++k) {
        uint32_t a[4];
        ldsm_x4_t(a, frag_at<HW>(eb + k * XY_BYTES, 16 * mt, kk, lane));
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          if (4 * nb + n2 >= nkd) continue;
          mma_bf16(acc[2 * n2], a, bb[n2][0], bb[n2][1]);
          mma_bf16(acc[2 * n2 + 1], a, bb[n2][2], bb[n2][3]);
        }
      }
    }
    float* out = w.dstates + state_of(d, b, c, h);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int n = 64 * nb + 8 * j + gc;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = 16 * mt + gr + 8 * r;
        if (p < d.hd) put2(out + p * d.ds + n, acc[j][2 * r], acc[j][2 * r + 1], n, d.ds);
      }
    }
  }
}

// -------------------------------------------------- bf16: 3. dx and dB
// per (head group, chunk, batch); warp w owns the rows s of block
// row_block(w). Per
// head: V = B dh_next^T (M = s, K = state, N = head dim), U = e x.V and dx
// = e dt V; then over the column blocks q >= s the transposed tiles C B^T
// and dy x^T (rows s), P^T and R^T in registers, dx += P^T dy, dB += R^T C,
// G's column sums (rows s here), dt's direct part and G's row sums (the
// warps' partials through shared memory, summed at the next head's start);
// then dB += e dt x dh_next. dB stays in registers over the group's heads.
// The next head's x, dy, dh_next, cum and dt load while this head computes.
// FULL: head_dim 64 and state 128 (mamba2-780m's), every loop's count known
// to the compiler.
constexpr int T_B = 0, T_C = T_B + ROWS_BYTES, T_X = T_C + ROWS_BYTES, T_Y = T_X + 2 * XY_BYTES,
              T_DHF = T_Y + 2 * XY_BYTES, T_DH = T_DHF + STATE_F32_BYTES,
              T_RED = T_DH + TERMS * STATE_BYTES, T_RAW = T_RED + WARPS * MAX_Q * 8,
              T_ROWS = T_RAW + 4 * MAX_Q * 4, T_BYTES = T_ROWS + 4 * MAX_Q * 4;

template <bool FULL>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_tc_dxdb(const bf16* __restrict__ x, const float* __restrict__ dt,
                const bf16* __restrict__ B, const bf16* __restrict__ C,
                const bf16* __restrict__ dy, bf16* __restrict__ dxo, Work w, Dims d,
                Strides st) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bs = reinterpret_cast<bf16*>(smem + T_B);
  bf16* cs = reinterpret_cast<bf16*>(smem + T_C);
  bf16* xs = reinterpret_cast<bf16*>(smem + T_X);  // two buffers
  bf16* ys = reinterpret_cast<bf16*>(smem + T_Y);  // two buffers
  float* dhf = reinterpret_cast<float*>(smem + T_DHF);
  bf16* dhs = reinterpret_cast<bf16*>(smem + T_DH);
  double* red = reinterpret_cast<double*>(smem + T_RED);  // [row block][q]: G's row sums
  float* rcum = reinterpret_cast<float*>(smem + T_RAW);   // [buffer][q]
  float* rdt = rcum + 2 * MAX_Q;                           // [buffer][q]
  float* cl = reinterpret_cast<float*>(smem + T_ROWS);  // cum log2(e)
  float* dts = cl + MAX_Q;
  float* es = dts + MAX_Q;   // e_s
  float* ews = es + MAX_Q;   // e_s dt_s
  const uint32_t bsa = smem_u32(bs), csa = smem_u32(cs), dha = smem_u32(dhs);
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = g * d.group, nh = min(d.group, d.H - h0);
  const int r0 = c * d.Q, qc = min(d.Q, d.S - r0), nqb = cdiv(qc, 16);
  const int nkh = FULL ? HW / 16 : cdiv(d.hd, 16), nkd = FULL ? DW / 16 : cdiv(d.ds, 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int sb = row_block(warp);  // this warp owns the rows s of block sb
  const bool live = sb < nqb;
  const int s0 = 16 * sb + gr, s1 = s0 + 8;
  auto fetch = [&](int hh, int buf) {  // head hh's operands, in flight
    const int h = h0 + hh;
    stage_chunk<HW>(xs + buf * XY_ELEMS,
                    x + b * st.x[0] + (long long)h * st.x[1] + (long long)r0 * st.x[2], st.x[2],
                    16 * nqb, qc, d.hd, st.vec & VEC_XY);
    stage_chunk<HW>(ys + buf * XY_ELEMS,
                    dy + b * st.dy[0] + (long long)h * st.dy[1] + (long long)r0 * st.dy[2],
                    st.dy[2], 16 * nqb, qc, d.hd, st.vec & VEC_XY);
    fetch_state(dhf, w.dstates + state_of(d, b, c, h), d.hd * d.ds, st.vec & VEC_ST);
    fetch_rows(rcum + buf * MAX_Q, rdt + buf * MAX_Q, w.cum + rows_of(d, b, h) + r0,
               dt + b * st.dt[0] + (long long)h * st.dt[1] + (long long)r0 * st.dt[2],
               st.dt[2], qc);
    cp_commit();
  };
  auto rowg_sum = [&](int hh) {  // G's row sums of head hh: the blocks' partials in order
    const long long rb = rows_of(d, b, h0 + hh) + r0;
    for (int q = tid; q < qc; q += THREADS) {
      double v = 0.0;
      for (int k = 0; k <= q / 16; ++k) v += red[k * MAX_Q + q];
      w.rowg[rb + q] = v;
    }
  };

  stage_chunk<DW>(bs, B + b * st.b[0] + (long long)r0 * st.b[1], st.b[1], 16 * nqb, qc, d.ds,
                  st.vec & VEC_BC);
  stage_chunk<DW>(cs, C + b * st.c[0] + (long long)r0 * st.c[1], st.c[1], 16 * nqb, qc, d.ds,
                  st.vec & VEC_BC);
  fetch(0, 0);
  float dba[16][4];  // dB of rows s0, s1 over the group's heads
#pragma unroll
  for (int j = 0; j < 16; ++j) dba[j][0] = dba[j][1] = dba[j][2] = dba[j][3] = 0.f;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh, buf = hh & 1;
    const long long rb = rows_of(d, b, h) + r0;
    const uint32_t xsa = smem_u32(xs + buf * XY_ELEMS), ysa = smem_u32(ys + buf * XY_ELEMS);
    const bf16* xb = xs + buf * XY_ELEMS;
    cp_wait<0>();
    __syncthreads();  // head hh's operands are in; every warp is done with head hh - 1
    if (hh > 0) rowg_sum(hh - 1);
    stage_state(dhs, dhf, nullptr, d);
    {
      const float* rc = rcum + buf * MAX_Q;
      const float* rd = rdt + buf * MAX_Q;
      const float total = rc[qc - 1];
      for (int q = tid; q < MAX_Q; q += THREADS) {
        const bool in = q < qc;
        const float cu = in ? rc[q] : 0.f, dv = in ? rd[q] : 0.f;
        const float e = in ? expf(total - cu) : 0.f;
        cl[q] = cu * LOG2E;
        dts[q] = dv;
        es[q] = e;
        ews[q] = e * dv;
      }
    }
    __syncthreads();  // dh_next is split, the rows are in; red and dhf are free
    if (hh + 1 < nh) fetch(hh + 1, buf ^ 1);

    if (live) {
      const float cl0 = cl[s0], cl1 = cl[s1], dt0 = dts[s0], dt1 = dts[s1];
      const float ew0 = ews[s0], ew1 = ews[s1];
      // V = B dh_next^T; U = e x.V; dx starts at e dt V
      float dxa[8][4];
      {
        float v[8][4];
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j][0] = v[j][1] = v[j][2] = v[j][3] = 0.f;
#pragma unroll
        for (int kk = 0; kk < nkd; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, frag_a<DW>(bsa, 16 * sb, kk, lane));
#pragma unroll
          for (int j2 = 0; j2 < 4; ++j2) {
            if (j2 >= nkh) continue;
#pragma unroll
            for (int k = 0; k < TERMS; ++k) {
              uint32_t bb[4];
              ldsm_x4(bb, frag_b<DW>(dha + k * STATE_BYTES, 16 * j2, kk, lane));
              mma_bf16(v[2 * j2], a, bb[0], bb[1]);
              mma_bf16(v[2 * j2 + 1], a, bb[2], bb[3]);
            }
          }
        }
        float u0 = 0.f, u1 = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float2 xa = ld_bf16x2(xb + swz<HW>(s0, j) + gc);
          const float2 xc = ld_bf16x2(xb + swz<HW>(s1, j) + gc);
          u0 += xa.x * v[j][0] + xa.y * v[j][1];
          u1 += xc.x * v[j][2] + xc.y * v[j][3];
          dxa[j][0] = ew0 * v[j][0];
          dxa[j][1] = ew0 * v[j][1];
          dxa[j][2] = ew1 * v[j][2];
          dxa[j][3] = ew1 * v[j][3];
        }
        u0 = quad_sum(u0);
        u1 = quad_sum(u1);
        if ((lane & 3) == 0) {
          if (s0 < qc) w.U[rb + s0] = es[s0] * u0;
          if (s1 < qc) w.U[rb + s1] = es[s1] * u1;
        }
      }
      // the triangle: column blocks kq >= warp
      double cg0 = 0.0, cg1 = 0.0, dd0 = 0.0, dd1 = 0.0;  // G's column sums, dt's direct part
      for (int kq = sb; kq < nqb; ++kq) {
        float cbt[2][4], dmt[2][4];
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) cbt[j][e] = dmt[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < nkd; ++kk) {  // (C B^T)^T = B C^T
          uint32_t a[4], bb[4];
          ldsm_x4(a, frag_a<DW>(bsa, 16 * sb, kk, lane));
          ldsm_x4(bb, frag_b<DW>(csa, 16 * kq, kk, lane));
          mma_bf16(cbt[0], a, bb[0], bb[1]);
          mma_bf16(cbt[1], a, bb[2], bb[3]);
        }
#pragma unroll
        for (int kk = 0; kk < nkh; ++kk) {  // (dy x^T)^T = x dy^T
          uint32_t a[4], bb[4];
          ldsm_x4(a, frag_a<HW>(xsa, 16 * sb, kk, lane));
          ldsm_x4(bb, frag_b<HW>(ysa, 16 * kq, kk, lane));
          mma_bf16(dmt[0], a, bb[0], bb[1]);
          mma_bf16(dmt[1], a, bb[2], bb[3]);
        }
        float pv[2][4], rv[2][4];
        double colp[2][2] = {{0.0, 0.0}, {0.0, 0.0}};  // G over this lane's rows, per column
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int q = 16 * kq + 8 * j + gc + (e & 1), hi = e >> 1;
            const int s = hi ? s1 : s0;
            const bool on = q >= s && q < qc;  // masked before the exp
            const float L = on ? exp2_ftz(cl[q] - (hi ? cl1 : cl0)) : 0.f;
            const float W = L * (hi ? dt1 : dt0);
            const float cbv = cbt[j][e], dmv = dmt[j][e];
            const float P = cbv * W, R = dmv * W, G = P * dmv;
            pv[j][e] = P;
            rv[j][e] = R;
            const double gd = (double)G, md = (double)(cbv * dmv * L);
            if (hi) {
              cg1 += gd;
              dd1 += md;
            } else {
              cg0 += gd;
              dd0 += md;
            }
            colp[j][e & 1] += gd;
          }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            double v = colp[j][k];
            v += __shfl_xor_sync(FULL, v, 4);
            v += __shfl_xor_sync(FULL, v, 8);
            v += __shfl_xor_sync(FULL, v, 16);
            if (lane < 4) red[sb * MAX_Q + 16 * kq + 8 * j + gc + k] = v;
          }
        uint32_t fa[TERMS][4];
        split_frag(pv, fa);  // dx += P^T dy: dy stored q x p, read transposed
#pragma unroll
        for (int n2 = 0; n2 < 4; ++n2) {
          if (n2 >= nkh) continue;
          uint32_t bb[4];
          ldsm_x4_t(bb, frag_bt<HW>(ysa, kq, n2, lane));
#pragma unroll
          for (int k = 0; k < TERMS; ++k) {
            mma_bf16(dxa[2 * n2], fa[k], bb[0], bb[1]);
            mma_bf16(dxa[2 * n2 + 1], fa[k], bb[2], bb[3]);
          }
        }
        split_frag(rv, fa);  // dB += R^T C: C stored q x n, read transposed
#pragma unroll
        for (int n2 = 0; n2 < 8; ++n2) {
          if (n2 >= nkd) continue;
          uint32_t bb[4];
          ldsm_x4_t(bb, frag_bt<DW>(csa, kq, n2, lane));
#pragma unroll
          for (int k = 0; k < TERMS; ++k) {
            mma_bf16(dba[2 * n2], fa[k], bb[0], bb[1]);
            mma_bf16(dba[2 * n2 + 1], fa[k], bb[2], bb[3]);
          }
        }
      }
      cg0 = quad_sum(cg0);
      cg1 = quad_sum(cg1);
      dd0 = quad_sum(dd0);
      dd1 = quad_sum(dd1);
      if ((lane & 3) == 0) {
        if (s0 < qc) {
          w.colg[rb + s0] = cg0;
          w.ddtd[rb + s0] = dd0;
        }
        if (s1 < qc) {
          w.colg[rb + s1] = cg1;
          w.ddtd[rb + s1] = dd1;
        }
      }
      bf16* dp = dxo + b * st.dx[0] + (long long)h * st.dx[1] + (long long)r0 * st.dx[2];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + gc;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int s = r ? s1 : s0;
          if (s >= qc) continue;
          if (p < d.hd) dp[(long long)s * st.dx[2] + p] = __float2bfloat16_rn(dxa[j][2 * r]);
          if (p + 1 < d.hd)
            dp[(long long)s * st.dx[2] + p + 1] = __float2bfloat16_rn(dxa[j][2 * r + 1]);
        }
      }
      // dB += e dt (x dh_next): dh_next stored p x n, read transposed
      float t[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < nkh; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, frag_a<HW>(xsa, 16 * sb, kk, lane));
#pragma unroll
        for (int n2 = 0; n2 < 8; ++n2) {
          if (n2 >= nkd) continue;
#pragma unroll
          for (int k = 0; k < TERMS; ++k) {
            uint32_t bb[4];
            ldsm_x4_t(bb, frag_bt<DW>(dha + k * STATE_BYTES, kk, n2, lane));
            mma_bf16(t[2 * n2], a, bb[0], bb[1]);
            mma_bf16(t[2 * n2 + 1], a, bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        dba[j][0] += ew0 * t[j][0];
        dba[j][1] += ew0 * t[j][1];
        dba[j][2] += ew1 * t[j][2];
        dba[j][3] += ew1 * t[j][3];
      }
    }
  }
  __syncthreads();  // the last head's partial row sums of G are in
  rowg_sum(nh - 1);
  if (!live) return;
  float* out = w.dbp + (((long long)g * d.b + b) * d.S + r0) * d.ds;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + gc;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int s = r ? s1 : s0;
      if (s < qc) put2(out + (long long)s * d.ds + n, dba[j][2 * r], dba[j][2 * r + 1], n, d.ds);
    }
  }
}

// ------------------------------------------------------- bf16: 4. dC
// per (head group, chunk, batch); warp w owns the rows q of block
// row_block(w). Per
// head: HC = dy h_prev (M = q, K = head dim, N = state), Y = exp(cum)
// C.HC, dC += exp(cum) HC; then over the blocks s <= q the tiles dy x^T,
// decayed into R in registers, dC += R B. Warp 0, whose triangle is the
// shortest, takes each head's dcum, its reverse sum, ddt and dA partial
// (float64) while the others compute the next head. dC stays in registers
// over the group's heads. The next head's x, dy, h_prev, cum and dt load
// while this head computes.
constexpr int D_B = 0, D_C = D_B + ROWS_BYTES, D_X = D_C + ROWS_BYTES, D_Y = D_X + 2 * XY_BYTES,
              D_HPF = D_Y + 2 * XY_BYTES, D_HP = D_HPF + STATE_F32_BYTES,
              D_RAW = D_HP + TERMS * STATE_BYTES, D_ROWS = D_RAW + 4 * MAX_Q * 4,
              D_RED = D_ROWS + 8 * MAX_Q * 4, D_BYTES = D_RED + 2 * THREADS * 4;

template <bool FULL>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_tc_dc(const bf16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const bf16* __restrict__ B,
              const bf16* __restrict__ C, const bf16* __restrict__ dy,
              const float* __restrict__ hstates, float* __restrict__ ddt, Work w, Dims d,
              Strides st) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* bs = reinterpret_cast<bf16*>(smem + D_B);
  bf16* cs = reinterpret_cast<bf16*>(smem + D_C);
  bf16* xs = reinterpret_cast<bf16*>(smem + D_X);  // two buffers
  bf16* ys = reinterpret_cast<bf16*>(smem + D_Y);  // two buffers
  float* hpf = reinterpret_cast<float*>(smem + D_HPF);
  bf16* hps = reinterpret_cast<bf16*>(smem + D_HP);
  float* rcum = reinterpret_cast<float*>(smem + D_RAW);  // [buffer][q]
  float* rdt = rcum + 2 * MAX_Q;                          // [buffer][q]
  float* cumr = reinterpret_cast<float*>(smem + D_ROWS);  // [buffer][q]
  float* dtr = cumr + 2 * MAX_Q;                          // [buffer][q]
  float* yvr = dtr + 2 * MAX_Q;                           // [buffer][q]: Y
  float* ecs = yvr + 2 * MAX_Q;                           // exp(cum_q)
  float* cl = ecs + MAX_Q;                                // cum_q log2(e)
  float* red = reinterpret_cast<float*>(smem + D_RED);    // [buffer][thread]
  const uint32_t bsa = smem_u32(bs), hpa = smem_u32(hps);
  const int g = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int h0 = g * d.group, nh = min(d.group, d.H - h0);
  const int r0 = c * d.Q, qc = min(d.Q, d.S - r0), nqb = cdiv(qc, 16);
  const int nkh = FULL ? HW / 16 : cdiv(d.hd, 16), nkd = FULL ? DW / 16 : cdiv(d.ds, 16);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, gc = (lane & 3) * 2;
  const int qb = row_block(warp);  // this warp owns the rows q of block qb
  const bool live = qb < nqb;
  const int q0 = 16 * qb + gr, q1 = q0 + 8;
  const bool carried = hstates != nullptr && c > 0;
  auto fetch = [&](int hh, int buf) {  // head hh's operands, in flight
    const int h = h0 + hh;
    stage_chunk<HW>(xs + buf * XY_ELEMS,
                    x + b * st.x[0] + (long long)h * st.x[1] + (long long)r0 * st.x[2], st.x[2],
                    16 * nqb, qc, d.hd, st.vec & VEC_XY);
    stage_chunk<HW>(ys + buf * XY_ELEMS,
                    dy + b * st.dy[0] + (long long)h * st.dy[1] + (long long)r0 * st.dy[2],
                    st.dy[2], 16 * nqb, qc, d.hd, st.vec & VEC_XY);
    if (carried) fetch_state(hpf, hstates + state_of(d, b, c, h), d.hd * d.ds, st.vec & VEC_ST);
    fetch_rows(rcum + buf * MAX_Q, rdt + buf * MAX_Q, w.cum + rows_of(d, b, h) + r0,
               dt + b * st.dt[0] + (long long)h * st.dt[1] + (long long)r0 * st.dt[2],
               st.dt[2], qc);
    cp_commit();
  };
  // dcum, its reverse sum, ddt and dA's partial of head hh, in float64 (one
  // warp)
  auto finalize = [&](int hh, int buf) {
    const int h = h0 + hh;
    const long long rb = rows_of(d, b, h) + r0;
    const float* cu = cumr + buf * MAX_Q;
    const float* dts = dtr + buf * MAX_Q;
    const float* yv = yvr + buf * MAX_Q;
    float frob = 0.f;  // <dh_next, h_prev>: the threads' shares in a fixed order
    for (int k = 0; k < WARPS; ++k) frob += red[buf * THREADS + k * 32 + lane];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) frob += __shfl_xor_sync(FULL, frob, o);
    const float total = cu[qc - 1];
    double tsum = 0.0;
    for (int r = lane; r < qc; r += 32) tsum += (double)(dts[r] * w.U[rb + r]);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) tsum += __shfl_xor_sync(FULL, tsum, o);
    const double a = A[h];
    double carry = 0.0, da_dt = 0.0;
    for (int base = cdiv(qc, 32) * 32 - 32; base >= 0; base -= 32) {
      const int r = base + lane;
      double v = 0.0;
      float ur = 0.f;
      if (r < qc) {
        ur = w.U[rb + r];
        v = w.rowg[rb + r] - w.colg[rb + r] + (double)yv[r] - (double)(dts[r] * ur);
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
        ddt[rb + r] = __double2float_rn(w.ddtd[rb + r] + (double)ur + a * v);
        da_dt += (double)dts[r] * v;
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) da_dt += __shfl_xor_sync(FULL, da_dt, o);
    if (lane == 0) w.dap[((long long)b * d.nch + c) * d.H + h] = (float)da_dt;
  };

  stage_chunk<DW>(bs, B + b * st.b[0] + (long long)r0 * st.b[1], st.b[1], 16 * nqb, qc, d.ds,
                  st.vec & VEC_BC);
  stage_chunk<DW>(cs, C + b * st.c[0] + (long long)r0 * st.c[1], st.c[1], 16 * nqb, qc, d.ds,
                  st.vec & VEC_BC);
  fetch(0, 0);
  float dca[16][4];  // dC of rows q0, q1 over the group's heads
#pragma unroll
  for (int j = 0; j < 16; ++j) dca[j][0] = dca[j][1] = dca[j][2] = dca[j][3] = 0.f;

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh, buf = hh & 1;
    const uint32_t xsa = smem_u32(xs + buf * XY_ELEMS), ysa = smem_u32(ys + buf * XY_ELEMS);
    cp_wait<0>();
    __syncthreads();  // head hh's operands are in; every warp is done with head hh - 1
    // h_prev in TERMS terms, and this thread's share of <dh_next, h_prev>
    red[buf * THREADS + tid] =
        carried ? stage_state(hps, hpf, w.dstates + state_of(d, b, c, h), d) : 0.f;
    {
      const float* rc = rcum + buf * MAX_Q;
      const float* rd = rdt + buf * MAX_Q;
      for (int q = tid; q < MAX_Q; q += THREADS) {
        const bool in = q < qc;
        const float cu = in ? rc[q] : 0.f;
        cumr[buf * MAX_Q + q] = cu;
        dtr[buf * MAX_Q + q] = in ? rd[q] : 0.f;
        ecs[q] = in ? expf(cu) : 0.f;
        cl[q] = cu * LOG2E;
      }
    }
    __syncthreads();  // h_prev is split, the rows are in; hpf is free
    if (hh + 1 < nh) fetch(hh + 1, buf ^ 1);
    if (warp == 0 && hh > 0) finalize(hh - 1, buf ^ 1);
    if (!live) continue;
    const float* dts = dtr + buf * MAX_Q;
    const float cl0 = cl[q0], cl1 = cl[q1], ec0 = ecs[q0], ec1 = ecs[q1];
    float y0 = 0.f, y1 = 0.f;
    if (carried) {  // HC = dy h_prev: h_prev stored p x n, read transposed
      float t[16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) t[j][0] = t[j][1] = t[j][2] = t[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < nkh; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, frag_a<HW>(ysa, 16 * qb, kk, lane));
#pragma unroll
        for (int n2 = 0; n2 < 8; ++n2) {
          if (n2 >= nkd) continue;
#pragma unroll
          for (int k = 0; k < TERMS; ++k) {
            uint32_t bb[4];
            ldsm_x4_t(bb, frag_bt<DW>(hpa + k * STATE_BYTES, kk, n2, lane));
            mma_bf16(t[2 * n2], a, bb[0], bb[1]);
            mma_bf16(t[2 * n2 + 1], a, bb[2], bb[3]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float2 ca = ld_bf16x2(cs + swz<DW>(q0, j) + gc);
        const float2 cb = ld_bf16x2(cs + swz<DW>(q1, j) + gc);
        y0 += ca.x * t[j][0] + ca.y * t[j][1];
        y1 += cb.x * t[j][2] + cb.y * t[j][3];
        dca[j][0] += ec0 * t[j][0];
        dca[j][1] += ec0 * t[j][1];
        dca[j][2] += ec1 * t[j][2];
        dca[j][3] += ec1 * t[j][3];
      }
      y0 = quad_sum(y0);
      y1 = quad_sum(y1);
    }
    if ((lane & 3) == 0) {
      yvr[buf * MAX_Q + q0] = ec0 * y0;
      yvr[buf * MAX_Q + q1] = ec1 * y1;
    }
    // the triangle: blocks ks <= qb
    for (int ks = 0; ks <= qb; ++ks) {
      float dm[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) dm[j][0] = dm[j][1] = dm[j][2] = dm[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < nkh; ++kk) {
        uint32_t a[4], bb[4];
        ldsm_x4(a, frag_a<HW>(ysa, 16 * qb, kk, lane));
        ldsm_x4(bb, frag_b<HW>(xsa, 16 * ks, kk, lane));
        mma_bf16(dm[0], a, bb[0], bb[1]);
        mma_bf16(dm[1], a, bb[2], bb[3]);
      }
      float rv[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int s = 16 * ks + 8 * j + gc + (e & 1), hi = e >> 1;
          const int q = hi ? q1 : q0;
          const bool on = s <= q && q < qc;  // masked before the exp
          const float L = on ? exp2_ftz((hi ? cl1 : cl0) - cl[s]) : 0.f;
          rv[j][e] = dm[j][e] * (L * dts[s]);
        }
      uint32_t fa[TERMS][4];
      split_frag(rv, fa);  // dC += R B: B stored s x n, read transposed
#pragma unroll
      for (int n2 = 0; n2 < 8; ++n2) {
        if (n2 >= nkd) continue;
        uint32_t bb[4];
        ldsm_x4_t(bb, frag_bt<DW>(bsa, ks, n2, lane));
#pragma unroll
        for (int k = 0; k < TERMS; ++k) {
          mma_bf16(dca[2 * n2], fa[k], bb[0], bb[1]);
          mma_bf16(dca[2 * n2 + 1], fa[k], bb[2], bb[3]);
        }
      }
    }
  }
  __syncthreads();  // the last head's Y and shares of <dh_next, h_prev> are in
  if (warp == 0) finalize(nh - 1, (nh - 1) & 1);
  if (!live) return;
  float* out = w.dcp + (((long long)g * d.b + b) * d.S + r0) * d.ds;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int n = 8 * j + gc;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int q = r ? q1 : q0;
      if (q < qc) put2(out + (long long)q * d.ds + n, dca[j][2 * r], dca[j][2 * r + 1], n, d.ds);
    }
  }
}

// ---------------------------------------------------------- float32: states
// per (head, chunk, batch): cum into the workspace, the chunk's total, and
// (chunk > 0) sum_q exp(cum_q) dy_q (x) C_q. Threads: rows p = warp + 8 i,
// columns n = lane + 32 u.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_states_kernel(const float* __restrict__ dt, const float* __restrict__ A, const T* __restrict__ C,
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

// ---------------------------------------------------------- float32: scores
// per (head group, chunk, batch): CB = C B^T in registers once, then per
// head DX = dy x^T, P = CB W and R = DX W into the workspace (zero where
// masked), the row sums of G = P DX, its column sums, and the column sums
// of CB DX L (dt's direct part), those three summed in float64 (the
// reverse sum of dcum cancels the terms both sums hold, exactly in float64
// where float32 would leave their roundings behind). Threads: rows
// q = ty + 16 i, columns s = tx + 16 j.
template <typename T, int RT>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_scores_kernel(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ B,
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

// -------------------------------------------------------------- float32: dx
// per (head, chunk, batch): dx = P^T dy + e dt (dh_next B); U; Y =
// exp(cum) dy.(h_prev C); <dh_next, h_prev>; then dcum, its reverse sum,
// ddt and the head's dA partial. Threads: rows ty + 16 i, head-dim
// columns tx + 16 j.
template <typename T, int RT>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dx_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
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

// ---------------------------------------------------------- float32: dC, dB
// per (head group, chunk, batch), summed over the group's heads in order:
// dC_q = R B + (exp(cum_q) dy_q) h_prev, dB_s = R^T C + (e_s dt_s x_s)
// dh_next, into the group's partial. Threads: rows ty + 16 i, state
// columns tx + 16 j.
template <typename T, int RT, bool DB>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dbc_kernel(const T* __restrict__ x, const float* __restrict__ dt, const T* __restrict__ B,
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

// ------------------------------------------------------------ both: 2. carry
// per (batch, head) and state element, over the chunks from the last: the
// local sum of chunk c becomes dh_next of chunk c. The loads of 8 chunks
// are started ahead of their dependent chain (ssd_scan.cu's pass 2).
__global__ void __launch_bounds__(THREADS)
ssd_bwd_carry_kernel(const float* __restrict__ dstate, Work w, Dims d) {
  constexpr int U = 8;
  const int n_el = d.hd * d.ds;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int bh = blockIdx.y, b = bh / d.H, h = bh - b * d.H;
  if (e >= n_el) return;
  float g = dstate ? dstate[(long long)bh * n_el + e] : 0.f;
  for (int c0 = d.nch - 1; c0 >= 0; c0 -= U) {
    float local[U], decay[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 - u;
      local[u] = c > 0 ? w.dstates[state_of(d, b, c, h) + e] : 0.f;
      decay[u] = c > 0 ? expf(w.totals[(long long)bh * d.nch + c]) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 - u;
      if (c < 0) break;
      w.dstates[state_of(d, b, c, h) + e] = g;
      if (c > 0) g = g * decay[u] + local[u];
    }
  }
}

// ----------------------------------------------------------- both: 5. reduce
// dB and dC: the groups' partials summed in group order; dA: the (batch,
// chunk) partials summed in float64 (block 0)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_reduce_kernel(Work w, Dims d, T* __restrict__ dB, T* __restrict__ dC,
                      float* __restrict__ dA) {
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
// shared memory of each float32 kernel, in bytes
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

int launch_carry(const float* dstate, const Work& w, const Dims& d, cudaStream_t s) {
  ssd_bwd_carry_kernel<<<dim3(cdiv(d.hd * d.ds, THREADS), d.b * d.H), THREADS, 0, s>>>(dstate, w,
                                                                                      d);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_reduce(const Work& w, const Dims& d, T* dB, T* dC, float* dA, cudaStream_t s) {
  const long long n = (long long)d.b * d.S * d.ds;
  ssd_bwd_reduce_kernel<T><<<(unsigned)((n + THREADS - 1) / THREADS), THREADS, 0, s>>>(w, d, dB,
                                                                                       dC, dA);
  return (int)cudaGetLastError();
}

// float32: the seven CUDA-core launches
template <int RT>
int launch_rt(const float* x, const float* dt, const float* A, const float* B, const float* C,
              const float* dy, const float* dstate, const float* hstates, float* dx, float* ddt,
              float* dA, float* dB, float* dC, const Work& w, const Dims& d, const Strides& st,
              int optin, cudaStream_t s) {
  using T = float;
  const int qr = 16 * RT;
  int e = launch_k(ssd_bwd_states_kernel<T>, dim3(d.H, d.nch, d.b), smem_states(d), optin, s, dt,
                   A, C, dy, w, d, st);
  if (e) return e;
  e = launch_carry(dstate, w, d, s);
  if (e) return e;
  const dim3 groups(d.ngroups, d.nch, d.b), heads(d.H, d.nch, d.b);
  e = launch_k(ssd_bwd_scores_kernel<T, RT>, groups, smem_scores(d, qr), optin, s, x, dt, B, C,
               dy, w, d, st);
  if (e) return e;
  e = launch_k(ssd_bwd_dx_kernel<T, RT>, heads, smem_dx(d, qr), optin, s, x, dt, A, B, C, dy,
               hstates, dx, ddt, w, d, st);
  if (e) return e;
  e = launch_k(ssd_bwd_dbc_kernel<T, RT, false>, groups, smem_dbc(d, qr), optin, s, x, dt, B, C,
               dy, hstates, w, d, st);
  if (e) return e;
  e = launch_k(ssd_bwd_dbc_kernel<T, RT, true>, groups, smem_dbc(d, qr), optin, s, x, dt, B, C,
               dy, hstates, w, d, st);
  if (e) return e;
  return launch_reduce(w, d, dB, dC, dA, s);
}

// bf16: the five tensor-core launches
int launch_tc(const bf16* x, const float* dt, const float* A, const bf16* B, const bf16* C,
              const bf16* dy, const float* dstate, const float* hstates, bf16* dx, float* ddt,
              float* dA, bf16* dB, bf16* dC, const Work& w, const Dims& d, const Strides& st,
              int optin, cudaStream_t s) {
  const dim3 groups(d.ngroups, d.nch, d.b);
  int e = launch_k(ssd_bwd_tc_states, groups, ST_BYTES, optin, s, dt, A, C, dy, w, d, st);
  if (e) return e;
  e = launch_carry(dstate, w, d, s);
  if (e) return e;
  const bool full = d.hd == HW && d.ds == DW;
  e = launch_k(full ? ssd_bwd_tc_dxdb<true> : ssd_bwd_tc_dxdb<false>, groups, T_BYTES, optin, s,
               x, dt, B, C, dy, dx, w, d, st);
  if (e) return e;
  e = launch_k(full ? ssd_bwd_tc_dc<true> : ssd_bwd_tc_dc<false>, groups, D_BYTES, optin, s, x,
               dt, A, B, C, dy, hstates, ddt, w, d, st);
  if (e) return e;
  return launch_reduce(w, d, dB, dC, dA, s);
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
  constexpr bool f32 = sizeof(T) == 4;
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
  // 16-byte pieces: rows of 8 bf16 at 16-byte aligned starts
  auto rows16 = [](const void* p, const long long* s, int n) {
    bool ok = aligned16(p);
    for (int i = 0; i < n; ++i) ok = ok && s[i] % 8 == 0;
    return ok;
  };
  st.vec = 0;
  if (ds % 8 == 0 && rows16(B, st.b, 2) && rows16(C, st.c, 2)) st.vec |= VEC_BC;
  if (hd % 8 == 0 && rows16(x, st.x, 3) && rows16(dy, st.dy, 3)) st.vec |= VEC_XY;
  Work w;
  carve(work, d, f32, &w);
  if ((hd * ds) % 4 == 0 && aligned16(w.dstates) && (hstates == nullptr || aligned16(hstates)))
    st.vec |= VEC_ST;
  const int optin = smem_optin();
  if (optin < 0) return -optin;
  const cudaStream_t s = (cudaStream_t)stream;
  if constexpr (!f32) {
    return launch_tc(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, w, d, st, optin, s);
  } else {
    if (Q <= 16)
      return launch_rt<1>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, w, d, st,
                          optin, s);
    if (Q <= 32)
      return launch_rt<2>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, w, d, st,
                          optin, s);
    if (Q <= 64)
      return launch_rt<4>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, w, d, st,
                          optin, s);
    return launch_rt<8>(x, dt, A, B, C, dy, dstate, hstates, dx, ddt, dA, dB, dC, w, d, st, optin,
                        s);
  }
}

}  // namespace

extern "C" {

// Floats of K6b's workspace at these sizes and head group, on the float32
// route (f32 != 0, which also holds the decayed scores) or the bf16 one
// (the host mirrors it as kernel.py::bwd_work_floats); -1 for sizes it
// refuses.
long long ssd_scan_bwd_work_floats(int b, int H, int S, int hd, int ds, int Q, int group,
                                   int f32) {
  if (!valid(b, H, S, hd, ds, Q, group)) return -1;
  return carve(nullptr, dims(b, H, S, hd, ds, Q, group), f32 != 0, nullptr);
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
