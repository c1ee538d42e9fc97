// Mamba-2 SSD chunked scan: the output and final state of the recurrence
//   h_t = exp(dt_t A) h_{t-1} + dt_t x_t (x) B_t,   y_t = C_t . h_t
// taken chunk by chunk, as the state-space duality (arXiv:2405.21060) does.
//
// Replaces src/repro/kernels/ssd_scan/kernel.py::ssd_scan_bhsd (_ssd_kernel),
// the Pallas TPU kernel behind modeling/ssd.py's prefill path.
// x: (b, H, S, hd) in float32 or bf16, dt: (b, H, S) float32, A: (H,) float32,
// B and C: (b, S, ds) in x's dtype, shared by every head (one group). Any
// strides with a contiguous last dimension for x, B, C and y (dt may have any
// strides), so the model's (b, S, H, hd) tensors and the slices of its
// projection are read and written without copies. y is written in x's dtype;
// the final state (b, H, hd, ds) is float32 and contiguous.
//
// Per chunk of Q rows (Q <= 128; the last chunk may be shorter), as the TPU
// kernel computes it, in float32 from widened inputs:
//   cum = cumsum(dt * A), total = cum[last row]  (the products dt * A in
//         float32, summed in float64 and rounded: exact in practice, so the
//         order of the scan does not show; the decays amplify a float32
//         sum's rounding, and the plain version sums in float64 too)
//   y   = ((C B^T) * L * dt_s) x + exp(cum) * (C h^T),  L = exp(cum_q - cum_s)
//         for s <= q and 0 above the diagonal (masked before the exp: above it
//         cum_q - cum_s > 0 and the exp could overflow)
//   h   = exp(total) h + (x * dt * exp(total - cum))^T B
// The rows past the end of a short last chunk are zeros with dt = 0, which
// is what the reference's zero padding feeds its kernel.
//
// Design. A block takes one (batch, chunk) and a group of up to 8 heads (and
// a slice of head_dim, 16, 32 or 64 wide, when head_dim is wider). It
// stages the chunk's B and C rows once, and the heads' dt; each of its 8
// warps sums one head's cum in float64. The scores C B^T do not depend on the
// head: the block computes them once, only the 16 x 8 tiles on or below the
// diagonal, for every head of the group.
//
// bf16 (the serving path, ssd_tc_kernel): every product runs on the tensor
// cores (mma.sync m16n8k16, float32 accumulators). The scores come from the
// exact bf16 rows of C and B. The products with a float32 operand, the
// decayed scores times x, C times the carried state and (x w)^T times B,
// split that operand into three bf16 terms (hi + mid + lo: 24 bits of
// mantissa) against the exact bf16 other operand, so they keep float32
// accuracy. The scores are decayed, masked and split per 16-column step in
// registers as A fragments; x, (x w) and B are staged transposed so that
// every fragment is one 4-byte shared load.
//
// float32 (ssd_chunk_kernel): CUDA cores, as the other float32 paths of the
// port; each warp keeps its score tiles in registers and the three per-head
// products are register-blocked FMAs from shared memory. States are written
// with 16-byte stores. In both kernels the next head's x is loaded into
// registers while the current one computes.
//
// Routes (single_chunk; the host mirrors it as ssd_route): a prompt of one chunk of at most 64 rows (the serving
// prefill: S = 32) is one launch with no workspace: y and the final state
// straight from the chunk. Longer prompts run their chunks in parallel in
// three launches, as K3's chunked float32 scan does: (1) per (batch, chunk,
// head group) each chunk's local state from zero and its total decay into a
// workspace; (2) per (batch, head) a short sequential pass over the chunks,
// h = exp(total) h + local, which leaves in the workspace the state entering
// each chunk and writes the final state; (3) per (batch, chunk, head group)
// y, the intra-chunk part plus exp(cum) C h_prev^T.
//
// What bounds it on the H100: at the serving prefill (48 heads, one chunk of
// 32) the latency of one launch's staging and its dependent steps; at long
// prompts the per-head products (about 2 Q hd ds + Q^2 hd multiply-adds per
// head and chunk): three tensor-core passes each in bf16, float32 FMAs on
// CUDA cores in float32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int MAX_GROUP = 8;  // heads of a block: one float64 cum scan per warp
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;
enum Mode { SINGLE = 0, STATES = 1, OUTPUT = 2 };

struct Strides {
  long long x[3], dt[3], b[2], c[2], y[3];  // (batch, head, seq) / (batch, seq)
  int vec;  // bit 0: B and C rows in 16-byte pieces; bit 1: the workspace's rows too
};

constexpr int VEC_BC = 1, VEC_WORK = 2;

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}


__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// row stride, in floats, of the float32 kernel's staged B or C tile: the
// state axis padded to 16 plus 4, so that the 8 rows of a fragment group
// fall on distinct banks and rows stay 16-byte aligned
__host__ __device__ __forceinline__ int tile_stride(int ds) { return cdiv(ds, 16) * 16 + 4; }

// Shared memory of a float32 block, in bytes (QR = 16 RT rows, PR = 16 PT
// columns): C tile (SINGLE, OUTPUT), B tile (the scores share its room in
// OUTPUT, where B is needed only for the scores), scores (SINGLE), x, x w
// (SINGLE, STATES), the carried state (OUTPUT), dt and cum of the group's
// heads.
__host__ __device__ __forceinline__ size_t smem_bytes(int mode, int rt, int pt, int ds) {
  const size_t qr = 16 * rt, pr = 16 * pt, tile = qr * tile_stride(ds) * sizeof(float);
  const size_t sc = qr * (qr + 1) * sizeof(float), xs = qr * pr * sizeof(float);
  size_t n = 2 * MAX_GROUP * qr * sizeof(float) + xs;
  if (mode == SINGLE) n += 2 * tile + sc + xs;
  if (mode == STATES) n += tile + xs;
  if (mode == OUTPUT) n += tile + (tile > sc ? tile : sc) + pr * (ds + 1) * sizeof(float);
  return n;
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], unsigned a0, unsigned a1, unsigned a2,
                                         unsigned a3, unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// the 16 x 8 score tile t of the lower triangle: row block mb, column tile nt
// (row block mb holds the column tiles 0 .. 2 mb + 1)
__device__ __forceinline__ void tile_of(int t, int& mb, int& nt) {
  mb = 0;
  while (t >= 2 * (mb + 1)) {
    t -= 2 * (mb + 1);
    ++mb;
  }
  nt = t;
}

template <int RT, int PT, int MODE>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
                 const float* __restrict__ Bm, const float* __restrict__ Cm, float* __restrict__ y,
                 float* __restrict__ state, float* __restrict__ work, float* __restrict__ totals,
                 int H, int S, int hd, int ds, int Q, int group, Strides st) {
  constexpr int QR = 16 * RT, PR = 16 * PT, SS = QR + 1;
  constexpr int MB = RT;                              // 16-row blocks of the chunk
  constexpr int TPW = (MB * (MB + 1) + WARPS - 1) / WARPS;  // score tiles of a warp
  constexpr bool SCORES = MODE != STATES;
  extern __shared__ __align__(16) unsigned char smem[];
  const int TSd = tile_stride(ds);
  const size_t tile_bytes = (size_t)QR * TSd * sizeof(float);
  unsigned char* p = smem;
  float* dts = reinterpret_cast<float*>(p);  p += MAX_GROUP * QR * sizeof(float);
  float* cum = reinterpret_cast<float*>(p);  p += MAX_GROUP * QR * sizeof(float);
  float* xs = reinterpret_cast<float*>(p);   p += QR * PR * sizeof(float);
  float* ct = nullptr;
  float* bt = nullptr;
  float* sc = nullptr;
  float* xw = nullptr;
  float* hp = nullptr;
  if (MODE == SINGLE) {
    ct = reinterpret_cast<float*>(p);      p += tile_bytes;
    bt = reinterpret_cast<float*>(p);      p += tile_bytes;
    sc = reinterpret_cast<float*>(p);  p += QR * SS * sizeof(float);
    xw = reinterpret_cast<float*>(p);
  } else if (MODE == STATES) {
    bt = reinterpret_cast<float*>(p);      p += tile_bytes;
    xw = reinterpret_cast<float*>(p);
  } else {
    ct = reinterpret_cast<float*>(p);      p += tile_bytes;
    bt = reinterpret_cast<float*>(p);      // the scores reuse B's room once they are taken
    sc = reinterpret_cast<float*>(p);
    const size_t scb = (size_t)QR * SS * sizeof(float);
    p += tile_bytes > scb ? tile_bytes : scb;
    hp = reinterpret_cast<float*>(p);
  }

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nslice = cdiv(hd, PR);
  const int hg = blockIdx.x / nslice, p0 = (blockIdx.x - hg * nslice) * PR;
  const int c = blockIdx.y, b = blockIdx.z, nch = gridDim.y;
  const int h0 = hg * group, nh = min(group, H - h0);
  const int np = min(PR, hd - p0);
  const int r0 = c * Q, qc = min(Q, S - r0);

  // ---- stage: the chunk's B (and C) rows, zero past qc and ds; the heads' dt
  {
    const float* bp = Bm + b * st.b[0] + (long long)r0 * st.b[1];
    const float* cp = Cm + b * st.c[0] + (long long)r0 * st.c[1];
    const float zero = 0.f;
    for (int i = tid; i < QR * TSd; i += THREADS) {
      const int s = i / TSd, k = i - s * TSd;
      const bool in = s < qc && k < ds;
      bt[i] = in ? bp[(long long)s * st.b[1] + k] : zero;
      if (SCORES) ct[i] = in ? cp[(long long)s * st.c[1] + k] : zero;
    }
    for (int i = tid; i < MAX_GROUP * QR; i += THREADS) {
      const int hh = i / QR, q = i - hh * QR;
      dts[i] = (hh < nh && q < qc)
                   ? dt[b * st.dt[0] + (long long)(h0 + hh) * st.dt[1] + (long long)(r0 + q) * st.dt[2]]
                   : 0.f;
    }
  }
  __syncthreads();
  // ---- cum: warp hh sums head hh's dt * A in float64, 32 rows a step
  if (warp < nh) {
    const float a = A[h0 + warp];
    double carry = 0.0;
    for (int base = 0; base < QR; base += 32) {
      const int q = base + lane;
      double v = (double)(dts[warp * QR + q] * a);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      cum[warp * QR + q] = __double2float_rn(v);
      carry = __shfl_sync(FULL, v, 31);
    }
  }
  // ---- the scores C B^T of this warp's lower-triangle tiles, in registers
  float g[TPW][4];
#pragma unroll
  for (int i = 0; i < TPW; ++i) g[i][0] = g[i][1] = g[i][2] = g[i][3] = 0.f;
  const int gr = lane >> 2, gc = (lane & 3) * 2;  // the fragment's row and column in its tile
  if (SCORES) {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int t = warp + WARPS * i;
      if (t >= MB * (MB + 1)) continue;
      int mb, nt;
      tile_of(t, mb, nt);
      // the fragment's rows 16 mb + gr (+ 8) of C, columns 8 nt + gc (+ 1)
      // of the scores: rows of B
      const float* crow = ct + (size_t)(16 * mb + gr) * TSd;
      const float* brow = bt + (size_t)(8 * nt + gc) * TSd;
      for (int k = 0; k < ds; ++k) {
        const float cv0 = crow[k], cv8 = crow[8 * TSd + k];
        const float bv0 = brow[k], bv1 = brow[TSd + k];
        g[i][0] = fmaf(cv0, bv0, g[i][0]);
        g[i][1] = fmaf(cv0, bv1, g[i][1]);
        g[i][2] = fmaf(cv8, bv0, g[i][2]);
        g[i][3] = fmaf(cv8, bv1, g[i][3]);
      }
    }
  }
  __syncthreads();  // cum is summed; B's room is free for the scores (OUTPUT)
  if (SCORES)
    for (int i = tid; i < QR * SS; i += THREADS) sc[i] = 0.f;  // above the diagonal tiles: 0

  // x of head hh, this thread's share, in registers: element tid + THREADS u
  constexpr int XPT = (QR * PR + THREADS - 1) / THREADS;
  float xr[XPT];
  auto fetch_x = [&](int hh) {
    const float* xp = x + b * st.x[0] + (long long)(h0 + hh) * st.x[1] + (long long)r0 * st.x[2] + p0;
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const int i = tid + THREADS * u, q = i / PR, pp = i - q * PR;
      xr[u] = (i < QR * PR && q < qc && pp < np) ? xp[(long long)q * st.x[2] + pp] : 0.f;
    }
  };
  fetch_x(0);
  const int ty = tid >> 4, tx = tid & 15;  // y: rows ty + 16 i, columns tx + 16 j
  const int py = tid >> 5;                 // states: rows py + 8 i, columns 4 lane + u

  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* cu = cum + hh * QR;
    const float* dh = dts + hh * QR;
    __syncthreads();  // the previous head is done with xs, sc, hp
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const int i = tid + THREADS * u;
      if (i < QR * PR) xs[i] = xr[u];
    }
    if (hh + 1 < nh) fetch_x(hh + 1);  // in flight while this head computes
    if (MODE != OUTPUT) __syncthreads();
    const float total = cu[qc - 1];
    if (MODE != OUTPUT) {  // x * (dt * exp(total - cum))
      for (int i = tid; i < QR * PR; i += THREADS) {
        const int q = i / PR;
        xw[i] = xs[i] * (dh[q] * expf(total - cu[q]));
      }
    }
    if (SCORES) {  // this warp's tiles, decayed and masked before the exp
#pragma unroll
      for (int i = 0; i < TPW; ++i) {
        const int t = warp + WARPS * i;
        if (t >= MB * (MB + 1)) continue;
        int mb, nt;
        tile_of(t, mb, nt);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = 16 * mb + gr + (e >> 1) * 8, s = 8 * nt + gc + (e & 1);
          sc[q * SS + s] = s <= q ? g[i][e] * expf(cu[q] - cu[s]) * dh[s] : 0.f;
        }
      }
    }
    const bool carried = MODE == OUTPUT && c > 0;
    if (carried) {  // the state entering this chunk (pass 2 left it in the workspace)
      const float* wp = work + (((long long)b * nch + c) * H + h) * hd * ds + (long long)p0 * ds;
      for (int i = tid; i < np * ds; i += THREADS) {
        const int pp = i / ds, n = i - pp * ds;
        hp[pp * (ds + 1) + n] = wp[i];
      }
    }
    __syncthreads();

    if (SCORES) {  // y = scores x (+ exp(cum) C h_prev^T)
      float yo[RT][PT], yi[RT][PT];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int j = 0; j < PT; ++j) yo[i][j] = yi[i][j] = 0.f;
      const int s_end = min(ty + 16 * (RT - 1), qc - 1);  // the thread's last live row
      for (int s = 0; s <= s_end; ++s) {
        float sv[RT], xv[PT];
#pragma unroll
        for (int i = 0; i < RT; ++i) sv[i] = sc[(ty + 16 * i) * SS + s];
#pragma unroll
        for (int j = 0; j < PT; ++j) xv[j] = xs[s * PR + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < PT; ++j) yo[i][j] = fmaf(sv[i], xv[j], yo[i][j]);
      }
      if (carried) {
        for (int n = 0; n < ds; ++n) {
          float cv[RT], hv[PT];
#pragma unroll
          for (int i = 0; i < RT; ++i) cv[i] = ct[(size_t)(ty + 16 * i) * TSd + n];
#pragma unroll
          for (int j = 0; j < PT; ++j) hv[j] = hp[(tx + 16 * j) * (ds + 1) + n];
#pragma unroll
          for (int i = 0; i < RT; ++i)
#pragma unroll
            for (int j = 0; j < PT; ++j) yi[i][j] = fmaf(cv[i], hv[j], yi[i][j]);
        }
      }
      float* yp = y + b * st.y[0] + (long long)h * st.y[1] + (long long)r0 * st.y[2] + p0;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        const int q = ty + 16 * i;
        if (q >= qc) continue;
        const float e = carried ? expf(cu[q]) : 0.f;
#pragma unroll
        for (int j = 0; j < PT; ++j) {
          const int pp = tx + 16 * j;
          if (pp < np)
            yp[(long long)q * st.y[2] + pp] = carried ? yo[i][j] + yi[i][j] * e : yo[i][j];
        }
      }
    }

    if (MODE != OUTPUT) {  // the chunk's state from zero: (x w)^T B
      float* out = MODE == SINGLE
                       ? state + ((long long)b * H + h) * hd * ds + (long long)p0 * ds
                       : work + (((long long)b * nch + c) * H + h) * hd * ds + (long long)p0 * ds;
      const bool vec = (ds & 3) == 0;
      for (int n0 = 0; n0 < ds; n0 += 128) {
        const int n = n0 + 4 * lane;
        float acc[PR / 8][4];
#pragma unroll
        for (int i = 0; i < PR / 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
        if (n < ds) {
          for (int s = 0; s < qc; ++s) {
            const float4 bv = *reinterpret_cast<const float4*>(bt + (size_t)s * TSd + n);
#pragma unroll
            for (int i = 0; i < PR / 8; ++i) {
              const float wv = xw[s * PR + py + 8 * i];
              acc[i][0] = fmaf(wv, bv.x, acc[i][0]);
              acc[i][1] = fmaf(wv, bv.y, acc[i][1]);
              acc[i][2] = fmaf(wv, bv.z, acc[i][2]);
              acc[i][3] = fmaf(wv, bv.w, acc[i][3]);
            }
          }
#pragma unroll
          for (int i = 0; i < PR / 8; ++i) {
            const int pp = py + 8 * i;
            if (pp >= np) continue;
            float* o = out + (long long)pp * ds + n;
            if (vec) {
              *reinterpret_cast<float4*>(o) = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
            } else {
#pragma unroll
              for (int u = 0; u < 4; ++u)
                if (n + u < ds) o[u] = acc[i][u];
            }
          }
        }
      }
      if (MODE == STATES && tid == 0 && p0 == 0)
        totals[((long long)b * H + h) * nch + c] = total;
    }
  }
}

// ------------------------------------------------- bf16: the tensor cores
// A float32 value as three bf16 terms, hi + mid + lo: 24 bits of mantissa,
// so a product of it with an exact bf16 operand keeps float32 accuracy
__device__ __forceinline__ void split3(float v, unsigned short (&t)[3]) {
  const __nv_bfloat16 h = __float2bfloat16_rn(v);
  const float r1 = v - __bfloat162float(h);
  const __nv_bfloat16 m = __float2bfloat16_rn(r1);
  const __nv_bfloat16 l = __float2bfloat16_rn(r1 - __bfloat162float(m));
  t[0] = __bfloat16_as_ushort(h);
  t[1] = __bfloat16_as_ushort(m);
  t[2] = __bfloat16_as_ushort(l);
}

// two split values as the three packed bf16x2 registers of an mma fragment
// (the lower column in the low half)
__device__ __forceinline__ void split3x2(float lo, float hi, unsigned (&r)[3]) {
  unsigned short a[3], b[3];
  split3(lo, a);
  split3(hi, b);
#pragma unroll
  for (int t = 0; t < 3; ++t) r[t] = (unsigned)a[t] | ((unsigned)b[t] << 16);
}

__device__ __forceinline__ unsigned ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// Shared memory of the bf16 kernel, in bytes from the block's base
struct TcLayout {
  size_t dts, cum, ct, bt, hp, g, xt, xw, bT, hf, total;
};

__host__ __device__ __forceinline__ TcLayout tc_layout(int mode, int rt, int pt, int ds) {
  const size_t qr = 16 * rt, pr = 16 * pt, qp = qr + 8, ds16 = cdiv(ds, 16) * 16, dp = ds16 + 8;
  TcLayout L;
  size_t o = 0;
  L.dts = o;  o += MAX_GROUP * qr * 4;                   // dt of the group's heads
  L.cum = o;  o += MAX_GROUP * qr * 4;                   // their cum
  L.ct = o;   o += mode != STATES ? qr * dp * 2 : 0;      // C rows
  // B rows (for the scores and B^T, taken once) share their room with the
  // carried state's three bf16 terms (OUTPUT)
  L.bt = L.hp = o;
  const size_t bt = qr * dp * 2, hp = mode == OUTPUT ? 3 * pr * dp * 2 : 0;
  o += bt > hp ? bt : hp;
  L.g = o;    o += mode != STATES ? qr * (qr + 4) * 4 : 0;  // the scores C B^T
  L.xt = o;   o += mode != STATES ? pr * qp * 2 : 0;      // x transposed
  L.xw = o;   o += mode != OUTPUT ? 3 * pr * qp * 2 : 0;  // (x w)^T, three terms
  L.bT = o;   o += mode != OUTPUT ? ds16 * qp * 2 : 0;    // B transposed
  L.hf = o;   o += mode == OUTPUT ? pr * ds16 * 4 : 0;    // the next carried state, float32
  L.total = o;
  return L;
}

// The bf16 kernel: every product on the tensor cores (mma.sync m16n8k16,
// float32 accumulators). The scores C B^T come from exact bf16 operands;
// the products with a float32 operand (the decayed scores times x, C times
// the carried state, (x w)^T times B) split it into three bf16 terms, each
// against the exact bf16 other operand.
template <int RT, int PT, int MODE>
__global__ void __launch_bounds__(THREADS)
ssd_tc_kernel(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
              const float* __restrict__ A, const __nv_bfloat16* __restrict__ Bm,
              const __nv_bfloat16* __restrict__ Cm, __nv_bfloat16* __restrict__ y,
              float* __restrict__ state, float* __restrict__ work, float* __restrict__ totals,
              int H, int S, int hd, int ds, int Q, int group, Strides st) {
  using bf16 = __nv_bfloat16;
  constexpr int QR = 16 * RT, PR = 16 * PT, QP = QR + 8, GS = QR + 4;
  constexpr int MB = RT;                                    // 16-row blocks of the chunk
  constexpr int TPW = (MB * (MB + 1) + WARPS - 1) / WARPS;  // score tiles of a warp
  constexpr int NG = WARPS / MB;                            // warps sharing a row block of y
  constexpr int NJM = (PR / 8 + NG - 1) / NG;               // y's n-tiles of a warp
  constexpr bool SCORES = MODE != STATES;
  extern __shared__ __align__(16) unsigned char smem[];
  const TcLayout Ly = tc_layout(MODE, RT, PT, ds);
  float* dts = reinterpret_cast<float*>(smem + Ly.dts);
  float* cum = reinterpret_cast<float*>(smem + Ly.cum);
  bf16* ct = reinterpret_cast<bf16*>(smem + Ly.ct);
  bf16* bt = reinterpret_cast<bf16*>(smem + Ly.bt);
  bf16* hpb = reinterpret_cast<bf16*>(smem + Ly.hp);
  float* gs = reinterpret_cast<float*>(smem + Ly.g);
  bf16* xt = reinterpret_cast<bf16*>(smem + Ly.xt);
  bf16* xwt = reinterpret_cast<bf16*>(smem + Ly.xw);
  bf16* bT = reinterpret_cast<bf16*>(smem + Ly.bT);
  const int DS16 = cdiv(ds, 16) * 16, DP = DS16 + 8;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, gc = (lane & 3) * 2;  // a fragment's row and column
  const int nslice = cdiv(hd, PR);
  const int hg = blockIdx.x / nslice, p0 = (blockIdx.x - hg * nslice) * PR;
  const int c = blockIdx.y, b = blockIdx.z, nch = gridDim.y;
  const int h0 = hg * group, nh = min(group, H - h0);
  const int np = min(PR, hd - p0);
  const int r0 = c * Q, qc = min(Q, S - r0);

  // x of head hh, this thread's share, in registers: element tid + THREADS u
  constexpr int XPT = (QR * PR + THREADS - 1) / THREADS;
  bf16 xr[XPT];
  auto fetch_x = [&](int hh) {
    const bf16* xp = x + b * st.x[0] + (long long)(h0 + hh) * st.x[1] + (long long)r0 * st.x[2] + p0;
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const int i = tid + THREADS * u, q = i / PR, pp = i - q * PR;
      xr[u] = (i < QR * PR && q < qc && pp < np) ? xp[(long long)q * st.x[2] + pp]
                                                 : __float2bfloat16_rn(0.f);
    }
  };
  // the state entering this chunk of head hh (pass 2 left it in the
  // workspace), into hf: async copies that run while a head computes
  const bool carried = MODE == OUTPUT && c > 0;
  float* hf = reinterpret_cast<float*>(smem + Ly.hf);
  auto fetch_h = [&](int hh) {
    const float* wp = work + (((long long)b * nch + c) * H + h0 + hh) * hd * ds + (long long)p0 * ds;
    if (st.vec & VEC_WORK) {
      const int k4 = ds / 4;
      for (int i = tid; i < np * k4; i += THREADS) {
        const int pp = i / k4, n = 4 * (i - pp * k4);
        cp_async16(hf + pp * DS16 + n, wp + (long long)pp * ds + n);
      }
    } else {
      for (int i = tid; i < np * ds; i += THREADS) {
        const int pp = i / ds, n = i - pp * ds;
        hf[pp * DS16 + n] = wp[i];
      }
    }
  };
  // the first head's x and carried state are in flight while B and C are staged
  fetch_x(0);
  if (carried) fetch_h(0);

  // ---- stage the chunk's B and C rows (16-byte async copies where the
  // rows allow them), zero past qc and ds, and the heads' dt; then B^T
  {
    const bf16* bp = Bm + b * st.b[0] + (long long)r0 * st.b[1];
    const bf16* cp = Cm + b * st.c[0] + (long long)r0 * st.c[1];
    const bf16 zero = __float2bfloat16_rn(0.f);
    if (st.vec & VEC_BC) {
      const int k8 = ds / 8;  // 16-byte pieces of a row
      for (int i = tid; i < QR * k8; i += THREADS) {
        const int s = i / k8, k = 8 * (i - s * k8);
        if (s < qc) {
          cp_async16(bt + s * DP + k, bp + (long long)s * st.b[1] + k);
          if (SCORES) cp_async16(ct + s * DP + k, cp + (long long)s * st.c[1] + k);
        } else {
          *reinterpret_cast<uint4*>(bt + s * DP + k) = make_uint4(0, 0, 0, 0);
          if (SCORES) *reinterpret_cast<uint4*>(ct + s * DP + k) = make_uint4(0, 0, 0, 0);
        }
      }
      for (int i = tid; i < QR * (DP - ds); i += THREADS) {  // the padding columns
        const int s = i / (DP - ds), k = ds + i - s * (DP - ds);
        bt[s * DP + k] = zero;
        if (SCORES) ct[s * DP + k] = zero;
      }
    } else {
      for (int i = tid; i < QR * DP; i += THREADS) {
        const int s = i / DP, k = i - s * DP;
        const bool in = s < qc && k < ds;
        bt[i] = in ? bp[(long long)s * st.b[1] + k] : zero;
        if (SCORES) ct[i] = in ? cp[(long long)s * st.c[1] + k] : zero;
      }
    }
    for (int i = tid; i < MAX_GROUP * QR; i += THREADS) {
      const int hh = i / QR, q = i - hh * QR;
      dts[i] = (hh < nh && q < qc)
                   ? dt[b * st.dt[0] + (long long)(h0 + hh) * st.dt[1] + (long long)(r0 + q) * st.dt[2]]
                   : 0.f;
    }
    cp_async_wait_all();
  }
  __syncthreads();
  if (MODE != OUTPUT)  // B transposed, from its staged rows
    for (int i = tid; i < DS16 * QR; i += THREADS) {
      const int n = i / QR, s = i - n * QR;
      bT[n * QP + s] = bt[s * DP + n];
    }
  // ---- cum: warp hh sums head hh's dt * A in float64, 32 rows a step
  if (warp < nh) {
    const float a = A[h0 + warp];
    double carry = 0.0;
    for (int base = 0; base < QR; base += 32) {
      const int q = base + lane;
      double v = (double)(dts[warp * QR + q] * a);
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const double u = __shfl_up_sync(FULL, v, o);
        if (lane >= o) v += u;
      }
      v += carry;
      cum[warp * QR + q] = __double2float_rn(v);
      carry = __shfl_sync(FULL, v, 31);
    }
  }
  // ---- the scores C B^T, once for every head: the 16 x 8 tiles on or below
  // the diagonal, round robin over the warps, into shared memory
  if (SCORES) {
#pragma unroll
    for (int i = 0; i < TPW; ++i) {
      const int t = warp + WARPS * i;
      if (t >= MB * (MB + 1)) continue;
      int mb, nt;
      tile_of(t, mb, nt);
      float d[4] = {0.f, 0.f, 0.f, 0.f};
      const bf16* crow = ct + (size_t)(16 * mb + gr) * DP + gc;
      const bf16* brow = bt + (size_t)(8 * nt + gr) * DP + gc;
      for (int k0 = 0; k0 < DS16; k0 += 16)
        mma_bf16(d, ld32(crow + k0), ld32(crow + 8 * DP + k0), ld32(crow + k0 + 8),
                 ld32(crow + 8 * DP + k0 + 8), ld32(brow + k0), ld32(brow + k0 + 8));
      float* g0 = gs + (size_t)(16 * mb + gr) * GS + 8 * nt + gc;
      g0[0] = d[0];
      g0[1] = d[1];
      g0[8 * GS] = d[2];
      g0[8 * GS + 1] = d[3];
    }
  }


  for (int hh = 0; hh < nh; ++hh) {
    const int h = h0 + hh;
    const float* cu = cum + hh * QR;
    const float* dh = dts + hh * QR;
    cp_async_wait_all();
    __syncthreads();  // the scores, cum and the carried state are in; the previous head is done
    const float total = cu[qc - 1];
#pragma unroll
    for (int u = 0; u < XPT; ++u) {
      const int i = tid + THREADS * u, q = i / PR, pp = i - q * PR;
      if (i >= QR * PR) continue;
      if (SCORES) xt[pp * QP + q] = xr[u];
      if (MODE != OUTPUT) {  // x * (dt * exp(total - cum)), in three terms
        unsigned short t3[3];
        split3(__bfloat162float(xr[u]) * (dh[q] * expf(total - cu[q])), t3);
#pragma unroll
        for (int t = 0; t < 3; ++t)
          xwt[(size_t)t * PR * QP + pp * QP + q] = __ushort_as_bfloat16(t3[t]);
      }
    }
    if (hh + 1 < nh) fetch_x(hh + 1);  // in flight while this head computes
    if (carried) {  // the state entering this chunk, in three terms
      for (int i = tid; i < PR * DS16; i += THREADS) {
        const int pp = i / DS16, n = i - pp * DS16;
        unsigned short t3[3];
        split3(pp < np && n < ds ? hf[pp * DS16 + n] : 0.f, t3);
#pragma unroll
        for (int t = 0; t < 3; ++t)
          hpb[(size_t)t * PR * DP + pp * DP + n] = __ushort_as_bfloat16(t3[t]);
      }
    }
    __syncthreads();
    if (carried && hh + 1 < nh) fetch_h(hh + 1);  // hf is free: the next head's, in flight

    if (SCORES) {  // y: row block mb, this warp's n-tiles of the slice
      const int mb = warp % MB, grp = warp / MB;
      const int q0 = 16 * mb + gr, q1 = q0 + 8;
      const float cq0 = cu[q0], cq1 = cu[q1];
      float acc[NJM][4], acc2[NJM][4];
#pragma unroll
      for (int i = 0; i < NJM; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][e] = acc2[i][e] = 0.f;
      for (int kk = 0; kk <= mb; ++kk) {
        // the decayed, masked scores of this k-step as A fragments
        const int s0 = 16 * kk + gc;
        float v[8];
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int q = (e & 2) ? q1 : q0, s = s0 + (e & 1) + ((e & 4) ? 8 : 0);
          const float cq = (e & 2) ? cq1 : cq0;
          v[e] = s <= q ? gs[(size_t)q * GS + s] * expf(cq - cu[s]) * dh[s] : 0.f;
        }
        unsigned a0[3], a1[3], a2[3], a3[3];
        split3x2(v[0], v[1], a0);  // row q0, columns s0, s0 + 1
        split3x2(v[2], v[3], a1);  // row q1
        split3x2(v[4], v[5], a2);  // row q0, columns s0 + 8, s0 + 9
        split3x2(v[6], v[7], a3);  // row q1
#pragma unroll
        for (int i = 0; i < NJM; ++i) {
          const int j = grp + NG * i;
          if (j >= PR / 8) continue;
          const bf16* xb = xt + (size_t)(8 * j + gr) * QP + s0;
          const unsigned b0 = ld32(xb), b1 = ld32(xb + 8);
#pragma unroll
          for (int t = 0; t < 3; ++t) mma_bf16(acc[i], a0[t], a1[t], a2[t], a3[t], b0, b1);
        }
      }
      if (carried) {  // C h_prev^T
        const bf16* c0 = ct + (size_t)q0 * DP + gc;
        for (int k0 = 0; k0 < DS16; k0 += 16) {
          const unsigned a0 = ld32(c0 + k0), a1 = ld32(c0 + 8 * DP + k0);
          const unsigned a2 = ld32(c0 + k0 + 8), a3 = ld32(c0 + 8 * DP + k0 + 8);
#pragma unroll
          for (int i = 0; i < NJM; ++i) {
            const int j = grp + NG * i;
            if (j >= PR / 8) continue;
#pragma unroll
            for (int t = 0; t < 3; ++t) {
              const bf16* hb = hpb + (size_t)t * PR * DP + (size_t)(8 * j + gr) * DP + k0 + gc;
              mma_bf16(acc2[i], a0, a1, a2, a3, ld32(hb), ld32(hb + 8));
            }
          }
        }
      }
      bf16* yp = y + b * st.y[0] + (long long)h * st.y[1] + (long long)r0 * st.y[2] + p0;
      const float e0 = carried ? expf(cq0) : 0.f, e1 = carried ? expf(cq1) : 0.f;
#pragma unroll
      for (int i = 0; i < NJM; ++i) {
        const int j = grp + NG * i;
        if (j >= PR / 8) continue;
        const int pp = 8 * j + gc;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int q = e < 2 ? q0 : q1, p = pp + (e & 1);
          if (q < qc && p < np) {
            const float yv = carried ? acc[i][e] + acc2[i][e] * (e < 2 ? e0 : e1) : acc[i][e];
            yp[(long long)q * st.y[2] + p] = __float2bfloat16_rn(yv);
          }
        }
      }
    }

    if (MODE != OUTPUT) {  // the chunk's state from zero: (x w)^T B, p x n tiles
      float* out = MODE == SINGLE
                       ? state + ((long long)b * H + h) * hd * ds + (long long)p0 * ds
                       : work + (((long long)b * nch + c) * H + h) * hd * ds + (long long)p0 * ds;
      const int ntn = DS16 / 8, tiles = (PR / 16) * ntn;
      for (int t = warp; t < tiles; t += WARPS) {
        const int mt = t / ntn, nt = t - mt * ntn;
        float d[4] = {0.f, 0.f, 0.f, 0.f};
        const bf16* bb = bT + (size_t)(8 * nt + gr) * QP + gc;
        for (int k0 = 0; k0 < QR; k0 += 16) {
          const unsigned b0 = ld32(bb + k0), b1 = ld32(bb + k0 + 8);
#pragma unroll
          for (int u = 0; u < 3; ++u) {
            const bf16* aw = xwt + (size_t)u * PR * QP + (size_t)(16 * mt + gr) * QP + k0 + gc;
            mma_bf16(d, ld32(aw), ld32(aw + 8 * QP), ld32(aw + 8), ld32(aw + 8 * QP + 8), b0, b1);
          }
        }
        const int pa = 16 * mt + gr, n = 8 * nt + gc;
#pragma unroll
        for (int r = 0; r < 2; ++r) {  // rows pa and pa + 8: two columns each
          const int pp = pa + 8 * r;
          float* o = out + (long long)pp * ds + n;
          if (pp >= np || n >= ds) continue;
          if (n + 1 < ds && (ds & 1) == 0)
            *reinterpret_cast<float2*>(o) = make_float2(d[2 * r], d[2 * r + 1]);
          else
            o[0] = d[2 * r];
        }
      }
      if (MODE == STATES && tid == 0 && p0 == 0)
        totals[((long long)b * H + h) * nch + c] = total;
    }
  }
}

// pass 2: per (batch, head) and state element, over the chunks in order:
// the workspace's local state of chunk c becomes the state entering it.
// The loads of 8 chunks are issued ahead of their dependent chain.
__global__ void __launch_bounds__(THREADS)
ssd_carry_kernel(float* __restrict__ work, const float* __restrict__ totals,
                 float* __restrict__ state, int H, int nch, int n_el) {
  constexpr int U = 8;
  const int e = blockIdx.x * THREADS + threadIdx.x;
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  if (e >= n_el) return;
  float hs = 0.f;
  for (int c0 = 0; c0 < nch; c0 += U) {
    float local[U], decay[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      local[u] = c < nch ? work[(((long long)b * nch + c) * H + h) * n_el + e] : 0.f;
      decay[u] = c < nch ? expf(totals[(long long)bh * nch + c]) : 1.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int c = c0 + u;
      if (c < nch) {
        work[(((long long)b * nch + c) * H + h) * n_el + e] = hs;
        hs = hs * decay[u] + local[u];
      }
    }
  }
  state[(long long)bh * n_el + e] = hs;
}

struct DeviceInfo {
  int sms = 0, smem_optin = 0;
};

int device_info(DeviceInfo* out) {
  static DeviceInfo cache[MAX_DEVICES];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  DeviceInfo* d = dev < MAX_DEVICES ? &cache[dev] : out;
  if (d->sms == 0) {
    e = cudaDeviceGetAttribute(&d->sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    e = cudaDeviceGetAttribute(&d->smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e != cudaSuccess) return (int)e;
  }
  *out = *d;
  return 0;
}

// the route of a prompt: one launch straight from the chunk when it is one
// chunk of at most 64 rows, else the three chunk-parallel passes
__host__ __device__ inline bool single_chunk(int S, int Q) { return S <= Q && Q <= 64; }

struct Plan {
  int rt, pt, group, ngroups, nslice;
};

// shared memory of a block of either kernel
template <typename T>
size_t block_smem(int mode, int rt, int pt, int ds) {
  return std::is_same<T, float>::value ? smem_bytes(mode, rt, pt, ds)
                                       : tc_layout(mode, rt, pt, ds).total;
}

template <typename T, int RT, int PT, int MODE>
int launch_one(const Plan& pl, const T* x, const float* dt, const float* A, const T* B,
               const T* C, T* y, float* state, float* work, float* totals, int b, int H, int S,
               int hd, int ds, int Q, const Strides& st, int smem_optin, cudaStream_t stream) {
  const size_t smem = block_smem<T>(MODE, RT, PT, ds);
  if (smem > (size_t)smem_optin) return (int)cudaErrorInvalidValue;
  auto kernel = [] {
    if constexpr (std::is_same<T, float>::value)
      return ssd_chunk_kernel<RT, PT, MODE>;
    else
      return ssd_tc_kernel<RT, PT, MODE>;
  }();
  if (smem > 48 * 1024) {
    // the opt-in holds per device: remember it per device
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || !opted_in[dev]) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) opted_in[dev] = true;
    }
  }
  const dim3 grid(pl.ngroups * pl.nslice, MODE == SINGLE ? 1 : cdiv(S, Q), b);
  kernel<<<grid, THREADS, smem, stream>>>(x, dt, A, B, C, y, state, work, totals, H, S, hd, ds,
                                          Q, pl.group, st);
  return (int)cudaGetLastError();
}

template <typename T, int RT, int MODE>
int launch_pt(const Plan& pl, const T* x, const float* dt, const float* A, const T* B,
              const T* C, T* y, float* state, float* work, float* totals, int b, int H, int S,
              int hd, int ds, int Q, const Strides& st, int o, cudaStream_t s) {
  if (pl.pt == 1)
    return launch_one<T, RT, 1, MODE>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  if (pl.pt == 2)
    return launch_one<T, RT, 2, MODE>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  return launch_one<T, RT, 4, MODE>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
}

template <typename T, int MODE>
int launch_rt(const Plan& pl, const T* x, const float* dt, const float* A, const T* B,
              const T* C, T* y, float* state, float* work, float* totals, int b, int H, int S,
              int hd, int ds, int Q, const Strides& st, int o, cudaStream_t s) {
  if (pl.rt == 1)
    return launch_pt<T, 1, MODE>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  if (pl.rt == 2)
    return launch_pt<T, 2, MODE>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  if (pl.rt == 4)
    return launch_pt<T, 4, MODE>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  if constexpr (MODE == SINGLE) {
    return (int)cudaErrorInvalidValue;  // one chunk of at most 64 rows
  } else {
    return launch_pt<T, 8, MODE>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  }
}

template <typename T>
int launch_chunk(int mode, const Plan& pl, const T* x, const float* dt, const float* A,
                 const T* B, const T* C, T* y, float* state, float* work, float* totals, int b,
                 int H, int S, int hd, int ds, int Q, const Strides& st, int o, cudaStream_t s) {
  if (mode == SINGLE)
    return launch_rt<T, SINGLE>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  if (mode == STATES)
    return launch_rt<T, STATES>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  return launch_rt<T, OUTPUT>(pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* B, const T* C, T* y,
           float* state, float* work, float* totals, int b, int H, int S, int hd, int ds, int Q,
           const long long* strides, void* stream) {
  if (b == 0 || H == 0) return 0;
  if (S < 1 || Q < 1 || Q > 128 || hd < 1 || ds < 1) return (int)cudaErrorInvalidValue;
  const bool single = single_chunk(S, Q);
  if (!single && (work == nullptr || totals == nullptr)) return (int)cudaErrorInvalidValue;
  DeviceInfo info;
  const int rc = device_info(&info);
  if (rc != 0) return rc;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.x[i] = strides[i];
    st.dt[i] = strides[3 + i];
    st.y[i] = strides[10 + i];
  }
  for (int i = 0; i < 2; ++i) {
    st.b[i] = strides[6 + i];
    st.c[i] = strides[8 + i];
  }
  // 16-byte pieces: rows of 8 bf16 at 16-byte aligned starts; the
  // workspace's rows of ds floats
  auto aligned = [](const void* p) { return ((unsigned long long)p & 15) == 0; };
  st.vec = 0;
  if (sizeof(T) == 2 && ds % 8 == 0 && aligned(B) && aligned(C) && st.b[0] % 8 == 0 &&
      st.b[1] % 8 == 0 && st.c[0] % 8 == 0 && st.c[1] % 8 == 0)
    st.vec |= VEC_BC;
  if (ds % 4 == 0 && (work == nullptr || aligned(work))) st.vec |= VEC_WORK;
  const int nch = cdiv(S, Q);
  Plan pl;
  pl.rt = Q <= 16 ? 1 : Q <= 32 ? 2 : Q <= 64 ? 4 : 8;
  pl.pt = hd <= 16 ? 1 : hd <= 32 ? 2 : 4;
  // narrower head-dim slices where the widest does not fit a block
  const int mode_big = single ? SINGLE : OUTPUT;
  while (pl.pt > 1 && (block_smem<T>(mode_big, pl.rt, pl.pt, ds) > (size_t)info.smem_optin ||
                       block_smem<T>(STATES, pl.rt, pl.pt, ds) > (size_t)info.smem_optin))
    pl.pt /= 2;
  pl.nslice = cdiv(hd, 16 * pl.pt);
  // heads a block shares its scores with: as many as keep two blocks per SM
  const long long per_head = (long long)b * nch * pl.nslice;
  long long grp = per_head * H / (2LL * info.sms);
  pl.group = (int)(grp < 1 ? 1 : (grp > MAX_GROUP ? MAX_GROUP : grp));
  pl.ngroups = cdiv(H, pl.group);
  const cudaStream_t s = (cudaStream_t)stream;
  const int o = info.smem_optin;
  if (single)
    return launch_chunk<T>(SINGLE, pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  int e = launch_chunk<T>(STATES, pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
  if (e != 0) return e;
  const int n_el = hd * ds;
  ssd_carry_kernel<<<dim3(cdiv(n_el, THREADS), b * H), THREADS, 0, s>>>(work, totals, state, H,
                                                                       nch, n_el);
  e = (int)cudaGetLastError();
  if (e != 0) return e;
  return launch_chunk<T>(OUTPUT, pl, x, dt, A, B, C, y, state, work, totals, b, H, S, hd, ds, Q, st, o, s);
}

}  // namespace

extern "C" {

// The workspace launch() needs: 0 for a single chunk of at most 64 rows,
// else b * nch * H * hd * ds floats of states and b * H * nch of totals.
long long ssd_scan_work_floats(int b, int H, int S, int hd, int ds, int Q) {
  if (single_chunk(S, Q)) return 0;
  const long long nch = cdiv(S, Q);
  return (long long)b * nch * H * hd * ds + (long long)b * H * nch;
}

// strides: 13 element strides: x (batch, head, seq), dt (batch, head, seq),
// B (batch, seq), C (batch, seq), y (batch, head, seq). work: the workspace
// (ssd_scan_work_floats), NULL when it is 0.
int ssd_scan_f32(const float* x, const float* dt, const float* A, const float* B,
                 const float* C, float* y, float* state, float* work, int b, int H, int S,
                 int hd, int ds, int Q, const long long* strides, void* stream) {
  const long long states = work ? (long long)b * cdiv(S, Q) * H * hd * ds : 0;
  return launch<float>(x, dt, A, B, C, y, state, work, work ? work + states : nullptr, b, H, S,
                       hd, ds, Q, strides, stream);
}

int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt, const float* A,
                  const __nv_bfloat16* B, const __nv_bfloat16* C, __nv_bfloat16* y,
                  float* state, float* work, int b, int H, int S, int hd, int ds, int Q,
                  const long long* strides, void* stream) {
  const long long states = work ? (long long)b * cdiv(S, Q) * H * hd * ds : 0;
  return launch<__nv_bfloat16>(x, dt, A, B, C, y, state, work,
                               work ? work + states : nullptr, b, H, S, hd, ds, Q, strides,
                               stream);
}

}  // extern "C"
