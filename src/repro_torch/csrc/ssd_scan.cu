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
// Layout: one block of 16 x 16 threads per (head-dim slice, head, batch); the
// rows of h and the columns of y split over head_dim independently, so a
// launch with few heads takes several slices of head_dim (16, 32 or 64 wide)
// per head to fill the SMs. The block walks the chunks in order and keeps its
// rows of h in shared memory in float32. Per chunk it stages dt, cum and its
// x columns, then walks the state axis in tiles of 32 columns of B and C:
// each thread accumulates an (RT x RT) register tile of the scores C B^T and
// an (RT x PT) tile of C h^T, then the tile's columns of h are updated. The
// scores are then masked, decayed and scaled into shared memory and
// multiplied with x. Shared tiles are padded against bank conflicts. The
// scores depend on neither the head nor the slice and are recomputed by every
// block.
//
// What bounds it on the H100: at the serving prefill (S = 32, one chunk) the
// launch; at long prompts the float32 FMAs on CUDA cores (the score tile is
// recomputed per head and slice, and half of it lies above the diagonal).
// Tensor cores (wgmma on bf16 tiles of B and C, TMA staging) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16
constexpr int NT = 32;        // state columns per staged tile of B and C
constexpr int TS = NT + 1;    // row stride of the B and C tiles
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct Strides {
  long long x[3], dt[3], b[2], c[2], y[3];  // (batch, head, seq) / (batch, seq)
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

__host__ __device__ __forceinline__ int cdiv(int a, int b) { return (a + b - 1) / b; }

// floats of shared memory for a (16 RT)-row chunk tile, (16 PT) head-dim
// columns and ds state columns
__host__ __device__ __forceinline__ size_t smem_floats(int rt, int pt, int ds) {
  const size_t qr = 16 * rt, pr = 16 * pt, hs = (size_t)cdiv(ds, NT) * NT + 1;
  return 2 * qr * TS + qr * (qr + 1) + 2 * qr * pr + pr * hs + 3 * qr;
}

template <typename T, int RT, int PT>
__global__ void __launch_bounds__(THREADS)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
           const T* __restrict__ Bm, const T* __restrict__ Cm, T* __restrict__ y,
           float* __restrict__ state, int H, int S, int hd, int ds, int Q, Strides st) {
  constexpr int QR = 16 * RT, PR = 16 * PT, SS = QR + 1;
  extern __shared__ float smem[];
  const int HS = cdiv(ds, NT) * NT + 1;  // row stride of h
  float* bt = smem;             // QR x TS   B rows of the chunk, one state tile
  float* ct = bt + QR * TS;     // QR x TS   C rows
  float* sc = ct + QR * TS;     // QR x SS   masked, decayed, scaled scores
  float* xs = sc + QR * SS;     // QR x PR   x columns of this slice
  float* xw = xs + QR * PR;     // QR x PR   x * dt * exp(total - cum)
  float* hs = xw + QR * PR;     // PR x HS   the carried state rows
  float* dts = hs + PR * HS;    // QR
  float* cum = dts + QR;        // QR
  float* ecum = cum + QR;       // QR        exp(cum)

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int p0 = blockIdx.x * PR, h = blockIdx.y, b = blockIdx.z;
  const int np = min(PR, hd - p0);
  const float a = A[h];
  const T* xp = x + b * st.x[0] + h * st.x[1] + p0;
  const float* dtp = dt + b * st.dt[0] + h * st.dt[1];
  const T* bp = Bm + b * st.b[0];
  const T* cp = Cm + b * st.c[0];
  T* yp = y + b * st.y[0] + h * st.y[1] + p0;

  for (int i = tid; i < PR * HS; i += THREADS) hs[i] = 0.f;

  const int nc = cdiv(S, Q);
  for (int c = 0; c < nc; ++c) {
    const int r0 = c * Q, qc = min(Q, S - r0);
    __syncthreads();  // the previous chunk is consumed
    for (int q = tid; q < QR; q += THREADS)
      dts[q] = q < qc ? dtp[(long long)(r0 + q) * st.dt[2]] : 0.f;
    for (int i = tid; i < QR * PR; i += THREADS) {
      const int q = i / PR, p = i - q * PR;
      xs[i] = (q < qc && p < np) ? load_f(xp + (long long)(r0 + q) * st.x[2] + p) : 0.f;
    }
    __syncthreads();
    if (warp == 0) {  // inclusive cumsum of dt * A: a warp scan, 32 rows a step
      double carry = 0.0;
      for (int base = 0; base < QR; base += 32) {
        const int q = base + lane;
        double v = q < QR ? (double)(dts[q] * a) : 0.0;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const double u = __shfl_up_sync(FULL, v, o);
          if (lane >= o) v += u;
        }
        v += carry;
        if (q < QR) cum[q] = __double2float_rn(v);
        carry = __shfl_sync(FULL, v, 31);
      }
    }
    __syncthreads();
    const float total = cum[qc - 1];
    const float e_total = expf(total);
    for (int q = tid; q < QR; q += THREADS) ecum[q] = expf(cum[q]);
    for (int i = tid; i < QR * PR; i += THREADS) {
      const int q = i / PR;
      xw[i] = xs[i] * (dts[q] * expf(total - cum[q]));
    }

    float acc[RT][RT], yi[RT][PT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < RT; ++j) acc[i][j] = 0.f;
#pragma unroll
      for (int j = 0; j < PT; ++j) yi[i][j] = 0.f;
    }

    for (int n0 = 0; n0 < ds; n0 += NT) {
      __syncthreads();  // xw is staged; the previous tile is consumed
      for (int i = tid; i < QR * NT; i += THREADS) {
        const int s = i / NT, k = i - s * NT;
        const bool in = s < qc && n0 + k < ds;
        bt[s * TS + k] = in ? load_f(bp + (long long)(r0 + s) * st.b[1] + n0 + k) : 0.f;
        ct[s * TS + k] = in ? load_f(cp + (long long)(r0 + s) * st.c[1] + n0 + k) : 0.f;
      }
      __syncthreads();
      // scores C B^T (rows ty + 16 i, columns tx + 16 j) and C h^T (rows
      // ty + 16 i, head-dim columns tx + 16 j) over this tile's columns
#pragma unroll 4
      for (int k = 0; k < NT; ++k) {
        float cv[RT], bv[RT], hv[PT];
#pragma unroll
        for (int i = 0; i < RT; ++i) cv[i] = ct[(ty + 16 * i) * TS + k];
#pragma unroll
        for (int j = 0; j < RT; ++j) bv[j] = bt[(tx + 16 * j) * TS + k];
#pragma unroll
        for (int j = 0; j < PT; ++j) hv[j] = hs[(tx + 16 * j) * HS + n0 + k];
#pragma unroll
        for (int i = 0; i < RT; ++i) {
#pragma unroll
          for (int j = 0; j < RT; ++j) acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
#pragma unroll
          for (int j = 0; j < PT; ++j) yi[i][j] = fmaf(cv[i], hv[j], yi[i][j]);
        }
      }
      __syncthreads();  // every read of this tile's columns of h is done
      // h[:, tile] = exp(total) h[:, tile] + xw^T B[:, tile]; a warp takes one
      // row of h, a lane one column
      for (int i = tid; i < PR * NT; i += THREADS) {
        const int p = i / NT, k = i - p * NT;
        float dot = 0.f;
        for (int s = 0; s < QR; ++s) dot = fmaf(xw[s * PR + p], bt[s * TS + k], dot);
        float* hp = hs + p * HS + n0 + k;
        *hp = *hp * e_total + dot;
      }
    }

#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int q = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < RT; ++j) {
        const int s = tx + 16 * j;
        sc[q * SS + s] = s <= q ? acc[i][j] * expf(cum[q] - cum[s]) * dts[s] : 0.f;
      }
    }
    __syncthreads();
    float yo[RT][PT];
#pragma unroll
    for (int i = 0; i < RT; ++i) {
#pragma unroll
      for (int j = 0; j < PT; ++j) yo[i][j] = 0.f;
    }
    for (int s = 0; s < QR; ++s) {
      float sv[RT], xv[PT];
#pragma unroll
      for (int i = 0; i < RT; ++i) sv[i] = sc[(ty + 16 * i) * SS + s];
#pragma unroll
      for (int j = 0; j < PT; ++j) xv[j] = xs[s * PR + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RT; ++i) {
#pragma unroll
        for (int j = 0; j < PT; ++j) yo[i][j] = fmaf(sv[i], xv[j], yo[i][j]);
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const int q = ty + 16 * i;
      if (q >= qc) continue;
#pragma unroll
      for (int j = 0; j < PT; ++j) {
        const int p = tx + 16 * j;
        if (p < np) store_f(yp + (long long)(r0 + q) * st.y[2] + p, yo[i][j] + yi[i][j] * ecum[q]);
      }
    }
  }

  __syncthreads();
  float* sp = state + ((long long)b * H + h) * hd * ds + (long long)p0 * ds;
  for (int i = tid; i < np * ds; i += THREADS) {
    const int p = i / ds, n = i - p * ds;
    sp[i] = hs[p * HS + n];
  }
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

template <typename T, int RT, int PT>
int launch_tile(const T* x, const float* dt, const float* A, const T* B, const T* C, T* y,
                float* state, int b, int H, int S, int hd, int ds, int Q, const Strides& st,
                int smem_optin, cudaStream_t stream) {
  const size_t smem = sizeof(float) * smem_floats(RT, PT, ds);
  if (smem > 48 * 1024) {
    // the opt-in holds per device: remember it per device
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || !opted_in[dev]) {
      e = cudaFuncSetAttribute(ssd_kernel<T, RT, PT>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem_optin);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) opted_in[dev] = true;
    }
  }
  const dim3 grid(cdiv(hd, 16 * PT), H, b);
  ssd_kernel<T, RT, PT><<<grid, THREADS, smem, stream>>>(x, dt, A, B, C, y, state, H, S, hd,
                                                         ds, Q, st);
  return (int)cudaGetLastError();
}

template <typename T, int RT>
int launch_rt(int pt, const T* x, const float* dt, const float* A, const T* B, const T* C,
              T* y, float* state, int b, int H, int S, int hd, int ds, int Q, const Strides& st,
              int smem_optin, cudaStream_t s) {
  if (pt == 1) return launch_tile<T, RT, 1>(x, dt, A, B, C, y, state, b, H, S, hd, ds, Q, st, smem_optin, s);
  if (pt == 2) return launch_tile<T, RT, 2>(x, dt, A, B, C, y, state, b, H, S, hd, ds, Q, st, smem_optin, s);
  return launch_tile<T, RT, 4>(x, dt, A, B, C, y, state, b, H, S, hd, ds, Q, st, smem_optin, s);
}

template <typename T>
int launch(const T* x, const float* dt, const float* A, const T* B, const T* C, T* y,
           float* state, int b, int H, int S, int hd, int ds, int Q, const long long* strides,
           void* stream) {
  if (b == 0 || H == 0) return 0;
  if (S < 1 || Q < 1 || Q > 128 || hd < 1 || ds < 1) return (int)cudaErrorInvalidValue;
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
  const int rt = Q <= 16 ? 1 : Q <= 32 ? 2 : Q <= 64 ? 4 : 8;
  // the widest head-dim slice that still gives every SM a block and fits
  int pt = hd <= 16 ? 1 : hd <= 32 ? 2 : 4;
  while (pt > 1 && ((long long)b * H * cdiv(hd, 16 * pt) < info.sms ||
                    sizeof(float) * smem_floats(rt, pt, ds) > (size_t)info.smem_optin))
    pt /= 2;
  if (sizeof(float) * smem_floats(rt, pt, ds) > (size_t)info.smem_optin)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int o = info.smem_optin;
  if (rt == 1) return launch_rt<T, 1>(pt, x, dt, A, B, C, y, state, b, H, S, hd, ds, Q, st, o, s);
  if (rt == 2) return launch_rt<T, 2>(pt, x, dt, A, B, C, y, state, b, H, S, hd, ds, Q, st, o, s);
  if (rt == 4) return launch_rt<T, 4>(pt, x, dt, A, B, C, y, state, b, H, S, hd, ds, Q, st, o, s);
  return launch_rt<T, 8>(pt, x, dt, A, B, C, y, state, b, H, S, hd, ds, Q, st, o, s);
}

}  // namespace

extern "C" {

// strides: 13 element strides: x (batch, head, seq), dt (batch, head, seq),
// B (batch, seq), C (batch, seq), y (batch, head, seq)
int ssd_scan_f32(const float* x, const float* dt, const float* A, const float* B,
                 const float* C, float* y, float* state, int b, int H, int S, int hd, int ds,
                 int Q, const long long* strides, void* stream) {
  return launch<float>(x, dt, A, B, C, y, state, b, H, S, hd, ds, Q, strides, stream);
}

int ssd_scan_bf16(const __nv_bfloat16* x, const float* dt, const float* A,
                  const __nv_bfloat16* B, const __nv_bfloat16* C, __nv_bfloat16* y,
                  float* state, int b, int H, int S, int hd, int ds, int Q,
                  const long long* strides, void* stream) {
  return launch<__nv_bfloat16>(x, dt, A, B, C, y, state, b, H, S, hd, ds, Q, strides, stream);
}

}  // extern "C"
