// Flash attention, causal or local-window, GQA: out = softmax(q k^T * scale) v.
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention_bhsd
// (_fa_kernel), the Pallas TPU kernel behind modeling/attention.py's prefill
// path. q: (B, H, Sq, D), k/v: (B, Hkv, Skv, D), any strides with a
// contiguous last dimension; query head h reads K/V head h / (H / Hkv). The
// output is written in q's dtype through its own strides, so the model's
// (B, S, H, D) tensors are read and written in place of a transpose.
//
// Numerics follow the TPU kernel: q, k and v are widened to float32, the
// online softmax state (m, l, acc) is float32, masked scores are
// NEG_INF = -2e38 and the row is divided by max(l, 1e-30) at the end. Key
// (q, k) pairs that are masked contribute exactly 0 (the TPU kernel's
// exp(NEG_INF - m) = 0 once the row has a live score); a row with no live key
// at all gives 0.
//
// Layout: one block of 4 warps per (b, h, 32-row query block); each warp owns
// 8 query rows. K and V tiles of 32 keys are staged in shared memory as
// float32 (K rows padded to D + 1 floats, so lane j reading key j's row walks
// 32 distinct banks). For each of its rows a warp computes 32 scores, one per
// lane, reduces max and sum across the warp with shuffles, and accumulates
// P V with lane j owning output dims j, j + 32, ... (D <= 256). As in the TPU
// kernel's pl.when(live), key tiles that no row of the block can see
// (beyond the causal diagonal or before the window) are never loaded, and a
// row skips a tile that holds none of its live keys.
//
// What bounds it on the H100: at the serving shape (Sq = 32, D = 64) launch
// latency; at long prefill the shared-memory reads of the scalar dot
// products. The tensor cores (mma.sync / wgmma on bf16 tiles) are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int ROWS = 8;              // query rows per warp
constexpr int BQ = WARPS * ROWS;     // query rows per block
constexpr int BK = 32;               // keys per tile: one per lane
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct Strides {
  long long q[3], k[3], v[3], o[3];  // (batch, head, seq) element strides
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) { return __bfloat162float(*p); }
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

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

template <typename T, int DPL>
__global__ void __launch_bounds__(THREADS)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int H, int Hkv, int Sq, int Skv, int D, Strides st,
          int causal, int window, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qs = smem;              // BQ x D
  float* ks = qs + BQ * D;       // BK x (D + 1)
  float* vs = ks + BK * DP;      // BK x D

  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const T* qp = q + b * st.q[0] + h * st.q[1];
  const T* kp = k + b * st.k[0] + hk * st.k[1];
  const T* vp = v + b * st.v[0] + hk * st.v[1];

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int qpos = q0 + r;
    qs[i] = qpos < Sq ? load_f(qp + qpos * st.q[2] + d) : 0.f;
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
        ks[r * DP + d] = in ? load_f(kp + kpos * st.k[2] + d) : 0.f;
        vs[i] = in ? load_f(vp + kpos * st.v[2] + d) : 0.f;
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

  T* op = o + b * st.o[0] + h * st.o[1];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int qpos = q0 + warp * ROWS + r;
    if (qpos >= Sq) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) store_f(op + qpos * st.o[2] + d, acc[r][i] / denom);
    }
  }
}

template <typename T, int DPL>
int launch_dpl(const T* q, const T* k, const T* v, T* o, int B, int H, int Hkv, int Sq,
               int Skv, int D, const Strides& st, int causal, int window, float scale,
               cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)BQ * D + (size_t)BK * (D + 1) + (size_t)BK * D);
  if (smem > 48 * 1024) {
    // the opt-in holds per device: remember it per device
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || !opted_in[dev]) {
      e = cudaFuncSetAttribute(fa_kernel<T, DPL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) opted_in[dev] = true;
    }
  }
  const dim3 grid((Sq + BQ - 1) / BQ, H, B);
  fa_kernel<T, DPL><<<grid, THREADS, smem, stream>>>(q, k, v, o, H, Hkv, Sq, Skv, D, st,
                                                     causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const T* q, const T* k, const T* v, T* o, int B, int H, int Hkv, int Sq,
           int Skv, int D, const long long* strides, int causal, int window, float scale,
           void* stream) {
  if (B == 0 || H == 0 || Sq == 0) return 0;
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0) return (int)cudaErrorInvalidValue;
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  const int dpl = (D + 31) / 32;
  if (dpl <= 1) return launch_dpl<T, 1>(q, k, v, o, B, H, Hkv, Sq, Skv, D, st, causal, window, scale, s);
  if (dpl <= 2) return launch_dpl<T, 2>(q, k, v, o, B, H, Hkv, Sq, Skv, D, st, causal, window, scale, s);
  if (dpl <= 4) return launch_dpl<T, 4>(q, k, v, o, B, H, Hkv, Sq, Skv, D, st, causal, window, scale, s);
  return launch_dpl<T, 8>(q, k, v, o, B, H, Hkv, Sq, Skv, D, st, causal, window, scale, s);
}

}  // namespace

extern "C" {

// strides: 12 element strides, (batch, head, seq) of q, k, v and o in turn
int flash_attention_f32(const float* q, const float* k, const float* v, float* o, int B,
                        int H, int Hkv, int Sq, int Skv, int D, const long long* strides,
                        int causal, int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, B, H, Hkv, Sq, Skv, D, strides, causal, window, scale,
                       stream);
}

int flash_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                         const __nv_bfloat16* v, __nv_bfloat16* o, int B, int H, int Hkv,
                         int Sq, int Skv, int D, const long long* strides, int causal,
                         int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, B, H, Hkv, Sq, Skv, D, strides, causal, window,
                               scale, stream);
}

}  // extern "C"
