// Flash decode: one query token per (batch, head) against a length-masked KV
// cache, GQA. out[b, h] = softmax(q k^T * scale) v over the cache slots
// s < lengths[b] of K/V head h / (H / Hkv).
//
// Replaces src/repro/kernels/decode_attention/kernel.py::decode_attention_bhd
// (_dec_kernel), the Pallas TPU kernel behind modeling/attention.py's decode
// path. q: (B, H, 1, D) and out: (B, H, 1, D) with (batch, head) strides;
// k/v: (B, Hkv, S, D) with (batch, head, slot) strides, contiguous last dim
// (the model passes (B, S, Hkv, D) cache slices transposed, not copied).
// lengths: (B,) int32 on the card. A length above S makes every slot valid
// (the serving executor decodes past its cache and the reference's clamped
// write leaves every slot live); a length of 0 gives 0, as the TPU kernel
// does.
//
// Numerics follow the TPU kernel: float32 scores and online softmax,
// NEG_INF = -2e38, division by max(l, 1e-30).
//
// Layout, split-K: the TPU kernel walks the KV axis sequentially in one grid
// step per block; here the slot axis is cut into chunks of 256 slots, one
// block per (chunk, KV head, up to 16 query heads of its group, batch), so a
// long cache fills the card. A block stages each 32-slot K/V tile in shared
// memory once for all the query heads of its group that it serves (one warp
// per head, or 2 or 4 heads per warp for wide groups) and writes its partial
// (m, l, acc) to a float32 workspace. Blocks whose chunk starts at or past
// lengths[b] load nothing and write an empty partial. A second kernel
// combines the partials of each (b, h): M = max m_i, L = sum l_i e^(m_i - M),
// out = sum acc_i e^(m_i - M) / max(L, 1e-30). A cache of at most one chunk
// (the serving shape) has nothing to combine: its one block per head writes
// acc / max(l, 1e-30) to the output itself, with no workspace and no second
// launch (the same floats the combine would give).
//
// What bounds it on the H100: at the serving shape (S = 32) launch latency;
// at long caches the bytes of K and V, read once for each group of heads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 32;      // slots per tile: one per lane
constexpr int CHUNK = 256;  // slots per block
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct Strides {
  long long q[2], k[3], v[3], o[2];
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

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(FULL, x, o);
  return x;
}

// workspace per (b, h, split): [m, l, acc[0..D)]; with nsplit == 1 (ws is
// null) the block writes the normalised output to o instead
template <typename T, int R, int DPL>
__global__ void __launch_bounds__(THREADS)
dec_partial(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
            const int* __restrict__ lengths, float* __restrict__ ws, T* __restrict__ o,
            int H, int Hkv, int S, int D, int hgroups, int nsplit, Strides st, float scale) {
  extern __shared__ float smem[];
  const int DP = D + 1;
  float* qs = smem;                 // (WARPS * R) x D
  float* ks = qs + WARPS * R * D;   // BK x (D + 1)
  float* vs = ks + BK * DP;         // BK x D

  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / hgroups, hg = blockIdx.y - hk * hgroups;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int len = min(lengths[b], S);
  const int c0 = split * CHUNK, c1 = min(c0 + CHUNK, len);
  const T* kp = k + b * st.k[0] + hk * st.k[1];
  const T* vp = v + b * st.v[0] + hk * st.v[1];

  // query head of (warp, r): g = hg * WARPS * R + warp * R + r of group hk
  for (int i = tid; i < WARPS * R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int g = hg * WARPS * R + r;
    qs[i] = g < G ? load_f(q + b * st.q[0] + (hk * G + g) * st.q[1] + d) : 0.f;
  }

  float m[R], l[R], acc[R][DPL];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int k0 = c0; k0 < c1; k0 += BK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      const int s = k0 + r;
      const bool in = s < c1;
      ks[r * DP + d] = in ? load_f(kp + s * st.k[2] + d) : 0.f;
      vs[i] = in ? load_f(vp + s * st.v[2] + d) : 0.f;
    }
    __syncthreads();
    const bool valid = k0 + lane < c1;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = warp * R + r;
      if (hg * WARPS * R + row >= G) continue;  // warp-uniform
      const float* qr = qs + row * D;
      const float* kr = ks + lane * DP;
      float s = 0.f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(qr[d], kr[d], s);
      s = valid ? s * scale : NEG_INF;
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

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int g = hg * WARPS * R + warp * R + r;
    if (g >= G) continue;
    if (nsplit == 1) {  // block-uniform: nothing to combine
      const float denom = fmaxf(l[r], 1e-30f);
      T* op = o + b * st.o[0] + (hk * G + g) * st.o[1];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) store_f(op + d, acc[r][i] / denom);
      }
      continue;
    }
    float* w = ws + (((size_t)b * H + hk * G + g) * nsplit + split) * (D + 2);
    if (lane == 0) {
      w[0] = m[r];
      w[1] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) w[2 + d] = acc[r][i];
    }
  }
}

template <typename T>
__global__ void dec_combine(const float* __restrict__ ws, T* __restrict__ o, int H, int D,
                            int nsplit, Strides st) {
  const int h = blockIdx.x, b = blockIdx.y;
  const float* w = ws + ((size_t)b * H + h) * nsplit * (D + 2);
  float M = NEG_INF;
  for (int i = 0; i < nsplit; ++i) M = fmaxf(M, w[i * (D + 2)]);
  float L = 0.f;
  for (int i = 0; i < nsplit; ++i) L += w[i * (D + 2) + 1] * expf(w[i * (D + 2)] - M);
  const float denom = fmaxf(L, 1e-30f);
  T* op = o + b * st.o[0] + h * st.o[1];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < nsplit; ++i)
      a += w[i * (D + 2) + 2 + d] * expf(w[i * (D + 2)] - M);
    store_f(op + d, a / denom);
  }
}

template <typename T, int R, int DPL>
int launch_partial(const T* q, const T* k, const T* v, const int* lengths, float* ws, T* o,
                   int B, int H, int Hkv, int S, int D, int nsplit, const Strides& st,
                   float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)WARPS * R * D + (size_t)BK * (D + 1) + (size_t)BK * D);
  if (smem > 48 * 1024) {
    // the opt-in holds per device: remember it per device
    static bool opted_in[MAX_DEVICES] = {};
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev >= MAX_DEVICES || !opted_in[dev]) {
      e = cudaFuncSetAttribute(dec_partial<T, R, DPL>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return (int)e;
      if (dev < MAX_DEVICES) opted_in[dev] = true;
    }
  }
  const int G = H / Hkv;
  const int hgroups = (G + WARPS * R - 1) / (WARPS * R);
  const dim3 grid(nsplit, Hkv * hgroups, B);
  dec_partial<T, R, DPL><<<grid, THREADS, smem, stream>>>(q, k, v, lengths, ws, o, H, Hkv, S,
                                                           D, hgroups, nsplit, st, scale);
  return (int)cudaGetLastError();
}

template <typename T, int R>
int launch_r(const T* q, const T* k, const T* v, const int* lengths, float* ws, T* o, int B,
             int H, int Hkv, int S, int D, int nsplit, const Strides& st, float scale,
             cudaStream_t s) {
  const int dpl = (D + 31) / 32;
  if (dpl <= 1) return launch_partial<T, R, 1>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, st, scale, s);
  if (dpl <= 2) return launch_partial<T, R, 2>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, st, scale, s);
  if (dpl <= 4) return launch_partial<T, R, 4>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, st, scale, s);
  return launch_partial<T, R, 8>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, st, scale, s);
}

template <typename T>
int launch(const T* q, const T* k, const T* v, const int* lengths, T* o, float* ws, int B,
           int H, int Hkv, int S, int D, const long long* strides, float scale, void* stream) {
  if (B == 0 || H == 0) return 0;
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || S < 1) return (int)cudaErrorInvalidValue;
  Strides st;
  st.q[0] = strides[0];
  st.q[1] = strides[1];
  for (int i = 0; i < 3; ++i) {
    st.k[i] = strides[2 + i];
    st.v[i] = strides[5 + i];
  }
  st.o[0] = strides[8];
  st.o[1] = strides[9];
  const cudaStream_t s = (cudaStream_t)stream;
  const int nsplit = (S + CHUNK - 1) / CHUNK;
  // heads of a group served by one block: 4 warps x R heads, R the smallest
  // of 1, 2, 4 that covers the group (up to 16 heads)
  const int G = H / Hkv;
  if (nsplit > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  int rc;
  if (G <= WARPS) rc = launch_r<T, 1>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, st, scale, s);
  else if (G <= 2 * WARPS) rc = launch_r<T, 2>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, st, scale, s);
  else rc = launch_r<T, 4>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, st, scale, s);
  if (rc != 0 || nsplit == 1) return rc;
  dec_combine<T><<<dim3(H, B), D < 128 ? 64 : 128, 0, s>>>(ws, o, H, D, nsplit, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// decode_attention_workspace_floats: floats of workspace the wrapper allocates
// (0 for a cache of one chunk, which needs none: pass a null ws then)
int decode_attention_workspace_floats(int B, int H, int S, int D) {
  const int nsplit = (S + CHUNK - 1) / CHUNK;
  return nsplit > 1 ? B * H * nsplit * (D + 2) : 0;
}

// strides: q (batch, head), k (batch, head, slot), v (batch, head, slot),
// o (batch, head): 10 element strides
int decode_attention_f32(const float* q, const float* k, const float* v, const int* lengths,
                         float* o, float* ws, int B, int H, int Hkv, int S, int D,
                         const long long* strides, float scale, void* stream) {
  return launch<float>(q, k, v, lengths, o, ws, B, H, Hkv, S, D, strides, scale, stream);
}

int decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const int* lengths, __nv_bfloat16* o,
                          float* ws, int B, int H, int Hkv, int S, int D,
                          const long long* strides, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, lengths, o, ws, B, H, Hkv, S, D, strides, scale,
                               stream);
}

}  // extern "C"
