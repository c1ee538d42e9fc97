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
// does. 1 <= D <= 256, any H % Hkv == 0.
//
// Numerics follow the TPU kernel: float32 scores and online softmax,
// NEG_INF = -2e38, division by max(l, 1e-30).
//
// Split-K. The TPU kernel walks the slot axis sequentially in one grid step;
// here the slot axis is cut into `nsplit` splits of `chunk` slots, one block
// per (split, KV head, 16 query heads of its group, batch). The wrapper
// chooses nsplit and chunk from B, Hkv, the group size, S and the card's SM
// count (kernel.py, `decode_splits`), never from `lengths`: the decode step is
// replayed from a CUDA graph while the lengths change on the device. A block
// whose split starts at or past lengths[b] exits at once; the combine reads
// only the splits that hold a live slot. With one split (the serving shape,
// S = 32) the block writes acc / max(l, 1e-30) itself: one launch, no
// workspace. With more, each block writes its (m, l, acc) to a float32
// workspace and a second launch combines them per (b, h): M = max m_i,
// L = sum l_i e^(m_i - M), out = sum acc_i e^(m_i - M) / max(L, 1e-30). The
// combine stays a second launch (a fused last-block combine needs a counter
// zeroed before every replay); it runs only for caches above one split.
//
// bf16 (the serving path): tensor cores. The G = H / Hkv query heads of a KV
// group are the rows of one 16-row A tile (zero rows past G), so a K/V tile
// is read once for the whole group. Each of the 4 warps owns every 4th tile
// of 16 slots of the split and streams it through its own ring of shared
// memory (4, 3 or 2 stages at padded head dims 64, 128, 256) with 16-byte
// cp.async, the next tiles' bytes in flight while the current one is
// computed; only warp barriers sit in the loop. Scores and P V are
// mma.sync m16n8k16 on ldmatrix fragments (bf16 in, float32 accumulate), the
// softmax in registers in the log2 domain (ex2.approx), P rounded to bf16
// for P V as the reference's XLA attention does. The 4 warps' (m, l, acc)
// are merged through shared memory at the end. What bounds it on the H100:
// the bytes of K and V at long caches (read once per KV head), launch
// latency at the serving shape.
//
// float32: CUDA cores: one warp per query head (2 or 4 heads per
// warp for wide groups), 32-slot K/V tiles widened to float32 in shared
// memory, one score per lane, warp-shuffle max and sum. It serves the
// full-width float32 parity of the models against their CPU copies.
//
// Built without -fmad=false (kernels/_build.py, FMAD_SOURCES): the softmax's
// scale and shift are one FMA, and the parity with the plain version is a
// tolerance (5e-5 in float32, 3e-2 in bf16), not bit-equality.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -2.0e38f;
constexpr float LN2 = 0.69314718055994531f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

struct Strides {
  long long q[2], k[3], v[3], o[2];
};

// Dynamic shared memory above 48 KB needs an opt-in, which holds per device.
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

__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) { *p = __float2bfloat16_rn(x); }

// ==================================================== float32: CUDA cores
constexpr int WARPS = 4;
constexpr int THREADS = WARPS * 32;
constexpr int BK = 32;  // slots per tile: one per lane

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

// workspace per (b, h, split): [m (natural log domain), l, acc[0..D)]; with
// nsplit == 1 (ws is null) the block writes the normalised output instead
template <int R, int DPL>
__global__ void __launch_bounds__(THREADS)
dec_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
               const float* __restrict__ v, const int* __restrict__ lengths,
               float* __restrict__ ws, float* __restrict__ o, int H, int Hkv, int S, int D,
               int hgroups, int nsplit, int chunk, Strides st, float scale) {
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
  const int c0 = split * chunk;
  if (nsplit > 1 && c0 >= len) return;  // block-uniform: no live slot here
  const int c1 = min(c0 + chunk, len);
  const float* kp = k + b * st.k[0] + hk * st.k[1];
  const float* vp = v + b * st.v[0] + hk * st.v[1];

  // query head of (warp, r): g = hg * WARPS * R + warp * R + r of group hk
  for (int i = tid; i < WARPS * R * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    const int g = hg * WARPS * R + r;
    qs[i] = g < G ? q[b * st.q[0] + (hk * G + g) * st.q[1] + d] : 0.f;
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
      ks[r * DP + d] = in ? kp[s * st.k[2] + d] : 0.f;
      vs[i] = in ? vp[s * st.v[2] + d] : 0.f;
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
      float* op = o + b * st.o[0] + (hk * G + g) * st.o[1];
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        if (d < D) op[d] = acc[r][i] / denom;
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

template <int R, int DPL>
int launch_f32(const float* q, const float* k, const float* v, const int* lengths, float* ws,
               float* o, int B, int H, int Hkv, int S, int D, int nsplit, int chunk,
               const Strides& st, float scale, cudaStream_t stream) {
  static bool opted_in[MAX_DEVICES] = {};
  const size_t smem = sizeof(float) * ((size_t)WARPS * R * D + (size_t)BK * (D + 1) + (size_t)BK * D);
  const size_t most = sizeof(float) * ((size_t)WARPS * R * 32 * DPL + (size_t)BK * (32 * DPL + 1) +
                                       (size_t)BK * 32 * DPL);
  const cudaError_t e = opt_in(dec_f32_kernel<R, DPL>, most, opted_in);
  if (e != cudaSuccess) return (int)e;
  const int G = H / Hkv;
  const int hgroups = (G + WARPS * R - 1) / (WARPS * R);
  const dim3 grid(nsplit, Hkv * hgroups, B);
  dec_f32_kernel<R, DPL><<<grid, THREADS, smem, stream>>>(q, k, v, lengths, ws, o, H, Hkv, S, D,
                                                          hgroups, nsplit, chunk, st, scale);
  return (int)cudaGetLastError();
}

template <int R>
int launch_f32_r(const float* q, const float* k, const float* v, const int* lengths, float* ws,
                 float* o, int B, int H, int Hkv, int S, int D, int nsplit, int chunk,
                 const Strides& st, float scale, cudaStream_t s) {
  const int dpl = (D + 31) / 32;
  if (dpl <= 1) return launch_f32<R, 1>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, s);
  if (dpl <= 2) return launch_f32<R, 2>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, s);
  if (dpl <= 4) return launch_f32<R, 4>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, s);
  return launch_f32<R, 8>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, s);
}

// =================================================== bf16: tensor cores
using bf16 = __nv_bfloat16;
constexpr int TC_WARPS = 4;
constexpr int TC_THREADS = TC_WARPS * 32;
constexpr int TC_ROWS = 16;  // query heads of a group per block: one A tile
constexpr int TK = 16;       // slots per warp tile

template <int DP>
__host__ __device__ constexpr int tc_stages() {
  return DP <= 64 ? 4 : (DP <= 128 ? 3 : 2);
}

// Q tile, then each warp's ring of ST x {K, V} x TK x DP; the closing merge of
// the warps' (m, l, acc) reuses the rings
template <int DP>
constexpr size_t tc_smem() {
  return sizeof(bf16) * ((size_t)TC_ROWS * DP + (size_t)TC_WARPS * tc_stages<DP>() * 2 * TK * DP);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// element offset of 16-byte chunk c of row r in a tile of DP-wide rows, the
// chunk index XORed with the row's low 3 bits (conflict-free ldmatrix)
template <int DP>
__device__ __forceinline__ int swz(int r, int c) {
  return r * DP + ((c ^ (r & 7)) << 3);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  // bytes == 0 fills the chunk with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// d += a (16 x 16, row) * b (16 x 8, col), bf16 in, float32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Stage `rows` rows of DP bf16 into a swizzled tile, threads t0, t0 + step,
// ... sharing the work: row r from src(r), its first D elements live and the
// rest zero; a null src(r) is a zero row. vec: D % 8 == 0 and 16-byte aligned
// rows, so cp.async moves 16-byte chunks; otherwise elements one by one.
template <int DP, typename RowPtr>
__device__ __forceinline__ void stage_rows(bf16* dst, int rows, int D, bool vec, RowPtr src,
                                           const bf16* any, int t0, int step) {
  constexpr int CH = DP / 8;
  for (int i = t0; i < rows * CH; i += step) {
    const int r = i / CH, c = i % CH;
    bf16* d = dst + swz<DP>(r, c);
    const bf16* g = src(r);
    const int live = g ? min(8, D - c * 8) : 0;
    if (vec) {
      cp_async16(smem_u32(d), live > 0 ? g + c * 8 : any, live > 0 ? 16 : 0);
    } else {
      unsigned e[8] = {0, 0, 0, 0, 0, 0, 0, 0};
      const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
      for (int j = 0; j < live; ++j) e[j] = gs[c * 8 + j];
      *reinterpret_cast<uint4*>(d) = make_uint4(e[0] | (e[1] << 16), e[2] | (e[3] << 16),
                                                e[4] | (e[5] << 16), e[6] | (e[7] << 16));
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
dec_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
              const bf16* __restrict__ v, const int* __restrict__ lengths,
              float* __restrict__ ws, bf16* __restrict__ o, int H, int Hkv, int S, int D,
              int hgroups, int nsplit, int chunk, Strides st, float scale_log2, int vec) {
  constexpr int ST = tc_stages<DP>();
  constexpr bool QREG = DP <= 128;  // Q fragments held in registers
  constexpr int RING = ST * 2 * TK * DP;  // elements of one warp's ring
  extern __shared__ uint4 smem_tc[];
  bf16* qs = reinterpret_cast<bf16*>(smem_tc);  // TC_ROWS x DP
  bf16* rings = qs + TC_ROWS * DP;

  const int split = blockIdx.x, b = blockIdx.z;
  const int hk = blockIdx.y / hgroups, hg = blockIdx.y - hk * hgroups;
  const int G = H / Hkv;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gq = lane >> 2, tq = lane & 3;
  const int len = min(lengths[b], S);
  const int c0 = split * chunk;
  if (nsplit > 1 && c0 >= len) return;  // block-uniform: no live slot here
  const int c1 = min(c0 + chunk, len);
  const bf16* kp = k + b * st.k[0] + hk * st.k[1];
  const bf16* vp = v + b * st.v[0] + hk * st.v[1];

  // A row r: query head hk * G + hg * 16 + r (a zero row past the group)
  stage_rows<DP>(
      qs, TC_ROWS, D, vec,
      [&](int r) -> const bf16* {
        const int g = hg * TC_ROWS + r;
        return g < G ? q + b * st.q[0] + (long long)(hk * G + g) * st.q[1] : nullptr;
      },
      q, tid, TC_THREADS);
  cp_commit();

  // this warp's tiles: the i-th is tile warp + 4 i of the split
  const int ntiles = c1 > c0 ? (c1 - c0 + TK - 1) / TK : 0;
  const int mine = ntiles > warp ? (ntiles - warp + TC_WARPS - 1) / TC_WARPS : 0;
  bf16* ring = rings + warp * RING;
  auto stage_kv = [&](int i) {
    const int k0 = c0 + (warp + i * TC_WARPS) * TK;
    bf16* ks = ring + (i % ST) * 2 * TK * DP;
    stage_rows<DP>(
        ks, TK, D, vec,
        [&](int r) -> const bf16* {
          return k0 + r < c1 ? kp + (long long)(k0 + r) * st.k[2] : nullptr;
        },
        k, lane, 32);
    stage_rows<DP>(
        ks + TK * DP, TK, D, vec,
        [&](int r) -> const bf16* {
          return k0 + r < c1 ? vp + (long long)(k0 + r) * st.v[2] : nullptr;
        },
        v, lane, 32);
  };
#pragma unroll
  for (int i = 0; i < ST - 1; ++i) {  // the ring's first tiles in flight
    if (i < mine) stage_kv(i);
    cp_commit();
  }
  cp_wait<ST - 1>();  // Q has landed (every thread's share)
  __syncthreads();

  const uint32_t q_base = smem_u32(qs);
  uint32_t qf[QREG ? DP / 16 : 1][4];
  if constexpr (QREG) {
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk)
      ldsm_x4(qf[kk], q_base + 2 * swz<DP>(lane & 15, kk * 2 + (lane >> 4)));
  }

  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};  // l: this thread's columns
  float acc[DP / 8][4];
#pragma unroll
  for (int n = 0; n < DP / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int i = 0; i < mine; ++i) {
    cp_wait<ST - 2>();  // tile i has landed (this lane's share)
    __syncwarp();       // ... every lane's, and slot (i - 1) % ST is consumed
    if (i + ST - 1 < mine) stage_kv(i + ST - 1);
    cp_commit();
    const int k0 = c0 + (warp + i * TC_WARPS) * TK;
    const bf16* ks = ring + (i % ST) * 2 * TK * DP;
    const uint32_t k_base = smem_u32(ks), v_base = smem_u32(ks + TK * DP);
    // S = Q K^T: 16 rows x 16 slots, two n-blocks of 8
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      uint32_t a[4];
      if constexpr (QREG) {
#pragma unroll
        for (int j = 0; j < 4; ++j) a[j] = qf[kk][j];
      } else {
        ldsm_x4(a, q_base + 2 * swz<DP>(lane & 15, kk * 2 + (lane >> 4)));
      }
      uint32_t bk[4];
      ldsm_x4(bk, k_base + 2 * swz<DP>((lane & 7) + ((lane >> 4) << 3), kk * 2 + ((lane >> 3) & 1)));
      mma_bf16(s[0], a, bk[0], bk[1]);
      mma_bf16(s[1], a, bk[2], bk[3]);
    }
    // element e of n-block n is slot k0 + 8n + 2tq + (e & 1) of row gq
    // (e < 2) or gq + 8; every row shares the slot range [c0, c1)
    const bool masked = k0 + TK > c1;  // warp-uniform: the split's last tile
    if (masked) {
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (k0 + 8 * n + 2 * tq + (e & 1) >= c1) s[n][e] = NEG_INF;
    }
    float alpha[2], neg_m[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // the 4 threads of a quad share a row
      float mx = fmaxf(fmaxf(s[0][2 * r], s[0][2 * r + 1]), fmaxf(s[1][2 * r], s[1][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
      const float m_new = fmaxf(m[r], mx == NEG_INF ? NEG_INF : mx * scale_log2);
      alpha[r] = exp2_ftz(m[r] - m_new);
      m[r] = m_new;
      neg_m[r] = -m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float p = exp2_ftz(fmaf(s[n][e], scale_log2, neg_m[r]));
        if (masked && s[n][e] == NEG_INF) p = 0.f;
        s[n][e] = p;
        l[r] += p;
      }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }
    // O += P V: P's accumulator fragments repacked as one bf16 A fragment
    const uint32_t a[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]),
                           pack_bf16(s[1][0], s[1][1]), pack_bf16(s[1][2], s[1][3])};
#pragma unroll
    for (int n2 = 0; n2 < DP / 16; ++n2) {
      uint32_t bv[4];
      ldsm_x4_t(bv, v_base + 2 * swz<DP>((lane & 7) + (((lane >> 3) & 1) << 3), n2 * 2 + (lane >> 4)));
      mma_bf16(acc[2 * n2], a, bv[0], bv[1]);
      mma_bf16(acc[2 * n2 + 1], a, bv[2], bv[3]);
    }
  }
  cp_wait<0>();

  // merge the 4 warps' states through shared memory (the rings are free)
  __syncthreads();
  float* cm = reinterpret_cast<float*>(rings);  // [warp][16] m (log2 domain)
  float* cl = cm + TC_WARPS * TC_ROWS;          // [warp][16] l
  float* ca = cl + TC_WARPS * TC_ROWS;          // [warp][16][DP] acc
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(FULL, lr, 1);
    lr += __shfl_xor_sync(FULL, lr, 2);
    const int row = warp * TC_ROWS + gq + 8 * r;
    if (tq == 0) {
      cm[row] = m[r];
      cl[row] = lr;
    }
#pragma unroll
    for (int n = 0; n < DP / 8; ++n) {
      const int d = 8 * n + 2 * tq;
      ca[row * DP + d] = acc[n][2 * r];
      ca[row * DP + d + 1] = acc[n][2 * r + 1];
    }
  }
  __syncthreads();
  const int rows = min(TC_ROWS, G - hg * TC_ROWS);
  for (int idx = tid; idx < rows * D; idx += TC_THREADS) {
    const int r = idx / D, d = idx - r * D;
    float M = NEG_INF;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) M = fmaxf(M, cm[w * TC_ROWS + r]);
    float L = 0.f, A = 0.f;
#pragma unroll
    for (int w = 0; w < TC_WARPS; ++w) {
      const float f = exp2_ftz(cm[w * TC_ROWS + r] - M);
      L += cl[w * TC_ROWS + r] * f;
      A += ca[(w * TC_ROWS + r) * DP + d] * f;
    }
    const int h = hk * G + hg * TC_ROWS + r;
    if (nsplit == 1) {  // block-uniform: nothing to combine
      o[b * st.o[0] + (long long)h * st.o[1] + d] = __float2bfloat16_rn(A / fmaxf(L, 1e-30f));
    } else {
      float* w = ws + (((size_t)b * H + h) * nsplit + split) * (D + 2);
      if (d == 0) {
        w[0] = M * LN2;  // the combine works in the natural log domain
        w[1] = L;
      }
      w[2 + d] = A;
    }
  }
}

template <int DP>
int launch_tc(const bf16* q, const bf16* k, const bf16* v, const int* lengths, float* ws, bf16* o,
              int B, int H, int Hkv, int S, int D, int nsplit, int chunk, const Strides& st,
              float scale, int vec, cudaStream_t stream) {
  static bool opted_in[MAX_DEVICES] = {};
  const size_t smem = tc_smem<DP>();
  const cudaError_t e = opt_in(dec_tc_kernel<DP>, smem, opted_in);
  if (e != cudaSuccess) return (int)e;
  const int G = H / Hkv;
  const int hgroups = (G + TC_ROWS - 1) / TC_ROWS;
  const dim3 grid(nsplit, Hkv * hgroups, B);
  dec_tc_kernel<DP><<<grid, TC_THREADS, smem, stream>>>(q, k, v, lengths, ws, o, H, Hkv, S, D,
                                                         hgroups, nsplit, chunk, st,
                                                         scale * 1.4426950408889634f, vec);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------------- combine
// one block per (h, b); only the splits holding a live slot are read
template <typename T>
__global__ void dec_combine(const float* __restrict__ ws, const int* __restrict__ lengths,
                            T* __restrict__ o, int H, int S, int D, int nsplit, int chunk,
                            Strides st) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int len = min(lengths[b], S);
  const int nlive = len > 0 ? (len + chunk - 1) / chunk : 0;
  const float* w = ws + ((size_t)b * H + h) * nsplit * (D + 2);
  float M = NEG_INF;
  for (int i = 0; i < nlive; ++i) M = fmaxf(M, w[i * (D + 2)]);
  float L = 0.f;
  for (int i = 0; i < nlive; ++i) L += w[i * (D + 2) + 1] * expf(w[i * (D + 2)] - M);
  const float denom = fmaxf(L, 1e-30f);
  T* op = o + b * st.o[0] + h * st.o[1];
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float a = 0.f;
    for (int i = 0; i < nlive; ++i) a += w[i * (D + 2) + 2 + d] * expf(w[i * (D + 2)] - M);
    store_f(op + d, a / denom);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

int unpack(int B, int H, int Hkv, int S, int D, int nsplit, int chunk, const float* ws,
           const long long* strides, Strides& st) {
  if (D < 1 || D > 256 || Hkv < 1 || H % Hkv != 0 || S < 1) return (int)cudaErrorInvalidValue;
  // the splits tile [0, S): every split but the last starts below S
  if (nsplit < 1 || chunk < 1 || (long long)nsplit * chunk < S || (long long)(nsplit - 1) * chunk >= S)
    return (int)cudaErrorInvalidValue;
  if (nsplit > 1 && ws == nullptr) return (int)cudaErrorInvalidValue;
  st.q[0] = strides[0];
  st.q[1] = strides[1];
  for (int i = 0; i < 3; ++i) {
    st.k[i] = strides[2 + i];
    st.v[i] = strides[5 + i];
  }
  st.o[0] = strides[8];
  st.o[1] = strides[9];
  return 0;
}

template <typename T>
int combine(const float* ws, const int* lengths, T* o, int B, int H, int S, int D, int nsplit,
            int chunk, const Strides& st, cudaStream_t s) {
  dec_combine<T><<<dim3(H, B), D < 128 ? 64 : 128, 0, s>>>(ws, lengths, o, H, S, D, nsplit,
                                                            chunk, st);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// strides: q (batch, head), k (batch, head, slot), v (batch, head, slot),
// o (batch, head): 10 element strides. nsplit splits of chunk slots tile
// [0, S); ws holds B * H * nsplit * (D + 2) floats when nsplit > 1, else it
// may be null.
int decode_attention_f32(const float* q, const float* k, const float* v, const int* lengths,
                         float* o, float* ws, int B, int H, int Hkv, int S, int D,
                         const long long* strides, float scale, int nsplit, int chunk,
                         void* stream) {
  if (B == 0 || H == 0) return 0;
  Strides st;
  if (const int rc = unpack(B, H, Hkv, S, D, nsplit, chunk, ws, strides, st)) return rc;
  const cudaStream_t s = (cudaStream_t)stream;
  // heads of a group served by one block: 4 warps x R heads, R the smallest
  // of 1, 2, 4 that covers the group (up to 16 heads)
  const int G = H / Hkv;
  int rc;
  if (G <= WARPS) rc = launch_f32_r<1>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, s);
  else if (G <= 2 * WARPS) rc = launch_f32_r<2>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, s);
  else rc = launch_f32_r<4>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, s);
  if (rc != 0 || nsplit == 1) return rc;
  return combine<float>(ws, lengths, o, B, H, S, D, nsplit, chunk, st, s);
}

int decode_attention_bf16(const __nv_bfloat16* q, const __nv_bfloat16* k,
                          const __nv_bfloat16* v, const int* lengths, __nv_bfloat16* o,
                          float* ws, int B, int H, int Hkv, int S, int D,
                          const long long* strides, float scale, int nsplit, int chunk,
                          void* stream) {
  if (B == 0 || H == 0) return 0;
  Strides st;
  if (const int rc = unpack(B, H, Hkv, S, D, nsplit, chunk, ws, strides, st)) return rc;
  bool vec = D % 8 == 0 && aligned16(q) && aligned16(k) && aligned16(v);
  for (int i = 0; i < 8; ++i) vec = vec && strides[i] % 8 == 0;
  const cudaStream_t s = (cudaStream_t)stream;
  int rc;
  if (D <= 64) rc = launch_tc<64>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, vec, s);
  else if (D <= 128) rc = launch_tc<128>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, vec, s);
  else rc = launch_tc<256>(q, k, v, lengths, ws, o, B, H, Hkv, S, D, nsplit, chunk, st, scale, vec, s);
  if (rc != 0 || nsplit == 1) return rc;
  return combine<__nv_bfloat16>(ws, lengths, o, B, H, S, D, nsplit, chunk, st, s);
}

}  // extern "C"
