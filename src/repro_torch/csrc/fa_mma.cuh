// Tensor-core building blocks shared by the flash-attention forward (K4,
// flash_attention.cu), its backward (K4b, flash_attention_bwd.cu) and the
// SSD backward (K6b, ssd_scan_bwd.cu):
// bf16 tiles staged with cp.async into shared memory whose 16-byte chunks
// are XOR-swizzled by row, fragments read with ldmatrix, and
// mma.sync.m16n8k16 (bf16 in, float32 accumulate).
//
// _build hashes this header into the name of each library that includes
// it, so an edit here rebuilds those.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr float NEG_INF = -2.0e38f;
constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_DEVICES = 64;

// Dynamic shared memory above 48 KB needs an opt-in, which holds per device:
// each kernel instantiation remembers it per device, for its largest size.
template <typename Kernel>
cudaError_t opt_in(Kernel* kernel, size_t max_smem, bool (&done)[MAX_DEVICES]) {
  if (max_smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < MAX_DEVICES && done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)max_smem);
  if (e == cudaSuccess && dev < MAX_DEVICES) done[dev] = true;
  return e;
}

inline bool aligned16(const void* p) { return ((uintptr_t)p & 15) == 0; }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// element offset of 16-byte chunk c of row r in a tile of W-wide bf16 rows.
// The chunk index is XORed with bits of the row, so the 8 rows an ldmatrix
// reads at one logical chunk fall in 8 distinct bank groups: with 8 or more
// chunks a row (W >= 64) by the row's low 3 bits; with 4 (W = 32, two rows
// to a 128-byte line) by bits 1-2, the low bit choosing the line's half.
template <int W>
__device__ __forceinline__ int swz(int r, int c) {
  static_assert(W == 32 || W % 64 == 0, "rows of 32 or a multiple of 64");
  if constexpr (W == 32) {
    return r * W + ((c ^ ((r >> 1) & 3)) << 3);
  } else {
    return r * W + ((c ^ (r & 7)) << 3);
  }
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

// ldmatrix addresses (bytes, from a tile's shared base) of the fragments of
// one mma.sync, for the calling lane. A: the 16 x 16 A operand at rows
// r0.., columns 16 kk.. of a row-major tile. B: two n-blocks (16 rows n0..
// of N, columns 16 kk.. of K) of a tile stored N x K (the "col" operand).
// BT: two n-blocks (columns 16 n2.. of N) of a tile stored K x N (rows
// 16 kk.. of K), read transposed.
template <int W>
__device__ __forceinline__ uint32_t frag_a(uint32_t base, int r0, int kk, int lane) {
  return base + 2 * swz<W>(r0 + (lane & 15), kk * 2 + (lane >> 4));
}

template <int W>
__device__ __forceinline__ uint32_t frag_b(uint32_t base, int n0, int kk, int lane) {
  return base + 2 * swz<W>(n0 + (lane & 7) + ((lane >> 4) << 3), kk * 2 + ((lane >> 3) & 1));
}

template <int W>
__device__ __forceinline__ uint32_t frag_bt(uint32_t base, int kk, int n2, int lane) {
  return base + 2 * swz<W>(kk * 16 + (lane & 7) + (((lane >> 3) & 1) << 3),
                           n2 * 2 + (lane >> 4));
}

// Stage `rows` rows of DP bf16 into a swizzled tile with NT threads: row r
// from src(r), the first D elements live and the rest zero; a null src(r)
// is a zero row. vec: D % 8 == 0 and every row 16-byte aligned, so cp.async
// moves 16-byte chunks (zero-filled past D; the caller commits the group);
// otherwise elements are copied one by one.
template <int DP, int NT, typename RowPtr>
__device__ __forceinline__ void stage_rows(bf16* dst, int rows, int D, bool vec, RowPtr src,
                                           const bf16* any) {
  constexpr int CH = DP / 8;
  for (int i = threadIdx.x; i < rows * CH; i += NT) {
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

}  // namespace
