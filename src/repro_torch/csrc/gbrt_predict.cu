// GBRT ensemble inference on Hopper: the Predictor's compute-time column.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   gbrt_multi  <- src/repro/kernels/gbrt_predict/kernel.py::gbrt_predict_multi
//                  (_gbrt_multi_kernel): every cloud config's ensemble in one
//                  launch, the size column shared, the memory feature broadcast;
//   gbrt_blocked <- src/repro/kernels/gbrt_predict/kernel.py::gbrt_predict_blocked
//                  (_gbrt_kernel): one ensemble over (N, F) feature rows.
//
// The TPU kernels turn every gather into a one-hot matmul for the MXU. Here a
// gather is a direct indexed load, so the walk is: one thread per row, the
// block's ensemble (features, thresholds, leaves) staged once in shared memory,
// `depth` indexed loads per tree. Trees are complete heaps (pass-through nodes
// carry a +inf threshold: every row goes left).
//
// What bounds it on the H100: not HBM. At N=65,536 rows x C=4 configs the
// kernel reads ~0.5 MB of sizes and writes 2 MB of predictions, but walks
// 150 trees x 3 levels per (row, config): ~2 shared-memory loads per level plus
// a leaf load, ~275M shared loads in all. Shared-memory bandwidth and the
// dependent load chain of each walk bound it; the design keeps the walk free
// of global-memory traffic and divergence-free (fixed depth).
//
// Accumulation is `acc = acc + lr * leaf` in tree order from `base`, each
// multiply and add rounded on its own (__dmul_rn/__dadd_rn, __fmul_rn/__fadd_rn;
// the file is also built with -fmad=false). In float64 that is bit-identical to
// the numpy walk `out += lr * tree` of GBRT.predict, and therefore to the
// serving step tables; the float32 instantiation is what the TPU kernel computes.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

constexpr int kThreads = 256;

// Stage one ensemble (T trees, I internal nodes, L leaves) into shared memory.
template <typename T>
__device__ void stage_ensemble(const int* feats, const T* thr, const T* leaves,
                               int n_int, int n_leaf, int* s_f, T* s_th, T* s_lv) {
  for (int i = threadIdx.x; i < n_int; i += blockDim.x) {
    s_f[i] = feats[i];
    s_th[i] = thr[i];
  }
  for (int i = threadIdx.x; i < n_leaf; i += blockDim.x) s_lv[i] = leaves[i];
  __syncthreads();
}

template <typename T>
__device__ T walk(const T* xrow, int n_feat, T x1, bool bcast, const int* s_f,
                  const T* s_th, const T* s_lv, int n_trees, int I, int L,
                  int depth, T lr, T base) {
  T acc = base;
  const int first_leaf = (1 << depth) - 1;
  for (int t = 0; t < n_trees; ++t) {
    const int* f = s_f + t * I;
    const T* th = s_th + t * I;
    int node = 0;
    for (int d = 0; d < depth; ++d) {
      const int fi = f[node];
      const T v = bcast ? (fi == 0 ? xrow[0] : x1) : xrow[fi < n_feat ? fi : 0];
      node = 2 * node + 1 + (v > th[node] ? 1 : 0);
    }
    acc = add_rn(acc, mul_rn(lr, s_lv[t * L + (node - first_leaf)]));
  }
  return acc;
}

// grid (C, row blocks); x (N,) sizes; mem/lr/base (C,); feats/thr (C,T,I);
// leaves (C,T,L); out (N, C)
template <typename T>
__global__ void gbrt_multi_kernel(const T* __restrict__ x, const T* __restrict__ mem,
                                  const T* __restrict__ lr, const T* __restrict__ base,
                                  const int* __restrict__ feats, const T* __restrict__ thr,
                                  const T* __restrict__ leaves, T* __restrict__ out,
                                  int N, int C, int n_trees, int I, int L, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int c = blockIdx.x;
  const int n_int = n_trees * I, n_leaf = n_trees * L;
  T* s_th = reinterpret_cast<T*>(smem);
  T* s_lv = s_th + n_int;
  int* s_f = reinterpret_cast<int*>(s_lv + n_leaf);
  stage_ensemble(feats + (size_t)c * n_int, thr + (size_t)c * n_int,
                 leaves + (size_t)c * n_leaf, n_int, n_leaf, s_f, s_th, s_lv);
  const int row = blockIdx.y * blockDim.x + threadIdx.x;
  if (row >= N) return;
  out[(size_t)row * C + c] = walk<T>(x + row, 1, mem[c], true, s_f, s_th, s_lv,
                                     n_trees, I, L, depth, lr[c], base[c]);
}

// grid (row blocks,); x (N, F); feats/thr (T, I); leaves (T, L); out (N,)
template <typename T>
__global__ void gbrt_blocked_kernel(const T* __restrict__ x, const int* __restrict__ feats,
                                    const T* __restrict__ thr, const T* __restrict__ leaves,
                                    T* __restrict__ out, int N, int F, int n_trees, int I,
                                    int L, int depth, T lr, T base) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n_int = n_trees * I, n_leaf = n_trees * L;
  T* s_th = reinterpret_cast<T*>(smem);
  T* s_lv = s_th + n_int;
  int* s_f = reinterpret_cast<int*>(s_lv + n_leaf);
  stage_ensemble(feats, thr, leaves, n_int, n_leaf, s_f, s_th, s_lv);
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  out[row] = walk<T>(x + (size_t)row * F, F, T(0), false, s_f, s_th, s_lv, n_trees,
                     I, L, depth, lr, base);
}

template <typename T>
size_t ensemble_bytes(int n_trees, int I, int L) {
  return (size_t)n_trees * I * (sizeof(T) + sizeof(int)) + (size_t)n_trees * L * sizeof(T);
}

template <typename T, typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

template <typename T>
int launch_multi(const T* x, const T* mem, const T* lr, const T* base, const int* feats,
                 const T* thr, const T* leaves, T* out, int N, int C, int n_trees, int I,
                 int L, int depth, void* stream) {
  if (N == 0 || C == 0) return 0;
  const size_t bytes = ensemble_bytes<T>(n_trees, I, L);
  int e = set_smem<T>(gbrt_multi_kernel<T>, bytes);
  if (e) return e;
  dim3 grid(C, (N + kThreads - 1) / kThreads);
  gbrt_multi_kernel<T><<<grid, kThreads, bytes, (cudaStream_t)stream>>>(
      x, mem, lr, base, feats, thr, leaves, out, N, C, n_trees, I, L, depth);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_blocked(const T* x, const int* feats, const T* thr, const T* leaves, T* out,
                   int N, int F, int n_trees, int I, int L, int depth, double lr,
                   double base, void* stream) {
  if (N == 0) return 0;
  const size_t bytes = ensemble_bytes<T>(n_trees, I, L);
  int e = set_smem<T>(gbrt_blocked_kernel<T>, bytes);
  if (e) return e;
  gbrt_blocked_kernel<T><<<(N + kThreads - 1) / kThreads, kThreads, bytes,
                           (cudaStream_t)stream>>>(x, feats, thr, leaves, out, N, F,
                                                   n_trees, I, L, depth, (T)lr, (T)base);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int gbrt_multi_f32(const float* x, const float* mem, const float* lr, const float* base,
                   const int* feats, const float* thr, const float* leaves, float* out,
                   int N, int C, int n_trees, int I, int L, int depth, void* stream) {
  return launch_multi<float>(x, mem, lr, base, feats, thr, leaves, out, N, C, n_trees, I,
                             L, depth, stream);
}

int gbrt_multi_f64(const double* x, const double* mem, const double* lr, const double* base,
                   const int* feats, const double* thr, const double* leaves, double* out,
                   int N, int C, int n_trees, int I, int L, int depth, void* stream) {
  return launch_multi<double>(x, mem, lr, base, feats, thr, leaves, out, N, C, n_trees, I,
                              L, depth, stream);
}

int gbrt_blocked_f32(const float* x, const int* feats, const float* thr, const float* leaves,
                     float* out, int N, int F, int n_trees, int I, int L, int depth,
                     double lr, double base, void* stream) {
  return launch_blocked<float>(x, feats, thr, leaves, out, N, F, n_trees, I, L, depth, lr,
                               base, stream);
}

int gbrt_blocked_f64(const double* x, const int* feats, const double* thr,
                     const double* leaves, double* out, int N, int F, int n_trees, int I,
                     int L, int depth, double lr, double base, void* stream) {
  return launch_blocked<double>(x, feats, thr, leaves, out, N, F, n_trees, I, L, depth, lr,
                                base, stream);
}

}  // extern "C"
