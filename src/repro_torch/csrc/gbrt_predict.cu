// GBRT ensemble inference on Hopper: the Predictor's compute-time column.
//
// Replaces two Pallas TPU kernels of the JAX package:
//   K1 gbrt_multi   <- src/repro/kernels/gbrt_predict/kernel.py::gbrt_predict_multi
//                      (_gbrt_multi_kernel): every cloud config's ensemble over one
//                      shared size column, the config's memory feature broadcast
//                      (any feature id other than 0 reads it); out (N, C);
//   K2 gbrt_blocked <- src/repro/kernels/gbrt_predict/kernel.py::gbrt_predict_blocked
//                      (_gbrt_kernel): one ensemble over (N, F) feature rows.
//
// Trees are complete heaps of depth d; the prediction is acc = acc + lr * leaf in
// tree order from base. The TPU kernels walk every tree for every row, turning each
// gather into a one-hot matmul for the MXU.
//
// What bounded a walk here (the design of the first port): one thread walked one
// (row, config) through all T trees, d dependent pairs of shared-memory loads
// (feature, threshold) and a leaf load per tree. At the main path (N = 65,536,
// C = 4, T = 150, d = 3) that is 39.3M walks, ~2.75e8 shared loads, ~37 us of load
// issue alone on 132 SMs before the latency chains; K1 took 0.115 ms, K2 0.051 ms.
// Yet with the memory fixed per config the ensemble is a step function of the size
// with at most (distinct feature-0 thresholds + 1) = 60 steps there.
//
// The design: a step table built on the card per call, then a lookup.
//   build  - one warp per table entry evaluates the whole ensemble at the entry's
//            representative point: lane l walks trees l, l + 32, ... in the block's
//            staged ensemble (16-byte cp.async) and rounds lr * leaf on its own into
//            shared memory; lane 0 adds the T products in tree order from base,
//            padding trees included (-0.0 + 0.0 is +0.0).
//   lookup - one thread per row: k = #{b < x} per searched feature by a branch-free
//            binary search over the sorted breaks in shared memory (K1: four
//            configs in lockstep, their loads overlapped), then one read of the
//            entry from global memory (L2-resident). K1 gathers a block's rows'
//            C * 256 outputs, one contiguous span of out, and writes them coalesced.
//            The lookup is launched as the build's programmatic dependent: its
//            blocks stage the breaks and search while the build runs, and wait for
//            the table (griddepcontrol.wait) only to read it.
// K2 takes the table while it has at most kMaxTableFeatures feature ids and at most
// 4,096 cells (the host routes on sizes it knows of the model); past that it runs the
// walk kernel (blocked_walk_kernel), one thread per row as in the first port. The
// host rejects a model with a feature id >= F.
// What bounds the table route: bytes, ~2.7 MB at K1's main path (0.5 MB of sizes
// read, 2.1 MB of predictions written) and ~1.6 MB at K2's; in time, the latency
// of two dependent launches: the build (~240 warps, the staging, five trees' walks
// a lane and a 150-add chain) and the lookup's tail. The values depend on mem, lr,
// base and the leaves and are rebuilt on every call; only the breaks (a function of
// the thresholds) come from the host's per-model cache.
//
// Exactness: with B a feature's sorted distinct thresholds (NaN and +inf left out: such
// nodes send every row left) and k(x) = #{b in B : b < x}, a node goes right iff its
// threshold's rank is < k(x): equal k, the same leaves and tree-order sum, bit for bit.
// B[k] (+inf for k = |B|) has that k; a NaN walks left everywhere, as B[0], and gets 0.
//
// Every multiply and add is rounded on its own (__dmul_rn/__dadd_rn, __fmul_rn/
// __fadd_rn; the file is also built with -fmad=false), so each route is bit-identical
// to the plain walk in float64 (and so to GBRT.predict), and does the same roundings
// in float32.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <map>
#include <mutex>
#include <utility>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxTableFeatures = 16;  // feature ids a K2 table may have

// K2's table layout, passed by value: feature f's entry index is
// (cell / stride[f]) % radix[f], radix[f] = its break count + 1.
struct Radix {
  int n;
  int radix[kMaxTableFeatures];
  int stride[kMaxTableFeatures];
};

// ------------------------------------------------------------------ staging
__device__ __forceinline__ void cp_async4(void* s, const void* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async16(void* s, const void* g) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(s));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a), "l"(g) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Shared bytes that stage<T>(n) takes: the array, rounded up to 16, plus 16 of slack.
template <typename T>
__host__ __device__ constexpr size_t staged_bytes(size_t n) {
  return ((n * sizeof(T) + 15) & ~static_cast<size_t>(15)) + 16;
}

// Start copying g[0, n) into shared memory at *s (16-byte aligned), placed at g's
// alignment modulo 16 so that the body moves in 16-byte pieces (the head and tail
// in 4-byte ones); advances *s past the region. The caller waits and syncs.
template <typename T>
__device__ const T* stage(const T* g, size_t n, unsigned char** s) {
  const unsigned char* src = reinterpret_cast<const unsigned char*>(g);
  const size_t mis = reinterpret_cast<uintptr_t>(g) & 15;
  unsigned char* dst = *s + mis;
  *s += staged_bytes<T>(n);
  const size_t bytes = n * sizeof(T);
  const size_t lead = (16 - mis) & 15;
  const size_t head = bytes < lead ? bytes : lead;
  const size_t body_end = head + ((bytes - head) & ~static_cast<size_t>(15));
  for (size_t i = 4 * threadIdx.x; i < head; i += 4 * blockDim.x) cp_async4(dst + i, src + i);
  for (size_t i = head + 16 * threadIdx.x; i < body_end; i += 16 * blockDim.x)
    cp_async16(dst + i, src + i);
  for (size_t i = body_end + 4 * threadIdx.x; i < bytes; i += 4 * blockDim.x)
    cp_async4(dst + i, src + i);
  return reinterpret_cast<const T*>(dst);
}

template <typename T>
struct Ensemble {
  const int* f;   // (T, I) feature ids
  const T* th;    // (T, I) thresholds
  const T* lv;    // (T, L) leaves
};

template <typename T>
size_t ensemble_bytes(int n_trees, int I, int L) {
  return staged_bytes<int>((size_t)n_trees * I) + staged_bytes<T>((size_t)n_trees * I) +
         staged_bytes<T>((size_t)n_trees * L);
}

template <typename T>
__device__ Ensemble<T> stage_ensemble(const int* feats, const T* thr, const T* leaves,
                                      int n_trees, int I, int L, unsigned char** s) {
  Ensemble<T> e;
  e.f = stage(feats, (size_t)n_trees * I, s);
  e.th = stage(thr, (size_t)n_trees * I, s);
  e.lv = stage(leaves, (size_t)n_trees * L, s);
  return e;
}

// ------------------------------------------------------------------- walking
// The leaf one tree sends a point to; feat(fi) is the point's feature fi.
template <typename T, typename Feat>
__device__ __forceinline__ T leaf_of(const Ensemble<T>& e, int t, int I, int L, int depth,
                                     Feat feat) {
  const int* f = e.f + t * I;
  const T* th = e.th + t * I;
  int node = 0;
  for (int d = 0; d < depth; ++d) node = 2 * node + 1 + (feat(f[node]) > th[node] ? 1 : 0);
  return e.lv[t * L + node - ((1 << depth) - 1)];
}

// The ensemble at one point, by one warp: lane l walks trees l, l + 32, ... and
// rounds lr * leaf into prod[t] (the warp's n_trees slots); lane 0 then adds the
// products in tree order from base, padding trees too, and returns the walk's sum.
template <typename T, typename Feat>
__device__ T warp_sum(const Ensemble<T>& e, T* prod, int n_trees, int I, int L, int depth,
                      T lr, T base, Feat feat) {
  for (int t = threadIdx.x & 31; t < n_trees; t += 32)
    prod[t] = mul_rn(lr, leaf_of(e, t, I, L, depth, feat));
  __syncwarp();
  T acc = base;
  if ((threadIdx.x & 31) == 0) {
#pragma unroll 8
    for (int t = 0; t < n_trees; ++t) acc = add_rn(acc, prod[t]);
  }
  return acc;
}

// k[j] = #{i < n : b[j * n + i] < x} for K rows of n >= 1 values sorted ascending:
// branch-free lower bounds (searchsorted side="left") run in lockstep so that the
// rows' loads overlap; a NaN x compares false everywhere and gets 0.
template <int K, typename T>
__device__ __forceinline__ void rank_below(const T* b, int n, T x, int* k) {
  int p[K];
#pragma unroll
  for (int j = 0; j < K; ++j) p[j] = j * n;
  for (int m = n; m > 1;) {
    const int half = m >> 1;
#pragma unroll
    for (int j = 0; j < K; ++j) p[j] = b[p[j] + half] < x ? p[j] + half : p[j];
    m -= half;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) k[j] = p[j] - j * n + (b[p[j]] < x ? 1 : 0);
}

// The lookups wait here for the build's table: each lookup is launched as its
// build's programmatic dependent (launch_lookup), which lets it stage its breaks and
// search while the build runs. The table is read only after the wait, by plain loads
// (not the read-only path: the build writes it while the lookup runs), so the
// lookup's signature leaves `vals` without __restrict__.
__device__ __forceinline__ void wait_for_build() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

__device__ __forceinline__ void release_lookup() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// ------------------------------------------------------------------------ K1
// grid (ceil(W / kWarps), C): warp k of config c evaluates entry k at
// (breaks[c, k], mem[c]). breaks (C, W): config c's sorted breaks, +inf padded.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    multi_build_kernel(const T* __restrict__ breaks, const T* __restrict__ mem,
                       const T* __restrict__ lr, const T* __restrict__ base,
                       const int* __restrict__ feats, const T* __restrict__ thr,
                       const T* __restrict__ leaves, T* __restrict__ vals, int W, int n_trees,
                       int I, int L, int depth) {
  extern __shared__ __align__(16) unsigned char smem[];
  release_lookup();
  const int c = blockIdx.y;
  unsigned char* s = smem;
  const Ensemble<T> e = stage_ensemble(feats + (size_t)c * n_trees * I,
                                       thr + (size_t)c * n_trees * I,
                                       leaves + (size_t)c * n_trees * L, n_trees, I, L, &s);
  T* prod = reinterpret_cast<T*>(s) + (threadIdx.x >> 5) * n_trees;
  const int k = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const T x0 = k < W ? breaks[(size_t)c * W + k] : T(0), x1 = mem[c];
  cp_async_wait_all();
  __syncthreads();
  if (k >= W) return;
  const T v = warp_sum(e, prod, n_trees, I, L, depth, lr[c], base[c],
                       [&](int fi) { return fi == 0 ? x0 : x1; });
  if ((threadIdx.x & 31) == 0) vals[(size_t)c * W + k] = v;
}

// grid (ceil(N / kThreads)): row r's config c is vals[c, rank of x[r] in breaks[c]].
// Each thread searches its row's C ranks (four configs in lockstep) into shared
// memory; after the build, the block writes its rows' C * kThreads outputs, one
// contiguous span of out, coalesced.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    multi_lookup_kernel(const T* __restrict__ x, const T* __restrict__ breaks, const T* vals,
                        T* __restrict__ out, int N, int C, int W) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s = smem;
  const T* s_br = stage(breaks, (size_t)C * W, &s);
  int* s_idx = reinterpret_cast<int*>(s);
  const int row0 = blockIdx.x * kThreads, row = row0 + threadIdx.x;
  const T xv = row < N ? x[row] : T(0);
  cp_async_wait_all();
  __syncthreads();
  if (row < N) {
    int* idx = s_idx + threadIdx.x * C;
    int c = 0;
    for (; c + 4 <= C; c += 4) {
      int k[4];
      rank_below<4>(s_br + c * W, W, xv, k);
#pragma unroll
      for (int j = 0; j < 4; ++j) idx[c + j] = (c + j) * W + k[j];
    }
    for (; c < C; ++c) {
      int k[1];
      rank_below<1>(s_br + c * W, W, xv, k);
      idx[c] = c * W + k[0];
    }
  }
  __syncthreads();
  wait_for_build();
  const int n = (N - row0 < kThreads ? N - row0 : kThreads) * C;
  T* o = out + (size_t)row0 * C;
  for (int i = threadIdx.x; i < n; i += kThreads) o[i] = vals[s_idx[i]];
}

// ------------------------------------------------------------------------ K2
// grid (ceil(cells / kWarps)): warp `cell` evaluates the ensemble at the point whose
// feature f is breaks[f, (cell / stride[f]) % radix[f]]. breaks (rx.n, W).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    blocked_build_kernel(const T* __restrict__ breaks, int W, Radix rx,
                         const int* __restrict__ feats, const T* __restrict__ thr,
                         const T* __restrict__ leaves, T* __restrict__ vals, int cells,
                         int n_trees, int I, int L, int depth, T lr, T base) {
  extern __shared__ __align__(16) unsigned char smem[];
  release_lookup();
  unsigned char* s = smem;
  const Ensemble<T> e = stage_ensemble(feats, thr, leaves, n_trees, I, L, &s);
  T* point = reinterpret_cast<T*>(s) + (threadIdx.x >> 5) * (kMaxTableFeatures + n_trees);
  T* prod = point + kMaxTableFeatures;
  const int cell = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (cell < cells && (threadIdx.x & 31) == 0) {
#pragma unroll
    for (int f = 0; f < kMaxTableFeatures; ++f)
      if (f < rx.n) point[f] = breaks[(size_t)f * W + (cell / rx.stride[f]) % rx.radix[f]];
  }
  cp_async_wait_all();
  __syncthreads();
  if (cell >= cells) return;
  const T v =
      warp_sum(e, prod, n_trees, I, L, depth, lr, base, [&](int fi) { return point[fi]; });
  if ((threadIdx.x & 31) == 0) vals[cell] = v;
}

// grid (ceil(N / kThreads)): row r reads vals[sum_f stride[f] * rank of x[r, f]].
template <typename T>
__global__ void __launch_bounds__(kThreads)
    blocked_lookup_kernel(const T* __restrict__ x, const T* __restrict__ breaks, int W,
                          Radix rx, const T* vals, T* __restrict__ out, int N, int F) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s = smem;
  const T* s_br = stage(breaks, (size_t)rx.n * W, &s);
  cp_async_wait_all();
  __syncthreads();
  const int row = blockIdx.x * kThreads + threadIdx.x;
  int cell = 0;
  if (row < N) {
    const T* xr = x + (size_t)row * F;
#pragma unroll
    for (int f = 0; f < kMaxTableFeatures; ++f)
      if (f < rx.n && rx.radix[f] > 1) {
        int k[1];
        rank_below<1>(s_br + f * W, rx.radix[f], xr[f], k);
        cell += rx.stride[f] * k[0];
      }
  }
  wait_for_build();
  if (row < N) out[row] = vals[cell];
}

// The walk route: one thread per row through every tree (every feature id < F).
template <typename T>
__global__ void __launch_bounds__(kThreads)
    blocked_walk_kernel(const T* __restrict__ x, const int* __restrict__ feats,
                        const T* __restrict__ thr, const T* __restrict__ leaves,
                        T* __restrict__ out, int N, int F, int n_trees, int I, int L,
                        int depth, T lr, T base) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* s = smem;
  const Ensemble<T> e = stage_ensemble(feats, thr, leaves, n_trees, I, L, &s);
  cp_async_wait_all();
  __syncthreads();
  const int row = blockIdx.x * kThreads + threadIdx.x;
  if (row >= N) return;
  const T* xr = x + (size_t)row * F;
  T acc = base;
  for (int t = 0; t < n_trees; ++t)
    acc = add_rn(acc, mul_rn(lr, leaf_of(e, t, I, L, depth,
                                         [&](int fi) { return xr[fi]; })));
  out[row] = acc;
}

// ------------------------------------------------------------------- launches
// Let `kernel` take `bytes` of dynamic shared memory. The limit belongs to the
// function and is shared by every host thread, so it is raised once per device
// to all the device allows and never set to one launch's size: shards and
// planner candidates launch at their own sizes from several threads at once,
// and a launch must not find the limit lowered under its size by another one.
template <typename K>
int set_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  static std::mutex mu;
  static std::map<std::pair<int, const void*>, int> limits;  // (device, kernel) -> bytes
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const std::lock_guard<std::mutex> lock(mu);
  auto it = limits.find({dev, (const void*)kernel});
  if (it == limits.end()) {
    int optin = 0;
    cudaFuncAttributes fa = {};
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess) e = cudaFuncGetAttributes(&fa, kernel);
    const int limit = optin - (int)fa.sharedSizeBytes;
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
    if (e != cudaSuccess) return (int)e;
    it = limits.emplace(std::make_pair(dev, (const void*)kernel), limit).first;
  }
  return bytes > (size_t)it->second ? (int)cudaErrorInvalidValue : 0;
}

int blocks(long long n, int per) { return (int)((n + per - 1) / per); }

// Launch a lookup after its build on `st` as the build's programmatic dependent: it
// may start while the build runs, and waits for the build's table in wait_for_build.
template <typename... P, typename... A>
int launch_lookup(void (*kernel)(P...), int grid, size_t smem, cudaStream_t st, A... args) {
  int e = set_smem(kernel, smem);
  if (e) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
}

template <typename T>
int launch_multi(const T* x, const T* mem, const T* lr, const T* base, const int* feats,
                 const T* thr, const T* leaves, const T* breaks, T* vals, T* out, int N, int C,
                 int n_trees, int I, int L, int depth, int W, void* stream) {
  if (N == 0 || C == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const size_t build_smem =
      ensemble_bytes<T>(n_trees, I, L) + (size_t)kWarps * n_trees * sizeof(T);
  int e = set_smem(multi_build_kernel<T>, build_smem);
  if (e) return e;
  multi_build_kernel<T><<<dim3(blocks(W, kWarps), C), kThreads, build_smem, st>>>(
      breaks, mem, lr, base, feats, thr, leaves, vals, W, n_trees, I, L, depth);
  e = (int)cudaGetLastError();
  if (e) return e;
  const size_t lookup_smem = staged_bytes<T>((size_t)C * W) + (size_t)kThreads * C * sizeof(int);
  return launch_lookup(multi_lookup_kernel<T>, blocks(N, kThreads), lookup_smem, st, x, breaks,
                       vals, out, N, C, W);
}

template <typename T>
int launch_blocked_table(const T* x, const int* feats, const T* thr, const T* leaves,
                         const T* breaks, const int* radix, int n_ids, int W, T* vals, T* out,
                         int N, int F, int n_trees, int I, int L, int depth, double lr,
                         double base, void* stream) {
  if (N == 0) return 0;
  if (n_ids < 1 || n_ids > kMaxTableFeatures || n_ids > F) return (int)cudaErrorInvalidValue;
  Radix rx;
  rx.n = n_ids;
  long long cells = 1;
  for (int f = 0; f < kMaxTableFeatures; ++f) {
    rx.radix[f] = f < n_ids ? radix[f] : 1;
    rx.stride[f] = (int)cells;
    if (rx.radix[f] < 1 || rx.radix[f] > W) return (int)cudaErrorInvalidValue;
    cells *= rx.radix[f];
    if (cells > (1 << 24)) return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const size_t build_smem = ensemble_bytes<T>(n_trees, I, L) +
                            (size_t)kWarps * (kMaxTableFeatures + n_trees) * sizeof(T);
  int e = set_smem(blocked_build_kernel<T>, build_smem);
  if (e) return e;
  blocked_build_kernel<T><<<blocks(cells, kWarps), kThreads, build_smem, st>>>(
      breaks, W, rx, feats, thr, leaves, vals, (int)cells, n_trees, I, L, depth, (T)lr,
      (T)base);
  e = (int)cudaGetLastError();
  if (e) return e;
  return launch_lookup(blocked_lookup_kernel<T>, blocks(N, kThreads),
                       staged_bytes<T>((size_t)n_ids * W), st, x, breaks, W, rx, vals, out,
                       N, F);
}

template <typename T>
int launch_blocked_walk(const T* x, const int* feats, const T* thr, const T* leaves, T* out,
                        int N, int F, int n_trees, int I, int L, int depth, double lr,
                        double base, void* stream) {
  if (N == 0) return 0;
  const size_t bytes = ensemble_bytes<T>(n_trees, I, L);
  int e = set_smem(blocked_walk_kernel<T>, bytes);
  if (e) return e;
  blocked_walk_kernel<T><<<blocks(N, kThreads), kThreads, bytes, (cudaStream_t)stream>>>(
      x, feats, thr, leaves, out, N, F, n_trees, I, L, depth, (T)lr, (T)base);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// K1: vals is (C, W) scratch; breaks (C, W).
int gbrt_multi_f32(const float* x, const float* mem, const float* lr, const float* base,
                   const int* feats, const float* thr, const float* leaves, const float* breaks,
                   float* vals, float* out, int N, int C, int n_trees, int I, int L, int depth,
                   int W, void* stream) {
  return launch_multi<float>(x, mem, lr, base, feats, thr, leaves, breaks, vals, out, N, C,
                             n_trees, I, L, depth, W, stream);
}

int gbrt_multi_f64(const double* x, const double* mem, const double* lr, const double* base,
                   const int* feats, const double* thr, const double* leaves,
                   const double* breaks, double* vals, double* out, int N, int C, int n_trees,
                   int I, int L, int depth, int W, void* stream) {
  return launch_multi<double>(x, mem, lr, base, feats, thr, leaves, breaks, vals, out, N, C,
                              n_trees, I, L, depth, W, stream);
}

// K2, table route: breaks (n_ids, W); radix a HOST array of n_ids ints; vals
// (prod radix,) scratch.
int gbrt_blocked_table_f32(const float* x, const int* feats, const float* thr,
                           const float* leaves, const float* breaks, const int* radix,
                           int n_ids, int W, float* vals, float* out, int N, int F,
                           int n_trees, int I, int L, int depth, double lr, double base,
                           void* stream) {
  return launch_blocked_table<float>(x, feats, thr, leaves, breaks, radix, n_ids, W, vals, out,
                                     N, F, n_trees, I, L, depth, lr, base, stream);
}

int gbrt_blocked_table_f64(const double* x, const int* feats, const double* thr,
                           const double* leaves, const double* breaks, const int* radix,
                           int n_ids, int W, double* vals, double* out, int N, int F,
                           int n_trees, int I, int L, int depth, double lr, double base,
                           void* stream) {
  return launch_blocked_table<double>(x, feats, thr, leaves, breaks, radix, n_ids, W, vals,
                                      out, N, F, n_trees, I, L, depth, lr, base, stream);
}

// K2, walk route.
int gbrt_blocked_walk_f32(const float* x, const int* feats, const float* thr,
                          const float* leaves, float* out, int N, int F, int n_trees, int I,
                          int L, int depth, double lr, double base, void* stream) {
  return launch_blocked_walk<float>(x, feats, thr, leaves, out, N, F, n_trees, I, L, depth, lr,
                                    base, stream);
}

int gbrt_blocked_walk_f64(const double* x, const int* feats, const double* thr,
                          const double* leaves, double* out, int N, int F, int n_trees, int I,
                          int L, int depth, double lr, double base, void* stream) {
  return launch_blocked_walk<double>(x, feats, thr, leaves, out, N, F, n_trees, I, L, depth,
                                     lr, base, stream);
}

}  // extern "C"
