// Gated linear recurrence h_t = a_t * h_{t-1} + x_t over (B, S, D), h_{-1} = 0.
//
// Replaces src/repro/kernels/linear_scan/kernel.py::linear_scan_bsd
// (_scan_kernel), the Pallas TPU kernel behind the RG-LRU recurrence and
// `ops.prefix_sum` (the a == 1 case). The wrapper picks one of two regimes
// from the dtype and from whether `a` is given, never from the shape, so a
// stream's numbers do not depend on its chunk size:
//
// (a) Exact fold (float64, or a == nullptr): bit-identical to the strict left
//     fold of the plain version, and so to np.cumsum. On the placement main
//     path prefix_sum runs in float64 over [s0, d_0, ..., d_{R-1}], the
//     Alg. 1 surplus bank, at B = D = 1. One block of 128 threads per
//     (b, 32-column slice of D), its warps specialised. Warps 1-3 stream x
//     (and a) through shared memory in tiles of 2,048 elements (1,024 for
//     gated float64), three stages deep with coalesced cp.async copies, so
//     device-memory latency overlaps the fold. Lane j of warp 0 folds column
//     j of the tile: it reads its next 16 values from shared memory into
//     registers ahead of the chain (those loads do not depend on h; two
//     register batches in turn, and the pitch a compile-time 1 when D = 1,
//     so no copy or address arithmetic sits between two adds), so the only
//     serial dependency left is the rounded multiply and add on h. h
//     goes back into the tile in place, and while warp 0 folds tile k,
//     warps 1-3 write tile k - 1 out coalesced and stage tile k + 2: one
//     block barrier per tile. Warp 0 issues no copy itself: the copies'
//     shared-memory traffic, queued with its own loads, held up its adds.
//     What bounds it: the dependent chain, S x the latency of a float64 add
//     (and multiply, when gated). It cannot be a parallel scan: any tree or
//     chunked scan reassociates the sums, and the verifying replay of the
//     placement walk recomputes `c_max + alpha * s_before` from these bits,
//     where one ulp can flip a decision at the boundary.
//     `linear_scan_chain_floor` times that floor alone: one thread, a chain
//     of dependent __dadd_rn in registers.
//
// (b) Chunked scan (float32 with a given: the RG-LRU recurrence). No bit
//     contract (the reference holds it to 5e-5), so the sequence axis is cut
//     into chunks of L rows and the whole card works. Pass 1: one thread per
//     (b, chunk, column) folds its chunk from h = 0 and keeps the product of
//     its a's. Pass 2: the same threads carry h into their chunk through the
//     earlier chunks' (h, prod a) pairs (a short sequential loop), then fold
//     the chunk again from that carry, writing y, and the last chunk writes
//     the final state. What bounds it: bytes (x and a read twice, y written
//     once, against a bound that reads each once). Its backward (b'), K3b,
//     runs the same two passes in reverse time.
//
// Each multiply and add is rounded on its own (no FMA: the file is built
// with -fmad=false and uses the _rn intrinsics), so a == 1 reproduces a
// plain running sum exactly.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

template <typename T>
__device__ __forceinline__ T step(T h, T x, T a, bool gated) {
  return gated ? add_rn(mul_rn(a, h), x) : add_rn(h, x);
}

// ------------------------------------------------------------ (a) exact fold
constexpr int FOLD_THREADS = 128;
constexpr int FOLD_COLS = 32;  // columns per block: lane j of warp 0 folds column j
constexpr int FOLD_STAGES = 3;
constexpr int FOLD_AHEAD = 16;  // values a lane reads ahead of its chain

// elements per operand and stage: 48 KB of shared memory at most
template <typename T, bool GATED>
__host__ __device__ constexpr int fold_tile() {
  return (GATED && sizeof(T) == 8) ? 1024 : 2048;
}

template <typename T>
__device__ __forceinline__ void cp_async(T* dst, const T* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (sizeof(T) == 8)
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// barrier 1 among the n threads of warps 1.. (n a multiple of 32)
__device__ __forceinline__ void loaders_sync(int n) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory");
}

// One lane folds `rows` rows of its column in place, starting from h. The
// pitch is PITCH when it is known at compile time (1: the surplus prefix,
// D = 1), else `pitch`. Values are read one batch of FOLD_AHEAD rows ahead
// of the chain, into two register batches used in turn.
template <typename T, bool GATED, int PITCH>
__device__ __forceinline__ T fold_column(T* xc, const T* ac, int rows, int pitch, T h) {
  const int C = PITCH ? PITCH : pitch;
  T xa[FOLD_AHEAD], aa[FOLD_AHEAD], xb[FOLD_AHEAD], ab[FOLD_AHEAD];
  auto load = [&](T(&xv)[FOLD_AHEAD], T(&av)[FOLD_AHEAD], int r0, bool ok) {
#pragma unroll
    for (int u = 0; u < FOLD_AHEAD; ++u) {
      xv[u] = ok ? xc[(r0 + u) * C] : T(0);
      av[u] = (GATED && ok) ? ac[(r0 + u) * C] : T(1);
    }
  };
  auto run = [&](const T(&xv)[FOLD_AHEAD], const T(&av)[FOLD_AHEAD], int r0) {
#pragma unroll
    for (int u = 0; u < FOLD_AHEAD; ++u) {
      h = step(h, xv[u], av[u], GATED);
      xc[(r0 + u) * C] = h;
    }
  };
  int r = 0;
  load(xa, aa, 0, rows >= FOLD_AHEAD);
  for (; r + 2 * FOLD_AHEAD <= rows; r += 2 * FOLD_AHEAD) {
    load(xb, ab, r + FOLD_AHEAD, true);
    run(xa, aa, r);
    load(xa, aa, r + 2 * FOLD_AHEAD, r + 3 * FOLD_AHEAD <= rows);
    run(xb, ab, r + FOLD_AHEAD);
  }
  if (r + FOLD_AHEAD <= rows) {  // xa holds rows r ...
    run(xa, aa, r);
    r += FOLD_AHEAD;
  }
  for (; r < rows; ++r) {
    h = step(h, xc[r * C], GATED ? ac[r * C] : T(1), GATED);
    xc[r * C] = h;
  }
  return h;
}

template <typename T, bool GATED>
__global__ void __launch_bounds__(FOLD_THREADS)
fold_kernel(const T* __restrict__ x, const T* __restrict__ a, T* __restrict__ y,
            T* __restrict__ state, int S, int D) {
  constexpr int TILE = fold_tile<T, GATED>();
  constexpr int LT = FOLD_THREADS - 32;  // loaders: warps 1, 2, 3
  extern __shared__ __align__(16) double smem_d[];
  T* xs = reinterpret_cast<T*>(smem_d);  // FOLD_STAGES x TILE
  T* as = xs + FOLD_STAGES * TILE;       // the same for a, when gated
  const int c0 = blockIdx.x * FOLD_COLS, b = blockIdx.y;
  const int tid = threadIdx.x, lt = tid - 32;  // lt < 0: warp 0, the folder
  const int C = min(FOLD_COLS, D);  // row pitch of a tile in shared memory
  const int w = min(C, D - c0);     // this block's live columns
  const bool dense = w == D;        // a tile is one contiguous run of x and y
  const int R = TILE / C;           // rows per tile
  const int ntiles = (S + R - 1) / R;
  const size_t base = (size_t)b * S * D + c0;
  // element i of tile k: its offset in x and y, and in the tile
  auto at = [&](int k, int i, int& s) -> size_t {
    if (dense) {
      s = i;
      return base + (size_t)k * R * D + i;
    }
    const int r = i / w, c = i - r * w;
    s = r * C + c;
    return base + (size_t)(k * R + r) * D + c;
  };
  auto issue = [&](int k) {  // loaders stage tile k (an empty group past the end)
    if (k < ntiles) {
      const int n = min(R, S - k * R) * w;
      T* xd = xs + (k % FOLD_STAGES) * TILE;
      T* ad = as + (k % FOLD_STAGES) * TILE;
      for (int i = lt; i < n; i += LT) {
        int s;
        const size_t g = at(k, i, s);
        cp_async(xd + s, x + g);
        if (GATED) cp_async(ad + s, a + g);
      }
    }
    cp_commit();
  };
  auto write_out = [&](int k) {  // loaders copy folded tile k to y
    const int n = min(R, S - k * R) * w;
    const T* xt = xs + (k % FOLD_STAGES) * TILE;
    for (int i = lt; i < n; i += LT) {
      int s;
      const size_t g = at(k, i, s);
      y[g] = xt[s];
    }
  };

  // The folder issues no copy of its own: its shared-memory reads would
  // queue behind them. While it folds tile k, the loaders write tile k - 1
  // out and stage tile k + 2 into its buffer.
  if (lt >= 0)
    for (int k = 0; k < FOLD_STAGES - 1; ++k) issue(k);
  T h = T(0);
  for (int k = 0; k < ntiles; ++k) {
    if (lt >= 0) cp_wait<FOLD_STAGES - 2>();  // tile k has landed (this thread's part)
    __syncthreads();  // ... every thread's part, and tile k - 1 is folded
    if (lt < 0) {
      T* xc = xs + (k % FOLD_STAGES) * TILE + tid;
      const T* ac = as + (k % FOLD_STAGES) * TILE + tid;
      const int rows = min(R, S - k * R);
      if (tid < w) {
        if (C == 1)  // tid == 0: the tile's own start, 16-byte aligned
          h = fold_column<T, GATED, 1>(xs + (k % FOLD_STAGES) * TILE,
                                       as + (k % FOLD_STAGES) * TILE, rows, 1, h);
        else
          h = fold_column<T, GATED, 0>(xc, ac, rows, C, h);
      }
      __syncwarp();  // the warp meets the barrier converged
    } else {
      if (k > 0) write_out(k - 1);
      loaders_sync(LT);  // tile k - 1 is read out before its buffer is restaged
      issue(k + FOLD_STAGES - 1);
    }
  }
  __syncthreads();
  if (lt >= 0 && ntiles > 0) write_out(ntiles - 1);
  if (tid < w) state[(size_t)b * D + c0 + tid] = h;
}

template <typename T, bool GATED>
int launch_fold(const T* x, const T* a, T* y, T* state, int B, int S, int D,
                cudaStream_t stream) {
  const size_t smem = sizeof(T) * FOLD_STAGES * fold_tile<T, GATED>() * (GATED ? 2 : 1);
  const dim3 grid((D + FOLD_COLS - 1) / FOLD_COLS, B);
  fold_kernel<T, GATED><<<grid, FOLD_THREADS, smem, stream>>>(x, a, y, state, S, D);
  return (int)cudaGetLastError();
}

template <typename T>
int fold(const T* x, const T* a, T* y, T* state, int B, int S, int D, void* stream) {
  if ((long long)B * D == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  return a == nullptr ? launch_fold<T, false>(x, a, y, state, B, S, D, s)
                      : launch_fold<T, true>(x, a, y, state, B, S, D, s);
}

// --------------------------------------------------------- (b) chunked scan
constexpr int CHUNK_THREADS = 128;  // one column each
constexpr int CHUNK_AHEAD = 8;      // rows loaded ahead of the chain

// Fold rows [r0, r1) of column d from h (y == nullptr: keep nothing, and
// return the product of the a's in *prod).
__device__ __forceinline__ float chunk_fold(const float* __restrict__ x,
                                            const float* __restrict__ a, float* y,
                                            size_t col, int D, int r0, int r1, float h,
                                            float* prod) {
  float p = 1.f;
  int r = r0;
  for (; r + CHUNK_AHEAD <= r1; r += CHUNK_AHEAD) {
    float xv[CHUNK_AHEAD], av[CHUNK_AHEAD];
#pragma unroll
    for (int u = 0; u < CHUNK_AHEAD; ++u) {
      xv[u] = x[col + (size_t)(r + u) * D];
      av[u] = a[col + (size_t)(r + u) * D];
    }
#pragma unroll
    for (int u = 0; u < CHUNK_AHEAD; ++u) {
      h = add_rn(mul_rn(av[u], h), xv[u]);
      if (y) y[col + (size_t)(r + u) * D] = h;
      else p = mul_rn(p, av[u]);
    }
  }
  for (; r < r1; ++r) {
    const float av = a[col + (size_t)r * D];
    h = add_rn(mul_rn(av, h), x[col + (size_t)r * D]);
    if (y) y[col + (size_t)r * D] = h;
    else p = mul_rn(p, av);
  }
  if (prod) *prod = p;
  return h;
}

// pass 1: per (b, chunk, column) the chunk's fold from 0 and its a product;
// summary layout (2, B, nC, D): h first, then prod
__global__ void __launch_bounds__(CHUNK_THREADS)
chunk_summary_kernel(const float* __restrict__ x, const float* __restrict__ a,
                     float* __restrict__ summary, int B, int S, int D, int L) {
  const int d = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z, nC = gridDim.y;
  if (d >= D || c == nC - 1) return;  // the last chunk's summary is never read
  float p;
  const float h = chunk_fold(x, a, nullptr, (size_t)b * S * D + d, D, c * L,
                             min(S, (c + 1) * L), 0.f, &p);
  const size_t o = ((size_t)b * nC + c) * D + d;
  summary[o] = h;
  summary[(size_t)B * nC * D + o] = p;
}

// pass 2: carry h into the chunk, fold it again from there, write y (and
// the final state from the last chunk)
__global__ void __launch_bounds__(CHUNK_THREADS)
chunk_apply_kernel(const float* __restrict__ x, const float* __restrict__ a,
                   const float* __restrict__ summary, float* __restrict__ y,
                   float* __restrict__ state, int B, int S, int D, int L) {
  const int d = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z, nC = gridDim.y;
  if (d >= D) return;
  const size_t sb = (size_t)b * nC * D + d, plane = (size_t)B * nC * D;
  float h = 0.f;
  for (int j = 0; j < c; ++j)
    h = add_rn(mul_rn(summary[plane + sb + (size_t)j * D], h), summary[sb + (size_t)j * D]);
  h = chunk_fold(x, a, y, (size_t)b * S * D + d, D, c * L, min(S, (c + 1) * L), h,
                 nullptr);
  if (c == nC - 1) state[(size_t)b * D + d] = h;
}

// ------------------------------------------- (b') the chunked scan's backward
// K3b: for the cotangents dh of h and dfinal of the final state, the fold
// g_t = dh_t + a_{t+1} g_{t+1} from g_{S-1} = dh_{S-1} + dfinal, backwards
// over S, and dx_t = g_t, da_t = g_t h_{t-1} (h_{-1} = 0). The chunked
// forward's two passes in reverse time, a read through its index one row
// later (never a flipped copy):
//   pass 1, per (b, chunk, column): fold the chunk backwards from g = 0
//   and keep a_{r0} g_{r0} and the product of the chunk's a's: the pair
//   that carries a gradient through the chunk into the one before it;
//   pass 2: carry g in from the later chunks' pairs (from dfinal), fold the
//   chunk again from there and write dx and da = g h_{t-1} (the forward's
//   saved h read one row back) in the same pass.
// What bounds it: bytes (dh and a read twice, h once, dx and da written
// once, against a bound that reads and writes each once).

// Fold rows [r0, r1) of column col backwards from the carry g (rows past
// r1 enter through it). With dx == nullptr keep nothing and return
// a_{r0} g_{r0} and the product of the a's in *prod; else write dx and da.
__device__ __forceinline__ float chunk_fold_bwd(const float* __restrict__ dh,
                                                const float* __restrict__ a,
                                                const float* __restrict__ h, float* dx,
                                                float* da, size_t col, int D, int r0,
                                                int r1, float g, float* prod) {
  float p = 1.f, an = 1.f;  // an: a of the row after the current one
  int r = r1;
  for (; r - CHUNK_AHEAD >= r0; r -= CHUNK_AHEAD) {
    float dv[CHUNK_AHEAD], av[CHUNK_AHEAD], hv[CHUNK_AHEAD];
#pragma unroll
    for (int u = 0; u < CHUNK_AHEAD; ++u) {
      const size_t o = col + (size_t)(r - 1 - u) * D;
      dv[u] = dh[o];
      av[u] = a[o];
      hv[u] = (dx && r - 2 - u >= 0) ? h[o - D] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < CHUNK_AHEAD; ++u) {
      g = add_rn(mul_rn(an, g), dv[u]);
      if (dx) {
        const size_t o = col + (size_t)(r - 1 - u) * D;
        dx[o] = g;
        da[o] = mul_rn(g, hv[u]);
      }
      an = av[u];
      p = mul_rn(p, an);
    }
  }
  for (; r > r0; --r) {
    const size_t o = col + (size_t)(r - 1) * D;
    g = add_rn(mul_rn(an, g), dh[o]);
    if (dx) {
      dx[o] = g;
      da[o] = mul_rn(g, r - 1 > 0 ? h[o - D] : 0.f);
    }
    an = a[o];
    p = mul_rn(p, an);
  }
  if (prod) *prod = p;
  return mul_rn(an, g);
}

// pass 1: per (b, chunk, column) the pair (a_{r0} g_{r0} from 0, prod a);
// summary layout (2, B, nC, D) as the forward's
__global__ void __launch_bounds__(CHUNK_THREADS)
chunk_bwd_summary_kernel(const float* __restrict__ dh, const float* __restrict__ a,
                         float* __restrict__ summary, int B, int S, int D, int L) {
  const int d = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z, nC = gridDim.y;
  if (d >= D || c == 0) return;  // the first chunk's pair is never read
  float p;
  const float g = chunk_fold_bwd(dh, a, nullptr, nullptr, nullptr, (size_t)b * S * D + d, D,
                                 c * L, min(S, (c + 1) * L), 0.f, &p);
  const size_t o = ((size_t)b * nC + c) * D + d;
  summary[o] = g;
  summary[(size_t)B * nC * D + o] = p;
}

// pass 2: carry g into the chunk from dfinal through the later chunks'
// pairs, fold it again from there, write dx and da
__global__ void __launch_bounds__(CHUNK_THREADS)
chunk_bwd_apply_kernel(const float* __restrict__ dh, const float* __restrict__ dfinal,
                       const float* __restrict__ a, const float* __restrict__ h,
                       const float* __restrict__ summary, float* __restrict__ dx,
                       float* __restrict__ da, int B, int S, int D, int L) {
  const int d = blockIdx.x * CHUNK_THREADS + threadIdx.x;
  const int c = blockIdx.y, b = blockIdx.z, nC = gridDim.y;
  if (d >= D) return;
  const size_t sb = (size_t)b * nC * D + d, plane = (size_t)B * nC * D;
  float g = dfinal ? dfinal[(size_t)b * D + d] : 0.f;
  for (int j = nC - 1; j > c; --j)
    g = add_rn(mul_rn(summary[plane + sb + (size_t)j * D], g), summary[sb + (size_t)j * D]);
  chunk_fold_bwd(dh, a, h, dx, da, (size_t)b * S * D + d, D, c * L, min(S, (c + 1) * L), g,
                 nullptr);
}

// ------------------------------------------------------ the chain's floor
__global__ void chain_floor_kernel(double inc, int n, double* out) {
  double h = 0.0;
#pragma unroll 16
  for (int i = 0; i < n; ++i) h = __dadd_rn(h, inc);
  *out = h;
}

}  // namespace

extern "C" {

// (a): a may be NULL (a == 1)
int linear_scan_fold_f32(const float* x, const float* a, float* y, float* state, int B,
                         int S, int D, void* stream) {
  return fold<float>(x, a, y, state, B, S, D, stream);
}

int linear_scan_fold_f64(const double* x, const double* a, double* y, double* state,
                         int B, int S, int D, void* stream) {
  return fold<double>(x, a, y, state, B, S, D, stream);
}

// (b): summary is scratch of 2 * B * max(1, ceil(S / L)) * D floats; S = 0
// is one empty chunk, which writes the zero state
int linear_scan_chunked_f32(const float* x, const float* a, float* y, float* state,
                            float* summary, int B, int S, int D, int L, void* stream) {
  if ((long long)B * D == 0) return 0;
  if (L < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nC = S > 0 ? (S + L - 1) / L : 1;
  const dim3 grid((D + CHUNK_THREADS - 1) / CHUNK_THREADS, nC, B);
  if (nC > 1) {
    chunk_summary_kernel<<<grid, CHUNK_THREADS, 0, s>>>(x, a, summary, B, S, D, L);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  chunk_apply_kernel<<<grid, CHUNK_THREADS, 0, s>>>(x, a, summary, y, state, B, S, D, L);
  return (int)cudaGetLastError();
}

// (b'): K3b; dfinal may be NULL (zero); summary is scratch of 2 * B *
// max(1, ceil(S / L)) * D floats
int linear_scan_chunked_bwd_f32(const float* dh, const float* dfinal, const float* a,
                                const float* h, float* dx, float* da, float* summary, int B,
                                int S, int D, int L, void* stream) {
  if ((long long)B * D * S == 0) return 0;
  if (L < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nC = (S + L - 1) / L;
  const dim3 grid((D + CHUNK_THREADS - 1) / CHUNK_THREADS, nC, B);
  if (nC > 1) {
    chunk_bwd_summary_kernel<<<grid, CHUNK_THREADS, 0, s>>>(dh, a, summary, B, S, D, L);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  chunk_bwd_apply_kernel<<<grid, CHUNK_THREADS, 0, s>>>(dh, dfinal, a, h, summary, dx, da, B, S,
                                                        D, L);
  return (int)cudaGetLastError();
}

// one thread: h = h + inc, n times, each add waiting on the last
int linear_scan_chain_floor(double* out, double inc, int n, void* stream) {
  chain_floor_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(inc, n, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
