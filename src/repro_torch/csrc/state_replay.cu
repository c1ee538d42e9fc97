// One pass of the placement core's sequential state replay for one chunk.
//
// No Pallas counterpart: the JAX device core gets this pass from lax.scan
// inside lax.while_loop (src/repro/core/jax_core.py, `state_fn`, the edge
// horizon scan at :537-559 and the CIL container-pool scan at :584-606). Under
// a speculated decision vector `guess` (policy-view codes: -1 = no state
// effect, 0..nc-1 = a cloud config, edge_col = the nominated edge device) it
// replays, row by row and in float64 with adds, max, compares and gathers only:
//
//   * the edge FIFO busy horizons: with least-predicted-wait nominations the
//     first-min argmin over max(h - now, 0) picks the device and a row placed on
//     the edge pushes it (h[d] = max(h[d], now) + comp); with fixed
//     nominations (round robin, random, one device) only the push remains;
//   * the CIL container pool of every cloud config: per row the config's
//     "no idle container" flag (cold), and for a row placed on the config the
//     most-recently-used idle container (first max of `last` over idle slots)
//     or, when none is idle, a cold start into slot `cnt` (overflow when the
//     pool is full: the caller grows the pool and replays).
//
// Design: the pools of different configs and the edge horizons never interact
// given `guess`, so each runs in its own block of one warp: block c < nc owns
// config c's (busy, last) pool in shared memory (cap x 16 B; 8 KB at cap 512),
// block nc the edge horizons. Rows stream through in tiles of 32 (one coalesced
// load per lane, broadcast with shuffles), the pool scan is split over the 32
// lanes and reduced with warp shuffles, so the row loop has no block barrier.
//
// What bounds it on the H100: latency. A chunk is one sequential problem of R
// dependent steps per block; at R = 65,536 the pass is a chain of ~65k warp
// reductions and the rest of the card idles. Bytes (tens of MB) and operations
// are far below the card's rates. The pool must fit one block's shared memory
// (up to 227 KB, cap <= 14,000 slots); the wrapper raises above that.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;

__device__ void cil_block(int c, const double* __restrict__ nows,
                          const int* __restrict__ guess, int R, int nc, int cap,
                          double t_idl, const double* __restrict__ occw,
                          const double* __restrict__ occc, const double* __restrict__ busy0,
                          const double* __restrict__ last0, const int* __restrict__ cnt0,
                          unsigned char* __restrict__ cold, double* __restrict__ busyF,
                          double* __restrict__ lastF, int* __restrict__ cntF,
                          int* __restrict__ ovf_out, double* smem) {
  const int lane = threadIdx.x;
  double* busy = smem;
  double* last = smem + cap;
  for (int j = lane; j < cap; j += kWarp) {
    busy[j] = busy0[(size_t)c * cap + j];
    last[j] = last0[(size_t)c * cap + j];
  }
  __syncwarp();
  int cnt = cnt0[c];
  int ovf = 0;
  for (int r0 = 0; r0 < R; r0 += kWarp) {
    const int r = r0 + lane;
    const bool live = r < R;
    const double my_now = live ? nows[r] : 0.0;
    const int my_g = live ? guess[r] : -1;
    const double my_w = (live && my_g == c) ? occw[(size_t)r * nc + c] : 0.0;
    const double my_c = (live && my_g == c) ? occc[(size_t)r * nc + c] : 0.0;
    unsigned char my_cold = 0;
    const int rows = min(kWarp, R - r0);
    for (int i = 0; i < rows; ++i) {
      const double now = __shfl_sync(kFull, my_now, i);
      const int g = __shfl_sync(kFull, my_g, i);
      // idle scan: busy <= now <= last + t_idl, first max of `last` per lane
      double bl = -CUDART_INF;
      int bj = cap;
      bool idle_any = false;
      for (int j = lane; j < cnt; j += kWarp) {
        const double b = busy[j], l = last[j];
        if (b <= now && now <= __dadd_rn(l, t_idl)) {
          idle_any = true;
          if (l > bl) {
            bl = l;
            bj = j;
          }
        }
      }
      const bool cold_row = __ballot_sync(kFull, idle_any) == 0u;
      if (lane == i) my_cold = cold_row ? 1 : 0;
      if (g != c) continue;  // uniform across the warp
      const double w = __shfl_sync(kFull, my_w, i);
      const double cc = __shfl_sync(kFull, my_c, i);
      int j;
      if (cold_row) {
        j = cnt;
      } else {
        for (int off = kWarp / 2; off > 0; off >>= 1) {
          const double ol = __shfl_down_sync(kFull, bl, off);
          const int oj = __shfl_down_sync(kFull, bj, off);
          if (ol > bl || (ol == bl && oj < bj)) {
            bl = ol;
            bj = oj;
          }
        }
        j = __shfl_sync(kFull, bj, 0);
      }
      if (cold_row && j >= cap) {
        ovf = 1;  // pool full: no write, the caller grows the pool and replays
      } else {
        const double completion = __dadd_rn(now, cold_row ? cc : w);
        if (lane == 0) {
          busy[j] = completion;
          last[j] = completion;
        }
        if (cold_row) ++cnt;
      }
      __syncwarp();
    }
    if (live) cold[(size_t)r * nc + c] = my_cold;
  }
  __syncwarp();
  for (int j = lane; j < cap; j += kWarp) {
    busyF[(size_t)c * cap + j] = busy[j];
    lastF[(size_t)c * cap + j] = last[j];
  }
  if (lane == 0) {
    cntF[c] = cnt;
    ovf_out[c] = ovf;
  }
}

__device__ void edge_block(const double* __restrict__ nows, const int* __restrict__ guess,
                           int R, int nd, int lpw, int edge_col,
                           const double* __restrict__ ecomp, const double* __restrict__ h0,
                           const int* __restrict__ nom_fixed, double* __restrict__ hb,
                           int* __restrict__ nom, double* __restrict__ h_fin,
                           double* smem) {
  const int lane = threadIdx.x;
  double* h = smem;                 // (nd,)
  double* s_now = h + nd;           // (32,)
  double* s_ec = s_now + kWarp;     // (32, nd)
  int* s_g = reinterpret_cast<int*>(s_ec + kWarp * nd);  // (32,)
  int* s_nf = s_g + kWarp;                              // (32,)
  for (int d = lane; d < nd; d += kWarp) h[d] = h0[d];
  for (int r0 = 0; r0 < R; r0 += kWarp) {
    const int rows = min(kWarp, R - r0);
    __syncwarp();
    if (lane < rows) {
      s_now[lane] = nows[r0 + lane];
      s_g[lane] = guess[r0 + lane];
      s_nf[lane] = lpw ? 0 : nom_fixed[r0 + lane];
    }
    for (int k = lane; k < rows * nd; k += kWarp) s_ec[k] = ecomp[(size_t)r0 * nd + k];
    __syncwarp();
    if (lane == 0) {
      for (int i = 0; i < rows; ++i) {
        const double now = s_now[i];
        const size_t r = (size_t)(r0 + i);
        int best;
        if (lpw) {
          best = 0;
          double bw = fmax(__dsub_rn(h[0], now), 0.0);
          for (int d = 1; d < nd; ++d) {
            const double w = fmax(__dsub_rn(h[d], now), 0.0);
            if (w < bw) {
              bw = w;
              best = d;
            }
          }
        } else {
          best = s_nf[i];
        }
        for (int d = 0; d < nd; ++d) hb[r * nd + d] = h[d];
        nom[r] = best;
        if (s_g[i] == edge_col) h[best] = __dadd_rn(fmax(h[best], now), s_ec[i * nd + best]);
      }
    }
  }
  __syncwarp();
  for (int d = lane; d < nd; d += kWarp) h_fin[d] = h[d];
}

__global__ void state_replay_kernel(
    const double* nows, const int* guess, int R,
    int nd, int lpw, int edge_col, const double* ecomp, const double* h0,
    const int* nom_fixed, double* hb, int* nom, double* h_fin,
    int nc, int cap, double t_idl, const double* occw, const double* occc,
    const double* busy0, const double* last0, const int* cnt0, unsigned char* cold,
    double* busyF, double* lastF, int* cntF, int* ovf) {
  extern __shared__ __align__(16) double smem_d[];
  if ((int)blockIdx.x < nc) {
    cil_block(blockIdx.x, nows, guess, R, nc, cap, t_idl, occw, occc, busy0, last0, cnt0,
              cold, busyF, lastF, cntF, ovf, smem_d);
  } else {
    edge_block(nows, guess, R, nd, lpw, edge_col, ecomp, h0, nom_fixed, hb, nom, h_fin,
               smem_d);
  }
}

// ---------------------------------------------------------------------------
// The sequential decision walk: the numpy core's scalar walk
// (src/repro/core/decision.py, DecisionEngine._cw_scalar_rows) on the card.
// Where the replay above follows a speculated decision vector, the walk
// DECIDES each row from the exact state left by the rows before it — LPW
// nomination, warm/cold per config, Alg. 1 budget, the policy's masked
// lexicographic minimum — and applies its effects, so its codes are the
// sequential trajectory itself. The placement core takes them as the chunk's
// decisions and verifies them with one replay pass (a speculated fixed point
// from a frozen-state guess needs up to R+1 passes on oscillating streams).
//
// What bounds it on the H100: the R-step dependent chain (one block; the
// rest of the card idles), whose every step is a few dependent shared-memory
// loads (~39 cycles each), float64 compares and warp collectives (redux.sync
// ~47 cycles) and one block barrier. The design keeps device memory, all but
// one block barrier and the pool scans off that chain:
//
//   * warp 0 decides, all its lanes running the same straight-line code: the
//     balancer nomination, then config `lane`'s warm/cold flag (lane t
//     merges config t's scan parts; one ballot gathers the flags), then the
//     policy's masked lexicographic minimum over the
//     targets, unrolled to a compile-time bound on the configs (NCM: 4, 8 or
//     32) with every load issued ahead of the compare chain, and compares
//     combined bitwise so that they stay predicated. It reads each row's
//     inputs (nows, the five (R, nc) latency/cost/occupancy columns,
//     elat/ecomp, nom_fixed) from a shared-memory ring that warp 1, the
//     producer, fills with cp.async tiles of TR rows, WALK_STAGES tiles deep
//     (TR = walk_ring_rows, a power of two read by shift and mask), well
//     ahead of the row being
//     decided, and writes its codes to shared memory, which the producer
//     copies out a tile at a time. Warp w runs on SMSP w % 4: warps 4, 8, ...
//     only pass the barrier, so the decider has its SMSP to itself;
//   * the other warps scan the pools, up to WALK_MAX_SPLIT warps a config
//     (walk_split), each over every S-th run of 32 slots. In the step where
//     row k is decided they apply row k-1's dispatch to their pool and scan
//     it for row k+1 at nows[k+1]: the first maximum of `last` over idle
//     slots (busy <= now <= last + t_idl) and the runner-up, as
//     order-preserving 64-bit keys of `last` (-0 read as +0, so key order
//     and ties are those of the doubles), each part reduced across its warp
//     with redux.sync. The loads of four slots are issued ahead of their
//     compares, and each slot is read and written by one thread only, so
//     applying a dispatch needs no warp sync;
//   * row k changes at most slot j of one pool, so in step k+1 the decider
//     patches row k+1's scan (taken before row k's dispatch) with slot j's
//     new (busy, last): the runner-up stands in when j was the maximum, and
//     slot j competes with its new key and index. This is the first maximum
//     by index of the whole pool, as `torch.argmax` over the masked `last`
//     gives it in the plain version;
//   * scan results and dispatches are double-buffered by row parity, so the
//     decider's row k and the scanners' row k+1 cross in one block barrier.
//
// `state_walk_chain_floor` times the chain's floor alone: one block of the
// walk's warp count, R steps of one barrier and a float64 that one thread
// writes to shared memory and every warp reads and folds.

constexpr int WALK_STAGES = 3;
constexpr long long WALK_RING_BUDGET = 96 * 1024;  // bytes of the input ring
// Warp w runs on SMSP w % 4. Warp 0 decides and runs alone on its SMSP (warps
// 4, 8, ... only pass the barrier), so no other code competes for its
// instruction cache; warp 1 stages the ring; the other warps scan pools.
constexpr int WALK_MAX_WARPS = 24;
constexpr int WALK_MAX_SCANNERS = WALK_MAX_WARPS - 2 - (WALK_MAX_WARPS - 1) / 4;  // 17
constexpr int WALK_MAX_SPLIT = 2;  // warps scanning one pool (2 beat 1 and 4 on the card)
constexpr unsigned kNoSlot = 0xffffffffu;

__host__ __device__ inline long long walk_row_bytes(int nd, int nc) {
  return 8LL * (1 + 5LL * nc + 2LL * nd) + 4;
}

// rows of a ring tile: the largest of 64, 32, ..., 2 whose stages fit the budget
__host__ __device__ inline int walk_ring_rows(int nd, int nc) {
  int tr = 64;
  while (tr > 2 && WALK_STAGES * tr * walk_row_bytes(nd, nc) > WALK_RING_BUDGET) tr >>= 1;
  return tr;
}

// scanner groups (one per config, two configs a group above
// WALK_MAX_SCANNERS = 17) and the warps that split each group's pool scan
// (up to WALK_MAX_SPLIT = 2, 17 scanner warps at most)
__host__ __device__ inline int walk_scanners(int nc) {
  return nc < WALK_MAX_SCANNERS ? nc : WALK_MAX_SCANNERS;
}

__host__ __device__ inline int walk_split(int nc) {
  const int s = nc > 0 ? WALK_MAX_SCANNERS / nc : 1;
  return s < 1 ? 1 : (s > WALK_MAX_SPLIT ? WALK_MAX_SPLIT : s);
}

// scanner index of warp w (w >= 2, w % 4 != 0), and the warps a block needs
// for `scanners` of them
__host__ __device__ inline int walk_scanner_of(int w) { return w - 2 - (w - 1) / 4; }

__host__ __device__ inline int walk_block_warps(int nc) {
  const int need = walk_scanners(nc) * walk_split(nc);
  int W = 2;
  while (walk_scanner_of(W) < need) ++W;  // warps 0 .. W-1 hold `need` scanners
  return W;
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// a key whose unsigned order is the order of the doubles; -0 is read as +0,
// so equal doubles have equal keys. 0 is below every double's key: no slot.
__device__ __forceinline__ unsigned long long okey(double x) {
  const long long u = __double_as_longlong(__dadd_rn(x, 0.0));
  return u < 0 ? ~(unsigned long long)u : ((unsigned long long)u | 0x8000000000000000ull);
}

// the warp's largest key and, among the lanes that hold it, the least slot
__device__ __forceinline__ void warp_first_max(unsigned long long key, unsigned j,
                                               unsigned long long& K, unsigned& J) {
  const unsigned hi = (unsigned)(key >> 32), lo = (unsigned)key;
  const unsigned H = __reduce_max_sync(kFull, hi);
  const unsigned L = __reduce_max_sync(kFull, hi == H ? lo : 0u);
  J = __reduce_min_sync(kFull, (hi == H && lo == L) ? j : kNoSlot);
  K = ((unsigned long long)H << 32) | L;
}

template <int NCM>
__global__ void __launch_bounds__(WALK_MAX_WARPS * 32) state_walk_kernel(
    const double* __restrict__ nows, int R, int n, int nd, int lpw,
    const double* __restrict__ ecomp, const double* __restrict__ elat,
    const double* __restrict__ h0, const int* __restrict__ nom_fixed, int nc,
    int cap, double t_idl, const double* __restrict__ latw,
    const double* __restrict__ latc, const double* __restrict__ costc,
    const double* __restrict__ occw, const double* __restrict__ occc,
    const double* __restrict__ busy0, const double* __restrict__ last0,
    const int* __restrict__ cnt0, int minlat, double c_max, double alpha,
    const double* __restrict__ s0, double deadline, int* __restrict__ code,
    int* __restrict__ ovf_out) {
  extern __shared__ __align__(16) double sm[];
  const int tid = threadIdx.x, lane = tid % kWarp, w = tid / kWarp;
  const int NS = walk_scanners(nc), S = walk_split(nc);
  // rows of a ring tile, a power of two: row r is entry r & (TR - 1) of
  // tile r >> TRS
  const int TR = walk_ring_rows(nd, nc), TRS = __ffs(TR) - 1;
  const int SD = TR * (1 + 5 * nc + 2 * nd);  // doubles of one ring stage
  double* busy = sm;                          // (nc, cap)
  double* last = busy + (size_t)nc * cap;     // (nc, cap)
  double* h = last + (size_t)nc * cap;        // (nd,) edge horizons
  double* ring = h + nd;                      // (WALK_STAGES, SD)
  double* d_comp = ring + (size_t)WALK_STAGES * SD;  // [2] dispatched completion
  // scan results [2][nc][S][best, runner-up]: keys, then slots
  unsigned long long* res_k = reinterpret_cast<unsigned long long*>(d_comp + 2);
  int* ring_nf = reinterpret_cast<int*>(res_k + 4 * nc * S);  // (WALK_STAGES, TR)
  unsigned* res_j = reinterpret_cast<unsigned*>(ring_nf + WALK_STAGES * TR);
  int* d_cj = reinterpret_cast<int*>(res_j + 4 * nc * S);  // [2][config, slot]
  int* s_code = d_cj + 4;                          // (WALK_STAGES, TR) decided codes

  // a ring stage: now[TR], latw, latc, costc, occw, occc [TR * nc] each,
  // elat, ecomp [TR * nd] each
  auto stage_of = [&](int r) { return ring + (size_t)((r >> TRS) % WALK_STAGES) * SD; };
  auto issue = [&](int t) {  // producer warp: tile t's rows into its stage
    const int r0 = t * TR, rows = min(r0 + TR, n) - r0;
    if (rows <= 0) return;
    double* sb = ring + (size_t)(t % WALK_STAGES) * SD;
    int* nb = ring_nf + (t % WALK_STAGES) * TR;
    for (int i = lane; i < rows; i += kWarp) {
      cp_async8(sb + i, nows + r0 + i);
      if (nd > 0 && !lpw) cp_async4(nb + i, nom_fixed + r0 + i);
    }
    const double* cols[5] = {latw, latc, costc, occw, occc};
    for (int x = 0; x < 5 && nc > 0; ++x)
      for (int i = lane; i < rows * nc; i += kWarp)
        cp_async8(sb + TR + (size_t)x * TR * nc + i, cols[x] + (size_t)r0 * nc + i);
    const double* ecols[2] = {elat, ecomp};
    for (int x = 0; x < 2 && nd > 0; ++x)
      for (int i = lane; i < rows * nd; i += kWarp)
        cp_async8(sb + TR + (size_t)5 * TR * nc + (size_t)x * TR * nd + i,
                  ecols[x] + (size_t)r0 * nd + i);
  };
  auto flush = [&](int t) {  // producer warp: tile t's decided codes out
    const int r0 = t * TR, rows = min(r0 + TR, n) - r0;
    const int* cb = s_code + (t % WALK_STAGES) * TR;
    for (int i = lane; i < rows; i += kWarp) code[r0 + i] = cb[i];
  };

  for (int i = tid; i < nc * cap; i += blockDim.x) {
    busy[i] = busy0[i];
    last[i] = last0[i];
  }
  for (int i = tid; i < nd; i += blockDim.x) h[i] = h0[i];
  for (int r = n + tid; r < R; r += blockDim.x) code[r] = -1;  // pad rows
  if (w == 1) {
    for (int t = 0; t < WALK_STAGES - 1; ++t) {
      issue(t);
      cp_commit();
    }
    cp_wait<WALK_STAGES - 2>();  // tile 0 has landed
  }

  // scanner warp sw: part `sub` of group g's configs g and g + NS; it scans
  // slots sub * 32 + lane + 32 S i; cntr: the configs' live-slot counts
  const bool idle = w > 0 && (w & 3) == 0;  // keeps SMSP 0 to the decider
  const int sw = walk_scanner_of(w), g = sw / S, sub = sw - g * S;
  const bool scanner = !idle && w >= 2 && g < NS;
  int cntr[2] = {0, 0};
  if (scanner) {
    for (int ci = 0; ci < 2; ++ci)
      if (g + ci * NS < nc) cntr[ci] = cnt0[g + ci * NS];
  }
  // row r's scan of part `sub` of config c's pool as it stands
  auto scan = [&](int c, int cnt, int r) {
    const int o = (((r & 1) * nc + c) * S + sub) * 2;  // this part's result
    if (cnt == 0) {  // an empty pool: no idle slot
      if (lane == 0) {
        res_k[o] = res_k[o + 1] = 0;
        res_j[o] = res_j[o + 1] = kNoSlot;
      }
      return;
    }
    const double now = stage_of(r)[r & (TR - 1)];
    const double* b = busy + (size_t)c * cap;
    const double* l = last + (size_t)c * cap;
    unsigned long long k1 = 0, k2 = 0;
    unsigned j1 = kNoSlot, j2 = kNoSlot;
    // four slots a batch, their loads issued ahead of the compares
    const int stride = kWarp * S;
    for (int j0 = sub * kWarp + lane; j0 < cnt; j0 += 4 * stride) {
      double bj[4], lj[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u * stride;
        bj[u] = j < cnt ? b[j] : CUDART_INF;
        lj[u] = j < cnt ? l[j] : -CUDART_INF;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const bool idle = (bj[u] <= now) & (now <= __dadd_rn(lj[u], t_idl));
        const unsigned long long key = idle ? okey(lj[u]) : 0ull;
        // ascending j: a later equal key ranks after
        const bool first = key > k1, second = !first & (key > k2);
        const unsigned j = (unsigned)(j0 + u * stride);
        k2 = first ? k1 : (second ? key : k2);
        j2 = first ? j1 : (second ? j : j2);
        k1 = first ? key : k1;
        j1 = first ? j : j1;
      }
    }
    unsigned long long K1, K2 = 0;
    unsigned J1, J2 = kNoSlot;
    warp_first_max(k1, j1, K1, J1);
    if (K1 != 0) {  // warp-uniform: the runner-up, the winner's lane offering its second
      const bool own = (J1 % kWarp) == (unsigned)lane;
      warp_first_max(own ? k2 : k1, own ? j2 : j1, K2, J2);
    }
    if (lane == 0) {
      res_k[o] = K1;
      res_k[o + 1] = K2;
      res_j[o] = J1;
      res_j[o + 1] = J2;
    }
  };
  __syncthreads();
  if (scanner && n > 0) {
    for (int ci = 0; ci < 2; ++ci)
      if (g + ci * NS < nc) scan(g + ci * NS, cntr[ci], 0);
  }
  __syncthreads();

  // the deciding warp: lane t holds target t (and t + 32, the edge when
  // nc = 32) and config t's slot count; s, the surplus, is the same in
  // every lane
  const int T = nc + (nd > 0 ? 1 : 0);
  const int edge_col = nd > 0 ? T - 1 : -1;
  double s = minlat ? s0[0] : 0.0;
  unsigned ovf = 0;
  int dcnt = (w == 0 && lane < nc) ? cnt0[lane] : 0;
  int pc = -1, pj = -1;  // the last dispatch: config, slot, completion
  double pcomp = 0.0;
  for (int k = 0; k < n; ++k) {
    if (w == 0) {
      const double* sb = stage_of(k);
      const int off = k & (TR - 1);
      const double now = sb[off];
      const double* rlatw = sb + TR + (size_t)off * nc;
      const double* rlatc = rlatw + (size_t)TR * nc;
      const double* rcost = rlatc + (size_t)TR * nc;
      const double* roccw = rcost + (size_t)TR * nc;
      const double* roccc = roccw + (size_t)TR * nc;
      const double* relat = sb + TR + (size_t)5 * TR * nc + (size_t)off * nd;
      const double* recomp = relat + (size_t)TR * nd;
      // balancer nomination: the first device of least predicted wait
      int d = 0;
      double wait = 0.0;
      if (nd > 0) {
        if (lpw) {
          wait = fmax(__dsub_rn(h[0], now), 0.0);
#pragma unroll
          for (int e = 1; e < 4; ++e) {  // straight-line for small fleets
            const double we = fmax(__dsub_rn(h[e < nd ? e : 0], now), 0.0);
            const bool less = (e < nd) & (we < wait);
            d = less ? e : d;
            wait = less ? we : wait;
          }
          for (int e = 4; e < nd; ++e) {
            const double we = fmax(__dsub_rn(h[e], now), 0.0);
            d = we < wait ? e : d;
            wait = we < wait ? we : wait;
          }
        } else {
          d = ring_nf[((k >> TRS) % WALK_STAGES) * TR + off];
          wait = fmax(__dsub_rn(h[d], now), 0.0);
        }
      }
      const double edge_lat = nd > 0 ? __dadd_rn(wait, relat[d]) : 0.0;
      // config `lane`: warm/cold from row k's scan, with row k-1's dispatch
      // patched in
      const int buf = k & 1;
      // the S parts' (best, runner-up) pairs merged by (key desc, slot asc),
      // all loads issued ahead, compares bitwise (no branches)
      const int o = (buf * nc + (lane < nc ? lane : 0)) * S * 2;
      unsigned long long KA = res_k[o], KB = res_k[o + 1];
      unsigned JA = res_j[o], JB = res_j[o + 1];
      unsigned long long pk[2 * (WALK_MAX_SPLIT - 1)];
      unsigned pj2[2 * (WALK_MAX_SPLIT - 1)];
#pragma unroll
      for (int i = 0; i < 2 * (WALK_MAX_SPLIT - 1); ++i) {
        const int q = 2 + i < 2 * S ? o + 2 + i : o;
        pk[i] = res_k[q];
        pj2[i] = res_j[q];
      }
#pragma unroll
      for (int i = 0; i < 2 * (WALK_MAX_SPLIT - 1); ++i) {
        const unsigned long long kq = pk[i];
        const unsigned jq = pj2[i];
        const bool live = 2 + i < 2 * S;
        const bool a = live & ((kq > KA) | ((kq == KA) & (jq < JA)));
        const bool b = live & !a & ((kq > KB) | ((kq == KB) & (jq < JB)));
        KB = a ? KA : (b ? kq : KB);
        JB = a ? JA : (b ? jq : JB);
        KA = a ? kq : KA;
        JA = a ? jq : JA;
      }
      if (lane == pc) {  // slot pj changed: its old value drops out, its new one competes
        if (JA == (unsigned)pj) {
          KA = KB;
          JA = JB;
        }
        if (pcomp <= now && now <= __dadd_rn(pcomp, t_idl)) {
          const unsigned long long kc = okey(pcomp);
          if (kc > KA || (kc == KA && (unsigned)pj < JA)) {
            KA = kc;
            JA = (unsigned)pj;
          }
        }
      }
      const unsigned coldm = __ballot_sync(kFull, lane < nc && KA == 0);
      // the policy's masked lexicographic minimum over the targets, the same
      // in every lane: configs unrolled to NCM (loads at clamped indices, all
      // issued ahead of the compare chain), then the edge, target nc
      const double allowed = minlat ? __dadd_rn(c_max, __dmul_rn(alpha, s)) : 0.0;
      int best = -1;
      double best_lat = 0.0, best_cost = 0.0;
      auto consider = [&](int t, double lat, double cost, bool feas) {
        // bitwise, not short-circuit: predicated code, no branches
        const bool better = feas & ((best < 0) |
            (minlat ? ((lat < best_lat) | ((lat == best_lat) & (cost < best_cost)))
                    : ((cost < best_cost) | ((cost == best_cost) & (lat < best_lat)))));
        best = better ? t : best;
        best_lat = better ? lat : best_lat;
        best_cost = better ? cost : best_cost;
      };
#pragma unroll
      for (int t = 0; t < NCM; ++t) {
        const int tc = t < nc ? t : 0;
        const double lat = (coldm >> tc) & 1u ? rlatc[tc] : rlatw[tc];
        const double cost = rcost[tc];
        consider(t, lat, cost, (t < nc) & (minlat ? cost <= allowed : lat <= deadline));
      }
      if (nd > 0) consider(nc, edge_lat, 0.0, minlat ? 0.0 <= allowed : edge_lat <= deadline);
      if (best < 0) {
        if (edge_col >= 0) {
          best = edge_col;  // MinLatency's fallback set / MinCost's edge queue
          best_cost = 0.0;
        } else {            // MinLatency without an edge: every target
#pragma unroll
          for (int t = 0; t < NCM; ++t) {
            const int tc = t < nc ? t : 0;
            const double lat = (coldm >> tc) & 1u ? rlatc[tc] : rlatw[tc];
            const double cost = rcost[tc];
            const bool better = (t < nc) & ((best < 0) | (lat < best_lat) |
                                            ((lat == best_lat) & (cost < best_cost)));
            best = better ? t : best;
            best_lat = better ? lat : best_lat;
            best_cost = better ? cost : best_cost;
          }
        }
      }
      if (minlat) s = __dadd_rn(s, __dsub_rn(c_max, best_cost));
      pc = -1;
      pj = -1;
      if (best >= 0 && best == edge_col) {
        if (lane == 0) h[d] = __dadd_rn(fmax(h[d], now), recomp[d]);
      } else if (best >= 0) {
        const bool cold = (coldm >> best) & 1u;
        const double comp = __dadd_rn(now, cold ? roccc[best] : roccw[best]);
        int j;
        if (cold) {  // a cold start into slot cnt
          j = __shfl_sync(kFull, dcnt, best);
          if (j >= cap) {
            ovf |= 1u << best;  // pool full: no write, the caller grows the pool
            j = -1;
          } else if (lane == best) {
            dcnt = j + 1;
          }
        } else {
          j = (int)__shfl_sync(kFull, JA, best);
        }
        if (j >= 0) {
          pc = best;
          pj = j;
          pcomp = comp;
        }
      }
      if (lane == 0) {
        s_code[((k >> TRS) % WALK_STAGES) * TR + off] = best;
        d_cj[buf * 2] = pc;
        d_cj[buf * 2 + 1] = pj;
        d_comp[buf] = pcomp;
      }
    } else if (w == 1) {
      if ((k & (TR - 1)) == 0) {  // tile t's rows are being decided: tile t + 2 in flight
        issue((k >> TRS) + WALK_STAGES - 1);
        cp_commit();
        if (k > 0) flush((k >> TRS) - 1);  // tile t - 1 is decided
        cp_wait<WALK_STAGES - 2>();    // tile t + 1 has landed
      }
    } else if (scanner) {
      if (k > 0) {  // row k-1's dispatch: the thread that scans slot dj writes it
        // (each slot is read and written by one thread only: no warp sync)
        const int o = ((k - 1) & 1) * 2;
        const int dc = d_cj[o], dj = d_cj[o + 1];
        for (int ci = 0; ci < 2; ++ci) {
          const int c = g + ci * NS;
          if (c < nc && c == dc && dj >= 0) {
            if (lane == dj % kWarp && sub == (dj / kWarp) % S) {
              const double dcomp = d_comp[(k - 1) & 1];
              busy[(size_t)c * cap + dj] = dcomp;
              last[(size_t)c * cap + dj] = dcomp;
            }
            if (dj == cntr[ci]) ++cntr[ci];
          }
        }
      }
      if (k + 1 < n) {
        for (int ci = 0; ci < 2; ++ci)
          if (g + ci * NS < nc) scan(g + ci * NS, cntr[ci], k + 1);
      }
    }
    __syncthreads();
  }
  if (w == 1) {
    if (n > 0) flush((n - 1) >> TRS);
    cp_wait<0>();
  }
  if (tid == 0)
    for (int c = 0; c < nc; ++c) ovf_out[c] = (ovf >> c) & 1u;
}

using WalkKernel = decltype(&state_walk_kernel<4>);

// the instantiation for the least of 4, 8, 32 configs that covers nc
WalkKernel walk_kernel(int nc) {
  return nc <= 4 ? state_walk_kernel<4> : (nc <= 8 ? state_walk_kernel<8> : state_walk_kernel<32>);
}

__global__ void walk_chain_floor_kernel(double inc, int R, double* out) {
  __shared__ double x[2];
  const int tid = threadIdx.x, lane = tid % kWarp, w = tid / kWarp;
  if (tid == 0) x[1] = 0.0;
  __syncthreads();
  double acc = 0.0;
  for (int r = 0; r < R; ++r) {
    if (tid == 0) x[r & 1] = __dadd_rn(x[(r + 1) & 1], inc);  // the previous step's value
    __syncthreads();
    acc = __dadd_rn(acc, x[r & 1]);
  }
  if (lane == 0) out[1 + w] = acc;
  if (tid == 0) out[0] = x[(R + 1) & 1];
}

}  // namespace

extern "C" {

// Shared memory of the walk's one block: the pools, the edge horizons, the
// input ring (walk_ring_rows), the double-buffered scan results of every
// part of every pool and the dispatches, the ring of decided codes.
long long state_walk_smem_bytes(int nd, int nc, int cap) {
  const long long TR = walk_ring_rows(nd, nc), S = walk_split(nc);
  const long long doubles = 2LL * nc * cap + nd + WALK_STAGES * TR * (1 + 5LL * nc + 2LL * nd) + 2;
  const long long keys = 4LL * nc * S;
  const long long ints = 2 * WALK_STAGES * TR + 4LL * nc * S + 4;
  return 8 * (doubles + keys) + 4 * ints;
}

int state_walk_f64(const double* nows, int R, int n, int nd, int lpw, const double* ecomp,
                   const double* elat, const double* h0, const int* nom_fixed, int nc, int cap,
                   double t_idl, const double* latw, const double* latc, const double* costc,
                   const double* occw, const double* occc, const double* busy0,
                   const double* last0, const int* cnt0, int minlat, double c_max, double alpha,
                   const double* s0, double deadline, int* code, int* ovf, void* stream) {
  if (R == 0) return 0;
  if (nc > 32) return (int)cudaErrorInvalidValue;  // the decider's config masks
  const long long bytes = state_walk_smem_bytes(nd, nc, cap);
  const WalkKernel kernel = walk_kernel(nc);
  if (bytes > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = kWarp * walk_block_warps(nc);
  kernel<<<1, threads, (size_t)bytes, (cudaStream_t)stream>>>(
      nows, R, n, nd, lpw, ecomp, elat, h0, nom_fixed, nc, cap, t_idl, latw, latc, costc,
      occw, occc, busy0, last0, cnt0, minlat, c_max, alpha, s0, deadline, code, ovf);
  return (int)cudaGetLastError();
}

// The walk's launch as state_walk_f64 makes it, for the host's mirror of it
// to be held against: out[0] warps of the block, out[1] rows of a ring tile,
// out[2] warps scanning each pool, out[3] bytes of shared memory.
int state_walk_layout(int nd, int nc, int cap, long long* out) {
  out[0] = walk_block_warps(nc);
  out[1] = walk_ring_rows(nd, nc);
  out[2] = walk_split(nc);
  out[3] = state_walk_smem_bytes(nd, nc, cap);
  return 0;
}

// The walk's chain floor: one block of `warps` warps through R steps of one
// barrier and a float64 handed from one thread to every warp. out: 1 + warps
// doubles (thread 0's running sum R x inc, then each warp's fold).
int state_walk_chain_floor(double* out, double inc, int R, int warps, void* stream) {
  if (warps < 1 || warps > 32) return (int)cudaErrorInvalidValue;
  walk_chain_floor_kernel<<<1, kWarp * warps, 0, (cudaStream_t)stream>>>(inc, R, out);
  return (int)cudaGetLastError();
}

// Shared memory one block needs: the larger of a config pool and the edge tile.
long long state_replay_smem_bytes(int nd, int nc, int cap) {
  const long long pool = nc > 0 ? 2LL * cap * (long long)sizeof(double) : 0;
  const long long edge =
      nd > 0 ? (long long)(nd + kWarp + kWarp * nd) * sizeof(double) + 2LL * kWarp * sizeof(int)
             : 0;
  return pool > edge ? pool : edge;
}

int state_replay_f64(const double* nows, const int* guess, int R, int nd, int lpw,
                     int edge_col, const double* ecomp, const double* h0,
                     const int* nom_fixed, double* hb, int* nom, double* h_fin, int nc,
                     int cap, double t_idl, const double* occw, const double* occc,
                     const double* busy0, const double* last0, const int* cnt0,
                     unsigned char* cold, double* busyF, double* lastF, int* cntF, int* ovf,
                     void* stream) {
  const int blocks = nc + (nd > 0 ? 1 : 0);
  if (blocks == 0 || R == 0) return 0;
  const long long bytes = state_replay_smem_bytes(nd, nc, cap);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(state_replay_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  state_replay_kernel<<<blocks, kWarp, (size_t)bytes, (cudaStream_t)stream>>>(
      nows, guess, R, nd, lpw, edge_col, ecomp, h0, nom_fixed, hb, nom, h_fin, nc, cap,
      t_idl, occw, occc, busy0, last0, cnt0, cold, busyF, lastF, cntF, ovf);
  return (int)cudaGetLastError();
}

}  // extern "C"
