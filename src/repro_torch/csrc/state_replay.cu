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
// One block: warp c < nc owns config c's pool in shared memory and scans it
// (as in cil_block); thread 0 decides the row and updates the surplus and
// edge horizons; the owner warp of a chosen config records the dispatch.
// Two block barriers per row: latency-bound, like the replay.
__global__ void state_walk_kernel(
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
  double* busy = sm;                          // (nc, cap)
  double* last = busy + (size_t)nc * cap;     // (nc, cap)
  double* h = last + (size_t)nc * cap;        // (nd,)
  double* s_comp = h + nd;                    // completion of the row's dispatch
  int* s_cnt = reinterpret_cast<int*>(s_comp + 1);  // (nc,)
  int* s_cold = s_cnt + nc;                   // (nc,) no idle container
  int* s_j = s_cold + nc;                     // (nc,) MRU idle slot
  int* s_dec = s_j + nc;                      // [chosen config or -1, slot]
  for (int i = tid; i < nc * cap; i += blockDim.x) {
    busy[i] = busy0[i];
    last[i] = last0[i];
  }
  for (int i = tid; i < nd; i += blockDim.x) h[i] = h0[i];
  for (int i = tid; i < nc; i += blockDim.x) s_cnt[i] = cnt0[i];
  for (int r = n + tid; r < R; r += blockDim.x) code[r] = -1;  // pad rows
  __syncthreads();
  const int T = nc + (nd > 0 ? 1 : 0);
  const int edge_col = nd > 0 ? T - 1 : -1;
  double s = minlat ? s0[0] : 0.0;
  int ovf = 0;
  for (int r = 0; r < n; ++r) {
    const double now = nows[r];
    if (w < nc) {  // warm/cold scan of config w's pool before row r
      const double* b = busy + (size_t)w * cap;
      const double* l = last + (size_t)w * cap;
      double bl = -CUDART_INF;
      int bj = cap;
      bool idle_any = false;
      const int cnt = s_cnt[w];
      for (int j = lane; j < cnt; j += kWarp) {
        if (b[j] <= now && now <= __dadd_rn(l[j], t_idl)) {
          idle_any = true;
          if (l[j] > bl) {
            bl = l[j];
            bj = j;
          }
        }
      }
      for (int off = kWarp / 2; off > 0; off >>= 1) {
        const double ol = __shfl_down_sync(kFull, bl, off);
        const int oj = __shfl_down_sync(kFull, bj, off);
        if (ol > bl || (ol == bl && oj < bj)) {
          bl = ol;
          bj = oj;
        }
      }
      const bool any = __ballot_sync(kFull, idle_any) != 0u;
      if (lane == 0) {
        s_cold[w] = any ? 0 : 1;
        s_j[w] = bj;
      }
    }
    __syncthreads();
    if (tid == 0) {
      // balancer nomination and the nominated device's predicted wait
      int d = 0;
      double wait = 0.0;
      if (nd > 0) {
        if (lpw) {
          wait = fmax(__dsub_rn(h[0], now), 0.0);
          for (int k = 1; k < nd; ++k) {
            const double wk = fmax(__dsub_rn(h[k], now), 0.0);
            if (wk < wait) {
              wait = wk;
              d = k;
            }
          }
        } else {
          d = nom_fixed[r];
          wait = fmax(__dsub_rn(h[d], now), 0.0);
        }
      }
      const size_t rc = (size_t)r * nc;
      const double allowed = minlat ? __dadd_rn(c_max, __dmul_rn(alpha, s)) : 0.0;
      int best = -1;
      double best_lat = 0.0, best_cost = 0.0;
      for (int t = 0; t < T; ++t) {
        double lat, cost;
        if (t < nc) {
          lat = s_cold[t] ? latc[rc + t] : latw[rc + t];
          cost = costc[rc + t];
        } else {
          lat = __dadd_rn(wait, elat[(size_t)r * nd + d]);
          cost = 0.0;
        }
        const bool feas = minlat ? cost <= allowed : lat <= deadline;
        if (!feas) continue;
        const bool better = best < 0 ||
            (minlat ? (lat < best_lat || (lat == best_lat && cost < best_cost))
                    : (cost < best_cost || (cost == best_cost && lat < best_lat)));
        if (better) {
          best = t;
          best_lat = lat;
          best_cost = cost;
        }
      }
      if (best < 0) {
        if (edge_col >= 0) {
          best = edge_col;  // MinLatency's fallback set / MinCost's edge queue
          best_cost = 0.0;
        } else {            // MinLatency without an edge: every target
          for (int t = 0; t < T; ++t) {
            const double lat = s_cold[t] ? latc[rc + t] : latw[rc + t];
            const double cost = costc[rc + t];
            if (best < 0 || lat < best_lat || (lat == best_lat && cost < best_cost)) {
              best = t;
              best_lat = lat;
              best_cost = cost;
            }
          }
        }
      }
      if (minlat) s = __dadd_rn(s, __dsub_rn(c_max, best_cost));
      code[r] = best;
      s_dec[0] = -1;
      if (best == edge_col) {
        h[d] = __dadd_rn(fmax(h[d], now), ecomp[(size_t)r * nd + d]);
      } else {
        const bool cold = s_cold[best] != 0;
        s_dec[0] = best;
        s_dec[1] = cold ? -1 : s_j[best];
        s_comp[0] = __dadd_rn(now, cold ? occc[rc + best] : occw[rc + best]);
      }
    }
    __syncthreads();
    if (w < nc && w == s_dec[0] && lane == 0) {
      int j = s_dec[1];
      if (j < 0) {  // cold start into slot cnt
        j = s_cnt[w];
        if (j >= cap) {
          ovf = 1;  // pool full: the caller grows the pool and re-runs
          j = -1;
        } else {
          s_cnt[w] = j + 1;
        }
      }
      if (j >= 0) {
        busy[(size_t)w * cap + j] = s_comp[0];
        last[(size_t)w * cap + j] = s_comp[0];
      }
    }
    __syncwarp();
  }
  if (lane == 0 && w < nc) ovf_out[w] = ovf;
}

}  // namespace

extern "C" {

long long state_walk_smem_bytes(int nd, int nc, int cap) {
  return (long long)(2LL * nc * cap + nd + 1) * sizeof(double) + (3LL * nc + 2) * sizeof(int);
}

int state_walk_f64(const double* nows, int R, int n, int nd, int lpw, const double* ecomp,
                   const double* elat, const double* h0, const int* nom_fixed, int nc, int cap,
                   double t_idl, const double* latw, const double* latc, const double* costc,
                   const double* occw, const double* occc, const double* busy0,
                   const double* last0, const int* cnt0, int minlat, double c_max, double alpha,
                   const double* s0, double deadline, int* code, int* ovf, void* stream) {
  if (R == 0) return 0;
  const long long bytes = state_walk_smem_bytes(nd, nc, cap);
  if (bytes > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(state_walk_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = kWarp * (nc > 0 ? nc : 1);
  state_walk_kernel<<<1, threads, (size_t)bytes, (cudaStream_t)stream>>>(
      nows, R, n, nd, lpw, ecomp, elat, h0, nom_fixed, nc, cap, t_idl, latw, latc, costc,
      occw, occc, busy0, last0, cnt0, minlat, c_max, alpha, s0, deadline, code, ovf);
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
