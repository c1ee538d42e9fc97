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
//     pool is full: no write, the caller grows the pool and replays).
//
// What bounds it on the H100: latency. Given `guess` the pools of different
// configs and the edge horizons never interact, but each is a chain of
// dependent steps, one block per chain (block c < nc: config c's pool; block
// nc: the edge horizons), and the rest of the card idles. Bytes (tens of MB)
// and operations are far below the card's rates. The design keeps on each
// chain only the rows that change its state:
//
//   * a config's pool changes only on that config's own dispatch rows. The
//     chunk streams through in segments of `replay_ring_rows` rows; while the
//     block works on one segment, its producer warp (warp 1) stages the next
//     (nows and codes with cp.async, then a ballot for guess == c compacts
//     the dispatch rows into a list, their (occw, occc) gathered with
//     cp.async beside it). The other warps then step through the segment's
//     dispatches only, one named barrier (the producer stays out of it) a
//     dispatch;
//   * in the step of dispatch k the REPLAY_SPLIT scanner warps (warp 0 and
//     warp 2) rank their parts of the pool at dispatch k's `now`: the
//     first maximum of `last` over idle slots (busy <= now <= last + t_idl),
//     as order-preserving keys, reduced across each warp with redux.sync.
//     Past the barrier every warp merges the parts and applies the dispatch
//     (the same decision in every warp, so no second barrier), and the
//     thread that scans the chosen slot writes it. Each slot is read in
//     scans and written by that one thread only, so the pool needs no
//     double buffer and no patch;
//   * the cold flags of the other rows come off the chain: between two
//     dispatches the pool is fixed, so in step k the gap warps flag the rows
//     between dispatches k-1 and k against the pool after dispatch k-1, a
//     warp a row, in parallel over rows. They take dispatch k-1's slot from
//     (pj, pcomp) with a predicated load that skips it, since its writer
//     may still be storing it;
//   * the edge block's chain thread keeps the horizons in registers
//     (unrolled to a compile-time bound on nd: 4 or 32; larger fleets keep
//     them in shared memory) and steps through the edge rows only, the next
//     row's inputs loaded while one is applied, writing the horizons after
//     each into a snapshot list. `hb` and `nom` of every row follow from the
//     snapshot of the edge rows before it, since h is constant between two
//     edge rows: writer warps fill them in parallel for the previous segment
//     while the producer stages the next.
//
// A design with a separate chain warp, whose scanners rank the pool one
// dispatch ahead (best and runner-up) and whose chain patches that with the
// slot the previous dispatch changed, took longer on the card (PERF.md): its
// runner-up doubles the reductions of a scan, and the scan, not the chain,
// is the longer of the two.
//
// This code shares nothing with the decision walk below but the copy and key
// helpers: on the main path the replay is the walk's only check.
// `state_replay_chain_floor` times one named-barrier hand-off a dispatch.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <map>
#include <mutex>
#include <utility>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarp = 32;

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

// ------------------------------------------------------------------ replay
constexpr int REPLAY_MAX_ROWS = 1024;                  // rows of a segment at most
constexpr long long REPLAY_EDGE_BUDGET = 128 * 1024;   // the edge block's 3 segment buffers
constexpr int REPLAY_GAP_WARPS = 4;                    // warps flagging the rows between dispatches
constexpr int REPLAY_SPLIT = 2;  // scanner warps of one pool (2 beat 1 and 4 on the card: PERF.md)
constexpr int kNone = 0x7fffffff;                      // no slot

// Shared-memory layouts, in bytes from the block's base; the host mirrors
// them (kernels/state_replay/kernel.py).
struct PoolLayout {  // a config block
  long long wcc, now, key, g, list, nd, slot, total;
};

__host__ __device__ inline PoolLayout pool_layout(int cap, int seg) {
  constexpr int split = REPLAY_SPLIT;
  PoolLayout L;
  long long o = 16LL * cap;                    // the pool: (busy, last) per slot
  L.wcc = o;   o += 2LL * seg * 16;            // [2][seg] (occw, occc) of the dispatches
  L.now = o;   o += 2LL * seg * 8;             // [2][seg] nows
  L.key = o;   o += 2LL * split * 8;           // [2][split] the scan parts' best keys
  L.g = o;     o += 2LL * seg * 4;             // [2][seg] staged codes
  L.list = o;  o += 2LL * seg * 4;             // [2][seg] the dispatch rows
  L.nd = o;    o += 2 * 4;                     // [2] dispatches of the segment
  L.slot = o;  o += 2LL * split * 4;           // [2][split] their slots
  L.total = o;
  return L;
}

struct EdgeLayout {  // the edge block: three buffers of each
  long long now, ec, snap, g, nf, list, cntb, nd, total;
};

__host__ __device__ inline EdgeLayout edge_layout(int nd, int seg) {
  EdgeLayout L;
  long long o = 0;
  L.now = o;   o += 3LL * seg * 8;             // nows
  L.ec = o;    o += 3LL * seg * nd * 8;        // ecomp rows
  L.snap = o;  o += 3LL * (seg + 1) * nd * 8;  // horizons before the segment and after each edge row
  L.g = o;     o += 3LL * seg * 4;             // staged codes
  L.nf = o;    o += 3LL * seg * 4;             // fixed nominations
  L.list = o;  o += 3LL * seg * 4;             // the edge rows
  L.cntb = o;  o += 3LL * seg * 4;             // edge rows before each row
  L.nd = o;    o += 3 * 4;                     // edge rows of the segment
  L.total = o;
  return L;
}

// rows of a segment: the largest power of two up to REPLAY_MAX_ROWS whose edge
// buffers fit REPLAY_EDGE_BUDGET
__host__ __device__ inline int replay_ring_rows(int nd) {
  int seg = REPLAY_MAX_ROWS;
  while (seg > 1 && edge_layout(nd, seg).total > REPLAY_EDGE_BUDGET) seg >>= 1;
  return seg;
}

// warps of a block: the scanners (warp 0 and warp 2), the producer (warp 1),
// the gap warps
constexpr int REPLAY_WARPS = 1 + REPLAY_SPLIT + REPLAY_GAP_WARPS;

__host__ __device__ inline long long replay_smem(int nd, int nc, int cap) {
  const int seg = replay_ring_rows(nd);
  const long long pool = nc > 0 ? pool_layout(cap, seg).total : 0;
  const long long edge = nd > 0 ? edge_layout(nd, seg).total : 0;
  return pool > edge ? pool : edge;
}

struct ReplayArgs {
  const double* nows;
  const int* guess;
  int R, nd, lpw, edge_col;
  const double* ecomp;
  const double* h0;
  const int* nom_fixed;
  double* hb;
  int* nom;
  double* h_fin;
  int nc, cap;
  double t_idl;
  const double* occw;
  const double* occc;
  const double* busy0;
  const double* last0;
  const int* cnt0;
  unsigned char* cold;
  double* busyF;
  double* lastF;
  int* cntF;
  int* ovf;
  const int* skip;  // when any of its nskip flags is set the pass writes nothing
  int nskip, seg;
};

__device__ __forceinline__ void group_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" ::"r"(threads) : "memory");
}

// slot j of the pool as a gap warp sees it in a step: slot `pj` (the last
// dispatch's) is `pcomp` and is not loaded (its scanning thread may still be
// writing it); slots at or past `cnt` are never idle
__device__ __forceinline__ void view_slot(const double2* pool, int j, int cnt, int pj,
                                          double pcomp, double& busy, double& last) {
  const bool load = (j < cnt) & (j != pj);
  busy = j == pj ? pcomp : CUDART_INF;
  last = j == pj ? pcomp : -CUDART_INF;
  const unsigned a = (unsigned)__cvta_generic_to_shared(pool + (j < cnt ? j : 0));
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.u32 p, %3, 0;\n @p ld.shared.v2.f64 {%0, %1}, [%2];\n}\n"
      : "+d"(busy), "+d"(last)
      : "r"(a), "r"((unsigned)load));
}

// (key, slot) ranks above (K, J): a larger key, or the same key at a smaller slot
__device__ __forceinline__ bool ranks_above(unsigned long long key, int j,
                                            unsigned long long K, int J) {
  return (key > K) | ((key == K) & (j < J));
}

// the warp's best (key, slot) pair: the largest key, then the smallest slot
__device__ __forceinline__ void warp_best(unsigned long long key, int j, unsigned long long& K,
                                          int& J) {
  const unsigned hi = __reduce_max_sync(kFull, (unsigned)(key >> 32));
  const unsigned lo = __reduce_max_sync(kFull, (unsigned)(key >> 32) == hi ? (unsigned)key : 0u);
  K = ((unsigned long long)hi << 32) | lo;
  J = (int)__reduce_min_sync(kFull, key == K ? (unsigned)j : (unsigned)kNone);
}

// A scanner warp's part of the pool at `now`: the first maximum of `last`
// over the idle slots among part * 32 + lane + 32 * REPLAY_SPLIT * i, as
// (key, slot).
// A slot is only ever written by the thread that scans it (the last
// dispatch's included), so the loads need no patch; each lane walks its own
// live slots only, the next slot's load in flight while one is ranked, by
// `last` as a double (slots ascending: an equal value keeps the first).
__device__ __forceinline__ void scan_part(const double2* pool, int cnt, double now,
                                          double t_idl, int part, int lane,
                                          unsigned long long& K, int& J) {
  constexpr int stride = kWarp * REPLAY_SPLIT;
  double best = -CUDART_INF;  // an idle slot's `last` is never -inf (now <= last + t_idl)
  int jb = kNone;
  int j = part * kWarp + lane;
  double2 v = j < cnt ? pool[j] : make_double2(0.0, 0.0);
  for (; j < cnt; j += stride) {
    const double2 vn = j + stride < cnt ? pool[j + stride] : v;
    const bool up = (v.x <= now) & (now <= __dadd_rn(v.y, t_idl)) & (v.y > best);
    best = up ? v.y : best;
    jb = up ? j : jb;
    v = vn;
  }
  warp_best(jb != kNone ? okey(best) : 0ull, jb, K, J);
}

// any slot of the pool idle at `now` (a warp, 32 slots a step)
__device__ __forceinline__ bool any_idle(const double2* pool, int cnt, int pj, double pcomp,
                                         double now, double t_idl, int lane) {
  for (int j0 = 0; j0 < cnt; j0 += kWarp) {
    double b, l;
    view_slot(pool, j0 + lane, cnt, pj, pcomp, b, l);
    if (__any_sync(kFull, (b <= now) & (now <= __dadd_rn(l, t_idl)))) return true;
  }
  return false;
}

__device__ void replay_pool_block(const int c, const ReplayArgs& a, unsigned char* sm) {
  constexpr int S = REPLAY_SPLIT;
  const int tid = threadIdx.x, lane = tid % kWarp, w = tid / kWarp;
  const int SEG = a.seg, cap = a.cap, nc = a.nc, R = a.R;
  const PoolLayout L = pool_layout(cap, SEG);
  double2* pool = reinterpret_cast<double2*>(sm);
  double2* wcc = reinterpret_cast<double2*>(sm + L.wcc);
  double* snow = reinterpret_cast<double*>(sm + L.now);
  unsigned long long* rkey = reinterpret_cast<unsigned long long*>(sm + L.key);
  int* sg = reinterpret_cast<int*>(sm + L.g);
  int* list = reinterpret_cast<int*>(sm + L.list);
  int* nD = reinterpret_cast<int*>(sm + L.nd);
  int* rslot = reinterpret_cast<int*>(sm + L.slot);
  const int group = (int)blockDim.x - kWarp;  // threads of the step group: all but the producer
  const int G = (int)blockDim.x / kWarp - 1 - S;
  // warp 0 and warp 2 scan parts 0 and 1; warps 3 .. flag the gaps
  const int part = w == 0 ? 0 : w - 1;
  const bool scanner = w != 1 && part < S;

  // producer warp: segment s's nows and codes, then its dispatch list
  auto stage = [&](int s) {
    const int b = s & 1, r0 = s * SEG, n = min(SEG, R - r0);
    double* nw = snow + (size_t)b * SEG;
    int* g = sg + (size_t)b * SEG;
    int* lst = list + (size_t)b * SEG;
    double2* oc = wcc + (size_t)b * SEG;
    for (int i = lane; i < n; i += kWarp) {
      cp_async8(nw + i, a.nows + r0 + i);
      cp_async4(g + i, a.guess + r0 + i);
    }
    cp_commit();
    cp_wait<0>();
    __syncwarp();
    int base = 0;
    for (int t = 0; t < n; t += kWarp) {
      const int i = t + lane;
      const bool mine = (i < n) && g[i] == c;
      const unsigned m = __ballot_sync(kFull, mine);
      if (mine) {
        const int at = base + __popc(m & ((1u << lane) - 1u));
        lst[at] = i;
        const size_t src = (size_t)(r0 + i) * nc + c;
        cp_async8(&oc[at].x, a.occw + src);
        cp_async8(&oc[at].y, a.occc + src);
      }
      base += __popc(m);
    }
    if (lane == 0) nD[b] = base;
    cp_commit();
    cp_wait<0>();
  };

  for (int i = tid; i < cap; i += blockDim.x)
    pool[i] = make_double2(a.busy0[(size_t)c * cap + i], a.last0[(size_t)c * cap + i]);
  int cnt = a.cnt0[c];  // every warp of the step group tracks the live-slot count
  int ovf = 0;
  const int nseg = (R + SEG - 1) / SEG;
  if (w == 1) stage(0);
  __syncthreads();

  for (int s = 0; s < nseg; ++s) {
    if (w == 1) {
      if (s + 1 < nseg) stage(s + 1);
      __syncthreads();
      continue;
    }
    const int b = s & 1, r0 = s * SEG, n = min(SEG, R - r0), D = nD[b];
    const double* nw = snow + (size_t)b * SEG;
    const int* lst = list + (size_t)b * SEG;
    const double2* oc = wcc + (size_t)b * SEG;
    // the previous dispatch (slot or -1, completion): the array has it only
    // in the thread that owns its slot, every other reader takes it from here
    int pj = -1;
    double pcomp = 0.0;
    // dispatch k's row, now and (occw, occc), loaded a step ahead, and the
    // next dispatch's row and now, two steps ahead (the scan waits on now)
    int row = D > 0 ? lst[0] : 0;
    double now = D > 0 ? nw[row] : 0.0;
    double2 o = D > 0 ? oc[0] : make_double2(0.0, 0.0);
    int row_n = D > 1 ? lst[1] : 0;
    double now_n = D > 1 ? nw[row_n] : 0.0;
    // Step k: the scanners rank the pool after dispatch k-1 at dispatch k's
    // now, the gap warps flag the rows between dispatches k-1 and k against
    // it; past the barrier every warp merges the parts and applies dispatch k
    for (int k = 0; k <= D; ++k) {
      if (scanner) {
        if (k < D) {
          unsigned long long K;
          int J;
          scan_part(pool, cnt, now, a.t_idl, part, lane, K, J);
          if (lane == 0) {
            rkey[(k & 1) * S + part] = K;
            rslot[(k & 1) * S + part] = J;
          }
        }
      } else {
        const int lo = k > 0 ? lst[k - 1] + 1 : 0, hi = k < D ? lst[k] : n;
        for (int i = lo + (w - 1 - S); i < hi; i += G) {
          const bool any = any_idle(pool, cnt, pj, pcomp, nw[i], a.t_idl, lane);
          if (lane == 0) a.cold[(size_t)(r0 + i) * nc + c] = any ? 0 : 1;
        }
      }
      group_sync(group);
      if (k == D) break;
      // dispatch k, the same in every warp of the group
      unsigned long long KA = rkey[(k & 1) * S];
      int JA = rslot[(k & 1) * S];
#pragma unroll
      for (int q = 1; q < S; ++q) {
        const unsigned long long kq = rkey[(k & 1) * S + q];
        const int jq = rslot[(k & 1) * S + q];
        const bool up = ranks_above(kq, jq, KA, JA);
        KA = up ? kq : KA;
        JA = up ? jq : JA;
      }
      const bool cold = KA == 0;
      int j = cold ? cnt : JA;
      if (cold) {
        if (j >= cap) {
          ovf = 1;  // pool full: no write, the caller grows the pool and replays
          j = -1;
        } else {
          ++cnt;
        }
      }
      const double comp = __dadd_rn(now, cold ? o.y : o.x);
      if (w == 0 && lane == 0) a.cold[(size_t)(r0 + row) * nc + c] = cold ? 1 : 0;
      // the slot's scanning thread writes it (and alone ever loads it in a
      // scan); the gap warps take it from (pj, pcomp) until the next barrier
      if (j >= 0 && scanner && lane == j % kWarp && part == (j / kWarp) % S)
        pool[j] = make_double2(comp, comp);
      pj = j;
      pcomp = comp;
      if (k + 1 < D) {
        row = row_n;
        now = now_n;
        o = oc[k + 1];
      }
      if (k + 2 < D) {
        row_n = lst[k + 2];
        now_n = nw[row_n];
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < cap; i += blockDim.x) {
    const double2 v = pool[i];
    a.busyF[(size_t)c * cap + i] = v.x;
    a.lastF[(size_t)c * cap + i] = v.y;
  }
  if (tid == 0) {
    a.cntF[c] = cnt;
    a.ovf[c] = ovf;
  }
}

// first device of least max(h - now, 0)
__device__ __forceinline__ int least_wait(const double* h, int nd, double now) {
  int best = 0;
  double bw = fmax(__dsub_rn(h[0], now), 0.0);
  for (int d = 1; d < nd; ++d) {
    const double wd = fmax(__dsub_rn(h[d], now), 0.0);
    if (wd < bw) {
      bw = wd;
      best = d;
    }
  }
  return best;
}

// NDM > 0: the horizons in registers, loops unrolled to NDM >= nd; NDM == 0:
// in the snapshot list itself (any nd)
template <int NDM>
__device__ void replay_edge_block(const ReplayArgs& a, unsigned char* sm) {
  const int tid = threadIdx.x, lane = tid % kWarp, w = tid / kWarp;
  const int SEG = a.seg, nd = a.nd, R = a.R;
  const EdgeLayout L = edge_layout(nd, SEG);
  double* enow = reinterpret_cast<double*>(sm + L.now);
  double* eec = reinterpret_cast<double*>(sm + L.ec);
  double* esnap = reinterpret_cast<double*>(sm + L.snap);
  int* eg = reinterpret_cast<int*>(sm + L.g);
  int* enf = reinterpret_cast<int*>(sm + L.nf);
  int* elist = reinterpret_cast<int*>(sm + L.list);
  int* ecntb = reinterpret_cast<int*>(sm + L.cntb);
  int* enD = reinterpret_cast<int*>(sm + L.nd);
  const int nseg = (R + SEG - 1) / SEG;

  double h[NDM > 0 ? NDM : 1];
#pragma unroll
  for (int d = 0; d < (NDM > 0 ? NDM : 1); ++d) h[d] = (NDM > 0 && d < nd) ? a.h0[d] : 0.0;

  for (int s = -1; s <= nseg; ++s) {
    if (w == 1 && s + 1 < nseg) {  // producer: stage segment s + 1
      const int t = s + 1, b = t % 3, r0 = t * SEG, n = min(SEG, R - r0);
      double* nw = enow + (size_t)b * SEG;
      int* g = eg + (size_t)b * SEG;
      int* nf = enf + (size_t)b * SEG;
      double* ec = eec + (size_t)b * SEG * nd;
      for (int i = lane; i < n; i += kWarp) {
        cp_async8(nw + i, a.nows + r0 + i);
        cp_async4(g + i, a.guess + r0 + i);
        if (!a.lpw) cp_async4(nf + i, a.nom_fixed + r0 + i);
      }
      for (int i = lane; i < n * nd; i += kWarp) cp_async8(ec + i, a.ecomp + (size_t)r0 * nd + i);
      cp_commit();
      cp_wait<0>();
      __syncwarp();
      int* lst = elist + (size_t)b * SEG;
      int* cb = ecntb + (size_t)b * SEG;
      int base = 0;
      for (int t0 = 0; t0 < n; t0 += kWarp) {
        const int i = t0 + lane;
        const bool edge = (i < n) && g[i] == a.edge_col;
        const unsigned m = __ballot_sync(kFull, edge);
        const int before = base + __popc(m & ((1u << lane) - 1u));
        if (i < n) cb[i] = before;
        if (edge) lst[before] = i;
        base += __popc(m);
      }
      if (lane == 0) enD[b] = base;
    } else if (w == 0 && s >= 0 && s < nseg) {  // the chain: segment s's edge rows
      if (lane == 0) {
        const int b = s % 3, D = enD[b];
        const double* nw = enow + (size_t)b * SEG;
        const double* ec = eec + (size_t)b * SEG * nd;
        const int* nf = enf + (size_t)b * SEG;
        const int* lst = elist + (size_t)b * SEG;
        double* sn = esnap + (size_t)b * (SEG + 1) * nd;
        if constexpr (NDM > 0) {
#pragma unroll
          for (int d = 0; d < NDM; ++d)
            if (d < nd) sn[d] = h[d];
          // row i's inputs are loaded while row i - 1 is applied
          int r = D > 0 ? lst[0] : 0;
          double now = D > 0 ? nw[r] : 0.0;
          double e[NDM];
#pragma unroll
          for (int d = 0; d < NDM; ++d) e[d] = (D > 0 && d < nd) ? ec[(size_t)r * nd + d] : 0.0;
          int fixed = (D > 0 && !a.lpw) ? nf[r] : 0;
          for (int i = 0; i < D; ++i) {
            const int rn = lst[i + 1 < D ? i + 1 : i];
            const double nown = nw[rn];
            double en[NDM];
#pragma unroll
            for (int d = 0; d < NDM; ++d) en[d] = d < nd ? ec[(size_t)rn * nd + d] : 0.0;
            const int fixedn = a.lpw ? 0 : nf[rn];
            int nom = fixed;
            if (a.lpw) {
              nom = 0;
              double bw = fmax(__dsub_rn(h[0], now), 0.0);
#pragma unroll
              for (int d = 1; d < NDM; ++d) {
                const double wd = fmax(__dsub_rn(h[d], now), 0.0);
                const bool less = (d < nd) & (wd < bw);
                nom = less ? d : nom;
                bw = less ? wd : bw;
              }
            }
            double hn = h[0], ev = e[0];
#pragma unroll
            for (int d = 1; d < NDM; ++d) {
              hn = d == nom ? h[d] : hn;
              ev = d == nom ? e[d] : ev;
            }
            const double v = __dadd_rn(fmax(hn, now), ev);
            double* out = sn + (size_t)(i + 1) * nd;
#pragma unroll
            for (int d = 0; d < NDM; ++d) {
              h[d] = d == nom ? v : h[d];
              if (d < nd) out[d] = h[d];
            }
            now = nown;
#pragma unroll
            for (int d = 0; d < NDM; ++d) e[d] = en[d];
            fixed = fixedn;
          }
        } else {
          if (s == 0)
            for (int d = 0; d < nd; ++d) sn[d] = a.h0[d];
          else  // the last snapshot of the previous segment
            for (int d = 0; d < nd; ++d)
              sn[d] = esnap[(size_t)((s - 1) % 3) * (SEG + 1) * nd +
                            (size_t)enD[(s - 1) % 3] * nd + d];
          for (int i = 0; i < D; ++i) {
            const int r = lst[i];
            const double now = nw[r];
            const double* prev = sn + (size_t)i * nd;
            double* out = sn + (size_t)(i + 1) * nd;
            const int nom = a.lpw ? least_wait(prev, nd, now) : nf[r];
            for (int d = 0; d < nd; ++d) out[d] = prev[d];
            out[nom] = __dadd_rn(fmax(prev[nom], now), ec[(size_t)r * nd + nom]);
          }
        }
      }
    } else if (w >= 2 && s >= 1) {  // writers: hb and nom of segment s - 1
      const int t = s - 1, b = t % 3, r0 = t * SEG, n = min(SEG, R - r0);
      const int wt = tid - 2 * kWarp, nwt = (int)blockDim.x - 2 * kWarp;
      const double* nw = enow + (size_t)b * SEG;
      const int* nf = enf + (size_t)b * SEG;
      const int* cb = ecntb + (size_t)b * SEG;
      const double* sn = esnap + (size_t)b * (SEG + 1) * nd;
      for (int e = wt; e < n * nd; e += nwt) {
        const int i = e / nd, d = e - i * nd;
        a.hb[(size_t)r0 * nd + e] = sn[(size_t)cb[i] * nd + d];
      }
      for (int i = wt; i < n; i += nwt)
        a.nom[r0 + i] = a.lpw ? least_wait(sn + (size_t)cb[i] * nd, nd, nw[i]) : nf[i];
    }
    __syncthreads();
  }
  if (tid == 0) {
    if constexpr (NDM > 0) {
#pragma unroll
      for (int d = 0; d < NDM; ++d)
        if (d < nd) a.h_fin[d] = h[d];
    } else {
      const int b = (nseg - 1) % 3;
      for (int d = 0; d < nd; ++d)
        a.h_fin[d] = esnap[(size_t)b * (SEG + 1) * nd + (size_t)enD[b] * nd + d];
    }
  }
}

template <int NDM>
__global__ void __launch_bounds__(kWarp * REPLAY_WARPS) state_replay_kernel(ReplayArgs a) {
  extern __shared__ __align__(16) unsigned char rsm[];
  // a pass the caller will discard (the walk that made `guess` overflowed a
  // pool): every thread reads the same flags, so the whole block returns
  if (a.nskip > 0) {
    const int lane = threadIdx.x % kWarp;
    int any = 0;
    for (int i = lane; i < a.nskip; i += kWarp) any |= a.skip[i];
    if (__any_sync(kFull, any != 0)) return;
  }
  if ((int)blockIdx.x < a.nc)
    replay_pool_block(blockIdx.x, a, rsm);
  else
    replay_edge_block<NDM>(a, rsm);
}

using ReplayKernel = decltype(&state_replay_kernel<4>);

// the instantiation for the fleet (horizons in registers up to 32 devices)
ReplayKernel replay_kernel(int nd) {
  return nd <= 4 ? state_replay_kernel<4> : (nd <= 32 ? state_replay_kernel<32> : state_replay_kernel<0>);
}

// the replay's chain floor: `steps` hand-offs of a float64 from one thread to
// every warp of a group, one named barrier each (as the config blocks' chain
// crosses one a dispatch)
__global__ void replay_chain_floor_kernel(double inc, int steps, double* out) {
  __shared__ double v[2];
  const int tid = threadIdx.x, w = tid / kWarp;
  if (tid == 0) v[0] = v[1] = 0.0;
  __syncthreads();
  double fold = 0.0;
  for (int k = 0; k < steps; ++k) {
    if (tid == 0) v[k & 1] = __dadd_rn(v[(k & 1) ^ 1], inc);
    group_sync(blockDim.x);
    fold = __dadd_rn(fold, v[k & 1]);
  }
  if (tid % kWarp == 0) out[1 + w] = fold;
  if (tid == 0) out[0] = v[(steps - 1) & 1];
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

// Let `kernel` take `bytes` of dynamic shared memory. The limit belongs to the
// function and is shared by every host thread, so it is raised once per device
// to all the device allows and never set to one launch's size: shards and
// planner candidates launch at their own sizes from several threads at once,
// and a launch must not find the limit lowered under its size by another one.
template <typename K>
int opt_in_smem(K kernel, long long bytes) {
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
  return bytes > it->second ? (int)cudaErrorInvalidValue : 0;
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
  const int e = opt_in_smem(kernel, bytes);
  if (e) return e;
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

// Shared memory of one replay block: the larger of a config block's
// (pool_layout) and the edge block's (edge_layout).
long long state_replay_smem_bytes(int nd, int nc, int cap) { return replay_smem(nd, nc, cap); }

int state_replay_f64(const double* nows, const int* guess, int R, int nd, int lpw,
                     int edge_col, const double* ecomp, const double* h0,
                     const int* nom_fixed, double* hb, int* nom, double* h_fin, int nc,
                     int cap, double t_idl, const double* occw, const double* occc,
                     const double* busy0, const double* last0, const int* cnt0,
                     unsigned char* cold, double* busyF, double* lastF, int* cntF, int* ovf,
                     const int* skip, int nskip, void* stream) {
  const int blocks = nc + (nd > 0 ? 1 : 0);
  if (blocks == 0 || R == 0) return 0;
  const ReplayArgs a{nows,  guess, R,     nd,    lpw,   edge_col, ecomp, h0,   nom_fixed,
                     hb,    nom,   h_fin, nc,    cap,   t_idl,    occw,  occc, busy0,
                     last0, cnt0,  cold,  busyF, lastF, cntF,     ovf,   skip, skip ? nskip : 0,
                     replay_ring_rows(nd)};
  const long long bytes = replay_smem(nd, nc, cap);
  const ReplayKernel kernel = replay_kernel(nd);
  const int e = opt_in_smem(kernel, bytes);
  if (e) return e;
  kernel<<<blocks, kWarp * REPLAY_WARPS, (size_t)bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The replay's launch as state_replay_f64 makes it, for the host's mirror of
// it to be held against: out[0] warps of a block, out[1] rows of a segment,
// out[2] scanner warps of a pool, out[3] bytes of shared memory.
int state_replay_layout(int nd, int nc, int cap, long long* out) {
  out[0] = REPLAY_WARPS;
  out[1] = replay_ring_rows(nd);
  out[2] = REPLAY_SPLIT;
  out[3] = replay_smem(nd, nc, cap);
  return 0;
}

// The replay's chain floor: one block of `warps` warps through `steps`
// named-barrier hand-offs of a float64. out: 1 + warps doubles (thread 0's
// running sum steps x inc, then each warp's fold).
int state_replay_chain_floor(double* out, double inc, int steps, int warps, void* stream) {
  if (warps < 1 || warps > 32 || steps < 1) return (int)cudaErrorInvalidValue;
  replay_chain_floor_kernel<<<1, kWarp * warps, 0, (cudaStream_t)stream>>>(inc, steps, out);
  return (int)cudaGetLastError();
}

}  // extern "C"
