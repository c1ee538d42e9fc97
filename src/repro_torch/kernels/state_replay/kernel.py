"""State-replay kernel: CUDA launch wrapper and its plain version.

One pass of the placement core's sequential state replay for one chunk (see
``repro_torch/csrc/state_replay.cu`` for the recurrences and the design).
Given the speculated policy-view codes ``guess`` (R,) — ``-1`` no state
effect, ``0..nc-1`` a cloud config, ``edge_col`` the nominated edge device —
it returns, per row, the edge horizons before the row (``hb`` (R, nd)), the
nominated device (``nom``), the per-config cold flags (``cold`` (R, nc)),
and the final state: horizons ``h_fin`` (nd,), pools ``busy``/``last``
(nc, cap), live-slot counts ``cnt`` (nc,) and per-config ``overflow`` (nc,)
(a cold start found its pool full; the caller grows the pool and replays).
Its kernel runs one block per config pool and one for the edge horizons;
each block's chain holds only the rows that change its state (the config's
dispatch rows, the edge rows), and the other rows' flags and horizons are
filled in parallel beside it.

``state_walk`` is the sequential decision walk over the same state: it
DECIDES each row from the exact state the rows before it left (balancer
nomination, warm/cold, the Alg. 1 budget, the policy's masked lexicographic
minimum) and returns the policy-view codes — the chunk's decisions, which
the placement core verifies with one replay pass. Its kernel is bound by
that R-step chain; it keeps device memory off the chain (the rows' inputs
are staged ahead into a shared-memory ring), crosses one block barrier a
row, and scans the pools one row ahead, patching the scan with the one
slot the row before changed (see the CUDA source).

All float state is float64; replay and walk only add, multiply once for the
budget (``c_max + alpha * s``, two rounded operations), take maxima, compare
and gather, so kernels and plain versions agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import _build

SMEM_LIMIT = 232_448  # bytes of shared memory one block may use on Hopper
_WARP = 32


class ReplayOut(NamedTuple):
    hb: torch.Tensor        # (R, nd) f64 horizon before each row
    nom: torch.Tensor       # (R,) int32 nominated device per row
    h_fin: torch.Tensor     # (nd,) f64
    cold: torch.Tensor      # (R, nc) bool: no idle container before the row
    busy: torch.Tensor      # (nc, cap) f64
    last: torch.Tensor      # (nc, cap) f64
    cnt: torch.Tensor       # (nc,) int32
    overflow: torch.Tensor  # (nc,) int32


REPLAY_MAX_ROWS = 1024           # rows of a replay segment at most
REPLAY_EDGE_BUDGET = 128 * 1024  # bytes of the edge block's three segment buffers
REPLAY_GAP_WARPS = 4             # warps flagging the rows between dispatches
REPLAY_SPLIT = 2                 # scanner warps of one pool (2 beat 1 and 4: PERF.md)


def _edge_block_bytes(nd: int, seg: int) -> int:
    """Mirrors ``edge_layout``: three buffers of nows, ecomp rows and the
    horizon snapshots (seg + 1 of them) in float64, then codes, fixed
    nominations, edge rows and edge counts before each row as 4-byte
    words, and three segment counts."""
    return 3 * seg * 8 * (1 + nd) + 3 * (seg + 1) * nd * 8 + 3 * seg * 16 + 12


def _pool_block_bytes(cap: int, seg: int) -> int:
    """Mirrors ``pool_layout``: the (busy, last) pool, two segment buffers
    of (occw, occc) pairs, nows, codes and dispatch rows, two segment counts
    and the scan parts' best keys and slots for two dispatches."""
    return 16 * cap + 2 * seg * (16 + 8 + 4 + 4) + 2 * 4 \
        + 2 * REPLAY_SPLIT * (8 + 4)


def replay_ring_rows(nd: int) -> int:
    """Rows of a replay segment (mirrors ``replay_ring_rows``): the largest
    power of two up to ``REPLAY_MAX_ROWS`` whose edge buffers fit
    ``REPLAY_EDGE_BUDGET``."""
    seg = REPLAY_MAX_ROWS
    while seg > 1 and _edge_block_bytes(nd, seg) > REPLAY_EDGE_BUDGET:
        seg //= 2
    return seg


def replay_warps() -> int:
    """Warps of a replay block (mirrors ``REPLAY_WARPS``): the
    ``REPLAY_SPLIT`` scanners, the producer and the gap warps."""
    return 1 + REPLAY_SPLIT + REPLAY_GAP_WARPS


def smem_bytes(nd: int, nc: int, cap: int) -> int:
    """Shared memory per replay block (mirrors ``state_replay_smem_bytes``):
    the larger of a config block's and the edge block's."""
    seg = replay_ring_rows(nd)
    pool = _pool_block_bytes(cap, seg) if nc else 0
    edge = _edge_block_bytes(nd, seg) if nd else 0
    return max(pool, edge)


def replay_launch_layout(nd: int, nc: int, cap: int) -> tuple[int, int, int, int]:
    """``(warps, ring_rows, split, smem_bytes)`` of the replay's launch as
    the built library makes it (``state_replay_layout``, from the same C
    helpers as ``state_replay_f64``); ``chip_smoke.py`` and the card tests
    hold the mirrors above to it."""
    out = (ctypes.c_longlong * 4)()
    fn = _build.function("state_replay", "state_replay_layout",
                         [_build.I32] * 3 + [_build.P])
    _build.check(fn(nd, nc, cap, out), "state_replay_layout")
    return tuple(int(x) for x in out)


def _shapes(nows, ecomp, busy0):
    R = nows.shape[0]
    nd = 0 if ecomp is None else ecomp.shape[1]
    nc, cap = (0, 0) if busy0 is None else tuple(busy0.shape)
    return R, nd, nc, cap


def state_replay_plain(nows, guess, *, ecomp=None, h0=None, nom_fixed=None,
                       lpw=False, edge_col=-1, occw=None, occc=None,
                       busy0=None, last0=None, cnt0=None,
                       t_idl: float = 0.0) -> ReplayOut:
    """The replay as a Python loop over rows: edge horizons on Python floats
    (IEEE double, like the kernel), container pools on tensors."""
    R, nd, nc, cap = _shapes(nows, ecomp, busy0)
    dev = nows.device
    nows_l = nows.tolist()
    g_l = guess.tolist()
    hb = torch.empty((R, nd), dtype=torch.float64)
    nom_l = [0] * R
    h_fin = torch.empty(nd, dtype=torch.float64)
    if nd:
        h = h0.tolist()
        ec = ecomp.tolist()
        nf = None if lpw else nom_fixed.tolist()
        hb_rows = []
        for r in range(R):
            now = nows_l[r]
            if lpw:
                best, bw = 0, max(h[0] - now, 0.0)
                for d in range(1, nd):
                    w = max(h[d] - now, 0.0)
                    if w < bw:
                        best, bw = d, w
            else:
                best = nf[r]
            hb_rows.append(list(h))
            nom_l[r] = best
            if g_l[r] == edge_col:
                hv = h[best]
                h[best] = (hv if hv > now else now) + ec[r][best]
        hb = torch.tensor(hb_rows, dtype=torch.float64).reshape(R, nd)
        h_fin = torch.tensor(h, dtype=torch.float64)
    cold = torch.zeros((R, nc), dtype=torch.bool)
    overflow = torch.zeros(nc, dtype=torch.int32)
    if nc:
        busy = busy0.detach().to("cpu", copy=True)
        last = last0.detach().to("cpu", copy=True)
        cnt = [int(c) for c in cnt0.tolist()]
        ow, oc = occw.tolist(), occc.tolist()
        for r in range(R):
            now = nows_l[r]
            idle = (busy <= now) & (now <= last + t_idl)
            cold_row = ~idle.any(dim=1)
            cold[r] = cold_row
            ci = g_l[r]
            if not 0 <= ci < nc:
                continue
            is_cold = bool(cold_row[ci])
            if is_cold:
                j = cnt[ci]
                if j >= cap:
                    overflow[ci] = 1
                    continue
                cnt[ci] += 1
            else:
                masked = torch.where(idle[ci], last[ci],
                                     torch.tensor(float("-inf"),
                                                  dtype=torch.float64))
                j = int(torch.argmax(masked))  # first max == MRU tie-break
            completion = now + (oc[r][ci] if is_cold else ow[r][ci])
            busy[ci, j] = completion
            last[ci, j] = completion
        cnt_t = torch.tensor(cnt, dtype=torch.int32)
    else:
        busy = torch.empty((0, cap), dtype=torch.float64)
        last = torch.empty((0, cap), dtype=torch.float64)
        cnt_t = torch.empty(0, dtype=torch.int32)
    return ReplayOut(hb.to(dev), torch.tensor(nom_l, dtype=torch.int32).to(dev),
                     h_fin.to(dev), cold.to(dev), busy.to(dev), last.to(dev),
                     cnt_t.to(dev), overflow.to(dev))


def state_replay(nows, guess, *, ecomp=None, h0=None, nom_fixed=None,
                 lpw=False, edge_col=-1, occw=None, occc=None, busy0=None,
                 last0=None, cnt0=None, t_idl: float = 0.0,
                 out=None, skip=None) -> ReplayOut:
    """One replay pass; see the module docstring. ``ecomp``/``h0`` (and
    ``nom_fixed`` unless ``lpw``) describe the edge fleet, ``occw``/``occc``/
    ``busy0``/``last0``/``cnt0`` the container pools; leave either group
    ``None`` when the engine has no edge fleet / no cloud config. ``out``
    may carry ``(busy, last, cnt)`` buffers for the final pools, reused
    across passes and chunks. ``skip``, an int32 tensor of flags (the
    walk's per-config overflow), makes a pass whose result the caller will
    discard cost nothing: when any flag is set nothing is computed or
    written (the outputs hold no values, ``overflow`` reads 0), and on the
    card the kernel returns at once without a host read.

    CPU tensors take the plain version; CUDA tensors launch
    ``state_replay_f64`` (one block per config pool plus one for the edge
    horizons) or raise."""
    R, nd, nc, cap = _shapes(nows, ecomp, busy0)
    if nows.device.type == "cpu":
        if skip is not None and bool(skip.any()):
            f64 = torch.float64
            busy, last, cnt = out if out is not None and nc else (
                torch.zeros((nc, cap), dtype=f64),
                torch.zeros((nc, cap), dtype=f64),
                torch.zeros(nc, dtype=torch.int32))
            return ReplayOut(torch.zeros((R, nd), dtype=f64),
                             torch.zeros(R, dtype=torch.int32),
                             torch.zeros(nd, dtype=f64),
                             torch.zeros((R, nc), dtype=torch.bool),
                             busy, last, cnt,
                             torch.zeros(nc, dtype=torch.int32))
        res = state_replay_plain(
            nows, guess, ecomp=ecomp, h0=h0, nom_fixed=nom_fixed, lpw=lpw,
            edge_col=edge_col, occw=occw, occc=occc, busy0=busy0,
            last0=last0, cnt0=cnt0, t_idl=t_idl)
        if out is not None and nc:
            for buf, val in zip(out, (res.busy, res.last, res.cnt)):
                buf.copy_(val)
            res = res._replace(busy=out[0], last=out[1], cnt=out[2])
        return res
    _build.refuse_grad("state_replay", nows, ecomp, h0, occw, occc, busy0,
                       last0)
    device = nows.device
    need = smem_bytes(nd, nc, cap)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"state_replay: a pool of {cap} container slots needs {need} B of "
            f"shared memory per block, more than the {SMEM_LIMIT} B a Hopper "
            "block can hold")

    def req(t, name, dtype, shape):
        if t is None or t.dtype != dtype or t.device != device \
                or tuple(t.shape) != shape or not t.is_contiguous():
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"state_replay: {name} must be a contiguous "
                             f"{dtype} tensor of shape {shape} on {device}, "
                             f"got {got}")

    f64, i32 = torch.float64, torch.int32
    req(nows, "nows", f64, (R,))
    req(guess, "guess", i32, (R,))
    if nd:
        req(ecomp, "ecomp", f64, (R, nd))
        req(h0, "h0", f64, (nd,))
        if not lpw:
            req(nom_fixed, "nom_fixed", i32, (R,))
    if nc:
        for name, t in (("occw", occw), ("occc", occc)):
            req(t, name, f64, (R, nc))
        req(busy0, "busy0", f64, (nc, cap))
        req(last0, "last0", f64, (nc, cap))
        req(cnt0, "cnt0", i32, (nc,))
    if skip is not None:
        req(skip, "skip", i32, (skip.numel(),))
    hb = torch.empty((R, nd), dtype=f64, device=device)
    nom = torch.zeros(R, dtype=i32, device=device)
    h_fin = torch.empty(nd, dtype=f64, device=device)
    cold = torch.empty((R, nc), dtype=torch.bool, device=device)
    if out is not None:
        busy, last, cnt = out
        req(busy, "out busy", f64, (nc, cap))
        req(last, "out last", f64, (nc, cap))
        req(cnt, "out cnt", i32, (nc,))
    else:
        busy = torch.empty((nc, cap), dtype=f64, device=device)
        last = torch.empty((nc, cap), dtype=f64, device=device)
        cnt = torch.empty(nc, dtype=i32, device=device)
    overflow = torch.zeros(nc, dtype=i32, device=device)
    P, I32, F64 = _build.P, _build.I32, _build.F64
    fn = _build.function(
        "state_replay", "state_replay_f64",
        [P, P, I32, I32, I32, I32, P, P, P, P, P, P, I32, I32, F64]
        + [P] * 11 + [I32, P])
    ptr = _build.ptr
    rc = fn(ptr(nows), ptr(guess), R, nd, int(bool(lpw)), int(edge_col),
            ptr(ecomp if nd else None), ptr(h0 if nd else None),
            ptr(nom_fixed if nd and not lpw else None), ptr(hb), ptr(nom),
            ptr(h_fin), nc, cap, float(t_idl),
            ptr(occw if nc else None), ptr(occc if nc else None),
            ptr(busy0 if nc else None), ptr(last0 if nc else None),
            ptr(cnt0 if nc else None), ptr(cold), ptr(busy), ptr(last),
            ptr(cnt), ptr(overflow), ptr(skip),
            0 if skip is None else skip.numel(), _build.stream_of(nows))
    _build.check(rc, "state_replay")
    _build.counted(state_replay)
    return ReplayOut(hb, nom, h_fin, cold, busy, last, cnt, overflow)


state_replay.launches = 0


WALK_STAGES = 3                # tiles of row inputs in the walk's ring
WALK_RING_BUDGET = 96 * 1024   # bytes the ring may take
WALK_MAX_WARPS = 24            # the walk's block
# pool-scanning warps: all but the decider, the producer and the warps that
# share the decider's SMSP (4, 8, ...), which only pass the barrier
WALK_MAX_SCANNERS = WALK_MAX_WARPS - 2 - (WALK_MAX_WARPS - 1) // 4
WALK_MAX_SPLIT = 2             # warps that share one pool's scan


def walk_ring_rows(nd: int, nc: int) -> int:
    """Rows of one tile of the walk's input ring (mirrors
    ``walk_ring_rows``): the largest of 64, 32, ..., 2 whose
    ``WALK_STAGES`` tiles of ``8 (1 + 5 nc + 2 nd) + 4`` bytes a row fit
    ``WALK_RING_BUDGET``."""
    row = 8 * (1 + 5 * nc + 2 * nd) + 4
    tr = 64
    while tr > 2 and WALK_STAGES * tr * row > WALK_RING_BUDGET:
        tr //= 2
    return tr


def walk_split(nc: int) -> int:
    """Warps that share each pool's scan (mirrors ``walk_split``): up to
    ``WALK_MAX_SPLIT``, with at most ``WALK_MAX_SCANNERS`` scanning warps."""
    return max(1, min(WALK_MAX_SPLIT, WALK_MAX_SCANNERS // nc)) if nc else 1


def walk_warps(nc: int) -> int:
    """Warps of the walk's block (mirrors ``walk_block_warps``): the
    deciding warp 0, the producer warp 1, ``walk_split(nc)`` scanners per
    config (at most ``WALK_MAX_SCANNERS``) on the warps that are not
    multiples of 4, which keep the decider's SMSP to it."""
    need = min(nc, WALK_MAX_SCANNERS) * walk_split(nc)
    w = 2
    while w - 2 - (w - 1) // 4 < need:
        w += 1
    return w


def walk_smem_bytes(nd: int, nc: int, cap: int) -> int:
    """Shared memory of the walk's one block (mirrors
    ``state_walk_smem_bytes``): the (busy, last) pools, the edge horizons,
    the input ring and two completions in float64; the (best, runner-up)
    keys of each part of each pool's scan for two rows; then as 4-byte
    words the ring's ``nom_fixed``, the slots beside those keys, the two
    dispatches and the ring of decided codes."""
    tr = walk_ring_rows(nd, nc)
    parts = 4 * nc * walk_split(nc)
    doubles = 2 * nc * cap + nd + WALK_STAGES * tr * (1 + 5 * nc + 2 * nd) + 2
    words = 2 * WALK_STAGES * tr + parts + 4
    return 8 * (doubles + parts) + 4 * words


def walk_launch_layout(nd: int, nc: int, cap: int) -> tuple[int, int, int, int]:
    """``(warps, ring_rows, split, smem_bytes)`` of the walk's launch as the
    built library makes it (``state_walk_layout``, from the same C helpers
    as ``state_walk_f64``). The mirrors above size the launch and the pool
    cap on the host; ``chip_smoke.py`` and the card tests hold them to
    this."""
    out = (ctypes.c_longlong * 4)()
    fn = _build.function("state_replay", "state_walk_layout",
                         [_build.I32, _build.I32, _build.I32, _build.P])
    _build.check(fn(nd, nc, cap, out), "state_walk_layout")
    return tuple(int(x) for x in out)


def state_walk_plain(nows, n: int, *, ecomp=None, elat=None, h0=None,
                     nom_fixed=None, lpw=False, latw=None, latc=None,
                     costc=None, occw=None, occc=None, busy0=None, last0=None,
                     cnt0=None, t_idl: float = 0.0, minlat=True,
                     c_max: float = 0.0, alpha: float = 0.0, s0=None,
                     deadline: float = 0.0):
    """The walk as a Python loop over the first ``n`` rows: decisions on
    Python floats (IEEE double), container pools on tensors. Returns
    ``(code (R,) int32, overflow (nc,) int32)`` on ``nows``' device."""
    R = nows.shape[0]
    dev = nows.device
    nd = 0 if ecomp is None else ecomp.shape[1]
    nc, cap = (0, 0) if busy0 is None else tuple(busy0.shape)
    T = nc + (1 if nd else 0)
    edge_col = T - 1 if nd else -1
    nows_l = nows.tolist()
    code = [-1] * R
    overflow = [0] * nc
    h = h0.tolist() if nd else []
    ec = ecomp.tolist() if nd else []
    el = elat.tolist() if nd else []
    nf = nom_fixed.tolist() if nd and not lpw else None
    lw, lc, cc = ((latw.tolist(), latc.tolist(), costc.tolist()) if nc
                  else ([], [], []))
    ow, oc = (occw.tolist(), occc.tolist()) if nc else ([], [])
    s = float(s0) if minlat else 0.0
    if nc:
        busy = busy0.detach().to("cpu", copy=True)
        last = last0.detach().to("cpu", copy=True)
        cnt = [int(c) for c in cnt0.tolist()]
    ninf = torch.tensor(float("-inf"), dtype=torch.float64)
    for r in range(n):
        now = nows_l[r]
        if nc:
            idle = (busy <= now) & (now <= last + t_idl)
            cold = (~idle.any(dim=1)).tolist()
        d, wait = 0, 0.0
        if nd:
            if lpw:
                wait = max(h[0] - now, 0.0)
                for k in range(1, nd):
                    wk = max(h[k] - now, 0.0)
                    if wk < wait:
                        d, wait = k, wk
            else:
                d = nf[r]
                wait = max(h[d] - now, 0.0)
        lats = [lc[r][t] if cold[t] else lw[r][t] for t in range(nc)]
        costs = [cc[r][t] for t in range(nc)]
        if nd:
            lats.append(wait + el[r][d])
            costs.append(0.0)
        allowed = c_max + alpha * s
        best = -1
        for t in range(T):
            if minlat:
                if costs[t] <= allowed and (
                        best < 0 or lats[t] < lats[best]
                        or (lats[t] == lats[best] and costs[t] < costs[best])):
                    best = t
            elif lats[t] <= deadline and (
                    best < 0 or costs[t] < costs[best]
                    or (costs[t] == costs[best] and lats[t] < lats[best])):
                best = t
        if best < 0:
            best = edge_col if nd else min(
                range(T), key=lambda t: (lats[t], costs[t]))
        if minlat:
            s = s + (c_max - costs[best])
        code[r] = best
        if best == edge_col:
            hv = h[d]
            h[d] = (hv if hv > now else now) + ec[r][d]
            continue
        if cold[best]:
            j = cnt[best]
            if j >= cap:
                overflow[best] = 1
                continue
            cnt[best] += 1
            completion = now + oc[r][best]
        else:
            j = int(torch.argmax(torch.where(idle[best], last[best], ninf)))
            completion = now + ow[r][best]
        busy[best, j] = completion
        last[best, j] = completion
    return (torch.tensor(code, dtype=torch.int32, device=dev),
            torch.tensor(overflow, dtype=torch.int32, device=dev))


def state_walk(nows, n: int, *, ecomp=None, elat=None, h0=None,
               nom_fixed=None, lpw=False, latw=None, latc=None, costc=None,
               occw=None, occc=None, busy0=None, last0=None, cnt0=None,
               t_idl: float = 0.0, minlat=True, c_max: float = 0.0,
               alpha: float = 0.0, s0=None, deadline: float = 0.0):
    """Policy-view codes (R,) int32 of the exact sequential walk over the
    first ``n`` of ``R`` rows (pad rows get -1), and the per-config
    ``overflow`` flags. Edge inputs (``ecomp``/``elat``/``h0``, and
    ``nom_fixed`` unless ``lpw``) and cloud inputs (the (R, nc) latency,
    cost and occupancy columns and the pools) as for ``state_replay``;
    ``s0`` is the surplus bank as a 0-d tensor (MinLatency), ``deadline``
    the MinCost deadline.

    CPU tensors take the plain version; CUDA tensors launch
    ``state_walk_f64`` (one block: a deciding warp; a warp staging the
    rows' inputs into a shared-memory ring; up to two warps per config pool
    scanning one row ahead) or raise."""
    kw = dict(ecomp=ecomp, elat=elat, h0=h0, nom_fixed=nom_fixed, lpw=lpw,
              latw=latw, latc=latc, costc=costc, occw=occw, occc=occc,
              busy0=busy0, last0=last0, cnt0=cnt0, t_idl=t_idl,
              minlat=minlat, c_max=c_max, alpha=alpha, s0=s0,
              deadline=deadline)
    if nows.device.type == "cpu":
        return state_walk_plain(nows, n, **kw)
    _build.refuse_grad("state_walk", nows, *(v for v in kw.values()
                                             if isinstance(v, torch.Tensor)))
    device = nows.device
    R = nows.shape[0]
    nd = 0 if ecomp is None else ecomp.shape[1]
    nc, cap = (0, 0) if busy0 is None else tuple(busy0.shape)
    if nc > 32:
        raise ValueError(f"state_walk: at most 32 cloud configs, got {nc}")
    need = walk_smem_bytes(nd, nc, cap)
    if need > SMEM_LIMIT:
        raise ValueError(
            f"state_walk: {nc} pools of {cap} container slots need {need} B "
            f"of shared memory in one block, more than the {SMEM_LIMIT} B a "
            "Hopper block can hold")
    f64, i32 = torch.float64, torch.int32
    checks = [("nows", nows, f64, (R,))]
    if nd:
        checks += [("ecomp", ecomp, f64, (R, nd)), ("elat", elat, f64, (R, nd)),
                   ("h0", h0, f64, (nd,))]
        if not lpw:
            checks.append(("nom_fixed", nom_fixed, i32, (R,)))
    if nc:
        checks += [(nm, t, f64, (R, nc)) for nm, t in
                   (("latw", latw), ("latc", latc), ("costc", costc),
                    ("occw", occw), ("occc", occc))]
        checks += [("busy0", busy0, f64, (nc, cap)),
                   ("last0", last0, f64, (nc, cap)),
                   ("cnt0", cnt0, i32, (nc,))]
    if minlat:
        checks.append(("s0", s0, f64, ()))
    for nm, t, dtype, shape in checks:
        if t is None or t.dtype != dtype or t.device != device \
                or tuple(t.shape) != shape or not t.is_contiguous():
            got = None if t is None else (t.dtype, tuple(t.shape), t.device)
            raise ValueError(f"state_walk: {nm} must be a contiguous {dtype} "
                             f"tensor of shape {shape} on {device}, got {got}")
    code = torch.empty(R, dtype=i32, device=device)
    overflow = torch.zeros(max(nc, 1), dtype=i32, device=device)
    P, I32, F64 = _build.P, _build.I32, _build.F64
    fn = _build.function(
        "state_replay", "state_walk_f64",
        [P, I32, I32, I32, I32, P, P, P, P, I32, I32, F64] + [P] * 8
        + [I32, F64, F64, P, F64, P, P, P])
    ptr = _build.ptr
    e = nd > 0
    c = nc > 0
    rc = fn(ptr(nows), R, int(n), nd, int(bool(lpw)),
            ptr(ecomp if e else None), ptr(elat if e else None),
            ptr(h0 if e else None),
            ptr(nom_fixed if e and not lpw else None), nc, cap, float(t_idl),
            *(ptr(t if c else None) for t in (latw, latc, costc, occw, occc,
                                              busy0, last0, cnt0)),
            int(bool(minlat)), float(c_max), float(alpha),
            ptr(s0 if minlat else None), float(deadline), ptr(code),
            ptr(overflow), _build.stream_of(nows))
    _build.check(rc, "state_walk")
    _build.counted(state_walk)
    return code, overflow[:nc]


state_walk.launches = 0
