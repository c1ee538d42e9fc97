"""Device-resident placement core: the predict -> place pass on torch tensors.

The columnar decision core (``repro_torch.core.decision``) is pure numpy: one
vectorized predict pass, then speculate-and-repair over the three sequential
recurrences. This module runs that per-chunk pipeline on torch tensors on the
engine's device (the CUDA card unless the caller asked for the CPU) —
selected per engine with ``DecisionEngine(array_backend="torch")`` or per
stream with ``serve_stream(..., array_backend="torch")``. The numpy path
stays the correctness oracle.

One chunk:

1. **Predict** — ridge upload / edge-compute models, normal-model scalars and
   Lambda pricing as eager torch ops in the oracle's association order; the
   GBRT compute column through the float64 ``gbrt_predict_multi`` CUDA kernel
   on the card (one launch for every cloud config), or as a gather over the
   cached serving step tables on the CPU. Both are bit-identical to the
   oracle's step tables.
2. **Place** — the ``state_walk`` kernel decides every row sequentially
   from the exact state (the numpy core's scalar walk on the device); its
   policy-view codes (``-1`` = pad row) are then verified as a fixed point
   in ONE pass with one host sync (one copy carries the verdict, the walk's
   overflow flag and the pools' largest live count): the sequential state
   is replayed from
   the chunk-start state under those codes — the edge FIFO horizons with
   the least-predicted-wait nominations and the CIL container pools through
   the ``state_replay`` kernel, the Alg. 1 surplus bank through the
   ``linear_scan`` prefix kernel — then ``allowed = c_max + alpha *
   s_before`` (two separate ops) and the policy's masked lexicographic
   argmins must give the same codes. A mismatch raises. Every output column
   comes from the replay, not from the walk.
3. **Commit or stay resident** — decision outputs come to the host in one
   copy. Without stream residency (a standalone ``place_many``) the CIL
   pools, edge horizons and surplus bank are written back like the numpy
   accept step (with the final reap at the last arrival). Under
   ``serve_stream`` the state STAYS ON THE DEVICE as a ``DeviceStreamState``:
   the next in-order chunk seeds its replay from it, the pool buffers are
   reused in place (the replay's output buffers and the seed swap roles each
   chunk), and the host CIL / queues / policy are materialized only on
   demand — stream end, a fallback exit, or ``sync_engine``. Deferring the
   reap is exact: the keep predicate is monotone in the reap time and dead
   containers are never warm-reusable. ``stage_chunk`` (run by
   ``runtime._prefetched_chunks`` on a transfer thread) copies the next
   chunk's task columns from pinned host memory on a side CUDA stream while
   the current chunk places; ``place_chunk`` waits on its event.

Parity contract. Torch eager never contracts a multiply and an add into an
FMA, every division here divides by a device tensor (a true division, not a
multiply by a reciprocal), and the sequential folds run in order, so one
backend serves both contracts: on the CPU it is BIT-IDENTICAL per record to
the numpy oracle (asserted by the tests), and on the card it is
decision-identical with floats within 1e-9 (asserted by ``chip_smoke.py``),
where bit-identity is expected too.

Fallback rules (all BEFORE any balancer/RNG state is consumed, so a fallback
chunk is indistinguishable from a numpy chunk): hedged/custom policies,
non-columnar balancers, quantile prediction, ``record_decisions``, custom
target/model/pricing types and out-of-order arrivals take the numpy path;
the engine counts such chunks in ``fallback_chunks``. Chunks are padded to
power-of-two rows (pad rows carry code ``-1`` and have no effects).
"""

from __future__ import annotations

import threading
import weakref
from dataclasses import dataclass, field

import numpy as np
import torch

from repro_torch import DTYPE
from repro_torch.core.cil import ContainerInfoList, ContainerRecord
from repro_torch.core.perf_models import NormalModel, RidgeModel, ScaledModel
from repro_torch.core.predictor import (
    EdgeTarget,
    LambdaTarget,
    Predictor,
    const1_serving_table,
    model_keyed_cache,
)
from repro_torch.core.pricing import EdgePricing, LambdaPricing
from repro_torch.core.workload import task_arrays
from repro_torch.kernels.gbrt_predict.ops import gbrt_predict_configs
from repro_torch.kernels.linear_scan.ops import prefix_sum
from repro_torch.kernels.state_replay.kernel import (
    SMEM_LIMIT,
    state_replay,
    state_walk,
    walk_smem_bytes,
)

POOL_MIN_CAP = 8        # starting CIL container-pool capacity (grows on overflow)
PAD_MIN = 8             # minimum padded chunk rows
I32 = torch.int32


class CoreIneligible(Exception):
    """This engine's policy/targets/models are outside the torch core's replica."""


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def max_pool_cap(n_dev: int, n_cloud: int) -> int:
    """The largest power-of-two pool capacity whose pools the ``state_walk``
    kernel's one block holds in shared memory (2048 slots for 4 configs).
    The walk scans only the live slots, so a large capacity costs a copy of
    the pools per launch and nothing per row."""
    cap = POOL_MIN_CAP
    while n_cloud and walk_smem_bytes(n_dev, n_cloud, 2 * cap) <= SMEM_LIMIT:
        cap *= 2
    return cap


# Device-resident tables, keyed on model identity + device with the
# _CONST1_TABLES weakref idiom — rebuilding a core (a hedged-policy swap and
# back) re-hosts nothing, and the per-chunk path does no host-side prep.
_DEVICE_TABLES: dict[tuple, dict] = {}
_DEVICE_TABLES_LOCK = threading.Lock()


@dataclass
class DeviceStreamState:
    """Cross-chunk device residency for one ``serve_stream`` run.

    Holds the sequential placement state ON THE DEVICE between consecutive
    in-order chunks: fixed-capacity CIL container pools (``busy``/``last`` at
    ``cap`` slots per cloud config plus per-config ``cnt``), per-device edge
    FIFO horizons ``h`` and the Alg. 1 surplus bank ``s``. Host-side
    bookkeeping rides along: ``t_last`` (last committed arrival — validates
    in-order re-entry) and ``cnt_max`` (pool-growth bound without
    materializing pools). Strong refs to the CIL / policy / queues objects
    pin the state to the exact host structures it shadows — any object swap
    invalidates it.
    """

    busy: torch.Tensor | None = None     # (n_cloud, cap)
    last: torch.Tensor | None = None     # (n_cloud, cap)
    cnt: torch.Tensor | None = None      # (n_cloud,) int32
    h: torch.Tensor | None = None        # (n_dev,)
    s: torch.Tensor | None = None        # 0-d (MinLatency only)
    cap: int = 0
    t_last: float = -np.inf
    cnt_max: int = 0
    cil: object = None
    policy: object = None
    queues: object = field(default=None)


# --------------------------------------------------------------------- spec
@dataclass
class _CloudSpec:
    name: str
    memory_mb: float
    up_theta: tuple[float, float]
    start_warm: float          # max(mean, 0) — precomputed like the batch path
    start_cold: float
    store: float
    quantum: float
    gb: float
    rate: float
    breaks: np.ndarray
    vals: np.ndarray


@dataclass
class _EdgeSpec:
    name: str
    theta: tuple[float, float]
    scale: float
    iot: float
    store: float


def _ridge2(model) -> tuple[float, float]:
    if type(model) is not RidgeModel or model.theta.shape != (2,):
        raise CoreIneligible("non-affine upload/edge model")
    return float(model.theta[0]), float(model.theta[1])


def _normal_mean(model) -> float:
    if type(model) is not NormalModel:
        raise CoreIneligible("non-normal component model")
    return max(model.predict(), 0.0)


def _extract_cloud(tgt) -> _CloudSpec:
    if type(tgt) is not LambdaTarget:
        raise CoreIneligible(f"cloud target {tgt!r} is not a LambdaTarget")
    if type(tgt.pricing) is not LambdaPricing \
            or tgt.pricing.include_request_charge:
        raise CoreIneligible("non-Lambda or request-charge pricing")
    model = tgt.comp_model
    if not (hasattr(model, "const1_table") and hasattr(model, "thresholds")):
        raise CoreIneligible("cloud comp model is not a GBRT")
    breaks, vals = const1_serving_table(model, float(tgt.memory_mb))
    return _CloudSpec(
        name=tgt.name, memory_mb=float(tgt.memory_mb),
        up_theta=_ridge2(tgt.upld_model),
        start_warm=_normal_mean(tgt.start_warm),
        start_cold=_normal_mean(tgt.start_cold),
        store=_normal_mean(tgt.store_model),
        quantum=float(tgt.pricing.quantum_ms),
        gb=tgt.memory_mb / 1024.0,
        rate=float(tgt.pricing.gb_second_rate),
        breaks=np.asarray(breaks, np.float64),
        vals=np.asarray(vals, np.float64))


def padded_step_tables(tables) -> tuple[np.ndarray, np.ndarray]:
    """The cloud configs' ``(breaks, vals)`` serving step tables as one
    ``BR`` (C, bmax) of breaks padded with +inf and ``VL`` (C, bmax + 1) of
    values padded with each config's last, for ``searchsorted`` + ``gather``
    (the core's CPU route)."""
    bmax = max(1, max(np.shape(b)[0] for b, _ in tables))
    BR = np.full((len(tables), bmax), np.inf)
    VL = np.zeros((len(tables), bmax + 1))
    for i, (b, v) in enumerate(tables):
        nb = np.shape(b)[0]
        BR[i, :nb] = b
        VL[i, :nb + 1] = v
        VL[i, nb + 1:] = v[-1]
    return BR, VL


def _extract_edge(dev) -> _EdgeSpec:
    if type(dev) is not EdgeTarget:
        raise CoreIneligible(f"edge device {dev!r} is not an EdgeTarget")
    if type(dev.pricing) is not EdgePricing:
        raise CoreIneligible("edge pricing is not EdgePricing")
    model = dev.comp_model
    scale = 1.0
    if type(model) is ScaledModel:
        scale = float(model.scale)
        model = model.base
    t0, t1 = _ridge2(model)
    return _EdgeSpec(name=dev.name, theta=(t0, t1), scale=scale,
                     iot=_normal_mean(dev.iotup_model),
                     store=_normal_mean(dev.store_model))


def _engine_key(engine) -> tuple:
    """Cheap identity key for the per-engine core cache. Model swaps (online
    refit) change ids; ``valid_for`` weakref-guards against id recycling."""
    pred = engine.predictor
    ids = [id(pred), id(engine.policy), type(engine.policy),
           type(engine.balancer), pred.quantile, str(engine.device)]
    for tgt in pred.cloud_targets:
        ids.append((id(tgt), id(tgt.comp_model), id(tgt.upld_model),
                    id(tgt.start_warm), id(tgt.start_cold),
                    id(tgt.store_model)))
    for dev in (pred.edge_fleet or ()):
        ids.append((id(dev), id(dev.comp_model), id(dev.iotup_model),
                    id(dev.store_model)))
    return tuple(ids)


# --------------------------------------------------------------------- core
class TorchPlacementCore:
    """One engine's predict -> place pipeline on its device.

    Built lazily per engine (``core_for``), revalidated per chunk against the
    captured model identities — a refit-by-swap misses the cache and
    triggers a rebuild, exactly like the serving step-table cache.
    """

    def __init__(self, engine):
        if not engine._columnar_eligible():
            raise CoreIneligible("engine is not columnar-eligible")
        pred: Predictor = engine.predictor
        if pred.quantile is not None:
            raise CoreIneligible("quantile prediction is host-side only")
        self.device = engine.device
        self.cloud = [_extract_cloud(t) for t in pred.cloud_targets]
        self._kernel_models = [t.comp_model for t in pred.cloud_targets]
        self.edges = [_extract_edge(d) for d in (pred.edge_fleet or ())]
        self.n_cloud = len(self.cloud)
        self.n_dev = len(self.edges)
        self.has_edge = self.n_dev > 0
        self.T = self.n_cloud + (1 if self.has_edge else 0)
        self.edge_col = self.T - 1 if self.has_edge else -1
        self.t_idl = float(pred.cil.t_idl_ms)

        from repro_torch.core.decision import (
            LeastPredictedWaitBalancer,
            MinLatencyPolicy,
        )

        self.is_minlat = type(engine.policy) is MinLatencyPolicy
        self.lpw = (self.n_dev > 1
                    and type(engine.balancer) is LeastPredictedWaitBalancer)
        self.use_gbrt_kernel = bool(self.n_cloud) \
            and self.device.type == "cuda"
        # the largest pool the walk's one block holds in shared memory
        self.cap_limit = max_pool_cap(self.n_dev, self.n_cloud)
        self.key = _engine_key(engine)
        self._targets = list(pred.cloud_targets) + list(pred.edge_fleet or ())
        self._refs = [weakref.ref(o) for o in (
            [pred, engine.policy]
            + [t for t in pred.cloud_targets]
            + [t.comp_model for t in pred.cloud_targets]
            + [d for d in (pred.edge_fleet or ())])]
        self._cap_hint = POOL_MIN_CAP
        self._tables = self._device_tables()
        dev = self.device
        self._cols = torch.arange(self.T, device=dev)[None, :]
        self._inf = torch.tensor(np.inf, dtype=DTYPE, device=dev)
        self._edge_onehot = self._cols == self.edge_col
        self._copy_stream = None
        self._spare = None      # reusable (busy, last, cnt) replay outputs
        # ---- stream residency (serve_stream only; see module docstring) ----
        self._resident: DeviceStreamState | None = None
        self.state_syncs = 0      # host materializations of resident state
        self.fallback_syncs = 0   # ... of which were forced by a fallback
        self.resident_chunks = 0  # chunks absorbed without a host sync
        self.verify_syncs = 0     # device-to-host copies of a walk's verdict
        self.chunk_commits = 0    # per-chunk host commits (no residency)
        self.pool_regrows = 0     # chunks walked again after a pool overflow

    # ------------------------------------------------------------ lifecycle
    def valid_for(self, engine) -> bool:
        return (self.key == _engine_key(engine)
                and all(r() is not None for r in self._refs))

    # ------------------------------------------------------- device operands
    def _device_tables(self) -> dict:
        key = (tuple(id(t) for t in self._targets), str(self.device))
        return model_keyed_cache(
            _DEVICE_TABLES, _DEVICE_TABLES_LOCK, key, self._targets,
            self._build_device_tables)

    def _build_device_tables(self) -> dict:
        dev = self.device

        def put(values):
            return torch.as_tensor(np.asarray(values, np.float64), device=dev)

        t: dict = {"K1000": put(1000.0)}
        if self.n_cloud:
            BR, VL = padded_step_tables([(c.breaks, c.vals)
                                         for c in self.cloud])
            t["BR"] = put(BR)
            t["VL"] = put(VL)
            for key, attr in (("SW", "start_warm"), ("SC", "start_cold"),
                              ("ST", "store"), ("QNT", "quantum"),
                              ("GB", "gb"), ("RATE", "rate"),
                              ("MEM", "memory_mb")):
                t[key] = put([getattr(c, attr) for c in self.cloud])
            t["UP0"] = put([c.up_theta[0] for c in self.cloud])
            t["UP1"] = put([c.up_theta[1] for c in self.cloud])
        if self.has_edge:
            t["ET0"] = put([e.theta[0] for e in self.edges])
            t["ET1"] = put([e.theta[1] for e in self.edges])
            t["ESC"] = put([e.scale for e in self.edges])
            t["EIO"] = put([e.iot for e in self.edges])
            t["EST"] = put([e.store for e in self.edges])
        return t

    # --------------------------------------------------------------- predict
    def _predict(self, sizes: torch.Tensor, nbytes: torch.Tensor) -> dict:
        """The chunk's prediction matrices, in the numpy oracle's association
        order (see ``predictor.cloud_components_batch`` and the pricing)."""
        t = self._tables
        out: dict = {}
        if self.n_cloud:
            if self.use_gbrt_kernel:
                comp = gbrt_predict_configs(self._kernel_models, t["MEM"],
                                            sizes)
            else:
                R = sizes.shape[0]
                idx = torch.searchsorted(
                    t["BR"], sizes.expand(self.n_cloud, R).contiguous(),
                    side="left")
                comp = torch.gather(t["VL"], 1, idx).T
            compc = torch.clamp_min(comp, 0.0)
            upld = torch.clamp_min(t["UP0"] + nbytes[:, None] * t["UP1"], 0.0)
            # associate exactly like sum(warm.values()) / occupancy_ms:
            # ((upld + start) + comp) (+ store)
            occ_w = (upld + t["SW"]) + compc
            occ_c = (upld + t["SC"]) + compc
            out["LATW"] = occ_w + t["ST"]
            out["LATC"] = occ_c + t["ST"]
            out["OCCW"] = occ_w.contiguous()
            out["OCCC"] = occ_c.contiguous()
            out["COMPC"] = compc
            billed = torch.ceil(
                torch.clamp_min(torch.round(compc), 1.0) / t["QNT"]) * t["QNT"]
            out["COSTC"] = ((billed / t["K1000"]) * t["GB"]) * t["RATE"]
        if self.has_edge:
            ec = torch.clamp_min(
                (t["ET0"] + sizes[:, None] * t["ET1"]) * t["ESC"], 0.0)
            out["ECOMP"] = ec.contiguous()
            out["ELAT"] = (ec + t["EIO"]) + t["EST"]
        return out

    # ------------------------------------------------------------ one pass
    def _state(self, guess: torch.Tensor, P: dict, S: dict,
               skip=None) -> dict:
        """One full state replay of the chunk under the speculated codes
        ``guess`` and the policy-view matrices it induces; a set flag in
        ``skip`` (the walk's overflow) leaves the replay undone."""
        nows, rr = P["nows"], P["rr"]
        R = nows.shape[0]
        rep = state_replay(
            nows, guess,
            ecomp=P.get("ECOMP"), h0=S.get("h0"), nom_fixed=P.get("nom_fixed"),
            lpw=self.lpw, edge_col=self.edge_col,
            occw=P.get("OCCW"), occc=P.get("OCCC"), busy0=S.get("busy0"),
            last0=S.get("last0"), cnt0=S.get("cnt0"), t_idl=self.t_idl,
            out=S.get("out"), skip=skip)
        st = {"rep": rep}
        cols_lat, cols_cost, cols_comp = [], [], []
        if self.n_cloud:
            cols_lat.append(torch.where(rep.cold, P["LATC"], P["LATW"]))
            cols_cost.append(P["COSTC"])
            cols_comp.append(P["COMPC"])
        if self.has_edge:
            nom = rep.nom.long()
            waits = torch.clamp_min(rep.hb - nows[:, None], 0.0)
            ew = waits[rr, nom]
            cols_lat.append((ew + P["ELAT"][rr, nom])[:, None])
            cols_cost.append(P["ECOST"])
            cols_comp.append(P["ECOMP"][rr, nom][:, None])
            st["nom"], st["ew"] = nom, ew
        LAT = torch.cat(cols_lat, dim=1)
        COST = torch.cat(cols_cost, dim=1)
        st.update(LAT=LAT, COST=COST, COMP=torch.cat(cols_comp, dim=1))
        if self.is_minlat:
            safe_g = torch.clamp(guess, 0, self.T - 1).long()
            delta = torch.where(guess >= 0, P["c_max"] - COST[rr, safe_g],
                                P["zero"])
            # [s0, d_0, ..., d_{R-1}] folded left: h[:R] = s_before, h[R] =
            # s_fin — the same sequential fold as the oracle's cumsum
            h = prefix_sum(torch.cat([S["s0"].reshape(1), delta]))
            st["s_before"], st["s_fin"] = h[:R], h[R]
        return st

    def _choose(self, LAT, COST, allowed, deadline, valid):
        """The policy kernels: masked lexicographic argmins (first minimum
        wins, in column order)."""
        cols = self._cols
        if self.is_minlat:
            feas = COST <= allowed[:, None]
            none_f = ~feas.any(dim=1)
            if self.has_edge:
                feas = torch.where(none_f[:, None], self._edge_onehot, feas)
            else:
                feas = feas | none_f[:, None]
            lmin = torch.where(feas, LAT, self._inf).amin(dim=1)
            tie = feas & (LAT == lmin[:, None])
            cmin = torch.where(tie, COST, self._inf).amin(dim=1)
            final = tie & (COST == cmin[:, None])
            code = torch.where(final, cols, self.T).amin(dim=1)
            feas_out = torch.ones_like(valid)
        else:  # MinCostPolicy (edge column guaranteed by eligibility)
            feas = LAT <= deadline
            any_f = feas.any(dim=1)
            cmin = torch.where(feas, COST, self._inf).amin(dim=1)
            tie = feas & (COST == cmin[:, None])
            lmin = torch.where(tie, LAT, self._inf).amin(dim=1)
            final = tie & (LAT == lmin[:, None])
            code = torch.where(final, cols, self.T).amin(dim=1)
            code = torch.where(any_f, code, self.edge_col)
            feas_out = any_f
        return torch.where(valid, code, -1).to(I32), feas_out

    def _finalize(self, st, code, feas, allowed, rr) -> torch.Tensor:
        """Chosen-row gathers for the chunk, stacked into ONE (9, R) float64
        block so a single copy brings every decision column to the host:
        gcode, lat, cost, cold, comp, wait, feas, allowed, nom."""
        R = code.shape[0]
        safe = torch.clamp(code, 0, self.T - 1).long()
        zeros = torch.zeros(R, dtype=DTYPE, device=self.device)
        rep = st["rep"]
        if self.n_cloud:
            cold = rep.cold[rr, torch.clamp(code, 0, self.n_cloud - 1).long()]
        else:
            cold = torch.zeros(R, dtype=torch.bool, device=self.device)
        if self.has_edge:
            is_edge = code == self.edge_col
            cold = torch.where(is_edge, False, cold)
            wait = torch.where(is_edge, st["ew"], zeros)
            nom = st["nom"]
            gcode = torch.where(is_edge, self.n_cloud + nom, code.long())
        else:
            wait = zeros
            nom = torch.full((R,), -1, dtype=torch.long, device=self.device)
            gcode = code.long()
        return torch.stack([
            gcode.to(DTYPE), st["LAT"][rr, safe], st["COST"][rr, safe],
            cold.to(DTYPE), st["COMP"][rr, safe], wait, feas.to(DTYPE),
            allowed, nom.to(DTYPE)])

    def _walk_and_verify(self, P: dict, S: dict, R: int):
        """The chunk's decisions: the ``state_walk`` kernel decides every row
        from the exact sequential state, then ONE replay pass recomputes the
        state under those codes and the policy chooses again from it. One
        copy brings the verdict to the host (one sync a walk): the walk's
        overflow flag, whether the codes reproduce themselves (with the
        replay's own overflow) and the largest live-slot count of the
        replayed pools. The replay takes the walk's overflow flags as
        ``skip``: after a walk whose pool overflowed it does no work, and
        this returns ``None`` (the caller grows the pool and walks again);
        codes that do not reproduce are a fault of the walk or the replay
        and raise. Returns ``(st, code, feas, allowed, cnt_max)``."""
        g, walk_ovf = state_walk(
            P["nows"], P["n"], ecomp=P.get("ECOMP"), elat=P.get("ELAT"),
            h0=S.get("h0"), nom_fixed=P.get("nom_fixed"), lpw=self.lpw,
            latw=P.get("LATW"), latc=P.get("LATC"), costc=P.get("COSTC"),
            occw=P.get("OCCW"), occc=P.get("OCCC"), busy0=S.get("busy0"),
            last0=S.get("last0"), cnt0=S.get("cnt0"), t_idl=self.t_idl,
            minlat=self.is_minlat, c_max=P["c_max"], alpha=P["alpha"],
            s0=S.get("s0"), deadline=P["deadline"])
        st = self._state(g, P, S, skip=walk_ovf if self.n_cloud else None)
        if self.is_minlat:
            # two rounded ops — the oracle's c_max + alpha * s_before
            allowed = torch.add(torch.mul(st["s_before"], P["alpha"]),
                                P["c_max"])
        else:
            allowed = self._inf.expand(R)
        code, feas = self._choose(st["LAT"], st["COST"], allowed,
                                  P["deadline"], P["valid"])
        verdict = [(code != g).any()]
        if self.n_cloud:
            rep = st["rep"]
            verdict += [walk_ovf.any(), rep.overflow.any(), rep.cnt.max()]
        verdict = torch.stack([v.to(torch.int64) for v in verdict]).tolist()
        self.verify_syncs += 1
        bad = bool(verdict[0])
        cnt_max = 0
        if self.n_cloud:
            if verdict[1]:
                return None  # the walk's pool overflowed: grow it first
            bad |= bool(verdict[2])
            cnt_max = int(verdict[3])
        if bad:
            raise RuntimeError(
                "torch placement: the replay of the state_walk decisions "
                "does not reproduce them")
        return st, code, feas, allowed, cnt_max

    def _compact(self, busy, last, cnt, t_last: float):
        """Device-side stable pool compaction == the deferred reap (exact:
        monotone keep predicate, dead records never warm-reusable; kept
        records keep their relative order, preserving MRU tie-breaks)."""
        nc, cap = busy.shape
        slots = torch.arange(cap, device=busy.device)
        in_use = slots[None, :] < cnt[:, None]
        keep = in_use & ((t_last < busy) | (t_last <= last + self.t_idl))
        d = torch.where(keep, torch.cumsum(keep, dim=1) - 1, cap)
        nb = torch.full((nc, cap + 1), np.inf, dtype=DTYPE, device=busy.device)
        nl = torch.full((nc, cap + 1), -np.inf, dtype=DTYPE,
                        device=busy.device)
        nb.scatter_(1, d, busy)
        nl.scatter_(1, d, last)
        return (nb[:, :cap].contiguous(), nl[:, :cap].contiguous(),
                keep.sum(dim=1).to(I32))

    # ------------------------------------------------------------ residency
    def stage_chunk(self, tasks) -> dict:
        """Host prep + device upload of one chunk's task columns. Engine-state
        free, so ``runtime._prefetched_chunks`` runs it on its transfer
        thread while the previous chunk places. On CUDA the columns are
        copied from pinned host memory on a side stream; ``place_chunk``
        waits on the recorded event. Failures raise."""
        n = len(tasks)
        host = task_arrays(tasks)
        _, nows_np, sizes_np, nbytes_np = host
        R = max(PAD_MIN, _next_pow2(n))
        pad = R - n
        cols = np.stack([np.pad(a, (0, pad), mode="edge")
                         for a in (sizes_np, nbytes_np, nows_np)])
        staged = {"host": host, "event": None}
        if self.device.type == "cuda":
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(self.device)
            pinned = torch.from_numpy(cols).pin_memory()
            with torch.cuda.stream(self._copy_stream):
                dev = pinned.to(self.device, non_blocking=True)
                event = torch.cuda.Event()
                event.record(self._copy_stream)
            # the bundle keeps the pinned buffer alive past the async copy
            staged.update(dev=dev, event=event, pinned=pinned)
        else:
            staged["dev"] = torch.from_numpy(cols)
        return staged

    def sync_host(self, reason: str = "external") -> bool:
        """Materialize resident device state into the host CIL / queues /
        policy and drop residency. Idempotent — ``False`` when nothing is
        resident. These calls (stream end, fallback exits, ``sync_engine``)
        are the ONLY host<->device state sync points of a resident stream."""
        rs = self._resident
        if rs is None:
            return False
        self._resident = None
        if self.is_minlat and rs.s is not None:
            rs.policy.surplus = float(rs.s)
        if self.has_edge and rs.h is not None:
            h = rs.h.cpu().numpy()
            for d, e in enumerate(self.edges):
                rs.queues[e.name].horizon_ms = float(h[d])
        if self.n_cloud and rs.busy is not None:
            self._commit_pools(rs.cil, rs.busy.cpu().numpy(),
                               rs.last.cpu().numpy(), rs.cnt.cpu().numpy(),
                               rs.t_last)
        self.state_syncs += 1
        if reason == "fallback":
            self.fallback_syncs += 1
        return True

    def _commit_pools(self, cil, busyF, lastF, cntF, t_last):
        """The numpy accept step's pool writeback, with the reap at
        ``t_last`` == the per-arrival walk's end state."""
        for ci, c in enumerate(self.cloud):
            k = int(cntF[ci])
            b, l = busyF[ci, :k], lastF[ci, :k]
            keep = (t_last < b) | (t_last <= l + self.t_idl)
            recs = [ContainerRecord(c.name, float(bb), float(ll))
                    for bb, ll, kp in zip(b, l, keep) if kp]
            if recs:
                cil.containers[c.name] = recs
            else:
                cil.containers.pop(c.name, None)

    def _seed_state(self, rs, pools, cap, edge_queues, dev_names, policy):
        """The sequential-state seed ``S`` of a replay — from resident device
        tensors when a valid ``DeviceStreamState`` is held (widening the pools
        on the device when ``cap`` outgrew them), else from host state — plus
        the replay's reusable pool output buffers."""
        dev = self.device
        S: dict = {}
        nc = self.n_cloud
        if nc and rs is not None:
            busy, last = rs.busy, rs.last
            have = int(busy.shape[1])
            if cap > have:
                busy = torch.cat([busy, torch.full((nc, cap - have), np.inf,
                                                   dtype=DTYPE, device=dev)], 1)
                last = torch.cat([last, torch.full((nc, cap - have), -np.inf,
                                                   dtype=DTYPE, device=dev)], 1)
            S["busy0"], S["last0"], S["cnt0"] = busy, last, rs.cnt
        elif nc:
            busy0 = np.full((nc, cap), np.inf)
            last0 = np.full((nc, cap), -np.inf)
            cnt0 = np.zeros(nc, dtype=np.int32)
            for ci, recs in enumerate(pools):
                for j, rec in enumerate(recs):
                    busy0[ci, j] = rec.busy_until
                    last0[ci, j] = rec.last_completion
                cnt0[ci] = len(recs)
            S["busy0"] = torch.as_tensor(busy0, device=dev)
            S["last0"] = torch.as_tensor(last0, device=dev)
            S["cnt0"] = torch.as_tensor(cnt0, device=dev)
        if nc:
            spare = self._spare
            seeds = (S["busy0"], S["last0"], S["cnt0"])
            if spare is None or tuple(spare[0].shape) != (nc, cap) \
                    or any(x is y for x in spare for y in seeds):
                spare = (torch.empty((nc, cap), dtype=DTYPE, device=dev),
                         torch.empty((nc, cap), dtype=DTYPE, device=dev),
                         torch.empty(nc, dtype=I32, device=dev))
            self._spare = spare
            S["out"] = spare
        if self.has_edge:
            S["h0"] = rs.h if rs is not None else torch.as_tensor(
                np.array([edge_queues[nm].horizon_ms for nm in dev_names],
                         np.float64), device=dev)
        if self.is_minlat:
            S["s0"] = rs.s if rs is not None else torch.as_tensor(
                np.float64(policy.surplus), device=dev)
        return S

    # ----------------------------------------------------------- chunk entry
    def place_chunk(self, engine, tasks, edge_queues):
        """Run one chunk on the device; returns a ``DecisionBatch`` with
        committed host state (or, under ``serve_stream`` residency, state
        left ON THE DEVICE), or ``None`` to fall back — in which case any
        resident state is synced first so the host walk sees canonical
        state and no balancer/RNG state is consumed."""
        from repro_torch.core.decision import (
            DecisionBatch,
            RandomBalancer,
            RoundRobinBalancer,
        )

        dev = self.device
        n = len(tasks)
        staged = engine.__dict__.pop("_torch_staged", None)
        if staged is not None and staged[0] is not tasks:
            staged = None       # stale prefetch for some other chunk
        if staged is not None:
            task_idx, nows_np, sizes_np, nbytes_np = staged[1]["host"]
        else:
            task_idx, nows_np, sizes_np, nbytes_np = task_arrays(tasks)
        if not self.has_edge and self.is_minlat and not self.cloud:
            self.sync_host("fallback")
            return None  # nothing to choose from — let the walk raise
        if n > 1 and not bool(np.all(np.diff(nows_np) >= 0.0)):
            self.sync_host("fallback")
            return None  # out-of-order arrivals: host walk replays reaps

        residency = bool(engine.__dict__.get("_device_residency", False))
        if not residency:
            # an out-of-stream place_many while state is resident: the
            # per-chunk path needs canonical host state first
            self.sync_host("external")
        cil: ContainerInfoList = engine.predictor.cil
        policy = engine.policy
        rs = self._resident
        if rs is not None and (
                rs.cil is not cil or rs.policy is not policy
                or rs.queues is not edge_queues
                or (n and float(nows_np[0]) < rs.t_last)):
            # host-structure swap or a cross-chunk out-of-order arrival: the
            # resident state no longer shadows this stream — sync, then
            # re-enter residency from host state below
            self.sync_host("fallback")
            rs = None

        # Everything below may consume balancer state — no fallback past here.
        nom_fixed = None
        if self.has_edge and not self.lpw:
            if self.n_dev == 1:
                nom_fixed = np.zeros(n, dtype=np.int64)
            else:
                bal = engine.balancer
                if type(bal) is RoundRobinBalancer:
                    nom_fixed = (bal._i + np.arange(n, dtype=np.int64)) \
                        % self.n_dev
                    bal._i += n
                elif type(bal) is RandomBalancer:
                    nom_fixed = bal.rng.integers(
                        self.n_dev, size=n).astype(np.int64)

        R = max(PAD_MIN, _next_pow2(n))
        pad = R - n
        cloud_names = [c.name for c in self.cloud]
        dev_names = [e.name for e in self.edges]
        pools = [cil.containers.get(nm, []) for nm in cloud_names]
        if rs is not None:
            max_existing = int(rs.cnt_max)
            cap = rs.cap
        else:
            max_existing = max((len(p) for p in pools), default=0)
            cap = _next_pow2(max(self._cap_hint, POOL_MIN_CAP))

        if staged is not None:
            if staged[1]["event"] is not None:
                torch.cuda.current_stream(dev).wait_event(staged[1]["event"])
                staged[1]["dev"].record_stream(torch.cuda.current_stream(dev))
            cols = staged[1]["dev"]
        else:
            cols = torch.as_tensor(np.stack(
                [np.pad(a, (0, pad), mode="edge")
                 for a in (sizes_np, nbytes_np, nows_np)]), device=dev)
        sizes, nbytes, nows = cols[0], cols[1], cols[2]
        P = self._predict(sizes, nbytes)
        rr = torch.arange(R, device=dev)
        P["nows"] = nows.contiguous()
        P["n"] = n
        P["rr"] = rr
        P["valid"] = rr < n
        P["zero"] = torch.zeros((), dtype=DTYPE, device=dev)
        if self.has_edge:
            P["ECOST"] = torch.zeros((R, 1), dtype=DTYPE, device=dev)
            if nom_fixed is not None:
                P["nom_fixed"] = torch.as_tensor(
                    np.pad(nom_fixed, (0, pad)).astype(np.int32), device=dev)
        if self.is_minlat:
            P["c_max"] = float(policy.c_max)
            P["alpha"] = float(policy.alpha)
            P["deadline"] = 0.0
        else:
            P["c_max"] = 0.0
            P["alpha"] = 0.0
            P["deadline"] = float(policy.deadline_ms)

        compacted = rs is None   # host seeds arrive freshly reaped
        while True:
            if cap < max_existing + 1:
                cap = _next_pow2(max_existing + 1)
            S = self._seed_state(rs, pools, cap, edge_queues, dev_names,
                                 policy)
            out = self._walk_and_verify(P, S, R)
            if out is not None:
                break
            # pool too small for this chunk's cold starts: nothing was
            # committed (the seed is never written), so the chunk walks again
            self.pool_regrows += 1
            if rs is not None and not compacted:
                # reap ON THE DEVICE first — a long resident stream
                # accumulates dead records (the deferred reap), so
                # compaction usually beats growing the pool
                rs.busy, rs.last, rs.cnt = self._compact(
                    rs.busy, rs.last, rs.cnt, rs.t_last)
                rs.cap = int(rs.busy.shape[1])
                rs.cnt_max = int(rs.cnt.max())
                max_existing = rs.cnt_max
                compacted = True
                continue
            # ... against the overflow-proof existing + n slots, or the
            # largest pool the walk's block holds when that is smaller (a
            # re-walk costs a whole chunk; a larger pool costs ~nothing)
            new_cap = min(_next_pow2(max_existing + n), self.cap_limit)
            if new_cap <= cap:
                raise RuntimeError(
                    f"torch placement: a chunk of {n} rows needs more than "
                    f"{cap} container slots in one pool, the most the "
                    "state_walk kernel's block holds")
            cap = new_cap
        st, code, feas, allowed, cnt_max = out
        self._cap_hint = cap

        block = self._finalize(st, code, feas, allowed,
                               rr)[:, :n].cpu().numpy()
        rep = st["rep"]
        t_last = float(nows_np[-1])
        if residency:
            # ---- stay resident: committed state LIVES on the device -------
            if rs is None:
                rs = DeviceStreamState()
            if self.n_cloud:
                # the replay's output buffers become the next seed; the old
                # seed becomes the next pass's output buffer (in-place reuse)
                old = (S["busy0"], S["last0"], S["cnt0"])
                rs.busy, rs.last, rs.cnt = rep.busy, rep.last, rep.cnt
                rs.cnt_max = cnt_max
                self._spare = old
            if self.has_edge:
                rs.h = rep.h_fin
            if self.is_minlat:
                rs.s = st["s_fin"]
            rs.cap = cap
            rs.t_last = t_last
            rs.cil, rs.policy, rs.queues = cil, policy, edge_queues
            self._resident = rs
            self.resident_chunks += 1
        else:
            # ---- commit host state (the numpy accept step, once) ----------
            if self.is_minlat:
                policy.surplus = float(st["s_fin"])
            if self.has_edge:
                h_fin = rep.h_fin.cpu().numpy()
                for d, nm in enumerate(dev_names):
                    edge_queues[nm].horizon_ms = float(h_fin[d])
            if self.n_cloud:
                self._commit_pools(cil, rep.busy.cpu().numpy(),
                                   rep.last.cpu().numpy(),
                                   rep.cnt.cpu().numpy(), t_last)
            self.chunk_commits += 1

        gcode, lat, cost, cold, comp, wait, feas_h, allowed_h, nom_h = block
        engine.columnar_stats = {"chunks": 1, "repairs": 0, "walked": 0,
                                 "n": n}
        engine.torch_stats = {"n": n, "rows": R,
                              "pool_cap": cap, "resident": residency,
                              "staged": staged is not None,
                              "device": str(dev)}
        return DecisionBatch(
            batch=None,
            names=tuple(cloud_names) + tuple(dev_names),
            n_cloud=self.n_cloud,
            task_idx=task_idx,
            target_codes=gcode.astype(np.int64),
            latency_ms=lat.copy(),
            cost=cost.copy(),
            cold=cold.astype(bool),
            comp_ms=comp.copy(),
            queue_wait_ms=wait.copy(),
            feasible=feas_h.astype(bool),
            allowed_cost=allowed_h.copy(),
            edge_device_codes=(nom_h.astype(np.int64) if self.has_edge
                               else None),
            batch_factory=lambda pred=engine.predictor, ts=tasks:
                pred.predict_batch(ts),
        )


# ------------------------------------------------------------------ caching
def core_for(engine) -> TorchPlacementCore | None:
    """The engine's cached core, rebuilt when model identities / policy /
    device / kernel mode change; ``None`` when the engine shape is
    ineligible."""
    key = _engine_key(engine)
    hit = engine.__dict__.get("_torch_core_cache")
    if hit is not None and hit[0] == key:
        core = hit[1]
        if core is None or core.valid_for(engine):
            return core
    if hit is not None and hit[1] is not None:
        # the outgoing core may hold resident stream state (a hedged-policy
        # swap mid-stream changes the key): materialize before replacing,
        # or the unsynced device state would be orphaned
        hit[1].sync_host("fallback")
    try:
        core = TorchPlacementCore(engine)
    except CoreIneligible:
        core = None
    engine.__dict__["_torch_core_cache"] = (key, core)
    return core


def sync_engine(engine, reason: str = "external") -> bool:
    """Materialize any device-resident stream state this engine's core holds
    back into the host CIL / queues / policy — the hook for external
    consumers (twin executors, admission snapshots, direct state reads).
    Safe no-op (``False``) when nothing is resident."""
    hit = engine.__dict__.get("_torch_core_cache")
    if hit is not None and hit[1] is not None:
        return hit[1].sync_host(reason)
    return False
