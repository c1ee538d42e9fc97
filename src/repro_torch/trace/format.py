"""The versioned trace format: recorded arrival traffic as columnar arrays.

A trace is the EdgeBench-style record of one stretch of real traffic: per
arrival a timestamp, an application name, the input size feature and payload
bytes, and optionally the latency that was observed when the arrival was
originally served. Two interchangeable encodings carry the same schema, and
the files are interchangeable with the JAX package's ``repro.trace``:

- **JSONL** (``.jsonl``): a header line ``{"schema": "repro.trace",
  "version": 1, "apps": [...], "n": ..., "lat": true|false}`` followed by
  one record per line — human-greppable, appendable, diff-able. Floats are
  written with Python's shortest round-tripping ``repr``, so a JSONL round
  trip is BIT-EXACT. The header's ``"lat"`` mark says whether the trace
  carries an observed-latency column, so an EMPTY trace with the column
  loads back with it; a header without the mark (files written by the JAX
  package, which ignores the mark when it reads) falls back to inferring the
  column from the rows.
- **NPZ** (``.npz``): the columns saved directly — the fast path for large
  traces (no per-row JSON), trivially bit-exact.

Loading VALIDATES by default and rejects malformed traces with the offending
record named — unsorted timestamps, NaN/negative sizes, out-of-range app
codes — instead of letting bad data propagate into the serve path (where an
unsorted stream silently drops to the slow per-task walk and NaN sizes poison
every prediction downstream).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from typing import Mapping, Sequence

import numpy as np

from repro_torch.core.workload import TaskChunk, first_disorder, task_arrays

TRACE_SCHEMA = "repro.trace"
TRACE_SCHEMA_VERSION = 1


class TraceError(ValueError):
    """A malformed trace: wrong schema, unsorted, NaN/negative, unknown app."""


def _col(name: str, values, dtype) -> np.ndarray:
    a = np.asarray(values, dtype=dtype)
    if a.ndim != 1:
        raise TraceError(f"trace column {name!r} must be 1-D, got shape {a.shape}")
    return a


@dataclass(eq=False)
class Trace:
    """One recorded stretch of traffic, struct-of-arrays.

    ``app_codes[i]`` indexes ``app_names`` — a single-app trace has one name
    and an all-zero code column. ``observed_latency_ms`` is optional: set when
    the trace was captured from a served run (twin or live), so replays can be
    compared against what actually happened.
    """

    arrival_ms: np.ndarray              # (n,) float64, nondecreasing
    size: np.ndarray                    # (n,) float64 — model input feature
    bytes: np.ndarray                   # (n,) float64 — payload for transfer
    app_codes: np.ndarray               # (n,) int64 into app_names
    app_names: tuple[str, ...]
    observed_latency_ms: np.ndarray | None = None
    meta: dict = field(default_factory=dict)
    version: int = TRACE_SCHEMA_VERSION

    # ------------------------------------------------------------ construction
    @classmethod
    def from_arrays(cls, arrival_ms, size, bytes, app_codes=None,
                    app_names: Sequence[str] = ("app",),
                    observed_latency_ms=None, meta: dict | None = None,
                    validate: bool = True) -> "Trace":
        arrival_ms = _col("arrival_ms", arrival_ms, np.float64)
        n = arrival_ms.shape[0]
        if app_codes is None:
            app_codes = np.zeros(n, dtype=np.int64)
        t = cls(
            arrival_ms=arrival_ms,
            size=_col("size", size, np.float64),
            bytes=_col("bytes", bytes, np.float64),
            app_codes=_col("app_codes", app_codes, np.int64),
            app_names=tuple(app_names),
            observed_latency_ms=None if observed_latency_ms is None
            else _col("observed_latency_ms", observed_latency_ms, np.float64),
            meta=dict(meta or {}),
        )
        if validate:
            t.validate()
        return t

    @classmethod
    def from_tasks(cls, tasks, app: str = "app",
                   meta: dict | None = None) -> "Trace":
        """A single-app trace from any task container (list or ``TaskChunk``)."""
        _, arrivals, sizes, nbytes = task_arrays(tasks, "asb")
        return cls.from_arrays(arrivals, sizes, nbytes, app_names=(app,),
                               meta=meta)

    # --------------------------------------------------------------- basic API
    @property
    def n(self) -> int:
        return self.arrival_ms.shape[0]

    def __len__(self) -> int:
        return self.n

    @property
    def duration_ms(self) -> float:
        if self.n == 0:
            return 0.0
        return float(self.arrival_ms[-1] - self.arrival_ms[0])

    def equal(self, other: "Trace") -> bool:
        """Bit-exact equality of every column (ignores ``meta``)."""
        if self.n != other.n or self.app_names != other.app_names:
            return False
        if (self.observed_latency_ms is None) != (other.observed_latency_ms is None):
            return False
        cols = (np.array_equal(self.arrival_ms, other.arrival_ms)
                and np.array_equal(self.size, other.size)
                and np.array_equal(self.bytes, other.bytes)
                and np.array_equal(self.app_codes, other.app_codes))
        if not cols:
            return False
        if self.observed_latency_ms is not None:
            return np.array_equal(self.observed_latency_ms,
                                  other.observed_latency_ms)
        return True

    # ------------------------------------------------------------- validation
    def validate(self) -> "Trace":
        """Reject malformed traces with the offending record named.

        Returns ``self`` so construction sites can chain. The checks exist to
        fail *at ingestion* — an unsorted trace would otherwise silently drop
        ``serve_stream`` into the per-task-walk fallback, and NaN/negative
        sizes would poison every component-model prediction downstream.
        """
        if self.version > TRACE_SCHEMA_VERSION:
            raise TraceError(
                f"trace schema version {self.version} is newer than the "
                f"supported version {TRACE_SCHEMA_VERSION} — upgrade "
                "repro_torch or re-export the trace at the older version")
        n = self.n
        for name in ("size", "bytes", "app_codes"):
            col = getattr(self, name)
            if col.shape[0] != n:
                raise TraceError(
                    f"trace column {name!r} has {col.shape[0]} records but "
                    f"arrival_ms has {n}")
        if self.observed_latency_ms is not None \
                and self.observed_latency_ms.shape[0] != n:
            raise TraceError(
                f"trace column 'observed_latency_ms' has "
                f"{self.observed_latency_ms.shape[0]} records but arrival_ms "
                f"has {n}")
        if not self.app_names:
            raise TraceError("trace has no app names")
        if len(set(self.app_names)) != len(self.app_names):
            raise TraceError(f"duplicate app names: {self.app_names}")

        bad = np.nonzero(~np.isfinite(self.arrival_ms))[0]
        if bad.size:
            i = int(bad[0])
            raise TraceError(
                f"trace record {i}: non-finite arrival_ms "
                f"{self.arrival_ms[i]!r}")
        i = first_disorder(self.arrival_ms)
        if i >= 0:
            raise TraceError(
                f"trace arrivals unsorted at record {i}: "
                f"arrival_ms[{i}]={float(self.arrival_ms[i])!r} < "
                f"arrival_ms[{i - 1}]={float(self.arrival_ms[i - 1])!r} — "
                "sort the trace by arrival time before replay (an unsorted "
                "stream would silently fall back to the slow per-task walk)")
        for name in ("size", "bytes"):
            col = getattr(self, name)
            bad = np.nonzero(np.isnan(col))[0]
            if bad.size:
                raise TraceError(f"trace record {int(bad[0])}: NaN {name}")
            bad = np.nonzero(col < 0.0)[0]
            if bad.size:
                i = int(bad[0])
                raise TraceError(
                    f"trace record {i}: negative {name} {float(col[i])!r}")
        bad = np.nonzero((self.app_codes < 0)
                         | (self.app_codes >= len(self.app_names)))[0]
        if bad.size:
            i = int(bad[0])
            raise TraceError(
                f"trace record {i}: app code {int(self.app_codes[i])} out of "
                f"range for apps {self.app_names}")
        if self.observed_latency_ms is not None:
            lat = self.observed_latency_ms
            bad = np.nonzero(np.isnan(lat) | (lat < 0.0))[0]
            if bad.size:
                i = int(bad[0])
                raise TraceError(
                    f"trace record {i}: invalid observed_latency_ms "
                    f"{float(lat[i])!r}")
        return self

    # ---------------------------------------------------------- app filtering
    def for_app(self, app: str) -> "Trace":
        """The single-app sub-trace of ``app``, original order preserved."""
        if app not in self.app_names:
            raise TraceError(
                f"unknown app {app!r}: this trace's apps are "
                f"{list(self.app_names)}")
        mask = self.app_codes == self.app_names.index(app)
        return Trace(
            arrival_ms=self.arrival_ms[mask],
            size=self.size[mask],
            bytes=self.bytes[mask],
            app_codes=np.zeros(int(np.count_nonzero(mask)), dtype=np.int64),
            app_names=(app,),
            observed_latency_ms=None if self.observed_latency_ms is None
            else self.observed_latency_ms[mask],
            meta=dict(self.meta),
            version=self.version,
        )

    def split_by_app(self) -> dict[str, "Trace"]:
        """One single-app trace per app — the deterministic, order-preserving
        split behind multi-app shard replay (``repro_torch.trace.trace_shards``):
        within each app the records keep their original relative order, so a
        shard's stream is exactly the trace filtered to that app up front."""
        return {app: self.for_app(app) for app in self.app_names}

    def prefix(self, n: int) -> "Trace":
        """The first ``n`` records (what successive-halving rungs replay)."""
        n = max(0, min(int(n), self.n))
        return Trace(
            arrival_ms=self.arrival_ms[:n], size=self.size[:n],
            bytes=self.bytes[:n], app_codes=self.app_codes[:n],
            app_names=self.app_names,
            observed_latency_ms=None if self.observed_latency_ms is None
            else self.observed_latency_ms[:n],
            meta=dict(self.meta), version=self.version,
        )

    def task_chunk(self) -> TaskChunk:
        """The whole trace as one columnar ``TaskChunk`` (array views)."""
        return TaskChunk(idx=np.arange(self.n, dtype=np.int64),
                         arrival_ms=self.arrival_ms, size=self.size,
                         bytes=self.bytes)

    # ----------------------------------------------------------------- JSONL
    def save_jsonl(self, path) -> None:
        lat = self.observed_latency_ms
        header = {"schema": TRACE_SCHEMA, "version": self.version,
                  "apps": list(self.app_names), "n": int(self.n),
                  "lat": lat is not None}
        if self.meta:
            header["meta"] = self.meta
        with open(path, "w") as f:
            f.write(json.dumps(header) + "\n")
            for i in range(self.n):
                row = {"t": float(self.arrival_ms[i]),
                       "app": int(self.app_codes[i]),
                       "size": float(self.size[i]),
                       "bytes": float(self.bytes[i])}
                if lat is not None:
                    row["lat"] = float(lat[i])
                f.write(json.dumps(row) + "\n")

    # ------------------------------------------------------------------- NPZ
    def save_npz(self, path) -> None:
        data = {
            "schema_version": np.array(self.version, dtype=np.int64),
            "arrival_ms": self.arrival_ms,
            "size": self.size,
            "bytes": self.bytes,
            "app_codes": self.app_codes,
            "app_names": np.array(self.app_names, dtype=np.str_),
            "meta_json": np.array(json.dumps(self.meta), dtype=np.str_),
        }
        if self.observed_latency_ms is not None:
            data["observed_latency_ms"] = self.observed_latency_ms
        np.savez(path, **data)

    def save(self, path) -> None:
        """Dispatch on extension: ``.jsonl``/``.json`` or ``.npz``."""
        p = str(path)
        if p.endswith(".npz"):
            self.save_npz(path)
        elif p.endswith((".jsonl", ".json")):
            self.save_jsonl(path)
        else:
            raise TraceError(
                f"cannot infer trace format from {p!r} — use a .jsonl or "
                ".npz extension, or call save_jsonl/save_npz directly")


def load_jsonl(path, validate: bool = True) -> Trace:
    """Load a JSONL trace; validates by default (see ``Trace.validate``)."""
    with open(path) as f:
        first = f.readline()
        if not first.strip():
            raise TraceError(f"{path}: empty file, expected a trace header line")
        try:
            header = json.loads(first)
        except json.JSONDecodeError as e:
            raise TraceError(f"{path}: line 1 is not valid JSON ({e})") from e
        if not isinstance(header, dict) or header.get("schema") != TRACE_SCHEMA:
            raise TraceError(
                f"{path}: line 1 is not a {TRACE_SCHEMA!r} header "
                f"(got {header!r:.120}) — JSONL traces start with "
                '{"schema": "repro.trace", "version": 1, "apps": [...]}')
        version = int(header.get("version", 0))
        if version > TRACE_SCHEMA_VERSION:
            raise TraceError(
                f"{path}: schema version {version} is newer than the "
                f"supported version {TRACE_SCHEMA_VERSION}")
        apps = header.get("apps")
        if not isinstance(apps, list) or not apps:
            raise TraceError(f"{path}: header has no 'apps' list")
        has_lat = header.get("lat")  # None: infer the column from the rows
        if has_lat not in (None, True, False):
            raise TraceError(
                f"{path}: header 'lat' must be true or false, got {has_lat!r}")
        arrivals: list[float] = []
        sizes: list[float] = []
        nbytes: list[float] = []
        codes: list[int] = []
        lats: list[float] = []
        for lineno, line in enumerate(f, start=2):
            if not line.strip():
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError as e:
                raise TraceError(
                    f"{path}: line {lineno} is not valid JSON ({e})") from e
            try:
                arrivals.append(float(row["t"]))
                codes.append(int(row["app"]))
                sizes.append(float(row["size"]))
                nbytes.append(float(row["bytes"]))
            except KeyError as e:
                raise TraceError(
                    f"{path}: line {lineno} is missing field {e.args[0]!r} "
                    "(records carry t/app/size/bytes[/lat])") from e
            if has_lat is not None and ("lat" in row) != has_lat:
                raise TraceError(
                    f"{path}: line {lineno} "
                    + ("is missing 'lat' but the header marks"
                       if has_lat else "has 'lat' but the header marks no")
                    + " observed-latency column — observed latency is "
                    "all-or-none")
            if "lat" in row:
                if len(lats) != len(arrivals) - 1:
                    raise TraceError(
                        f"{path}: line {lineno} has 'lat' but an earlier "
                        "record does not — observed latency is all-or-none")
                lats.append(float(row["lat"]))
            elif lats:
                raise TraceError(
                    f"{path}: line {lineno} is missing 'lat' but earlier "
                    "records carry it — observed latency is all-or-none")
    t = Trace(
        arrival_ms=np.array(arrivals, dtype=np.float64),
        size=np.array(sizes, dtype=np.float64),
        bytes=np.array(nbytes, dtype=np.float64),
        app_codes=np.array(codes, dtype=np.int64),
        app_names=tuple(str(a) for a in apps),
        observed_latency_ms=np.array(lats, dtype=np.float64)
        if (lats if has_lat is None else has_lat) else None,
        meta=dict(header.get("meta") or {}),
        version=version,
    )
    return t.validate() if validate else t


def load_npz(path, validate: bool = True) -> Trace:
    """Load an NPZ trace; validates by default (see ``Trace.validate``)."""
    with np.load(path, allow_pickle=False) as z:
        missing = [k for k in ("schema_version", "arrival_ms", "size",
                               "bytes", "app_codes", "app_names")
                   if k not in z.files]
        if missing:
            raise TraceError(
                f"{path}: not a {TRACE_SCHEMA!r} NPZ archive — missing "
                f"arrays {missing}")
        version = int(z["schema_version"])
        if version > TRACE_SCHEMA_VERSION:
            raise TraceError(
                f"{path}: schema version {version} is newer than the "
                f"supported version {TRACE_SCHEMA_VERSION}")
        meta = {}
        if "meta_json" in z.files:
            meta = json.loads(str(z["meta_json"]))
        t = Trace(
            arrival_ms=z["arrival_ms"].astype(np.float64, copy=True),
            size=z["size"].astype(np.float64, copy=True),
            bytes=z["bytes"].astype(np.float64, copy=True),
            app_codes=z["app_codes"].astype(np.int64, copy=True),
            app_names=tuple(str(a) for a in z["app_names"].tolist()),
            observed_latency_ms=z["observed_latency_ms"].astype(
                np.float64, copy=True)
            if "observed_latency_ms" in z.files else None,
            meta=meta,
            version=version,
        )
    return t.validate() if validate else t


def load(path, validate: bool = True) -> Trace:
    """Load a trace, dispatching on extension (``.jsonl``/``.json``/``.npz``)."""
    p = str(path)
    if p.endswith(".npz"):
        return load_npz(path, validate=validate)
    if p.endswith((".jsonl", ".json")):
        return load_jsonl(path, validate=validate)
    raise TraceError(
        f"cannot infer trace format from {p!r} — use a .jsonl or .npz "
        "extension, or call load_jsonl/load_npz directly")


def merge(traces: Mapping[str, Trace]) -> Trace:
    """Interleave single-app traces into one multi-app trace by arrival time.

    The sort is stable with ties broken by mapping order, so
    ``merge(t.split_by_app()).equal(t)`` holds for any valid multi-app trace
    whose per-app streams came from that same split — the round-trip behind
    sharded replay and ``capture_sharded``.
    """
    if not traces:
        raise TraceError("merge needs at least one trace")
    names: list[str] = []
    arr, size, nbytes, codes, lats = [], [], [], [], []
    any_lat = any(t.observed_latency_ms is not None for t in traces.values())
    all_lat = all(t.observed_latency_ms is not None for t in traces.values())
    if any_lat and not all_lat:
        raise TraceError(
            "cannot merge traces where only some carry observed_latency_ms "
            "— observed latency is all-or-none")
    for app, t in traces.items():
        if len(t.app_names) != 1:
            raise TraceError(
                f"merge takes single-app traces; {app!r} has apps "
                f"{list(t.app_names)} (split_by_app() first)")
        names.append(app)
        arr.append(t.arrival_ms)
        size.append(t.size)
        nbytes.append(t.bytes)
        codes.append(np.full(t.n, len(names) - 1, dtype=np.int64))
        if all_lat:
            lats.append(t.observed_latency_ms)
    arrival = np.concatenate(arr)
    order = np.argsort(arrival, kind="stable")
    return Trace(
        arrival_ms=arrival[order],
        size=np.concatenate(size)[order],
        bytes=np.concatenate(nbytes)[order],
        app_codes=np.concatenate(codes)[order],
        app_names=tuple(names),
        observed_latency_ms=np.concatenate(lats)[order] if all_lat else None,
    ).validate()
