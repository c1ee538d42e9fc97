"""What every part of the benchmark shares: where its files are, how a
configuration, a cell, a traffic generator or a metric reader is found by
its name, and the metric arithmetic.

Everything that belongs to one configuration, one cell or one per-layer
metric sits in a file of its own under this folder, found by the name that
``BENCHMARK.json`` gives it:

- ``configs/<config>.json``: the sizes the program is built with (``program``)
  and the published configuration they come from (``source_config``);
- ``reference/<config>.py``: the plain float32 reference of that model;
- ``workloads/<cell>.json``: the cell's traffic, serving and check
  parameters; its ``traffic.kind`` names ``traffic/<kind>.py``;
- ``metrics/<metric>.py``: the reader of one per-layer metric.

The arithmetic (mean, percentile, the paper's latency error, quartile
spread) is written out here rather than taken from the program's
``SimulationResult``, so that a change to the program cannot change what a
metric means.
"""

from __future__ import annotations

import importlib.util
import json
import math
import statistics
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

_MODULES: dict[Path, object] = {}


def log(msg: str) -> None:
    """Progress goes to standard error: standard output carries the result
    line alone."""
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def load_module(path: Path):
    """Import ``path`` by its location, once per process. The module's name
    is derived from its path, so files named after cells or metrics (which
    may hold ``-`` and ``.``) load like any other."""
    path = Path(path).resolve()
    mod = _MODULES.get(path)
    if mod is not None:
        return mod
    if not path.is_file():
        raise FileNotFoundError(f"no such benchmark file: {path}")
    rel = path.relative_to(HERE).with_suffix("")
    name = "perfbench_" + "_".join(
        "".join(c if c.isalnum() else "_" for c in part) for part in rel.parts)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    _MODULES[path] = mod
    return mod


def config_file(name: str) -> Path:
    return HERE / "configs" / f"{name}.json"


def load_config(name: str) -> dict:
    return load_json(config_file(name))


def reference_module(config_name: str):
    return load_module(HERE / "reference" / f"{config_name}.py")


def load_workload(name: str) -> dict:
    return load_json(HERE / "workloads" / f"{name}.json")


def traffic_module(kind: str):
    return load_module(HERE / "traffic" / f"{kind}.py")


def metric_reader(name: str):
    return load_module(HERE / "metrics" / f"{name}.py")


def cell_entry(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                   f"{[w['name'] for w in bench['workloads']]}")


def metrics_of(bench: dict, kind: str, cell: str) -> list[dict]:
    """The ``end_to_end`` or ``per_layer`` metrics that ``cell`` reports:
    those without a ``workloads`` key and those that list it."""
    return [m for m in bench[kind]
            if "workloads" not in m or cell in m["workloads"]]


# ------------------------------------------------------------- arithmetic
def mean(xs) -> float:
    xs = [float(x) for x in xs]
    if not xs:
        raise ValueError("mean of no values")
    return math.fsum(xs) / len(xs)


def percentile(xs, q: float) -> float:
    """The ``q``-th percentile by linear interpolation between the two
    closest ranks (numpy's default rule)."""
    xs = sorted(float(x) for x in xs)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def latency_error_pct(predicted, actual) -> float:
    """The paper's latency prediction error: the gap between the mean
    predicted and the mean actual latency, over the mean actual."""
    a = mean(actual)
    return abs(mean(predicted) - a) / max(a, 1e-9) * 100.0


def spread(values) -> float:
    """Interquartile distance over the median (``statistics.quantiles``
    with ``n=4``, its default exclusive method)."""
    q1, med, q3 = statistics.quantiles([float(v) for v in values], n=4)
    return (q3 - q1) / abs(med) if med else float("inf")
