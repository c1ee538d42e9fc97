"""Every configuration, cell, traffic kind and per-layer metric that
BENCHMARK.json names is found by its name, and the file keeps to the
benchmark's contract."""

import re

import pytest

import pb_common as pc

BENCH = pc.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_configs_resolve(cfg):
    assert pc.ROOT.joinpath(cfg["file"]) == pc.config_file(cfg["name"])
    data = pc.load_config(cfg["name"])
    assert data["program"]["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"]
    assert hasattr(pc.reference_module(cfg["name"]), "outputs")
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(w):
    assert NAME.match(w["name"]) and w["chips"] == 1
    assert len(w["why"]) <= 200
    wl = pc.load_workload(w["name"])
    assert hasattr(pc.traffic_module(wl["traffic"]["kind"]), "stream")
    assert "logit_err" in wl["check"]["limits"]
    assert set(wl["check"]["limits"]) <= {"logit_err", "kv_err"}
    for kind in ("end_to_end", "per_layer"):
        assert pc.metrics_of(BENCH, kind, w["name"])


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_readers_resolve(m):
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert callable(pc.metric_reader(m["name"]).read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    names = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", names)) <= names


def test_end_to_end_bounds():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(set(names)) == len(names)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        pc.cell_entry(BENCH, "no-such-cell")
    with pytest.raises(FileNotFoundError):
        pc.metric_reader("no_such_metric")
