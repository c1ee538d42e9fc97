"""The readers of the program's spans (``pb_spans``, ``metrics/*``,
``spans_run.py``) on a small chrome trace and span list made by hand, and
one tiny run on the CPU with the recorder on.

The hand-made stretch: 2000 us of wall time, kernels from 100 to 1250 us
(busy 595 us); gaps of 5 us (under 20 us), 100 us ending at a kernel
launched inside ``exec.launch``, 200 us inside ``exec.feed`` under
``pool.dispatch``, 200 us inside ``serve.place`` and 50 us ending at a
kernel with no runtime call; 850 us before the first kernel and after the
last."""

import json
import sys
from types import SimpleNamespace

import pytest
import torch

import pb_common as pc

sys.path.insert(0, str(pc.ROOT / "src"))

import pb_harness  # noqa: E402
import pb_spans  # noqa: E402
import spans_run  # noqa: E402
from repro_torch import spans  # noqa: E402
from test_perfbench_check import SMALL, TINY  # noqa: E402

BASE_NS = 1_790_000_000_000_000_000
# native thread ids: the trace gives the main thread's host events its
# native id, a worker's CUDA runtime calls the low 32 bits of its pthread
# id as a signed int32's magnitude
MAIN, NATIVE_WORKER = 11, 12
IDENT = {MAIN: 0x7F00_1234_5678, NATIVE_WORKER: 0x7F00_E1DF_A6C0}
WORKER = 0x100000000 - 0xE1DFA6C0
KERNELS = [  # (start us, end us, correlation, launching thread or None)
    (100, 200, 1, MAIN), (205, 300, 2, WORKER), (400, 500, 3, WORKER),
    (700, 800, 4, WORKER), (1000, 1100, 5, MAIN), (1150, 1200, 6, None),
    (1180, 1250, 7, MAIN)]
# (name, start us, end us, thread, id, parent id)
SPANS = [("serve.slice", 0, 1900, MAIN, 1, 0),
         ("serve.place", 900, 1120, MAIN, 2, 1),
         ("serve.execute", 50, 890, MAIN, 3, 1),
         ("pool.dispatch", 60, 880, NATIVE_WORKER, 4, 3),
         ("exec", 70, 870, NATIVE_WORKER, 5, 4),
         ("exec.launch", 310, 520, NATIVE_WORKER, 6, 5),
         ("exec.feed", 600, 790, NATIVE_WORKER, 7, 5),
         ("cold.weights", 0, 40, MAIN, 8, 0),
         ("cold.weights", 0, 60, MAIN, 9, 0),
         ("cold.capture", 0, 10, MAIN, 10, 0),
         ("calibrate", 0, 2_500_000, MAIN, 11, 0)]
WALL_S = 2000e-6


def events():
    ev = [{"ph": "X", "cat": "kernel", "name": f"k{c}", "ts": float(s),
           "dur": float(e - s), "args": {"correlation": c}}
          for s, e, c, _ in KERNELS]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaGraphLaunch",
            "ts": float(s) - 3.0, "dur": 2.0, "tid": tid,
            "args": {"correlation": c}}
           for s, _, c, tid in KERNELS if tid is not None]
    ev.append({"ph": "X", "cat": "user_annotation", "name": "pb.place_many",
               "ts": 905.0, "dur": 200.0, "tid": MAIN})
    return ev


def recorded():
    return [SimpleNamespace(name=n, start_ns=int(a * 1000),
                            end_ns=int(b * 1000), tid=t, ident=IDENT[t],
                            id=i, parent=p, attrs={})
            for n, a, b, t, i, p in SPANS]


ANCHOR = spans.Anchor(unix_ns=BASE_NS, perf_ns=0)


def write_trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"baseTimeNanoseconds": BASE_NS,
                                "traceEvents": events()}))
    return path


def span_ctx(tmp_path):
    """``_read_trace``'s context of the hand-made trace, with the spans'
    keys added as ``spans_run`` adds them."""
    kept = {}
    ctx = spans_run.span_read_trace(pb_harness._read_trace,
                                    write_trace(tmp_path), WALL_S, kept=kept)
    ctx.update(spans=recorded(), span_anchor=ANCHOR)
    return ctx, kept


def test_each_gap_is_counted_once(tmp_path):
    ctx, _ = span_ctx(tmp_path)
    assert [g[:2] for g in ctx["gaps"]] == [
        (200.0, 205.0), (300.0, 400.0), (500.0, 700.0), (800.0, 1000.0),
        (1100.0, 1150.0)]
    assert [g[2:] for g in ctx["gaps"]] == [
        (WORKER, "k2"), (WORKER, "k3"), (WORKER, "k4"), (MAIN, "k5"),
        (None, "k6")]
    split = pb_spans.idle_split(ctx)
    assert split["gaps_attributed"] == 4 and split["unlinked"] == 1
    assert split["short"] == pytest.approx(5e-6)
    assert split["launch"] == pytest.approx(100e-6)
    assert split["pool"] == pytest.approx(200e-6)
    assert split["serve"] == pytest.approx((200 + 50 + 850) * 1e-6)
    assert split["by_span"] == pytest.approx({
        "exec.launch": 100e-6, "exec.feed": 200e-6, "serve.place": 200e-6,
        "none": 50e-6})
    assert split["by_kernel"] == pytest.approx({
        "k4": 200e-6, "k5": 200e-6, "k3": 100e-6, "k6": 50e-6})


def test_the_shares_make_up_idle_pct(tmp_path):
    ctx, _ = span_ctx(tmp_path)
    parts = [pc.metric_reader(n).read(ctx) for n in
             ("launch_idle_pct", "pool_idle_pct", "serve_idle_pct")]
    short = 100.0 * pb_spans.idle_split(ctx)["short"] / ctx["trace_window_s"]
    idle = pc.metric_reader("idle_pct").read(ctx)
    assert idle == pytest.approx(100.0 * (1 - 595e-6 / WALL_S), abs=1e-9)
    assert abs(sum(parts) + short - idle) < 1e-9
    assert parts == pytest.approx([5.0, 10.0, 55.0])


def test_read_trace_keeps_its_keys_and_readers_their_values(tmp_path):
    plain = pb_harness._read_trace(write_trace(tmp_path), WALL_S)
    ctx, _ = span_ctx(tmp_path)
    assert set(ctx) - set(plain) == {"gaps", "trace_base_ns", "spans",
                                     "span_anchor"}
    for k, v in plain.items():
        assert ctx[k] == v, k
    assert pc.metric_reader("idle_pct").read(ctx) \
        == pc.metric_reader("idle_pct").read(plain)


def test_set_up_readers(tmp_path):
    ctx, _ = span_ctx(tmp_path)
    read = {n: pc.metric_reader(n).read(ctx) for n in
            ("cold_weights_ms", "cold_capture_ms", "calibrate_s")}
    assert read == pytest.approx({"cold_weights_ms": 0.05,
                                  "cold_capture_ms": 0.01,
                                  "calibrate_s": 2.5})


@pytest.mark.parametrize("name", [m["name"] for m in spans_run.SPAN_METRICS])
def test_readers_find_nothing_without_spans(tmp_path, name):
    """A program without spans (or a run with the recorder off) gives no
    value and raises nothing."""
    plain = pb_harness._read_trace(write_trace(tmp_path), WALL_S)
    assert pc.metric_reader(name).read(plain) is None
    assert pc.metric_reader(name).read({**plain, "spans": [],
                                        "span_anchor": None}) is None


def test_alignment_on_the_trace():
    got = spans_run.alignment(events(), recorded(), ANCHOR, BASE_NS)
    assert got["place_start_us"]["median"] == pytest.approx(5.0)
    assert got["place_end_us"]["median"] == pytest.approx(15.0)
    # the launches of kernels 3 (inside exec.launch) and no other
    assert got["graph_launches"] == 6
    assert got["graph_launches_in_exec_launch"] == 1
    assert got["launch_after_span_start_us"]["min"] == pytest.approx(87.0)
    assert got["launch_before_span_end_us"]["min"] == pytest.approx(121.0)


def test_trace_tids():
    main, worker = recorded()[0], recorded()[3]
    assert pb_spans.trace_tids(main) == {MAIN, 0x12345678}
    assert pb_spans.trace_tids(worker) == {NATIVE_WORKER, WORKER}


def test_span_metrics_keep_the_contract():
    names = {m["name"] for m in pc.benchmark()["per_layer"]}
    layers = {m["layer"] for m in pc.benchmark()["per_layer"]}
    for m in spans_run.SPAN_METRICS:
        assert m["name"] not in names
        assert callable(pc.metric_reader(m["name"]).read)
        assert m["source"] == "program_span"
        assert m["layer"] in layers | {"serve loop"}
        assert set(m["workloads"]) == {w["name"] for w in
                                       pc.benchmark()["workloads"]}


def test_tiny_run_with_spans_on():
    """A run on the CPU with the recorder on: the end-to-end metrics, the
    set-up by span, and every cold execution of the window within 2% of
    its record's ``start_ms``; the recorder is off again afterwards."""
    torch.manual_seed(0)
    out = spans_run.run("mamba2-long", 2**31 + 7, 0.5, False, True,
                        device="cpu", config_overrides=TINY["mamba2-long"],
                        workload_overrides=SMALL, log=lambda m: None)
    assert out["correct"] and "tasks_per_s" in out["metrics"]
    setup = out["spans"]["setup"]
    assert setup["calibrate"] > 0.0 and setup["pool.make"] > 0.0
    assert setup["calibrate"] >= setup["calibrate.cold"] \
        + setup["calibrate.warm"] + setup["calibrate.fit"]
    assert setup["edge_reseed"] > 0.0
    assert setup["before_window"]["cold.weights"]["n"] >= 1
    cold = out["spans"]["cold_vs_record"]
    assert cold["without_span"] == 0
    if cold["cold_execs"]:
        assert cold["max_rel_diff"] < 0.02
    assert not spans.enabled()
