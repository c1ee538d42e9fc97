"""The traffic generators: the same seed gives the same stream; every seed
sends the same sizes over a block, in its own order; the rates hold."""

import itertools

import numpy as np
import pytest

import pb_common as pc

POISSON = {"kind": "poisson", "rate_per_s": 20.0,
           "tokens": {"median": 512, "sigma": 0.6, "min": 64, "max": 4096},
           "bytes_per_token": 4.0, "block": 64}


def take(p, seed, n):
    return list(itertools.islice(
        pc.traffic_module(p["kind"]).stream(p, seed), n))


def test_same_seed_same_stream():
    p = POISSON
    big = 2**31 + 977
    assert take(p, big, 300) == take(p, big, 300)
    assert take(p, big, 300) != take(p, big + 1, 300)


def test_a_block_holds_the_same_sizes_for_every_seed():
    p = POISSON
    a = sorted(n for _, n, _ in take(p, 1, p["block"]))
    b = sorted(n for _, n, _ in take(p, 2, p["block"]))
    assert a == b
    lo, hi = p["tokens"]["min"], p["tokens"]["max"]
    assert lo <= a[0] and a[-1] <= hi
    assert np.median(a) == pytest.approx(p["tokens"]["median"], rel=0.1)


def test_arrivals_increase_and_payload_follows_tokens():
    p = POISSON
    rows = take(p, 5, 500)
    t = [r[0] for r in rows]
    assert all(b > a for a, b in zip(t, t[1:]))
    assert all(nb == n * p["bytes_per_token"] for _, n, nb in rows)


def test_poisson_rate():
    rows = take(POISSON, 3, POISSON["block"] * 10)
    rate = len(rows) / (rows[-1][0] / 1e3)
    assert rate == pytest.approx(POISSON["rate_per_s"], rel=0.02)



@pytest.mark.parametrize(
    "cell", [w["name"] for w in pc.benchmark()["workloads"]
             if pc.load_workload(w["name"])["traffic"].get("block")
             == pc.load_workload(w["name"])["window"]["slice_tasks"]])
def test_a_slice_sized_block_sends_every_slice_the_same_work(cell):
    wl = pc.load_workload(cell)
    per = wl["window"]["slice_tasks"]

    def slices(seed):
        rows = take(wl["traffic"], seed, per * 5)
        out, t0 = [], 0.0
        for k in range(5):
            part = rows[k * per:(k + 1) * per]
            out.append((sorted(n for _, n, _ in part), part[-1][0] - t0))
            t0 = part[-1][0]
        return out

    first = slices(2**31 + 11)
    for sizes, span in first + slices(7):
        assert sizes == first[0][0]
        assert span == pytest.approx(first[0][1], rel=1e-9)
