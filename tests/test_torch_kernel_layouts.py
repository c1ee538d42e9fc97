"""The host-side arithmetic of the flash-decode, walk, replay and SSD-scan
kernels, on the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``);
what the wrappers compute before a launch is plain Python and is held here:
K5's split rule and workspace size, the walk's and the replay's
shared-memory layouts and the pool capacity the placement core derives from
them, and K6's route (one launch without a workspace for the serving
prefill) and workspace size.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.core.torch_core import max_pool_cap
from repro_torch.kernels.decode_attention.kernel import (
    SPLIT_ALIGN,
    decode_attention_bhd,
    decode_attention_plain,
    decode_splits,
    workspace_floats,
)
from repro_torch.kernels.ssd_scan.kernel import (
    ssd_route,
    ssd_scan_bhsd,
    ssd_scan_plain,
    work_floats,
)
from repro_torch.kernels.state_replay.kernel import (
    REPLAY_EDGE_BUDGET,
    REPLAY_GAP_WARPS,
    REPLAY_MAX_ROWS,
    REPLAY_SPLIT,
    SMEM_LIMIT,
    replay_ring_rows,
    replay_warps,
    smem_bytes,
    WALK_RING_BUDGET,
    WALK_STAGES,
    walk_ring_rows,
    walk_smem_bytes,
    walk_split,
    walk_warps,
)

H100_SMS = 132


def test_decode_splits_serving_shape_is_one_launch():
    """llama3.2-1b's decode step (B=1, Hkv=8, G=4, S=32): one split of the
    whole cache, so no workspace and no combine launch."""
    nsplit, chunk = decode_splits(1, 8, 4, 32, H100_SMS)
    assert (nsplit, chunk) == (1, 32)
    assert workspace_floats(1, 32, 64, nsplit) == 0


@pytest.mark.parametrize("B,Hkv,G,S", [
    (1, 8, 4, 32), (1, 8, 4, 64), (1, 8, 4, 65), (4, 8, 4, 4096),
    (3, 2, 4, 200), (2, 1, 16, 600), (1, 1, 32, 100_000), (64, 8, 4, 4096),
    (2, 2, 8, 700), (1, 1, 1, 129)])
def test_decode_splits_tile_the_slot_axis(B, Hkv, G, S):
    """The splits cover [0, S) exactly: every split starts below S, the
    last ends at or past it, and the chunk is a multiple of SPLIT_ALIGN
    unless the whole cache is one split."""
    nsplit, chunk = decode_splits(B, Hkv, G, S, H100_SMS)
    assert nsplit >= 1 and chunk >= 1
    assert nsplit * chunk >= S and (nsplit - 1) * chunk < S
    if nsplit > 1:
        assert chunk % SPLIT_ALIGN == 0
    else:
        assert chunk == S


def test_decode_splits_fill_the_card_at_long_caches():
    """At B=4, Hkv=8, S=4096 the blocks of all splits reach the H100's 132
    SMs; the rule reads the SM count it is given."""
    B, Hkv, G, S = 4, 8, 4, 4096
    nsplit, _ = decode_splits(B, Hkv, G, S, H100_SMS)
    assert nsplit * B * Hkv >= H100_SMS
    assert decode_splits(B, Hkv, G, S, 8)[0] < nsplit


def test_decode_workspace_floats():
    """(m, l, acc[D]) float32 per (batch, head, split) when there is more
    than one split."""
    assert workspace_floats(4, 32, 64, 8) == 4 * 32 * 8 * 66
    assert workspace_floats(2, 3, 5, 1) == 0


def test_decode_wrapper_on_cpu_takes_the_plain_version(rng):
    q = torch.as_tensor(rng.normal(size=(2, 8, 1, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.normal(size=(2, 2, 100, 16)), dtype=torch.float32)
    v = torch.as_tensor(rng.normal(size=(2, 2, 100, 16)), dtype=torch.float32)
    lens = torch.tensor([120, 0], dtype=torch.int32)
    before = decode_attention_bhd.launches
    got = decode_attention_bhd(q, k, v, lens)
    assert torch.equal(got, decode_attention_plain(q, k, v, lens))
    assert not got[1].any()
    assert decode_attention_bhd.launches == before


@pytest.mark.parametrize("nd,nc,cap,tile,split", [
    (3, 4, 2048, 64, 2), (0, 4, 512, 64, 2), (3, 0, 0, 64, 1),
    (3, 8, 1024, 64, 2), (3, 9, 512, 64, 1), (3, 32, 8, 16, 1),
    (200, 4, 64, 8, 2)])
def test_walk_smem_bytes_follow_the_kernel_layout(nd, nc, cap, tile, split):
    """``walk_smem_bytes`` is the CUDA layout's arithmetic: float64 pools,
    horizons, the ring of WALK_STAGES tiles (now, five (tile, nc) columns,
    two (tile, nd) columns) and two dispatched completions; the (best,
    runner-up) 64-bit keys of each of the ``split`` parts of each pool for
    two rows; 4-byte words for the ring's nom_fixed, the slots beside those
    keys, two (config, slot) dispatches and the ring of decided codes."""
    assert walk_ring_rows(nd, nc) == tile
    assert walk_split(nc) == split
    ring = WALK_STAGES * tile * (1 + 5 * nc + 2 * nd)
    parts = 2 * 2 * nc * split
    want = 8 * (2 * nc * cap + nd + ring + 2) + 8 * parts \
        + 4 * (WALK_STAGES * tile + parts + 4 + WALK_STAGES * tile)
    assert walk_smem_bytes(nd, nc, cap) == want
    row_bytes = 8 * (1 + 5 * nc + 2 * nd) + 4
    assert WALK_STAGES * tile * row_bytes <= WALK_RING_BUDGET or tile == 2


@pytest.mark.parametrize("nc", [0, 1, 4, 7, 8, 10, 15, 16, 17, 31, 32])
def test_walk_warps_stay_within_a_block(nc):
    """A deciding warp alone on its SMSP (warps 4, 8, ... idle), a producer
    warp and up to two scanning warps per config on the others: at most
    24 warps up to the 32-config limit."""
    w = walk_warps(nc)
    scanners = w - 2 - (w - 1) // 4
    assert scanners >= min(nc, 17) * walk_split(nc)
    assert w <= 24
    assert walk_warps(4) == 12


def test_max_pool_cap_of_the_slice_stays_2048():
    """The stream's 3-device fleet and 4 configs: pools of 2048 slots (one
    regrow per stream), with the input ring beside them in one block."""
    assert max_pool_cap(3, 4) == 2048
    assert walk_smem_bytes(3, 4, 2048) <= SMEM_LIMIT
    assert walk_smem_bytes(3, 4, 4096) > SMEM_LIMIT


@pytest.mark.parametrize("nc", range(1, 9))
def test_max_pool_cap_fits_the_block(nc):
    cap = max_pool_cap(3, nc)
    assert cap >= 8 and cap & (cap - 1) == 0
    assert walk_smem_bytes(3, nc, cap) <= SMEM_LIMIT
    assert walk_smem_bytes(3, nc, 2 * cap) > SMEM_LIMIT


# ------------------------------------------------------------ the replay
@pytest.mark.parametrize("nd", [0, 1, 3, 4, 5, 32, 33, 200])
def test_replay_ring_rows_fit_the_edge_budget(nd):
    """A segment is the largest power of two up to REPLAY_MAX_ROWS rows
    whose three edge buffers (nows, ecomp rows and horizon snapshots in
    float64, four 4-byte words a row, three counts) fit the budget."""
    seg = replay_ring_rows(nd)
    assert seg & (seg - 1) == 0 and 1 <= seg <= REPLAY_MAX_ROWS

    def edge(rows):
        return 3 * rows * 8 * (1 + 2 * nd) + 3 * 8 * nd + 3 * rows * 16 + 12

    assert edge(seg) <= REPLAY_EDGE_BUDGET or seg == 1
    assert seg == REPLAY_MAX_ROWS or edge(2 * seg) > REPLAY_EDGE_BUDGET
    assert replay_ring_rows(3) == 512


@pytest.mark.parametrize("nc", range(0, 33))
@pytest.mark.parametrize("nd", [1, 3, 40])
def test_replay_layout_mirror_over_every_config_count(nc, nd):
    """The replay's shared memory at every config count, for fleets of
    one, three and forty devices: a config block's (busy, last) pool, two
    segment buffers ((occw, occc), now, code and dispatch row a row), two
    dispatches' scan parts (``REPLAY_SPLIT`` a pool) and the segment counts;
    the edge block's three buffers; the larger of the two. Config blocks
    are independent of nc; the pools the placement core may grow to
    (``max_pool_cap``) always fit one block."""
    seg = replay_ring_rows(nd)
    cap = max_pool_cap(nd, nc) if nc else 0
    pool = 16 * cap + 2 * seg * 32 + 8 + 2 * REPLAY_SPLIT * 12
    edge = 3 * seg * 8 * (1 + 2 * nd) + 3 * 8 * nd + 3 * seg * 16 + 12
    want = max(pool if nc else 0, edge)
    assert smem_bytes(nd, nc, cap) == want
    assert smem_bytes(nd, nc, cap) <= SMEM_LIMIT
    # without an edge fleet: the config blocks alone, on 1024-row segments
    seg0 = replay_ring_rows(0)
    assert seg0 == REPLAY_MAX_ROWS
    assert smem_bytes(0, nc, cap) == (
        16 * cap + 2 * seg0 * 32 + 8 + 2 * REPLAY_SPLIT * 12 if nc else 0)
    assert replay_warps() == 1 + REPLAY_SPLIT + REPLAY_GAP_WARPS


def test_replay_default_launch():
    """The stream's launch: 7 warps (2 scanners, the producer, 4 gap
    warps), segments of 512 rows, 2048-slot pools in 110,676 B."""
    assert REPLAY_SPLIT == 2 and replay_warps() == 7
    assert smem_bytes(3, 4, 2048) == 110_676


# ------------------------------------------------------------ K6's route
@pytest.mark.parametrize("S,chunk,route", [
    (32, 128, "single"), (1, 128, "single"), (64, 128, "single"),
    (65, 128, "chunked"), (128, 128, "chunked"), (300, 128, "chunked"),
    (4096, 128, "chunked"), (20, 8, "chunked"), (9, 64, "single"),
    (16, 16, "single"), (17, 16, "chunked")])
def test_ssd_route(S, chunk, route):
    """One chunk of at most 64 rows runs as one launch without a workspace
    (the serving prefill, S = 32); anything longer takes the chunk-parallel
    passes over a workspace of every chunk's state and total decay."""
    assert ssd_route(S, chunk) == route
    b, H, hd, ds = 2, 48, 64, 128
    n = work_floats(b, H, S, hd, ds, chunk)
    if route == "single":
        assert n == 0
    else:
        nch = -(-S // min(chunk, S))
        assert n == b * nch * H * hd * ds + b * H * nch


def test_ssd_wrapper_on_cpu_takes_the_plain_version(rng):
    x = torch.as_tensor(rng.normal(size=(1, 3, 40, 8)), dtype=torch.float32)
    dt = torch.as_tensor(np.abs(rng.normal(size=(1, 3, 40))) * 0.5,
                         dtype=torch.float32)
    A = torch.tensor([-0.5, -1.0, -0.2])
    B = torch.as_tensor(rng.normal(size=(1, 40, 16)), dtype=torch.float32)
    C = torch.as_tensor(rng.normal(size=(1, 40, 16)), dtype=torch.float32)
    before = ssd_scan_bhsd.launches
    y, st = ssd_scan_bhsd(x, dt, A, B, C, chunk=16)
    yp, sp = ssd_scan_plain(x, dt, A, B, C, chunk=16)
    assert torch.equal(y, yp) and torch.equal(st, sp)
    assert ssd_scan_bhsd.launches == before
