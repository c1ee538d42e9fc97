"""The host-side arithmetic of the flash-decode and walk kernels, on the CPU.

The kernels themselves run only on a card (``tests/test_torch_cuda.py``);
what the wrappers compute before a launch is plain Python and is held here:
K5's split rule and workspace size, the walk's shared-memory layout and the
pool capacity the placement core derives from it.
"""

from __future__ import annotations

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
from repro_torch.kernels.state_replay.kernel import (
    SMEM_LIMIT,
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
