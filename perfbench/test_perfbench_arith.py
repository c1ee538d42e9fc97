"""The benchmark's metric arithmetic against values worked out by hand."""

import math

import pytest

import pb_common as pc


def test_mean_and_percentile_by_hand():
    xs = [4.0, 1.0, 3.0, 2.0]
    assert pc.mean(xs) == 2.5
    # ranks 0..3 of [1, 2, 3, 4]; the 95th percentile lies at rank 2.85
    assert pc.percentile(xs, 95) == pytest.approx(3.85)
    assert pc.percentile(xs, 50) == pytest.approx(2.5)
    assert pc.percentile([7.0], 95) == 7.0


def test_latency_error_is_the_gap_of_the_means():
    # mean predicted 110, mean actual 100: 10% off
    assert pc.latency_error_pct([100.0, 120.0], [90.0, 110.0]) \
        == pytest.approx(10.0)


def test_spread_is_the_quartile_distance_over_the_median():
    # statistics.quantiles([1..5], n=4) gives 1.5, 3, 4.5
    assert pc.spread([1, 2, 3, 4, 5]) == pytest.approx(3.0 / 3.0)


def test_empty_inputs_raise():
    with pytest.raises(ValueError):
        pc.mean([])
    with pytest.raises(ValueError):
        pc.percentile([], 95)


def test_roofline_bounds_by_hand():
    import pb_roofline as rf

    olmoe = pc.load_config("olmoe-1b-7b")["program"]
    ops, nbytes = rf.k4(olmoe, 32)
    assert ops == 4 * 16 * (32 * 33 // 2) * 128
    assert nbytes == 2 * 32 * 128 * (16 * 4)
    ops, nbytes = rf.k5(olmoe, 32)
    assert nbytes == 2 * (2 * 32 * 16 * 128 + 2 * 16 * 128)
    assert rf.bound_s("K5", olmoe, 32) == pytest.approx(270336 / 3.35e12)
    pre, dec = rf.step_flops(olmoe, 32, "moe")
    per_tok = 16 * (2 * 2048 * 128 * 64 + 2 * 8 * 3 * 2048 * 1024
                    + 2 * 2048 * 64)
    assert dec == pytest.approx(per_tok + 16 * 4 * 16 * 128 * 32
                                + 2 * 2048 * 50304)
    assert pre > 32 * per_tok
    assert math.isfinite(rf.bound_s("K6", pc.load_config("mamba2-780m")
                                    ["program"], 32))


def test_kernel_names_sort_into_their_kernels():
    import pb_roofline as rf

    assert rf.kind_of("void fa_tc_kernel<128>(...)") == ("K4", True)
    assert rf.kind_of("dec_combine<float>") == ("K5", False)
    assert rf.kind_of("ssd_carry_kernel") == ("K6", False)
    assert rf.kind_of("nvjet_tst_512x40") is None
