"""The yardstick's arithmetic: bytes, bounds, the window and the check."""

import numpy as np
import pytest

from benchmark.harness import bounds, check, window


def test_forward_bytes_per_ray():
    # scene 1 at R = 2^18: 160 B a ray (the [8, R] rays in, [32, R] out)
    base = bounds.fwd_bytes(0, 485, 0)
    assert bounds.fwd_bytes(1 << 18, 485, 0) - base == 160 * (1 << 18)
    assert base == 4 * 485 * (10 + 27)


def test_forward_bound_is_bytes_over_bandwidth():
    b = bounds.fwd_bound_s(10, 1 << 18, 485, 0)
    assert b == pytest.approx(10 * bounds.fwd_bytes(1 << 18, 485, 0) / 3.35e12)


def test_backward_bound_takes_the_larger_part():
    rays = 202_800
    no_hits = bounds.bwd_bound_s(rays, 0, 0, 485, 0)
    assert no_hits == pytest.approx((4 * rays * 9 + 8 * 485 * 10
                                     + 4 * 485 * 27) / 3.35e12)
    many = bounds.bwd_bound_s(rays, rays, 0, 485, 0)
    assert many == pytest.approx(max(
        (4 * rays * 9 + 4 * rays * 37 + 8 * 485 * 10 + 4 * 485 * 27)
        / 3.35e12, rays * 130 / 67e12))


def test_window_counts_whole_units():
    clock = iter(np.arange(0.0, 100.0, 0.5))
    units = []

    def unit(k):
        units.append(k)

    orig = window.time.perf_counter
    window.time.perf_counter = lambda: float(next(clock))
    try:
        w = window.run_units(unit, 3.0)
    finally:
        window.time.perf_counter = orig
    # starts at 0.5 then every 1.0 s; the unit that ends at/after 3.0 s
    # past the first call completes and is counted
    assert w["units"] == len(units) == 3
    assert w["wall"] == pytest.approx(w["ends"][-1] - w["starts"][0])
    rate = w["units"] * 100 / w["wall"]
    assert rate == pytest.approx(300 / (w["ends"][-1] - w["starts"][0]))


def test_percentile_takes_every_unit():
    assert window.percentile(list(range(1, 101)), 95) == pytest.approx(95.05)


def test_unit_seeds_are_32_bit_and_follow_the_seed():
    a = window.unit_seeds(2 ** 31 + 12345, "frames", 8)
    assert a == window.unit_seeds(2 ** 31 + 12345, "frames", 8)
    assert a != window.unit_seeds(2 ** 31 + 12346, "frames", 8)
    assert all(0 <= s < 2 ** 32 for s in a)


def test_pixels_off_and_judge():
    ref = np.full((4, 3), 0.5, np.float32)
    prog = ref.copy()
    prog[1, 2] += 2e-4          # inside atol + rtol * 0.5 = 6e-4
    prog[2, 0] += 1e-3          # outside
    prog[3, 1] = np.nan
    assert check.pixels_off(prog, ref).tolist() == [False, False, True, True]
    ok, lines = check.judge({"numbers": {"px_off": {"limit": 0.1}}},
                            {"px_off": 0.5})
    assert not ok and "limit 0.1" in lines[0]


def test_counted_leaves_and_gaps():
    ref = {"a": np.ones(4), "b": np.full(4, 2.0), "c": np.full(4, 1e-9)}
    leaves = check.counted_leaves(ref)
    assert leaves == ["a", "b"]
    prog = {"a": np.ones(4) * 1.1, "b": np.full(4, 2.0), "c": np.zeros(4)}
    g = check.norm_gaps(prog, ref, leaves)
    assert g["b"] == 0.0 and g["a"] == pytest.approx(0.1 * 2 / 3, rel=1e-6)
