"""The window's arithmetic on synthetic timings: a rate over the whole window,
the 95th percentile over every request, the device's idle share."""
import pytest

from port_bench import core


def test_rate_is_over_the_whole_window_with_a_stall():
    lat = [0.01] * 99 + [1.0]                  # one stalled request
    w = core.Window(10.0, 10.0 + 0.99 + 1.0, lat)
    assert w.stat("ms_per_unit") == pytest.approx(1e3 * 1.99 / 100)
    assert w.stat("p95_latency_ms") == pytest.approx(10.0)


def test_p95_counts_every_request():
    vals = [float(i) for i in range(1, 101)]
    assert core.p95(vals) == 95.0
    assert core.p95(list(reversed(vals))) == 95.0
    assert core.p95([5.0] * 94 + [50.0] * 6) == 50.0
    assert core.p95([3.0]) == 3.0
    with pytest.raises(ValueError):
        core.p95([])


def test_idle_share_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (9.0, 12.0)]
    assert core.union_seconds(iv) == pytest.approx(6.0)
    assert core.union_seconds(iv, (1.5, 10.0)) == pytest.approx(0.5 + 1.0 + 1.0)
    assert core.idle_share(iv, (0.0, 10.0)) == pytest.approx(100.0 * (1 - 4.0 / 10.0))
    assert core.gaps(iv, (0.0, 10.0)) == [(2.0, 3.0), (4.0, 9.0)]
    assert core.idle_share([], (0.0, 2.0)) == 100.0


def test_unknown_statistic_is_refused():
    with pytest.raises(ValueError):
        core.Window(0.0, 1.0, [1.0]).stat("median_ms")
