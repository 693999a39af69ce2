"""The benchmark's arithmetic: idle share, device time within spans,
spreads."""

import statistics
import types

import pytest

from perfbench import stats
from perfbench.metrics._device import busy_ns, idle_share


def _run(events, lo, hi):
    return types.SimpleNamespace(window_ns=(lo, hi), on_card=True,
                                 events=[(f"k{i}", s, e, False) for i, (s, e) in enumerate(events)])


def test_idle_share_is_the_complement_of_the_union():
    # kernels that overlap: their summed time (1084) exceeds the window
    # (963), which a sum-based share would read as -12.6 % idle
    events = [(0, 600), (100, 700), (650, 900), (950, 963 - 1), (0, 50), (10, 20)]
    assert sum(e - s for s, e in events) > 963 - 0 - 100
    busy = 900 + (962 - 950)
    assert idle_share(_run(events, 0, 963)) == pytest.approx(100 * (1 - busy / 963))
    assert 0 <= idle_share(_run(events, 0, 963)) <= 100


def test_union_clips_to_the_window():
    assert stats.covered(stats.clip([(-5, 5), (8, 20)], 0, 10)) == 7
    assert stats.gaps([(2, 3), (5, 6)], 0, 10) == [(0, 2), (3, 5), (6, 10)]


def test_busy_within_spans_counts_only_the_kernels_inside():
    # a CRUSH stage [100, 400] and [600, 700]; a fix-up kernel between them
    # and a copy inside the first, which a kernel-only reading leaves out
    run = _run([(120, 200), (150, 260), (450, 550), (380, 640), (690, 720)], 0, 1000)
    run.events.append(("Memcpy DtoH", 300, 350, True))
    spans = [(100, 400), (600, 700)]
    assert busy_ns(run, False, spans) == (260 - 120) + (400 - 380) + (640 - 600) + (700 - 690)
    assert busy_ns(run, None, spans) == busy_ns(run, False, spans) + 50
    assert busy_ns(run, False) == (260 - 120) + (640 - 380) + (720 - 690)


def test_spread_uses_statistics_quartiles():
    xs = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, q2, q3 = statistics.quantiles(xs, n=4)
    assert stats.spread(xs) == pytest.approx((q3 - q1) / q2)


def test_checks_pass_only_within_their_limits():
    assert stats.passed([{"value": 0, "limit": 0}, {"value": 5, "limit": 1, "min": True}])
    assert not stats.passed([{"value": 1, "limit": 0}])
    assert not stats.passed([{"value": 0, "limit": 1, "min": True}])
