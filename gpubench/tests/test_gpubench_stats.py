"""The window's statistics: the rate over the window and the tail over all
batches finished in it, a stall included."""

import pytest

from gpubench.common import percentile, window_rate


def test_rate_counts_only_batches_finished_in_the_window():
    done = [0.5, 1.0, 1.5, 2.0, 2.5]
    assert window_rate(done, [32] * 5, 0.0, 2.0) == pytest.approx(4 * 32 / 2.0)


@pytest.mark.parametrize("stall", [0.0, 3.0])
def test_a_stall_moves_the_rate_and_the_tail(stall):
    # 40 batches of 32, one every 0.1 s; a stall of ``stall`` s after the 20th
    t, done, lat = 0.0, [], []
    for k in range(40):
        t += 0.1 + (stall if k == 20 else 0.0)
        done.append(t)
        lat.append(100.0 + (1e3 * stall if k == 20 else 0.0))
    rate = window_rate(done, [32] * 40, 0.0, 4.05)
    p95 = percentile(lat, 95)
    if stall:
        assert rate < 32 * 40 / 4.05 * 0.6
        assert percentile(lat + [1e3 * stall] * 2, 95) > 1000.0
    else:
        assert rate == pytest.approx(32 * 40 / 4.05)
        assert p95 == 100.0


def test_percentile_is_nearest_rank_over_all_values():
    values = list(range(1, 101))
    assert percentile(values, 95) == 95
    assert percentile(values, 100) == 100
    assert percentile([7.0], 95) == 7.0
    with pytest.raises(ValueError):
        percentile([], 95)
