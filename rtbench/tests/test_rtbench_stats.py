"""The end-to-end arithmetic on synthetic timings."""

from __future__ import annotations

import numpy as np
import pytest

from rtbench import stats


def test_rate_is_all_work_over_all_time():
    assert stats.rate(23_040_000 * 10, 2.0) == pytest.approx(115_200_000.0)
    with pytest.raises(ValueError):
        stats.rate(1, 0.0)


@pytest.mark.parametrize("q", [50, 95, 99])
def test_percentile_matches_numpy(q):
    xs = list(np.random.default_rng(3).gamma(2.0, 1.5, size=1001))
    assert stats.percentile(xs, q) == pytest.approx(float(np.percentile(xs, q)))


def test_p95_is_over_every_frame():
    frames = [1.0] * 95 + [10.0] * 5
    assert stats.percentile(frames, 95) == pytest.approx(1.45)
    assert stats.percentile(frames + [10.0] * 5, 95) == 10.0


def test_step_time_counts_completed_steps():
    assert stats.per_unit_ms(7.0, 50) == pytest.approx(140.0)
    with pytest.raises(ValueError):
        stats.per_unit_ms(1.0, 0)

