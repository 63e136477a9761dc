"""The generator is deterministic by seed and gives every seed the same
work; the metric arithmetic: nearest rank, whole-window rates, misses."""
import pytest

from fosbench import common, traffic


@pytest.mark.parametrize("name", ["chat_b16", "longdoc_b4", "rag_b4"])
def test_lengths_by_seed(name):
    spec = common.traffic(name)["prompt_len"]
    a, b = traffic.lengths(spec, 2**31 + 99), traffic.lengths(spec,
                                                                2**31 + 99)
    assert a == b
    others = [traffic.lengths(spec, s) for s in (1, 2, 3, 4)]
    assert all(sorted(o) == sorted(a) for o in others)   # one set
    assert len({tuple(o) for o in others}) > 1            # other orders
    assert spec["low"] <= min(a) and max(a) <= spec["high"]


def test_sub_seed_large():
    s = 2**40 + 3
    assert traffic.sub_seed(s, 1) != traffic.sub_seed(s, 2)
    assert 0 <= traffic.sub_seed(s, 1) < 2**63


def test_nearest_rank_p95():
    assert common.p95(list(range(1, 101))) == 95
    assert common.p95(list(range(1, 21))) == 19
    assert common.p95([5.0]) == 5.0
    assert common.p95([3, 1, 2]) == 3


def test_misses_sit_above_every_limit():
    # a failed request counts with the time it was waited for
    lat = [10.0] * 18 + [60_000.0, 60_000.0]
    assert common.p95(lat) == 60_000.0
