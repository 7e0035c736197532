"""Traffic drawn from the seed alone; percentiles over every request."""

import collections

import numpy as np

from benchmark.lib import stats, traffic

from .conftest import SERVE_MIX


def _sizes(reqs):
    """The multisets of prompt and output lengths (each shuffled on its
    own, so their pairing is the seed's)."""
    return (collections.Counter(len(r["prompt"]) for r in reqs),
            collections.Counter(r["new"] for r in reqs))


def test_same_seed_same_schedule():
    a = traffic.schedule(SERVE_MIX, 2**31 + 17, 10, 512)
    b = traffic.schedule(SERVE_MIX, 2**31 + 17, 10, 512)
    assert a == b
    c = traffic.schedule(SERVE_MIX, 2**31 + 18, 10, 512)
    assert [r["prompt"] for r in a] != [r["prompt"] for r in c]


def test_stratified_rounds_hold_one_set_of_sizes():
    """Every closed-loop round is the same multiset on every seed, the
    first round's residual lives included."""
    clients = SERVE_MIX["clients"]
    a = traffic.schedule(SERVE_MIX, 5, 10, 512)
    b = traffic.schedule(SERVE_MIX, 99, 10, 512)
    for r in range(1, SERVE_MIX["per_client"]):
        ra = a[r * clients:(r + 1) * clients]
        rb = b[r * clients:(r + 1) * clients]
        assert _sizes(ra) == _sizes(rb)
    # The first round: the same prompts and the same residual lives.
    assert _sizes(a[:clients]) == _sizes(b[:clients])
    assert all(r["client"] is None for r in a[clients:])


def test_open_loop_arrivals():
    """The window's arrivals are the same sizes and gaps on every seed,
    in the seed's order, the first due as it opens; the ramp's come
    before it."""
    mix = dict(SERVE_MIX, loop="open", rate_per_s=5.0, ramp_s=2.0)
    a = traffic.schedule(mix, 7, 20, 512)
    b = traffic.schedule(mix, 8, 20, 512)
    for sched in (a, b):
        due = np.array([r["due"] for r in sched])
        assert np.all(np.diff(due) > 0)
        window = due[due >= 0]
        assert len(window) == 100 and window[0] == 0.0
        assert window[-1] < 20.0 and len(due) - len(window) == 10
    win_a = [r for r in a if r["due"] >= 0]
    win_b = [r for r in b if r["due"] >= 0]
    assert _sizes(win_a) == _sizes(win_b)
    gaps_a = np.sort(np.diff([r["due"] for r in win_a]))
    gaps_b = np.sort(np.diff([r["due"] for r in win_b]))
    # Each window holds n - 1 of the same n stratified gaps.
    assert len(set(np.round(gaps_a, 9)) ^ set(np.round(gaps_b, 9))) <= 2


def test_lengths_follow_the_mix():
    spec = {"dist": "lognormal", "median": 384, "sigma": 0.6, "min": 64,
            "max": 2048}
    vals = traffic.draw_lengths(spec, 4001, traffic.rng(1, "x"))
    assert vals.min() >= 64 and vals.max() <= 2048
    assert np.median(vals) == 384


def test_percentile_over_all_values():
    vals = list(np.random.default_rng(0).exponential(size=1001))
    for q in (50, 95, 99):
        assert abs(stats.percentile(vals, q) - np.percentile(vals, q)) < 1e-12
    assert stats.percentile([], 95) is None
    assert stats.percentile([3.0], 95) == 3.0

