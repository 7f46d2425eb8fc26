"""The general generator: the same work for every seed, in another
order."""

import numpy as np
import pytest

from perfbench import traffic

SPEC = {"dist": "lognormal", "median": 300, "sigma": 0.6, "min": 32,
        "max": 512}


@pytest.mark.parametrize("seeds", [(1, 2), (3000000007, 2 ** 31 + 11)])
def test_sizes_are_one_multiset_in_seeded_orders(seeds):
    a, b = (traffic.sizes(SPEC, 400, traffic.rng_for(s, "lengths"))
            for s in seeds)
    assert sorted(a) == sorted(b) and not np.array_equal(a, b)
    assert a.min() >= 32 and a.max() == 512
    assert abs(np.median(a) - 300) <= 2
    again = traffic.sizes(SPEC, 400, traffic.rng_for(seeds[0], "lengths"))
    assert np.array_equal(a, again)


def test_linear_and_fixed_sizes():
    assert traffic.quantiles({"dist": "linear", "min": 384, "max": 640},
                             16)[[0, -1]].tolist() == [384, 640]
    assert set(traffic.quantiles({"dist": "fixed", "value": 7}, 5)) == {7}


def test_arrivals_hold_the_rate():
    for seed in (5, 6):
        due = traffic.arrivals(20.0, 2000, traffic.rng_for(seed, "due"))
        assert np.all(np.diff(due) > 0)
        assert abs(due[-1] - 100.0) < 1.0  # n / rate
    a = traffic.arrivals(20.0, 100, traffic.rng_for(5, "due"))
    b = traffic.arrivals(20.0, 100, traffic.rng_for(6, "due"))
    assert abs(a[-1] - b[-1]) < 1e-9 and not np.array_equal(a, b)


def test_popularity_counts_follow_zipf():
    picks = traffic.popularity(16, 1.1, 1000, traffic.rng_for(1, "pick"))
    counts = np.bincount(picks, minlength=16)
    assert counts.sum() == 1000 and np.all(np.diff(counts) <= 0)
    other = traffic.popularity(16, 1.1, 1000, traffic.rng_for(2, "pick"))
    assert np.array_equal(np.bincount(other, minlength=16), counts)


def test_token_rows_have_their_lengths():
    rows = traffic.token_rows([3, 5], 50, traffic.rng_for(1, "tokens"))
    assert [len(r) for r in rows] == [3, 5]
    assert all(0 <= t < 50 for r in rows for t in r)


def test_every_seed_puts_the_same_requests_in_the_serving_window():
    """The cell's own schedule at its full size: the window holds
    round(rate x seconds) requests, due at the same times with the same
    system prompts, user turn lengths and answers in every seed (the
    cell's ``schedule_seed``); the tokens are the seed's."""
    from perfbench import harness

    def window(seed):
        ctx = harness.Context("serve-gptj6b-sessions", seed, 45.0, False,
                              device="cpu")
        driver = harness.load_module("drivers", "serve_open_loop").make(ctx)
        requests = driver.schedule(ctx.seconds)
        warm = ctx.cell["warm_seconds"]
        inside = [r for r in requests if warm <= r[0] < warm + 45.0]
        return (len(inside), round(ctx.cell["rate"] * 45.0),
                [(r[0], r[1], len(r[2]), r[3]) for r in inside],
                [r[2] for r in inside])

    a, b = window(3000000019), window(2 ** 31 + 5)
    assert a[0] == a[1] == b[0]
    assert a[2] == b[2]
    assert not all(np.array_equal(x, y) for x, y in zip(a[3], b[3]))
