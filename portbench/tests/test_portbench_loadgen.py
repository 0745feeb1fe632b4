"""The copied load generator: deterministic per seed, the same work for
every seed, and the clipped lognormals of the profiles."""
import math

import numpy as np
import pytest
from scipy import stats as sps

from portbench import loadgen

TRAFFIC = {"lengths": {"in_mu": 5.0, "in_sigma": 0.9, "in_min": 8,
                       "in_max": 4096, "out_mu": 5.0, "out_sigma": 0.8,
                       "out_min": 4, "out_max": 2048},
           "arrival": "poisson", "rate_rps": 5.0, "warm_s": 10,
           "set_seed": 7,
           "slo_mix": {"interactive": 0.3, "standard": 0.5, "batch": 0.2}}


def test_same_seed_same_requests():
    a = loadgen.schedule(TRAFFIC, 40, 2**31 + 12345, 64000)
    b = loadgen.schedule(TRAFFIC, 40, 2**31 + 12345, 64000)
    assert a == b


def test_every_seed_gets_the_same_work_with_its_own_tokens():
    a = loadgen.schedule(TRAFFIC, 40, 1, 64000)
    b = loadgen.schedule(TRAFFIC, 40, 2, 64000)
    assert len(a) == len(b) == loadgen.request_count(TRAFFIC, 40) == 250
    def key(r):
        return r.due, len(r.prompt_ids), r.max_tokens, r.slo_class
    assert [key(r) for r in a] == [key(r) for r in b]
    assert [r.prompt_ids for r in a] != [r.prompt_ids for r in b]
    assert a[0].due == 0.0
    # the gaps average one over the rate exactly, within the span
    assert a[-1].due == pytest.approx((250 - 1) / 5.0)
    names = [r.slo_class for r in a]
    assert (names.count("interactive"), names.count("standard"),
            names.count("batch")) == (75, 125, 50)
    assert names != sorted(names)


def test_class_counts_follow_the_mix():
    names = loadgen.class_counts(TRAFFIC["slo_mix"], 250)
    assert (names.count("interactive"), names.count("standard"),
            names.count("batch")) == (75, 125, 50)


def _clipped_mean(mu, sigma, lo, hi):
    """E[clip(X, lo, hi)] of a lognormal X, in closed form."""
    a, b = (math.log(lo) - mu) / sigma, (math.log(hi) - mu) / sigma
    inner = math.exp(mu + sigma ** 2 / 2) * (
        sps.norm.cdf(b - sigma) - sps.norm.cdf(a - sigma))
    return lo * sps.norm.cdf(a) + inner + hi * sps.norm.sf(b)


@pytest.mark.parametrize("mu,sigma,lo,hi", [(5.0, 0.9, 8, 4096),
                                            (5.0, 0.8, 4, 2048),
                                            (7.0, 0.5, 8, 4096),
                                            (3.2, 0.6, 4, 96)])
def test_clipped_lognormal_means_match_the_profiles(mu, sigma, lo, hi):
    x = loadgen.clipped_lognormal(np.random.default_rng(0), mu, sigma, lo,
                                  hi, 200_000)
    # astype(int) truncates: the mean sits half a token below on average
    assert x.mean() == pytest.approx(_clipped_mean(mu, sigma, lo, hi) - 0.5,
                                     rel=0.01)
    assert x.min() >= lo and x.max() <= hi


def test_poisson_gaps_have_the_rate():
    t = loadgen.arrival_times(np.random.default_rng(0), 5.0, 0, 100_000)
    assert np.diff(t).mean() == pytest.approx(0.2, rel=0.01)
