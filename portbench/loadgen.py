"""Open-loop traffic from a traffic file and a seed.

The length model (clipped lognormals of prompt and output length) and the
arrival processes (Poisson, on/off bursts, a ramp) are copies of the
program's ``serving/workload.py`` (``DatasetProfile``, ``arrival_times``),
kept here so that the yardstick does not move with the program.

Every seed gets the same work: the arrival times, prompt lengths, output
lengths and SLO classes are drawn once from the traffic file's
``set_seed``, in one order; ``--seed`` draws the prompts' token ids (and
the run's weights). Two seeds therefore differ in content, not in the
work or its timing, so their runs spread no wider than two runs of one
seed. (Permuting the order by seed would move the TTFT tail between
seeds, as long prompts cluster differently.)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping

import numpy as np


@dataclasses.dataclass(frozen=True)
class RequestSpec:
    """One request of the schedule. ``due`` is seconds after the first
    arrival of the warm traffic."""
    due: float
    prompt_ids: List[int]
    max_tokens: int
    slo_class: str


def arrival_times(rng: np.random.Generator, rps: float, duration_s: float,
                  n: int, *, pattern: str = "poisson",
                  burst_on: float = 4.0, burst_off: float = 8.0,
                  burst_factor: float = 4.0) -> np.ndarray:
    """``n`` arrival times of an (in)homogeneous Poisson process of mean
    rate ``rps``: the stationary one as exponential gaps, the others by
    mapping unit-rate arrivals through the inverse cumulative intensity."""
    if pattern == "poisson":
        return np.cumsum(rng.exponential(1.0 / rps, size=n))
    u = np.cumsum(rng.exponential(1.0, size=n))
    if pattern == "ramp":
        d = max(duration_s, 1e-9)
        return d * (np.sqrt(0.04 + 3.2 * u / (rps * d)) - 0.2) / 1.6
    if pattern == "burst":
        if burst_on <= 0 or burst_off < 0:
            raise ValueError("burst_on must be > 0 and burst_off >= 0")
        if burst_factor <= 0 or \
                burst_factor * burst_on > burst_on + burst_off + 1e-12:
            raise ValueError("burst_factor must be in (0, (on+off)/on]")
        period = burst_on + burst_off
        lam_on = rps * burst_factor
        lam_off = ((rps * period - lam_on * burst_on) / burst_off
                   if burst_off > 0 else 0.0)
        lam_off = max(lam_off, 1e-12)
        per_period = lam_on * burst_on + lam_off * burst_off
        k, rem = np.divmod(u, per_period)
        on_mass = lam_on * burst_on
        in_on = rem <= on_mass
        t_in = np.where(in_on, rem / lam_on,
                        burst_on + (rem - on_mass) / lam_off)
        return k * period + t_in
    raise ValueError(f"unknown arrival pattern {pattern!r}")


def clipped_lognormal(rng: np.random.Generator, mu: float, sigma: float,
                      lo: int, hi: int, n: int) -> np.ndarray:
    return np.clip(rng.lognormal(mu, sigma, n), lo, hi).astype(int)


def class_counts(mix: Mapping[str, float], n: int) -> List[str]:
    """``n`` class names in the mix's proportions (largest remainders),
    in sorted name order."""
    names = sorted(mix)
    total = sum(mix[k] for k in names)
    exact = [mix[k] / total * n for k in names]
    counts = [int(math.floor(x)) for x in exact]
    order = sorted(range(len(names)), key=lambda i: counts[i] - exact[i])
    for i in order[:n - sum(counts)]:
        counts[i] += 1
    return [k for k, c in zip(names, counts) for _ in range(c)]


def request_count(traffic: Mapping, seconds: float) -> int:
    """Arrivals in the warm traffic and the window together."""
    return max(int(math.ceil(traffic["rate_rps"]
                             * (traffic["warm_s"] + seconds))), 1)


def base_set(traffic: Mapping, seconds: float) -> Dict[str, np.ndarray]:
    """The work every seed shares: prompt and output lengths, classes and
    the ``n - 1`` gaps between ``n`` arrivals, drawn from the traffic
    file's ``set_seed``. A Poisson draw's gaps are scaled so that they
    average one over the rate exactly."""
    n = request_count(traffic, seconds)
    rng = np.random.default_rng(int(traffic["set_seed"]))
    lengths = traffic["lengths"]
    span = traffic["warm_s"] + seconds
    rate = float(traffic["rate_rps"])
    pattern = traffic.get("arrival", "poisson")
    times = arrival_times(rng, rate, span, n, pattern=pattern,
                          **traffic.get("arrival_kw", {}))
    if pattern == "poisson" and n > 1:
        # scaled to the stated mean rate exactly, so the arrivals span the
        # warm traffic and the window whatever the draw
        times = times[0] + (times - times[0]) * (
            (n - 1) / rate / (times[-1] - times[0]))
    prompt = clipped_lognormal(rng, lengths["in_mu"], lengths["in_sigma"],
                               lengths["in_min"], lengths["in_max"], n)
    output = clipped_lognormal(rng, lengths["out_mu"], lengths["out_sigma"],
                               lengths["out_min"], lengths["out_max"], n)
    classes = np.array(class_counts(traffic["slo_mix"], n))
    return {"gaps": np.diff(times), "prompt": prompt, "output": output,
            "classes": classes[rng.permutation(n)]}


def schedule(traffic: Mapping, seconds: float, seed: int,
             vocab: int) -> List[RequestSpec]:
    """The run's requests in due order, those due before the warm traffic
    and the window end: the shared set, with prompt token ids drawn from
    ``seed``."""
    base = base_set(traffic, seconds)
    rng = np.random.default_rng([int(seed), 0x9E3779B9])
    due = np.concatenate([[0.0], np.cumsum(base["gaps"])])
    ids = rng.integers(1, vocab, size=int(base["prompt"].sum()))
    out, at = [], 0
    for i, plen in enumerate(base["prompt"].tolist()):
        if due[i] >= traffic["warm_s"] + seconds:
            break
        out.append(RequestSpec(due=float(due[i]),
                               prompt_ids=[int(x) for x in ids[at:at + plen]],
                               max_tokens=int(base["output"][i]),
                               slo_class=str(base["classes"][i])))
        at += plen
    return out
