"""Workload generation: Poisson / bursty / ramp arrivals + dataset-like
length distributions.

ShareGPT / LMSYS-Chat-1M length statistics are modeled as clipped lognormals
fit to the published distributions (no network access in this environment);
all draws are seeded and deterministic.

Every generated request carries client-facing ``SamplingParams`` (oracle
mode: ``max_tokens`` = drawn output length, ``ignore_eos=True``) and an SLO
class name. ``generate_mixed_requests`` produces heterogeneous tiers
(interactive / standard / batch) over the *same* arrival/length draws as the
homogeneous trace, so mixes are comparable run-to-run.

Non-stationary arrivals (``arrival=``, composing with every generator and
with ``--arrival`` in launch.serve): ``"poisson"`` is the stationary
default (bit-identical to the pre-pattern draws); ``"burst"`` is an on/off
modulated Poisson process (rate ``burst_factor * rps`` inside on-windows,
reduced off-windows, SAME mean rate ``rps``) — the trace that exposes
prefill/decode interference and motivates disaggregation; ``"ramp"`` grows
the rate linearly from 0.2x to 1.8x across the duration (mean ``rps``) —
the warm-up/traffic-shift scenario. Both are generated by time-rescaling a
unit-rate Poisson process through the exact piecewise inverse of the
cumulative intensity, so request COUNT and the downstream length draws
match the stationary trace at the same seed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np

from repro_torch.configs.base import SLOConfig
from repro_torch.core.types import (Request, SamplingParams, SLO_CLASSES,
                                    resolve_slo_class)


@dataclasses.dataclass(frozen=True)
class DatasetProfile:
    name: str
    in_mu: float        # lognormal mu of prompt length
    in_sigma: float
    out_mu: float
    out_sigma: float
    max_in: int = 4096
    max_out: int = 1024


# means: ShareGPT ~220 in / ~200 out; LMSYS ~100 in / ~160 out
SHAREGPT = DatasetProfile("sharegpt", in_mu=5.0, in_sigma=0.9,
                          out_mu=5.0, out_sigma=0.8,
                          max_in=4096, max_out=2048)
LMSYS = DatasetProfile("lmsys", in_mu=4.2, in_sigma=1.1,
                       out_mu=4.8, out_sigma=0.8,
                       max_in=2048, max_out=1024)
# RAG/summarization-style: ~1200-token prompts, ~27-token answers. The
# prefill-heavy profile where prefill/decode interference dominates — the
# disaggregation workload (benchmarks/bench_disagg.py): decode's KV working
# set is small enough for a dedicated decode pool while long chunked
# prefills would otherwise inflate every colocated decode iteration.
RAG = DatasetProfile("rag", in_mu=7.0, in_sigma=0.5,
                     out_mu=3.2, out_sigma=0.6,
                     max_in=4096, max_out=96)

DATASETS = {d.name: d for d in (SHAREGPT, LMSYS, RAG)}


ARRIVAL_PATTERNS = ("poisson", "burst", "ramp")


def arrival_times(rng: np.random.Generator, rps: float, duration_s: float,
                  n: int, *, pattern: str = "poisson",
                  burst_on: float = 4.0, burst_off: float = 8.0,
                  burst_factor: float = 4.0) -> np.ndarray:
    """``n`` arrival times for an (in)homogeneous Poisson process of mean
    rate ``rps``. The stationary path consumes the rng exactly like the
    legacy exponential-gap draw (golden-pinned); the non-stationary paths
    draw the same ``n`` exponentials at unit rate and map them through the
    exact inverse cumulative intensity Λ⁻¹ (time-rescaling theorem), so the
    downstream length draws stay aligned across patterns at one seed."""
    if pattern == "poisson":
        return np.cumsum(rng.exponential(1.0 / rps, size=n))
    u = np.cumsum(rng.exponential(1.0, size=n))        # unit-rate arrivals
    if pattern == "ramp":
        # λ(t) = rps·(0.2 + 1.6·t/D): Λ(t) = rps·(0.2·t + 0.8·t²/D);
        # invert the quadratic (positive root)
        d = max(duration_s, 1e-9)
        return d * (np.sqrt(0.04 + 3.2 * u / (rps * d)) - 0.2) / 1.6
    if pattern == "burst":
        if burst_on <= 0 or burst_off < 0:
            raise ValueError("burst_on must be > 0 and burst_off >= 0")
        if burst_factor <= 0 or \
                burst_factor * burst_on > burst_on + burst_off + 1e-12:
            raise ValueError(
                "burst_factor must be in (0, (on+off)/on] so the "
                "off-window rate stays >= 0")
        period = burst_on + burst_off
        lam_on = rps * burst_factor
        # off-rate chosen so the time-average rate stays exactly rps
        lam_off = ((rps * period - lam_on * burst_on) / burst_off
                   if burst_off > 0 else 0.0)
        lam_off = max(lam_off, 1e-12)
        per_period = lam_on * burst_on + lam_off * burst_off
        k, rem = np.divmod(u, per_period)              # whole periods + rest
        on_mass = lam_on * burst_on
        in_on = rem <= on_mass
        t_in = np.where(in_on, rem / lam_on,
                        burst_on + (rem - on_mass) / lam_off)
        return k * period + t_in
    raise ValueError(f"unknown arrival pattern {pattern!r}; "
                     f"known: {ARRIVAL_PATTERNS}")


def generate_requests(dataset: str, rps: float, duration_s: float,
                      seed: int = 0, slo: Optional[SLOConfig] = None,
                      slo_class: str = "standard", *,
                      arrival: str = "poisson",
                      arrival_kw: Optional[Dict[str, float]] = None
                      ) -> List[Request]:
    prof = DATASETS[dataset]
    rng = np.random.default_rng(seed)
    n = max(int(rps * duration_s), 1)
    arrivals = arrival_times(rng, rps, duration_s, n, pattern=arrival,
                             **(arrival_kw or {}))
    in_lens = np.clip(rng.lognormal(prof.in_mu, prof.in_sigma, n), 8,
                      prof.max_in).astype(int)
    out_lens = np.clip(rng.lognormal(prof.out_mu, prof.out_sigma, n), 4,
                       prof.max_out).astype(int)
    if slo is None:
        slo = resolve_slo_class(slo_class)
    return [Request(req_id=i, arrival_time=float(arrivals[i]),
                    prompt_len=int(in_lens[i]), output_len=int(out_lens[i]),
                    slo=slo, slo_class=slo_class,
                    sampling=SamplingParams(max_tokens=int(out_lens[i]),
                                            ignore_eos=True))
            for i in range(n)]


def parse_class_mix(spec: str) -> Dict[str, float]:
    """Parse "interactive=0.3,standard=0.5,batch=0.2" into a weight map.

    Weights are normalized; every class name must be registered in
    ``SLO_CLASSES``.
    """
    mix: Dict[str, float] = {}
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        name, sep, frac = part.partition("=")
        name, frac = name.strip(), frac.strip()
        if sep and not frac:
            raise ValueError(f"missing weight after '=': {part!r}")
        resolve_slo_class(name)   # raises on unknown class
        if name in mix:
            raise ValueError(f"duplicate SLO class in mix: {name!r}")
        weight = float(frac) if frac else 1.0
        if weight <= 0:
            raise ValueError(f"SLO class weight must be positive: "
                             f"{name}={weight}")
        mix[name] = weight
    if not mix:
        raise ValueError(f"empty SLO class mix: {spec!r}")
    total = sum(mix.values())
    return {k: v / total for k, v in mix.items()}


def _normalize_class_mix(class_mix: "Dict[str, float] | str"
                         ) -> Dict[str, float]:
    if isinstance(class_mix, str):
        return parse_class_mix(class_mix)
    for name, weight in class_mix.items():  # dict path: same per-entry contract
        resolve_slo_class(name)    # raises on unknown class
        if weight <= 0:
            raise ValueError(f"SLO class weight must be positive: "
                             f"{name}={weight}")
    total = sum(class_mix.values())
    return {k: v / total for k, v in class_mix.items()}


def assign_slo_classes(reqs: List[Request],
                       class_mix: "Dict[str, float] | str",
                       seed: int = 0) -> List[Request]:
    """Assign each request a named SLO class drawn from ``class_mix`` by an
    independent seeded stream (composes with any trace generator — shared
    arrivals/lengths stay untouched)."""
    class_mix = _normalize_class_mix(class_mix)
    names = sorted(class_mix)          # deterministic order
    probs = [class_mix[k] for k in names]
    rng = np.random.default_rng([seed, 0xC1A55])   # independent stream
    picks = rng.choice(len(names), size=len(reqs), p=probs)
    for r, k in zip(reqs, picks):
        name = names[int(k)]
        r.slo_class = name
        r.slo = SLO_CLASSES[name]
    return reqs


def generate_mixed_requests(dataset: str, rps: float, duration_s: float,
                            seed: int = 0,
                            class_mix: "Dict[str, float] | str" =
                            "interactive=0.3,standard=0.5,batch=0.2", *,
                            arrival: str = "poisson",
                            arrival_kw: Optional[Dict[str, float]] = None
                            ) -> List[Request]:
    """Heterogeneous-SLO trace: same arrivals/lengths as the homogeneous
    trace at this seed; each request is assigned a named SLO class drawn
    from ``class_mix`` by an independent seeded stream."""
    reqs = generate_requests(dataset, rps, duration_s, seed=seed,
                             arrival=arrival, arrival_kw=arrival_kw)
    return assign_slo_classes(reqs, class_mix, seed=seed)


def generate_bursty_requests(dataset: str, rps: float, duration_s: float,
                             seed: int = 0, *, burst_on: float = 4.0,
                             burst_off: float = 8.0,
                             burst_factor: float = 3.0,
                             class_mix: "Dict[str, float] | str | None" =
                             None) -> List[Request]:
    """On/off bursty trace at mean rate ``rps``: arrivals cluster at
    ``burst_factor * rps`` during ``burst_on``-second windows separated by
    ``burst_off``-second lulls (the disaggregation/interference scenario).
    Lengths match the stationary trace at this seed; ``class_mix`` composes
    heterogeneous SLO tiers onto the same draws."""
    reqs = generate_requests(
        dataset, rps, duration_s, seed=seed, arrival="burst",
        arrival_kw=dict(burst_on=burst_on, burst_off=burst_off,
                        burst_factor=burst_factor))
    if class_mix:
        assign_slo_classes(reqs, class_mix, seed=seed)
    return reqs


def generate_ramp_requests(dataset: str, rps: float, duration_s: float,
                           seed: int = 0, *,
                           class_mix: "Dict[str, float] | str | None" = None
                           ) -> List[Request]:
    """Ramp trace: the rate grows linearly from 0.2x to 1.8x ``rps`` across
    the duration (mean ``rps``) — the warm-up / traffic-shift scenario."""
    reqs = generate_requests(dataset, rps, duration_s, seed=seed,
                             arrival="ramp")
    if class_mix:
        assign_slo_classes(reqs, class_mix, seed=seed)
    return reqs


def generate_shared_prefix_requests(dataset: str, rps: float,
                                    duration_s: float, *, seed: int = 0,
                                    share_ratio: float = 0.5,
                                    prefix_len: int = 256,
                                    n_prefixes: int = 8,
                                    vocab_size: int = 32000,
                                    class_mix: "Dict[str, float] | str | None"
                                    = None,
                                    arrival: str = "poisson",
                                    arrival_kw: Optional[Dict[str, float]]
                                    = None) -> List[Request]:
    """Trace with real prompt token IDs and controllable prefix sharing —
    the prefix-cache workload (multi-turn chat / shared system prompts).

    Arrivals and output lengths match ``generate_requests`` at this seed.
    Each request draws (independent seeded stream): with probability
    ``share_ratio`` its prompt is one of ``n_prefixes`` common prefixes of
    ``prefix_len`` tokens followed by a unique suffix (prompt lengths are
    raised to at least ``prefix_len + 8`` so a real suffix exists);
    otherwise a fully unique prompt. All token IDs are deterministic per
    seed. ``class_mix`` composes heterogeneous SLO tiers onto the trace
    (same assignment stream as ``generate_mixed_requests``).
    """
    if not 0.0 <= share_ratio <= 1.0:
        raise ValueError(f"share_ratio must be in [0, 1]: {share_ratio}")
    if prefix_len < 1 or n_prefixes < 1:
        raise ValueError("prefix_len and n_prefixes must be >= 1")
    reqs = generate_requests(dataset, rps, duration_s, seed=seed,
                             arrival=arrival, arrival_kw=arrival_kw)
    rng = np.random.default_rng([seed, 0x50F1])    # independent stream
    prefixes = rng.integers(1, vocab_size, size=(n_prefixes, prefix_len))
    for r in reqs:
        if rng.random() < share_ratio:
            k = int(rng.integers(0, n_prefixes))
            plen = max(r.prompt_len, prefix_len + 8)
            suffix = rng.integers(1, vocab_size, size=plen - prefix_len)
            ids = [int(x) for x in prefixes[k]] + [int(x) for x in suffix]
        else:
            plen = r.prompt_len
            ids = [int(x) for x in rng.integers(1, vocab_size, size=plen)]
        r.prompt_len = plen
        r.prompt_ids = ids
    if class_mix:
        assign_slo_classes(reqs, class_mix, seed=seed)
    return reqs
