"""SLO attainment and latency metrics (paper §5.1: attainment rate = % of
requests meeting the TTFT / TBT thresholds).

Accounting rules (see DESIGN.md §API layer):

* A request that never produced a token counts as a **miss** for both TTFT
  and TBT attainment (it is in the denominator but can satisfy neither SLO);
  ``n_no_token`` makes that population explicit.
* **Aborted** requests (client cancellations, ``finish_reason=="aborted"``)
  are excluded from attainment denominators — a cancelled request is not an
  SLO violation — and reported via ``n_aborted``. Their generated tokens
  still count toward throughput (they consumed capacity).
* ``per_class`` breaks attainment down by the named SLO class each request
  was submitted under (heterogeneous-tier traces, ``--slo-mix``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch.core.types import Request


def percentile(vals: Sequence[float], p: float) -> float:
    if not len(vals):
        return 0.0
    return float(np.percentile(np.asarray(vals), p))


@dataclasses.dataclass
class TTFTMissBreakdown:
    """Summed attribution over the requests that MISSED their TTFT SLO:
    where the violated time actually went. ``queue_wait_s`` (arrival to
    first RUNNING) + ``rotation_stall_s`` (pre-first-token ROTARY time) +
    ``prefill_compute_s`` (the remainder: chunked-prefill execution and
    in-batch queueing between chunks) == ``ttft_s`` exactly, per request
    and therefore summed (see ``Request.ttft_breakdown``)."""
    n_missed: int = 0
    ttft_s: float = 0.0
    queue_wait_s: float = 0.0
    rotation_stall_s: float = 0.0
    prefill_compute_s: float = 0.0


def _miss_breakdown(requests: Sequence[Request]) -> TTFTMissBreakdown:
    bd = TTFTMissBreakdown()
    for r in requests:
        if r.aborted or r.ttft_ok() is not False:
            continue
        d = r.ttft_breakdown()
        if d is None:
            continue
        bd.n_missed += 1
        bd.ttft_s += d["ttft_s"]
        bd.queue_wait_s += d["queue_wait_s"]
        bd.rotation_stall_s += d["rotation_stall_s"]
        bd.prefill_compute_s += d["prefill_compute_s"]
    return bd


@dataclasses.dataclass
class ClassReport:
    """Attainment breakdown for one SLO class."""
    n: int
    n_aborted: int
    n_no_token: int
    ttft_attainment: float
    tbt_attainment: float
    p50_ttft: float
    p99_ttft: float
    ttft_miss: TTFTMissBreakdown = dataclasses.field(
        default_factory=TTFTMissBreakdown)


@dataclasses.dataclass
class SLOReport:
    n: int
    ttft_attainment: float
    tbt_attainment: float
    p50_ttft: float
    p99_ttft: float
    p50_tbt: float
    p99_tbt: float
    mean_tbt: float
    throughput_tok_s: float
    total_time_s: float
    rotations: int
    migrations: int = 0                # cross-replica KV handoffs (disagg)
    n_aborted: int = 0
    n_no_token: int = 0
    # Two-tier prefix cache (0.0/0 with the cache off — replay-inert):
    # hit rate = cached prompt tokens / total prompt tokens, over all
    # requests in the report (a merged report therefore yields the
    # cluster-wide rate from the union of raw requests).
    prefix_hit_rate: float = 0.0
    prefill_tokens_saved: int = 0      # prompt tokens served from cache
    # Per-iteration timing breakdown (accumulated ms across the engine's
    # iterations; cluster reports sum the replicas' — EngineStats.timing_row
    # feeds these via the ``timing`` kwarg). overlap_ms > 0 is the
    # observable pipelining win (transfer time hidden under compute).
    schedule_ms: float = 0.0
    transfer_ms: float = 0.0
    execute_ms: float = 0.0
    overlap_ms: float = 0.0
    ttft_miss: TTFTMissBreakdown = dataclasses.field(
        default_factory=TTFTMissBreakdown)
    per_class: Dict[str, ClassReport] = dataclasses.field(default_factory=dict)

    def row(self) -> Dict[str, object]:
        return dataclasses.asdict(self)


def merge_reports(groups: Sequence[Sequence[Request]], total_time: float,
                  timing: Optional[Dict[str, float]] = None) -> SLOReport:
    """Aggregate per-replica request groups into one cluster-level report.

    Percentiles are not mergeable from per-replica summaries, so the merge
    recomputes every metric from the union of the raw requests; counts and
    attainment come out equal to the request-weighted combination of the
    per-replica reports (tested in test_engine_core.py). ``timing`` is the
    cluster-summed per-iteration breakdown (merged EngineStats).
    """
    return evaluate([r for g in groups for r in g], total_time=total_time,
                    timing=timing)


def _attainment(requests: Sequence[Request]):
    """(live, done, ttft_ok, tbt_ok) with aborts excluded from `live`."""
    live = [r for r in requests if not r.aborted]
    done = [r for r in live if r.t_first_token is not None]
    ttft_ok = [r for r in done if r.ttft_ok()]
    tbt_ok = [r for r in done if r.tbt_ok()]
    return live, done, ttft_ok, tbt_ok


def evaluate(requests: Sequence[Request], *, total_time: float,
             timing: Optional[Dict[str, float]] = None) -> SLOReport:
    live, done, ttft_ok, tbt_ok = _attainment(requests)
    # TBT attainment: a request attains its TBT SLO if its mean TBT is within
    # the threshold (per-request accounting, like the paper); requests that
    # never produced a token can satisfy neither SLO and count as misses.
    ttfts = [r.ttft() for r in done]
    tbts = [v for r in done for v in r.tbt_values()]
    toks = sum(r.tokens_generated for r in requests)
    n_live = len(live)
    per_class: Dict[str, ClassReport] = {}
    for name in sorted({r.slo_class for r in requests}):
        sub = [r for r in requests if r.slo_class == name]
        s_live, s_done, s_ttft_ok, s_tbt_ok = _attainment(sub)
        s_ttfts = [r.ttft() for r in s_done]
        per_class[name] = ClassReport(
            n=len(sub),
            n_aborted=len(sub) - len(s_live),
            n_no_token=len(s_live) - len(s_done),
            ttft_attainment=len(s_ttft_ok) / len(s_live) if s_live else 0.0,
            tbt_attainment=len(s_tbt_ok) / len(s_live) if s_live else 0.0,
            p50_ttft=percentile(s_ttfts, 50),
            p99_ttft=percentile(s_ttfts, 99),
            ttft_miss=_miss_breakdown(sub))
    cached_toks = sum(r.num_cached_tokens for r in requests)
    prompt_toks = sum(r.prompt_len for r in requests)
    return SLOReport(
        n=len(requests),
        ttft_attainment=len(ttft_ok) / n_live if n_live else 0.0,
        tbt_attainment=len(tbt_ok) / n_live if n_live else 0.0,
        p50_ttft=percentile(ttfts, 50),
        p99_ttft=percentile(ttfts, 99),
        p50_tbt=percentile(tbts, 50),
        p99_tbt=percentile(tbts, 99),
        mean_tbt=float(np.mean(tbts)) if tbts else 0.0,
        throughput_tok_s=toks / total_time if total_time else 0.0,
        total_time_s=total_time,
        rotations=sum(r.rotations for r in requests),
        migrations=sum(r.migrations for r in requests),
        n_aborted=len(requests) - n_live,
        n_no_token=n_live - len(done),
        prefix_hit_rate=cached_toks / prompt_toks if prompt_toks else 0.0,
        prefill_tokens_saved=cached_toks,
        schedule_ms=timing.get("schedule_ms", 0.0) if timing else 0.0,
        transfer_ms=timing.get("transfer_ms", 0.0) if timing else 0.0,
        execute_ms=timing.get("execute_ms", 0.0) if timing else 0.0,
        overlap_ms=timing.get("overlap_ms", 0.0) if timing else 0.0,
        ttft_miss=_miss_breakdown(requests),
        per_class=per_class)
