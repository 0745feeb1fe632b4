"""Multi-replica front-end: N independent EngineCores behind a routing policy.

Each replica is a full SuperInfer engine (own scheduler, DuplexKV block table,
clock). The router advances every replica's simulation to a request's arrival
time before routing it, so load-aware policies see the state an online
dispatcher would. Policies:

  * ``round-robin``     — arrival order, ignores load (baseline),
  * ``least-loaded``    — fewest requests in flight,
  * ``slo-aware``       — least TTFT pressure: pending prefill tokens (the
    work standing between a new arrival and its first token) plus the decode
    population as a tiebreaker, scaled by remaining HBM headroom,
  * ``prefix-affinity`` — consistent-hash on the request's first-block
    prefix hash, so same-prefix requests land on the same replica and hit
    its prefix cache instead of re-prefilling cold on another one;
    cache-cold requests (no token ids / shorter than one block) fall back
    to least-loaded.

``Router.run(trace)`` replays a whole arrival trace; ``add_request``/
``step``/``drain`` mirror the single-engine online API. Reports come
per-replica and aggregated (metrics.merge_reports).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.configs.base import (HardwareProfile, ModelConfig, ServingConfig,
                                SLOConfig, GH200)
from repro_torch.core.types import Request, SamplingParams
from repro_torch.serving.core import EngineCore, EngineStats, IterationOutcome
from repro_torch.serving.metrics import SLOReport, evaluate, merge_reports
from repro_torch.serving.outputs import DriverClaim, RequestHandle


# --------------------------------------------------------------------- policy
class RoutingPolicy:
    name = "base"

    def choose(self, replicas: Sequence[EngineCore], req: Request) -> int:
        raise NotImplementedError


class RoundRobin(RoutingPolicy):
    name = "round-robin"

    def __init__(self):
        self._next = 0

    def choose(self, replicas, req):
        idx = self._next % len(replicas)
        self._next += 1
        return idx


class LeastLoaded(RoutingPolicy):
    """Fewest requests in flight (queued + admitted); ties to lowest index."""
    name = "least-loaded"

    def choose(self, replicas, req):
        return min(range(len(replicas)), key=lambda i: (replicas[i].load, i))


class SLOAware(RoutingPolicy):
    """Route where the new request's TTFT is least at risk: minimize queued
    prefill work, weighted up when the replica's HBM pool is near-full (a
    full pool means admission must wait on rotation transfers)."""
    name = "slo-aware"

    def choose(self, replicas, req):
        def risk(i: int):
            core = replicas[i]
            free = core.kv.hbm_free_blocks
            total = core.kv.table.num_hbm_blocks
            pressure = 1.0 + (1.0 - free / total if total else 0.0)
            return (core.queued_prefill_tokens() * pressure
                    + 0.1 * len(core.active), i)
        return min(range(len(replicas)), key=risk)


class PrefixAffinity(RoutingPolicy):
    """Consistent-hash on the first-block prefix hash: requests sharing a
    prompt prefix (multi-turn chat, common system prompts) concentrate on
    one replica, whose prefix cache then serves them — per-replica caches
    are independent, so scattering same-prefix requests (round-robin) pays
    one cold prefill per replica instead of one per cluster. The hash ring
    (``VNODES`` virtual nodes per replica) keeps the mapping stable as
    replica count changes; cache-cold requests — no token ids, or a prompt
    shorter than one block — carry nothing cacheable and fall back to
    least-loaded."""
    name = "prefix-affinity"
    VNODES = 32
    _MASK = (1 << 32) - 1

    def __init__(self):
        self._fallback = LeastLoaded()
        self._ring: List[tuple] = []        # [(point, replica_idx)] sorted
        self._ring_n = 0

    def _ring_for(self, n: int) -> List[tuple]:
        if self._ring_n != n:
            # int-only tuples: Python hashes them deterministically
            # regardless of PYTHONHASHSEED (unlike str)
            self._ring = sorted(
                (hash((0x51AF_F1A1, i, v)) & self._MASK, i)
                for i in range(n) for v in range(self.VNODES))
            self._ring_n = n
        return self._ring

    def choose(self, replicas, req):
        ids = req.prompt_ids
        bs = replicas[0].serving.block_size
        if not ids or len(ids) < bs:
            return self._fallback.choose(replicas, req)
        from repro_torch.core.duplexkv import prefix_hash_chain
        key = prefix_hash_chain(ids[:bs], bs)[0] & self._MASK
        ring = self._ring_for(len(replicas))
        lo, hi = 0, len(ring)
        while lo < hi:                       # first ring point >= key
            mid = (lo + hi) // 2
            if ring[mid][0] < key:
                lo = mid + 1
            else:
                hi = mid
        return ring[lo % len(ring)][1]


_POLICIES = {p.name: p for p in (RoundRobin, LeastLoaded, SLOAware,
                                 PrefixAffinity)}
ROUTER_POLICIES = tuple(sorted(_POLICIES))


def make_policy(name: str) -> RoutingPolicy:
    try:
        return _POLICIES[name.lower()]()
    except KeyError:
        raise KeyError(f"unknown router policy {name!r}; "
                       f"known: {ROUTER_POLICIES}") from None


# --------------------------------------------------------------------- router
@dataclasses.dataclass
class ReplicaReport:
    idx: int
    report: SLOReport
    stats: EngineStats
    n_routed: int


class Router:
    def __init__(self, cfg: ModelConfig, serving: ServingConfig,
                 hw: HardwareProfile = GH200, *, replicas: int = 2,
                 policy: str = "least-loaded",
                 runner_cfg: Optional[ModelConfig] = None,
                 runner_seed: int = 0, device=None):
        if replicas < 1:
            raise ValueError("need at least one replica")
        # each replica owns its executor (paged runners: independent pools)
        self.replicas: List[EngineCore] = [
            EngineCore(cfg, serving, hw, runner_cfg=runner_cfg,
                       runner_seed=runner_seed, device=device)
            for _ in range(replicas)]
        for i, core in enumerate(self.replicas):
            core.set_replica(i)
        self.policy = make_policy(policy)
        self._owner: Dict[int, int] = {}   # req_id -> replica index
        self._next_req_id = 0              # cluster-unique ids (handle path)
        self.driver_claim = DriverClaim()  # exclusive-driver ownership

    # ------------------------------------------------------------- online API
    def add_request(self, prompt_len=None, *,
                    prompt_ids: Optional[Sequence[int]] = None,
                    sampling_params: Optional[SamplingParams] = None,
                    slo_class: str = "standard",
                    slo: Optional[SLOConfig] = None,
                    arrival_time: Optional[float] = None):
        """Route one request to a replica.

        New-style (client-facing params) returns a ``RequestHandle`` whose
        pump advances the *cluster* (lagging-replica order), with a
        cluster-unique req_id; ``handle.abort()`` is forwarded to the owning
        replica. The legacy path (a pre-built ``Request`` as the first
        argument) keeps returning the chosen replica index. Replicas are
        first advanced to the arrival time so load signals are current.
        """
        if isinstance(prompt_len, Request):          # legacy trace-replay path
            req = prompt_len
            if req.req_id in self._owner:
                raise ValueError(f"duplicate req_id {req.req_id} across the "
                                 f"cluster")
            self.advance_to(req.arrival_time)
            idx = self.policy.choose(self.replicas, req)
            self.replicas[idx].submit(req)
            self._owner[req.req_id] = idx
            self._next_req_id = max(self._next_req_id, req.req_id + 1)
            return idx
        t = self.clock if arrival_time is None else arrival_time
        self.advance_to(t)
        probe = Request(req_id=-1, arrival_time=t,
                        prompt_len=(len(prompt_ids) if prompt_ids is not None
                                    else int(prompt_len or 1)),
                        output_len=(sampling_params or SamplingParams()
                                    ).max_tokens)
        idx = self.policy.choose(self.replicas, probe)
        rid = self._next_req_id
        self._next_req_id += 1
        handle = self.replicas[idx].add_request(
            prompt_len, prompt_ids=prompt_ids,
            sampling_params=sampling_params, slo_class=slo_class, slo=slo,
            arrival_time=t, req_id=rid)
        self._owner[rid] = idx
        handle.bind_pump(self._pump)
        handle.bind_abort(self.abort)   # keep the owner map consistent
        return handle

    def abort(self, req_id: int) -> bool:
        """Forward an abort to the replica that owns the request."""
        idx = self._owner.pop(req_id, None)
        if idx is None:
            return False
        return self.replicas[idx].abort(req_id)

    def _pump(self) -> bool:
        self.driver_claim.require("RequestHandle pump (stream()/result())")
        return self.step() is not None

    def step(self) -> Optional[IterationOutcome]:
        """Step the lagging replica (earliest clock with work): keeps the
        cluster simulation causally consistent with one global timeline."""
        live = [i for i, c in enumerate(self.replicas) if c.has_work]
        if not live:
            return None
        idx = min(live, key=lambda i: (self.replicas[i].clock, i))
        out = self.replicas[idx].step()
        for rid in out.finished:       # keep the owner map bounded by live
            self._owner.pop(rid, None)
        return out

    def advance_to(self, t: float) -> None:
        for core in self.replicas:
            while core.has_work and core.clock < t:
                for rid in core.step().finished:
                    self._owner.pop(rid, None)

    @property
    def has_work(self) -> bool:
        return any(c.has_work for c in self.replicas)

    @property
    def clock(self) -> float:
        return max(c.clock for c in self.replicas)

    def drain(self, max_time_s: float = 1e9) -> None:
        self.driver_claim.require("drain()")
        for core in self.replicas:
            core.drain(max_time_s)
        # this path bypasses Router.step's per-finish pruning
        self._owner = {rid: idx for rid, idx in self._owner.items()
                       if self.replicas[idx].is_live(rid)}

    def drain_wallclock(self, timeout_s: float, *, owner=None, on_step=None,
                        now=None) -> List[int]:
        """Wall-clock-bounded cluster drain (graceful shutdown); steps the
        lagging replica until idle or ``timeout_s`` host seconds elapse.
        Returns unfinished req_ids across all replicas (see
        EngineCore.drain_wallclock)."""
        now = now or time.monotonic
        self.driver_claim.require("drain_wallclock()", owner=owner)
        deadline = now() + timeout_s
        while self.has_work and now() < deadline:
            out = self.step()
            if out is None:
                break
            if on_step is not None:
                on_step(out)
        self._owner = {rid: idx for rid, idx in self._owner.items()
                       if self.replicas[idx].is_live(rid)}
        return self.live_request_ids()

    def live_request_ids(self) -> List[int]:
        return sorted(rid for c in self.replicas
                      for rid in c.live_request_ids())

    def run(self, requests: Sequence[Request], *,
            max_time_s: float = 1e9) -> SLOReport:
        for r in sorted(requests, key=lambda r: r.arrival_time):
            self.add_request(r)
        self.drain(max_time_s)
        return self.aggregate_report()

    # ---------------------------------------------------------------- reports
    def per_replica_reports(self) -> List[ReplicaReport]:
        return [ReplicaReport(idx=i,
                              report=evaluate(c.submitted,
                                              total_time=c.clock),
                              stats=c.stats, n_routed=len(c.submitted))
                for i, c in enumerate(self.replicas)]

    def aggregate_report(self) -> SLOReport:
        return merge_reports([c.submitted for c in self.replicas],
                             total_time=self.clock,
                             timing=self.aggregate_stats().timing_row())

    def aggregate_stats(self) -> EngineStats:
        out = EngineStats()
        for c in self.replicas:
            out = out.merged_with(c.stats)
        return out

    def aggregate_cache_counters(self) -> Dict[str, int]:
        """Cluster-wide prefix-cache counters (summed over replicas).

        Each replica owns an independent cache — there is no cross-replica
        block sharing — so the cluster hit rate depends on how often the
        routing policy lands same-prefix requests on the same replica
        (round-robin scatters them; ``prefix-affinity`` concentrates them —
        asserted in tests/test_prefix_cache.py). The report-level
        ``prefix_hit_rate`` from
        ``aggregate_report`` is already cluster-wide: ``merge_reports``
        recomputes it from the union of raw requests.
        """
        out: Dict[str, int] = {}
        for c in self.replicas:
            for k, v in c.kv.cache_counters().items():
                out[k] = out.get(k, 0) + v
        return out
