"""Disaggregated prefill/decode serving: two replica pools bridged by
cross-replica KV migration over the DRAM tier (DESIGN.md §Disaggregation).

``DisaggCluster`` partitions its replicas into a **prefill pool** and a
**decode pool**. A request prefills (and emits its first token — TTFT is
paid entirely on the prefill side) on a prefill replica, then its KV blocks
are handed to a decode replica through the DRAM tier
(``core.migration.MigrationEngine``): D2H on the source rides the
eager-demotion path (already-demoted blocks move for free), the host-side
slot handoff is zero-copy, and the H2D on the target rides the target's own
``plan_iteration`` as an ordinary rotary swap-in. Decode replicas therefore
run almost pure decode batches — no prefill chunks inflating their
iteration time — which is what protects TBT from prefill interference, the
same way RotaSched protects TTFT from head-of-line blocking.

Dispatch policy:

* **Prefill placement** — least-loaded over the prefill pool, refined by
  the TTFT deadline: a slack-rich request (e.g. the ``batch`` tier) parks on
  the most-loaded replica that still meets its deadline, keeping the
  emptiest replicas clear for tight-deadline arrivals.
* **Migration backpressure** — a decode replica is only eligible as a
  handoff target while its pending-swap-in backlog stays under
  ``migration_watermark`` blocks: migrated-in requests land ROTARY and
  their H2D competes with the replica's own rotation resumptions, so the
  gate keeps decode H2D from starving rotation traffic. Gated handoffs are
  deferred and retried next iteration.
* **Colocation fallback** — when the prefill pool's queue exceeds
  ``colocate_watermark`` tokens, new arrivals prefill directly on the
  least-prefill-loaded decode replica (and never migrate); a request whose
  handoff stays gated past ``defer_tokens`` decode steps is pinned to its
  prefill replica. Either way pool imbalance degrades gracefully into the
  colocated behaviour instead of queueing.

Replicas are full ``EngineCore`` instances (sim or paged-runner executors;
the dense legacy ``RealExecutor`` cannot export its caches and is not
constructible here). ``--disagg`` in ``launch.serve`` is the CLI surface.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Set

from repro_torch.configs.base import (HardwareProfile, ModelConfig, ServingConfig,
                                SLOConfig, GH200)
from repro_torch.core.migration import MigrationEngine, MigrationRecord
from repro_torch.core.types import (Request, RequestState, SamplingParams,
                              resolve_slo_class)
from repro_torch.serving.core import EngineCore, EngineStats, IterationOutcome
from repro_torch.serving.metrics import SLOReport, evaluate
from repro_torch.serving.outputs import DriverClaim

PREFILL_POOL = "prefill"
DECODE_POOL = "decode"


class DisaggCluster:
    def __init__(self, cfg: ModelConfig, serving: ServingConfig,
                 hw: HardwareProfile = GH200, *,
                 prefill_replicas: int = 1, decode_replicas: int = 1,
                 migration_watermark: int = 2048,
                 colocate_watermark: int = 8192,
                 defer_tokens: int = 4,
                 deadline_slack: float = 0.5,
                 runner_cfg: Optional[ModelConfig] = None,
                 runner_seed: int = 0, device=None):
        if prefill_replicas < 1 or decode_replicas < 1:
            raise ValueError("need at least one replica in each pool")
        if migration_watermark < 1:
            raise ValueError("migration_watermark must be >= 1 block")
        mk = lambda: EngineCore(cfg, serving, hw, runner_cfg=runner_cfg,  # noqa: E731
                                runner_seed=runner_seed, device=device)
        self.prefill_pool: List[EngineCore] = [mk()
                                               for _ in range(prefill_replicas)]
        self.decode_pool: List[EngineCore] = [mk()
                                              for _ in range(decode_replicas)]
        self.replicas: List[EngineCore] = self.prefill_pool + self.decode_pool
        for i, core in enumerate(self.replicas):
            core.set_replica(i, role=("prefill" if i < prefill_replicas
                                      else "decode"))
        self._pool_of = {id(c): PREFILL_POOL for c in self.prefill_pool}
        self._pool_of.update({id(c): DECODE_POOL for c in self.decode_pool})
        self.serving = serving
        self.migrator = MigrationEngine()
        self.migration_watermark = migration_watermark
        self.colocate_watermark = colocate_watermark
        self.defer_tokens = defer_tokens
        self.deadline_slack = deadline_slack
        # roofline prefill rate (tokens/s) for the TTFT-deadline heuristic —
        # a placement signal, not a simulator (attention term omitted)
        self._prefill_tok_rate = max(
            hw.flops_bf16 * hw.mfu / (2.0 * cfg.active_param_count()), 1.0)
        self._owner: Dict[int, EngineCore] = {}     # req_id -> current core
        self._requests: List[Request] = []          # cluster-level union
        self._no_migrate: Set[int] = set()          # colocated requests
        self.colocated_prefills = 0                 # dispatch-time fallbacks
        self._next_req_id = 0
        self.driver_claim = DriverClaim()           # exclusive-driver ownership

    # ------------------------------------------------------------- placement
    def _choose_prefill(self, req: Request) -> EngineCore:
        """TTFT-deadline-aware least-loaded over the prefill pool. Load
        signals are snapshotted once — ``queued_prefill_tokens`` scans the
        replica's live set, so per-candidate recomputation would make every
        placement O(pool * live)."""
        queued = {id(c): c.queued_prefill_tokens() for c in self.prefill_pool}
        cores = sorted(self.prefill_pool,
                       key=lambda c: (queued[id(c)], c.load))
        budget = req.slo.ttft_s * self.deadline_slack
        for c in reversed(cores):       # most-loaded first
            est = (queued[id(c)] + req.prompt_len) / self._prefill_tok_rate
            if est <= budget:
                return c
        return cores[0]                 # nobody meets the deadline: emptiest

    def _place(self, req: Request) -> "tuple[EngineCore, bool]":
        """Returns ``(core, colocated)``. Colocation fires only when the
        prefill pool's queue is past the watermark AND a decode replica is
        genuinely less prefill-loaded (pool-imbalance absorption, not a
        steady-state bypass)."""
        best = self._choose_prefill(req)
        best_queued = best.queued_prefill_tokens()
        if best_queued + req.prompt_len > self.colocate_watermark:
            dec_queued = {id(c): c.queued_prefill_tokens()
                          for c in self.decode_pool}
            dec = min(self.decode_pool,
                      key=lambda c: (dec_queued[id(c)], c.load))
            if dec_queued[id(dec)] < best_queued:
                return dec, True
        return best, False

    def _pick_decode_target(self, n_blocks: int,
                            backlog: Dict[int, int]) -> Optional[EngineCore]:
        """``backlog`` is the per-scan snapshot of each decode replica's
        pending-swap-in blocks (id(core) -> blocks), maintained by the
        caller across candidates so one scan never rescans live sets."""
        cands = [c for c in self.decode_pool
                 if backlog[id(c)] + n_blocks <= self.migration_watermark]
        if not cands:
            return None
        return min(cands, key=lambda c: (backlog[id(c)], c.load))

    # ------------------------------------------------------------- online API
    def add_request(self, prompt_len=None, *,
                    prompt_ids: Optional[Sequence[int]] = None,
                    sampling_params: Optional[SamplingParams] = None,
                    slo_class: str = "standard",
                    slo: Optional[SLOConfig] = None,
                    arrival_time: Optional[float] = None):
        """Mirror of ``Router.add_request``: client-facing params return a
        cluster-pumping ``RequestHandle``; a pre-built ``Request`` takes the
        trace-replay path and returns the chosen ``(pool, index)``."""
        if isinstance(prompt_len, Request):
            return self.submit(prompt_len)
        t = self.clock if arrival_time is None else arrival_time
        self.advance_to(t)
        sp = sampling_params or SamplingParams()
        probe = Request(req_id=-1, arrival_time=t,
                        prompt_len=(len(prompt_ids) if prompt_ids is not None
                                    else int(prompt_len or 1)),
                        output_len=sp.max_tokens, slo_class=slo_class,
                        slo=slo or resolve_slo_class(slo_class))
        core, colocated = self._place(probe)
        rid = self._next_req_id
        self._next_req_id += 1
        handle = core.add_request(
            prompt_len, prompt_ids=prompt_ids, sampling_params=sp,
            slo_class=slo_class, slo=slo, arrival_time=t, req_id=rid)
        self._register(handle.request, core, colocated)
        handle.bind_pump(self._pump)
        handle.bind_abort(self.abort)
        return handle

    def submit(self, req: Request) -> "tuple[str, int]":
        """Trace-replay path: place and enqueue a pre-built request; returns
        ``(pool_name, replica_index_within_pool)``."""
        if req.req_id in self._owner:
            raise ValueError(f"duplicate req_id {req.req_id} across the "
                             f"cluster")
        self.advance_to(req.arrival_time)
        core, colocated = self._place(req)
        core.submit(req)
        self._register(req, core, colocated)
        pool = self._pool_of[id(core)]
        pool_list = (self.prefill_pool if pool == PREFILL_POOL
                     else self.decode_pool)
        return pool, pool_list.index(core)

    def _register(self, req: Request, core: EngineCore,
                  colocated: bool) -> None:
        self._owner[req.req_id] = core
        self._requests.append(req)
        self._next_req_id = max(self._next_req_id, req.req_id + 1)
        if colocated:
            self._no_migrate.add(req.req_id)
            self.colocated_prefills += 1

    def abort(self, req_id: int) -> bool:
        core = self._owner.get(req_id)
        if core is None:
            return False
        return core.abort(req_id)

    def _pump(self) -> bool:
        self.driver_claim.require("RequestHandle pump (stream()/result())")
        return self.step() is not None

    # -------------------------------------------------------------- stepping
    def step(self) -> Optional[IterationOutcome]:
        """Step the lagging replica (earliest clock with work), then hand
        off any freshly finished prefills it produced."""
        live = [i for i, c in enumerate(self.replicas) if c.has_work]
        if not live:
            return None
        idx = min(live, key=lambda i: (self.replicas[i].clock, i))
        return self._step_core(self.replicas[idx])

    def _step_core(self, core: EngineCore) -> IterationOutcome:
        out = core.step()
        if self._pool_of[id(core)] == PREFILL_POOL:
            self._scan_migrations(core)
        return out

    def advance_to(self, t: float) -> None:
        for core in self.replicas:
            while core.has_work and core.clock < t:
                self._step_core(core)

    @property
    def has_work(self) -> bool:
        return any(c.has_work for c in self.replicas)

    @property
    def clock(self) -> float:
        return max(c.clock for c in self.replicas)

    def drain(self, max_time_s: float = 1e9) -> None:
        self.driver_claim.require("drain()")
        while self.has_work and self.clock < max_time_s:
            if self.step() is None:
                break

    def drain_wallclock(self, timeout_s: float, *, owner=None, on_step=None,
                        now=None) -> List[int]:
        """Wall-clock-bounded cluster drain (graceful shutdown); see
        EngineCore.drain_wallclock. Returns unfinished req_ids across both
        pools."""
        now = now or time.monotonic
        self.driver_claim.require("drain_wallclock()", owner=owner)
        deadline = now() + timeout_s
        while self.has_work and now() < deadline:
            out = self.step()
            if out is None:
                break
            if on_step is not None:
                on_step(out)
        return self.live_request_ids()

    def live_request_ids(self) -> List[int]:
        return sorted(rid for c in self.replicas
                      for rid in c.live_request_ids())

    def run(self, requests: Sequence[Request], *,
            max_time_s: float = 1e9) -> SLOReport:
        for r in sorted(requests, key=lambda r: r.arrival_time):
            self.submit(r)
        self.drain(max_time_s)
        return self.aggregate_report()

    # -------------------------------------------------------------- migration
    def _scan_migrations(self, src: EngineCore) -> None:
        """Hand finished prefills off to the decode pool. Candidates are
        post-first-token requests (TTFT already paid here); a candidate the
        backpressure gate defers past ``defer_tokens`` decode steps is
        pinned colocated — by then it owns a warm decode context and the
        handoff would cost more than it saves."""
        backlog: Optional[Dict[int, int]] = None   # built on first candidate
        for r in list(src.active):
            if (r.state not in (RequestState.RUNNING, RequestState.ROTARY)
                    or not r.prefill_done or r.tokens_generated < 1
                    or r.done or r.req_id in self._no_migrate):
                continue
            if r.tokens_generated > self.defer_tokens:
                self._no_migrate.add(r.req_id)
                self.migrator.stats.colocated_sticky += 1
                continue
            if backlog is None:
                backlog = {id(c): c.rotary_backlog_blocks()
                           for c in self.decode_pool}
            n_blocks = len(src.kv.table.blocks_of(r.req_id))
            dst = self._pick_decode_target(n_blocks, backlog)
            if dst is None or not self.migrator.can_migrate(r.req_id,
                                                            src.kv, dst.kv):
                self.migrator.stats.deferred += 1
                continue
            self._migrate(r, src, dst)
            backlog[id(dst)] += n_blocks   # the handoff just queued its H2D

    def _migrate(self, r: Request, src: EngineCore,
                 dst: EngineCore) -> MigrationRecord:
        w0 = time.monotonic_ns()
        rec = self.migrator.migrate(r.req_id, src.kv, dst.kv, src.clock)
        wall = (w0, time.monotonic_ns())
        src.detach_request(r.req_id)
        r.begin_migration()
        dst.adopt_request(r, arrival_time=rec.t_ready)
        if src.telemetry is not None:
            src.telemetry.span(
                "MIGRATE", r.req_id, rec.t_start, rec.t_ready,
                slo_class=r.slo_class, wall=wall, direction="d2h",
                bytes=rec.nbytes, d2h_bytes=rec.d2h_bytes,
                blocks=rec.blocks, dst_replica=dst.replica_index,
                shared_on_target=rec.shared_on_target)
        if dst.telemetry is not None:
            dst.telemetry.span(
                "MIGRATE", r.req_id, rec.t_start, rec.t_ready,
                slo_class=r.slo_class, wall=wall, direction="h2d",
                bytes=rec.nbytes, blocks=rec.blocks,
                src_replica=src.replica_index)
        handle = src.collector.detach(r.req_id)
        if handle is not None:
            dst.collector.attach(handle)
        self._owner[r.req_id] = dst
        return rec

    # ---------------------------------------------------------------- reports
    def aggregate_report(self) -> SLOReport:
        return evaluate(self._requests, total_time=self.clock,
                        timing=self.aggregate_stats().timing_row())

    def aggregate_stats(self) -> EngineStats:
        out = EngineStats()
        for c in self.replicas:
            out = out.merged_with(c.stats)
        return out

    def pool_token_counts(self) -> Dict[str, int]:
        """Generated tokens attributed to the pool that finally owned each
        request (a migrated request's tokens count as decode-pool work)."""
        counts = {PREFILL_POOL: 0, DECODE_POOL: 0}
        for r in self._requests:
            core = self._owner.get(r.req_id)
            if core is not None:
                counts[self._pool_of[id(core)]] += r.tokens_generated
        return counts

    def migration_counters(self) -> Dict[str, object]:
        row = self.migrator.stats.row()
        row["colocated_prefills"] = self.colocated_prefills
        return row

    def aggregate_cache_counters(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for c in self.replicas:
            for k, v in c.kv.cache_counters().items():
                out[k] = out.get(k, 0) + v
        return out
