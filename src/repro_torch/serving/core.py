"""EngineCore: one-iteration-at-a-time serving core with an online API.

The monolithic ``ServingEngine.run()`` replay loop is decomposed into three
layers that compose per iteration (see DESIGN.md §Engine-core architecture):

    scheduler policy  ->  AdmissionController  ->  BatchBuilder  ->  execute/
    (serving.schedulers)  (state transitions +     (BatchPlan, no   transfer +
                           block-budget accounting) Request mutation) commit

``EngineCore.step()`` performs exactly one iteration — arrivals, schedule,
admission/preemption, batch build, execute/transfer, commit — and returns an
``IterationOutcome`` describing what happened. Requests may be added while
the engine runs (``add_request``), which is what the multi-replica router
(serving.router) and any future async front-end build on. The legacy batch
driver ``ServingEngine.run(requests)`` is now a thin replay loop over this
core and produces bit-identical metrics.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from typing import Dict, List, Optional, Sequence, Set, Tuple

from torch.profiler import record_function

from repro_torch.configs.base import (HardwareProfile, ModelConfig, ServingConfig,
                                      SLOConfig, GH200)
from repro_torch.core.blocktable import OutOfBlocks
from repro_torch.core.duplexkv import DuplexKV
from repro_torch.core.transfer import PipelineTimeline
from repro_torch.core.types import (FINISH_ABORTED, Request, RequestOutput,
                                    RequestState, SamplingParams, resolve_slo_class)
from repro_torch.serving.executor import (BatchPlan, Executor,
                                          RealExecutorAdapter, SimExecutor)
from repro_torch.serving.outputs import DriverClaim, OutputCollector, RequestHandle
from repro_torch.serving.schedulers import Scheduler, make_scheduler
from repro_torch.serving.telemetry import PHASES


@dataclasses.dataclass
class EngineStats:
    iterations: int = 0
    exec_time: float = 0.0
    transfer_time: float = 0.0
    stall_time: float = 0.0            # transfer time NOT hidden by exec
    passive_preemptions: int = 0
    active_rotations: int = 0
    eager_blocks: int = 0
    dropped: int = 0
    aborted: int = 0                   # client cancellations (abort API)
    prefill_tokens: int = 0            # prompt tokens actually executed
    # per-iteration timing breakdown (accumulated milliseconds), ALL
    # modeled times — a real host-clock measurement here would make the
    # otherwise deterministic report rows unreproducible across runs.
    schedule_ms: float = 0.0           # host planning share (plan_time)
    transfer_ms: float = 0.0           # transfer channel occupancy (+ eager)
    execute_ms: float = 0.0            # kernel execution time
    overlap_ms: float = 0.0            # transfer time hidden under compute

    def merged_with(self, other: "EngineStats") -> "EngineStats":
        return EngineStats(*(a + b for a, b in
                             zip(dataclasses.astuple(self),
                                 dataclasses.astuple(other))))

    def timing_row(self) -> Dict[str, float]:
        """The per-iteration timing breakdown, for SLOReport/serve.py."""
        return dict(schedule_ms=self.schedule_ms,
                    transfer_ms=self.transfer_ms,
                    execute_ms=self.execute_ms,
                    overlap_ms=self.overlap_ms)


@dataclasses.dataclass
class WallStats:
    """Wall seconds on the host's monotonic clock (``time.monotonic_ns``),
    apart from ``EngineStats``, whose rows are modelled and deterministic:
    nothing in the engine reads these back. ``<phase>_wall_s`` partition
    ``step_wall_s``, the non-idle steps' wall, exactly. A queue wait runs
    from a request's submission to the plan of its first prefill chunk; a
    time out from its ``rotate_out`` to its ``complete_swap_in``."""
    schedule_wall_s: float = 0.0       # ingest, schedule, admission, build
    kv_plan_wall_s: float = 0.0        # plan_iteration and its row movement
    execute_wall_s: float = 0.0        # execute, or execute_async().wait()
    commit_wall_s: float = 0.0         # tokens, finishes, output dispatch
    step_wall_s: float = 0.0
    queue_wait_wall_s: float = 0.0
    queue_waits: int = 0
    rotated_out_wall_s: float = 0.0
    rotation_returns: int = 0

    def add_step(self, ns: Sequence[int]) -> None:
        """Count one step from its boundary readings (``StepWalls.ns``)."""
        for phase, a, b in zip(PHASES, ns, ns[1:]):
            key = f"{phase}_wall_s"
            setattr(self, key, getattr(self, key) + (b - a) / 1e9)
        self.step_wall_s += (ns[-1] - ns[0]) / 1e9


class StepWalls:
    """One ``time.monotonic_ns()`` reading at each phase boundary of one
    step (``ns``), so the phases partition it exactly. A phase's
    ``superinfer.<phase>`` profiler range opens before the reading that
    starts the phase and closes after the one that ends it, so on the
    profiler's timeline each reading lies inside the ranges of both phases
    it divides. ``execute`` has no range: the runner's cover it."""

    RANGED = frozenset(("schedule", "kv_plan", "commit"))

    def __init__(self) -> None:
        self.ns: List[int] = []
        self._range = None
        self.next("schedule")

    def next(self, phase: str) -> None:
        """The boundary before ``phase``."""
        rf = None
        if phase in self.RANGED:
            rf = record_function("superinfer." + phase)
            rf.__enter__()
        self.ns.append(time.monotonic_ns())
        self.close()
        self._range = rf

    def end(self) -> None:
        """The step's last reading; the commit range stays open until
        ``close``, so what the flight recorder stamps with the readings
        is recorded inside it."""
        self.ns.append(time.monotonic_ns())

    def close(self) -> None:
        if self._range is not None:
            self._range.__exit__(None, None, None)
            self._range = None


@dataclasses.dataclass
class AdmissionOutcome:
    """What the admission layer decided this iteration."""
    preempt_ids: List[int] = dataclasses.field(default_factory=list)
    swapin_ids: List[int] = dataclasses.field(default_factory=list)
    started: List[Request] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class IterationOutcome:
    """One ``EngineCore.step()``: timing, the batch, and every transition."""
    t_start: float
    t_end: float
    idle: bool = False                 # no runnable work: clock jump only
    exec_s: float = 0.0
    transfer_s: float = 0.0
    plan: Optional[BatchPlan] = None
    admitted: List[int] = dataclasses.field(default_factory=list)   # W -> R
    resumed: List[int] = dataclasses.field(default_factory=list)    # S -> R
    preempted: List[int] = dataclasses.field(default_factory=list)  # R -> S
    finished: List[int] = dataclasses.field(default_factory=list)
    # streaming events: one per request that produced tokens or finished
    outputs: List[RequestOutput] = dataclasses.field(default_factory=list)


class AdmissionController:
    """Owns request lifecycle transitions and HBM block-budget accounting.

    The scheduler expresses *policy* (who should run); admission enforces
    *feasibility*: which prioritized requests fit the free-block budget once
    preempted requests release theirs, and which running requests must be
    passively rotated when an allocation fails mid-batch (vLLM's OOM path).
    """

    def __init__(self, kv: DuplexKV, stats: EngineStats, block_size: int,
                 executor: Optional[Executor] = None,
                 walls: Optional[WallStats] = None):
        self.kv = kv
        self.stats = stats
        self.bs = block_size
        self.executor = executor or Executor()   # default: no-op hooks
        self.walls = walls or WallStats()

    def _admit_need(self, r: Request, kv_view) -> int:
        """HBM blocks the request must still acquire. With the prefix cache
        on (``kv_view`` set — the same snapshot the scheduler used, so the
        two layers can never drift), admission charges only the uncached
        suffix: cache-hit blocks and shared prefixes a ROTARY request left
        resident are free."""
        need = r.blocks_needed(self.bs)
        if kv_view is not None:
            need = max(need - kv_view.resident.get(r.req_id, 0), 0)
        return need

    def _freed_by(self, r: Request, kv_view) -> int:
        """HBM blocks a preemption actually releases (shared prefix blocks
        stay resident for their other referencing requests)."""
        need = r.blocks_needed(self.bs)
        if kv_view is not None:
            return min(need, kv_view.releasable.get(r.req_id, need))
        return need

    def apply(self, decision, kv_view=None,
              t: Optional[float] = None) -> AdmissionOutcome:
        out = AdmissionOutcome()
        for r in decision.preempted:
            if r.state != RequestState.RUNNING:
                continue
            out.preempt_ids.append(r.req_id)
            r.rotate_out(t)
            r.wall_rotated_ns = time.monotonic_ns()
            self.stats.active_rotations += 1
            self.executor.swap_out(r.req_id)

        freed = sum(self._freed_by(r, kv_view) for r in decision.preempted)
        budget = self.kv.hbm_free_blocks + freed
        for r in decision.prioritized:
            need = self._admit_need(r, kv_view)
            if need > budget:
                continue
            if r.state == RequestState.ROTARY \
                    and r.req_id not in out.preempt_ids:
                out.swapin_ids.append(r.req_id)
                budget -= need
            elif r.state == RequestState.WAITING:
                out.started.append(r)
                budget -= need
        return out

    def passive_preempt(self, r: Request, out: AdmissionOutcome,
                        t: Optional[float] = None) -> None:
        out.preempt_ids.append(r.req_id)
        r.rotate_out(t)
        r.wall_rotated_ns = time.monotonic_ns()
        self.stats.passive_preemptions += 1
        self.executor.swap_out(r.req_id)

    def start_prefill(self, r: Request, t: float) -> None:
        r.start_running(t)

    def complete_swap_in(self, r: Request, t: float) -> None:
        r.resume(t)
        if r.wall_rotated_ns is not None:
            self.walls.rotated_out_wall_s += (
                time.monotonic_ns() - r.wall_rotated_ns) / 1e9
            self.walls.rotation_returns += 1
            r.wall_rotated_ns = None
        self.executor.swap_in(r.req_id)


class BatchBuilder:
    """Builds one iteration's ``BatchPlan`` (decodes + chunked prefills).

    Allocation failures are routed through the admission controller's passive
    preemption; chunk sizes live on the plan (``prefill_chunks``), never on
    the ``Request``.
    """

    def __init__(self, serving: ServingConfig, kv: DuplexKV,
                 admission: AdmissionController):
        self.serving = serving
        self.kv = kv
        self.admission = admission

    def build(self, active: Sequence[Request], adm: AdmissionOutcome,
              t: float) -> BatchPlan:
        bs = self.serving.block_size
        plan = BatchPlan()
        running = [r for r in active if r.state == RequestState.RUNNING]
        decodes = [r for r in running if r.prefill_done]
        decodes = decodes[:self.serving.max_batch_size]
        for r in decodes:
            try:
                self.kv.grow(r.req_id, r.blocks_needed(bs, lookahead=1))
            except OutOfBlocks:
                self.admission.passive_preempt(r, adm, t)
                continue
            plan.decode_reqs.append(r.req_id)
            plan.decode_kv_tokens += r.total_len

        chunk_budget = self.serving.prefill_chunk
        for r in [x for x in running if not x.prefill_done] + adm.started:
            if chunk_budget <= 0:
                break
            take = min(chunk_budget, r.prompt_len - r.prefill_pos)
            if take <= 0:
                continue
            try:
                needed = -(-(r.prefill_pos + take) // bs)
                self.kv.grow(r.req_id, needed)
            except OutOfBlocks:
                if r.state == RequestState.RUNNING:
                    self.admission.passive_preempt(r, adm, t)
                continue
            if r.state == RequestState.WAITING:
                self.admission.start_prefill(r, t)
            if r.wall_first_chunk_ns is None:
                r.wall_first_chunk_ns = time.monotonic_ns()
                if r.wall_submit_ns is not None:
                    walls = self.admission.walls
                    walls.queue_wait_wall_s += (
                        r.wall_first_chunk_ns - r.wall_submit_ns) / 1e9
                    walls.queue_waits += 1
            plan.prefill_chunks.append((r.req_id, take))
            plan.prefill_tokens += take
            plan.prefill_attn_tokens += take * (r.prefill_pos + take)
            chunk_budget -= take
        return plan


class EngineCore:
    """Event-driven serving core: ``add_request`` any time, ``step`` once per
    iteration, ``drain`` to completion. One EngineCore == one replica."""

    def __init__(self, cfg: ModelConfig, serving: ServingConfig,
                 hw: HardwareProfile = GH200,
                 scheduler: Optional[Scheduler] = None,
                 executor: Optional[Executor] = None,
                 real_executor=None,
                 runner_cfg: Optional[ModelConfig] = None,
                 runner_seed: int = 0,
                 device=None):
        self.cfg = cfg
        self.serving = serving
        self.hw = hw
        self.scheduler = scheduler or make_scheduler(serving.scheduler,
                                                     serving.rotary)
        # -- executor resolution: one ``Executor`` serves the whole step().
        #    * ``real_executor`` (legacy per-request prefill/decode object)
        #      is wrapped in the protocol adapter, timed by a SimExecutor;
        #    * ``serving.paged_runner`` builds the batched PagedModelRunner
        #      (``runner_cfg``: the model it executes — typically a tiny
        #      ``reduced()`` — while timing stays on ``cfg``) on ``device``
        #      (CUDA unless the caller passes "cpu");
        #    * default: pure SimExecutor (tokens are oracle counts).
        self.real = real_executor
        tp = int(getattr(serving, "tp", 1) or 1)
        kvd = getattr(serving, "kv_dtype", "bf16")
        if real_executor is not None:
            self.executor: Executor = RealExecutorAdapter(
                real_executor, executor or SimExecutor(cfg, hw, tp=tp,
                                                       kv_dtype=kvd))
        elif executor is not None:
            self.executor = executor
        elif serving.paged_runner:
            from repro_torch.serving.paged_runner import PagedModelRunner
            self.executor = PagedModelRunner(
                runner_cfg or cfg, serving, hw, seed=runner_seed,
                timing_cfg=cfg, device=device)
        else:
            self.executor = SimExecutor(cfg, hw, tp=tp, kv_dtype=kvd)
        self.kv = DuplexKV(cfg, serving, hw)
        if hasattr(self.executor, "bind"):
            self.executor.bind(self.kv)   # pool-backed executors attach here
        self.stats = EngineStats()
        self.walls = WallStats()
        self.clock = 0.0
        # Flight recorder (DESIGN.md §Observability). Default off: no bus
        # is allocated and step() takes the golden-replay code path — every
        # telemetry hook below is behind ``if self.telemetry is not None``.
        # Over the paged runner the bus also keeps the clock offset that
        # puts its wall stamps on the profiler's clock, and the trace
        # export lays them out in place of the sim clock's.
        self.replica_index = 0
        self.replica_role = "replica"
        self.telemetry = None
        if getattr(serving, "telemetry", False):
            from repro_torch.serving.paged_runner import PagedModelRunner
            from repro_torch.serving.telemetry import TelemetryBus
            self.telemetry = TelemetryBus(
                capacity=getattr(serving, "telemetry_buffer", 65536),
                wall=isinstance(self.executor, PagedModelRunner))
        self._exec_ema = 0.03   # for auto B_xfer sizing
        # Cross-iteration two-stage pipeline (ServingConfig.pipeline): the
        # per-direction transfer channels persist across step() calls and
        # compute serializes only on true row dependencies. Scheduling
        # decisions are UNCHANGED (each step still plans against the
        # post-commit state of the previous one), so token streams are
        # structurally identical to synchronous mode — only the clock math
        # and the executor dispatch path differ.
        self._pipeline = bool(serving.pipeline)
        self._timeline = PipelineTimeline() if self._pipeline else None
        self._pipe_warm = False   # pipeline filled: plan N+1 ran under exec N
        # Prefix caching requires block-level KV sharing on the device; the
        # dense per-request caches of the legacy RealExecutor cannot share,
        # so the cache is forced off under it. The paged runner CAN — its
        # cache-hit blocks are genuinely shared pool rows.
        self._prefix_cache = (serving.prefix_cache
                              and self.executor.supports_prefix_cache)
        self.admission = AdmissionController(self.kv, self.stats,
                                             serving.block_size,
                                             self.executor, self.walls)
        self.batcher = BatchBuilder(serving, self.kv, self.admission)
        self.active: List[Request] = []
        self._pending: List[Tuple[float, int, Request]] = []   # arrival heap
        self._seq = itertools.count()
        self.submitted: List[Request] = []     # every request ever added
        self._index: Dict[int, Request] = {}   # req_id -> live request (O(1))
        self._next_req_id = 0                  # auto ids for add_request()
        self.collector = OutputCollector()
        # Exclusive-driver ownership: while claimed (serving.async_engine),
        # synchronous pumps/drains refuse to advance the engine.
        self.driver_claim = DriverClaim()

    # ------------------------------------------------------------- online API
    def add_request(self, prompt_len: Optional[int] = None, *,
                    prompt_ids: Optional[Sequence[int]] = None,
                    sampling_params: Optional[SamplingParams] = None,
                    slo_class: str = "standard",
                    slo: Optional[SLOConfig] = None,
                    arrival_time: Optional[float] = None,
                    req_id: Optional[int] = None) -> RequestHandle:
        """Public submission entry: build a Request from client-facing params
        and return a streaming ``RequestHandle``.

        Exactly one of ``prompt_len`` (oracle/sim mode) or ``prompt_ids``
        (real-executor mode) is required. ``arrival_time`` defaults to the
        engine's current clock (i.e. "now"); ``slo`` overrides the tier the
        ``slo_class`` name resolves to. Passing a pre-built ``Request`` as
        the first argument is the legacy path and delegates to ``submit``
        (no streaming attachment — replay callers never consume events).
        """
        if isinstance(prompt_len, Request):      # legacy Request-object path
            return self.submit(prompt_len)
        if (prompt_len is None) == (prompt_ids is None):
            raise ValueError("pass exactly one of prompt_len or prompt_ids")
        if prompt_ids is not None:
            prompt_ids = [int(x) for x in prompt_ids]
            prompt_len = len(prompt_ids)
        if prompt_len < 1:
            raise ValueError("prompt must be non-empty")
        sp = sampling_params or SamplingParams()
        tier = resolve_slo_class(slo_class)   # validate even under override
        req = Request(
            req_id=self._next_req_id if req_id is None else req_id,
            arrival_time=self.clock if arrival_time is None else arrival_time,
            prompt_len=prompt_len,
            output_len=sp.max_tokens,
            slo=slo or tier,
            slo_class=slo_class,
            sampling=sp,
            prompt_ids=prompt_ids,
            wall_submit_ns=time.monotonic_ns())
        return self.submit(req, make_handle=True)

    def submit(self, req: Request, *, make_handle: bool = False
               ) -> RequestHandle:
        """Internal/legacy constructor path: enqueue a pre-built Request; it
        enters the engine once ``clock`` reaches its ``arrival_time``
        (requests with past arrival times enter next step). Streaming
        delivery only attaches with ``make_handle=True`` (the new-style
        ``add_request`` path) — trace replay must not accumulate event
        buffers nobody consumes."""
        if req.req_id in self._index:
            raise ValueError(f"duplicate req_id {req.req_id}")
        heapq.heappush(self._pending, (req.arrival_time, next(self._seq), req))
        self.submitted.append(req)
        self._index[req.req_id] = req
        self._next_req_id = max(self._next_req_id, req.req_id + 1)
        handle = RequestHandle(req, pump=self._pump, abort_fn=self.abort)
        if make_handle:
            self.collector.attach(handle)
        return handle

    def set_replica(self, index: int, role: str = "replica") -> None:
        """Label this core for multi-replica telemetry/metrics (router
        replicas, disagg prefill/decode pools)."""
        self.replica_index = int(index)
        self.replica_role = role
        if self.telemetry is not None:
            self.telemetry.replica = int(index)
            self.telemetry.role = role

    def abort(self, req_id: int) -> bool:
        """Cancel a request: free its HBM/DRAM blocks, cancel any pending
        swap-in, and drop it from the pending/active sets. Safe in any
        non-finished state; returns False if unknown or already finished.
        The final streaming event carries ``finish_reason == "aborted"``."""
        r = self._index.get(req_id)
        if r is None or r.state == RequestState.FINISHED:
            return False
        self._remove_live(req_id)
        # frees HBM and DRAM residency in one go; a ROTARY request with a
        # swap-in scheduled for the next iteration simply never reaches the
        # scheduler again (the swap-in is cancelled by removal from `active`)
        self.kv.finish(req_id)
        self.executor.drop(req_id)
        r.finish_at(self.clock, reason=FINISH_ABORTED)
        if self.telemetry is not None:
            now = time.monotonic_ns()
            self.telemetry.span("FINISH", req_id, self.clock, self.clock,
                                slo_class=r.slo_class, wall=(now, now),
                                reason=FINISH_ABORTED,
                                tokens=r.tokens_generated)
        del self._index[req_id]
        self.stats.aborted += 1
        self.collector.dispatch([r.make_output(self.clock)])
        return True

    def _remove_live(self, req_id: int) -> None:
        """Drop a request from the active set or, failing that, the arrival
        heap (shared by abort and the migration detach)."""
        if any(a.req_id == req_id for a in self.active):
            self.active = [a for a in self.active if a.req_id != req_id]
        else:                          # still on the arrival heap
            self._pending = [(t, s, q) for (t, s, q) in self._pending
                             if q.req_id != req_id]
            heapq.heapify(self._pending)

    # -------------------------------------------------- migration (disagg)
    def detach_request(self, req_id: int) -> Optional[Request]:
        """Remove a live request WITHOUT finishing it — the first step of a
        cross-replica handoff (serving.disagg). KV block export/import is
        the caller's job (``DuplexKV.migrate_export``); this only severs the
        engine-side bookkeeping. Pool-backed executors hold no per-request
        state, so ``drop`` is safe; the dense legacy RealExecutor cannot
        migrate (its caches are not exportable) and is rejected by
        ``DisaggCluster``. Returns the request, or None if unknown/finished.
        """
        r = self._index.get(req_id)
        if r is None or r.state == RequestState.FINISHED:
            return None
        del self._index[req_id]
        self._remove_live(req_id)
        self.executor.drop(req_id)
        return r

    def adopt_request(self, req: Request, *, arrival_time: float) -> None:
        """Insert a migrated-in request. Its KV must already be imported
        into this replica's DRAM tier (``DuplexKV.migrate_import``) and its
        state set ROTARY; it enters the engine once the clock reaches
        ``arrival_time`` (the migration's D2H completion) and resumes
        through the ordinary rotary swap-in path. NOT added to
        ``submitted`` — the request stays attributed to the replica it
        arrived on; cluster-level reporting owns the union."""
        if req.req_id in self._index:
            raise ValueError(f"adopt_request: duplicate req_id {req.req_id}")
        heapq.heappush(self._pending, (arrival_time, next(self._seq), req))
        self._index[req.req_id] = req
        self._next_req_id = max(self._next_req_id, req.req_id + 1)

    def rotary_backlog_blocks(self) -> int:
        """HBM blocks the pending swap-ins of this replica's ROTARY
        requests will demand — the H2D pressure signal the disaggregation
        dispatcher gates migrations on (migrated-in requests land ROTARY,
        so their H2D competes with rotation resumptions)."""
        bs = self.serving.block_size
        live = self.active + [p[2] for p in self._pending]
        return sum(r.blocks_needed(bs) for r in live
                   if r.state == RequestState.ROTARY)

    def _pump(self) -> bool:
        """Advance one iteration on behalf of a streaming handle."""
        self.driver_claim.require("RequestHandle pump (stream()/result())")
        if not self.has_work:
            return False
        self.step()
        return True

    @property
    def has_work(self) -> bool:
        return bool(self.active or self._pending)

    @property
    def load(self) -> int:
        """Requests in flight (admitted or queued) — router load signal."""
        return len(self.active) + len(self._pending)

    def queued_prefill_tokens(self) -> int:
        """Prompt tokens not yet prefilled — a TTFT-pressure signal."""
        live = [r for r in self.active] + [p[2] for p in self._pending]
        return sum(r.prompt_len - r.prefill_pos for r in live
                   if not r.prefill_done)

    def drain(self, max_time_s: float = 1e9) -> None:
        """Replay-time drain: step until idle or the ENGINE clock (simulated
        seconds) passes ``max_time_s``. Unsuitable for graceful shutdown of
        an online service — a backlogged engine can simulate far less than
        wall time in ``max_time_s`` wall seconds; use ``drain_wallclock``."""
        self.driver_claim.require("drain()")
        while self.has_work and self.clock < max_time_s:
            self.step()

    def drain_wallclock(self, timeout_s: float, *, owner=None, on_step=None,
                        now=None) -> List[int]:
        """Wall-clock-bounded drain for graceful shutdown: step until idle
        or ``timeout_s`` HOST seconds elapse (measured with
        ``time.monotonic``), regardless of how much simulated time each
        iteration models. Returns the req_ids still unfinished at the
        deadline (empty list = clean drain). ``on_step(outcome)`` fires
        after every iteration so a streaming front-end can keep delivering
        tokens while draining; ``owner`` identifies the exclusive driver
        when one holds the claim."""
        now = now or time.monotonic
        self.driver_claim.require("drain_wallclock()", owner=owner)
        deadline = now() + timeout_s
        while self.has_work and now() < deadline:
            out = self.step()
            if on_step is not None:
                on_step(out)
        return self.live_request_ids()

    def wall_counters(self) -> Dict[str, float]:
        """This replica's host wall-clock counters, flat and cumulative:
        the steps' phases and the requests' waits (``WallStats``), the
        runner's sync (``sync_wall_s``), the store's readbacks and stacks
        (``readback_wall_s``, ``kv_stack_wall_s``) and DuplexKV's eager
        demotion (``eager_d2h_rows``, ``eager_d2h_wall_s``). An executor
        or store without a counter leaves it out. Observability only."""
        out = {k: float(v) for k, v in dataclasses.asdict(self.walls).items()}
        store = getattr(self.executor, "store", None)
        for obj, names in ((self.executor, ("sync_wall_s",)),
                           (store, ("readback_wall_s", "kv_stack_wall_s")),
                           (self.kv, ("eager_d2h_rows", "eager_d2h_wall_s"))):
            out.update({n: float(getattr(obj, n)) for n in names
                        if hasattr(obj, n)})
        return out

    def live_request_ids(self) -> List[int]:
        """req_ids still pending or active (not finished/aborted), sorted."""
        return sorted(self._index)

    # ------------------------------------------------------------- iteration
    def step(self) -> IterationOutcome:
        """Run exactly one engine iteration at the current clock."""
        t = self.clock
        if not self.active and not (self._pending
                                    and self._pending[0][0] <= t):
            if self._pending:   # idle: jump to the next arrival
                self.clock = self._pending[0][0]
            self._pipe_warm = False   # pipeline drains across an idle gap
            return IterationOutcome(t_start=t, t_end=self.clock, idle=True)
        walls = StepWalls()
        try:
            return self._iterate(t, walls)
        finally:
            walls.close()

    def _iterate(self, t: float, walls: StepWalls) -> IterationOutcome:
        """The non-idle step at clock ``t``; ``walls`` takes a reading at
        each phase boundary."""
        self._ingest(t)

        # -- schedule --------------------------------------------------------
        bs = self.serving.block_size
        b_xfer = None
        if self.serving.auto_b_xfer:
            # size the per-iteration transfer budget to what the duplex
            # link can hide under model execution (§4.2.3 co-design)
            rate = self.kv.engine.sustained_block_rate(
                self.kv.block_bytes, self.kv.table.segments_per_block)
            b_xfer = max(int(rate * self._exec_ema), 1)
        kv_view = (self.kv.scheduler_view(self.active)
                   if self._prefix_cache else None)
        decision = self.scheduler.schedule(
            self.active, t, self.kv.hbm_free_blocks, bs, b_xfer=b_xfer,
            kv_view=kv_view)

        # -- admission / preemption (same residency snapshot as the
        # scheduler, so the two layers' block accounting cannot drift) ------
        adm = self.admission.apply(decision, kv_view=kv_view, t=t)

        # -- build device batch ---------------------------------------------
        plan = self.batcher.build(self.active, adm, t)

        # stall-breaker: cache-hit blocks pinned at ingest by still-waiting
        # requests are neither evictable (refcount > 0) nor preemptible (no
        # running owner). If an iteration schedules nothing at all while
        # such pins exist, they may be starving admission of the very blocks
        # it needs — un-pin them; the requests retry uncached next step.
        if (self._prefix_cache and plan.empty and not adm.started
                and not adm.swapin_ids and not adm.preempt_ids):
            for r in self.active:
                if (r.state == RequestState.WAITING and r.num_cached_tokens
                        and r.prefill_pos == r.num_cached_tokens):
                    self.kv.drop_prefix_refs(r.req_id)
                    r.num_cached_tokens = 0
                    r.prefill_pos = 0
        # budgeted-but-unstarted requests (chunk budget exhausted, OOB) stay
        # WAITING and are not admissions; they retry next iteration
        admitted = [r.req_id for r in adm.started
                    if r.state == RequestState.RUNNING]

        # -- execute + transfer (pipelined or serial) -----------------------
        walls.next("kv_plan")
        exec_s = self.executor.step_time(plan)
        # pipelined mode: the batch's read/write pool rows are known before
        # transfers stage, so eager demotion can avoid rows the kernels
        # WRITE this iteration (a logically-synced tail block's last token
        # lands physically now — see blocktable.eager_candidates)
        plan_rows = self._plan_rows(plan) if self._pipeline else None
        xfers = self.kv.plan_iteration(
            adm.preempt_ids, adm.swapin_ids, iteration_budget_s=exec_s,
            exclude_slots=plan_rows[1] if plan_rows else frozenset())
        self.stats.schedule_ms += self.executor.plan_time(plan) * 1e3
        tr_s = xfers.stats.e2e_time
        eager_d2h = xfers.eager_stats.d2h_time if xfers.eager_stats else 0.0
        if self._pipeline:
            # Cross-iteration pipeline: this iteration's transfers occupy
            # their per-direction channels from NOW (they were planned while
            # the previous iteration executed) and keep streaming under the
            # following iterations' compute; compute starts as soon as its
            # true row dependencies allow. Eager demotions ride the D2H
            # channel — reads of synced, never-rewritten rows, legal under
            # concurrent compute (blocktable.guard_compute).
            # after the pipeline fills, this iteration's host planning ran
            # during the PREVIOUS iteration's execute window — its share of
            # the fixed overhead leaves the critical path (the first
            # iteration after an idle gap pays it: pipeline fill)
            hidden_plan = (self.executor.plan_time(plan)
                           if self._pipe_warm else 0.0)
            end, ov, stall = self._timeline.advance(
                t, max(exec_s - hidden_plan, 0.0),
                xfers.stats.d2h_time + eager_d2h,
                xfers.stats.h2d_time,
                exec_needs_h2d=xfers.promo_blocks > 0,
                h2d_after_d2h=xfers.h2d_after_d2h,
                gates_next_exec=bool(xfers.swapin_done))
            iter_s = max(end - t, 1e-4)
            self.stats.stall_time += stall
            self.stats.overlap_ms += (ov + hidden_plan) * 1e3
            self._pipe_warm = True
            if self.telemetry is not None:
                w = self._timeline.last
                tel_w = dict(exec_start=w["exec"][0],
                             exec_dur=w["exec"][1] - w["exec"][0],
                             d2h_start=w["d2h"][0], h2d_start=w["h2d"][0],
                             overlap=ov, stall=stall, hidden=hidden_plan)
        elif self.serving.pipeline_overlap:
            iter_s = max(exec_s, tr_s, 1e-4)
            self.stats.stall_time += max(tr_s - exec_s, 0.0)
            self.stats.overlap_ms += min(exec_s, tr_s) * 1e3
            if self.telemetry is not None:
                # within-iteration overlap: both channels start with exec;
                # a half-duplex link serializes H2D behind D2H
                serial_dirs = self.kv.engine.mode != "duplex"
                d2h_busy = xfers.stats.d2h_time + eager_d2h
                tel_w = dict(exec_start=t, exec_dur=exec_s, d2h_start=t,
                             h2d_start=t + (d2h_busy if serial_dirs else 0.0),
                             overlap=min(exec_s, tr_s),
                             stall=max(tr_s - exec_s, 0.0), hidden=0.0)
        else:
            iter_s = exec_s + tr_s + 0.001   # serial schedule+transfer
            self.stats.stall_time += tr_s
            if self.telemetry is not None:
                # strictly serial: transfers land, then the batch executes
                d2h_busy = xfers.stats.d2h_time + eager_d2h
                tel_w = dict(exec_start=t + tr_s + 0.001, exec_dur=exec_s,
                             d2h_start=t, h2d_start=t + d2h_busy,
                             overlap=0.0, stall=tr_s, hidden=0.0)
        self.clock = t + iter_s
        self.stats.iterations += 1
        self.stats.exec_time += exec_s
        self.stats.transfer_time += tr_s
        self.stats.execute_ms += exec_s * 1e3
        self.stats.transfer_ms += (tr_s + eager_d2h) * 1e3
        self.stats.prefill_tokens += plan.prefill_tokens
        self._exec_ema = 0.9 * self._exec_ema + 0.1 * exec_s
        if xfers.eager_stats:
            self.stats.eager_blocks += int(
                xfers.eager_stats.d2h_bytes // max(self.kv.block_bytes, 1))

        # -- commit results --------------------------------------------------
        resumed: List[int] = []
        for rid in xfers.swapin_done:
            r = self._by_id(rid)
            if r is not None and r.state == RequestState.ROTARY:
                self.admission.complete_swap_in(r, self.clock)
                resumed.append(rid)

        # model execution: the executor sees requests in their PRE-commit
        # state and returns at most one sampled token per request (empty in
        # sim mode — oracle token accounting needs only the counts below).
        # Runs after plan_iteration so swap-in/promotion rows have landed in
        # the physical pool before any kernel reads them. Pipelined mode
        # declares the batch's pool rows first (the transfer/compute hazard
        # guard — carried eager D2H may only RACE reads) and dispatches
        # through execute_async: every launch enqueues without a host sync
        # and wait() is the iteration's single sync point.
        walls.next("execute")
        if self._pipeline:
            self.kv.table.set_compute_rows(*plan_rows)
            try:
                result = self.executor.execute_async(plan, self._index).wait()
            finally:
                self.kv.table.clear_compute_rows()
        else:
            result = self.executor.execute(plan, self._index)
        walls.next("commit")

        new_count: Dict[int, int] = {}        # req_id -> tokens this iter
        new_ids: Dict[int, List[int]] = {}    # req_id -> their ids (real mode)

        def emit_token(r: Request, tok: int) -> None:
            r.generated_ids.append(tok)
            new_ids.setdefault(r.req_id, []).append(tok)
            if r.sampling is not None and r.sampling.stops_on(tok):
                r.stopped = True

        for rid, take in plan.prefill_chunks:
            r = self._by_id(rid)
            if r is None:
                continue
            r.prefill_pos += take
            if r.prefill_done and r.tokens_generated == 0:
                if rid in result.tokens:
                    emit_token(r, result.tokens[rid])
                r.record_token(self.clock)    # first token at prefill tail
                new_count[rid] = new_count.get(rid, 0) + 1
            self.kv.sync_progress(r.req_id, r.prefill_pos,
                                  written_from=r.prefill_pos - take)

        for rid in plan.decode_reqs:
            r = self._by_id(rid)
            if r is None or r.state != RequestState.RUNNING:
                continue
            if rid in result.tokens:
                emit_token(r, result.tokens[rid])
            r.record_token(self.clock)
            new_count[rid] = new_count.get(rid, 0) + 1
            # the token sampled THIS iteration has no KV yet (it is written
            # when fed back next iteration), so the physically written
            # position is total_len - 2 post-commit — the invalidation
            # anchor for host-copy staleness (see invalidate_dirty_tail)
            self.kv.sync_progress(r.req_id, r.total_len,
                                  written_from=max(r.total_len - 2, 0))

        finished: List[int] = []
        for r in self.active:
            if r.done and r.state != RequestState.FINISHED:
                r.finish_at(self.clock)   # reason: "stop" if EOS else "length"
                self.kv.finish(r.req_id)
                self.executor.drop(r.req_id)
                finished.append(r.req_id)
                new_count.setdefault(r.req_id, 0)

        outputs = [r.make_output(self.clock, new_count[r.req_id],
                                 new_ids.get(r.req_id))
                   for r in self.active if r.req_id in new_count]
        self.collector.dispatch(outputs)
        walls.end()
        self.walls.add_step(walls.ns)
        if self.telemetry is not None:
            self._record_telemetry(t, adm, plan, xfers, eager_d2h,
                                   admitted, resumed, finished, tel_w,
                                   walls.ns)
        for rid in finished:
            self._index.pop(rid, None)
        self.active = [r for r in self.active
                       if r.state != RequestState.FINISHED]

        return IterationOutcome(
            t_start=t, t_end=self.clock, exec_s=exec_s, transfer_s=tr_s,
            plan=plan, admitted=admitted, resumed=resumed,
            preempted=adm.preempt_ids, finished=finished, outputs=outputs)

    # -------------------------------------------------------------- telemetry
    def _record_telemetry(self, t: float, adm: AdmissionOutcome,
                          plan: BatchPlan, xfers, eager_d2h: float,
                          admitted: List[int], resumed: List[int],
                          finished: List[int], w: Dict[str, float],
                          ns: Sequence[int]) -> None:
        """Record this iteration on the flight recorder: one EngineEvent
        (execution + per-direction channel windows) plus the request
        lifecycle spans it produced. Called only when the bus exists;
        append-only side records — nothing here feeds back into the sim.
        ``ns`` are the step's phase-boundary readings (``StepWalls``): the
        wall stamps of the event and of the spans (a request's own for
        ADMIT; the kv_plan phase for the rotations, whose rows move there;
        the execute phase for PREFILL and DECODE)."""
        from repro_torch.core.vlt import vlt
        tel = self.telemetry
        kv_plan, execute = (ns[1], ns[2]), (ns[2], ns[3])
        bb = self.kv.block_bytes
        eager_bytes = xfers.eager_stats.d2h_bytes if xfers.eager_stats else 0
        d2h_busy = xfers.stats.d2h_time + eager_d2h
        h2d_busy = xfers.stats.h2d_time
        tel.event(
            iteration=self.stats.iterations, t_start=t, t_end=self.clock,
            exec_start=w["exec_start"], exec_s=w["exec_dur"],
            d2h_start=w["d2h_start"], d2h_s=d2h_busy,
            h2d_start=w["h2d_start"], h2d_s=h2d_busy,
            sched_s=self.executor.plan_time(plan),
            overlap_s=w["overlap"], stall_s=w["stall"],
            plan_hidden_s=w["hidden"],
            wall_start_ns=ns[0], wall_end_ns=ns[-1],
            **{f"{phase}_wall_s": (b - a) / 1e9
               for phase, a, b in zip(PHASES, ns, ns[1:])},
            attrs=dict(
                decode_reqs=len(plan.decode_reqs),
                prefill_chunks=len(plan.prefill_chunks),
                prefill_tokens=plan.prefill_tokens,
                decode_kv_tokens=plan.decode_kv_tokens,
                hbm_free_blocks=self.kv.hbm_free_blocks,
                cache_hit_tokens=self.kv.table.cache_hit_tokens,
                d2h_bytes=xfers.stats.d2h_bytes + eager_bytes,
                h2d_bytes=xfers.stats.h2d_bytes,
                kv_shards=self.kv.kv_shards,
                vlt_max=max((vlt(r, t, self.serving.rotary)
                             for r in self.active), default=0.0)))
        admitted_set = set(admitted)
        for r in adm.started:
            if r.req_id in admitted_set:
                wall = (r.wall_submit_ns, r.wall_first_chunk_ns)
                tel.span("ADMIT", r.req_id, r.arrival_time, t,
                         slo_class=r.slo_class,
                         wall=None if None in wall else wall,
                         queue_wait_s=t - r.arrival_time)
        for rid, take in plan.prefill_chunks:
            r = self._by_id(rid)
            if r is not None:
                tel.span("PREFILL", rid, w["exec_start"],
                         w["exec_start"] + w["exec_dur"],
                         slo_class=r.slo_class, wall=execute, tokens=take,
                         pos=r.prefill_pos)
        for rid in plan.decode_reqs:
            r = self._by_id(rid)
            if r is not None:
                tel.span("DECODE", rid, w["exec_start"],
                         w["exec_start"] + w["exec_dur"],
                         slo_class=r.slo_class, wall=execute,
                         tokens_generated=r.tokens_generated)
        for rid in adm.preempt_ids:
            r = self._by_id(rid)
            if r is not None:
                tel.span("ROTATE_OUT", rid, w["d2h_start"],
                         w["d2h_start"] + d2h_busy,
                         slo_class=r.slo_class, wall=kv_plan,
                         direction="d2h",
                         bytes=len(self.kv.table.blocks_of(rid)) * bb)
        for rid in resumed:
            r = self._by_id(rid)
            if r is not None:
                tel.span("ROTATE_IN", rid, w["h2d_start"],
                         w["h2d_start"] + h2d_busy,
                         slo_class=r.slo_class, wall=kv_plan,
                         direction="h2d",
                         bytes=len(self.kv.table.blocks_of(rid)) * bb)
        for rid in finished:
            r = self._by_id(rid)
            if r is not None:
                attrs = dict(reason=r.finish_reason,
                             tokens=r.tokens_generated,
                             rotations=r.rotations, migrations=r.migrations)
                bd = r.ttft_breakdown()
                if bd is not None:
                    attrs.update(bd)
                tel.span("FINISH", rid, self.clock, self.clock,
                         slo_class=r.slo_class, wall=(ns[-1], ns[-1]),
                         **attrs)

    # ------------------------------------------------------------------ utils
    def _plan_rows(self, plan: BatchPlan) -> Tuple[Set[int], Set[int]]:
        """HBM pool rows this iteration's kernels read / write — the hazard
        declaration for pipelined mode (``blocktable.set_compute_rows``).
        Writes: the decode tail block (the new token's K/V) and the prefill
        chunk's rows; reads: every other assigned row (context)."""
        P = self.serving.block_size
        reads: Set[int] = set()
        writes: Set[int] = set()
        for rid in plan.decode_reqs:
            r = self._by_id(rid)
            if r is None:
                continue
            wi = (r.total_len - 1) // P
            for i, b in enumerate(self.kv.table.blocks_of(rid)):
                if b.hbm_slot is None:
                    continue
                (writes if i == wi else reads).add(b.hbm_slot)
        for rid, take in plan.prefill_chunks:
            r = self._by_id(rid)
            if r is None or take <= 0:
                continue
            lo = r.prefill_pos // P
            hi = (r.prefill_pos + take - 1) // P
            for i, b in enumerate(self.kv.table.blocks_of(rid)):
                if b.hbm_slot is None:
                    continue
                (writes if lo <= i <= hi else reads).add(b.hbm_slot)
        return reads, writes

    def _ingest(self, t: float) -> None:
        while self._pending and self._pending[0][0] <= t:
            r = heapq.heappop(self._pending)[2]
            if self._prefix_cache and r.prefill_pos == 0:
                # content-addressed lookup on arrival: hit blocks are shared
                # (incref'd) now so they cannot be evicted while r waits, and
                # prefill starts at the first uncached token
                cached = self.kv.lookup_prefix(r.req_id, r.prompt_ids)
                if cached:
                    r.num_cached_tokens = cached
                    r.prefill_pos = cached
            self.active.append(r)

    def is_live(self, req_id: int) -> bool:
        """True while the request is pending or active (not finished or
        aborted) — the router's owner-map pruning predicate."""
        return req_id in self._index

    def _by_id(self, rid: int) -> Optional[Request]:
        """O(1) live-request lookup (hot path: every decode req, every
        iteration). The index spans pending+active; entries leave on
        finish/abort, so a stale rid from an earlier iteration misses."""
        return self._index.get(rid)
