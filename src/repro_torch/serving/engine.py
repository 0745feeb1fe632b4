"""ServingEngine: the single-replica serving front-end.

All per-iteration mechanics live in serving.core (EngineCore + admission +
batch building); this module keeps the user-facing surface:

  * the **online API** — ``add_request(req)`` / ``step()`` / ``drain()`` —
    requests may arrive while the engine runs (used by serving.router and
    the launchers), and
  * the legacy **batch driver** ``run(requests)``: a thin replay loop over
    ``EngineCore.step()`` that produces the same SLOReport the monolithic
    loop did (tested bit-identical).

Only device execution time and link transfer time come from calibrated
models (serving.executor, core.transfer); the scheduler, block table and
transfer planning are the real code paths. The cross-iteration pipeline
(paper Fig. 15) is the ``pipeline_overlap`` flag: schedule+transfers overlap
model execution, so an iteration takes max(exec, transfer) instead of their
sum.
"""
from __future__ import annotations

from typing import Optional, Sequence

from repro_torch.configs.base import (HardwareProfile, ModelConfig, ServingConfig,
                                      SLOConfig, GH200)
from repro_torch.core.types import Request, SamplingParams
from repro_torch.serving.core import EngineCore, EngineStats, IterationOutcome
from repro_torch.serving.executor import SimExecutor
from repro_torch.serving.metrics import SLOReport, evaluate
from repro_torch.serving.outputs import RequestHandle
from repro_torch.serving.schedulers import Scheduler

__all__ = ["ServingEngine", "EngineStats", "EngineCore", "IterationOutcome",
           "RequestHandle"]


class ServingEngine:
    def __init__(self, cfg: ModelConfig, serving: ServingConfig,
                 hw: HardwareProfile = GH200,
                 scheduler: Optional[Scheduler] = None,
                 executor: Optional[SimExecutor] = None,
                 real_executor=None,
                 runner_cfg: Optional[ModelConfig] = None,
                 runner_seed: int = 0,
                 device=None):
        self.core = EngineCore(cfg, serving, hw, scheduler=scheduler,
                               executor=executor, real_executor=real_executor,
                               runner_cfg=runner_cfg, runner_seed=runner_seed,
                               device=device)

    # ------------------------------------------------------------- delegation
    @property
    def cfg(self) -> ModelConfig:
        return self.core.cfg

    @property
    def serving(self) -> ServingConfig:
        return self.core.serving

    @property
    def hw(self) -> HardwareProfile:
        return self.core.hw

    @property
    def scheduler(self) -> Scheduler:
        return self.core.scheduler

    @property
    def executor(self) -> SimExecutor:
        return self.core.executor

    @property
    def real(self):
        return self.core.real

    @property
    def kv(self):
        return self.core.kv

    @property
    def stats(self) -> EngineStats:
        return self.core.stats

    @property
    def driver_claim(self):
        """Exclusive-driver ownership token (see serving.outputs)."""
        return self.core.driver_claim

    @property
    def clock(self) -> float:
        return self.core.clock

    @property
    def telemetry(self):
        """The flight-recorder bus (None unless ServingConfig.telemetry)."""
        return self.core.telemetry

    def write_trace(self, path: str):
        """Export this engine's flight recorder as a Perfetto JSON file."""
        from repro_torch.serving.trace_export import write_trace
        return write_trace(path, [self.core])

    # ------------------------------------------------------------- online API
    def add_request(self, prompt_len=None, *,
                    prompt_ids: Optional[Sequence[int]] = None,
                    sampling_params: Optional[SamplingParams] = None,
                    slo_class: str = "standard",
                    slo: Optional[SLOConfig] = None,
                    arrival_time: Optional[float] = None) -> RequestHandle:
        """Submit a request from client-facing parameters and return a
        streaming ``RequestHandle`` (see EngineCore.add_request). A pre-built
        ``Request`` as the first argument takes the legacy path. May be
        called between ``step()`` calls; the request is served once the
        engine clock reaches its arrival time."""
        return self.core.add_request(
            prompt_len, prompt_ids=prompt_ids,
            sampling_params=sampling_params, slo_class=slo_class, slo=slo,
            arrival_time=arrival_time)

    def submit(self, req: Request, *, make_handle: bool = False
               ) -> RequestHandle:
        """Legacy/internal path: enqueue a pre-built oracle ``Request``.
        Pass ``make_handle=True`` to also attach streaming delivery."""
        return self.core.submit(req, make_handle=make_handle)

    def abort(self, req_id: int) -> bool:
        """Cancel a request, freeing its KV blocks (any non-finished state)."""
        return self.core.abort(req_id)

    def step(self) -> IterationOutcome:
        """Run one engine iteration (see EngineCore.step)."""
        return self.core.step()

    @property
    def has_work(self) -> bool:
        return self.core.has_work

    def drain(self, max_time_s: float = 1e9) -> SLOReport:
        """Step until every submitted request finished; return the report."""
        self.core.drain(max_time_s)
        return self.report()

    def drain_wallclock(self, timeout_s: float, **kw):
        """Wall-clock-bounded drain for graceful shutdown; returns the
        req_ids still unfinished at the deadline (EngineCore.drain_wallclock)."""
        return self.core.drain_wallclock(timeout_s, **kw)

    def report(self) -> SLOReport:
        return evaluate(self.core.submitted, total_time=self.core.clock,
                        timing=self.core.stats.timing_row())

    # ------------------------------------------------------- batch-replay API
    def run(self, requests: Sequence[Request], *,
            max_time_s: float = 1e9) -> SLOReport:
        """Compatibility driver: submit a whole trace, replay to completion.
        No handles are attached, so no event buffers accumulate."""
        for r in requests:
            self.core.submit(r)
        self.core.drain(max_time_s)
        return evaluate(requests, total_time=self.core.clock,
                        timing=self.core.stats.timing_row())
