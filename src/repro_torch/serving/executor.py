"""Executors: model execution for one engine iteration behind ONE protocol.

``Executor`` is the single interface ``EngineCore.step()`` consumes: it
turns a ``BatchPlan`` into per-request next tokens (``execute``), models the
iteration's device time (``step_time``), and receives request lifecycle
hooks (``swap_out``/``swap_in``/``drop``) so rotation and aborts reach
whatever holds per-request device state. Two implementations:

* ``SimExecutor`` — roofline cost model on a HardwareProfile (the SLO
  benchmarks run on CPU, so wall-time is simulated around the *real*
  scheduler/block-table code). Emits no tokens.
* ``repro_torch.serving.paged_runner.PagedModelRunner`` — batched execution
  over a pooled block-first KV buffer addressed by the engine's own block
  table (the paper's §4.3 design); decode is one batched paged-attention
  launch per layer per iteration regardless of batch size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

from repro_torch.configs.base import HardwareProfile, ModelConfig


@dataclasses.dataclass
class BatchPlan:
    """One engine iteration's device work."""
    decode_reqs: List[int] = dataclasses.field(default_factory=list)
    decode_kv_tokens: int = 0            # total KV tokens read by decodes
    prefill_chunks: List[Tuple[int, int]] = dataclasses.field(
        default_factory=list)            # (req_id, chunk tokens) this iter
    prefill_tokens: int = 0              # chunked-prefill tokens this iter
    prefill_attn_tokens: int = 0         # sum over prefill chunks of ctx len

    @property
    def empty(self) -> bool:
        return not self.decode_reqs and self.prefill_tokens == 0


@dataclasses.dataclass
class ExecutionResult:
    """What an ``Executor.execute`` call produced: at most one sampled token
    per request this iteration (a decode step, or the first token at the
    tail of a completed prefill). Sim mode emits none — the engine's oracle
    token accounting proceeds on counts alone."""
    tokens: Dict[int, int] = dataclasses.field(default_factory=dict)


class PendingExecution:
    """Handle to an in-flight iteration's device work (the cross-iteration
    pipeline's execute stage). ``execute_async`` dispatches the launches and
    returns immediately; ``wait()`` materializes the sampled tokens — the
    single host sync point of the iteration. ``waiter`` runs at most once;
    repeated ``wait()`` calls return the cached result."""

    def __init__(self, waiter):
        self._waiter = waiter
        self._result: Optional[ExecutionResult] = None

    @property
    def done(self) -> bool:
        return self._waiter is None

    def wait(self) -> ExecutionResult:
        if self._waiter is not None:
            waiter, self._waiter = self._waiter, None
            self._result = waiter()
        return self._result if self._result is not None else ExecutionResult()


class Executor:
    """The engine-facing execution protocol (see module docstring).

    ``supports_prefix_cache``: whether KV produced by one request is
    physically shareable with another (block-level sharing). Dense
    per-request caches are not; the engine forces the prefix cache off.
    """

    supports_prefix_cache = True

    def step_time(self, plan: BatchPlan) -> float:
        raise NotImplementedError

    def plan_time(self, plan: BatchPlan) -> float:
        """Host-side planning/batch-assembly seconds INCLUDED in
        ``step_time`` that a two-stage pipeline hides: iteration N+1's
        scheduling runs while iteration N's kernels execute, so in
        pipelined mode this portion leaves the critical path (after the
        pipeline fills). Default 0 — executors that model no host
        overhead have nothing to hide."""
        return 0.0

    def execute(self, plan: BatchPlan, requests: Mapping[int, object]
                ) -> ExecutionResult:
        """Run the plan's prefill chunks and decodes. ``requests`` maps
        req_id -> live Request in its PRE-commit state (``prefill_pos`` /
        ``generated_ids`` not yet advanced for this iteration)."""
        return ExecutionResult()

    def execute_async(self, plan: BatchPlan, requests: Mapping[int, object]
                      ) -> PendingExecution:
        """Dispatch the plan's device work without blocking on results.
        Implementations that can (PagedModelRunner) enqueue every launch on
        the device stream and defer the host sync to ``wait()``; the
        default wraps the synchronous ``execute`` so every executor
        satisfies the pipelined engine's protocol. ``wait()`` must be
        called strictly after the iteration's transfers were issued (the
        ``plan_iteration`` ordering contract still holds)."""
        return PendingExecution(lambda: self.execute(plan, requests))

    # -- lifecycle hooks (no-ops unless the executor holds per-request state)
    def swap_out(self, req_id: int) -> None:
        pass

    def swap_in(self, req_id: int) -> None:
        pass

    def drop(self, req_id: int) -> None:
        pass


class SimExecutor(Executor):
    def __init__(self, cfg: ModelConfig, hw: HardwareProfile,
                 fixed_overhead_s: float = 0.004, tp: int = 1,
                 kv_dtype: str = "bf16"):
        self.cfg = cfg
        self.hw = hw
        self.fixed = fixed_overhead_s
        # tensor parallelism: tp chips each hold 1/tp of the weights and KV
        # and contribute their full FLOP/bandwidth budgets — the roofline
        # scales both denominators by tp (the psum latency hides inside
        # fixed_overhead_s). tp == 1 is arithmetically unchanged.
        self.tp = max(int(tp), 1)
        self.n_active = cfg.active_param_count()
        self.weight_bytes = cfg.param_count() * 2
        # decode's HBM read per context token: int8 KV tier halves it (the
        # per-block fp32 scale rows are noise next to P·D int8 values and
        # are not amortizable here — step_time sees tokens, not blocks)
        self.kv_per_token = cfg.kv_bytes_per_token(
            dtype_bytes=1 if kv_dtype == "int8" else None)

    def step_time(self, plan: BatchPlan) -> float:
        if plan.empty:
            return self.fixed / 2
        n_tok = len(plan.decode_reqs) + plan.prefill_tokens
        flops = 2 * self.n_active * n_tok
        # attention flops: decode reads KV; prefill quadratic on chunk ctx
        hqd = max(self.cfg.num_heads * self.cfg.head_dim, 1)
        flops += 4 * plan.decode_kv_tokens * hqd * self.cfg.num_attn_layers \
            / max(self.cfg.num_layers, 1) * self.cfg.num_layers
        flops += 2 * plan.prefill_attn_tokens * hqd * self.cfg.num_attn_layers
        t_compute = flops / (self.hw.flops_bf16 * self.hw.mfu * self.tp)
        # memory: weights once per iteration + decode KV reads
        t_mem = (self.weight_bytes + plan.decode_kv_tokens
                 * self.kv_per_token) / (self.hw.hbm_bw * self.tp)
        return max(t_compute, t_mem) + self.fixed

    def plan_time(self, plan: BatchPlan) -> float:
        # Half the fixed per-iteration overhead is host work (scheduling,
        # admission, batch assembly, transfer planning) that the two-stage
        # pipeline runs during the PREVIOUS iteration's execute window; the
        # other half (kernel launch, completion handling) stays on the
        # critical path. Mirrors step_time's empty-plan halving.
        return self.fixed / 2 if not plan.empty else self.fixed / 4
