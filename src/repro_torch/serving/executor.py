"""Executors: model execution for one engine iteration behind ONE protocol.

``Executor`` is the single interface ``EngineCore.step()`` consumes: it
turns a ``BatchPlan`` into per-request next tokens (``execute``), models the
iteration's device time (``step_time``), and receives request lifecycle
hooks (``swap_out``/``swap_in``/``drop``) so rotation and aborts reach
whatever holds per-request device state. Three implementations:

* ``SimExecutor`` — roofline cost model on a HardwareProfile (the SLO
  benchmarks run on CPU, so wall-time is simulated around the *real*
  scheduler/block-table code). Emits no tokens.
* ``RealExecutor`` (+ ``RealExecutorAdapter``) — drives the decoder-only
  ``LM`` (every family) with dense per-request caches, one Python call per request, on
  ``device`` (CUDA unless the caller passes "cpu"): the path that proves the
  engine lossless under rotation, and the only one that runs
  sliding-window/global patterns.
* ``repro_torch.serving.paged_runner.PagedModelRunner`` — batched execution
  over a pooled block-first KV buffer addressed by the engine's own block
  table (the paper's §4.3 design); decode is one batched paged-attention
  launch per layer per iteration regardless of batch size.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

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


class RealExecutor:
    """Drives the dense decoder ``LM`` with a dense per-request KV view.

    Token streams must be identical with and without rotation: rotation
    copies a request's caches, byte for byte, to CPU tensors in a host store
    and back, the DuplexKV data path in its plainest form. Weights are
    ``params`` (``models.params.from_jax_lm_params``) or drawn from ``seed``
    (``init_lm_params``, the same draw as the paged runner's). ``device``
    defaults to CUDA; with no CUDA device only an explicit ``device="cpu"``
    runs. Wrap in ``RealExecutorAdapter`` to plug into ``EngineCore``.

    Every decoder-only config runs here (attention, SSM, hybrid, MoE); a
    cache is a list of per-layer dicts, and rotation copies every tensor of
    each. ``prefill`` passes only the prompt's tokens, as the reference's
    does, so a config with a frontend or an encoder, which needs its
    embeddings too, is refused at construction.

    ``record_margins = True`` makes the executor keep, per request, the
    top-2 logit margin of every token it emits (``margins``), read in the
    same host sync as the token, as the paged runner's do.
    """

    def __init__(self, cfg: ModelConfig, seed: int = 0, *, device=None,
                 params: Optional[dict] = None):
        import torch
        from repro_torch.device import resolve_device
        from repro_torch.models.lm import LM
        from repro_torch.models.params import init_lm_params
        if cfg.frontend.kind != "none" or cfg.num_encoder_layers:
            need = "src_embeds" if cfg.num_encoder_layers else "embeds"
            raise ValueError(
                f"RealExecutor serves token prompts only; {cfg.name} also "
                f"needs {need!r} (the embeddings its "
                f"{'encoder' if cfg.num_encoder_layers else 'frontend'} "
                f"reads): run LM.prefill/decode_step with them")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lm = LM(cfg)
        if params is None:
            gen = torch.Generator(device=self.device).manual_seed(seed)
            params = init_lm_params(cfg, gen, self.device)
        self.params = params
        self._caches: Dict[int, list] = {}   # req_id -> per-layer caches
        self._host: Dict[int, Optional[list]] = {}   # req_id -> CPU copies
        self._tokens: Dict[int, List[int]] = {}
        self.record_margins = False
        self.margins: Dict[int, List[float]] = {}

    def _emit(self, req_id: int, logits) -> int:
        """The argmax of a (1, V) logits row and its top-2 margin (fp32),
        read in one host sync; the token is appended to the request's."""
        import torch
        row = logits[0]
        top2 = row.float().topk(2).values
        tok, margin = torch.stack([row.argmax().float(),
                                   top2[0] - top2[1]]).tolist()
        if self.record_margins:
            self.margins.setdefault(req_id, []).append(margin)
        self._tokens.setdefault(req_id, []).append(int(tok))
        return int(tok)

    def prefill(self, req_id: int, tokens: Sequence[int], capacity: int) -> int:
        import torch
        toks = torch.tensor([list(tokens)], dtype=torch.long,
                            device=self.device)
        logits, cache = self.lm.prefill(self.params, {"tokens": toks},
                                        capacity)
        self._caches[req_id] = cache
        self._tokens[req_id] = []
        return self._emit(req_id, logits)

    def decode(self, req_id: int, token: int, cache_len: int) -> int:
        import torch
        if req_id not in self._caches:
            raise RuntimeError(
                f"decode on request {req_id} with no device cache — it was "
                "swapped out (or dropped) and never swapped back in")
        logits, cache = self.lm.decode_step(
            self.params, self._caches[req_id],
            {"token": torch.tensor([token], dtype=torch.long,
                                   device=self.device),
             "cache_len": int(cache_len)})
        self._caches[req_id] = cache
        return self._emit(req_id, logits)

    # rotation = copy the caches off the device and back — the real data path
    def swap_out(self, req_id: int) -> None:
        cache = self._caches.pop(req_id, None)
        if cache is None:
            # Mid-prefill requests have no cache yet; that is only a legal
            # state BEFORE the first token. A cache-less request that has
            # already generated tokens lost its KV — fail loudly instead of
            # silently resuming with garbage.
            if self._tokens.get(req_id):
                raise RuntimeError(
                    f"swap_out on request {req_id}: no device cache but "
                    f"{len(self._tokens[req_id])} generated tokens — its KV "
                    "state was lost")
            self._host[req_id] = None   # sentinel: rotated out mid-prefill
            return
        self._host[req_id] = [{k: t.to("cpu", copy=True) for k, t in c.items()}
                              for c in cache]

    def swap_in(self, req_id: int) -> None:
        host = self._host.pop(req_id, None)
        if host is None:
            # Mid-prefill resume: no KV existed at swap-out, so there is
            # nothing to restore — prefill has not completed, and the engine
            # re-runs it before any decode. A token-bearing request in this
            # state would decode against a missing cache.
            if self._tokens.get(req_id):
                raise RuntimeError(
                    f"swap_in on request {req_id}: resumed without a KV "
                    "cache after generating tokens")
            return
        self._caches[req_id] = [
            {k: t.to(self.device, copy=True) for k, t in c.items()}
            for c in host]

    def drop(self, req_id: int) -> None:
        self._caches.pop(req_id, None)
        self._host.pop(req_id, None)
        self._tokens.pop(req_id, None)


class RealExecutorAdapter(Executor):
    """Adapts a per-request real executor (``prefill``/``decode``/``swap_*``
    /``drop``) to the batched ``Executor`` protocol. Iteration timing comes
    from a wrapped ``SimExecutor`` (device wall-time stays simulated; only
    tokens are real). Dense per-request caches cannot share prefix blocks,
    so ``supports_prefix_cache`` is False — the engine forces the cache off.
    """

    supports_prefix_cache = False

    def __init__(self, real, sim: SimExecutor):
        self.real = real
        self.sim = sim

    def step_time(self, plan: BatchPlan) -> float:
        return self.sim.step_time(plan)

    def plan_time(self, plan: BatchPlan) -> float:
        return self.sim.plan_time(plan)

    def execute(self, plan: BatchPlan, requests) -> ExecutionResult:
        from repro_torch.core.types import RequestState
        out = ExecutionResult()
        for rid, take in plan.prefill_chunks:
            r = requests.get(rid)
            if r is None or r.prompt_ids is None:
                continue
            # legacy semantics: dense prefill of the WHOLE prompt runs once,
            # at the iteration whose chunk completes it
            if r.prefill_pos + take >= r.prompt_len and r.tokens_generated == 0:
                out.tokens[rid] = self.real.prefill(
                    rid, r.prompt_ids,
                    capacity=r.prompt_len + r.output_len + 1)
        for rid in plan.decode_reqs:
            r = requests.get(rid)
            if r is None or r.state != RequestState.RUNNING:
                continue
            if r.generated_ids:
                out.tokens[rid] = self.real.decode(
                    rid, r.generated_ids[-1], r.total_len - 1)
        return out

    def swap_out(self, req_id: int) -> None:
        self.real.swap_out(req_id)

    def swap_in(self, req_id: int) -> None:
        self.real.swap_in(req_id)

    def drop(self, req_id: int) -> None:
        self.real.drop(req_id)
