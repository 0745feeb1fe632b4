"""Request model + states shared by the scheduler, engine and block manager,
plus the client-facing request/response types (SamplingParams, SLO classes,
RequestOutput) the streaming API is built from (see DESIGN.md §API layer)."""
from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import SLOConfig


class RequestState(enum.Enum):
    WAITING = "waiting"    # arrived, no KV on HBM yet (or prefill not started)
    RUNNING = "running"    # scheduled on GPU, KV resident in HBM
    ROTARY = "rotary"      # paused, KV swapped to DRAM (paper's rotary state)
    SWAPPING_IN = "swapping_in"    # H2D in flight
    SWAPPING_OUT = "swapping_out"  # D2H in flight
    FINISHED = "finished"


# Finish reasons carried on Request.finish_reason / RequestOutput.finish_reason:
#   "length"  — generated max_tokens (oracle output_len) tokens
#   "stop"    — real-executor mode hit an EOS / stop token (ignore_eos=False)
#   "aborted" — client cancelled via handle.abort() / EngineCore.abort()
FINISH_LENGTH = "length"
FINISH_STOP = "stop"
FINISH_ABORTED = "aborted"


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request generation controls (the client-facing knobs).

    In oracle/simulation mode ``max_tokens`` doubles as the oracle decode
    length and ``ignore_eos`` stays True (the sim emits no token ids). In
    real-executor mode set ``ignore_eos=False`` plus ``eos_token_id`` /
    ``stop_token_ids`` to finish with reason "stop" on an EOS hit.
    """
    max_tokens: int = 128
    ignore_eos: bool = True            # oracle mode: run to max_tokens
    eos_token_id: Optional[int] = None
    stop_token_ids: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.max_tokens < 1:
            raise ValueError("max_tokens must be >= 1")

    def stops_on(self, token_id: int) -> bool:
        if self.ignore_eos:
            return False
        return token_id == self.eos_token_id or token_id in self.stop_token_ids


# ---------------------------------------------------------------------------
# SLO classes: named tiers a client picks at submission time. "standard" must
# stay equal to SLOConfig() so legacy traces are bit-identical.
# ---------------------------------------------------------------------------

SLO_CLASSES: Dict[str, SLOConfig] = {
    "interactive": SLOConfig(ttft_s=1.0, tbt_s=0.05),   # chat-like latency
    "standard": SLOConfig(),                             # paper defaults
    "batch": SLOConfig(ttft_s=30.0, tbt_s=0.5),          # offline/bulk tier
}


def resolve_slo_class(name: str) -> SLOConfig:
    try:
        return SLO_CLASSES[name]
    except KeyError:
        raise KeyError(f"unknown SLO class {name!r}; "
                       f"known: {sorted(SLO_CLASSES)}") from None


_BUILTIN_SLO_CLASSES = frozenset(SLO_CLASSES)


def register_slo_class(name: str, slo: SLOConfig) -> None:
    """Add a named tier at runtime. The built-in tiers are immutable —
    'standard' in particular must stay equal to SLOConfig() or legacy trace
    replay stops being bit-identical."""
    if name in _BUILTIN_SLO_CLASSES:
        raise ValueError(f"cannot redefine built-in SLO class {name!r}")
    SLO_CLASSES[name] = slo


@dataclasses.dataclass
class RequestOutput:
    """One streaming event for one request: the token delta produced by a
    single engine iteration plus live progress/latency so far.

    ``token_ids`` (the cumulative generated ids, real-executor mode) is
    materialized only on the *final* event — copying it per token would make
    streaming O(T^2); mid-stream the live list is ``request.generated_ids``.
    """
    req_id: int
    new_tokens: int                    # tokens produced this iteration
    new_token_ids: List[int]           # their ids (real-executor mode only)
    token_ids: List[int]               # cumulative ids (final event only)
    tokens_generated: int              # cumulative count
    finished: bool
    finish_reason: Optional[str]       # "length" | "stop" | "aborted" | None
    t: float                           # engine clock at emission
    slo_class: str = "standard"
    ttft_s: Optional[float] = None     # live TTFT (None before first token)
    last_tbt_s: Optional[float] = None
    mean_tbt_s: Optional[float] = None
    cached_tokens: int = 0             # prompt tokens served by the prefix cache


@dataclasses.dataclass
class Request:
    req_id: int
    arrival_time: float
    prompt_len: int
    output_len: int                  # target generation length (oracle for sim)
    slo: SLOConfig = dataclasses.field(default_factory=SLOConfig)
    slo_class: str = "standard"      # named tier the client submitted under
    sampling: Optional[SamplingParams] = None

    state: RequestState = RequestState.WAITING
    stopped: bool = False            # EOS/stop-token hit (real-executor mode)
    finish_reason: Optional[str] = None   # "length" | "stop" | "aborted"
    prompt_ids: Optional[List[int]] = None    # real-execution mode
    generated_ids: List[int] = dataclasses.field(default_factory=list)
    tokens_generated: int = 0
    prefill_pos: int = 0             # chunked-prefill progress (tokens done)
    num_cached_tokens: int = 0       # prompt tokens served by the prefix cache
    t_first_token: Optional[float] = None
    t_last_token: Optional[float] = None   # time of last generated token
    t_run_start: Optional[float] = None    # time entering RUNNING
    token_times: List[float] = dataclasses.field(default_factory=list)
    finish_time: Optional[float] = None
    # number of rotations (preemptions) this request experienced
    rotations: int = 0
    # number of cross-replica migrations (disaggregated prefill/decode)
    migrations: int = 0
    # -- TTFT attribution bookkeeping (always on; pure-float side records) --
    # engine clock when the request FIRST entered RUNNING (queue wait ends)
    t_first_run: Optional[float] = None
    # seconds spent rotated out (ROTARY) before the first token was emitted
    pre_token_rotary_s: float = 0.0
    # non-None while the request sits in ROTARY pre-first-token
    _t_rotary_since: Optional[float] = None
    # -- wall stamps (``time.monotonic_ns``; observability only, never read
    # by scheduling): submission, the plan of the first prefill chunk, and
    # the last rotate_out until its swap-in completes
    wall_submit_ns: Optional[int] = None
    wall_first_chunk_ns: Optional[int] = None
    wall_rotated_ns: Optional[int] = None

    @property
    def prefill_done(self) -> bool:
        return self.prefill_pos >= self.prompt_len

    @property
    def total_len(self) -> int:
        return self.prompt_len + self.tokens_generated

    @property
    def done(self) -> bool:
        return self.stopped or self.tokens_generated >= self.output_len

    def blocks_needed(self, block_size: int, lookahead: int = 0) -> int:
        """Blocks to hold current KV (+ lookahead new tokens)."""
        toks = min(self.total_len + lookahead, self.prompt_len + self.output_len)
        return -(-max(toks, 1) // block_size)

    # -- lifecycle transitions (owned by the admission layer) ----------------
    def start_running(self, t: float) -> None:
        """WAITING -> RUNNING: first prefill chunk scheduled on device."""
        self.state = RequestState.RUNNING
        self.t_run_start = t
        if self.t_first_run is None:
            self.t_first_run = t

    def rotate_out(self, t: Optional[float] = None) -> None:
        """RUNNING -> ROTARY: KV leaves HBM (active rotation or OOM preempt)."""
        self.state = RequestState.ROTARY
        self.rotations += 1
        if t is not None and self.t_first_token is None:
            self._t_rotary_since = t

    def resume(self, t: float) -> None:
        """ROTARY -> RUNNING: swap-in transfer completed."""
        self.state = RequestState.RUNNING
        self.t_run_start = t
        if self._t_rotary_since is not None:
            self.pre_token_rotary_s += t - self._t_rotary_since
            self._t_rotary_since = None

    def begin_migration(self) -> None:
        """RUNNING/ROTARY -> ROTARY for a cross-replica handoff: KV is
        exported to the DRAM tier and re-imported on the target replica,
        where ``resume`` fires once the target's swap-in lands. Not counted
        as a rotation — migrations are tracked separately."""
        self.state = RequestState.ROTARY
        self.migrations += 1

    def finish_at(self, t: float, reason: Optional[str] = None) -> None:
        self.state = RequestState.FINISHED
        self.finish_time = t
        if self.finish_reason is None:
            self.finish_reason = reason or (
                FINISH_STOP if self.stopped else FINISH_LENGTH)

    @property
    def aborted(self) -> bool:
        return self.finish_reason == FINISH_ABORTED

    def record_token(self, t: float) -> None:
        self.tokens_generated += 1
        self.token_times.append(t)
        self.t_last_token = t
        if self.t_first_token is None:
            self.t_first_token = t

    # -- streaming events ----------------------------------------------------
    def make_output(self, t: float, new_tokens: int = 0,
                    new_token_ids: Optional[List[int]] = None
                    ) -> RequestOutput:
        # O(1) per event: the inter-token gaps telescope, so the mean needs
        # no tbt_values() rebuild (which is O(tokens) and would make a
        # T-token stream O(T^2))
        ts = self.token_times
        n = len(ts)
        finished = self.state == RequestState.FINISHED
        return RequestOutput(
            req_id=self.req_id,
            new_tokens=new_tokens,
            new_token_ids=list(new_token_ids or []),
            token_ids=list(self.generated_ids) if finished else [],
            tokens_generated=self.tokens_generated,
            finished=finished,
            finish_reason=self.finish_reason,
            t=t,
            slo_class=self.slo_class,
            ttft_s=self.ttft(),
            last_tbt_s=ts[-1] - ts[-2] if n > 1 else None,
            mean_tbt_s=(ts[-1] - ts[0]) / (n - 1) if n > 1 else None,
            cached_tokens=self.num_cached_tokens)

    # -- metrics -------------------------------------------------------------
    def ttft(self) -> Optional[float]:
        if self.t_first_token is None:
            return None
        return self.t_first_token - self.arrival_time

    def ttft_breakdown(self) -> Optional[dict]:
        """Decompose TTFT into queue-wait, rotation-stall and
        prefill-compute components (sim-clock seconds). The three parts sum
        to ``ttft()`` exactly by construction: queue wait ends at the first
        RUNNING transition, rotation stall is the accumulated pre-first-
        token ROTARY time, and prefill compute is the remainder (chunked
        prefill execution plus any in-batch queueing between chunks).
        ``None`` until the first token exists."""
        t = self.ttft()
        if t is None or self.t_first_run is None:
            return None
        queue = self.t_first_run - self.arrival_time
        rot = self.pre_token_rotary_s
        return {"ttft_s": t,
                "queue_wait_s": queue,
                "rotation_stall_s": rot,
                "prefill_compute_s": t - queue - rot}

    def tbt_values(self) -> List[float]:
        ts = self.token_times
        return [b - a for a, b in zip(ts, ts[1:])]

    def ttft_ok(self) -> Optional[bool]:
        t = self.ttft()
        return None if t is None else t <= self.slo.ttft_s

    def tbt_ok(self) -> Optional[bool]:
        """Per-request TBT attainment: mean TBT within SLO (occasional
        rotation gaps amortize across the stream, matching the paper's
        'comparable TBT under rotation' accounting)."""
        vals = self.tbt_values()
        if not vals:
            return True
        return sum(vals) / len(vals) <= self.slo.tbt_s

    def tbt_ok_strict(self) -> Optional[bool]:
        vals = self.tbt_values()
        if not vals:
            return True
        return max(vals) <= self.slo.tbt_s
