"""Client-facing output plumbing: RequestHandle + OutputCollector.

``EngineCore.add_request(...)`` returns a ``RequestHandle``; every
``EngineCore.step()`` pushes that iteration's ``RequestOutput`` events
through the engine's ``OutputCollector`` to the owning handles. A handle is
a *pull* surface: ``stream()`` pumps the engine (or the router, for
cluster-level handles) whenever its buffer runs dry, so a single-threaded
caller can interleave token consumption with engine progress:

    h = engine.add_request(prompt_len=512,
                           sampling_params=SamplingParams(max_tokens=64),
                           slo_class="interactive")
    for out in h.stream():
        ...                    # out.new_tokens arrived this iteration
    print(h.metrics())

Handles attached to a Router pump the whole cluster (lagging-replica order),
so two handles on different replicas can be consumed concurrently from one
thread. ``abort()`` cancels mid-stream; the final event then carries
``finish_reason == "aborted"``.

Single-pump ownership
---------------------
Handle pumps and the legacy batch drivers (``drain()`` / ``run(trace)``)
assume they are the ONLY thing advancing the engine. Once a concurrent
driver exists (serving.async_engine owns the step loop on its own thread),
a synchronous pump racing it would interleave two drivers through the same
mutable engine — silently, and with corrupted block accounting. Every
engine-like object therefore carries a ``DriverClaim``: an exclusive driver
claims it before stepping, and every synchronous pump surface
(``RequestHandle.stream()/result()`` via ``_pump``, ``drain()``, ``run()``)
raises a clear ``RuntimeError`` naming the owner instead of interleaving.
"""
from __future__ import annotations

import collections
from typing import Callable, Deque, Dict, Iterator, List, Optional

from repro_torch.core.types import Request, RequestOutput, RequestState

# Pump: advance the engine/cluster by one iteration; False = no work left.
Pump = Callable[[], bool]
AbortFn = Callable[[int], bool]


class DriverClaim:
    """Exclusive-driver token for an engine-like object (EngineCore, Router,
    DisaggCluster). At most one driver may hold the claim; while held, the
    synchronous pump surfaces must refuse to advance the engine (see
    module docstring). ``require`` is the guard those surfaces call."""

    def __init__(self):
        self.owner: Optional[str] = None

    def claim(self, owner: str) -> None:
        if self.owner is not None:
            raise RuntimeError(
                f"engine is already driven exclusively by {self.owner!r}; "
                f"a second driver ({owner!r}) would interleave two step "
                f"loops through the same engine")
        self.owner = owner

    def release(self, owner: str) -> None:
        if self.owner != owner:
            raise RuntimeError(
                f"driver claim held by {self.owner!r}, not {owner!r}")
        self.owner = None

    def require(self, what: str, owner: Optional[str] = None) -> None:
        """Raise unless unclaimed or called on behalf of the claim holder.
        ``what`` names the refused operation in the error message."""
        if self.owner is not None and self.owner != owner:
            raise RuntimeError(
                f"{what} would interleave with the exclusive driver "
                f"{self.owner!r} that owns this engine's step loop; consume "
                f"tokens through that driver's handles instead (e.g. the "
                f"async engine's AsyncRequestHandle)")


class RequestHandle:
    """Live view of one submitted request (see DESIGN.md §API layer)."""

    def __init__(self, request: Request, pump: Pump, abort_fn: AbortFn):
        self.request = request
        self._pump = pump
        self._abort = abort_fn
        self._buf: Deque[RequestOutput] = collections.deque()
        self._final: Optional[RequestOutput] = None

    # -- identity ------------------------------------------------------------
    @property
    def req_id(self) -> int:
        return self.request.req_id

    @property
    def slo_class(self) -> str:
        return self.request.slo_class

    @property
    def finished(self) -> bool:
        # detached handles (legacy submit without streaming) never receive
        # the final event; fall back to the request's own state
        return (self._final is not None
                or self.request.state == RequestState.FINISHED)

    # -- event delivery (called by OutputCollector) --------------------------
    def _push(self, out: RequestOutput) -> None:
        self._buf.append(out)
        if out.finished:
            self._final = out

    def bind_pump(self, pump: Pump) -> None:
        """Re-bind who advances the world (Router-owned handles pump the
        cluster, not a single replica)."""
        self._pump = pump

    def bind_abort(self, abort_fn: AbortFn) -> None:
        """Re-bind the abort target (Router-owned handles must go through
        ``Router.abort`` so the cluster's owner map stays consistent)."""
        self._abort = abort_fn

    # -- consumption ---------------------------------------------------------
    def events(self) -> List[RequestOutput]:
        """Drain buffered events without advancing the engine (poll mode,
        for consuming several handles from one driver loop)."""
        out = list(self._buf)
        self._buf.clear()
        return out

    def stream(self) -> Iterator[RequestOutput]:
        """Yield output events until the request finishes, stepping the
        engine whenever no event is buffered. Raises RuntimeError if an
        exclusive driver (serving.async_engine) owns the engine's step loop
        — pumping here would interleave two drivers (DriverClaim)."""
        while True:
            while self._buf:
                yield self._buf.popleft()
            if self.finished:
                return
            if not self._pump():
                # engine drained without finishing us — only possible if the
                # request was never going to run (e.g. aborted elsewhere)
                return

    def result(self) -> RequestOutput:
        """Block (step the engine) until finished; return the final event.
        Buffered intermediate events stay readable via ``events()``."""
        while not self.finished:
            if not self._pump():
                raise RuntimeError(
                    f"engine ran out of work before request {self.req_id} "
                    f"finished (state={self.request.state.value})")
        if self._final is None:     # detached handle: synthesize the summary
            self._final = self.request.make_output(
                self.request.finish_time or 0.0)
        return self._final

    def abort(self) -> bool:
        """Cancel this request; frees its HBM/DRAM blocks immediately.
        Returns False if it already finished."""
        return self._abort(self.req_id)

    # -- metrics -------------------------------------------------------------
    def metrics(self) -> Dict[str, object]:
        r = self.request
        tbts = r.tbt_values()
        return dict(
            req_id=r.req_id,
            state=r.state.value,
            slo_class=r.slo_class,
            finish_reason=r.finish_reason,
            tokens_generated=r.tokens_generated,
            cached_tokens=r.num_cached_tokens,
            rotations=r.rotations,
            ttft_s=r.ttft(),
            mean_tbt_s=sum(tbts) / len(tbts) if tbts else None,
            max_tbt_s=max(tbts) if tbts else None,
            ttft_ok=r.ttft_ok(),
            tbt_ok=r.tbt_ok(),
        )

    def __repr__(self) -> str:
        return (f"RequestHandle(req_id={self.req_id}, "
                f"state={self.request.state.value}, "
                f"tokens={self.request.tokens_generated}, "
                f"slo_class={self.slo_class!r})")


class OutputCollector:
    """Routes per-iteration RequestOutput events to registered handles.

    Requests submitted without a handle (legacy ``run(trace)`` replay) have
    no entry here, so replay accumulates no event buffers.
    """

    def __init__(self):
        self._handles: Dict[int, RequestHandle] = {}

    def attach(self, handle: RequestHandle) -> None:
        self._handles[handle.req_id] = handle

    def get(self, req_id: int) -> Optional[RequestHandle]:
        return self._handles.get(req_id)

    def detach(self, req_id: int) -> Optional[RequestHandle]:
        """Remove and return a handle so it can follow its request to
        another replica's collector (the disaggregation handoff)."""
        return self._handles.pop(req_id, None)

    def dispatch(self, outputs: List[RequestOutput]) -> None:
        for out in outputs:
            h = self._handles.get(out.req_id)
            if h is None:
                continue
            h._push(out)
            if out.finished:
                del self._handles[out.req_id]
