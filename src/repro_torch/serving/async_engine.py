"""AsyncServingEngine: the asyncio front door over the blocking step loop.

Everything below ``EngineCore.step()`` is synchronous, host-bound (the
CUDA kernel launches of ``--paged-runner`` and the dense executor are
dispatched from the host) and single-threaded by design —
the block table, DuplexKV and scheduler share mutable state with no locks.
The async engine therefore does NOT make the engine concurrent; it gives it
exactly one **driver thread** that owns every engine touch, and bridges
that thread to an asyncio event loop (see DESIGN.md §Service layer):

    event loop (HTTP handlers, clients)          driver thread (owns engine)
    ---------------------------------            --------------------------
    await submit(...)  --- control queue + Condition --->  engine.add_request
    async for out in handle.stream()  <-- call_soon_threadsafe --  step() +
                                                           handle.events()
    await abort(req_id) / await call(fn) ------------->  engine.abort / fn
    await shutdown(t)  ----------------->  engine.drain_wallclock(t) + exit

* **Wall-clock arrivals** — the engine clock is *simulated* seconds. At
  ``start()`` the driver anchors ``clock0 = engine.clock`` against
  ``t0 = time.monotonic()``; a request submitted ``w`` wall seconds later
  arrives at engine time ``max(engine.clock, clock0 + w)``. With pacing on
  (the default) the driver sleeps whenever the simulated clock runs ahead
  of the wall mapping, so engine time tracks wall time and SLO metrics read
  in real seconds. When an iteration takes *longer* in wall time than it
  models (host dispatch on the card, or CPU execution), the clock falls
  behind and arrivals queue — an overloaded engine, reported as such. ``pace=False`` steps
  flat-out (replay/parity/bench mode; callers pass explicit arrival times).
* **Streaming** — every ``step()`` the driver drains each live sync
  handle's buffered events (``RequestHandle.events()``, the poll surface —
  never the pump) and posts them to the owning ``AsyncRequestHandle``'s
  ``asyncio.Queue`` via ``loop.call_soon_threadsafe``; consumers just
  ``async for``. The driver holds the engine's ``DriverClaim``, so a
  synchronous ``stream()``/``drain()``/``run(trace)`` racing it raises
  instead of silently interleaving (serving.outputs).
* **Idle is cheap** — no work and no control messages parks the driver in
  ``Condition.wait()``; submissions/aborts/shutdown notify it.
* **Shutdown** — ``shutdown(drain_timeout_s)`` stops admission
  (``ServiceDraining`` on new submits), drains bounded by *wall* seconds
  (``drain_wallclock``), aborts whatever remains so
  every open stream terminates (``finish_reason == "aborted"`` and blocks
  are freed), and returns the unfinished ids (non-empty => dirty drain).

Works over any engine-like object: ``EngineCore`` / ``ServingEngine`` (its
core is unwrapped), ``Router``, ``DisaggCluster``.

The driver thread launches every CUDA kernel. PyTorch's current device is
per thread, so the executors name their ``device`` on every tensor they
make and never rely on ``torch.cuda.current_device()`` there.
"""
from __future__ import annotations

import asyncio
import collections
import sys
import threading
import time
import traceback
from typing import Any, AsyncIterator, Callable, Dict, List, Optional, Tuple

from repro_torch.core.types import RequestOutput, SamplingParams
from repro_torch.serving.outputs import RequestHandle

DRIVER_NAME = "AsyncServingEngine"


class ServiceDraining(RuntimeError):
    """submit() after shutdown began: the service no longer admits work."""


class ServiceStopped(RuntimeError):
    """The driver thread has exited (shutdown finished or crashed)."""


class AsyncRequestHandle:
    """Async view of one in-flight request: ``async for`` token streaming
    plus result/abort. Single-consumer: exactly one task may iterate
    ``stream()`` (the HTTP handler that owns the connection)."""

    def __init__(self, handle: RequestHandle, service: "AsyncServingEngine",
                 queue: "asyncio.Queue"):
        self._handle = handle
        self._service = service
        self._queue = queue
        self._final: Optional[RequestOutput] = None

    # -- identity ------------------------------------------------------------
    @property
    def req_id(self) -> int:
        return self._handle.req_id

    @property
    def slo_class(self) -> str:
        return self._handle.slo_class

    @property
    def finished(self) -> bool:
        return self._final is not None or self._handle.finished

    # -- delivery (event-loop thread, via call_soon_threadsafe) --------------
    def _feed(self, evts: List[RequestOutput]) -> None:
        for e in evts:
            self._queue.put_nowait(e)

    def _feed_crash(self, exc: BaseException) -> None:
        self._queue.put_nowait(exc)

    # -- consumption ---------------------------------------------------------
    async def stream(self) -> AsyncIterator[RequestOutput]:
        """Yield ``RequestOutput`` events until the final one (inclusive).
        The final event carries ``finished=True`` and the finish reason."""
        if self._final is not None:
            return
        while True:
            evt = await self._queue.get()
            if isinstance(evt, BaseException):
                raise ServiceStopped("engine driver crashed "
                                     "mid-stream") from evt
            yield evt
            if evt.finished:
                self._final = evt
                return

    async def result(self) -> RequestOutput:
        """Consume the stream to completion; return the final event."""
        if self._final is None:
            async for _ in self.stream():
                pass
        return self._final

    async def abort(self) -> bool:
        """Cancel this request on the driver thread; its stream then ends
        with ``finish_reason == "aborted"`` and its blocks are freed."""
        return await self._service.abort(self.req_id)

    def metrics(self) -> Dict[str, object]:
        """Point-in-time metrics snapshot. Reads request fields the driver
        thread may be mutating — individual values are consistent, the set
        is advisory; take authoritative numbers after ``result()``."""
        return self._handle.metrics()

    def __repr__(self) -> str:
        return (f"AsyncRequestHandle(req_id={self.req_id}, "
                f"finished={self.finished})")


class AsyncServingEngine:
    """Owns the engine step loop on a driver thread; async API on top."""

    _PACE_SLACK = 2e-3       # tolerated sim-ahead-of-wall before sleeping
    _MAX_NAP = 0.25          # pacing sleep cap (stay responsive to control)

    def __init__(self, engine, *, pace: bool = True,
                 name: str = DRIVER_NAME):
        self.engine = getattr(engine, "core", engine)   # unwrap ServingEngine
        for attr in ("add_request", "step", "abort", "has_work",
                     "driver_claim"):
            if not hasattr(self.engine, attr):
                raise TypeError(f"engine-like object lacks .{attr}; expected "
                                f"EngineCore/ServingEngine/Router/"
                                f"DisaggCluster")
        self.pace = pace
        self.name = name
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._thread: Optional[threading.Thread] = None
        self._cv = threading.Condition()
        self._control: "collections.deque[Callable[[], None]]" = \
            collections.deque()
        self._live: Dict[int, Tuple[RequestHandle, AsyncRequestHandle]] = {}
        self._started = False
        self._stopped = False
        self._draining = False
        self._stop_requested = False
        self._drain_timeout = 0.0
        self._shutdown_fut: Optional[asyncio.Future] = None
        self._crashed: Optional[BaseException] = None
        self._t0 = 0.0           # wall anchor (time.monotonic at start)
        self._clock0 = 0.0       # engine-clock anchor at start
        self.steps = 0           # iterations driven (service counter)

    # --------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        """Claim the engine and start the driver thread. Must be awaited
        from the event loop that will consume the streams."""
        if self._started:
            raise RuntimeError("service already started")
        self._loop = asyncio.get_running_loop()
        self.engine.driver_claim.claim(self.name)
        self._t0 = time.monotonic()
        self._clock0 = self.engine.clock
        self._started = True
        self._thread = threading.Thread(target=self._drive,
                                        name=self.name, daemon=True)
        self._thread.start()

    async def shutdown(self, drain_timeout_s: float = 30.0) -> List[int]:
        """Graceful stop: no new admissions, wall-clock-bounded drain with
        live streaming, leftovers aborted. Returns the req_ids that did NOT
        finish within the deadline (empty == clean). Idempotent: concurrent
        callers share one drain."""
        if not self._started:
            self._stopped = True
            return []
        if self._stopped:                # driver already gone
            if self._crashed is not None:
                raise ServiceStopped("engine driver crashed") \
                    from self._crashed
            return []
        if self._shutdown_fut is None:
            self._shutdown_fut = self._loop.create_future()
            with self._cv:
                self._draining = True
                self._drain_timeout = float(drain_timeout_s)
                self._stop_requested = True
                self._cv.notify_all()
        return await asyncio.shield(self._shutdown_fut)

    @property
    def started(self) -> bool:
        return self._started and not self._stopped

    @property
    def draining(self) -> bool:
        return self._draining

    @property
    def crashed(self) -> Optional[BaseException]:
        return self._crashed

    def engine_now(self) -> float:
        """Current wall time mapped onto the engine clock axis."""
        return self._clock0 + (time.monotonic() - self._t0)

    # --------------------------------------------------------------- async API
    async def submit(self, prompt_len: Optional[int] = None, *,
                     prompt_ids: Optional[List[int]] = None,
                     sampling_params: Optional[SamplingParams] = None,
                     slo_class: str = "standard",
                     slo=None,
                     arrival_time: Optional[float] = None
                     ) -> AsyncRequestHandle:
        """Submit a request; resolves once the driver thread registered it.
        ``arrival_time`` defaults to "now" on the wall-anchored engine clock
        (explicit values are the replay/testing path, ``pace=False``). The
        request's wall submission stamp is this call's, on the clients'
        ``time.monotonic`` clock: its queue wait includes the hand-over to
        the driver thread."""
        submitted_ns = time.monotonic_ns()
        self._check_admitting()
        queue: asyncio.Queue = asyncio.Queue()
        fut = self._loop.create_future()

        def run() -> None:
            if self._draining:
                self._resolve(fut, exc=ServiceDraining(
                    "service is draining; not admitting new requests"))
                return
            t = arrival_time
            if t is None:
                t = (max(self.engine.clock, self.engine_now()) if self.pace
                     else self.engine.clock)
            try:
                h = self.engine.add_request(
                    prompt_len, prompt_ids=prompt_ids,
                    sampling_params=sampling_params, slo_class=slo_class,
                    slo=slo, arrival_time=t)
            except BaseException as e:   # bad params -> client error
                self._resolve(fut, exc=e)
                return
            h.request.wall_submit_ns = submitted_ns
            ah = AsyncRequestHandle(h, self, queue)
            self._live[h.req_id] = (h, ah)
            self._resolve(fut, result=ah)

        self._enqueue(run)
        return await fut

    async def abort(self, req_id: int) -> bool:
        """Cancel a request from any task; safe in any non-finished state."""

        def run(engine) -> bool:
            ok = engine.abort(req_id)
            self._deliver()        # push the final "aborted" event now
            return ok

        return await self.call(run)

    async def call(self, fn: Callable[[Any], Any]) -> Any:
        """Run ``fn(engine)`` on the driver thread (the only thread allowed
        to touch engine state) and return its result — the metrics/report
        snapshot path."""
        if self._stopped:
            raise ServiceStopped("service driver has exited")
        if not self._started:
            raise RuntimeError("service not started")
        fut = self._loop.create_future()

        def run() -> None:
            try:
                res = fn(self.engine)
            except BaseException as e:
                self._resolve(fut, exc=e)
            else:
                self._resolve(fut, result=res)

        self._enqueue(run)
        return await fut

    async def snapshot_trace(self) -> Any:
        """Perfetto/Chrome-trace JSON of the engine's flight recorder,
        assembled on the driver thread (the buses are engine state)."""
        from repro_torch.serving.server import engine_cores
        from repro_torch.serving.trace_export import trace_from_cores

        return await self.call(lambda eng: trace_from_cores(
            engine_cores(eng)))

    # ------------------------------------------------------------ driver side
    def _check_admitting(self) -> None:
        if self._crashed is not None:
            raise ServiceStopped("engine driver crashed") from self._crashed
        if self._stopped:
            raise ServiceStopped("service driver has exited")
        if self._draining:
            raise ServiceDraining("service is draining; not admitting new "
                                  "requests")
        if not self._started:
            raise RuntimeError("service not started")

    def _enqueue(self, fn: Callable[[], None]) -> None:
        with self._cv:
            if self._stopped:
                raise ServiceStopped("service driver has exited")
            self._control.append(fn)
            self._cv.notify_all()

    def _resolve(self, fut: asyncio.Future, *, result=None,
                 exc: Optional[BaseException] = None) -> None:
        """Settle an event-loop future from the driver thread."""

        def settle() -> None:
            if fut.cancelled():
                return
            if exc is not None:
                fut.set_exception(exc)
            else:
                fut.set_result(result)

        try:
            self._loop.call_soon_threadsafe(settle)
        except RuntimeError:         # loop already closed mid-shutdown
            pass

    def _run_control(self) -> None:
        while True:
            with self._cv:
                if not self._control:
                    return
                fns = list(self._control)
                self._control.clear()
            for fn in fns:
                fn()

    def _deliver(self) -> None:
        """Drain each live sync handle's buffered events to its async twin
        on the event loop (driver thread only)."""
        if not self._live:
            return
        done: List[int] = []
        for rid, (h, ah) in self._live.items():
            evts = h.events()
            if not evts:
                continue
            try:
                self._loop.call_soon_threadsafe(ah._feed, evts)
            except RuntimeError:     # loop closed: consumer is gone
                pass
            if evts[-1].finished:
                done.append(rid)
        for rid in done:
            del self._live[rid]

    def _drive(self) -> None:
        engine = self.engine
        unfinished: Optional[List[int]] = None
        exc: Optional[BaseException] = None
        try:
            while True:
                self._run_control()
                if self._stop_requested:
                    break
                if not engine.has_work:
                    with self._cv:
                        if not self._control and not self._stop_requested:
                            self._cv.wait()            # idle: park, no spin
                    continue
                if self.pace:
                    ahead = engine.clock - self.engine_now()
                    if ahead > self._PACE_SLACK:
                        with self._cv:
                            if not self._control and not self._stop_requested:
                                self._cv.wait(min(ahead, self._MAX_NAP))
                        continue
                engine.step()
                self.steps += 1
                self._deliver()

            # -- drain phase: bounded by WALL seconds, streams stay live ----
            def tick(_outcome) -> None:
                self.steps += 1
                self._run_control()    # disconnect aborts during drain
                self._deliver()

            unfinished = engine.drain_wallclock(
                self._drain_timeout, owner=self.name, on_step=tick)
            for rid in unfinished:
                engine.abort(rid)      # frees blocks; streams end "aborted"
            self._deliver()
        except BaseException as e:     # engine bug: fail loudly, not silently
            exc = self._crashed = e
            traceback.print_exc(file=sys.stderr)
            for _rid, (_h, ah) in list(self._live.items()):
                try:
                    self._loop.call_soon_threadsafe(ah._feed_crash, e)
                except RuntimeError:
                    pass
            self._live.clear()
        finally:
            with self._cv:
                self._stopped = True
            self._run_control()        # settle stragglers (they see stopped/
            self._deliver()            # draining and resolve with errors)
            try:
                self.engine.driver_claim.release(self.name)
            except RuntimeError:
                pass
            # resolve shutdown() LAST: by the time the awaiter resumes, the
            # claim is released and the legacy blocking API is usable again
            self._finish(unfinished, exc=exc)

    def _finish(self, unfinished: Optional[List[int]],
                exc: Optional[BaseException] = None) -> None:
        fut = self._shutdown_fut
        if fut is None:
            return
        if exc is not None:
            self._resolve(fut, exc=ServiceStopped(
                "driver crashed during operation"))
        else:
            self._resolve(fut, result=list(unfinished or []))
