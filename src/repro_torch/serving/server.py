"""Stdlib-only asyncio HTTP/1.1 serving front end (DESIGN.md §Service layer).

No third-party dependencies: ``asyncio.start_server`` + hand-rolled request
parsing, chunked transfer encoding for streams. One request per connection
(``Connection: close``) by default; GET probe endpoints (``/healthz``,
``/readyz``, ``/v1/metrics``) and ``POST /v1/generate`` honor an explicit
``Connection: keep-alive`` request header — probes reuse trivially, and a
generate stream that ends cleanly (terminal chunk delivered) leaves the
socket open for the client's next request, dropping the per-request TCP
handshake from steady-state load generators. Disconnects, errors, and
clients that never ask still get the one-shot behaviour. Endpoints:

* ``POST /v1/generate`` — JSON in, SSE-style chunked stream out. Body::

      {"prompt_len": 512,            // or "prompt_ids": [1, 2, ...]
       "max_tokens": 64, "slo_class": "interactive",
       "ignore_eos": true, "eos_token_id": null, "stop_token_ids": [],
       "arrival_time": null}         // replay/testing knob (engine seconds)

  Response chunks are ``data: <RequestOutput-as-JSON>\\n\\n``; the final
  event has ``finished: true`` plus ``finish_reason`` and (real-executor
  mode) the cumulative ``token_ids``. Closing the connection mid-stream
  aborts the request on the engine — its HBM/DRAM blocks are freed.
* ``GET /healthz`` — liveness: 200 while the driver thread is healthy, 500
  after an engine crash (restart me).
* ``GET /readyz`` — readiness: 200 only when the engine is warm (driver
  running), not draining, and every replica's free-HBM fraction is above
  ``ready_headroom``; 503 otherwise (load balancers stop routing here
  first — the drain sequence flips readiness before closing the listener).
* ``GET /v1/metrics`` — the live SLOReport (attainment, latency
  percentiles, timing breakdown) plus server counters, as JSON.

Graceful drain (SIGTERM/SIGINT): stop admitting (readyz 503, generate 503),
close the listener, finish in-flight requests bounded by ``drain_timeout``
WALL seconds (streams keep delivering while draining), abort leftovers, and
exit — code 0 on a clean drain, 1 if anything was cut off.

Real execution (``paged_runner``) runs on CUDA unless the config names
``"device": "cpu"``; with no CUDA device and no ``"cpu"``, building the
engine raises instead of falling back. With ``tp > 1`` one replica spans
``tp`` shards: on the CPU, on ``tp`` cards, or on the list of ``tp``
devices ``"device"`` names (a repeated card stacks shards on it).

Run standalone (the supervised path is ``launch.server_main``)::

    PYTHONPATH=src python -m repro_torch.serving.server --config-json \
        '{"port": 8711, "replicas": 2, "pipeline": true}'
"""
from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import signal
import sys
import time
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.serving.async_engine import (AsyncServingEngine,
                                              ServiceDraining, ServiceStopped)

MAX_BODY_BYTES = 1 << 20
REQUEST_TIMEOUT_S = 30.0


# Structured JSON-lines logging: one {"ts": ..., "event": ..., **fields}
# object per stderr line — the single emitter shared with serve.py and the
# launcher supervisor (re-exported here; see telemetry.StructuredLogger).
from repro_torch.serving.telemetry import log_event  # noqa: E402  (re-export)


# --------------------------------------------------------------------- config
@dataclasses.dataclass
class ServerConfig:
    """Typed, validated service configuration (CLI flags and JSON map 1:1).

    ``build_engine()`` mirrors ``launch.serve``'s topology selection:
    ``disagg`` wins over ``replicas > 1`` wins over a single EngineCore."""
    host: str = "127.0.0.1"
    port: int = 8711                  # 0 = ephemeral (tests)
    model: str = "qwen2.5-32b"
    hw: str = "gh200"
    scheduler: str = "rotasched"
    replicas: int = 1
    router: str = "least-loaded"
    disagg: bool = False
    prefill_replicas: int = 1
    decode_replicas: int = 1
    pipeline: bool = False
    prefix_cache: bool = False
    paged_runner: bool = False        # real reduced-model execution
    # where real execution runs: None = CUDA (an error without a card),
    # "cpu", "cuda" or "cuda:N"; under tp > 1 also a list of tp of them
    # (or one string, comma-separated), one device per shard
    device: Optional[Union[str, List[str]]] = None
    tp: int = 1                       # tensor parallelism (devices/replica)
    kv_dtype: str = "bf16"            # "int8" = quantized KV tier
    hbm_blocks: int = 4000
    dram_blocks: int = 100000
    drain_timeout: float = 15.0       # wall seconds for graceful drain
    ready_headroom: float = 0.005     # min free-HBM fraction for /readyz
    pace: bool = True                 # wall-clock pacing (False = replay)
    seed: int = 0
    # Flight recorder on every replica (GET /v1/trace, Prometheus
    # iteration histograms). The HTTP path carries no golden-replay
    # contract, so it records by default; --no-telemetry turns it off.
    telemetry: bool = True
    # supervisor knobs (consumed by launch.server_main, not the server)
    max_restarts: int = 3
    backoff_base: float = 0.5
    backoff_cap: float = 8.0

    SCHEDULERS = ("rotasched", "fcfs", "wf", "sf", "sjf", "ltr", "lightllm")

    def validate(self) -> "ServerConfig":
        from repro_torch.configs import HW_PROFILES, get_config
        from repro_torch.serving.router import ROUTER_POLICIES
        problems: List[str] = []
        if not (0 <= self.port <= 65535):
            problems.append(f"port {self.port} outside [0, 65535]")
        try:
            get_config(self.model)
        except KeyError as e:
            problems.append(str(e))
        if self.hw not in HW_PROFILES:
            problems.append(f"unknown hw profile {self.hw!r}; "
                            f"known: {sorted(HW_PROFILES)}")
        if self.scheduler not in self.SCHEDULERS:
            problems.append(f"unknown scheduler {self.scheduler!r}")
        if self.router not in ROUTER_POLICIES:
            problems.append(f"unknown router policy {self.router!r}")
        if self.replicas < 1:
            problems.append("replicas must be >= 1")
        if self.tp < 1:
            problems.append("tp must be >= 1")
        devs = self.devices()
        if isinstance(devs, list):
            if len(devs) != self.tp or not all(map(_device_ok, devs)):
                problems.append(f"device must list tp={self.tp} devices, "
                                f"each 'cpu', 'cuda' or 'cuda:N', got "
                                f"{self.device!r}")
        elif not (devs is None or _device_ok(devs)):
            problems.append(f"device must be None, 'cpu', 'cuda' or "
                            f"'cuda:N', got {self.device!r}")
        if self.kv_dtype not in ("bf16", "int8"):
            problems.append(f"kv_dtype must be 'bf16' or 'int8', "
                            f"got {self.kv_dtype!r}")
        if self.prefill_replicas < 1 or self.decode_replicas < 1:
            problems.append("prefill/decode replicas must be >= 1")
        if self.hbm_blocks < 1 or self.dram_blocks < 1:
            problems.append("hbm/dram block pools must be >= 1")
        if self.drain_timeout <= 0:
            problems.append("drain_timeout must be > 0 seconds")
        if not (0.0 <= self.ready_headroom < 1.0):
            problems.append("ready_headroom must be in [0, 1)")
        if self.max_restarts < 0:
            problems.append("max_restarts must be >= 0")
        if self.backoff_base <= 0 or self.backoff_cap < self.backoff_base:
            problems.append("need 0 < backoff_base <= backoff_cap")
        if problems:
            raise ValueError("invalid ServerConfig: " + "; ".join(problems))
        return self

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "ServerConfig":
        known = {f.name for f in dataclasses.fields(cls)}
        unknown = sorted(set(d) - known)
        if unknown:
            raise ValueError(f"unknown ServerConfig keys: {unknown}; "
                             f"known: {sorted(known)}")
        return cls(**d)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def devices(self):
        """``device`` as one device, or a list (one a shard)."""
        if isinstance(self.device, str) and "," in self.device:
            return [d.strip() for d in self.device.split(",")]
        if isinstance(self.device, (list, tuple)):
            return list(self.device)
        return self.device

    def build_engine(self):
        """Construct the engine-like object this config describes."""
        from repro_torch.configs import HW_PROFILES, ServingConfig, get_config
        from repro_torch.device import resolve_device
        from repro_torch.serving.core import EngineCore
        from repro_torch.serving.disagg import DisaggCluster
        from repro_torch.serving.router import Router
        cfg = get_config(self.model)
        sv = ServingConfig(num_hbm_blocks=self.hbm_blocks,
                           num_dram_blocks=self.dram_blocks,
                           scheduler=self.scheduler,
                           pipeline=self.pipeline,
                           prefix_cache=self.prefix_cache,
                           paged_runner=self.paged_runner,
                           tp=self.tp,
                           kv_dtype=self.kv_dtype,
                           telemetry=self.telemetry)
        hw = HW_PROFILES[self.hw]
        if self.tp > 1:
            # too few cards fail here with the recipe; the runner builds
            # the mesh from the same device (or list of devices)
            from repro_torch.launch.hostenv import ensure_host_devices
            device = self.devices()
            ensure_host_devices(self.tp, device)
        else:
            device = resolve_device(self.device)
        runner_cfg = None
        if self.paged_runner:   # real execution: reduced fp32 model
            runner_cfg = dataclasses.replace(cfg.reduced(), dtype="float32")
        if self.disagg:
            return DisaggCluster(cfg, sv, hw,
                                 prefill_replicas=self.prefill_replicas,
                                 decode_replicas=self.decode_replicas,
                                 runner_cfg=runner_cfg,
                                 runner_seed=self.seed, device=device)
        if self.replicas > 1:
            return Router(cfg, sv, hw, replicas=self.replicas,
                          policy=self.router, runner_cfg=runner_cfg,
                          runner_seed=self.seed, device=device)
        return EngineCore(cfg, sv, hw, runner_cfg=runner_cfg,
                          runner_seed=self.seed, device=device)


def _device_ok(d) -> bool:
    return d in ("cpu", "cuda") or (isinstance(d, str)
                                    and d.startswith("cuda:")
                                    and d[5:].isdigit())


def engine_cores(engine) -> List[object]:
    """The EngineCore replicas behind an engine-like object."""
    return list(getattr(engine, "replicas", None) or [engine])


def snapshot_report_row(engine) -> Dict[str, object]:
    """SLOReport row for any engine-like object (driver thread only)."""
    from repro_torch.serving.metrics import evaluate
    if hasattr(engine, "aggregate_report"):
        return engine.aggregate_report().row()
    return evaluate(engine.submitted, total_time=engine.clock,
                    timing=engine.stats.timing_row()).row()


# ----------------------------------------------------------------- HTTP bits
class HttpError(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(message)
        self.status = status
        self.message = message


_REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
            405: "Method Not Allowed", 413: "Payload Too Large",
            500: "Internal Server Error", 503: "Service Unavailable"}


async def _read_http_request(reader: asyncio.StreamReader
                             ) -> Optional[Tuple[str, str, Dict[str, str],
                                                 bytes]]:
    """Parse one HTTP/1.1 request; None if the client closed cleanly."""
    try:
        line = await reader.readline()
    except ValueError as e:                     # request line over limit
        raise HttpError(400, "request line too long") from e
    if not line:
        return None
    parts = line.decode("latin-1").strip().split()
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise HttpError(400, "malformed request line")
    method, path = parts[0].upper(), parts[1]
    headers: Dict[str, str] = {}
    while True:
        try:
            hline = await reader.readline()
        except ValueError as e:
            raise HttpError(400, "header line too long") from e
        if hline in (b"\r\n", b"\n", b""):
            break
        if len(headers) >= 64:
            raise HttpError(400, "too many headers")
        key, sep, val = hline.decode("latin-1").partition(":")
        if not sep:
            raise HttpError(400, "malformed header")
        headers[key.strip().lower()] = val.strip()
    body = b""
    clen = headers.get("content-length")
    if clen is not None:
        try:
            n = int(clen)
        except ValueError as e:
            raise HttpError(400, "bad Content-Length") from e
        if n < 0 or n > MAX_BODY_BYTES:
            raise HttpError(413, f"body over {MAX_BODY_BYTES} bytes")
        if n:
            body = await reader.readexactly(n)
    return method, path, headers, body


def _response_head(status: int, headers: Dict[str, str]) -> bytes:
    lines = [f"HTTP/1.1 {status} {_REASONS.get(status, 'Unknown')}"]
    lines += [f"{k}: {v}" for k, v in headers.items()]
    return ("\r\n".join(lines) + "\r\n\r\n").encode("latin-1")


def _json_response(writer: asyncio.StreamWriter, status: int,
                   obj: object, *, keep_alive: bool = False) -> None:
    body = json.dumps(obj).encode()
    writer.write(_response_head(status, {
        "Content-Type": "application/json",
        "Content-Length": str(len(body)),
        "Connection": "keep-alive" if keep_alive else "close"}) + body)


# Paths that may reuse the connection (explicit opt-in only: clients that
# never send ``Connection: keep-alive`` see the original one-shot
# behaviour, response header included). GET probes reuse trivially;
# ``POST /v1/generate`` reuses after a CLEAN stream end (terminal chunk
# delivered) — bytes of a pipelined next request that the disconnect
# watcher swallowed mid-stream are pushed back before the next parse.
_KEEPALIVE_PATHS = frozenset({"/healthz", "/readyz", "/v1/metrics",
                              "/v1/trace"})
_KEEPALIVE_POST_PATHS = frozenset({"/v1/generate"})


def _chunk(data: bytes) -> bytes:
    return f"{len(data):X}\r\n".encode("latin-1") + data + b"\r\n"


def _sse_event(obj: object) -> bytes:
    return _chunk(b"data: " + json.dumps(obj).encode() + b"\n\n")


class ClientDisconnected(Exception):
    pass


async def _watch_eof(reader: asyncio.StreamReader,
                     stash: Optional[bytearray] = None) -> None:
    """Resolve when the client half-closes its socket (disconnect signal
    during streaming). Consumed bytes go into ``stash`` when given — a
    kept-alive client may legally pipeline its next request while the
    stream is still running, and those bytes must survive the watch."""
    while True:
        data = await reader.read(4096)
        if not data:
            return
        if stash is not None:
            stash.extend(data)


def _unread(reader: asyncio.StreamReader, data: bytes) -> bool:
    """Push consumed bytes back to the FRONT of the reader's buffer (they
    arrived before anything still buffered). Touches a private CPython
    attribute by necessity — returns False (caller closes instead of
    reusing) if the implementation doesn't expose it."""
    if not data:
        return True
    buf = getattr(reader, "_buffer", None)
    if not isinstance(buf, bytearray):
        return False
    buf[:0] = data
    return True


# --------------------------------------------------------------------- server
class InferenceServer:
    """The asyncio HTTP front end over one ``AsyncServingEngine``."""

    def __init__(self, service: AsyncServingEngine, cfg: ServerConfig):
        self.service = service
        self.cfg = cfg
        self.port: Optional[int] = None
        self._server: Optional[asyncio.base_events.Server] = None
        self._t_up = time.monotonic()
        self._shutdown_ev = asyncio.Event()
        self._conn_tasks: set = set()
        # server counters (surfaced by /v1/metrics)
        self.http_requests = 0
        self.streams_started = 0
        self.streams_active = 0
        self.aborted_on_disconnect = 0

    # ------------------------------------------------------------- lifecycle
    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle_conn, host=self.cfg.host, port=self.cfg.port)
        self.port = self._server.sockets[0].getsockname()[1]
        self._t_up = time.monotonic()

    def request_shutdown(self) -> None:
        """Begin graceful drain; safe to call from signal handlers (must
        run on the event loop thread — use call_soon_threadsafe across
        threads). Idempotent."""
        if not self._shutdown_ev.is_set():
            log_event("drain_begin", drain_timeout=self.cfg.drain_timeout)
            self._shutdown_ev.set()

    async def run_until_shutdown(self) -> int:
        """Serve until a shutdown is requested, then drain. Returns the
        process exit code: 0 clean drain, 1 if requests were cut off."""
        await self._shutdown_ev.wait()
        # 1) stop admitting: close the listener (readyz already flips 503
        #    via _draining, so balancers stop routing before the close).
        #    Its wait_closed() comes last: since Python 3.12 it also waits
        #    for every open connection, so awaiting it here would hold the
        #    drain until the open streams finished on their own.
        self._server.close()
        # 2) finish in-flight work bounded by WALL seconds; open streams
        #    keep receiving tokens while the engine drains
        unfinished = await self.service.shutdown(self.cfg.drain_timeout)
        # 3) aborted leftovers emit final events; give handlers a moment to
        #    flush them to their sockets, then cut any stragglers
        if self._conn_tasks:
            await asyncio.wait(self._conn_tasks, timeout=3.0)
        for t in list(self._conn_tasks):
            t.cancel()
        if self._conn_tasks:
            await asyncio.gather(*self._conn_tasks, return_exceptions=True)
        await self._server.wait_closed()
        log_event("drain_done", unfinished=len(unfinished),
                  unfinished_ids=unfinished[:16])
        return 0 if not unfinished else 1

    @property
    def _draining(self) -> bool:
        return self._shutdown_ev.is_set() or self.service.draining

    def _readiness(self) -> Tuple[bool, str, float]:
        """(ready, reason, min free-HBM fraction across replicas)."""
        cores = engine_cores(self.service.engine)
        # racy int reads of another thread's counters: readiness is a
        # monitoring signal, not an engine invariant
        headroom = min((c.kv.hbm_free_blocks / max(c.kv.table.num_hbm_blocks,
                                                   1)) for c in cores)
        if self.service.crashed is not None:
            return False, "engine driver crashed", headroom
        if not self.service.started:
            return False, "engine not started", headroom
        if self._draining:
            return False, "draining", headroom
        if headroom < self.cfg.ready_headroom:
            return False, (f"HBM headroom {headroom:.4f} below watermark "
                           f"{self.cfg.ready_headroom}"), headroom
        return True, "ok", headroom

    # ------------------------------------------------------------ connection
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        self._conn_tasks.add(task)
        try:
            while True:                    # loops only on kept-alive probes
                try:
                    req = await asyncio.wait_for(_read_http_request(reader),
                                                 REQUEST_TIMEOUT_S)
                except (asyncio.TimeoutError, asyncio.IncompleteReadError,
                        ConnectionError):
                    return
                except HttpError as e:
                    _json_response(writer, e.status, {"error": e.message})
                    return
                if req is None:
                    return
                method, path, headers, body = req
                path, _, query = path.partition("?")
                self.http_requests += 1
                wants_keep = (headers.get("connection", "").lower()
                              == "keep-alive")
                keep = wants_keep and (
                    (method == "GET" and path in _KEEPALIVE_PATHS)
                    or (method == "POST" and path in _KEEPALIVE_POST_PATHS))
                try:
                    keep = await self._dispatch(method, path, body, reader,
                                                writer, keep_alive=keep,
                                                query=query, headers=headers)
                except HttpError as e:
                    _json_response(writer, e.status, {"error": e.message})
                    keep = False           # error responses always close
                except (ConnectionError, ClientDisconnected):
                    return
                if not keep:
                    return
                try:
                    await writer.drain()
                except ConnectionError:
                    return
        except asyncio.CancelledError:     # drain cutting off a straggler
            pass
        finally:
            self._conn_tasks.discard(task)
            try:
                writer.close()
                await writer.wait_closed()
            except (ConnectionError, RuntimeError):
                pass

    async def _dispatch(self, method: str, path: str, body: bytes,
                        reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter, *,
                        keep_alive: bool = False, query: str = "",
                        headers: Optional[Dict[str, str]] = None) -> bool:
        """Route one request; returns whether the connection may be reused
        (``_generate`` can demote an approved keep-alive mid-stream)."""
        if path == "/healthz":
            if method != "GET":
                raise HttpError(405, "use GET")
            if self.service.crashed is not None:
                _json_response(writer, 500, {
                    "status": "crashed",
                    "error": repr(self.service.crashed)},
                    keep_alive=keep_alive)
            else:
                _json_response(writer, 200, {
                    "status": "ok",
                    "uptime_s": round(time.monotonic() - self._t_up, 3),
                    "draining": self._draining}, keep_alive=keep_alive)
        elif path == "/readyz":
            if method != "GET":
                raise HttpError(405, "use GET")
            ready, reason, headroom = self._readiness()
            _json_response(writer, 200 if ready else 503, {
                "ready": ready, "reason": reason,
                "hbm_headroom": round(headroom, 4)}, keep_alive=keep_alive)
        elif path == "/v1/metrics":
            if method != "GET":
                raise HttpError(405, "use GET")
            # content negotiation: JSON stays the default (existing
            # clients/CI); Prometheus text on ?format=prometheus or an
            # Accept header asking for text/plain or openmetrics
            accept = (headers or {}).get("accept", "")
            if ("format=prometheus" in query or "text/plain" in accept
                    or "openmetrics" in accept):
                await self._metrics_prometheus(writer,
                                               keep_alive=keep_alive)
            else:
                await self._metrics(writer, keep_alive=keep_alive)
        elif path == "/v1/trace":
            if method != "GET":
                raise HttpError(405, "use GET")
            await self._trace(writer, keep_alive=keep_alive)
        elif path == "/v1/generate":
            if method != "POST":
                raise HttpError(405, "use POST")
            return await self._generate(body, reader, writer,
                                        keep_alive=keep_alive)
        else:
            raise HttpError(404, f"no route for {path}")
        return keep_alive

    async def _metrics(self, writer: asyncio.StreamWriter, *,
                       keep_alive: bool = False) -> None:
        try:
            row = await self.service.call(snapshot_report_row)
        except (ServiceStopped, ServiceDraining) as e:
            raise HttpError(503, f"metrics unavailable: {e}") from e
        row["server"] = {
            "uptime_s": round(time.monotonic() - self._t_up, 3),
            "engine_steps": self.service.steps,
            "http_requests": self.http_requests,
            "streams_started": self.streams_started,
            "streams_active": self.streams_active,
            "aborted_on_disconnect": self.aborted_on_disconnect,
            "draining": self._draining,
        }
        _json_response(writer, 200, row, keep_alive=keep_alive)

    async def _metrics_prometheus(self, writer: asyncio.StreamWriter, *,
                                  keep_alive: bool = False) -> None:
        """Prometheus text-format 0.0.4 exposition (stdlib-only)."""
        from repro_torch.serving.telemetry import render_prometheus
        ready, _, headroom = self._readiness()
        extra = {
            "ready": int(ready),
            "hbm_headroom": headroom,
            "uptime_seconds": round(time.monotonic() - self._t_up, 3),
            "engine_steps": self.service.steps,
            "http_requests": self.http_requests,
            "streams_started": self.streams_started,
            "streams_active": self.streams_active,
            "aborted_on_disconnect": self.aborted_on_disconnect,
            "draining": int(self._draining),
        }
        try:
            text = await self.service.call(
                lambda eng: render_prometheus(engine_cores(eng),
                                              extra=extra))
        except (ServiceStopped, ServiceDraining) as e:
            raise HttpError(503, f"metrics unavailable: {e}") from e
        body = text.encode()
        writer.write(_response_head(200, {
            "Content-Type": "text/plain; version=0.0.4; charset=utf-8",
            "Content-Length": str(len(body)),
            "Connection": "keep-alive" if keep_alive else "close"}) + body)

    async def _trace(self, writer: asyncio.StreamWriter, *,
                     keep_alive: bool = False) -> None:
        """Perfetto/Chrome-trace JSON of the replicas' flight recorders
        (empty trace when ``telemetry`` is off)."""
        from repro_torch.serving.trace_export import trace_from_cores
        try:
            trace = await self.service.call(
                lambda eng: trace_from_cores(engine_cores(eng)))
        except (ServiceStopped, ServiceDraining) as e:
            raise HttpError(503, f"trace unavailable: {e}") from e
        _json_response(writer, 200, trace, keep_alive=keep_alive)

    # -------------------------------------------------------------- generate
    @staticmethod
    def _parse_generate(body: bytes) -> Dict[str, object]:
        from repro_torch.core.types import SamplingParams
        try:
            payload = json.loads(body.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise HttpError(400, f"invalid JSON body: {e}") from e
        if not isinstance(payload, dict):
            raise HttpError(400, "body must be a JSON object")
        known = {"prompt_len", "prompt_ids", "max_tokens", "ignore_eos",
                 "eos_token_id", "stop_token_ids", "slo_class",
                 "arrival_time"}
        unknown = sorted(set(payload) - known)
        if unknown:
            raise HttpError(400, f"unknown fields: {unknown}")
        try:
            sp = SamplingParams(
                max_tokens=int(payload.get("max_tokens", 128)),
                ignore_eos=bool(payload.get("ignore_eos", True)),
                eos_token_id=payload.get("eos_token_id"),
                stop_token_ids=tuple(payload.get("stop_token_ids", ())))
        except (TypeError, ValueError) as e:
            raise HttpError(400, f"bad sampling params: {e}") from e
        prompt_ids = payload.get("prompt_ids")
        prompt_len = payload.get("prompt_len")
        if (prompt_len is None) == (prompt_ids is None):
            raise HttpError(400, "pass exactly one of prompt_len/prompt_ids")
        arrival = payload.get("arrival_time")
        return dict(prompt_len=(int(prompt_len) if prompt_len is not None
                                else None),
                    prompt_ids=prompt_ids, sampling_params=sp,
                    slo_class=str(payload.get("slo_class", "standard")),
                    arrival_time=(float(arrival) if arrival is not None
                                  else None))

    async def _generate(self, body: bytes, reader: asyncio.StreamReader,
                        writer: asyncio.StreamWriter, *,
                        keep_alive: bool = False) -> bool:
        """Stream one generation; returns True when the connection may be
        reused (keep-alive requested AND the stream ended with its terminal
        chunk delivered — disconnects and errors always close)."""
        if self._draining:
            raise HttpError(503, "draining: not admitting new requests")
        kw = self._parse_generate(body)
        try:
            handle = await self.service.submit(**kw)
        except ServiceDraining as e:
            raise HttpError(503, str(e)) from e
        except ServiceStopped as e:
            raise HttpError(503, str(e)) from e
        except (ValueError, KeyError, TypeError) as e:
            raise HttpError(400, str(e)) from e

        self.streams_started += 1
        self.streams_active += 1
        writer.write(_response_head(200, {
            "Content-Type": "text/event-stream",
            "Transfer-Encoding": "chunked",
            "Cache-Control": "no-store",
            "Connection": "keep-alive" if keep_alive else "close"}))
        stash = bytearray() if keep_alive else None
        eof = asyncio.ensure_future(_watch_eof(reader, stash))
        stream = handle.stream()
        try:
            while True:
                nxt = asyncio.ensure_future(anext(stream))
                done, _ = await asyncio.wait(
                    {nxt, eof}, return_when=asyncio.FIRST_COMPLETED)
                if nxt not in done:               # client went away first
                    nxt.cancel()
                    await asyncio.gather(nxt, return_exceptions=True)
                    raise ClientDisconnected
                try:
                    evt = nxt.result()
                except StopAsyncIteration:
                    break
                try:
                    writer.write(_sse_event(dataclasses.asdict(evt)))
                    await writer.drain()
                except ConnectionError as e:
                    raise ClientDisconnected from e
                if evt.finished:
                    break
            writer.write(b"0\r\n\r\n")            # terminal chunk
            await writer.drain()
        except (ClientDisconnected, ConnectionError):
            if not handle.finished:
                self.aborted_on_disconnect += 1
                try:
                    await self.service.abort(handle.req_id)
                except (ServiceStopped, ServiceDraining):
                    pass
            raise ClientDisconnected from None
        finally:
            self.streams_active -= 1
            eof.cancel()
            await asyncio.gather(eof, return_exceptions=True)
            await stream.aclose()
        if not keep_alive:
            return False
        # clean stream end: hand back any next-request bytes the watcher
        # consumed so the connection loop can parse them
        return _unread(reader, bytes(stash))


# ----------------------------------------------------------------- entrypoint
async def serve_main(cfg: ServerConfig, *, install_signals: bool = True,
                     ready_cb=None) -> int:
    """Build engine + service + server, run until drained; returns the exit
    code. ``ready_cb(server, service)`` fires once the socket is bound
    (tests use it to learn the ephemeral port)."""
    engine = cfg.build_engine()
    service = AsyncServingEngine(engine, pace=cfg.pace)
    server = InferenceServer(service, cfg)
    await service.start()
    await server.start()
    loop = asyncio.get_running_loop()
    if install_signals:
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, server.request_shutdown)
    log_event("server_up", host=cfg.host, port=server.port,
              model=cfg.model, replicas=cfg.replicas, disagg=cfg.disagg,
              pipeline=cfg.pipeline, prefix_cache=cfg.prefix_cache,
              paged_runner=cfg.paged_runner, tp=cfg.tp,
              pid=__import__("os").getpid())
    if ready_cb is not None:
        ready_cb(server, service)
    code = await server.run_until_shutdown()
    from repro_torch.kernels.ops import launch_counts
    # the process's kernel launches by kernel: what a supervised child ran
    log_event("server_exit", code=code, kernel_launches=launch_counts())
    return code


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="SuperInfer asyncio HTTP server (single process; see "
                    "launch.server_main for the supervised launcher)")
    g = ap.add_mutually_exclusive_group(required=True)
    g.add_argument("--config-json", help="ServerConfig as a JSON object")
    g.add_argument("--config-file", help="path to a ServerConfig JSON file")
    args = ap.parse_args(argv)
    if args.config_file:
        with open(args.config_file) as f:
            raw = json.load(f)
    else:
        raw = json.loads(args.config_json)
    cfg = ServerConfig.from_dict(raw).validate()
    return asyncio.run(serve_main(cfg))


if __name__ == "__main__":
    sys.exit(main())
