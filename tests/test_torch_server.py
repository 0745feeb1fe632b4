"""The port's HTTP front door (``repro_torch.serving.server``) over a real
localhost socket, in process on an ephemeral port, on the CPU.

``serve_main`` runs on a background thread (``install_signals=False``:
asyncio signal handlers need the main thread; the SIGTERM path runs in
``chip_smoke.py`` phase 9 through ``launch.server_main``). Covers:

  * ``ServerConfig.validate()`` errors equal to the reference's for the
    same bad configs, plus the port's ``device`` key and ``tp > 1``;
  * stream, metrics, 4xx answers and a clean drain; keep-alive probes;
  * the SSE events of a fixed request list equal to the reference
    server's (sim mode, ``pace=False``, explicit arrival times);
  * a client that disconnects mid-stream aborts its request and frees its
    blocks;
  * ``paged_runner=True, device="cpu"``: the HTTP ``token_ids`` equal the
    port's offline engine's at the same seed;
  * readiness flips to 503 once the drain starts and a request that cannot
    finish inside an explicit drain deadline ends "aborted", exit code 1.
    The request can never be scheduled, so the outcome does not depend on
    how loaded the host is (the reference's own wall-paced scenario,
    tests/test_server.py, is not copied).
"""
import asyncio
import json
import socket
import threading
import time

import numpy as np
import pytest

pytest.importorskip("torch")

import repro.serving.server as rserver  # noqa: E402

import repro_torch.serving.server as tserver  # noqa: E402
from repro_torch.core.types import SamplingParams  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")


# ------------------------------------------------------------------ harness
class ServerUnderTest:
    """``serve_main`` of one package on a daemon thread."""

    def __init__(self, mod=tserver, **cfg_kw):
        cfg_kw.setdefault("port", 0)
        cfg_kw.setdefault("model", "llama3-8b")
        cfg_kw.setdefault("hbm_blocks", 256)
        cfg_kw.setdefault("dram_blocks", 2048)
        if mod is tserver:
            cfg_kw.setdefault("device", "cpu")
        self.cfg = mod.ServerConfig(**cfg_kw).validate()
        self.mod = mod
        self.code = None
        self.server = self.service = self.loop = None
        self._ready = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        def ready_cb(server, service):
            self.server, self.service = server, service
            self.loop = asyncio.get_running_loop()
            self._ready.set()
        try:
            self.code = asyncio.run(self.mod.serve_main(
                self.cfg, install_signals=False, ready_cb=ready_cb))
        finally:
            self._ready.set()       # unblock __enter__ on startup failure

    def __enter__(self):
        self._thread.start()
        assert self._ready.wait(60), "server did not start"
        assert self.server is not None, "serve_main died during startup"
        return self

    def __exit__(self, *exc):
        if self._thread.is_alive():
            self.loop.call_soon_threadsafe(self.server.request_shutdown)
            self._thread.join(60)
        assert not self._thread.is_alive(), "server failed to shut down"

    @property
    def port(self):
        return self.server.port

    @property
    def engine(self):
        return self.service.engine

    def stop(self):
        self.__exit__()
        return self.code


def http(port, method, path, body=None, timeout=30.0):
    """One blocking HTTP exchange (Connection: close); returns (status,
    body bytes)."""
    payload = b"" if body is None else json.dumps(body).encode()
    head = (f"{method} {path} HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n").encode()
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(head + payload)
        raw = b""
        while chunk := s.recv(65536):
            raw += chunk
    head, _, rest = raw.partition(b"\r\n\r\n")
    return int(head.split(b" ", 2)[1]), rest


class EventReader:
    """Incremental parser of ``data: {...}`` events out of a chunked SSE
    body: each byte is scanned once, however long the stream."""

    def __init__(self):
        self.buf = b""
        self.pos = 0
        self.events = []

    def feed(self, data):
        self.buf += data
        while (s := self.buf.find(b"data: ", self.pos)) != -1:
            e = self.buf.find(b"\n\n", s)
            if e == -1:
                break
            self.events.append(json.loads(self.buf[s + 6:e]))
            self.pos = e + 2


def stream_events(port, body, stop_after=None, timeout=60.0):
    """POST /v1/generate and read events as they arrive; closing early
    (``stop_after``) models a client disconnect."""
    payload = json.dumps(body).encode()
    head = (f"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
            f"Content-Length: {len(payload)}\r\n\r\n").encode()
    rd = EventReader()
    with socket.create_connection(("127.0.0.1", port), timeout=timeout) as s:
        s.sendall(head + payload)
        while chunk := s.recv(65536):
            rd.feed(chunk)
            if rd.events and rd.events[-1]["finished"]:
                break
            if stop_after is not None and len(rd.events) >= stop_after:
                break           # leaving the block closes the socket
    return rd.events


# ------------------------------------------------------------------- config
BAD_CONFIGS = [
    {"model": "nope", "scheduler": "nope", "replicas": 0,
     "drain_timeout": -1},
    {"port": 70000, "hw": "tpu-v9", "router": "random"},
    {"tp": 0, "kv_dtype": "fp8", "prefill_replicas": 0},
    {"hbm_blocks": 0, "ready_headroom": 1.0, "max_restarts": -1},
    {"backoff_base": 2.0, "backoff_cap": 1.0},
]


@pytest.mark.parametrize("bad", BAD_CONFIGS, ids=range(len(BAD_CONFIGS)))
def test_config_validation_errors_equal_reference(bad):
    with pytest.raises(ValueError) as want:
        rserver.ServerConfig(**bad).validate()
    with pytest.raises(ValueError) as got:
        tserver.ServerConfig(**bad).validate()
    assert str(got.value) == str(want.value)


def test_config_device_tp_and_keys():
    for ok in (None, "cpu", "cuda", "cuda:1"):
        cfg = tserver.ServerConfig(device=ok)
        assert cfg.validate() is cfg
    for bad in ("gpu", "cuda:x", "cuda:", 0):
        with pytest.raises(ValueError, match="device must be"):
            tserver.ServerConfig(device=bad).validate()
    with pytest.raises(ValueError, match=r"unknown ServerConfig keys: "
                                         r"\['bogus'\]"):
        tserver.ServerConfig.from_dict({"bogus": 1})
    cfg = tserver.ServerConfig.from_dict({"port": 0, "replicas": 2,
                                          "device": "cpu"})
    assert cfg.to_dict()["device"] == "cpu"
    assert {k: v for k, v in cfg.to_dict().items() if k != "device"} == \
        rserver.ServerConfig.from_dict({"port": 0, "replicas": 2}).to_dict()
    # tp > 1 validates as in the reference and builds: one replica whose
    # DuplexKV splits every row over two kv shards
    cfg = tserver.ServerConfig(tp=2, device="cpu")
    assert cfg.validate() is cfg
    assert cfg.build_engine().kv.kv_shards == 2


# ---------------------------------------------------------------- endpoints
def test_stream_health_metrics_and_clean_drain():
    with ServerUnderTest(pace=False) as sut:
        status, body = http(sut.port, "GET", "/healthz")
        assert status == 200 and json.loads(body)["status"] == "ok"
        status, body = http(sut.port, "GET", "/readyz")
        assert status == 200 and json.loads(body)["ready"] is True

        evts = stream_events(sut.port, {"prompt_len": 64, "max_tokens": 12,
                                        "slo_class": "interactive"})
        assert evts[-1]["finished"]
        assert evts[-1]["finish_reason"] == "length"
        assert evts[-1]["tokens_generated"] == 12
        assert sum(e["new_tokens"] for e in evts) == 12
        assert evts[-1]["slo_class"] == "interactive"
        assert evts[-1]["ttft_s"] is not None

        status, body = http(sut.port, "GET", "/v1/metrics")
        row = json.loads(body)
        assert status == 200 and row["n"] >= 1
        assert "ttft_attainment" in row
        assert row["server"]["streams_started"] == 1
        assert row["server"]["engine_steps"] > 0
        status, body = http(sut.port, "GET", "/v1/metrics?format=prometheus")
        assert status == 200 and b"# TYPE" in body

        for bad in ({"max_tokens": 4},                       # no prompt
                    {"prompt_len": 4, "prompt_ids": [1, 2]},  # both
                    {"prompt_len": 4, "wat": 1}):             # unknown field
            status, body = http(sut.port, "POST", "/v1/generate", bad)
            assert status == 400, body
        assert http(sut.port, "GET", "/nope")[0] == 404
        assert http(sut.port, "POST", "/healthz")[0] == 405
    assert sut.stop() == 0          # nothing in flight: clean drain


def test_probe_keepalive_reuses_one_socket():
    def recv_response(s):
        raw = b""
        while b"\r\n\r\n" not in raw:
            chunk = s.recv(65536)
            assert chunk, "server closed mid-response"
            raw += chunk
        head, _, body = raw.partition(b"\r\n\r\n")
        headers = dict(
            line.split(b": ", 1) for line in head.split(b"\r\n")[1:])
        clen = int(headers[b"Content-Length"])
        while len(body) < clen:
            chunk = s.recv(65536)
            assert chunk, "server closed mid-body"
            body += chunk
        return int(head.split(b" ", 2)[1]), headers, json.loads(body)

    with ServerUnderTest(pace=False) as sut:
        with socket.create_connection(("127.0.0.1", sut.port),
                                      timeout=30.0) as s:
            for path, key in (("/healthz", "status"), ("/readyz", "ready"),
                              ("/v1/metrics", "server"), ("/healthz", None)):
                s.sendall((f"GET {path} HTTP/1.1\r\nHost: t\r\n"
                           f"Connection: keep-alive\r\n\r\n").encode())
                status, headers, obj = recv_response(s)
                assert status == 200
                assert headers[b"Connection"] == b"keep-alive"
                if key is not None:
                    assert key in obj
            assert sut.server.http_requests >= 4
            s.sendall(b"GET /healthz HTTP/1.1\r\nHost: t\r\n\r\n")
            status, headers, _ = recv_response(s)
            assert status == 200 and headers[b"Connection"] == b"close"
            assert s.recv(65536) == b""          # server closed its end
    assert sut.stop() == 0


# ------------------------------------------------------------------- parity
REPLAY = [{"prompt_len": 300, "max_tokens": 9, "slo_class": "interactive",
           "arrival_time": 0.0},
          {"prompt_ids": list(range(1, 41)), "max_tokens": 5,
           "arrival_time": 0.1},
          {"prompt_len": 1200, "max_tokens": 7, "slo_class": "batch",
           "arrival_time": 5.0},
          {"prompt_len": 16, "max_tokens": 3, "eos_token_id": 2,
           "ignore_eos": False, "arrival_time": 0.0}]


def replay_events(mod):
    with ServerUnderTest(mod, pace=False) as sut:
        out = [stream_events(sut.port, body) for body in REPLAY]
    assert sut.code == 0
    return out


def test_sse_events_equal_reference():
    """One request at a time, each at an explicit engine arrival time: the
    port's event stream equals the reference server's, field for field."""
    want = replay_events(rserver)
    got = replay_events(tserver)
    assert got == want
    assert [e[-1]["tokens_generated"] for e in got] == [9, 5, 7, 3]


def test_token_parity_with_offline_engine():
    """paged_runner on the CPU: the HTTP stream's final token_ids equal the
    port's offline engine at the same seed (argmax ids are independent of
    batching and timing)."""
    kw = dict(model="llama3-8b", paged_runner=True, seed=7, hbm_blocks=256,
              dram_blocks=2048, pace=False, device="cpu")
    rng = np.random.default_rng(11)
    prompts = [[int(x) for x in rng.integers(1, 256, int(rng.integers(8, 20)))]
               for _ in range(3)]
    max_toks = [6, 9, 12]
    offline = tserver.ServerConfig(port=0, **kw).build_engine()
    want = [offline.add_request(
        prompt_ids=ids, sampling_params=SamplingParams(max_tokens=mt)
    ).result().token_ids for ids, mt in zip(prompts, max_toks)]
    with ServerUnderTest(**kw) as sut:
        assert sut.engine.executor.device.type == "cpu"
        for ids, mt, ref in zip(prompts, max_toks, want):
            evts = stream_events(sut.port, {"prompt_ids": ids,
                                            "max_tokens": mt})
            assert evts[-1]["finish_reason"] == "length"
            assert evts[-1]["token_ids"] == ref
            assert [t for e in evts for t in e["new_token_ids"]] == ref
    assert sut.code == 0


def test_concurrent_clients():
    n = 8
    with ServerUnderTest(pace=False, replicas=2, pipeline=True) as sut:
        results = [None] * n

        def worker(i):
            results[i] = stream_events(
                sut.port, {"prompt_len": 32 + i, "max_tokens": 6 + i})
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        rids = set()
        for i, evts in enumerate(results):
            assert evts is not None and evts[-1]["finished"]
            assert evts[-1]["tokens_generated"] == 6 + i
            rids.add(evts[-1]["req_id"])
        assert len(rids) == n       # cluster-unique ids across replicas
    assert sut.code == 0


# -------------------------------------------------------------- disconnect
def test_disconnect_aborts_and_frees_blocks():
    with ServerUnderTest(pace=True) as sut:
        core = sut.engine
        hbm0, dram0 = core.kv.hbm_free_blocks, core.kv.table.dram_free
        evts = stream_events(sut.port,
                             {"prompt_len": 256, "max_tokens": 100000},
                             stop_after=2)
        assert len(evts) >= 2 and not evts[-1]["finished"]
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline:
            if (not core.has_work and core.kv.hbm_free_blocks == hbm0
                    and core.kv.table.dram_free == dram0):
                break
            time.sleep(0.05)
        assert not core.has_work, "abort-on-disconnect never landed"
        assert core.kv.hbm_free_blocks == hbm0
        assert core.kv.table.dram_free == dram0
        assert sut.server.aborted_on_disconnect == 1
    assert sut.code == 0


# ------------------------------------------------------------------- drain
def test_readyz_flips_and_dirty_drain():
    """A request that cannot finish inside the drain deadline: /readyz
    answers 503 "draining" once the drain starts (probed over a connection
    accepted before the listener closed), the open stream ends "aborted",
    and the server exits 1. The request needs 125 blocks of a 64-block HBM,
    so it waits for ever and streams nothing until its final event: only
    the 0.3 s deadline ends it, however loaded the host is."""
    sut = ServerUnderTest(pace=False, drain_timeout=0.3, hbm_blocks=64)
    with sut:
        probe = socket.create_connection(("127.0.0.1", sut.port), timeout=30)
        got = {}

        def client():
            got["events"] = stream_events(
                sut.port, {"prompt_len": 2000, "max_tokens": 10})
        t = threading.Thread(target=client, daemon=True)
        t.start()
        deadline = time.monotonic() + 30
        while not sut.engine.has_work and time.monotonic() < deadline:
            time.sleep(0.01)
        assert sut.engine.has_work
        sut.loop.call_soon_threadsafe(sut.server.request_shutdown)
        while not sut.server._draining and time.monotonic() < deadline:
            time.sleep(0.01)
        probe.sendall(b"GET /readyz HTTP/1.1\r\nHost: t\r\n"
                      b"Content-Length: 0\r\n\r\n")
        raw = b""
        while chunk := probe.recv(65536):
            raw += chunk
        probe.close()
        assert b" 503 " in raw.split(b"\r\n", 1)[0]
        assert b"draining" in raw
        t.join(60)
        assert not t.is_alive()
        evts = got["events"]
        assert len(evts) == 1 and evts[0]["finished"]
        assert evts[0]["finish_reason"] == "aborted"
        assert evts[0]["tokens_generated"] == 0
    assert sut.code == 1            # the request was cut off
