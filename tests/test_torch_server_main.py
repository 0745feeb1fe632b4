"""The port's supervised launcher (``repro_torch.launch.server_main``).

For the same flags its ``config_from_args`` equals the reference's, apart
from the port's ``device`` key; its child runs the port's server; and, as
a user runs it on the CPU (``--device cpu``), it serves a stream, forwards
SIGTERM to the child, and exits 0 after a clean drain."""
import json
import os
import signal
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

import repro.launch.server_main as rmain  # noqa: E402

import repro_torch.launch.server_main as tmain  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

FLAGS = [
    [],
    ["--port", "0", "--replicas", "2", "--pipeline", "--drain-timeout", "5"],
    ["--model", "llama3-8b", "--paged-runner", "--hbm-blocks", "96",
     "--no-pace", "--seed", "3", "--kv-dtype", "int8"],
    ["--disagg", "--prefill-replicas", "2", "--decode-replicas", "1",
     "--prefix-cache", "--no-telemetry", "--max-restarts", "0",
     "--backoff-base", "0.1", "--backoff-cap", "0.2"],
]


@pytest.mark.parametrize("flags", FLAGS, ids=range(len(FLAGS)))
def test_config_from_args_equals_reference(flags, tmp_path):
    base = tmp_path / "base.json"
    base.write_text(json.dumps({"model": "yi-34b", "scheduler": "fcfs"}))
    for extra in ([], ["--config-file", str(base)]):
        want = rmain.config_from_args(
            rmain.build_parser().parse_args(flags + extra)).to_dict()
        got = tmain.config_from_args(
            tmain.build_parser().parse_args(flags + extra)).to_dict()
        assert got.pop("device") is None
        assert got == want
    got = tmain.config_from_args(tmain.build_parser().parse_args(
        flags + ["--device", "cpu"]))
    assert got.device == "cpu"
    with pytest.raises(ValueError, match="device must be"):
        tmain.config_from_args(tmain.build_parser().parse_args(
            flags + ["--device", "tpu"]))


def test_child_argv_runs_the_port_server():
    cfg = tmain.config_from_args(tmain.build_parser().parse_args(
        ["--device", "cpu", "--port", "0"]))
    argv = tmain.Supervisor(cfg).child_argv()
    assert argv[:3] == [sys.executable, "-m", "repro_torch.serving.server"]
    assert json.loads(argv[4]) == cfg.to_dict()
    assert tmain.main(["--device", "gpu"]) == 2      # bad config: exit 2


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_launcher_serves_and_drains_on_sigterm():
    port = free_port()
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(ROOT / "src"), os.environ.get("PYTHONPATH")) if p))
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.server_main", "--device",
         "cpu", "--port", str(port), "--model", "llama3-8b", "--hbm-blocks",
         "256", "--dram-blocks", "2048", "--no-pace"],
        cwd=ROOT, env=env, stdout=subprocess.DEVNULL,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                s = socket.create_connection(("127.0.0.1", port), timeout=5)
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline, "server never listened"
                time.sleep(0.1)
        body = json.dumps({"prompt_len": 32, "max_tokens": 5}).encode()
        with s:
            s.sendall(b"POST /v1/generate HTTP/1.1\r\nHost: t\r\n"
                      b"Content-Length: %d\r\n\r\n" % len(body) + body)
            raw = b""
            while chunk := s.recv(65536):
                raw += chunk
        events = [json.loads(line[6:]) for line in raw.split(b"\n")
                  if line.startswith(b"data: ")]
        assert events[-1]["finished"]
        assert events[-1]["tokens_generated"] == 5
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
        log = proc.stderr.read()
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    assert '"event": "drain_done", "unfinished": 0' in log
    assert '"event": "launcher_exit", "code": 0' in log
    # the server child reports its kernel launches as it exits (none on the
    # CPU, where the wrappers run their plain versions)
    exit_ = [json.loads(line) for line in log.splitlines()
             if '"event": "server_exit"' in line]
    assert exit_ and exit_[-1]["code"] == 0
    assert exit_[-1]["kernel_launches"] == {
        "flash_attention": 0, "kv_copy": 0, "paged_attention": 0,
        "paged_attention_int8": 0}
