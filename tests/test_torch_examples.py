"""The port's examples under ``examples/torch/`` on the CPU.

- ``client_streaming.py`` and ``serve_slo_comparison.py`` run the host
  layer on the GH200 model's clock, a copy of the reference's: each prints
  exactly what the reference's example prints, both run in subprocesses
  (the comparison at 10 s of trace, to keep it short).
- ``serve_small_real.py --device cpu`` serves the reduced llama3-8b through
  ``RealExecutor`` with 4096 and with 16 HBM blocks, rotating in the
  second, and prints "lossless ✓".
- ``client_http.py`` streams against the port's ``server_main`` on the CPU
  and sees the abandoned stream's ``aborted_on_disconnect`` tick.
"""
import asyncio
import importlib.util
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import pytest

pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]


def env(**extra):
    return dict(os.environ, JAX_PLATFORMS="cpu", **extra,
                PYTHONPATH=os.pathsep.join(
                    p for p in (str(ROOT / "src"),
                                os.environ.get("PYTHONPATH")) if p))


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, ROOT / "examples" / "torch" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("name,args", [
    ("client_streaming", []),
    ("serve_slo_comparison", ["--duration", "10"])])
def test_sim_examples_print_the_reference_report(name, args):
    out = {}
    for where in ("examples", "examples/torch"):
        proc = subprocess.run(
            [sys.executable, str(ROOT / where / f"{name}.py"), *args],
            cwd=ROOT, env=env(), capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr[-3000:]
        out[where] = proc.stdout
    assert out["examples/torch"] == out["examples"]
    assert len(out["examples"].splitlines()) >= 5


def test_serve_small_real_on_cpu(capsys):
    streams = load_example("serve_small_real").main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "lossless ✓" in out
    assert "[tight memory (forced rotation)] rotations=0" not in out
    assert len(streams) == 8 and all(streams.values())


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_client_http_against_server_main(capsys):
    port = free_port()
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.server_main", "--device",
         "cpu", "--port", str(port)], cwd=ROOT, env=env(),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 60
        while True:
            try:
                socket.create_connection(("127.0.0.1", port),
                                         timeout=5).close()
                break
            except OSError:
                assert proc.poll() is None, proc.stderr.read()
                assert time.monotonic() < deadline, "server never listened"
                time.sleep(0.1)
        client = load_example("client_http")
        assert asyncio.run(client.main(["--port", str(port)])) == 0
    finally:
        proc.terminate()
        try:
            proc.wait(60)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        proc.stderr.close()
    out = capsys.readouterr().out
    assert "[A] finished:" in out and "reason=length" in out
    assert "[B] hung up after" in out
    assert "aborted_on_disconnect=1 " in out, out
