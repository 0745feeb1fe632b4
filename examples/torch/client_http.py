"""``python -m repro_torch.launch.server_main --port 8711`` starts a
server of the PyTorch port (on the CUDA card; add ``--device cpu`` to run
it on the CPU), or ``python -m repro_torch.serving.server --config-json
'{"port": 8711, "device": "cpu"}'`` its server alone; then::

    python examples/torch/client_http.py --port 8711

The HTTP streaming client against it, the port of
``examples/client_http.py``. It opens two concurrent streams over
``POST /v1/generate``: the first is consumed to completion, the second is
*abandoned* mid-stream by closing the socket; the server notices the
disconnect and aborts the request on the engine, freeing its HBM/DRAM
blocks (``aborted_on_disconnect`` ticks in ``GET /v1/metrics``, printed at
the end).

Stdlib only, like the server: raw asyncio sockets, hand-parsed chunked
SSE events.
"""
import argparse
import asyncio
import json
import sys


async def read_events(reader):
    """Yield decoded ``data: {...}`` events from a chunked SSE response."""
    buf = b""
    # skip response head
    while b"\r\n\r\n" not in buf:
        chunk = await reader.read(4096)
        if not chunk:
            return
        buf += chunk
    head, buf = buf.split(b"\r\n\r\n", 1)
    status = head.split(b"\r\n", 1)[0].decode()
    if " 200 " not in status + " ":
        raise RuntimeError(f"server said: {status}; body={buf.decode()!r}")
    while True:
        while b"data: " in buf and b"\n\n" in buf:
            s = buf.index(b"data: ")
            try:
                e = buf.index(b"\n\n", s)
            except ValueError:
                break
            yield json.loads(buf[s + 6:e])
            buf = buf[e + 2:]
        chunk = await reader.read(4096)
        if not chunk:
            return
        buf += chunk


async def generate(host, port, payload):
    body = json.dumps(payload).encode()
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(b"POST /v1/generate HTTP/1.1\r\n"
                 b"Host: %b\r\nContent-Type: application/json\r\n"
                 b"Content-Length: %d\r\n\r\n%b"
                 % (host.encode(), len(body), body))
    await writer.drain()
    return reader, writer


async def full_stream(host, port, tag, payload):
    """Consume a stream to completion, printing progress."""
    reader, writer = await generate(host, port, payload)
    n = 0
    try:
        async for evt in read_events(reader):
            n += evt["new_tokens"]
            if evt["finished"]:
                print(f"[{tag}] finished: {evt['tokens_generated']} tokens, "
                      f"reason={evt['finish_reason']}, "
                      f"ttft={evt['ttft_s']:.3f}s" if evt.get("ttft_s")
                      else f"[{tag}] finished: reason={evt['finish_reason']}")
                return evt
            if n and n % 8 == 0:
                print(f"[{tag}] ... {evt['tokens_generated']} tokens")
    finally:
        writer.close()


async def abandoned_stream(host, port, tag, payload, after_tokens):
    """Read a few events, then hang up mid-stream (client disconnect)."""
    reader, writer = await generate(host, port, payload)
    got = 0
    async for evt in read_events(reader):
        got = evt["tokens_generated"]
        if got >= after_tokens:
            break
    writer.close()                      # <-- the "disconnect"
    try:
        await writer.wait_closed()
    except ConnectionError:
        pass
    print(f"[{tag}] hung up after {got} tokens "
          f"(server aborts + frees the KV blocks)")
    return got


async def fetch_json(host, port, path):
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(b"GET %b HTTP/1.1\r\nHost: %b\r\n\r\n"
                 % (path.encode(), host.encode()))
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return json.loads(raw.split(b"\r\n\r\n", 1)[1])


async def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8711)
    args = ap.parse_args(argv)

    health = await fetch_json(args.host, args.port, "/healthz")
    print(f"server up: {health}")

    finished, hung_up = await asyncio.gather(
        full_stream(args.host, args.port, "A",
                    {"prompt_len": 256, "max_tokens": 32,
                     "slo_class": "interactive"}),
        abandoned_stream(args.host, args.port, "B",
                         {"prompt_len": 512, "max_tokens": 512,
                          "slo_class": "standard"}, after_tokens=4),
    )
    assert finished["finished"] and finished["finish_reason"] == "length"
    assert hung_up >= 4

    await asyncio.sleep(0.5)            # let the abort land
    metrics = await fetch_json(args.host, args.port, "/v1/metrics")
    srv = metrics.get("server", {})
    print(f"metrics: streams_started={srv.get('streams_started')} "
          f"aborted_on_disconnect={srv.get('aborted_on_disconnect')} "
          f"engine_steps={srv.get('engine_steps')}")
    print(f"attainment so far: ttft={metrics.get('ttft_attainment')} "
          f"tbt={metrics.get('tbt_attainment')}")
    return 0


if __name__ == "__main__":
    sys.exit(asyncio.run(main()))
