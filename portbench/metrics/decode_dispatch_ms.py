"""decode_dispatch_ms: host milliseconds to dispatch one batched decode
iteration (every layer's launches)."""


def read(rec):
    n = rec.delta("decode_batches")
    if n <= 0:
        return None
    return rec.delta("decode_launch_wall_s") / n * 1e3
