"""prefill_dispatch_ms: host milliseconds to dispatch one prefill chunk."""


def read(rec):
    n = rec.delta("prefill_chunks_run")
    if n <= 0:
        return None
    return rec.delta("prefill_launch_wall_s") / n * 1e3
