"""engine_iter_ms: wall milliseconds per engine iteration (iterations that
scheduled work), over the span the counters were read."""


def read(rec):
    n = rec.delta("iterations")
    if n <= 0:
        return None
    return (rec.span[1] - rec.span[0]) / n * 1e3
