"""paged_roofline_pct: least time of the decode attention work in the traced
span, over the device time of the paged-attention kernels there. The work
is the decode tokens the clients received in the span, each at its context
length (``costs.decode_attention_work``)."""
from portbench import costs

KERNEL = "paged_"


def read(rec):
    t = rec.trace
    if t is None:
        return None
    dev = sum(s for name, s in t.kernel_s.items() if KERNEL in name)
    flops = nbytes = 0.0
    for r, k, _ in rec.tokens(t.t0, t.t1):
        if k > 0:
            f, b = costs.decode_attention_work(rec.dims, r.prompt_len + k)
            flops, nbytes = flops + f, nbytes + b
    if dev <= 0 or flops <= 0:
        return None
    return 100.0 * costs.least_seconds(flops, nbytes) / dev
