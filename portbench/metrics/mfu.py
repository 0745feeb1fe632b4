"""mfu: the model's useful FLOPs over the span, against the card's bf16
peak. The work is what the clients observed: each prompt whose first token
came in the span is charged its whole prefill, each later token its decode
step at its context length (``costs.py``)."""
from portbench import costs


def read(rec):
    a, b = rec.span
    flops = 0.0
    for r, k, _ in rec.tokens(a, b):
        flops += (costs.prefill_model_flops(rec.dims, r.prompt_len) if k == 0
                  else costs.decode_model_flops(rec.dims, r.prompt_len + k))
    return 100.0 * flops / ((b - a) * costs.H100_PEAK_BF16_FLOPS)
