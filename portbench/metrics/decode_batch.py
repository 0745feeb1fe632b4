"""decode_batch: sequences in a batched decode launch, on average: the
paged runner's decode tokens over its decode batches."""


def read(rec):
    n = rec.delta("decode_batches")
    if n <= 0:
        return None
    return rec.delta("decode_tokens") / n
