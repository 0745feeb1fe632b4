"""output_tok_s: output tokens delivered to the clients inside the window,
over the window's seconds."""


def read(rec):
    n = sum(1 for _ in rec.tokens(rec.w0, rec.w1))
    return n / rec.window_s
