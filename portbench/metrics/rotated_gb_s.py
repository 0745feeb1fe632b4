"""rotated_gb_s: KV rows moved between the card and the host tier, both
ways, in GB per second of the span: the store's row counts times the
row's bytes, which the configuration's sizes give."""


def read(rec):
    rows = rec.delta("d2h_rows") + rec.delta("h2d_rows")
    return rows * rec.dims.row_bytes / (rec.span[1] - rec.span[0]) / 1e9
