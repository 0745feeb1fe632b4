"""row_move_share: share of the span's wall the host spent in row movement
(row-copy launches, readbacks to the host tier, uploads)."""


def read(rec):
    s = rec.delta("copy_launch_wall_s") + rec.delta("upload_launch_wall_s")
    return 100.0 * s / (rec.span[1] - rec.span[0])
