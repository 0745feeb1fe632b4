"""setup_s: process start to the first due arrival of the warm traffic."""


def read(rec):
    return rec.setup_s
