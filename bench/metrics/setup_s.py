"""Set-up: process start to the window's start, less the readings taken for
the check (host clock)."""


def read(rec):
    return rec.setup_s
