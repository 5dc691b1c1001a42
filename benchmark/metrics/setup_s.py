"""Set-up: seconds from process start to the start of the window
(the benchmark's host clock)."""


def read(rec):
    return rec.setup_s
