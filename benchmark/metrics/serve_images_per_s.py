"""Requests done (outputs on the host) inside the window, over the
window (the benchmark's host clock)."""


def read(rec):
    return rec.completed / rec.window_s if rec.window_s > 0 else None
