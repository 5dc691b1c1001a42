"""Share of the window in which the device ran no request: one minus the
requests' device time (CUDA events from the copy in to the copy out)
over the wall time from the window's start to the last request done."""


def read(rec):
    if rec.span_s <= 0 or not len(rec.busy_ms):
        return None
    return 100.0 * (1.0 - float(rec.busy_ms.sum()) * 1e-3 / rec.span_s)
