"""Median host span of the queueing of a request's outputs' copy into
pinned host buffers (``evaluation/loop.py::_to_host``): the program's
span ``to_host`` (``centermask2_tpu_torch/utils/tracing.py``), recorded
while the traced slice's profiler runs, on the host's clock. None where
the program has no such span."""


def read(rec):
    try:
        from centermask2_tpu_torch.utils import tracing
    except ImportError:  # a program without the spans
        return None
    return tracing.span_median_ms("to_host")
