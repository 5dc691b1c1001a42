"""Median host span of the native s2d pack of a request
(``data/preprocess.py::s2d_pack_u8``): the program's span ``pack``
(``centermask2_tpu_torch/utils/tracing.py``), recorded while the traced
slice's profiler runs, on the host's clock. None where the program has
no such span."""


def read(rec):
    try:
        from centermask2_tpu_torch.utils import tracing
    except ImportError:  # a program without the spans
        return None
    return tracing.span_median_ms("pack")
