"""Seconds of set-up spent capturing the CUDA graphs, their eager warm-ups
included: the program's counter ``capture_s``
(``centermask2_tpu_torch/utils/tracing.py``, added by
``export/captured.py::CapturedInference``). None where the program has
no such counter or counted nothing."""


def read(rec):
    try:
        from centermask2_tpu_torch.utils import tracing
    except ImportError:  # a program without the counters
        return None
    return tracing.counter("capture_s")
