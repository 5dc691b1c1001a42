"""Seconds of set-up spent in ``build_centermask`` (the model made with its
initializers and moved to the card): the program's counter
``model_build_s`` (``centermask2_tpu_torch/utils/tracing.py``). None
where the program has no such counter or counted nothing."""


def read(rec):
    try:
        from centermask2_tpu_torch.utils import tracing
    except ImportError:  # a program without the counters
        return None
    return tracing.counter("model_build_s")
