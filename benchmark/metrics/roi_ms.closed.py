"""Mean device time of the ROI heads (kernel 2, SAG-Mask, MaskIoU) and the
outputs' assembly, a replay: the program's section stamps
(``%globaltimer`` written from inside the CUDA graph,
``centermask2_tpu_torch/utils/tracing.py``), over every row of the ring,
the window's replays among them. None where the program has no stamps."""


def read(rec):
    try:
        from centermask2_tpu_torch.utils import tracing
    except ImportError:  # a program without the section stamps
        return None
    return tracing.section_mean_ms("roi")
