"""Mean device time of the FPN, the FCOS tower and head, and the locations,
a replay: the program's section stamps (``%globaltimer`` written from
inside the CUDA graph, ``centermask2_tpu_torch/utils/tracing.py``), over
every row of the ring, the window's replays among them. None where the
program has no stamps."""


def read(rec):
    try:
        from centermask2_tpu_torch.utils import tracing
    except ImportError:  # a program without the section stamps
        return None
    return tracing.section_mean_ms("fpn_head")
