"""The model's FLOPs (convolutions and matrix products, counted once a
canvas in set-up) over the replays' device time, as a share of the
card's bf16 peak."""


def read(rec):
    if rec.peaks is None or rec.flops is None or not len(rec.replay_ms):
        return None
    seconds = float(rec.replay_ms.sum()) * 1e-3
    return 100.0 * float(rec.flops.sum()) / seconds / rec.peaks.bf16
