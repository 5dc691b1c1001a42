"""Kernel 1 (``cm2::nms_keep_sorted``: ``nms_mask_kernel`` then
``nms_scan_kernel``) against its roofline: the least time its call's
shapes need (``benchmark/harness/flops.py::nms_cost`` over the f32 and
HBM peaks) over its device time a call in the traced slice, averaged
over the kernel rows found."""

from benchmark.harness.flops import nms_cost, vector_bound_s


def read(rec):
    if rec.trace is None or rec.peaks is None:
        return None
    k = rec.trace.kernels
    scan = [v for n, v in k.items() if "nms_scan_kernel" in n]
    mask = [v for n, v in k.items() if "nms_mask_kernel" in n]
    calls = sum(c for c, _ in scan)
    if not calls or not mask:
        return None
    seconds = (sum(s for _, s in scan) + sum(s for _, s in mask)) / calls
    ops, nbytes = nms_cost(*rec.nms_shape)
    return 100.0 * vector_bound_s(rec.peaks, ops, nbytes) / seconds
