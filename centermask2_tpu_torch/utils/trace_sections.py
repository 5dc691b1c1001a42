"""Pipeline-section buckets for device-trace attribution (the port's copy
of ``centermask2_tpu/utils/trace_sections.py``).

Maps the module path of an op, as ``tools/profile_model.py`` records it,
to a pipeline section. Shared by ``tools/profile_model.py`` (the section
rollup) and ``tools/roofline_bound.py`` (the bound table), so both
bucket a trace alike.

A path is the scopes an op ran in, joined by ``/``, outermost first, as
JAX's name stack reads: the model's methods (``CenterMask.inference``,
``CenterMask.features``, ``CenterMask._fcos_raw``, ``CenterMask._decode``,
``CenterMask.loss``, the ROI heads' ``roi_heads.pool``,
``roi_heads.mask_forward_train``, ...), each module by its attribute name
(``backbone``, ``OSA2_1``, ``layer0``, ``conv``), and ``optimizer`` for
the SGD update, e.g. ``CenterMask.inference/CenterMask.features/backbone/
OSA2_1/layer0/conv``. An op of the backward has its forward op's path
behind ``transpose/`` (JAX's ``transpose(jvp(...))``), and its section
gets the `` [bwd]`` suffix.

A graph replay carries no module paths, so ``SECTIONS`` cannot bucket its
kernels. ``REPLAY_SECTIONS`` are the five spans that the section stamps
of a captured serving program time instead (``utils/tracing.py``), each
one or more of the eager sections above:

- ``stem``: ``host/normalize+s2d`` and the backbone's stem;
- ``backbone``: the rest of ``backbone``;
- ``fpn_head``: ``fpn`` and ``fcos_head``;
- ``decode``: ``decode+nms``;
- ``roi``: ``roi+mask+maskiou``, ``keypoint`` and the outputs' assembly.
"""

from __future__ import annotations

SECTIONS = (
    ("host/normalize+s2d", ("CenterMask._normalize_u8_s2d",
                            "CenterMask._pad_to_canvas")),
    ("backbone", ("CenterMask.features/backbone",)),
    ("fpn", ("CenterMask.features/fpn",)),
    ("fcos_head", ("CenterMask._fcos_raw", "fcos_head")),
    ("decode+nms", ("CenterMask._decode",)),
    ("roi+mask+maskiou", ("roi_heads", "mask_head", "maskiou_head")),
    ("keypoint", ("keypoint_head",)),
    ("losses/assign", ("CenterMask.loss", "CenterMask._mask_losses")),
    ("optimizer", ("optimizer",)),
)


REPLAY_SECTIONS = ("stem", "backbone", "fpn_head", "decode", "roi")


def section_of(path: str, unmatched: str = "(unattributed)") -> str:
    """Section label for a module path; backward ops (under the
    ``transpose/`` prefix of a train trace) get a `` [bwd]`` suffix so
    fwd-vs-bwd efficiency stays visible per section."""
    for name, keys in SECTIONS:
        if any(k in path for k in keys):
            return name + (" [bwd]" if "transpose" in path else "")
    return unmatched
