"""Data-parallel batched inference over the ranks of a process group (the
port of ``centermask2_tpu/parallel/serve.py``).

JAX shards a global batch over its ``data`` mesh and runs the single-image
program on each device's rows (``CenterMask.inference_batched`` under
``shard_map``), the outputs keeping the global batch dimension. Here each
rank runs its rows of the global batch, through ``inference_batched`` or,
on CUDA, one ``CapturedInference`` replay an image, and ``all_gather``s
the fixed-shape outputs back into the global batch, so that every rank
returns every slot, in the batch's order. The request itself takes no
collective; the gather is the one.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..export.captured import CapturedInference, supports_graphs
from ..models.meta import CenterMask, InferenceOutputs, per_image
from ..utils.comm import Group, all_gather_cat, world_group
from .mesh import local_rows


def make_dp_inference(model: CenterMask, group: Group = None):
    """Returns ``infer(images, image_sizes=None, valid_hw=None) ->
    InferenceOutputs`` over a global batch whose size the group's size
    divides (``group``: the default process group unless given; one
    process without one). ``image_sizes`` defaults to the padded canvas
    (``default_image_sizes``); ``valid_hw`` normalizes a RAW uint8 s2d
    input and defaults to the full canvas. On CUDA each image replays a
    ``CapturedInference`` of the model; on the CPU the rows run through
    ``inference_batched``."""
    group = world_group() if group is None else group
    fn = CapturedInference(model) \
        if supports_graphs(next(model.parameters()).device) else None

    def replay(*args):  # a replay's outputs are the graph's buffers
        return InferenceOutputs(*(None if v is None else v.clone()
                                  for v in fn(*args)))

    def run_local(images, image_sizes, valid_hw):
        if fn is None:
            return model.inference_batched(images, image_sizes, valid_hw)
        return per_image(replay, images, image_sizes, valid_hw)

    def infer(images: torch.Tensor,
              image_sizes: Optional[torch.Tensor] = None,
              valid_hw: Optional[torch.Tensor] = None) -> InferenceOutputs:
        image_sizes = default_image_sizes(model, images, image_sizes)
        rows = local_rows(images.shape[0], group)
        out = run_local(images[rows], image_sizes[rows],
                        None if valid_hw is None else valid_hw[rows])
        return InferenceOutputs(*(None if v is None else
                                  all_gather_cat(v, group) for v in out))

    return infer


def default_image_sizes(model: CenterMask, images: torch.Tensor,
                        image_sizes: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """(B, 2) float true (h, w); defaults to the padded canvas (the
    FakeImageList contract), undoing the s2d input layout."""
    if image_sizes is not None:
        return torch.as_tensor(image_sizes, dtype=torch.float32,
                               device=images.device)
    H, W = model.canvas_hw(images)
    return torch.tensor([[H, W]], dtype=torch.float32,
                        device=images.device).expand(images.shape[0], 2)
