"""Fixed-shape export (the port of ``centermask2_tpu/export/aot.py``, the
counterpart of the reference's ``convert_model_into_onnx.py``).

``export_serialized`` traces ``model.inference`` at one input shape with
``torch.export`` and saves the program with its weights inside as a
``.pt2`` file: the f32 program ``callable(images)``, or with
``input_dtype=torch.uint8`` the serving program ``callable(images_u8,
valid_hw)`` over the raw s2d pack, with ``canvas_hw`` when the pack is a
tight canvas that the program pads back. The hand kernels stay in the
graph as the registered operators ``cm2::nms_keep_sorted`` and
``cm2::roi_align``, so ``load_serialized`` needs this package's ``ops``
(imported here) but no model object, config or weights file. The output
is the model's ``InferenceOutputs``, registered for serialization below
as ``register_namedtuple_serialization`` registers it in the JAX package.

``compile_inference`` is the counterpart of XLA's ahead-of-time compile:
the captured program (``captured.py``) with its graph recorded, and a
cost dict with the FLOPs of one call.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.utils._pytree as pytree
from torch import nn

from .. import ops  # noqa: F401  (registers the cm2:: operators)
from ..models.meta import InferenceOutputs
from ..utils.measures import count_flops
from .captured import CapturedInference

if InferenceOutputs not in pytree.SUPPORTED_NODES:
    pytree._register_namedtuple(
        InferenceOutputs,
        serialized_type_name="centermask2_tpu_torch.InferenceOutputs")


class _Program(nn.Module):
    """``model.inference`` at a fixed canvas, as the module to export."""

    def __init__(self, model, canvas_hw: Optional[Tuple[int, int]]):
        super().__init__()
        self.model = model
        self.canvas_hw = canvas_hw

    def forward(self, images: torch.Tensor,
                valid_hw: Optional[torch.Tensor] = None) -> InferenceOutputs:
        return self.model.inference(images, None, valid_hw, self.canvas_hw)


def _example_inputs(model, input_shape: Tuple[int, ...],
                    input_dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    """Zero inputs of the program's signature on the model's device:
    (images,), or (images_u8, valid_hw) for a uint8 program."""
    dev = next(model.parameters()).device
    x = torch.zeros(input_shape, dtype=input_dtype, device=dev)
    if input_dtype == torch.uint8:
        return x, torch.zeros((input_shape[0], 2), dtype=torch.int32,
                              device=dev)
    return (x,)


def export_serialized(model, input_shape: Tuple[int, ...], path: str, *,
                      input_dtype: torch.dtype = torch.float32,
                      canvas_hw: Optional[Tuple[int, int]] = None) -> str:
    """Export the inference function (weights inside) at ``input_shape``
    to ``path`` (``.pt2``); returns the path."""
    with torch.no_grad():
        program = torch.export.export(
            _Program(model, canvas_hw),
            _example_inputs(model, input_shape, input_dtype))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    torch.export.save(program, path)
    return path


def load_serialized(path: str) -> Callable:
    """A saved artifact -> ``callable(images)`` or ``callable(images_u8,
    valid_hw)`` returning ``InferenceOutputs``, on the device it was
    exported on."""
    program = torch.export.load(path).module()

    def call(*args):
        with torch.no_grad():
            return program(*args)

    return call


def inference_flops(model, input_shape: Tuple[int, ...], *,
                    input_dtype: torch.dtype = torch.float32,
                    canvas_hw: Optional[Tuple[int, int]] = None) -> int:
    """FLOPs of one call, counted by ``utils/measures.py::count_flops``
    over one run: the convolutions and matrix products (two per
    multiply-add), which is where XLA's count of the JAX program also
    lies."""
    x, *hw = _example_inputs(model, input_shape, input_dtype)
    return count_flops(model, model.inference, x, None,
                       hw[0] if hw else None, canvas_hw)


def compile_inference(model, input_shape: Tuple[int, ...], *,
                      input_dtype: torch.dtype = torch.float32,
                      canvas_hw: Optional[Tuple[int, int]] = None,
                      graphs=None) -> Tuple[Callable, Dict[str, float]]:
    """(the captured program with its graph for ``input_shape`` recorded,
    ``{"flops": ...}``). The program is called as ``model.inference``;
    CUDA only (``CapturedInference`` raises on a CPU model)."""
    cost = {"flops": float(inference_flops(
        model, input_shape, input_dtype=input_dtype, canvas_hw=canvas_hw))}
    program = CapturedInference(model, graphs=graphs)
    x, *hw = _example_inputs(model, input_shape, input_dtype)
    program(x, None, hw[0] if hw else None, canvas_hw)
    return program, cost
