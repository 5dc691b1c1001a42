"""Weights prepared once per set of weights, for the captured serving
program.

On the plain path every conv and linear casts its float32 parameters to
the compute dtype on each call, and a ``ConvNormAct`` with FrozenBN runs
its conv, then ``x * scale + bias`` as two more passes over the map. A
CUDA graph replays all of that on every request. ``PreparedWeights``
holds, for each module of a model that reads it, the tensors that work
is for, computed from the parameters once:

- ``Conv2d``, ``ConvTranspose2d``, ``Linear``: weight and bias in the
  compute dtype, the conv weight in the memory format its input comes in
  (channels-last in the FCOS towers on the card);
- ``ConvNormAct`` with ``FrozenBatchNorm``: the norm folded into the conv,
  ``w * s`` and ``b_conv * s + b`` (or ``b``), computed in float32 and
  rounded to the compute dtype once; the forward is then the conv with
  that bias and, where a ReLU follows, the conv with its whole epilogue
  in one call (``ops/conv_bias_act.py``; a ResNet bottleneck's ``conv3``
  adds its shortcut there too);
- the VoVNet's s2d stem: its zero-embedded kernels with the three
  FrozenBN scales folded in and the biases as the convs' biases, each
  conv with its epilogue in one call.

On CUDA the served trunk and FPN run channels-last (``channels_last``):
the model keeps its NHWC input's layout, cuDNN's, so no conv transposes
its input or its output, and each module reads a weight prepared for
the format its input comes in.

Only ``export/captured.py::CapturedInference`` reads the store: its
warm-ups and captures run inside ``serving()``, and a module reads its
prepared tensors only there and with autograd off (``weights``). Every
other path (eager inference, training, ``torch.export``, the FLOP
count, the layer dump) runs the plain chain. The store is made at the
first call inside ``serving()``, each entry at its module's first call
(a detached copy of what ``prepare_weights`` returns), never while
``capturing``: a module that meets a new input format during a capture
raises, so nothing is allocated inside a graph. ``refresh()`` (once per
request, before the replay) compares each source tensor's data pointer
and version counter with the last set prepared and, where one moved,
recomputes every entry in place: the graphs read the same storage and
see the new weights with no recapture.

Counters (``utils/tracing.py::count``): ``weights_prepared`` +1 for each
set of weights prepared (the first, and each refresh after a change);
``prepared_convs`` +1 for each conv or linear served from the store (the
s2d stem counts its three convs); ``folded_norms`` +1 for each FrozenBN
folded; ``fused_convs`` +1 for each conv the store serves through
``conv_bias_act`` (the s2d stem counts its four calls), each counted at
its entry.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from ..utils import tracing

_active = None  # (thread, store, capturing) inside ``serving()``


def active() -> Optional["PreparedWeights"]:
    """The store the modules read on this thread: inside ``serving()``
    with autograd off, else None (the plain chain)."""
    a = _active
    if a is None or a[0] != threading.get_ident() or \
            torch.is_grad_enabled():
        return None
    return a[1]


def channels_last(x: torch.Tensor) -> bool:
    """Whether the served trunk and FPN take the map ``x`` channels-last:
    a CUDA map (cuDNN's NHWC kernels) with the store active."""
    return x.is_cuda and active() is not None


def is_channels_last(x: torch.Tensor) -> bool:
    """Whether a 4-d map is laid out channels-last (and not also NCHW)."""
    return x.dim() == 4 and not x.is_contiguous() and \
        x.is_contiguous(memory_format=torch.channels_last)


def weights(module: nn.Module, fmt=None) -> Tuple[torch.Tensor, ...]:
    """``module``'s tensors for input format ``fmt``: the store's inside
    ``serving()`` (``active``), else ``module.prepare_weights(fmt)``, the
    plain chain's, computed on this call."""
    store = active()
    if store is None:
        return module.prepare_weights(fmt)
    return store.get(module, fmt)


class PreparedWeights:
    """The prepared tensors of ``model``'s modules (the module
    docstring). A module that takes part has ``prepare_weights(fmt)``,
    which returns its tensors for the input format ``fmt`` (the store
    keeps a detached copy of each), ``prepared_sources()``, the
    parameters and buffers they are computed from, and
    ``prepared_counts``, the (convs, folded norms) it stands for; the
    module says at ``get`` how many of its convs run through
    ``conv_bias_act``."""

    def __init__(self, model: nn.Module):
        seen, sources = set(), []
        for m in model.modules():
            if hasattr(m, "prepare_weights"):
                for t in m.prepared_sources():
                    if id(t) not in seen:
                        seen.add(id(t))
                        sources.append(t)
        self.sources: List[torch.Tensor] = sources  # built once
        self.entries: Dict[Tuple[nn.Module, object],
                           Tuple[torch.Tensor, ...]] = {}
        self.key = None
        self.convs = 0
        self.folded = 0
        self.fused = 0

    def _key(self):
        return [(t.data_ptr(), t._version) for t in self.sources]

    def refresh(self) -> bool:
        """Recompute every entry in place if a source changed since the
        last set prepared (the first call starts a set). Outside any
        capture. Returns whether a set was started."""
        key = self._key()
        if key == self.key:
            return False
        with torch.no_grad():
            for (m, fmt), dst in self.entries.items():
                for d, s in zip(dst, m.prepare_weights(fmt)):
                    if d is not None:
                        d.copy_(s)
        self.key = key
        tracing.count("weights_prepared", 1)
        return True

    def get(self, module: nn.Module, fmt=None,
            fused: int = 0) -> Tuple[torch.Tensor, ...]:
        """``module``'s tensors for input format ``fmt``, made at its
        first call outside a capture; ``fused``: how many of its convs
        run through ``conv_bias_act`` on them."""
        e = self.entries.get((module, fmt))
        if e is not None:
            return e
        a = _active
        if a is not None and a[1] is self and a[2]:
            raise RuntimeError(
                f"{type(module).__name__} met input format {fmt!r} during a "
                "capture with no prepared weights for it: the warm-up "
                "before the capture runs every format first")
        with torch.no_grad():  # the entry owns its storage
            e = tuple(None if t is None else t.detach().clone()
                      for t in module.prepare_weights(fmt))
        self.entries[(module, fmt)] = e
        convs, folded = module.prepared_counts
        self.convs += convs
        self.folded += folded
        tracing.count("prepared_convs", convs)
        if folded:
            tracing.count("folded_norms", folded)
        if fused:
            self.fused += fused
            tracing.count("fused_convs", fused)
        return e

    @contextmanager
    def serving(self, capturing: bool = False):
        """The modules read this store on this thread inside the block;
        ``capturing``: no entry may be made there."""
        global _active
        prev = _active
        _active = (threading.get_ident(), self, capturing)
        try:
            yield self
        finally:
            _active = prev


def fold_frozen_bn(weight: torch.Tensor, bias: Optional[torch.Tensor],
                   scale: torch.Tensor, shift: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``conv(x, w) * s + b`` as ``conv(x, w * s) + (b_conv * s + b)``, in
    float32: (weight, bias) for a conv of weight (O, ...) and output
    channels scaled by ``scale``, shifted by ``shift``."""
    s = scale.float()
    w = weight.float() * s.reshape((-1,) + (1,) * (weight.dim() - 1))
    b = shift.float() if bias is None else bias.float() * s + shift.float()
    return w, b
