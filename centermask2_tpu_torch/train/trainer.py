"""The training step and loop (the port of
``centermask2_tpu/train/trainer.py`` and of the loop body of the
repository's ``tools/train_net.py``): one process on one device, or one
rank of a data-parallel process group, each rank on its own device.

``make_train_step`` returns the step: the losses of ``CenterMask.loss``,
their sum's backward, the clipped SGD update and the schedule's step,
with no host sync; the metrics come back as device tensors. On CUDA the
step is captured whole into one CUDA graph (``CapturedTrainStep``), the
counterpart of the JAX package's one jitted step: its first
``WARMUP_STEPS`` calls run eagerly on a side stream (cuDNN's choices,
the kernels' first use, SGD's momentum buffers), the next one records
the graph, and every call replays it. The tensors of the capturing call
(the batch and the sampler's uniforms) are the graph's inputs: a later
call with other tensors copies them in, and without uniforms of its own
draws them in place with ``torch.rand(..., generator=, out=)``, the
same draw in the same order as the eager step's, so the random stream
is the same. Every field of the ``GroundTruth`` that is not None (a
keypoint model's ``keypoints`` among them) is a graph input. ``train_loop`` passes the same device buffers every step,
so nothing is copied twice. The model's parameters, the momentum
buffers and the schedule's count are updated in place by every replay,
which then bumps the parameters' version counters as an eager step's
in-place update does (a ``CapturedInference`` of the model refreshes its
prepared weights by them); ``restore_train_state`` writes a checkpoint into those same tensors, so
the graph stays valid across a restore. ``train_loop`` feeds the step
host batches (``data/coco.py::train_batches``) through pinned and
device buffers that it reuses, and is the loop both
``tools/train_net.py`` and ``chip_smoke.py`` run.

With a process ``group`` the step is the JAX ``shard_map`` step
(``trainer.py:47-115``) as ranks: each rank's loss averages the FCOS
normalizers (and SyncBN's moments) over the group, and after the backward
one all-reduce sums a flat buffer holding every gradient (the ``counted``
frozen leaves' among them), the plain BN running statistics and the
losses, which is then divided by the world size: JAX's ``pmean`` of the
gradients, the losses, ``total_loss`` and the ``batch_stats``. SyncBN's
statistics are global already and stay out of the buffer. The buffer is
allocated at the first step and reused, so that a captured step reads and
writes fixed addresses; on NCCL the all-reduce is captured with the step
(the warm-up steps run the first collective, which sets up the
communicator). On gloo the step runs eagerly: the caller passes
``capture=False``, and ``capture=True`` raises. Every rank must start from
the same parameters (``parallel/mesh.py::replicate``) and draw the same
sampler uniforms (a generator seeded alike on every rank), as JAX hands
every replica the same key.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
from torch.autograd.graph import increment_version

from ..export.captured import CudaGraphs, supports_graphs
from ..layers import BatchNorm
from ..models.meta import CenterMask, GroundTruth
from ..utils.comm import Group, all_reduce_sum_, is_gloo, world_size

Metrics = Dict[str, torch.Tensor]
StepFn = Callable[..., Metrics]

# eager steps before a CUDA step is captured; at least one, so that the
# graph records the momentum buffers' update and not their creation
WARMUP_STEPS = 3


class _Pmean:
    """The cross-rank mean of a step (the module docstring): one flat
    buffer of the gradients, the plain BN running statistics and the
    losses, summed over ``group`` in one all-reduce and divided by the
    world size. The buffer is allocated at the first call and reused."""

    def __init__(self, model: CenterMask, optimizer, group: Group):
        self.group = group
        self.world = world_size(group)
        self.params = [p for g in optimizer.param_groups for p in g["params"]]
        self.params += list(getattr(optimizer, "counted", ()))
        self.stats = [t for m in model.modules()
                      if isinstance(m, BatchNorm) and not m.sync
                      for t in (m.bn.mean, m.bn.var)]
        self.flat = None
        self.views = None

    def __call__(self, losses: torch.Tensor) -> torch.Tensor:
        grads = [p.grad for p in self.params if p.grad is not None]
        parts = grads + self.stats + [losses]
        if self.flat is None:
            if any(t.dtype != torch.float32 for t in parts):
                raise TypeError("the data-parallel step reduces float32 "
                                "gradients, statistics and losses")
            self.flat = torch.empty(sum(t.numel() for t in parts),
                                    dtype=torch.float32, device=losses.device)
            self.views = [v.view_as(t) for v, t in zip(
                self.flat.split([t.numel() for t in parts]), parts)]
        elif len(parts) != len(self.views):
            raise RuntimeError("the set of gradients changed between steps")
        torch._foreach_copy_(self.views, parts)
        all_reduce_sum_(self.flat, self.group)
        self.flat.div_(self.world)
        torch._foreach_copy_(parts[:-1], self.views[:-1])
        return self.views[-1]


def _step_body(model: CenterMask, optimizer, scheduler, group: Group = None):
    """One update from given draws: ``(images, gt, draws) -> metrics``.
    BN and SyncBN train in train mode for the loss (JAX applies with
    ``batch_stats`` mutable); the model's mode is put back after it."""
    pmean = _Pmean(model, optimizer, group) if group is not None else None

    def body(images: torch.Tensor, gt: GroundTruth,
             draws: Optional[torch.Tensor]) -> Metrics:
        optimizer.zero_grad(set_to_none=True)
        was_training = model.training
        model.train()  # through the backward, which may recompute (remat)
        try:
            losses = model.loss(images, gt, draws=draws, group=group)
            total = sum(losses.values())
            total.backward()
        finally:
            model.train(was_training)
        values = torch.stack([*losses.values(), total]).detach()
        if pmean is not None:  # a copy: the buffer is the next step's
            values = pmean(values).clone()
        optimizer.step()
        scheduler.step()
        metrics = dict(zip([*losses, "total_loss"], values.unbind()))
        return metrics

    return body


def _draws(model: CenterMask, gt: GroundTruth,
           generator: Optional[torch.Generator],
           out: Optional[torch.Tensor] = None) -> Optional[torch.Tensor]:
    """The sampler's uniforms of one step (None without an ROI branch,
    mask or keypoint, which draws none)."""
    if not model.roi_training:
        return None
    shape = model.draws_shape(gt)
    if out is not None:
        return torch.rand(shape, generator=generator, out=out)
    return torch.rand(shape, generator=generator, device=gt.valid.device)


class CapturedTrainStep:
    """The train step as one CUDA graph (the module docstring), called as
    the eager step: ``(images, gt, draws=None, generator=None) ->
    metrics``. The metrics are copies, valid after the next replay. The
    tensors of the capturing call stay the graph's inputs, and a later
    call writes its own into them: hand the capture no tensor that is
    needed afterwards for anything else.
    ``graphs``: the capturing object (``export/captured.py::CudaGraphs``
    by default). ``capture_s``: the seconds the capture took."""

    def __init__(self, model: CenterMask, optimizer, scheduler, *,
                 graphs=None, group: Group = None):
        self.model = model
        self.body = _step_body(model, optimizer, scheduler, group)
        self.graphs = graphs if graphs is not None else CudaGraphs(
            next(model.parameters()).device)
        # what a replay writes in place, out of autograd's sight: their
        # version counters are bumped after it, as an eager step's are
        # (``CapturedInference`` refreshes its prepared weights by them)
        self.written = [p for g in optimizer.param_groups
                        for p in g["params"]]
        self.calls = 0
        self.graph = None
        self.static = None
        self.out = None
        self.capture_s = 0.0

    def __call__(self, images: torch.Tensor, gt: GroundTruth,
                 draws: Optional[torch.Tensor] = None,
                 generator: Optional[torch.Generator] = None) -> Metrics:
        if self.graph is None:
            if draws is None:
                draws = _draws(self.model, gt, generator)
            if self.calls < WARMUP_STEPS:
                self.calls += 1
                return self.graphs.warm_up(
                    lambda: self.body(images, gt, draws), 1)
            t0 = time.perf_counter()
            self.static = (images, *gt, draws)
            self.graph, self.out = self.graphs.capture(
                lambda: self.body(images, gt, draws))
            self.capture_s = time.perf_counter() - t0
        else:
            for dst, src in zip(self.static[:-1], (images, *gt)):
                if dst is not None and src is not dst:
                    dst.copy_(src, non_blocking=True)
            if draws is not None:
                if draws is not self.static[-1]:
                    self.static[-1].copy_(draws)
            elif self.static[-1] is not None:
                _draws(self.model, gt, generator, out=self.static[-1])
        self.graph.replay()
        for p in self.written:
            increment_version(p)
        return {k: v.clone() for k, v in self.out.items()}


def make_train_step(model: CenterMask, optimizer, scheduler, *,
                    capture: Optional[bool] = None,
                    graphs=None, group: Group = None) -> StepFn:
    """Returns ``step(images, gt, draws=None, generator=None) -> metrics``:
    the five losses and ``total_loss``, detached device scalars. Without
    ``draws`` the step draws the sampler's uniforms from ``generator``.
    ``capture`` (default: on CUDA) returns a ``CapturedTrainStep``; else
    the step runs eagerly. ``group``: the data-parallel process group
    (the module docstring), or None for one process; a gloo group runs
    eagerly only, and ``capture=True`` with one raises. The optimizer's
    ``counted`` tensors (frozen leaves that clipping by norm counts) get
    gradients from here on."""
    for t in getattr(optimizer, "counted", ()):
        t.requires_grad_(True)
    if capture is None:
        capture = supports_graphs(next(model.parameters()).device)
    if capture and is_gloo(group):
        raise ValueError("a gloo process group cannot be captured into a "
                         "CUDA graph: pass capture=False for the eager step")
    if capture:
        return CapturedTrainStep(model, optimizer, scheduler, graphs=graphs,
                                 group=group)
    body = _step_body(model, optimizer, scheduler, group)

    def step(images: torch.Tensor, gt: GroundTruth,
             draws: Optional[torch.Tensor] = None,
             generator: Optional[torch.Generator] = None) -> Metrics:
        if draws is None:
            draws = _draws(model, gt, generator)
        return body(images, gt, draws)

    return step


class StaticBatch:
    """Pinned host buffers and device buffers, one per batch key, reused
    by every batch of the same shapes: a batch is written into the pinned
    buffers and copied to the device without blocking the host. Before
    the host writes the pinned buffers again it waits on an event behind
    the previous copy (the device's copy of the previous step's batch),
    so the host runs at most one step ahead."""

    def __init__(self, dev: torch.device):
        self.dev = torch.device(dev)
        self.host: Dict[str, torch.Tensor] = {}
        self.device: Dict[str, torch.Tensor] = {}
        self.copied: Optional[torch.cuda.Event] = None

    def __call__(self, arrays: Dict[str, np.ndarray]
                 ) -> Dict[str, torch.Tensor]:
        if self.copied is not None:
            self.copied.synchronize()
        for k, a in arrays.items():
            t = torch.from_numpy(np.ascontiguousarray(a))
            h = self.host.get(k)
            if h is None or h.shape != t.shape or h.dtype != t.dtype:
                h = self.host[k] = torch.empty(t.shape, dtype=t.dtype,
                                               pin_memory=True)
                self.device[k] = torch.empty(t.shape, dtype=t.dtype,
                                             device=self.dev)
            h.copy_(t)
            self.device[k].copy_(h, non_blocking=True)
        self.copied = torch.cuda.Event()
        self.copied.record()
        return {k: self.device[k] for k in arrays}


def _to_device(x: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dev.type == "cuda":  # pinned, so the copy does not block the host
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def batch_to_device(batch: Dict[str, np.ndarray], dev: torch.device,
                    s2d_input: bool = False,
                    buffers: Optional[StaticBatch] = None
                    ) -> Tuple[torch.Tensor, GroundTruth]:
    """A ``train_batches`` batch -> (images, GroundTruth) on ``dev``. The
    images are the f32 normalized canvases, put in the s2d layout on the
    host for an s2d-input model (as the JAX ``input_transform_for``).
    With ``buffers`` (CUDA) the arrays go through its reused pinned and
    device buffers, else each through a tensor of its own."""
    dev = torch.device(dev)
    images = batch["image"]
    if s2d_input:
        from ..data.preprocess import stem_space_to_depth

        images = stem_space_to_depth(images)
    arrays = {"image": images, "gt_boxes": batch["gt_boxes"],
              "gt_classes": batch["gt_classes"],
              "gt_valid": batch["gt_valid"],
              "gt_mask_patches": batch["gt_mask_patches"],
              "image_size": batch["image_size"].astype(np.float32)}
    if "gt_keypoints" in batch:
        arrays["gt_keypoints"] = batch["gt_keypoints"]
    if buffers is not None:
        t = buffers(arrays)
    else:
        t = {k: _to_device(a, dev) for k, a in arrays.items()}
    gt = GroundTruth(boxes=t["gt_boxes"], classes=t["gt_classes"],
                     valid=t["gt_valid"], mask_patches=t["gt_mask_patches"],
                     keypoints=t.get("gt_keypoints"),
                     image_sizes=t["image_size"])
    return t["image"], gt


def train_loop(step: StepFn, batches: Iterable[Dict[str, np.ndarray]], *,
               device: torch.device, start_iter: int, max_iter: int,
               s2d_input: bool = False,
               generator: Optional[torch.Generator] = None,
               storage=None, log_every: int = 20,
               after_step: Optional[Callable[[int, Metrics], None]] = None,
               log: Callable[[str], None] = print) -> Optional[Metrics]:
    """Runs iterations ``start_iter .. max_iter - 1`` over ``batches``.
    Every ``log_every`` iterations the metrics come to the host, into
    ``storage`` (an ``EventStorage``) with the seconds per iteration, and
    into ``log``. ``after_step(iteration_done, metrics)`` runs after each
    step (checkpoints, evaluation, measurements), then ``storage.step()``.
    Returns the last step's metrics (device tensors)."""
    metrics = None
    dev = torch.device(device)
    buffers = StaticBatch(dev) if dev.type == "cuda" else None
    t0 = time.perf_counter()
    for it, batch in zip(range(start_iter, max_iter), batches):
        images, gt = batch_to_device(batch, dev, s2d_input, buffers)
        metrics = step(images, gt, generator=generator)
        if (it + 1) % log_every == 0:
            m = {k: float(v) for k, v in metrics.items()}
            dt = (time.perf_counter() - t0) / log_every
            t0 = time.perf_counter()
            if storage is not None:
                storage.put_scalars(**m)
                storage.put_scalar("s_per_iter", dt)
            log(f"iter {it + 1}/{max_iter} " + " ".join(
                f"{k}={v:.4f}" for k, v in sorted(m.items()))
                + f" ({dt:.3f} s/it)")
        if after_step is not None:
            after_step(it + 1, metrics)
        if storage is not None:
            storage.step()
    return metrics
