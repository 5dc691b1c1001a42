"""Profile the inference pipeline (or the train step) by module on one
card (the port's counterpart of the repository's
``tools/profile_model.py``).

    python -m centermask2_tpu_torch.tools.profile_model [--device cpu] \\
        [--config-file configs/centermask/zy_model_config.yaml] \\
        [--batch 1] [--runs 3] [--top 25] [--trace-dir DIR] [--train] \\
        [KEY VALUE ...]

Runs ``torch.profiler`` (CPU and CUDA activities, ``record_shapes``) over
``--runs`` EAGER calls of ``CenterMask.inference`` (with ``--train``: of
the eager train step, on ``bench_train``'s synthetic batch), the calls
between two 20 ms device sleeps, as ``tools/profile_replays.py`` places
them. A CUDA graph's replay carries no host ranges, so only eager calls
can be attributed; the device time of one replay of the captured program
(``CapturedInference``, ``CapturedTrainStep``) is printed beside the
eager run's. The default config is the flagship yaml (bf16); the random
weights come from seed 0, the classification bias at 0 (``--train``: at
``bench_train.TRAIN_CLS_BIAS``).

Attribution. Every module's forward and the model's stage methods
(``SCOPED_METHODS``) push their name on a scope stack while they run;
``OpRecorder``, a ``TorchDispatchMode``, records each aten op with the
stack as its module path, its FLOPs (``FlopCounterMode``'s formulas) and
bytes (each input read once, each output written once), and wraps it in a
``record_function`` range ``cm2op#<i>``, through which the profiler's
launch correlation joins the op to its CUDA kernels (cuDNN's transposes
around a convolution included: they fall in the convolution's range). An
op of the backward, which runs on autograd's thread outside every scope,
takes the path of its forward op through the autograd node's
``sequence_nr`` behind ``transpose/`` (``utils/trace_sections.py``).

Prints the device time a run, the top CUDA kernels each with its module
path, the section rollup (``utils/trace_sections.py::section_of``), the
top unattributed kernels and the replay's device time, then one JSON
line of the same numbers. Writes under ``--trace-dir``: ``trace.json``
(the chrome trace), ``ops.jsonl`` (one record per aten op in launch
order: path, FLOPs, bytes, dtype, TF32, kernels with their
microseconds) and ``meta.json`` (the card, its peaks, the runs), which
``tools/roofline_bound.py`` reads. With ``--device cpu`` the ops' host
times stand in for kernels (a rehearsal of the attribution, no device
metric).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
from collections import defaultdict
from typing import Dict, List

from .bench import FLAGSHIP, card
from .profile_replays import PAD_CYCLES

TAG = "cm2op#"  # the record_function range around each recorded aten op
# the model's methods that open a scope of their own name, as flax names
# a module's methods other than __call__ in JAX's name stack
SCOPED_METHODS = {
    "": ("inference", "features", "_fcos_raw", "_decode", "loss",
         "_normalize_u8_s2d", "_pad_to_canvas"),
    "roi_heads": ("pool", "_assign_levels", "mask_forward_train",
                  "maskiou_forward", "keypoint_forward"),
}
# ops that read only as many elements of their source as they write
GATHERS = {"index", "index_select", "gather", "take", "embedding",
           "masked_select", "_unsafe_index", "take_along_dim"}
# in-place ops that overwrite their first argument without reading it
OVERWRITES = {"fill_", "zero_", "copy_", "uniform_", "normal_",
              "bernoulli_", "random_", "exponential_"}
# in-place ops that write only the elements their source or values give
PARTIAL_WRITES = {"index_put_", "_index_put_impl_", "scatter_",
                  "scatter_add_", "scatter_reduce_", "index_add_",
                  "index_copy_", "masked_scatter_", "index_fill_"}
CONV_OPS = {"convolution", "convolution_backward", "_convolution",
            "cudnn_convolution", "conv2d"}


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default=FLAGSHIP)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--runs", type=int, default=3)
    p.add_argument("--top", type=int, default=25)
    p.add_argument("--trace-dir", default=None)
    p.add_argument("--train", action="store_true",
                   help="profile the train step (forward, backward, SGD) "
                        "on bench_train's synthetic batch instead of "
                        "inference")
    p.add_argument("--device", default=None,
                   help="cuda (default) or cpu; no fallback")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


class Scopes:
    """The scope stack (module attribute names and stage methods) of the
    running forward, kept by hooks and method wrappers installed on
    ``model`` (and a scope ``optimizer`` around ``optimizer.step``) for
    the ``with`` block only."""

    def __init__(self, model, optimizer=None):
        self.model, self.optimizer = model, optimizer
        self.stack: List[str] = []
        self.handles = []
        self.wrapped = []

    def _push(self, name: str) -> None:  # a hook's None keeps the output
        self.stack.append(name)

    def _pop(self) -> None:
        self.stack.pop()

    def _wrap(self, owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr)

        def scoped(*args, **kwargs):
            self.stack.append(name)
            try:
                return fn(*args, **kwargs)
            finally:
                self.stack.pop()

        setattr(owner, attr, scoped)
        self.wrapped.append((owner, attr))

    def __enter__(self):
        for qual, mod in self.model.named_modules():
            if not qual:
                continue
            name = qual.rsplit(".", 1)[-1]
            self.handles.append(mod.register_forward_pre_hook(
                lambda m, a, n=name: self._push(n)))
            self.handles.append(mod.register_forward_hook(
                lambda m, a, o: self._pop()))
        for qual, methods in SCOPED_METHODS.items():
            if qual and not hasattr(self.model, qual):
                continue
            owner = self.model.get_submodule(qual)
            prefix = qual or type(self.model).__name__
            for m in methods:
                if hasattr(owner, m):
                    self._wrap(owner, m, f"{prefix}.{m}")
        if self.optimizer is not None:
            self._wrap(self.optimizer, "step", "optimizer")
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        for owner, attr in self.wrapped:
            delattr(owner, attr)  # the class's method again
        self.handles, self.wrapped = [], []
        return False


def _tensors(tree):
    import torch
    from torch.utils._pytree import tree_leaves

    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def tensor_bytes(t) -> int:
    """Bytes of the distinct elements of ``t``: a broadcast (stride 0)
    axis counts once."""
    n = 1
    for size, stride in zip(t.shape, t.stride()):
        if stride != 0:
            n *= size
    return n * t.element_size()


def op_counts(func, args, kwargs, out) -> Dict:
    """FLOPs (``FlopCounterMode``'s formula for the op, 0 where it has
    none: elementwise work) and the bytes one call must move: each input
    read once, each output written once, with three exceptions that only
    lower the count, so that a bound from it stays below the time: a
    gather reads as many elements of its source as it writes, an
    in-place fill or copy does not read its destination, and an indexed
    write touches only the elements its values give. Also the compute
    dtype (the first floating input's) and whether TF32 is allowed for
    it (cuDNN's flag for a convolution, the matmul flag otherwise)."""
    import torch
    from torch.utils.flop_counter import flop_registry

    name = func._overloadpacket.__name__
    formula = flop_registry.get(func._overloadpacket)
    flops = int(formula(*args, **kwargs, out_val=out)) if formula else 0
    kw = {k: v for k, v in kwargs.items() if k != "out"}
    ins = _tensors((args, kw))
    outs = _tensors(out)
    if name in OVERWRITES and ins:
        ins = ins[1:]
    if name in PARTIAL_WRITES and ins:
        src = ins[-1]
        written = src.numel() * ins[0].element_size()
        nbytes = sum(tensor_bytes(t) for t in ins[1:]) + written
    elif name in GATHERS and ins and outs:
        written = sum(tensor_bytes(t) for t in outs)
        nbytes = min(tensor_bytes(ins[0]), written) + written + sum(
            tensor_bytes(t) for t in ins[1:])
    else:
        nbytes = sum(tensor_bytes(t) for t in ins) + sum(
            tensor_bytes(t) for t in outs)
    floats = [t for t in ins if t.is_floating_point()]
    dtype = floats[0].dtype if floats else (ins[0].dtype if ins else None)
    tf32 = (torch.backends.cudnn.allow_tf32 if name in CONV_OPS
            else torch.backends.cuda.matmul.allow_tf32)
    return {"flops": flops, "bytes": int(nbytes),
            "dtype": str(dtype).replace("torch.", ""), "tf32": bool(tf32)}


def _recorder_class():
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    class OpRecorder(TorchDispatchMode):
        """Records each aten op that reaches the dispatcher below
        autograd: its index, name, module path (the forward's scope stack,
        or the forward op's path behind ``transpose/`` for an op of the
        backward) and ``op_counts``, the op run inside a range
        ``cm2op#<index>``."""

        def __init__(self, scopes: Scopes):
            super().__init__()
            self.scopes = scopes
            self.records: List[Dict] = []
            self.fwd_paths: Dict[int, str] = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if func.namespace == "profiler":  # another tool's host range
                return func(*args, **kwargs)
            i = len(self.records)
            node = torch._C._current_autograd_node()
            if node is not None:  # the backward, on autograd's thread
                path = "transpose/" + self.fwd_paths.get(
                    node._sequence_nr(), "")
            else:
                path = "/".join(self.scopes.stack)
                # the autograd node this op created (if any) took the
                # last sequence number; the first op to see it is its own
                self.fwd_paths.setdefault(
                    torch.autograd._get_sequence_nr() - 1, path)
            with torch.profiler.record_function(f"{TAG}{i}"):
                out = func(*args, **kwargs)
            self.records.append({"i": i, "op": str(func), "path": path,
                                 "bwd": node is not None,
                                 **op_counts(func, args, kwargs, out)})
            return out

    return OpRecorder


def record_ops(run, scopes: Scopes) -> List[Dict]:
    """The op records of one ``run()`` without the profiler (the
    attribution of every op to its module path, on any device)."""
    with scopes, _recorder_class()(scopes) as rec:
        run()
    return rec.records


def _is_annotation(name: str) -> bool:
    """A range of the host shown on the device's timeline, or the
    profiler window's device sleep: not a kernel of the run."""
    return (name.startswith(TAG) or name.startswith("Optimizer.")
            or "spin_kernel" in name)


def profile_runs(run, runs: int, scopes: Scopes, dev):
    """(records, prof): ``runs`` calls of ``run()`` under the profiler and
    the recorder, between two device sleeps on the card; each record gets
    ``kernels`` ([name, us] of the CUDA kernels launched inside its range;
    on the CPU the range's own host time under the op's name)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = dev.type == "cuda"
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts, record_shapes=True) as prof:
        if cuda:
            torch.cuda._sleep(PAD_CYCLES)
        with scopes, _recorder_class()(scopes) as rec:
            for _ in range(runs):
                run()
        if cuda:
            torch.cuda._sleep(PAD_CYCLES)
            torch.cuda.synchronize(dev)
    records = rec.records
    for r in records:
        r["kernels"] = []
    for e in prof.events():
        owner = e
        while owner is not None and not owner.name.startswith(TAG):
            owner = owner.cpu_parent
        if owner is None:
            continue
        r = records[int(owner.name[len(TAG):])]
        if cuda:
            r["kernels"] += [[k.name, k.duration] for k in e.kernels
                             if not _is_annotation(k.name)]
        elif e is owner:
            r["kernels"].append([r["op"], e.cpu_time_total])
    return records, prof


def short_name(kernel: str) -> str:
    """A kernel's name without its return type, namespaces, template and
    call arguments (for the tables; the records keep the full name)."""
    name = kernel.replace("(anonymous namespace)::", "")
    name = name[5:] if name.startswith("void ") else name
    cut = min([i for i in (name.find("<"), name.find("(")) if i > 0],
              default=len(name))
    return name[:cut].rsplit("::", 1)[-1]


def device_total_us(prof) -> float:
    """Microseconds of every CUDA event in a profile but the host's
    ranges and the device sleeps (``key_averages``)."""
    import torch

    return sum(e.device_time_total for e in prof.key_averages()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA
               and not _is_annotation(e.key))


def replay_device_ms(replay, dev) -> float:
    """Device ms of one replay of a captured program, by the profiler,
    between two device sleeps (its kernels carry no host op to join)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    replay()
    torch.cuda.synchronize(dev)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(PAD_CYCLES)
        replay()
        torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize(dev)
    return device_total_us(prof) / 1e3


def summarize(records, runs: int, top: int, total_us: float,
              cuda: bool) -> Dict:
    """Prints the tables; returns the summary (ms a run)."""
    from ..utils.trace_sections import section_of

    what = "device kernel" if cuda else "host op (CPU rehearsal)"
    joined = sum(us for r in records for _, us in r["kernels"])
    total = total_us if cuda else joined
    print(f"{what} time: {total / runs / 1e3:.3f} ms/run "
          f"({joined / runs / 1e3:.3f} joined to {len(records) // runs} "
          f"recorded ops a run)")
    by = defaultdict(float)
    sections = defaultdict(float)
    kernels = defaultdict(lambda: defaultdict(float))
    for r in records:
        sec = section_of(r["path"])
        for name, us in r["kernels"]:
            by[(name, r["path"])] += us
            sections[sec] += us
            kernels[sec][name] += us
    unjoined = total - joined
    if unjoined > 0:
        sections["(unattributed)"] += unjoined
    print(f"{'ms/run':>9}  {'cum%':>5}  kernel (module path)")
    cum = 0.0
    for (name, path), us in sorted(by.items(), key=lambda kv: -kv[1])[:top]:
        cum += us
        print(f"{us / runs / 1e3:9.3f}  {cum / total * 100:5.1f}  "
              f"{short_name(name)[:40]} {path[-95:]}")
    print("\nsection rollup:")
    for name, us in sorted(sections.items(), key=lambda kv: -kv[1]):
        print(f"{us / runs / 1e3:9.3f}  {us / total * 100:5.1f}%  {name}")
    unattr = sorted(((n, p, us) for (n, p), us in by.items()
                     if section_of(p) == "(unattributed)"),
                    key=lambda x: -x[2])
    if unattr or unjoined > 0:
        print("\ntop unattributed kernels:")
        if unjoined > 0:
            print(f"{unjoined / runs / 1e3:9.3f}  (kernels of no recorded "
                  "op)")
        for n, p, us in unattr[:12]:
            print(f"{us / runs / 1e3:9.3f}  {short_name(n)[:60]} {p[-40:]}")
    attributed = sum(us for s, us in sections.items()
                     if s != "(unattributed)")
    return {"ms_per_run": total / runs / 1e3,
            "attributed_share": attributed / total if total else 0.0,
            "sections": {s: us / runs / 1e3 for s, us in sections.items()},
            "section_kernels": {s: {k: us / runs / 1e3 for k, us in
                                    ks.items()} for s, ks in kernels.items()}}


def run(args) -> Dict:
    import numpy as np
    import torch

    from ..config import get_cfg
    from ..data.preprocess import stem_space_to_depth
    from ..export import CapturedInference
    from ..models.meta import build_centermask
    from ..utils.device import resolve_device
    from ..utils.measures import chip_peaks

    dev = resolve_device(args.device)
    cuda = dev.type == "cuda"
    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(list(args.opts))
    if not cfg.MODEL.MASK_ON:
        print("[warn] MODEL.MASK_ON is False: profiling a MASKLESS graph "
              "(pass MODEL.MASK_ON True MODEL.MASKIOU_ON True for the "
              "flagship pipeline)", file=sys.stderr)
    fixed = cfg.TPU.FIXED_EDGE_SIZE
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="cm2_trace_")
    os.makedirs(trace_dir, exist_ok=True)

    if args.train:
        from ..train import make_train_step
        from .bench_train import build_train_model, synthetic_batch

        model, opt, sched = build_train_model(cfg, dev)
        x, gt = synthetic_batch(args.batch, fixed, fixed, dev,
                                model.s2d_input)
        gen = torch.Generator(device=dev).manual_seed(0)
        eager = make_train_step(model, opt, sched, capture=False)

        def call():
            return eager(x, gt, generator=gen)

        scopes = Scopes(model, opt)
    else:
        model = build_centermask(cfg, device=dev, seed=0)
        with torch.no_grad():
            model.fcos_head.cls_logits.bias.zero_()
        rng = np.random.RandomState(0)
        x_img = rng.randn(args.batch, fixed, fixed, 3).astype(np.float32) * 30
        x = torch.from_numpy(stem_space_to_depth(x_img) if model.s2d_input
                             else x_img).to(dev)

        def call():
            return model.inference(x)

        scopes = Scopes(model)
    call()  # cuDNN's choices and the kernels' first use, outside the window
    if cuda:
        torch.cuda.synchronize(dev)
    records, prof = profile_runs(call, args.runs, scopes, dev)
    prof.export_chrome_trace(os.path.join(trace_dir, "trace.json"))
    total_us = device_total_us(prof) if cuda else 0.0
    print(f"trace: {trace_dir}")
    summary = summarize(records, args.runs, args.top, total_us, cuda)

    replay_ms = None
    if cuda:
        if args.train:
            step = make_train_step(model, opt, sched)
            replay = lambda: step(x, gt, generator=gen)  # noqa: E731
            from ..train.trainer import WARMUP_STEPS
            for _ in range(WARMUP_STEPS + 1):  # the warm-up and capture
                replay()
        else:
            prog = CapturedInference(model)
            replay = lambda: prog(x)  # noqa: E731
        replay_ms = replay_device_ms(replay, dev)
        print(f"\ncaptured replay device time: {replay_ms:.3f} ms (the "
              f"eager run's kernels: {summary['ms_per_run']:.3f} ms)")
    summary["replay_device_ms"] = replay_ms
    peaks = chip_peaks(dev)
    meta = {"tool": "profile_model", "train": args.train, "runs": args.runs,
            "device": card(dev), "clock": "cuda kernels" if cuda
            else "host ops (CPU rehearsal)",
            "dtype": cfg.TPU.COMPUTE_DTYPE,
            "peaks": peaks._asdict() if peaks is not None else None,
            "trace_dir": trace_dir}
    with open(os.path.join(trace_dir, "meta.json"), "w") as f:
        json.dump(meta, f)
    with open(os.path.join(trace_dir, "ops.jsonl"), "w") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")
    out = {**meta, **summary}
    print(json.dumps(out), flush=True)
    return out


def main(argv=None) -> Dict:
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
