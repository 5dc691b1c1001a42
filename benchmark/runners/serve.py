"""The serving runner: one configuration of ``centermask2_tpu_torch``
served under one traffic mix (``harness/traffic.py`` makes the requests,
``harness/serve.py`` sends them), then the plain reference over a sample
of what was served (``harness/compare.py``).

Set-up (``setup_s``) runs from process start to the window's start:
imports, the model, the seed's weights, the kernels built or loaded, one
captured graph a canvas, warmed up. With ``--trace 1`` the window is
measured as in a plain run, then a slice of the same traffic is served
under ``torch.profiler``, so that its cost moves no window number.
"""

from __future__ import annotations

import gc
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from benchmark.harness import compare
from benchmark.harness.flops import peaks_of
from benchmark.harness.main import Outcome, Run
from benchmark.harness.serve import Sampler, Server
from benchmark.harness.spec import program_cfg
from benchmark.harness.trace import summarize
from benchmark.harness.weights import make
from benchmark.reference.model import Reference, exact_f32

TRACE_S = 2.0  # the traced slice after a --trace 1 window


def run(r: Run) -> Outcome:
    dev, cuda = r.dev, r.dev.type == "cuda"
    cfg = program_cfg(r.conf)
    server = Server(cfg, r.traffic, r.seed, dev, program=r.program)
    server.warm_up()
    flops_by_canvas = server.count_flops() if r.trace else None
    sampler = Sampler(int(r.traffic["sample"]), r.seed)
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - r.t_start
    rec = server.window(r.seconds, sampler)
    rec.setup_s = setup_s
    requests = server.requests
    peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    if r.trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
        server.window(min(TRACE_S, r.seconds), Sampler(0, r.seed),
                      profiler=profiler)
        rec.peaks = peaks_of(torch.cuda.get_device_name(dev)) if cuda \
            else None
        rec.flops = np.array([flops_by_canvas[c] for c in rec.canvases],
                             float)
        cand = int(cfg.TPU.NMS_CANDIDATES)
        rec.nms_shape = (1, -(-cand // 128) * 128)
        with tempfile.TemporaryDirectory() as tmp:
            path = Path(tmp) / "trace.json"
            profiler.export_chrome_trace(str(path))
            rec.trace = summarize(path)
        del profiler
    # the program's state freed, then the reference over the sample
    sample = sampler.sample()
    images, feed, entries = server.images, server.feed, server.entries
    server.close()
    del server
    gc.collect()
    with exact_f32(), torch.no_grad():
        # the seed's weights again, as the program got them
        ref = Reference(r.conf["cfg"]).to(dev).load(make(entries, r.seed,
                                                         dev))
        readings = []
        for i, outputs in sorted(sample.items()):
            q = requests[i]
            img = compare.image_tensor(images[(q.hw, q.variant)], dev)
            readings.append(compare.gaps(ref, outputs, img,
                                         feed.compute_canvas(q.hw),
                                         r.limits))
    numbers = compare.widest(readings) if readings else {}
    return Outcome(rec, numbers, peak)
