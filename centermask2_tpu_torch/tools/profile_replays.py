"""How often the PyTorch profiler misses the port's kernels in the
CUDA-graph replays of a served request, with and without a device sleep
around the profiled replays.

    python -m centermask2_tpu_torch.tools.profile_replays \\
        [--config-file configs/centermask/zy_model_config.yaml] \\
        [--canvas 1344] [--calls 5] [--trials 15] [--no-tf32] [KEY VALUE ...]

Captures ``model.inference`` at one square canvas (``CapturedInference``,
random weights from seed 0, the class bias at 0 as ``chip_smoke.py`` sets
it), then profiles ``--trials`` windows of ``--calls`` replays each:
first bare, then with a 20 ms device sleep before and after the replays,
as ``chip_smoke.py``'s ``replay_launches`` profiles them. A window misses
when a kernel of kernels 1 and 2 (``nms_mask_kernel``,
``nms_scan_kernel``, ``roi_align_kernel``) is counted other than once a
replay. Prints, per variant, the windows that missed, the first missed
window's counts, and the device events of every window (the most of them
is the whole record). Needs a GPU.
"""

from __future__ import annotations

import argparse
import collections
import subprocess

PORT_KERNELS = ("nms_mask_kernel", "nms_scan_kernel", "roi_align_kernel")
PAD_CYCLES = int(1.98e9 * 0.020)  # 20 ms at the H100's 1.98 GHz


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file",
                   default="configs/centermask/zy_model_config.yaml")
    p.add_argument("--canvas", type=int, default=1344)
    p.add_argument("--calls", type=int, default=5)
    p.add_argument("--trials", type=int, default=15)
    p.add_argument("--no-tf32", action="store_true",
                   help="f32 convolutions and matmuls without TF32")
    p.add_argument("opts", nargs=argparse.REMAINDER)
    return p.parse_args(argv)


def window(run, calls: int, pad: bool):
    """(port kernel counts, device events) of one profiled window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    run()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if pad:
            torch.cuda._sleep(PAD_CYCLES)
        for _ in range(calls):
            run()
        if pad:
            torch.cuda._sleep(PAD_CYCLES)
        torch.cuda.synchronize()
    evs = [e for e in prof.key_averages() if e.device_time_total > 0]
    counts = {k: sum(e.count for e in evs if k in e.key)
              for k in PORT_KERNELS}
    return counts, sum(e.count for e in evs)


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from ..config import get_cfg
    from ..export import CapturedInference
    from ..models.meta import build_centermask

    if args.no_tf32:
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    model = build_centermask(cfg, device="cuda", seed=0)
    with torch.no_grad():
        model.fcos_head.cls_logits.bias.zero_()
    g = torch.Generator().manual_seed(0)
    img = torch.rand((1, args.canvas, args.canvas, 3), generator=g) * 255.0
    img = (img - torch.tensor(cfg.MODEL.PIXEL_MEAN)).cuda()
    prog = CapturedInference(model)
    prog(img)
    torch.cuda.synchronize()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"{card}; {cfg.MODEL.VOVNET.CONV_BODY} "
          f"{cfg.TPU.COMPUTE_DTYPE} {args.canvas}x{args.canvas}, TF32 "
          f"{'off' if args.no_tf32 else 'default'}; {args.trials} windows "
          f"of {args.calls} replays a variant", flush=True)
    want = dict.fromkeys(PORT_KERNELS, args.calls)
    for pad in (False, True):
        missed, events, first = 0, [], None
        for _ in range(args.trials):
            counts, n = window(lambda: prog(img), args.calls, pad)
            events.append(n)
            if counts != want:
                missed += 1
                first = first or counts
        name = "20 ms device sleeps around" if pad else "bare"
        print(f"{name}: {missed} of {args.trials} windows missed a port "
              f"kernel (first: {first}); device events per window "
              f"{collections.Counter(events).most_common()}", flush=True)


if __name__ == "__main__":
    main()
