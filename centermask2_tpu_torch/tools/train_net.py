"""Training over a COCO-format dataset with the port, one process on one
device or several data-parallel processes, one device each (the
counterpart of the repository's ``tools/train_net.py``).

    python -m centermask2_tpu_torch.tools.train_net \\
        --config-file configs/centermask/zy_model_config.yaml \\
        --ann instances_train2017.json --image-root train2017 \\
        [--max-iter N] [--resume DIR] [--log-every N] [--device cpu|cuda:N] \\
        [--val-ann instances_val2017.json --val-image-root val2017] \\
        [KEY VALUE ...]

The model trains on the GPU unless ``--device cpu`` asks for the CPU.
``SOLVER.IMS_PER_BATCH`` is the global batch. Each step is
``train/trainer.py``'s: the losses, backward, clipped SGD with the
warm-up multistep schedule, captured as one CUDA graph on the GPU and
eager on the CPU. Every ``--log-every`` iterations the losses
and seconds per iteration go to ``OUTPUT_DIR/metrics.jsonl``; a
checkpoint (``checkpoint/torch_io.py``) goes to
``OUTPUT_DIR/checkpoints/step_N`` every ``SOLVER.CHECKPOINT_PERIOD``
iterations and at the end; with ``--val-ann``, ``evaluate_dataset``
scores the model every ``TEST.EVAL_PERIOD`` iterations and at the end.
``--resume`` takes a ``step_N`` directory or the directory holding them
(the newest). Without a resume the weights are random, from seed 0.
Reading image files needs PIL, rasterizing polygons cv2.

Data parallelism (JAX ``tools/train_net.py:75-145``): with
``CM2_COORDINATOR``, ``CM2_NUM_PROCESSES`` and ``CM2_PROCESS_ID`` set,
the process joins a process group first (``parallel/distributed.py``;
NCCL on CUDA, each process on the card its ``--device`` names, gloo on
the CPU). Each rank takes its ``IMS_PER_BATCH / world`` rows of every
global batch, rank 0's parameters (built or resumed) are broadcast to
every rank, and the step is ``make_train_step``'s data-parallel one (the
gradients, losses and plain BN statistics averaged over the ranks; on
gloo it runs eagerly). Only rank 0 writes checkpoints and
``metrics.jsonl`` and prints; the periodic evaluation runs on every rank
over its share of the images and rank 0 scores. The ranks meet at a
barrier after the first step.

Random streams, as the JAX CLI seeds them (``tools/train_net.py:145,
174``): the loader's stream is seeded with ``SEED`` (one process), so a
resumed run replays the batches from the fresh run's first batch; the
proposal sampler's generator is seeded with the step it starts from
(``PRNGKey(start)`` there), alike on every rank, as JAX hands every
replica the same key. Neither resumes where the stopped run was: the
checkpoint holds no loader position, as the JAX package's holds none.
Every rank draws the loader's stream from ``SEED`` and keeps its rows of
each global batch (``data/coco.py::train_batches``); the JAX CLI seeds
each process with ``SEED + process`` instead.
"""

from __future__ import annotations

import argparse
import contextlib
import os


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--config-file", default=None)
    p.add_argument("--ann", required=True, help="COCO annotations json")
    p.add_argument("--image-root", required=True)
    p.add_argument("--val-ann", default=None,
                   help="COCO annotations for the periodic evaluation")
    p.add_argument("--val-image-root", default=None)
    p.add_argument("--val-limit", type=int, default=0)
    p.add_argument("--max-iter", type=int, default=0,
                   help="iterations to train to (default SOLVER.MAX_ITER)")
    p.add_argument("--resume", default=None)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N or cpu; no fallback")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from ..parallel import (barrier, init_distributed, is_main_process,
                            process_count, process_index, replicate)

    # the process group first, before any model or CUDA work
    init_distributed(device=args.device)
    world, rank = process_count(), process_index()
    main_rank = is_main_process()

    from ..checkpoint.torch_io import (latest_checkpoint, load_checkpoint,
                                       restore_train_state, save_checkpoint,
                                       train_state)
    from ..config import get_cfg
    from ..data.coco import (CocoDataset, filter_images_with_few_keypoints,
                             train_batches)
    from ..data.prefetch import prefetch
    from ..models.meta import build_centermask
    from ..train import make_optimizer_from_cfg, make_train_step, train_loop
    from ..utils.comm import world_group
    from ..utils.events import EventStorage

    def log(msg: str) -> None:
        if main_rank:
            print(msg)

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    max_iter = args.max_iter or cfg.SOLVER.MAX_ITER
    model = build_centermask(cfg, device=args.device, seed=0).train()
    dev = next(model.parameters()).device
    optimizer, scheduler = make_optimizer_from_cfg(model, cfg)
    out_dir = cfg.OUTPUT_DIR
    ckpt_dir = os.path.join(out_dir, "checkpoints")
    if main_rank:
        os.makedirs(out_dir, exist_ok=True)

    start = 0
    if args.resume:
        path = args.resume if os.path.basename(
            os.path.normpath(args.resume)).startswith("step_") \
            else latest_checkpoint(args.resume)
        if path is None:
            raise SystemExit(f"--resume {args.resume}: no checkpoint there")
        start = restore_train_state(load_checkpoint(path), model, optimizer,
                                    scheduler)
        log(f"resumed from {path} at step {start}")
    # the JAX CLI replicates rank 0's state over the mesh; ranks that built
    # or resumed alike hold it already, and the broadcast makes sure
    replicate(model)

    ds = CocoDataset(args.ann, args.image_root,
                     filter_empty=cfg.DATALOADER.FILTER_EMPTY_ANNOTATIONS)
    if cfg.MODEL.KEYPOINT_ON:
        min_kp = cfg.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE
        dropped = filter_images_with_few_keypoints(ds, min_kp)
        if dropped:
            log(f"dropped {dropped} images with < {min_kp} visible "
                "keypoints")
    fixed = cfg.TPU.FIXED_EDGE_SIZE
    batch_size = cfg.SOLVER.IMS_PER_BATCH
    if batch_size % world:
        raise SystemExit(f"SOLVER.IMS_PER_BATCH {batch_size} does not split "
                         f"over {world} processes")
    log(f"{len(ds)} training images, batch {batch_size} "
        f"({batch_size // world} a process, {world} processes) on {dev}")
    seed = max(cfg.SEED, 0)
    batches = prefetch(train_batches(
        ds, batch_size, min_sizes=tuple(cfg.INPUT.MIN_SIZE_TRAIN),
        max_size=cfg.INPUT.MAX_SIZE_TRAIN, pad_to=(fixed, fixed),
        max_gt=cfg.TPU.MAX_GT_INSTANCES, seed=seed,
        random_flip=cfg.INPUT.RANDOM_FLIP,
        sampling=cfg.INPUT.MIN_SIZE_TRAIN_SAMPLING,
        workers=cfg.DATALOADER.NUM_WORKERS,
        tight_pad=cfg.TPU.TRAIN_TIGHT_PAD,
        with_keypoints=cfg.MODEL.KEYPOINT_ON, rank=rank, world=world),
        depth=2)

    eval_period = cfg.TEST.EVAL_PERIOD if args.val_ann else 0
    if eval_period > 0:
        import json

        from ..evaluation import COCOGt
        from ..evaluation.loop import evaluate_dataset
        from ..export.captured import CapturedInference, supports_graphs

        # one captured forward for the whole run, its graphs reused at
        # every evaluation (the JAX CLI hoists its jitted eval_fn)
        eval_fn = CapturedInference(model) if supports_graphs(dev) \
            else model.inference

        val_root = args.val_image_root or args.image_root
        eval_ds = CocoDataset(args.val_ann, val_root, filter_empty=False)
        with open(args.val_ann) as f:
            eval_gt = COCOGt(json.load(f))
        eval_tasks = ("bbox", "segm") if cfg.MODEL.MASK_ON else ("bbox",)

    storage = EventStorage(os.path.join(out_dir, "metrics.jsonl"),
                           start_iter=start) if main_rank else None

    def after_step(done: int, metrics) -> None:
        if done == start + 1:
            barrier()
        if main_rank and (done % cfg.SOLVER.CHECKPOINT_PERIOD == 0
                          or done == max_iter):
            path = save_checkpoint(
                ckpt_dir, train_state(model, optimizer, scheduler, done),
                done)
            print(f"saved {path}")
        if eval_period > 0 and (done % eval_period == 0 or done == max_iter):
            model.eval()
            results, _, _ = evaluate_dataset(
                model, ann=args.val_ann, image_root=val_root,
                fixed_size=fixed, min_size=cfg.INPUT.MIN_SIZE_TEST,
                max_size=cfg.INPUT.MAX_SIZE_TEST, tasks=eval_tasks,
                limit=args.val_limit, ds=eval_ds, gt=eval_gt,
                progress_every=0, fn=eval_fn, distributed=world > 1)
            model.train()
            if not main_rank:
                return
            flat = {f"{task}/{k}": v for task, m in results.items()
                    for k, v in m.items() if not k.startswith("AP-")}
            storage.put_scalars(**flat)
            print(f"eval @{done}: " + " ".join(
                f"{k}={v:.2f}" for k, v in flat.items()
                if k in ("bbox/AP", "segm/AP", "bbox/AP50", "segm/AP50")))

    generator = torch.Generator(device=dev).manual_seed(start)
    group = world_group() if world > 1 else None
    # gloo reduces through the host, which a CUDA graph cannot capture
    capture = False if group is not None and \
        torch.distributed.get_backend(group) == "gloo" else None
    step = make_train_step(model, optimizer, scheduler, capture=capture,
                           group=group)
    try:
        with storage if storage is not None else contextlib.nullcontext():
            train_loop(step, batches, device=dev, start_iter=start,
                       max_iter=max_iter, s2d_input=model.s2d_input,
                       generator=generator, storage=storage,
                       log_every=args.log_every, after_step=after_step,
                       log=log)
    finally:
        batches.close()


if __name__ == "__main__":
    main()
