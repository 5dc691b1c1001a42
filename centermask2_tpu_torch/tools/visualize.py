"""Draw predictions on an image (the counterpart of the repository's
``tools/visualize.py``, the reference's ``visualizer.py`` analog).

    python -m centermask2_tpu_torch.tools.visualize --image img.jpg \\
        [--config-file ...] [--weights model.pth|converted_dir] \\
        [--output visualized_outputs.jpg] [--score-thresh 0.3] \\
        [--device cpu] [KEY VALUE ...]

Runs ``model.inference`` on the image through the host pipeline and draws
boxes, class labels, scores, mask overlays and, for a keypoint model, the
keypoints with the COCO person skeleton, at the original size
(``--output``, after ``detector_postprocess``) and at the padded network
canvas (``<output stem>_padded<ext>``: the network's boxes, masks pasted
at the canvas), the pair the reference renders to spot a pre/post
mismatch (visualizer.py:41-106). cv2 is imported only by the drawing and
writing functions; reading the image needs PIL. Runs on the GPU unless
``--device cpu``; without ``--weights`` the weights are random, from
seed 0.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

# COCO person skeleton (1-based keypoint pairs, the d2/COCO rendering)
COCO_SKELETON = ((16, 14), (14, 12), (17, 15), (15, 13), (12, 13), (6, 12),
                 (7, 13), (6, 7), (6, 8), (7, 9), (8, 10), (9, 11), (2, 3),
                 (1, 2), (1, 3), (2, 4), (3, 5), (4, 6), (5, 7))


def draw(image_bgr, boxes, classes, scores, masks=None, class_names=None,
         keypoints=None, kp_thresh=0.05):
    """The instances drawn on a copy of ``image_bgr`` (HWC uint8)."""
    import cv2

    rng = np.random.RandomState(0)
    colors = rng.randint(60, 255, (80, 3))
    out = image_bgr.copy()
    for i in range(len(boxes)):
        x0, y0, x1, y1 = [int(round(v)) for v in boxes[i]]
        c = tuple(int(v) for v in colors[int(classes[i]) % 80])
        cv2.rectangle(out, (x0, y0), (x1, y1), c, 2)
        name = (class_names[int(classes[i])]
                if class_names else str(int(classes[i])))
        cv2.putText(out, f"{name} {scores[i]:.2f}", (x0, max(y0 - 4, 10)),
                    cv2.FONT_HERSHEY_SIMPLEX, 0.5, c, 1)
        if masks is not None:
            m = masks[i].astype(bool)
            overlay = out[m].astype(np.float32) * 0.5 + np.array(c) * 0.5
            out[m] = overlay.astype(np.uint8)
        if keypoints is not None:
            kp = np.asarray(keypoints[i])  # (K, 3) x, y, prob
            vis = kp[:, 2] >= kp_thresh
            for k in range(len(kp)):
                if vis[k]:
                    cv2.circle(out, (int(round(kp[k, 0])),
                                     int(round(kp[k, 1]))), 3, c, -1)
            if len(kp) == 17:  # COCO person skeleton
                for a, b in COCO_SKELETON:
                    if vis[a - 1] and vis[b - 1]:
                        cv2.line(out,
                                 (int(round(kp[a - 1, 0])),
                                  int(round(kp[a - 1, 1]))),
                                 (int(round(kp[b - 1, 0])),
                                  int(round(kp[b - 1, 1]))), c, 1)
    return out


def write_image(path: str, image_bgr: np.ndarray) -> None:
    import cv2

    if not cv2.imwrite(path, image_bgr):
        raise OSError(f"cv2 could not write {path}")


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--image", required=True)
    p.add_argument("--config-file", default=None)
    p.add_argument("--weights", default=None,
                   help="a reference-schema .pth checkpoint or a converted "
                        "checkpoint directory (tools/convert_weights.py)")
    p.add_argument("--output", default="visualized_outputs.jpg")
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback")
    p.add_argument("opts", nargs=argparse.REMAINDER, default=[])
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_args(argv)
    import torch

    from ..checkpoint.weights import load_weights
    from ..config import get_cfg
    from ..data import (detector_postprocess, paste_masks_np,
                        preprocess_for_model, read_image_bgr,
                        resize_shortest_edge, single_wrap_outputs)
    from ..models.meta import build_centermask

    cfg = get_cfg()
    if args.config_file:
        cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    model = build_centermask(cfg, device=args.device, seed=0)
    if args.weights:
        load_weights(model, cfg, args.weights)
    fixed = cfg.TPU.FIXED_EDGE_SIZE
    short, max_size = cfg.INPUT.MIN_SIZE_TEST, cfg.INPUT.MAX_SIZE_TEST
    pre = preprocess_for_model(args.image, fixed, short, max_size,
                               s2d=model.s2d_input)
    x = torch.from_numpy(pre["input"]).to(next(model.parameters()).device)
    with torch.no_grad():
        out = {k: v.cpu().numpy() for k, v in model.inference(x)._asdict()
               .items() if v is not None}
    keep = out["valid"][0] & (out["scores"][0] >= args.score_thresh)
    rows = [out[k][0][keep] if k in out else None
            for k in ("locations", "mask_scores", "pred_boxes",
                      "pred_classes", "pred_masks", "scores",
                      "pred_keypoints")]
    h, w = pre["original_hw"]
    post = detector_postprocess(single_wrap_outputs(rows), h, w,
                                short=short, max_size=max_size)
    original = read_image_bgr(args.image)
    write_image(args.output, draw(
        original, post["pred_boxes"], post["pred_classes"], post["scores"],
        post["pred_masks"], keypoints=post.get("pred_keypoints")))

    # the padded network canvas: the resized image in the top-left corner
    canvas = np.zeros((fixed, fixed, 3), np.uint8)
    resized = resize_shortest_edge(original, short, max_size)
    canvas[:resized.shape[0], :resized.shape[1]] = resized
    boxes, masks = rows[2], rows[4][:, 0]
    padded = os.path.splitext(args.output)
    padded = f"{padded[0]}_padded{padded[1]}"
    write_image(padded, draw(
        canvas, boxes, rows[3], rows[5],
        paste_masks_np(masks, boxes, (fixed, fixed), 0.5),
        keypoints=rows[6]))
    print(f"wrote {args.output} with {len(post['pred_boxes'])} instances "
          f"and {padded} with {len(boxes)} at the {fixed}x{fixed} canvas")


if __name__ == "__main__":
    main()
