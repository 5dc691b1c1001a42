"""Faults planted in the program's decode, for the readings that
``set_gap``'s limit is held against (``tools/readings.py --fault``) and
for the benchmark's own tests. Each takes the model and ``capture``,
which makes the program from it (``CapturedInference`` on the card,
``lambda m: m.inference`` on the CPU), and returns the program.

- ``over_suppression``: greedy NMS at an IoU of 0.3 in place of the
  configuration's NMS_TH, so boxes that overlap a kept one by 0.3 to
  NMS_TH are suppressed and the list runs on below. ``set_gap`` sees it
  only above the ties: with random weights the boxes it drops lie
  within the score limit of the last one served, and it read 0 on the
  cells' seeds (PERF.md);
- ``dropped_keeper``: the third kept detection left out and the list
  run on by one, as a keep set that suppresses one box it should keep
  (seen where the third scores above the tie of the last served: on
  most of the cells' seeds, not all);
- ``shifted_topk``: the post-NMS top-k serves the kept detections from
  the sixth on, a top-k that picks above-threshold detections but not
  the highest.
"""

from __future__ import annotations

import torch


def over_suppression(model, capture):
    model.decode_kwargs = dict(model.decode_kwargs, nms_thresh=0.3)
    return capture(model)


def _served_slots(model, capture, slots):
    """The program with one more kept detection than served, serving the
    kept slots ``slots(k)`` of the k + 1."""
    k = int(model.decode_kwargs["post_nms_topk"])
    model.decode_kwargs = dict(model.decode_kwargs, post_nms_topk=k + 5)
    prog = capture(model)
    keep = None

    def call(*args):
        nonlocal keep
        out = prog(*args)
        if keep is None:
            keep = torch.tensor(slots(k), device=out.valid.device)
        return type(out)(*(None if t is None else t[:, keep] for t in out))
    return call


def dropped_keeper(model, capture):
    return _served_slots(model, capture,
                         lambda k: [0, 1] + list(range(3, k + 1)))


def shifted_topk(model, capture):
    return _served_slots(model, capture, lambda k: list(range(5, k + 5)))


FAULTS = {"over_suppression": over_suppression,
          "dropped_keeper": dropped_keeper, "shifted_topk": shifted_topk}
# the faults that set_gap sees at the tests' tiny size
CAUGHT = ("dropped_keeper", "shifted_topk")
