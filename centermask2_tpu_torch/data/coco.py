"""COCO-format dataset reading for evaluation (the port's own copy of
``CocoDataset`` from ``centermask2_tpu/data/coco.py``), without
pycocotools. The training loaders of that file come with training
(ROADMAP queue 1, item 13).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict


class CocoDataset:
    def __init__(self, json_path: str, image_root: str,
                 filter_empty: bool = True):
        with open(json_path) as f:
            self.dataset = json.load(f)
        self.image_root = image_root
        self.imgs = {im["id"]: im for im in self.dataset["images"]}
        cat_ids = sorted(c["id"] for c in self.dataset.get("categories", []))
        # dataset category id -> contiguous [0, C)
        self.cat_to_contiguous = {cid: i for i, cid in enumerate(cat_ids)}
        self.contiguous_to_cat = {i: cid for cid, i in
                                  self.cat_to_contiguous.items()}
        anns = defaultdict(list)
        for a in self.dataset.get("annotations", []):
            if a.get("iscrowd", 0):
                continue  # crowd regions are eval-only ignore regions
            anns[a["image_id"]].append(a)
        self.img_to_anns = anns
        ids = sorted(self.imgs.keys())
        if filter_empty:
            ids = [i for i in ids if len(anns[i]) > 0]
        self.ids = ids

    def __len__(self) -> int:
        return len(self.ids)

    def image_path(self, img_id: int) -> str:
        return os.path.join(self.image_root, self.imgs[img_id]["file_name"])
