"""A deterministic in-memory detection dataset of drawn rectangles.

The recipe and constructor of ``SyntheticDataset`` in the JAX package's
``tests/test_data.py``: image ``i`` draws from ``default_rng(i)`` 1-3
rectangles of ``box_range`` pixels a side, paints each with its class's grey
level (``(class + 1) * 60``, modulo 256 here, so that more than four classes
fit in uint8) and gives each a full-image mask and, ``with_keypoints``, four
keypoints at its box's corners, all labelled visible; ``with_sem_seg`` adds a
label map ``sem_seg [H, W]`` int32: 0 for the background, each box's class
+ 1 inside it, later boxes over earlier ones as they are painted.
``first_id`` (0 there) offsets the image ids, and with them the draws, so
that a second set (a validation split) holds other images. Besides indexing it has the surface the
evaluator reads from a COCO dataset: ``images`` (``(info, annotations)``
pairs whose ``info["id"]`` is the image id) and ``image_id(i)``.

``jittered_proposals`` is the precomputed-proposal recipe of the JAX
package's ``tests/test_fast_rcnn.py`` ``ProposalDataset``: 8 copies of each
GT box moved by N(0, 2 px) per coordinate, clipped to the image, scored
U(0, 10); ``write_proposal_file`` writes the recipe's proposals for a COCO JSON's
images as a Detectron2 proposal pickle (``MODEL.LOAD_PROPOSALS``).
"""

from __future__ import annotations

import json
import pickle

import numpy as np


class SyntheticDataset:
    """Deterministic little detection dataset (drawn rectangles)."""

    def __init__(self, n=8, h=97, w=153, num_classes=3, with_masks=True,
                 seed=0, box_range=(10, 30), first_id=0, with_keypoints=False,
                 with_sem_seg=False):
        self.n, self.h, self.w = n, h, w
        self.box_range = box_range
        self.num_classes = num_classes
        self.with_masks = with_masks
        self.with_keypoints = with_keypoints
        self.with_sem_seg = with_sem_seg
        self.rng = np.random.default_rng(seed)
        self.samples = [self._make(first_id + i) for i in range(n)]
        self.images = [({"id": first_id + i, "file_name": f"{first_id + i}.jpg"}, [])
                       for i in range(n)]

    def _make(self, i):
        rng = np.random.default_rng(i)
        img = rng.integers(0, 255, (self.h, self.w, 3), np.uint8)
        k = rng.integers(1, 4)
        boxes, classes, masks = [], [], []
        for _ in range(k):
            lo, hi = self.box_range
            x0, y0 = rng.uniform(0, self.w - hi), rng.uniform(0, self.h - hi)
            bw, bh = rng.uniform(lo, hi), rng.uniform(lo, hi)
            box = [x0, y0, min(x0 + bw, self.w), min(y0 + bh, self.h)]
            boxes.append(box)
            cls = int(rng.integers(0, self.num_classes))
            classes.append(cls)
            img[int(box[1]): int(box[3]), int(box[0]): int(box[2])] = (cls + 1) * 60 % 256
            m = np.zeros((self.h, self.w), np.float32)
            m[int(box[1]): int(box[3]), int(box[0]): int(box[2])] = 1
            masks.append(m)
        s = {
            "image": img,
            "image_id": i,
            "boxes": np.asarray(boxes, np.float32),
            "classes": np.asarray(classes, np.int32),
            "is_crowd": np.zeros(k, bool),
        }
        if self.with_masks:
            s["masks"] = np.stack(masks)
        if self.with_sem_seg:
            sem = np.zeros((self.h, self.w), np.int32)
            for b, c in zip(boxes, classes):
                sem[int(b[1]): int(b[3]), int(b[0]): int(b[2])] = c + 1
            s["sem_seg"] = sem
        if self.with_keypoints:  # (x0, y0), (x1, y0), (x0, y1), (x1, y1), visible
            b = s["boxes"]
            s["keypoints"] = np.stack([
                np.stack([[b[j, 0], b[j, 1], 2.0], [b[j, 2], b[j, 1], 2.0],
                          [b[j, 0], b[j, 3], 2.0], [b[j, 2], b[j, 3], 2.0]])
                for j in range(len(b))]).astype(np.float32)
        return s

    def __len__(self):
        return self.n

    def image_id(self, i: int) -> int:
        return self.images[i][0]["id"]

    def __getitem__(self, i):
        return {k: (v.copy() if isinstance(v, np.ndarray) else v)
                for k, v in self.samples[i].items()}


def jittered_proposals(boxes: np.ndarray, h: int, w: int, rng: np.random.Generator,
                       per_box: int = 8, sigma: float = 2.0):
    """``(proposals [per_box * N, 4], scores [per_box * N])``: GT-jittered
    boxes clipped to the ``h x w`` image, scores uniform in [0, 10)."""
    boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
    jitter = rng.normal(0, sigma, (len(boxes) * per_box, 4)).astype(np.float32)
    props = np.clip(np.repeat(boxes, per_box, axis=0) + jitter, 0, [w, h, w, h])
    return props.astype(np.float32), rng.uniform(0, 10, len(props)).astype(np.float32)


def write_proposal_file(annotations_json: str, path: str, seed: int = 0) -> int:
    """Write :func:`jittered_proposals` of each image's annotated boxes (COCO
    ``bbox`` x, y, w, h) to ``path`` as a Detectron2 proposal pickle
    (``ids``, ``boxes`` xyxy, ``objectness_logits``); returns the image
    count."""
    with open(annotations_json) as f:
        coco = json.load(f)
    boxes = {img["id"]: [] for img in coco["images"]}
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        boxes[a["image_id"]].append([x, y, x + w, y + h])
    rng = np.random.default_rng(seed)
    data = {"ids": [], "boxes": [], "objectness_logits": []}
    for img in coco["images"]:
        props, scores = jittered_proposals(np.asarray(boxes[img["id"]], np.float32),
                                           img["height"], img["width"], rng)
        data["ids"].append(img["id"])
        data["boxes"].append(props)
        data["objectness_logits"].append(scores)
    with open(path, "wb") as f:
        pickle.dump(data, f)
    return len(data["ids"])
