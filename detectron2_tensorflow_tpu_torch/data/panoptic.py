"""COCO-panoptic files: the panoptic PNG id maps as training and evaluation GT.

Port of the JAX package's ``data/panoptic.py`` (``rgb_to_id``, ``id_to_rgb``,
``CocoPanopticDataset``) over the port's PIL decoder (``image_io``), which
reads a PNG as RGB where the JAX package reads BGR with ``cv2`` and
converts. A sample carries the thing instances (boxes, classes and
full-image masks of the non-crowd thing segments) and ``sem_seg [H, W]``
int32 for the semantic head: 0 for every thing pixel (the merged thing
class), ``1 .. S`` for the stuff categories in the order of their ids, and
``ignore_label`` where no segment lies.
"""

from __future__ import annotations

import json
import os
from typing import Dict

import numpy as np

from . import image_io

# The ignore label's colour in an RGB id map: 256^3 - 1, all 255.
IGNORE_ID = 256 ** 3 - 1


def rgb_to_id(color: np.ndarray) -> np.ndarray:
    """``[..., 3]`` uint8 panoptic PNG -> ``[...]`` int32 segment ids (base 256)."""
    color = color.astype(np.int32)
    return color[..., 0] + 256 * color[..., 1] + 256 * 256 * color[..., 2]


def id_to_rgb(ids: np.ndarray) -> np.ndarray:
    """``[...]`` int segment ids -> ``[..., 3]`` uint8 (the inverse of :func:`rgb_to_id`)."""
    ids = ids.astype(np.int64)
    return np.stack([ids % 256, (ids // 256) % 256, (ids // (256 * 256)) % 256],
                    axis=-1).astype(np.uint8)


def encode_label_map(sem: np.ndarray) -> bytes:
    """A label map ``[H, W]`` (-1 unlabelled) as the RGB id-map PNG that a
    record's ``image/sem_seg`` holds: -1 becomes :data:`IGNORE_ID`."""
    sem = np.asarray(sem, np.int64)
    return image_io.encode_png_rgb(id_to_rgb(np.where(sem < 0, IGNORE_ID, sem)))


def decode_label_map(data: bytes) -> np.ndarray:
    """The inverse of :func:`encode_label_map`: int32 ``[H, W]``, -1 unlabelled."""
    ids = rgb_to_id(image_io.decode_image(data))
    return np.where(ids == IGNORE_ID, -1, ids).astype(np.int32)


class CocoPanopticDataset:
    """A panoptic JSON and its PNG id maps, with the images.

    ``images`` (and ``entries``) pair each image's info with its panoptic
    annotation; ``thing_contiguous`` / ``stuff_contiguous`` map category ids
    to the thing classes ``0 .. T-1`` and the stuff labels ``1 .. S``;
    ``thing_classes`` and ``stuff_classes`` (``"things"`` first) are their
    names. Like the JAX class it names no ``image_path``, so ``build_records``
    encodes its images anew.
    """

    def __init__(self, panoptic_json: str, panoptic_root: str, image_root: str,
                 ignore_label: int = -1):
        with open(panoptic_json) as f:
            pano = json.load(f)
        self.image_root = image_root
        self.panoptic_root = panoptic_root
        self.ignore_label = ignore_label
        things = sorted((c for c in pano["categories"] if c.get("isthing", 0)),
                        key=lambda c: c["id"])
        stuff = sorted((c for c in pano["categories"] if not c.get("isthing", 0)),
                       key=lambda c: c["id"])
        self.thing_contiguous = {c["id"]: i for i, c in enumerate(things)}
        self.stuff_contiguous = {c["id"]: i + 1 for i, c in enumerate(stuff)}
        self.thing_classes = [c["name"] for c in things]
        self.stuff_classes = ["things"] + [c["name"] for c in stuff]
        img_by_id = {i["id"]: i for i in pano["images"]}
        self.entries = [(img_by_id[a["image_id"]], a) for a in pano["annotations"]]
        self.images = self.entries

    def __len__(self) -> int:
        return len(self.entries)

    def _segment_ids(self, ann) -> np.ndarray:
        with open(os.path.join(self.panoptic_root, ann["file_name"]), "rb") as f:
            return rgb_to_id(image_io.decode_image(f.read()))

    def get_panoptic_gt(self, idx: int):
        """``(gt_map [H, W] segment ids, segments_info)`` at the original
        resolution, for PQ."""
        ann = self.entries[idx][1]
        return self._segment_ids(ann), ann["segments_info"]

    def __getitem__(self, idx: int) -> Dict:
        img_info, ann = self.entries[idx]
        image = image_io.load_image_rgb(os.path.join(self.image_root, img_info["file_name"]))
        h, w = image.shape[:2]
        seg_ids = self._segment_ids(ann)
        sem_seg = np.full((h, w), self.ignore_label, np.int32)
        boxes, classes, masks = [], [], []
        for seg in ann["segments_info"]:
            region = seg_ids == seg["id"]
            cat = seg["category_id"]
            if cat in self.thing_contiguous:
                sem_seg[region] = 0
                if not seg.get("iscrowd", 0):
                    ys, xs = np.nonzero(region)
                    if len(ys) == 0:
                        continue
                    boxes.append([xs.min(), ys.min(), xs.max() + 1, ys.max() + 1])
                    classes.append(self.thing_contiguous[cat])
                    masks.append(region.astype(np.float32))
            else:
                sem_seg[region] = self.stuff_contiguous[cat]
        n = len(boxes)
        return {
            "image": image,
            "image_id": img_info["id"],
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "is_crowd": np.zeros(n, bool),
            "masks": np.stack(masks) if masks else np.zeros((0, h, w), np.float32),
            "sem_seg": sem_seg,
        }
