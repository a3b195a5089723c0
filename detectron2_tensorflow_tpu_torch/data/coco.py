"""COCO-format datasets: the annotation JSON, its masks and the images.

Port of the JAX package's ``data/coco.py`` without ``cv2`` or pycocotools:
images are decoded by PIL (``image_io``), polygons are filled by
``polygon.fill_poly`` (``cv2.fillPoly``'s algorithm, pixel for pixel for
vertices inside the image), and COCO RLE (uncompressed counts or the
compressed string) is decoded in numpy. Produces the sample dicts that
``data/transforms.py`` consumes.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from . import image_io
from .image_io import load_image_rgb
from .polygon import fill_poly


def decode_rle(rle: Dict, h: int, w: int) -> np.ndarray:
    """Decode COCO RLE (uncompressed counts list or compressed LEB128-style
    string) to a [h, w] uint8 mask. Column-major order per COCO spec."""
    counts = rle["counts"]
    if isinstance(counts, str):
        counts = _decode_compressed_counts(counts.encode("ascii"))
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in counts:
        flat[pos : pos + c] = val
        pos += c
        val = 1 - val
    return flat.reshape(w, h).T  # column-major


def _decode_compressed_counts(s: bytes) -> List[int]:
    """COCO's modified-LEB128 run-length encoding (coco mask API cString)."""
    counts = []
    i = 0
    while i < len(s):
        x = 0
        k = 0
        more = True
        while more:
            c = s[i] - 48
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            i += 1
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return counts


def segmentation_to_mask(seg, h: int, w: int) -> np.ndarray:
    """COCO segmentation (polygon list or RLE dict) -> [h, w] uint8 mask."""
    if isinstance(seg, dict):
        return decode_rle(seg, h, w)
    mask = np.zeros((h, w), np.uint8)
    for poly in seg:
        pts = np.asarray(poly, np.float64).reshape(-1, 2)
        fill_poly(mask, np.round(pts).astype(np.int64), 1)
    return mask


class CocoDataset:
    """Indexable COCO detection/instance-segmentation dataset.

    ``category_map``: contiguous 0-based class ids from sorted COCO ids
    (the Detectron2 convention — required for converted-weight parity).
    """

    def __init__(
        self,
        annotation_file: str,
        image_root: str,
        load_masks: bool = True,
        filter_empty: bool = True,
        min_keypoints: int = 0,
    ):
        """``min_keypoints``: drop images whose annotations carry fewer than
        this many labeled keypoints in total (v > 0) — the upstream-D2
        keypoint-training filter behind
        MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE (the reference
        defines the key at lib/config/defaults.py but never consumes it)."""
        with open(annotation_file) as f:
            coco = json.load(f)
        self.image_root = image_root
        self.load_masks = load_masks
        cat_ids = sorted(c["id"] for c in coco.get("categories", []))
        self.cat_id_to_contiguous = {cid: i for i, cid in enumerate(cat_ids)}
        self.contiguous_to_cat_id = {i: cid for cid, i in self.cat_id_to_contiguous.items()}
        self.class_names = [
            c["name"] for c in sorted(coco.get("categories", []), key=lambda c: c["id"])
        ]

        anns_by_image: Dict[int, List] = {}
        for a in coco.get("annotations", []):
            anns_by_image.setdefault(a["image_id"], []).append(a)

        self.images = []
        for img in coco["images"]:
            anns = anns_by_image.get(img["id"], [])
            if filter_empty and not anns:
                continue
            if min_keypoints > 0:
                num_kp = sum(
                    int(np.asarray(a["keypoints"][2::3]).astype(bool).sum())
                    for a in anns
                    if "keypoints" in a
                )
                if num_kp < min_keypoints:
                    continue
            self.images.append((img, anns))

    def set_proposals(self, path: str) -> None:
        """Attach a Detectron2-format precomputed-proposal file (a pickle of
        {ids, boxes, objectness_logits}; boxes are absolute XYXY) for the
        MODEL.LOAD_PROPOSALS / Fast R-CNN path."""
        import pickle

        with open(path, "rb") as f:
            data = pickle.load(f, encoding="latin1")
        self._proposals = {
            int(i): (np.asarray(b, np.float32).reshape(-1, 4),
                     np.asarray(s, np.float32).reshape(-1))
            for i, b, s in zip(
                data["ids"], data["boxes"], data["objectness_logits"]
            )
        }

    def __len__(self) -> int:
        return len(self.images)

    def image_path(self, idx: int) -> str:
        """On-disk path of sample ``idx`` (``build_records`` copies its bytes)."""
        return os.path.join(self.image_root, self.images[idx][0]["file_name"])

    def image_id(self, idx: int) -> int:
        return int(self.images[idx][0]["id"])

    def sample_gt(self, idx: int) -> Dict:
        """Ground truth only, without decoding the image: the fields of
        ``__getitem__`` but ``image``, plus ``original_size``; masks stay
        uint8. Image dims come from the COCO JSON (``height``/``width``),
        else from the image file's header."""
        img_info, _ = self.images[idx]
        if "height" in img_info and "width" in img_info:
            h, w = int(img_info["height"]), int(img_info["width"])
        else:
            h, w = image_io.image_size(self.image_path(idx))
        sample = self._build_gt(idx, h, w, mask_dtype=np.uint8)
        sample["original_size"] = (h, w)
        return sample

    def _build_gt(self, idx: int, h: int, w: int, mask_dtype=np.float32) -> Dict:
        img_info, anns = self.images[idx]
        boxes, classes, is_crowd, masks, keypoints = [], [], [], [], []
        areas = []
        for a in anns:
            x, y, bw, bh = a["bbox"]
            if bw <= 0 or bh <= 0:
                continue
            boxes.append([x, y, x + bw, y + bh])
            classes.append(self.cat_id_to_contiguous[a["category_id"]])
            is_crowd.append(bool(a.get("iscrowd", 0)))
            # COCO annotation segment area — pycocotools keys OKS and the
            # small/medium/large splits on this, not the box area.
            areas.append(float(a.get("area", bw * bh)))
            if "keypoints" in a:
                keypoints.append(
                    np.asarray(a["keypoints"], np.float32).reshape(-1, 3)
                )
            if self.load_masks:
                seg = a.get("segmentation")
                masks.append(
                    segmentation_to_mask(seg, h, w)
                    if seg
                    else np.zeros((h, w), np.uint8)
                )
        sample = {
            "image_id": img_info["id"],
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "is_crowd": np.asarray(is_crowd, bool),
            "areas": np.asarray(areas, np.float32),
        }
        if self.load_masks:
            sample["masks"] = (
                np.stack(masks).astype(mask_dtype)
                if masks
                else np.zeros((0, h, w), mask_dtype)
            )
        if keypoints and len(keypoints) == len(boxes):
            sample["keypoints"] = np.stack(keypoints)
        props = getattr(self, "_proposals", None)
        if props is not None:
            pb, ps = props.get(
                img_info["id"], (np.zeros((0, 4), np.float32), np.zeros(0, np.float32))
            )
            sample["proposals"] = pb
            sample["proposal_scores"] = ps
        return sample

    def __getitem__(self, idx: int) -> Dict:
        img_info, _ = self.images[idx]
        path = os.path.join(self.image_root, img_info["file_name"])
        image = load_image_rgb(path)
        h, w = image.shape[:2]
        sample = self._build_gt(idx, h, w)
        sample["image"] = image
        return sample
