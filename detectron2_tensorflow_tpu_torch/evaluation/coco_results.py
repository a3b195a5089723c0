"""COCO-format result files (detections, segmentations, keypoints).

Port of the JAX package's ``evaluation/coco_results.py``: the standard COCO
results JSON that the evaluation server and pycocotools read, with xywh
boxes, the dataset's category ids and compressed-RLE segmentations (the
port's ``evaluation/rle.py``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

from . import rle as rle_codec


def detections_to_coco(
    image_id: int,
    boxes: np.ndarray,          # [N, 4] xyxy absolute, original resolution
    scores: np.ndarray,
    classes: np.ndarray,        # [N] contiguous ids
    masks: Optional[np.ndarray] = None,       # [N, H, W] binary
    keypoints: Optional[np.ndarray] = None,   # [N, K, 3]
    contiguous_to_cat_id: Optional[Dict[int, int]] = None,
) -> List[Dict]:
    """One image's detections -> list of COCO result records."""
    out = []
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    for i in range(len(boxes)):
        x0, y0, x1, y1 = boxes[i]
        cid = int(classes[i])
        if contiguous_to_cat_id is not None:
            cid = int(contiguous_to_cat_id.get(cid, cid))
        rec = {
            "image_id": int(image_id),
            "category_id": cid,
            "bbox": [float(x0), float(y0), float(x1 - x0), float(y1 - y0)],
            "score": float(scores[i]),
        }
        if masks is not None:
            enc = rle_codec.encode(np.asarray(masks[i], np.uint8))
            rec["segmentation"] = {
                "size": enc["size"],
                # JSON needs text; the COCO string is ASCII by construction.
                "counts": enc["counts"].decode("ascii"),
            }
        if keypoints is not None:
            rec["keypoints"] = [
                float(v) for v in np.asarray(keypoints[i]).reshape(-1)
            ]
        out.append(rec)
    return out


class CocoResultsWriter:
    """Accumulates per-image records; dumps one COCO results JSON."""

    def __init__(self, contiguous_to_cat_id: Optional[Dict[int, int]] = None):
        # JSON round-trips dict keys as strings; accept either.
        self.cat_map = (
            {int(k): int(v) for k, v in contiguous_to_cat_id.items()}
            if contiguous_to_cat_id
            else None
        )
        self._records: List[Dict] = []

    def add_image(self, image_id, boxes, scores, classes,
                  masks=None, keypoints=None) -> None:
        self._records.extend(
            detections_to_coco(
                image_id, boxes, scores, classes, masks, keypoints,
                self.cat_map,
            )
        )

    def save(self, path: str) -> int:
        with open(path, "w") as f:
            json.dump(self._records, f)
        return len(self._records)
