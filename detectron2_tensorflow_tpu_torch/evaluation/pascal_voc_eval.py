"""Pascal VOC detection evaluation (AP at one IoU, CorLoc) in numpy.

Port of the JAX package's ``evaluation/pascal_voc_eval.py``: per class,
detections in descending score are matched greedily to the ground truth at
one IoU threshold (a detection on a difficult box is ignored), AP is the
area under the monotone precision envelope (VOC 2010 and later), and CorLoc
is the share of images with a class's ground truth whose best detection of
that class hits one of its boxes.

Inputs are plain dicts at the original image resolution:
  gt:  boxes [G, 4] xyxy, classes [G], (is_difficult [G], is_group_of [G],
       masks [G, H, W] bool)
  det: boxes [D, 4] xyxy, scores [D], classes [D], (masks [D, H, W] bool)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from .coco_eval import box_iou_matrix


def compute_average_precision(precision: np.ndarray, recall: np.ndarray) -> float:
    """VOC 2010+ AP: the area under the monotone precision envelope."""
    if len(precision) == 0:
        return 0.0
    rec = np.concatenate([[0.0], recall, [1.0]])
    prec = np.concatenate([[0.0], precision, [0.0]])
    prec = np.maximum.accumulate(prec[::-1])[::-1]
    idx = np.where(rec[1:] != rec[:-1])[0]
    return float(np.sum((rec[idx + 1] - rec[idx]) * prec[idx + 1]))


def _box_iou_1_to_many(db: np.ndarray, g_boxes: np.ndarray) -> np.ndarray:
    return box_iou_matrix(db[None], g_boxes, np.zeros(len(g_boxes), bool))[0]


def _box_ioa_1_to_many(db: np.ndarray, g_boxes: np.ndarray) -> np.ndarray:
    """Intersection over the detection's area: COCO's crowd rule."""
    return box_iou_matrix(db[None], g_boxes, np.ones(len(g_boxes), bool))[0]


def _mask_overlaps(dm: np.ndarray, gms: np.ndarray) -> np.ndarray:
    """``(intersections [M], detection area)`` of one mask against ``[M, H, W]``."""
    d = dm.reshape(-1).astype(np.float64)
    return gms.reshape(len(gms), -1).astype(np.float64) @ d, d.sum()


def _mask_iou(dm: np.ndarray, gms: np.ndarray) -> np.ndarray:
    inter, d_area = _mask_overlaps(dm, gms)
    union = gms.reshape(len(gms), -1).astype(np.float64).sum(1) + d_area - inter
    return inter / np.maximum(union, 1e-10)


def _corpus_ap(scores: np.ndarray, tp: np.ndarray, num_gt: float) -> float:
    """AP of (score, TP credit) pairs against ``num_gt``: a pair with no
    credit is a false positive; fractional group-of credit counts as TP only."""
    tp = tp[np.argsort(-scores, kind="mergesort")]
    cum_tp = np.cumsum(tp)
    cum_fp = np.cumsum(tp <= 0)
    return compute_average_precision(cum_tp / np.maximum(cum_tp + cum_fp, 1e-10),
                                     cum_tp / num_gt)


class PascalVocEvaluator:
    """Pascal VOC detection / instance-segmentation evaluator.

    ``weighted``: one AP over every class's detections against the total GT
    count, instead of the mean of the classes' APs. ``use_masks``: match by
    mask IoU instead of box IoU. ``group_of_weight``: Open-Images group-of
    boxes (``is_group_of``) take no part in the IoU matching; a detection
    left unmatched there is matched to them by intersection over its own
    area, and is then ignored. At a weight above 0 each group-of box that
    some detection hit adds one pseudo-detection at the best such score with
    ``group_of_weight`` of TP credit, and every group-of box adds
    ``group_of_weight`` to its class's GT count. A class with no GT count is
    left out of mAP and CorLoc.
    """

    def __init__(self, num_classes: int, matching_iou_threshold: float = 0.5,
                 class_names: Optional[List[str]] = None, weighted: bool = False,
                 use_masks: bool = False, group_of_weight: float = 0.0):
        self.num_classes = num_classes
        self.iou_thresh = matching_iou_threshold
        self.class_names = class_names
        self.weighted = weighted
        self.use_masks = use_masks
        self.group_of_weight = float(group_of_weight)
        self._scores = [[] for _ in range(num_classes)]
        self._tp = [[] for _ in range(num_classes)]
        self._num_gt = np.zeros(num_classes, np.float64)
        self._images_with_gt = np.zeros(num_classes, np.int64)
        self._images_correctly_detected = np.zeros(num_classes, np.int64)

    def add_image(self, gt: Dict, det: Dict) -> None:
        gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        gt_classes = np.asarray(gt["classes"]).reshape(-1)
        difficult = np.asarray(gt.get("is_difficult", np.zeros(len(gt_boxes), bool)))
        group_of = np.asarray(gt.get("is_group_of", np.zeros(len(gt_boxes), bool)))
        dt_boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        dt_scores = np.asarray(det["scores"], np.float64).reshape(-1)
        dt_classes = np.asarray(det["classes"]).reshape(-1)
        gt_masks = np.asarray(gt["masks"], bool) if self.use_masks else None
        dt_masks = np.asarray(det["masks"], bool) if self.use_masks else None

        for c in range(self.num_classes):
            g_sel = gt_classes == c
            d_sel = dt_classes == c
            ng, go = g_sel & ~group_of, g_sel & group_of
            g_boxes, g_diff, go_boxes = gt_boxes[ng], difficult[ng], gt_boxes[go]
            g_masks = gt_masks[ng] if self.use_masks else None
            go_masks = gt_masks[go] if self.use_masks else None
            self._num_gt[c] += float((~g_diff).sum())
            self._num_gt[c] += self.group_of_weight * float(go.sum())
            # CorLoc's images: any GT of the class, difficult and group-of included.
            if g_sel.any():
                self._images_with_gt[c] += 1
            if not d_sel.any():
                continue
            order = np.argsort(-dt_scores[d_sel], kind="stable")
            d_boxes = dt_boxes[d_sel][order]
            d_masks = dt_masks[d_sel][order] if self.use_masks else None
            d_scores = dt_scores[d_sel][order]

            # CorLoc: the top detection against all the class's GT, by plain IoU.
            if g_sel.any():
                top_iou = (_mask_iou(d_masks[0], gt_masks[g_sel]) if self.use_masks
                           else _box_iou_1_to_many(d_boxes[0], gt_boxes[g_sel]))
                if top_iou.max() >= self.iou_thresh:
                    self._images_correctly_detected[c] += 1

            matched = np.zeros(len(g_boxes), bool)
            go_scores = np.zeros(len(go_boxes), np.float64)  # best hit of each group-of box
            for i, db in enumerate(d_boxes):
                if len(g_boxes):  # stage 1: IoU against the other boxes
                    iou = (_mask_iou(d_masks[i], g_masks) if self.use_masks
                           else _box_iou_1_to_many(db, g_boxes))
                    j = int(np.argmax(iou))
                    if iou[j] >= self.iou_thresh:
                        if g_diff[j]:
                            continue  # a difficult box: the detection is ignored
                        if not matched[j]:
                            matched[j] = True
                            self._scores[c].append(d_scores[i])
                            self._tp[c].append(1.0)
                            continue
                if len(go_boxes):  # stage 2: a false positive so far, by IoA
                    if self.use_masks:
                        inter, d_area = _mask_overlaps(d_masks[i], go_masks)
                        ioa = inter / np.maximum(d_area, 1e-10)
                    else:
                        ioa = _box_ioa_1_to_many(db, go_boxes)
                    j = int(np.argmax(ioa))
                    if ioa[j] >= self.iou_thresh:
                        go_scores[j] = max(go_scores[j], d_scores[i])
                        continue
                self._scores[c].append(d_scores[i])
                self._tp[c].append(0.0)
            if self.group_of_weight > 0:
                for s in go_scores[go_scores > 0]:
                    self._scores[c].append(float(s))
                    self._tp[c].append(self.group_of_weight)

    def evaluate(self) -> Dict[str, float]:
        aps, corlocs, all_scores, all_tp = [], [], [], []
        out = {}
        for c in range(self.num_classes):
            if self._num_gt[c] == 0:
                continue
            scores = np.asarray(self._scores[c])
            tp = np.asarray(self._tp[c], np.float64)
            if self.weighted:
                all_scores.append(scores)
                all_tp.append(tp)
            ap = _corpus_ap(scores, tp, self._num_gt[c])
            aps.append(ap)
            if self._images_with_gt[c]:
                corlocs.append(self._images_correctly_detected[c] / self._images_with_gt[c])
            if self.class_names:
                out[f"AP-{self.class_names[c]}"] = 100 * ap
        if self.weighted:
            scores = np.concatenate(all_scores) if all_scores else np.zeros(0)
            tp = np.concatenate(all_tp) if all_tp else np.zeros(0)
            out["mAP"] = 100 * _corpus_ap(scores, tp, max(float(self._num_gt.sum()), 1.0))
        else:
            out["mAP"] = 100 * float(np.mean(aps)) if aps else 0.0
        out["CorLoc"] = 100 * float(np.mean(corlocs)) if corlocs else 0.0
        return out
