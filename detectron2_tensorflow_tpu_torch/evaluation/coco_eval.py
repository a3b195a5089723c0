"""COCO-style AP evaluation in numpy.

Port of the JAX package's ``evaluation/coco_eval.py`` (bbox and segm): the
COCOeval algorithm (greedy per-category matching over IoU thresholds
0.50:0.05:0.95, crowd-ignore semantics, area ranges, 101-point interpolated
precision). Keypoint OKS and the proposal-recall evaluator wait for their
families.

Inputs are plain dicts at ORIGINAL image resolution:
  gt:  boxes [G,4] xyxy, classes [G], is_crowd [G], (masks [G,H,W] bool)
  det: boxes [D,4] xyxy, scores [D], classes [D], (masks [D,H,W] bool)
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

IOU_THRESHS = np.linspace(0.5, 0.95, 10)
RECALL_GRID = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "small": (0.0, 32.0**2),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = (1, 10, 100)


def box_iou_matrix(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    """[D, G] IoU; crowd gt uses intersection / det-area (COCO semantics)."""
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), np.float64)
    lt = np.maximum(dt[:, None, :2], gt[None, :, :2])
    rb = np.minimum(dt[:, None, 2:], gt[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    a_dt = ((dt[:, 2] - dt[:, 0]) * (dt[:, 3] - dt[:, 1]))[:, None]
    a_gt = ((gt[:, 2] - gt[:, 0]) * (gt[:, 3] - gt[:, 1]))[None, :]
    union = np.where(iscrowd[None, :], a_dt, a_dt + a_gt - inter)
    return inter / np.maximum(union, 1e-10)


def mask_iou_matrix(dt: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray) -> np.ndarray:
    if len(dt) == 0 or len(gt) == 0:
        return np.zeros((len(dt), len(gt)), np.float64)
    d = dt.reshape(len(dt), -1).astype(np.float64)
    g = gt.reshape(len(gt), -1).astype(np.float64)
    inter = d @ g.T
    a_dt = d.sum(1)[:, None]
    a_gt = g.sum(1)[None, :]
    union = np.where(iscrowd[None, :], a_dt, a_dt + a_gt - inter)
    return inter / np.maximum(union, 1e-10)


def _match_image(
    dt_scores, ious, gt_ignore, iscrowd, num_thresh
):
    """COCOeval's per-image greedy matching.

    Returns (dt_matched_gt [T, D] int, dt_ignore [T, D] bool).
    """
    d = len(dt_scores)
    g = ious.shape[1]
    gtm = -np.ones((num_thresh, g), np.int64)
    dtm = -np.ones((num_thresh, d), np.int64)
    dt_ig = np.zeros((num_thresh, d), bool)
    order_gt = np.argsort(gt_ignore, kind="stable")  # non-ignored first
    for ti, t in enumerate(IOU_THRESHS[:num_thresh]):
        for di in range(d):
            best = -1
            best_iou = min(t, 1 - 1e-10)
            for gi in order_gt:
                if gtm[ti, gi] >= 0 and not iscrowd[gi]:
                    continue
                # Once matched to a non-ignored gt, never switch to ignored.
                if best >= 0 and not gt_ignore[best] and gt_ignore[gi]:
                    break
                if ious[di, gi] < best_iou:
                    continue
                best_iou = ious[di, gi]
                best = gi
            if best >= 0:
                dtm[ti, di] = best
                gtm[ti, best] = di
                dt_ig[ti, di] = gt_ignore[best]
    return dtm, dt_ig


class CocoEvaluator:
    """Accumulates per-image GT/detections, computes COCO APs.

    ``iou_type``: "bbox" or "segm" ("keypoints" waits for the keypoint
    family and raises).
    """

    def __init__(self, num_classes: int, iou_type: str = "bbox",
                 class_names: Optional[List[str]] = None,
                 per_category: bool = False,
                 all_per_category: bool = False):
        if iou_type == "keypoints":
            raise NotImplementedError("keypoint evaluation (OKS) is not ported")
        if iou_type not in ("bbox", "segm"):
            raise ValueError(f"unknown iou_type '{iou_type}'")
        self.num_classes = num_classes
        self.iou_type = iou_type
        self.class_names = class_names
        self.per_category = per_category
        # EVAL.ALL_METRICS_PER_CATEGORY (reference evaluation.py:108 /
        # coco_evaluator.py:19-32): per-category rows for EVERY summary
        # metric (AP50/AP75/APs/m/l), not just mAP.
        self.all_per_category = all_per_category
        # per (class, area) lists across images
        self._entries: List[Dict] = []

    def add_image(self, gt: Dict, det: Dict) -> None:
        """Record one image's ground truth and detections (original res)."""
        use_masks = self.iou_type == "segm"
        gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)
        gt_classes = np.asarray(gt["classes"], np.int64).reshape(-1)
        iscrowd = np.asarray(gt.get("is_crowd", np.zeros(len(gt_boxes), bool)), bool)
        dt_boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)
        dt_scores = np.asarray(det["scores"], np.float64).reshape(-1)
        dt_classes = np.asarray(det["classes"], np.int64).reshape(-1)

        # pycocotools gates area ranges on the annotation segment area
        # (gt['area']) for every iou type; fall back to mask sum / box area
        # when the caller didn't supply it.
        if gt.get("areas") is not None and len(gt["areas"]) == len(gt_boxes):
            gt_area = np.asarray(gt["areas"], np.float64)
        elif use_masks:
            gt_area = np.asarray(
                [m.sum() for m in np.asarray(gt["masks"], bool)], np.float64
            ) if len(gt_boxes) else np.zeros(0)
        else:
            gt_area = (gt_boxes[:, 2] - gt_boxes[:, 0]) * (gt_boxes[:, 3] - gt_boxes[:, 1])
        dt_area = (dt_boxes[:, 2] - dt_boxes[:, 0]) * (dt_boxes[:, 3] - dt_boxes[:, 1])

        entry = {"per_class": {}}
        for c in np.union1d(gt_classes, dt_classes):
            gsel = gt_classes == c
            dsel = dt_classes == c
            order = np.argsort(-dt_scores[dsel], kind="stable")
            if use_masks:
                gm = np.asarray(gt["masks"], bool)[gsel] if gsel.any() else np.zeros((0, 1, 1), bool)
                dm = np.asarray(det["masks"], bool)[dsel][order] if dsel.any() else np.zeros((0, 1, 1), bool)
                ious = mask_iou_matrix(dm, gm, iscrowd[gsel])
            else:
                ious = box_iou_matrix(dt_boxes[dsel][order], gt_boxes[gsel], iscrowd[gsel])
            entry["per_class"][int(c)] = {
                "scores": dt_scores[dsel][order],
                "dt_area": dt_area[dsel][order],
                "gt_area": gt_area[gsel],
                "iscrowd": iscrowd[gsel],
                "ious": ious,
            }
        self._entries.append(entry)

    def evaluate(self) -> Dict[str, float]:
        T = len(IOU_THRESHS)
        stats = {}
        ap_per_class: Dict[str, Dict[int, float]] = {}
        for area_name, (amin, amax) in AREA_RANGES.items():
            for max_det in MAX_DETS:
                if area_name != "all" and max_det != 100:
                    continue
                ap_all, ar_all = [], []
                for c in range(self.num_classes):
                    scores_l, tps_l, igs_l = [], [], []
                    n_gt = 0
                    for e in self._entries:
                        pc = e["per_class"].get(c)
                        if pc is None:
                            continue
                        gt_ig = self._gt_ignore(pc, amin, amax)
                        n_gt += int((~gt_ig).sum())
                        k = min(max_det, len(pc["scores"]))
                        ious = pc["ious"][:k]
                        dtm, dt_ig = _match_image(
                            pc["scores"][:k], ious, gt_ig, pc["iscrowd"], T
                        )
                        # Unmatched dts outside the area range are ignored.
                        out_of_area = (pc["dt_area"][:k] < amin) | (
                            pc["dt_area"][:k] > amax
                        )
                        dt_ig = dt_ig | ((dtm < 0) & out_of_area[None, :])
                        scores_l.append(pc["scores"][:k])
                        tps_l.append(dtm >= 0)
                        igs_l.append(dt_ig)
                    if n_gt == 0:
                        continue
                    if scores_l:
                        scores = np.concatenate(scores_l)
                        tps = np.concatenate(tps_l, axis=1)
                        igs = np.concatenate(igs_l, axis=1)
                        order = np.argsort(-scores, kind="mergesort")
                        tps = tps[:, order]
                        igs = igs[:, order]
                        ap_t, ar_t = [], []
                        for ti in range(T):
                            keep = ~igs[ti]
                            tp = np.cumsum(tps[ti][keep])
                            fp = np.cumsum(~tps[ti][keep])
                            rec = tp / n_gt
                            prec = tp / np.maximum(tp + fp, 1e-10)
                            # monotone-decreasing envelope + 101-pt interp
                            prec = np.maximum.accumulate(prec[::-1])[::-1]
                            idx = np.searchsorted(rec, RECALL_GRID, side="left")
                            p = np.where(
                                idx < len(prec), prec[np.minimum(idx, max(len(prec) - 1, 0))], 0.0
                            ) if len(prec) else np.zeros_like(RECALL_GRID)
                            ap_t.append(p.mean())
                            ar_t.append(rec[-1] if len(rec) else 0.0)
                        ap_c = float(np.mean(ap_t))
                        ar_c = float(np.mean(ar_t))
                    else:
                        ap_c, ar_c = 0.0, 0.0
                    ap_all.append(ap_c)
                    ar_all.append(ar_c)
                    if area_name == "all" and max_det == 100:
                        ap_per_class.setdefault("AP", {})[c] = ap_c
                    elif area_name != "all":
                        ap_per_class.setdefault(
                            f"AP{area_name[0]}", {}
                        )[c] = ap_c
                mean_ap = float(np.mean(ap_all)) if ap_all else float("nan")
                mean_ar = float(np.mean(ar_all)) if ar_all else float("nan")
                if area_name == "all" and max_det == 100:
                    stats["AP"] = 100 * mean_ap
                    stats["AR@100"] = 100 * mean_ar
                elif area_name == "all":
                    stats[f"AR@{max_det}"] = 100 * mean_ar
                else:
                    stats[f"AP{area_name[0]}"] = 100 * mean_ap
                    stats[f"AR{area_name[0]}"] = 100 * mean_ar

        # AP at fixed thresholds 0.5 / 0.75 (all area, 100 dets)
        for name, ti in (("AP50", 0), ("AP75", 5)):
            mean_v, by_class = self._ap_at_threshold(ti)
            stats[name] = 100 * mean_v
            ap_per_class[name] = by_class
        if (self.per_category or self.all_per_category) and self.class_names:
            for c, v in ap_per_class.get("AP", {}).items():
                stats[f"AP-{self.class_names[c]}"] = 100 * v
        if self.all_per_category and self.class_names:
            for metric in ("AP50", "AP75", "APs", "APm", "APl"):
                for c, v in ap_per_class.get(metric, {}).items():
                    stats[f"{metric}-{self.class_names[c]}"] = 100 * v
        return stats

    def _gt_ignore(self, pc, amin, amax):
        return pc["iscrowd"] | (pc["gt_area"] < amin) | (pc["gt_area"] > amax)

    def _ap_at_threshold(self, ti: int):
        """Mean AP at one IoU threshold + the per-class values."""
        amin, amax = AREA_RANGES["all"]
        aps = []
        by_class = {}
        for c in range(self.num_classes):
            scores_l, tps_l, igs_l = [], [], []
            n_gt = 0
            for e in self._entries:
                pc = e["per_class"].get(c)
                if pc is None:
                    continue
                gt_ig = self._gt_ignore(pc, amin, amax)
                n_gt += int((~gt_ig).sum())
                k = min(100, len(pc["scores"]))
                dtm, dt_ig = _match_image(
                    pc["scores"][:k], pc["ious"][:k], gt_ig, pc["iscrowd"], len(IOU_THRESHS)
                )
                scores_l.append(pc["scores"][:k])
                tps_l.append(dtm[ti] >= 0)
                igs_l.append(dt_ig[ti])
            if n_gt == 0:
                continue
            if not scores_l:
                aps.append(0.0)
                by_class[c] = 0.0
                continue
            scores = np.concatenate(scores_l)
            tps = np.concatenate(tps_l)
            igs = np.concatenate(igs_l)
            order = np.argsort(-scores, kind="mergesort")
            tps, igs = tps[order], igs[order]
            keep = ~igs
            tp = np.cumsum(tps[keep])
            fp = np.cumsum(~tps[keep])
            rec = tp / n_gt
            prec = tp / np.maximum(tp + fp, 1e-10)
            prec = np.maximum.accumulate(prec[::-1])[::-1]
            idx = np.searchsorted(rec, RECALL_GRID, side="left")
            p = (
                np.where(idx < len(prec), prec[np.minimum(idx, max(len(prec) - 1, 0))], 0.0)
                if len(prec)
                else np.zeros_like(RECALL_GRID)
            )
            aps.append(float(p.mean()))
            by_class[c] = aps[-1]
        return (float(np.mean(aps)) if aps else float("nan")), by_class
