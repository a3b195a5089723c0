"""Panoptic quality (PQ, with SQ and RQ, over all, thing and stuff categories).

The port's numpy copy of the JAX package's ``evaluation/panoptic_eval.py``
(Kirillov et al. 2019): a GT and a predicted segment of one category match
when their IoU exceeds 0.5; the union leaves out the prediction's overlap
with GT void (panopticapi's rule); crowd GT segments match nothing and count
no miss; an unmatched prediction that lies more than half on void or on a
crowd region of its category is not counted as a false positive. PQ =
sum(IoU of matches) / (TP + FP / 2 + FN / 2) per category, averaged over the
categories that have any segment, in percent.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List

import numpy as np

VOID = 0


class PanopticEvaluator:
    def __init__(self, categories: Dict[int, bool]):
        """``categories``: ``{category_id: is_thing}``."""
        self.categories = dict(categories)
        self.iou_sum = defaultdict(float)
        self.tp = defaultdict(int)
        self.fp = defaultdict(int)
        self.fn = defaultdict(int)

    def add_image(self, gt_map: np.ndarray, gt_segments: List[Dict], pred_map: np.ndarray,
                  pred_segments: List[Dict]) -> None:
        """Maps: ``[H, W]`` int segment ids (0 void). Segments: dicts with
        ``id`` and ``category_id`` (and, on the GT, optionally ``iscrowd``)."""
        gt_by_id = {s["id"]: s for s in gt_segments}
        pred_by_id = {s["id"]: s for s in pred_segments}
        base = int(pred_map.max() + 2)
        keys, counts = np.unique(gt_map.astype(np.int64) * base + pred_map, return_counts=True)
        inter = {(int(k) // base, int(k) % base): int(c) for k, c in zip(keys, counts)}
        gt_areas = {s["id"]: int((gt_map == s["id"]).sum()) for s in gt_segments}
        pred_areas = {s["id"]: int((pred_map == s["id"]).sum()) for s in pred_segments}

        matched_gt, matched_pred = set(), set()
        for (gid, pid), i in inter.items():
            if gid == VOID or pid == VOID:
                continue
            g, p = gt_by_id.get(gid), pred_by_id.get(pid)
            if g is None or p is None or g.get("iscrowd", 0):
                continue
            if g["category_id"] != p["category_id"]:
                continue
            union = gt_areas[gid] + pred_areas[pid] - i - inter.get((VOID, pid), 0)
            iou = i / max(union, 1)
            if iou > 0.5:
                c = g["category_id"]
                self.iou_sum[c] += iou
                self.tp[c] += 1
                matched_gt.add(gid)
                matched_pred.add(pid)

        crowd_by_cat = {s["category_id"]: s["id"] for s in gt_segments if s.get("iscrowd", 0)}
        for s in gt_segments:
            if s["id"] not in matched_gt and not s.get("iscrowd", 0):
                self.fn[s["category_id"]] += 1
        for s in pred_segments:
            if s["id"] in matched_pred:
                continue
            area = pred_areas[s["id"]]
            ignored = inter.get((VOID, s["id"]), 0)
            crowd_id = crowd_by_cat.get(s["category_id"])
            if crowd_id is not None:
                ignored += inter.get((crowd_id, s["id"]), 0)
            if area > 0 and ignored / area > 0.5:
                continue
            self.fp[s["category_id"]] += 1

    def evaluate(self) -> Dict[str, float]:
        def agg(cats):
            pq, sq, rq = [], [], []
            for c in cats:
                tp, fp, fn = self.tp[c], self.fp[c], self.fn[c]
                if tp + fp + fn == 0:
                    continue
                s = self.iou_sum[c] / tp if tp else 0.0
                r = tp / (tp + 0.5 * fp + 0.5 * fn)
                pq.append(s * r)
                sq.append(s)
                rq.append(r)
            n = max(len(pq), 1)
            return 100 * sum(pq) / n, 100 * sum(sq) / n, 100 * sum(rq) / n

        out = {}
        for suffix, cats in (("", list(self.categories)),
                             ("_th", [c for c, t in self.categories.items() if t]),
                             ("_st", [c for c, t in self.categories.items() if not t])):
            for name, v in zip(("PQ", "SQ", "RQ"), agg(cats)):
                out[name + suffix] = v
        return {k: out[k] for k in ("PQ", "SQ", "RQ", "PQ_th", "SQ_th", "RQ_th",
                                    "PQ_st", "SQ_st", "RQ_st")}
