"""Semantic segmentation evaluation: confusion-matrix mIoU, mACC, pACC and fwIoU.

The port's numpy copy of the JAX package's ``evaluation/sem_seg_eval.py``:
one ``[K, K]`` confusion matrix over every labelled pixel (GT rows,
prediction columns); IoU and accuracy are averaged over the classes that
occur in the GT, in percent.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SemSegEvaluator:
    def __init__(self, num_classes: int, ignore_label: int = -1):
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self._conf = np.zeros((num_classes, num_classes), np.int64)

    def add_image(self, gt: np.ndarray, pred: np.ndarray) -> None:
        """``gt`` and ``pred``: ``[H, W]`` int class maps at the same resolution."""
        valid = gt != self.ignore_label
        idx = gt[valid].astype(np.int64) * self.num_classes + pred[valid].astype(np.int64)
        self._conf += np.bincount(idx, minlength=self.num_classes ** 2).reshape(
            self.num_classes, self.num_classes)

    def evaluate(self) -> Dict[str, float]:
        conf = self._conf.astype(np.float64)
        tp = np.diag(conf)
        gt_total = conf.sum(1)
        union = gt_total + conf.sum(0) - tp
        present = gt_total > 0
        iou = np.where(union > 0, tp / np.maximum(union, 1e-10), 0.0)
        acc = np.where(gt_total > 0, tp / np.maximum(gt_total, 1e-10), 0.0)
        return {
            "mIoU": 100 * float(iou[present].mean()) if present.any() else 0.0,
            "mACC": 100 * float(acc[present].mean()) if present.any() else 0.0,
            "pACC": 100 * float(tp.sum() / max(gt_total.sum(), 1e-10)),
            "fwIoU": 100 * float((iou * gt_total / max(gt_total.sum(), 1e-10)).sum()),
        }
