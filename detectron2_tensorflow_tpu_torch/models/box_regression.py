"""Box delta decode in the (dx, dy, dw, dh) parameterization.

Port of the JAX package's ``models/box_regression.py`` (inference
half): xyxy boxes, per-coordinate weights, and the log-space size clamp at
``log(1000 / 16)`` exactly as Detectron2 applies it.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

SCALE_CLAMP = math.log(1000.0 / 16.0)


class Box2BoxTransform:
    """Weights are (wx, wy, ww, wh); Detectron2 uses (10, 10, 5, 5) for ROI heads."""

    def __init__(self, weights: Sequence[float], scale_clamp: float = SCALE_CLAMP):
        self.weights = tuple(float(w) for w in weights)
        self.scale_clamp = scale_clamp

    def get_deltas(self, src_boxes: torch.Tensor, target_boxes: torch.Tensor) -> torch.Tensor:
        """Encode targets relative to sources: ``[..., 4] -> [..., 4]``."""
        src_w = src_boxes[..., 2] - src_boxes[..., 0]
        src_h = src_boxes[..., 3] - src_boxes[..., 1]
        src_cx = src_boxes[..., 0] + 0.5 * src_w
        src_cy = src_boxes[..., 1] + 0.5 * src_h

        tgt_w = target_boxes[..., 2] - target_boxes[..., 0]
        tgt_h = target_boxes[..., 3] - target_boxes[..., 1]
        tgt_cx = target_boxes[..., 0] + 0.5 * tgt_w
        tgt_cy = target_boxes[..., 1] + 0.5 * tgt_h

        wx, wy, ww, wh = self.weights
        eps = 1e-6
        src_w = torch.clamp(src_w, min=eps)
        src_h = torch.clamp(src_h, min=eps)
        dx = wx * (tgt_cx - src_cx) / src_w
        dy = wy * (tgt_cy - src_cy) / src_h
        dw = ww * torch.log(torch.clamp(tgt_w, min=eps) / src_w)
        dh = wh * torch.log(torch.clamp(tgt_h, min=eps) / src_h)
        return torch.stack([dx, dy, dw, dh], dim=-1)

    def apply_deltas(self, deltas: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
        """Decode deltas ``[..., k*4]`` against boxes ``[..., 4]`` -> ``[..., k*4]``
        (the k classes share the source box)."""
        widths = boxes[..., 2] - boxes[..., 0]
        heights = boxes[..., 3] - boxes[..., 1]
        cx = boxes[..., 0] + 0.5 * widths
        cy = boxes[..., 1] + 0.5 * heights

        wx, wy, ww, wh = self.weights
        shape = deltas.shape
        d = deltas.reshape(shape[:-1] + (-1, 4))
        dx = d[..., 0] / wx
        dy = d[..., 1] / wy
        dw = torch.clamp(d[..., 2] / ww, max=self.scale_clamp)
        dh = torch.clamp(d[..., 3] / wh, max=self.scale_clamp)

        pred_cx = dx * widths[..., None] + cx[..., None]
        pred_cy = dy * heights[..., None] + cy[..., None]
        pred_w = torch.exp(dw) * widths[..., None]
        pred_h = torch.exp(dh) * heights[..., None]

        out = torch.stack(
            [
                pred_cx - 0.5 * pred_w,
                pred_cy - 0.5 * pred_h,
                pred_cx + 0.5 * pred_w,
                pred_cy + 0.5 * pred_h,
            ],
            dim=-1,
        )
        return out.reshape(shape)
