"""Box operations on dense ``[..., 4]`` XYXY tensors.

Port of the JAX package's ``structures/boxes.py``: boxes are plain
float tensors in absolute-pixel ``(x0, y0, x1, y1)`` order, batched over any
leading dimensions, with validity masks carried beside them. Every function
applies the same float32 operations in the same order as the JAX version,
so elementwise results agree bit for bit on the same inputs.

The aligned IoU family (``matched_iou``, ``matched_giou``, ``matched_diou``,
``matched_ciou``) backs YOLOv4's box loss, so its gradients are the JAX
package's too: every ``jnp.maximum`` / ``jnp.minimum`` is ``torch.maximum``
/ ``torch.minimum`` against a tensor, which, as JAX does, splits the
gradient in halves where both sides are equal (``torch.clamp`` would pass
all of it), and CIoU's trade-off ``alpha`` is detached (the JAX
``stop_gradient``).
"""

from __future__ import annotations

import math

import torch

EPS = 1e-8


def _max(x: torch.Tensor, c: float) -> torch.Tensor:
    """``jnp.maximum(x, c)``, ties' gradient halved as there."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Areas of ``[..., 4]`` xyxy boxes -> ``[...]``."""
    w = _max(boxes[..., 2] - boxes[..., 0], 0.0)
    h = _max(boxes[..., 3] - boxes[..., 1], 0.0)
    return w * h


def pairwise_intersection(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection areas of all pairs: ``[..., N, 4] x [..., M, 4] -> [..., N, M]``."""
    lt = torch.maximum(boxes1[..., :, None, :2], boxes2[..., None, :, :2])
    rb = torch.minimum(boxes1[..., :, None, 2:], boxes2[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    return wh[..., 0] * wh[..., 1]


def pairwise_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """IoU of all pairs: ``[..., N, 4] x [..., M, 4] -> [..., N, M]``. Empty pairs give 0."""
    inter = pairwise_intersection(boxes1, boxes2)
    a1 = area(boxes1)[..., :, None]
    a2 = area(boxes2)[..., None, :]
    union = a1 + a2 - inter
    iou = inter / torch.clamp(union, min=EPS)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def matched_iou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Elementwise IoU of aligned box arrays ``[..., 4] x [..., 4] -> [...]``;
    an empty union gives 0."""
    lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    wh = _max(rb - lt, 0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area(boxes1) + area(boxes2) - inter
    iou = inter / _max(union, EPS)
    return torch.where(union > 0, iou, torch.zeros_like(iou))


def _enclosing_box(boxes1: torch.Tensor, boxes2: torch.Tensor):
    lt = torch.minimum(boxes1[..., :2], boxes2[..., :2])
    rb = torch.maximum(boxes1[..., 2:], boxes2[..., 2:])
    return lt, rb


def matched_giou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Generalized IoU of aligned boxes (Rezatofighi et al., 2019)."""
    iou = matched_iou(boxes1, boxes2)
    lt, rb = _enclosing_box(boxes1, boxes2)
    wh = _max(rb - lt, 0.0)
    convex = wh[..., 0] * wh[..., 1]
    inter_lt = torch.maximum(boxes1[..., :2], boxes2[..., :2])
    inter_rb = torch.minimum(boxes1[..., 2:], boxes2[..., 2:])
    inter_wh = _max(inter_rb - inter_lt, 0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = area(boxes1) + area(boxes2) - inter
    return iou - (convex - union) / _max(convex, EPS)


def _center_distance_sq(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    c1 = (boxes1[..., :2] + boxes1[..., 2:]) * 0.5
    c2 = (boxes2[..., :2] + boxes2[..., 2:]) * 0.5
    d = c1 - c2
    return d[..., 0] ** 2 + d[..., 1] ** 2


def matched_diou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Distance IoU of aligned boxes (Zheng et al., 2020)."""
    iou = matched_iou(boxes1, boxes2)
    lt, rb = _enclosing_box(boxes1, boxes2)
    wh = _max(rb - lt, 0.0)
    diag_sq = wh[..., 0] ** 2 + wh[..., 1] ** 2
    return iou - _center_distance_sq(boxes1, boxes2) / _max(diag_sq, EPS)


def matched_ciou(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Complete IoU of aligned boxes: DIoU less the aspect-ratio penalty
    ``alpha * v``, ``alpha`` a constant in the gradient (the CIoU paper's)."""
    iou = matched_iou(boxes1, boxes2)
    diou = matched_diou(boxes1, boxes2)
    w1 = _max(boxes1[..., 2] - boxes1[..., 0], EPS)
    h1 = _max(boxes1[..., 3] - boxes1[..., 1], EPS)
    w2 = _max(boxes2[..., 2] - boxes2[..., 0], EPS)
    h2 = _max(boxes2[..., 3] - boxes2[..., 1], EPS)
    v = (4.0 / math.pi ** 2) * (torch.atan(w2 / h2) - torch.atan(w1 / h1)) ** 2
    alpha = (v / _max(1.0 - iou + v, EPS)).detach()
    return diou - alpha * v


def clip(boxes: torch.Tensor, image_size: torch.Tensor) -> torch.Tensor:
    """Clip ``[B, ..., 4]`` boxes to per-image ``image_size`` ``[B, 2]`` (h, w)."""
    size = image_size.to(boxes.dtype)
    shape = (size.shape[0],) + (1,) * (boxes.dim() - 2)
    h = size[:, 0].reshape(shape)
    w = size[:, 1].reshape(shape)
    zero = torch.zeros((), dtype=boxes.dtype, device=boxes.device)
    x0 = torch.minimum(torch.maximum(boxes[..., 0], zero), w)
    y0 = torch.minimum(torch.maximum(boxes[..., 1], zero), h)
    x1 = torch.minimum(torch.maximum(boxes[..., 2], zero), w)
    y1 = torch.minimum(torch.maximum(boxes[..., 3], zero), h)
    return torch.stack([x0, y0, x1, y1], dim=-1)


def nonempty(boxes: torch.Tensor, threshold: float = 0.0) -> torch.Tensor:
    """Mask of boxes with both sides strictly greater than ``threshold``."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return (w > threshold) & (h > threshold)


def pairwise_ioa(boxes1: torch.Tensor, boxes2: torch.Tensor) -> torch.Tensor:
    """Intersection over the area of ``boxes2`` for all pairs -> ``[..., N, M]``
    (crowd-region ignoring). Empty ``boxes2`` give 0."""
    inter = pairwise_intersection(boxes1, boxes2)
    a2 = area(boxes2)[..., None, :]
    ioa = inter / torch.clamp(a2, min=EPS)
    return torch.where(a2 > 0, ioa, torch.zeros_like(ioa))


def inside_image(boxes: torch.Tensor, image_size: torch.Tensor,
                 boundary_thresh: float = 0.0) -> torch.Tensor:
    """Mask of ``[B, ..., 4]`` boxes inside per-image ``image_size`` ``[B, 2]``
    (h, w), tolerating ``boundary_thresh`` pixels."""
    size = image_size.to(boxes.dtype)
    shape = (size.shape[0],) + (1,) * (boxes.dim() - 2)
    h = size[:, 0].reshape(shape)
    w = size[:, 1].reshape(shape)
    t = boundary_thresh
    return ((boxes[..., 0] >= -t) & (boxes[..., 1] >= -t)
            & (boxes[..., 2] <= w + t) & (boxes[..., 3] <= h + t))
