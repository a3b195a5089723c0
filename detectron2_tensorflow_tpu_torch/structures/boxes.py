"""Box operations on dense ``[..., 4]`` XYXY tensors.

Port of the JAX package's ``structures/boxes.py``: boxes are plain
float tensors in absolute-pixel ``(x0, y0, x1, y1)`` order, batched over any
leading dimensions, with validity masks carried beside them. Every function
applies the same float32 operations in the same order as the JAX version,
so elementwise results agree bit for bit on the same inputs.
"""

from __future__ import annotations

import torch

EPS = 1e-8


def area(boxes: torch.Tensor) -> torch.Tensor:
    """Areas of ``[..., 4]`` xyxy boxes -> ``[...]``."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
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
