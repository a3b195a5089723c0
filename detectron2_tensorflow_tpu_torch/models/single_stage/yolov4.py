"""YOLOv4: the head, its decode and inference (serving).

Port of the serving half of the JAX package's
``models/single_stage/yolov4.py`` (``YOLOV4Head`` and the ``YOLOv4``
driver's ``decode`` and ``inference``).

The head (:class:`YOLOV4Head`) runs, on each level ``i`` of
``SINGLE_STAGE_HEAD.IN_FEATURES`` (p3-p5), a 3x3 conv ``conv{i+1}`` of
``2**i * YOLOV4.CONV_DIMS`` channels (``YOLOV4.NORM``,
``YOLOV4.ACTIVATION``) and a 1x1 predictor ``pred{i+1}`` of ``A * (5 + K)``
channels with a bias: channel ``a * (5 + K) + j`` is field ``j`` (x, y, w,
h, objectness, then the K classes) of anchor ``a``.

``YOLOv4.decode`` turns the float32 maps ``[B, A * (5 + K), H, W]`` into
flat candidates. Each map is permuted to ``[B, H, W, A, 5 + K]`` before it
is reshaped, so that the flat index of a candidate is ``(y * W + x) * A +
a`` within its level, as the JAX package's NHWC maps give it, and the
levels are concatenated. A centre is ``(cell + dxy) * stride`` with ``dxy =
s * sigmoid(t) - 0.5 * (s - 1)`` (``YOLOV4.SCALE_YX`` ``s`` per level), a
size ``exp(t) * anchor`` with the anchor's ``(w, h)`` from the cell anchors
of :class:`~..anchors.YOLOAnchorGenerator`.

``YOLOv4.inference``: the score of a candidate is ``sigmoid(objectness) *
sigmoid(class)``, its class the first argmax over the classes; the top
1000 candidates by score (22743 at 608x608; ties in index order, as
``lax.top_k``) are clipped to ``image_size`` before NMS (the JAX package's
documented deviation from the TF reference, which clips after), those
above ``YOLOV4.SCORE_THRESH_TEST`` are valid, and one class-agnostic
greedy NMS (``ops.nms.nms_fixed``, ``presorted``, IoU
``YOLOV4.NMS_THRESH_TEST``) keeps ``TEST.DETECTIONS_PER_IMAGE`` slots, so
one ``nms_keep`` launch serves a batch. Empty slots score 0 with class -1.

Training is a later slice of the port: ``YOLOv4.losses`` (the YOLO
matcher, the CIoU box loss and the confidence and class losses) raises
``NotImplementedError``, and so does ``build_model(cfg, training=True)``.
"""

from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from ...ops.nms import nms_fixed
from ...ops.topk import top_k
from ...structures import Instances, boxes as box_ops
from ..anchors import YOLOAnchorGenerator
from ..layers import Conv2d

TRAINING_NOT_PORTED = (
    "YOLOv4 training (the YOLOV4Head losses: the YOLO matcher, the CIoU box loss, the "
    "confidence and class losses) is not ported yet: it is a later slice of the port, "
    "which serves and evaluates YOLOv4 only")
# Candidates kept for NMS per image (the JAX driver's topk_pre_nms).
TOPK_PRE_NMS = 1000


class YOLOV4Head(nn.Module):
    """Per level ``[B, C_l, H, W]`` -> raw maps ``[B, A * (5 + K), H, W]``."""

    def __init__(self, in_channels: Sequence[int], num_classes: int, num_anchors: int,
                 conv_dims: int, norm: str, activation: str):
        super().__init__()
        for i, ch in enumerate(in_channels):
            width = 2 ** i * conv_dims
            self.add_module(f"conv{i + 1}", Conv2d(ch, width, 3, norm=norm,
                                                   activation=activation))
            self.add_module(f"pred{i + 1}", Conv2d(width, num_anchors * (5 + num_classes), 1))

    def forward(self, features: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return [getattr(self, f"pred{i + 1}")(getattr(self, f"conv{i + 1}")(x))
                for i, x in enumerate(features)]


class YOLOv4:
    """What runs around the head: decode and inference. It holds
    configuration only."""

    def __init__(self, cfg, strides: Sequence[int]):
        h = cfg.MODEL.SINGLE_STAGE_HEAD
        y = cfg.MODEL.YOLOV4
        self.num_classes = h.NUM_CLASSES
        self.in_features = list(h.IN_FEATURES)
        self.strides = list(strides)
        self.anchor_generator = YOLOAnchorGenerator(cfg.MODEL.ANCHOR_GENERATOR.SIZES,
                                                    self.strides)
        a = self.anchor_generator.num_anchors_per_location
        if len(set(a)) != 1:
            raise ValueError("YOLOv4 needs equal anchors per level")
        self.num_anchors = a[0]
        self.scale_yx = list(y.SCALE_YX)
        if len(self.scale_yx) != len(self.strides):
            raise ValueError(f"MODEL.YOLOV4.SCALE_YX has {len(self.scale_yx)} entries for "
                             f"{len(self.strides)} levels")
        self.score_thresh = y.SCORE_THRESH_TEST
        self.nms_thresh = y.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE
        self._anchor_wh = {}  # (level, device) -> the level's anchor (w, h) in pixels, [A, 2]

    def anchor_wh(self, level: int, device) -> torch.Tensor:
        """Level ``level``'s anchor ``(w, h)`` on ``device``, copied there once:
        a copy from host memory would wait for the stream at every call."""
        key = (level, torch.device(device))
        if key not in self._anchor_wh:
            cell = self.anchor_generator.cell_anchors[level]
            self._anchor_wh[key] = torch.from_numpy(cell[:, 2:] - cell[:, :2]).to(device)
        return self._anchor_wh[key]

    def build_head(self, cfg, in_channels: Sequence[int]) -> YOLOV4Head:
        y = cfg.MODEL.YOLOV4
        return YOLOV4Head(in_channels, self.num_classes, self.num_anchors, y.CONV_DIMS,
                          y.NORM, y.ACTIVATION)

    def decode(self, preds: List[torch.Tensor]):
        """Float32 maps ``[B, A * (5 + K), H, W]`` per level -> (boxes ``[B, R,
        4]`` xyxy, objectness logits ``[B, R]``, class logits ``[B, R, K]``)
        over the ``R`` candidates of every level (module docstring)."""
        boxes_all, conf_all, cls_all = [], [], []
        for level, p in enumerate(preds):
            b, _, hh, ww = p.shape
            p = p.permute(0, 2, 3, 1).reshape(b, hh, ww, self.num_anchors, 5 + self.num_classes)
            stride = self.strides[level]
            s = self.scale_yx[level]
            gx = torch.arange(ww, dtype=torch.float32, device=p.device)[None, None, :, None]
            gy = torch.arange(hh, dtype=torch.float32, device=p.device)[None, :, None, None]
            dxy = s * torch.sigmoid(p[..., 0:2]) - 0.5 * (s - 1)
            cx = (gx + dxy[..., 0]) * stride
            cy = (gy + dxy[..., 1]) * stride
            wh = self.anchor_wh(level, p.device)
            pw = torch.exp(p[..., 2]) * wh[:, 0]
            ph = torch.exp(p[..., 3]) * wh[:, 1]
            box = torch.stack([cx - pw / 2, cy - ph / 2, cx + pw / 2, cy + ph / 2], dim=-1)
            boxes_all.append(box.reshape(b, -1, 4))
            conf_all.append(p[..., 4].reshape(b, -1))
            cls_all.append(p[..., 5:].reshape(b, -1, self.num_classes))
        return torch.cat(boxes_all, 1), torch.cat(conf_all, 1), torch.cat(cls_all, 1)

    def losses(self, preds, gt):
        raise NotImplementedError(TRAINING_NOT_PORTED)

    @torch.no_grad()
    def inference(self, preds: List[torch.Tensor], image_sizes: torch.Tensor) -> Instances:
        """Float32 head maps -> ``Instances`` with ``boxes [B, D, 4]``,
        ``scores [B, D]``, ``pred_classes [B, D]`` (-1 on empty slots) and
        ``is_valid [B, D]``."""
        boxes, conf, cls_logits = self.decode(preds)
        probs = torch.sigmoid(conf)[..., None] * torch.sigmoid(cls_logits)
        score = probs.amax(dim=-1)
        cls = probs.argmax(dim=-1)  # the first of equal maxima, as jnp.argmax
        top_scores, idx = top_k(score, min(TOPK_PRE_NMS, score.shape[1]))
        top_boxes = box_ops.clip(
            torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4)), image_sizes)
        top_cls = torch.gather(cls, 1, idx)
        out_boxes, out_scores, out_idx, out_valid = nms_fixed(
            top_boxes, top_scores, self.nms_thresh, self.detections_per_image,
            valid=top_scores > self.score_thresh, presorted=True)
        return Instances(
            boxes=out_boxes,
            scores=torch.where(out_valid, out_scores, torch.zeros_like(out_scores)),
            pred_classes=torch.where(out_valid, torch.gather(top_cls, 1, out_idx),
                                     torch.full_like(out_idx, -1)),
            is_valid=out_valid,
        )
