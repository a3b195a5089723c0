"""YOLOv4: the head, its decode, the YOLO matcher and losses, and inference.

Port of the JAX package's ``models/single_stage/yolov4.py`` (``YOLOV4Head``
and the ``YOLOv4`` class).

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

``YOLOv4.assign`` is the YOLO matcher. Each usable GT (valid, not crowd)
takes the one candidate of the level and anchor whose shape IoU with it is
the best of the 9 cell anchors (the first of equal ones), at the cell
``floor(centre / stride)`` (no clamp): flat index ``offset + (gy * W + gx)
* A + a``. That candidate responds, with the GT's box and one-hot class as
its targets. The JAX package scatters with ``.at[].set(mode="drop")``: an
index below 0 counts from the end once, one outside ``[0, R)`` is dropped,
and of two GT on one candidate the later one stays (XLA's scatter writes in
order). Here each candidate takes the largest GT index that lands on it
(``scatter_reduce`` ``amax``), the same GT on the CPU and the card, and
``respond``, the boxes and the classes all read that one. A candidate is
background when the CIoU of its box with every valid GT (crowd included) is
below ``SINGLE_STAGE_HEAD.IOU_THRESHOLDS[0]`` and it does not respond; the
``[B, G, R]`` CIoU feeds only that comparison, so it is computed without
gradients.

``YOLOv4.losses`` (float32, each summed and divided by the number of
images): ``box_loss``, ``(1 - CIoU) * (2 - area / image_area)`` on the
responding candidates times ``YOLOV4.IOU_NORMALIZER``, ``image_area`` the
padded input's; ``conf_loss``, the objectness BCE weighted by ``(respond -
sigmoid)^2`` on responding and background candidates; ``cls_loss``, the
class BCE on responding candidates times ``YOLOV4.CLS_NORMALIZER``.

``YOLOv4.inference``: the score of a candidate is ``sigmoid(objectness) *
sigmoid(class)``, its class the first argmax over the classes; the top
1000 candidates by score (22743 at 608x608; ties in index order, as
``lax.top_k``) are clipped to ``image_size`` before NMS (the JAX package's
documented deviation from the TF reference, which clips after), those
above ``YOLOV4.SCORE_THRESH_TEST`` are valid, and one class-agnostic
greedy NMS (``ops.nms.nms_fixed``, ``presorted``, IoU
``YOLOV4.NMS_THRESH_TEST``) keeps ``TEST.DETECTIONS_PER_IMAGE`` slots, so
one ``nms_keep`` launch serves a batch. Empty slots score 0 with class -1.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ...ops.nms import nms_fixed
from ...ops.topk import top_k
from ...structures import Instances, boxes as box_ops
from ..anchors import YOLOAnchorGenerator
from ..layers import Conv2d
from ..losses import sigmoid_cross_entropy

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
    """What runs around the head: decode, the matcher, the losses and
    inference. It holds configuration only."""

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
        self.cls_normalizer = y.CLS_NORMALIZER
        self.iou_normalizer = y.IOU_NORMALIZER
        self.ignore_thresh = h.IOU_THRESHOLDS[0]
        self.score_thresh = y.SCORE_THRESH_TEST
        self.nms_thresh = y.NMS_THRESH_TEST
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE
        self._anchor_wh = {}  # (level, device) -> the level's anchor (w, h) in pixels, [A, 2]
        self._levels = {}  # (grid sizes, device) -> per-level stride, width, flat offset

    def anchor_wh(self, level: int, device) -> torch.Tensor:
        """Level ``level``'s anchor ``(w, h)`` on ``device``, copied there once:
        a copy from host memory would wait for the stream at every call."""
        key = (level, torch.device(device))
        if key not in self._anchor_wh:
            cell = self.anchor_generator.cell_anchors[level]
            self._anchor_wh[key] = torch.from_numpy(cell[:, 2:] - cell[:, :2]).to(device)
        return self._anchor_wh[key]

    def cell_wh(self, device) -> torch.Tensor:
        """The ``(w, h)`` of the 9 cell anchors, level by level, ``[L * A, 2]``."""
        return torch.cat([self.anchor_wh(level, device)
                          for level in range(len(self.strides))])

    def levels(self, grid_hw: Sequence[Tuple[int, int]], device):
        """Per level, on ``device`` (copied there once, as ``anchor_wh``):
        the stride (float32), the grid's width and the offset of its first
        candidate in the flat order."""
        key = (tuple(grid_hw), torch.device(device))
        if key not in self._levels:
            offsets, off = [], 0
            for hh, ww in grid_hw:
                offsets.append(off)
                off += hh * ww * self.num_anchors
            self._levels[key] = (
                torch.tensor(self.strides, dtype=torch.float32).to(device),
                torch.tensor([ww for _, ww in grid_hw]).to(device),
                torch.tensor(offsets).to(device))
        return self._levels[key]

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

    def assign(self, pred_boxes: torch.Tensor, gt: Dict[str, torch.Tensor],
               grid_hw: Sequence[Tuple[int, int]]):
        """The matcher (module docstring) over decoded ``pred_boxes [B, R, 4]``
        on levels of ``grid_hw`` cells: ``respond [B, R]``, ``bgd [B, R]``
        (float32 0 / 1), ``tgt_boxes [B, R, 4]`` and ``tgt_cls [B, R, K]``
        (zeros where nothing responds)."""
        b, r = pred_boxes.shape[:2]
        dev = pred_boxes.device
        boxes = gt["gt_boxes"].float()
        valid = gt["gt_valid"].bool()
        crowd = gt.get("gt_is_crowd")
        usable = valid if crowd is None else valid & ~crowd.bool()
        a = self.num_anchors
        cell = self.cell_wh(dev)
        w = boxes[..., 2] - boxes[..., 0]
        h = boxes[..., 3] - boxes[..., 1]
        inter = (torch.minimum(w[..., None], cell[:, 0])
                 * torch.minimum(h[..., None], cell[:, 1]))
        union = w[..., None] * h[..., None] + cell[:, 0] * cell[:, 1] - inter
        best = (inter / torch.clamp(union, min=1e-6)).argmax(-1)  # the first of equal ones
        level, anchor = best // a, best % a
        strides, widths, offsets = self.levels(grid_hw, dev)
        stride = strides[level]
        gx = torch.floor((boxes[..., 0] + boxes[..., 2]) / 2 / stride).long()
        gy = torch.floor((boxes[..., 1] + boxes[..., 3]) / 2 / stride).long()
        idx = offsets[level] + (gy * widths[level] + gx) * a + anchor
        idx = torch.where(idx < 0, idx + r, idx)  # the JAX scatter's wrap, then its drop
        idx = torch.where(usable & (idx >= 0) & (idx < r), idx, torch.full_like(idx, r))
        order = torch.arange(boxes.shape[1], device=dev).expand_as(idx)
        winner = torch.full((b, r + 1), -1, dtype=torch.long, device=dev).scatter_reduce_(
            1, idx, order, "amax")[:, :r]
        hit = winner >= 0
        g = winner.clamp(min=0)
        tgt_boxes = torch.where(hit[..., None],
                                torch.gather(boxes, 1, g[..., None].expand(-1, -1, 4)),
                                torch.zeros((), device=dev))
        cls = torch.gather(gt["gt_classes"].long(), 1, g)
        onehot = (cls[..., None] == torch.arange(self.num_classes, device=dev)).float()
        tgt_cls = torch.where(hit[..., None], onehot, torch.zeros((), device=dev))
        respond = hit.float()
        with torch.no_grad():  # [B, G, R]: it reaches the loss through a comparison only
            ciou = box_ops.matched_ciou(boxes[:, :, None], pred_boxes[:, None])
            ciou = torch.where(valid[..., None], ciou, torch.full((), -1.0, device=dev))
            bgd = (ciou.amax(1) < self.ignore_thresh).float() * (1.0 - respond)
        return respond, bgd, tgt_boxes, tgt_cls

    def losses(self, preds: List[torch.Tensor],
               gt: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``box_loss``, ``conf_loss`` and ``cls_loss`` (module docstring) of
        the float32 head maps against the batch's GT fields ``gt_boxes``,
        ``gt_classes``, ``gt_valid`` and, when present, ``gt_is_crowd``."""
        pred_boxes, conf_logits, cls_logits = self.decode(preds)
        grid_hw = [tuple(p.shape[2:]) for p in preds]
        image_area = float((grid_hw[0][0] * self.strides[0]) * (grid_hw[0][1] * self.strides[0]))
        respond, bgd, tgt_boxes, tgt_cls = self.assign(pred_boxes.detach(), gt, grid_hw)
        num_images = float(pred_boxes.shape[0])
        ciou = box_ops.matched_ciou(pred_boxes, tgt_boxes)
        area = ((tgt_boxes[..., 2] - tgt_boxes[..., 0])
                * (tgt_boxes[..., 3] - tgt_boxes[..., 1]))
        scale = 2.0 - area / image_area
        box_loss = ((1.0 - ciou) * scale * respond).sum() * self.iou_normalizer / num_images
        conf_focal = (respond - torch.sigmoid(conf_logits)) ** 2
        conf_ce = sigmoid_cross_entropy(conf_logits, respond)
        conf_loss = (conf_focal * conf_ce * (respond + bgd)).sum() / num_images
        cls_ce = sigmoid_cross_entropy(cls_logits, tgt_cls).sum(-1)
        cls_loss = (cls_ce * respond).sum() * self.cls_normalizer / num_images
        return {"box_loss": box_loss, "conf_loss": conf_loss, "cls_loss": cls_loss}

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
