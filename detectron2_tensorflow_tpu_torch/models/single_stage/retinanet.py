"""RetinaNet: the head (shared conv towers), focal-loss training and dense
inference.

Port of the JAX package's ``models/single_stage/retinanet.py``
(``RetinaNetHead`` and the ``RetinaNet`` class around it). The head runs the same two
towers of ``NUM_CONVS`` 3x3 convs + ReLU (256 wide, no norm) on every level
(p3-p7), then a 3x3 ``cls_score`` (A * K logits, bias ``-log((1 - p) / p)``
at init) and a 3x3 ``bbox_pred`` (A * 4 deltas). Module names follow
Detectron2 (``head.cls_subnet.{0,2,4,6}``, ``head.bbox_subnet.*``,
``head.cls_score``, ``head.bbox_pred``): each tower is a ``Sequential`` of
conv, ReLU pairs.

Training (``RetinaNet.losses``): every anchor is matched to the GT by a
dense ``[B, G, R]`` IoU (``Matcher([0.4, 0.5], [0, -1, 1])`` with
low-quality matches; crowd boxes match like any other, as in the JAX
package), the sigmoid focal loss over the one-hot classes of the valid
anchors and the smooth L1 on the positives' deltas, both divided by the
EMA normalizer ``0.9 * norm + 0.1 * max(num_pos, 1)``.

Inference (``RetinaNet.inference``), per level and image: an exact
two-stage top-k (``TOPK_CANDIDATES_TEST`` positions by their best class
through ``ops.topk.spatial_top_k``, then the top-k of their k x K sigmoid
scores, ties to the lower index), decode and clip, the candidates above
``SCORE_THRESH_TEST`` valid; then one class-aware NMS over every level's
candidates of the image to ``DETECTIONS_PER_IMAGE`` slots.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ...ops.nms import class_aware_nms
from ...ops.topk import spatial_top_k, top_k
from ...structures import Instances, boxes as box_ops
from ..anchors import build_anchor_generator
from ..box_regression import Box2BoxTransform
from ..layers import Conv2d
from ..losses import sigmoid_focal_loss, smooth_l1_loss
from ..matcher import Matcher


class RetinaNetHead(nn.Module):
    """Per level ``[B, C, H, W]`` -> logits ``[B, H, W, A*K]`` and deltas
    ``[B, H, W, A*4]`` (NHWC), the towers shared across levels."""

    def __init__(self, in_channels: int, num_classes: int, num_anchors: int,
                 num_convs: int, prior_prob: float, conv_channels: int = 256):
        super().__init__()
        towers = {"cls_subnet": [], "bbox_subnet": []}
        for layers in towers.values():
            ch = in_channels
            for _ in range(num_convs):
                layers += [Conv2d(ch, conv_channels, 3), nn.ReLU()]
                ch = conv_channels
        self.cls_subnet = nn.Sequential(*towers["cls_subnet"])
        self.bbox_subnet = nn.Sequential(*towers["bbox_subnet"])
        self.cls_score = Conv2d(conv_channels, num_anchors * num_classes, 3)
        self.bbox_pred = Conv2d(conv_channels, num_anchors * 4, 3)
        # The classifier's initial bias: every anchor starts at prior_prob.
        self.prior_bias = -math.log((1 - prior_prob) / prior_prob)

    def forward(self, features: Sequence[torch.Tensor]):
        logits, deltas = [], []
        for x in features:
            logits.append(self.cls_score(self.cls_subnet(x)).permute(0, 2, 3, 1))
            deltas.append(self.bbox_pred(self.bbox_subnet(x)).permute(0, 2, 3, 1))
        return logits, deltas


def level_top_k(logit: torch.Tensor, num_classes: int, topk: int):
    """The top ``min(topk, H*W*A*K)`` sigmoid scores of one level's float32
    logits ``[B, H, W, A*K]``: (scores ``[B, k]``, anchor index ``[B, k]``
    in (y, x, a) order, class ``[B, k]``), ties to the lower flat index.

    Exact, as the JAX package's two stages: a (position, class) pair of the
    top k has its position among the top k positions by best class (else k
    positions would each hold a higher pair), so the k positions that
    ``spatial_top_k`` picks hold all of them, and the top k of their k x K
    scores is the flat top k."""
    b, hh, ww = logit.shape[:3]
    per_pos = logit.reshape(b, -1, num_classes)  # [B, HWA, K]
    n = per_pos.shape[1]
    k = min(topk, n * num_classes)
    kpos = min(k, n)
    pos_max = per_pos.amax(dim=-1).reshape(b, hh, ww, n // (hh * ww))
    _, pos_idx = spatial_top_k(pos_max, kpos)
    sel = torch.sigmoid(torch.gather(per_pos, 1, pos_idx[..., None].expand(b, kpos, num_classes)))
    scores, flat_idx = top_k(sel.reshape(b, -1), k)
    anchor_idx = torch.gather(pos_idx, 1, torch.div(flat_idx, num_classes, rounding_mode="floor"))
    return scores, anchor_idx, flat_idx % num_classes


class RetinaNet:
    """What runs around the head: anchors, GT assignment and losses, and
    inference. It holds configuration only; the EMA loss normalizer is the
    caller's (``SingleStageDetector.loss_normalizer``)."""

    momentum = 0.9  # of the loss normalizer

    def __init__(self, cfg, strides: Sequence[int]):
        h = cfg.MODEL.SINGLE_STAGE_HEAD
        r = cfg.MODEL.RETINANET
        self.in_features = list(h.IN_FEATURES)
        self.num_classes = h.NUM_CLASSES
        self.anchor_generator = build_anchor_generator(cfg, strides)
        a = self.anchor_generator.num_anchors_per_location
        if len(set(a)) != 1:
            raise ValueError("RetinaNet needs equal anchors per level")
        self.num_anchors = a[0]
        self.box2box = Box2BoxTransform(r.BBOX_REG_WEIGHTS)
        self.matcher = Matcher(h.IOU_THRESHOLDS, h.IOU_LABELS, allow_low_quality_matches=True)
        self.focal_alpha = r.FOCAL_LOSS_ALPHA
        self.focal_gamma = r.FOCAL_LOSS_GAMMA
        self.smooth_l1_beta = r.SMOOTH_L1_LOSS_BETA
        self.score_thresh = r.SCORE_THRESH_TEST
        self.topk_candidates = r.TOPK_CANDIDATES_TEST
        self.nms_thresh = r.NMS_THRESH_TEST
        self.nms_class_agnostic = r.NMS_CLS_AGNOSTIC
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE

    def _anchors(self, logits: List[torch.Tensor]) -> List[torch.Tensor]:
        return self.anchor_generator([(l.shape[1], l.shape[2]) for l in logits],
                                     device=logits[0].device)

    def losses(self, logits: List[torch.Tensor], deltas: List[torch.Tensor],
               gt: Dict[str, torch.Tensor], loss_normalizer: torch.Tensor
               ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
        """Float32 head outputs and the GT fields (``gt_boxes [B, G, 4]``,
        ``gt_classes [B, G]``, ``gt_valid [B, G]``) -> (``{"loss_cls",
        "loss_box_reg"}``, the new normalizer)."""
        anchors = torch.cat(self._anchors(logits), 0)  # [R, 4]
        b, k = logits[0].shape[0], self.num_classes
        pred_logits = torch.cat([l.reshape(b, -1, k) for l in logits], 1)  # [B, R, K]
        pred_deltas = torch.cat([d.reshape(b, -1, 4) for d in deltas], 1)

        gt_boxes = gt["gt_boxes"]
        quality = box_ops.pairwise_iou(gt_boxes, anchors)  # [B, G, R]
        matched_idx, labels = self.matcher(quality, gt["gt_valid"])
        del quality
        matched_boxes = torch.gather(gt_boxes, 1, matched_idx[..., None].expand(-1, -1, 4))
        matched_classes = torch.gather(gt["gt_classes"].long(), 1, matched_idx)
        pos = labels == 1
        valid = labels != -1

        # One-hot foreground targets over the valid anchors (background: none).
        target = F.one_hot(torch.where(pos, matched_classes, torch.full_like(matched_classes, k)),
                           k + 1)[..., :k].to(pred_logits.dtype)
        cls_loss = sigmoid_focal_loss(pred_logits, target, self.focal_alpha,
                                      self.focal_gamma).sum(-1)
        cls_loss = torch.sum(cls_loss * valid)
        gt_deltas = self.box2box.get_deltas(anchors[None], matched_boxes)
        reg_loss = smooth_l1_loss(pred_deltas, gt_deltas, self.smooth_l1_beta).sum(-1)
        reg_loss = torch.sum(reg_loss * pos)

        num_pos = torch.clamp(pos.float().sum(), min=1.0)
        new_norm = self.momentum * loss_normalizer + (1.0 - self.momentum) * num_pos
        return {"loss_cls": cls_loss / new_norm, "loss_box_reg": reg_loss / new_norm}, new_norm

    @torch.no_grad()
    def inference(self, logits: List[torch.Tensor], deltas: List[torch.Tensor],
                  image_sizes: torch.Tensor) -> Instances:
        """Float32 head outputs -> ``Instances`` with ``boxes [B, D, 4]``,
        ``scores [B, D]`` (sigmoid), ``pred_classes [B, D]`` (-1 on empty
        slots) and ``is_valid [B, D]``."""
        b, k_cls = logits[0].shape[0], self.num_classes
        boxes, scores, classes = [], [], []
        for logit, delta, anchors in zip(logits, deltas, self._anchors(logits)):
            top_scores, anchor_idx, cls = level_top_k(logit, k_cls, self.topk_candidates)
            k = top_scores.shape[1]
            sel_deltas = torch.gather(delta.reshape(b, -1, 4), 1,
                                      anchor_idx[..., None].expand(b, k, 4))
            decoded = self.box2box.apply_deltas(sel_deltas, anchors[anchor_idx])
            boxes.append(box_ops.clip(decoded, image_sizes))
            scores.append(top_scores)
            classes.append(cls)
        boxes, scores, classes = torch.cat(boxes, 1), torch.cat(scores, 1), torch.cat(classes, 1)
        out_boxes, out_scores, out_idx, out_valid = class_aware_nms(
            boxes, scores, classes, self.nms_thresh, self.detections_per_image,
            valid=scores > self.score_thresh, class_agnostic=self.nms_class_agnostic)
        return Instances(
            boxes=out_boxes,
            scores=torch.where(out_valid, out_scores, torch.zeros_like(out_scores)),
            pred_classes=torch.where(out_valid, torch.gather(classes, 1, out_idx),
                                     torch.full_like(out_idx, -1)),
            is_valid=out_valid,
        )
