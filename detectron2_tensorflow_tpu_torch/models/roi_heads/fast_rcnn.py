"""Fast R-CNN output layers, losses and fixed-shape inference.

Port of the JAX package's ``models/roi_heads/fast_rcnn.py``
(``FastRCNNOutputLayers``, ``fast_rcnn_losses``, ``fast_rcnn_inference``).
Losses: softmax CE over the sampled slots and class-specific L1 on the
foreground deltas, both normalized by the sampled count. Inference: softmax, per-class
decode and clip, an exact top-2000 of the (proposal, class) scores, the
score threshold as a validity mask, then class-aware NMS to
``DETECTIONS_PER_IMAGE`` fixed slots.
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from ...ops.nms import class_aware_nms
from ...ops.topk import flat_top_k
from ...structures import Instances, boxes as box_ops
from ..box_regression import Box2BoxTransform
from ..layers import Linear
from ..losses import smooth_l1_loss, softmax_cross_entropy


class FastRCNNOutputLayers(nn.Module):
    """(K+1)-way class logits and 4K (or 4) box deltas."""

    def __init__(self, in_dim: int, num_classes: int, cls_agnostic_bbox_reg: bool):
        super().__init__()
        self.cls_score = Linear(in_dim, num_classes + 1)
        self.bbox_pred = Linear(in_dim, (1 if cls_agnostic_bbox_reg else num_classes) * 4)

    def forward(self, x: torch.Tensor):
        return self.cls_score(x), self.bbox_pred(x)


def fast_rcnn_losses(
    class_logits: torch.Tensor,  # [N, K+1]
    deltas: torch.Tensor,  # [N, K*4 or 4]
    gt_classes: torch.Tensor,  # [N] in [0, K]; K = background
    gt_proposal_deltas: torch.Tensor,  # [N, 4]
    valid: torch.Tensor,  # [N]
    smooth_l1_beta: float,
    num_classes: int,
    cls_agnostic: bool,
) -> Dict[str, torch.Tensor]:
    """Softmax CE and class-specific smooth L1, both normalized by the
    number of valid sampled slots (Detectron2's rule, not the fg count)."""
    n = class_logits.shape[0]
    count = torch.clamp(valid.sum().float(), min=1.0)
    ce = softmax_cross_entropy(class_logits, gt_classes)
    loss_cls = torch.sum(ce * valid) / count
    fg = valid & (gt_classes < num_classes)
    if cls_agnostic:
        fg_deltas = deltas
    else:
        d = deltas.reshape(n, num_classes, 4)
        cls_idx = torch.clamp(gt_classes, 0, num_classes - 1).long()
        fg_deltas = torch.gather(d, 1, cls_idx[:, None, None].expand(n, 1, 4))[:, 0]
    reg = smooth_l1_loss(fg_deltas, gt_proposal_deltas, smooth_l1_beta).sum(-1)
    return {"loss_cls": loss_cls, "loss_box_reg": torch.sum(reg * fg) / count}


@torch.no_grad()
def fast_rcnn_inference(
    class_logits: torch.Tensor,  # [B, P, K+1] float32
    deltas: torch.Tensor,  # [B, P, K*4 or 4] float32
    proposal_boxes: torch.Tensor,  # [B, P, 4]
    proposal_valid: torch.Tensor,  # [B, P]
    image_sizes: torch.Tensor,  # [B, 2]
    box2box: Box2BoxTransform,
    score_thresh: float,
    nms_thresh: float,
    detections_per_image: int,
    num_classes: int,
    cls_agnostic: bool,
    nms_class_agnostic: bool = False,
    pre_nms_topk: int = 2000,
) -> Instances:
    """Decode -> score filter -> class-aware NMS -> fixed top-k detections."""
    b, p = class_logits.shape[:2]
    scores = torch.softmax(class_logits, dim=-1)[..., :num_classes]  # [B, P, K]
    decoded = box2box.apply_deltas(deltas, proposal_boxes)
    if cls_agnostic:
        decoded = decoded[:, :, None, :].expand(b, p, num_classes, 4)
    else:
        decoded = decoded.reshape(b, p, num_classes, 4)
    decoded = box_ops.clip(decoded, image_sizes)

    flat_scores = torch.where(proposal_valid[..., None], scores,
                              torch.zeros_like(scores)).reshape(b, -1)
    k = min(pre_nms_topk, flat_scores.shape[1])
    top_scores, top_idx = flat_top_k(flat_scores, k)
    cls = top_idx % num_classes
    cand_boxes = torch.gather(decoded.reshape(b, -1, 4), 1,
                              top_idx[..., None].expand(b, k, 4))
    cand_valid = top_scores > score_thresh
    out_boxes, out_scores, out_i, out_valid = class_aware_nms(
        cand_boxes, top_scores, cls, nms_thresh, detections_per_image,
        valid=cand_valid, class_agnostic=nms_class_agnostic, presorted=True,
    )
    return Instances(
        boxes=out_boxes,
        scores=torch.where(out_valid, out_scores, torch.zeros_like(out_scores)),
        pred_classes=torch.where(out_valid, torch.gather(cls, 1, out_i),
                                 torch.full_like(out_i, -1)),
        is_valid=out_valid,
    )
