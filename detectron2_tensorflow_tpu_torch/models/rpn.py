"""Region Proposal Network: head, anchor assignment and losses, proposal
selection.

Port of the JAX package's ``models/rpn.py`` (``StandardRPNHead``,
``RPN.losses``, ``RPN.proposals``, ``add_ground_truth_to_proposals``).
Proposals, per level and image: exact top-k of the objectness map in its own
dtype, decode, clip, min-size mask, greedy NMS to a fixed budget (all levels
in one batch, ``ops.nms.nms_fixed_levels``); then a cross-level top-k to the
``POST_NMS_TOPK_*`` budget (``_TRAIN`` or ``_TEST``).
Losses: anchors matched to the GT by IoU, subsampled to
``BATCH_SIZE_PER_IMAGE``, sigmoid CE on objectness and L1 on the deltas of
positives. All shapes are fixed and every image is independent, as under the
JAX package's vmap.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ..ops.nms import nms_fixed_levels
from ..ops.topk import spatial_top_k, top_k
from ..structures import Instances, boxes as box_ops
from .anchors import build_anchor_generator
from .box_regression import Box2BoxTransform
from .layers import Conv2d
from .losses import sigmoid_cross_entropy, smooth_l1_loss
from .matcher import Matcher
from .sampling import subsample_labels


class StandardRPNHead(nn.Module):
    """Shared 3x3 conv + relu, then 1x1 objectness and 1x1 deltas."""

    def __init__(self, in_channels: int, num_anchors: int):
        super().__init__()
        self.conv = Conv2d(in_channels, in_channels, 3, activation="relu")
        self.objectness_logits = Conv2d(in_channels, num_anchors, 1)
        self.anchor_deltas = Conv2d(in_channels, num_anchors * 4, 1)

    def forward(self, features: List[torch.Tensor]):
        """Per level: logits ``[B, H, W, A]`` and deltas ``[B, H, W, A*4]`` (NHWC)."""
        logits, deltas = [], []
        for x in features:
            t = self.conv(x)
            logits.append(self.objectness_logits(t).permute(0, 2, 3, 1))
            deltas.append(self.anchor_deltas(t).permute(0, 2, 3, 1))
        return logits, deltas


class RPN(nn.Module):
    """The RPN head (``rpn_head``, D2's name) and proposal selection."""

    def __init__(self, cfg, strides: List[int], in_channels: int):
        super().__init__()
        r = cfg.MODEL.RPN
        if r.HEAD_NAME != "StandardRPNHead":
            raise NotImplementedError(f"RPN head '{r.HEAD_NAME}' is not ported")
        self.in_features = list(r.IN_FEATURES)
        self.anchor_generator = build_anchor_generator(cfg, strides)
        self.box2box = Box2BoxTransform(r.BBOX_REG_WEIGHTS)
        self.nms_thresh = r.NMS_THRESH
        self.min_size = cfg.MODEL.PROPOSAL_GENERATOR.MIN_SIZE
        self.pre_nms_topk = {True: r.PRE_NMS_TOPK_TRAIN, False: r.PRE_NMS_TOPK_TEST}
        self.post_nms_topk = {True: r.POST_NMS_TOPK_TRAIN, False: r.POST_NMS_TOPK_TEST}
        self.matcher = Matcher(r.IOU_THRESHOLDS, r.IOU_LABELS, allow_low_quality_matches=True)
        self.batch_size_per_image = r.BATCH_SIZE_PER_IMAGE
        self.positive_fraction = r.POSITIVE_FRACTION
        self.smooth_l1_beta = r.SMOOTH_L1_BETA
        self.loss_weight = r.LOSS_WEIGHT
        self.boundary_thresh = r.BOUNDARY_THRESH
        a = self.anchor_generator.num_anchors_per_location
        if len(set(a)) != 1:
            raise ValueError("the RPN needs equal anchors per level")
        self.rpn_head = StandardRPNHead(in_channels, a[0])

    def losses(self, logits: List[torch.Tensor], deltas: List[torch.Tensor],
               gt: Dict[str, torch.Tensor], image_sizes: torch.Tensor,
               noise: Tuple[torch.Tensor, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``loss_rpn_cls`` and ``loss_rpn_loc`` for the head's outputs and the
        GT fields of ``gt`` (``gt_boxes``, ``gt_valid``, optional
        ``gt_is_crowd``); ``noise`` is the sampler's (positive, negative)
        uniform ``[B, R]`` draws over the R anchors."""
        anchors = torch.cat(self.anchor_generator(
            [(l.shape[1], l.shape[2]) for l in logits], device=logits[0].device), 0)
        b = logits[0].shape[0]
        flat_logits = torch.cat([l.reshape(b, -1) for l in logits], 1)  # [B, R]
        flat_deltas = torch.cat([d.reshape(b, -1, 4) for d in deltas], 1)  # [B, R, 4]

        gt_boxes, gt_valid = gt["gt_boxes"], gt["gt_valid"]
        is_crowd = gt.get("gt_is_crowd")
        if is_crowd is None:
            is_crowd = torch.zeros_like(gt_valid)
        quality = box_ops.pairwise_iou(gt_boxes, anchors)  # [B, G, R]
        matched_idx, labels = self.matcher(quality, gt_valid & ~is_crowd)
        # Anchors mostly inside a crowd region are ignored.
        ioa = box_ops.pairwise_ioa(gt_boxes, anchors)
        in_crowd = (ioa * (gt_valid & is_crowd)[..., None].to(ioa.dtype) > 0.5).any(dim=-2)
        labels = torch.where(in_crowd, torch.full_like(labels, -1), labels)
        if self.boundary_thresh >= 0:
            inside = box_ops.inside_image(anchors[None], image_sizes, self.boundary_thresh)
            labels = torch.where(inside, labels, torch.full_like(labels, -1))
        idx, is_pos, valid = subsample_labels(labels.int(), self.batch_size_per_image,
                                              self.positive_fraction, noise)
        sel_matched = torch.gather(matched_idx, 1, idx)
        matched_boxes = torch.gather(gt_boxes, 1, sel_matched[..., None].expand(-1, -1, 4))

        # Gather first, then widen the [B, S] slices to float32.
        sel_logits = torch.gather(flat_logits, 1, idx).float()
        sel_deltas = torch.gather(flat_deltas, 1, idx[..., None].expand(-1, -1, 4)).float()
        sel_anchors = anchors[idx]

        objectness = sigmoid_cross_entropy(sel_logits, is_pos.to(sel_logits.dtype))
        loss_cls = torch.sum(objectness * valid)
        gt_deltas = self.box2box.get_deltas(sel_anchors, matched_boxes)
        reg = smooth_l1_loss(sel_deltas, gt_deltas, self.smooth_l1_beta).sum(-1)
        loss_reg = torch.sum(reg * (is_pos & valid))
        normalizer = float(self.batch_size_per_image * b)
        return {
            "loss_rpn_cls": loss_cls / normalizer * self.loss_weight,
            "loss_rpn_loc": loss_reg / normalizer * self.loss_weight,
        }

    @torch.no_grad()
    def proposals(self, logits: List[torch.Tensor], deltas: List[torch.Tensor],
                  image_sizes: torch.Tensor, training: bool = False) -> Instances:
        """Batched ``Instances(proposal_boxes [B, K, 4], objectness_logits [B, K],
        is_valid [B, K])`` under the ``_TRAIN`` or ``_TEST`` budgets."""
        level_anchors = self.anchor_generator(
            [(l.shape[1], l.shape[2]) for l in logits], device=logits[0].device
        )
        pre_k = self.pre_nms_topk[training]
        post_k = self.post_nms_topk[training]
        b = logits[0].shape[0]
        levels = []
        for logit, delta, anchors in zip(logits, deltas, level_anchors):
            k = min(pre_k, logit[0].numel())
            top_scores, top_idx = spatial_top_k(logit, k)
            top_scores = top_scores.float()
            sel_anchors = anchors[top_idx]  # [B, k, 4]
            flat = delta.reshape(b, -1, 4)
            sel_deltas = torch.gather(flat, 1, top_idx[..., None].expand(b, k, 4)).float()
            boxes = self.box2box.apply_deltas(sel_deltas, sel_anchors)
            boxes = box_ops.clip(boxes, image_sizes)
            levels.append((boxes, top_scores, box_ops.nonempty(boxes, float(self.min_size))))
        # Every level's NMS in one keep-mask launch.
        cand_boxes, cand_scores, cand_valid = zip(
            *nms_fixed_levels(levels, self.nms_thresh, post_k))
        boxes = torch.cat(cand_boxes, 1)
        scores = torch.cat(cand_scores, 1)
        valid = torch.cat(cand_valid, 1)
        k = min(post_k, scores.shape[1])
        top_scores, top_idx = top_k(
            torch.where(valid, scores, torch.full_like(scores, -1e10)), k
        )
        top_boxes = torch.gather(boxes, 1, top_idx[..., None].expand(b, k, 4))
        top_valid = top_scores > -1e9
        return Instances(
            proposal_boxes=torch.where(top_valid[..., None], top_boxes,
                                       torch.zeros_like(top_boxes)),
            objectness_logits=top_scores,
            is_valid=top_valid,
        )


def add_ground_truth_to_proposals(proposals: Instances,
                                  gt: Dict[str, torch.Tensor]) -> Instances:
    """Append the GT boxes as proposals (logit 23, valid where the GT is
    valid and not crowd), keeping fixed shapes by concatenation."""
    gt_valid = gt["gt_valid"]
    if gt.get("gt_is_crowd") is not None:
        gt_valid = gt_valid & ~gt["gt_is_crowd"]
    gt_logits = torch.where(gt_valid, torch.full(gt_valid.shape, 23.0, device=gt_valid.device),
                            torch.full(gt_valid.shape, -1e10, device=gt_valid.device))
    return Instances(
        proposal_boxes=torch.cat([proposals.proposal_boxes, gt["gt_boxes"]], 1),
        objectness_logits=torch.cat([proposals.objectness_logits, gt_logits], 1),
        is_valid=torch.cat([proposals.is_valid, gt_valid], 1),
    )
