"""Cascade R-CNN ROI heads: three box stages of rising IoU.

Port of the JAX package's ``models/roi_heads/cascade.py``
(``CascadeROIHeads``, ``scale_gradient``). Stage k has its own box head,
class-agnostic predictor (``roi_heads.box_head.{k}``,
``roi_heads.box_predictor.{k}``, Detectron2's names), ``Box2BoxTransform``
weights (``ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS``) and matcher: stage 0
keeps the base matcher, later stages match at ``IOUS[k]`` with labels
``[0, 1]`` and no low-quality matches. Stage k + 1 pools the decoded,
clipped and detached boxes of stage k; in training they are matched again
to the GT but not sampled again, so the slots (and their validity) stay
stage 0's. Inference averages the stages' softmaxes and decodes the last
stage's deltas.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from ...structures import Instances, boxes as box_ops
from ..box_regression import Box2BoxTransform
from ..matcher import Matcher
from .fast_rcnn import FastRCNNOutputLayers, fast_rcnn_inference, fast_rcnn_losses
from .heads import FastRCNNConvFCHead
from .roi_heads import SampledProposals, StandardROIHeads


def scale_gradient(x: torch.Tensor, scale: float) -> torch.Tensor:
    """The JAX ``x * scale + stop_gradient(x * (1 - scale))``: the gradient
    is scaled by ``scale``; the value is ``x`` up to the rounding of the two
    products and their sum in ``x``'s dtype (which bf16 does not always
    undo), as in the JAX package. Its Python scalars are weakly typed, so
    ``scale`` and ``1 - scale`` are first rounded to that dtype; so they are
    here."""
    s, rest = x.new_tensor(scale), x.new_tensor(1.0 - scale)
    return x * s + (x * rest).detach()


class CascadeROIHeads(StandardROIHeads):
    """``num_stages`` box heads and predictors, the mask head of
    :class:`StandardROIHeads`, and the cascade's matching, losses, box
    refinement and inference."""

    def __init__(self, cfg, strides: List[int], in_channels: int):
        super().__init__(cfg, strides, in_channels)
        ch = cfg.MODEL.ROI_BOX_CASCADE_HEAD
        if not cfg.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG:
            raise ValueError("Cascade R-CNN requires class-agnostic box regression "
                             "(MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG)")
        self.num_stages = len(ch.IOUS)
        self.stage_transforms = [Box2BoxTransform(w) for w in ch.BBOX_REG_WEIGHTS]
        self.stage_matchers = [self.matcher] + [Matcher([iou], [0, 1]) for iou in ch.IOUS[1:]]

    def _build_box_branch(self, cfg, in_channels: int) -> int:
        bh = cfg.MODEL.ROI_BOX_HEAD
        stages = range(len(cfg.MODEL.ROI_BOX_CASCADE_HEAD.IOUS))
        self.box_head = nn.ModuleList(
            FastRCNNConvFCHead(in_channels, bh.POOLER_RESOLUTION, bh.NUM_CONV, bh.CONV_DIM,
                               bh.NUM_FC, bh.FC_DIM, bh.NORM) for _ in stages)
        self.box_predictor = nn.ModuleList(
            FastRCNNOutputLayers(bh.FC_DIM, self.num_classes, True) for _ in stages)
        return in_channels

    def box_outputs(self, pooled: torch.Tensor, stage: int = 0):
        """Stage ``stage``'s ``(class logits [N, K+1], deltas [N, 4], None)``."""
        scores, deltas = self.box_predictor[stage](self.box_head[stage](pooled))
        return scores, deltas, None

    def _rematch(self, stage: int, boxes: torch.Tensor, gt: Dict[str, torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Match ``[B, S, 4]`` boxes to the GT at ``stage``'s IoU: (classes
        ``[B, S]``, background K, matched GT boxes ``[B, S, 4]``, matched
        index ``[B, S]``); crowd GT boxes match nothing."""
        gt_boxes, gt_valid = gt["gt_boxes"], gt["gt_valid"]
        is_crowd = gt.get("gt_is_crowd")
        if is_crowd is None:
            is_crowd = torch.zeros_like(gt_valid)
        quality = box_ops.pairwise_iou(gt_boxes, boxes)  # [B, G, S]
        midx, labels = self.stage_matchers[stage](quality, gt_valid & ~is_crowd)
        cls = torch.gather(gt["gt_classes"].long(), 1, midx)
        cls = torch.where(labels == 1, cls, torch.full_like(cls, self.num_classes))
        return cls, torch.gather(gt_boxes, 1, midx[..., None].expand(-1, -1, 4)), midx

    def stage_losses(self, stage: int, class_logits: torch.Tensor, deltas: torch.Tensor,
                     boxes: torch.Tensor, gt_classes: torch.Tensor, gt_boxes: torch.Tensor,
                     valid: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``loss_cls_stage{k}`` and ``loss_box_reg_stage{k}`` of ``[B*S, ...]``
        float32 outputs against the stage's targets (class-agnostic)."""
        gt_deltas = self.stage_transforms[stage].get_deltas(boxes, gt_boxes)
        losses = fast_rcnn_losses(class_logits, deltas, gt_classes.reshape(-1),
                                  gt_deltas.reshape(-1, 4), valid.reshape(-1),
                                  self.smooth_l1_beta, self.num_classes, cls_agnostic=True)
        return {f"{k}_stage{stage}": v for k, v in losses.items()}

    def refine_boxes(self, stage: int, deltas: torch.Tensor, boxes: torch.Tensor,
                     image_sizes: torch.Tensor) -> torch.Tensor:
        """Stage ``stage``'s ``[B*S, 4]`` deltas decoded on its ``[B, S, 4]``
        boxes, clipped and detached: the next stage's boxes."""
        b, s = boxes.shape[:2]
        decoded = self.stage_transforms[stage].apply_deltas(deltas.reshape(b, s, 4), boxes)
        return box_ops.clip(decoded, image_sizes).detach()

    def box_detections(self, proposals: Instances, storage_pack, image_sizes) -> Instances:
        """Serving's box stages: each pools its input boxes (every proposal
        slot, valid as the proposal is), the next stage takes its refined
        boxes; the detections average the stages' scores."""
        boxes, stage_scores, deltas = proposals.proposal_boxes, [], None
        for k in range(self.num_stages):
            pooled = self.pool_box_features(boxes, storage_pack, valid=proposals.is_valid)
            scores, deltas, _ = self.box_outputs(pooled, k)
            deltas = deltas.float()
            stage_scores.append(scores.float())
            if k + 1 < self.num_stages:
                boxes = self.refine_boxes(k, deltas, boxes, image_sizes)
        return self.cascade_inference(stage_scores, deltas, boxes, proposals.is_valid,
                                      image_sizes)

    def box_branch_losses(self, sampled: SampledProposals, storage_pack,
                          gt: Dict[str, torch.Tensor]
                          ) -> Tuple[Dict[str, torch.Tensor], Dict[str, torch.Tensor]]:
        """Training's box stages on the stage-0 sample: each pools its boxes
        (the pooled features' gradient scaled by 1 / num_stages), takes its
        losses, then refines the boxes and matches them again for the next
        stage, whose slots keep stage 0's validity. The mask and keypoint
        heads' inputs are the stage-0 sample's leading ``mask_slots``, each
        pooled on its own (the JAX cascade fuses no pools)."""
        boxes, gt_classes, gt_boxes = sampled.boxes, sampled.gt_classes, sampled.gt_boxes
        losses = {}
        for k in range(self.num_stages):
            pooled = self.pool_box_features(boxes, storage_pack, valid=sampled.valid)
            scores, deltas, _ = self.box_outputs(scale_gradient(pooled, 1.0 / self.num_stages), k)
            scores, deltas = scores.float(), deltas.float()
            losses.update(self.stage_losses(k, scores, deltas, boxes, gt_classes, gt_boxes,
                                            sampled.valid))
            if k + 1 < self.num_stages:
                boxes = self.refine_boxes(k, deltas, boxes, gt["image_size"])
                gt_classes, gt_boxes, _ = self._rematch(k + 1, boxes, gt)
        m, inputs = self.mask_slots, {}
        if self.mask_on:
            inputs["mask"] = self.pool_mask_features(sampled.boxes[:, :m], storage_pack,
                                                     valid=sampled.valid[:, :m])
        if self.keypoint_on:
            inputs["keypoint"] = self.pool_keypoint_features(sampled.boxes[:, :m], storage_pack,
                                                             valid=sampled.valid[:, :m])
        return losses, inputs

    @torch.no_grad()
    def cascade_inference(self, stage_scores: List[torch.Tensor], final_deltas: torch.Tensor,
                          final_boxes: torch.Tensor, proposal_valid: torch.Tensor,
                          image_sizes: torch.Tensor) -> Instances:
        """The mean of the stages' softmaxes (``[B*P, K+1]`` logits each),
        as log-probabilities (floored at 1e-12) into ``fast_rcnn_inference``
        with the last stage's deltas on its input boxes ``[B, P, 4]``."""
        mean = sum(torch.softmax(s, dim=-1) for s in stage_scores) / len(stage_scores)
        log_scores = torch.log(torch.clamp(mean, min=1e-12))
        b, p = final_boxes.shape[:2]
        return fast_rcnn_inference(
            log_scores.reshape(b, p, -1), final_deltas.reshape(b, p, -1), final_boxes,
            proposal_valid, image_sizes, self.stage_transforms[-1], self.score_thresh,
            self.nms_thresh, self.detections_per_image, self.num_classes, cls_agnostic=True,
            nms_class_agnostic=self.nms_class_agnostic)
