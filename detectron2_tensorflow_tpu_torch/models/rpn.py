"""Region Proposal Network: head and inference-time proposal selection.

Port of the JAX package's ``models/rpn.py`` (``StandardRPNHead`` and
``RPN.proposals``). Per level and image: exact top-k of the objectness map
in its own dtype, decode, clip, min-size mask, greedy NMS to a fixed budget;
then a cross-level top-k to ``POST_NMS_TOPK_TEST`` proposals. All shapes are
fixed and every image is independent, as under the JAX package's vmap.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from ..ops.nms import nms_fixed
from ..ops.topk import spatial_top_k, top_k
from ..structures import Instances, boxes as box_ops
from .anchors import build_anchor_generator
from .box_regression import Box2BoxTransform
from .layers import Conv2d


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
        self.pre_nms_topk = r.PRE_NMS_TOPK_TEST
        self.post_nms_topk = r.POST_NMS_TOPK_TEST
        a = self.anchor_generator.num_anchors_per_location
        if len(set(a)) != 1:
            raise ValueError("the RPN needs equal anchors per level")
        self.rpn_head = StandardRPNHead(in_channels, a[0])

    @torch.no_grad()
    def proposals(self, logits: List[torch.Tensor], deltas: List[torch.Tensor],
                  image_sizes: torch.Tensor) -> Instances:
        """Batched ``Instances(proposal_boxes [B, K, 4], objectness_logits [B, K],
        is_valid [B, K])``."""
        level_anchors = self.anchor_generator(
            [(l.shape[1], l.shape[2]) for l in logits], device=logits[0].device
        )
        b = logits[0].shape[0]
        cand_boxes, cand_scores, cand_valid = [], [], []
        for logit, delta, anchors in zip(logits, deltas, level_anchors):
            k = min(self.pre_nms_topk, logit[0].numel())
            top_scores, top_idx = spatial_top_k(logit, k)
            top_scores = top_scores.float()
            sel_anchors = anchors[top_idx]  # [B, k, 4]
            flat = delta.reshape(b, -1, 4)
            sel_deltas = torch.gather(flat, 1, top_idx[..., None].expand(b, k, 4)).float()
            boxes = self.box2box.apply_deltas(sel_deltas, sel_anchors)
            boxes = box_ops.clip(boxes, image_sizes)
            valid = box_ops.nonempty(boxes, float(self.min_size))
            nb, ns, _, nv = nms_fixed(boxes, top_scores, self.nms_thresh,
                                      min(self.post_nms_topk, k), valid=valid,
                                      presorted=True)
            cand_boxes.append(nb)
            cand_scores.append(ns)
            cand_valid.append(nv)
        boxes = torch.cat(cand_boxes, 1)
        scores = torch.cat(cand_scores, 1)
        valid = torch.cat(cand_valid, 1)
        k = min(self.post_nms_topk, scores.shape[1])
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
