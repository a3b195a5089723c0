"""ROI heads: proposal sampling for training, shared pooling storage, box
and mask pooling, losses, box and mask inference.

Port of the JAX package's ``models/roi_heads/roi_heads.py``
(``StandardROIHeads``: ``label_and_sample_proposals``, ``pooling_storage``,
``pool_multi``, ``pool_box_features``, ``pool_mask_features``,
``box_losses``, ``mask_loss``, ``box_inference``, ``mask_inference``) and
of the head modules its ``rcnn.py`` builds around it: the FC box head
(:class:`StandardROIHeads`, FPN and DC5 models) or the res5 stage shared by
the box and mask branches (:class:`Res5ROIHeads`, C4 models). The pooling
storage is one plane for any number of levels: one level (``res4`` or
``res5``) with its 2x and 4x extent-tier aliases on the single-level
models. Every image samples exactly ``BATCH_SIZE_PER_IMAGE`` proposal
slots, positives compacted to the front, and the mask branch trains on the
first ``mask_slots = BATCH_SIZE_PER_IMAGE * POSITIVE_FRACTION`` of them, so
no positive is dropped. Without ``MASK_ON`` there is no mask head.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import torch
from torch import nn

from ...structures import Instances, boxes as box_ops
from ..box_regression import Box2BoxTransform
from ..losses import sigmoid_cross_entropy
from ..matcher import Matcher
from ..backbones.resnet import build_res5_head
from ..poolers import ROIPooler, pool_multi_from_storage
from ..sampling import subsample_labels
from .fast_rcnn import FastRCNNOutputLayers, fast_rcnn_inference, fast_rcnn_losses
from .heads import FastRCNNConvFCHead, MaskRCNNConvUpsampleHead


@dataclasses.dataclass
class SampledProposals:
    """Fixed-capacity training sample of the ROI heads, all ``[B, S, ...]``."""

    boxes: torch.Tensor  # proposal boxes [B, S, 4]
    gt_classes: torch.Tensor  # [B, S] in [0, K]; K = background
    gt_boxes: torch.Tensor  # matched GT boxes [B, S, 4] (meaningful on fg slots)
    matched_idx: torch.Tensor  # [B, S] index into the image's GT arrays
    is_fg: torch.Tensor  # [B, S]
    valid: torch.Tensor  # [B, S]


class StandardROIHeads(nn.Module):
    """The box head, box predictor and mask head (D2's names), with the
    pooling and inference around them."""

    is_res5 = False

    def __init__(self, cfg, strides: List[int], in_channels: int):
        super().__init__()
        rh = cfg.MODEL.ROI_HEADS
        self.in_features = list(rh.IN_FEATURES)
        self.num_classes = rh.NUM_CLASSES
        self.score_thresh = rh.SCORE_THRESH_TEST
        self.nms_thresh = rh.NMS_THRESH_TEST
        self.nms_class_agnostic = rh.NMS_CLS_AGNOSTIC
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE
        self.batch_size_per_image = rh.BATCH_SIZE_PER_IMAGE
        self.positive_fraction = rh.POSITIVE_FRACTION
        self.proposal_append_gt = rh.PROPOSAL_APPEND_GT
        self.matcher = Matcher(rh.IOU_THRESHOLDS, rh.IOU_LABELS)
        self.mask_slots = int(rh.BATCH_SIZE_PER_IMAGE * rh.POSITIVE_FRACTION)

        bh = cfg.MODEL.ROI_BOX_HEAD
        self.box2box = Box2BoxTransform(bh.BBOX_REG_WEIGHTS)
        self.smooth_l1_beta = bh.SMOOTH_L1_BETA
        self.cls_agnostic_bbox_reg = bh.CLS_AGNOSTIC_BBOX_REG
        max_img = max(cfg.TRANSFORM.RESIZE.MAX_SIZE_TRAIN,
                      cfg.TRANSFORM.RESIZE.MAX_SIZE_TEST)
        self.box_pooler = ROIPooler(bh.POOLER_RESOLUTION, strides,
                                    bh.POOLER_SAMPLING_RATIO, bh.POOLER_TYPE,
                                    max_image_size=max_img)
        mh = cfg.MODEL.ROI_MASK_HEAD
        self.mask_pooler = ROIPooler(mh.POOLER_RESOLUTION, strides,
                                     mh.POOLER_SAMPLING_RATIO, mh.POOLER_TYPE,
                                     max_image_size=max_img)
        self.cls_agnostic_mask = mh.CLS_AGNOSTIC_MASK

        self.mask_on = cfg.MODEL.MASK_ON
        mask_in = self._build_box_branch(cfg, in_channels)
        if self.mask_on:
            self.mask_head = MaskRCNNConvUpsampleHead(mask_in, self.num_classes,
                                                      mh.NUM_CONV, mh.CONV_DIM, mh.NORM,
                                                      self.cls_agnostic_mask)

    def _build_box_branch(self, cfg, in_channels: int) -> int:
        """The box head and predictor; returns the mask head's input channels."""
        bh = cfg.MODEL.ROI_BOX_HEAD
        self.box_head = FastRCNNConvFCHead(in_channels, bh.POOLER_RESOLUTION,
                                           bh.NUM_CONV, bh.NUM_FC, bh.FC_DIM, bh.NORM)
        self.box_predictor = FastRCNNOutputLayers(bh.FC_DIM, self.num_classes,
                                                  self.cls_agnostic_bbox_reg)
        return in_channels

    def box_outputs(self, pooled: torch.Tensor):
        """Pooled ``[N, S, S, C]`` -> ``(class logits [N, K+1], deltas,
        ROI features or None)`` (the JAX module's ``box`` method)."""
        scores, deltas = self.box_predictor(self.box_head(pooled))
        return scores, deltas, None

    def label_and_sample_proposals(self, proposals: Instances, gt: Dict[str, torch.Tensor],
                                   noise: Tuple[torch.Tensor, torch.Tensor]) -> SampledProposals:
        """Match proposals ``[B, P]`` to the GT by IoU and sample
        ``BATCH_SIZE_PER_IMAGE`` of them per image; ``noise`` is the sampler's
        (positive, negative) uniform ``[B, P]`` draws."""
        boxes = proposals.proposal_boxes
        gt_boxes, gt_valid = gt["gt_boxes"], gt["gt_valid"]
        is_crowd = gt.get("gt_is_crowd")
        if is_crowd is None:
            is_crowd = torch.zeros_like(gt_valid)
        quality = box_ops.pairwise_iou(gt_boxes, boxes)  # [B, G, P]
        matched_idx, labels = self.matcher(quality, gt_valid & ~is_crowd)
        labels = torch.where(proposals.is_valid, labels, torch.full_like(labels, -1))
        # Proposals mostly inside crowd regions are ignored.
        ioa = box_ops.pairwise_ioa(gt_boxes, boxes)
        in_crowd = (ioa * (gt_valid & is_crowd)[..., None].to(ioa.dtype) > 0.5).any(dim=-2)
        labels = torch.where(in_crowd, torch.full_like(labels, -1), labels)

        idx, is_pos, valid = subsample_labels(labels.int(), self.batch_size_per_image,
                                              self.positive_fraction, noise)
        sel_boxes = torch.gather(boxes, 1, idx[..., None].expand(-1, -1, 4))
        sel_matched = torch.gather(matched_idx, 1, idx)
        sel_gt_boxes = torch.gather(gt_boxes, 1, sel_matched[..., None].expand(-1, -1, 4))
        sel_classes = torch.gather(gt["gt_classes"].long(), 1, sel_matched)
        sel_classes = torch.where(is_pos, sel_classes, torch.full_like(sel_classes, self.num_classes))
        return SampledProposals(sel_boxes, sel_classes, sel_gt_boxes, sel_matched, is_pos, valid)

    def pooling_storage(self, features: Dict[str, torch.Tensor]):
        """One storage plane ``[B, Htot, Wm, C]`` (and its meta) shared by the
        box and mask poolers. ``features`` are NCHW-shaped, NHWC in memory."""
        feats = [features[f].permute(0, 2, 3, 1) for f in self.in_features]
        return self.box_pooler.build_storage(feats)

    def pool_box_features(self, boxes, storage_pack, valid=None) -> torch.Tensor:
        """``[B, N, 4]`` -> ``[B*N, S, S, C]``; invalid slots pool zeros."""
        storage, meta = storage_pack
        pooled = self.box_pooler.pool(storage, meta, boxes, valid)
        return pooled.reshape((-1,) + pooled.shape[2:])

    def pool_mask_features(self, boxes, storage_pack, valid=None) -> torch.Tensor:
        storage, meta = storage_pack
        pooled = self.mask_pooler.pool(storage, meta, boxes, valid)
        return pooled.reshape((-1,) + pooled.shape[2:])

    def pool_multi(self, requests: Sequence[tuple], storage_pack) -> List[torch.Tensor]:
        """Pool several ROI sets ``(pooler, boxes [B, N, 4], valid [B, N])``
        from the shared storage in one op whose backward chains through one
        float32 accumulator (``poolers.pool_multi_from_storage``). Returns one
        ``[B*N, S, S, C]`` tensor per request."""
        storage, meta = storage_pack
        reqs = [dict(boxes=b, valid=v, output_size=p.output_size,
                     sampling_ratio=p.sampling_ratio,
                     canonical_box_size=p.canonical_box_size,
                     canonical_level=p.canonical_level)
                for p, b, v in requests]
        outs = pool_multi_from_storage(storage, meta, reqs)
        return [o.reshape((-1,) + o.shape[2:]) for o in outs]

    def box_losses(self, class_logits: torch.Tensor, deltas: torch.Tensor,
                   sampled: SampledProposals) -> Dict[str, torch.Tensor]:
        """``loss_cls`` and ``loss_box_reg`` for ``[B*S, ...]`` head outputs in
        sampled-slot order."""
        gt_deltas = self.box2box.get_deltas(sampled.boxes, sampled.gt_boxes)
        return fast_rcnn_losses(
            class_logits, deltas, sampled.gt_classes.reshape(-1),
            gt_deltas.reshape(-1, 4), sampled.valid.reshape(-1),
            self.smooth_l1_beta, self.num_classes, self.cls_agnostic_bbox_reg,
        )

    def mask_loss(self, mask_logits: torch.Tensor, sampled: SampledProposals,
                  gt: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Sigmoid CE of the GT class's channel of ``[B*M, 2S, 2S, K]`` logits
        against the GT mini-masks ``gt_masks [B, G, Mm, Mm]`` (in GT-box
        frames) cropped to the proposal boxes, over foreground slots."""
        m = self.mask_slots
        b = sampled.gt_classes.shape[0]
        out = mask_logits.shape[1]
        fg = (sampled.is_fg & sampled.valid)[:, :m]
        matched = sampled.matched_idx[:, :m]
        gt_masks = gt["gt_masks"]
        mm = gt_masks.shape[-1]
        sel_masks = torch.gather(gt_masks, 1, matched[..., None, None].expand(-1, -1, mm, mm))
        gbox = torch.gather(gt["gt_boxes"], 1, matched[..., None].expand(-1, -1, 4))
        pbox = sampled.boxes[:, :m]
        # Proposal-box pixel centers mapped into the GT box's mini-mask cells,
        # then a bilinear crop as two float32 matmuls.
        dev = pbox.device
        ey = torch.clamp(gbox[..., 3] - gbox[..., 1], min=1e-4)
        ex = torch.clamp(gbox[..., 2] - gbox[..., 0], min=1e-4)
        steps = (torch.arange(out, dtype=torch.float32, device=dev) + 0.5) / out
        ys = pbox[..., 1, None] + steps * (pbox[..., 3] - pbox[..., 1])[..., None]
        xs = pbox[..., 0, None] + steps * (pbox[..., 2] - pbox[..., 0])[..., None]
        uy = (ys - gbox[..., 1, None]) / ey[..., None] * mm - 0.5
        ux = (xs - gbox[..., 0, None]) / ex[..., None] * mm - 0.5
        cells = torch.arange(mm, dtype=torch.float32, device=dev)
        wy = torch.clamp(1.0 - torch.abs(uy[..., None] - cells), min=0.0)  # [B, M, out, Mm]
        wx = torch.clamp(1.0 - torch.abs(ux[..., None] - cells), min=0.0)
        targets = torch.matmul(torch.matmul(wy, sel_masks.float()), wx.transpose(-1, -2))
        targets = (targets > 0.5).float()

        # Gather the class channel on the flat logits, in their own dtype,
        # then widen the small selected tensor.
        if self.cls_agnostic_mask:
            sel_flat = mask_logits[..., 0]
        else:
            cls = torch.clamp(sampled.gt_classes[:, :m], 0, self.num_classes - 1).reshape(-1)
            sel_flat = torch.gather(
                mask_logits, 3, cls[:, None, None, None].expand(mask_logits.shape[:3] + (1,))
            )[..., 0]
        sel = sel_flat.reshape(b, m, out, out)
        ce = sigmoid_cross_entropy(sel.float(), targets)
        num = torch.sum(ce * fg[:, :, None, None])
        den = torch.clamp(fg.sum().float() * (out * out), min=1.0)
        return num / den

    def box_inference(self, class_logits, deltas, proposals: Instances,
                      image_sizes) -> Instances:
        b, p = proposals.proposal_boxes.shape[:2]
        return fast_rcnn_inference(
            class_logits.reshape(b, p, -1), deltas.reshape(b, p, -1),
            proposals.proposal_boxes, proposals.is_valid, image_sizes,
            self.box2box, self.score_thresh, self.nms_thresh,
            self.detections_per_image, self.num_classes,
            self.cls_agnostic_bbox_reg, self.nms_class_agnostic,
        )

    def mask_inference(self, mask_logits: torch.Tensor,
                       detections: Instances) -> Instances:
        """Gather each detection's class channel of the raw-dtype logits
        ``[B*D, 2S, 2S, K]``, then widen: ``pred_masks [B, D, 2S, 2S]``."""
        b, d = detections.pred_classes.shape
        if self.cls_agnostic_mask:
            sel = mask_logits[..., 0]
        else:
            cls = torch.clamp(detections.pred_classes, 0, self.num_classes - 1).reshape(-1)
            sel = torch.gather(
                mask_logits, 3,
                cls[:, None, None, None].expand(mask_logits.shape[:3] + (1,)),
            )[..., 0]
        sel = sel.reshape((b, d) + mask_logits.shape[1:3]).float()
        return detections.replace(pred_masks=torch.sigmoid(sel))


class Res5ROIHeads(StandardROIHeads):
    """C4's ROI heads: the res5 stage (``roi_heads.res5``) on box-pooled
    res4 features, its 7x7 mean into the predictor; the mask head reads the
    same res5 features (``NUM_CONV 0``: a deconv straight on them), so the
    mask branch pools nothing of its own. Port of the JAX ``rcnn.py``
    ``Res5ROIHeads`` wiring (``_build_rcnn_parts`` and the module's ``box``
    method)."""

    is_res5 = True

    def _build_box_branch(self, cfg, in_channels: int) -> int:
        self.res5 = build_res5_head(cfg, in_channels)
        out = cfg.MODEL.RESNETS.RES2_OUT_CHANNELS * 8
        self.box_predictor = FastRCNNOutputLayers(out, self.num_classes,
                                                  self.cls_agnostic_bbox_reg)
        return out

    def box_outputs(self, pooled: torch.Tensor):
        """Pooled ``[N, S, S, C]`` -> ``(class logits, deltas, res5 features
        [N, S/2, S/2, C5])``; the predictor reads their spatial mean."""
        feats = self.res5(pooled.permute(0, 3, 1, 2))  # NHWC memory seen as NCHW
        scores, deltas = self.box_predictor(feats.mean(dim=(2, 3)))
        return scores, deltas, feats.permute(0, 2, 3, 1)
