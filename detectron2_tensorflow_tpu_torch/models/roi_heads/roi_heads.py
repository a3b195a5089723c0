"""Standard (FPN) ROI heads at inference: shared pooling storage, box and
mask pooling, box inference and mask inference.

Port of the inference half of
the JAX package's ``models/roi_heads/roi_heads.py``
(``StandardROIHeads``: ``pooling_storage``, ``pool_box_features``,
``pool_mask_features``, ``box_inference``, ``mask_inference``).
"""

from __future__ import annotations

from typing import Dict, List

import torch
from torch import nn

from ...structures import Instances
from ..box_regression import Box2BoxTransform
from ..poolers import ROIPooler
from .fast_rcnn import FastRCNNOutputLayers, fast_rcnn_inference
from .heads import FastRCNNConvFCHead, MaskRCNNConvUpsampleHead


class StandardROIHeads(nn.Module):
    """The box head, box predictor and mask head (D2's names), with the
    pooling and inference around them."""

    def __init__(self, cfg, strides: List[int], in_channels: int):
        super().__init__()
        rh = cfg.MODEL.ROI_HEADS
        self.in_features = list(rh.IN_FEATURES)
        self.num_classes = rh.NUM_CLASSES
        self.score_thresh = rh.SCORE_THRESH_TEST
        self.nms_thresh = rh.NMS_THRESH_TEST
        self.nms_class_agnostic = rh.NMS_CLS_AGNOSTIC
        self.detections_per_image = cfg.TEST.DETECTIONS_PER_IMAGE

        bh = cfg.MODEL.ROI_BOX_HEAD
        self.box2box = Box2BoxTransform(bh.BBOX_REG_WEIGHTS)
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

        self.box_head = FastRCNNConvFCHead(in_channels, bh.POOLER_RESOLUTION,
                                           bh.NUM_CONV, bh.NUM_FC, bh.FC_DIM, bh.NORM)
        self.box_predictor = FastRCNNOutputLayers(bh.FC_DIM, self.num_classes,
                                                  self.cls_agnostic_bbox_reg)
        self.mask_head = MaskRCNNConvUpsampleHead(in_channels, self.num_classes,
                                                  mh.NUM_CONV, mh.CONV_DIM, mh.NORM,
                                                  self.cls_agnostic_mask)

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
