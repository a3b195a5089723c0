"""GeneralizedRCNN: Faster and Mask R-CNN, with an FPN (R50-FPN) or on one
feature level (C4, DC5), serving and training losses.

Port of the non-cascade branches of ``predict_fn`` and ``loss_fn`` in the
JAX package's ``models/meta_arch/rcnn.py``. Serving: trunk and neck (FPN or
none), RPN proposals, one pooling storage shared by the box and mask
poolers, box head and class-aware NMS to fixed detection slots, mask head on
the detections. Training: RPN losses, training proposals (without gradient)
plus the GT boxes, ROI sampling, box and mask ROIs pooled by one fused op
(one float32 gradient accumulator for both), box and mask losses.

The single-level models follow the JAX wiring of ``Res5ROIHeads`` (C4: the
trunk stops at res4 and the res5 stage is the ROI head) and of
``StandardROIHeads`` on a dilated res5 (DC5). C4 takes no fused multi-pool:
it pools the box set alone, and its mask head reads the res5 features of the
leading (foreground) slots in training; in serving it pools the detections
with the box pooler and runs res5 again for the mask head. Without
``MASK_ON`` (Faster R-CNN) there is no mask branch and ``predict`` returns
no ``pred_masks``.

Parameters follow Detectron2's names (``backbone.bottom_up.*`` with an FPN,
``backbone.*`` without one, ``proposal_generator.rpn_head.*``,
``roi_heads.box_head.*``, ``roi_heads.res5.*``, ...).
Activations stay NHWC in memory: images enter as ``[B, H, W, 3]`` and are
viewed as NCHW, which is PyTorch's ``channels_last`` layout.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...structures import Instances
from ..backbones.resnet import ResNet, build_resnet_backbone, output_shapes
from ..necks.fpn import build_neck
from ..roi_heads.roi_heads import Res5ROIHeads, StandardROIHeads
from ..rpn import RPN, add_ground_truth_to_proposals
from ..sampling import draw_noise
from .common import preprocess_images

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
ROI_HEADS = {"StandardROIHeads": StandardROIHeads, "Res5ROIHeads": Res5ROIHeads}


class GeneralizedRCNN(nn.Module):
    """Faster or Mask R-CNN; ``predict(batch)`` is the serving entry point."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg.MODEL
        if m.META_ARCHITECTURE != "GeneralizedRCNN":
            raise NotImplementedError(f"meta-architecture '{m.META_ARCHITECTURE}' is not ported")
        if m.KEYPOINT_ON or m.LOAD_PROPOSALS or m.ROI_HEADS.NAME not in ROI_HEADS:
            raise NotImplementedError(
                "only Faster and Mask R-CNN with StandardROIHeads or Res5ROIHeads (no "
                "keypoints, no loaded proposals) are ported"
            )
        ported = [("PROPOSAL_GENERATOR.NAME", "RPN")]
        if m.ROI_HEADS.NAME == "StandardROIHeads":
            ported.append(("ROI_BOX_HEAD.NAME", "FastRCNNConvFCHead"))
        if m.MASK_ON:
            ported.append(("ROI_MASK_HEAD.NAME", "MaskRCNNConvUpsampleHead"))
        for key, name in ported:
            group, leaf = key.split(".")
            if m[group][leaf] != name:
                raise NotImplementedError(f"MODEL.{key} '{m[group][leaf]}' is not ported")
        self.dtype = DTYPES[m.DTYPE]
        self.pixel_mean = list(m.PIXEL_MEAN)
        self.pixel_std = list(m.PIXEL_STD)
        self.input_format = m.INPUT_FORMAT
        self.mask_on = m.MASK_ON
        self.backbone, shapes = build_neck(cfg, build_resnet_backbone(cfg), output_shapes(cfg))
        rpn_in = [shapes[f] for f in m.RPN.IN_FEATURES]
        self.proposal_generator = RPN(cfg, [s for _, s in rpn_in], rpn_in[0][0])
        roi_in = [shapes[f] for f in m.ROI_HEADS.IN_FEATURES]
        self.roi_heads = ROI_HEADS[m.ROI_HEADS.NAME](cfg, [s for _, s in roi_in], roi_in[0][0])

    @property
    def trunk(self) -> ResNet:
        """The ResNet trunk (``backbone.bottom_up`` with an FPN, else ``backbone``)."""
        return getattr(self.backbone, "bottom_up", self.backbone)

    def features(self, images: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Raw ``[B, H, W, 3]`` images -> the neck's ``{p2..p6}`` (or the
        trunk's ``{res4}`` / ``{res5}``) ``[B, C, H, W]`` (NHWC memory)."""
        x = preprocess_images(images, self.pixel_mean, self.pixel_std,
                              self.input_format, self.dtype)
        return self.backbone(x.permute(0, 3, 1, 2))

    @torch.inference_mode()
    def predict(self, batch: Dict[str, torch.Tensor]) -> Instances:
        """``batch = {"image": [B, H, W, 3] float, "image_size": [B, 2] int32}``
        on the model's device -> ``Instances`` with ``boxes [B, D, 4]``,
        ``scores [B, D]``, ``pred_classes [B, D]``, ``is_valid [B, D]`` and,
        with ``MASK_ON``, ``pred_masks [B, D, 2S, 2S]`` (probabilities; 28 x
        28 at the configs' resolutions)."""
        image_sizes = batch["image_size"]
        features = self.features(batch["image"])
        rpn = self.proposal_generator
        logits, deltas = rpn.rpn_head([features[f] for f in rpn.in_features])
        proposals = rpn.proposals(logits, deltas, image_sizes)

        heads = self.roi_heads
        storage = heads.pooling_storage(features)
        pooled = heads.pool_box_features(proposals.proposal_boxes, storage,
                                         valid=proposals.is_valid)
        scores, deltas, _ = heads.box_outputs(pooled)
        detections = heads.box_inference(scores.float(), deltas.float(), proposals,
                                         image_sizes)
        if not self.mask_on:
            return detections
        if heads.is_res5:  # the detections through the box pooler and res5 again
            pooled = heads.pool_box_features(detections.boxes, storage,
                                             valid=detections.is_valid)
            mask_in = heads.box_outputs(pooled)[2]
        else:
            mask_in = heads.pool_mask_features(detections.boxes, storage,
                                               valid=detections.is_valid)
        return heads.mask_inference(heads.mask_head(mask_in), detections)

    def losses(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
               ) -> Dict[str, torch.Tensor]:
        """The training losses of one batch: ``loss_rpn_cls``, ``loss_rpn_loc``,
        ``loss_cls``, ``loss_box_reg`` and, with ``MASK_ON``, ``loss_mask``
        (float32 scalars).

        ``batch`` holds ``image [B, H, W, 3]``, ``image_size [B, 2]`` and the
        GT fields ``gt_boxes [B, G, 4]``, ``gt_classes [B, G]``,
        ``gt_valid [B, G]``, ``gt_masks [B, G, Mm, Mm]`` (mini-masks in GT-box
        frames) and optionally ``gt_is_crowd [B, G]``. The two samplers draw
        their uniform noise from ``generator`` (on the batch's device), RPN
        first, unless ``noise = {"rpn": (pos, neg), "roi": (pos, neg)}``
        hands the draws in (``[B, anchors]`` and ``[B, proposals]``).
        """
        image_sizes = batch["image_size"]
        features = self.features(batch["image"])
        rpn = self.proposal_generator
        logits, deltas = rpn.rpn_head([features[f] for f in rpn.in_features])
        b, dev = logits[0].shape[0], logits[0].device
        if noise is None:
            noise = {"rpn": draw_noise(generator, (b, sum(l[0].numel() for l in logits)), dev)}
        losses = rpn.losses(logits, deltas, batch, image_sizes, noise["rpn"])
        proposals = rpn.proposals(logits, deltas, image_sizes, training=True)

        heads = self.roi_heads
        if heads.proposal_append_gt:
            proposals = add_ground_truth_to_proposals(proposals, batch)
        roi_noise = noise.get("roi")
        if roi_noise is None:
            roi_noise = draw_noise(generator, proposals.is_valid.shape, dev)
        sampled = heads.label_and_sample_proposals(proposals, batch, roi_noise)
        m = heads.mask_slots
        storage = heads.pooling_storage(features)
        mask_in = None
        if self.mask_on and not heads.is_res5:
            box_in, mask_in = heads.pool_multi(
                [(heads.box_pooler, sampled.boxes, sampled.valid),
                 (heads.mask_pooler, sampled.boxes[:, :m], sampled.valid[:, :m])],
                storage,
            )
        else:
            box_in = heads.pool_box_features(sampled.boxes, storage, valid=sampled.valid)
        scores, box_deltas, roi_feats = heads.box_outputs(box_in)
        losses.update(heads.box_losses(scores.float(), box_deltas.float(), sampled))
        if self.mask_on:
            if heads.is_res5:  # the res5 features of the leading (foreground) slots
                rf = roi_feats.reshape((b, -1) + roi_feats.shape[1:])[:, :m]
                mask_in = rf.reshape((-1,) + rf.shape[2:])
            losses["loss_mask"] = heads.mask_loss(heads.mask_head(mask_in), sampled, batch)
        return losses


# Layers the JAX package initializes with small normals (std by port name).
_SMALL_INIT = {
    "proposal_generator.rpn_head.conv": 0.01,
    "proposal_generator.rpn_head.objectness_logits": 0.01,
    "proposal_generator.rpn_head.anchor_deltas": 0.01,
    "roi_heads.box_predictor.cls_score": 0.01,
    "roi_heads.box_predictor.bbox_pred": 0.001,
    "roi_heads.mask_head.predictor": 0.001,
}
# The JAX initializers' truncated normal keeps [-2, 2] standard deviations and rescales by
# this factor so that the kept values have the asked variance.
_TRUNC_STD = 0.87962566103423978
INIT_RECIPES = ("serving", "jax")


def init_weights(model: GeneralizedRCNN, generator: torch.Generator,
                 recipe: str = "serving") -> None:
    """Seeded random weights: ``recipe`` "serving" (``_init_for_serving``)
    or "jax".

    "jax" draws from the JAX package's initializers, the ones its ``train.py``
    starts from scratch with: convs and the deconv truncated normal with
    variance ``2 / fan_out`` (``variance_scaling(2.0, "fan_out",
    "normal")``), the box head's FCs uniform with variance ``1 / fan_in``,
    the small normals of the RPN head and the predictors, zero biases, GN
    at identity (FrozenBN keeps its identity buffers).
    """
    if recipe == "jax":
        _init_like_jax(model, generator)
        return
    if recipe != "serving":
        raise ValueError(f"unknown init recipe {recipe!r} (known: {INIT_RECIPES})")
    _init_for_serving(model, generator)


def _init_like_jax(model: GeneralizedRCNN, generator: torch.Generator) -> None:
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight
                if name in _SMALL_INIT:
                    w.copy_(torch.randn(w.shape, generator=generator) * _SMALL_INIT[name])
                elif isinstance(mod, nn.Linear):
                    limit = math.sqrt(3.0 / w.shape[1])
                    w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * limit)
                else:
                    out = w.shape[1] if isinstance(mod, nn.ConvTranspose2d) else w.shape[0]
                    std = math.sqrt(2.0 / (out * w[0, 0].numel())) / _TRUNC_STD
                    t = torch.empty(w.shape)
                    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
                    w.copy_(t)
                if mod.bias is not None:
                    mod.bias.zero_()
            elif isinstance(mod, nn.GroupNorm):
                mod.weight.fill_(1.0)
                mod.bias.zero_()


def _init_for_serving(model: GeneralizedRCNN, generator: torch.Generator) -> None:
    """Seeded random weights that keep activations of order one.

    Convs and FCs are variance-preserving (He-normal over fan-in, with the
    JAX package's small normals for the RPN head and the predictors), and
    every bottleneck's last FrozenBN scales its branch by 0.2, so the
    residual stream does not grow with depth. With zero biases the network
    is linear in the input's scale up to the softmax; the stem's FrozenBN
    scales the raw pixels (std 1, values up to ~130) by 1/640, which keeps
    the class softmax unsaturated (scores near 1/81 at 80 classes) and the
    RPN deltas small, so proposals are real boxes near their anchors.
    """
    small = _SMALL_INIT
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                w = mod.weight
                if name in small:
                    std = small[name]
                elif isinstance(mod, nn.ConvTranspose2d):  # stride = kernel: one tap
                    std = math.sqrt(2.0 / w.shape[0])
                else:
                    std = math.sqrt(2.0 / w[0].numel())
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if mod.bias is not None:
                    mod.bias.zero_()
            if hasattr(mod, "running_var"):
                if name.endswith("stem.conv1.norm"):
                    mod.weight.fill_(1.0 / 640)
                elif name.endswith("conv3.norm"):
                    mod.weight.fill_(0.2)
