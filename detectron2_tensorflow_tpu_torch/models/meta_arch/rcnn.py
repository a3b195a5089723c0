"""GeneralizedRCNN: Faster, Mask, Keypoint and Cascade Mask R-CNN, with an FPN
(R50-FPN) or on one feature level (C4, DC5), Fast R-CNN over loaded
proposals, the RPN-only ProposalNetwork, PanopticFPN and the
SemanticSegmentor; serving and training losses.

Port of ``predict_fn`` and ``loss_fn`` in the JAX package's
``models/meta_arch/rcnn.py`` (the families above). Serving: trunk and neck (FPN or
none), RPN proposals, one pooling storage shared by the box and mask
poolers, box head and class-aware NMS to fixed detection slots, mask head
and keypoint head on the detections. Training: RPN losses, training
proposals (without gradient) plus the GT boxes, ROI sampling, box, mask and
keypoint ROIs pooled by one fused op (one float32 gradient accumulator for
all), box, mask and keypoint losses. ``KEYPOINT_ON`` adds the keypoint
head with ``MASK_ON`` on or off; ``predict`` then returns
``pred_keypoints [B, D, K, 3]`` (x, y, score) in the input frame.

The single-level models follow the JAX wiring of ``Res5ROIHeads`` (C4: the
trunk stops at res4 and the res5 stage is the ROI head) and of
``StandardROIHeads`` on a dilated res5 (DC5). C4 takes no fused multi-pool:
it pools the box set alone, and its mask head reads the res5 features of the
leading (foreground) slots in training; in serving it pools the detections
with the box pooler and runs res5 again for the mask head. Its keypoint
head, and a cascade's, pools its ROIs on its own, as in the JAX package. Without
``MASK_ON`` (Faster R-CNN) there is no mask branch and ``predict`` returns
no ``pred_masks``.

``CascadeROIHeads`` follows the JAX cascade branches: three box stages,
each pooling its own boxes (the JAX package fuses no pools there), the
pooled features' gradient scaled by 1/3 in training, where the later stages
re-match their refined boxes without sampling again and the mask head pools
the stage-0 sample; in serving the mask head pools the detections of the
averaged stages.

``RelationROIHeads`` (Relation Networks, ``models/roi_heads/relation.py``)
follows the JAX relation branches: the box head attends over each image's
proposals (their boxes and validity go in with the pooled features), and
with ``ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_ON`` the learned duplicate
removal on the head's appearance features replaces the class-aware NMS. Its
training is a later slice of the port: ``losses`` and ``build_model(...,
training=True)`` raise ``NotImplementedError`` (``training_not_ported``).

With ``MODEL.LOAD_PROPOSALS`` (Fast R-CNN) the model has no RPN, not even
its parameters: the proposals come from the batch (``proposal_boxes``,
``proposal_scores``, ``proposal_valid``, the loader's fixed top-k slots), in
serving and in training, where there is no RPN loss (the JAX
``batch_proposals``). :class:`ProposalNetwork` is the trunk, the neck and
the RPN alone (the JAX ``build_proposal_network``): RPN losses in training,
and ``predict`` returns the ``_TEST`` proposals as instances of class 0
scored by their objectness logits.

A model with trainable BN normalizes with batch moments (and updates its
running statistics) in ``losses`` when it was built for training, and
always with its running statistics in ``predict``, as the JAX package
applies ``train=True`` and ``train=False``.

:class:`PanopticFPN` is this R50-FPN Mask R-CNN with the semantic FPN head
(``models/sem_seg.py``) beside it, and :class:`SemanticSegmentor` the trunk,
the neck and that head alone (the JAX ``build_panoptic_fpn`` and
``build_semantic_segmentor``); :func:`panoptic_fusion` fuses a PanopticFPN's
detections and semantic map.

Parameters follow Detectron2's names (``backbone.bottom_up.*`` with an FPN,
``backbone.*`` without one, ``proposal_generator.rpn_head.*``,
``roi_heads.box_head.*``, ``roi_heads.box_head.{k}.*`` for a cascade,
``roi_heads.res5.*``, ...).
Activations stay NHWC in memory: images enter as ``[B, H, W, 3]`` and are
viewed as NCHW, which is PyTorch's ``channels_last`` layout.
"""

from __future__ import annotations

import math
import re
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from ...structures import Instances
from ..deform_conv import OFFSET_CONV, DeformConv2d
from ..layers import BatchNorm2d
from ..roi_heads.cascade import CascadeROIHeads
from ..roi_heads.relation import DuplicateRemovalModule, RelationBoxHead, RelationROIHeads
from ..roi_heads.roi_heads import Res5ROIHeads, StandardROIHeads
from ..rpn import RPN, add_ground_truth_to_proposals
from ..sampling import draw_noise
from ..sem_seg import build_sem_seg_head, combine_semantic_and_instance_outputs, sem_seg_loss
from .common import Detector, norms_in_eval
from .single_stage import SingleStageDetector

ROI_HEADS = {"StandardROIHeads": StandardROIHeads, "Res5ROIHeads": Res5ROIHeads,
             "CascadeROIHeads": CascadeROIHeads, "RelationROIHeads": RelationROIHeads}
# Why a model cannot train yet (``build_model(..., training=True)`` and
# ``losses`` raise it).
RELATION_TRAINING_NOT_PORTED = (
    "RelationROIHeads training (the duplicate-removal targets and loss_dup) is not ported "
    "yet: a Relation Networks model serves and evaluates only")


def batch_proposals(batch: Dict[str, torch.Tensor]) -> Instances:
    """The loader's precomputed-proposal slots as proposals (the JAX
    ``batch_proposals``)."""
    return Instances(proposal_boxes=batch["proposal_boxes"],
                     objectness_logits=batch["proposal_scores"],
                     is_valid=batch["proposal_valid"])


class GeneralizedRCNN(Detector):
    """Faster, Mask, Cascade Mask or Fast R-CNN; ``predict(batch)`` is the
    serving entry point."""

    meta_architecture = "GeneralizedRCNN"
    # Why the model cannot train yet (``build_model(..., training=True)``
    # and ``losses`` raise it), or None.
    training_not_ported = None

    def __init__(self, cfg):
        super().__init__()
        m = cfg.MODEL
        if m.META_ARCHITECTURE != self.meta_architecture:
            raise NotImplementedError(f"meta-architecture '{m.META_ARCHITECTURE}' is not ported "
                                      f"by {type(self).__name__}")
        if m.ROI_HEADS.NAME not in ROI_HEADS:
            raise NotImplementedError(
                f"ROI heads '{m.ROI_HEADS.NAME}': only Faster, Mask, Keypoint, Cascade, Fast "
                f"R-CNN and Relation Networks with {', '.join(ROI_HEADS)} are ported"
            )
        if m.ROI_HEADS.NAME == "RelationROIHeads":
            self.training_not_ported = RELATION_TRAINING_NOT_PORTED
        self.load_proposals = m.LOAD_PROPOSALS
        ported = [] if self.load_proposals else [("PROPOSAL_GENERATOR.NAME", "RPN")]
        if m.ROI_HEADS.NAME in ("StandardROIHeads", "CascadeROIHeads"):
            ported.append(("ROI_BOX_HEAD.NAME", "FastRCNNConvFCHead"))
        if m.MASK_ON:
            ported.append(("ROI_MASK_HEAD.NAME", "MaskRCNNConvUpsampleHead"))
        if m.KEYPOINT_ON:
            ported.append(("ROI_KEYPOINT_HEAD.NAME", "KRCNNConvDeconvUpsampleHead"))
        for key, name in ported:
            group, leaf = key.split(".")
            if m[group][leaf] != name:
                raise NotImplementedError(f"MODEL.{key} '{m[group][leaf]}' is not ported")
        self.mask_on = m.MASK_ON
        self.keypoint_on = m.KEYPOINT_ON
        shapes = self._build_backbone(cfg)
        if not self.load_proposals:
            rpn_in = [shapes[f] for f in m.RPN.IN_FEATURES]
            self.proposal_generator = RPN(cfg, [s for _, s in rpn_in], rpn_in[0][0])
        roi_in = [shapes[f] for f in m.ROI_HEADS.IN_FEATURES]
        self.roi_heads = ROI_HEADS[m.ROI_HEADS.NAME](cfg, [s for _, s in roi_in], roi_in[0][0])

    def _predict(self, batch: Dict[str, torch.Tensor]) -> Instances:
        """``batch = {"image": [B, H, W, 3] float, "image_size": [B, 2] int32}``
        (and, with ``LOAD_PROPOSALS``, the ``proposal_*`` slots) on the
        model's device -> ``Instances`` with ``boxes [B, D, 4]``,
        ``scores [B, D]``, ``pred_classes [B, D]``, ``is_valid [B, D]``,
        with ``MASK_ON`` ``pred_masks [B, D, 2S, 2S]`` (probabilities; 28 x
        28 at the configs' resolutions) and with ``KEYPOINT_ON``
        ``pred_keypoints [B, D, K, 3]`` (x, y, score)."""
        return self._detect(batch, self.features(batch["image"]))

    def _detect(self, batch: Dict[str, torch.Tensor],
                features: Dict[str, torch.Tensor]) -> Instances:
        image_sizes = batch["image_size"]
        if self.load_proposals:
            proposals = batch_proposals(batch)
        else:
            rpn = self.proposal_generator
            logits, deltas = rpn.rpn_head([features[f] for f in rpn.in_features])
            proposals = rpn.proposals(logits, deltas, image_sizes)

        heads = self.roi_heads
        storage = heads.pooling_storage(features)
        detections = heads.box_detections(proposals, storage, image_sizes)
        return self._instance_outputs(detections, storage)

    def _instance_outputs(self, detections: Instances, storage) -> Instances:
        """The mask and keypoint heads on ``detections`` (when the model has them)."""
        heads = self.roi_heads
        if self.mask_on:
            mask_in = heads.detection_mask_features(detections, storage)
            detections = heads.mask_inference(heads.mask_head(mask_in), detections)
        if self.keypoint_on:
            detections = heads.detection_keypoints(detections, storage)
        return detections

    def predict_with_boxes(self, batch: Dict[str, torch.Tensor],
                           detections: Instances) -> Instances:
        """The mask and keypoint heads on GIVEN ``detections`` (``boxes [B, D,
        4]`` in ``batch``'s frame, ``pred_classes``, ``is_valid``) over
        ``batch``'s features: no proposals and no box stage (the JAX
        ``predict_with_boxes_fn``, Detectron2's ``detected_instances``
        path). TTA attaches masks to its merged boxes this way. Serving
        mode, as :meth:`predict`."""
        with torch.inference_mode(), norms_in_eval(self):
            features = self.features(batch["image"])
            return self._instance_outputs(detections,
                                          self.roi_heads.pooling_storage(features))

    def losses(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
               ) -> Dict[str, torch.Tensor]:
        """The training losses of one batch: ``loss_rpn_cls``, ``loss_rpn_loc``
        (not with ``LOAD_PROPOSALS``), ``loss_cls``, ``loss_box_reg``, with
        ``MASK_ON`` ``loss_mask`` and with ``KEYPOINT_ON`` ``loss_keypoint``
        (float32 scalars).

        ``batch`` holds ``image [B, H, W, 3]``, ``image_size [B, 2]`` and the
        GT fields ``gt_boxes [B, G, 4]``, ``gt_classes [B, G]``,
        ``gt_valid [B, G]``, ``gt_masks [B, G, Mm, Mm]`` (mini-masks in GT-box
        frames; with ``MASK_ON``), ``gt_keypoints [B, G, K, 3]`` (x, y,
        visibility; with ``KEYPOINT_ON``) and optionally ``gt_is_crowd [B, G]``. The two samplers draw
        their uniform noise from ``generator`` (on the batch's device), RPN
        first, unless ``noise = {"rpn": (pos, neg), "roi": (pos, neg)}``
        hands the draws in (``[B, anchors]`` and ``[B, proposals]``). With
        ``LOAD_PROPOSALS`` the batch holds the ``proposal_*`` slots and the
        RPN draw is neither made nor read. A Relation Networks model raises
        ``NotImplementedError`` (``training_not_ported``).
        """
        if self.training_not_ported:
            raise NotImplementedError(self.training_not_ported)
        return self._losses(batch, self.features(batch["image"]), generator, noise)

    def _losses(self, batch, features, generator, noise) -> Dict[str, torch.Tensor]:
        image_sizes = batch["image_size"]
        b, dev = image_sizes.shape[0], image_sizes.device
        noise = dict(noise or {})
        if self.load_proposals:
            losses = {}
            proposals = batch_proposals(batch)
        else:
            rpn = self.proposal_generator
            logits, deltas = rpn.rpn_head([features[f] for f in rpn.in_features])
            if "rpn" not in noise:
                noise["rpn"] = draw_noise(generator, (b, sum(l[0].numel() for l in logits)), dev)
            losses = rpn.losses(logits, deltas, batch, image_sizes, noise["rpn"])
            proposals = rpn.proposals(logits, deltas, image_sizes, training=True)

        heads = self.roi_heads
        if heads.proposal_append_gt:
            proposals = add_ground_truth_to_proposals(proposals, batch)
        roi_noise = noise.get("roi")
        if roi_noise is None:
            roi_noise = draw_noise(generator, proposals.is_valid.shape, dev)
        sampled = heads.label_and_sample_proposals(proposals, batch, roi_noise)
        box_losses, inputs = heads.box_branch_losses(sampled, heads.pooling_storage(features),
                                                     batch)
        losses.update(box_losses)
        if self.mask_on:
            losses["loss_mask"] = heads.mask_loss(heads.mask_head(inputs["mask"]), sampled, batch)
        if self.keypoint_on:
            kp_logits = heads.keypoint_head(inputs["keypoint"]).float()
            losses["loss_keypoint"] = heads.keypoint_loss(kp_logits, sampled, batch)
        return losses


class ProposalNetwork(Detector):
    """The RPN-only meta-architecture: trunk, neck and RPN (the JAX
    ``build_proposal_network``). ``losses`` are the RPN's; ``predict``
    returns the ``POST_NMS_TOPK_TEST`` proposals as ``Instances`` with
    ``boxes``, ``scores`` (objectness logits, -1e10 on empty slots),
    ``pred_classes`` (0) and ``is_valid``."""

    load_proposals = False

    def __init__(self, cfg):
        super().__init__()
        m = cfg.MODEL
        if m.META_ARCHITECTURE != "ProposalNetwork":
            raise NotImplementedError(f"meta-architecture '{m.META_ARCHITECTURE}' is not "
                                      "ProposalNetwork")
        if m.PROPOSAL_GENERATOR.NAME != "RPN":
            raise NotImplementedError(
                f"MODEL.PROPOSAL_GENERATOR.NAME '{m.PROPOSAL_GENERATOR.NAME}' is not ported")
        shapes = self._build_backbone(cfg)
        rpn_in = [shapes[f] for f in m.RPN.IN_FEATURES]
        self.proposal_generator = RPN(cfg, [s for _, s in rpn_in], rpn_in[0][0])

    def _rpn_outputs(self, batch):
        features = self.features(batch["image"])
        rpn = self.proposal_generator
        return rpn.rpn_head([features[f] for f in rpn.in_features])

    def _predict(self, batch: Dict[str, torch.Tensor]) -> Instances:
        logits, deltas = self._rpn_outputs(batch)
        props = self.proposal_generator.proposals(logits, deltas, batch["image_size"])
        scores = props.objectness_logits
        return Instances(boxes=props.proposal_boxes, scores=scores,
                         pred_classes=torch.zeros(scores.shape, dtype=torch.int32,
                                                  device=scores.device),
                         is_valid=props.is_valid)

    def losses(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
               ) -> Dict[str, torch.Tensor]:
        """``loss_rpn_cls`` and ``loss_rpn_loc`` of one batch (the fields of
        :meth:`GeneralizedRCNN.losses` but the masks); the sampler's draws
        come from ``generator`` unless ``noise = {"rpn": (pos, neg)}``."""
        logits, deltas = self._rpn_outputs(batch)
        rpn_noise = (noise or {}).get("rpn")
        if rpn_noise is None:
            b = logits[0].shape[0]
            rpn_noise = draw_noise(generator, (b, sum(l[0].numel() for l in logits)),
                                   logits[0].device)
        return self.proposal_generator.losses(logits, deltas, batch, batch["image_size"],
                                              rpn_noise)


def semantic_logits(model: Detector, features: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The sem-seg head's logits at the input's resolution, float32 ``[B, K, H, W]``."""
    return model.sem_seg_head(features).float()


class PanopticFPN(GeneralizedRCNN):
    """Mask R-CNN R50-FPN plus the semantic FPN head (``sem_seg_head``): the
    JAX ``build_panoptic_fpn``. ``losses`` add ``loss_sem_seg`` (after the
    RPN's, before the ROI heads') and scale the ROI heads' losses, not the
    RPN's, by ``PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT``; ``predict`` adds
    ``sem_seg [B, H, W]`` (int64), the first maximum of the float32 logits
    per pixel. :func:`panoptic_fusion` fuses the two outputs."""

    meta_architecture = "PanopticFPN"

    def __init__(self, cfg):
        super().__init__(cfg)
        self.sem_seg_head = build_sem_seg_head(cfg, self.feature_shapes)
        h = cfg.MODEL.SEM_SEG_HEAD
        self.sem_seg_ignore = h.IGNORE_VALUE
        self.sem_seg_loss_weight = h.LOSS_WEIGHT
        self.instance_loss_weight = cfg.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT

    def _predict(self, batch: Dict[str, torch.Tensor]) -> Instances:
        features = self.features(batch["image"])
        detections = self._detect(batch, features)
        return detections.replace(sem_seg=torch.argmax(semantic_logits(self, features), dim=1))

    def losses(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[Dict[str, Tuple[torch.Tensor, torch.Tensor]]] = None
               ) -> Dict[str, torch.Tensor]:
        """:meth:`GeneralizedRCNN.losses` plus ``loss_sem_seg`` against the
        batch's ``gt_sem_seg [B, H, W]`` (``SEM_SEG_HEAD.IGNORE_VALUE`` where
        unlabelled, and in the padding)."""
        features = self.features(batch["image"])
        found = self._losses(batch, features, generator, noise)
        losses = {k: v for k, v in found.items() if k.startswith("loss_rpn_")}
        losses["loss_sem_seg"] = sem_seg_loss(semantic_logits(self, features), batch["gt_sem_seg"],
                                              self.sem_seg_ignore, self.sem_seg_loss_weight)
        losses.update({k: v * self.instance_loss_weight for k, v in found.items()
                       if k not in losses})
        return losses


class SemanticSegmentor(Detector):
    """Trunk, neck and the semantic FPN head alone (the JAX
    ``build_semantic_segmentor``). ``losses`` give ``loss_sem_seg``;
    ``predict`` gives ``sem_seg [B, H, W]`` (int64, the first maximum),
    ``sem_seg_logits [B, H, W, K]`` (float32) and ``is_valid [B, 1]``
    (torch's argmax takes the first of equal maxima, as JAX's does)."""

    def __init__(self, cfg):
        super().__init__()
        m = cfg.MODEL
        if m.META_ARCHITECTURE != "SemanticSegmentor":
            raise NotImplementedError(f"meta-architecture '{m.META_ARCHITECTURE}' is not "
                                      "SemanticSegmentor")
        self.sem_seg_head = build_sem_seg_head(cfg, self._build_backbone(cfg))
        self.sem_seg_ignore = m.SEM_SEG_HEAD.IGNORE_VALUE
        self.sem_seg_loss_weight = m.SEM_SEG_HEAD.LOSS_WEIGHT

    def _predict(self, batch: Dict[str, torch.Tensor]) -> Instances:
        logits = semantic_logits(self, self.features(batch["image"]))
        return Instances(sem_seg=torch.argmax(logits, dim=1),
                         sem_seg_logits=logits.permute(0, 2, 3, 1),
                         is_valid=torch.ones((logits.shape[0], 1), dtype=torch.bool,
                                             device=logits.device))

    def losses(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """``loss_sem_seg`` of one batch (``image``, ``gt_sem_seg``); nothing is drawn."""
        del generator, noise
        logits = semantic_logits(self, self.features(batch["image"]))
        return {"loss_sem_seg": sem_seg_loss(logits, batch["gt_sem_seg"], self.sem_seg_ignore,
                                             self.sem_seg_loss_weight)}


def panoptic_fusion(cfg, detections: Instances):
    """The panoptic fusion of a PanopticFPN's ``predict`` output (its
    ``pred_masks`` and ``sem_seg``) with ``PANOPTIC_FPN.COMBINE``'s
    thresholds: ``(panoptic_map [B, H, W], segment tables)``, see
    :func:`..sem_seg.combine_semantic_and_instance_outputs`."""
    comb = cfg.MODEL.PANOPTIC_FPN.COMBINE
    return combine_semantic_and_instance_outputs(
        detections, detections.sem_seg, comb.OVERLAP_THRESH, comb.STUFF_AREA_LIMIT,
        comb.INSTANCES_CONFIDENCE_THRESH, cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES)


META_ARCHITECTURES = {"GeneralizedRCNN": GeneralizedRCNN, "ProposalNetwork": ProposalNetwork,
                      "SingleStageDetector": SingleStageDetector, "PanopticFPN": PanopticFPN,
                      "SemanticSegmentor": SemanticSegmentor}


def meta_architecture(cfg):
    """The model class ``MODEL.META_ARCHITECTURE`` names; raises for the
    families not ported yet."""
    name = cfg.MODEL.META_ARCHITECTURE
    if name not in META_ARCHITECTURES:
        raise NotImplementedError(f"meta-architecture '{name}' is not ported "
                                  f"(ported: {sorted(META_ARCHITECTURES)})")
    return META_ARCHITECTURES[name]


# Layers the JAX package initializes with small normals (std by port name; a
# cascade's stages, ``roi_heads.box_predictor.{k}``, as the one predictor).
_SMALL_INIT = {
    "proposal_generator.rpn_head.conv": 0.01,
    "proposal_generator.rpn_head.objectness_logits": 0.01,
    "proposal_generator.rpn_head.anchor_deltas": 0.01,
    "roi_heads.box_predictor.cls_score": 0.01,
    "roi_heads.box_predictor.bbox_pred": 0.001,
    "roi_heads.mask_head.predictor": 0.001,
    "sem_seg_head.predictor": 0.001,
    "head.cls_score": 0.01,
    "head.bbox_pred": 0.01,
    "head.cate_pred": 0.01,
    "head.kernel_pred": 0.01,
    "head.pred1": 0.01,
    "head.pred2": 0.01,
    "head.pred3": 0.01,
}
# RetinaNet's towers and YOLOv4's 3x3 head convs: normal(0.01) in the JAX package,
# variance-preserving for serving.
_JAX_TOWERS = ("head.cls_subnet.", "head.bbox_subnet.", "head.conv1", "head.conv2", "head.conv3")
# The last norm of a residual branch, scaled by 0.2 for serving: a ResNet
# bottleneck's conv3, a DarkNet block's conv2.
_RESIDUAL_NORM = re.compile(r"(conv3|\.block_\d+\.conv2)\.norm$")
# The JAX initializers' truncated normal keeps [-2, 2] standard deviations and rescales by
# this factor so that the kept values have the asked variance.
_TRUNC_STD = 0.87962566103423978
INIT_RECIPES = ("serving", "jax")


def _small_std(name: str, jax_recipe: bool) -> Optional[float]:
    """The small normal's std of layer ``name``, or None (the recipe's rule)."""
    name = re.sub(r"^roi_heads\.box_predictor\.\d+\.", "roi_heads.box_predictor.", name)
    if jax_recipe and name.startswith(_JAX_TOWERS):
        return 0.01
    return _SMALL_INIT.get(name)


def init_weights(model: nn.Module, generator: torch.Generator,
                 recipe: str = "serving") -> None:
    """Seeded random weights: ``recipe`` "serving" (``_init_for_serving``)
    or "jax". Either way the classifier bias of RetinaNet's and SOLOv2's
    head starts at its prior (``prior_bias``), as in the JAX package.

    "jax" draws from the JAX package's initializers, the ones its ``train.py``
    starts from scratch with: convs and the deconv truncated normal with
    variance ``2 / fan_out`` (``variance_scaling(2.0, "fan_out",
    "normal")``; RetinaNet's P6 and P7 too), the box head's FCs uniform with
    variance ``1 / fan_in``, the small normals of the RPN head, the
    predictors, RetinaNet's head (every conv of it), SOLOv2's
    ``cate_pred`` and ``kernel_pred`` and YOLOv4's head (every conv of it),
    zero biases, GN
    and BN at identity with BN's running statistics at (0, 1) (FrozenBN
    keeps its identity buffers), a deformable conv's kernel as a conv's and
    its offset conv at zero (``DeformConv2D``'s initializers), and the
    Relation Networks layers (the relation box head's FCs and attention, the
    duplicate removal) the JAX ``Dense`` layer's default: a truncated normal
    with variance ``1 / fan_in`` (``lecun_normal``).
    """
    if recipe == "jax":
        _init_like_jax(model, generator)
    elif recipe == "serving":
        _init_for_serving(model, generator)
    else:
        raise ValueError(f"unknown init recipe {recipe!r} (known: {INIT_RECIPES})")
    head = getattr(model, "head", None)
    if hasattr(head, "prior_bias"):  # not YOLOv4's head, which has no prior
        with torch.no_grad():
            classifier = head.cate_pred if hasattr(head, "cate_pred") else head.cls_score
            classifier.bias.fill_(head.prior_bias)


def _is_offset_conv(name: str) -> bool:
    return name.rsplit(".", 1)[-1] == OFFSET_CONV


def _trunc_normal(shape, std: float, generator: torch.Generator) -> torch.Tensor:
    """The JAX initializers' truncated normal: [-2, 2] of ``std`` /
    ``_TRUNC_STD``, so that the kept values have variance ``std ** 2``."""
    std = std / _TRUNC_STD
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=generator)
    return t


def _init_like_jax(model: nn.Module, generator: torch.Generator) -> None:
    lecun = {id(m) for top in model.modules()
             if isinstance(top, (RelationBoxHead, DuplicateRemovalModule)) for m in top.modules()}
    with torch.no_grad():
        for name, mod in model.named_modules():
            if _is_offset_conv(name):
                mod.weight.zero_()
                mod.bias.zero_()
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, DeformConv2d)):
                w = mod.weight
                small = _small_std(name, jax_recipe=True)
                if small is not None:
                    w.copy_(torch.randn(w.shape, generator=generator) * small)
                elif id(mod) in lecun:
                    w.copy_(_trunc_normal(w.shape, math.sqrt(1.0 / w.shape[1]), generator))
                elif isinstance(mod, nn.Linear):
                    limit = math.sqrt(3.0 / w.shape[1])
                    w.copy_((torch.rand(w.shape, generator=generator) * 2 - 1) * limit)
                else:
                    out = w.shape[1] if isinstance(mod, nn.ConvTranspose2d) else w.shape[0]
                    w.copy_(_trunc_normal(w.shape, math.sqrt(2.0 / (out * w[0, 0].numel())),
                                          generator))
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            elif isinstance(mod, (nn.GroupNorm, BatchNorm2d)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
                if isinstance(mod, BatchNorm2d):
                    mod.running_mean.zero_()
                    mod.running_var.fill_(1.0)


def _init_for_serving(model: nn.Module, generator: torch.Generator) -> None:
    """Seeded random weights that keep activations of order one.

    Convs and FCs are variance-preserving (He-normal over fan-in, with the
    JAX package's small normals for the RPN head, the predictors,
    RetinaNet's classifier and box convs, SOLOv2's ``cate_pred`` and
    ``kernel_pred`` and YOLOv4's predictors: the sigmoid scores start near
    the prior, unsaturated, and YOLOv4's boxes near their anchors), and
    every residual branch's last norm (a bottleneck's ``conv3``, a DarkNet
    block's ``conv2``) scales it by 0.2, so the residual stream does not
    grow with depth. With zero biases the network
    is linear in the input's scale up to the softmax; the stem's FrozenBN
    scales the raw pixels (std 1, values up to ~130) by 1/640, which keeps
    the class softmax unsaturated (scores near 1/81 at 80 classes) and the
    RPN deltas small, so proposals are real boxes near their anchors. A
    deformable conv's offset conv gets zero weights and standard normal
    biases: constant offsets of about a pixel, whatever the activations'
    scale, so its samples fall between pixels and, at the borders, off the
    map.
    """
    with torch.no_grad():
        for name, mod in model.named_modules():
            if _is_offset_conv(name):
                mod.weight.zero_()
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=generator))
            elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear, DeformConv2d)):
                w = mod.weight
                std = _small_std(name, jax_recipe=False)
                if std is None and isinstance(mod, nn.ConvTranspose2d):
                    # Each output sums in_channels * (kernel / stride)^2 taps.
                    taps = w.shape[0] * (w.shape[2] // mod.stride[0]) * (w.shape[3] // mod.stride[1])
                    std = math.sqrt(2.0 / taps)
                elif std is None:
                    std = math.sqrt(2.0 / w[0].numel())
                w.copy_(torch.randn(w.shape, generator=generator) * std)
                if getattr(mod, "bias", None) is not None:
                    mod.bias.zero_()
            if hasattr(mod, "running_var"):
                if name.endswith("stem.conv1.norm"):
                    mod.weight.fill_(1.0 / 640)
                elif _RESIDUAL_NORM.search(name):
                    mod.weight.fill_(0.2)
