"""SingleStageDetector: trunk, neck and a dense head (RetinaNet or SOLOv2).

Port of the RetinaNet and SOLOv2 branches of the JAX package's
``models/meta_arch/single_stage.py``: the trunk and FPN of
:class:`~.common.Detector`, then a dense head whose float32 outputs go to
the losses or the inference of ``RetinaNet`` or ``SOLOv2``.

  * ``RetinaNetHead`` (over ``res3..res5``, with the ``P6P7`` top block):
    :class:`~..single_stage.retinanet.RetinaNetHead` on p3-p7. The EMA loss
    normalizer (the JAX package's ``TrainState.aux``, starting at 100) is
    the float32 buffer ``loss_normalizer``: each ``losses`` call divides by
    its new value and stores it, as each JAX train step returns it, and
    ``state_dict`` (so checkpoints and resume) carries it.
  * ``SOLOv2Head`` (over ``res2..res5``, with the ``MAXPOOL`` top block):
    :class:`~..single_stage.solov2.SOLOv2Head` on p2-p6 and the mask
    features; ``predict`` gives whole-frame masks at stride 4.

The YOLOv4 head and the DarkNet trunk raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...structures import Instances
from ..single_stage.retinanet import RetinaNet, RetinaNetHead
from ..single_stage.solov2 import SOLOv2
from .common import Detector

# The EMA loss normalizer's start (the JAX ``initial_state``).
INITIAL_LOSS_NORMALIZER = 100.0
HEADS = ("RetinaNetHead", "SOLOv2Head")


class SingleStageDetector(Detector):
    """RetinaNet or SOLOv2; ``predict(batch)`` is the serving entry point."""

    load_proposals = False

    def __init__(self, cfg):
        super().__init__()
        m = cfg.MODEL
        if m.META_ARCHITECTURE != "SingleStageDetector":
            raise NotImplementedError(f"meta-architecture '{m.META_ARCHITECTURE}' is not "
                                      "SingleStageDetector")
        head_name = m.SINGLE_STAGE_HEAD.NAME
        if head_name not in HEADS:
            raise NotImplementedError(f"single-stage head '{head_name}' is not ported "
                                      f"(ported: {HEADS})")
        self.mask_on = head_name == "SOLOv2Head"
        shapes = self._build_backbone(cfg)
        head_in = [shapes[f] for f in m.SINGLE_STAGE_HEAD.IN_FEATURES]
        if self.mask_on:
            self.solov2 = SOLOv2(cfg)
            self.head = self.solov2.build_head(cfg, head_in[0][0])
            return
        self.retinanet = RetinaNet(cfg, [s for _, s in head_in])
        self.head = RetinaNetHead(head_in[0][0], self.retinanet.num_classes,
                                  self.retinanet.num_anchors, m.RETINANET.NUM_CONVS,
                                  m.RETINANET.PRIOR_PROB)
        self.register_buffer("loss_normalizer", torch.tensor(INITIAL_LOSS_NORMALIZER))

    def _head_outputs(self, images: torch.Tensor):
        features = self.features(images)
        if self.mask_on:
            cate, kernels, mask_features = self.head(features)
            return ([c.float() for c in cate], [k.float() for k in kernels],
                    mask_features.float())
        logits, deltas = self.head([features[f] for f in self.retinanet.in_features])
        return [l.float() for l in logits], [d.float() for d in deltas]

    def _predict(self, batch: Dict[str, torch.Tensor]) -> Instances:
        """``batch = {"image": [B, H, W, 3], "image_size": [B, 2]}`` ->
        ``Instances`` (``boxes``, ``scores``, ``pred_classes``, ``is_valid``
        and, from SOLOv2, ``pred_masks``; ``DETECTIONS_PER_IMAGE`` slots)."""
        outputs = self._head_outputs(batch["image"])
        if self.mask_on:
            return self.solov2.inference(*outputs)
        return self.retinanet.inference(*outputs, batch["image_size"])

    def losses(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """The losses of one batch (``image``, and the GT fields ``gt_boxes``,
        ``gt_classes``, ``gt_valid`` and, for SOLOv2, the mini-masks
        ``gt_masks``). RetinaNet: ``loss_cls`` and ``loss_box_reg``, each
        divided by the updated ``loss_normalizer``; it samples nothing, so
        ``generator`` and ``noise`` are not read. SOLOv2: ``loss_ins`` and
        ``loss_cate``; the positive cap's uniform draws are ``noise["solo"]``
        (``[B, cells]`` in [0, 0.5)) when given, else from ``generator``."""
        outputs = self._head_outputs(batch["image"])
        if self.mask_on:
            return self.solov2.losses(*outputs, batch, tuple(batch["image"].shape[1:3]),
                                      generator, (noise or {}).get("solo"))
        losses, new_norm = self.retinanet.losses(*outputs, batch, self.loss_normalizer)
        with torch.no_grad():
            self.loss_normalizer.copy_(new_norm)
        return losses
