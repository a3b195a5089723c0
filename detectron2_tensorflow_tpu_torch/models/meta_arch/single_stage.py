"""SingleStageDetector: trunk, neck and a dense head (RetinaNet).

Port of the RetinaNet branch of the JAX package's
``models/meta_arch/single_stage.py``: the trunk and FPN of
:class:`~.common.Detector` (over ``res3..res5``, with the ``P6P7`` top
block), then :class:`~..single_stage.retinanet.RetinaNetHead` on p3-p7,
whose float32 outputs go to ``RetinaNet``'s losses or inference.
The EMA loss normalizer (the JAX package's ``TrainState.aux``, starting at
100) is the float32 buffer ``loss_normalizer``: each ``losses`` call divides
by its new value and stores it, as each JAX train step returns it, and
``state_dict`` (so checkpoints and resume) carries it. The SOLOv2 and YOLOv4
heads and the DarkNet trunk raise ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from ...structures import Instances
from ..single_stage.retinanet import RetinaNet, RetinaNetHead
from .common import Detector

# The EMA loss normalizer's start (the JAX ``initial_state``).
INITIAL_LOSS_NORMALIZER = 100.0


class SingleStageDetector(Detector):
    """RetinaNet; ``predict(batch)`` is the serving entry point."""

    load_proposals = False

    def __init__(self, cfg):
        super().__init__()
        m = cfg.MODEL
        if m.META_ARCHITECTURE != "SingleStageDetector":
            raise NotImplementedError(f"meta-architecture '{m.META_ARCHITECTURE}' is not "
                                      "SingleStageDetector")
        if m.SINGLE_STAGE_HEAD.NAME != "RetinaNetHead":
            raise NotImplementedError(f"single-stage head '{m.SINGLE_STAGE_HEAD.NAME}' is not "
                                      "ported (RetinaNetHead is)")
        self.mask_on = False
        shapes = self._build_backbone(cfg)
        head_in = [shapes[f] for f in m.SINGLE_STAGE_HEAD.IN_FEATURES]
        self.retinanet = RetinaNet(cfg, [s for _, s in head_in])
        self.head = RetinaNetHead(head_in[0][0], self.retinanet.num_classes,
                                  self.retinanet.num_anchors, m.RETINANET.NUM_CONVS,
                                  m.RETINANET.PRIOR_PROB)
        self.register_buffer("loss_normalizer", torch.tensor(INITIAL_LOSS_NORMALIZER))

    def _head_outputs(self, images: torch.Tensor):
        features = self.features(images)
        logits, deltas = self.head([features[f] for f in self.retinanet.in_features])
        return [l.float() for l in logits], [d.float() for d in deltas]

    def _predict(self, batch: Dict[str, torch.Tensor]) -> Instances:
        """``batch = {"image": [B, H, W, 3], "image_size": [B, 2]}`` ->
        ``Instances`` (``boxes``, ``scores``, ``pred_classes``, ``is_valid``;
        ``DETECTIONS_PER_IMAGE`` slots)."""
        logits, deltas = self._head_outputs(batch["image"])
        return self.retinanet.inference(logits, deltas, batch["image_size"])

    def losses(self, batch: Dict[str, torch.Tensor],
               generator: Optional[torch.Generator] = None,
               noise: Optional[dict] = None) -> Dict[str, torch.Tensor]:
        """``loss_cls`` and ``loss_box_reg`` of one batch (``image``, and the
        GT fields ``gt_boxes``, ``gt_classes``, ``gt_valid``), each divided
        by the updated ``loss_normalizer``. Nothing is sampled, so
        ``generator`` and ``noise`` (the R-CNNs' signature) are not read."""
        del generator, noise
        logits, deltas = self._head_outputs(batch["image"])
        losses, new_norm = self.retinanet.losses(logits, deltas, batch, self.loss_normalizer)
        with torch.no_grad():
            self.loss_normalizer.copy_(new_norm)
        return losses
