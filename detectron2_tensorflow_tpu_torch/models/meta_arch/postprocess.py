"""Serving output format: the ``conventional`` mode of ``detector_postprocess``.

Port of that mode of the JAX package's ``models/meta_arch/postprocess.py``:
soft ``[B, D, m, m]`` masks are pasted at their boxes into the
network-input-shaped canvas and binarized to uint8.
"""

from __future__ import annotations

import torch

from ...structures import Instances
from ...structures.masks import paste_masks_in_image


def detector_postprocess(cfg, detections: Instances, batch,
                         mask_threshold: float = 0.5) -> Instances:
    """Replace ``pred_masks`` by uint8 ``[B, D, H, W]`` image masks."""
    if "pred_masks" not in detections:
        return detections
    fmt = cfg.MODEL.SEGMENTATION_OUTPUT.FORMAT
    if fmt != "conventional":
        raise NotImplementedError(f"SEGMENTATION_OUTPUT.FORMAT '{fmt}' is not ported")
    h, w = batch["image"].shape[1:3]
    masks = detections.pred_masks
    pasted = [
        paste_masks_in_image(m, bx, (h, w), mask_threshold)
        for m, bx in zip(masks, detections.boxes)
    ]
    return detections.replace(pred_masks=torch.stack(pasted).to(torch.uint8))
