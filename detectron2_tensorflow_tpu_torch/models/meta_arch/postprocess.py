"""Serving output format: the ``conventional`` mode of ``detector_postprocess``,
and ``sem_seg_postprocess``'s ``conventional`` and ``raw`` modes.

Port of those modes of the JAX package's ``models/meta_arch/postprocess.py``:
soft ``[B, D, m, m]`` masks are pasted at their boxes into the
network-input-shaped canvas and binarized to uint8; a semantic map keeps the
network-input canvas with its padding zeroed. The ``fixed`` format raises.
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


def sem_seg_postprocess(cfg, sem_seg: torch.Tensor, batch) -> torch.Tensor:
    """``sem_seg [B, H, W]`` (the network-input canvas) with every pixel
    outside the image's ``image_size`` set to 0, for the ``conventional``
    and ``raw`` formats."""
    fmt = cfg.MODEL.SEGMENTATION_OUTPUT.FORMAT
    if fmt not in ("conventional", "raw"):
        raise NotImplementedError(f"SEGMENTATION_OUTPUT.FORMAT '{fmt}' is not ported for "
                                  "semantic maps")
    h, w = sem_seg.shape[1:3]
    sizes = batch["image_size"].to(sem_seg.device)
    ys = torch.arange(h, device=sem_seg.device)[None, :, None]
    xs = torch.arange(w, device=sem_seg.device)[None, None, :]
    content = (ys < sizes[:, 0, None, None]) & (xs < sizes[:, 1, None, None])
    return torch.where(content, sem_seg, torch.zeros_like(sem_seg))
