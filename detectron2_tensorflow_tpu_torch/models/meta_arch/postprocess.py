"""Serving output formats (``MODEL.SEGMENTATION_OUTPUT.FORMAT``):
``detector_postprocess`` and ``sem_seg_postprocess``.

Port of the JAX package's ``models/meta_arch/postprocess.py``. Every format
returns uint8 binary masks:

  * ``raw``: the head's masks binarized where they are (an R-CNN's
    ``[B, D, m, m]`` box crops, SOLOv2's whole frames at stride 4);
  * ``conventional``: an R-CNN's soft masks pasted at their boxes into the
    network-input-shaped canvas; SOLOv2's frames resized to that canvas
    (``jax.image.resize``'s bilinear rule);
  * ``fixed``: a square canvas of ``FIXED_RESOLUTION``: an R-CNN's boxes
    rescaled by the canvas over the image's true size and pasted there;
    SOLOv2's frames sampled over the image's content region at the
    canvas's cell centres, bilinearly with the frame's edge repeated
    (``jax.scipy.ndimage.map_coordinates(order=1, mode="nearest")``, its
    four products summed in its order).

A semantic map keeps the network-input canvas with its padding zeroed
(``conventional``, ``raw``) or, ``fixed``, has its content region resized to
the square canvas by the nearest rule.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ...structures import Instances
from ...structures.masks import paste_masks_in_image


def fullframe_masks(cfg) -> bool:
    """Whether the model's masks are whole frames (SOLOv2), not box crops."""
    return (cfg.MODEL.META_ARCHITECTURE == "SingleStageDetector"
            and cfg.MODEL.SINGLE_STAGE_HEAD.NAME == "SOLOv2Head")


def sample_frames(frames: torch.Tensor, extent_y: torch.Tensor, extent_x: torch.Tensor,
                  r: int) -> torch.Tensor:
    """``[B, N, Hm, Wm]`` frames sampled at ``r x r`` cell centres spread over
    each image's ``[0, extent_y) x [0, extent_x)`` (frame cells, ``[B]``):
    bilinear, indices clamped to the frame (float32 ``[B, N, r, r]``)."""
    b, n, hm, wm = frames.shape
    frames = frames.float()
    steps = torch.arange(r, device=frames.device, dtype=torch.float32) + 0.5
    ys = steps[None] * extent_y[:, None] / r - 0.5  # [B, r]
    xs = steps[None] * extent_x[:, None] / r - 0.5

    def nodes(c, size):
        lower = torch.floor(c)
        upper_w = c - lower
        index = lower.to(torch.int64)
        return [(torch.clamp(index, 0, size - 1), 1 - upper_w),
                (torch.clamp(index + 1, 0, size - 1), upper_w)]

    flat = frames.reshape(b, n, hm * wm)
    out = None
    for yi, wy in nodes(ys, hm):
        for xi, wx in nodes(xs, wm):
            idx = (yi[:, :, None] * wm + xi[:, None, :]).reshape(b, 1, r * r).expand(b, n, -1)
            weight = (wy[:, :, None] * wx[:, None, :]).reshape(b, 1, r * r)
            term = weight * torch.gather(flat, 2, idx)
            out = term if out is None else out + term
    return out.reshape(b, n, r, r)


def detector_postprocess(cfg, detections: Instances, batch,
                         mask_threshold: float = 0.5) -> Instances:
    """Replace ``pred_masks`` by uint8 masks in the configured format
    (module docstring); detections without masks pass through."""
    if "pred_masks" not in detections:
        return detections
    fmt = cfg.MODEL.SEGMENTATION_OUTPUT.FORMAT
    masks, boxes = detections.pred_masks, detections.boxes

    def binary(m):
        return detections.replace(pred_masks=(m > mask_threshold).to(torch.uint8))

    if fmt == "raw":
        return binary(masks)
    h, w = batch["image"].shape[1:3]
    if fullframe_masks(cfg):
        b, n, mh, mw = masks.shape
        if fmt == "conventional":
            up = F.interpolate(masks.float().reshape(b * n, 1, mh, mw), size=(h, w),
                               mode="bilinear", align_corners=False, antialias=True)
            return binary(up.reshape(b, n, h, w))
        if fmt == "fixed":
            sizes = batch["image_size"].to(masks.device).float()
            return binary(sample_frames(masks, sizes[:, 0] * (mh / h), sizes[:, 1] * (mw / w),
                                        cfg.MODEL.SEGMENTATION_OUTPUT.FIXED_RESOLUTION))
    if fmt == "conventional":
        pasted = [paste_masks_in_image(m, bx, (h, w), mask_threshold)
                  for m, bx in zip(masks, boxes)]
        return detections.replace(pred_masks=torch.stack(pasted).to(torch.uint8))
    if fmt == "fixed":
        r = cfg.MODEL.SEGMENTATION_OUTPUT.FIXED_RESOLUTION
        # Each image's boxes scaled by the canvas over its true size.
        scale = r / batch["image_size"].to(boxes.device).float()  # [B, 2] (h, w)
        sc = torch.stack([scale[:, 1], scale[:, 0], scale[:, 1], scale[:, 0]], -1)
        pasted = [paste_masks_in_image(m, bx, (r, r), mask_threshold)
                  for m, bx in zip(masks, boxes * sc[:, None, :])]
        return detections.replace(pred_masks=torch.stack(pasted).to(torch.uint8))
    raise ValueError(f"unknown SEGMENTATION_OUTPUT.FORMAT '{fmt}'")


def sem_seg_postprocess(cfg, sem_seg: torch.Tensor, batch) -> torch.Tensor:
    """``sem_seg [B, H, W]`` (the network-input canvas) with every pixel
    outside the image's ``image_size`` set to 0 (``conventional``, ``raw``);
    ``fixed`` then resizes each image's content region to the ``r x r``
    canvas by the nearest rule (the source pixel of cell ``i`` is
    ``floor((i + 0.5) * size / r)``, clipped to the canvas)."""
    fmt = cfg.MODEL.SEGMENTATION_OUTPUT.FORMAT
    if fmt not in ("conventional", "raw", "fixed"):
        raise ValueError(f"unknown SEGMENTATION_OUTPUT.FORMAT '{fmt}'")
    h, w = sem_seg.shape[1:3]
    sizes = batch["image_size"].to(sem_seg.device)
    ys = torch.arange(h, device=sem_seg.device)[None, :, None]
    xs = torch.arange(w, device=sem_seg.device)[None, None, :]
    content = (ys < sizes[:, 0, None, None]) & (xs < sizes[:, 1, None, None])
    sem_seg = torch.where(content, sem_seg, torch.zeros_like(sem_seg))
    if fmt != "fixed":
        return sem_seg
    r = cfg.MODEL.SEGMENTATION_OUTPUT.FIXED_RESOLUTION
    steps = torch.arange(r, device=sem_seg.device, dtype=torch.float32) + 0.5
    iy = torch.clamp(steps[None] * (sizes[:, :1].float() / r), 0, h - 1).to(torch.int64)
    ix = torch.clamp(steps[None] * (sizes[:, 1:].float() / r), 0, w - 1).to(torch.int64)
    rows = torch.gather(sem_seg, 1, iy[:, :, None].expand(-1, -1, w))
    return torch.gather(rows, 2, ix[:, None, :].expand(-1, r, -1))
