"""Paste fixed-resolution box masks into full images.

Port of the JAX package's ``structures/masks.py``: bilinear
interpolation along each axis is a linear map, so a pasted mask is
``W_y @ mask @ W_x^T`` with hat-function weights evaluated at the
box-relative pixel centers (``align_corners=False`` with zero padding).
"""

from __future__ import annotations

from typing import Tuple

import torch


def _bilinear_weight_matrix(out_size: int, lo: torch.Tensor, hi: torch.Tensor,
                            mask_size: int) -> torch.Tensor:
    """``[N, out_size, mask_size]`` weights mapping mask cells to image pixels.

    Output pixel center ``p + 0.5`` maps to mask coordinate
    ``(p + 0.5 - lo) / (hi - lo) * mask_size - 0.5``; cell ``m`` gets
    ``max(0, 1 - |coord - m|)``.
    """
    dtype, device = lo.dtype, lo.device
    pix = torch.arange(out_size, dtype=dtype, device=device) + 0.5
    extent = torch.clamp(hi - lo, min=1e-4)
    coord = (pix[None, :] - lo[:, None]) / extent[:, None] * mask_size - 0.5
    cells = torch.arange(mask_size, dtype=dtype, device=device)
    return torch.clamp(1.0 - torch.abs(coord[:, :, None] - cells), min=0.0)


def paste_masks_in_image(
    masks: torch.Tensor,
    boxes: torch.Tensor,
    image_size: Tuple[int, int],
    threshold: float = 0.5,
) -> torch.Tensor:
    """Paste ``[N, Mh, Mw]`` soft masks into ``[N, H, W]`` image masks.

    ``boxes``: ``[N, 4]`` xyxy absolute pixels. ``threshold >= 0`` returns a
    bool mask; ``threshold < 0`` returns the soft float masks.
    """
    n, mh, mw = masks.shape
    h, w = image_size
    masks = masks.float() if not torch.is_floating_point(masks) else masks
    boxes = boxes.to(masks.dtype)
    wy = _bilinear_weight_matrix(h, boxes[:, 1], boxes[:, 3], mh)  # [N, H, Mh]
    wx = _bilinear_weight_matrix(w, boxes[:, 0], boxes[:, 2], mw)  # [N, W, Mw]
    pasted = torch.bmm(torch.bmm(wy, masks), wx.transpose(1, 2))  # [N, H, W]
    if threshold >= 0:
        return pasted > threshold
    return pasted
