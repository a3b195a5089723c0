"""Numpy mask pasting for host-side evaluation (a copy of the JAX
package's ``evaluation/np_masks.py``, with the numpy bilinear resize of
``data/transforms.py`` in place of ``cv2``).

The separable-bilinear paste of ``structures/masks.py`` (two matmuls per
mask), in numpy, pastes the 28x28 predicted masks at the ORIGINAL image
resolution before mask IoU: the device pastes only at network resolution.
"""

from __future__ import annotations

import numpy as np

from ..data.transforms import resize_bilinear


def _weights(out_size: int, lo: float, hi: float, m: int) -> np.ndarray:
    pix = np.arange(out_size, dtype=np.float64) + 0.5
    extent = max(hi - lo, 1e-4)
    coord = (pix - lo) / extent * m - 0.5
    cells = np.arange(m, dtype=np.float64)
    return np.maximum(0.0, 1.0 - np.abs(coord[:, None] - cells[None, :]))


def fullframe_masks_to_image(
    masks: np.ndarray, rh: int, rw: int, height: int, width: int,
    stride: int = 4, threshold: float = 0.5,
) -> np.ndarray:
    """Full-frame predicted masks (SOLOv2: whole padded frame at the
    mask-feature stride, solov2.py inference) -> [N, H, W] bool at the
    original resolution. Crops the valid content region (the resized image
    occupies [0:rh, 0:rw] of the padded frame) before upsampling — unlike
    ``paste_masks``, which expects box-cropped M x M masks."""
    ch = max(int(np.ceil(rh / stride)), 1)
    cw = max(int(np.ceil(rw / stride)), 1)
    out = np.zeros((len(masks), height, width), bool)
    for i, m in enumerate(masks):
        crop = np.asarray(m[:ch, :cw], np.float32)
        out[i] = resize_bilinear(crop, height, width) > threshold
    return out


def paste_masks(
    masks: np.ndarray, boxes: np.ndarray, height: int, width: int,
    threshold: float = 0.5,
) -> np.ndarray:
    """[N, M, M] soft masks + [N, 4] xyxy -> [N, H, W] bool."""
    n = len(masks)
    out = np.zeros((n, height, width), bool)
    for i in range(n):
        x0, y0, x1, y1 = boxes[i]
        # Only touch the box's pixel span (fast for small boxes).
        px0 = max(int(np.floor(x0)) - 1, 0)
        py0 = max(int(np.floor(y0)) - 1, 0)
        px1 = min(int(np.ceil(x1)) + 1, width)
        py1 = min(int(np.ceil(y1)) + 1, height)
        if px1 <= px0 or py1 <= py0:
            continue
        wy = _weights(py1 - py0, y0 - py0, y1 - py0, masks.shape[1])
        wx = _weights(px1 - px0, x0 - px0, x1 - px0, masks.shape[2])
        patch = wy @ masks[i].astype(np.float64) @ wx.T
        out[i, py0:py1, px0:px1] = patch > threshold
    return out
