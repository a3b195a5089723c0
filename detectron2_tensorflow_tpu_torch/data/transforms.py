"""Host-side sample transforms: flip -> shortest-edge resize -> mini-masks.

Port of the default COCO pipeline of the JAX package's ``data/transforms.py``
(``flip_horizontal``, ``resize_shortest_edge``, ``make_mini_masks``,
``run``) in numpy, without ``cv2``. The resize is bilinear with half-pixel
centres, clamped at the borders, as ``cv2.INTER_LINEAR`` samples: each
output coordinate maps to ``(d + 0.5) * in / out - 0.5``, the two source
taps get float32 weights, and the rows are filtered before the columns. For
float32 masks this agrees with ``cv2`` to float32 rounding; ``cv2`` filters
uint8 images in fixed point, so images agree to one level.

Every augmentation the default config leaves off (crop, vertical flip,
rotation, the colour changes, box jitter) raises ``NotImplementedError``
naming its ``AUGMENT.*`` key. Samples that carry keypoints, semantic maps or
precomputed proposals belong to families the port does not have yet and
raise too.

Samples are dicts: image uint8 [H, W, 3] RGB, boxes float32 [N, 4] xyxy
absolute, classes int [N], is_crowd bool [N], masks float [N, H, W]
(optional).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

_UNPORTED_FIELDS = ("keypoints", "proposals", "sem_seg")
_OFF_AUGMENTATIONS = (
    ("CROP.ENABLED", lambda a: a.CROP.ENABLED),
    ("VERTICAL_FLIP", lambda a: a.VERTICAL_FLIP),
    ("ROTATE", lambda a: a.ROTATE),
    ("PIXEL_VALUE_SCALE.ENABLED", lambda a: a.PIXEL_VALUE_SCALE.ENABLED),
    ("ADJUST_BRIGHTNESS.ENABLED", lambda a: a.ADJUST_BRIGHTNESS.ENABLED),
    ("ADJUST_CONSTRACT.ENABLED", lambda a: a.ADJUST_CONSTRACT.ENABLED),
    ("ADJUST_HUE.ENABLED", lambda a: a.ADJUST_HUE.ENABLED),
    ("ADJUST_SATURATION.ENABLED", lambda a: a.ADJUST_SATURATION.ENABLED),
    ("DISTORT_COLOR.ENABLED", lambda a: a.DISTORT_COLOR.ENABLED),
    ("JITTER_BOX.ENABLED", lambda a: a.JITTER_BOX.ENABLED),
)


def check_supported(cfg, sample: Optional[Dict] = None) -> None:
    """Raise ``NotImplementedError`` for an augmentation or a sample field
    the port does not have yet."""
    for key, enabled in _OFF_AUGMENTATIONS:
        if enabled(cfg.AUGMENT):
            raise NotImplementedError(f"AUGMENT.{key} is not ported")
    for field in _UNPORTED_FIELDS:
        if sample is not None and sample.get(field) is not None:
            raise NotImplementedError(f"samples with '{field}' are not ported")


# -- bilinear resize ----------------------------------------------------------

def _taps(n_out: int, n_in: int):
    """Source indices and float32 weights of a half-pixel bilinear resize
    along one axis."""
    f = (np.arange(n_out, dtype=np.float64) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    frac = f - i0
    low = i0 < 0
    frac[low], i0[low] = 0.0, 0
    high = i0 >= n_in - 1
    frac[high], i0[high] = 0.0, n_in - 1
    i1 = np.minimum(i0 + 1, n_in - 1)
    return i0, i1, (1.0 - frac).astype(np.float32), frac.astype(np.float32)


def resize_bilinear(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """``arr [H, W(, C)]`` -> float32 ``[height, width(, C)]``."""
    a = np.asarray(arr, np.float32)
    h, w = a.shape[:2]
    x0, x1, wx0, wx1 = _taps(width, w)
    y0, y1, wy0, wy1 = _taps(height, h)
    extra = (1,) * (a.ndim - 2)
    rows = a[:, x0] * wx0.reshape(1, -1, *extra) + a[:, x1] * wx1.reshape(1, -1, *extra)
    return rows[y0] * wy0.reshape(-1, 1, *extra) + rows[y1] * wy1.reshape(-1, 1, *extra)


def resize_image(image: np.ndarray, height: int, width: int) -> np.ndarray:
    """uint8 ``[H, W, C]`` -> uint8 ``[height, width, C]``, rounded half up."""
    out = resize_bilinear(image, height, width)
    return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)


# -- geometry -----------------------------------------------------------------

def flip_horizontal(sample: Dict) -> Dict:
    h, w = sample["image"].shape[:2]
    out = dict(sample)
    out["image"] = sample["image"][:, ::-1]
    if len(sample.get("boxes", ())):
        b = sample["boxes"].copy()
        b[:, [0, 2]] = w - b[:, [2, 0]]
        out["boxes"] = b
    if sample.get("masks") is not None:
        out["masks"] = sample["masks"][:, :, ::-1]
    return out


def resize_shortest_edge(sample: Dict, min_size: int, max_size: int) -> Tuple[Dict, float]:
    """Scale so the short side is ``min_size``, capped so the long side is at
    most ``max_size``. Returns ``(sample, scale)``."""
    h, w = sample["image"].shape[:2]
    if min_size <= 0:
        return sample, 1.0
    scale = min_size / min(h, w)
    if max(h, w) * scale > max_size:
        scale = max_size / max(h, w)
    nh, nw = int(round(h * scale)), int(round(w * scale))
    out = dict(sample)
    out["image"] = resize_image(sample["image"], nh, nw)
    if len(sample.get("boxes", ())):
        out["boxes"] = sample["boxes"] * np.array([nw / w, nh / h, nw / w, nh / h], np.float32)
    if sample.get("masks") is not None and len(sample["masks"]):
        out["masks"] = np.stack([resize_bilinear(m, nh, nw) for m in sample["masks"]])
    return out, scale


def make_mini_masks(masks: np.ndarray, boxes: np.ndarray, size: int) -> np.ndarray:
    """Crop each full-image mask to its box and resize to ``[size, size]``.
    Empty input -> ``[0, size, size]``."""
    out = np.zeros((len(boxes), size, size), np.float32)
    for i, (m, b) in enumerate(zip(masks, boxes)):
        x0, y0, x1, y1 = (int(math.floor(b[0])), int(math.floor(b[1])),
                          int(math.ceil(b[2])), int(math.ceil(b[3])))
        x1 = max(x1, x0 + 1)
        y1 = max(y1, y0 + 1)
        x0 = max(x0, 0)
        y0 = max(y0, 0)
        crop = m[y0:y1, x0:x1]
        if crop.size == 0:
            continue
        out[i] = resize_bilinear(crop, size, size)
    return out


# -- pipeline -----------------------------------------------------------------

def run(cfg, sample: Dict, training: bool, rng: Optional[np.random.Generator] = None):
    """Per-sample pipeline: flip (training) -> resize -> mini-masks.

    Returns ``(sample, scale)``; boxes stay absolute xyxy in the resized
    frame. Draws from ``rng`` as the JAX package's ``run`` does with the
    default augmentations, so one seed gives both the same flips and sizes.
    """
    check_supported(cfg, sample)
    rng = rng if rng is not None else np.random.default_rng()
    if training and cfg.AUGMENT.HORIZONTAL_FLIP and rng.uniform() < 0.5:
        sample = flip_horizontal(sample)

    r = cfg.TRANSFORM.RESIZE
    if training:
        min_size = int(rng.choice(list(r.MIN_SIZE_TRAIN)))
        max_size = r.MAX_SIZE_TRAIN
    else:
        min_size, max_size = r.MIN_SIZE_TEST, r.MAX_SIZE_TEST
    sample, scale = resize_shortest_edge(sample, min_size, max_size)

    if sample.get("masks") is not None and r.USE_MINI_MASKS:
        masks = sample["masks"]
        sample = dict(sample)
        if len(masks):
            sample["masks"] = make_mini_masks(masks, sample["boxes"], r.MINI_MASK_SIZE)
        else:
            sample["masks"] = np.zeros((0, r.MINI_MASK_SIZE, r.MINI_MASK_SIZE), np.float32)
    return sample, scale
