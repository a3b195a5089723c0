"""Host-side sample transforms: flip -> shortest-edge resize -> mini-masks.

Port of the default COCO pipeline of the JAX package's ``data/transforms.py``
(``flip_horizontal``, ``resize_shortest_edge``, ``make_mini_masks``,
``run``) in numpy, without ``cv2``. The resize is bilinear with half-pixel
centres, clamped at the borders, as ``cv2.INTER_LINEAR`` samples: each
output coordinate maps to ``(d + 0.5) * in / out - 0.5``, the two source
taps get float32 weights, and the rows are filtered before the columns. For
float32 masks this agrees with ``cv2`` to float32 rounding; ``cv2`` filters
uint8 images in fixed point, so images agree to one level.
A float32 image (the TTA's scales, ``engine/tta.py``) goes through
:func:`resize_bilinear` unrounded, as the JAX TTA hands ``cv2.resize`` a
float32 array: ``cv2``'s float path, which it matches to three float32
ulps (4.6e-5 at pixel values up to 255, ``tests/test_torch_tta.py``).

Every augmentation the default config leaves off (crop, vertical flip,
rotation, the colour changes, box jitter) raises ``NotImplementedError``
naming its ``AUGMENT.*`` key. Precomputed proposals (``proposals [P, 4]``
xyxy, with ``proposal_scores [P]``, ``MODEL.LOAD_PROPOSALS``) and keypoints
(``keypoints [N, K, 3]``: x, y, visibility) are flipped and scaled with the
boxes, as the JAX ``flip_horizontal`` and ``resize_shortest_edge`` do: a
flip mirrors the labelled keypoints' x and, for COCO's 17 person
keypoints, swaps left and right (``COCO_KP_FLIP``). A semantic label map
(``sem_seg``) is flipped with the image and resized by
:func:`resize_nearest`, ``cv2.INTER_NEAREST``'s rule.

Samples are dicts: image uint8 [H, W, 3] RGB, boxes float32 [N, 4] xyxy
absolute, classes int [N], is_crowd bool [N], masks float [N, H, W]
(optional), keypoints float32 [N, K, 3] (optional), sem_seg int [H, W]
(optional).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np

# COCO person-keypoint left/right swap under a horizontal flip.
COCO_KP_FLIP = [0, 2, 1, 4, 3, 6, 5, 8, 7, 10, 9, 12, 11, 14, 13, 16, 15]
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


def check_supported(cfg) -> None:
    """Raise ``NotImplementedError`` for an augmentation the port does not have yet."""
    for key, enabled in _OFF_AUGMENTATIONS:
        if enabled(cfg.AUGMENT):
            raise NotImplementedError(f"AUGMENT.{key} is not ported")


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


def resize_nearest(arr: np.ndarray, height: int, width: int) -> np.ndarray:
    """``arr [H, W]`` -> ``[height, width]`` by ``cv2.INTER_NEAREST``'s rule:
    output ``d`` takes source ``min(floor(d * (1 / (out / in))), in - 1)``,
    the scale inverted in float64 as OpenCV inverts it."""
    h, w = arr.shape[:2]
    iy = np.floor(np.arange(height, dtype=np.float64) * (1.0 / (height / h))).astype(np.int64)
    ix = np.floor(np.arange(width, dtype=np.float64) * (1.0 / (width / w))).astype(np.int64)
    return arr[np.minimum(iy, h - 1)][:, np.minimum(ix, w - 1)]


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
    if sample.get("proposals") is not None and len(sample["proposals"]):
        pr = sample["proposals"].copy()
        pr[:, [0, 2]] = w - pr[:, [2, 0]]
        out["proposals"] = pr
    if sample.get("keypoints") is not None and len(sample["keypoints"]):
        kp = sample["keypoints"].copy()
        kp[..., 0] = np.where(kp[..., 2] > 0, w - kp[..., 0], kp[..., 0])
        if kp.shape[1] == len(COCO_KP_FLIP):
            kp = kp[:, COCO_KP_FLIP]
        out["keypoints"] = kp
    if sample.get("masks") is not None:
        out["masks"] = sample["masks"][:, :, ::-1]
    if sample.get("sem_seg") is not None:
        out["sem_seg"] = sample["sem_seg"][:, ::-1]
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
    if sample.get("proposals") is not None and len(sample["proposals"]):
        out["proposals"] = sample["proposals"] * np.array([nw / w, nh / h, nw / w, nh / h],
                                                          np.float32)
    if sample.get("keypoints") is not None and len(sample["keypoints"]):
        kp = sample["keypoints"].copy()
        kp[..., 0] *= nw / w
        kp[..., 1] *= nh / h
        out["keypoints"] = kp
    if sample.get("masks") is not None and len(sample["masks"]):
        out["masks"] = np.stack([resize_bilinear(m, nh, nw) for m in sample["masks"]])
    if sample.get("sem_seg") is not None:
        out["sem_seg"] = resize_nearest(np.asarray(sample["sem_seg"], np.int32), nh, nw)
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
    check_supported(cfg)
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
