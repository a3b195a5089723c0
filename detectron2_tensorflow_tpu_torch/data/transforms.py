"""Host-side sample transforms: augment -> shortest-edge resize -> mini-masks.

Port of the JAX package's ``data/transforms.py`` in numpy, without ``cv2``.
The resize is bilinear with half-pixel
centres, clamped at the borders, as ``cv2.INTER_LINEAR`` samples: each
output coordinate maps to ``(d + 0.5) * in / out - 0.5``, the two source
taps get float32 weights, and the rows are filtered before the columns. For
float32 masks this agrees with ``cv2`` to float32 rounding; ``cv2`` filters
uint8 images in fixed point, so images agree to one level.
A float32 image (the TTA's scales, ``engine/tta.py``) goes through
:func:`resize_bilinear` unrounded, as the JAX TTA hands ``cv2.resize`` a
float32 array: ``cv2``'s float path, which it matches to three float32
ulps (4.6e-5 at pixel values up to 255, ``tests/test_torch_tta.py``).

The training augmentations of the ``AUGMENT`` config (the reference's:
min-object-covered crop, horizontal and vertical flips, 90-degree
rotations, pixel scale, brightness, contrast, hue, saturation, the
``distort_color`` chain and box jitter) run before the resize, in the JAX
``run``'s order, each drawing from the sample's generator as the JAX
function draws: one seed gives both packages the same sample, bit for bit.
Hue and saturation go through 8-bit HSV as ``cv2.cvtColor`` computes it
(:func:`rgb_to_hsv`, :func:`hsv_to_rgb`). Precomputed proposals
(``proposals [P, 4]`` xyxy, with ``proposal_scores [P]``,
``MODEL.LOAD_PROPOSALS``), keypoints (``keypoints [N, K, 3]``: x, y,
visibility), full-frame masks and a semantic label map (``sem_seg``) follow
the geometry: a horizontal flip mirrors the labelled keypoints' x and, for
COCO's 17 person keypoints, swaps left and right (``COCO_KP_FLIP``); a crop
drops the instances it leaves less than ``OVERLAP_THRESH`` of, crops their
full-frame masks (before mini-masks are made) and zeroes the visibility of
keypoints outside it. A ``sem_seg`` is resized by :func:`resize_nearest`,
``cv2.INTER_NEAREST``'s rule.

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


def flip_vertical(sample: Dict) -> Dict:
    h, w = sample["image"].shape[:2]
    out = dict(sample)
    out["image"] = sample["image"][::-1]
    if len(sample.get("boxes", ())):
        b = sample["boxes"].copy()
        b[:, [1, 3]] = h - b[:, [3, 1]]
        out["boxes"] = b
    if sample.get("proposals") is not None and len(sample["proposals"]):
        pr = sample["proposals"].copy()
        pr[:, [1, 3]] = h - pr[:, [3, 1]]
        out["proposals"] = pr
    if sample.get("keypoints") is not None and len(sample["keypoints"]):
        # No top/bottom keypoint swap: COCO's skeleton pairs left and right only.
        kp = sample["keypoints"].copy()
        kp[..., 1] = np.where(kp[..., 2] > 0, h - kp[..., 1], kp[..., 1])
        out["keypoints"] = kp
    if sample.get("masks") is not None:
        out["masks"] = sample["masks"][:, ::-1]
    if sample.get("sem_seg") is not None:
        out["sem_seg"] = sample["sem_seg"][::-1]
    return out


def rotate90(sample: Dict, k: int = 1) -> Dict:
    """Rotate counter-clockwise by ``k`` x 90 degrees (``np.rot90``'s
    convention); an unlabelled keypoint keeps its coordinates."""
    k = k % 4
    if k == 0:
        return sample
    h, w = sample["image"].shape[:2]
    out = dict(sample)
    out["image"] = np.ascontiguousarray(np.rot90(sample["image"], k))
    if sample.get("masks") is not None:
        out["masks"] = np.ascontiguousarray(np.rot90(sample["masks"], k, axes=(1, 2)))
    if sample.get("sem_seg") is not None:
        out["sem_seg"] = np.ascontiguousarray(np.rot90(sample["sem_seg"], k))
    for key in ("boxes", "proposals"):
        if not len(sample.get(key, ())):
            continue
        b = sample[key]
        rh, rw = h, w
        for _ in range(k):
            # 90 degrees counter-clockwise: (x, y) -> (y, w - x) in the (w, h) image.
            x0, y0, x1, y1 = b[:, 0], b[:, 1], b[:, 2], b[:, 3]
            b = np.stack([y0, rw - x1, y1, rw - x0], axis=1)
            rh, rw = rw, rh
        out[key] = b.astype(np.float32)
    if sample.get("keypoints") is not None and len(sample["keypoints"]):
        kp = sample["keypoints"].copy()
        rh, rw = h, w
        for _ in range(k):
            x = kp[..., 0].copy()
            kp[..., 0] = kp[..., 1]
            kp[..., 1] = rw - x
            rh, rw = rw, rh
        invis = sample["keypoints"][..., 2] <= 0
        kp[..., 0] = np.where(invis, sample["keypoints"][..., 0], kp[..., 0])
        kp[..., 1] = np.where(invis, sample["keypoints"][..., 1], kp[..., 1])
        out["keypoints"] = kp
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


# -- 8-bit HSV, as cv2.cvtColor computes it -------------------------------------

_HSV_SHIFT = 12
# cv2's fixed-point tables: round((255 << 12) / v) and round((180 << 12) / (6 d)).
_SDIV = np.concatenate([[0], np.rint((255 << _HSV_SHIFT) / np.arange(1, 256.0))]).astype(np.int64)
_HDIV = np.concatenate([[0], np.rint((180 << _HSV_SHIFT) / (6.0 * np.arange(1, 256.0)))]
                       ).astype(np.int64)
# The pixels of a row that cv2's vectorised HSV -> RGB converts at a time.
HSV_BLOCK = 32
# For each hue sector, the (r, g, b) entries of (v, p, q, t) in hsv_to_rgb.
_SECTOR_RGB = np.array([[0, 3, 1], [2, 0, 1], [1, 0, 3], [1, 2, 0], [3, 1, 0], [0, 1, 2]])


def rgb_to_hsv(image: np.ndarray) -> np.ndarray:
    """uint8 RGB ``[..., 3]`` -> uint8 HSV as ``cv2.COLOR_RGB2HSV``: hue in
    [0, 180), in cv2's fixed point (12 fraction bits, rounded)."""
    rgb = image.astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v, diff = rgb.max(-1), rgb.max(-1) - rgb.min(-1)
    s = (diff * _SDIV[v] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + (1 << (_HSV_SHIFT - 1))) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], -1).astype(np.uint8)


def hsv_to_rgb(image: np.ndarray) -> np.ndarray:
    """uint8 HSV ``[..., W, 3]`` (hue in [0, 180)) -> uint8 RGB as
    ``cv2.COLOR_HSV2RGB`` computes it: float32 math on s, v / 255, with
    ``1 - s * f`` and ``1 - s * (1 - f)`` each one fused multiply-add,
    rounded once (the float32 product is exact in float64; the difference is
    rounded to float32 once), then times 255. cv2's vectorised build
    converts each row ``HSV_BLOCK`` pixels at a time and truncates there; the
    rest of the row goes pixel by pixel and rounds to nearest even."""
    f32, one = np.float32, np.float32(1.0)
    h = image[..., 0].astype(f32) * f32(6.0 / 180)
    s = image[..., 1].astype(f32) * f32(1.0 / 255)
    v = image[..., 2].astype(f32) * f32(1.0 / 255)
    sector = np.floor(h)
    f = h - sector

    def one_minus(x, y):
        return (1.0 - x.astype(np.float64) * y.astype(np.float64)).astype(f32)

    tab = np.stack([v, v * (one - s), v * one_minus(s, f), v * one_minus(s, one - f)], -1)
    rgb = np.take_along_axis(tab, _SECTOR_RGB[sector.astype(np.int64) % 6], -1) * f32(255)
    width = image.shape[-2]
    blocked = (np.arange(width) < width // HSV_BLOCK * HSV_BLOCK)[:, None]
    return np.clip(np.where(blocked, np.trunc(rgb), np.rint(rgb)), 0, 255).astype(np.uint8)


# -- photometric ----------------------------------------------------------------

def pixel_value_scale(sample, rng, min_value=0.9, max_value=1.1):
    out = dict(sample)
    out["image"] = np.clip(
        sample["image"].astype(np.float32) * rng.uniform(min_value, max_value), 0, 255
    ).astype(np.uint8)
    return out


def adjust_brightness(sample, rng, max_delta=0.2):
    delta = rng.uniform(-max_delta, max_delta) * 255.0
    out = dict(sample)
    out["image"] = np.clip(sample["image"].astype(np.float32) + delta, 0, 255).astype(np.uint8)
    return out


def adjust_contrast(sample, rng, min_delta=0.8, max_delta=1.25):
    f = rng.uniform(min_delta, max_delta)
    img = sample["image"].astype(np.float32)
    mean = img.mean(axis=(0, 1), keepdims=True)
    out = dict(sample)
    out["image"] = np.clip((img - mean) * f + mean, 0, 255).astype(np.uint8)
    return out


def adjust_hue(sample, rng, max_delta=0.02):
    delta = rng.uniform(-max_delta, max_delta) * 180.0  # 8-bit hue is [0, 180)
    hsv = rgb_to_hsv(sample["image"]).astype(np.float32)
    hsv[..., 0] = (hsv[..., 0] + delta) % 180.0
    out = dict(sample)
    out["image"] = hsv_to_rgb(hsv.astype(np.uint8))
    return out


def adjust_saturation(sample, rng, min_delta=0.8, max_delta=1.25):
    f = rng.uniform(min_delta, max_delta)
    hsv = rgb_to_hsv(sample["image"]).astype(np.float32)
    hsv[..., 1] = np.clip(hsv[..., 1] * f, 0, 255)
    out = dict(sample)
    out["image"] = hsv_to_rgb(hsv.astype(np.uint8))
    return out


def distort_color(sample, rng, color_ordering=0):
    """Brightness, saturation, hue and contrast in one of the reference's two
    orders."""
    if color_ordering % 2 == 0:
        sample = adjust_brightness(sample, rng)
        sample = adjust_saturation(sample, rng)
        sample = adjust_hue(sample, rng)
        sample = adjust_contrast(sample, rng)
    else:
        sample = adjust_brightness(sample, rng)
        sample = adjust_contrast(sample, rng)
        sample = adjust_saturation(sample, rng)
        sample = adjust_hue(sample, rng)
    return sample


# -- box / crop -----------------------------------------------------------------

def jitter_boxes(sample, rng, ratio=0.05):
    if not len(sample.get("boxes", ())):
        return sample
    b = sample["boxes"]
    wh = np.stack([b[:, 2] - b[:, 0], b[:, 3] - b[:, 1]], axis=1)
    noise = rng.uniform(-ratio, ratio, (len(b), 4)) * np.concatenate([wh, wh], axis=1)
    out = dict(sample)
    h, w = sample["image"].shape[:2]
    out["boxes"] = np.clip(b + noise.astype(np.float32), 0, [w, h, w, h]).astype(np.float32)
    return out


def random_crop(sample, rng, min_object_covered=1.0, aspect_ratio_range=(0.75, 1.33),
                area_range=(0.1, 1.0), overlap_thresh=0.3, random_coef=0.0, max_attempts=100):
    """A crop of random aspect ratio and area that covers at least
    ``min_object_covered`` of some box, tried up to ``max_attempts`` times
    (the sample is kept whole if none fits, or with probability
    ``random_coef``); :func:`_apply_crop` drops the instances it leaves less
    than ``overlap_thresh`` of."""
    if rng.uniform() < random_coef:
        return sample
    h, w = sample["image"].shape[:2]
    boxes = sample.get("boxes")
    for _ in range(max_attempts):
        ar = math.exp(rng.uniform(math.log(aspect_ratio_range[0]),
                                  math.log(aspect_ratio_range[1])))
        area = rng.uniform(area_range[0], area_range[1]) * h * w
        cw = int(round(math.sqrt(area * ar)))
        ch = int(round(math.sqrt(area / ar)))
        if cw > w or ch > h or cw < 1 or ch < 1:
            continue
        cx = rng.integers(0, w - cw + 1)
        cy = rng.integers(0, h - ch + 1)
        if boxes is not None and len(boxes) and min_object_covered > 0:
            ix0 = np.maximum(boxes[:, 0], cx)
            iy0 = np.maximum(boxes[:, 1], cy)
            ix1 = np.minimum(boxes[:, 2], cx + cw)
            iy1 = np.minimum(boxes[:, 3], cy + ch)
            inter = np.clip(ix1 - ix0, 0, None) * np.clip(iy1 - iy0, 0, None)
            areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            cover = inter / np.maximum(areas, 1e-6)
            if cover.max(initial=0.0) < min_object_covered:
                continue
        return _apply_crop(sample, cx, cy, cw, ch, overlap_thresh)
    return sample


def _apply_crop(sample, cx, cy, cw, ch, overlap_thresh):
    out = dict(sample)
    out["image"] = sample["image"][cy:cy + ch, cx:cx + cw]
    if sample.get("sem_seg") is not None:
        out["sem_seg"] = sample["sem_seg"][cy:cy + ch, cx:cx + cw]
    boxes = sample.get("boxes")
    if boxes is None or not len(boxes):
        return out
    shifted = boxes - np.array([cx, cy, cx, cy], np.float32)
    clipped = np.clip(shifted, 0, [cw, ch, cw, ch]).astype(np.float32)
    areas = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
    vis = (clipped[:, 2] - clipped[:, 0]) * (clipped[:, 3] - clipped[:, 1])
    keep = vis / np.maximum(areas, 1e-6) >= overlap_thresh
    out["boxes"] = clipped[keep]
    out["classes"] = sample["classes"][keep]
    out["is_crowd"] = sample["is_crowd"][keep]
    if sample.get("areas") is not None and len(sample["areas"]) == len(boxes):
        out["areas"] = sample["areas"][keep]
    if sample.get("masks") is not None and len(sample["masks"]):
        out["masks"] = sample["masks"][keep][:, cy:cy + ch, cx:cx + cw]
    if sample.get("proposals") is not None and len(sample["proposals"]):
        pr = sample["proposals"] - np.array([cx, cy, cx, cy], np.float32)
        out["proposals"] = np.clip(pr, 0, [cw, ch, cw, ch]).astype(np.float32)
    if sample.get("keypoints") is not None and len(sample["keypoints"]) == len(boxes):
        kp = sample["keypoints"].copy()
        kp[..., 0] -= cx
        kp[..., 1] -= cy
        inside = (kp[..., 0] >= 0) & (kp[..., 0] < cw) & (kp[..., 1] >= 0) & (kp[..., 1] < ch)
        kp[..., 2] = np.where(inside, kp[..., 2], 0.0)
        out["keypoints"] = kp[keep]
    return out


# -- mini masks -----------------------------------------------------------------

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
    """Per-sample pipeline: augment (training) -> resize -> mini-masks.

    Returns ``(sample, scale)``; boxes stay absolute xyxy in the resized
    frame. Draws from ``rng`` as the JAX package's ``run`` does, so one seed
    gives both the same augmentations and sizes.
    """
    rng = rng if rng is not None else np.random.default_rng()
    a = cfg.AUGMENT
    if training:
        if a.CROP.ENABLED:
            sample = random_crop(sample, rng, a.CROP.MIN_OBJECT_COVERED,
                                 tuple(a.CROP.ASPECT_RATIO_RANGE), tuple(a.CROP.AREA_RANGE),
                                 a.CROP.OVERLAP_THRESH, a.CROP.RANDOM_COEF)
        if a.HORIZONTAL_FLIP and rng.uniform() < 0.5:
            sample = flip_horizontal(sample)
        if a.VERTICAL_FLIP and rng.uniform() < 0.5:
            sample = flip_vertical(sample)
        if a.ROTATE and rng.uniform() < 0.5:
            k = rng.choice([1, 3]) if a.ROTATE_BOTH_DIRECTION else 1
            sample = rotate90(sample, int(k))
        if a.PIXEL_VALUE_SCALE.ENABLED:
            sample = pixel_value_scale(sample, rng, a.PIXEL_VALUE_SCALE.MIN_VALUE,
                                       a.PIXEL_VALUE_SCALE.MAX_VALUE)
        if a.ADJUST_BRIGHTNESS.ENABLED:
            sample = adjust_brightness(sample, rng, a.ADJUST_BRIGHTNESS.MAX_DELTA)
        if a.ADJUST_CONSTRACT.ENABLED:
            sample = adjust_contrast(sample, rng, a.ADJUST_CONSTRACT.MIN_DELTA,
                                     a.ADJUST_CONSTRACT.MAX_DELTA)
        if a.ADJUST_HUE.ENABLED:
            sample = adjust_hue(sample, rng, a.ADJUST_HUE.MAX_DELTA)
        if a.ADJUST_SATURATION.ENABLED:
            sample = adjust_saturation(sample, rng, a.ADJUST_SATURATION.MIN_DELTA,
                                       a.ADJUST_SATURATION.MAX_DELTA)
        if a.DISTORT_COLOR.ENABLED:
            sample = distort_color(sample, rng, a.DISTORT_COLOR.COLOR_ORDERING)
        if a.JITTER_BOX.ENABLED:
            sample = jitter_boxes(sample, rng, a.JITTER_BOX.RATIO)

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
