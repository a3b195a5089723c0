"""The port's training augmentations against the JAX package's
``data/transforms.py``, on the same samples and seeds.

Each augmentation alone, and ``run`` with all of them on, must give the
JAX function's sample bit for bit: image, boxes, classes, crowd flags,
areas, full-frame masks, keypoints, proposals and ``sem_seg``, and the
generator must be left where the JAX function leaves it (the same draws).
The 8-bit HSV conversions behind hue and saturation are held against
``cv2.cvtColor``, which the JAX package calls, on every input they can take:
all 2^24 RGB triples and all 180 x 256 x 256 HSV triples. Past the resize,
``tests/test_torch_data.py``'s tolerances hold (``cv2`` resizes uint8 images
in fixed point: one level; float32 mini-masks 5e-7), and without a resize
the loader's batches are bit-equal.
"""

import cv2
import numpy as np
import pytest

from detectron2_tensorflow_tpu.data import build_dataloader as jax_build_dataloader
from detectron2_tensorflow_tpu.data import transforms as jtransforms
from detectron2_tensorflow_tpu_torch.data import SyntheticDataset, build_dataloader, transforms
from test_data import SyntheticDataset as JaxSyntheticDataset
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)
from test_torch_data import MASK_ATOL, assert_batches_match, small_cfgs

SEEDS = range(6)
# Every AUGMENT.* switch on (the crop at the reference's settings but for a
# looser coverage, so that crops are found on small boxes).
EVERY_AUGMENTATION = {
    "AUGMENT.CROP.ENABLED": True,
    "AUGMENT.CROP.MIN_OBJECT_COVERED": 0.5,
    "AUGMENT.HORIZONTAL_FLIP": True,
    "AUGMENT.VERTICAL_FLIP": True,
    "AUGMENT.ROTATE": True,
    "AUGMENT.ROTATE_BOTH_DIRECTION": True,
    "AUGMENT.PIXEL_VALUE_SCALE.ENABLED": True,
    "AUGMENT.ADJUST_BRIGHTNESS.ENABLED": True,
    "AUGMENT.ADJUST_CONSTRACT.ENABLED": True,
    "AUGMENT.ADJUST_HUE.ENABLED": True,
    "AUGMENT.ADJUST_SATURATION.ENABLED": True,
    "AUGMENT.DISTORT_COLOR.ENABLED": True,
    "AUGMENT.JITTER_BOX.ENABLED": True,
}
NO_RESIZE = {"TRANSFORM.RESIZE.MIN_SIZE_TRAIN": (0,),
             "INPUT.PAD_BUCKETS": ((160, 160),)}


def full_sample(i=0, h=97, w=153):
    """A synthetic sample with every field a transform carries: boxes,
    classes, crowd flags, areas, full-frame masks, keypoints (one of them
    unlabelled), proposals and a semantic map."""
    s = dict(SyntheticDataset(n=i + 1, h=h, w=w, with_keypoints=True, with_sem_seg=True)[i])
    rng = np.random.default_rng(100 + i)
    n = len(s["boxes"])
    s["is_crowd"] = rng.uniform(size=n) < 0.3
    s["areas"] = rng.uniform(10, 500, n).astype(np.float32)
    kp = s["keypoints"].copy()
    kp[0, 1] = (5.0, 7.0, 0.0)
    s["keypoints"] = kp
    xy = rng.uniform(0, [w, h], (7, 2))
    s["proposals"] = np.concatenate([xy, xy + rng.uniform(4, 40, (7, 2))], 1).astype(np.float32)
    s["proposal_scores"] = rng.uniform(size=7).astype(np.float32)
    return s


def assert_samples_equal(got, want):
    assert set(got) == set(want)
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            g = np.asarray(got[k])
            assert g.shape == v.shape and g.dtype == v.dtype, (k, g.shape, v.shape, g.dtype)
            np.testing.assert_array_equal(g, v, err_msg=k)
        else:
            assert got[k] == v, k


def generators(seed):
    return np.random.default_rng(seed), np.random.default_rng(seed)


def assert_same_draws(ours, theirs):
    """Both generators were advanced alike."""
    assert ours.bit_generator.state == theirs.bit_generator.state


# -- 8-bit HSV against cv2, on every input -------------------------------------

def test_rgb_to_hsv_matches_cv2_on_every_rgb_triple():
    codes = np.arange(1 << 24, dtype=np.uint32)
    rgb = np.stack([codes >> 16, (codes >> 8) & 255, codes & 255], -1).astype(np.uint8)
    rgb = rgb.reshape(4096, 4096, 3)
    for rows in range(0, 4096, 512):
        block = rgb[rows:rows + 512]
        np.testing.assert_array_equal(transforms.rgb_to_hsv(block),
                                      cv2.cvtColor(block, cv2.COLOR_RGB2HSV))


@pytest.mark.parametrize("width", [8 * transforms.HSV_BLOCK, transforms.HSV_BLOCK // 2])
def test_hsv_to_rgb_matches_cv2_on_every_hsv_triple(width):
    """In rows of ``width`` pixels: whole blocks of ``HSV_BLOCK`` (cv2's
    vectorised path) and rows shorter than one (its pixel-by-pixel path)."""
    h, s, v = np.meshgrid(np.arange(180), np.arange(256), np.arange(256), indexing="ij")
    hsv = np.stack([h, s, v], -1).astype(np.uint8).reshape(-1, width, 3)
    step = (1 << 20) // width
    for rows in range(0, len(hsv), step):
        block = hsv[rows:rows + step]
        np.testing.assert_array_equal(transforms.hsv_to_rgb(block),
                                      cv2.cvtColor(block, cv2.COLOR_HSV2RGB))


# -- each augmentation alone ---------------------------------------------------

@pytest.mark.parametrize("name,args", [
    ("flip_vertical", ()), ("rotate90", (1,)), ("rotate90", (2,)), ("rotate90", (3,)),
    ("rotate90", (4,)),
])
def test_geometry_matches_jax(name, args):
    for i in range(3):
        s = full_sample(i)
        got = getattr(transforms, name)(s, *args)
        want = getattr(jtransforms, name)(s, *args)
        assert_samples_equal(got, want)
        if name == "rotate90" and args[0] % 2:
            assert got["image"].shape[:2] == s["image"].shape[1::-1]


@pytest.mark.parametrize("name,kwargs", [
    ("pixel_value_scale", {}), ("pixel_value_scale", {"min_value": 0.5, "max_value": 1.8}),
    ("adjust_brightness", {}), ("adjust_brightness", {"max_delta": 0.6}),
    ("adjust_contrast", {}), ("adjust_contrast", {"min_delta": 0.3, "max_delta": 2.5}),
    ("adjust_hue", {}), ("adjust_hue", {"max_delta": 0.5}),
    ("adjust_saturation", {}), ("adjust_saturation", {"min_delta": 0.2, "max_delta": 3.0}),
    ("distort_color", {"color_ordering": 0}), ("distort_color", {"color_ordering": 1}),
    ("jitter_boxes", {}), ("jitter_boxes", {"ratio": 0.4}),
])
def test_photometric_and_jitter_match_jax(name, kwargs):
    changed = set()
    for seed in SEEDS:
        s = full_sample(seed % 3)
        ours, theirs = generators(seed)
        got = getattr(transforms, name)(s, ours, **kwargs)
        want = getattr(jtransforms, name)(s, theirs, **kwargs)
        assert_samples_equal(got, want)
        assert_same_draws(ours, theirs)
        changed |= {k for k in ("image", "boxes") if not np.array_equal(got[k], s[k])}
    assert changed == ({"boxes"} if name == "jitter_boxes" else {"image"})


@pytest.mark.parametrize("kwargs", [
    {},  # the reference's: the crop must hold one box whole
    {"min_object_covered": 0.1, "area_range": (0.05, 0.5), "overlap_thresh": 0.5},
    {"min_object_covered": 0.0, "aspect_ratio_range": (0.5, 2.0)},
    {"random_coef": 0.5},
    {"min_object_covered": 1.0, "area_range": (0.01, 0.02), "max_attempts": 3},  # none fits
])
def test_random_crop_matches_jax(kwargs):
    for seed in SEEDS:
        s = full_sample(seed % 3)
        ours, theirs = generators(seed)
        got = transforms.random_crop(s, ours, **kwargs)
        want = jtransforms.random_crop(s, theirs, **kwargs)
        assert_samples_equal(got, want)
        assert_same_draws(ours, theirs)


def test_random_crop_without_boxes_matches_jax():
    s = full_sample(1)
    for k in ("boxes", "classes", "is_crowd", "areas", "keypoints"):
        s[k] = s[k][:0]
    s["masks"] = s["masks"][:0]
    ours, theirs = generators(3)
    got = transforms.random_crop(s, ours, min_object_covered=0.0)
    assert_samples_equal(got, jtransforms.random_crop(s, theirs, min_object_covered=0.0))
    assert got["image"].shape != s["image"].shape


def test_apply_crop_crops_full_frame_masks_and_hides_keypoints_outside():
    """The crop cuts each kept instance's full-frame mask to the window and
    zeroes the visibility of the keypoints it leaves out, as the JAX
    ``_apply_crop`` does."""
    s = full_sample(2)
    box = s["boxes"][0]
    cx, cy = int(box[0]) + 2, int(box[1]) + 2  # cuts the first box's top-left corner off
    h, w = s["image"].shape[:2]
    cw, ch = min(60, w - cx), min(50, h - cy)
    got = transforms._apply_crop(s, cx, cy, cw, ch, 0.3)
    assert_samples_equal(got, jtransforms._apply_crop(s, cx, cy, cw, ch, 0.3))
    assert got["masks"].shape[1:] == (ch, cw) == got["image"].shape[:2]
    kp = s["keypoints"][0]
    inside = (kp[:, 0] >= cx) & (kp[:, 0] < cx + cw) & (kp[:, 1] >= cy) & (kp[:, 1] < cy + ch)
    np.testing.assert_array_equal(got["keypoints"][0, :, 2], np.where(inside, kp[:, 2], 0))
    assert not inside[0] and kp[0, 2] > 0  # its (x0, y0) corner left the crop
    np.testing.assert_array_equal(got["masks"][0], s["masks"][0][cy:cy + ch, cx:cx + cw])


# -- the pipeline ----------------------------------------------------------------

@pytest.mark.parametrize("overrides", [
    {},
    {"AUGMENT.ROTATE_BOTH_DIRECTION": False, "AUGMENT.DISTORT_COLOR.COLOR_ORDERING": 1},
    {"AUGMENT.CROP.MIN_OBJECT_COVERED": 0.1, "AUGMENT.CROP.RANDOM_COEF": 0.3},
])
def test_run_with_every_augmentation_matches_jax(overrides):
    """``run`` before the resize (``MIN_SIZE_TRAIN`` 0, full-frame masks):
    every field bit-equal, over several seeds."""
    jcfg, tcfg = small_cfgs(**{**EVERY_AUGMENTATION, **NO_RESIZE, **overrides,
                               "TRANSFORM.RESIZE.USE_MINI_MASKS": False})
    shapes = set()
    for seed in range(12):
        s = full_sample(seed % 3)
        ours, theirs = generators(seed)
        got, got_scale = transforms.run(tcfg, s, True, ours)
        want, want_scale = jtransforms.run(jcfg, s, True, theirs)
        assert got_scale == want_scale
        assert_samples_equal(got, want)
        assert_same_draws(ours, theirs)
        shapes.add(got["image"].shape[0] > got["image"].shape[1])
    assert shapes == {True, False}  # some samples were rotated


def test_run_with_every_augmentation_and_resize_matches_jax():
    """With the resize and mini-masks after the augmentations: the image to
    one level, the mini-masks to MASK_ATOL, every other field bit-equal."""
    jcfg, tcfg = small_cfgs(**EVERY_AUGMENTATION)
    for seed in SEEDS:
        s = full_sample(seed % 3)
        ours, theirs = generators(seed)
        got, got_scale = transforms.run(tcfg, s, True, ours)
        want, want_scale = jtransforms.run(jcfg, s, True, theirs)
        assert got_scale == want_scale
        assert np.abs(got["image"].astype(int) - want["image"]).max() <= 1
        np.testing.assert_allclose(got["masks"], want["masks"], rtol=0, atol=MASK_ATOL)
        assert_samples_equal({k: v for k, v in got.items() if k not in ("image", "masks")},
                             {k: v for k, v in want.items() if k not in ("image", "masks")})


ROTATE_ONLY = {"AUGMENT.ROTATE": True, "AUGMENT.ROTATE_BOTH_DIRECTION": True}


@pytest.mark.parametrize("overrides", [
    pytest.param({**EVERY_AUGMENTATION, "DATALOADER.NUM_READERS": 1}, id="every-1-reader"),
    pytest.param({**EVERY_AUGMENTATION, "DATALOADER.NUM_READERS": 3}, id="every-3-readers"),
    pytest.param(ROTATE_ONLY, id="rotate"),
])
def test_loader_with_augmentations_matches_jax(overrides):
    """Training batches at the small training scales: the same buckets,
    padding and GT as the JAX loader's (rotated samples take the portrait
    bucket)."""
    jcfg, tcfg = small_cfgs(**overrides)
    ours = build_dataloader(tcfg, SyntheticDataset(n=8, with_keypoints=True), training=True,
                            seed=0)
    theirs = jax_build_dataloader(jcfg, JaxSyntheticDataset(n=8, with_keypoints=True),
                                  training=True, seed=0)
    buckets = set()
    for _ in range(6):
        got, want = next(ours), next(theirs)
        assert_batches_match(got, want)
        buckets.add(got["image"].shape[1:3])
    ours.close()
    if overrides is ROTATE_ONLY:
        assert buckets == {(96, 128), (128, 96)}


def test_loader_with_every_augmentation_is_bit_equal_without_resize():
    jcfg, tcfg = small_cfgs(**EVERY_AUGMENTATION, **NO_RESIZE)
    ours = build_dataloader(tcfg, SyntheticDataset(n=6, with_masks=False), training=True, seed=1)
    theirs = jax_build_dataloader(jcfg, JaxSyntheticDataset(n=6, with_masks=False),
                                  training=True, seed=1)
    for _ in range(4):
        got, want = next(ours), next(theirs)
        assert list(got) == list(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    ours.close()
