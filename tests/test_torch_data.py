"""The port's data pipeline against the JAX package's: the synthetic
dataset, the transforms and ``build_dataloader``, on the same seeds.

The JAX pipeline resizes with ``cv2``; the port resizes in numpy with the
same sampling rule. ``cv2`` filters uint8 images in fixed point, so images
agree to IMAGE_ATOL = 1 level. Float32 masks agree to MASK_ATOL = 5e-7:
``cv2`` rounds its float bilinear (here through Intel IPP) differently from
the port's two float32 passes, by one float32 step (1.2e-7 measured) in each
of the two resizes a mini-mask goes through. Everything else (sizes,
buckets, flips, boxes, classes, validity, ids) must be equal.
"""

import numpy as np
import pytest

from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.data import build_dataloader as jax_build_dataloader
from detectron2_tensorflow_tpu.data import transforms as jtransforms
from detectron2_tensorflow_tpu_torch.config import finalize, get_cfg
from detectron2_tensorflow_tpu_torch.data import (
    SyntheticDataset,
    build_dataloader,
    pick_bucket,
    transforms,
)
from test_data import SyntheticDataset as JaxSyntheticDataset

IMAGE_ATOL = 1
MASK_ATOL = 5e-7
SMALL = {
    "TRANSFORM.RESIZE.MIN_SIZE_TRAIN": (64, 80),
    "TRANSFORM.RESIZE.MAX_SIZE_TRAIN": 128,
    "TRANSFORM.RESIZE.MIN_SIZE_TEST": 64,
    "TRANSFORM.RESIZE.MAX_SIZE_TEST": 128,
    "TRANSFORM.RESIZE.MINI_MASK_SIZE": 28,
    "INPUT.PAD_BUCKETS": ((96, 128), (128, 96)),
    "INPUT.MAX_GT_INSTANCES": 8,
    "SOLVER.IMS_PER_BATCH": 2,
    "AUGMENT.HORIZONTAL_FLIP": True,
}


def small_cfgs(**overrides):
    """(JAX cfg, port cfg) with the small sizes above."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for key, value in {**SMALL, **overrides}.items():
        for cfg in (jcfg, tcfg):
            *parents, leaf = key.split(".")
            node = cfg
            for p in parents:
                node = node[p]
            node[leaf] = value
    return jcfg, tcfg


@pytest.mark.parametrize("kwargs", [{}, {"n": 3, "h": 480, "w": 640, "num_classes": 4,
                                         "box_range": (40, 200), "seed": 5}])
def test_synthetic_dataset_matches_jax(kwargs):
    ours, theirs = SyntheticDataset(**kwargs), JaxSyntheticDataset(**kwargs)
    assert len(ours) == len(theirs)
    assert [info for info, _ in ours.images] == [info for info, _ in theirs.images]
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b)
        for k in a:
            assert np.array_equal(a[k], b[k]) and np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k
        assert ours.image_id(i) == i


def test_synthetic_dataset_takes_many_classes():
    """The JAX recipe's grey level overflows uint8 above four classes; the
    port's wraps it."""
    ds = SyntheticDataset(n=4, num_classes=80)
    assert max(int(ds[i]["classes"].max()) for i in range(4)) >= 4


def test_synthetic_first_id_gives_other_images():
    val = SyntheticDataset(n=2, first_id=5)
    assert [val.image_id(i) for i in range(2)] == [5, 6]
    assert np.array_equal(val[0]["image"], SyntheticDataset(n=6)[5]["image"])


@pytest.mark.parametrize("hw", [(97, 153, 64, 101), (480, 640, 800, 1067), (30, 17, 56, 56)])
def test_resize_matches_cv2(hw):
    import cv2

    h, w, nh, nw = hw
    rng = np.random.default_rng(h)
    image = rng.integers(0, 255, (h, w, 3), np.uint8)
    want = cv2.resize(image, (nw, nh), interpolation=cv2.INTER_LINEAR)
    got = transforms.resize_image(image, nh, nw)
    assert got.dtype == np.uint8 and got.shape == want.shape
    assert np.abs(got.astype(int) - want).max() <= IMAGE_ATOL
    mask = (rng.uniform(0, 1, (h, w)) > 0.5).astype(np.float32)
    want = cv2.resize(mask, (nw, nh), interpolation=cv2.INTER_LINEAR)
    np.testing.assert_allclose(transforms.resize_bilinear(mask, nh, nw), want, rtol=0,
                               atol=MASK_ATOL)


def test_flip_roundtrip():
    s = SyntheticDataset(n=1)[0]
    f2 = transforms.flip_horizontal(transforms.flip_horizontal(s))
    np.testing.assert_array_equal(f2["image"], s["image"])
    np.testing.assert_array_equal(f2["boxes"], s["boxes"])
    f = transforms.flip_horizontal(s)
    jf = jtransforms.flip_horizontal(s)
    for k in ("image", "boxes", "masks"):
        np.testing.assert_array_equal(f[k], jf[k])


def test_resize_shortest_edge_caps_max():
    s = {"image": np.zeros((100, 300, 3), np.uint8), "boxes": np.zeros((0, 4), np.float32)}
    out, scale = transforms.resize_shortest_edge(s, 80, 200)
    want, want_scale = jtransforms.resize_shortest_edge(s, 80, 200)
    assert out["image"].shape == want["image"].shape and scale == want_scale
    h, w = out["image"].shape[:2]
    assert max(h, w) <= 200 and abs(w - 200) <= 1


def test_mini_masks_roundtrip_quality():
    s = SyntheticDataset(n=1)[0]
    mm = transforms.make_mini_masks(s["masks"], s["boxes"], 28)
    assert mm.shape == (len(s["boxes"]), 28, 28)
    assert mm.mean() > 0.8  # box-aligned rectangles fill their mini-masks
    np.testing.assert_allclose(mm, jtransforms.make_mini_masks(s["masks"], s["boxes"], 28),
                               rtol=0, atol=MASK_ATOL)


def test_pick_bucket():
    buckets = ((64, 128), (128, 64), (128, 128))
    assert pick_bucket(60, 100, buckets) == (64, 128)
    assert pick_bucket(100, 60, buckets) == (128, 64)
    assert pick_bucket(100, 100, buckets) == (128, 128)
    assert pick_bucket(500, 500, buckets) == (128, 128)  # fallback largest


def test_dataloader_shapes_and_masks():
    _, cfg = small_cfgs()
    batch = next(build_dataloader(cfg, SyntheticDataset(), training=True, seed=0))
    assert batch["image"].shape[0] == 2
    assert batch["image"].shape[1:] in ((96, 128, 3), (128, 96, 3))
    assert batch["gt_boxes"].shape == (2, 8, 4)
    assert batch["gt_masks"].shape == (2, 8, 28, 28)
    assert batch["gt_valid"].any()
    for i in range(2):
        v = batch["gt_valid"][i]
        h, w = batch["image_size"][i]
        assert batch["gt_boxes"][i][v][:, 2].max() <= w + 1e-3
        assert batch["gt_boxes"][i][v][:, 3].max() <= h + 1e-3


def assert_batches_match(got, want):
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        if k == "image":
            assert np.abs(got[k] - v).max() <= IMAGE_ATOL
        elif k == "gt_masks":
            np.testing.assert_allclose(got[k], v, rtol=0, atol=MASK_ATOL)
        else:
            np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("readers", [1, 3])
def test_dataloader_matches_jax(readers):
    """Six training batches at seed 0: the same images, flips, scales,
    buckets and GT, with one reader and with several."""
    jcfg, tcfg = small_cfgs(**{"DATALOADER.NUM_READERS": readers})
    ds = JaxSyntheticDataset(n=8)
    ours = build_dataloader(tcfg, SyntheticDataset(n=8), training=True, seed=0)
    theirs = jax_build_dataloader(jcfg, ds, training=True, seed=0)
    sizes = set()
    for _ in range(6):
        got, want = next(ours), next(theirs)
        assert_batches_match(got, want)
        sizes.update(min(int(x) for x in hw) for hw in got["image_size"])
    assert sizes == {64, 80}  # both training scales were drawn
    ours.close()


def test_dataloader_eval_covers_all_images_once():
    jcfg, tcfg = small_cfgs(**{"SOLVER.IMS_PER_BATCH": 3})
    ds = SyntheticDataset(n=8)
    got = list(build_dataloader(tcfg, ds, training=False, seed=0))
    want = list(jax_build_dataloader(jcfg, JaxSyntheticDataset(n=8), training=False, seed=0))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_batches_match(g, w)
    ids = np.concatenate([b["image_id"] for b in got])
    assert sorted(ids[ids >= 0].tolist()) == list(range(len(ds)))
    assert (ids == -1).sum() == 3 * len(got) - len(ds)


def test_dataloader_sample_1_of_n():
    _, cfg = small_cfgs(**{"DATALOADER.SAMPLE_1_OF_N": 3})
    ids = np.concatenate([b["image_id"] for b in
                          build_dataloader(cfg, SyntheticDataset(n=8), training=False)])
    assert sorted(ids[ids >= 0].tolist()) == [0, 3, 6]


def test_pad_buckets_must_match_size_divisibility():
    cfg = get_cfg()
    cfg.INPUT.PAD_BUCKETS = ((800, 1340),)  # 1340 % 32 != 0
    with pytest.raises(ValueError, match="SIZE_DIVISIBILITY"):
        finalize(cfg, training=False, device="cpu")


@pytest.mark.parametrize("key", ["CROP.ENABLED", "VERTICAL_FLIP", "ROTATE",
                                 "PIXEL_VALUE_SCALE.ENABLED", "ADJUST_BRIGHTNESS.ENABLED",
                                 "ADJUST_CONSTRACT.ENABLED", "ADJUST_HUE.ENABLED",
                                 "ADJUST_SATURATION.ENABLED", "DISTORT_COLOR.ENABLED",
                                 "JITTER_BOX.ENABLED"])
def test_unported_augmentations_raise(key):
    """Each ``AUGMENT.*`` augmentation on its own (``tests/test_torch_augment.py``
    holds them together): four training batches equal the JAX loader's."""
    jcfg, tcfg = small_cfgs(**{f"AUGMENT.{key}": True, "AUGMENT.CROP.MIN_OBJECT_COVERED": 0.5})
    ours = build_dataloader(tcfg, SyntheticDataset(n=6), training=True, seed=2)
    theirs = jax_build_dataloader(jcfg, JaxSyntheticDataset(n=6), training=True, seed=2)
    for _ in range(4):
        assert_batches_match(next(ours), next(theirs))
    ours.close()


def test_reader_errors_reach_the_consumer():
    _, cfg = small_cfgs()

    class Broken(SyntheticDataset):
        def __getitem__(self, i):
            raise OSError("unreadable sample")

    with pytest.raises(OSError, match="unreadable"):
        next(build_dataloader(cfg, Broken(n=2), training=True))
