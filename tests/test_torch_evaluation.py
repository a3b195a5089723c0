"""The port's COCO evaluator, RLE codec and mask pasting against the JAX
package's, on the same inputs.

The evaluator is the same float64 numpy arithmetic on both sides, so every
metric must agree to 1e-12 (NaN where a range has no GT, on both sides). The
cases of ``tests/test_evaluation.py`` that hold the COCO evaluator are
repeated here, each held against the JAX package's result as well as its
own expectation; ``test_random_detections_match_jax`` draws detections,
crowd GT, annotation areas and masks from a numpy seed.
"""

import math

import numpy as np
import pytest

from detectron2_tensorflow_tpu.evaluation import rle as jrle
from detectron2_tensorflow_tpu.evaluation.coco_eval import CocoEvaluator as JaxCocoEvaluator
from detectron2_tensorflow_tpu.evaluation.coco_eval import box_iou_matrix as jax_box_iou
from detectron2_tensorflow_tpu.evaluation.coco_eval import mask_iou_matrix as jax_mask_iou
from detectron2_tensorflow_tpu.evaluation.np_masks import (
    fullframe_masks_to_image as jax_fullframe,
)
from detectron2_tensorflow_tpu.evaluation.np_masks import paste_masks as jax_paste_masks
from detectron2_tensorflow_tpu_torch.evaluation import (
    CocoEvaluator,
    fullframe_masks_to_image,
    paste_masks,
    rle,
)
from detectron2_tensorflow_tpu_torch.evaluation.coco_eval import box_iou_matrix, mask_iou_matrix

TOL = 1e-12


def _img_gt(boxes, classes, crowd=None):
    boxes = np.asarray(boxes, np.float64).reshape(-1, 4)
    return {"boxes": boxes, "classes": np.asarray(classes),
            "is_crowd": np.asarray(crowd if crowd is not None else [False] * len(boxes))}


def _det(boxes, scores, classes):
    return {"boxes": np.asarray(boxes, np.float64).reshape(-1, 4),
            "scores": np.asarray(scores, np.float64), "classes": np.asarray(classes)}


def assert_metrics_equal(got, want, tol=TOL):
    assert list(got) == list(want)
    for k, v in want.items():
        if math.isnan(v):
            assert math.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= tol, (k, got[k], v)


def both(images, num_classes, iou_type="bbox", **kwargs):
    """The port's and the JAX package's metrics on the same images."""
    ours = CocoEvaluator(num_classes, iou_type, **kwargs)
    theirs = JaxCocoEvaluator(num_classes, iou_type, **kwargs)
    for gt, det in images:
        ours.add_image(gt, det)
        theirs.add_image(gt, det)
    got, want = ours.evaluate(), theirs.evaluate()
    assert_metrics_equal(got, want)
    return got


def test_perfect_detections_give_ap_100():
    images = [(_img_gt([[10, 10, 50, 50], [60, 60, 90, 95]], [0, 2]),
               _det([[10, 10, 50, 50], [60, 60, 90, 95]], [0.9, 0.8], [0, 2]))] * 4
    m = both(images, 3)
    assert abs(m["AP"] - 100.0) < 1e-6 and abs(m["AP50"] - 100.0) < 1e-6
    assert abs(m["AR@100"] - 100.0) < 1e-6


def test_missed_half_gives_half_recall():
    m = both([(_img_gt([[10, 10, 50, 50], [100, 100, 150, 150]], [0, 0]),
               _det([[10, 10, 50, 50]], [0.9], [0]))], 1)
    assert abs(m["AR@100"] - 50.0) < 1e-6 and 45.0 < m["AP"] < 55.0


def test_false_positive_lowers_ap50():
    m = both([(_img_gt([[10, 10, 50, 50]], [0]),
               _det([[200, 200, 240, 240], [10, 10, 50, 50]], [0.95, 0.9], [0, 0]))], 1)
    assert m["AP50"] < 60.0


def test_crowd_gt_is_ignored_not_counted():
    m = both([(_img_gt([[10, 10, 50, 50], [60, 60, 200, 200]], [0, 0], crowd=[False, True]),
               _det([[10, 10, 50, 50], [70, 70, 190, 190]], [0.9, 0.85], [0, 0]))], 1)
    assert abs(m["AP"] - 100.0) < 1e-6


def test_iou_threshold_sweep():
    m = both([(_img_gt([[0, 0, 100, 100]], [0]), _det([[0, 0, 100, 75]], [0.9], [0]))], 1)
    assert abs(m["AP50"] - 100.0) < 1e-6 and abs(m["AP75"] - 100.0) < 1e-6
    assert abs(m["AP"] - 60.0) < 1e-5


def test_segm_evaluator_with_pasted_masks():
    gt_mask = np.zeros((64, 64), bool)
    gt_mask[16:48, 16:48] = True
    box = np.array([[16.0, 16.0, 48.0, 48.0]])
    gt = {"boxes": box, "classes": np.array([0]), "is_crowd": np.array([False]),
          "masks": gt_mask[None]}
    det = {"boxes": box, "scores": np.array([0.9]), "classes": np.array([0]),
           "masks": paste_masks(np.ones((1, 28, 28), np.float32), box, 64, 64)}
    m = both([(gt, det)], 1, "segm")
    assert m["AP"] > 90.0


def test_coco_eval_area_ranges_use_annotation_area():
    gt = {"boxes": np.array([[0.0, 0.0, 100.0, 100.0]]), "classes": np.array([0]),
          "is_crowd": np.array([False]), "areas": np.array([100.0])}
    det = _det([[0.0, 0.0, 100.0, 100.0]], [0.9], [0])
    m = both([(gt, det)], 1)
    assert m["APs"] > 0 and (np.isnan(m["APl"]) or m["APl"] <= 0)


def test_all_metrics_per_category_rows():
    images = [(_img_gt([[10, 10, 50, 50], [60, 60, 90, 95]], [0, 1]),
               _det([[10, 10, 50, 50], [200, 200, 230, 230]], [0.9, 0.8], [0, 1]))] * 3
    m = both(images, 2, class_names=["cat", "dog"], all_per_category=True)
    assert abs(m["AP-cat"] - 100.0) < 1e-6 and abs(m["AP-dog"]) < 1e-6
    assert abs(m["AP50-cat"] - 100.0) < 1e-6 and abs(m["AP75-cat"] - 100.0) < 1e-6
    assert abs(m["AP"] - (m["AP-cat"] + m["AP-dog"]) / 2) < 1e-6
    assert any(k.startswith(("APs-", "APm-")) for k in m)


def test_per_category_off_emits_no_class_rows():
    m = both([(_img_gt([[10, 10, 50, 50]], [0]), _det([[10, 10, 50, 50]], [0.9], [0]))], 2,
             class_names=["cat", "dog"])
    assert not any("-cat" in k or "-dog" in k for k in m)


def test_keypoint_evaluation_waits_for_its_family():
    with pytest.raises(NotImplementedError, match="keypoint"):
        CocoEvaluator(1, "keypoints")


def _random_images(rng, n_images, num_classes, size=96, with_masks=False):
    images = []
    for _ in range(n_images):
        g, d = int(rng.integers(0, 6)), int(rng.integers(0, 40))
        xy = rng.uniform(0, size - 8, (g, 2))
        gt_boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (g, 2))], 1)
        jitter = gt_boxes[rng.integers(0, max(g, 1), d) % max(g, 1)] if g else \
            np.tile([[10.0, 10.0, 40.0, 40.0]], (d, 1))
        det_boxes = jitter + rng.normal(0, 6, (d, 4))
        det_boxes[:, 2:] = np.maximum(det_boxes[:, 2:], det_boxes[:, :2] + 1)
        gt = {"boxes": gt_boxes, "classes": rng.integers(0, num_classes, g),
              "is_crowd": rng.uniform(0, 1, g) < 0.15}
        if rng.uniform() < 0.5:
            gt["areas"] = rng.uniform(50, 5000, g)
        det = {"boxes": det_boxes, "scores": np.round(rng.uniform(0, 1, d), 2),
               "classes": rng.integers(0, num_classes, d)}
        if with_masks:
            gt["masks"] = _box_masks(gt_boxes, rng, size)
            det["masks"] = _box_masks(det_boxes, rng, size)
        images.append((gt, det))
    return images


def _box_masks(boxes, rng, size):
    yy, xx = np.mgrid[:size, :size]
    out = np.zeros((len(boxes), size, size), bool)
    for i, (x0, y0, x1, y1) in enumerate(boxes):
        out[i] = (xx >= x0) & (xx < x1) & (yy >= y0) & (yy < y1) & (rng.uniform(0, 1, (size, size)) < 0.9)
    return out


@pytest.mark.parametrize("iou_type,seed", [("bbox", 0), ("bbox", 1), ("segm", 2)])
def test_random_detections_match_jax(iou_type, seed):
    """Every metric, per category too, on detections drawn from a seed (ties
    in score included), against the JAX package's evaluator to 1e-12."""
    rng = np.random.default_rng(seed)
    images = _random_images(rng, 12 if iou_type == "bbox" else 6, 4, with_masks=iou_type == "segm")
    m = both(images, 4, iou_type, class_names=list("abcd"), all_per_category=True)
    assert 0.0 < m["AP"] < 100.0


def test_iou_matrices_match_jax():
    rng = np.random.default_rng(3)
    (gt, det), = _random_images(rng, 1, 2, with_masks=True)
    crowd = np.array([True, False] * 4)[: len(gt["boxes"])]
    np.testing.assert_array_equal(box_iou_matrix(det["boxes"], gt["boxes"], crowd),
                                  jax_box_iou(det["boxes"], gt["boxes"], crowd))
    np.testing.assert_array_equal(mask_iou_matrix(det["masks"], gt["masks"], crowd),
                                  jax_mask_iou(det["masks"], gt["masks"], crowd))


# -- RLE and pasting ---------------------------------------------------------

@pytest.mark.parametrize("shape,p", [((37, 53), 0.3), ((1, 1), 1.0), ((64, 48), 0.0), ((20, 30), 0.9)])
def test_rle_matches_jax(shape, p):
    rng = np.random.default_rng(shape[0])
    masks = [(rng.uniform(0, 1, shape) < p).astype(np.uint8) for _ in range(3)]
    for m in masks:
        counts = rle.encode_counts(m)
        np.testing.assert_array_equal(counts, jrle.encode_counts(m))
        assert rle.compress(counts) == jrle.compress(counts)
        np.testing.assert_array_equal(rle.decompress(rle.compress(counts)), counts)
        enc = rle.encode(m)
        assert enc == jrle.encode(m)
        np.testing.assert_array_equal(rle.decode(enc), m)
        assert rle.area(enc) == jrle.area(enc) == int(m.sum())
    dt, gt = [rle.encode(m) for m in masks], [rle.encode(m) for m in masks[::-1]]
    crowd = [False, True, False]
    np.testing.assert_array_equal(rle.iou(dt, gt, crowd), jrle.iou(dt, gt, crowd))


def test_rle_reads_uncompressed_counts():
    enc = {"size": [12, 12], "counts": [3, 2, 139]}
    m = rle.decode(enc)
    assert m.sum() == 2 and m[3, 0] == 1 and m[4, 0] == 1
    assert rle.area(enc) == 2


def test_paste_masks_matches_jax():
    rng = np.random.default_rng(0)
    soft = rng.uniform(0, 1, (3, 28, 28)).astype(np.float32)
    boxes = np.array([[5.2, 7.9, 40.7, 50.1], [0.0, 0.0, 64.0, 64.0], [30.0, 30.0, 33.0, 35.0]],
                     np.float32)
    np.testing.assert_array_equal(paste_masks(soft, boxes, 64, 70),
                                  jax_paste_masks(soft, boxes, 64, 70))


def test_fullframe_masks_match_jax():
    """The port upsamples with its numpy bilinear where the JAX package calls
    ``cv2``; the two differ by float32 rounding, so a pixel may differ only
    where the interpolated value lies within 1e-6 of the threshold."""
    import cv2

    rng = np.random.default_rng(1)
    soft = rng.uniform(0, 1, (2, 40, 48)).astype(np.float32)
    got = fullframe_masks_to_image(soft, 150, 180, 111, 133)
    want = jax_fullframe(soft, 150, 180, 111, 133)
    assert got.shape == want.shape == (2, 111, 133)
    values = np.stack([cv2.resize(m[:38, :45], (133, 111), interpolation=cv2.INTER_LINEAR)
                       for m in soft])
    differ = got != want
    assert (np.abs(values[differ] - 0.5) < 1e-6).all()
    assert differ.mean() < 1e-3
