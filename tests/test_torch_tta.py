"""Test-time augmentation (``engine/tta.py``), ``predict_with_boxes`` and the
evaluator's TTA dispatch: the port against the JAX package on the CPU.

* The scale resize: ``data.transforms.resize_bilinear`` on a float32 image
  against ``cv2.resize`` (the JAX TTA's call) within RESIZE_TOL, three
  float32 ulps at pixel values up to 255 (OpenCV's float path rounds its
  coefficients otherwise); the JAX ``_resize_batch``'s whole batch and
  factors the same way; ``flip_content`` and the bucket (a wide image's up
  to ``MAX_SIZE``) exactly.
* The merge: stub models that return the same seeded detections in the
  order both packages call them, so ``tta_predict``'s flip-back, scaling and
  class-aware NMS are compared bit for bit; the evaluator's dispatch the
  same way (``evaluate`` with ``TEST.AUG`` against the JAX ``evaluate``).
* A narrow float32 R50-dconv Mask R-CNN (``test_torch_dconv.py``'s, random
  offsets): ``predict_with_boxes`` at the JAX detections (masks 1e-5) and
  ``tta_predict`` at three small scales with flips (boxes, scores, masks
  1e-4: the port's resize sits within RESIZE_TOL of cv2's).
* The semantic evaluation raises on ``TEST.AUG`` in the port; the JAX one
  fails too (``tta_predict``'s merged detections have no ``sem_seg``).
"""

import importlib

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.engine import tta as jtta
from detectron2_tensorflow_tpu.engine.evaluator import evaluate as jax_evaluate
from detectron2_tensorflow_tpu.engine.evaluator import evaluate_sem_seg as jax_evaluate_sem_seg
from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
from detectron2_tensorflow_tpu_torch.data import build_dataloader
from detectron2_tensorflow_tpu_torch.data.transforms import resize_bilinear
from detectron2_tensorflow_tpu_torch.engine import evaluate, evaluate_panoptic, evaluate_sem_seg
from detectron2_tensorflow_tpu_torch.engine import evaluator as tevaluator
from detectron2_tensorflow_tpu_torch.engine.tta import (
    flip_content,
    resize_to_scale,
    tta_bucket,
    tta_predict,
)
from detectron2_tensorflow_tpu_torch.structures import Instances
import test_torch_c4 as c4
from test_torch_dconv import DCONV_YAML, FPN, real_offsets
from test_torch_loop import _metrics_equal, dataset, loop_cfgs
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

tnms = importlib.import_module("detectron2_tensorflow_tpu_torch.ops.nms")
RESIZE_TOL = 3 * 2.0 ** -16  # three float32 ulps at 128-255
SMALL_AUG = {"TEST.AUG.ENABLED": True, "TEST.AUG.MIN_SIZES": (96, 128, 160),
             "TEST.AUG.MAX_SIZE": 400, "TEST.AUG.FLIP": True}


# -- the scale resize, the flip, the bucket -------------------------------------------------

@pytest.mark.parametrize("h,w,nh,nw", [(800, 1067, 1200, 1600), (800, 1333, 400, 667),
                                       (97, 143, 500, 737), (100, 400, 1000, 4000),
                                       (64, 64, 32, 32)])
def test_float_resize_matches_cv2(h, w, nh, nw):
    """The float32 image resized as ``cv2.resize`` resizes it: no uint8
    rounding, within RESIZE_TOL of cv2's float path."""
    img = np.floor(np.random.default_rng(h + w).uniform(0, 256, (h, w, 3))).astype(np.float32)
    got = resize_bilinear(img, nh, nw)
    want = cv2.resize(img, (nw, nh))
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=RESIZE_TOL * 256)
    assert (got != np.round(got)).any()


@pytest.mark.parametrize("size,min_size", [((120, 150), 96), ((120, 150), 160),
                                           ((100, 400), 1200)])
def test_resize_to_scale_matches_jax(size, min_size):
    """The scale's padded batch, its size and its float32 factors as the JAX
    ``_resize_batch``'s (cv2 there), the image within RESIZE_TOL."""
    rng = np.random.default_rng(1)
    image = np.zeros((1, 128, 416, 3), np.float32)
    h, w = size
    image[0, :h, :w] = np.floor(rng.uniform(0, 256, (h, w, 3)))
    batch = {"image": image, "image_size": np.array([[h, w]], np.int32)}
    bucket = (1024, 4096)
    want, (jsx, jsy) = jtta._resize_batch(batch, min_size, 4000, bucket)
    got, (sx, sy) = resize_to_scale(image[0], batch["image_size"][0], min_size, 4000, bucket)
    np.testing.assert_array_equal(got["image_size"], np.asarray(want["image_size"]))
    assert (sx, sy) == (jsx, jsy) and got["image"].shape == want["image"].shape
    np.testing.assert_allclose(got["image"], np.asarray(want["image"]), rtol=0,
                               atol=RESIZE_TOL * 256)


def test_flip_content_matches_jax():
    """Only the content columns flip; the padding stays zero."""
    img = np.random.default_rng(2).uniform(0, 255, (1, 64, 96, 3)).astype(np.float32)
    img[0, 50:] = 0
    img[0, :, 70:] = 0
    scaled = {"image": img, "image_size": np.array([[50, 70]], np.int32)}
    got = flip_content(scaled)
    want = jtta.flip_content(scaled)
    np.testing.assert_array_equal(got["image"], np.asarray(want["image"]))
    np.testing.assert_array_equal(got["image"][0, :50, :70], img[0, :50, :70][:, ::-1])
    assert not got["image"][0, :, 70:].any()


def recorded_buckets(cfg_pair, size):
    """The buckets the JAX ``tta_predict`` hands ``_resize_batch`` for an image
    of ``size`` (a stub model), and the port's."""
    jcfg, tcfg = cfg_pair
    seen = []
    real = jtta._resize_batch

    def spy(batch, min_size, max_size, bucket):
        seen.append(tuple(bucket))
        return real(batch, min_size, max_size, bucket)

    h, w = size
    det = stub_detections(np.random.default_rng(0), 1, 4, 1)[0]
    stub = JaxStub([det] * 40)
    batch = {"image": np.zeros((1, h, w, 3), np.float32),
             "image_size": np.array([[h, w]], np.int32)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtta, "_resize_batch", spy)
        mp.setattr(jtta.jax, "jit", lambda f: f)
        jtta.tta_predict(jcfg, stub, None, batch)
    return set(seen), tta_bucket(tcfg, h, w)


@pytest.mark.parametrize("size,bucket", [((800, 1333), (1280, 2048)), ((100, 400), (1024, 4096)),
                                         ((480, 640), (1280, 1664))])
def test_bucket_matches_jax(size, bucket):
    """One bucket per image: the default ``TEST.AUG`` (9 scales up to 1200,
    ``MAX_SIZE`` 4000) gives a COCO-sized image the 1280 x 2048 plane and
    a 1:4 image a width capped at ``MAX_SIZE`` (rounded up to 4096)."""
    cfgs = loop_cfgs("TEST.AUG.ENABLED", "True")
    jax_buckets, got = recorded_buckets(cfgs, size)
    assert jax_buckets == {got} and got == bucket


# -- the merge, bit for bit, through stub models ------------------------------------------

def stub_detections(rng, calls, slots, classes, size=(120, 150)):
    """``calls`` seeded detection sets ``(boxes [1, D, 4], scores, classes,
    valid)`` as float32 / int32 / bool numpy arrays, a few slots invalid
    (class -1, box 0), boxes clustered so that the merge suppresses."""
    h, w = size
    out = []
    centers = rng.uniform(20, 100, (4, 2))
    for _ in range(calls):
        c = centers[rng.integers(0, 4, slots)] + rng.normal(0, 3, (slots, 2))
        half = rng.uniform(8, 20, (slots, 2))
        boxes = np.concatenate([c - half, c + half], 1).clip(0, [w, h, w, h])
        valid = rng.uniform(size=slots) < 0.8
        cls = np.where(valid, rng.integers(0, classes, slots), -1)
        scores = np.where(valid, rng.uniform(0.05, 1, slots), 0.0)
        boxes = np.where(valid[:, None], boxes, 0.0)
        out.append((boxes[None].astype(np.float32), scores[None].astype(np.float32),
                    cls[None].astype(np.int32), valid[None]))
    return out


class JaxStub:
    """A JAX-side model whose ``predict`` returns the next detection set."""

    def __init__(self, dets):
        self.dets = list(dets)

    def predict(self, variables, batch):
        b, s, c, v = self.dets.pop(0)
        return JaxInstances(boxes=jnp.asarray(b), scores=jnp.asarray(s),
                            pred_classes=jnp.asarray(c), is_valid=jnp.asarray(v))


class PortStub(torch.nn.Module):
    """The port-side stub: the same sets in the same order."""

    def __init__(self, dets):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))
        self.dets = list(dets)
        self.calls = []

    def predict(self, batch):
        self.calls.append(tuple(int(v) for v in batch["image_size"][0]))
        b, s, c, v = self.dets.pop(0)
        return Instances(boxes=torch.from_numpy(b), scores=torch.from_numpy(s),
                         pred_classes=torch.from_numpy(c).long(), is_valid=torch.from_numpy(v))


def run_both(jcfg, tcfg, dets, batch):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtta.jax, "jit", lambda f: f)
        want = jtta.tta_predict(jcfg, JaxStub(dets), None, batch)
    stub = PortStub(dets)
    got = tta_predict(tcfg, stub, batch)
    return got, want, stub


@pytest.mark.parametrize("flip", [True, False])
def test_merge_matches_jax_bit_for_bit(flip):
    """Slots of every scale and flip mapped back (flipped in the scaled frame,
    scaled by the float32 factors) and merged by one class-aware NMS at
    ``NMS_THRESH_TEST`` into ``DETECTIONS_PER_IMAGE`` slots: boxes, scores,
    classes and valid bit-equal to the JAX merge; one ``nms_keep`` call."""
    jcfg, tcfg = loop_cfgs("MODEL.MASK_ON", "False", "TEST.AUG.ENABLED", "True",
                           "TEST.AUG.MIN_SIZES", "(96, 128, 160, 200)",
                           "TEST.AUG.FLIP", str(flip), "TEST.DETECTIONS_PER_IMAGE", "20")
    calls = 4 * (2 if flip else 1)
    dets = stub_detections(np.random.default_rng(3), calls, 30, 3)
    image = np.zeros((1, 128, 160, 3), np.float32)
    image[0, :120, :150] = np.random.default_rng(4).uniform(0, 255, (120, 150, 3))
    batch = {"image": image, "image_size": np.array([[120, 150]], np.int32)}
    keeps = []
    real = tnms.greedy_keep
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tnms, "greedy_keep", lambda *a, **k: keeps.append(a[0].shape) or real(*a, **k))
        got, want, stub = run_both(jcfg, tcfg, dets, batch)
    assert keeps == [(1, calls * 30, 4)]
    assert len(stub.calls) == calls and stub.calls[0] == (96, 120)
    for k in ("boxes", "scores", "pred_classes", "is_valid"):
        np.testing.assert_array_equal(got.get_fields()[k].numpy(), np.asarray(getattr(want, k)),
                                      err_msg=k)
    assert got.boxes.shape == (1, 20, 4) and int(got.is_valid.sum()) == 20
    assert sum(int(v.sum()) for _, _, _, v in dets) > 20  # the merge kept 20 of them


def test_evaluate_dispatches_to_tta_like_jax():
    """``evaluate`` with ``TEST.AUG`` predicts each image through
    ``tta_predict`` (a padded slot of the last batch too, as the JAX loop
    does) and un-resizes the merged detections as ``predict``'s: the same
    bbox metrics as the JAX ``evaluate`` on the same stub detections."""
    jcfg, tcfg = loop_cfgs("MODEL.MASK_ON", "False", "TEST.AUG.ENABLED", "True",
                           "TEST.AUG.MIN_SIZES", "(96, 128)", "SOLVER.IMS_PER_BATCH", "2",
                           "MODEL.ROI_HEADS.NUM_CLASSES", "1", "EVAL.METRICS",
                           "('coco_detection_metrics',)")
    ds = dataset(n=3, first_id=10, box_range=(30, 60), num_classes=1)
    batches = list(build_dataloader(tcfg, ds, training=False))
    assert len(batches) == 2
    dets = stub_detections(np.random.default_rng(5), 4 * 4, 20, 1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtta.jax, "jit", lambda f: f)
        want = jax_evaluate(jcfg, JaxStub(dets), None, ds, iter(batches))
    stub = PortStub(dets)
    got = evaluate(tcfg, stub, ds, iter(batches))
    assert len(stub.calls) == 16 and not stub.dets
    _metrics_equal(got, want, 0.0)
    assert set(got) == set(want) and "bbox/AP" in got


def test_semantic_and_panoptic_tta_raise():
    """The port's semantic and panoptic loops refuse ``TEST.AUG``; the JAX
    semantic loop fails on it too: the merged detections have no
    ``sem_seg``."""
    jcfg, tcfg = loop_cfgs("TEST.AUG.ENABLED", "True", "TEST.AUG.MIN_SIZES", "(96,)",
                           "TEST.AUG.FLIP", "False")
    with pytest.raises(NotImplementedError, match="TEST.AUG.*semantic"):
        evaluate_sem_seg(tcfg, None, None, iter([]))
    with pytest.raises(NotImplementedError, match="TEST.AUG.*panoptic"):
        evaluate_panoptic(tcfg, None, None, iter([]))
    ds = dataset(n=1)
    batch = next(iter(build_dataloader(tcfg, ds, training=False)))
    dets = stub_detections(np.random.default_rng(6), batch["image"].shape[0], 10, 5)
    with pytest.MonkeyPatch.context() as mp, pytest.raises(AttributeError, match="sem_seg"):
        mp.setattr(jtta.jax, "jit", lambda f: f)
        jax_evaluate_sem_seg(jcfg, JaxStub(dets), None, ds, iter([batch]))


def test_tta_of_loaded_proposals_raises():
    """A Fast R-CNN has no proposals at the scales (the JAX TTA hands it
    none): the port says so."""
    _, tcfg = loop_cfgs("MODEL.LOAD_PROPOSALS", "True", "TEST.AUG.ENABLED", "True")
    with pytest.raises(NotImplementedError, match="LOAD_PROPOSALS"):
        tta_predict(tcfg, PortStub([]), {"image": np.zeros((1, 8, 8, 3), np.float32),
                                         "image_size": np.array([[8, 8]], np.int32)})


# -- a real model ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dconv_pair():
    """The narrow R50-dconv Mask R-CNN of both packages (random offsets) on
    one 120 x 150 image in a 128 x 160 batch, with SMALL_AUG."""
    with real_offsets():
        pair = c4.predict_pair(*c4.yaml_cfgs(DCONV_YAML, **FPN, **SMALL_AUG))
    batch = {k: np.array(v)[:1] for k, v in pair["batch"].items()}
    batch["image_size"] = np.array([[120, 150]], np.int32)
    batch["image"][0, 120:] = 0
    batch["image"][0, :, 150:] = 0
    pair["one"] = batch
    return pair


def test_predict_with_boxes_matches_jax(dconv_pair):
    """Masks recomputed at given detections (the JAX predict's, on the
    two-image batch): the same probabilities to 1e-5, no box stage run."""
    p = dconv_pair
    jout = p["jout"]
    given = Instances(boxes=torch.from_numpy(np.array(jout.boxes)),
                      scores=torch.from_numpy(np.array(jout.scores)),
                      pred_classes=torch.from_numpy(np.array(jout.pred_classes)).long(),
                      is_valid=torch.from_numpy(np.array(jout.is_valid)))
    want = jax.jit(p["jmodel"].predict_with_boxes)(p["variables"], p["batch"], jout)
    got = p["tmodel"].predict_with_boxes(p["tbatch"], given)
    np.testing.assert_array_equal(got.boxes.numpy(), np.asarray(jout.boxes))
    np.testing.assert_allclose(got.pred_masks.numpy(), np.asarray(want.pred_masks), rtol=1e-4,
                               atol=1e-5)


def test_tta_predict_matches_jax(dconv_pair):
    """``tta_predict`` of the real model at three scales and their flips:
    the merged slots (valid, classes equal; boxes, scores and the masks
    recomputed at them to 1e-4) as the JAX ``tta_predict``'s."""
    p = dconv_pair
    want = jtta.tta_predict(p["jcfg"], p["jmodel"], p["variables"],
                            {k: jnp.asarray(v) for k, v in p["one"].items()})
    got = tta_predict(p["tcfg"], p["tmodel"], p["one"])
    valid = got.is_valid.numpy()
    np.testing.assert_array_equal(valid, np.asarray(want.is_valid))
    assert valid.sum() == p["tcfg"].TEST.DETECTIONS_PER_IMAGE
    np.testing.assert_array_equal(got.pred_classes.numpy(), np.asarray(want.pred_classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(got.pred_masks.numpy(), np.asarray(want.pred_masks), rtol=1e-4,
                               atol=1e-4)
    assert got.pred_masks.shape == (1, 100, 28, 28)


def test_tta_evaluation_builds_one_predict_per_image(dconv_pair, monkeypatch):
    """``build_tta_predict`` calls ``tta_predict`` once per image of the batch
    and stacks the numpy outputs in the batch's order."""
    calls = []
    real = tevaluator.tta_predict

    def spy(cfg, model, batch):
        calls.append(int(np.asarray(batch["image_size"])[0, 1]))
        return real(cfg, model, batch)

    monkeypatch.setattr(tevaluator, "tta_predict", spy)
    p = dconv_pair
    batch = {k: np.asarray(v) for k, v in p["tbatch"].items()}
    out = tevaluator.build_tta_predict(p["tcfg"], p["tmodel"])(batch)
    assert calls == [160, 150]
    assert out["boxes"].shape == (2, 100, 4) and out["pred_masks"].shape == (2, 100, 28, 28)
    one = tta_predict(p["tcfg"], p["tmodel"], {k: v[1:] for k, v in batch.items()})
    np.testing.assert_array_equal(out["boxes"][1], one.boxes[0].numpy())
