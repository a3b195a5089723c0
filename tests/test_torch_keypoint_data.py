"""The keypoint family's data and evaluation against the JAX package: the
flip (``COCO_KP_FLIP``) and resize of keypoints, the loader's
``gt_keypoints``, the training dataset of a keypoint model (the COCO JSON
with ``MIN_KEYPOINTS_PER_IMAGE``), ``oks_matrix``, ``CocoEvaluator("keypoints")``
and the evaluation loop's keypoint feed, the synthetic keypoint set and
``tools.overfit_check --arch keypoint``.

Keypoints are float32 numpy on both sides: flips, scales and the loader's
padded slots must be equal. The evaluators are the same float64 numpy
arithmetic, so every metric must agree to 1e-12 (NaN where a range has no
GT, on both sides).
"""

import json
import math
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import train as jax_train
from detectron2_tensorflow_tpu.data import CocoDataset as JaxCocoDataset
from detectron2_tensorflow_tpu.data import build_dataloader as jax_build_dataloader
from detectron2_tensorflow_tpu.data import transforms as jtransforms
from detectron2_tensorflow_tpu.engine import evaluator as jevaluator
from detectron2_tensorflow_tpu.evaluation.coco_eval import CocoEvaluator as JaxCocoEvaluator
from detectron2_tensorflow_tpu.evaluation.coco_eval import oks_matrix as jax_oks_matrix
from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
from detectron2_tensorflow_tpu_torch.data import CocoDataset, SyntheticDataset, build_dataloader
from detectron2_tensorflow_tpu_torch.data import transforms
from detectron2_tensorflow_tpu_torch.engine import evaluator as tevaluator
from detectron2_tensorflow_tpu_torch.evaluation import CocoEvaluator
from detectron2_tensorflow_tpu_torch.evaluation.coco_eval import COCO_KP_SIGMAS, oks_matrix
from detectron2_tensorflow_tpu_torch.evaluation.coco_results import CocoResultsWriter
from detectron2_tensorflow_tpu_torch.structures import Instances
from detectron2_tensorflow_tpu_torch.tools import train as tools_train
from test_data import SyntheticDataset as JaxSyntheticDataset
from test_torch_c4 import OVERFIT_NARROW, check_overfit_cfg, run_overfit_check
from test_torch_coco import _fmt_cfgs, _format_root, _kind
from test_torch_data import assert_batches_match, small_cfgs
from test_torch_evaluation import TOL, assert_metrics_equal
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)


def _with_keypoints(sample, k, seed):
    """``sample`` with ``k`` keypoints per box drawn from ``seed``: inside
    the image, visibility 0, 1 or 2 (x of an unlabelled one left as drawn)."""
    rng = np.random.default_rng(seed)
    h, w = sample["image"].shape[:2]
    n = len(sample["boxes"])
    kp = np.zeros((n, k, 3), np.float32)
    kp[..., 0] = rng.uniform(0, w, (n, k))
    kp[..., 1] = rng.uniform(0, h, (n, k))
    kp[..., 2] = rng.integers(0, 3, (n, k))
    return {**sample, "keypoints": kp}


# -- transforms and the loader ------------------------------------------------------------

@pytest.mark.parametrize("k", [17, 4])
def test_flip_moves_keypoints_as_jax(k):
    """A horizontal flip mirrors the labelled keypoints' x (w - x), keeps the
    unlabelled ones' and, for COCO's 17, swaps left and right
    (``COCO_KP_FLIP``, the JAX table); twice is the identity (up to
    float32 rounding of w - (w - x))."""
    s = _with_keypoints(SyntheticDataset(n=1)[0], k, seed=k)
    got, want = transforms.flip_horizontal(s), jtransforms.flip_horizontal(s)
    np.testing.assert_array_equal(got["keypoints"], want["keypoints"])
    assert got["keypoints"].dtype == np.float32
    assert transforms.COCO_KP_FLIP == jtransforms.COCO_KP_FLIP
    np.testing.assert_allclose(transforms.flip_horizontal(got)["keypoints"], s["keypoints"],
                               rtol=1e-6, atol=1e-5)
    labelled = s["keypoints"][..., 2] > 0
    order = transforms.COCO_KP_FLIP if k == 17 else list(range(k))
    flipped = got["keypoints"][:, np.argsort(order)]
    np.testing.assert_array_equal(flipped[..., 0][labelled], 153 - s["keypoints"][..., 0][labelled])
    np.testing.assert_array_equal(flipped[..., 0][~labelled], s["keypoints"][..., 0][~labelled])


def test_resize_scales_keypoints_as_jax():
    """``resize_shortest_edge`` scales x by the new width over the old and y
    by the heights', labelled or not, bit-equal to the JAX transform."""
    s = _with_keypoints(SyntheticDataset(n=1, h=97, w=153)[0], 17, seed=1)
    got, gs = transforms.resize_shortest_edge(s, 64, 128)
    want, ws = jtransforms.resize_shortest_edge(s, 64, 128)
    assert gs == ws
    np.testing.assert_array_equal(got["keypoints"], want["keypoints"])
    assert got["image"].shape[:2] == (64, 101)
    np.testing.assert_array_equal(got["keypoints"][..., 2], s["keypoints"][..., 2])


class _Keypointed:
    """A dataset whose samples gain ``_with_keypoints`` (17 a box)."""

    def __init__(self, ds):
        self.ds = ds
        self.images = ds.images

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        return _with_keypoints(self.ds[i], 17, seed=100 + i)


@pytest.mark.parametrize("readers", [1, 3])
def test_dataloader_keypoints_match_jax(readers):
    """Six training batches at seed 0 (flips and both scales drawn):
    ``gt_keypoints [B, G, 17, 3]``, zero in the padded GT slots, equal to the
    JAX loader's, with every other field."""
    jcfg, tcfg = small_cfgs(**{"DATALOADER.NUM_READERS": readers,
                               "DATALOADER.NATIVE_TRAIN_IO": False})
    ours = build_dataloader(tcfg, _Keypointed(SyntheticDataset(n=8)), training=True, seed=0)
    theirs = jax_build_dataloader(jcfg, _Keypointed(JaxSyntheticDataset(n=8)), training=True,
                                  seed=0)
    for _ in range(6):
        got, want = next(ours), next(theirs)
        assert_batches_match(got, want)
        kp = got["gt_keypoints"]
        assert kp.shape == (2, 8, 17, 3) and not kp[~got["gt_valid"]].any()
    ours.close()


def test_synthetic_keypoints_are_the_jax_recipe():
    """``SyntheticDataset(with_keypoints=True)``: the box corners, all
    labelled visible, sample for sample as the JAX tests' recipe."""
    ours, theirs = SyntheticDataset(with_keypoints=True), JaxSyntheticDataset(with_keypoints=True)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert set(a) == set(b) and "keypoints" in a
        for k in a:
            assert np.array_equal(a[k], b[k]) and np.asarray(a[k]).dtype == np.asarray(b[k]).dtype
        np.testing.assert_array_equal(a["keypoints"][:, 0, :2], a["boxes"][:, :2])
        assert (a["keypoints"][..., 2] == 2).all()


# -- the training dataset of a keypoint model ---------------------------------------------

def _keypoint_root(tmp_path, min_labelled=(0, 2, 5, 9)):
    """``_format_root``'s synthetic COCO (records beside the JSON) with 17
    keypoints added to every training annotation: image i's annotations
    label ``min_labelled[i]`` of theirs in total (v = 2), the rest 0."""
    root = _format_root(tmp_path)
    path = os.path.join(root, "train.json")
    with open(path) as f:
        coco = json.load(f)
    rng = np.random.default_rng(0)
    budget = dict(zip(sorted(img["id"] for img in coco["images"]), min_labelled))
    for a in coco["annotations"]:
        x, y, w, h = a["bbox"]
        kp = np.zeros((17, 3))
        kp[:, 0] = rng.uniform(x, x + w, 17)
        kp[:, 1] = rng.uniform(y, y + h, 17)
        n = min(budget[a["image_id"]], 17)
        kp[:n, 2] = 2
        budget[a["image_id"]] -= n
        a["keypoints"] = [float(v) for v in kp.reshape(-1)]
        a["num_keypoints"] = n
    with open(path, "w") as f:
        json.dump(coco, f)
    return root


@pytest.mark.parametrize("min_kp", [1, 5])
def test_keypoint_models_train_from_the_json(tmp_path, min_kp):
    """A keypoint model trains from the COCO JSON though records exist (they
    carry no keypoints), without the images that label fewer than
    ``MIN_KEYPOINTS_PER_IMAGE`` keypoints: the JAX ``train.py``'s dataset,
    image for image; its evaluation split stays the JAX ``eval.py``'s
    choice (the records)."""
    root = _keypoint_root(tmp_path)
    kw = {"MODEL.KEYPOINT_ON": True, "MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE": min_kp}
    jcfg, tcfg = _fmt_cfgs(root, "auto", **kw)
    ours, theirs = tools_train.build_train_dataset(tcfg), jax_train.build_train_dataset(jcfg)
    assert isinstance(ours, CocoDataset) and isinstance(theirs, JaxCocoDataset)
    assert len(ours) == len(theirs) == (3 if min_kp == 1 else 2)
    for i in range(len(ours)):
        a, b = ours[i], theirs[i]
        assert a["image_id"] == b["image_id"]
        np.testing.assert_array_equal(a["keypoints"], b["keypoints"])
        assert a["keypoints"].shape[1:] == (17, 3)
    from detectron2_tensorflow_tpu_torch.tools import eval as tools_eval
    import eval as jax_eval
    assert _kind(tools_eval.build_eval_dataset(tcfg)) == _kind(jax_eval.build_eval_dataset(jcfg))


def test_keypoint_training_refuses_records(tmp_path):
    """``DATASETS.TRAIN_FORMAT records`` cannot feed a keypoint model: the
    port says so before reading (the JAX ``train.py`` reads the records and
    fails at the first loss)."""
    root = _format_root(tmp_path)
    _, tcfg = _fmt_cfgs(root, "records", **{"MODEL.KEYPOINT_ON": True})
    with pytest.raises(ValueError, match="TFRecords carry no keypoints"):
        tools_train.build_train_dataset(tcfg)


# -- OKS and the evaluator ---------------------------------------------------------------

def _kp_images(rng, n_images, num_classes, k=17, size=96):
    """Images of GT boxes with ``k`` keypoints (some unlabelled, some
    annotation areas) and detections near them with jittered keypoints,
    scores with ties."""
    images = []
    for _ in range(n_images):
        g, d = int(rng.integers(0, 5)), int(rng.integers(0, 12))
        xy = rng.uniform(0, size - 8, (g, 2))
        gt_boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (g, 2))], 1)
        gkp = np.zeros((g, k, 3))
        gkp[..., :2] = gt_boxes[:, None, :2] + rng.uniform(0, 1, (g, k, 2)) * (
            gt_boxes[:, None, 2:] - gt_boxes[:, None, :2])
        gkp[..., 2] = rng.integers(0, 3, (g, k))
        pick = rng.integers(0, max(g, 1), d) % max(g, 1)
        dkp = np.zeros((d, k, 3))
        if g:
            dkp[..., :2] = gkp[pick, :, :2] + rng.normal(0, rng.uniform(0.5, 6, (d, 1, 1)),
                                                          (d, k, 2))
            det_boxes = gt_boxes[pick] + rng.normal(0, 3, (d, 4))
        else:
            dkp[..., :2] = rng.uniform(0, size, (d, k, 2))
            det_boxes = np.tile([[10.0, 10.0, 40.0, 40.0]], (d, 1))
        dkp[..., 2] = rng.uniform(0, 1, (d, k))
        gt = {"boxes": gt_boxes, "classes": rng.integers(0, num_classes, g),
              "is_crowd": rng.uniform(0, 1, g) < 0.1, "keypoints": gkp}
        if rng.uniform() < 0.5:
            gt["areas"] = rng.uniform(50, 3000, g)
        det = {"boxes": det_boxes, "scores": np.round(rng.uniform(0, 1, d), 2),
               "classes": np.where(rng.uniform(0, 1, d) < 0.8, gt["classes"][pick] if g else 0,
                                   rng.integers(0, num_classes, d)),
               "keypoints": dkp}
        images.append((gt, det))
    return images


def test_oks_matrix_matches_jax():
    """``oks_matrix`` on random keypoints (unlabelled GT keypoints, a GT with
    none labelled, areas below 1) with COCO's sigmas and with others: equal
    to the JAX package's; 1 for a perfect prediction, about 0 far away, and
    smaller for a smaller annotation area (the JAX test's cases)."""
    rng = np.random.default_rng(0)
    dt = rng.uniform(0, 100, (7, 17, 3))
    gt = rng.uniform(0, 100, (5, 17, 3))
    gt[..., 2] = rng.integers(0, 3, (5, 17))
    gt[1, :, 2] = 0
    areas = np.array([400.0, 100.0, 0.5, 2500.0, 9000.0])
    crowd = np.array([False, True, False, False, False])
    for sigmas in (None, np.full(17, 0.05)):
        np.testing.assert_array_equal(oks_matrix(dt, gt, areas, crowd, sigmas),
                                      jax_oks_matrix(dt, gt, areas, crowd, sigmas))
    np.testing.assert_array_equal(COCO_KP_SIGMAS, jax_oks_matrix.__globals__["COCO_KP_SIGMAS"])
    assert oks_matrix(dt[:0], gt, areas, crowd).shape == (0, 5)
    one = np.zeros((1, 17, 3))
    one[0, :, :2], one[0, :, 2] = 50.0, 2
    perfect = oks_matrix(np.concatenate([one, one + [300, 300, 0]]), one, [1e4], [False])
    assert abs(perfect[0, 0] - 1.0) < 1e-9 and perfect[1, 0] < 1e-4
    near = one + [3.0, 3.0, 0.0]
    assert oks_matrix(near, one, [2500.0], [False])[0, 0] < oks_matrix(near, one, [1e4],
                                                                         [False])[0, 0]


@pytest.mark.parametrize("sigmas,seed", [(None, 0), (None, 1), ("narrow", 2)])
def test_keypoint_evaluator_matches_jax(sigmas, seed):
    """``CocoEvaluator("keypoints")`` (OKS matching, the GT ``areas`` or
    else the box area, empty classes as (0, 17, 3)) on random images, with
    COCO's sigmas or ``kp_sigmas``: every metric, per category too, to
    1e-12."""
    rng = np.random.default_rng(seed)
    images = _kp_images(rng, 10, 3)
    ours = CocoEvaluator(3, "keypoints", class_names=list("abc"), all_per_category=True)
    theirs = JaxCocoEvaluator(3, "keypoints", class_names=list("abc"), all_per_category=True)
    if sigmas:
        ours.kp_sigmas = theirs.kp_sigmas = np.linspace(0.03, 0.1, 17)
    for gt, det in images:
        ours.add_image(gt, det)
        theirs.add_image(gt, det)
    got, want = ours.evaluate(), theirs.evaluate()
    assert_metrics_equal(got, want, TOL)
    assert 0.0 < got["AP"] < 100.0


# -- the evaluation loop -------------------------------------------------------------------

_GT_FIELDS = ("gt_boxes", "gt_classes", "gt_valid", "gt_keypoints")


class _TorchOracle(torch.nn.Module):
    """A port model whose ``predict`` returns the batch's GT (resized frame)
    as detections, scored 0.9, the keypoints moved by (1, -2) px."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(()))

    def predict(self, batch):
        kp = batch["gt_keypoints"].clone()
        kp[..., 0] += 1.0
        kp[..., 1] -= 2.0
        kp[..., 2] = 1.0
        valid = batch["gt_valid"]
        return Instances(boxes=batch["gt_boxes"], scores=valid.float() * 0.9,
                         pred_classes=batch["gt_classes"], is_valid=valid, pred_keypoints=kp)


class _JaxOracle:
    """The JAX side of ``_TorchOracle``."""

    def predict(self, variables, batch):
        kp = batch["gt_keypoints"]
        kp = jnp.stack([kp[..., 0] + 1.0, kp[..., 1] - 2.0, jnp.ones_like(kp[..., 2])], -1)
        valid = batch["gt_valid"]
        return JaxInstances(boxes=batch["gt_boxes"], scores=valid.astype(jnp.float32) * 0.9,
                            pred_classes=batch["gt_classes"], is_valid=valid,
                            pred_keypoints=kp)


@pytest.mark.parametrize("metrics", [("coco_detection_metrics",),
                                     ("coco_detection_metrics", "coco_keypoint_metrics")])
def test_evaluate_feeds_keypoints_as_jax(tmp_path, monkeypatch, metrics):
    """The evaluation loop over 5 synthetic keypoint images (4 box corners):
    the keypoint evaluator added by default (or named), with
    ``TEST.KEYPOINT_OKS_SIGMAS`` (four of 0.05: COCO's are 17), keypoints
    scaled to the original frame;
    every metric equal to the JAX loop's on the same detections, and the
    results file carrying 4 x 3 keypoint values a detection."""
    monkeypatch.setattr(tevaluator, "_PREDICT_INPUTS", tevaluator._PREDICT_INPUTS + _GT_FIELDS)
    jcfg, tcfg = small_cfgs(**{"EVAL.METRICS": metrics, "TEST.KEYPOINT_OKS_SIGMAS": [0.05] * 4,
                               "MODEL.MASK_ON": False})
    ds = SyntheticDataset(n=5, with_keypoints=True)
    writer = CocoResultsWriter()
    got = tevaluator.evaluate(tcfg, _TorchOracle(), ds,
                              build_dataloader(tcfg, ds, training=False), results_writer=writer)
    jds = JaxSyntheticDataset(n=5, with_keypoints=True)
    want = jevaluator.evaluate(jcfg, _JaxOracle(), {}, jds,
                               jax_build_dataloader(jcfg, jds, training=False))
    assert_metrics_equal(got, want, TOL)
    assert "keypoints/AP" in got and 0.0 < got["keypoints/AP"] < 100.0
    path = str(tmp_path / "results.json")
    n = writer.save(path)
    with open(path) as f:
        records = json.load(f)
    assert n == sum(len(ds[i]["boxes"]) for i in range(5)) == len(records)
    assert all(len(r["keypoints"]) == 12 for r in records)


def test_evaluate_without_keypoint_gt_adds_no_keypoint_metrics(monkeypatch):
    """A dataset without keypoints: no keypoint evaluator is added, as in
    the JAX loop (its keypoint metrics would be empty)."""
    monkeypatch.setattr(tevaluator, "_PREDICT_INPUTS", tevaluator._PREDICT_INPUTS + _GT_FIELDS[:3])
    _, tcfg = small_cfgs(**{"MODEL.MASK_ON": False})

    class Oracle(_TorchOracle):
        def predict(self, batch):
            b, g = batch["gt_valid"].shape
            return super().predict({**batch, "gt_keypoints": torch.zeros((b, g, 4, 3))})

    ds = SyntheticDataset(n=3)
    got = tevaluator.evaluate(tcfg, Oracle(), ds, build_dataloader(tcfg, ds, training=False))
    assert not any(k.startswith("keypoints/") for k in got) and "bbox/AP" in got


# -- the overfit tool ----------------------------------------------------------------------

def test_overfit_cfg_matches_the_jax_tool_keypoint():
    """``overfit_check``'s keypoint recipe is the JAX tool's ``get_cfg_for
    ("keypoint")`` on the tiny inputs, key for key."""
    check_overfit_cfg("keypoint")
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from tools import overfit_check as jax_overfit_check
    from detectron2_tensorflow_tpu_torch.tools import overfit_check

    jcfg, tcfg = jax_overfit_check.get_cfg_for("keypoint"), overfit_check.get_cfg_for("keypoint")
    assert tcfg.MODEL.KEYPOINT_ON and not tcfg.MODEL.MASK_ON
    assert tuple(tcfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS) == tuple(
        jcfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS) == (128,) * 4
    assert list(tcfg.TEST.KEYPOINT_OKS_SIGMAS) == [0.05] * 4


def test_overfit_check_keypoint_runs_on_the_cpu(capsys):
    """``tools.overfit_check --arch keypoint --device cpu`` at narrow widths
    and 2 images a step: one step, the evaluation, the JSON line with bbox
    AP and ``keypoints_ap``."""
    out = run_overfit_check("keypoint", OVERFIT_NARROW + [
        "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", "(32, 32)", "SOLVER.IMS_PER_BATCH", "2"],
        capsys, steps=1)
    assert out["arch"] == "keypoint" and out["steps"] == 1
    assert {"bbox_ap", "bbox_ap50", "keypoints_ap"} <= set(out) and "segm_ap" not in out
    assert math.isnan(out["keypoints_ap"]) or 0.0 <= out["keypoints_ap"] <= 100.0
