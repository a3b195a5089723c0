"""The panoptic family's data and evaluation against the JAX package: the
id-map colours, ``CocoPanopticDataset``, the nearest resize and flip of
semantic maps, the loader's ``gt_sem_seg``, ``image/sem_seg`` records read
across the packages, the ``--panoptic`` synthetic split, the semantic and
panoptic evaluators and their evaluation loops, and the CLI route
(``tools.make_synthetic_coco --panoptic`` -> ``tools.build_records``
``coco_pano`` -> ``tools.train`` -> ``tools.eval``) at narrow widths.

Label maps, id maps, boxes, classes and segment tables must be equal; images
decoded from one JPEG are equal (PIL and ``cv2`` run libjpeg alike);
resized masks agree to ``test_torch_data``'s MASK_ATOL and images to its
IMAGE_ATOL. The evaluators are the same float64 numpy arithmetic on the
same integer counts: every metric to 1e-6 (NaN where a category range is
empty, on both sides).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import eval as jax_eval
import train as jax_train
from detectron2_tensorflow_tpu.data import build_dataloader as jax_build_dataloader
from detectron2_tensorflow_tpu.data import panoptic as jpanoptic
from detectron2_tensorflow_tpu.data import records as jrecords
from detectron2_tensorflow_tpu.data import transforms as jtransforms
from detectron2_tensorflow_tpu.engine import evaluator as jevaluator
from detectron2_tensorflow_tpu.evaluation.panoptic_eval import (
    PanopticEvaluator as JaxPanopticEvaluator,
)
from detectron2_tensorflow_tpu.evaluation.sem_seg_eval import SemSegEvaluator as JaxSemSegEvaluator
from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
from detectron2_tensorflow_tpu_torch.data import (
    CocoPanopticDataset,
    SyntheticDataset,
    TFRecordDataset,
    build_dataloader,
    build_records,
    id_to_rgb,
    rgb_to_id,
    transforms,
)
from detectron2_tensorflow_tpu_torch.data.panoptic import decode_label_map, encode_label_map
from detectron2_tensorflow_tpu_torch.data.polygon import fill_ellipse
from detectron2_tensorflow_tpu_torch.engine import evaluator as tevaluator
from detectron2_tensorflow_tpu_torch.engine import make_train_batch
from detectron2_tensorflow_tpu_torch.evaluation import PanopticEvaluator, SemSegEvaluator
from detectron2_tensorflow_tpu_torch.structures import Instances
from detectron2_tensorflow_tpu_torch.tools import make_synthetic_coco
from detectron2_tensorflow_tpu_torch.tools import train as tools_train
from detectron2_tensorflow_tpu_torch.tools import eval as tools_eval
from detectron2_tensorflow_tpu_torch.tools import workflow_check_panoptic
from test_data import SyntheticDataset as JaxSyntheticDataset
from test_torch_c4 import REPO, check_overfit_cfg, run_overfit_check
from test_torch_cli import NARROW
from test_torch_coco import _fmt_cfgs, _kind
from test_torch_data import assert_batches_match, small_cfgs
from test_torch_evaluation import assert_metrics_equal
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6
PANO_NARROW = NARROW + ["MODEL.SEM_SEG_HEAD.CONVS_DIM", "32"]


@pytest.fixture(scope="module")
def jax_pano(tmp_path_factory):
    """A synthetic COCO-panoptic directory written by the JAX package's tool
    (6 train and 3 val images)."""
    root = tmp_path_factory.mktemp("pano")
    subprocess.run([sys.executable, "tools/make_synthetic_coco.py", str(root), "6", "3",
                    "--panoptic"], cwd=REPO, check=True, capture_output=True)
    return root


def _datasets(root, split="train", ignore_label=-1):
    args = (str(root / f"{split}_panoptic.json"), str(root / f"{split}_panoptic"),
            str(root / split))
    return (CocoPanopticDataset(*args, ignore_label=ignore_label),
            jpanoptic.CocoPanopticDataset(*args, ignore_label=ignore_label))


# -- id maps and the dataset ---------------------------------------------------------------

def test_rgb_id_round_trip_matches_jax():
    """``id_to_rgb`` and ``rgb_to_id`` (base 256) as the JAX package's, over
    ids up to 256^3 - 1; the label-map PNG keeps -1 as 256^3 - 1 and
    ``cv2`` decodes the port's PNG to the same colours."""
    rng = np.random.default_rng(0)
    ids = rng.integers(0, 256 ** 3, (5, 9))
    ids[0, 0] = 256 ** 3 - 1
    np.testing.assert_array_equal(id_to_rgb(ids), jpanoptic.id_to_rgb(ids))
    rgb = rng.integers(0, 256, (4, 6, 3)).astype(np.uint8)
    np.testing.assert_array_equal(rgb_to_id(rgb), jpanoptic.rgb_to_id(rgb))
    np.testing.assert_array_equal(rgb_to_id(id_to_rgb(ids)), ids)
    sem = rng.integers(-1, 70000, (7, 5)).astype(np.int32)
    data = encode_label_map(sem)
    np.testing.assert_array_equal(decode_label_map(data), sem)
    bgr = cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)
    np.testing.assert_array_equal(bgr[..., ::-1], id_to_rgb(np.where(sem < 0, 256 ** 3 - 1, sem)))


def test_panoptic_dataset_matches_jax(jax_pano):
    """``CocoPanopticDataset`` over the JAX tool's files: the category tables,
    ``images``, every sample (image, boxes, classes, masks, ``sem_seg`` with
    things at 0, stuff from 1, unlabelled at the ignore label) and
    ``get_panoptic_gt`` equal to the JAX dataset's."""
    for ignore in (-1, 255):
        ours, theirs = _datasets(jax_pano, ignore_label=ignore)
        assert len(ours) == len(theirs) == 6
        for attr in ("thing_contiguous", "stuff_contiguous", "thing_classes", "stuff_classes",
                     "images"):
            assert getattr(ours, attr) == getattr(theirs, attr), attr
        for i in range(len(ours)):
            a, b = ours[i], theirs[i]
            assert a.keys() == b.keys() and a["image_id"] == b["image_id"]
            for k in ("image", "boxes", "classes", "is_crowd", "masks", "sem_seg"):
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            assert set(np.unique(a["sem_seg"])) <= {0, 1, 2}
            (ga, sa), (gb, sb) = ours.get_panoptic_gt(i), theirs.get_panoptic_gt(i)
            np.testing.assert_array_equal(ga, gb)
            assert sa == sb


def test_unlabelled_pixels_take_the_ignore_label(tmp_path):
    """A segment-free pixel (id 0 in the PNG) is ``ignore_label`` in
    ``sem_seg``, as in the JAX dataset; a crowd thing is class 0 there but
    no instance."""
    root = tmp_path / "p"
    make_synthetic_coco.main([str(root), "2", "1", "--panoptic"])
    ann = json.loads((root / "train_panoptic.json").read_text())
    png = root / "train_panoptic" / ann["annotations"][0]["file_name"]
    ids = rgb_to_id(cv2.imread(str(png))[..., ::-1])
    ids[:5, :7] = 0
    cv2.imwrite(str(png), id_to_rgb(ids)[..., ::-1])
    ann["annotations"][0]["segments_info"][-1]["iscrowd"] = 1
    (root / "train_panoptic.json").write_text(json.dumps(ann))
    ours, theirs = _datasets(root)
    a, b = ours[0], theirs[0]
    assert (a["sem_seg"][:5, :7] == -1).all()
    for k in ("boxes", "classes", "masks", "sem_seg"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    assert len(a["boxes"]) == len(ann["annotations"][0]["segments_info"]) - 3


# -- transforms and the loader -------------------------------------------------------------

@pytest.mark.parametrize("shape,out", [((97, 153), (64, 101)), ((240, 320), (800, 1067)),
                                       ((194, 306), (128, 202)), ((37, 51), (111, 153)),
                                       ((480, 640), (360, 481)), ((5, 7), (3, 2))])
def test_nearest_resize_matches_cv2(shape, out):
    """``resize_nearest`` equals ``cv2.resize(..., INTER_NEAREST)`` on int32
    label maps scaled up and down, by integer and other ratios."""
    sem = np.random.default_rng(shape[0]).integers(-1, 60, shape).astype(np.int32)
    want = cv2.resize(sem, (out[1], out[0]), interpolation=cv2.INTER_NEAREST)
    np.testing.assert_array_equal(transforms.resize_nearest(sem, *out), want)


def test_sem_seg_transforms_match_jax():
    """``flip_horizontal``, ``flip_vertical`` and ``resize_shortest_edge``
    carry ``sem_seg`` as the JAX transforms do, and so does ``run`` with the
    flips drawn."""
    jcfg, tcfg = small_cfgs()
    s = SyntheticDataset(n=1, h=97, w=153, with_sem_seg=True)[0]
    np.testing.assert_array_equal(transforms.flip_horizontal(s)["sem_seg"],
                                  jtransforms.flip_horizontal(s)["sem_seg"])
    for size in (64, 80, 200):
        got, _ = transforms.resize_shortest_edge(s, size, 400)
        want, _ = jtransforms.resize_shortest_edge(s, size, 400)
        np.testing.assert_array_equal(got["sem_seg"], want["sem_seg"])
        assert got["sem_seg"].dtype == np.int32
    for seed in range(4):
        got, _ = transforms.run(tcfg, s, True, np.random.default_rng(seed))
        want, _ = jtransforms.run(jcfg, s, True, np.random.default_rng(seed))
        np.testing.assert_array_equal(got["sem_seg"], want["sem_seg"])
    np.testing.assert_array_equal(transforms.flip_vertical(s)["sem_seg"],
                                  jtransforms.flip_vertical(s)["sem_seg"])
    tcfg.AUGMENT.VERTICAL_FLIP = jcfg.AUGMENT.VERTICAL_FLIP = True
    for seed in range(4):
        got, _ = transforms.run(tcfg, s, True, np.random.default_rng(seed))
        want, _ = jtransforms.run(jcfg, s, True, np.random.default_rng(seed))
        np.testing.assert_array_equal(got["sem_seg"], want["sem_seg"])


def test_loader_gt_sem_seg_matches_jax():
    """Training batches of semantic samples: ``gt_sem_seg [B, bh, bw]`` int32,
    -1 in the padding, and every other field as the JAX loader gives them."""
    jcfg, tcfg = small_cfgs(**{"DATALOADER.NUM_READERS": 2, "DATALOADER.NATIVE_TRAIN_IO": False})
    ours = build_dataloader(tcfg, SyntheticDataset(n=6, with_sem_seg=True), training=True, seed=0)
    theirs = jax_build_dataloader(jcfg, JaxSyntheticDataset(n=6, with_sem_seg=True),
                                  training=True, seed=0)
    for _ in range(4):
        got, want = next(ours), next(theirs)
        assert got["gt_sem_seg"].dtype == np.int32
        assert_batches_match(got, want)
        h, w = got["image_size"][0]
        assert (got["gt_sem_seg"][0, h:] == -1).all() and (got["gt_sem_seg"][0, :, w:] == -1).all()
    ours.close()


def test_synthetic_semantic_recipe_matches_jax():
    """``SyntheticDataset(with_sem_seg=True)``: the JAX test recipe's map (0
    background, class + 1 in each box, later boxes over earlier ones)."""
    for kw in ({}, {"h": 194, "w": 306, "box_range": (30, 70)}):
        a = SyntheticDataset(n=4, num_classes=3, with_sem_seg=True, **kw)
        b = JaxSyntheticDataset(n=4, num_classes=3, with_sem_seg=True, **kw)
        for i in range(4):
            np.testing.assert_array_equal(a[i]["sem_seg"], b[i]["sem_seg"])
            assert a[i]["sem_seg"].max() >= 1


def test_make_train_batch_draws_a_semantic_map_last():
    """A model with a semantic head gets ``gt_sem_seg [B, H, W]``: labels of
    its classes and ignored blocks, ignored right of the image size; the
    other fields as drawn without it."""
    _, tcfg = small_cfgs(**{"MODEL.META_ARCHITECTURE": "PanopticFPN",
                            "MODEL.SEM_SEG_HEAD.NUM_CLASSES": 5})
    with_sem = make_train_batch(tcfg, 64, 1344)
    tcfg.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
    without = make_train_batch(tcfg, 64, 1344)
    assert set(with_sem) == set(without) | {"gt_sem_seg"}
    for k, v in without.items():
        np.testing.assert_array_equal(with_sem[k], v)
    sem = with_sem["gt_sem_seg"]
    assert sem.shape == (2, 64, 1344) and sem.dtype == np.int32
    assert set(np.unique(sem[:, :, :1333])) == set(range(-1, 5))
    assert (sem[:, :, 1333:] == -1).all()


# -- records -------------------------------------------------------------------------------

def test_panoptic_records_cross_read(jax_pano, tmp_path):
    """Records of the panoptic set written by each package and read by both:
    equal ``sem_seg`` maps (the ignore label through 256^3 - 1), boxes,
    classes and masks; the image as the writer's own reader decodes it."""
    ours, theirs = _datasets(jax_pano)
    build_records(ours, str(tmp_path / "ours.record"), 2)
    jrecords.build_records(theirs, str(tmp_path / "jax.record"), 2)
    for name in ("ours", "jax"):
        pattern = str(tmp_path / f"{name}.record-*")
        a, b = TFRecordDataset(pattern), jrecords.TFRecordDataset(pattern)
        assert len(a) == len(b) == 6
        for i in range(len(a)):
            x, y = a[i], b[i]
            for k in ("image", "sem_seg", "boxes", "classes", "masks"):
                np.testing.assert_array_equal(x[k], y[k], err_msg=f"{name} {k}")
            src = ours[[e[0]["id"] for e in ours.entries].index(x["image_id"])]
            np.testing.assert_array_equal(x["sem_seg"], src["sem_seg"])


def test_panoptic_training_dataset_choice_matches_jax(jax_pano, tmp_path):
    """A PanopticFPN trains from the panoptic JSON without records and from
    ``coco_pano`` records with them, as the JAX ``train.py`` chooses; the
    evaluation of the semantic and panoptic metrics reads the panoptic JSON,
    as the JAX ``eval.py`` does."""
    root = str(jax_pano)
    extra = {"MODEL.META_ARCHITECTURE": "PanopticFPN", "DATASETS.VAL": "val",
             "EVAL.METRICS": ("coco_detection_metrics", "panoptic_segmentation_metrics")}
    jcfg, tcfg = _fmt_cfgs(root, "auto", **extra)
    ds = tools_train.build_train_dataset(tcfg)
    assert isinstance(ds, CocoPanopticDataset) and type(jax_train.build_train_dataset(
        jcfg)).__name__ == "CocoPanopticDataset"
    assert len(tools_eval.build_eval_dataset(tcfg)) == len(jax_eval.build_eval_dataset(jcfg)) == 3
    shards = tmp_path / "shards"
    shards.mkdir()
    for name in os.listdir(jax_pano):
        os.symlink(jax_pano / name, shards / name)
    build_records(ds, str(shards / "train.record"), 2)
    jcfg, tcfg = _fmt_cfgs(str(shards), "auto", **extra)
    assert _kind(tools_train.build_train_dataset(tcfg)) == _kind(
        jax_train.build_train_dataset(jcfg)) == "records"
    assert tools_train.build_train_dataset(tcfg)[0]["sem_seg"].shape == (240, 320)


# -- the synthetic tool ----------------------------------------------------------------------

def test_fill_ellipse_matches_cv2():
    """``fill_ellipse`` is ``cv2.ellipse(..., 0, 0, 360, color, -1)`` pixel for
    pixel over every pair of half axes the synthetic tool draws (20-44 px)
    and small ones, inside the image and clipped at its edges."""
    for ax in list(range(0, 8)) + list(range(20, 45)):
        for ay in list(range(0, 8)) + list(range(20, 45)):
            for cx, cy in ((100, 90), (3, 5), (315, 237)):
                a = np.zeros((240, 320, 3), np.uint8)
                b = a.copy()
                cv2.ellipse(a, (cx, cy), (ax, ay), 0, 0, 360, (60, 230, 60), -1)
                fill_ellipse(b, (cx, cy), (ax, ay), (60, 230, 60))
                assert np.array_equal(a, b), (ax, ay, cx, cy)


def test_panoptic_synthetic_split_matches_the_jax_tool(jax_pano, tmp_path):
    """``--panoptic``: the same JSON, id maps that decode to the same ids and
    images that decode equal to the JAX tool's, split for split."""
    ours = tmp_path / "ours"
    make_synthetic_coco.main([str(ours), "6", "3", "--panoptic"])
    assert json.loads((ours / "category_map.json").read_text()) == {
        "thing_classes": ["square", "disk", "stripe"], "stuff_classes": ["things", "floor", "sky"]}
    for split in ("train", "val"):
        ann = json.loads((ours / f"{split}_panoptic.json").read_text())
        assert ann == json.loads((jax_pano / f"{split}_panoptic.json").read_text())
        for a, img in zip(ann["annotations"], ann["images"]):
            for sub, name in ((f"{split}_panoptic", a["file_name"]), (split, img["file_name"])):
                got = cv2.imread(str(ours / sub / name))
                want = cv2.imread(str(jax_pano / sub / name))
                np.testing.assert_array_equal(got, want, err_msg=f"{sub}/{name}")


# -- the evaluators --------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sem_seg_evaluator_matches_jax(seed):
    """mIoU, mACC, pACC and fwIoU over maps with ignored pixels and absent
    classes, to 1e-6 (in the JAX package's key order)."""
    rng = np.random.default_rng(seed)
    a, b = SemSegEvaluator(7), JaxSemSegEvaluator(7)
    for _ in range(3):
        gt = rng.integers(-1, 6, (30, 40))
        pred = np.where(rng.uniform(size=gt.shape) < 0.7, np.maximum(gt, 0),
                        rng.integers(0, 7, gt.shape))
        a.add_image(gt, pred)
        b.add_image(gt, pred)
    assert_metrics_equal(a.evaluate(), b.evaluate(), TOL)


def _segments(rng, ids, cats, crowd=False):
    return [{"id": int(i), "category_id": int(cats[i % len(cats)]),
             **({"iscrowd": int(crowd and i % 5 == 0)} if crowd else {})} for i in ids]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_panoptic_evaluator_matches_jax(seed):
    """PQ, SQ, RQ and their thing and stuff parts over maps with void, crowd
    GT, predictions mostly on void or on a crowd of their class, and
    unmatched segments, to 1e-6."""
    rng = np.random.default_rng(seed)
    cats = {0: True, 1: True, 2: True, 1001: False, 1002: False}
    a, b = PanopticEvaluator(cats), JaxPanopticEvaluator(cats)
    for _ in range(3):
        gt = np.kron(rng.integers(0, 9, (6, 8)), np.ones((5, 5), np.int64))
        pred = gt.copy()
        noise = rng.uniform(size=gt.shape) < 0.2
        pred[noise] = rng.integers(0, 11, noise.sum())
        gt_segs = _segments(rng, [i for i in np.unique(gt) if i], list(cats), crowd=True)
        pred_segs = _segments(rng, [i for i in np.unique(pred) if i], list(cats))
        a.add_image(gt, gt_segs, pred, pred_segs)
        b.add_image(gt, gt_segs, pred, pred_segs)
    got, want = a.evaluate(), b.evaluate()
    assert_metrics_equal(got, want, TOL)
    assert 0.0 < got["PQ"] < 100.0


# -- the evaluation loops --------------------------------------------------------------------

_GT = ("gt_boxes", "gt_classes", "gt_valid", "gt_masks", "gt_sem_seg")


def _oracle_sem(sem, k):
    """The map an oracle predicts: the GT with its padding at 0 and the
    labels of the left third moved to the next class."""
    sem = np.maximum(np.asarray(sem), 0)
    w = sem.shape[-1]
    return np.where(np.arange(w) < w // 3, (sem + 1) % k, sem)


class _TorchOracle(torch.nn.Module):
    """A port model whose ``predict`` gives the batch's GT as detections
    (scored 0.9, its mini-masks as mask probabilities) and ``_oracle_sem``
    of its semantic GT."""

    def __init__(self, k):
        super().__init__()
        self.k = k
        self.anchor = torch.nn.Parameter(torch.zeros(()))

    def predict(self, batch):
        valid = batch["gt_valid"]
        sem = torch.from_numpy(_oracle_sem(batch["gt_sem_seg"].numpy(), self.k))
        return Instances(boxes=batch["gt_boxes"], scores=valid.float() * 0.9,
                         pred_classes=batch["gt_classes"], is_valid=valid,
                         pred_masks=batch["gt_masks"], sem_seg=sem)


class _JaxOracle:
    """The JAX side of ``_TorchOracle``."""

    def __init__(self, k):
        self.k = k

    def predict(self, variables, batch):
        valid = batch["gt_valid"]
        sem = jnp.maximum(batch["gt_sem_seg"], 0)
        w = sem.shape[-1]
        sem = jnp.where(jnp.arange(w) < w // 3, (sem + 1) % self.k, sem)
        return JaxInstances(boxes=batch["gt_boxes"], scores=valid.astype(jnp.float32) * 0.9,
                            pred_classes=batch["gt_classes"], is_valid=valid,
                            pred_masks=batch["gt_masks"], sem_seg=sem)


EVAL_SIZES = {"TRANSFORM.RESIZE.MIN_SIZE_TEST": 192, "TRANSFORM.RESIZE.MAX_SIZE_TEST": 256,
              "INPUT.PAD_BUCKETS": ((192, 256), (256, 192)),
              "MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT": 1024,
              "MODEL.SEM_SEG_HEAD.NUM_CLASSES": 3, "MODEL.META_ARCHITECTURE": "PanopticFPN"}


def test_evaluate_sem_seg_matches_jax(monkeypatch):
    """``evaluate_sem_seg`` over 5 synthetic semantic images (the recipe's 4
    classes) through oracle models: the same un-resized maps, every metric
    to 1e-6."""
    monkeypatch.setattr(tevaluator, "_PREDICT_INPUTS", tevaluator._PREDICT_INPUTS + _GT)
    jcfg, tcfg = small_cfgs(**{"MODEL.SEM_SEG_HEAD.NUM_CLASSES": 4})
    ds = SyntheticDataset(n=5, with_sem_seg=True)
    got = tevaluator.evaluate_sem_seg(tcfg, _TorchOracle(4), ds,
                                      build_dataloader(tcfg, ds, training=False))
    jds = JaxSyntheticDataset(n=5, with_sem_seg=True)
    want = jevaluator.evaluate_sem_seg(jcfg, _JaxOracle(4), {}, jds,
                                       jax_build_dataloader(jcfg, jds, training=False))
    assert_metrics_equal(got, want, TOL)
    assert 20.0 < got["sem_seg/mIoU"] < 100.0


def test_run_evaluation_panoptic_matches_jax(jax_pano, monkeypatch):
    """``run_evaluation`` with the detection, semantic and panoptic metrics
    over the JAX tool's panoptic val split through oracle models (the fusion
    on the predicted masks and map): every metric of the three families to
    1e-6, PQ above zero on both thing and stuff segments."""
    monkeypatch.setattr(tevaluator, "_PREDICT_INPUTS", tevaluator._PREDICT_INPUTS + _GT)
    metrics = ("coco_detection_metrics", "semantic_segmentation_metrics",
               "panoptic_segmentation_metrics")
    jcfg, tcfg = small_cfgs(**EVAL_SIZES, **{"EVAL.METRICS": metrics})
    ours, theirs = _datasets(jax_pano, "val")
    got = tevaluator.run_evaluation(tcfg, _TorchOracle(3), ours,
                                    lambda: build_dataloader(tcfg, ours, training=False))
    want = jevaluator.run_evaluation(jcfg, _JaxOracle(3), {}, theirs,
                                     lambda: jax_build_dataloader(jcfg, theirs, training=False))
    assert_metrics_equal(got, want, TOL)
    assert got["panoptic/PQ_th"] > 0 and got["panoptic/PQ_st"] > 0 and got["bbox/AP"] > 50


# -- the tools -------------------------------------------------------------------------------

def test_overfit_cfg_matches_the_jax_tool_semantic():
    """``overfit_check``'s semantic recipe is the JAX tool's, key for key
    (``overfit_cfg`` and then its ``main``'s 128/256 inputs), on the same
    194x306 images."""
    check_overfit_cfg("semantic")
    sys.path.insert(0, REPO)
    from tools import overfit_check as jax_overfit_check
    from detectron2_tensorflow_tpu_torch.tools import overfit_check

    cfg = overfit_check.overfit_cfg("semantic")
    ds = overfit_check.overfit_inputs(cfg, "semantic")
    assert cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES == 4
    assert cfg.INPUT.PAD_BUCKETS == ((128, 256), (256, 128))
    assert tuple(cfg.TRANSFORM.RESIZE.MIN_SIZE_TRAIN) == (128,)
    assert jax_overfit_check.get_cfg_for("semantic").MODEL.SEM_SEG_HEAD.NUM_CLASSES == 4
    want = JaxSyntheticDataset(n=8, h=194, w=306, num_classes=3, box_range=(30, 70),
                               with_sem_seg=True)
    for i in range(8):
        np.testing.assert_array_equal(ds[i]["sem_seg"], want[i]["sem_seg"])


def test_overfit_check_semantic_runs_on_the_cpu(capsys):
    """``tools.overfit_check --arch semantic --device cpu`` at narrow widths:
    one step, the evaluation, the JSON line with ``miou`` and ``macc``."""
    out = run_overfit_check("semantic", ["MODEL.RESNETS.STEM_OUT_CHANNELS", "32",
                                         "MODEL.RESNETS.RES2_OUT_CHANNELS", "128",
                                         "MODEL.NECK.OUT_CHANNELS", "32",
                                         "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32",
                                         "SOLVER.IMS_PER_BATCH", "2"], capsys, steps=1)
    assert out["arch"] == "semantic" and out["steps"] == 1
    assert set(out) == {"arch", "steps", "train_seconds", "final_loss", "miou", "macc"}
    assert 0.0 <= out["miou"] <= 100.0 and np.isfinite(out["final_loss"])


def test_panoptic_workflow_runs_its_four_steps(tmp_path, capsys):
    """``tools.workflow_check_panoptic`` at a tiny size on the CPU: the
    synthetic panoptic set, ``coco_pano`` records read back, one training
    step from them (``loss_sem_seg`` among the losses) and ``tools.eval``
    printing the box, semantic and panoptic metrics under a gate any model
    passes (its own gate needs the card's 600 iterations)."""
    passing = ("[['bbox', 'AP', 0.0, 100.0], ['sem_seg', 'mIoU', 0.0, 100.0], "
               "['panoptic', 'PQ', 0.0, 100.0]]")
    result = workflow_check_panoptic.run_workflow(str(tmp_path / "wf"), device="cpu",
                                                  opts=PANO_NARROW, max_iter=1, expected=passing,
                                                  echo=False)
    assert result["train"]["steps"] == 1 and "loss_sem_seg" in result["train"]["final_losses"]
    assert {"bbox/AP", "sem_seg/mIoU", "sem_seg/mACC", "panoptic/PQ", "panoptic/PQ_st"} <= set(
        result["metrics"])
    assert "pano records ok: 16 examples" in capsys.readouterr().out


def test_panoptic_workflow_gate_is_the_jax_workflows():
    """The gate, config and steps are those of ``tools/workflow_check_panoptic.sh``."""
    script = (Path(REPO) / "tools" / "workflow_check_panoptic.sh").read_text()
    assert workflow_check_panoptic.CFG in script
    assert workflow_check_panoptic.EXPECTED.replace("'", "") in script.replace("'", "")
    for step in ("16 8 --panoptic", "BUILD_RECORDS.TYPE coco_pano", "DATASETS.VAL train"):
        assert step in script


def test_semantic_segmentor_trains_and_evaluates_from_the_panoptic_json(tmp_path, capsys):
    """The SemanticSegmentor route without records: ``tools.train`` one step
    from ``train_panoptic.json`` (its stuff labels from the id maps) and
    ``tools.eval`` of the semantic metrics on the val split."""
    root = tmp_path / "sem"
    make_synthetic_coco.main([str(root), "2", "2", "--panoptic"])
    flags = ["--config_file", "configs/COCO-SemanticSegmentation/semantic_R_50_FPN_1x.yaml",
             "--device", "cpu"]
    opts = ["DATASETS.ROOT_DIR", str(root), "LOGS.ROOT_DIR",
            str(root / "logs"), "MODEL.RESNETS.DEPTH", "18", *PANO_NARROW,
            "TRANSFORM.RESIZE.MIN_SIZE_TRAIN", "(96,)", "TRANSFORM.RESIZE.MAX_SIZE_TRAIN", "128",
            "TRANSFORM.RESIZE.MIN_SIZE_TEST", "96", "TRANSFORM.RESIZE.MAX_SIZE_TEST", "128",
            "INPUT.PAD_BUCKETS", "((96, 128), (128, 96))"]
    cwd = os.getcwd()
    os.chdir(REPO)
    try:
        summary = tools_train.main([*flags, "--max_iter", "1", *opts])
        metrics = tools_eval.main([*flags, *opts])
    finally:
        os.chdir(cwd)
    assert summary["steps"] == 1 and set(summary["final_losses"]) == {"total_loss",
                                                                       "loss_sem_seg"}
    assert set(metrics) == {"sem_seg/mIoU", "sem_seg/mACC", "sem_seg/pACC", "sem_seg/fwIoU"}
    assert "sem_seg/mIoU: " in capsys.readouterr().out
