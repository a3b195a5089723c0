"""Relation Networks' ``predict`` against the JAX package, and its
evaluation.

``configs/Misc/relation_rcnn_R_50_FPN_1x.yaml`` at narrow widths
(``test_torch_relation.RELATION_NARROW``: R50 depth, stem 16, res2 32, 8 per
group, FPN 32, FC 64, 4 relation groups of key dim 16, rank embedding 32, 5
classes, float32) on 2 x 128 x 160 images, in four settings: the YAML as it
is (no duplicate removal: the class-aware NMS), the learned duplicate
removal with its five IoU heads combined by ``mean`` and by ``max``, and
``MASK_ON`` over the removal's detections (the last two in
``test_torch_relation_variants.py``, which runs this file's checks on its
own fixture, so that each file stays near a minute on one CPU). The same seeded numpy inputs and
weights (the JAX ones carried over by ``convert.py``) go through both
packages, slot by slot, at the standing tolerances of ``test_torch_c4.py``:
valid slots and classes equal, boxes 1e-4 (measured 1.5e-5 px), scores
1e-4 relative (measured 8.5e-6), masks 1e-5. The NMS and pooling calls of a
``predict`` are counted, and the YAML evaluates (bbox only) through
``run_evaluation`` and ``tools.eval``.
"""

import os

import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu_torch.config import finalize
from detectron2_tensorflow_tpu_torch.data import CocoDataset, build_dataloader
from detectron2_tensorflow_tpu_torch.engine import run_evaluation
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.tools import eval as tools_eval
from detectron2_tensorflow_tpu_torch.tools import make_synthetic_coco
from test_torch_c4 import SINGLE_NARROW, check_detections, check_masks, predict_pair
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)
from test_torch_relation import DUP_ON, REPO, RELATION_NARROW, RELATION_YAML, relation_cfgs

SETTINGS = {
    "yaml": {},
    "dup_mean": DUP_ON,
    "dup_max": {**DUP_ON, "MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_COMBINE": "max"},
    "dup_mask": {**DUP_ON, "MODEL.MASK_ON": True},
}
# The synthetic images (240 x 320) resized and padded to a small bucket, a
# few detection slots, for the CPU.
EVAL_SMALL = {"TRANSFORM.RESIZE.MIN_SIZE_TEST": 128, "TRANSFORM.RESIZE.MAX_SIZE_TEST": 160,
              "INPUT.PAD_BUCKETS": ((128, 160), (160, 128)), "MODEL.ROI_HEADS.NUM_CLASSES": 3,
              "MODEL.RPN.POST_NMS_TOPK_TEST": 100, "TEST.DETECTIONS_PER_IMAGE": 20,
              "SOLVER.IMS_PER_GPU": 2}


@pytest.fixture(scope="module", params=["yaml", "dup_mean"])
def relation(request):
    return predict_pair(*relation_cfgs(**SETTINGS[request.param]))


def test_relation_detections_match_jax(relation):
    """Slot by slot: 100 slots an image (the removal's top-k of its 400
    candidates, or the NMS's), valid slots and classes equal."""
    check_detections(relation)
    assert relation["tout"].boxes.shape == (2, 100, 4)


def test_relation_masks_match_jax(relation):
    """With ``MASK_ON`` the mask head on the detections, 28 x 28; without it
    no masks in either package."""
    check_masks(relation, 28)


def test_relation_predict_calls(relation, monkeypatch):
    """One box pool per ``predict`` (plus the mask pool with ``MASK_ON``);
    the RPN's NMS, and the box head's class-aware NMS only without the
    duplicate removal."""
    import importlib

    from detectron2_tensorflow_tpu_torch.models import poolers

    nms = importlib.import_module("detectron2_tensorflow_tpu_torch.ops.nms")
    calls = {"pool": 0, "nms": 0}
    real_pool, real_nms = poolers.roi_patch_interpolate, nms.greedy_keep

    def pool(*a, **k):
        calls["pool"] += 1
        return real_pool(*a, **k)

    def keep(*a, **k):
        calls["nms"] += 1
        return real_nms(*a, **k)

    monkeypatch.setattr(poolers, "roi_patch_interpolate", pool)
    monkeypatch.setattr(nms, "greedy_keep", keep)
    cfg = relation["tcfg"]
    relation["tmodel"].predict(relation["tbatch"])
    dup = cfg.MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_ON
    assert calls == {"pool": 2 if cfg.MODEL.MASK_ON else 1, "nms": 1 if dup else 2}


# -- evaluation ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("relation_coco")
    make_synthetic_coco.main([str(root), "2", "3"])
    return root


def test_relation_evaluates_through_run_evaluation_and_tools_eval(coco_root, tmp_path):
    """The narrow YAML with the duplicate removal: ``run_evaluation`` on 3
    synthetic images gives the bbox metrics and no segm, and ``tools.eval
    --device cpu`` from a checkpoint of the same weights gives the same
    numbers."""
    _, cfg = relation_cfgs(**DUP_ON, **EVAL_SMALL)
    finalize(cfg, training=False, device="cpu")
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(3))
    ds = CocoDataset(os.path.join(coco_root, "val.json"), os.path.join(coco_root, "val"))
    metrics = run_evaluation(cfg, model, ds, lambda: build_dataloader(cfg, ds, training=False))
    assert "bbox/AP" in metrics and "bbox/AP50" in metrics
    assert not any(k.startswith(("segm", "keypoints")) for k in metrics), sorted(metrics)
    ckpt = tmp_path / "relation.pt"
    torch.save(model.state_dict(), ckpt)
    opts = [str(x) for kv in {**SINGLE_NARROW, **RELATION_NARROW, **DUP_ON,
                              **EVAL_SMALL}.items() for x in kv]
    got = tools_eval.main(["--device", "cpu", "--checkpoint", str(ckpt), "--config_file",
                           os.path.join(REPO, RELATION_YAML), "DATASETS.ROOT_DIR",
                           str(coco_root), "LOGS.ROOT_DIR", str(tmp_path / "logs"), *opts])
    assert got.keys() == metrics.keys()
    for k, v in metrics.items():
        assert got[k] == v or (np.isnan(got[k]) and np.isnan(v)), k
