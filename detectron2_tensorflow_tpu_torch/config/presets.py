"""The presets the port's benchmarks and tools start from.

``bench_cfg()`` is the JAX package's ``bench.py`` ``bench_cfg()``: Mask
R-CNN R50-FPN, 800x1344 serving in bf16. ``train_cfg()`` is
``bench_train.py`` ``train_cfg()``: the same model with the FPN RPN training
budgets 2000/1000, at most 64 GT instances per image, ``batch_size`` images
per step and no LR auto-scaling. ``small_cfg()`` is the tiny-input recipe of the JAX
package's ``tests/test_data.py`` ``small_cfg()``, which its
``tools/overfit_check.py`` starts from. All start from the full default
tree. ``tests/test_torch_config.py`` holds ``bench_cfg()`` and
``train_cfg()`` against their JAX counterparts key by key.
"""

from __future__ import annotations

from .config import CfgNode, get_cfg


def _mask_rcnn_r50_fpn(cfg: CfgNode) -> CfgNode:
    m = cfg.MODEL
    m.META_ARCHITECTURE = "GeneralizedRCNN"
    m.MASK_ON = True
    m.DTYPE = "bfloat16"
    m.RESNETS.DEPTH = 50
    m.RESNETS.OUT_FEATURES = ["res2", "res3", "res4", "res5"]
    m.NECK.NAME = "FPN"
    m.NECK.IN_FEATURES = ["res2", "res3", "res4", "res5"]
    m.ANCHOR_GENERATOR.SIZES = [[32], [64], [128], [256], [512]]
    m.RPN.IN_FEATURES = ["p2", "p3", "p4", "p5", "p6"]
    m.ROI_HEADS.NAME = "StandardROIHeads"
    m.ROI_HEADS.IN_FEATURES = ["p2", "p3", "p4", "p5"]
    m.ROI_BOX_HEAD.NAME = "FastRCNNConvFCHead"
    m.ROI_BOX_HEAD.NUM_FC = 2
    m.ROI_BOX_HEAD.POOLER_RESOLUTION = 7
    m.ROI_MASK_HEAD.NUM_CONV = 4
    return cfg


def bench_cfg() -> CfgNode:
    """Mask R-CNN R50-FPN, 800x1344 serving, bf16 (``bench.bench_cfg()``)."""
    cfg = _mask_rcnn_r50_fpn(get_cfg())
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 1000
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
    cfg.TEST.DETECTIONS_PER_IMAGE = 100
    return cfg


def train_cfg(batch_size: int = 8) -> CfgNode:
    """The training step's configuration (``bench_train.train_cfg()``)."""
    cfg = _mask_rcnn_r50_fpn(get_cfg())
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 2000
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 1000
    cfg.SOLVER.IMS_PER_BATCH = batch_size
    cfg.SOLVER.AUTO_SCALE_LR_SCHEDULE = False
    cfg.INPUT.MAX_GT_INSTANCES = 64
    return cfg


def small_cfg() -> CfgNode:
    """64x128 inputs in two pad buckets, 28x28 mini-masks, at most 8 GT
    instances, 2 images per step (``tests/test_data.py`` ``small_cfg()``)."""
    cfg = get_cfg()
    r = cfg.TRANSFORM.RESIZE
    r.MIN_SIZE_TRAIN = (64,)
    r.MAX_SIZE_TRAIN = 128
    r.MIN_SIZE_TEST = 64
    r.MAX_SIZE_TEST = 128
    r.MINI_MASK_SIZE = 28
    cfg.INPUT.PAD_BUCKETS = ((64, 128), (128, 64))
    cfg.INPUT.MAX_GT_INSTANCES = 8
    cfg.SOLVER.IMS_PER_BATCH = 2
    return cfg
