"""The configuration this port reads, as a plain standard-library tree.

The JAX package's yacs-style config (``config/``)
imports PyYAML at module level, which the GPU machine does not have, so the
port carries its own small tree. It holds only the keys the Mask R-CNN
R50-FPN slices read (serving and the training step), with the values of the
JAX package's ``get_cfg()`` after the benchmark overrides in ``bench.py``
``bench_cfg()``; :func:`train_cfg` applies ``bench_train.py``
``train_cfg()``'s overrides instead. ``tests/test_torch_config.py`` holds
each against its JAX counterpart key by key.
"""

from __future__ import annotations


class CfgNode(dict):
    """A dict whose keys are also attributes (``cfg.MODEL.DTYPE``)."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k, v in self.items():
            if isinstance(v, dict) and not isinstance(v, CfgNode):
                self[k] = CfgNode(v)

    def __getattr__(self, name):
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name, value):
        if name not in self:
            raise AttributeError(f"unknown config key '{name}'")
        self[name] = value

    def flatten(self, prefix: str = ""):
        """Yield ``("MODEL.RPN.NMS_THRESH", value)`` pairs for every leaf."""
        for k, v in self.items():
            path = f"{prefix}{k}"
            if isinstance(v, CfgNode):
                yield from v.flatten(path + ".")
            else:
                yield path, v


def get_cfg() -> CfgNode:
    """Mask R-CNN R50-FPN, 800x1344 serving, bf16 (``bench.bench_cfg()``)."""
    return CfgNode(
        MODEL=dict(
            META_ARCHITECTURE="GeneralizedRCNN",
            MASK_ON=True,
            KEYPOINT_ON=False,
            LOAD_PROPOSALS=False,
            DTYPE="bfloat16",
            PIXEL_MEAN=[123.675, 116.28, 103.53],
            PIXEL_STD=[1.0, 1.0, 1.0],
            INPUT_FORMAT="BGR",
            BACKBONE=dict(NAME="ResNet", FREEZE_AT=2),
            RESNETS=dict(
                DEPTH=50,
                OUT_FEATURES=["res2", "res3", "res4", "res5"],
                NUM_GROUPS=1,
                NORM="FrozenBN",
                WIDTH_PER_GROUP=64,
                STRIDE_IN_1X1=True,
                RES5_DILATION=1,
                RES2_OUT_CHANNELS=256,
                STEM_OUT_CHANNELS=64,
            ),
            NECK=dict(
                NAME="FPN",
                IN_FEATURES=["res2", "res3", "res4", "res5"],
                OUT_CHANNELS=256,
                NORM="",
                ACTIVATION="",
                FUSE_TYPE="sum",
                TOP_BLOCK_TYPE="MAXPOOL",
            ),
            ANCHOR_GENERATOR=dict(
                NAME="DefaultAnchorGenerator",
                SIZES=[[32], [64], [128], [256], [512]],
                ASPECT_RATIOS=[[0.5, 1.0, 2.0]],
            ),
            PROPOSAL_GENERATOR=dict(NAME="RPN", MIN_SIZE=0),
            RPN=dict(
                HEAD_NAME="StandardRPNHead",
                IN_FEATURES=["p2", "p3", "p4", "p5", "p6"],
                BBOX_REG_WEIGHTS=(1.0, 1.0, 1.0, 1.0),
                PRE_NMS_TOPK_TEST=1000,
                POST_NMS_TOPK_TEST=1000,
                NMS_THRESH=0.7,
                BOUNDARY_THRESH=-1,
                IOU_THRESHOLDS=[0.3, 0.7],
                IOU_LABELS=[0, -1, 1],
                BATCH_SIZE_PER_IMAGE=256,
                POSITIVE_FRACTION=0.5,
                SMOOTH_L1_BETA=0.0,
                LOSS_WEIGHT=1.0,
                PRE_NMS_TOPK_TRAIN=12000,
                POST_NMS_TOPK_TRAIN=2000,
            ),
            ROI_HEADS=dict(
                NAME="StandardROIHeads",
                NUM_CLASSES=80,
                IN_FEATURES=["p2", "p3", "p4", "p5"],
                SCORE_THRESH_TEST=0.05,
                NMS_THRESH_TEST=0.5,
                NMS_CLS_AGNOSTIC=False,
                IOU_THRESHOLDS=[0.5],
                IOU_LABELS=[0, 1],
                BATCH_SIZE_PER_IMAGE=512,
                POSITIVE_FRACTION=0.25,
                PROPOSAL_APPEND_GT=True,
            ),
            ROI_BOX_HEAD=dict(
                NAME="FastRCNNConvFCHead",
                BBOX_REG_WEIGHTS=(10.0, 10.0, 5.0, 5.0),
                POOLER_RESOLUTION=7,
                POOLER_SAMPLING_RATIO=0,
                POOLER_TYPE="ROIAlignV2",
                NUM_FC=2,
                FC_DIM=1024,
                NUM_CONV=0,
                CONV_DIM=256,
                NORM="",
                CLS_AGNOSTIC_BBOX_REG=False,
                SMOOTH_L1_BETA=0.0,
            ),
            ROI_MASK_HEAD=dict(
                NAME="MaskRCNNConvUpsampleHead",
                POOLER_RESOLUTION=14,
                POOLER_SAMPLING_RATIO=0,
                POOLER_TYPE="ROIAlignV2",
                NUM_CONV=4,
                CONV_DIM=256,
                NORM="",
                CLS_AGNOSTIC_MASK=False,
            ),
            SEGMENTATION_OUTPUT=dict(FORMAT="conventional", FIXED_RESOLUTION=512),
        ),
        TEST=dict(DETECTIONS_PER_IMAGE=100),
        TRANSFORM=dict(RESIZE=dict(MAX_SIZE_TRAIN=1333, MAX_SIZE_TEST=1333)),
        INPUT=dict(MAX_GT_INSTANCES=100),
        SOLVER=dict(
            LR_SCHEDULER_NAME="WarmupMultiStepLR",
            IMS_PER_BATCH=16,
            AUTO_SCALE_LR_SCHEDULE=True,
            IMS_PER_BATCH_BASE=16,
            MAX_ITER=40000,
            BASE_LR=0.001,
            MOMENTUM=0.9,
            WEIGHT_DECAY=0.0001,
            WEIGHT_DECAY_NORM=0.0,
            WEIGHT_DECAY_BIAS=0.0001,
            BIAS_LR_FACTOR=1.0,
            GAMMA=0.1,
            STEPS=(30000,),
            WARMUP_FACTOR=1.0 / 1000,
            WARMUP_ITERS=1000,
            WARMUP_METHOD="linear",
            CLIP_GRADIENTS_BY_NORM=10.0,
        ),
    )


def train_cfg(batch_size: int = 8) -> CfgNode:
    """The training step's configuration (``bench_train.py`` ``train_cfg()``):
    the serving model with the FPN RPN training budgets 2000/1000, at most 64
    GT instances per image, ``batch_size`` images per step and no LR
    auto-scaling. ``PRE_NMS_TOPK_TEST`` is the JAX package's default there."""
    cfg = get_cfg()
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 2000
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 1000
    cfg.SOLVER.IMS_PER_BATCH = batch_size
    cfg.SOLVER.AUTO_SCALE_LR_SCHEDULE = False
    cfg.INPUT.MAX_GT_INSTANCES = 64
    return cfg
