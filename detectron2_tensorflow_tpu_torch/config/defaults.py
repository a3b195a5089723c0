"""The full default configuration tree, key for key as the JAX package's
``config/defaults.py``, so that the same YAML files merge into the same tree.

Some keys configure what only the JAX package has (its XLA compilation
cache, ``PARALLEL`` meshes, rematerialization); the port keeps them for the
schema's sake, and its builders raise on values of keys they do not support
rather than ignore them.

Convention: keys used only during training end in _TRAIN; test-only keys end
in _TEST.
"""

from .config import CfgNode as CN

_C = CN()

# ----------------------------------------------------------------------------
# Logging / output locations
# ----------------------------------------------------------------------------
_C.LOGS = CN()
_C.LOGS.ROOT_DIR = ""
_C.LOGS.TRAIN = "train"
_C.LOGS.EVAL = "eval"
_C.LOGS.EXPORT = "export"
# The JAX package's persistent XLA compilation cache. The port has no such
# cache, and its default names no directory (the one key whose default
# differs from the JAX package's).
_C.LOGS.COMPILATION_CACHE_DIR = ""

_C.OUTPUT_DIR = "./output"
# Seed of the train state: max(SEED, 0), as the JAX package's train() takes it.
_C.SEED = -1
# Vestigial GPU knob kept for config-compat; ignored on TPU.
_C.CUDNN_BENCHMARK = False

# ----------------------------------------------------------------------------
# Serving / export
# ----------------------------------------------------------------------------
_C.SERVING_MODEL = CN()
_C.SERVING_MODEL.FROZEN_GRAPH_FILE_NAME = "frozen_inference_graph.pb"
_C.SERVING_MODEL.INPUT_OUTPUT_TENSOR_PREFIX = ""
_C.SERVING_MODEL.TYPE = "Detection"
_C.SERVING_MODEL.LABEL_OFFSET = 1

# ----------------------------------------------------------------------------
# Offline record building (COCO -> sharded records)
# ----------------------------------------------------------------------------
_C.BUILD_RECORDS = CN()
_C.BUILD_RECORDS.TYPE = "coco_pano"  # "coco_pano" | "coco_det"
# Embed per-instance PNG masks in coco_det records. The reference's det
# builder hardwires include_masks=False (build_coco_det.py:212-236 never
# passes it), leaving its own mask models untrainable from det records;
# defaulting True here is a deliberate usability fix.
_C.BUILD_RECORDS.INCLUDE_MASKS = True
_C.BUILD_RECORDS.ROOT_DIR = ""
_C.BUILD_RECORDS.TRAIN_NUM_SHARDS = 16
_C.BUILD_RECORDS.VAL_NUM_SHARDS = 16

# ----------------------------------------------------------------------------
# Datasets
# ----------------------------------------------------------------------------
_C.DATASETS = CN()
_C.DATASETS.ROOT_DIR = ""
_C.DATASETS.TRAIN = "train"
_C.DATASETS.VAL = "val"
_C.DATASETS.CATEGORY_MAP_NAME = "category_map.json"
# Training input source. The reference always trains from TFRecords
# (reference lib/data/dataloader.py:69-112); this framework also reads COCO
# JSON directly. "auto" = use `<ROOT>/<TRAIN>.record-*` shards when they
# exist (built by build_records.py), else `<ROOT>/<TRAIN>.json`.
_C.DATASETS.TRAIN_FORMAT = "auto"  # auto | coco_json | records
# Precomputed proposal files for RPN-less Fast R-CNN training/eval
# (upstream-D2 DATASETS.PROPOSAL_FILES_*; consumed when MODEL.LOAD_PROPOSALS).
_C.DATASETS.PROPOSAL_FILES_TRAIN = ()
_C.DATASETS.PROPOSAL_FILES_TEST = ()
# Top-k precomputed proposals kept per image (upstream-D2 key names).
_C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 2000
_C.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 1000

# ----------------------------------------------------------------------------
# Evaluation
# ----------------------------------------------------------------------------
_C.EVAL = CN()
_C.EVAL.METRICS = ("coco_detection_metrics",)
_C.EVAL.NUM_EVAL = 5000
_C.EVAL.INCLUDE_METRICS_PER_CATEGORY = False
_C.EVAL.ALL_METRICS_PER_CATEGORY = False
_C.EVAL.MAX_EXAMPLE_TO_DRAW = 100
_C.EVAL.MIN_VISUALIZATION_SCORE_THRESH = 0.5
_C.EVAL.PASCAL_MATCHING_IOU_THRESH = 0.5
# Open-Images group-of box weight for the VOC family (reference
# pascal_voc_evaluator.py group_of_weight): 0 ignores detections matched
# (by IoA) to crowd/group-of boxes; w > 0 grants each matched group-of box
# a fractional-TP pseudo-detection of weight w and counts it as w ground
# truths.
_C.EVAL.PASCAL_GROUP_OF_WEIGHT = 0.0
_C.EVAL.CLASS_AGNOSTIC = False

# ----------------------------------------------------------------------------
# Pretrained weights (foreign-framework import)
# ----------------------------------------------------------------------------
_C.PRETRAINS = CN()
_C.PRETRAINS.ROOT = ""
_C.PRETRAINS.DETECTRON2 = ""
_C.PRETRAINS.ONLY_BACKBONE = False
_C.PRETRAINS.BACKBONE = ""
_C.PRETRAINS.WEIGHTS = ""
_C.PRETRAINS.MMDET = ""
_C.PRETRAINS.DARKNET = ""

# ----------------------------------------------------------------------------
# Input transforms (resize policy)
# ----------------------------------------------------------------------------
_C.TRANSFORM = CN()
_C.TRANSFORM.RESIZE = CN()
_C.TRANSFORM.RESIZE.MIN_SIZE_TRAIN = (800,)
_C.TRANSFORM.RESIZE.MAX_SIZE_TRAIN = 1333
_C.TRANSFORM.RESIZE.MIN_SIZE_TEST = 800  # 0 disables test-time resize
_C.TRANSFORM.RESIZE.MAX_SIZE_TEST = 1333
_C.TRANSFORM.RESIZE.USE_MINI_MASKS = True
_C.TRANSFORM.RESIZE.MINI_MASK_SIZE = 56

# ----------------------------------------------------------------------------
# Augmentations (host-side, numpy)
# ----------------------------------------------------------------------------
_C.AUGMENT = CN()
_C.AUGMENT.HORIZONTAL_FLIP = False
_C.AUGMENT.VERTICAL_FLIP = False
_C.AUGMENT.ROTATE = False
_C.AUGMENT.ROTATE_BOTH_DIRECTION = False

_C.AUGMENT.PIXEL_VALUE_SCALE = CN({"ENABLED": False})
_C.AUGMENT.PIXEL_VALUE_SCALE.MIN_VALUE = 0.9
_C.AUGMENT.PIXEL_VALUE_SCALE.MAX_VALUE = 1.1

_C.AUGMENT.ADJUST_BRIGHTNESS = CN({"ENABLED": False})
_C.AUGMENT.ADJUST_BRIGHTNESS.MAX_DELTA = 0.2

# (sic) key name kept as in the reference schema for YAML compatibility
_C.AUGMENT.ADJUST_CONSTRACT = CN({"ENABLED": False})
_C.AUGMENT.ADJUST_CONSTRACT.MIN_DELTA = 0.8
_C.AUGMENT.ADJUST_CONSTRACT.MAX_DELTA = 1.25

_C.AUGMENT.ADJUST_HUE = CN({"ENABLED": False})
_C.AUGMENT.ADJUST_HUE.MAX_DELTA = 0.02

_C.AUGMENT.ADJUST_SATURATION = CN({"ENABLED": False})
_C.AUGMENT.ADJUST_SATURATION.MIN_DELTA = 0.8
_C.AUGMENT.ADJUST_SATURATION.MAX_DELTA = 1.25

_C.AUGMENT.DISTORT_COLOR = CN({"ENABLED": False})
_C.AUGMENT.DISTORT_COLOR.COLOR_ORDERING = 0

_C.AUGMENT.CROP = CN({"ENABLED": False})
_C.AUGMENT.CROP.MIN_OBJECT_COVERED = 1.0
_C.AUGMENT.CROP.ASPECT_RATIO_RANGE = (0.75, 1.33)
_C.AUGMENT.CROP.AREA_RANGE = (0.1, 1.0)
_C.AUGMENT.CROP.OVERLAP_THRESH = 0.3
_C.AUGMENT.CROP.RANDOM_COEF = 0.0

_C.AUGMENT.JITTER_BOX = CN({"ENABLED": False})
_C.AUGMENT.JITTER_BOX.RATIO = 0.05

# ----------------------------------------------------------------------------
# Dataloader
# ----------------------------------------------------------------------------
_C.DATALOADER = CN()
_C.DATALOADER.NUM_READERS = 4
# The four tf.data streaming knobs below (reference dataloader.py:31,92-111)
# are accepted for YAML compatibility but architecturally SUBSUMED here:
# records are indexed at construction and read by random access, so the
# loader shuffles the FULL epoch order (strictly stronger than any
# streaming shuffle buffer), and parallel batch assembly is governed by
# NUM_READERS + NUM_PREFETCH_BATCHES alone.
_C.DATALOADER.READ_BLOCK_LENGTH = 1
_C.DATALOADER.FILE_READ_BUFFER_SIZE = 8
_C.DATALOADER.SAMPLE_1_OF_N = 1
_C.DATALOADER.SHUFFLE = True
_C.DATALOADER.FILENAME_SHUFFLE_BUFFER_SIZE = 64
_C.DATALOADER.SHUFFLE_BUFFER_SIZE = 16
_C.DATALOADER.NUM_PARALLEL_BATCHES = 4
_C.DATALOADER.NUM_PREFETCH_BATCHES = 2
# TPU addition: route eval input through the native C++ pipeline
# (native/imageio.cpp — fused parallel JPEG decode + resize + pad) when the
# library builds and the dataset is all-JPEG. Decoder output differs from
# cv2 by <= 1 pixel LSB.
_C.DATALOADER.NATIVE_EVAL_IO = True
# TPU addition: fused C++ training input path (per-image random-scale decode
# + resize + flip in one batched GIL-free call; mini-mask targets computed
# without materializing resized full masks). Auto-falls-back to the python
# pipeline when an unsupported augmentation is enabled — see
# data/loader.native_train_loader_usable.
_C.DATALOADER.NATIVE_TRAIN_IO = True
_C.DATALOADER.LOAD_SEMANTIC_MASKS = False

# ----------------------------------------------------------------------------
# Model (top level)
# ----------------------------------------------------------------------------
_C.MODEL = CN()
_C.MODEL.LOAD_PROPOSALS = False
_C.MODEL.MASK_ON = True
# Keypoint head: config-only in the reference (defaults.py:510-540, no
# implementation in its lib/); fully implemented here.
_C.MODEL.KEYPOINT_ON = False
_C.MODEL.META_ARCHITECTURE = "GeneralizedRCNN"
_C.MODEL.INPUT_FORMAT = "BGR"
# ImageNet per-channel mean, RGB order (BGR-flipped at preprocess if needed).
_C.MODEL.PIXEL_MEAN = [123.675, 116.280, 103.530]
# std=1: MSRA/caffe2 weights absorb std into conv1. ImageNet std otherwise.
_C.MODEL.PIXEL_STD = [1.0, 1.0, 1.0]
# TPU addition: computation dtype of the conv trunk ("float32" | "bfloat16").
# Params stay float32; bfloat16 activations feed the MXU at full rate.
_C.MODEL.DTYPE = "float32"

_C.MODEL.SEGMENTATION_OUTPUT = CN()
_C.MODEL.SEGMENTATION_OUTPUT.FORMAT = "conventional"  # raw | fixed | conventional
_C.MODEL.SEGMENTATION_OUTPUT.FIXED_RESOLUTION = 512

# ----------------------------------------------------------------------------
# Backbones
# ----------------------------------------------------------------------------
_C.MODEL.BACKBONE = CN()
_C.MODEL.BACKBONE.NAME = "ResNet"
# Stages <= FREEZE_AT get stop_gradient + frozen norms.
_C.MODEL.BACKBONE.FREEZE_AT = 2

_C.MODEL.RESNETS = CN()
_C.MODEL.RESNETS.DEPTH = 101
# TPU addition: space-to-depth rewrite of the 7x7/2 stem conv (arithmetic-
# exact; opt-in — measured neutral-to-slower on v5e, can win elsewhere).
_C.MODEL.RESNETS.STEM_SPACE_TO_DEPTH = False
# TPU addition: jax.checkpoint each unfrozen residual block — backward
# recomputes block activations instead of storing them (~3x less backbone
# activation HBM for ~33% extra backbone FLOPs); buys a larger train batch.
_C.MODEL.RESNETS.REMAT = False
_C.MODEL.RESNETS.OUT_FEATURES = ["res4"]  # C4: ["res4"]; FPN: res2..res5
_C.MODEL.RESNETS.NUM_GROUPS = 1  # >1 => ResNeXt
_C.MODEL.RESNETS.NORM = "FrozenBN"  # FrozenBN | GN | SyncBN | BN
_C.MODEL.RESNETS.ACTIVATION = "mish"
_C.MODEL.RESNETS.WIDTH_PER_GROUP = 64
_C.MODEL.RESNETS.STRIDE_IN_1X1 = True  # True: MSRA/caffe2; False: torchvision
_C.MODEL.RESNETS.RES5_DILATION = 1  # 2 => DC5 models
_C.MODEL.RESNETS.RES2_OUT_CHANNELS = 256
_C.MODEL.RESNETS.STEM_OUT_CHANNELS = 64
_C.MODEL.RESNETS.DEFORM_ON_PER_STAGE = [False, False, False, False]
_C.MODEL.RESNETS.DEFORM_MODULATED = False
_C.MODEL.RESNETS.DEFORM_NUM_GROUPS = 1

# SpineNet: key-parity only. The reference defines these keys but ships no
# implementation (SURVEY.md §2.4); kept so configs referencing them still load.
_C.MODEL.SPINENETS = CN()
_C.MODEL.SPINENETS.VARIANT = "49"
_C.MODEL.SPINENETS.OUT_FEATURES = ["sp3_2", "sp4_4", "sp5_4", "sp6_2", "sp7_2"]
_C.MODEL.SPINENETS.NORM = "FrozenBN"
_C.MODEL.SPINENETS.STEM_OUT_CHANNELS = 64
_C.MODEL.SPINENETS.L2_OUT_CHANNELS = 64
_C.MODEL.SPINENETS.INIT_BLOCK_TYPE = "bottleneck"
_C.MODEL.SPINENETS.NUM_INIT_BLOCKS = 2
_C.MODEL.SPINENETS.INIT_DROP_CONNECT_RATE = 0.0
_C.MODEL.SPINENETS.ACTIVATION = "swish"

# ----------------------------------------------------------------------------
# Necks
# ----------------------------------------------------------------------------
_C.MODEL.NECK = CN()
_C.MODEL.NECK.NAME = ""  # "" => identity neck
_C.MODEL.NECK.IN_FEATURES = []
_C.MODEL.NECK.OUT_CHANNELS = 256
_C.MODEL.NECK.NORM = ""  # "" | "GN"
_C.MODEL.NECK.ACTIVATION = ""
_C.MODEL.NECK.FUSE_TYPE = "sum"  # sum | avg
_C.MODEL.NECK.TOP_BLOCK_TYPE = "MAXPOOL"  # MAXPOOL | P6P7

# ----------------------------------------------------------------------------
# Proposal generator / anchors
# ----------------------------------------------------------------------------
_C.MODEL.PROPOSAL_GENERATOR = CN()
_C.MODEL.PROPOSAL_GENERATOR.NAME = "RPN"
_C.MODEL.PROPOSAL_GENERATOR.MIN_SIZE = 0

_C.MODEL.ANCHOR_GENERATOR = CN()
_C.MODEL.ANCHOR_GENERATOR.NAME = "DefaultAnchorGenerator"
# SIZES[i] / ASPECT_RATIOS[i] apply to IN_FEATURES[i]; a single entry
# broadcasts over all levels.
_C.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
_C.MODEL.ANCHOR_GENERATOR.ASPECT_RATIOS = [[0.5, 1.0, 2.0]]
# Rotated-anchor angles: upstream-D2 schema compat only. Neither the
# reference nor this framework implements rotated boxes (no consumer of the
# key exists in reference lib/ either).
_C.MODEL.ANCHOR_GENERATOR.ANGLES = [[-90, 0, 90]]

_C.MODEL.RPN = CN()
_C.MODEL.RPN.HEAD_NAME = "StandardRPNHead"
_C.MODEL.RPN.IN_FEATURES = ["res4"]
_C.MODEL.RPN.BOUNDARY_THRESH = -1  # <0 disables boundary pruning
# [BG_IOU, FG_IOU]: IoU < BG => negative, >= FG => positive, else ignored.
_C.MODEL.RPN.IOU_THRESHOLDS = [0.3, 0.7]
_C.MODEL.RPN.IOU_LABELS = [0, -1, 1]
_C.MODEL.RPN.BATCH_SIZE_PER_IMAGE = 256
_C.MODEL.RPN.POSITIVE_FRACTION = 0.5
_C.MODEL.RPN.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
_C.MODEL.RPN.SMOOTH_L1_BETA = 0.0  # 0 => pure L1
_C.MODEL.RPN.LOSS_WEIGHT = 1.0
# pre-NMS topk is per FPN level; post-NMS topk is per image across levels.
_C.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 12000
_C.MODEL.RPN.PRE_NMS_TOPK_TEST = 6000
_C.MODEL.RPN.POST_NMS_TOPK_TRAIN = 2000
_C.MODEL.RPN.POST_NMS_TOPK_TEST = 1000
_C.MODEL.RPN.NMS_THRESH = 0.7

# ----------------------------------------------------------------------------
# ROI heads
# ----------------------------------------------------------------------------
_C.MODEL.ROI_HEADS = CN()
_C.MODEL.ROI_HEADS.NAME = "Res5ROIHeads"
_C.MODEL.ROI_HEADS.NUM_CLASSES = 80
_C.MODEL.ROI_HEADS.IN_FEATURES = ["res4"]
_C.MODEL.ROI_HEADS.IOU_THRESHOLDS = [0.5]
_C.MODEL.ROI_HEADS.IOU_LABELS = [0, 1]
_C.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 512
_C.MODEL.ROI_HEADS.POSITIVE_FRACTION = 0.25
_C.MODEL.ROI_HEADS.PROPOSAL_APPEND_GT = True
_C.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
_C.MODEL.ROI_HEADS.NMS_THRESH_TEST = 0.5
_C.MODEL.ROI_HEADS.NMS_CLS_AGNOSTIC = False

_C.MODEL.ROI_BOX_HEAD = CN()
_C.MODEL.ROI_BOX_HEAD.NAME = ""  # C4 models don't use a named box head
# (dy, dx, dh, dw) normalization; chosen for ~unit-variance targets.
_C.MODEL.ROI_BOX_HEAD.BBOX_REG_WEIGHTS = (10.0, 10.0, 5.0, 5.0)
_C.MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA = 0.0
_C.MODEL.ROI_BOX_HEAD.FOCAL_LOSS_ALPHA = 0.25
_C.MODEL.ROI_BOX_HEAD.FOCAL_LOSS_GAMMA = 2.0
_C.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_BOX_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_BOX_HEAD.POOLER_TYPE = "ROIAlignV2"
_C.MODEL.ROI_BOX_HEAD.NUM_FC = 0
_C.MODEL.ROI_BOX_HEAD.FC_DIM = 1024
_C.MODEL.ROI_BOX_HEAD.NUM_CONV = 0
_C.MODEL.ROI_BOX_HEAD.CONV_DIM = 256
_C.MODEL.ROI_BOX_HEAD.NORM = ""
_C.MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG = False

_C.MODEL.ROI_BOX_RELATION_HEAD = CN()
_C.MODEL.ROI_BOX_RELATION_HEAD.NUM_GROUPS = 16
_C.MODEL.ROI_BOX_RELATION_HEAD.KEY_DIM = 64
_C.MODEL.ROI_BOX_RELATION_HEAD.GEOMETRY_EMBEDDING_DIM = 64
# Learned duplicate removal (Relation Networks' NMS-free inference). The
# reference defines the three tuning keys below but contains no consumer
# (its relation_module.compute_rank_embeddings cannot even run — undefined
# var); here DUPLICATE_REMOVAL_ON (TPU addition) enables the full stage:
# a rank-embedded relation classifier whose sigmoid multiplies the class
# score, trained with one-positive-per-GT BCE at DUPLICATE_REMOVAL_IOU.
_C.MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_ON = False
_C.MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_IOU = 0.5
# Multi-threshold heads (Hu et al. 2018 §4.3 "multiple thresholds"): one
# keep logit per IoU threshold, shared relation features, probabilities
# averaged at inference. A single eta=0.5 head optimizes AP50 at the cost
# of high-IoU AP (measured: bbox AP 54.6 with AP50 94.2 on the overfit
# gate); the ladder recovers the strict-IoU precision. Empty tuple (the
# default, matching the reference's single DUPLICATE_REMOVAL_IOU key and
# keeping old single-head checkpoints loadable — the 'logit' Dense is
# [F, len(ious)]) means use (DUPLICATE_REMOVAL_IOU,) alone; the shipped
# relation config opts into the 5-eta ladder.
_C.MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_IOUS = ()
# How the T threshold heads combine at inference: "mean" (paper §4.3) or
# "max" (keep what any head votes for; duplicates are positive in no head
# so they stay suppressed — fixes the mean rule's AP50 drag from strict-eta
# heads down-scoring loose-but-correct boxes).
_C.MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_COMBINE = "mean"
_C.MODEL.ROI_BOX_RELATION_HEAD.RANK_EMBEDDING_DIM = 128
_C.MODEL.ROI_BOX_RELATION_HEAD.NMS_NUM_GROUP = 16

_C.MODEL.ROI_BOX_CASCADE_HEAD = CN()
# Stage count is the length of these tuples.
_C.MODEL.ROI_BOX_CASCADE_HEAD.BBOX_REG_WEIGHTS = (
    (10.0, 10.0, 5.0, 5.0),
    (20.0, 20.0, 10.0, 10.0),
    (30.0, 30.0, 15.0, 15.0),
)
_C.MODEL.ROI_BOX_CASCADE_HEAD.IOUS = (0.5, 0.6, 0.7)

_C.MODEL.ROI_MASK_HEAD = CN()
_C.MODEL.ROI_MASK_HEAD.NAME = "MaskRCNNConvUpsampleHead"
_C.MODEL.ROI_MASK_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_MASK_HEAD.POOLER_SAMPLING_RATIO = 0
_C.MODEL.ROI_MASK_HEAD.NUM_CONV = 0
_C.MODEL.ROI_MASK_HEAD.CONV_DIM = 256
_C.MODEL.ROI_MASK_HEAD.NORM = ""
_C.MODEL.ROI_MASK_HEAD.CLS_AGNOSTIC_MASK = False
_C.MODEL.ROI_MASK_HEAD.POOLER_TYPE = "ROIAlignV2"

_C.MODEL.ROI_KEYPOINT_HEAD = CN()
_C.MODEL.ROI_KEYPOINT_HEAD.NAME = "KRCNNConvDeconvUpsampleHead"
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_RESOLUTION = 14
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO = 2
_C.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = tuple(512 for _ in range(8))
_C.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS = 17
_C.MODEL.ROI_KEYPOINT_HEAD.MIN_KEYPOINTS_PER_IMAGE = 1
_C.MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS = True
_C.MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT = 1.0
_C.MODEL.ROI_KEYPOINT_HEAD.POOLER_TYPE = "ROIAlignV2"

# ----------------------------------------------------------------------------
# Semantic segmentation / panoptic fusion
# ----------------------------------------------------------------------------
_C.MODEL.SEM_SEG_HEAD = CN()
_C.MODEL.SEM_SEG_HEAD.NAME = "SemSegFPNHead"
_C.MODEL.SEM_SEG_HEAD.IN_FEATURES = ["p2", "p3", "p4", "p5"]
_C.MODEL.SEM_SEG_HEAD.IGNORE_VALUE = -1
_C.MODEL.SEM_SEG_HEAD.NUM_CLASSES = 54
_C.MODEL.SEM_SEG_HEAD.CONVS_DIM = 128
_C.MODEL.SEM_SEG_HEAD.COMMON_STRIDE = 4
_C.MODEL.SEM_SEG_HEAD.NORM = "GN"
_C.MODEL.SEM_SEG_HEAD.LOSS_WEIGHT = 1.0

_C.MODEL.PANOPTIC_FPN = CN()
_C.MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT = 1.0
_C.MODEL.PANOPTIC_FPN.COMBINE = CN({"ENABLED": True})
_C.MODEL.PANOPTIC_FPN.COMBINE.OVERLAP_THRESH = 0.5
_C.MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT = 4096
_C.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.5

# ----------------------------------------------------------------------------
# Single-stage heads
# ----------------------------------------------------------------------------
_C.MODEL.SINGLE_STAGE_HEAD = CN()
_C.MODEL.SINGLE_STAGE_HEAD.NAME = "RetinaNetHead"
_C.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES = 80
_C.MODEL.SINGLE_STAGE_HEAD.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
_C.MODEL.SINGLE_STAGE_HEAD.IOU_THRESHOLDS = [0.4, 0.5]
_C.MODEL.SINGLE_STAGE_HEAD.IOU_LABELS = [0, -1, 1]

_C.MODEL.RETINANET = CN()
_C.MODEL.RETINANET.NUM_CONVS = 4
_C.MODEL.RETINANET.PRIOR_PROB = 0.01
_C.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
_C.MODEL.RETINANET.TOPK_CANDIDATES_TEST = 1000
_C.MODEL.RETINANET.NMS_THRESH_TEST = 0.5
_C.MODEL.RETINANET.NMS_CLS_AGNOSTIC = False
_C.MODEL.RETINANET.BBOX_REG_WEIGHTS = (1.0, 1.0, 1.0, 1.0)
_C.MODEL.RETINANET.FOCAL_LOSS_GAMMA = 2.0
_C.MODEL.RETINANET.FOCAL_LOSS_ALPHA = 0.25
_C.MODEL.RETINANET.SMOOTH_L1_LOSS_BETA = 0.1

_C.MODEL.SOLO = CN()
_C.MODEL.SOLO.MASK_KERNEL_NUM_CONVS = 4
_C.MODEL.SOLO.USE_DEFORM_CONV = False
_C.MODEL.SOLO.DEFORM_MODULATED = False
_C.MODEL.SOLO.MASK_KERNEL_NORM = "GN"
_C.MODEL.SOLO.MASK_KERNEL_SIZE = 1
_C.MODEL.SOLO.MASK_KERNEL_CONVS_DIM = 512
_C.MODEL.SOLO.MASK_FEATURE_IN_FEATURES = ["p2", "p3", "p4", "p5"]
_C.MODEL.SOLO.MASK_FEATURE_CONVS_DIM = 128
_C.MODEL.SOLO.MASK_FEATURE_OUT_DIMS = 256
_C.MODEL.SOLO.MASK_FEATURE_COMMON_STRIDE = 4
_C.MODEL.SOLO.MASK_FEATURE_NORM = "GN"
_C.MODEL.SOLO.SCALE_RANGES = [[1, 96], [48, 192], [96, 384], [192, 768], [384, 2048]]
_C.MODEL.SOLO.NUM_GRIDS = [40, 36, 24, 16, 12]
_C.MODEL.SOLO.PRIOR_PROB = 0.01
_C.MODEL.SOLO.SIGMA = 0.2
_C.MODEL.SOLO.FOCAL_LOSS_GAMMA = 2.0
_C.MODEL.SOLO.FOCAL_LOSS_ALPHA = 0.25
_C.MODEL.SOLO.INS_LOSS_WEIGHT = 3.0
# Instance-mask loss. "dice" is the reference/paper loss (lib/layers/
# loss.py:104-137). Pure dice's gradient dies when the sigmoid saturates —
# training from SCRATCH reliably collapses to all-on/all-off masks (the
# reference has the same property; it only ever trains from pretrained
# backbones). "dice+bce" adds a saturation-safe BCE term that keeps
# gradients alive; use it for from-scratch or synthetic-data training.
_C.MODEL.SOLO.INS_LOSS_TYPE = "dice"  # "dice" | "dice+bce"
_C.MODEL.SOLO.SCORE_THRESH_TEST = 0.1
_C.MODEL.SOLO.UPDATE_SCORE_THRESH_TEST = 0.05
_C.MODEL.SOLO.MASK_THRESH_TEST = 0.5
_C.MODEL.SOLO.TOPK_CANDIDATES_TEST = 500
_C.MODEL.SOLO.NMS_KERNEL = "gaussian"  # gaussian | linear
_C.MODEL.SOLO.NMS_SIGMA = 2.0
_C.MODEL.SOLO.NMS_CLS_AGNOSTIC = False

_C.MODEL.YOLOV4 = CN()
_C.MODEL.YOLOV4.CONV_DIMS = 256
_C.MODEL.YOLOV4.NORM = "BN"
_C.MODEL.YOLOV4.ACTIVATION = "leaky_relu"
_C.MODEL.YOLOV4.SCALE_YX = [1.2, 1.1, 1.05]
_C.MODEL.YOLOV4.CLS_NORMALIZER = 1.0
_C.MODEL.YOLOV4.IOU_NORMALIZER = 0.07
_C.MODEL.YOLOV4.SCORE_THRESH_TEST = 0.05
_C.MODEL.YOLOV4.NMS_THRESH_TEST = 0.5

# ----------------------------------------------------------------------------
# Solver
# ----------------------------------------------------------------------------
_C.SOLVER = CN()
_C.SOLVER.LR_SCHEDULER_NAME = "WarmupMultiStepLR"
# Device/batch topology. NUM_GPUS is kept under its reference name; it means
# "number of data-parallel devices" here (TPU chips or mesh data-axis size).
_C.SOLVER.NUM_GPUS = 8
_C.SOLVER.IMS_PER_GPU = 2
_C.SOLVER.IMS_PER_BATCH = 16
_C.SOLVER.AUTO_SCALE_LR_SCHEDULE = True
_C.SOLVER.IMS_PER_BATCH_BASE = 16
_C.SOLVER.MAX_ITER = 40000
_C.SOLVER.SHORT_TERM_NUM_STEPS = 10000
_C.SOLVER.SHORT_TERM_SAVE_STEPS = 2000
_C.SOLVER.LONG_TERM_SAVE_STEPS = 10000
_C.SOLVER.BASE_LR = 0.001
_C.SOLVER.MOMENTUM = 0.9
_C.SOLVER.WEIGHT_DECAY = 0.0001
_C.SOLVER.WEIGHT_DECAY_NORM = 0.0
_C.SOLVER.GAMMA = 0.1
_C.SOLVER.STEPS = (30000,)
_C.SOLVER.WARMUP_FACTOR = 1.0 / 1000
_C.SOLVER.WARMUP_ITERS = 1000
_C.SOLVER.WARMUP_METHOD = "linear"
_C.SOLVER.CHECKPOINT_PERIOD = 5000
_C.SOLVER.BIAS_LR_FACTOR = 1.0
_C.SOLVER.WEIGHT_DECAY_BIAS = _C.SOLVER.WEIGHT_DECAY
_C.SOLVER.CLIP_GRADIENTS_BY_NORM = 10.0

# ----------------------------------------------------------------------------
# Test-time options
# ----------------------------------------------------------------------------
_C.TEST = CN()
# [[task, metric, value, tolerance], ...]; consumed by evaluation harness.
_C.TEST.EXPECTED_RESULTS = []
_C.TEST.EVAL_PERIOD = 0
_C.TEST.KEYPOINT_OKS_SIGMAS = []
_C.TEST.DETECTIONS_PER_IMAGE = 100
_C.TEST.AUG = CN({"ENABLED": False})
_C.TEST.AUG.MIN_SIZES = (400, 500, 600, 700, 800, 900, 1000, 1100, 1200)
_C.TEST.AUG.MAX_SIZE = 4000
_C.TEST.AUG.FLIP = True
_C.TEST.PRECISE_BN = CN({"ENABLED": False})
_C.TEST.PRECISE_BN.NUM_ITER = 200

# ----------------------------------------------------------------------------
# TPU-specific additions (no reference equivalent)
# ----------------------------------------------------------------------------
# Static input padding: each (H, W) bucket compiles once. Images are resized
# by the reference policy then padded to the smallest bucket that fits.
_C.INPUT = CN()
_C.INPUT.PAD_BUCKETS = ((800, 1344), (1344, 800))
_C.INPUT.SIZE_DIVISIBILITY = 32  # overridden by neck requirements
# Fixed per-image GT capacity (padded; excess instances dropped host-side).
_C.INPUT.MAX_GT_INSTANCES = 100

_C.PARALLEL = CN()
# Mesh axis sizes; -1 means "all remaining devices". Detection convnets are
# data-parallel: the model axis exists for very-large-image spatial sharding.
_C.PARALLEL.DATA_AXIS = -1
_C.PARALLEL.MODEL_AXIS = 1
# Multi-host: when COORDINATOR is set (host:port of process 0), every
# process calls jax.distributed.initialize before touching the backend;
# the mesh then spans all hosts' devices and each process feeds its local
# 1/process_count slice of SOLVER.IMS_PER_BATCH (parallel.shard_batch
# assembles the global batch without cross-host data movement). 0 / -1 =
# auto-detect from the standard JAX env vars / cloud TPU metadata.
_C.PARALLEL.COORDINATOR = ""
_C.PARALLEL.NUM_PROCESSES = 0
_C.PARALLEL.PROCESS_ID = -1

# Upstream-D2 schema escape hatch, kept so zoo YAMLs that poke it still
# merge; intentionally read by nothing.
_C.GLOBAL = CN()
_C.GLOBAL.HACK = 1.0
