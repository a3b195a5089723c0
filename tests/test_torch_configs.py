"""The port's config system against the JAX package's: its YAML reader
against PyYAML's loader on every file in ``configs/``, every file merged into
the full default tree, the ``CfgNode`` rules (one case for each test of
``tests/test_config.py`` that holds them), ``dump`` and ``finalize``.

PyYAML is imported here only, to hold the port's standard-library reader
against it. Every file in ``configs/`` merges in the JAX package (its
upstream-key shim reads the ``quick_schedules`` and ``PascalVOC`` files too),
so each must merge in the port, to the same tree.
"""

import glob
import os

import pytest
import yaml

from detectron2_tensorflow_tpu.config import CfgNode as JaxCfgNode
from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.config.config import _RestrictedEvalLoader
from detectron2_tensorflow_tpu.config.finalize import finalize as jax_finalize
from detectron2_tensorflow_tpu_torch.config import CfgNode, finalize, get_cfg
from detectron2_tensorflow_tpu_torch.config import yaml_subset
from test_torch_config import PORT_ONLY_DEFAULTS, assert_same_tree, jax_flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(os.path.relpath(p, REPO) for p in
                 glob.glob(os.path.join(REPO, "configs", "**", "*.yaml"), recursive=True))


def test_every_config_file_is_listed():
    assert len(CONFIGS) == 79


@pytest.mark.parametrize("path", CONFIGS)
def test_yaml_reader_matches_pyyaml(path):
    """The same value, types included, as the JAX package's loader."""
    with open(os.path.join(REPO, path)) as f:
        want = yaml.load(f, Loader=_RestrictedEvalLoader)
    got = yaml_subset.load_file(os.path.join(REPO, path))
    assert got == want and repr(got) == repr(want)


@pytest.mark.parametrize("path", CONFIGS)
def test_config_merges_like_jax(path):
    full = os.path.join(REPO, path)
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    try:
        jcfg.merge_from_file(full)
    except Exception as e:  # noqa: BLE001 — the port must fail alike
        with pytest.raises(type(e)):
            tcfg.merge_from_file(full)
        return
    tcfg.merge_from_file(full)
    assert_same_tree(jcfg, tcfg)


def test_defaults_match_jax_key_by_key():
    assert_same_tree(jax_get_cfg(), get_cfg())


@pytest.mark.parametrize("text", [
    "A: 1e-4\nB: 1.0e-4\nC: 1.0e4\nD: 010\nE: 0x1F\nF: .5\nG: ~\nH:\nI: yes\n",
    'A: "x\\ty \\u00e9"\nB: \'it\'\'s\'\nC: [1, [2, "3"], ]\nD: a#b # note\nE: -.inf\n',
    "A:\n  B:\n    C: (1,\n       2)\n  D: [\n    [1, 2],\n    [3]\n  ]\nE: off\n",
    "# only a comment\n",
])
def test_yaml_reader_matches_pyyaml_on_scalar_forms(text):
    want = yaml.load(text, Loader=_RestrictedEvalLoader)
    got = yaml_subset.load(text)
    assert repr(got) == repr(want)


@pytest.mark.parametrize("text,line", [
    ("A: 1\nB:\n  - x\n", 3),
    ("A: &anchor 1\n", 1),
    ("A: {B: 1}\n", 1),
    ("A: |\n  text\n", 1),
    ("A: !!python/object/apply:os.system ['true']\n", 1),
    ("A: [1, 2\n", 1),
    ("A: 2001-12-14\n", 1),
])
def test_yaml_reader_rejects_what_it_does_not_read(text, line):
    with pytest.raises(yaml_subset.YamlError, match=f"f.yaml:{line}:"):
        yaml_subset.load(text, "f.yaml")


# -- tests/test_config.py, case by case -------------------------------------

def test_freeze_blocks_mutation():
    cfg = get_cfg()
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.MODEL.MASK_ON = False
    cfg.COMPUTED_NUM_CLASSES = 80  # insert-only even when frozen
    assert cfg.COMPUTED_NUM_CLASSES == 80
    with pytest.raises(KeyError):
        cfg.COMPUTED_NUM_CLASSES = 81
    cfg.defrost()
    cfg.MODEL.MASK_ON = False
    assert cfg.MODEL.MASK_ON is False


def test_merge_from_list_type_checks():
    cfg, jcfg = get_cfg(), jax_get_cfg()
    opts = ["MODEL.RESNETS.DEPTH", "50", "MODEL.MASK_ON", "False",
            "SOLVER.BASE_LR", "2", "MODEL.PIXEL_STD", "(57.0, 57.0, 58.0)"]
    cfg.merge_from_list(opts)
    jcfg.merge_from_list(opts)
    assert cfg.MODEL.RESNETS.DEPTH == 50 and cfg.MODEL.MASK_ON is False
    assert cfg.SOLVER.BASE_LR == 2.0 and type(cfg.SOLVER.BASE_LR) is float
    assert_same_tree(jcfg, cfg)
    with pytest.raises(KeyError):
        cfg.merge_from_list(["MODEL.NO_SUCH_KEY", "1"])
    with pytest.raises(ValueError):
        cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "'a string'"])
    with pytest.raises(ValueError):
        cfg.merge_from_list(["MODEL.RESNETS.DEPTH"])
    cfg.freeze()
    with pytest.raises(AttributeError):
        cfg.merge_from_list(["MODEL.RESNETS.DEPTH", "101"])


def test_merge_rejects_unknown_keys():
    cfg = get_cfg()
    with pytest.raises(KeyError):
        cfg.merge_from_other_cfg(CfgNode({"MODEL": {"TYPO_KEY": 1}}))
    with pytest.raises(ValueError):
        cfg.merge_from_other_cfg(CfgNode({"MODEL": {"MASK_ON": {"A": 1}}}))


def test_base_inheritance(tmp_path):
    base = tmp_path / "base.yaml"
    base.write_text("MODEL:\n  MASK_ON: false\n  RESNETS:\n    DEPTH: 50\n")
    child = tmp_path / "child.yaml"
    child.write_text('_BASE_: "base.yaml"\nMODEL:\n  RESNETS:\n    DEPTH: 101\n')
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_file(str(child))
    jcfg.merge_from_file(str(child))
    assert cfg.MODEL.MASK_ON is False  # from the base
    assert cfg.MODEL.RESNETS.DEPTH == 101  # overridden by the child
    assert_same_tree(jcfg, cfg)


def test_tuple_list_coercion():
    cfg = get_cfg()
    cfg.merge_from_list(["TRANSFORM.RESIZE.MIN_SIZE_TRAIN", "(640, 672, 704)"])
    assert cfg.TRANSFORM.RESIZE.MIN_SIZE_TRAIN == (640, 672, 704)
    cfg.merge_from_list(["MODEL.RESNETS.OUT_FEATURES", "('res4',)"])
    assert cfg.MODEL.RESNETS.OUT_FEATURES == ["res4"]


def test_restricted_eval_tag(tmp_path):
    f = tmp_path / "evaltag.yaml"
    f.write_text(
        "MODEL:\n  ANCHOR_GENERATOR:\n"
        '    SIZES: !!python/object/apply:eval ["[[x, x * 2] for x in [32, 64]]"]\n'
    )
    cfg = get_cfg()
    cfg.merge_from_file(str(f))
    assert cfg.MODEL.ANCHOR_GENERATOR.SIZES == [[32, 64], [64, 128]]


def test_eval_tag_cannot_reach_builtins(tmp_path):
    f = tmp_path / "evil.yaml"
    f.write_text('SEED: !!python/object/apply:eval ["__import__(\'os\').getpid()"]\n')
    with pytest.raises(NameError):
        get_cfg().merge_from_file(str(f))


def test_upstream_alias_shim(tmp_path):
    y = tmp_path / "d2.yaml"
    y.write_text(
        'MODEL:\n'
        '  WEIGHTS: "detectron2://COCO/mask_rcnn/137849600/model_final.pkl"\n'
        'INPUT:\n'
        '  MIN_SIZE_TRAIN: (600,)\n'
        '  MAX_SIZE_TEST: 1000\n'
        'DATASETS:\n'
        '  TRAIN: ("coco_2017_val",)\n'
        '  TEST: ("coco_2017_val_100",)\n'
        'DATALOADER:\n'
        '  NUM_WORKERS: 2\n'
        'SOLVER:\n'
        '  CHECKPOINT_PERIOD: 300\n'
    )
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_file(str(y))
    jcfg.merge_from_file(str(y))
    assert cfg.PRETRAINS.DETECTRON2 == "COCO/mask_rcnn/137849600/model_final.pkl"
    assert cfg.TRANSFORM.RESIZE.MIN_SIZE_TRAIN == (600,)
    assert cfg.TRANSFORM.RESIZE.MAX_SIZE_TEST == 1000
    assert (cfg.DATASETS.TRAIN, cfg.DATASETS.VAL) == ("coco_2017_val", "coco_2017_val_100")
    assert cfg.DATALOADER.NUM_READERS == 2 and cfg.SOLVER.SHORT_TERM_SAVE_STEPS == 300
    assert_same_tree(jcfg, cfg)

    y2 = tmp_path / "bb.yaml"
    y2.write_text('MODEL:\n  WEIGHTS: "detectron2://ImageNetPretrained/MSRA/R-50.pkl"\n')
    cfg = get_cfg()
    cfg.merge_from_file(str(y2))
    assert cfg.PRETRAINS.BACKBONE == "ImageNetPretrained/MSRA/R-50.pkl"
    assert cfg.PRETRAINS.DETECTRON2 == ""


# -- dump, clone, finalize ----------------------------------------------------

def test_dump_reads_back_to_the_same_tree():
    """``dump`` of a merged tree loads (with PyYAML or the port's reader) to
    what the JAX package's ``dump`` loads to."""
    path = os.path.join(REPO, "configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml")
    cfg, jcfg = get_cfg(), jax_get_cfg()
    cfg.merge_from_file(path)
    jcfg.merge_from_file(path)
    jcfg.LOGS.COMPILATION_CACHE_DIR = PORT_ONLY_DEFAULTS["LOGS.COMPILATION_CACHE_DIR"]
    text = cfg.dump()
    assert yaml.safe_load(text) == yaml.safe_load(jcfg.dump())
    assert yaml_subset.load(text) == yaml.safe_load(text)


def test_clone_is_independent():
    cfg = get_cfg()
    other = cfg.clone()
    other.MODEL.RESNETS.DEPTH = 50
    assert cfg.MODEL.RESNETS.DEPTH == 101


@pytest.mark.parametrize("path", [None, "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml"])
def test_finalize_matches_jax_on_one_device(path, monkeypatch):
    import jax

    monkeypatch.setattr(jax, "device_count", lambda *a: 1)
    cfg, jcfg = get_cfg(), jax_get_cfg()
    if path:
        cfg.merge_from_file(os.path.join(REPO, path))
        jcfg.merge_from_file(os.path.join(REPO, path))
    jcfg.LOGS.COMPILATION_CACHE_DIR = ""  # no XLA cache directory made here
    jax_finalize(jcfg)
    assert finalize(cfg, device="cpu") is cfg
    assert cfg.is_frozen() and cfg.MODEL.is_frozen()
    assert cfg.SOLVER.NUM_GPUS == 1 and cfg.SOLVER.IMS_PER_BATCH == cfg.SOLVER.IMS_PER_GPU
    assert jax_flatten(jcfg) == dict(cfg.flatten())


def test_finalize_reads_the_category_map(tmp_path):
    (tmp_path / "category_map.json").write_text('{"thing_classes": ["a", "b", "c"]}')
    cfg = get_cfg()
    cfg.DATASETS.ROOT_DIR = str(tmp_path)
    finalize(cfg, device="cpu")
    assert cfg.MODEL.ROI_HEADS.NUM_CLASSES == 3 and cfg.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES == 3


def test_finalize_on_the_card_needs_one():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        finalize(get_cfg())


def test_jax_cfgnode_and_port_cfgnode_agree_on_construction():
    tree = {"A": {"B": (1, 2), "C": "x"}, "D": 1.5}
    assert jax_flatten(JaxCfgNode(tree)) == dict(CfgNode(tree).flatten())
    with pytest.raises(ValueError):
        CfgNode({"A": object()})


# -- the models a config builds -------------------------------------------------

# The files whose model the port has (Faster, Mask, Cascade Mask and Fast
# R-CNN on FPN, C4 and DC5 trunks: R50, R101, X101, the class-agnostic heads,
# GN and SyncBN, the R18-GN overfit config; the RPN-only ProposalNetwork;
# RetinaNet; Keypoint R-CNN; PanopticFPN and the SemanticSegmentor, the R18-GN
# panoptic overfit config; the deformable trunks of the four Misc dconv
# files; SOLOv2; YOLOv4's CSP-DarkNet53 and SPP/PAN neck; Relation Networks'
# RelationROIHeads); every other file must
# raise NotImplementedError on a key the port does not read yet, never build
# while ignoring one.
BUILDS = {
    "configs/Base-RetinaNet.yaml",
    "configs/COCO-Detection/retinanet_R_101_FPN_3x.yaml",
    "configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml",
    "configs/COCO-Detection/retinanet_R_50_FPN_3x.yaml",
    "configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml",
    "configs/Misc/cascade_mask_rcnn_R_50_FPN_3x.yaml",
    "configs/Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml",
    "configs/Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml",
    "configs/Misc/mask_rcnn_R_50_FPN_3x_dconv_c3-c5.yaml",
    "configs/Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml",
    "configs/Base-RCNN-C4.yaml",
    "configs/Base-RCNN-DilatedC5.yaml",
    "configs/Base-RCNN-FPN.yaml",
    "configs/COCO-Detection/faster_rcnn_R_101_C4_3x.yaml",
    "configs/COCO-Detection/faster_rcnn_R_101_DC5_3x.yaml",
    "configs/COCO-Detection/faster_rcnn_R_101_FPN_3x.yaml",
    "configs/COCO-Detection/faster_rcnn_R_50_C4_1x.yaml",
    "configs/COCO-Detection/faster_rcnn_R_50_C4_3x.yaml",
    "configs/COCO-Detection/faster_rcnn_R_50_DC5_1x.yaml",
    "configs/COCO-Detection/faster_rcnn_R_50_DC5_3x.yaml",
    "configs/COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml",
    "configs/COCO-Detection/faster_rcnn_R_50_FPN_3x.yaml",
    "configs/COCO-Detection/faster_rcnn_X_101_32x8d_FPN_3x.yaml",
    "configs/COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml",
    "configs/COCO-Detection/rpn_R_50_C4_1x.yaml",
    "configs/COCO-Detection/rpn_R_50_FPN_1x.yaml",
    "configs/Misc/mask_rcnn_R_50_FPN_3x_gn.yaml",
    "configs/Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml",
    "configs/Misc/scratch_mask_rcnn_R_50_FPN_3x_gn.yaml",
    "configs/quick_schedules/fast_rcnn_R_50_FPN_inference_acc_test.yaml",
    "configs/quick_schedules/fast_rcnn_R_50_FPN_instant_test.yaml",
    "configs/quick_schedules/rpn_R_50_FPN_inference_acc_test.yaml",
    "configs/quick_schedules/rpn_R_50_FPN_instant_test.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_101_C4_3x.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_101_DC5_3x.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_3x.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_DC5_1x.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_DC5_3x.yaml",
    "configs/PascalVOC-Detection/faster_rcnn_R_50_C4.yaml",
    "configs/PascalVOC-Detection/faster_rcnn_R_50_FPN.yaml",
    "configs/quick_schedules/mask_rcnn_R_50_C4_inference_acc_test.yaml",
    "configs/quick_schedules/mask_rcnn_R_50_C4_instant_test.yaml",
    "configs/quick_schedules/mask_rcnn_R_50_C4_training_acc_test.yaml",
    "configs/quick_schedules/mask_rcnn_R_50_DC5_inference_acc_test.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_101_FPN_1x.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_101_FPN_3x.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_3x.yaml",
    "configs/COCO-InstanceSegmentation/mask_rcnn_X_101_32x8d_FPN_3x.yaml",
    "configs/Misc/mask_rcnn_R_50_FPN_1x_cls_agnostic.yaml",
    "configs/quick_schedules/mask_rcnn_R_50_FPN_inference_acc_test.yaml",
    "configs/quick_schedules/mask_rcnn_R_50_FPN_instant_test.yaml",
    "configs/quick_schedules/mask_rcnn_R_50_FPN_training_acc_test.yaml",
    "configs/synthetic/overfit_mask_rcnn_R_18.yaml",
    "configs/COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml",
    "configs/COCO-Keypoints/keypoint_rcnn_R_50_FPN_3x.yaml",
    "configs/quick_schedules/keypoint_rcnn_R_50_FPN_inference_acc_test.yaml",
    "configs/quick_schedules/keypoint_rcnn_R_50_FPN_instant_test.yaml",
    "configs/quick_schedules/keypoint_rcnn_R_50_FPN_normalized_training_acc_test.yaml",
    "configs/quick_schedules/keypoint_rcnn_R_50_FPN_training_acc_test.yaml",
    "configs/COCO-PanopticSegmentation/Base-Panoptic-FPN.yaml",
    "configs/COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml",
    "configs/COCO-PanopticSegmentation/panoptic_fpn_R_50_3x.yaml",
    "configs/COCO-PanopticSegmentation/panoptic_fpn_R_101_3x.yaml",
    "configs/COCO-SemanticSegmentation/semantic_R_50_FPN_1x.yaml",
    "configs/quick_schedules/panoptic_fpn_R_50_inference_acc_test.yaml",
    "configs/quick_schedules/panoptic_fpn_R_50_instant_test.yaml",
    "configs/quick_schedules/panoptic_fpn_R_50_training_acc_test.yaml",
    "configs/quick_schedules/semantic_R_50_FPN_inference_acc_test.yaml",
    "configs/quick_schedules/semantic_R_50_FPN_instant_test.yaml",
    "configs/quick_schedules/semantic_R_50_FPN_training_acc_test.yaml",
    "configs/synthetic/overfit_panoptic_R_18.yaml",
    "configs/Base-SOLO.yaml",
    "configs/COCO-InstanceSegmentation/solo_v2_R_50_FPN_1x.yaml",
    "configs/Base-YOLO.yaml",
    "configs/COCO-Detection/yolov4_D_53_PAN_1x.yaml",
    "configs/Misc/relation_rcnn_R_50_FPN_1x.yaml",
}


def _meta_model(cfg):
    import torch

    from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import meta_architecture

    with torch.device("meta"):
        return meta_architecture(cfg)(cfg)


@pytest.mark.parametrize("path", CONFIGS)
def test_config_builds_or_raises(path):
    """Each file's model (built on the meta device, so without memory)."""
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, path))
    if path in BUILDS:
        model = _meta_model(cfg)
        assert sum(p.numel() for p in model.parameters()) > 1e7
    else:
        with pytest.raises(NotImplementedError):
            _meta_model(cfg)


@pytest.mark.parametrize("opts,match", [
    (["MODEL.BACKBONE.NAME", "'SpineNet'"], "SpineNet"),
    (["MODEL.RESNETS.STEM_SPACE_TO_DEPTH", "True"], "STEM_SPACE_TO_DEPTH"),
    # REMAT is ported: the model builds, its stages after FREEZE_AT recomputing.
    pytest.param(["MODEL.RESNETS.REMAT", "True"], None, id="opts2-REMAT"),
    # Deformable stages are ported on bottleneck trunks; a basic-block trunk raises.
    (["MODEL.RESNETS.DEFORM_ON_PER_STAGE", "[False, True, True, True]",
      "MODEL.RESNETS.DEPTH", "18", "MODEL.RESNETS.RES2_OUT_CHANNELS", "64"], "DEFORM"),
    (["MODEL.PROPOSAL_GENERATOR.NAME", "'PrecomputedProposals'"], "PROPOSAL_GENERATOR"),
    (["MODEL.ROI_BOX_HEAD.NAME", "'Other'"], "ROI_BOX_HEAD"),
    (["MODEL.ROI_MASK_HEAD.NAME", "'Other'"], "ROI_MASK_HEAD"),
    (["MODEL.KEYPOINT_ON", "True", "MODEL.ROI_KEYPOINT_HEAD.NAME", "'Other'"],
     "ROI_KEYPOINT_HEAD"),
])
def test_unported_model_keys_raise(opts, match):
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, "configs/COCO-InstanceSegmentation/"
                                           "mask_rcnn_R_50_FPN_1x.yaml"))
    cfg.merge_from_list(opts)
    if match is None:
        from detectron2_tensorflow_tpu_torch.models.backbones.resnet import RematStage

        trunk = _meta_model(cfg).backbone.bottom_up
        assert [isinstance(getattr(trunk, s), RematStage) for s in trunk.stage_names] == [
            False, True, True, True]
        return
    with pytest.raises(NotImplementedError, match=match):
        _meta_model(cfg)


SOLO_YAML = "configs/COCO-InstanceSegmentation/solo_v2_R_50_FPN_1x.yaml"


def test_solo_mask_kernel_size_raises_and_fails_in_jax():
    """``MODEL.SOLO.MASK_KERNEL_SIZE`` 3: the kernel head would emit 9 x 256
    channels for a dynamic conv that is a 1x1 product over 256, so the
    port's model raises by name, and the JAX model's ``predict`` fails on
    the shapes (abstractly evaluated: no compile)."""
    import jax
    import jax.numpy as jnp

    from detectron2_tensorflow_tpu.models import build_model as jax_build_model

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, SOLO_YAML))
    cfg.MODEL.SOLO.MASK_KERNEL_SIZE = 3
    with pytest.raises(NotImplementedError, match="MASK_KERNEL_SIZE"):
        _meta_model(cfg)
    jcfg = jax_get_cfg()
    jcfg.merge_from_file(os.path.join(REPO, SOLO_YAML))
    jcfg.MODEL.SOLO.MASK_KERNEL_SIZE = 3
    jmodel = jax_build_model(jcfg)
    batch = {"image": jnp.zeros((1, 64, 64, 3)), "image_size": jnp.asarray([[64, 64]])}
    variables = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0), batch)
    with pytest.raises(ValueError, match="2304"):
        jax.eval_shape(jmodel.predict, variables, batch)


def test_solo_full_frame_masks_raise_in_the_loader_and_fail_in_jax():
    """The SOLO YAMLs set ``TRANSFORM.RESIZE.USE_MINI_MASKS False``, which
    keeps full-frame masks; both loaders collate ``gt_masks`` as mini-masks,
    the only targets SOLOv2's loss reads. The port's loader raises a
    ``ValueError`` naming the key (training and evaluation), the JAX
    loader's collation fails on a broadcast; with the key True both give
    56 x 56 mini-masks."""
    import numpy as np

    from detectron2_tensorflow_tpu.data.loader import pad_sample_to_batch_arrays as jax_pad
    from detectron2_tensorflow_tpu_torch.data import SyntheticDataset, build_dataloader
    from detectron2_tensorflow_tpu_torch.data import transforms

    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, SOLO_YAML))
    assert cfg.TRANSFORM.RESIZE.USE_MINI_MASKS is False
    r = cfg.TRANSFORM.RESIZE
    r.MIN_SIZE_TRAIN, r.MAX_SIZE_TRAIN, r.MIN_SIZE_TEST, r.MAX_SIZE_TEST = (128,), 256, 128, 256
    cfg.INPUT.PAD_BUCKETS = ((128, 256), (256, 128))
    cfg.SOLVER.IMS_PER_BATCH = 2
    ds = SyntheticDataset(n=2, h=194, w=306, num_classes=3, box_range=(30, 70))
    for training in (True, False):
        with pytest.raises(ValueError, match="TRANSFORM.RESIZE.USE_MINI_MASKS"):
            next(build_dataloader(cfg, ds, training=training))
    sample, _ = transforms.run(cfg, ds[0], True, np.random.default_rng(0))
    assert sample["masks"].shape[1:] == (128, 202)
    with pytest.raises(ValueError, match="broadcast"):
        jax_pad(sample, (128, 256), cfg.INPUT.MAX_GT_INSTANCES, r.MINI_MASK_SIZE)
    r.USE_MINI_MASKS = True
    batch = next(build_dataloader(cfg, ds, training=True))
    assert batch["gt_masks"].shape == (2, cfg.INPUT.MAX_GT_INSTANCES, 56, 56)
