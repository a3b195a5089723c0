"""ImageNet trunks through ``PRETRAINS.BACKBONE``: the port's converters and
``load_pretrained`` against the JAX package's, and the ``quick_schedules``
YAMLs that name such a trunk training through ``tools.train``.

The checkpoints are written to ``tmp_path`` from a seeded numpy generator in
the public files' layouts: an MSRA/caffe2 pickle (``R-50.pkl``:
``{"blobs": {"conv1_w", "res_conv1_bn_s", "res2_0_branch2a_w", ...}}``,
each BN folded into ``_bn_s`` / ``_bn_b``, with the ``fc1000`` classifier,
``_momentum`` blobs and blobs no model has) and a torchvision ``resnet``
``state_dict`` (``conv1``, ``bn1``, ``layer{L}.{b}.conv{i}`` / ``bn{i}`` /
``downsample``, ``fc``, ``num_batches_tracked``), bare or under an mmdet
checkpoint's ``backbone.`` prefix. The converted tensors, the leftover
lists and the loaded models' weights are bit-equal to the JAX package's
(through ``convert_variables``); the trunk's features from those weights
agree to FEATURE_RTOL (float32 convolutions summed in other orders).
"""

import glob
import logging
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.convert.backbone import (
    convert_caffe2_backbone as jax_convert_caffe2,
    load_caffe2_pickle as jax_load_caffe2,
)
from detectron2_tensorflow_tpu.convert.d2 import load_state_dict as jax_load_state_dict
from detectron2_tensorflow_tpu.convert.torchvision import (
    convert_torchvision_backbone as jax_convert_torchvision,
)
from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.engine.checkpoint import load_pretrained as jax_load_pretrained
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts, _RCNNDrivers
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import (
    convert_caffe2_backbone,
    convert_torchvision_backbone,
    convert_variables,
    load_caffe2_pickle,
    load_state_dict,
)
from detectron2_tensorflow_tpu_torch.data import write_proposal_file
from detectron2_tensorflow_tpu_torch.engine import load_pretrained
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import meta_architecture
from detectron2_tensorflow_tpu_torch.tools import make_synthetic_coco
from detectron2_tensorflow_tpu_torch.tools import train as tools_train
from test_torch_cli import _with_keypoints
from test_torch_config import NARROW, _set, narrow_cfgs
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FEATURE_RTOL = 1e-5
FPN_YAML = "configs/COCO-Detection/faster_rcnn_R_50_FPN_1x.yaml"
C4_YAML = "configs/COCO-Detection/faster_rcnn_R_50_C4_1x.yaml"
H, W = 128, 160
# The quick_schedules YAMLs whose MODEL.WEIGHTS is an ImageNet trunk
# (PRETRAINS.BACKBONE after the config reader's alias).
QUICK = sorted(os.path.relpath(p, REPO)
               for p in glob.glob(os.path.join(REPO, "configs/quick_schedules/*.yaml"))
               if "ImageNetPretrained" in open(p).read())
CAFFE2_BRANCH = {"conv1": "branch2a", "conv2": "branch2b", "conv3": "branch2c",
                 "shortcut": "branch1"}
# Blobs of a real MSRA pickle that no model has; "lr" and the bias are left over.
CAFFE2_EXTRAS = ("fc1000_w", "fc1000_b", "pred_b", "lr", "res2_0_branch2a_b")


def trunk_convs(cfg):
    """``{module: kernel shape}`` of the port trunk's convs (``stem.conv1``,
    ``res2.0.conv1``, ...) for ``cfg``, from a model on the meta device."""
    with torch.device("meta"):
        model = meta_architecture(cfg)(cfg)
    prefix = next(n for n, m in model.named_modules() if m is model.trunk) + "."
    return {k[len(prefix):-len(".weight")]: tuple(v.shape)
            for k, v in model.state_dict().items()
            if k.startswith(prefix) and k.endswith(".weight") and ".norm." not in k}


def conv_and_scale(rng, module, shape):
    """He-scaled kernel and a FrozenBN scale that keeps activations near 1
    (the stem's 1/640, a block's last 0.2, as ``test_torch_slice.tame_variables``)."""
    w = rng.standard_normal(shape) * np.sqrt(2.0 / np.prod(shape[1:]))
    s = rng.uniform(0.5, 1.5, shape[0])
    if module == "stem.conv1":
        s = s / 640
    elif module.endswith(("conv2", "conv3")):  # a basic or a bottleneck block's last
        s = s * 0.2
    return w.astype(np.float32), s.astype(np.float32)


def caffe2_blobs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    blobs = {}
    for module, shape in trunk_convs(cfg).items():
        if module == "stem.conv1":
            conv, bn = "conv1", "res_conv1_bn"
        else:
            stage, block, name = module.split(".")
            conv = f"{stage}_{block}_{CAFFE2_BRANCH[name]}"
            bn = conv + "_bn"
        w, s = conv_and_scale(rng, module, shape)
        blobs[conv + "_w"] = w
        blobs[bn + "_s"] = s
        blobs[bn + "_b"] = (rng.standard_normal(shape[0]) * 0.1).astype(np.float32)
        blobs[conv + "_w_momentum"] = np.zeros_like(w)
    for name in CAFFE2_EXTRAS:
        blobs[name] = rng.standard_normal(4).astype(np.float32)
    return blobs


def write_caffe2_pickle(path, cfg, seed=0):
    with open(path, "wb") as f:
        pickle.dump({"blobs": caffe2_blobs(cfg, seed)}, f)
    return str(path)


def torchvision_state_dict(cfg, seed=0, prefix=""):
    rng = np.random.default_rng(seed)
    sd = {}
    for module, shape in trunk_convs(cfg).items():
        if module == "stem.conv1":
            conv, bn = "conv1", "bn1"
        else:
            stage, block, name = module.split(".")
            layer = f"layer{int(stage[3:]) - 1}.{block}"
            conv, bn = ((f"{layer}.downsample.0", f"{layer}.downsample.1")
                        if name == "shortcut" else (f"{layer}.{name}", f"{layer}.bn{name[-1]}"))
        w, s = conv_and_scale(rng, module, shape)
        n = shape[0]
        sd[f"{conv}.weight"] = w
        sd[f"{bn}.weight"] = s
        sd[f"{bn}.bias"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
        sd[f"{bn}.running_mean"] = (rng.standard_normal(n) * 0.1).astype(np.float32)
        sd[f"{bn}.running_var"] = rng.uniform(0.5, 2.0, n).astype(np.float32)
        sd[f"{bn}.num_batches_tracked"] = np.array(7)
    sd["fc.weight"] = rng.standard_normal((10, 4)).astype(np.float32)
    sd["fc.bias"] = rng.standard_normal(10).astype(np.float32)
    return {prefix + k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}


def write_torchvision_pth(path, cfg, seed=0, prefix=""):
    sd = torchvision_state_dict(cfg, seed, prefix)
    if prefix:  # an mmdet checkpoint: the model's other parts beside the trunk
        sd["neck.lateral_convs.0.conv.weight"] = torch.zeros(4, 4, 1, 1)
    torch.save({"state_dict": sd} if prefix else sd, path)
    return str(path)


def assert_tensors_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype == torch.float32, k
        assert torch.equal(got[k], v), k


# -- the converters -------------------------------------------------------------

@pytest.mark.parametrize("depth", [50, 18])
def test_caffe2_converter_matches_jax(tmp_path, depth):
    _, tcfg = narrow_cfgs(**{"MODEL.RESNETS.DEPTH": depth})
    path = write_caffe2_pickle(tmp_path / "R.pkl", tcfg)
    blobs = load_caffe2_pickle(path)
    assert not any(k.endswith("_momentum") for k in blobs)
    got, leftovers = convert_caffe2_backbone(blobs)
    tree, jax_leftovers = jax_convert_caffe2(jax_load_caffe2(path))
    assert leftovers == jax_leftovers == ["lr", "res2_0_branch2a_b"]
    assert_tensors_equal(got, convert_variables(tree))
    moved, _ = convert_caffe2_backbone(blobs, "backbone.bottom_up")
    assert list(moved) == ["backbone.bottom_up." + k[len("backbone."):] for k in got]
    np.testing.assert_array_equal(got["backbone.stem.conv1.norm.running_var"].numpy(),
                                  np.float32(1) - np.float32(1e-5))


@pytest.mark.parametrize("depth", [50, 18])
@pytest.mark.parametrize("prefix", ["", "backbone."])
def test_torchvision_converter_matches_jax(tmp_path, depth, prefix):
    """A bare torchvision ``state_dict`` and an mmdet checkpoint's trunk
    (``prefix``); R18's basic blocks have no ``conv3``."""
    _, tcfg = narrow_cfgs(**{"MODEL.RESNETS.DEPTH": depth})
    path = write_torchvision_pth(tmp_path / "r.pth", tcfg, prefix=prefix)
    got, leftovers = convert_torchvision_backbone(load_state_dict(path), prefix)
    tree, jax_leftovers = jax_convert_torchvision(jax_load_state_dict(path), prefix)
    assert leftovers == jax_leftovers == (["neck.lateral_convs.0.conv.weight"] if prefix else [])
    assert_tensors_equal(got, convert_variables(tree))
    assert any(".conv3." in k for k in got) == (depth == 50)


# -- load_pretrained and the trunk's forward ------------------------------------------

def yaml_cfgs(path, **overrides):
    """(JAX cfg, port cfg): the YAML at narrow widths (``NARROW``), float32."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(os.path.join(REPO, path))
        for key, value in {**NARROW, **overrides}.items():
            _set(cfg, key, value)
    return jcfg, tcfg


def jax_and_port_models(jcfg, tcfg):
    """The JAX model's tamed initial variables, and the port's model built
    from them."""
    rng = np.random.default_rng(0)
    image = rng.uniform(0, 255, (2, H, W, 3)).astype(np.float32)
    batch = {"image": jnp.asarray(image), "image_size": jnp.asarray([[H, W], [112, 150]])}
    jmodel = jax_build_model(jcfg)
    variables = jax.tree_util.tree_map(
        np.array, jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch))
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    return jmodel, variables, tmodel, batch, torch.from_numpy(image)


def features_close(jcfg, variables, batch, tmodel, timage):
    jfeats = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg)).features_only(variables, batch, False)
    with torch.no_grad():
        tfeats = tmodel.features(timage)
    assert set(tfeats) == set(jfeats)
    for k, want in jfeats.items():
        want = np.asarray(want)
        got = tfeats[k].permute(0, 2, 3, 1).numpy()  # NCHW -> the JAX NHWC
        np.testing.assert_allclose(got, want, rtol=FEATURE_RTOL,
                                   atol=FEATURE_RTOL * np.abs(want).max(), err_msg=k)
        assert np.abs(want).max() > 1e-3, k


@pytest.mark.parametrize("arch,source", [
    ("fpn", "caffe2"), ("c4", "caffe2"), ("fpn", "torchvision"),
])
def test_load_pretrained_backbone_matches_jax(tmp_path, caplog, arch, source):
    """``load_pretrained`` overlays the trunk as the JAX package's does (a C4
    model has no ``res5`` in its trunk: both skip those blobs with a
    warning), and the features of the loaded models agree."""
    overrides = {"PRETRAINS.ROOT": str(tmp_path)}
    if source == "torchvision":
        overrides.update({"MODEL.RESNETS.STRIDE_IN_1X1": False, "MODEL.INPUT_FORMAT": "RGB",
                          "MODEL.PIXEL_STD": (58.395, 57.120, 57.375)})
    jcfg, tcfg = yaml_cfgs(C4_YAML if arch == "c4" else FPN_YAML, **overrides)
    name = "R-50.pkl" if source == "caffe2" else "resnet50.pth"
    _, r50 = yaml_cfgs(FPN_YAML)  # the whole ResNet-50, res5 included
    (write_caffe2_pickle if source == "caffe2" else write_torchvision_pth)(
        tmp_path / name, r50, seed=3)
    jcfg.PRETRAINS.BACKBONE = tcfg.PRETRAINS.BACKBONE = name
    jmodel, variables, tmodel, batch, timage = jax_and_port_models(jcfg, tcfg)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        jloaded = jax_load_pretrained(jcfg, jmodel, variables)
        jax_warnings = [r.getMessage() for r in caplog.records]
        caplog.clear()
        assert load_pretrained(tcfg, tmodel)
        port_warnings = [r.getMessage() for r in caplog.records]
    want = convert_variables(jax.tree_util.tree_map(np.asarray, jloaded))
    assert_tensors_equal(tmodel.state_dict(), {k: want.get(k, before[k]) for k in before})
    trunk = "backbone." if arch == "c4" else "backbone.bottom_up."
    changed = {k for k, v in tmodel.state_dict().items() if not torch.equal(v, before[k])}
    assert changed and all(k.startswith(trunk) for k in changed)
    # The JAX package warns once for the res5 subtree, the port for each tensor.
    jax_skipped = [m.split()[2] for m in jax_warnings if "not in model" in m]
    skipped = [m.split()[2] for m in port_warnings if "not in model" in m]
    assert jax_skipped == (["params/backbone/res5", "frozen/backbone/res5"] if arch == "c4" else [])
    assert all(s.startswith("backbone.res5.") for s in skipped) and bool(skipped) == (arch == "c4")
    features_close(jcfg, jloaded, batch, tmodel, timage)


def test_missing_backbone_file_warns_and_keeps_the_init(tmp_path, caplog):
    """Both packages warn that the file is missing and leave the model at its
    initial weights."""
    jcfg, tcfg = narrow_cfgs(**{"PRETRAINS.ROOT": str(tmp_path),
                                "PRETRAINS.BACKBONE": "ImageNetPretrained/MSRA/R-50.pkl"})
    jmodel, variables, tmodel, _, _ = jax_and_port_models(jcfg, tcfg)
    before = {k: v.clone() for k, v in tmodel.state_dict().items()}
    with caplog.at_level(logging.WARNING):
        assert jax_load_pretrained(jcfg, jmodel, variables) is variables
        assert not load_pretrained(tcfg, tmodel)
    messages = [r.getMessage() for r in caplog.records]
    assert len(messages) == 2 and all("R-50.pkl not found" in m for m in messages)
    assert_tensors_equal(tmodel.state_dict(), before)


# -- the quick_schedules YAMLs ----------------------------------------------------------

QUICK_NARROW = ["MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
                "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.NECK.OUT_CHANNELS", "32",
                "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_MASK_HEAD.CONV_DIM", "32",
                "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS", "(32, 32)",
                "MODEL.SEM_SEG_HEAD.CONVS_DIM", "32", "MODEL.DTYPE", "float32",
                "SOLVER.IMS_PER_GPU", "2", "DATALOADER.NUM_READERS", "1",
                "INPUT.PAD_BUCKETS", "((160, 224), (224, 160))",
                "TRANSFORM.RESIZE.MIN_SIZE_TRAIN", "(160,)",
                "TRANSFORM.RESIZE.MAX_SIZE_TRAIN", "224",
                "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "200", "MODEL.RPN.POST_NMS_TOPK_TRAIN", "100",
                "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "64",
                "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", "100",
                "DATASETS.TRAIN", "train", "DATASETS.VAL", "val"]


@pytest.fixture(scope="module")
def synthetic_roots(tmp_path_factory):
    """A synthetic COCO directory with proposal files, its copy with
    keypoints, and a COCO-panoptic one (2 training images each)."""
    base = tmp_path_factory.mktemp("quick")
    det = base / "det"
    make_synthetic_coco.main([str(det), "2", "1"])
    write_proposal_file(str(det / "train.json"), str(det / "train_proposals.pkl"), 0)
    pano = base / "pano"
    make_synthetic_coco.main([str(pano), "2", "1", "--panoptic"])
    return {"det": det, "kp": _with_keypoints(det, base / "kp"), "pano": pano}


def test_quick_schedules_name_imagenet_trunks():
    assert len(QUICK) == 13


@pytest.mark.parametrize("path", QUICK)
def test_quick_schedule_trains_without_its_backbone_file(path, synthetic_roots, tmp_path,
                                                         caplog):
    """The YAML's ``MODEL.WEIGHTS`` became ``PRETRAINS.BACKBONE``; its file is
    not there, so ``tools.train`` warns and trains from the model's own
    initialization, as the JAX package's ``train.py`` does. (The panoptic
    base YAML also names a Detectron2 checkpoint, which comes first.)"""
    text = open(os.path.join(REPO, path)).read()
    cfg = get_cfg()
    cfg.merge_from_file(os.path.join(REPO, path))
    assert cfg.PRETRAINS.BACKBONE == "ImageNetPretrained/MSRA/R-50.pkl"
    first = next(cfg.PRETRAINS[k] for k in ("WEIGHTS", "DETECTRON2", "BACKBONE")
                 if cfg.PRETRAINS[k])
    kind = ("pano" if "panoptic" in path or "semantic" in path
            else "kp" if "KEYPOINT_ON: True" in text else "det")
    opts = ["--config_file", os.path.join(REPO, path), "--device", "cpu", "--max_iter", "1",
            *QUICK_NARROW, "DATASETS.ROOT_DIR", str(synthetic_roots[kind]),
            "LOGS.ROOT_DIR", str(tmp_path / "logs"), "PRETRAINS.ROOT", str(tmp_path)]
    if "fast_rcnn" in path:
        opts += ["DATASETS.PROPOSAL_FILES_TRAIN", "('train_proposals.pkl',)"]
    with caplog.at_level(logging.WARNING):
        summary = tools_train.main(opts)
    assert f"{first} not found" in caplog.text
    assert summary["steps"] == 1
    assert all(np.isfinite(v) for v in summary["final_losses"].values())
