"""YOLOv4's darknet converter, ``PRETRAINS.DARKNET``, evaluation and
training from the YAML, against the JAX package.

The converter: a seeded blob read through the manifest of the narrow
``yolov4_D_53_PAN_1x`` model (``test_torch_yolov4.YOLO_NARROW``) gives the
port, tensor for tensor, what the JAX converter gives carried across by
``convert_variables``; the port's ``emit_manifest`` of its model is the JAX
``emit_manifest`` of the JAX variables, node for node. ``PRETRAINS.DARKNET``
loads a blob written from a model's own weights (``write_darknet_weights``,
the converter's inverse) into another, bit for bit. The evaluation runs a
narrow YOLOv4 through ``run_evaluation`` and ``tools.eval`` on synthetic
COCO images (``tools.make_synthetic_coco``), bbox AP only. Training runs:
``losses``, ``build_model(..., training=True)`` and ``tools.train`` from the
YAML (the losses themselves are held against the JAX package in
``test_torch_yolov4_train.py``).
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.convert.darknet import (
    convert_darknet_weights as jax_convert_darknet,
)
from detectron2_tensorflow_tpu.convert.darknet import emit_manifest as jax_emit_manifest
from detectron2_tensorflow_tpu.convert.darknet import read_darknet_blob as jax_read_blob
from detectron2_tensorflow_tpu_torch.config import finalize
from detectron2_tensorflow_tpu_torch.convert import (
    convert_darknet_weights,
    convert_variables,
    darknet_floats,
    emit_manifest,
    read_darknet_blob,
    write_darknet_weights,
)
from detectron2_tensorflow_tpu_torch.data import CocoDataset, build_dataloader
from detectron2_tensorflow_tpu_torch.engine import run_evaluation
from detectron2_tensorflow_tpu_torch.engine.checkpoint import load_pretrained
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import meta_architecture
from detectron2_tensorflow_tpu_torch.tools import eval as tools_eval
from detectron2_tensorflow_tpu_torch.tools import make_synthetic_coco
from detectron2_tensorflow_tpu_torch.tools import train as tools_train
from test_torch_c4 import jax_param_shapes
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)
from test_torch_yolov4 import REPO, YOLO_NARROW, YOLO_YAML, yolo_cfgs

# The synthetic images (240 x 320) resized and padded to a small bucket, and a
# few detection slots, for the CPU.
EVAL_SMALL = {"TRANSFORM.RESIZE.MIN_SIZE_TEST": 128, "TRANSFORM.RESIZE.MAX_SIZE_TEST": 160,
              "INPUT.PAD_BUCKETS": ((128, 160), (160, 128)),
              "MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES": 3, "TEST.DETECTIONS_PER_IMAGE": 20,
              "SOLVER.IMS_PER_GPU": 2}


def manifest_size(manifest) -> int:
    """Floats a blob holds for ``manifest``: each node's biases, its norm's
    three vectors and its weights."""
    norms = manifest["norm"]
    return sum(n["out_channels"] * (4 if n["name"] in norms else 1)
               + n["in_channels"] * n["out_channels"] * n["size"] ** 2
               for n in manifest["nodes"])


def write_blob(path, floats: np.ndarray) -> None:
    """A darknet ``.weights`` file: major, minor, revision (int32), seen
    (int64), then the floats."""
    with open(path, "wb") as f:
        np.asarray([0, 2, 5], np.int32).tofile(f)
        np.asarray([32013312], np.int64).tofile(f)
        floats.astype(np.float32).tofile(f)


@pytest.fixture(scope="module")
def narrow():
    """The narrow YOLOv4: the JAX variables' shapes and manifest, the port's
    model on the meta device and its manifest."""
    jcfg, tcfg = yolo_cfgs()
    variables = jax_param_shapes(jcfg)
    with torch.device("meta"):
        model = meta_architecture(tcfg)(tcfg)
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, jmanifest=jax_emit_manifest(variables),
                manifest=emit_manifest(model), model=model)


def test_emit_manifest_matches_jax(narrow):
    """Node for node (paths, channels, kernel sizes, in the JAX walk's order)
    and the norm map: the trunk's FrozenBN nodes ``frozen``, the neck's and
    the head's 3x3 convs ``bn``, the predictors none."""
    got, want = narrow["manifest"], narrow["jmanifest"]
    assert got["nodes"] == want["nodes"]
    assert got["norm"] == want["norm"]
    assert got["nodes"][0]["name"] == "backbone/res1/block_1/conv1"
    assert got["norm"]["backbone/stem"] == "frozen" and got["norm"]["neck/spp_conv1"] == "bn"
    assert "head/pred1" not in got["norm"] and got["norm"]["head/conv1"] == "bn"
    assert len(got["nodes"]) == len(list(narrow["model"].named_modules())) - sum(
        not isinstance(m, torch.nn.Conv2d) for m in narrow["model"].modules())


def test_darknet_converter_matches_jax(narrow):
    """A seeded blob through both converters: the port's state dict equals
    ``convert_variables`` of the JAX tree, bit for bit, covering every
    tensor of the model; both consume the whole blob."""
    manifest = narrow["jmanifest"]
    n = manifest_size(manifest)
    blob = np.random.default_rng(3).normal(0, 1, n).astype(np.float32)
    got, used = convert_darknet_weights(blob, manifest)
    jtree, jused = jax_convert_darknet(blob, manifest)
    want = convert_variables(jtree)
    assert used == jused == n
    assert sorted(got) == sorted(want) == sorted(narrow["model"].state_dict())
    for k, v in want.items():
        assert got[k].dtype == torch.float32 and torch.equal(got[k], v), k
    first = manifest["nodes"][0]
    k = first["out_channels"]  # the first node's biases, then its norm's gamma
    name = "backbone.bottom_up.res1.block_1.conv1"
    np.testing.assert_array_equal(got[f"{name}.norm.bias"].numpy(), blob[:k])
    np.testing.assert_array_equal(got[f"{name}.norm.weight"].numpy(), blob[k:2 * k])


def test_darknet_floats_invert_the_converter(narrow):
    """``darknet_floats`` of the converter's output is the blob again."""
    manifest = narrow["jmanifest"]
    blob = np.random.default_rng(4).normal(0, 1, manifest_size(manifest)).astype(np.float32)
    converted, _ = convert_darknet_weights(blob, manifest)
    np.testing.assert_array_equal(darknet_floats(converted, manifest), blob)


def test_read_darknet_blob_skips_the_header(tmp_path):
    floats = np.arange(7, dtype=np.float32)
    write_blob(tmp_path / "w.weights", floats)
    got = read_darknet_blob(str(tmp_path / "w.weights"))
    np.testing.assert_array_equal(got, floats)
    np.testing.assert_array_equal(got, jax_read_blob(str(tmp_path / "w.weights")))
    assert len(read_darknet_blob(str(tmp_path / "w.weights"), skip_header=False)) == 12


@pytest.mark.parametrize("case", ["exhausted", "unknown_norm"])
def test_darknet_converter_raises_as_jax_does(narrow, case):
    """A blob one float short, or a norm the converter does not know: both
    converters refuse it."""
    manifest = json.loads(json.dumps(narrow["jmanifest"]))
    blob = np.zeros(manifest_size(manifest), np.float32)
    if case == "exhausted":
        blob, match = blob[:-1], "exhausted"
    else:
        manifest["norm"]["head/conv2"] = "gn"
        match = "unknown manifest norm 'gn' at head/conv2"
    with pytest.raises(ValueError, match=match):
        convert_darknet_weights(blob, manifest)
    with pytest.raises((AssertionError, ValueError), match=match):
        jax_convert_darknet(blob, manifest)


def test_load_pretrained_darknet(tmp_path, caplog):
    """``PRETRAINS.DARKNET`` with the YAML's paths under ``PRETRAINS.ROOT``:
    a missing blob is skipped with the warning (and so is the YAML's
    missing ``WEIGHTS``); a blob and its ``.json`` manifest there load into
    the model, every tensor bit for bit."""
    _, tcfg = yolo_cfgs()
    tcfg.PRETRAINS.ROOT = str(tmp_path)
    model = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(5))
    with caplog.at_level(logging.WARNING):
        assert load_pretrained(tcfg, model) is False
    assert "coco_object_detection/yolov4.ckpt not found" in caplog.text
    assert "darknet/yolov4.weights not found" in caplog.text

    source = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(6))
    manifest = emit_manifest(source)
    (tmp_path / "darknet").mkdir()
    write_darknet_weights(str(tmp_path / "darknet" / "yolov4.weights"), source.state_dict(),
                          manifest)
    assert load_pretrained(tcfg, model) is True
    want = source.state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


# -- evaluation ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def coco_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("yolo_coco")
    make_synthetic_coco.main([str(root), "2", "3"])
    return root


def test_run_evaluation_reports_bbox_ap_only(coco_root):
    """A narrow YOLOv4 through ``run_evaluation`` on 3 synthetic images: the
    bbox metrics and no segm (the model predicts no masks)."""
    _, cfg = yolo_cfgs(**EVAL_SMALL)
    finalize(cfg, training=False, device="cpu")
    ds = CocoDataset(os.path.join(coco_root, "val.json"), os.path.join(coco_root, "val"))
    model = build_model(cfg, device="cpu")
    metrics = run_evaluation(cfg, model, ds, lambda: build_dataloader(cfg, ds, training=False))
    assert "bbox/AP" in metrics and "bbox/AP50" in metrics
    assert not any(k.startswith(("segm", "keypoints")) for k in metrics), sorted(metrics)
    assert all(0.0 <= metrics[k] <= 100.0 or np.isnan(metrics[k]) for k in metrics), metrics


def test_tools_eval_loads_the_darknet_blob(coco_root, tmp_path, caplog):
    """``tools.eval --config_file`` the YOLO YAML at narrow widths: no
    checkpoint, so ``PRETRAINS.DARKNET`` (a blob and manifest written from
    a seeded model) gives the weights; the bbox metrics come out."""
    _, tcfg = yolo_cfgs(**EVAL_SMALL)
    source = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(7))
    (tmp_path / "darknet").mkdir()
    write_darknet_weights(str(tmp_path / "darknet" / "yolov4.weights"), source.state_dict(),
                          emit_manifest(source))
    opts = [str(x) for kv in {**YOLO_NARROW, **EVAL_SMALL}.items() for x in kv]
    with caplog.at_level(logging.INFO):
        metrics = tools_eval.main(["--device", "cpu", "--config_file",
                                   os.path.join(REPO, YOLO_YAML),
                                   "DATASETS.ROOT_DIR", str(coco_root), "PRETRAINS.ROOT",
                                   str(tmp_path), "LOGS.ROOT_DIR", str(tmp_path / "logs"),
                                   *opts])
    assert "initializing from darknet weights" in caplog.text
    assert "bbox/AP" in metrics and not any(k.startswith("segm") for k in metrics)


# -- training ------------------------------------------------------------------------------

# The synthetic training images at the small bucket, two a step.
TRAIN_SMALL = {"TRANSFORM.RESIZE.MIN_SIZE_TRAIN": (128,), "TRANSFORM.RESIZE.MAX_SIZE_TRAIN": 160,
               "SOLVER.IMS_PER_BATCH": 2, "INPUT.MAX_GT_INSTANCES": 8}


def test_yolov4_training_raises_by_name(coco_root, tmp_path):
    """YOLOv4 trains: ``build_model(..., training=True)`` builds, ``losses``
    gives finite ``box_loss``, ``conf_loss`` and ``cls_loss`` (crowd slots
    included), and ``tools.train --config_file`` the YOLO YAML takes 2 steps
    on the CPU from synthetic COCO images at narrow widths, writing its
    checkpoint and its summary."""
    _, tcfg = yolo_cfgs()
    model = build_model(tcfg, device="cpu", training=True, init="jax")
    assert model.training
    rng = np.random.default_rng(0)
    boxes = np.zeros((2, 3, 4), np.float32)
    boxes[..., :2] = rng.uniform(0, 80, (2, 3, 2))
    boxes[..., 2:] = boxes[..., :2] + rng.uniform(10, 40, (2, 3, 2))
    batch = {"image": torch.from_numpy(rng.uniform(0, 255, (2, 128, 160, 3)).astype(np.float32)),
             "image_size": torch.tensor([[128, 160], [128, 150]]),
             "gt_boxes": torch.from_numpy(boxes), "gt_classes": torch.tensor([[0, 1, 3], [2, 2, 0]]),
             "gt_valid": torch.tensor([[True, True, False], [True, True, True]]),
             "gt_is_crowd": torch.tensor([[False, False, False], [False, True, False]])}
    losses = model.losses(batch)
    assert set(losses) == {"box_loss", "conf_loss", "cls_loss"}
    assert all(bool(torch.isfinite(v)) and float(v.detach()) > 0 for v in losses.values())
    sum(losses.values()).backward()
    opts = [str(x) for kv in {**YOLO_NARROW, **EVAL_SMALL, **TRAIN_SMALL}.items() for x in kv]
    summary = tools_train.main(["--device", "cpu", "--max_iter", "2", "--config_file",
                                os.path.join(REPO, YOLO_YAML), "DATASETS.ROOT_DIR",
                                str(coco_root), "LOGS.ROOT_DIR", str(tmp_path), *opts])
    assert summary["steps"] == 2 and summary["step"] == 2
    assert set(summary["final_losses"]) == {"total_loss", "box_loss", "conf_loss", "cls_loss"}
    assert all(np.isfinite(v) for v in summary["final_losses"].values())
    assert summary["launches"] == {k: 0 for k in summary["launches"]}
    assert os.listdir(summary["checkpoint_dir"])
