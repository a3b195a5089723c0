"""SOLOv2's outputs downstream, against the JAX package: the serving formats
of ``detector_postprocess`` (``raw``, ``fixed``, ``conventional``, for an
R-CNN's box crops and SOLOv2's whole frames), the evaluator's full-frame
route (the ported ``tests/test_solo_mask_eval.py``), the mmdet converter
(the ported ``tests/test_convert_solo.py`` and the SOLO case of
``tests/test_convert_numeric.py``), ``PRETRAINS.MMDET`` and the loop
(``train`` and ``run_evaluation``) at narrow widths.

Masks are compared exactly (uint8); the converter's tensors bit for bit;
the numeric converter check 1e-4, as the JAX test holds it.
"""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.convert.solo import convert_solo_weights as jax_convert_solo
from detectron2_tensorflow_tpu.engine.evaluator import evaluate as jax_evaluate
from detectron2_tensorflow_tpu.evaluation.np_masks import (
    fullframe_masks_to_image as jax_fullframe,
)
from detectron2_tensorflow_tpu.models.meta_arch.postprocess import (
    detector_postprocess as jax_postprocess,
)
from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import convert_solo_weights, convert_variables
from detectron2_tensorflow_tpu_torch.data import SyntheticDataset, build_dataloader
from detectron2_tensorflow_tpu_torch.engine import run_evaluation, train
from detectron2_tensorflow_tpu_torch.engine.checkpoint import load_pretrained
from detectron2_tensorflow_tpu_torch.engine.evaluator import evaluate
from detectron2_tensorflow_tpu_torch.evaluation.np_masks import (
    fullframe_masks_to_image,
    paste_masks,
)
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.meta_arch.postprocess import detector_postprocess
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import meta_architecture
from detectron2_tensorflow_tpu_torch.models.single_stage.solov2 import SOLOv2
from detectron2_tensorflow_tpu_torch.structures import Instances
from test_convert_numeric import small_solo_cfg, torch_mmdet_solov2_forward
from test_convert_solo import synth_mmdet_solov2_state
from test_torch_c4 import REPO
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

SOLO_YAML = "configs/COCO-InstanceSegmentation/solo_v2_R_50_FPN_1x.yaml"
FPN_YAML = "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml"
BOX = (8.0, 16.0, 40.0, 48.0)  # xyxy inside a 64x64 image


def both_cfgs(path=None, **overrides):
    """(JAX cfg, port cfg): the default tree (or ``path``'s YAML) with
    ``overrides`` (dotted keys)."""
    out = []
    for cfg in (jax_get_cfg(), get_cfg()):
        if path:
            cfg.merge_from_file(os.path.join(REPO, path))
        for key, value in overrides.items():
            *parents, leaf = key.split(".")
            node = cfg
            for p in parents:
                node = getattr(node, p)
            setattr(node, leaf, value)
        out.append(cfg)
    return tuple(out)


def solo_stub_cfgs():
    """The JAX test's ``_solo_cfg`` on both packages."""
    return both_cfgs(**{"MODEL.META_ARCHITECTURE": "SingleStageDetector",
                        "MODEL.SINGLE_STAGE_HEAD.NAME": "SOLOv2Head",
                        "MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES": 3,
                        "TRANSFORM.RESIZE.MIN_SIZE_TEST": 64,
                        "TRANSFORM.RESIZE.MAX_SIZE_TEST": 64,
                        "TEST.DETECTIONS_PER_IMAGE": 4})


# -- the evaluator's full-frame route (tests/test_solo_mask_eval.py) -----------------------

class RectDataset:
    """One 64x64 image with one GT box and its mask."""

    def __init__(self):
        mask = np.zeros((64, 64), np.float32)
        x0, y0, x1, y1 = map(int, BOX)
        mask[y0:y1, x0:x1] = 1
        self._sample = {"image": np.zeros((64, 64, 3), np.uint8), "image_id": 0,
                        "boxes": np.array([BOX], np.float32),
                        "classes": np.array([0], np.int32), "is_crowd": np.zeros(1, bool),
                        "masks": mask[None]}
        self.images = [({"id": 0, "file_name": "0.jpg"}, [])]

    def __len__(self):
        return 1

    def __getitem__(self, i):
        return dict(self._sample)


def stub_frame():
    """The GT box's full frame at stride 4 (16 x 16)."""
    frame = np.zeros((16, 16), bool)
    x0, y0, x1, y1 = (int(v / 4) for v in BOX)
    frame[y0:y1, x0:x1] = True
    return frame


class JaxStubSolo:
    def predict(self, variables, batch):
        return JaxInstances(boxes=jnp.asarray([[BOX]], jnp.float32), scores=jnp.asarray([[0.9]]),
                            pred_classes=jnp.asarray([[0]], jnp.int32),
                            pred_masks=jnp.asarray(stub_frame()[None, None]),
                            is_valid=jnp.asarray([[True]]))


class PortStubSolo(torch.nn.Module):
    """The port-side stub: the GT box and its frame, as bool masks."""

    def __init__(self):
        super().__init__()
        self.anchor = torch.nn.Parameter(torch.zeros(1))

    def predict(self, batch):
        return Instances(boxes=torch.tensor([[BOX]]), scores=torch.tensor([[0.9]]),
                         pred_classes=torch.tensor([[0]]),
                         pred_masks=torch.from_numpy(stub_frame()[None, None]),
                         is_valid=torch.tensor([[True]]))


def stub_batch():
    return {"image": np.zeros((1, 64, 64, 3), np.float32),
            "image_size": np.asarray([[64, 64]], np.int32), "image_id": np.asarray([0])}


def test_solov2_mask_eval_routes_fullframe():
    """A prediction equal to the GT: bbox and segm AP 100 on both packages
    (a box paste of the frame would squash it into the box)."""
    jcfg, tcfg = solo_stub_cfgs()
    want = jax_evaluate(jcfg, JaxStubSolo(), {}, RectDataset(),
                        [{k: jnp.asarray(v) for k, v in stub_batch().items()}])
    got = evaluate(tcfg, PortStubSolo(), RectDataset(), [stub_batch()])
    assert got["bbox/AP"] == want["bbox/AP"] == 100.0
    assert got["segm/AP"] == want["segm/AP"] == 100.0, (got, want)


def test_detector_postprocess_fullframe_formats():
    """The stub's frame: ``conventional`` (64 x 64) and ``fixed`` (32 x 32)
    as the JAX test pins them, and equal to the JAX package's."""
    jcfg, tcfg = solo_stub_cfgs()
    det = PortStubSolo().predict(None)
    jdet = JaxStubSolo().predict({}, None)
    batch = stub_batch()
    for cfg in (jcfg, tcfg):
        cfg.MODEL.SEGMENTATION_OUTPUT.FIXED_RESOLUTION = 32
    for fmt, size in (("conventional", 64), ("fixed", 32)):
        jcfg.MODEL.SEGMENTATION_OUTPUT.FORMAT = tcfg.MODEL.SEGMENTATION_OUTPUT.FORMAT = fmt
        got = detector_postprocess(tcfg, det, {k: torch.from_numpy(v) for k, v in
                                               batch.items()}).pred_masks.numpy()
        want = np.asarray(jax_postprocess(jcfg, jdet, {k: jnp.asarray(v) for k, v in
                                                       batch.items()}).pred_masks)
        assert got.shape == want.shape == (1, 1, size, size) and got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)
    m = got[0, 0]
    assert m[16, 12] == 1 and m[2, 2] == 0


def test_fullframe_helper_matches_direct_upsample():
    frame = np.zeros((2, 16, 16), np.float32)
    frame[:, 4:12, 2:10] = 1
    out = fullframe_masks_to_image(frame, 64, 64, 64, 64, stride=4)
    assert out.shape == (2, 64, 64)
    assert out[0, 20:44, 12:36].all()
    assert not out[0, :12].any() and not out[0, :, 44:].any()
    np.testing.assert_array_equal(out, jax_fullframe(frame, 64, 64, 64, 64, stride=4))
    # The R-CNN route (a box paste of a full frame) would not reproduce the GT.
    pasted = paste_masks(frame, np.array([[8, 16, 40, 48]] * 2, np.float32), 64, 64)
    gt = np.zeros((64, 64), bool)
    gt[16:48, 8:40] = True
    assert (pasted[0] & gt).sum() / max((pasted[0] | gt).sum(), 1) < 0.5


# -- detector_postprocess, every format -----------------------------------------------------

def postprocess_pair(jcfg, tcfg, det, batch):
    got = detector_postprocess(tcfg, Instances(**{k: torch.from_numpy(v) for k, v in
                                                  det.items()}),
                               {k: torch.from_numpy(v) for k, v in batch.items()})
    want = jax_postprocess(jcfg, JaxInstances(**{k: jnp.asarray(v) for k, v in det.items()}),
                           {k: jnp.asarray(v) for k, v in batch.items()})
    return got.pred_masks.numpy(), np.asarray(want.pred_masks)


@pytest.mark.parametrize("fmt", ["raw", "fixed", "conventional"])
def test_detector_postprocess_rcnn_matches_jax(fmt):
    """Box crops ``[B, D, 28, 28]`` of soft masks: binarized where they are
    (``raw``), pasted at their boxes into the input canvas
    (``conventional``) or at boxes scaled to the 40 x 40 ``fixed`` canvas by
    each image's true size."""
    jcfg, tcfg = both_cfgs(FPN_YAML, **{"MODEL.SEGMENTATION_OUTPUT.FORMAT": fmt,
                                        "MODEL.SEGMENTATION_OUTPUT.FIXED_RESOLUTION": 40})
    rng = np.random.default_rng(0)
    xy = rng.uniform(0, 90, (2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (2, 6, 2))], -1).astype(np.float32)
    det = {"boxes": boxes, "pred_masks": rng.uniform(0, 1, (2, 6, 28, 28)).astype(np.float32)}
    batch = {"image": np.zeros((2, 128, 160, 3), np.float32),
             "image_size": np.array([[128, 160], [112, 150]], np.int32)}
    got, want = postprocess_pair(jcfg, tcfg, det, batch)
    size = {"raw": 28, "fixed": 40, "conventional": None}[fmt]
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape
    assert got.shape[2:] == ((size, size) if size else (128, 160))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 100


@pytest.mark.parametrize("fmt", ["raw", "fixed", "conventional"])
def test_detector_postprocess_solov2_matches_jax(fmt):
    """Whole frames ``[B, D, 32, 40]`` (bool, random rectangles): ``raw`` as
    they are, ``conventional`` resized to the 128 x 160 canvas, ``fixed``
    sampled over each image's content region at 24 x 24 cells."""
    jcfg, tcfg = both_cfgs(SOLO_YAML, **{"MODEL.SEGMENTATION_OUTPUT.FORMAT": fmt,
                                         "MODEL.SEGMENTATION_OUTPUT.FIXED_RESOLUTION": 24})
    rng = np.random.default_rng(1)
    frames = np.zeros((2, 5, 32, 40), bool)
    for i in range(2):
        for j in range(5):
            y0, x0 = rng.integers(0, 24), rng.integers(0, 30)
            frames[i, j, y0:y0 + rng.integers(2, 9), x0:x0 + rng.integers(2, 11)] = True
    det = {"boxes": np.zeros((2, 5, 4), np.float32), "pred_masks": frames}
    batch = {"image": np.zeros((2, 128, 160, 3), np.float32),
             "image_size": np.array([[128, 160], [101, 137]], np.int32)}
    got, want = postprocess_pair(jcfg, tcfg, det, batch)
    size = {"raw": (32, 40), "fixed": (24, 24), "conventional": (128, 160)}[fmt]
    assert got.dtype == want.dtype == np.uint8 and got.shape == want.shape == (2, 5) + size
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 50


def test_detector_postprocess_unknown_format_raises():
    _, tcfg = both_cfgs(SOLO_YAML, **{"MODEL.SEGMENTATION_OUTPUT.FORMAT": "other"})
    det = Instances(boxes=torch.zeros((1, 1, 4)), pred_masks=torch.zeros((1, 1, 4, 4), dtype=bool))
    with pytest.raises(ValueError, match="other"):
        detector_postprocess(tcfg, det, {"image": torch.zeros((1, 16, 16, 3)),
                                         "image_size": torch.tensor([[16, 16]])})


# -- the mmdet converter (tests/test_convert_solo.py, tests/test_convert_numeric.py) ---------

def solo_yaml_cfgs():
    return both_cfgs(SOLO_YAML, **{"MODEL.RESNETS.DEPTH": 50})


def test_convert_solo_matches_the_jax_converter_and_leaves_nothing():
    """The port's ``convert_solo_weights`` on the synthetic mmdet SOLOv2-R50
    state dict equals ``convert_variables`` of the JAX converter's tree, key
    for key and bit for bit, leaves no leftovers, and loads strictly into
    the port's model (every tensor, shapes included)."""
    jcfg, tcfg = solo_yaml_cfgs()
    sd = synth_mmdet_solov2_state(jcfg, np.random.default_rng(0))
    tree, j_left = jax_convert_solo(sd, jcfg)
    got, left = convert_solo_weights(sd, tcfg)
    assert left == j_left == []
    want = convert_variables(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    with torch.device("meta"):
        model = meta_architecture(tcfg)(tcfg)
    shapes = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert set(got) == set(shapes) and all(tuple(got[k].shape) == s for k, s in shapes.items())
    assert shapes["head.kernel_tower_0.weight"][1] == 258 and shapes["head.cate_tower_0.weight"][1] == 256
    assert shapes["head.mask_p5_0.weight"][1] == 258


def test_convert_solo_reports_leftovers():
    _, tcfg = solo_yaml_cfgs()
    sd = synth_mmdet_solov2_state(tcfg, np.random.default_rng(0))
    sd["bbox_head.extra.weight"] = np.zeros(3, np.float32)
    sd["fc.weight"] = np.zeros(3, np.float32)  # the classifier: dropped silently
    _, left = convert_solo_weights(sd, tcfg)
    assert left == ["bbox_head.extra.weight"]


def test_convert_solo_numeric_vs_torch_mmdet_head():
    """The converted head against mmdet's forward transcribed in torch from
    the checkpoint's own names (``test_convert_numeric.py``), at identity
    grid sizes (feature == grid), 1e-4."""
    jcfg = small_solo_cfg()
    tcfg = get_cfg()
    tcfg.merge_from_file(os.path.join(REPO, SOLO_YAML))
    tcfg.MODEL.RESNETS.DEPTH = 50
    tcfg.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES = 4
    s = tcfg.MODEL.SOLO
    s.MASK_KERNEL_NUM_CONVS, s.MASK_KERNEL_CONVS_DIM = 2, 64
    s.MASK_FEATURE_CONVS_DIM, s.MASK_FEATURE_OUT_DIMS, s.MASK_KERNEL_SIZE = 32, 32, 1
    s.NUM_GRIDS = [16, 8, 4, 2, 1]
    rng = np.random.default_rng(11)
    sd = synth_mmdet_solov2_state(jcfg, rng)
    sd = {k: v * 0.1 if k.endswith(".weight") and v.ndim == 4 else v for k, v in sd.items()}
    converted, left = convert_solo_weights(sd, tcfg)
    assert left == []
    head = SOLOv2(tcfg).build_head(tcfg, 256)
    head.load_state_dict({k[len("head."):]: v for k, v in converted.items()
                          if k.startswith("head.")})
    sizes = {"p2": 16, "p3": 8, "p4": 4, "p5": 2, "p6": 1}
    feats = {f: torch.from_numpy(rng.standard_normal((1, 256, n, n)).astype(np.float32))
             for f, n in sizes.items()}
    with torch.no_grad():
        cate, kern, mask = head(feats)
        want_cate, want_kern, want_mask = torch_mmdet_solov2_forward(sd, feats, jcfg)
    for lvl in range(len(want_cate)):
        np.testing.assert_allclose(cate[lvl].numpy(), want_cate[lvl].permute(0, 2, 3, 1).numpy(),
                                   rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(kern[lvl].numpy(), want_kern[lvl].permute(0, 2, 3, 1).numpy(),
                                   rtol=1e-4, atol=1e-4)
    assert want_mask.abs().max() > 0.1
    np.testing.assert_allclose(mask.numpy(), want_mask.numpy(), rtol=1e-4, atol=1e-4)


def test_load_pretrained_mmdet(tmp_path, caplog):
    """``PRETRAINS.MMDET``: a missing file is skipped with the JAX warning (and
    so is the YAML's missing ``WEIGHTS``); a checkpoint there loads every
    tensor it holds into the model."""
    _, tcfg = solo_yaml_cfgs()
    tcfg.PRETRAINS.ROOT = str(tmp_path)
    with torch.device("meta"):
        model = meta_architecture(tcfg)(tcfg)
    with caplog.at_level(logging.WARNING):
        assert load_pretrained(tcfg, model) is False
    assert "solo/SOLO_v2_R_50_FPN_1x.pkl not found" in caplog.text

    tcfg.MODEL.RESNETS.DEPTH = 50
    tcfg.MODEL.SOLO.MASK_KERNEL_CONVS_DIM = 64
    tcfg.MODEL.SOLO.MASK_KERNEL_NUM_CONVS = 1
    sd = synth_mmdet_solov2_state(tcfg, np.random.default_rng(2))
    path = tmp_path / "solo" / "SOLO_v2_R_50_FPN_1x.pth"
    path.parent.mkdir()
    torch.save({"state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    tcfg.PRETRAINS.MMDET = "solo/SOLO_v2_R_50_FPN_1x.pth"
    model = build_model(tcfg, device="cpu")
    assert load_pretrained(tcfg, model) is True
    got = model.state_dict()
    np.testing.assert_array_equal(got["head.cate_pred.weight"].numpy(), sd["bbox_head.solo_cate.weight"])
    np.testing.assert_array_equal(got["backbone.bottom_up.res5.2.conv3.norm.running_var"].numpy(),
                                  sd["backbone.layer4.2.bn3.running_var"])


# -- the loop -------------------------------------------------------------------------------

LOOP_NARROW = {"MODEL.RESNETS.STEM_OUT_CHANNELS": 16, "MODEL.RESNETS.RES2_OUT_CHANNELS": 32,
               "MODEL.RESNETS.WIDTH_PER_GROUP": 8, "MODEL.NECK.OUT_CHANNELS": 32,
               "MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES": 3, "MODEL.SOLO.NUM_GRIDS": [12, 10, 8, 6, 4],
               "MODEL.SOLO.MASK_KERNEL_CONVS_DIM": 32, "MODEL.SOLO.MASK_KERNEL_NUM_CONVS": 1,
               "MODEL.SOLO.MASK_FEATURE_CONVS_DIM": 32, "MODEL.SOLO.MASK_FEATURE_OUT_DIMS": 32,
               "MODEL.SOLO.SCORE_THRESH_TEST": 0.0, "MODEL.SOLO.UPDATE_SCORE_THRESH_TEST": 0.0,
               "TEST.DETECTIONS_PER_IMAGE": 10, "MODEL.DTYPE": "float32",
               "TRANSFORM.RESIZE.USE_MINI_MASKS": True, "SOLVER.IMS_PER_BATCH": 2,
               "INPUT.MAX_GT_INSTANCES": 4, "TRANSFORM.RESIZE.MIN_SIZE_TRAIN": (128,),
               "TRANSFORM.RESIZE.MAX_SIZE_TRAIN": 160, "TRANSFORM.RESIZE.MIN_SIZE_TEST": 128,
               "TRANSFORM.RESIZE.MAX_SIZE_TEST": 160,
               "INPUT.PAD_BUCKETS": ((128, 160), (160, 128))}


def test_train_and_run_evaluation_report_segm_ap(tmp_path):
    """The SOLO YAML (with ``USE_MINI_MASKS`` on) through ``train`` (2 steps
    from the loader, a checkpoint) and ``run_evaluation``: the evaluator
    adds the segm evaluator for the ``MASK_ON`` model and feeds it SOLOv2's
    frames through the full-frame route."""
    _, cfg = both_cfgs(SOLO_YAML, **LOOP_NARROW)
    ds = SyntheticDataset(n=4, h=120, w=150, num_classes=3, box_range=(30, 70))
    model = build_model(cfg, device="cpu", training=True)
    state = train(cfg, model, build_dataloader(cfg, ds, training=True), max_iter=2,
                  checkpoint_dir=str(tmp_path))
    assert state.step == 2 and os.listdir(tmp_path)
    metrics = run_evaluation(cfg, state.model, ds, lambda: build_dataloader(cfg, ds,
                                                                            training=False))
    assert {"bbox/AP", "segm/AP"} <= set(metrics)
    assert all(0.0 <= metrics[k] <= 100.0 for k in ("bbox/AP", "segm/AP")), metrics
