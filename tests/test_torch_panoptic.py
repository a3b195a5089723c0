"""PanopticFPN and the SemanticSegmentor (the semantic FPN head, its loss,
the panoptic fusion, the whole models) against the JAX package.

The components on seeded random inputs: the bilinear upsample by 2 and 4
against ``jax.image.resize`` (float32 1e-6; in bf16 within two bf16
roundings of the taps' magnitudes), the head with the JAX parameters carried
by ``convert.py`` (float32 1e-5 of the largest logit), ``sem_seg_loss``
and its gradient (1e-6 relative; 1e-5 of the largest gradient), and the
fusion, bit-equal to the JAX fusion and to
``tests/test_pipeline_oracle.py``'s numpy oracle. The models:
``configs/COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml`` and
``configs/COCO-SemanticSegmentation/semantic_R_50_FPN_1x.yaml`` at narrow
widths (``PANO_NARROW``: ResNet-18 with stem 16 and res2 32, FPN 32, the
head's convs 32, FC 64, mask conv 32, 5 thing classes, float32) on 2 x 128
x 160 images, from the same (tamed) JAX weights. Tolerances: the
detections at the port's standing ones (``test_torch_c4``); ``sem_seg``
equal wherever the two largest logits lie more than 1e-5 apart; the
logits 1e-4 of their largest magnitude; ``loss_sem_seg`` 1e-5 relative and
the other losses at their standing tolerances; gradients and one step's
updates 1e-4 of each tensor's largest magnitude; the fusion of the same
detections and map bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.convert.d2 import convert_d2_weights as jax_convert_d2
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.meta_arch.postprocess import (
    sem_seg_postprocess as jax_sem_seg_postprocess,
)
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import (
    _build_rcnn_parts,
    _RCNNDrivers,
)
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import panoptic_fusion as jax_panoptic_fusion
from detectron2_tensorflow_tpu.models.sem_seg import SemSegFPNHead as JaxSemSegFPNHead
from detectron2_tensorflow_tpu.models.sem_seg import (
    combine_semantic_and_instance_outputs as jax_combine,
)
from detectron2_tensorflow_tpu.models.sem_seg import sem_seg_loss as jax_sem_seg_loss
from detectron2_tensorflow_tpu.models.sem_seg import upsample_bilinear as jax_upsample
from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import _port_shapes, convert_d2_weights
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.models import build_model, panoptic_fusion
from detectron2_tensorflow_tpu_torch.models.meta_arch import meta_architecture
from detectron2_tensorflow_tpu_torch.models.meta_arch.postprocess import sem_seg_postprocess
from detectron2_tensorflow_tpu_torch.models.sem_seg import (
    SemSegFPNHead,
    combine_semantic_and_instance_outputs,
    sem_seg_loss,
    upsample_bilinear,
)
from detectron2_tensorflow_tpu_torch.structures import Instances
import test_torch_c4 as c4
from test_torch_c4 import LOSS_RTOL, check_detections, check_masks, jax_init, yaml_cfgs
from test_torch_keypoint import tame_r18
from test_torch_train import (
    GRAD_TOL,
    MASK_LOSS_RTOL,
    assert_grad_close,
    assert_update_close,
    fixed_jax_proposals,
    jax_noise,
    jax_proposals,
    jax_updated_params,
)
from test_pipeline_oracle import np_paste_masks
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

PANO_YAML = "configs/COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml"
SEM_YAML = "configs/COCO-SemanticSegmentation/semantic_R_50_FPN_1x.yaml"
PANO_NARROW = {"MODEL.RESNETS.DEPTH": 18, "MODEL.NECK.OUT_CHANNELS": 32,
               "MODEL.SEM_SEG_HEAD.CONVS_DIM": 32}
HEAD_TOL = 1e-5  # the head's logits, float32, of their largest magnitude
LOGIT_TOL = 1e-4  # the whole model's logits, of their largest magnitude
TIE = 1e-5  # sem_seg is held where the two largest logits lie further apart
B, H, W = c4.B, c4.H, c4.W


def pano_cfgs(path=PANO_YAML, **overrides):
    """(JAX cfg, port cfg): ``path`` at ``PANO_NARROW`` widths."""
    return yaml_cfgs(path, **{**PANO_NARROW, **overrides})


# -- the upsample and the head ------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_matches_jax_image_resize(factor, dtype):
    """``upsample_bilinear`` by an integer factor against ``jax.image.resize``
    (``"bilinear"``, antialiasing off for an upscale): float32 to 1e-6; in
    bf16 JAX rounds after each axis and PyTorch once, so they differ by at
    most two bf16 roundings (2^-8 each) of the taps' magnitudes."""
    rng = np.random.default_rng(factor)
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    want = np.asarray(jax_upsample(jnp.asarray(x, dtype), factor).astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = upsample_bilinear(tx, factor).permute(0, 2, 3, 1).float().numpy()
    assert got.shape == want.shape == (2, 5 * factor, 7 * factor, 3)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        mag = upsample_bilinear(tx.float().abs(), factor).permute(0, 2, 3, 1).numpy()
        assert (np.abs(got - want) <= 2 * 2.0 ** -8 * mag).all()


@pytest.mark.parametrize("factor", [2, 4])
def test_upsample_edges_take_the_edge_values(factor):
    """At the border the half-pixel samples fall outside the input: JAX
    renormalizes the one tap inside, PyTorch clamps to it, so on an input
    constant along W the outer rows equal the edge rows on both sides."""
    x = np.random.default_rng(9).standard_normal((1, 6, 1, 2)).astype(np.float32)
    x = np.repeat(x, 3, axis=2)
    want = np.asarray(jax_upsample(jnp.asarray(x), factor))
    got = upsample_bilinear(torch.from_numpy(x).permute(0, 3, 1, 2), factor)
    got = got.permute(0, 2, 3, 1).numpy()
    edge = factor // 2  # output rows whose sample lies before the first centre
    for out in (got, want):
        for r in range(edge):
            np.testing.assert_allclose(out[0, r], np.repeat(x[0, 0, :1], 3 * factor, 0),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(out[0, -1 - r], np.repeat(x[0, -1, :1], 3 * factor, 0),
                                       rtol=1e-6, atol=0)


def _features(rng, c=32, b=2, h=32, w=48):
    return {f"p{k}": rng.standard_normal((b, h >> (k - 2), w >> (k - 2), c)).astype(np.float32)
            for k in (2, 3, 4, 5)}


@pytest.mark.parametrize("norm", ["GN", ""])
def test_sem_seg_head_matches_jax(norm):
    """The head (per level conv+norm+ReLU and 2x upsamples, the sum, the 1x1
    predictor, the 4x upsample) with the JAX parameters carried by
    ``convert_variables``: logits ``[B, K, H, W]`` against the JAX ``[B, H, W,
    K]`` to 1e-5 of the largest, GN and no norm (then the convs have biases)."""
    rng = np.random.default_rng(5)
    feats = _features(rng)
    head = JaxSemSegFPNHead(in_features=("p2", "p3", "p4", "p5"), strides=(4, 8, 16, 32),
                            num_classes=7, convs_dim=32, common_stride=4, norm=norm)
    jf = {k: jnp.asarray(v) for k, v in feats.items()}
    params = head.init(jax.random.PRNGKey(2), jf)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) + 0.0, params)
    want = np.asarray(head.apply(params, jf))
    sd = convert_variables({"params": {"sem_seg_head": params["params"]}})
    port = SemSegFPNHead(("p2", "p3", "p4", "p5"), 32, (4, 8, 16, 32), 7, 32, 4, norm)
    port.load_state_dict({k[len("sem_seg_head."):]: v for k, v in sd.items()})
    got = port({k: torch.from_numpy(v).permute(0, 3, 1, 2) for k, v in feats.items()})
    got = got.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == want.shape == (2, 128, 192, 7)  # p2's stride 4
    np.testing.assert_allclose(got, want, rtol=0, atol=HEAD_TOL * float(np.abs(want).max()))
    names = set(port.state_dict())
    assert {"p5.4.weight", "p4.2.weight", "predictor.bias"} <= names
    assert ("p2.0.norm.weight" in names) == (norm == "GN")


# -- the loss -----------------------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sem_seg_loss_and_gradient_match_jax(seed):
    """``sem_seg_loss`` over float32 logits with ignored pixels (-1), labels
    beyond the classes (clipped) and a weight: the value to 1e-6 relative,
    the logits' gradient to 1e-5 of its largest magnitude; JAX's
    ``log_softmax`` formula. An all-ignored map gives 0 (the denominator's
    floor of 1)."""
    rng = np.random.default_rng(seed)
    k = 6
    logits = (rng.standard_normal((2, k, 24, 40)) * (1 + 4 * seed)).astype(np.float32)
    gt = rng.integers(-1, k + 2, (2, 24, 40)).astype(np.int32)
    jl = jnp.asarray(logits.transpose(0, 2, 3, 1))
    want, want_g = jax.value_and_grad(
        lambda x: jax_sem_seg_loss(x, jnp.asarray(gt), -1, 0.5))(jl)
    tl = torch.from_numpy(logits).requires_grad_(True)
    got = sem_seg_loss(tl, torch.from_numpy(gt), -1, 0.5)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-6)
    g = tl.grad.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(g, np.asarray(want_g), rtol=0,
                               atol=1e-5 * float(np.abs(want_g).max()))
    empty = sem_seg_loss(tl, torch.full((2, 24, 40), -1, dtype=torch.int32), -1)
    assert float(empty.detach()) == 0.0


# -- the fusion ---------------------------------------------------------------------------

def _detections(rng, b=2, d=12, h=60, w=84, m=14):
    """Random detections: boxes over the image, a score ladder with ties and
    scores at the threshold, invalid slots, carved mask probabilities."""
    xy = rng.uniform(0, [w - 10, h - 10], (b, d, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(6, 40, (b, d, 2))], -1).astype(np.float32)
    scores = rng.choice([0.3, 0.5, 0.55, 0.7, 0.7, 0.9, 0.95], (b, d)).astype(np.float32)
    classes = rng.integers(0, 5, (b, d)).astype(np.int32)
    valid = rng.uniform(0, 1, (b, d)) > 0.2
    masks = rng.uniform(0.2, 1.0, (b, d, m, m)).astype(np.float32)
    masks[:, ::3, :4] = 0.0
    return dict(boxes=boxes, scores=scores, pred_classes=classes, is_valid=valid,
                pred_masks=masks)


def _jax_fusion(det, sem, overlap, limit, conf, num_stuff):
    jdet = JaxInstances(**{k: jnp.asarray(v) for k, v in det.items()})
    out = jax.jit(lambda dd, ss: jax.vmap(lambda o, s: jax_combine(
        o, s, overlap, limit, conf, num_stuff))(dd, ss))(jdet, jnp.asarray(sem))
    return jax.tree_util.tree_map(np.asarray, out)


def _port_fusion(det, sem, overlap, limit, conf, num_stuff, device="cpu"):
    tdet = Instances(**{k: torch.from_numpy(v).to(device) for k, v in det.items()})
    pan, info = combine_semantic_and_instance_outputs(
        tdet, torch.from_numpy(sem).to(device), overlap, limit, conf, num_stuff)
    return pan.cpu().numpy(), {k: v.cpu().numpy() for k, v in info.items()}


@pytest.mark.parametrize("overlap,limit,conf", [(0.5, 40, 0.5), (0.3, 120, 0.6), (0.8, 1, 0.0)])
def test_fusion_matches_jax(overlap, limit, conf):
    """The fusion of the same detections and stuff map, bit-equal to the JAX
    fusion: the panoptic map and the four segment tables, with stuff
    segments accepted and rejected by area."""
    rng = np.random.default_rng(int(overlap * 10) + limit)
    det = _detections(rng)
    sem = np.kron(rng.integers(0, 6, (2, 6, 7)), np.ones((10, 12), np.int64)).astype(np.int32)
    want_map, want = _jax_fusion(det, sem, overlap, limit, conf, 6)
    got_map, got = _port_fusion(det, sem, overlap, limit, conf, 6)
    assert got_map.dtype == np.int32 and got_map.shape == (2, 60, 84)
    np.testing.assert_array_equal(got_map, want_map)
    for k in ("category_id", "is_thing", "score", "valid"):
        assert got[k].shape == want[k].shape == (2, 12 + 6 + 1), k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert (got["valid"] & got["is_thing"]).any() and (got["valid"] & ~got["is_thing"]).any()


def oracle_case():
    """``tests/test_pipeline_oracle.py``'s fusion case and its numpy oracle's
    answer: ``(detections of one image, sem [1, H, W], thresholds, (map,
    category_id, is_thing, score, valid))``."""
    rng = np.random.default_rng(31)
    h, w, d, num_stuff = 64, 80, 6, 5
    boxes = np.stack([[8, 8, 40, 40], [10, 10, 42, 44], [30, 20, 70, 60],
                      [5, 35, 35, 62], [50, 5, 78, 30], [0, 0, 12, 12]]).astype(np.float32)
    scores = np.asarray([0.9, 0.8, 0.85, 0.55, 0.45, 0.7], np.float32)
    classes = np.asarray([2, 1, 0, 3, 2, 1], np.int32)
    is_valid = np.asarray([1, 1, 1, 1, 1, 0], bool)
    masks = rng.uniform(0.4, 1.0, (d, 14, 14)).astype(np.float32)
    masks[1, :3] = 0.0
    masks[3, :, :4] = 0.0
    sem = rng.integers(0, num_stuff, (8, 10)).astype(np.int32)
    sem = np.kron(sem, np.ones((8, 8), np.int32))
    sem[sem == 3] = 4
    sem[:, :2] = 0
    conf_thresh = 0.5

    pasted = np_paste_masks(masks, boxes, (h, w))
    order_scores = np.where(is_valid, scores, -1.0)
    order = np.argsort(-order_scores, kind="stable")
    pixel = np.zeros((h, w), np.int32)
    next_id = 1
    cap = d + num_stuff + 1
    cat = np.full(cap, -1, np.int32)
    thing = np.zeros(cap, bool)
    segsc = np.zeros(cap, np.float32)
    segval = np.zeros(cap, bool)
    for det_i in order:
        mask = pasted[det_i]
        sc = order_scores[det_i]
        area = mask.sum()
        free = mask & (pixel == 0)
        if sc >= conf_thresh and area > 0 and free.sum() / max(area, 1) > 1 - 0.5:
            pixel[free] = next_id
            cat[next_id], thing[next_id] = classes[det_i], True
            segsc[next_id], segval[next_id] = sc, True
            next_id += 1
    stuff_area_limit = 150
    flat = sem.reshape(-1)
    free0 = np.nonzero((flat == 0) & (pixel.reshape(-1) == 0))[0]
    flat[free0[:stuff_area_limit]] = 3
    free2 = np.nonzero((flat == 2) & (pixel.reshape(-1) == 0))[0]
    flat[free2[stuff_area_limit - 1:]] = 4
    sem = flat.reshape(h, w)
    for c in range(1, num_stuff):
        region = (sem == c) & (pixel == 0)
        if region.sum() >= stuff_area_limit:
            pixel[region] = next_id
            cat[next_id], thing[next_id], segval[next_id] = c, False, True
            next_id += 1
    det = dict(boxes=boxes[None], scores=scores[None], pred_classes=classes[None],
               is_valid=is_valid[None], pred_masks=masks[None])
    return det, sem[None], (0.5, stuff_area_limit, conf_thresh, num_stuff), (
        pixel, cat, thing, segsc, segval)


def test_fusion_matches_the_numpy_oracle():
    """``tests/test_pipeline_oracle.py``'s case (a stuff class whose free area
    is exactly the limit, one just below it, instances rejected by overlap
    and validity) through the port: its sequential numpy oracle's map and
    tables, bit for bit."""
    det, sem, thresholds, (pixel, cat, thing, segsc, segval) = oracle_case()
    got_map, got = _port_fusion(det, sem, *thresholds)
    assert segval[cat == 3].any() and 2 <= (segval & thing).sum() < det["is_valid"].sum()
    np.testing.assert_array_equal(got_map[0], pixel)
    np.testing.assert_array_equal(got["category_id"][0], cat)
    np.testing.assert_array_equal(got["is_thing"][0], thing)
    np.testing.assert_array_equal(got["valid"][0], segval)
    np.testing.assert_array_equal(got["score"][0], segsc)


def test_fusion_reads_no_value_back_per_slot(monkeypatch):
    """The fusion's loop stays on the tensors' device: no ``.item()``,
    ``.cpu()`` or ``.tolist()`` anywhere in it."""
    det, sem, thresholds, _ = oracle_case()
    calls = []
    for name in ("item", "cpu", "tolist"):
        real = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name,
                            lambda self, *a, _r=real, _n=name, **k: calls.append(_n) or _r(
                                self, *a, **k))
    tdet = Instances(**{k: torch.from_numpy(v) for k, v in det.items()})
    combine_semantic_and_instance_outputs(tdet, torch.from_numpy(sem), *thresholds)
    assert calls == []


def test_sem_seg_postprocess_matches_jax():
    """``conventional`` and ``raw`` zero the padding as the JAX package does;
    ``fixed`` resizes the content region to its square canvas as it does."""
    rng = np.random.default_rng(3)
    sem = rng.integers(0, 9, (2, 32, 48)).astype(np.int32)
    sizes = np.array([[32, 40], [20, 48]], np.int32)
    _, tcfg = pano_cfgs()
    jcfg, _ = pano_cfgs()
    for fmt in ("conventional", "raw", "fixed"):
        jcfg.MODEL.SEGMENTATION_OUTPUT.FORMAT = tcfg.MODEL.SEGMENTATION_OUTPUT.FORMAT = fmt
        jcfg.MODEL.SEGMENTATION_OUTPUT.FIXED_RESOLUTION = 24
        tcfg.MODEL.SEGMENTATION_OUTPUT.FIXED_RESOLUTION = 24
        want = np.asarray(jax_sem_seg_postprocess(jcfg, jnp.asarray(sem),
                                                  {"image_size": jnp.asarray(sizes)}))
        got = sem_seg_postprocess(tcfg, torch.from_numpy(sem),
                                  {"image_size": torch.from_numpy(sizes)}).numpy()
        np.testing.assert_array_equal(got, want)
        if fmt == "fixed":
            assert got.shape == (2, 24, 24) and got.any()
        else:
            assert not got[0, :, 40:].any() and not got[1, 20:].any()
    tcfg.MODEL.SEGMENTATION_OUTPUT.FORMAT = "other"
    with pytest.raises(ValueError, match="other"):
        sem_seg_postprocess(tcfg, torch.from_numpy(sem), {"image_size": torch.from_numpy(sizes)})


# -- the whole models ---------------------------------------------------------------------

def check_sem_seg(got, want, logits):
    """``sem_seg`` equal at every pixel whose two largest ``logits [B, K, H,
    W]`` lie more than ``TIE`` apart (and those pixels are most of them)."""
    top2 = torch.topk(logits, 2, dim=1).values
    clear = (top2[:, 0] - top2[:, 1] > TIE).numpy()
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(np.asarray(got)[clear], np.asarray(want)[clear])


def port_logits(p):
    with torch.no_grad():
        return p["tmodel"].sem_seg_head(p["tmodel"].features(p["tbatch"]["image"])).float()


@pytest.fixture(scope="module")
def pano():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(c4, "tame", tame_r18)
        return c4.predict_pair(*pano_cfgs())


def test_panoptic_predict_matches_jax(pano):
    """PanopticFPN's ``predict``: the detections and masks at the standing
    tolerances, ``sem_seg [B, H, W]`` outside logit ties."""
    check_detections(pano)
    check_masks(pano, 28)
    got = pano["tout"].sem_seg
    assert tuple(got.shape) == (B, H, W) and pano["jout"].sem_seg.shape == (B, H, W)
    check_sem_seg(got.numpy(), pano["jout"].sem_seg, port_logits(pano))


def test_panoptic_fusion_of_predict_matches_jax(pano):
    """``panoptic_fusion(cfg, predict output)`` on the JAX model's output (the
    same detections and map on both sides; a low stuff limit and confidence
    so that segments of both kinds form): bit-equal maps and tables."""
    jcfg, tcfg = pano_cfgs(**{"MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT": 64,
                              "MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH": 0.0})
    jout = pano["jout"]
    want_map, want = jax.tree_util.tree_map(np.asarray, jax_panoptic_fusion(
        jcfg, jax.tree_util.tree_map(jnp.asarray, jout)))
    fields = {k: torch.from_numpy(np.array(getattr(jout, k)))
              for k in ("boxes", "scores", "pred_classes", "is_valid", "pred_masks", "sem_seg")}
    got_map, got = panoptic_fusion(tcfg, Instances(**fields))
    np.testing.assert_array_equal(got_map.numpy(), want_map)
    for k, v in got.items():
        np.testing.assert_array_equal(v.numpy(), want[k], err_msg=k)
    assert bool((got["valid"] & got["is_thing"]).any()) and bool((got["valid"] & ~got["is_thing"]).any())


@pytest.fixture(scope="module")
def sem():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(c4, "tame", tame_r18)
        return c4.predict_pair(*pano_cfgs(SEM_YAML))


def test_semantic_predict_matches_jax(sem):
    """The SemanticSegmentor's ``predict``: ``sem_seg_logits [B, H, W, K]``
    to 1e-4 of their largest magnitude, ``sem_seg`` outside ties,
    ``is_valid [B, 1]`` true."""
    tout, jout = sem["tout"], sem["jout"]
    logits = tout.sem_seg_logits.numpy()
    assert logits.shape == jout.sem_seg_logits.shape == (B, H, W, 54)
    np.testing.assert_allclose(logits, jout.sem_seg_logits, rtol=0,
                               atol=LOGIT_TOL * float(np.abs(jout.sem_seg_logits).max()))
    check_sem_seg(tout.sem_seg.numpy(), jout.sem_seg, tout.sem_seg_logits.permute(0, 3, 1, 2))
    np.testing.assert_array_equal(tout.is_valid.numpy(), jout.is_valid)
    assert tout.is_valid.shape == (B, 1) and bool(tout.is_valid.all())


def pano_train_pair(jcfg, tcfg, key=1):
    """``test_torch_c4.train_pair`` for PanopticFPN: one step of both packages
    from the same weights, noise and (the JAX package's) proposals on
    ``make_train_batch``'s batch with its ``gt_sem_seg``."""
    nb = make_train_batch(tcfg, H, W)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    variables = tame_r18(jax_init(jcfg, key, jbatch))
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg, with_sem_seg=True), True)
    step_rng = jax.random.PRNGKey(1)
    rng_rpn, rng_roi = jax.random.split(step_rng)

    def raw_proposals(v, b):
        _, logits, deltas = drv.features_and_rpn(v, b, True)
        return drv.rpn.proposals(logits, deltas, b["image_size"], training=True)

    j_raw = jax.tree_util.tree_map(np.asarray, jax.jit(raw_proposals)(variables, jbatch))

    def total_loss(params):
        total, (loss_dict, _) = drv.loss_fn({**variables, "params": params}, jbatch, step_rng, {})
        return total, loss_dict

    with fixed_jax_proposals(drv, j_raw):
        (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(total_loss, has_aux=True))(
            variables["params"])
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables),
                         training=True)
    with torch.no_grad():
        feats = tmodel.features(tbatch["image"])
        rpn = tmodel.proposal_generator
        n_anchors = sum(l[0].numel() for l in rpn.rpn_head([feats[f] for f in rpn.in_features])[0])
    n_props = j_raw.is_valid.shape[1] + c4.G
    noise = {"rpn": jax_noise(rng_rpn, B, n_anchors), "roi": jax_noise(rng_roi, B, n_props)}
    with jax_proposals(tmodel, j_raw):
        t_losses = tmodel.losses(tbatch, noise=noise)
    sum(t_losses.values()).backward()
    return dict(
        jcfg=jcfg, tcfg=tcfg, variables=variables, tbatch=tbatch, j_raw=j_raw, noise=noise,
        j_total=float(j_total), j_losses={k: float(v) for k, v in j_losses.items()},
        j_grads=j_grads, tmodel=tmodel,
        t_losses={k: float(v.detach()) for k, v in t_losses.items()},
        t_grads={n: p.grad.numpy().copy() for n, p in tmodel.named_parameters()
                 if p.grad is not None})


def semantic_train_pair(jcfg, tcfg, key=1):
    """One SemanticSegmentor step of both packages from the same weights:
    ``loss_sem_seg`` and the gradients (``jax.grad`` of the JAX ``loss_fn``)."""
    nb = make_train_batch(tcfg, H, W)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    variables = tame_r18(jax_init(jcfg, key, jbatch))
    jmodel = jax_build_model(jcfg)

    def total_loss(params):
        total, (loss_dict, _) = jmodel.loss_fn({**variables, "params": params}, jbatch,
                                               jax.random.PRNGKey(1), {})
        return total, loss_dict

    (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(total_loss, has_aux=True))(
        variables["params"])
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables),
                         training=True)
    t_losses = tmodel.losses(tbatch)
    sum(t_losses.values()).backward()
    return dict(
        jcfg=jcfg, tcfg=tcfg, variables=variables, tbatch=tbatch, noise=None, j_raw=None,
        j_total=float(j_total), j_losses={k: float(v) for k, v in j_losses.items()},
        j_grads=j_grads, tmodel=tmodel,
        t_losses={k: float(v.detach()) for k, v in t_losses.items()},
        t_grads={n: p.grad.numpy().copy() for n, p in tmodel.named_parameters()
                 if p.grad is not None})


TRAIN = {"INPUT.MAX_GT_INSTANCES": c4.G, "SOLVER.IMS_PER_BATCH": B}


@pytest.fixture(scope="module", params=["panoptic", "semantic"])
def run(request):
    """PanopticFPN (``INSTANCE_LOSS_WEIGHT`` 0.5, which scales the ROI
    heads' losses only) or the SemanticSegmentor, one step of both packages."""
    if request.param == "panoptic":
        return pano_train_pair(*pano_cfgs(**TRAIN, **{
            "MODEL.PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT": 0.5,
            "MODEL.RPN.POST_NMS_TOPK_TRAIN": 200}))
    return semantic_train_pair(*pano_cfgs(SEM_YAML, **TRAIN))


def test_train_losses_match_jax(run):
    """The losses in the JAX package's order (the RPN's, ``loss_sem_seg``,
    then the ROI heads'), ``loss_sem_seg`` to 1e-5 relative, the others at
    their standing tolerances; ignore pixels in the GT."""
    got, want = run["t_losses"], run["j_losses"]
    if run["tcfg"].MODEL.META_ARCHITECTURE == "PanopticFPN":
        keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_sem_seg", "loss_cls", "loss_box_reg",
                "loss_mask")
    else:
        keys = ("loss_sem_seg",)
    assert tuple(got) == keys and set(want) == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=MASK_LOSS_RTOL if k == "loss_mask"
                                   else LOSS_RTOL, err_msg=k)
    assert (run["tbatch"]["gt_sem_seg"] == -1).any() and got["loss_sem_seg"] > 0


def test_train_gradients_match_jax(run):
    """Every trainable parameter's gradient, ``sem_seg_head``'s included,
    against ``jax.grad``, 1e-4 of its largest magnitude; the frozen stem and
    res2 get none."""
    want = convert_variables({"params": run["j_grads"]})
    got = run["t_grads"]
    trainable = tsolver.trainable_parameters(run["tmodel"], 2)
    assert set(got) == set(trainable)
    for name, w in want.items():
        if name in trainable:
            assert_grad_close(got[name], w.numpy(), name)
        else:
            assert name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")), name
    heads = [n for n in got if n.startswith("sem_seg_head.")]
    assert len(heads) == 23 and np.abs(got["sem_seg_head.predictor.weight"]).max() > 0


def test_train_step_matches_jax_update(run):
    """``create_train_state`` + ``build_train_step``: the total loss and one
    step's updates against the JAX gradients through the optax chain."""
    tcfg = run["tcfg"]
    start = convert_variables(run["variables"])
    model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    state = create_train_state(tcfg, model, torch.Generator().manual_seed(0))
    step = build_train_step(tcfg, state)
    if run["j_raw"] is None:
        metrics = step(run["tbatch"])
    else:
        with jax_proposals(model, run["j_raw"]):
            metrics = step(run["tbatch"], noise=run["noise"])
    np.testing.assert_allclose(float(metrics["total_loss"]), run["j_total"], rtol=LOSS_RTOL,
                               atol=MASK_LOSS_RTOL * run["j_losses"].get("loss_mask", 0.0))
    want = convert_variables({"params": jax_updated_params(run["jcfg"], run["variables"]["params"],
                                                           run["j_grads"])})
    for name, p in model.named_parameters():
        assert_update_close(p.detach().numpy(), want[name].numpy(), start[name].numpy(),
                            GRAD_TOL, name)


def test_instance_loss_weight_scales_the_roi_losses_only():
    """``PANOPTIC_FPN.INSTANCE_LOSS_WEIGHT`` multiplies the box and mask
    losses; the RPN's and ``loss_sem_seg`` stay as they are."""
    _, tcfg = pano_cfgs(**TRAIN)
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(tcfg, 64, 96).items()}
    model = build_model(tcfg, device="cpu", training=True, init="jax",
                        generator=torch.Generator().manual_seed(0))
    out = {}
    for weight in (1.0, 0.25):
        model.instance_loss_weight = weight
        with torch.no_grad():
            out[weight] = model.losses(batch, generator=torch.Generator().manual_seed(3))
    for k, v in out[1.0].items():
        scale = 1.0 if k.startswith("loss_rpn_") or k == "loss_sem_seg" else 0.25
        np.testing.assert_allclose(float(out[0.25][k]), scale * float(v), rtol=1e-6, err_msg=k)


# -- the family around it ------------------------------------------------------------------

TREE_NARROW = {"MODEL.NECK.OUT_CHANNELS": 32, "MODEL.SEM_SEG_HEAD.CONVS_DIM": 32}
YAMLS = [f"configs/COCO-PanopticSegmentation/{f}.yaml" for f in (
    "Base-Panoptic-FPN", "panoptic_fpn_R_50_1x", "panoptic_fpn_R_50_3x", "panoptic_fpn_R_101_3x")
] + [SEM_YAML] + [f"configs/quick_schedules/{f}.yaml" for f in (
    "panoptic_fpn_R_50_inference_acc_test", "panoptic_fpn_R_50_instant_test",
    "panoptic_fpn_R_50_training_acc_test", "semantic_R_50_FPN_inference_acc_test",
    "semantic_R_50_FPN_instant_test", "semantic_R_50_FPN_training_acc_test")
] + ["configs/synthetic/overfit_panoptic_R_18.yaml"]


@pytest.mark.parametrize("path", YAMLS)
def test_yaml_builds_the_jax_tree(path):
    """Each panoptic and semantic YAML builds (narrow) with the JAX model's
    tensors, ``sem_seg_head/*`` carried to ``sem_seg_head.p{l}.{2i}`` and
    ``predictor``, name for name and shape for shape."""
    gn = {"MODEL.RESNETS.STEM_OUT_CHANNELS": 32, "MODEL.RESNETS.WIDTH_PER_GROUP": 32,
          "MODEL.RESNETS.RES2_OUT_CHANNELS": 128} if "synthetic" in path else {}  # GN's 32 groups
    jcfg, tcfg = yaml_cfgs(path, **TREE_NARROW, **gn)
    want = {k: tuple(v.shape) for k, v in convert_variables(c4.jax_param_shapes(jcfg)).items()}
    got = _port_shapes(tcfg)
    assert got == want
    k = tcfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    assert got["sem_seg_head.predictor.weight"] == (k, 32, 1, 1)
    assert ("proposal_generator.rpn_head.conv.weight" in got) == (
        tcfg.MODEL.META_ARCHITECTURE == "PanopticFPN")


def test_dconv_panoptic_yaml_raises_by_name():
    """``Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml`` builds: a cascade
    PanopticFPN on an R101-GN trunk with deformable res3-res5 (30 blocks).
    On a basic-block trunk its deformable stages raise, naming them, as
    Detectron2 refuses them."""
    cfg = get_cfg()
    cfg.merge_from_file(c4.os.path.join(c4.REPO,
                                        "configs/Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml"))
    assert meta_architecture(cfg).__name__ == "PanopticFPN"
    with torch.device("meta"):
        model = meta_architecture(cfg)(cfg)
    names = [n for n, _ in model.named_modules() if n.endswith(".conv2.conv_offset")]
    assert len(names) == 4 + 23 + 3 and type(model.roi_heads).__name__ == "CascadeROIHeads"
    cfg.MODEL.RESNETS.DEPTH = 34
    cfg.MODEL.RESNETS.RES2_OUT_CHANNELS = 64
    with pytest.raises(NotImplementedError, match="DEFORM"):
        with torch.device("meta"):
            meta_architecture(cfg)(cfg)


def test_convert_d2_weights_panoptic_matches_jax_converter():
    """A seeded Detectron2-named PanopticFPN state dict through the port's
    converter: every tensor the JAX converter carries equals its tree
    carried by ``convert_variables``; the semantic head
    (``sem_seg_head.p{l}.{2i}`` with its GN, ``predictor``), which the JAX
    converter leaves behind, arrives as Detectron2 stores it (OIHW, the
    port's layout), so nothing is left over."""
    jcfg, tcfg = pano_cfgs()
    rng = np.random.default_rng(8)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in _port_shapes(tcfg).items()}
    got, got_left = convert_d2_weights(dict(sd), tcfg)
    tree, _ = jax_convert_d2(dict(sd), jcfg)
    want = convert_variables(tree)
    head = {k for k in got if k.startswith("sem_seg_head.")}
    assert len(head) == 23 and set(got) - head == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    for k in head:
        assert torch.equal(got[k], torch.from_numpy(sd[k])), k
    assert got_left == []
