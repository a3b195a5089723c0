"""Keypoint R-CNN (the keypoint pooler's fixed sampling ratio, the
``KRCNNConvDeconvUpsampleHead``, ``keypoint_loss`` and
``keypoint_inference``, the whole model) against the JAX package.

``configs/COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml`` at narrow widths
(``KP_NARROW``: ResNet-18 with stem 16 and res2 32, FPN 32, FC 64, a
keypoint head of two 32-wide convs, 5 classes, float32), ``MASK_ON`` False
(the YAML's) and True, on 2 x 128 x 160 images. The same seeded numpy inputs
and weights (the JAX ones carried over by ``convert.py``) go through both
packages; in training both take the JAX package's proposals and sampler
draws. On the CPU the JAX model takes its XLA paths and the port the
kernels' plain versions. Tolerances are the port's standing ones: the
plan's integers, valid slots, classes and NMS keeps equal; plan weights
1e-6; pooled features and the head float32 1e-5; boxes and keypoints 1e-4,
keypoint scores 1e-5; losses 1e-5 relative (the mask loss 3e-4); gradients
and one step's updates 1e-4 of each tensor's largest magnitude, but for
the keypoint deconv's bias, whose gradient is zero (a per-keypoint constant
moves every position's logit alike, which the softmax over positions does
not see): both packages' are held below 1e-4 of the head's largest weight
gradient (update).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from detectron2_tensorflow_tpu.convert.d2 import convert_d2_weights as jax_convert_d2
from detectron2_tensorflow_tpu.models import poolers as jp
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts
from detectron2_tensorflow_tpu.models.roi_heads.heads import (
    KRCNNConvDeconvUpsampleHead as JaxKeypointHead,
)
from detectron2_tensorflow_tpu.models.roi_heads.roi_heads import (
    SampledProposals as JaxSampledProposals,
)
from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import _port_shapes, convert_d2_weights
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import build_train_step, create_train_state
from detectron2_tensorflow_tpu_torch.engine import make_train_batch
from detectron2_tensorflow_tpu_torch.models import build_model, poolers as tp
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import GeneralizedRCNN
from detectron2_tensorflow_tpu_torch.models.roi_heads.heads import KRCNNConvDeconvUpsampleHead
from detectron2_tensorflow_tpu_torch.models.roi_heads.roi_heads import SampledProposals
from detectron2_tensorflow_tpu_torch.structures import Instances
import test_torch_c4 as c4
from test_torch_c4 import (
    ATOL,
    LOSS_RTOL,
    RTOL,
    check_detections,
    check_masks,
    jax_param_shapes,
    yaml_cfgs,
)
from test_torch_roi import STRIDES, _boxes, _features
from test_torch_train import (
    GRAD_TOL,
    MASK_LOSS_RTOL,
    assert_grad_close,
    assert_update_close,
    jax_proposals,
    jax_updated_params,
)
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

KP_YAML = "configs/COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml"
KP_YAMLS = [f"configs/COCO-Keypoints/keypoint_rcnn_R_50_FPN_{s}.yaml" for s in ("1x", "3x")] + [
    f"configs/quick_schedules/keypoint_rcnn_R_50_FPN_{s}.yaml" for s in (
        "inference_acc_test", "instant_test", "normalized_training_acc_test", "training_acc_test")]
KP_NARROW = {"MODEL.RESNETS.DEPTH": 18, "MODEL.NECK.OUT_CHANNELS": 32,
             "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS": (32, 32)}
KP_TOL = 1e-5  # pooled features, the head, the losses' logits gradients
BIAS = "roi_heads.keypoint_head.score_lowres.bias"


def kp_cfgs(**overrides):
    """(JAX cfg, port cfg): the keypoint YAML at ``KP_NARROW`` widths."""
    return yaml_cfgs(KP_YAML, **{**KP_NARROW, **overrides})


def tame_r18(variables):
    """numpy copy of ResNet-18 JAX variables with activations kept small: the
    stem's FrozenBN scale 1/640, every basic block's last one 0.2 (the
    port's ``init_weights`` rule for bottlenecks)."""
    v = jax.tree_util.tree_map(np.array, jax.tree_util.tree_map(np.asarray, variables))
    frozen = v["frozen"]["backbone"]
    frozen["stem"]["conv1"]["FrozenBatchNorm_0"]["scale"][:] = 1.0 / 640
    for stage, blocks in frozen.items():
        if stage.startswith("res"):
            for block in blocks.values():
                block["conv2"]["FrozenBatchNorm_0"]["scale"][:] = 0.2
    return v


# -- the fixed-ratio plan ------------------------------------------------------------------

def _fixed_plans(feats, boxes, valid, out_size, ratio):
    """(JAX storage, meta, plan per image stacked; port storage, meta, plan)
    at a fixed ``sampling_ratio``."""
    p, tiers = jp.plan_patch(1333, STRIDES[-1])
    j_st, j_plan = [], []
    for i in range(boxes.shape[0]):
        st, meta = jp.build_storage([jnp.asarray(f[i]) for f in feats], STRIDES, p, tiers)
        j_st.append(st)
        j_plan.append(jp.plan_rois(meta, jnp.asarray(boxes[i]), out_size, ratio, 224, 4,
                                   valid=jnp.asarray(valid[i])))
    t_storage, t_meta = tp.build_storage([torch.from_numpy(f) for f in feats], STRIDES, p)
    t_plan = tp.plan_rois(t_meta, torch.from_numpy(boxes), out_size, ratio, 224, 4,
                          valid=torch.from_numpy(valid))
    return ((jnp.stack(j_st), meta, *(np.asarray(jnp.stack(x)) for x in zip(*j_plan))),
            (t_storage, t_meta, *t_plan))


def _kp_boxes(rng, b, n):
    """``_boxes`` (4-300 px) plus boxes the size of the image, two of zero
    width and one reaching past the image's edge."""
    boxes = _boxes(rng, b, n)
    boxes[:, 0] = [0, 0, 384, 256]
    boxes[:, 1, 2] = boxes[:, 1, 0]
    boxes[:, 2, 3] = boxes[:, 2, 1]
    boxes[:, 3] = [350, 200, 420, 300]
    return boxes


@pytest.mark.parametrize("out_size,ratio", [(14, 2), (7, 2), (14, 1)])
def test_fixed_ratio_plan_matches_jax(out_size, ratio):
    """``plan_rois`` with ``sampling_ratio`` > 0 (the keypoint pooler's 2):
    the starts (plane row, 8-aligned column, tier class) equal, the hat
    weights to 1e-6, skipped slots on the skip class with zero weights."""
    rng = np.random.default_rng(out_size * 10 + ratio)
    boxes = _kp_boxes(rng, 2, 24)
    valid = rng.uniform(0, 1, (2, 24)) > 0.2
    valid[:, :4] = True
    (_, jmeta, jst, jwy, jwx), (_, tmeta, tst, twy, twx) = _fixed_plans(
        _features(rng), boxes, valid, out_size, ratio)
    np.testing.assert_array_equal(tst.numpy(), jst)
    np.testing.assert_allclose(twy.numpy(), jwy, rtol=0, atol=1e-6)
    np.testing.assert_allclose(twx.numpy(), jwx, rtol=0, atol=1e-6)
    assert twy.shape[-2:] == (out_size, tmeta.patch_size)
    assert (tst[..., 2].numpy()[~valid] == tp.skip_tier_class(tmeta.patch_size)).all()
    assert not twy.numpy()[~valid].any()
    # A zero-width box keeps its row weights (no adaptive gate), as in JAX.
    assert twy.numpy()[:, 1].any()


@pytest.mark.parametrize("out_size,ratio", [(14, 2), (7, 2)])
def test_fixed_ratio_pool_matches_jax_xla_path(out_size, ratio):
    """The whole fixed-ratio pool (plan and the plain contraction) against the
    JAX ``pool_from_storage(use_pallas=False)``, float32 1e-5; skipped slots
    exact zeros on both sides."""
    rng = np.random.default_rng(300 + out_size)
    boxes = _kp_boxes(rng, 2, 20)
    valid = rng.uniform(0, 1, (2, 20)) > 0.25
    (js, jmeta, *_), (ts, tmeta, *_) = _fixed_plans(_features(rng), boxes, valid, out_size,
                                                     ratio)
    want = np.asarray(jax.vmap(
        lambda st, b, v: jp.pool_from_storage(st, jmeta, b, out_size, ratio, use_pallas=False,
                                              valid=v)
    )(js, jnp.asarray(boxes), jnp.asarray(valid)))
    got = tp.pool_from_storage(ts, tmeta, torch.from_numpy(boxes), out_size, ratio,
                               valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got[~valid], 0.0)
    np.testing.assert_array_equal(want[~valid], 0.0)
    np.testing.assert_allclose(got, want, rtol=0, atol=KP_TOL)


def test_fixed_ratio_support_holds_every_weight_at_serving_shapes():
    """At 800x1344 (p2-p5, detector-like boxes of 12-600 px) the hat
    support the ROI kernels narrow each slot's window to (``hat_support``:
    the rows and columns with a nonzero weight, the zero-weight rows between
    samples inside it) holds every nonzero weight of the ratio-2 plan, and
    lies inside the slot's tier window."""
    rng = np.random.default_rng(11)
    feats = _features(rng, h=200, w=336, c=1)
    ctr = rng.uniform([0, 0], [1333, 800], (2, 160, 2))
    half = np.exp(rng.uniform(np.log(12), np.log(600), (2, 160, 1))) / 2 * [1.0, 0.6]
    boxes = np.clip(np.concatenate([ctr - half, ctr + half], -1), 0, [1333, 800, 1333, 800])
    valid = rng.uniform(0, 1, (2, 160)) > 0.1
    _, (_, tmeta, tst, twy, twx) = _fixed_plans(feats, boxes.astype(np.float32), valid, 14, 2)
    p = tmeta.patch_size
    pos = torch.arange(p)
    cls = tst[..., 2]
    keep = cls < tp.skip_tier_class(p)
    cols = [c for c in tp.COL_TIERS if c < p] + [p]
    rows = [r for r in tp.ROW_TIERS if r < p] + [p]
    for w, tiers, part in ((twy, rows, cls // len(cols)), (twx, cols, cls % len(cols))):
        sup = tp.hat_support(w)
        outside = (pos < sup[..., :1]) | (pos >= sup[..., 1:])
        assert not bool((w * outside[..., None, :]).any())
        assert bool((sup[..., 1][keep] <= torch.tensor(tiers)[part[keep]]).all())


# -- the head --------------------------------------------------------------------------

def _jax_head(conv_dims, k, x):
    head = JaxKeypointHead(num_keypoints=k, conv_dims=conv_dims)
    params = head.init(jax.random.PRNGKey(3), jnp.asarray(x))
    return head, params


def _port_head(params, c, conv_dims, k):
    sd = convert_variables({"params": {"keypoint_head": params["params"]}})
    prefix = "roi_heads.keypoint_head."
    head = KRCNNConvDeconvUpsampleHead(c, k, conv_dims)
    head.load_state_dict({n[len(prefix):]: v for n, v in sd.items()})
    return head


def test_keypoint_head_matches_jax():
    """Convs, the kernel-4 stride-2 ``SAME`` deconv (PyTorch's padding 1 on
    the flipped kernel) and the bilinear 2x, float32 1e-5, on 14x14 inputs:
    logits [N, 56, 56, K], with the JAX parameters carried by
    ``convert.py``."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((6, 14, 14, 24)).astype(np.float32)
    head, params = _jax_head((32, 16), 17, x)
    want = np.asarray(head.apply(params, jnp.asarray(x)))
    got = _port_head(params, 24, (32, 16), 17)(torch.from_numpy(x))
    assert tuple(got.shape) == want.shape == (6, 56, 56, 17)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=KP_TOL * max(1.0, float(np.abs(want).max())))


def test_keypoint_deconv_is_same_padded():
    """The deconv alone on a one-hot input: a 4x4 footprint placed as the
    JAX ``SAME`` transposed convolution places it (the output is 2x the
    input, the impulse at (i, j) lands on rows and columns 2i-1 .. 2i+2)."""
    x = np.zeros((1, 5, 5, 1), np.float32)
    x[0, 2, 3, 0] = 1.0
    head, params = _jax_head((), 1, x)
    want = np.asarray(head.apply(params, jnp.asarray(x)))
    port = _port_head(params, 1, (), 1)
    lowres = port.score_lowres(torch.from_numpy(x).permute(0, 3, 1, 2))
    want_lowres = np.asarray(jax.lax.conv_transpose(
        jnp.asarray(x), params["params"]["score_lowres"]["deconv"]["kernel"], (2, 2), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))) + np.asarray(
            params["params"]["score_lowres"]["deconv"]["bias"])
    got = lowres.permute(0, 2, 3, 1).detach().numpy()
    assert got.shape == (1, 10, 10, 1) and want.shape == (1, 20, 20, 1)
    np.testing.assert_allclose(got, want_lowres, rtol=0, atol=1e-6)
    nz = np.argwhere(got[0, ..., 0] != 0)
    assert len(nz) == 16 and np.ptp(nz[:, 0]) == 3 and np.ptp(nz[:, 1]) == 3


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("hw", [(7, 7), (6, 9)])
def test_bilinear_2x_matches_jax_image_resize(dtype, hw):
    """``jax.image.resize(..., "bilinear")`` at 2x, edges included, against
    ``F.interpolate(mode="bilinear", align_corners=False)``: float32 to
    1e-6; in bf16 JAX rounds after each axis's contraction and PyTorch once,
    so they differ by at most two bf16 roundings (unit roundoff 2^-8 each)
    of the taps' magnitudes (the same upsample of |x|)."""
    rng = np.random.default_rng(hw[0] * 10 + hw[1])
    x = rng.standard_normal((3,) + hw + (5,)).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    want = np.asarray(jax.image.resize(jx, (3, 2 * hw[0], 2 * hw[1], 5), "bilinear")
                      .astype(jnp.float32))
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = F.interpolate(tx, scale_factor=2, mode="bilinear", align_corners=False)
    got = got.permute(0, 2, 3, 1).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    else:
        mag = F.interpolate(tx.float().abs(), scale_factor=2, mode="bilinear",
                            align_corners=False).permute(0, 2, 3, 1).numpy()
        assert (np.abs(got - want) <= 2 * 2.0 ** -8 * mag).all()
        assert (got == want).mean() > 0.5


def test_bilinear_2x_keeps_the_border_rows():
    """At the border the half-pixel sample falls a quarter cell outside: JAX
    renormalizes the one tap inside and PyTorch clamps to it, so on an input
    constant along W the first and last output rows are the first and last
    input rows, exactly, on both sides."""
    x = np.random.default_rng(2).standard_normal((1, 6, 1, 3)).astype(np.float32)
    x = np.repeat(x, 4, axis=2)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 12, 8, 3), "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), scale_factor=2,
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    for out in (got, want):  # JAX's einsum over every tap rounds once more
        np.testing.assert_allclose(out[0, 0], x[0, 0, :1].repeat(8, 0), rtol=1e-6, atol=0)
        np.testing.assert_allclose(out[0, -1], x[0, -1, :1].repeat(8, 0), rtol=1e-6, atol=0)


# -- the loss and the inference ----------------------------------------------------------

@pytest.fixture(scope="module")
def kp_heads():
    """The JAX package's ``StandardROIHeads`` and the port's heads (on the meta
    device: ``keypoint_loss`` and ``keypoint_inference`` read no parameter)
    of the narrow keypoint config at 64 ROIs an image (16 keypoint slots),
    normalized by visible keypoints or not (``LOSS_WEIGHT`` 4, the
    normalized quick schedule's)."""
    out = {}
    for normalize in (True, False):
        jcfg, tcfg = kp_cfgs(**{"MODEL.ROI_KEYPOINT_HEAD.NORMALIZE_LOSS_BY_VISIBLE_KEYPOINTS":
                                normalize, "MODEL.ROI_KEYPOINT_HEAD.LOSS_WEIGHT": 4.0,
                                "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 64})
        with torch.device("meta"):
            heads = GeneralizedRCNN(tcfg).roi_heads
        out[normalize] = (_build_rcnn_parts(jcfg)[2], heads, jcfg)
    return out


def _sample(rng, b=2, s=64, g=5, k=17):
    """A sample of ``s`` slots per image (the leading 16 the keypoint
    branch's: positives, then background and padded slots) and GT keypoints
    with invisible ones and ones outside their proposal box."""
    xy = rng.uniform(0, 100, (b, s, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 60, (b, s, 2))], -1).astype(np.float32)
    matched = rng.integers(0, g, (b, s)).astype(np.int32)
    is_fg = np.zeros((b, s), bool)
    is_fg[:, :10] = True
    valid = np.ones((b, s), bool)
    valid[:, 13:] = False
    valid[0, 40:] = True
    gt_boxes = np.take_along_axis(boxes, matched[..., None].repeat(4, -1), 1)
    classes = np.where(is_fg, rng.integers(0, 5, (b, s)), 5).astype(np.int32)
    kp = np.zeros((b, g, k, 3), np.float32)
    kp[..., :2] = rng.uniform(-10, 170, (b, g, k, 2))
    kp[..., 2] = rng.integers(0, 3, (b, g, k))
    return dict(boxes=boxes, gt_classes=classes, gt_boxes=gt_boxes, matched_idx=matched,
                is_fg=is_fg, valid=valid), kp


@pytest.mark.parametrize("normalize", [True, False])
def test_keypoint_loss_matches_jax(kp_heads, normalize):
    """The softmax cross-entropy over the 56 x 56 positions at each labelled,
    in-box GT keypoint of the foreground slots, normalized by their count or
    by the foreground slots x K, weight 4: the value to 1e-5 relative and its
    gradient by the logits to 1e-5 of its largest magnitude."""
    jdrv, heads, _ = kp_heads[normalize]
    rng = np.random.default_rng(21 + normalize)
    fields, kp = _sample(rng)
    m = heads.mask_slots
    logits = rng.normal(0, 2, (2 * m, 56, 56, 17)).astype(np.float32)

    def jloss(lg):
        sampled = JaxSampledProposals(**{k: jnp.asarray(v) for k, v in fields.items()})
        return jdrv.keypoint_loss(lg, sampled, {"gt_keypoints": jnp.asarray(kp)},
                                  normalize, 4.0)

    want, wgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    tl = torch.from_numpy(logits).requires_grad_(True)
    sampled = SampledProposals(**{k: torch.from_numpy(v).long() if k in ("gt_classes",
                                  "matched_idx") else torch.from_numpy(v)
                                  for k, v in fields.items()})
    got = heads.keypoint_loss(tl, sampled, {"gt_keypoints": torch.from_numpy(kp)})
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=LOSS_RTOL)
    wgrad = np.asarray(wgrad)
    np.testing.assert_allclose(tl.grad.numpy(), wgrad, rtol=0,
                               atol=KP_TOL * float(np.abs(wgrad).max()))
    # The cases are there: invisible, out-of-box, background and padded slots.
    assert (kp[..., 2] == 0).any() and (~fields["is_fg"][:, :m]).any()
    assert (~fields["valid"][:, :m]).any() and float(want) > 0


def test_keypoint_loss_without_visible_keypoints_is_zero(kp_heads):
    """No labelled keypoint: 0 (the count floored at 1), as in JAX."""
    jdrv, heads, _ = kp_heads[True]
    fields, kp = _sample(np.random.default_rng(3))
    kp[..., 2] = 0
    m = heads.mask_slots
    logits = torch.zeros((2 * m, 56, 56, 17))
    sampled = SampledProposals(**{k: torch.from_numpy(v) for k, v in fields.items()})
    assert float(heads.keypoint_loss(logits, sampled, {"gt_keypoints": torch.from_numpy(kp)})) == 0


def _detections(rng, b=2, d=12):
    xy = rng.uniform(0, 100, (b, d, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(5, 60, (b, d, 2))], -1).astype(np.float32)
    classes = rng.integers(0, 5, (b, d)).astype(np.int32)
    return boxes, classes


def test_keypoint_inference_matches_jax(kp_heads):
    """``pred_keypoints [B, D, K, 3]``: the softmax maximum's cell centre in
    the box and the maximum itself, to 1e-6 relative; at ties (a flat
    heatmap, two equal peaks) the first position wins on both sides."""
    jdrv, heads, _ = kp_heads[True]
    rng = np.random.default_rng(8)
    boxes, classes = _detections(rng)
    logits = rng.normal(0, 3, (24, 56, 56, 17)).astype(np.float32)
    logits[0, :, :, 0] = 1.5  # flat: every position ties
    logits[1, :, :, 1] = -4.0
    logits[1, 9, 30, 1] = logits[1, 40, 2, 1] = 6.0  # two equal peaks
    logits[2, 55, 55, 2] = 40.0  # the last cell
    valid = np.ones((2, 12), bool)
    jd = JaxInstances(boxes=jnp.asarray(boxes), scores=jnp.ones((2, 12)),
                      pred_classes=jnp.asarray(classes), is_valid=jnp.asarray(valid))
    want = np.asarray(jdrv.keypoint_inference(jnp.asarray(logits), jd).pred_keypoints)
    td = Instances(boxes=torch.from_numpy(boxes), scores=torch.ones((2, 12)),
                   pred_classes=torch.from_numpy(classes), is_valid=torch.from_numpy(valid))
    got = heads.keypoint_inference(torch.from_numpy(logits), td).pred_keypoints.numpy()
    assert got.shape == want.shape == (2, 12, 17, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    x0, y0, x1, y1 = boxes[0, 0]
    np.testing.assert_allclose(got[0, 0, 0, :2], [x0 + 0.5 / 56 * (x1 - x0),
                                                  y0 + 0.5 / 56 * (y1 - y0)], rtol=1e-6)
    x0, y0, x1, y1 = boxes[0, 1]
    np.testing.assert_allclose(got[0, 1, 1, :2], [x0 + 30.5 / 56 * (x1 - x0),
                                                  y0 + 9.5 / 56 * (y1 - y0)], rtol=1e-6)
    np.testing.assert_allclose(got[0, 0, 0, 2], 1.0 / 56 ** 2, rtol=1e-5)
    assert abs(got[0, 2, 2, 0] - boxes[0, 2, 2]) < 0.6 * (boxes[0, 2, 2] - boxes[0, 2, 0]) / 56


# -- the whole model -------------------------------------------------------------------

@pytest.fixture(scope="module", params=[False, True], ids=["keypoint", "mask_keypoint"])
def kp(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(c4, "tame", tame_r18)
        return c4.predict_pair(*kp_cfgs(**{"MODEL.MASK_ON": request.param}))


def test_keypoint_detections_match_jax(kp):
    check_detections(kp)


def test_keypoint_predictions_match_jax(kp):
    """``pred_keypoints [B, 100, 17, 3]`` slot by slot: x, y to 1e-4, the
    scores to 1e-5; every keypoint of a valid detection inside its box."""
    got, want = kp["tout"].pred_keypoints.numpy(), kp["jout"].pred_keypoints
    assert got.shape == want.shape == (2, 100, 17, 3)
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-5)
    boxes, valid = kp["tout"].boxes.numpy(), kp["tout"].is_valid.numpy()
    for c in (0, 1):
        inside = ((got[..., c] >= boxes[..., None, c]) & (got[..., c] <= boxes[..., None, c + 2]))
        assert inside[valid].all()


def test_keypoint_masks_match_jax(kp):
    check_masks(kp, 28)


def test_keypoint_predict_pools_detections_for_the_heads(kp, monkeypatch):
    """Serving pools the proposals (the box head) and, per head on, the
    detections: 2 pools for Keypoint R-CNN, 3 with masks."""
    calls = []
    real = tp.roi_patch_interpolate
    monkeypatch.setattr(tp, "roi_patch_interpolate",
                        lambda *a, **k: calls.append(a[1].shape) or real(*a, **k))
    kp["tmodel"].predict(kp["tbatch"])
    assert len(calls) == (3 if kp["tcfg"].MODEL.MASK_ON else 2)


@pytest.fixture(scope="module", params=[False, True], ids=["keypoint", "mask_keypoint"])
def kp_train(request):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(c4, "tame", tame_r18)
        return c4.train_pair(*kp_cfgs(**{"MODEL.MASK_ON": request.param,
                                         "INPUT.MAX_GT_INSTANCES": 5,
                                         "SOLVER.IMS_PER_BATCH": 2,
                                         "MODEL.RPN.POST_NMS_TOPK_TRAIN": 200}))


def test_keypoint_train_losses_match_jax(kp_train):
    """The RPN's, box, (mask) and keypoint losses, each to 1e-5 (the mask
    loss 3e-4), in the JAX package's order."""
    got, want = kp_train["t_losses"], kp_train["j_losses"]
    keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg") + (
        ("loss_mask",) if kp_train["tcfg"].MODEL.MASK_ON else ()) + ("loss_keypoint",)
    assert tuple(got) == keys and set(want) == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=MASK_LOSS_RTOL if k == "loss_mask"
                                   else LOSS_RTOL, err_msg=k)
    assert got["loss_keypoint"] > 0


def test_keypoint_train_gradients_match_jax(kp_train):
    """Every trainable parameter's gradient against ``jax.grad``, the
    keypoint head's included; the deconv bias's (zero) below 1e-4 of the
    head's largest weight gradient on both sides."""
    want = convert_variables({"params": kp_train["j_grads"]})
    got = kp_train["t_grads"]
    trainable = tsolver.trainable_parameters(kp_train["tmodel"], 2)
    assert set(got) == set(trainable)
    scale = float(np.abs(got["roi_heads.keypoint_head.score_lowres.weight"]).max())
    for name, w in want.items():
        if name == BIAS:
            assert np.abs(got[name]).max() <= GRAD_TOL * scale
            assert np.abs(w.numpy()).max() <= GRAD_TOL * scale
        elif name in trainable:
            assert_grad_close(got[name], w.numpy(), name)
        else:
            assert name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")), name
            assert not w.numpy().any(), name
    assert np.abs(got["roi_heads.keypoint_head.conv_fcn1.weight"]).max() > 0


def test_keypoint_train_step_matches_jax_update(kp_train):
    """``create_train_state`` + ``build_train_step``: the total loss and one
    step's updates against the JAX gradients through the optax chain (the
    deconv bias's update, of a zero gradient, below 1e-4 of the deconv
    weight's on both sides)."""
    run = kp_train
    tcfg = run["tcfg"]
    start = convert_variables(run["variables"])
    model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    state = create_train_state(tcfg, model, torch.Generator().manual_seed(0))
    with jax_proposals(model, run["j_raw"]):
        metrics = build_train_step(tcfg, state)(run["tbatch"], noise=run["noise"])
    np.testing.assert_allclose(float(metrics["total_loss"]), run["j_total"], rtol=LOSS_RTOL,
                               atol=MASK_LOSS_RTOL * run["j_losses"].get("loss_mask", 0.0))
    want = convert_variables({"params": jax_updated_params(run["jcfg"], run["variables"]["params"],
                                                           run["j_grads"])})
    params = dict(model.named_parameters())
    weight = BIAS.replace("bias", "weight")
    scale = float(np.abs(want[weight].numpy() - start[weight].numpy()).max())
    for name, p in params.items():
        got = p.detach().numpy()
        if name == BIAS:
            assert np.abs(got - start[name].numpy()).max() <= GRAD_TOL * scale
            assert np.abs(want[name].numpy() - start[name].numpy()).max() <= GRAD_TOL * scale
            continue
        assert_update_close(got, want[name].numpy(), start[name].numpy(), GRAD_TOL, name)


def test_keypoint_train_pools_box_and_heads_in_one_op(kp_train, monkeypatch):
    """One fused pool: the box set, (the mask set) and the keypoint set, in
    that order, each ``(starts, wy, wx)``; the keypoint set at 14 x 14."""
    calls = []
    real = tp.RoiPatchPoolMulti.apply
    monkeypatch.setattr(tp.RoiPatchPoolMulti, "apply",
                        lambda *a: calls.append([t.shape[-2] for t in a[2::3]]) or real(*a))
    with torch.no_grad(), jax_proposals(kp_train["tmodel"], kp_train["j_raw"]):
        kp_train["tmodel"].losses(kp_train["tbatch"], noise=kp_train["noise"])
    assert calls == [[7, 14, 14] if kp_train["tcfg"].MODEL.MASK_ON else [7, 14]]


# -- the family around it ------------------------------------------------------------------

@pytest.mark.parametrize("path", KP_YAMLS)
def test_keypoint_yaml_builds_the_jax_tree(path):
    """Each keypoint YAML builds (narrow) with the JAX model's tensors
    (``keypoint_head/conv_fcn{i}``, ``score_lowres``), name for name."""
    jcfg, tcfg = yaml_cfgs(path, **KP_NARROW)
    want = {k: tuple(v.shape) for k, v in convert_variables(jax_param_shapes(jcfg)).items()}
    got = _port_shapes(tcfg)
    assert got == want
    assert got["roi_heads.keypoint_head.score_lowres.weight"] == (32, 17, 4, 4)
    assert tcfg.MODEL.KEYPOINT_ON and tcfg.MODEL.ROI_KEYPOINT_HEAD.POOLER_SAMPLING_RATIO == 2


def test_convert_d2_weights_keypoint_matches_jax_converter():
    """A seeded Detectron2-named Keypoint R-CNN state dict
    (``roi_heads.keypoint_head.conv_fcn{i}``, ``score_lowres``) through the
    port's converter equals the JAX converter's tree carried by
    ``convert_variables`` (whose deconv flip undoes the JAX converter's)."""
    jcfg, tcfg = kp_cfgs()
    rng = np.random.default_rng(7)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in _port_shapes(tcfg).items()}
    got, got_left = convert_d2_weights(dict(sd), tcfg)
    tree, want_left = jax_convert_d2(dict(sd), jcfg)
    want = convert_variables(tree)
    assert set(got) == set(want) and "roi_heads.keypoint_head.conv_fcn2.bias" in got
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(got["roi_heads.keypoint_head.score_lowres.weight"],
                       torch.from_numpy(sd["roi_heads.keypoint_head.score_lowres.weight"]))
    assert got_left == want_left == []


def test_keypoint_model_on_the_jax_end_to_end_case():
    """``tests/test_keypoints.py``'s case (the keypoint YAML at ResNet-18, a
    head of two 64-wide convs, 100/50 RPN proposals, 16 ROIs, 5 detections,
    one 64 x 64 image with two GT boxes, 17 keypoints in the first) through
    the port: a finite loss with ``loss_keypoint``, ``pred_keypoints`` of
    shape (1, 5, 17, 3), each valid detection's keypoints inside its box."""
    cfg = get_cfg()
    cfg.merge_from_file(c4.os.path.join(c4.REPO, KP_YAML))
    cfg.MODEL.RESNETS.DEPTH = 18
    cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = (64, 64)
    cfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN = 100
    cfg.MODEL.RPN.POST_NMS_TOPK_TRAIN = 50
    cfg.MODEL.RPN.PRE_NMS_TOPK_TEST = 100
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 50
    cfg.MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE = 16
    cfg.TEST.DETECTIONS_PER_IMAGE = 5
    kp = np.zeros((1, 2, 17, 3), np.float32)
    kp[0, 0, :, 0] = np.linspace(10, 28, 17)
    kp[0, 0, :, 1] = np.linspace(10, 28, 17)
    kp[0, 0, :, 2] = 2
    batch = {"image": torch.full((1, 64, 64, 3), 90.0),
             "image_size": torch.tensor([[64, 64]], dtype=torch.int32),
             "gt_boxes": torch.tensor([[[8.0, 8.0, 30.0, 30.0], [32.0, 32.0, 60.0, 60.0]]]),
             "gt_classes": torch.zeros((1, 2), dtype=torch.int32),
             "gt_valid": torch.ones((1, 2), dtype=torch.bool),
             "gt_keypoints": torch.from_numpy(kp)}
    model = build_model(cfg, device="cpu", training=True, init="jax",
                        generator=torch.Generator().manual_seed(0))
    losses = model.losses(batch, generator=torch.Generator().manual_seed(1))
    assert "loss_keypoint" in losses
    assert np.isfinite(float(sum(losses.values()).detach()))
    out = model.predict(batch)
    assert tuple(out.pred_keypoints.shape) == (1, 5, 17, 3)
    kps, boxes, valid = out.pred_keypoints[0], out.boxes[0], out.is_valid[0]
    for i in range(5):
        if valid[i]:
            assert bool((kps[i, :, 0] >= boxes[i, 0] - 1e-3).all())
            assert bool((kps[i, :, 0] <= boxes[i, 2] + 1e-3).all())


def test_make_train_batch_draws_keypoints_last():
    """With ``KEYPOINT_ON`` the synthetic batch gains ``gt_keypoints [B, G,
    K, 3]`` inside the GT boxes, visibility in {0, 1, 2}, and keeps every
    other field as drawn without keypoints."""
    _, tcfg = kp_cfgs(**{"INPUT.MAX_GT_INSTANCES": 4, "SOLVER.IMS_PER_BATCH": 2})
    with_kp = make_train_batch(tcfg, 64, 96)
    tcfg.MODEL.KEYPOINT_ON = False
    without = make_train_batch(tcfg, 64, 96)
    assert set(with_kp) == set(without) | {"gt_keypoints"}
    for k, v in without.items():
        np.testing.assert_array_equal(with_kp[k], v)
    kp, boxes = with_kp["gt_keypoints"], with_kp["gt_boxes"]
    assert kp.shape == (2, 4, 17, 3) and set(np.unique(kp[..., 2])) <= {0.0, 1.0, 2.0}
    assert ((kp[..., 0] >= boxes[..., None, 0]) & (kp[..., 0] <= boxes[..., None, 2])).all()


def test_keypoint_head_serving_init_keeps_the_deconv_unit_gain():
    """The serving init's deconv std counts the taps each output sums
    (``in * (kernel / stride)^2``): the mask head's 2x2 deconv keeps its
    ``sqrt(2 / in)``, the keypoint head's 4x4 stride-2 one gets ``sqrt(2 /
    (4 in))``."""
    _, tcfg = kp_cfgs(**{"MODEL.MASK_ON": True, "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS": (256,)})
    model = build_model(tcfg, device="cpu", generator=torch.Generator().manual_seed(0))
    kp_w = model.roi_heads.keypoint_head.score_lowres.weight
    mask_w = model.roi_heads.mask_head.deconv.weight
    np.testing.assert_allclose(float(kp_w.std()), (2.0 / (256 * 4)) ** 0.5, rtol=0.05)
    np.testing.assert_allclose(float(mask_w.std()), (2.0 / mask_w.shape[0]) ** 0.5, rtol=0.05)


@pytest.mark.parametrize("family", ["c4", "cascade"])
def test_keypoints_on_c4_and_cascade_match_jax(family):
    """``KEYPOINT_ON`` on the C4 YAML (``Res5ROIHeads``: the keypoint
    pooler on the res4 plane) and the cascade's (``CascadeROIHeads``), each
    head pooling its ROIs on its own as the JAX package does: the
    keypoints of ``predict`` slot by slot (x, y 1e-4, scores 1e-5), the
    losses to 1e-5 (the mask loss 3e-4) and the keypoint head's gradients to
    1e-4 of their largest magnitude (the deconv bias's, zero, aside)."""
    path, extra = {"c4": (c4.C4_YAML, {}),
                   "cascade": ("configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml",
                               {"MODEL.NECK.OUT_CHANNELS": 32})}[family]
    kw = {"MODEL.KEYPOINT_ON": True, "MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS": (32, 32), **extra}
    p = c4.predict_pair(*yaml_cfgs(path, **kw))
    check_detections(p)
    got, want = p["tout"].pred_keypoints.numpy(), p["jout"].pred_keypoints
    np.testing.assert_allclose(got[..., :2], want[..., :2], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got[..., 2], want[..., 2], rtol=0, atol=1e-5)
    run = c4.train_pair(*yaml_cfgs(path, **kw, **{"INPUT.MAX_GT_INSTANCES": 5,
                                                  "SOLVER.IMS_PER_BATCH": 2}))
    assert set(run["t_losses"]) == set(run["j_losses"]) and "loss_keypoint" in run["t_losses"]
    for k, v in run["t_losses"].items():
        np.testing.assert_allclose(v, run["j_losses"][k], rtol=MASK_LOSS_RTOL if k == "loss_mask"
                                   else LOSS_RTOL, err_msg=k)
    want = convert_variables({"params": run["j_grads"]})
    heads = [n for n in want if n.startswith("roi_heads.keypoint_head.") and n != BIAS]
    assert len(heads) == 5
    for name in heads:
        assert_grad_close(run["t_grads"][name], want[name].numpy(), name)
