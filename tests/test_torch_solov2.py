"""SOLOv2 (``SingleStageDetector`` with ``SOLOv2Head``: the grid resize, the
category and kernel towers, the mask-feature branch, the GT assignment, the
losses, matrix NMS and inference) against the JAX package.

``configs/COCO-InstanceSegmentation/solo_v2_R_50_FPN_1x.yaml`` at narrow
widths (``SOLO_NARROW``: R50 depth, stem 16, res2 32, 8 per group, FPN 32,
4 classes, grids 12/10/8/6/4, two 64-wide tower convs, mask features 32,
float32) on 2 x 128 x 160 images. The same seeded numpy inputs and weights
(the JAX ones carried over by ``convert.py``) go through both packages. The
JAX head's classifier and kernel predictors start at normal(0.01), which
leaves every score within ~1e-3 of the prior and every mask logit near 0;
``spread`` scales them (x30, x10) so that scores and mask pixels sit clear
of the packages' float32 rounding. Tolerances:
  * integer outputs (valid slots, classes, masks) equal;
  * the antialiased grid resize: float32 two float32 ulps (2^-22) of the
    larger of 1 and the value (2.4e-7 at most on unit normals); bf16 2^-8
    of the input's largest magnitude (the JAX resize rounds to bf16 after
    each axis, the port once, after a float32 resize);
  * the head's outputs, and the losses' gradients with respect to them,
    1e-5 of each tensor's largest magnitude, the loss values 1e-5
    relative (``dice+bce`` on unsaturated mask logits: see
    ``test_losses_and_their_gradients_match_jax``); a whole model's head
    outputs, through the trunk and the FPN, the standing 1e-4;
  * scores and matrix-NMS decays 1e-5 relative; boxes (mask extents)
    equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.meta_arch.common import preprocess_images as jax_prep
from detectron2_tensorflow_tpu.models.single_stage.solov2 import SOLOv2 as JaxSOLOv2
from detectron2_tensorflow_tpu.models.single_stage.solov2 import _coord_grids
from detectron2_tensorflow_tpu.ops.nms import matrix_nms as jax_matrix_nms
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.models import SingleStageDetector, build_model
from detectron2_tensorflow_tpu_torch.models.single_stage.solov2 import (
    SOLOv2,
    SOLOv2Head,
    coord_grids,
    resize_to_grid,
)
from detectron2_tensorflow_tpu_torch.ops.nms import matrix_nms
from test_pipeline_oracle import np_matrix_nms
from test_torch_c4 import B, H, W, SIZES, images, jax_init, tame, yaml_cfgs
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

SOLO_YAML = "configs/COCO-InstanceSegmentation/solo_v2_R_50_FPN_1x.yaml"
SOLO_NARROW = {
    "MODEL.NECK.OUT_CHANNELS": 32,
    "MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES": 4,
    "MODEL.SOLO.NUM_GRIDS": [12, 10, 8, 6, 4],
    "MODEL.SOLO.MASK_KERNEL_CONVS_DIM": 64,
    "MODEL.SOLO.MASK_KERNEL_NUM_CONVS": 2,
    "MODEL.SOLO.MASK_FEATURE_CONVS_DIM": 32,
    "MODEL.SOLO.MASK_FEATURE_OUT_DIMS": 32,
    "MODEL.SOLO.TOPK_CANDIDATES_TEST": 50,
    "TEST.DETECTIONS_PER_IMAGE": 8,
}
HEAD_TOL = 1e-5
MODEL_TOL = 1e-4  # a whole model's outputs, through the trunk and the FPN
BCE_KERNEL_STD = 0.1  # dice+bce's loss test: mask logits clear of saturation
BF16_REL = 2.0 ** -8
F32_ULPS = 2.0 ** -22  # two float32 ulps at 1


def solo_cfgs(**overrides):
    """(JAX cfg, port cfg): the SOLOv2 YAML at narrow widths."""
    return yaml_cfgs(SOLO_YAML, **{**SOLO_NARROW, **overrides})


def spread(variables, cate=30.0, kernel=10.0):
    """``tame`` (the trunk's FrozenBN scales), then the head's ``cate_pred``
    kernel x ``cate`` and ``kernel_pred`` kernel x ``kernel`` (module
    docstring)."""
    v = tame(variables)
    head = v["params"]["head"]
    head["cate_pred"]["conv"]["kernel"] *= cate
    head["kernel_pred"]["conv"]["kernel"] *= kernel
    return v


def assert_rel_close(got, want, tol, name=""):
    """Within ``tol`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


# -- the grid resize, the coord channels, matrix NMS -------------------------------------

@pytest.mark.parametrize("shape,size", [((13, 21), 12), ((200, 336), 40), ((25, 42), 16),
                                        ((2, 4), 8), ((7, 5), 6), ((12, 12), 12)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_resize_to_grid_matches_jax_image_resize(shape, size, dtype):
    """The antialiased bilinear resize of each level to its grid, shrinking
    (p2 200x336 -> 40 at full width, p6 13x21 -> 12), mixed (the overfit
    recipe's p6, 2x4 -> 8: one axis grows, one shrinks) and at identity;
    plain ``F.interpolate`` bilinear differs by up to ~1 on unit normals."""
    x = np.random.default_rng(0).standard_normal((2,) + shape + (3,)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(jax.image.resize(jnp.asarray(x, jdt), (2, size, size, 3), "bilinear"),
                      np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype)).permute(0, 3, 1, 2)
    got = resize_to_grid(tx, size)
    assert got.dtype == tx.dtype
    got = got.float().permute(0, 2, 3, 1).numpy()
    tol = (F32_ULPS * np.maximum(np.abs(want), 1.0) if dtype == "float32"
           else BF16_REL * np.abs(x).max())
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()
    if shape[0] > size and shape[1] > size:  # plain bilinear is not this rule
        plain = torch.nn.functional.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2),
                                                size=(size, size), mode="bilinear")
        assert np.abs(plain.permute(0, 2, 3, 1).numpy() - want).max() > 1e-3


@pytest.mark.parametrize("n", [1, 2, 5, 7, 12, 40, 336])
def test_coord_grids_match_jax(n):
    """x then y in [-1, 1]; ``torch.linspace`` and ``jnp.linspace`` round a
    few values to neighbouring floats (XLA folds the JAX formula its own
    way), so within one float32 ulp at 1."""
    want = np.asarray(_coord_grids(n, 7, jnp.float32))  # [h, w, 2], x then y
    got = coord_grids(1, n, 7, torch.float32, "cpu")[0].permute(1, 2, 0).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2.0 ** -23)
    assert got[0, 0].tolist() == [-1.0, -1.0] and got[-1, -1].tolist() == [1.0, 1.0 if n > 1
                                                                           else -1.0]


def random_masks(rng, b, n, h, w):
    """``[b, n, h, w]`` binary masks: random rectangles, some repeated
    (IoU 1), some empty."""
    masks = np.zeros((b, n, h, w), bool)
    for i in range(b):
        for j in range(n):
            if j % 7 == 6:
                continue  # empty
            if j % 5 == 4:
                masks[i, j] = masks[i, j - 1]
                continue
            y0, x0 = rng.integers(0, h - 4), rng.integers(0, w - 4)
            masks[i, j, y0:y0 + rng.integers(2, h - y0 + 1), x0:x0 + rng.integers(2, w - x0 + 1)] = 1
    return masks


@pytest.mark.parametrize("kernel,sigma", [("gaussian", 2.0), ("linear", 2.0), ("gaussian", 0.5)])
@pytest.mark.parametrize("ties", [False, True])
def test_matrix_nms_matches_jax(kernel, sigma, ties):
    """Decayed scores of score-sorted masks (some repeated, some empty; with
    ``ties`` every score equal) against the JAX ``matrix_nms`` and the
    pipeline oracle's numpy transcription, per image of the batch."""
    rng = np.random.default_rng(4)
    b, n = 2, 40
    masks = random_masks(rng, b, n, 24, 30)
    labels = rng.integers(0, 3, (b, n)).astype(np.int32)
    scores = np.full((b, n), 0.4, np.float32) if ties else \
        -np.sort(-rng.uniform(0.05, 1.0, (b, n))).astype(np.float32)
    got = matrix_nms(torch.from_numpy(masks), torch.from_numpy(labels),
                     torch.from_numpy(scores), sigma=sigma, kernel=kernel).numpy()
    for i in range(b):
        want = np.asarray(jax_matrix_nms(jnp.asarray(masks[i], jnp.float32),
                                         jnp.asarray(labels[i]), jnp.asarray(scores[i]),
                                         sigma=sigma, kernel=kernel))
        np.testing.assert_allclose(got[i], want, rtol=1e-5, atol=1e-7)
        oracle = np_matrix_nms(masks[i].astype(np.float32), labels[i], scores[i], sigma, kernel)
        np.testing.assert_allclose(got[i], oracle, rtol=1e-5, atol=1e-7)
    assert (got < scores - 1e-3).any() and (got <= scores + 1e-7).all()


def test_matrix_nms_unknown_kernel_raises():
    m = torch.zeros((1, 2, 4, 4), dtype=torch.bool)
    with pytest.raises(ValueError, match="box"):
        matrix_nms(m, torch.zeros((1, 2)), torch.ones((1, 2)), kernel="box")


# -- the head -------------------------------------------------------------------------------

FEATURE_SIZES = {"p2": (32, 40), "p3": (16, 20), "p4": (8, 10), "p5": (4, 5), "p6": (2, 3)}


def head_pair(deform=False, modulated=False):
    """The JAX head module's float32 outputs on seeded features, and the
    port's head with the same (spread) weights."""
    jcfg, tcfg = solo_cfgs(**{"MODEL.SOLO.USE_DEFORM_CONV": deform,
                              "MODEL.SOLO.DEFORM_MODULATED": modulated})
    rng = np.random.default_rng(7)
    feats = {f: rng.standard_normal((B,) + hw + (32,)).astype(np.float32)
             for f, hw in FEATURE_SIZES.items()}
    module = JaxSOLOv2(jcfg, {}).head_module(jcfg, jnp.float32)
    params = jax.jit(module.init)(jax.random.PRNGKey(3), {f: jnp.asarray(v) for f, v in
                                                          feats.items()})["params"]
    params = jax.tree_util.tree_map(np.array, params)
    params["cate_pred"]["conv"]["kernel"] *= 30.0
    params["kernel_pred"]["conv"]["kernel"] *= 10.0
    if deform:  # offsets away from zero: samples between pixels and off the map
        for name, mod in params.items():
            if "conv_offset" in mod["conv"]:
                off = mod["conv"]["conv_offset"]
                off["bias"] = rng.uniform(-1.5, 1.5, off["bias"].shape).astype(np.float32)
                off["kernel"] = rng.normal(0, 0.02, off["kernel"].shape).astype(np.float32)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(module.apply)(
        {"params": params}, {f: jnp.asarray(v) for f, v in feats.items()}))
    sd = {k[len("head."):]: v for k, v in convert_variables({"params": {"head": params}}).items()}
    head = SOLOv2(tcfg).build_head(tcfg, 32)
    head.load_state_dict(sd)
    tfeats = {f: torch.from_numpy(v).permute(0, 3, 1, 2) for f, v in feats.items()}
    return head, tfeats, want


@pytest.mark.parametrize("deform,modulated", [(False, False), (True, False), (True, True)])
def test_head_outputs_match_jax(deform, modulated):
    """Category logits and kernels per level and the mask features, the
    deformable towers (``MODEL.SOLO.USE_DEFORM_CONV``, v1 and v2) too."""
    head, tfeats, (w_cate, w_kern, w_mask) = head_pair(deform, modulated)
    assert isinstance(head, SOLOv2Head)
    with torch.no_grad():
        cate, kern, mask = head(tfeats)
    for lvl, (c, k, wc, wk) in enumerate(zip(cate, kern, w_cate, w_kern)):
        assert_rel_close(c.numpy(), wc, HEAD_TOL, f"cate {lvl}")
        assert_rel_close(k.numpy(), wk, HEAD_TOL, f"kernels {lvl}")
    assert_rel_close(mask.permute(0, 2, 3, 1).numpy(), w_mask, HEAD_TOL, "mask features")
    assert np.abs(w_mask).max() > 0.1 and np.abs(w_cate[0]).std() > 0.1


def test_head_tower_widths_and_names():
    """The kernel tower's first conv reads C + 2 channels (the coords), the
    category tower's C; the mask branch's last level adds the coords; p5
    chains three convs, p4 two, p3 and p2 one (the converter's names)."""
    _, tcfg = solo_cfgs()
    head = SOLOv2(tcfg).build_head(tcfg, 32)
    sd = head.state_dict()
    assert sd["kernel_tower_0.weight"].shape[1] == 34
    assert sd["cate_tower_0.weight"].shape[1] == 32
    assert sd["mask_p5_0.weight"].shape[1] == 34 and sd["mask_p2_0.weight"].shape[1] == 32
    assert {k.split(".")[0] for k in sd if k.startswith("mask_")} == {
        "mask_p2_0", "mask_p3_0", "mask_p4_0", "mask_p4_1", "mask_p5_0", "mask_p5_1",
        "mask_p5_2", "mask_pred"}


# -- GT assignment, losses, inference --------------------------------------------------------

def random_gt(rng, b=B, g=6, h=H, w=W, ties=True):
    """Padded GT of ``b`` images: boxes of every level's size range at the
    input's scale, random mini-masks, the last slot invalid; with ``ties``
    two boxes repeat another (an argmin tie, to the first)."""
    xy = rng.uniform(0, 0.6, (b, g, 2)) * [w, h]
    wh = rng.uniform(4, 90, (b, g, 2))
    boxes = np.concatenate([xy, np.minimum(xy + wh, [w, h])], -1).astype(np.float32)
    if ties:
        boxes[:, 3] = boxes[:, 1]
        boxes[:, 4] = boxes[:, 1]
    valid = np.ones((b, g), bool)
    valid[:, -1] = False
    return {"gt_boxes": boxes, "gt_classes": rng.integers(0, 4, (b, g)).astype(np.int32),
            "gt_valid": valid, "gt_masks": rng.uniform(0, 1, (b, g, 28, 28)).astype(np.float32)}


def test_assign_level_matches_jax():
    """Every level's (category target, GT index, positive) equal, over boxes
    of several scales with argmin ties."""
    jcfg, tcfg = solo_cfgs()
    jdrv, tdrv = JaxSOLOv2(jcfg, {}), SOLOv2(tcfg)
    gt = random_gt(np.random.default_rng(1))
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    positives = 0
    for (lo, hi), grid in zip(tdrv.scale_ranges, tdrv.num_grids):
        got = tdrv.assign_level(tgt, grid, lo, hi, (H, W))
        want = jax.vmap(lambda g: jdrv._assign_level(g, grid, lo, hi, (H, W)))(
            {k: jnp.asarray(v) for k, v in gt.items()})
        for a, bb, name in zip(got, want, ("cate", "gt_idx", "pos")):
            np.testing.assert_array_equal(a.numpy(), np.asarray(bb), err_msg=f"{grid} {name}")
        positives += int(got[2].sum())
    assert positives > 10


def head_outputs(rng, drv, dm=32, hm=H // 4, wm=W // 4, kernel_std=0.5):
    """Random float32 head outputs: logits spread over a few units, kernels
    of std ``kernel_std`` (mask logits of std ``kernel_std * sqrt(32)``)
    and mask features of order one."""
    cate = [rng.normal(-2.0, 2.0, (B, s, s, drv.num_classes)).astype(np.float32)
            for s in drv.num_grids]
    kern = [rng.normal(0, kernel_std, (B, s, s, dm)).astype(np.float32)
            for s in drv.num_grids]
    mask = rng.normal(0, 1.0, (B, hm, wm, dm)).astype(np.float32)
    return cate, kern, mask


def jax_solo_noise(key, b, cells):
    """The JAX ``SOLOv2.losses``' positive-cap draws: ``U(0, 0.5)`` per image under its
    key split."""
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.uniform(k, (cells,), minval=0.0, maxval=0.5))
        for k in jax.random.split(key, b)]))


@pytest.mark.parametrize("loss_type", ["dice", "dice+bce"])
def test_losses_and_their_gradients_match_jax(loss_type):
    """``loss_ins`` and ``loss_cate`` and their gradients with respect to every
    head output, from the same positive-cap noise. ``dice+bce`` on mask
    logits of std ~0.6 (BCE_KERNEL_STD), where the port's BCE from the
    logits and the JAX package's through ``log(p + 1e-6)`` agree to ~1e-6:
    where the sigmoid saturates, the JAX BCE's gradient through ``log(1 - p
    + 1e-6)`` is one float32 ulp of ``p`` times up to 1e6, rounding noise
    (torch's sigmoid and XLA's differ by an ulp in ~0.4% of values), and
    below ``p`` = 1e-6 it vanishes
    (``test_dice_bce_keeps_its_gradient_where_the_masks_saturate``)."""
    jcfg, tcfg = solo_cfgs(**{"MODEL.SOLO.INS_LOSS_TYPE": loss_type})
    jdrv, tdrv = JaxSOLOv2(jcfg, {}), SOLOv2(tcfg)
    rng = np.random.default_rng(2)
    cate, kern, mask = head_outputs(rng, tdrv, kernel_std=0.5 if loss_type == "dice"
                                    else BCE_KERNEL_STD)
    gt = random_gt(rng)
    key = jax.random.PRNGKey(5)

    def jloss(c, k, m):
        out = jdrv.losses(key, c, k, m, {kk: jnp.asarray(v) for kk, v in gt.items()}, (H, W))
        return out["loss_ins"] + out["loss_cate"], out

    (_, want), grads = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True))(
        [jnp.asarray(c) for c in cate], [jnp.asarray(k) for k in kern], jnp.asarray(mask))
    tc = [torch.from_numpy(c).requires_grad_(True) for c in cate]
    tk = [torch.from_numpy(k).requires_grad_(True) for k in kern]
    tm = torch.from_numpy(mask).permute(0, 3, 1, 2).contiguous().requires_grad_(True)
    got = tdrv.losses(tc, tk, tm, {k: torch.from_numpy(v) for k, v in gt.items()}, (H, W),
                      noise=jax_solo_noise(key, B, tdrv.num_cells()))
    for k in ("loss_ins", "loss_cate"):
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=HEAD_TOL,
                                   err_msg=k)
    sum(got.values()).backward()
    for lvl in range(len(cate)):
        assert_rel_close(tc[lvl].grad.numpy(), np.asarray(grads[0][lvl]), HEAD_TOL,
                         f"dcate {lvl}")
        assert_rel_close(tk[lvl].grad.numpy(), np.asarray(grads[1][lvl]), HEAD_TOL,
                         f"dkern {lvl}")
    assert_rel_close(tm.grad.permute(0, 2, 3, 1).numpy(), np.asarray(grads[2]), HEAD_TOL,
                     "dmask")
    assert float(got["loss_ins"].detach()) > 0 and np.abs(np.asarray(grads[1][0])).max() > 0


def test_dice_bce_keeps_its_gradient_where_the_masks_saturate():
    """Every mask logit far below -14 (non-negative features, as after the
    mask branch's ReLU, against negative kernels): the JAX ``dice+bce``
    loses its gradient with respect to the kernels (``log(p + 1e-6)`` and the
    dice are flat there), which stalls a from-scratch run for good; the
    port's BCE, from the logits, pushes each positive pixel's logit up with
    a gradient of ``p - t`` (module docstring of ``models/single_stage/solov2.py``)."""
    jcfg, tcfg = solo_cfgs(**{"MODEL.SOLO.INS_LOSS_TYPE": "dice+bce"})
    jdrv, tdrv = JaxSOLOv2(jcfg, {}), SOLOv2(tcfg)
    rng = np.random.default_rng(2)
    cate, kern, mask = head_outputs(rng, tdrv, kernel_std=BCE_KERNEL_STD)
    mask = np.abs(mask) + 0.5
    kern = [-np.abs(k) - 1.0 for k in kern]  # logits below -16 (32 channels of >= 0.5)
    gt = random_gt(rng)
    key = jax.random.PRNGKey(5)

    def jloss(k):
        return jdrv.losses(key, [jnp.asarray(c) for c in cate], k, jnp.asarray(mask),
                           {kk: jnp.asarray(v) for kk, v in gt.items()}, (H, W))["loss_ins"]

    jgrad = jax.jit(jax.grad(jloss))([jnp.asarray(k) for k in kern])
    tk = [torch.from_numpy(k).requires_grad_(True) for k in kern]
    got = tdrv.losses([torch.from_numpy(c) for c in cate], tk,
                      torch.from_numpy(mask).permute(0, 3, 1, 2).contiguous(),
                      {k: torch.from_numpy(v) for k, v in gt.items()}, (H, W),
                      noise=jax_solo_noise(key, B, tdrv.num_cells()))
    got["loss_ins"].backward()
    want_max = max(float(np.abs(np.asarray(g)).max()) for g in jgrad)
    got_max = max(float(k.grad.abs().max()) for k in tk)
    assert got_max > 1e-3 and want_max < 1e-6 * got_max, (got_max, want_max)


def test_losses_need_noise_or_a_generator():
    _, tcfg = solo_cfgs()
    drv = SOLOv2(tcfg)
    cate, kern, mask = head_outputs(np.random.default_rng(0), drv)
    args = ([torch.from_numpy(c) for c in cate], [torch.from_numpy(k) for k in kern],
            torch.from_numpy(mask).permute(0, 3, 1, 2),
            {k: torch.from_numpy(v) for k, v in random_gt(np.random.default_rng(0)).items()},
            (H, W))
    with pytest.raises(ValueError, match="Generator"):
        drv.losses(*args)
    out = drv.losses(*args, generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(v)) for v in out.values())


def check_solo_detections(got, want):
    """Slot by slot: valid slots, classes, masks and boxes (mask extents)
    equal, scores 1e-5 relative."""
    np.testing.assert_array_equal(got["is_valid"], want["is_valid"])
    assert want["is_valid"].any(), "vacuous: no valid detections"
    np.testing.assert_array_equal(got["pred_classes"], want["pred_classes"])
    np.testing.assert_allclose(got["scores"], want["scores"], rtol=1e-5, atol=1e-7)
    assert got["pred_masks"].dtype == bool and want["pred_masks"][want["is_valid"]].any()
    np.testing.assert_array_equal(got["pred_masks"], want["pred_masks"])
    np.testing.assert_array_equal(got["boxes"], want["boxes"])


@pytest.mark.parametrize("kernel", ["gaussian", "linear"])
def test_inference_matches_jax(kernel):
    """Point NMS, the stable top-k, the dynamic conv, maskness, matrix NMS
    and the mask-extent boxes on random head outputs, slot by slot."""
    jcfg, tcfg = solo_cfgs(**{"MODEL.SOLO.NMS_KERNEL": kernel,
                              "MODEL.SOLO.UPDATE_SCORE_THRESH_TEST": 0.6,
                              "TEST.DETECTIONS_PER_IMAGE": 40})
    jdrv, tdrv = JaxSOLOv2(jcfg, {}), SOLOv2(tcfg)
    cate, kern, mask = head_outputs(np.random.default_rng(3), tdrv)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jdrv.inference)(
        [jnp.asarray(c) for c in cate], [jnp.asarray(k) for k in kern], jnp.asarray(mask),
        jnp.asarray(SIZES)))
    got = tdrv.inference([torch.from_numpy(c) for c in cate], [torch.from_numpy(k) for k in kern],
                         torch.from_numpy(mask).permute(0, 3, 1, 2))
    got = {k: v.numpy() for k, v in got.get_fields().items()}
    check_solo_detections(got, want.get_fields())
    assert not want.is_valid.all()  # the update threshold drops some


def test_mask_kernel_size_other_than_one_raises():
    """The kernel head emits ``size^2 * D`` channels but the dynamic conv is
    a 1x1 product over ``D``: the port raises by name, and the JAX package
    fails on the shapes."""
    jcfg, tcfg = solo_cfgs(**{"MODEL.SOLO.MASK_KERNEL_SIZE": 3})
    with pytest.raises(NotImplementedError, match="MASK_KERNEL_SIZE"):
        SOLOv2(tcfg)
    jdrv = JaxSOLOv2(jcfg, {})
    cate, kern, mask = head_outputs(np.random.default_rng(0), jdrv)
    kern = [np.concatenate([k] * 9, -1) for k in kern]  # the head's 9 * D channels
    with pytest.raises(Exception):
        jdrv.inference([jnp.asarray(c) for c in cate], [jnp.asarray(k) for k in kern],
                       jnp.asarray(mask), jnp.asarray(SIZES))


# -- the whole model -------------------------------------------------------------------------

@pytest.fixture(scope="module")
def solo():
    """Both packages' SOLOv2 on one batch from the same (spread) weights."""
    jcfg, tcfg = solo_cfgs(**{"MODEL.SOLO.SCORE_THRESH_TEST": 0.05,
                              "MODEL.SOLO.UPDATE_SCORE_THRESH_TEST": 0.02})
    batch, tbatch = images()
    jmodel = jax_build_model(jcfg)
    variables = spread(jax_init(jcfg, 0, batch))
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.predict)(variables, batch))

    def jhead(v, im):
        x = jax_prep(im, jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD, jcfg.MODEL.INPUT_FORMAT,
                     jnp.float32)
        return jmodel.module.apply(v, x, train=False)

    head = jax.tree_util.tree_map(np.asarray, jax.jit(jhead)(variables, batch["image"]))
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, batch=batch, tbatch=tbatch,
                jmodel=jmodel, tmodel=tmodel, jout=jout, tout=tmodel.predict(tbatch),
                jhead=head)


def test_model_is_a_solov2_single_stage_detector(solo):
    m = solo["tmodel"]
    assert isinstance(m, SingleStageDetector) and m.mask_on and isinstance(m.head, SOLOv2Head)
    assert not hasattr(m, "loss_normalizer")
    assert set(convert_variables(solo["variables"])) == set(m.state_dict())


def test_head_outputs_of_the_model_match_jax(solo):
    """Through the trunk and the FPN: the standing float32 1e-4."""
    with torch.no_grad():
        cate, kern, mask = solo["tmodel"]._head_outputs(solo["tbatch"]["image"])
    w_cate, w_kern, w_mask = solo["jhead"]
    for lvl in range(len(cate)):
        assert_rel_close(cate[lvl].numpy(), w_cate[lvl], MODEL_TOL, f"cate {lvl}")
        assert_rel_close(kern[lvl].numpy(), w_kern[lvl], MODEL_TOL, f"kernels {lvl}")
    assert_rel_close(mask.permute(0, 2, 3, 1).numpy(), w_mask, MODEL_TOL, "mask features")


def test_predict_matches_jax_slot_by_slot(solo):
    """``predict``: valid slots, classes, scores, whole-frame masks
    ``[B, D, H/4, W/4]`` and mask-extent boxes."""
    got = {k: v.numpy() for k, v in solo["tout"].get_fields().items()}
    want = solo["jout"].get_fields()
    assert got["pred_masks"].shape == (B, 8, H // 4, W // 4)
    check_solo_detections(got, want)
    assert got["is_valid"].sum() >= 4


def test_predict_matches_the_numpy_oracle(solo):
    """The pipeline oracle of ``tests/test_pipeline_oracle.py`` (point NMS by
    explicit windows, argsort top-k, einsum, maskness, numpy matrix NMS,
    mask extents) on the JAX head's outputs, against the port's
    ``predict``."""
    drv = solo["tmodel"].solov2
    cate, kernels, mask_feat = solo["jhead"]
    got = solo["tout"]
    for i in range(B):
        scores_l, kerns_l = [], []
        for logit, kern in zip(cate, kernels):
            s = 1.0 / (1.0 + np.exp(-np.asarray(logit[i], np.float32)))
            gh, gw, kc = s.shape
            padded = np.full((gh + 1, gw + 1, kc), -np.inf, np.float32)
            padded[1:, 1:] = s
            pooled = np.stack([padded[y:y + 2, x:x + 2].max(axis=(0, 1))
                               for y in range(gh) for x in range(gw)]).reshape(gh, gw, kc)
            scores_l.append(np.where(s == pooled, s, 0.0).reshape(-1, kc))
            kerns_l.append(kern[i].reshape(-1, kern.shape[-1]))
        flat = np.concatenate(scores_l).reshape(-1)
        kerns = np.concatenate(kerns_l)
        top = np.argsort(-flat, kind="stable")[:drv.topk]
        cell, cls = top // drv.num_classes, top % drv.num_classes
        pred = 1.0 / (1.0 + np.exp(-np.einsum("pe,hwe->phw", kerns[cell], mask_feat[i])))
        binary = pred > drv.mask_thresh
        areas = binary.sum(axis=(1, 2)).astype(np.float32)
        maskness = (pred * binary).sum(axis=(1, 2)) / np.maximum(areas, 1e-6)
        valid = (flat[top] > drv.score_thresh) & (areas > 0)
        scores2 = np.where(valid, flat[top] * maskness, 0.0)
        order = np.argsort(-scores2, kind="stable")
        decayed = np_matrix_nms(binary[order].astype(np.float32), cls[order], scores2[order],
                                drv.nms_sigma, drv.nms_kernel)
        gated = np.where(decayed > drv.update_thresh, decayed, 0.0)
        keep = np.argsort(-gated, kind="stable")[:drv.detections_per_image]
        ok = gated[keep] > 0
        np.testing.assert_array_equal(got.is_valid[i].numpy(), ok)
        np.testing.assert_allclose(got.scores[i].numpy()[ok], gated[keep][ok], rtol=1e-4)
        np.testing.assert_array_equal(got.pred_classes[i].numpy()[ok], cls[order][keep][ok])
        np.testing.assert_array_equal(got.pred_masks[i].numpy()[ok], binary[order][keep][ok])
        for j in np.flatnonzero(ok):
            ys, xs = np.nonzero(binary[order][keep][j])
            np.testing.assert_array_equal(got.boxes[i, j].numpy(),
                                          np.array([xs.min(), ys.min(), xs.max() + 1,
                                                    ys.max() + 1], np.float32) * 4.0)
