"""RetinaNet (``SingleStageDetector``: the P6P7 FPN, ``RetinaNetHead``, the
focal loss and dense inference) against the JAX package.

``configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml`` at narrow widths
(``RETINA_NARROW``: R50 depth, stem 16, res2 32, 8 per group, FPN 32, 5
classes, 50 candidates a level, float32) on 2 x 128 x 160 images. The same
seeded numpy inputs and weights (the JAX ones carried over by
``convert.py``) go through both packages; on the CPU the port's NMS takes
its plain version. The JAX weights are ``tame``d (``test_torch_c4.tame``)
and the head's kernels scaled up (``spread_head``) so that the sigmoid
scores spread over (0, 1): at the JAX init (normal 0.01) every logit sits
within ~1e-4 of the prior bias, and two candidates closer than the
packages' float32 rounding would trade top-k slots. Tolerances are the
port's standing ones: valid slots, classes and NMS keeps equal; float32
values 1e-4; losses 1e-5 relative; gradients and one step's updates 1e-4 of
each tensor's largest magnitude; the loss normalizer 1e-6 relative.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from detectron2_tensorflow_tpu import solver as jsolver
from detectron2_tensorflow_tpu.convert.d2 import convert_d2_weights as jax_convert_d2
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models import losses as jlosses
from detectron2_tensorflow_tpu.models.meta_arch.common import preprocess_images as jax_prep
from detectron2_tensorflow_tpu.models.meta_arch.single_stage import _build_backbone_neck
from detectron2_tensorflow_tpu.models.single_stage.retinanet import RetinaNet as JaxRetinaNet
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.config import small_cfg
from detectron2_tensorflow_tpu_torch.convert import _port_shapes, convert_d2_weights
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.data import SyntheticDataset, build_dataloader
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
    run_evaluation,
    train,
)
from detectron2_tensorflow_tpu_torch.models import SingleStageDetector, build_model
from detectron2_tensorflow_tpu_torch.models import losses as tlosses
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import meta_architecture
from detectron2_tensorflow_tpu_torch.models.single_stage.retinanet import level_top_k
from detectron2_tensorflow_tpu_torch.ops.topk import top_k
from test_torch_c4 import (
    LOSS_RTOL,
    RTOL,
    ATOL,
    B,
    G,
    H,
    W,
    SIZES,
    _tagged,
    check_overfit_cfg,
    images,
    jax_init,
    jax_param_shapes,
    run_overfit_check,
    tame,
    yaml_cfgs,
)
from test_torch_train import GRAD_TOL, assert_grad_close, assert_update_close
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

RETINA_YAML = "configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml"
RETINA_YAMLS = ["configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml",
                "configs/COCO-Detection/retinanet_R_50_FPN_3x.yaml",
                "configs/COCO-Detection/retinanet_R_101_FPN_3x.yaml"]
RETINA_NARROW = {"MODEL.NECK.OUT_CHANNELS": 32, "MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES": 5,
                 "MODEL.RETINANET.TOPK_CANDIDATES_TEST": 50}
NORM_RTOL = 1e-6


def retina_cfgs(**overrides):
    """(JAX cfg, port cfg): the RetinaNet YAML at narrow widths."""
    return yaml_cfgs(RETINA_YAML, **{**RETINA_NARROW, **overrides})


def spread_head(variables):
    """``tame`` (trunk FrozenBN scales), then the head's kernels x3 (the
    towers' std 0.03, about He-normal's) and the classifier's x30 more, so
    that the logits are of order one (the deltas stay small: a box's
    float32 error grows with its delta times its anchor's size)."""
    v = tame(variables)
    head = v["params"]["head"]
    for name, mod in head.items():
        mod["conv"]["kernel"] *= 90.0 if name == "cls_score" else 3.0
    return v


def jax_head(jmodel, jcfg, variables, image):
    """The JAX model's float32 head outputs (logits, deltas) per level."""
    def fn(v, im):
        x = jax_prep(im, jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD, jcfg.MODEL.INPUT_FORMAT,
                     jnp.float32)
        return jmodel.module.apply(v, x, train=False)
    return jax.tree_util.tree_map(np.asarray, jax.jit(fn)(variables, image))


# -- modules ---------------------------------------------------------------------------

@pytest.mark.parametrize("alpha,gamma", [(0.25, 2.0), (-1.0, 2.0), (0.5, 1.5)])
def test_sigmoid_focal_loss_and_its_gradient_match_jax(alpha, gamma):
    """Values and gradients at random logits and at exact zeros (where the
    sigmoid CE's subgradient is a choice; the port's ``sigmoid_cross_entropy``
    takes the JAX package's there)."""
    rng = np.random.default_rng(0)
    logits = np.concatenate([rng.normal(0, 3, 60), np.zeros(4)]).astype(np.float32)
    t = np.concatenate([rng.integers(0, 2, 60), [0, 1, 0, 1]]).astype(np.float32)
    x = torch.from_numpy(logits).requires_grad_(True)
    got = tlosses.sigmoid_focal_loss(x, torch.from_numpy(t), alpha, gamma)
    got.sum().backward()
    want = jlosses.sigmoid_focal_loss(jnp.asarray(logits), jnp.asarray(t), alpha, gamma)
    grad = jax.grad(lambda z: jlosses.sigmoid_focal_loss(z, jnp.asarray(t), alpha, gamma).sum())(
        jnp.asarray(logits))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(grad), rtol=1e-5, atol=1e-7)


@pytest.fixture(scope="module")
def retina():
    """Both packages' RetinaNet on one batch from the same weights: JAX
    ``predict`` and head outputs, and the port's model."""
    jcfg, tcfg = retina_cfgs()
    batch, tbatch = images()
    jmodel = jax_build_model(jcfg)
    variables = spread_head(jax_init(jcfg, 0, batch))
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.predict)(variables, batch))
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, batch=batch, tbatch=tbatch,
                jmodel=jmodel, tmodel=tmodel, jout=jout, tout=tmodel.predict(tbatch),
                jhead=jax_head(jmodel, jcfg, variables, batch["image"]))


def test_retinanet_model_layout(retina):
    """FPN over res3..res5 with the P6P7 block (``backbone.top_block.p6``,
    ``.p7`` on p5's 32 channels), the head's towers as Detectron2 names them
    (``head.cls_subnet.{0,2,4,6}``), 9 anchors of 3 sizes x 3 ratios a
    location on five levels, the normalizer at 100."""
    m = retina["tmodel"]
    sd = m.state_dict()
    assert sd["backbone.top_block.p6.weight"].shape == (32, 32, 3, 3)
    assert "backbone.fpn_lateral2.weight" not in sd
    assert [k for k in sd if k.startswith("head.cls_subnet.") and k.endswith("weight")] == [
        f"head.cls_subnet.{i}.weight" for i in (0, 2, 4, 6)]
    assert sd["head.cls_score.weight"].shape == (9 * 5, 256, 3, 3)
    ag = m.retinanet.anchor_generator
    assert ag.num_anchors_per_location == [9] * 5 and ag.strides == [8, 16, 32, 64, 128]
    np.testing.assert_allclose(ag.cell_anchors[0][1::3, 2] * 2, [32, 32 * 2 ** (1 / 3),
                                                                32 * 2 ** (2 / 3)], rtol=1e-6)
    assert float(m.loss_normalizer) == 100.0 and m.loss_normalizer.dtype == torch.float32


def test_full_size_anchors_are_the_jax_ones():
    """At 800x1344 both packages put 201,600 anchors (9 a location on p3-p7:
    100 x 168 down to 7 x 11) at the same coordinates."""
    jcfg, tcfg = retina_cfgs()
    _, _, neck_shapes, _ = _build_backbone_neck(jcfg)
    jdrv = JaxRetinaNet(jcfg, neck_shapes)
    grids = [(-(-800 // s), -(-1344 // s)) for s in (8, 16, 32, 64, 128)]
    with torch.device("meta"):
        model = SingleStageDetector(tcfg)
    got = torch.cat(model.retinanet.anchor_generator(grids), 0).numpy()
    want = np.concatenate([np.asarray(a) for a in jdrv.anchor_generator(grids)])
    assert got.shape == want.shape == (201_600, 4)
    np.testing.assert_array_equal(got, want)


def test_p6p7_features_match_jax(retina):
    """The P6P7 FPN's p3-p7 against the JAX neck's, 1e-4 of each level's max."""
    jcfg, jmodel, variables = retina["jcfg"], retina["jmodel"], retina["variables"]

    def neck(v, im):
        x = jax_prep(im, jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD, jcfg.MODEL.INPUT_FORMAT,
                     jnp.float32)
        return jmodel.module.apply(v, x, method=lambda m, y: m.neck(m.backbone(y)))

    want = jax.tree_util.tree_map(np.asarray, jax.jit(neck)(variables, retina["batch"]["image"]))
    with torch.no_grad():
        got = retina["tmodel"].features(retina["tbatch"]["image"])
    assert sorted(got) == sorted(want) == ["p3", "p4", "p5", "p6", "p7"]
    for f in want:
        g = got[f].permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(g, want[f], rtol=0, atol=1e-4 * np.abs(want[f]).max(),
                                   err_msg=f)
    assert want["p7"].shape[1:3] == (1, 2)


def test_retinanet_head_matches_jax(retina):
    """The shared towers' logits ``[B, H, W, 45]`` and deltas ``[B, H, W,
    36]`` on every level, 1e-4 of each one's max."""
    with torch.no_grad():
        logits, deltas = retina["tmodel"]._head_outputs(retina["tbatch"]["image"])
    jl, jd = retina["jhead"]
    for got, want in zip(logits + deltas, list(jl) + list(jd)):
        assert tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * np.abs(want).max())


def test_level_top_k_is_the_flat_top_k():
    """The two-stage candidate selection equals one top-k over all H*W*A*K
    sigmoid scores: the same values, and the same (anchor, class) pairs
    where no two scores tie (at ties, pairs of those scores). Logits drawn
    from a few values make ties common."""
    rng = np.random.default_rng(1)
    for b, h, w, a, k, topk in ((2, 16, 20, 9, 5, 50), (1, 7, 11, 9, 80, 1000), (2, 3, 3, 9, 4, 30)):
        for values in (None, 7):
            x = rng.normal(0, 2, (b, h, w, a * k))
            if values:
                x = rng.integers(0, values, x.shape) / 2.0
            logit = torch.from_numpy(x.astype(np.float32))
            scores, anchor_idx, cls = level_top_k(logit, k, topk)
            want_s, want_i = top_k(torch.sigmoid(logit.reshape(b, -1)), min(topk, h * w * a * k))
            np.testing.assert_array_equal(scores.numpy(), want_s.numpy())
            for row_s, row_i, row_w in zip(want_s.numpy(), (anchor_idx * k + cls).numpy(),
                                           want_i.numpy()):
                _, inverse, counts = np.unique(row_s, return_inverse=True, return_counts=True)
                unique = counts[inverse] == 1  # float32 sigmoids tie even where logits do not
                np.testing.assert_array_equal(row_i[unique], row_w[unique])
                assert values or unique.mean() > 0.5
            flat = torch.sigmoid(logit.reshape(b, -1))
            np.testing.assert_array_equal(torch.gather(flat, 1, anchor_idx * k + cls).numpy(),
                                          scores.numpy())


def _head_outputs_and_gt(seed=0):
    rng = np.random.default_rng(seed)
    shapes = [(16, 20), (8, 10), (4, 5), (2, 3), (1, 2)]
    logits = [rng.normal(-1, 2, (B, h, w, 45)).astype(np.float32) for h, w in shapes]
    deltas = [rng.normal(0, 0.5, (B, h, w, 36)).astype(np.float32) for h, w in shapes]
    gt = {"gt_boxes": np.array([[[10, 12, 60, 70], [30, 30, 140, 110], [0, 0, 20, 20],
                                 [5, 5, 6, 6], [0, 0, 0, 0]]] * B, np.float32),
          "gt_classes": np.array([[0, 3, 4, 1, 0]] * B, np.int32),
          "gt_valid": np.array([[True] * 4 + [False], [True] * 3 + [False] * 2])}
    return logits, deltas, gt


@pytest.fixture(scope="module")
def drivers():
    """The JAX ``RetinaNet`` driver and the port's, of the narrow model."""
    jcfg, tcfg = retina_cfgs()
    _, _, neck_shapes, _ = _build_backbone_neck(jcfg)
    with torch.device("meta"):
        model = SingleStageDetector(tcfg)
    return JaxRetinaNet(jcfg, neck_shapes), model.retinanet


def test_retinanet_losses_and_normalizer_match_jax(drivers):
    """``RetinaNet.losses`` on the same float32 head outputs and GT (an
    invalid slot, a tiny box that only a low-quality match reaches): both
    losses to 1e-5, their gradients by the logits and deltas to 1e-4 of
    each max, and the EMA normalizer over two steps to 1e-6."""
    jdrv, tdrv = drivers
    logits, deltas, gt = _head_outputs_and_gt()
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}

    def jloss(lg, dl, norm):
        losses, new = jdrv.losses(lg, dl, jgt, norm)
        return sum(losses.values()), (losses, new)

    @jax.jit
    def two_steps(lg, dl):
        (_, (losses, norm)), grads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            lg, dl, jnp.asarray(100.0))
        return losses, norm, grads, jloss(lg, dl, norm)[1][1]

    j_losses, j_norm, j_grads, j_norm2 = two_steps([jnp.asarray(x) for x in logits],
                                                   [jnp.asarray(x) for x in deltas])
    tl = [torch.from_numpy(x).requires_grad_(True) for x in logits]
    td = [torch.from_numpy(x).requires_grad_(True) for x in deltas]
    t_losses, t_norm = tdrv.losses(tl, td, tgt, torch.tensor(100.0))
    sum(t_losses.values()).backward()
    _, t_norm2 = tdrv.losses(tl, td, tgt, t_norm)
    assert set(t_losses) == set(j_losses) == {"loss_cls", "loss_box_reg"}
    for k in t_losses:
        np.testing.assert_allclose(float(t_losses[k].detach()), float(j_losses[k]),
                                   rtol=LOSS_RTOL, err_msg=k)
    assert float(t_losses["loss_box_reg"].detach()) > 0
    for got, want in zip([x.grad.numpy() for x in tl + td],
                         [np.asarray(g) for g in j_grads[0] + j_grads[1]]):
        assert_grad_close(got, want, "head outputs")
    for got, want in ((t_norm, j_norm), (t_norm2, j_norm2)):
        np.testing.assert_allclose(float(got), float(want), rtol=NORM_RTOL)
    assert float(t_norm2) != float(t_norm) != 100.0


def test_retinanet_inference_on_head_outputs_matches_jax(drivers):
    """``RetinaNet.inference`` on the same float32 head outputs: valid slots,
    classes and kept boxes equal, boxes and scores to 1e-4."""
    jdrv, tdrv = drivers
    logits, deltas, _ = _head_outputs_and_gt(3)
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jdrv.inference)(
        [jnp.asarray(x) for x in logits], [jnp.asarray(x) for x in deltas], jnp.asarray(SIZES)))
    got = tdrv.inference([torch.from_numpy(x) for x in logits],
                         [torch.from_numpy(x) for x in deltas], torch.from_numpy(SIZES))
    np.testing.assert_array_equal(got.is_valid.numpy(), want.is_valid)
    assert got.is_valid.numpy().sum() > 100
    np.testing.assert_array_equal(got.pred_classes.numpy(), want.pred_classes)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=RTOL, atol=1e-6)


# -- the whole model -------------------------------------------------------------------

def test_retinanet_detections_match_jax(retina):
    jout, tout = retina["jout"], retina["tout"]
    valid = tout.is_valid.numpy()
    np.testing.assert_array_equal(valid, jout.is_valid)
    assert valid.sum() >= 60 and "pred_masks" not in tout.get_fields()
    np.testing.assert_array_equal(tout.pred_classes.numpy(), jout.pred_classes)
    np.testing.assert_allclose(tout.boxes.numpy(), jout.boxes, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tout.scores.numpy(), jout.scores, rtol=RTOL, atol=1e-6)


def test_retinanet_passes_the_pipeline_oracle():
    """``tests/test_pipeline_oracle.py``'s RetinaNet oracle (one flat sort of
    each level's H*W*A*K sigmoid scores, decode, clip, sequential greedy
    class-offset NMS, in numpy on the JAX head's outputs) holds the port's
    ``predict``."""
    from test_torch_gn import port_in
    from tests import test_pipeline_oracle as oracle

    with port_in(oracle):
        oracle.test_retinanet_inference_matches_numpy_oracle()


def test_port_p6p7_matches_the_numpy_trunk_oracle():
    """``tests/test_trunk_oracle.py``'s P6P7 oracle on the port: an R18 FPN
    with the P6P7 block (its config), p6 = conv(p5) and p7 = conv(relu(p6))
    in float64 numpy from the JAX weights, against the port's p6 and p7."""
    from test_torch_gn import oracle_cfg, port_cfg_from, port_model
    from tests.test_trunk_oracle import np_conv, np_fpn, np_resnet18

    jcfg = oracle_cfg()
    jcfg.MODEL.MASK_ON = False
    jcfg.MODEL.NECK.TOP_BLOCK_TYPE = "P6P7"
    jcfg.MODEL.RPN.IN_FEATURES = ["p3", "p4", "p5", "p6", "p7"]
    img = np.random.default_rng(13).uniform(0, 255, (64, 128, 3)).astype(np.float32)
    batch = {"image": jnp.asarray(img[None]), "image_size": jnp.asarray([[64, 128]], jnp.int32)}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(6), batch))
    with torch.no_grad():
        feats = port_model(port_cfg_from(jcfg), variables).features(torch.from_numpy(img[None]))
    params = variables["params"]
    x = (img.astype(np.float64) - np.asarray(jcfg.MODEL.PIXEL_MEAN)) / np.asarray(
        jcfg.MODEL.PIXEL_STD)
    if jcfg.MODEL.INPUT_FORMAT == "BGR":
        x = x[..., ::-1]
    planes = np_fpn(np_resnet18(x, params["backbone"]), params["neck"])
    tb6, tb7 = (params["neck"][f"top_block_p{i}"]["conv"] for i in (6, 7))
    p6 = np_conv(planes["p5"], tb6["kernel"], 2, bias=tb6["bias"])
    p7 = np_conv(np.maximum(p6, 0.0), tb7["kernel"], 2, bias=tb7["bias"])
    for name, want in (("p6", p6), ("p7", p7)):
        got = feats[name][0].permute(1, 2, 0).numpy().astype(np.float64)
        np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4, err_msg=name)


@pytest.fixture(scope="module")
def retina_train():
    """One training step of both packages from the same weights and batch
    (RetinaNet samples nothing): losses, gradients, the optax update and the
    normalizer after a second step."""
    jcfg, tcfg = retina_cfgs(**{"INPUT.MAX_GT_INSTANCES": G, "SOLVER.IMS_PER_BATCH": B})
    nb = make_train_batch(tcfg, H, W)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    jmodel = jax_build_model(jcfg)
    variables = spread_head(jax_init(jcfg, 1, jbatch))
    rng = jax.random.PRNGKey(1)
    params = variables["params"]
    tx = jsolver.build_optimizer(jcfg, params)

    def two_steps(p):
        def total(q, state):
            t, (losses, new) = jmodel.loss_fn({**variables, "params": q}, jbatch, rng, state)
            return t, (losses, new)

        (t, (losses, aux)), grads = jax.value_and_grad(total, has_aux=True)(
            p, jmodel.initial_state)
        updates, _ = tx.update(grads, tx.init(p), p)
        p1 = optax.apply_updates(p, updates)
        _, (_, aux2) = total(p1, aux)
        return t, losses, grads, p1, aux["loss_normalizer"], aux2["loss_normalizer"]

    j_total, j_losses, j_grads, j_p1, j_norm, j_norm2 = jax.tree_util.tree_map(
        np.asarray, jax.jit(two_steps)(params))
    start = convert_variables(variables)
    tmodel = build_model(tcfg, device="cpu", state_dict=start, training=True)
    t_losses = tmodel.losses(tbatch)
    sum(t_losses.values()).backward()
    t_norm = float(tmodel.loss_normalizer)
    step_model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    state = create_train_state(tcfg, step_model, torch.Generator().manual_seed(0))
    step = build_train_step(tcfg, state)
    metrics = step(tbatch)
    after_one = {n: p.detach().clone() for n, p in step_model.named_parameters()}
    step(tbatch)
    return dict(
        jcfg=jcfg, tcfg=tcfg, start=start, j_total=float(j_total),
        j_losses={k: float(v) for k, v in j_losses.items()}, j_grads=j_grads, j_p1=j_p1,
        j_norm=float(j_norm), j_norm2=float(j_norm2), tmodel=tmodel,
        t_losses={k: float(v.detach()) for k, v in t_losses.items()}, t_norm=t_norm,
        t_grads={n: p.grad.numpy().copy() for n, p in tmodel.named_parameters()
                 if p.grad is not None},
        metrics=metrics, after_one=after_one, t_norm2=float(step_model.loss_normalizer))


def test_retinanet_train_losses_match_jax(retina_train):
    got, want = retina_train["t_losses"], retina_train["j_losses"]
    assert set(got) == set(want) == {"loss_cls", "loss_box_reg"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(retina_train["metrics"]["total_loss"]),
                               retina_train["j_total"], rtol=LOSS_RTOL)


def test_retinanet_train_gradients_match_jax(retina_train):
    """Every trainable parameter's gradient (the head's, the FPN's with P6
    and P7, the trunk above res2) against ``jax.grad``; the frozen stem
    and res2 have none in the port and a zero one in JAX."""
    want = convert_variables({"params": retina_train["j_grads"]})
    trainable = tsolver.trainable_parameters(retina_train["tmodel"], 2)
    assert set(retina_train["t_grads"]) == set(trainable)
    assert "backbone.top_block.p7.weight" in trainable and "head.cls_score.bias" in trainable
    for name, w in want.items():
        if name == "loss_normalizer":
            continue
        if name in trainable:
            assert_grad_close(retina_train["t_grads"][name], w.numpy(), name)
        else:
            assert name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")), name
            assert not w.numpy().any(), name


def test_retinanet_train_step_matches_jax_update(retina_train):
    """``build_train_step``'s update against the JAX gradients through the
    optax chain, and the normalizer after one and two steps."""
    want = convert_variables({"params": retina_train["j_p1"]})
    start = retina_train["start"]
    for name, p in retina_train["after_one"].items():
        assert_update_close(p.numpy(), want[name].numpy(), start[name].numpy(), GRAD_TOL, name)
    np.testing.assert_allclose(retina_train["t_norm"], retina_train["j_norm"], rtol=NORM_RTOL)
    np.testing.assert_allclose(retina_train["t_norm2"], retina_train["j_norm2"], rtol=NORM_RTOL)
    assert retina_train["j_norm2"] != retina_train["j_norm"] != 100.0


# -- the solver, the converters, the config files, the loop -------------------------------

@pytest.mark.parametrize("freeze_at", [2, 5])
def test_retinanet_trainable_parameters_match_jax_mask(freeze_at):
    """``solver.trainable_parameters`` of a ``SingleStageDetector`` is the
    JAX ``trainable_mask``: the stem and res2 .. res{FREEZE_AT} of the trunk
    are frozen, the FPN and the head train."""
    jcfg, tcfg = retina_cfgs(**{"MODEL.BACKBONE.FREEZE_AT": freeze_at})
    params = jax_param_shapes(jcfg)["params"]
    names = list(convert_variables({"params": _tagged(params)}).items())
    by_tag = {int(v.reshape(-1)[0]): k for k, v in names if k != "loss_normalizer"}
    mask = jax.tree_util.tree_leaves(jsolver.trainable_mask(params, freeze_at))
    want = {by_tag[i] for i, m in enumerate(mask) if m}
    with torch.device("meta"):
        model = SingleStageDetector(tcfg)
    got = set(tsolver.trainable_parameters(model, freeze_at))
    assert got == want and len(want) < len(mask)
    assert not any(n.startswith("backbone.bottom_up.stem.") for n in got)
    assert any(n.startswith("head.") for n in got)


def test_convert_d2_weights_retinanet_matches_jax_converter():
    """A seeded Detectron2-named RetinaNet state dict (``head.cls_subnet.{2i}``,
    ``backbone.top_block.p{6,7}``) through the port's converter equals the
    JAX converter's tree carried by ``convert_variables``; the normalizer,
    no Detectron2 tensor, starts at 100."""
    jcfg, tcfg = retina_cfgs()
    rng = np.random.default_rng(7)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in _port_shapes(tcfg).items()
          if k != "loss_normalizer"}
    sd["pixel_mean"] = np.zeros(3, np.float32)
    sd["head.extra.weight"] = np.zeros(2, np.float32)
    got, got_left = convert_d2_weights(dict(sd), tcfg)
    tree, want_left = jax_convert_d2(dict(sd), jcfg)
    want = convert_variables(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert float(got["loss_normalizer"]) == 100.0
    assert got_left == want_left == ["head.extra.weight"]


@pytest.mark.parametrize("path", RETINA_YAMLS)
def test_retinanet_yaml_builds_the_jax_tree(path):
    """Each RetinaNet YAML builds (narrow) with the JAX model's tensors, name
    for name and shape for shape, and the normalizer."""
    jcfg, tcfg = yaml_cfgs(path)
    want = {k: tuple(v.shape) for k, v in convert_variables(jax_param_shapes(jcfg)).items()}
    assert _port_shapes(tcfg) == want and want["loss_normalizer"] == ()


@pytest.mark.parametrize("path,match", [
    ("configs/Misc/cascade_lcc_R_50_FPN_3x.yaml", "CascadeLCCHeads"),
    # The deformable X152 builds now (tests/test_torch_dconv.py); its deformable
    # stages on a basic-block trunk raise, naming them.
    ("configs/Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml", "deformable"),
    ("configs/COCO-InstanceSegmentation/solo_v2_R_50_FPN_1x.yaml", "SOLOv2Head"),
    ("configs/COCO-Detection/yolov4_D_53_PAN_1x.yaml", "YOLOV4Head|DarkNet53"),
])
def test_unported_families_raise_by_name(path, match):
    _, tcfg = yaml_cfgs(path)
    if "dconv" in path:
        with torch.device("meta"):
            assert meta_architecture(tcfg)(tcfg) is not None
        tcfg.MODEL.RESNETS.DEPTH = 34
    if "solo_v2" in path:  # SOLOv2 builds now (tests/test_torch_solov2.py); a kernel size of 3 raises
        with torch.device("meta"):
            assert meta_architecture(tcfg)(tcfg) is not None
        tcfg.MODEL.SOLO.MASK_KERNEL_SIZE = 3
        match = "MASK_KERNEL_SIZE"
    with pytest.raises(NotImplementedError, match=match), torch.device("meta"):
        meta_architecture(tcfg)(tcfg)


def loop_cfg():
    """The RetinaNet YAML at narrow widths with ``small_cfg``'s inputs and
    loader, batch 2, a checkpoint every step."""
    _, tcfg = retina_cfgs(**{"SOLVER.IMS_PER_BATCH": 2, "SOLVER.SHORT_TERM_SAVE_STEPS": 1,
                             "SOLVER.SHORT_TERM_NUM_STEPS": 2,
                             "MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES": 3})
    tiny = small_cfg()
    tcfg.TRANSFORM, tcfg.INPUT = tiny.TRANSFORM, tiny.INPUT
    return tcfg


def test_retinanet_resumes_bit_equal_with_its_normalizer(tmp_path):
    """``train()`` to step 1, a resume to step 2, against 2 steps in one run:
    the parameters and ``loss_normalizer`` bit-equal (the checkpoints carry
    it in the model's state dict)."""
    cfg = loop_cfg()
    ds = SyntheticDataset(n=4, num_classes=3)
    loader = build_dataloader(cfg, ds, training=True, seed=0)
    batches = [next(loader) for _ in range(2)]
    loader.close()

    def run(max_iter, d, start=0):
        model = build_model(cfg, device="cpu", training=True)
        return train(cfg, model, iter(batches[start:]), max_iter=max_iter,
                     checkpoint_dir=str(d))

    whole = run(2, tmp_path / "whole")
    run(1, tmp_path / "split")
    resumed = run(2, tmp_path / "split", start=1)
    a, b = whole.model.state_dict(), resumed.model.state_dict()
    assert float(a["loss_normalizer"]) != 100.0
    assert all(torch.equal(a[k], b[k]) for k in a)


def test_retinanet_run_evaluation_gives_bbox_metrics():
    """``run_evaluation`` of a RetinaNet: COCO bbox metrics, no segm."""
    cfg = loop_cfg()
    ds = SyntheticDataset(n=2, num_classes=3)
    metrics = run_evaluation(cfg, build_model(cfg, device="cpu"), ds,
                             lambda: build_dataloader(cfg, ds, training=False))
    assert "bbox/AP" in metrics and not any(k.startswith("segm/") for k in metrics)


def test_overfit_cfg_matches_the_jax_tool_retinanet():
    """Key for key the JAX tool's recipe, its ``SINGLE_STAGE_HEAD.SCORE_THRESH_TEST``
    0.3 included, which neither RetinaNet reads (both keep
    ``RETINANET.SCORE_THRESH_TEST`` 0.05)."""
    check_overfit_cfg("retinanet")
    from detectron2_tensorflow_tpu_torch.tools import overfit_check

    cfg = overfit_check.overfit_cfg("retinanet")
    assert cfg.MODEL.SINGLE_STAGE_HEAD.SCORE_THRESH_TEST == 0.3
    with torch.device("meta"):
        assert SingleStageDetector(cfg).retinanet.score_thresh == 0.05


def test_overfit_check_retinanet_runs_on_the_cpu(capsys):
    """``tools.overfit_check --arch retinanet --device cpu`` at narrow widths
    and 2 images a step: one step, the evaluation, and the JSON line with
    bbox AP only."""
    out = run_overfit_check("retinanet", ["MODEL.RESNETS.STEM_OUT_CHANNELS", "32",
                                          "MODEL.RESNETS.RES2_OUT_CHANNELS", "128",
                                          "MODEL.NECK.OUT_CHANNELS", "32",
                                          "SOLVER.IMS_PER_BATCH", "2"], capsys, steps=1)
    assert out["arch"] == "retinanet" and out["steps"] == 1 and np.isfinite(out["final_loss"])
    assert {"bbox_ap", "bbox_ap50"} <= set(out) and "segm_ap" not in out
    json.dumps(out)


def test_retinanet_jax_init_recipe_matches_the_jax_initializers(retina):
    """``init_weights(..., "jax")`` on a RetinaNet draws as the JAX package
    does: every head conv normal(0.01) (not truncated), the classifier's
    bias at the prior ``-log(99)``, P6 and P7 as the JAX ``Conv2D`` default;
    checked on each tensor's moments, the constant ones exactly."""
    from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import init_weights

    want = {k: v.numpy() for k, v in convert_variables(jax.tree_util.tree_map(
        np.asarray, jax_init(retina["jcfg"], 5, retina["batch"]))).items()}
    model = SingleStageDetector(retina["tcfg"])
    init_weights(model, torch.Generator().manual_seed(0), "jax")
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    np.testing.assert_allclose(got["head.cls_score.bias"], -np.log(99.0), rtol=1e-6)
    for name, w in want.items():
        g = got[name]
        if np.all(w == w.reshape(-1)[0]):  # biases, the prior, the normalizer
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
            continue
        assert abs(g.std() / w.std() - 1) < 0.02 + 3 / np.sqrt(w.size), (name, g.std(), w.std())
        if name.startswith("head."):
            assert abs(g.std() - 0.01) < 0.02 * 0.01 + 0.03 / np.sqrt(w.size), name
