"""Cascade Mask R-CNN (``CascadeROIHeads``: three box stages of rising IoU)
against the JAX package.

``configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml`` at narrow widths
(``test_torch_c4.SINGLE_NARROW`` plus FPN 32: R50 depth, stem 16, res2 32,
8 per group, FC 64, mask conv 32, 5 classes, float32) on 2 x 128 x 160
images. The same seeded numpy inputs and weights (the JAX ones carried over
by ``convert.py``) go through both packages; in training both take the JAX
package's proposals and sampler draws. Tolerances are the port's standing
ones: valid slots, classes and NMS keeps equal; float32 values 1e-4; losses
1e-5 relative (the mask loss 3e-4); gradients and one step's updates 1e-4 of
each tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.convert.d2 import convert_d2_weights as jax_convert_d2
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts
from detectron2_tensorflow_tpu.models.roi_heads import cascade as jcascade
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.convert import _port_shapes, convert_d2_weights
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import GeneralizedRCNN
from detectron2_tensorflow_tpu_torch.models.roi_heads.cascade import scale_gradient
from test_torch_c4 import (
    ATOL,
    LOSS_RTOL,
    RTOL,
    SIZES,
    check_detections,
    check_masks,
    check_overfit_cfg,
    check_update,
    jax_param_shapes,
    predict_pair,
    repo_configs,
    run_overfit_check,
    train_pair,
    yaml_cfgs,
    OVERFIT_NARROW,
)
from test_torch_train import MASK_LOSS_RTOL, assert_grad_close, jax_proposals
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

CASCADE_YAML = "configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml"
CASCADE_YAMLS = [CASCADE_YAML, "configs/Misc/cascade_mask_rcnn_R_50_FPN_3x.yaml"]
STAGE_KEYS = tuple(f"{k}_stage{s}" for s in range(3) for k in ("loss_cls", "loss_box_reg"))


def cascade_cfgs(**overrides):
    """(JAX cfg, port cfg): the cascade YAML at narrow widths."""
    return yaml_cfgs(CASCADE_YAML, **{"MODEL.NECK.OUT_CHANNELS": 32, **overrides})


@pytest.fixture(scope="module")
def both_heads():
    """The JAX ``CascadeROIHeads`` and the port's heads (built on the meta
    device: the methods under test read no parameter)."""
    jcfg, tcfg = cascade_cfgs()
    jdrv = _build_rcnn_parts(jcfg)[2]
    with torch.device("meta"):
        heads = GeneralizedRCNN(tcfg).roi_heads
    return jdrv, heads


def _boxes(rng, b, n):
    xy = rng.uniform(0, 120, (b, n, 2))
    return np.concatenate([xy, xy + rng.uniform(4, 60, (b, n, 2))], -1).astype(np.float32)


def _gt(rng):
    boxes = _boxes(rng, 2, 5)
    return {"gt_boxes": boxes, "gt_classes": rng.integers(0, 5, (2, 5)).astype(np.int32),
            "gt_valid": np.array([[1, 1, 1, 1, 0], [1, 1, 1, 0, 0]], bool),
            "gt_is_crowd": np.array([[0, 0, 0, 1, 0], [0, 0, 0, 0, 0]], bool)}


# -- the heads' functions --------------------------------------------------------------

def test_cascade_heads_layout(both_heads):
    """Three stages of box head and class-agnostic predictor under
    Detectron2's names, each stage's transform weights and IoU."""
    _, heads = both_heads
    sd = heads.state_dict()
    assert sd["box_head.2.fc1.weight"].shape == (64, 7 * 7 * 32)
    assert sd["box_predictor.1.bbox_pred.weight"].shape == (4, 64)
    assert "box_head.fc1.weight" not in sd and heads.num_stages == 3
    assert [t.weights for t in heads.stage_transforms] == [
        (10.0, 10.0, 5.0, 5.0), (20.0, 20.0, 10.0, 10.0), (30.0, 30.0, 15.0, 15.0)]
    assert [m.thresholds[1:-1] for m in heads.stage_matchers[1:]] == [[0.6], [0.7]]
    assert heads.stage_matchers[0] is heads.matcher


@pytest.mark.parametrize("stage", [1, 2])
def test_rematch_matches_jax(both_heads, stage):
    """``_rematch`` at a later stage's IoU (crowd GT matching nothing):
    classes, matched boxes and indices equal."""
    jdrv, heads = both_heads
    rng = np.random.default_rng(stage)
    gt = _gt(rng)
    boxes = np.concatenate([_boxes(rng, 2, 30), gt["gt_boxes"] + rng.normal(0, 2, (2, 5, 4))
                            .astype(np.float32)], 1)
    want = jax.tree_util.tree_map(np.asarray, jdrv._rematch(
        stage, jnp.asarray(boxes), {k: jnp.asarray(v) for k, v in gt.items()}))
    got = heads._rematch(stage, torch.from_numpy(boxes),
                         {k: torch.from_numpy(v) for k, v in gt.items()})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w)
    assert (got[0].numpy() < 5).sum() >= 3  # some slots are foreground at this IoU


def test_refine_boxes_and_stage_losses_match_jax(both_heads):
    """``refine_boxes`` (decode with the stage's weights, clip, detached) and
    ``stage_losses`` (class-agnostic, named ``_stage{k}``) with their
    gradients by the logits and deltas."""
    jdrv, heads = both_heads
    rng = np.random.default_rng(5)
    boxes = _boxes(rng, 2, 16)
    deltas = rng.normal(0, 1, (32, 4)).astype(np.float32)
    logits = rng.normal(0, 2, (32, 6)).astype(np.float32)
    classes = rng.integers(0, 6, (2, 16))
    gt_boxes = _boxes(rng, 2, 16)
    valid = rng.uniform(0, 1, (2, 16)) > 0.2
    for stage in range(3):
        want = np.asarray(jdrv.refine_boxes(stage, jnp.asarray(deltas), jnp.asarray(boxes),
                                            jnp.asarray(SIZES)))
        got = heads.refine_boxes(stage, torch.from_numpy(deltas).requires_grad_(True),
                                 torch.from_numpy(boxes), torch.from_numpy(SIZES))
        assert not got.requires_grad
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=ATOL)

        def jloss(lg, dl, stage=stage):
            losses = jdrv.stage_losses(stage, lg, dl, jnp.asarray(boxes), jnp.asarray(classes),
                                       jnp.asarray(gt_boxes), jnp.asarray(valid))
            return sum(losses.values()), losses

        (_, j_losses), j_grads = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
            jnp.asarray(logits), jnp.asarray(deltas))
        tl, td = (torch.from_numpy(x).requires_grad_(True) for x in (logits, deltas))
        t_losses = heads.stage_losses(stage, tl, td, torch.from_numpy(boxes),
                                      torch.from_numpy(classes), torch.from_numpy(gt_boxes),
                                      torch.from_numpy(valid))
        sum(t_losses.values()).backward()
        assert set(t_losses) == set(j_losses) == {f"loss_cls_stage{stage}",
                                                  f"loss_box_reg_stage{stage}"}
        for k, v in t_losses.items():
            np.testing.assert_allclose(float(v.detach()), float(j_losses[k]), rtol=LOSS_RTOL)
        assert_grad_close(tl.grad.numpy(), np.asarray(j_grads[0]), "logits")
        assert_grad_close(td.grad.numpy(), np.asarray(j_grads[1]), "deltas")


def test_cascade_inference_matches_jax(both_heads):
    """The mean of three stages' softmaxes through ``fast_rcnn_inference``
    with the last stage's deltas: slots, classes and kept boxes equal,
    boxes and scores to 1e-4."""
    jdrv, heads = both_heads
    rng = np.random.default_rng(9)
    scores = [rng.normal(0, 2, (2 * 40, 6)).astype(np.float32) for _ in range(3)]
    deltas = rng.normal(0, 1, (2 * 40, 4)).astype(np.float32)
    boxes = _boxes(rng, 2, 40)
    valid = rng.uniform(0, 1, (2, 40)) > 0.1
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jdrv.cascade_inference)(
        [jnp.asarray(s) for s in scores], jnp.asarray(deltas), jnp.asarray(boxes),
        jnp.asarray(valid), jnp.asarray(SIZES)))
    got = heads.cascade_inference([torch.from_numpy(s) for s in scores], torch.from_numpy(deltas),
                                  torch.from_numpy(boxes), torch.from_numpy(valid),
                                  torch.from_numpy(SIZES))
    np.testing.assert_array_equal(got.is_valid.numpy(), want.is_valid)
    assert got.is_valid.numpy().sum() >= 100
    np.testing.assert_array_equal(got.pred_classes.numpy(), want.pred_classes)
    np.testing.assert_allclose(got.boxes.numpy(), want.boxes, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got.scores.numpy(), want.scores, rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_scale_gradient_matches_jax(dtype):
    """The forward value bit for bit (in bf16 it need not equal the input)
    and the gradient scaled by 1/3."""
    x = np.random.default_rng(0).normal(0, 3, (4096,)).astype(np.float32)
    want = np.asarray(jcascade.scale_gradient(jnp.asarray(x, dtype), 1.0 / 3).astype(jnp.float32))
    t = torch.from_numpy(x).to(getattr(torch, dtype)).requires_grad_(True)
    got = scale_gradient(t, 1.0 / 3)
    np.testing.assert_array_equal(got.float().detach().numpy(), want)
    got.float().sum().backward()
    np.testing.assert_allclose(t.grad.float().numpy(), 1.0 / 3, rtol=1e-2 if dtype == "bfloat16"
                               else 1e-7)
    if dtype == "bfloat16":
        assert (want != np.asarray(jnp.asarray(x, dtype).astype(jnp.float32))).any()


# -- the whole model -------------------------------------------------------------------

@pytest.fixture(scope="module")
def cascade():
    return predict_pair(*cascade_cfgs())


def test_cascade_detections_match_jax(cascade):
    check_detections(cascade)


def test_cascade_masks_match_jax(cascade):
    """The mask head on the detections of the averaged stages."""
    check_masks(cascade, 28)


def test_cascade_predict_pools_four_roi_sets(cascade, monkeypatch):
    """Serving pools three box sets (each stage's boxes) and the detections."""
    from detectron2_tensorflow_tpu_torch.models import poolers

    calls = []
    real = poolers.roi_patch_interpolate
    monkeypatch.setattr(poolers, "roi_patch_interpolate",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    cascade["tmodel"].predict(cascade["tbatch"])
    assert len(calls) == 4


def test_cascade_passes_the_pipeline_oracle():
    """``tests/test_pipeline_oracle.py``'s cascade oracle (three stages, each
    pooling the previous one's decoded boxes in numpy, the mean softmax, the
    last stage's decode, class-aware NMS) holds the port's ``predict``."""
    from test_torch_gn import port_in
    from tests import test_pipeline_oracle as oracle

    with repo_configs(), port_in(oracle):
        oracle.test_cascade_inference_matches_numpy_oracle()


@pytest.fixture(scope="module")
def cascade_train():
    return train_pair(*cascade_cfgs(**{"INPUT.MAX_GT_INSTANCES": 5, "SOLVER.IMS_PER_BATCH": 2}))


def test_cascade_train_losses_match_jax(cascade_train):
    """The RPN's, every stage's and the mask loss, each to 1e-5 (the mask
    loss 3e-4); the later stages have positives to regress."""
    got, want = cascade_train["t_losses"], cascade_train["j_losses"]
    keys = ("loss_rpn_cls", "loss_rpn_loc") + STAGE_KEYS + ("loss_mask",)
    assert set(got) == set(want) == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=MASK_LOSS_RTOL if k == "loss_mask"
                                   else LOSS_RTOL, err_msg=k)
    assert all(got[f"loss_box_reg_stage{s}"] > 0 for s in range(3))


def test_cascade_train_gradients_match_jax(cascade_train):
    """Every trainable parameter's gradient, each stage's head's included:
    the pooled features' gradient scaled by 1/3 on the way to the trunk; the
    frozen stem and res2 have none in the port and a zero one in JAX."""
    want = convert_variables({"params": cascade_train["j_grads"]})
    trainable = tsolver.trainable_parameters(cascade_train["tmodel"], 2)
    assert set(cascade_train["t_grads"]) == set(trainable)
    for name, w in want.items():
        if name in trainable:
            assert_grad_close(cascade_train["t_grads"][name], w.numpy(), name)
        else:
            assert name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")), name
            assert not w.numpy().any(), name
    for s in range(3):
        assert np.abs(cascade_train["t_grads"][f"roi_heads.box_head.{s}.fc1.weight"]).max() > 0


def test_cascade_train_step_matches_jax_update(cascade_train):
    check_update(cascade_train)


def test_cascade_train_pools_each_stage_and_the_mask_set(cascade_train, monkeypatch):
    """No fused multi-pool (the JAX cascade skips it): three box pools and
    the mask pool of the stage-0 sample, each a set of its own."""
    from detectron2_tensorflow_tpu_torch.models import poolers

    calls = []
    real = poolers.RoiPatchPoolMulti.apply
    monkeypatch.setattr(poolers.RoiPatchPoolMulti, "apply",
                        lambda *a: calls.append(len(a) - 1) or real(*a))
    with torch.no_grad(), jax_proposals(cascade_train["tmodel"], cascade_train["j_raw"]):
        cascade_train["tmodel"].losses(cascade_train["tbatch"], noise=cascade_train["noise"])
    assert calls == [3, 3, 3, 3]  # one ROI set each: (starts, wy, wx)


# -- the converters, the config files, the overfit tool -----------------------------------

def test_convert_d2_weights_cascade_matches_jax_converter():
    """A seeded Detectron2-named cascade state dict (``roi_heads.box_head.{k}.fcN``,
    ``roi_heads.box_predictor.{k}.*``; each stage's ``fc1`` columns in (c, h,
    w) order) through the port's converter equals the JAX converter's tree
    carried by ``convert_variables``."""
    jcfg, tcfg = cascade_cfgs()
    rng = np.random.default_rng(7)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in _port_shapes(tcfg).items()}
    sd["roi_heads.extra.weight"] = np.zeros(2, np.float32)
    got, got_left = convert_d2_weights(dict(sd), tcfg)
    tree, want_left = jax_convert_d2(dict(sd), jcfg)
    want = convert_variables(tree)
    assert set(got) == set(want) and "roi_heads.box_head.2.fc1.weight" in got
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert not torch.equal(got["roi_heads.box_head.1.fc1.weight"],
                           torch.from_numpy(sd["roi_heads.box_head.1.fc1.weight"]))
    assert got_left == want_left == ["roi_heads.extra.weight"]


@pytest.mark.parametrize("path", CASCADE_YAMLS)
def test_cascade_yaml_builds_the_jax_tree(path):
    """Each cascade YAML builds (narrow) with the JAX model's tensors (the
    ``box_heads_{k}`` / ``box_predictors_{k}`` subtrees), name for name."""
    jcfg, tcfg = yaml_cfgs(path, **{"MODEL.NECK.OUT_CHANNELS": 32})
    want = {k: tuple(v.shape) for k, v in convert_variables(jax_param_shapes(jcfg)).items()}
    assert _port_shapes(tcfg) == want


def test_cascade_needs_class_agnostic_regression():
    _, tcfg = cascade_cfgs(**{"MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG": False})
    with pytest.raises(ValueError, match="class-agnostic"), torch.device("meta"):
        GeneralizedRCNN(tcfg)


def test_overfit_cfg_matches_the_jax_tool_cascade():
    check_overfit_cfg("cascade")


def test_overfit_check_cascade_runs_on_the_cpu(capsys):
    """``tools.overfit_check --arch cascade --device cpu`` at narrow widths
    and 2 images a step: one step, the evaluation, the JSON line with bbox
    and segm AP."""
    out = run_overfit_check("cascade", [*OVERFIT_NARROW, "SOLVER.IMS_PER_BATCH", "2"], capsys,
                            steps=1)
    assert out["arch"] == "cascade" and out["steps"] == 1 and np.isfinite(out["final_loss"])
    assert {"bbox_ap", "bbox_ap50", "segm_ap", "segm_ap50"} <= set(out)
