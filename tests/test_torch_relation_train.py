"""Relation Networks training: the duplicate-removal targets, ``loss_dup`` and
the whole narrow model's losses, gradients and optimizer step against the
JAX package's on the same numpy inputs.

The targets are held exactly against ``duplicate_removal_targets_multi``
(and its one-threshold wrapper) on candidates built to hit every rule:
exact score ties, invalid candidates that outscore the valid ones, invalid
GT, class mismatches and candidates at IoUs across the thresholds.
``loss_dup`` and its gradients with respect to the class logits, the box
deltas and the appearance features are held against the JAX driver's
``dup_removal_loss`` with ``jax.grad``, crowd GT included.

The whole model is ``configs/Misc/relation_rcnn_R_50_FPN_1x.yaml`` at
``test_torch_relation.RELATION_NARROW`` widths (R50 depth, stem 16, res2 32,
FPN 32, FC 64, 4 relation groups of key dim 16, 5 classes, float32) on
``make_train_batch``'s 2 x 128 x 160 images with 5 GT slots, one of them a
crowd, in four variants: the YAML as it is, the duplicate removal with its
five IoU heads, the removal with ``MASK_ON``, and the removal with
class-agnostic box regression. One JAX init of the largest model serves all
four (each variant drops the subtrees it lacks; the agnostic one keeps the
first class's box regressor), and both packages get the same samplers'
draws (the JAX key's, ``test_torch_train.jax_noise``) and the same
proposals, as ``test_torch_train.py`` has it.

The relation path is ill-conditioned at random weights, so the inputs are
chosen as a trained model would give them, not as the random one does:

- The proposals are the JAX RPN's jittered by up to JITTER px. At random
  weights the RPN's deltas are near 0, so its proposals are the anchors,
  three aspect ratios about each centre; the removal's candidates then come
  in triples whose centres lie within ~0.01 px, where the geometry's
  ``100 * log(|dc| / w)`` has a slope of 1e4 per px. There a 1-ulp change of
  the candidate boxes (the two libraries' decodes differ by that) moved the
  box regressor's gradient by 4.3e-3 of its largest element on the port
  alone, and port against JAX by 9.5e-4; from the jittered proposals the
  latter is 1.4e-4 (the class-agnostic regressor).
- The class logits are spread (the classifier's kernel x CLS_SPREAD), so
  that no two candidates' class scores lie within rounding: their order is
  the rank embedding's input.

Tolerances, each above the worst case measured on the CPU: losses
LOSS_RTOL 1e-5 relative (``loss_mask`` 3e-4, ``test_torch_train.py``'s);
gradients GRAD_TOL = 1e-4 of each tensor's largest magnitude, elementwise
and in norm (measured 3.5e-6), but where a gradient passes through a
geometry embedding:

- the box head's ``geometry_weight``: the embedding of the same proposals,
  which the two libraries' log and sines compute up to 1.3e-4 apart
  (``test_torch_relation.GEO_ATOL``), times the attention's gradient summed
  over every pair of ROIs: GEO_GRAD_TOL 1e-3 (measured 2.0e-4);
- with the duplicate removal, its ``geometry_weight`` and the box regressor,
  whose gradient reaches the loss through the embedding of the decoded
  candidate boxes: its slope ``100 / |dc|`` is ~1e4 per px for the pairs of
  the 512 candidates whose centres lie within 0.01 px along an axis, and
  their terms dominate these sums. Scaling the candidate boxes by 1 + 1e-7
  (about the ulp by which the libraries' decodes differ) moves these
  gradients by up to 3.3e-3 on the port alone; REMOVAL_GRAD_TOL 1e-2
  (measured port against JAX 9.7e-4). ``test_dup_removal_loss_and_gradients_match_jax``
  holds the same path to GRAD_TOL on candidates that lie apart.

Each ``key.bias`` has a zero gradient in exact arithmetic (it adds one
constant to all of a query's logits, which the softmax cancels); both
packages' are rounding, held below GRAD_TOL of the key kernel's gradient.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.models.meta_arch.common import StatsTape
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts, _RCNNDrivers
from detectron2_tensorflow_tpu.models.roi_heads import relation as jrel
from detectron2_tensorflow_tpu.models.roi_heads.roi_heads import (
    SampledProposals as JaxSampledProposals,
)
from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.roi_heads import relation as trel
from detectron2_tensorflow_tpu_torch.models.roi_heads.roi_heads import SampledProposals
from test_torch_c4 import (
    check_overfit_cfg,
    jax_init,
    run_overfit_check,
    tame,
)
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)
from test_torch_relation import DUP_ON, boxes_np, port_heads, relation_cfgs, t
from test_torch_train import (
    GRAD_TOL,
    LOSS_RTOL,
    MASK_LOSS_RTOL,
    fixed_jax_proposals,
    jax_noise,
    jax_proposals,
    jax_updated_params,
)

B, H, W, G = 2, 128, 160, 5
JITTER = 3.0
CLS_SPREAD = 30.0
GEO_GRAD_TOL = 1e-3
REMOVAL_GRAD_TOL = 1e-2
VARIANTS = {
    "yaml": {},
    "dup": DUP_ON,
    "dup_mask": {**DUP_ON, "MODEL.MASK_ON": True},
    "dup_agnostic": {**DUP_ON, "MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG": True},
}
FROZEN = ("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")


def train_cfgs(**overrides):
    """(JAX cfg, port cfg): the relation YAML at narrow widths, 2 images of
    G GT slots a step."""
    return relation_cfgs(**{"INPUT.MAX_GT_INSTANCES": G, "SOLVER.IMS_PER_BATCH": B,
                            **overrides})


# -- the targets ----------------------------------------------------------------------------

def target_inputs(seed, n=48, g=6, k=4):
    """Candidates about G GT boxes (two images): jittered copies at IoUs on
    both sides of 0.5-0.9, exact score ties between eligible candidates,
    invalid candidates with the highest scores, an invalid GT, and
    candidates of another class on top of a GT."""
    rng = np.random.default_rng(seed)
    gt = boxes_np(rng, 2, g, size=200.0)
    gt[..., 2:] = gt[..., :2] + rng.uniform(20, 80, (2, g, 2))
    gt_classes = rng.integers(0, k, (2, g)).astype(np.int32)
    gt_valid = np.ones((2, g), bool)
    gt_valid[1, g - 1] = False
    owner = rng.integers(0, g, (2, n))
    wh = np.take_along_axis(gt[..., 2:] - gt[..., :2], owner[..., None], 1)
    boxes = np.take_along_axis(gt, owner[..., None], 1) + (
        rng.uniform(-0.25, 0.25, (2, n, 4)) * np.concatenate([wh, wh], -1))
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 1)
    boxes = boxes.astype(np.float32)
    classes = np.take_along_axis(gt_classes, owner, 1)
    classes[:, ::7] = (classes[:, ::7] + 1) % k  # class mismatches
    scores = rng.uniform(0.05, 1, (2, n)).astype(np.float32)
    scores[:, 1::6] = scores[:, ::6][:, : scores[:, 1::6].shape[1]]  # exact ties
    valid = rng.uniform(0, 1, (2, n)) > 0.15
    scores[~valid] = 1.5  # invalid candidates outscore every valid one
    return boxes, classes, scores, valid, gt.astype(np.float32), gt_classes, gt_valid


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("threshs", [(0.5,), (0.5, 0.6, 0.7, 0.8, 0.9)], ids=["T1", "T5"])
def test_duplicate_removal_targets_match_jax(seed, threshs):
    """``[B, N, T]`` float32 targets equal to the JAX function's, image by
    image; every GT wins at most one candidate per threshold, and some of the
    tied candidates are eligible."""
    args = target_inputs(seed)
    got = trel.duplicate_removal_targets(*[t(a) for a in args], threshs)
    assert got.shape == (2, 48, len(threshs)) and got.dtype == torch.float32
    for i in range(2):
        want = jrel.duplicate_removal_targets_multi(*[jnp.asarray(a[i]) for a in args], threshs)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
        if len(threshs) == 1:
            one = jrel.duplicate_removal_targets(*[jnp.asarray(a[i]) for a in args], threshs[0])
            np.testing.assert_array_equal(got[i, :, 0].numpy(), np.asarray(one))
    assert 0 < float(got.sum()) <= 2 * 6 * len(threshs)
    valid = args[3]
    assert not got.numpy()[~valid].any()  # invalid candidates are never positive


def test_duplicate_removal_targets_break_ties_to_the_earlier_candidate():
    """Two identical candidates on one GT: the earlier is the positive; the
    invalid GT and a class mismatch give none; a third candidate below the
    threshold never wins."""
    gt = torch.tensor([[[10.0, 10.0, 50.0, 50.0], [60.0, 60.0, 90.0, 90.0]]])
    boxes = torch.tensor([[[10.0, 10.0, 50.0, 50.0], [10.0, 10.0, 50.0, 50.0],
                           [10.0, 10.0, 30.0, 30.0], [60.0, 60.0, 90.0, 90.0]]])
    scores = torch.tensor([[0.5, 0.5, 0.9, 0.7]])
    got = trel.duplicate_removal_targets(
        boxes, torch.tensor([[1, 1, 1, 2]]), scores, torch.ones((1, 4), dtype=torch.bool), gt,
        torch.tensor([[1, 3]]), torch.tensor([[True, True]]), (0.5,))
    assert got[0, :, 0].tolist() == [1.0, 0.0, 0.0, 0.0]


# -- loss_dup -------------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dup_loss_pair():
    """The JAX driver of the narrow YAML with the duplicate removal (five
    heads), its removal's weights and the port's ROI heads with them."""
    jcfg, tcfg = train_cfgs(**DUP_ON)
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    rng = np.random.default_rng(12)
    dm = jrel.DuplicateRemovalModule(num_groups=4, key_dim=16, rank_dim=32, num_thresholds=5)
    probe = [jnp.asarray(a) for a in (np.zeros((1, 3, 64), np.float32), np.ones((1, 3), np.float32),
                                      boxes_np(rng, 1, 3), np.ones((1, 3), bool))]
    variables = {"params": {"duplicate_removal": dm.init(jax.random.PRNGKey(13), *probe)["params"]}}
    return dict(drv=drv, variables=variables, tcfg=tcfg,
                heads=port_heads(tcfg, convert_variables(variables)).train(),
                k=tcfg.MODEL.ROI_HEADS.NUM_CLASSES)


def dup_loss_inputs(seed, k, agnostic=False, s=40, g=5):
    """A sample of ``s`` slots per image whose centres lie on a shuffled
    2.5 px grid along each axis (so that no two candidates' centres come
    within 2 px, where the geometry embedding's slope is mild), ``g`` GT
    boxes each within 1 px of a slot (one GT a crowd, one invalid), class
    logits spread with each slot's GT class ahead, small deltas and the
    appearance features."""
    rng = np.random.default_rng(seed)
    step = 2.5
    cx = np.stack([rng.permutation(s) for _ in range(2)]) * step + 20
    cy = np.stack([rng.permutation(s) for _ in range(2)]) * step + 10
    wh = rng.uniform(12, 40, (2, s, 2))
    boxes = np.stack([cx - wh[..., 0] / 2, cy - wh[..., 1] / 2, cx + wh[..., 0] / 2,
                      cy + wh[..., 1] / 2], -1)
    owner = rng.integers(0, g, (2, s))
    owner[:, :g] = np.arange(g)
    gt = boxes[:, :g] + rng.uniform(-1, 1, (2, g, 4))
    valid = np.ones((2, s), bool)
    valid[1, s - 6:] = False
    gt_classes = rng.integers(0, k, (2, g)).astype(np.int32)
    logits = (rng.standard_normal((2, s, k + 1)) * 2).astype(np.float32)
    own = np.take_along_axis(gt_classes, owner, 1)
    np.put_along_axis(logits, own[..., None], 3.0 + np.take_along_axis(logits, own[..., None], 2),
                      2)
    deltas = (rng.standard_normal((2, s, 4 if agnostic else 4 * k)) * 0.05).astype(np.float32)
    app = rng.standard_normal((2 * s, 64)).astype(np.float32)
    batch = {"gt_boxes": gt.astype(np.float32), "gt_classes": gt_classes,
             "gt_valid": np.array([[True] * g, [True] * (g - 1) + [False]]),
             "gt_is_crowd": np.zeros((2, g), bool),
             "image_size": np.array([[128, 160], [112, 150]], np.int32)}
    batch["gt_is_crowd"][0, 1] = True
    return (logits.reshape(2 * s, -1), deltas.reshape(2 * s, -1), app,
            boxes.astype(np.float32), valid, batch)


def jax_dup_loss(pair, logits, deltas, app, boxes, valid, batch, agnostic=False):
    """The JAX ``dup_removal_loss`` and its gradients with respect to the
    class logits, the deltas and the appearance features."""
    drv, variables = pair["drv"], pair["variables"]
    drv.roi.cls_agnostic_bbox_reg = agnostic
    sampled = JaxSampledProposals(boxes=jnp.asarray(boxes), gt_classes=None, gt_boxes=None,
                                  matched_idx=None, is_fg=None, valid=jnp.asarray(valid))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}

    def loss(lg, d, a):
        return drv.dup_removal_loss(variables, StatsTape(variables), lg, d, a, sampled, jb,
                                    jb["image_size"])

    try:
        value, grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2)))(
            jnp.asarray(logits), jnp.asarray(deltas), jnp.asarray(app))
    finally:
        drv.roi.cls_agnostic_bbox_reg = False
    return float(value), [np.asarray(x) for x in grads]


def port_dup_loss(heads, logits, deltas, app, boxes, valid, batch):
    inputs = [t(a).requires_grad_(True) for a in (logits, deltas, app)]
    sampled = SampledProposals(t(boxes), None, None, None, None, t(valid))
    loss = heads.dup_removal_loss(*inputs, sampled, {k: t(v) for k, v in batch.items()})
    loss.backward()
    return float(loss.detach()), [x.grad.numpy() for x in inputs]


def assert_grad_close(got, want, name, tol=GRAD_TOL):
    """Within ``tol`` of ``want``'s largest magnitude, elementwise and in norm."""
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()),
                               err_msg=name)
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want), name


@pytest.mark.parametrize("seed,agnostic", [(0, False), (1, False), (2, True)])
def test_dup_removal_loss_and_gradients_match_jax(dup_loss_pair, seed, agnostic):
    """The loss to LOSS_RTOL and its gradients with respect to the class
    logits, the deltas and the appearance features to GRAD_TOL; every one
    of the three carries gradient (nothing is detached)."""
    pair = dup_loss_pair
    args = dup_loss_inputs(seed, pair["k"], agnostic)
    want, want_g = jax_dup_loss(pair, *args, agnostic=agnostic)
    heads = pair["heads"]
    heads.cls_agnostic_bbox_reg = agnostic
    try:
        got, got_g = port_dup_loss(heads, *args)
    finally:
        heads.cls_agnostic_bbox_reg = False
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert 0 < got < 1
    for name, g, w in zip(("class logits", "deltas", "appearance"), got_g, want_g):
        assert np.abs(w).max() > 0, name
        assert_grad_close(g, w, name)


def test_dup_removal_loss_clip_drops_the_gradient_of_a_hopeless_positive(dup_loss_pair):
    """The JAX package's fault, kept for parity: the final score is clipped
    to [1e-6, 1 - 1e-6] before the log, so a positive whose class score x
    sigmoid(keep logit) falls below 1e-6 gets no gradient at all, in both
    packages: with the keep logits' bias at -20 (every sigmoid ~2e-9) the
    loss reads -log(1e-6) for each positive column and nothing moves it;
    at -8 (~3e-4, above the clip) the same inputs have a gradient."""
    pair = dup_loss_pair
    args = dup_loss_inputs(3, pair["k"])
    found = {}
    for bias in (-20.0, -8.0):
        variables = jax.tree_util.tree_map(np.array, pair["variables"])
        variables["params"]["duplicate_removal"]["logit"]["bias"][:] = bias
        heads = port_heads(pair["tcfg"], convert_variables(variables)).train()
        want, want_g = jax_dup_loss({**pair, "variables": variables}, *args)
        got, got_g = port_dup_loss(heads, *args)
        np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
        found[bias] = (got, got_g, want_g)
    loss, got_g, want_g = found[-20.0]
    assert loss > 0.1 * -math.log(1e-6) / 5  # positives sit on the clip
    for g in got_g + want_g:
        assert not g.any()
    for g, w in zip(*found[-8.0][1:]):
        assert np.abs(g).max() > 0
        assert_grad_close(g, w, "above the clip")


# -- the whole narrow model ------------------------------------------------------------------

def spread_classes(variables):
    """The classifier's kernel x CLS_SPREAD: no class scores within rounding."""
    variables["params"]["box_predictors_0"]["cls_score"]["kernel"] *= CLS_SPREAD
    return variables


def jittered(props, sizes, seed=0):
    """``props`` with every box moved by up to JITTER px per coordinate,
    clipped to its image, at least 1 px wide and high."""
    rng = np.random.default_rng(seed)
    boxes = props.proposal_boxes + rng.uniform(-JITTER, JITTER, props.proposal_boxes.shape)
    hw = sizes[:, None, ::-1].astype(np.float64)
    boxes = np.clip(boxes, 0, np.concatenate([hw, hw], -1))
    boxes[..., 2:] = np.maximum(boxes[..., 2:], boxes[..., :2] + 1)
    return JaxInstances(proposal_boxes=boxes.astype(np.float32),
                        objectness_logits=props.objectness_logits, is_valid=props.is_valid)


def variant_variables(full, name):
    """The largest model's variables cut to ``name``'s model."""
    opts = VARIANTS[name]
    params = dict(full["params"])
    if not opts.get("MODEL.MASK_ON"):
        del params["mask_head"]
    if not opts:
        del params["duplicate_removal"]
    if opts.get("MODEL.ROI_BOX_HEAD.CLS_AGNOSTIC_BBOX_REG"):
        pred = dict(params["box_predictors_0"])
        pred["bbox_pred"] = {k: v[..., :4] for k, v in pred["bbox_pred"].items()}
        params["box_predictors_0"] = pred
    return {**full, "params": params}


@pytest.fixture(scope="module")
def shared():
    """One JAX init of the largest variant (removal and mask head), its
    jittered training proposals, the batch (GT 3 of image 1 a crowd) and the
    samplers' draws, shared by every variant."""
    jcfg, tcfg = train_cfgs(**VARIANTS["dup_mask"])
    nb = make_train_batch(tcfg, H, W)
    nb["gt_is_crowd"][1, 3] = True
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    variables = spread_classes(tame(jax_init(jcfg, 1, jbatch)))
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))

    def raw(v, b):
        _, logits, deltas = drv.features_and_rpn(v, b, True)
        return drv.rpn.proposals(logits, deltas, b["image_size"], training=True), [
            lg.shape for lg in logits]

    props, shapes = jax.jit(raw)(variables, jbatch)
    props = jittered(jax.tree_util.tree_map(np.asarray, props), nb["image_size"])
    step_rng = jax.random.PRNGKey(1)
    rng_rpn, rng_roi = jax.random.split(step_rng)
    n_anchors = sum(int(np.prod(s[1:])) for s in shapes)
    noise = {"rpn": jax_noise(rng_rpn, B, n_anchors),
             "roi": jax_noise(rng_roi, B, props.is_valid.shape[1] + G)}
    return dict(variables=variables, jbatch=jbatch, tbatch=tbatch, props=props, noise=noise,
                step_rng=step_rng)


@pytest.fixture(scope="module", params=list(VARIANTS))
def step(request, shared):
    """One training step of both packages: losses, gradients, the models."""
    name = request.param
    jcfg, tcfg = train_cfgs(**VARIANTS[name])
    variables = variant_variables(shared["variables"], name)
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))

    def total_loss(params):
        total, (losses, _) = drv.loss_fn({**variables, "params": params}, shared["jbatch"],
                                         shared["step_rng"], {})
        return total, losses

    with fixed_jax_proposals(drv, shared["props"]):
        (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(total_loss, has_aux=True))(
            variables["params"])
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables),
                         training=True)
    with jax_proposals(tmodel, shared["props"]):
        t_losses = tmodel.losses(shared["tbatch"], noise=shared["noise"])
    sum(t_losses.values()).backward()
    return dict(
        name=name, jcfg=jcfg, tcfg=tcfg, variables=variables, j_total=float(j_total),
        j_losses={k: float(v) for k, v in j_losses.items()},
        j_tree=j_grads, j_grads=convert_variables({"params": j_grads}), tmodel=tmodel,
        t_losses={k: float(v.detach()) for k, v in t_losses.items()},
        t_grads={n: p.grad.numpy().copy() for n, p in tmodel.named_parameters()
                 if p.grad is not None})


def test_relation_loss_dict_matches_jax(step):
    """The keys in the JAX ``loss_fn``'s order (``loss_dup`` after
    ``loss_box_reg``, before ``loss_mask``) and each value to LOSS_RTOL."""
    cfg = step["tcfg"].MODEL
    keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg") + (
        ("loss_dup",) if cfg.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_ON else ()) + (
        ("loss_mask",) if cfg.MASK_ON else ())
    got, want = step["t_losses"], step["j_losses"]
    assert tuple(got) == keys and set(want) == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=MASK_LOSS_RTOL if k == "loss_mask"
                                   else LOSS_RTOL, err_msg=k)
    assert got["loss_box_reg"] > 0 and got.get("loss_dup", 1.0) > 0


def grad_tol(name: str, removal: bool) -> float:
    """The tolerance of ``name``'s gradient (the module docstring)."""
    if removal and name.startswith(("roi_heads.duplicate_removal.relation.geometry_weight.",
                                    "roi_heads.box_predictor.bbox_pred.")):
        return REMOVAL_GRAD_TOL
    return GEO_GRAD_TOL if ".geometry_weight." in name else GRAD_TOL


def check_gradients(t_grads, j_grads, trainable, removal: bool):
    """Every trainable gradient against JAX's (``grad_tol``; a ``key.bias``
    below GRAD_TOL of its kernel's on both sides); the frozen stem and res2
    have none in the port and a zero one in JAX."""
    assert set(t_grads) == set(trainable)
    for name, w in j_grads.items():
        w = w.numpy()
        if name not in trainable:
            assert name.startswith(FROZEN) and not w.any(), name
        elif name.endswith(".key.bias"):
            bound = GRAD_TOL * float(np.abs(j_grads[name[:-4] + "weight"].numpy()).max())
            assert np.abs(w).max() <= bound and np.abs(t_grads[name]).max() <= bound, name
        else:
            assert_grad_close(t_grads[name], w, name, grad_tol(name, removal))


def test_relation_gradients_match_jax(step):
    """Every trainable parameter's gradient against ``jax.grad``, the relation
    modules and the duplicate removal included, each of which moves."""
    trainable = tsolver.trainable_parameters(step["tmodel"], 2)
    dup = step["tcfg"].MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_ON
    check_gradients(step["t_grads"], step["j_grads"], trainable, dup)
    relation = [n for n in trainable if n.startswith(("roi_heads.box_head.relation",
                                                      "roi_heads.duplicate_removal."))]
    assert len(relation) == 20 + (16 if dup else 0)
    for n in relation:
        assert n.endswith(".key.bias") or np.abs(step["t_grads"][n]).max() > 0, n


@pytest.mark.parametrize("step", ["dup"], indirect=True)
def test_relation_train_step_matches_optax(step, shared):
    """``create_train_state`` + ``build_train_step`` with the removal: the
    total loss and one step's parameter updates against the JAX gradients
    through the optax chain (an update within ``grad_tol`` of the largest,
    plus one float32 spacing)."""
    start = convert_variables(step["variables"])
    model = build_model(step["tcfg"], device="cpu", state_dict=start, training=True)
    state = create_train_state(step["tcfg"], model, torch.Generator().manual_seed(0))
    with jax_proposals(model, shared["props"]):
        metrics = build_train_step(step["tcfg"], state)(shared["tbatch"], noise=shared["noise"])
    assert tuple(metrics) == ("total_loss", "loss_rpn_cls", "loss_rpn_loc", "loss_cls",
                              "loss_box_reg", "loss_dup")
    np.testing.assert_allclose(float(metrics["total_loss"]), step["j_total"], rtol=LOSS_RTOL)
    want = convert_variables({"params": jax_updated_params(
        step["jcfg"], step["variables"]["params"], step["j_tree"])})
    for name, p in model.named_parameters():
        got, w, s = p.detach().numpy(), want[name].numpy(), start[name].numpy()
        du, dw = got - s, w - s
        slack = grad_tol(name, True) * np.abs(dw).max() + np.spacing(np.maximum(np.abs(got), np.abs(w)))
        if name.endswith(".key.bias"):  # its zero gradient's rounding, then weight decay
            slack += GRAD_TOL * np.abs(want[name[:-4] + "weight"].numpy() - start[
                name[:-4] + "weight"].numpy()).max()
        assert (np.abs(du - dw) <= slack).all(), name
    assert not np.array_equal(want["roi_heads.duplicate_removal.logit.weight"].numpy(),
                              start["roi_heads.duplicate_removal.logit.weight"].numpy())



# -- the overfit recipe ---------------------------------------------------------------------

RELATION_OVERFIT_NARROW = [str(x) for kv in {
    "MODEL.ROI_BOX_HEAD.FC_DIM": 64, "MODEL.ROI_BOX_RELATION_HEAD.NUM_GROUPS": 4,
    "MODEL.ROI_BOX_RELATION_HEAD.NMS_NUM_GROUP": 4, "MODEL.ROI_BOX_RELATION_HEAD.KEY_DIM": 16,
    "MODEL.ROI_BOX_RELATION_HEAD.RANK_EMBEDDING_DIM": 32}.items() for x in kv]


def test_relation_overfit_cfg_matches_the_jax_tool(monkeypatch):
    """``overfit_cfg("relation")`` is the JAX tool's key for key (the
    removal on, FPN anchors for 10-30 px boxes), and so is it with the JAX
    tool's ``--no-dup`` / ``--dup-max`` against the port's flags."""
    import sys

    from detectron2_tensorflow_tpu_torch.tools import overfit_check

    check_overfit_cfg("relation")
    from tools import overfit_check as jax_overfit_check
    from test_torch_config import assert_same_tree

    for flags, dup, dup_max in ((["--no-dup"], False, False), (["--dup-max"], True, True)):
        monkeypatch.setattr(sys, "argv", ["overfit_check.py", "600", "--arch", "relation", *flags])
        args = overfit_check.parse_args(sys.argv[1:])
        assert (args.dup, args.dup_max) == (dup, dup_max)
        assert_same_tree(jax_overfit_check.overfit_cfg("relation"),
                         overfit_check.overfit_cfg("relation", args.dup, args.dup_max))
    with pytest.raises(SystemExit):
        overfit_check.parse_args(["1", "--arch", "rcnn", "--no-dup"])


def test_relation_overfit_check_runs_on_the_cpu(capsys):
    """``tools.overfit_check 1 --arch relation --seed 1 --device cpu`` at
    narrow widths trains a step with ``loss_dup`` and evaluates (bbox only,
    the seed in the JSON line); no kernel launches on the CPU."""
    from test_torch_c4 import OVERFIT_NARROW

    out = run_overfit_check("relation", ["--seed", "1", *OVERFIT_NARROW,
                                         *RELATION_OVERFIT_NARROW], capsys, steps=1)
    assert out["arch"] == "relation" and out["seed"] == 1 and out["steps"] == 1
    assert np.isfinite(out["final_loss"])
    assert 0.0 <= out["bbox_ap"] <= 100.0 and "segm_ap" not in out
    assert out["launches"] == {k: 0 for k in out["launches"]}


def test_profile_train_times_the_relation_head_and_loss_dup(monkeypatch):
    """``profile_train.relation_train_times`` on a narrow model with the
    removal (the profiler's timer stubbed: the CPU has no device time):
    the step's sampled ROIs, the head's forward and backward and
    ``loss_dup``'s each run, and the model keeps no gradient."""
    from detectron2_tensorflow_tpu_torch.tools import profile_predict, profile_train

    ran = []

    def device_time(fn, runs, host_ops=True):
        fn()
        ran.append(runs)
        return 1.0, 1.0, 0.0, None

    monkeypatch.setattr(profile_predict, "device_time", device_time)
    _, tcfg = train_cfgs(**DUP_ON, **{"MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200,
                                      "MODEL.RPN.POST_NMS_TOPK_TRAIN": 100})
    model = build_model(tcfg, device="cpu", training=True)
    data = {k: torch.from_numpy(v) for k, v in make_train_batch(tcfg, H, W).items()}
    got = profile_train.relation_train_times(model, data)
    assert got == {"rois": (B, 512), "head_ms": 1.0, "dup_ms": 1.0} and len(ran) == 2
    assert all(p.grad is None for p in model.parameters())
