"""The training slice: the port's losses, gradients, sampler, matcher and
solver against the JAX package's on the same numpy inputs.

R50 depth at narrow widths (``test_torch_config.NARROW``), 5 classes,
float32, 2 x 128 x 160 images with 5 GT boxes each and 56x56 mini-masks, the
``bench_train.train_cfg()`` configuration otherwise. The JAX weights are
carried over by ``convert.py`` and the samplers' uniform noise is the JAX
package's own draws (``jax_noise``), handed to the port. The RPN's
proposals come out of a top-k over float32 scores, and the two packages'
convolutions round differently: scores closer than that rounding (about
1e-8 here) may trade slots. So the proposals are compared as sets with equal
scores, and the tests of the later stages hand both sides the same
proposals, computed once by the JAX package (``jax_proposals`` for the port,
``fixed_jax_proposals`` for ``loss_fn``, which computes them without
gradient). Even a second compile of the JAX package's own proposal code
rounds differently, and a proposal that trades slots changes a few sampled
ROIs: at random weights every ROI has nearly the same loss, so the losses
move by 1e-6 while the gradients move by 4e-3. On the CPU the JAX
model takes its XLA pooler, whose gradient is autodiff of the patch
gather; the port takes ``roi_patch_backward_reference`` through
``RoiPatchPoolMulti``.

Tolerances: integer outputs (matched GT, labels, sampled indices, classes,
validity) must be equal. Losses agree to 1e-5 relative: the same float32
arithmetic in other orders. The mask loss is a mean of 2e5 terms that are
nearly all ln 2 at random weights, and the JAX package's XLA CPU path sums
them in sequence in float32: it reads 1.1e-4 relative above the float64
value, which the port meets to 1e-7; so ``loss_mask`` is held to 3e-4.
Gradients and one step's parameter updates are held to GRAD_TOL = 1e-4 of
each tensor's largest magnitude, element by element and as a norm. Measured
worst: 2.6e-6 elementwise and 1.6e-6 in norm (the mask head's deconv bias,
a sum over every mask position); the updates the same. The one thing that
moves a gradient further is a ReLU input within float32 rounding of 0,
which takes the other side on one of the two packages and moves a whole
slice of the gradient below it by ~1e-3: the weights of ``PRNGKey(0)`` had
one in the mask head (4e-8 of its scale, reached by a 1-ulp change of the
image on the port alone), so the JAX package initializes from
``PRNGKey(1)``, where no such input exists. The updates the two solvers
make from the same gradients agree to 1e-5 relative. The LR schedule agrees
to 1e-6 relative (float32 on both sides).
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import bench_train
from detectron2_tensorflow_tpu import solver as jsolver
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models import losses as jlosses
from detectron2_tensorflow_tpu.models.matcher import Matcher as JaxMatcher
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts, _RCNNDrivers
from detectron2_tensorflow_tpu.models.roi_heads.roi_heads import (
    SampledProposals as JaxSampledProposals,
)
from detectron2_tensorflow_tpu.models.rpn import add_ground_truth_to_proposals as jax_add_gt
from detectron2_tensorflow_tpu.models.sampling import subsample_labels as jax_subsample
from detectron2_tensorflow_tpu.structures import boxes as jboxes
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch import train_cfg as torch_train_cfg
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models import losses as tlosses
from detectron2_tensorflow_tpu_torch.models.matcher import Matcher
from detectron2_tensorflow_tpu_torch.models.roi_heads.roi_heads import SampledProposals
from detectron2_tensorflow_tpu_torch.models.rpn import add_ground_truth_to_proposals
from detectron2_tensorflow_tpu_torch.models.sampling import subsample_labels
from detectron2_tensorflow_tpu_torch.structures import Instances
from detectron2_tensorflow_tpu_torch.structures import boxes as tboxes
from test_torch_config import NARROW, _set
from test_torch_slice import tame_variables

B, H, W, G = 2, 128, 160, 5
LOSS_RTOL, MASK_LOSS_RTOL = 1e-5, 3e-4
GRAD_TOL = 1e-4
UPDATE_RTOL = 1e-5
LOSS_KEYS = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg", "loss_mask")


def train_cfgs(**overrides):
    """(JAX cfg, port cfg): ``train_cfg(2)`` at narrow widths, G GT slots."""
    jcfg, tcfg = bench_train.train_cfg(B), torch_train_cfg(B)
    for path, value in {**NARROW, "INPUT.MAX_GT_INSTANCES": G, **overrides}.items():
        _set(jcfg, path, value)
        _set(tcfg, path, value)
    return jcfg, tcfg


def jax_noise(key, b, n):
    """The uniform draws ``subsample_labels`` makes for ``b`` images of ``n``
    items under the JAX package's per-image key split, as (pos, neg) tensors."""
    pos, neg = [], []
    for k in jax.random.split(key, b):
        kp, kn = jax.random.split(k)
        pos.append(np.asarray(jax.random.uniform(kp, (n,))))
        neg.append(np.asarray(jax.random.uniform(kn, (n,))))
    return torch.from_numpy(np.stack(pos)), torch.from_numpy(np.stack(neg))


@contextlib.contextmanager
def fixed_jax_proposals(drv, props):
    """Make the JAX package's ``loss_fn`` (of ``drv``) take the proposals
    ``props`` in place of its own (which it computes without gradient)."""
    drv.rpn.proposals = lambda *args, **kwargs: props
    try:
        yield
    finally:
        del drv.rpn.proposals


def jax_pieces(drv, variables, batch, step_rng):
    """The JAX package's RPN losses, raw training proposals, proposals with
    GT appended and the ROI sample of one step, as numpy trees."""
    rng_rpn, rng_roi = jax.random.split(step_rng)

    def pieces(v, b):
        _, logits, deltas = drv.features_and_rpn(v, b, True)
        rpn_losses = drv.rpn.losses(rng_rpn, logits, deltas, b, b["image_size"])
        raw = drv.rpn.proposals(logits, deltas, b["image_size"], training=True)
        props = jax_add_gt(raw, b)
        sampled = drv.roi.label_and_sample_proposals(rng_roi, props, b)
        return rpn_losses, raw, props, {f.name: getattr(sampled, f.name)
                                        for f in dataclasses.fields(sampled)}

    rpn, raw, props, sampled = jax.tree_util.tree_map(np.asarray, jax.jit(pieces)(variables, batch))
    return rpn, raw, props, JaxSampledProposals(**sampled)


@contextlib.contextmanager
def jax_proposals(model, props):
    """Make ``model``'s RPN return the JAX package's proposals ``props``."""
    fields = {k: torch.from_numpy(np.array(getattr(props, k)))
              for k in ("proposal_boxes", "objectness_logits", "is_valid")}
    model.proposal_generator.proposals = lambda *args, **kwargs: Instances(**fields)
    try:
        yield
    finally:
        del model.proposal_generator.proposals


def assert_grad_close(got, want, name):
    """Within GRAD_TOL of ``want``'s largest magnitude, elementwise and in norm."""
    np.testing.assert_allclose(got, want, rtol=0, atol=GRAD_TOL * float(np.abs(want).max()),
                               err_msg=name)
    assert np.linalg.norm(got - want) <= GRAD_TOL * np.linalg.norm(want), name


def assert_update_close(got, want, start, tol, name):
    """Parameters after an update: ``got - start`` against ``want - start``
    within ``tol`` of the largest update, plus one float32 spacing of the
    parameter (each side rounds ``p + u`` on its own)."""
    du, dw = got - start, want - start
    slack = tol * np.abs(dw).max() + np.spacing(np.maximum(np.abs(got), np.abs(want)))
    bad = np.abs(du - dw) > slack
    assert not bad.any(), f"{name}: {bad.sum()} updates differ, max {np.abs(du - dw).max()}"


@pytest.fixture(scope="module")
def run():
    jcfg, tcfg = train_cfgs()
    nb = make_train_batch(tcfg, H, W)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    variables = tame_variables(jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(1), jbatch))
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    step_rng = jax.random.PRNGKey(1)
    rng_rpn, rng_roi = jax.random.split(step_rng)

    def total_loss(params):
        total, (loss_dict, _) = drv.loss_fn({**variables, "params": params}, jbatch, step_rng, {})
        return total, loss_dict

    j_rpn, j_raw, j_props, j_sampled = jax_pieces(drv, variables, jbatch, step_rng)
    with fixed_jax_proposals(drv, j_raw):
        (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(total_loss, has_aux=True))(
            variables["params"])

    tmodel = build_model(tcfg, state_dict=convert_variables(variables), training=True)
    n_anchors = sum(int(np.prod(x.shape[1:3])) * 3 for x in _port_logits(tmodel, tbatch))
    noise = {"rpn": jax_noise(rng_rpn, B, n_anchors),
             "roi": jax_noise(rng_roi, B, j_props.is_valid.shape[1])}
    with jax_proposals(tmodel, j_raw):
        t_losses = tmodel.losses(tbatch, noise=noise)
    sum(t_losses.values()).backward()
    t_grads = {n: p.grad.numpy().copy() for n, p in tmodel.named_parameters() if p.grad is not None}
    return dict(
        jcfg=jcfg, tcfg=tcfg, jbatch=jbatch, tbatch=tbatch, variables=variables, drv=drv,
        j_rpn=j_rpn, j_raw=j_raw, j_props=j_props, j_sampled=j_sampled,
        j_total=float(j_total),
        j_losses={k: float(v) for k, v in j_losses.items()}, j_grads=j_grads,
        tmodel=tmodel, noise=noise, t_losses={k: float(v.detach()) for k, v in t_losses.items()},
        t_grads=t_grads,
    )


def _port_logits(model, batch):
    with torch.no_grad():
        feats = model.features(batch["image"])
        rpn = model.proposal_generator
        return rpn.rpn_head([feats[f] for f in rpn.in_features])[0]


# -- components --------------------------------------------------------------

@pytest.mark.parametrize("low_quality", [False, True])
def test_matcher_matches_jax(low_quality):
    rng = np.random.default_rng(3)
    gt = rng.uniform(0, 100, (3, 6, 2))
    gt = np.concatenate([gt, gt + rng.uniform(5, 60, (3, 6, 2))], -1).astype(np.float32)
    anchors = np.concatenate([gt[0, :3], rng.uniform(0, 80, (200, 2)).repeat(2, 1)
                              + np.array([0, 0, 30, 30])], 0).astype(np.float32)  # ties
    valid = rng.uniform(0, 1, (3, 6)) > 0.3
    valid[2] = False  # an image without GT
    thresholds, labels = ([0.3, 0.7], [0, -1, 1]) if low_quality else ([0.5], [0, 1])
    q = tboxes.pairwise_iou(torch.from_numpy(gt), torch.from_numpy(anchors))
    idx, lab = Matcher(thresholds, labels, low_quality)(q, torch.from_numpy(valid))
    jm = JaxMatcher(thresholds, labels, low_quality)
    for i in range(3):
        jq = jboxes.pairwise_iou(jnp.asarray(gt[i]), jnp.asarray(anchors))
        jidx, jlab = jm(jq, jnp.asarray(valid[i]))
        np.testing.assert_array_equal(idx[i].numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(lab[i].numpy(), np.asarray(jlab))
    assert (lab[2].numpy() == labels[0]).all()


@pytest.mark.parametrize("n,p_pos,p_neg", [(3000, 0.01, 0.9), (900, 0.3, 0.3), (40, 0.1, 0.2)])
def test_subsample_labels_matches_jax(n, p_pos, p_neg):
    rng = np.random.default_rng(n)
    u = rng.uniform(0, 1, (3, n))
    labels = np.where(u < p_pos, 1, np.where(u < p_pos + p_neg, 0, -1)).astype(np.int32)
    key = jax.random.PRNGKey(n)
    got = subsample_labels(torch.from_numpy(labels), 256, 0.25, jax_noise(key, 3, n))
    for i, k in enumerate(jax.random.split(key, 3)):
        want = jax_subsample(k, jnp.asarray(labels[i]), 256, 0.25)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w))


def test_box_ops_match_jax():
    rng = np.random.default_rng(5)
    a = rng.uniform(-20, 150, (7, 4)).astype(np.float32)
    b = rng.uniform(-20, 150, (9, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        tboxes.pairwise_ioa(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jboxes.pairwise_ioa(jnp.asarray(a), jnp.asarray(b))))
    size = np.array([[100, 120], [140, 90]], np.int32)
    got = tboxes.inside_image(torch.from_numpy(np.stack([b, b])), torch.from_numpy(size), 3.0)
    for i in range(2):
        want = jboxes.inside_image(jnp.asarray(b), jnp.asarray(size[i]), 3.0)
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


@pytest.mark.parametrize("beta", [0.0, 0.5])
def test_losses_match_jax(beta):
    rng = np.random.default_rng(11)
    x, y = (rng.standard_normal((50, 4)).astype(np.float32) for _ in range(2))
    np.testing.assert_allclose(
        tlosses.smooth_l1_loss(torch.from_numpy(x), torch.from_numpy(y), beta).numpy(),
        np.asarray(jlosses.smooth_l1_loss(jnp.asarray(x), jnp.asarray(y), beta)), rtol=1e-6)
    logits = (rng.standard_normal((50, 6)) * 8).astype(np.float32)
    t = (rng.uniform(0, 1, (50, 6)) > 0.5).astype(np.float32)
    np.testing.assert_allclose(
        tlosses.sigmoid_cross_entropy(torch.from_numpy(logits), torch.from_numpy(t)).numpy(),
        np.asarray(jlosses.sigmoid_cross_entropy(jnp.asarray(logits), jnp.asarray(t))),
        rtol=1e-6, atol=1e-7)
    lab = rng.integers(-1, 8, 50).astype(np.int32)
    np.testing.assert_allclose(
        tlosses.softmax_cross_entropy(torch.from_numpy(logits), torch.from_numpy(lab)).numpy(),
        np.asarray(jlosses.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(lab))),
        rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("overrides", [
    {},
    {"SOLVER.WARMUP_METHOD": "constant", "SOLVER.STEPS": (5, 9), "SOLVER.WARMUP_ITERS": 4},
    {"SOLVER.AUTO_SCALE_LR_SCHEDULE": True, "SOLVER.IMS_PER_BATCH": 8,
     "SOLVER.STEPS": (30000, 35000), "SOLVER.BASE_LR": 0.02},
])
def test_lr_schedule_matches_jax(overrides):
    jcfg, tcfg = train_cfgs(**overrides)
    assert tsolver.scaled_max_iter(tcfg) == jsolver.scaled_max_iter(jcfg)
    ours, theirs = tsolver.build_lr_schedule(tcfg), jsolver.build_lr_schedule(jcfg)
    for step in [0, 1, 2, 3, 4, 5, 8, 9, 10, 500, 999, 1000, 1001, 14999, 15000, 17500,
                 29999, 30000, 40000]:
        np.testing.assert_allclose(ours(step), float(theirs(step)), rtol=1e-6, err_msg=step)


def test_make_train_batch_matches_bench_train():
    jcfg, tcfg = bench_train.train_cfg(2), torch_train_cfg(2)
    want = bench_train.make_train_batch(jcfg)
    got = make_train_batch(tcfg)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].shape == v.shape and got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], np.asarray(v), err_msg=k)


# -- the slice on shared weights and noise -------------------------------------

def test_rpn_losses_match_jax(run):
    m = run["tmodel"]
    with torch.no_grad():
        feats = m.features(run["tbatch"]["image"])
        rpn = m.proposal_generator
        logits, deltas = rpn.rpn_head([feats[f] for f in rpn.in_features])
        got = rpn.losses(logits, deltas, run["tbatch"], run["tbatch"]["image_size"],
                         run["noise"]["rpn"])
    for k, v in run["j_rpn"].items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    assert float(got["loss_rpn_loc"]) > 0  # positives were sampled


def test_training_proposals_match_jax(run):
    """The ``*_TRAIN`` budgets' proposals: the same valid slots and scores,
    the same boxes as sets; a slot whose box differs holds a near-tie that
    traded places with its neighbour."""
    m, tb, jp = run["tmodel"], run["tbatch"], run["j_raw"]
    with torch.no_grad():
        feats = m.features(tb["image"])
        rpn = m.proposal_generator
        logits, deltas = rpn.rpn_head([feats[f] for f in rpn.in_features])
        props = rpn.proposals(logits, deltas, tb["image_size"], training=True)
    assert props.proposal_boxes.shape == (B, 1000, 4)
    np.testing.assert_array_equal(props.is_valid.numpy(), jp.is_valid)
    assert props.is_valid.numpy().sum() > 1000
    scores = props.objectness_logits.numpy()
    np.testing.assert_allclose(scores, jp.objectness_logits, rtol=1e-4, atol=1e-6)
    boxes = props.proposal_boxes.numpy()
    for i in range(B):
        np.testing.assert_allclose(np.sort(boxes[i], 0), np.sort(jp.proposal_boxes[i], 0),
                                   rtol=1e-4, atol=1e-4)
        moved = np.flatnonzero(np.abs(boxes[i] - jp.proposal_boxes[i]).max(-1) > 1e-3)
        for j in moved:
            near = scores[i, max(j - 1, 0): j + 2]
            assert np.abs(near - scores[i, j]).min(initial=1.0, where=near != scores[i, j]) < 1e-7


def test_label_and_sample_proposals_match_jax(run):
    """GT appended, matching and sampling on the JAX package's proposals:
    the same sampled slots, classes, matched GT and validity."""
    m, tb = run["tmodel"], run["tbatch"]
    raw = run["j_raw"]
    props = add_ground_truth_to_proposals(
        Instances(**{k: torch.from_numpy(np.array(getattr(raw, k)))
                     for k in ("proposal_boxes", "objectness_logits", "is_valid")}), tb)
    got = m.roi_heads.label_and_sample_proposals(props, tb, run["noise"]["roi"])
    jp, js = run["j_props"], run["j_sampled"]
    np.testing.assert_array_equal(props.is_valid.numpy(), jp.is_valid)
    np.testing.assert_array_equal(props.proposal_boxes.numpy(), jp.proposal_boxes)
    np.testing.assert_array_equal(props.objectness_logits.numpy(), jp.objectness_logits)
    for k in ("boxes", "gt_classes", "gt_boxes", "matched_idx", "is_fg", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(js, k), err_msg=k)
    assert got.valid.numpy().all() and got.is_fg.numpy().sum() >= B * G


def test_box_and_mask_losses_match_jax(run):
    """Both heads' losses on the JAX package's sample and the same logits."""
    js, heads, jroi = run["j_sampled"], run["tmodel"].roi_heads, run["drv"].roi
    rng = np.random.default_rng(2)
    n, k, m = B * js.boxes.shape[1], run["tcfg"].MODEL.ROI_HEADS.NUM_CLASSES, heads.mask_slots
    cls_logits = rng.standard_normal((n, k + 1)).astype(np.float32)
    deltas = (rng.standard_normal((n, 4 * k)) * 0.5).astype(np.float32)
    mask_logits = (rng.standard_normal((B * m, 28, 28, k)) * 3).astype(np.float32)
    tsam = SampledProposals(*(torch.from_numpy(np.asarray(getattr(js, f))) for f in
                              ("boxes", "gt_classes", "gt_boxes", "matched_idx", "is_fg", "valid")))
    got = heads.box_losses(torch.from_numpy(cls_logits), torch.from_numpy(deltas), tsam)
    want = jroi.box_losses(jnp.asarray(cls_logits), jnp.asarray(deltas), js)
    for key in want:
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL, err_msg=key)
    got_m = heads.mask_loss(torch.from_numpy(mask_logits), tsam, run["tbatch"])
    want_m = jroi.mask_loss(jnp.asarray(mask_logits), js, run["jbatch"])
    np.testing.assert_allclose(float(got_m), float(want_m), rtol=LOSS_RTOL)
    assert float(got["loss_box_reg"]) > 0 and float(got_m) > 0


def test_loss_dict_matches_jax(run):
    got, want = run["t_losses"], run["j_losses"]
    assert tuple(got) == LOSS_KEYS and set(want) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        rtol = MASK_LOSS_RTOL if k == "loss_mask" else LOSS_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
    np.testing.assert_allclose(sum(got.values()), run["j_total"], rtol=LOSS_RTOL,
                               atol=MASK_LOSS_RTOL * want["loss_mask"])


def test_gradients_match_jax(run):
    """Every trainable parameter's gradient against ``jax.grad``, carried
    into the port's layout by ``convert_variables``; the frozen stem and
    res2 have no gradient in the port and a zero one in JAX."""
    want = convert_variables({"params": run["j_grads"]})
    trainable = tsolver.trainable_parameters(run["tmodel"], 2)
    assert set(run["t_grads"]) == set(trainable)
    for name, w in want.items():
        if name in trainable:
            assert_grad_close(run["t_grads"][name], w.numpy(), name)
        else:
            assert name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2."))
            assert not w.numpy().any(), name
    assert len(trainable) == len(want) - 11  # stem conv + res2's 10 convs


@pytest.mark.parametrize("overrides", [
    {},
    {"SOLVER.BIAS_LR_FACTOR": 2.0, "SOLVER.WEIGHT_DECAY_BIAS": 0.0,
     "SOLVER.CLIP_GRADIENTS_BY_NORM": 0.05, "SOLVER.WARMUP_ITERS": 2,
     "SOLVER.STEPS": (2,), "SOLVER.BASE_LR": 0.05},
])
def test_optimizer_steps_match_optax(run, overrides):
    """Three updates with the same gradients: warmup LR, momentum trace,
    weight decay per group, clipping over the trainable gradients only, the
    bias LR factor and the frozen mask, against ``build_optimizer``."""
    jcfg, tcfg = train_cfgs(**overrides)
    params = run["variables"]["params"]
    tx = jsolver.build_optimizer(jcfg, params)
    opt_state = tx.init(params)
    model = build_model(tcfg, state_dict=convert_variables(run["variables"]), training=True)
    opt = tsolver.build_optimizer(tcfg, model)
    grads = convert_variables({"params": run["j_grads"]})
    tparams = dict(model.named_parameters())
    norm = np.sqrt(sum(float((grads[n] ** 2).sum()) for n in opt_trainable(model)))
    assert (norm > tcfg.SOLVER.CLIP_GRADIENTS_BY_NORM) == bool(overrides)  # clipping triggers
    for _ in range(3):
        updates, opt_state = tx.update(run["j_grads"], opt_state, params)
        params = optax.apply_updates(params, updates)
        for name, p in tparams.items():
            p.grad = grads[name].clone()
        opt.step()
    start = convert_variables(run["variables"])
    want = convert_variables({"params": params})
    for name, p in tparams.items():
        if name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")):
            assert torch.equal(p.detach(), start[name]), name
            np.testing.assert_array_equal(want[name].numpy(), start[name].numpy(), err_msg=name)
        else:
            assert_update_close(p.detach().numpy(), want[name].numpy(), start[name].numpy(),
                                UPDATE_RTOL, name)


def opt_trainable(model):
    return tsolver.trainable_parameters(model, 2)


def test_train_step_matches_jax_update(run):
    """``create_train_state`` + ``build_train_step``: the metrics and one
    step's parameter updates against ``loss_fn``'s gradients through the
    optax chain."""
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    start = convert_variables(run["variables"])
    model = build_model(tcfg, state_dict=start, training=True)
    state = create_train_state(tcfg, model, torch.Generator().manual_seed(0))
    with jax_proposals(model, run["j_raw"]):
        metrics = build_train_step(tcfg, state)(run["tbatch"], noise=run["noise"])
    assert state.step == 1 and state.optimizer.count == 1
    assert tuple(metrics) == ("total_loss",) + LOSS_KEYS
    np.testing.assert_allclose(float(metrics["total_loss"]), run["j_total"], rtol=LOSS_RTOL,
                               atol=MASK_LOSS_RTOL * run["j_losses"]["loss_mask"])

    params = run["variables"]["params"]
    tx = jsolver.build_optimizer(jcfg, params)
    updates, _ = tx.update(run["j_grads"], tx.init(params), params)
    want = convert_variables({"params": optax.apply_updates(params, updates)})
    for name, p in model.named_parameters():
        assert_update_close(p.detach().numpy(), want[name].numpy(), start[name].numpy(),
                            GRAD_TOL, name)


def test_train_step_draws_noise_from_the_generator():
    """Without handed-in noise the samplers draw from the state's generator:
    the same seed gives the same losses, another seed other ones."""
    _, tcfg = train_cfgs()
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(tcfg, H, W).items()}
    totals = []
    for seed in (5, 5, 6):
        model = build_model(tcfg, generator=torch.Generator().manual_seed(0), training=True)
        state = create_train_state(tcfg, model, torch.Generator().manual_seed(seed))
        metrics = build_train_step(tcfg, state)(batch)
        assert all(np.isfinite(float(v)) for v in metrics.values())
        totals.append(float(metrics["total_loss"]))
    assert totals[0] == totals[1] != totals[2]


# -- crowd regions and the boundary rule ---------------------------------------

@pytest.fixture(scope="module")
def crowd(run):
    """``run``'s weights and noise on a batch with two crowd GT slots, one of
    them a large region over many anchors and proposals, under
    ``MODEL.RPN.BOUNDARY_THRESH = 0``: the crowd-ignore, crowd-exclusion and
    anchor-boundary branches that ``run`` (no crowds, -1) leaves untaken."""
    jcfg, tcfg = train_cfgs(**{"MODEL.RPN.BOUNDARY_THRESH": 0})
    nb = make_train_batch(tcfg, H, W)
    nb["gt_boxes"][0, 1] = (16, 12, 136, 104)
    nb["gt_is_crowd"][0, 1] = nb["gt_is_crowd"][1, 3] = True
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    variables = run["variables"]
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    step_rng = jax.random.PRNGKey(1)
    j_rpn, j_raw, j_props, j_sampled = jax_pieces(drv, variables, jbatch, step_rng)
    with fixed_jax_proposals(drv, j_raw):
        _, (j_losses, _) = jax.jit(lambda v, b: drv.loss_fn(v, b, step_rng, {}))(variables, jbatch)
    tmodel = build_model(tcfg, state_dict=convert_variables(variables), training=True)
    with torch.no_grad(), jax_proposals(tmodel, j_raw):
        t_losses = tmodel.losses(tbatch, noise=run["noise"])
    return dict(tbatch=tbatch, j_rpn=j_rpn, j_raw=j_raw, j_props=j_props, j_sampled=j_sampled,
                j_losses={k: float(v) for k, v in j_losses.items()}, tmodel=tmodel,
                t_losses={k: float(v) for k, v in t_losses.items()})


def test_crowd_rpn_losses_match_jax(run, crowd):
    """Anchors mostly inside a crowd region and anchors across the image
    border are ignored as the JAX package ignores them."""
    m, tb = crowd["tmodel"], crowd["tbatch"]
    with torch.no_grad():
        feats = m.features(tb["image"])
        rpn = m.proposal_generator
        logits, deltas = rpn.rpn_head([feats[f] for f in rpn.in_features])
        got = rpn.losses(logits, deltas, tb, tb["image_size"], run["noise"]["rpn"])
    assert rpn.boundary_thresh == 0
    for k, v in crowd["j_rpn"].items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=LOSS_RTOL, err_msg=k)
    # Other positives than without crowds (the classification loss is near
    # ln 2 for every anchor at random weights and hardly moves).
    loc, loc0 = float(crowd["j_rpn"]["loss_rpn_loc"]), float(run["j_rpn"]["loss_rpn_loc"])
    assert abs(loc - loc0) > 1e-2 * loc0


def test_crowd_label_and_sample_proposals_match_jax(run, crowd):
    """Crowd GT is not appended as a proposal, and proposals mostly inside a
    crowd region are ignored: the same proposals and the same sample as the
    JAX package's."""
    tb, raw = crowd["tbatch"], crowd["j_raw"]
    props = add_ground_truth_to_proposals(
        Instances(**{k: torch.from_numpy(np.array(getattr(raw, k)))
                     for k in ("proposal_boxes", "objectness_logits", "is_valid")}), tb)
    got = crowd["tmodel"].roi_heads.label_and_sample_proposals(props, tb, run["noise"]["roi"])
    jp, js = crowd["j_props"], crowd["j_sampled"]
    np.testing.assert_array_equal(props.is_valid.numpy(), jp.is_valid)
    np.testing.assert_array_equal(props.objectness_logits.numpy(), jp.objectness_logits)
    n = raw.is_valid.shape[1]
    assert not jp.is_valid[0, n + 1] and not jp.is_valid[1, n + 3] and jp.is_valid[:, n:].sum() == 2 * G - 2
    for k in ("boxes", "gt_classes", "gt_boxes", "matched_idx", "is_fg", "valid"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), getattr(js, k), err_msg=k)
    assert not np.array_equal(js.boxes, run["j_sampled"].boxes)  # the crowd moved the sample


def test_crowd_loss_dict_matches_jax(crowd):
    got, want = crowd["t_losses"], crowd["j_losses"]
    assert set(want) == set(got) == set(LOSS_KEYS)
    for k in LOSS_KEYS:
        rtol = MASK_LOSS_RTOL if k == "loss_mask" else LOSS_RTOL
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)


def test_loss_gradients_match_jax_at_ties():
    """Where the elementwise losses' subgradients are a choice (a logit of
    exactly 0, a prediction equal to its target), the port makes the JAX
    package's."""
    logits = np.array([0.0, 0.0, 1.5, -2.0], np.float32)
    t = np.array([0.0, 1.0, 1.0, 0.0], np.float32)
    x = torch.from_numpy(logits).requires_grad_(True)
    tlosses.sigmoid_cross_entropy(x, torch.from_numpy(t)).sum().backward()
    want = jax.grad(lambda z: jlosses.sigmoid_cross_entropy(z, jnp.asarray(t)).sum())(jnp.asarray(logits))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)
    pred = np.array([0.5, -1.0, 0.25, 2.0], np.float32)
    target = np.array([0.5, -1.0, 0.0, 1.0], np.float32)
    for beta in (0.0, 0.5):
        x = torch.from_numpy(pred).requires_grad_(True)
        tlosses.smooth_l1_loss(x, torch.from_numpy(target), beta).sum().backward()
        want = jax.grad(lambda z: jlosses.smooth_l1_loss(z, jnp.asarray(target), beta).sum())(
            jnp.asarray(pred))
        np.testing.assert_array_equal(x.grad.numpy(), np.asarray(want), err_msg=beta)
