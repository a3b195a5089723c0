"""Pascal VOC: the port's ``PascalVocEvaluator``, its VOC metrics in
``run_evaluation``, ``WarmupCosineLR`` and one training step of the VOC
Faster R-CNN from an ImageNet trunk, against the JAX package's.

* The evaluator in its four variants (plain and ``weighted``, boxes and
  ``use_masks``), with difficult boxes, group-of boxes at weights 0 and 0.5
  and classes without GT or detections, on seeded detection streams: every
  metric to METRIC_TOL.
* ``run_evaluation`` with the four VOC metrics over a narrow Mask R-CNN
  (crowd GT read as group-of): the JAX ``evaluate``'s dict to EVAL_TOL, as
  ``tests/test_torch_loop.py`` holds the COCO metrics.
* The cosine schedule at every step of the VOC YAML's ``MAX_ITER``, with
  ``AUTO_SCALE_LR_SCHEDULE`` off and on: bit-equal (1 float32 ulp allowed).
* The slice: ``configs/PascalVOC-Detection/faster_rcnn_R_50_FPN.yaml`` at
  narrow widths (20 classes), its trunk from a seeded MSRA pickle through
  ``PRETRAINS.BACKBONE``, a batch from both loaders with every augmentation
  on (the same seed), the JAX package's sampler noise and proposals (as
  ``tests/test_torch_train.py`` hands them over): losses to LOSS_RTOL and
  gradients to GRAD_TOL of each tensor's largest magnitude, and three
  updates of the cosine schedule through both solvers from the same
  gradients to ``test_torch_train.UPDATE_RTOL``.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from detectron2_tensorflow_tpu import solver as jsolver
from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.data import build_dataloader as jax_build_dataloader
from detectron2_tensorflow_tpu.engine.checkpoint import load_pretrained as jax_load_pretrained
from detectron2_tensorflow_tpu.engine.evaluator import evaluate as jax_evaluate
from detectron2_tensorflow_tpu.evaluation import pascal_voc_eval as jvoc
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts, _RCNNDrivers
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.data import SyntheticDataset, build_dataloader
from detectron2_tensorflow_tpu_torch.engine import load_pretrained, run_evaluation
from detectron2_tensorflow_tpu_torch.evaluation import pascal_voc_eval as tvoc
from detectron2_tensorflow_tpu_torch.models import build_model
from test_data import SyntheticDataset as JaxSyntheticDataset
from test_torch_augment import EVERY_AUGMENTATION
from test_torch_config import NARROW, _set
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)
from test_torch_data import assert_batches_match
from test_torch_loop import EVAL_TOL, _metrics_equal, dataset, loop_cfgs
from test_torch_pretrained import write_caffe2_pickle
from test_torch_slice import tame_variables
from test_torch_train import (
    UPDATE_RTOL,
    _port_logits,
    assert_grad_close,
    assert_update_close,
    fixed_jax_proposals,
    jax_noise,
    jax_pieces,
    jax_proposals,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOC_YAML = "configs/PascalVOC-Detection/faster_rcnn_R_50_FPN.yaml"
METRIC_TOL = 1e-12
LOSS_RTOL = 1e-4
VOC_METRICS = ("pascal_voc_detection_metrics", "weighted_pascal_voc_detection_metrics",
               "pascal_voc_instance_segmentation_metrics",
               "weighted_pascal_voc_instance_segmentation_metrics")


# -- the evaluator ----------------------------------------------------------------

def detection_stream(seed, n_images=12, num_classes=6, h=48, w=64):
    """(gt, det) dicts per image: GT of classes 0..num_classes-2 (the last
    class never has GT), some difficult, some group-of; detections near the
    GT (some on the wrong class, some on the last class) and scattered, with
    tied scores, and masks filled from the boxes."""
    rng = np.random.default_rng(seed)

    def boxes(n):
        xy = rng.uniform(0, [w - 12, h - 12], (n, 2))
        return np.concatenate([xy, xy + rng.uniform(6, 30, (n, 2))], 1).clip(0, [w, h, w, h])

    def masks(b):
        m = np.zeros((len(b), h, w), bool)
        for i, (x0, y0, x1, y1) in enumerate(b.astype(int)):
            m[i, y0:y1 + 1, x0:x1 + 1] = True
        return m

    stream = []
    for _ in range(n_images):
        g = int(rng.integers(0, 6))
        gt_boxes = boxes(g)
        gt = {"boxes": gt_boxes, "classes": rng.integers(0, num_classes - 1, g),
              "is_difficult": rng.uniform(size=g) < 0.2, "is_group_of": rng.uniform(size=g) < 0.25,
              "masks": masks(gt_boxes)}
        near = gt_boxes[rng.integers(0, max(g, 1), int(rng.integers(0, 8)))] if g else boxes(0)
        near = (near + rng.normal(0, 2.0, near.shape)).clip(0, [w, h, w, h])
        det_boxes = np.concatenate([near, boxes(int(rng.integers(0, 5)))])
        n = len(det_boxes)
        classes = np.where(rng.uniform(size=n) < 0.8,
                           gt["classes"][rng.integers(0, max(g, 1), n)] if g else 0,
                           rng.integers(0, num_classes, n))
        scores = np.round(rng.uniform(size=n), 1)  # ties
        stream.append((gt, {"boxes": det_boxes, "scores": scores, "classes": classes,
                            "masks": masks(det_boxes)}))
    return stream


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("use_masks", [False, True])
@pytest.mark.parametrize("group_of_weight", [0.0, 0.5])
@pytest.mark.parametrize("iou", [0.5, 0.7])
def test_pascal_voc_evaluator_matches_jax(weighted, use_masks, group_of_weight, iou):
    names = [f"c{i}" for i in range(6)]
    kw = dict(matching_iou_threshold=iou, class_names=names, weighted=weighted,
              use_masks=use_masks, group_of_weight=group_of_weight)
    ours, theirs = tvoc.PascalVocEvaluator(6, **kw), jvoc.PascalVocEvaluator(6, **kw)
    for seed in range(3):
        for gt, det in detection_stream(seed):
            ours.add_image(gt, det)
            theirs.add_image(gt, det)
    got, want = ours.evaluate(), theirs.evaluate()
    assert list(got) == list(want)
    assert "AP-c5" not in got  # no GT: out of the mean, as in the JAX evaluator
    for k, v in want.items():
        assert abs(got[k] - v) <= METRIC_TOL, (k, got[k], v)
    assert 0 < got["mAP"] < 100 and 0 < got["CorLoc"] < 100


def test_pascal_voc_evaluator_empty_matches_jax():
    ours, theirs = tvoc.PascalVocEvaluator(3), jvoc.PascalVocEvaluator(3)
    gt = {"boxes": np.zeros((0, 4)), "classes": np.zeros(0, int)}
    det = {"boxes": np.array([[1.0, 1, 5, 5]]), "scores": np.array([0.5]),
           "classes": np.array([1])}
    ours.add_image(gt, det)
    theirs.add_image(gt, det)
    assert ours.evaluate() == theirs.evaluate() == {"mAP": 0.0, "CorLoc": 0.0}


def test_average_precision_matches_jax():
    rng = np.random.default_rng(4)
    for n in (0, 1, 7, 50):
        p, r = rng.uniform(size=n), np.sort(rng.uniform(size=n))
        assert tvoc.compute_average_precision(p, r) == jvoc.compute_average_precision(p, r)


# -- run_evaluation ------------------------------------------------------------------

@pytest.mark.parametrize("group_of_weight", [0.0, 0.5])
def test_run_evaluation_voc_metrics_match_jax(group_of_weight):
    """The four VOC metrics of the bridged narrow Mask R-CNN on 5 images, one
    GT of each of three made crowd (group-of), against the JAX ``evaluate``."""
    jcfg, tcfg = loop_cfgs("SOLVER.IMS_PER_BATCH", "3", "MODEL.ROI_HEADS.NUM_CLASSES", "1",
                           "EVAL.METRICS", repr(VOC_METRICS),
                           "EVAL.PASCAL_GROUP_OF_WEIGHT", str(group_of_weight))
    ds = dataset(n=5, first_id=10, box_range=(60, 110), num_classes=1)
    for i in (0, 2, 4):
        ds.samples[i]["is_crowd"][0] = True
    batches = list(build_dataloader(tcfg, ds, training=False))
    jmodel = jax_build_model(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    variables = tame_variables(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb))
    want = jax_evaluate(jcfg, jmodel, variables, ds, iter(batches))
    model = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    got = run_evaluation(tcfg, model, ds, iter(batches))
    assert {k.split("/")[0] for k in got} == {"voc_bbox", "voc_bbox_weighted", "voc_segm",
                                              "voc_segm_weighted"}
    _metrics_equal(got, want, EVAL_TOL)
    assert got["voc_bbox/mAP"] > 1 and got["voc_segm/mAP"] > 1


# -- WarmupCosineLR ----------------------------------------------------------------------

def voc_cfgs(**overrides):
    """(JAX cfg, port cfg): the VOC YAML, then ``overrides``."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(os.path.join(REPO, VOC_YAML))
        for key, value in overrides.items():
            _set(cfg, key, value)
    return jcfg, tcfg


@pytest.mark.parametrize("auto_scale,batch", [(False, 16), (True, 16), (True, 8), (True, 64)])
def test_cosine_schedule_matches_jax_at_every_step(auto_scale, batch):
    jcfg, tcfg = voc_cfgs(**{"SOLVER.LR_SCHEDULER_NAME": "WarmupCosineLR",
                             "SOLVER.AUTO_SCALE_LR_SCHEDULE": auto_scale,
                             "SOLVER.IMS_PER_BATCH": batch})
    total = tsolver.scaled_max_iter(tcfg)
    assert total == jsolver.scaled_max_iter(jcfg) == (18000 * 16 // batch if auto_scale else 18000)
    steps = np.arange(total + 3)
    ours = np.array([tsolver.build_lr_schedule(tcfg)(int(t)) for t in steps], np.float32)
    theirs = np.asarray(jsolver.build_lr_schedule(jcfg)(jnp.asarray(steps)))
    ulps = np.abs(ours.view(np.int32).astype(np.int64) - theirs.view(np.int32).astype(np.int64))
    assert ulps.max() <= 1, (steps[ulps.argmax()], ours[ulps.argmax()], theirs[ulps.argmax()])
    assert ours[-1] == 0 and ours[total // 2] < ours[100] / 1.9


def test_unknown_lr_scheduler_raises_as_jax():
    jcfg, tcfg = voc_cfgs(**{"SOLVER.LR_SCHEDULER_NAME": "WarmupPolyLR"})
    for build in (tsolver.build_lr_schedule, jsolver.build_lr_schedule):
        with pytest.raises(ValueError, match="WarmupPolyLR"):
            build(tcfg if build is tsolver.build_lr_schedule else jcfg)


# -- the slice: one VOC step from an ImageNet trunk -----------------------------------------

B, G = 2, 8
STEP = {**NARROW, **EVERY_AUGMENTATION,
        "MODEL.ROI_HEADS.NUM_CLASSES": 20, "INPUT.MAX_GT_INSTANCES": G,
        "SOLVER.IMS_PER_BATCH": B, "SOLVER.LR_SCHEDULER_NAME": "WarmupCosineLR",
        "SOLVER.MAX_ITER": 4, "SOLVER.WARMUP_ITERS": 1, "SOLVER.AUTO_SCALE_LR_SCHEDULE": False,
        "TRANSFORM.RESIZE.MIN_SIZE_TRAIN": (96, 112, 128),
        "TRANSFORM.RESIZE.MAX_SIZE_TRAIN": 160,
        "INPUT.PAD_BUCKETS": ((128, 160), (160, 128)), "DATALOADER.NUM_READERS": 1,
        "PRETRAINS.BACKBONE": "R-50.pkl"}


@pytest.fixture(scope="module")
def voc_step(tmp_path_factory):
    root = tmp_path_factory.mktemp("voc")
    jcfg, tcfg = voc_cfgs(**STEP, **{"PRETRAINS.ROOT": str(root)})
    write_caffe2_pickle(root / "R-50.pkl", tcfg, seed=5)
    ours = build_dataloader(tcfg, SyntheticDataset(n=4, num_classes=4, with_masks=False),
                            training=True, seed=3)
    theirs = jax_build_dataloader(jcfg, JaxSyntheticDataset(n=4, num_classes=4,
                                                            with_masks=False),
                                  training=True, seed=3)
    nb, port_batch = next(theirs), next(ours)
    ours.close()
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(np.asarray(v)) for k, v in nb.items()}

    jmodel = jax_build_model(jcfg)
    init = tame_variables(jax.jit(jmodel.init)(jax.random.PRNGKey(1), jbatch))
    variables = jax.tree_util.tree_map(np.asarray, jax_load_pretrained(jcfg, jmodel, init))
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    step_rng = jax.random.PRNGKey(1)
    rng_rpn, rng_roi = jax.random.split(step_rng)

    def total_loss(params):
        total, (loss_dict, _) = drv.loss_fn({**variables, "params": params}, jbatch, step_rng, {})
        return total, loss_dict

    _, j_raw, j_props, _ = jax_pieces(drv, variables, jbatch, step_rng)
    with fixed_jax_proposals(drv, j_raw):
        (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(total_loss, has_aux=True))(
            variables["params"])

    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(init), training=True)
    assert load_pretrained(tcfg, tmodel)
    n_anchors = sum(int(np.prod(x.shape[1:3])) * 3 for x in _port_logits(tmodel, tbatch))
    noise = {"rpn": jax_noise(rng_rpn, B, n_anchors),
             "roi": jax_noise(rng_roi, B, j_props.is_valid.shape[1])}
    with jax_proposals(tmodel, j_raw):
        t_losses = tmodel.losses(tbatch, noise=noise)
    sum(t_losses.values()).backward()
    return dict(jcfg=jcfg, tcfg=tcfg, nb=nb, port_batch=port_batch, variables=variables,
                tmodel=tmodel, j_losses={k: float(v) for k, v in j_losses.items()},
                j_total=float(j_total), j_grads=j_grads,
                t_losses={k: float(v.detach()) for k, v in t_losses.items()},
                t_grads={n: p.grad.numpy().copy() for n, p in tmodel.named_parameters()
                         if p.grad is not None})


def test_voc_step_batch_and_trunk_match_jax(voc_step):
    """Both loaders give the same augmented batch, and the port's model holds
    the JAX model's weights after both load the trunk from the pickle."""
    assert_batches_match(voc_step["port_batch"], voc_step["nb"])
    want = convert_variables(voc_step["variables"])
    got = voc_step["tmodel"].state_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


def test_voc_step_losses_match_jax(voc_step):
    got, want = voc_step["t_losses"], voc_step["j_losses"]
    assert set(got) == set(want) == {"loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg"}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(sum(got.values()), voc_step["j_total"], rtol=LOSS_RTOL)
    assert got["loss_box_reg"] > 0


def test_voc_step_gradients_match_jax(voc_step):
    want = convert_variables({"params": voc_step["j_grads"]})
    trainable = tsolver.trainable_parameters(voc_step["tmodel"], 2)
    assert set(voc_step["t_grads"]) == set(trainable)
    for name in trainable:
        assert_grad_close(voc_step["t_grads"][name], want[name].numpy(), name)


def test_voc_step_cosine_updates_match_optax(voc_step):
    """Three updates of the cosine schedule (warmup, then cos(pi t / 4))
    from the JAX gradients through both solvers."""
    jcfg, tcfg = voc_step["jcfg"], voc_step["tcfg"]
    params = voc_step["variables"]["params"]
    tx = jsolver.build_optimizer(jcfg, params)
    opt_state = tx.init(params)
    start = convert_variables(voc_step["variables"])
    model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    opt = tsolver.build_optimizer(tcfg, model)
    grads = convert_variables({"params": voc_step["j_grads"]})
    tparams = dict(model.named_parameters())

    @jax.jit
    def jstep(opt_state, params):
        updates, opt_state = tx.update(voc_step["j_grads"], opt_state, params)
        return opt_state, optax.apply_updates(params, updates)

    for _ in range(3):
        opt_state, params = jstep(opt_state, params)
        for name, p in tparams.items():
            p.grad = grads[name].clone()
        opt.step()
    want = convert_variables({"params": params})
    for name, p in tparams.items():
        assert_update_close(p.detach().numpy(), want[name].numpy(), start[name].numpy(),
                            UPDATE_RTOL, name)
    schedule = tsolver.build_lr_schedule(tcfg)
    assert schedule(0) < schedule(1) and schedule(2) < schedule(1)  # warmup, then the decay
