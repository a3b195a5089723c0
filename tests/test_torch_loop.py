"""The port's train loop and evaluation loop against the JAX package's, from
``configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml`` at narrow
widths (``test_torch_config.NARROW``), float32, on 120x150 synthetic images
padded to 128x160.

* Resume: ``train()`` for 4 steps, and ``train()`` cut at step 2 and resumed
  to 4 on the same batches, give ``torch.equal`` parameters, momentum
  buffers, optimizer count, generator state and step on the CPU. These runs
  take ``torch.use_deterministic_algorithms(True)``: the plain ROI backward
  accumulates with ``index_put_``, whose multi-threaded CPU kernel adds
  duplicate indices in thread order, so without it two identical CPU runs
  differ in the last bits after one step. The files on
  disk follow the save-and-keep schedule; ``eval_fn`` runs every
  ``TEST.EVAL_PERIOD`` steps and at the end (``tests/test_train_resume.py``'s
  cases).
* JAX parity: 2 steps of the port's ``train()`` against the JAX ``train()``,
  both started from the same bridged weights through ``PRETRAINS.WEIGHTS``,
  on the same batches, to the tolerances of ``tests/test_torch_train.py``:
  the samplers' noise is the JAX train state's own draws, and the port takes
  the proposals the JAX step made (captured with ``jax.debug.callback``),
  since near-tied RPN scores may trade slots between the packages.
* ``evaluate`` on the bridged model: the same metrics dict as the JAX
  ``evaluate`` on the same batches, to EVAL_TOL = 1e-6.
"""

import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.data import build_dataloader as jax_build_dataloader
from detectron2_tensorflow_tpu.engine.evaluator import evaluate as jax_evaluate
from detectron2_tensorflow_tpu.engine.train import train as jax_train
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.parallel import create_mesh
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.data import SyntheticDataset, build_dataloader
from detectron2_tensorflow_tpu_torch.engine import evaluate, run_evaluation, train
from detectron2_tensorflow_tpu_torch.engine.checkpoint import all_steps
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.ops import fused_residual
from detectron2_tensorflow_tpu_torch.solver import trainable_parameters
from detectron2_tensorflow_tpu_torch.structures import Instances
from test_data import SyntheticDataset as JaxSyntheticDataset
from test_torch_config import NARROW
from test_torch_slice import tame_variables
from test_torch_train import GRAD_TOL, jax_noise
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAML = os.path.join(REPO, "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml")
B, G, IMG_H, IMG_W = 2, 8, 120, 150
EVAL_TOL = 1e-6
OPTS = [
    "TRANSFORM.RESIZE.MIN_SIZE_TRAIN", "(112, 120)",
    "TRANSFORM.RESIZE.MAX_SIZE_TRAIN", "160",
    "TRANSFORM.RESIZE.MIN_SIZE_TEST", "120",
    "TRANSFORM.RESIZE.MAX_SIZE_TEST", "160",
    "INPUT.PAD_BUCKETS", "((128, 160), (160, 128))",
    "INPUT.MAX_GT_INSTANCES", str(G),
    "SOLVER.IMS_PER_BATCH", str(B),
    "SOLVER.AUTO_SCALE_LR_SCHEDULE", "False",
    "SOLVER.WARMUP_ITERS", "2",
    "SOLVER.SHORT_TERM_SAVE_STEPS", "1",
    "SOLVER.SHORT_TERM_NUM_STEPS", "2",
    "SOLVER.LONG_TERM_SAVE_STEPS", "3",
    "AUGMENT.HORIZONTAL_FLIP", "True",
]


def loop_cfgs(*opts):
    """(JAX cfg, port cfg): the YAML file, then the narrow widths, then
    ``OPTS`` and ``opts``, through ``merge_from_list`` on both."""
    narrow = [x for k, v in NARROW.items() for x in (k, str(v))]
    out = []
    for cfg in (jax_get_cfg(), get_cfg()):
        cfg.merge_from_file(YAML)
        cfg.merge_from_list(narrow + OPTS + list(opts))
        out.append(cfg)
    return tuple(out)


def dataset(n=4, first_id=0, box_range=(10, 30), num_classes=5):
    return SyntheticDataset(n=n, h=IMG_H, w=IMG_W, num_classes=num_classes, first_id=first_id,
                            box_range=box_range)


@pytest.fixture(autouse=True)
def unfused(monkeypatch):
    monkeypatch.delenv(fused_residual.ENV_SWITCH, raising=False)


def state_of(state):
    """Everything a resume must restore, as CPU tensors and ints."""
    opt = state.optimizer.sgd
    return {
        "params": {k: v.detach().clone() for k, v in state.model.state_dict().items()},
        "momentum": [opt.state[p]["momentum_buffer"].clone() for g in opt.param_groups
                     for p in g["params"]],
        "count": state.optimizer.count,
        "step": state.step,
        "generator": state.generator.get_state().clone(),
    }


def assert_states_equal(a, b):
    assert (a["step"], a["count"]) == (b["step"], b["count"])
    assert set(a["params"]) == set(b["params"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    assert len(a["momentum"]) == len(b["momentum"]) > 0
    assert all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"]))
    assert torch.equal(a["generator"], b["generator"])


@contextlib.contextmanager
def deterministic():
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's loop: 4 steps in one run (``EVAL_PERIOD`` 2, a recording
    ``eval_fn``), and a run cut at 2, called again at 2 and resumed to 4."""
    with pytest.MonkeyPatch.context() as mp, deterministic():
        mp.delenv(fused_residual.ENV_SWITCH, raising=False)
        _, cfg = loop_cfgs("TEST.EVAL_PERIOD", "2")
        ds = dataset()
        batches = []
        it = build_dataloader(cfg, ds, training=True, seed=0)
        batches = [next(it) for _ in range(5)]
        it.close()
        root = tmp_path_factory.mktemp("loop")
        calls = []

        def eval_fn(state, step):
            calls.append((step, state.step))
            return {"fake/metric": 1.0}

        full = train(cfg, build_model(cfg, device="cpu", training=True), iter(batches),
                     max_iter=4, checkpoint_dir=str(root / "full"), log_every=1, eval_fn=eval_fn)
        full_state, full_files = state_of(full), all_steps(str(root / "full"))

        cut_dir = str(root / "cut")
        first = train(cfg, build_model(cfg, device="cpu", training=True), iter(batches),
                      max_iter=2, checkpoint_dir=cut_dir, log_every=1)
        first_state, first_files = state_of(first), all_steps(cut_dir)
        again = train(cfg, build_model(cfg, device="cpu", training=True), iter(batches[2:]),
                      max_iter=2, checkpoint_dir=cut_dir, log_every=1)
        again_state = state_of(again)
        resumed = train(cfg, build_model(cfg, device="cpu", training=True), iter(batches[2:]),
                        max_iter=4, checkpoint_dir=cut_dir, log_every=1)
        yield dict(cfg=cfg, ds=ds, calls=calls, full=full_state, full_files=full_files,
                   first=first_state, first_files=first_files, again=again_state,
                   resumed=state_of(resumed), resumed_files=all_steps(cut_dir),
                   resumed_model=resumed.model)


def test_train_resumed_run_equals_uninterrupted(runs):
    assert runs["full"]["step"] == 4 and runs["full"]["count"] == 4
    assert_states_equal(runs["resumed"], runs["full"])


def test_train_resume_at_max_iter_restores_without_training(runs):
    """A second call with the same ``max_iter`` trains nothing and returns
    the saved state bit for bit."""
    assert_states_equal(runs["again"], runs["first"])
    assert any(not torch.equal(runs["first"]["params"][k], runs["full"]["params"][k])
               for k in runs["full"]["params"])  # steps 3-4 trained


def test_checkpoint_files_follow_the_schedule(runs):
    """Save every step, keep the newest 2 // 1 = 2 and every multiple of 3
    (``LONG_TERM_SAVE_STEPS``)."""
    assert runs["first_files"] == [1, 2]
    assert runs["full_files"] == runs["resumed_files"] == [3, 4]


def test_eval_period_invokes_eval_fn(runs):
    assert runs["calls"] == [(2, 2), (4, 4)]


def test_train_needs_a_training_model():
    _, cfg = loop_cfgs()
    with pytest.raises(ValueError, match="training=True"):
        train(cfg, build_model(cfg, device="cpu"), iter([]), max_iter=1)


# -- against the JAX package -----------------------------------------------------

def test_two_train_steps_match_jax(tmp_path, monkeypatch):
    """Both ``train()`` from the same bridged weights (an Orbax checkpoint
    for the JAX package, a port checkpoint for the port, each named by
    ``PRETRAINS.WEIGHTS``), on the same two batches, with the same noise and
    proposals: the parameters after step 2 agree as the step of
    ``tests/test_torch_train.py`` does. As there, a ReLU input within float32
    rounding of 0 takes the other side in one package and moves a slice of
    the gradient below it by ~3e-4: on these batches the weights of
    ``PRNGKey(1)`` hold one at unit 13 of the box head's fc1, and those of
    ``PRNGKey(3)`` one in res3, so the JAX package initializes from
    ``PRNGKey(2)``, which holds none."""
    import orbax.checkpoint as ocp

    jcfg, tcfg = loop_cfgs()
    it = jax_build_dataloader(jcfg, JaxSyntheticDataset(n=4, h=IMG_H, w=IMG_W, num_classes=5),
                              training=True, seed=0)
    batches = [next(it) for _ in range(2)]
    assert all(b["image"].shape == (B, 128, 160, 3) for b in batches)

    jmodel = jax_build_model(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    variables = tame_variables(jax.jit(jmodel.init)(jax.random.PRNGKey(2), jb))
    jax_dir = str(tmp_path / "jax_weights")
    ckptr = ocp.StandardCheckpointer()
    ckptr.save(jax_dir, {"params": variables["params"], "frozen": variables["frozen"]})
    ckptr.wait_until_finished()
    jcfg.PRETRAINS.WEIGHTS = jax_dir
    start = convert_variables(variables)
    torch.save(start, str(tmp_path / "port_weights.pt"))
    tcfg.PRETRAINS.WEIGHTS = str(tmp_path / "port_weights.pt")

    drv = jmodel.loss_fn.__self__
    real = drv.rpn.proposals
    captured = []

    def capturing(*args, **kwargs):
        props = real(*args, **kwargs)
        if kwargs.get("training"):
            jax.debug.callback(lambda *xs: captured.append([np.asarray(x) for x in xs]),
                               props.proposal_boxes, props.objectness_logits, props.is_valid)
        return props

    monkeypatch.setattr(drv.rpn, "proposals", capturing, raising=False)
    jstate = jax_train(jcfg, jmodel, iter([{k: jnp.asarray(v) for k, v in b.items()}
                                           for b in batches]),
                       mesh=create_mesh(1, 1, devices=jax.devices()[:1]), max_iter=2, log_every=1)
    assert int(jstate.step) == 2 and len(captured) == 2

    # The JAX train state's draws: PRNGKey(max(SEED, 0)) split for init and
    # state, then one split per step, then the RPN / ROI split of loss_fn.
    model = build_model(tcfg, device="cpu", training=True)
    with torch.no_grad():
        feats = model.features(torch.from_numpy(batches[0]["image"]))
        rpn = model.proposal_generator
        logits = rpn.rpn_head([feats[f] for f in rpn.in_features])[0]
    n_anchors = sum(int(np.prod(x.shape[1:3])) * 3 for x in logits)
    n_props = tcfg.MODEL.RPN.POST_NMS_TOPK_TRAIN + G
    _, rng = jax.random.split(jax.random.PRNGKey(max(jcfg.SEED, 0)))
    noise = []
    for _ in range(2):
        rng, step_rng = jax.random.split(rng)
        rng_rpn, rng_roi = jax.random.split(step_rng)
        noise.append({"rpn": jax_noise(rng_rpn, B, n_anchors), "roi": jax_noise(rng_roi, B, n_props)})

    losses, steps = model.losses, iter(range(2))
    proposals = iter(captured)

    def jax_proposals(*args, **kwargs):
        boxes, logits_, valid = next(proposals)
        return Instances(proposal_boxes=torch.from_numpy(np.array(boxes)),
                         objectness_logits=torch.from_numpy(np.array(logits_)),
                         is_valid=torch.from_numpy(np.array(valid)))

    monkeypatch.setattr(model.proposal_generator, "proposals", jax_proposals, raising=False)
    monkeypatch.setattr(model, "losses",
                        lambda batch, generator=None, noise_=None: losses(batch, generator,
                                                                          noise[next(steps)]),
                        raising=False)
    state = train(tcfg, model, iter(batches), max_iter=2, log_every=1)
    assert state.step == 2 and state.optimizer.count == 2

    want = convert_variables({"params": jax.device_get(jstate.params)})
    got = dict(model.named_parameters())
    assert set(want) == set(got)
    moved = 0
    for name, p in got.items():
        assert_updates_close(p.detach().numpy(), want[name].numpy(), start[name].numpy(),
                             GRAD_TOL, 2, name)
        moved += not np.array_equal(want[name].numpy(), start[name].numpy())
    # Every trainable tensor moved; the frozen stem and res2 did not.
    assert moved == len(trainable_parameters(model, tcfg.MODEL.BACKBONE.FREEZE_AT))


def assert_updates_close(got, want, start, tol, steps, name):
    """``tests/test_torch_train.py``'s ``assert_update_close`` over ``steps``
    updates: ``got - start`` against ``want - start`` within ``tol`` of the
    largest update, plus one float32 spacing of the parameter for each step
    (each side rounds ``p + u`` on its own at every step)."""
    du, dw = got - start, want - start
    slack = tol * np.abs(dw).max() + steps * np.spacing(np.maximum(np.abs(got), np.abs(want)))
    bad = np.abs(du - dw) > slack
    assert not bad.any(), f"{name}: {bad.sum()} updates differ, max {np.abs(du - dw).max()}"


def _metrics_equal(got, want, tol):
    assert list(got) == list(want)
    for k, v in want.items():
        if np.isnan(v):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - v) <= tol, (k, got[k], v)


def test_evaluate_matches_jax():
    """``evaluate`` of the bridged narrow model on 5 validation images (two
    batches, the last one padded), against the JAX ``evaluate`` on the same
    batches: every bbox and segm metric to EVAL_TOL. One class and large
    objects (60-110 px), so that many of the random model's detections
    match and the metrics are far from 0."""
    jcfg, tcfg = loop_cfgs("SOLVER.IMS_PER_BATCH", "3", "MODEL.ROI_HEADS.NUM_CLASSES", "1")
    ds = dataset(n=5, first_id=10, box_range=(60, 110), num_classes=1)
    batches = list(build_dataloader(tcfg, ds, training=False))
    assert [int((b["image_id"] < 0).sum()) for b in batches] == [0, 1]
    jmodel = jax_build_model(jcfg)
    jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
    variables = tame_variables(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jb))
    want = jax_evaluate(jcfg, jmodel, variables, ds, iter(batches))
    model = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    got = evaluate(tcfg, model, ds, iter(batches))
    assert {k.split("/")[0] for k in got} == {"bbox", "segm"}
    _metrics_equal(got, want, EVAL_TOL)
    assert got["bbox/AP"] > 1 and got["segm/AP"] > 1
    again = run_evaluation(tcfg, model, ds, lambda: iter(batches))
    _metrics_equal(again, got, 0.0)


def test_evaluate_on_the_trained_model(runs):
    """``run_evaluation`` through the loader on the model the loop trained:
    bbox and segm dicts whose AP and AR values are finite."""
    cfg = runs["cfg"]
    val = dataset(n=3, first_id=20)
    metrics = run_evaluation(cfg, runs["resumed_model"], val,
                             lambda: build_dataloader(cfg, val, training=False))
    for prefix in ("bbox", "segm"):
        for key in ("AP", "AP50", "AP75", "AR@1", "AR@10", "AR@100"):
            assert np.isfinite(metrics[f"{prefix}/{key}"]), (prefix, key)


@pytest.mark.parametrize("opts,match", [
    (("TEST.AUG.ENABLED", "True"), "TEST.AUG"),
    (("EVAL.METRICS", "('coco_detection_metrics', 'pascal_voc_detection_metrics')"),
     "pascal_voc"),
    (("EVAL.METRICS", "('panoptic_segmentation_metrics',)"), "panoptic"),
])
def test_unported_evaluation_raises(opts, match):
    _, cfg = loop_cfgs(*opts)
    with pytest.raises(NotImplementedError, match=match):
        evaluate(cfg, None, dataset(n=1), iter([]))


def test_check_expected_results_matches_jax():
    from detectron2_tensorflow_tpu.engine.evaluator import (
        check_expected_results as jax_check,
    )
    from detectron2_tensorflow_tpu_torch.engine import check_expected_results

    jcfg, tcfg = loop_cfgs("TEST.EXPECTED_RESULTS",
                           "[['bbox', 'AP', 40.0, 1.0], ['segm', 'AP', 30.0, 0.5],"
                           " ['panoptic_seg', 'PQ', 20.0, 1.0]]")
    metrics = {"bbox/AP": 40.5, "segm/AP": 31.0}
    got = check_expected_results(tcfg, metrics)
    assert got == jax_check(jcfg, metrics)
    assert len(got) == 2 and got[0].startswith("segm/AP") and "panoptic/PQ" in got[1]
