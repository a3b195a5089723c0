"""The RPN-only ``ProposalNetwork``, precomputed proposals through the data
path, the proposal-recall evaluator, ``EVAL.CLASS_AGNOSTIC`` and the
``ROIAlign`` pooler name: the port against the JAX package.

Models: ``configs/COCO-Detection/rpn_R_50_{FPN,C4}_1x.yaml`` at the narrow
widths of ``test_torch_c4.py`` (R50 depth, stem 16, res2 32, 8 per group,
FPN 32), float32, on 2 x 128 x 160 images, from the same tamed JAX weights
carried over by ``convert.py``. Proposals are compared as sets (ROADMAP
Queue 3: proposals whose scores lie within ~1e-8 trade top-k slots between
the packages): the same number of valid slots per image, and each valid
proposal of one package within 1e-4 (box) and 1e-5 (logit) of one of the
other's. The RPN losses of one step: 1e-5 relative, their gradients 1e-4 of
each tensor's largest magnitude (``test_torch_train.py``). Transforms and
loader slots: float32 rounding (1e-5 relative); evaluator metrics: 1e-9.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.data import build_dataloader as jax_build_dataloader
from detectron2_tensorflow_tpu.data import transforms as jax_transforms
from detectron2_tensorflow_tpu.engine.evaluator import evaluate as jax_evaluate
from detectron2_tensorflow_tpu.evaluation.coco_eval import ProposalEvaluator as JaxProposalEvaluator
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.poolers import ROIPooler as JaxROIPooler
from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.data import (
    SyntheticDataset,
    build_dataloader,
    jittered_proposals,
    transforms,
)
from detectron2_tensorflow_tpu_torch.data.loader import proposal_slots
from detectron2_tensorflow_tpu_torch.engine import evaluate, make_train_batch
from detectron2_tensorflow_tpu_torch.evaluation import ProposalEvaluator
from detectron2_tensorflow_tpu_torch.models import ProposalNetwork, build_model
from detectron2_tensorflow_tpu_torch.models.poolers import ROIPooler
from detectron2_tensorflow_tpu_torch.structures import Instances
from test_torch_c4 import B, H, W, images, tame, yaml_cfgs
from test_torch_config import _set
from test_torch_train import LOSS_RTOL, assert_grad_close, jax_noise
from tests.test_fast_rcnn import ProposalDataset as JaxProposalDataset
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

class ProposalDataset(SyntheticDataset):
    """The JAX test's ``ProposalDataset`` in the port: each sample carries
    ``data.jittered_proposals`` of its boxes, drawn from
    ``default_rng(i + 100)`` for image ``i``."""

    def __getitem__(self, i):
        s = super().__getitem__(i)
        s["proposals"], s["proposal_scores"] = jittered_proposals(
            s["boxes"], self.h, self.w, np.random.default_rng(i + 100))
        return s


RPN_YAMLS = {"fpn": "configs/COCO-Detection/rpn_R_50_FPN_1x.yaml",
             "c4": "configs/COCO-Detection/rpn_R_50_C4_1x.yaml"}
BOX_TOL, LOGIT_TOL = 1e-4, 1e-5


def rpn_cfgs(name, **overrides):
    return yaml_cfgs(RPN_YAMLS[name], **{"MODEL.NECK.OUT_CHANNELS": 32, **overrides})


@functools.lru_cache(maxsize=None)
def rpn_pair(name):
    """Both packages' ProposalNetwork from the same tamed weights, and their
    ``predict`` on one batch."""
    jcfg, tcfg = rpn_cfgs(name)
    batch, tbatch = images()
    jmodel = jax_build_model(jcfg)
    variables = tame(jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch))
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.predict)(variables, batch))
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, variables=variables, batch=batch,
                tbatch=tbatch, jmodel=jmodel, tmodel=tmodel, jout=jout,
                tout=tmodel.predict(tbatch))


@pytest.fixture(scope="module", params=sorted(RPN_YAMLS))
def rpn(request):
    return rpn_pair(request.param)


def assert_same_proposal_sets(got, want):
    """Per image: equal valid counts, and every valid proposal of each side
    matched by one of the other side's within BOX_TOL and LOGIT_TOL."""
    for i in range(got["is_valid"].shape[0]):
        gv, wv = got["is_valid"][i], want["is_valid"][i]
        assert gv.sum() == wv.sum() > 100
        for a, b in ((got, want), (want, got)):
            ab, bb = a["boxes"][i][a["is_valid"][i]], b["boxes"][i][b["is_valid"][i]]
            asc, bsc = a["scores"][i][a["is_valid"][i]], b["scores"][i][b["is_valid"][i]]
            dist = np.abs(ab[:, None, :] - bb[None, :, :]).max(-1)  # [Na, Nb]
            dist = np.where(np.abs(asc[:, None] - bsc[None, :]) <= LOGIT_TOL, dist, np.inf)
            assert (dist.min(1) <= BOX_TOL).all()


def test_proposal_network_has_only_trunk_neck_and_rpn(rpn):
    model = rpn["tmodel"]
    assert isinstance(model, ProposalNetwork)
    names = {k.split(".")[0] for k in model.state_dict()}
    assert names == {"backbone", "proposal_generator"}
    assert set(convert_variables(rpn["variables"])) == set(model.state_dict())


def test_proposal_network_predict_matches_jax(rpn):
    """``predict``: the ``POST_NMS_TOPK_TEST`` (2000) proposals as instances
    of class 0 scored by their objectness logits, as sets."""
    tout, jout = rpn["tout"], rpn["jout"]
    got = {k: v.numpy() for k, v in tout.get_fields().items()}
    want = {k: np.asarray(getattr(jout, k)) for k in got}
    assert set(got) == {"boxes", "scores", "pred_classes", "is_valid"}
    assert got["boxes"].shape == want["boxes"].shape
    # FPN: 2000 slots; C4: every anchor of the one 8 x 10 level (15 a cell) fits in 2000
    assert got["boxes"].shape[1] == {"fpn": 2000, "c4": 1200}[rpn["name"]]
    assert (got["pred_classes"] == 0).all() and (want["pred_classes"] == 0).all()
    assert got["pred_classes"].dtype == want["pred_classes"].dtype == np.int32
    assert_same_proposal_sets(got, want)
    np.testing.assert_array_equal(got["scores"][~got["is_valid"]], -1e10)


def test_proposal_network_losses_and_gradients_match_jax(rpn):
    """The RPN losses of one step (the JAX ``loss_fn`` draws its sampler noise
    from the step key itself) and the gradients of every trainable
    parameter."""
    jcfg, tcfg, variables, jmodel = rpn["jcfg"], rpn["tcfg"].clone(), rpn["variables"], rpn["jmodel"]
    _set(tcfg, "SOLVER.IMS_PER_BATCH", B)
    nb = make_train_batch(tcfg, H, W)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    key = jax.random.PRNGKey(1)

    def total(params):
        t, (losses, _) = jmodel.loss_fn({**variables, "params": params}, jbatch, key, {})
        return t, losses

    (_, j_losses), j_grads = jax.jit(jax.value_and_grad(total, has_aux=True))(variables["params"])
    model = build_model(tcfg, device="cpu", state_dict=convert_variables(variables),
                        training=True)
    with torch.no_grad():
        logits, _ = model._rpn_outputs(tbatch)
    noise = {"rpn": jax_noise(key, B, sum(l[0].numel() for l in logits))}
    losses = model.losses(tbatch, noise=noise)
    assert set(losses) == set(j_losses) == {"loss_rpn_cls", "loss_rpn_loc"}
    for k, v in losses.items():
        np.testing.assert_allclose(float(v.detach()), float(j_losses[k]), rtol=LOSS_RTOL, err_msg=k)
    sum(losses.values()).backward()
    want = convert_variables({"params": jax.tree_util.tree_map(np.asarray, j_grads)})
    trainable = tsolver.trainable_parameters(model, tcfg.MODEL.BACKBONE.FREEZE_AT)
    for name, p in model.named_parameters():
        if name in trainable:
            assert_grad_close(p.grad.numpy(), want[name].numpy(), name)
        else:
            assert p.grad is None and not want[name].numpy().any(), name


def test_proposal_network_evaluate_matches_jax():
    """``evaluate`` on a ProposalNetwork gives the proposal recall,
    ``box_proposals/AR@100`` and ``AR@1000``, as the JAX evaluate does on its
    own model (the FPN model)."""
    rpn = rpn_pair("fpn")
    jcfg, tcfg = rpn["jcfg"].clone(), rpn["tcfg"].clone()
    for cfg in (jcfg, tcfg):
        _set(cfg, "SOLVER.IMS_PER_BATCH", 2)
        _set(cfg, "INPUT.PAD_BUCKETS", ((128, 160), (160, 128)))
        _set(cfg, "TRANSFORM.RESIZE.MIN_SIZE_TEST", 97)
        _set(cfg, "TRANSFORM.RESIZE.MAX_SIZE_TEST", 160)
    ds = ProposalDataset(n=4, num_classes=3, with_masks=False)
    got = evaluate(tcfg, build_model(tcfg, device="cpu",
                                     state_dict=convert_variables(rpn["variables"])),
                   ds, build_dataloader(tcfg, ds, training=False))
    jds = JaxProposalDataset(n=4, num_classes=3, with_masks=False)
    want = jax_evaluate(jcfg, jax_build_model(jcfg), rpn["variables"], jds,
                        jax_build_dataloader(jcfg, jds, training=False))
    assert set(got) == set(want) == {"box_proposals/AR@100", "box_proposals/AR@1000"}
    for k in got:
        assert 0.0 <= got[k] <= 100.0
        assert abs(got[k] - want[k]) < 1e-9, (k, got[k], want[k])


def test_proposal_evaluator_matches_jax():
    """AR@100 / AR@1000 with greedy best overlap over the non-crowd GT, on
    random images with crowd boxes, empty images and few proposals."""
    rng = np.random.default_rng(3)
    ours, theirs = ProposalEvaluator(), JaxProposalEvaluator()
    for i in range(12):
        g = int(rng.integers(0, 8))
        xy = rng.uniform(0, 200, (g, 2))
        gt = {"boxes": np.concatenate([xy, xy + rng.uniform(5, 80, (g, 2))], 1),
              "is_crowd": rng.uniform(0, 1, g) < 0.2}
        n = [0, 3, 150, 1200][i % 4]
        ctr = rng.uniform(0, 250, (n, 2))
        wh = rng.uniform(4, 90, (n, 2))
        det = {"boxes": np.concatenate([ctr - wh / 2, ctr + wh / 2], 1),
               "scores": rng.normal(0, 3, n)}
        ours.add_image(gt, det)
        theirs.add_image(gt, det)
    got, want = ours.evaluate(), theirs.evaluate()
    assert set(got) == set(want) == {"AR@100", "AR@1000"}
    for k in got:
        assert abs(got[k] - want[k]) < 1e-9
    assert 0 < got["AR@100"] < got["AR@1000"] <= 100


def _detections_of(gt_boxes, gt_classes, gt_valid, xp):
    """Each GT box moved by one pixel, labelled with the next class, scored
    by slot: found by a class-agnostic evaluation, missed by a class-aware
    one."""
    n = gt_boxes.shape[1]
    return {"boxes": gt_boxes + 1.0, "pred_classes": (gt_classes + 1) % 3,
            "scores": xp.broadcast_to(0.9 - 0.01 * xp.arange(n, dtype=xp.float32),
                                      gt_valid.shape),
            "is_valid": gt_valid}


class _PortDetections:
    """A port model stand-in: ``predict`` returns ``_detections_of`` the GT of
    the next batch of ``batches`` (the evaluation loader's, in its order;
    ``evaluate`` hands ``predict`` the images only)."""

    def __init__(self, batches):
        self.batches = iter(batches)

    def parameters(self):
        return iter([torch.zeros(1)])

    def predict(self, batch):
        b = next(self.batches)
        f = _detections_of(b["gt_boxes"], b["gt_classes"], b["gt_valid"], np)
        return Instances(**{k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in f.items()})


class _JaxDetections:
    """The JAX model stand-in: the same detections from the batch it is
    handed (the JAX evaluate passes the whole batch)."""

    def predict(self, variables, batch):
        return JaxInstances(**_detections_of(batch["gt_boxes"], batch["gt_classes"],
                                             batch["gt_valid"], jnp))


@pytest.mark.parametrize("agnostic", [False, True])
def test_class_agnostic_evaluation_matches_jax(agnostic):
    """``EVAL.CLASS_AGNOSTIC`` zeroes the GT and predicted classes before the
    COCO evaluators (localization only), as the JAX evaluate does: detections
    of the wrong class score AP 0 without it and near 100 with it."""
    from test_torch_data import small_cfgs
    from tests.test_data import SyntheticDataset as JaxSynthetic

    jcfg, tcfg = small_cfgs()
    for cfg in (jcfg, tcfg):
        _set(cfg, "EVAL.CLASS_AGNOSTIC", agnostic)
        _set(cfg, "MODEL.MASK_ON", False)
    ds, jds = SyntheticDataset(n=4, num_classes=3), JaxSynthetic(n=4, num_classes=3)
    model = _PortDetections(list(build_dataloader(tcfg, ds, training=False)))
    got = evaluate(tcfg, model, ds, build_dataloader(tcfg, ds, training=False))
    want = jax_evaluate(jcfg, _JaxDetections(), None, jds,
                        jax_build_dataloader(jcfg, jds, training=False))
    assert set(got) == set(want)
    for k in got:
        assert abs(got[k] - want[k]) < 1e-9 or (np.isnan(got[k]) and np.isnan(want[k])), k
    assert got["bbox/AP50"] > 99 if agnostic else got["bbox/AP50"] == 0


# -- precomputed proposals through the data path -------------------------------------------

def _proposal_sample(rng, n=40):
    xy = rng.uniform(0, 120, (n, 2)).astype(np.float32)
    props = np.concatenate([xy, xy + rng.uniform(2, 60, (n, 2)).astype(np.float32)], 1)
    return {"image": rng.integers(0, 255, (97, 153, 3), np.uint8),
            "boxes": props[:3].copy(), "classes": np.array([0, 1, 2], np.int32),
            "is_crowd": np.zeros(3, bool), "proposals": props,
            "proposal_scores": rng.uniform(0, 10, n).astype(np.float32)}


@pytest.mark.parametrize("training", [True, False])
def test_proposal_transforms_match_jax(training):
    """Flips and resizes move the proposals with the boxes (the JAX
    ``flip_horizontal`` / ``resize_shortest_edge``), seed for seed."""
    from test_torch_data import small_cfgs

    jcfg, tcfg = small_cfgs()
    rng = np.random.default_rng(2)
    for seed in range(6):
        s = _proposal_sample(rng)
        got, gs = transforms.run(tcfg, s, training, np.random.default_rng(seed))
        want, ws = jax_transforms.run(jcfg, dict(s), training, np.random.default_rng(seed))
        assert gs == ws
        np.testing.assert_allclose(got["proposals"], want["proposals"], rtol=1e-6, atol=1e-5)
        np.testing.assert_array_equal(got["proposal_scores"], want["proposal_scores"])
    flipped = transforms.flip_horizontal(s)
    np.testing.assert_array_equal(flipped["proposals"][:, [0, 2]],
                                  153 - s["proposals"][:, [2, 0]])


@pytest.mark.parametrize("training", [True, False])
def test_loader_proposal_slots_match_jax(training):
    """``build_dataloader`` over the JAX test's ``ProposalDataset``: the fixed
    top-k slots (``PRECOMPUTED_PROPOSAL_TOPK_TRAIN`` / ``_TEST``), sorted by
    score stably, empty slots scored -1e10, equal to the JAX loader's."""
    from test_torch_data import small_cfgs

    jcfg, tcfg = small_cfgs()
    for cfg in (jcfg, tcfg):
        _set(cfg, "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", 20)
        _set(cfg, "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", 12)
    ds, jds = ProposalDataset(n=6, num_classes=3), JaxProposalDataset(n=6, num_classes=3)
    got = [b for b, _ in zip(build_dataloader(tcfg, ds, training, batch_size=2, seed=0),
                             range(3))]
    want = [b for b, _ in zip(jax_build_dataloader(jcfg, jds, training, batch_size=2, seed=0),
                              range(3))]
    assert len(got) == len(want) == 3
    k = 20 if training else 12
    for g, w in zip(got, want):
        assert g["proposal_boxes"].shape == (2, k, 4)
        np.testing.assert_array_equal(g["proposal_valid"], w["proposal_valid"])
        np.testing.assert_array_equal(g["proposal_scores"], w["proposal_scores"])
        np.testing.assert_allclose(g["proposal_boxes"], w["proposal_boxes"], rtol=1e-6,
                                   atol=1e-5)
        assert (np.diff(g["proposal_scores"], axis=1) <= 0).all()
    slots = proposal_slots(np.zeros((0, 4)), None, 4)
    assert not slots["proposal_valid"].any() and (slots["proposal_scores"] == -1e10).all()


# -- the ROIAlign pooler name ----------------------------------------------------------------

def test_roialign_pools_as_roialignv2_in_both_packages():
    """``POOLER_TYPE "ROIAlign"`` is accepted and pools exactly as
    ``ROIAlignV2``: the JAX pooler records ``aligned`` and never reads it,
    and the port keeps that."""
    rng = np.random.default_rng(4)
    feats = [rng.standard_normal((2, 32 // s, 40 // s, 8)).astype(np.float32) for s in (1, 2)]
    xy = rng.uniform(0, 100, (2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(4, 60, (2, 6, 2))], -1).astype(np.float32)
    outs = {}
    for kind in ("ROIAlign", "ROIAlignV2"):
        p = ROIPooler(7, [4, 8], 0, kind, max_image_size=160)
        storage, meta = p.build_storage([torch.from_numpy(f) for f in feats])
        outs[kind] = p.pool(storage, meta, torch.from_numpy(boxes))
        jp = JaxROIPooler(7, [4, 8], 0, kind, max_image_size=160)
        outs["jax " + kind] = np.stack([np.asarray(jp([jnp.asarray(f[i]) for f in feats],
                                                      jnp.asarray(boxes[i])))
                                        for i in range(2)])
    assert torch.equal(outs["ROIAlign"], outs["ROIAlignV2"])
    np.testing.assert_array_equal(outs["jax ROIAlign"], outs["jax ROIAlignV2"])
    with pytest.raises(NotImplementedError, match="ROIPool"):
        ROIPooler(7, [4], 0, "ROIPool", max_image_size=160)
