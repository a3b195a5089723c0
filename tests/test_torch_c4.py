"""The C4 family (``Res5ROIHeads``: the trunk stops at res4, the res5 stage is
the ROI head shared by the box and mask branches) against the JAX package.

``configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml`` at narrow
widths (``SINGLE_NARROW``: R50 depth, stem 16, res2 32, 8 per group, 5
classes, float32), on 2 x 128 x 160 images, with ``MASK_ON`` True and False
(Mask and Faster R-CNN). The same seeded numpy inputs and the same weights
(the JAX ones carried over by ``convert.py``) go through both packages. On
the CPU the JAX model takes its XLA paths and the port the kernels' plain
versions. Tolerances are those of ``test_torch_slice.py`` and
``test_torch_train.py``: integer outputs (validity, classes, which boxes NMS
keeps) equal, float32 values to 1e-4; losses to 1e-5 relative (the mask loss
3e-4), gradients and one step's updates to 1e-4 of each tensor's largest
magnitude. This file also holds the shared helpers of ``test_torch_dc5.py``.
"""

import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu import solver as jsolver
from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.config.config import CfgNode as JaxCfgNode
from detectron2_tensorflow_tpu.convert.d2 import convert_d2_weights as jax_convert_d2
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts, _RCNNDrivers
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import _port_shapes, convert_d2_weights
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import GeneralizedRCNN
from detectron2_tensorflow_tpu_torch.models.poolers import plan_patch
from detectron2_tensorflow_tpu_torch.tools import overfit_check
from test_torch_config import _set, assert_same_tree
from test_torch_slice import count_fused_calls, fused_custom_vjp_calls, fused_switch
from test_torch_slice import tame_variables
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
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
C4_YAML = "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml"
DC5_YAML = "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_DC5_1x.yaml"
FPN_YAML = "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml"
SINGLE_NARROW = {
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 16,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
    "MODEL.ROI_BOX_HEAD.FC_DIM": 64,
    "MODEL.ROI_MASK_HEAD.CONV_DIM": 32,
    "MODEL.ROI_HEADS.NUM_CLASSES": 5,
    "MODEL.DTYPE": "float32",
}
B, H, W, G = 2, 128, 160, 5
SIZES = np.array([[128, 160], [112, 150]], np.int32)
RTOL, ATOL = 1e-4, 1e-4
LOSS_RTOL = 1e-5
C4_YAMLS = sorted(f"configs/{d}/{f}" for d in ("COCO-Detection", "COCO-InstanceSegmentation")
                  for f in os.listdir(os.path.join(REPO, "configs", d)) if "_C4_" in f
                  and not f.startswith("rpn_"))
DC5_YAMLS = sorted(f"configs/{d}/{f}" for d in ("COCO-Detection", "COCO-InstanceSegmentation")
                   for f in os.listdir(os.path.join(REPO, "configs", d)) if "_DC5_" in f)


def yaml_cfgs(path, **overrides):
    """(JAX cfg, port cfg): ``path``'s YAML at ``SINGLE_NARROW`` widths."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_file(os.path.join(REPO, path))
    tcfg.merge_from_file(os.path.join(REPO, path))
    for key, value in {**SINGLE_NARROW, **overrides}.items():
        _set(jcfg, key, value)
        _set(tcfg, key, value)
    return jcfg, tcfg


def tame(variables):
    """``tame_variables`` (stem FrozenBN scale 1/640, each trunk bottleneck's
    last 0.2), and 0.2 for the C4 head's res5 bottlenecks too."""
    v = tame_variables(variables)
    for block in v["frozen"].get("res5", {}).values():
        block["conv3"]["FrozenBatchNorm_0"]["scale"][:] = 0.2
    return v


def images(seed=0):
    img = np.random.default_rng(seed).uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    return ({"image": jnp.asarray(img), "image_size": jnp.asarray(SIZES)},
            {"image": torch.from_numpy(img), "image_size": torch.from_numpy(SIZES)})


_JAX_INITS = {}


def jax_init(jcfg, key, batch):
    """The JAX model's ``init`` from ``PRNGKey(key)`` on ``batch``'s image,
    jitted once per ``cfg.MODEL`` (the variables depend on it and on the
    key only), so that fixtures of one model share the compile."""
    model_key = jcfg.MODEL.dump()
    if model_key not in _JAX_INITS:
        _JAX_INITS[model_key] = jax.jit(jax_build_model(jcfg).init)
    return _JAX_INITS[model_key](jax.random.PRNGKey(key), {k: batch[k] for k in ("image",
                                                                               "image_size")})


def predict_pair(jcfg, tcfg, key=0):
    """Both packages' ``predict`` on one batch from the same (tamed) weights."""
    batch, tbatch = images()
    jmodel = jax_build_model(jcfg)
    variables = tame(jax_init(jcfg, key, batch))
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.predict)(variables, batch))
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, batch=batch, tbatch=tbatch,
                jmodel=jmodel, tmodel=tmodel, jout=jout, tout=tmodel.predict(tbatch))


def check_detections(p):
    """Valid slots, classes and kept boxes equal; boxes and scores to 1e-4."""
    jout, tout = p["jout"], p["tout"]
    valid = tout.is_valid.numpy()
    np.testing.assert_array_equal(valid, jout.is_valid)
    assert valid.sum() >= 100  # real detections, which the mask path pools
    np.testing.assert_array_equal(tout.pred_classes.numpy(), jout.pred_classes)
    np.testing.assert_allclose(tout.boxes.numpy(), jout.boxes, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tout.scores.numpy(), jout.scores, rtol=RTOL, atol=1e-6)


def check_masks(p, size):
    """``MASK_ON``: probabilities ``[B, 100, size, size]`` to 1e-5; off:
    neither package predicts masks."""
    jout, tout = p["jout"], p["tout"]
    if not p["tcfg"].MODEL.MASK_ON:
        assert "pred_masks" not in tout.get_fields() and not jout.has("pred_masks")
        return
    masks = tout.pred_masks.numpy()
    assert masks.shape == jout.pred_masks.shape == (B, 100, size, size)
    np.testing.assert_allclose(masks, jout.pred_masks, rtol=RTOL, atol=1e-5)


def check_proposals(p):
    """The RPN's serving proposals (top-k of one level, decode, NMS keeps)
    slot by slot."""
    jcfg, variables, batch, tbatch, tmodel = (p[k] for k in (
        "jcfg", "variables", "batch", "tbatch", "tmodel"))
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))

    def props(v, b):
        _, logits, deltas = drv.features_and_rpn(v, b, False)
        return drv.rpn.proposals(logits, deltas, b["image_size"], training=False)

    jp = jax.tree_util.tree_map(np.asarray, jax.jit(props)(variables, batch))
    with torch.no_grad():
        feats = tmodel.features(tbatch["image"])
        rpn = tmodel.proposal_generator
        logits, deltas = rpn.rpn_head([feats[f] for f in rpn.in_features])
        tp = rpn.proposals(logits, deltas, tbatch["image_size"])
    assert len(logits) == 1 and logits[0].shape[-1] == 15  # one level, 15 anchors a cell
    np.testing.assert_array_equal(tp.is_valid.numpy(), jp.is_valid)
    assert tp.is_valid.numpy().sum() > 500
    np.testing.assert_allclose(tp.proposal_boxes.numpy(), jp.proposal_boxes,
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tp.objectness_logits.numpy(), jp.objectness_logits,
                               rtol=RTOL, atol=1e-5)


def train_pair(jcfg, tcfg, key=1):
    """One training step of both packages from the same weights, sampler noise
    and (the JAX package's) proposals: losses, gradients, the models."""
    nb = make_train_batch(tcfg, H, W)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    variables = tame(jax_init(jcfg, key, jbatch))
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
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
    n_props = j_raw.is_valid.shape[1] + G  # the GT boxes are appended
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


def train_cfgs(path):
    return yaml_cfgs(path, **{"INPUT.MAX_GT_INSTANCES": G, "SOLVER.IMS_PER_BATCH": B})


def check_losses(run):
    """Every loss to 1e-5 relative (the mask loss 3e-4), the same keys."""
    got, want = run["t_losses"], run["j_losses"]
    keys = ("loss_rpn_cls", "loss_rpn_loc", "loss_cls", "loss_box_reg") + (
        ("loss_mask",) if run["tcfg"].MODEL.MASK_ON else ())
    assert tuple(got) == keys and set(want) == set(keys)
    for k in keys:
        np.testing.assert_allclose(got[k], want[k], rtol=MASK_LOSS_RTOL if k == "loss_mask"
                                   else LOSS_RTOL, err_msg=k)
    assert got["loss_box_reg"] > 0


def check_gradients(run):
    """Every trainable parameter's gradient against ``jax.grad``; the frozen
    stem and res2 have none in the port and a zero one in JAX."""
    want = convert_variables({"params": run["j_grads"]})
    trainable = tsolver.trainable_parameters(run["tmodel"], 2)
    assert set(run["t_grads"]) == set(trainable)
    for name, w in want.items():
        if name in trainable:
            assert_grad_close(run["t_grads"][name], w.numpy(), name)
        else:
            assert name.startswith(("backbone.stem.", "backbone.res2.")), name
            assert not w.numpy().any(), name


def check_update(run):
    """``create_train_state`` + ``build_train_step``: the total loss and one
    step's parameter updates against the JAX gradients through the optax
    chain."""
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    start = convert_variables(run["variables"])
    model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    state = create_train_state(tcfg, model, torch.Generator().manual_seed(0))
    with jax_proposals(model, run["j_raw"]):
        metrics = build_train_step(tcfg, state)(run["tbatch"], noise=run["noise"])
    np.testing.assert_allclose(float(metrics["total_loss"]), run["j_total"], rtol=LOSS_RTOL,
                               atol=MASK_LOSS_RTOL * run["j_losses"].get("loss_mask", 0.0))
    want = convert_variables({"params": jax_updated_params(jcfg, run["variables"]["params"],
                                                           run["j_grads"])})
    for name, p in model.named_parameters():
        assert_update_close(p.detach().numpy(), want[name].numpy(), start[name].numpy(),
                            GRAD_TOL, name)


def _tagged(params):
    """Each leaf replaced by a constant array holding its index."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tagged = [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, tagged)


def jax_param_shapes(jcfg):
    """The JAX model's variables as zero numpy arrays (shapes from
    ``jax.eval_shape``, no weights drawn)."""
    batch = {"image": jnp.zeros((1, 64, 64, 3)), "image_size": jnp.asarray([[64, 64]], jnp.int32)}
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0), batch)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)


def check_trainable_mask(path, freeze_at):
    """``solver.trainable_parameters`` is the JAX ``trainable_mask``, leaf for
    leaf: the stem and res2 .. res{freeze_at} of the trunk are frozen,
    wherever the neck puts the trunk; nothing else is."""
    jcfg, tcfg = yaml_cfgs(path, **{"MODEL.BACKBONE.FREEZE_AT": freeze_at})
    params = jax_param_shapes(jcfg)["params"]
    names = list(convert_variables({"params": _tagged(params)}).items())
    by_tag = {int(v.reshape(-1)[0]): k for k, v in names}
    mask = jax.tree_util.tree_leaves(jsolver.trainable_mask(params, freeze_at))
    want = {by_tag[i] for i, m in enumerate(mask) if m}
    with torch.device("meta"):
        model = GeneralizedRCNN(tcfg)
    assert set(tsolver.trainable_parameters(model, freeze_at)) == want
    assert len(want) < len(mask)  # something is frozen
    return want


def check_yaml_shapes(path):
    """The YAML's narrow port model has the JAX tree's tensors, name for name
    and shape for shape."""
    jcfg, tcfg = yaml_cfgs(path)
    want = {k: tuple(v.shape) for k, v in convert_variables(jax_param_shapes(jcfg)).items()}
    assert _port_shapes(tcfg) == want


# Narrow widths (GN's 32 groups divide them) and fewer ROIs for the CPU.
OVERFIT_NARROW = ["MODEL.RESNETS.STEM_OUT_CHANNELS", "32",
                  "MODEL.RESNETS.RES2_OUT_CHANNELS", "128",
                  "MODEL.ROI_MASK_HEAD.CONV_DIM", "32",
                  "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "16",
                  "MODEL.RPN.POST_NMS_TOPK_TRAIN", "50", "MODEL.RPN.POST_NMS_TOPK_TEST", "50"]


def run_overfit_check(arch, opts, capsys, steps=2):
    """``tools.overfit_check`` in this process: its last stdout line."""
    out = overfit_check.main([str(steps), "--arch", arch, "--device", "cpu", *opts])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[-1]) == out
    return out


def check_overfit_cfg(arch):
    """The port's ``overfit_cfg`` is the JAX tool's, key for key."""
    import sys

    sys.path.insert(0, REPO)
    from tools import overfit_check as jax_overfit_check

    assert_same_tree(jax_overfit_check.overfit_cfg(arch), overfit_check.overfit_cfg(arch))


@contextlib.contextmanager
def repo_configs():
    """The JAX package's ``merge_from_file`` reads a missing ``.../configs/X``
    from this repo's ``configs/X`` (an oracle test names another tree)."""
    real = JaxCfgNode.merge_from_file

    def merge(self, filename, *args, **kwargs):
        if not os.path.exists(filename) and "/configs/" in filename:
            filename = os.path.join(REPO, "configs", filename.split("/configs/", 1)[1])
        return real(self, filename, *args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxCfgNode, "merge_from_file", merge)
        yield


# -- serving ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[True, False], ids=["mask", "faster"])
def c4(request):
    return predict_pair(*yaml_cfgs(C4_YAML, **{"MODEL.MASK_ON": request.param}))


def test_c4_model_is_res5_roi_heads(c4):
    """The trunk stops at res4 (``backbone.res4``, no res5), the ROI head owns
    res5 (``roi_heads.res5``) on res4's channels, no box head, the predictor
    on res5's 2048/8-wide (here 256) mean."""
    m = c4["tmodel"]
    names = {n.split(".")[0] + "." + n.split(".")[1] for n, _ in m.named_parameters()}
    assert {"backbone.res4", "roi_heads.res5", "roi_heads.box_predictor"} <= names
    assert not {"backbone.res5", "roi_heads.box_head"} & names
    assert m.roi_heads.res5[0].conv1.weight.shape[1] == 128  # res4: 32 * 4
    assert m.roi_heads.box_predictor.cls_score.weight.shape[1] == 256  # 32 * 8
    assert m.roi_heads.box_pooler.output_size == 14
    assert ("roi_heads.mask_head.deconv.weight" in m.state_dict()) == c4["tcfg"].MODEL.MASK_ON


def test_c4_detections_match_jax(c4):
    check_detections(c4)


def test_c4_masks_match_jax(c4):
    """Masks from res5 run again on the detections (7x7 -> deconv -> 14x14)."""
    check_masks(c4, 14)


def test_c4_proposals_match_jax(c4):
    check_proposals(c4)


@pytest.mark.parametrize("mode,tails", [("predict", 19), ("losses", 16)])
def test_c4_fused_tails_match_jax(mode, tails):
    """With the switch on, the fused tail runs as often in the port as the JAX
    trace holds it: the trunk's 13 (res2-res4) and the head's 3, which
    ``predict`` runs twice (proposals, then detections)."""
    with fused_switch(True), pytest.MonkeyPatch.context() as mp:
        jcfg, tcfg = yaml_cfgs(C4_YAML, **{"INPUT.MAX_GT_INSTANCES": G,
                                           "SOLVER.IMS_PER_BATCH": B})
        nb = make_train_batch(tcfg, H, W)
        jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
        tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
        jmodel = jax_build_model(jcfg)
        variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch)
        tmodel = build_model(tcfg, device="cpu", training=mode == "losses")
        calls = count_fused_calls(mp)
        if mode == "predict":
            jaxpr = str(jax.make_jaxpr(jmodel.predict)(variables, jbatch))
            tmodel.predict(tbatch)
        else:
            jaxpr = str(jax.make_jaxpr(lambda v: jmodel.loss_fn(
                v, jbatch, jax.random.PRNGKey(1), {})[0])(variables))
            with torch.no_grad():
                tmodel.losses(tbatch, generator=torch.Generator().manual_seed(0))
        assert fused_custom_vjp_calls(jaxpr) == len(calls) == tails


def test_c4_inference_passes_the_pipeline_oracle():
    """``tests/test_pipeline_oracle.py``'s C4 oracle (its own R18 C4 config
    from this repo's YAML: proposals, single-level pooling with the extent
    aliases, res5, class-aware NMS, masks through res5 again, in sequential
    numpy on the JAX features and head) holds the port's ``predict``."""
    from test_torch_gn import port_in
    from tests import test_pipeline_oracle as oracle

    with repo_configs(), port_in(oracle):
        oracle.test_c4_inference_matches_numpy_oracle()


# -- training --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def c4_train():
    return train_pair(*train_cfgs(C4_YAML))


def test_c4_train_losses_match_jax(c4_train):
    check_losses(c4_train)


def test_c4_train_gradients_match_jax(c4_train):
    """The head's res5 takes the box loss's gradient and the mask loss's
    (through the leading slots' res5 features) as in JAX."""
    check_gradients(c4_train)
    assert np.abs(c4_train["t_grads"]["roi_heads.res5.0.conv1.weight"]).max() > 0


def test_c4_train_step_matches_jax_update(c4_train):
    check_update(c4_train)


def test_c4_train_pools_the_box_set_alone(c4_train, monkeypatch):
    """No fused multi-pool: one pooling call (the box set), and the mask head
    reads the res5 features of the first ``mask_slots`` sampled slots."""
    from detectron2_tensorflow_tpu_torch.models import poolers

    calls = []
    real = poolers.RoiPatchPoolMulti.apply
    monkeypatch.setattr(poolers.RoiPatchPoolMulti, "apply",
                        lambda *a: calls.append(len(a) - 1) or real(*a))
    with torch.no_grad(), jax_proposals(c4_train["tmodel"], c4_train["j_raw"]):
        c4_train["tmodel"].losses(c4_train["tbatch"], noise=c4_train["noise"])
    assert calls == [3]  # one ROI set: (starts, wy, wx)


# -- the solver, the converters and the config files --------------------------------------

@pytest.mark.parametrize("freeze_at", [2, 5])
def test_c4_trainable_parameters_match_jax_mask(freeze_at):
    """The C4 head's res5 trains even at ``FREEZE_AT`` 5 (the JAX mask keys
    on the trunk's stage names, and the trunk has no res5)."""
    want = check_trainable_mask(C4_YAML, freeze_at)
    assert any(n.startswith("roi_heads.res5.") for n in want)
    assert not any(n.startswith(("backbone.stem.", "backbone.res2.")) for n in want)


def test_convert_d2_weights_c4_matches_jax_converter():
    """A seeded Detectron2-named C4 state dict (3-stage trunk ``backbone.*``,
    ``roi_heads.res5.{b}.*``, FrozenBN buffers, the mask deconv) through the
    port's converter equals the JAX converter's tree carried by
    ``convert_variables``; both leave the same keys over."""
    jcfg, tcfg = yaml_cfgs(C4_YAML)
    rng = np.random.default_rng(7)
    sd = {k: rng.standard_normal(s).astype(np.float32) for k, s in _port_shapes(tcfg).items()}
    sd["pixel_mean"] = np.zeros(3, np.float32)
    sd["roi_heads.extra.weight"] = np.zeros(2, np.float32)
    assert any(k.startswith("roi_heads.res5.2.") for k in sd)
    assert not any(k.startswith("backbone.res5.") for k in sd)
    got, got_left = convert_d2_weights(dict(sd), tcfg)
    tree, want_left = jax_convert_d2(dict(sd), jcfg)
    want = convert_variables(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert got_left == want_left == ["roi_heads.extra.weight"]


@pytest.mark.parametrize("path", C4_YAMLS)
def test_c4_yaml_builds_the_jax_tree(path):
    """Each C4 YAML of ``COCO-Detection/`` and ``COCO-InstanceSegmentation/``
    builds (narrow) with the JAX model's tensors."""
    assert len(C4_YAMLS) == 6
    check_yaml_shapes(path)


def test_single_level_patch_fits_the_kernel():
    """The C4/DC5 plane (one level at stride 16, its 2x and 4x aliases) at
    the serving and training sizes takes a 32-cell patch, under the ROI
    kernels' limit of 64."""
    _, tcfg = yaml_cfgs(C4_YAML)
    with torch.device("meta"):
        pooler = GeneralizedRCNN(tcfg).roi_heads.box_pooler
    assert pooler.strides == [16]
    assert pooler.patch_size == plan_patch(1344, 16) == 32 <= 64


def test_proposal_network_raises_by_name():
    """``GeneralizedRCNN`` names any other meta-architecture it is handed
    (the C4 RPN YAML's ``ProposalNetwork`` builds through ``build_model``),
    and ``build_model`` names what the port refuses (deformable convs on a
    basic-block trunk, as Detectron2 refuses them)."""
    _, tcfg = yaml_cfgs("configs/COCO-Detection/rpn_R_50_C4_1x.yaml")
    with pytest.raises(NotImplementedError, match="ProposalNetwork"), torch.device("meta"):
        GeneralizedRCNN(tcfg)
    _set(tcfg, "MODEL.META_ARCHITECTURE", "PanopticFPN")
    with pytest.raises(NotImplementedError, match="PanopticFPN"), torch.device("meta"):
        GeneralizedRCNN(tcfg)
    _set(tcfg, "MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True])
    _set(tcfg, "MODEL.RESNETS.DEPTH", 18)
    with pytest.raises(NotImplementedError, match="DEFORM_ON_PER_STAGE"):
        build_model(tcfg, device="cpu")


def test_faster_r_cnn_evaluates_boxes_only():
    """``evaluate`` of a model without a mask head (Faster R-CNN C4): bbox
    metrics and no segm evaluator, which the JAX evaluator adds only when the
    predictions hold masks."""
    from detectron2_tensorflow_tpu_torch.config import small_cfg
    from detectron2_tensorflow_tpu_torch.data import SyntheticDataset, build_dataloader
    from detectron2_tensorflow_tpu_torch.engine.evaluator import evaluate

    _, tcfg = yaml_cfgs("configs/COCO-Detection/faster_rcnn_R_50_C4_1x.yaml",
                        **{"MODEL.ROI_HEADS.NUM_CLASSES": 3})
    tiny = small_cfg()
    tcfg.TRANSFORM, tcfg.INPUT = tiny.TRANSFORM, tiny.INPUT
    ds = SyntheticDataset(n=2, num_classes=3)
    metrics = evaluate(tcfg, build_model(tcfg, device="cpu"), ds,
                       build_dataloader(tcfg, ds, training=False))
    assert "bbox/AP" in metrics and not any(k.startswith("segm/") for k in metrics)


# -- the overfit tool --------------------------------------------------------------------

def test_overfit_cfg_matches_the_jax_tool_c4():
    check_overfit_cfg("c4")


def test_overfit_check_c4_runs_on_the_cpu(capsys):
    """``tools.overfit_check --arch c4 --device cpu`` at narrow widths: two
    steps, the evaluation, and the JSON line with bbox and segm AP."""
    out = run_overfit_check("c4", [*OVERFIT_NARROW, "MODEL.RESNETS.WIDTH_PER_GROUP", "4"],
                            capsys)
    assert out["arch"] == "c4" and out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert {"bbox_ap", "bbox_ap50", "segm_ap", "segm_ap50"} <= set(out)


def test_overfit_check_eval_at_reports_an_earlier_step(capsys):
    """``--eval_at 1`` of a two-step run: a JSON line for step 1 with the
    same keys before the last line's step 2, and training goes on after it."""
    out = overfit_check.main(["2", "--arch", "c4", "--device", "cpu", "--eval_at", "1",
                              *OVERFIT_NARROW, "MODEL.RESNETS.WIDTH_PER_GROUP", "4"])
    captured = capsys.readouterr()
    lines = [json.loads(ln) for ln in captured.out.strip().splitlines()]
    assert [r["steps"] for r in lines] == [1, 2] and lines[-1] == out
    assert len([ln for ln in captured.err.splitlines() if ln.startswith("instances found")]) == 2
    assert set(lines[0]) == set(out) and np.isfinite(lines[0]["final_loss"])
    assert lines[0]["train_seconds"] <= out["train_seconds"]
    with pytest.raises(SystemExit):
        overfit_check.parse_args(["2", "--eval_at", "2"])


def test_overfit_check_counts_found_missed_and_false_detections():
    """``find_instances`` on a stand-in model that returns, per image, each
    GT box but the first (scaled to the resized image) with its class, the
    first GT box with a wrong class, and one box on no instance, all scored
    0.9, plus a box on no instance scored under c4's report threshold (0.25,
    the JAX tool's for every arch but ``rcnn``): every first GT is missed and
    both confident wrong boxes are false; the low one is not counted."""
    import types

    cfg = overfit_check.overfit_cfg("c4")
    ds = overfit_check.SyntheticDataset(n=3, num_classes=3)
    samples = iter(ds[i] for i in range(len(ds)))

    def predict(batch):
        s = next(samples)
        (nh, nw), (h, w) = batch["image_size"][0].tolist(), s["image"].shape[:2]
        boxes = (np.concatenate([s["boxes"], [[0, 0, 4, 4], [0, 0, 5, 5]]])
                 * np.array([nw / w, nh / h] * 2))
        classes = np.concatenate([[(s["classes"][0] + 1) % 3], s["classes"][1:], [0, 0]])
        scores = np.array([0.9] * (len(boxes) - 1) + [0.2])
        return types.SimpleNamespace(
            boxes=torch.tensor(boxes)[None], pred_classes=torch.tensor(classes)[None],
            scores=torch.tensor(scores)[None], is_valid=torch.ones(1, len(boxes), dtype=bool))

    found, missed, false = overfit_check.find_instances(
        cfg, types.SimpleNamespace(predict=predict), ds, "cpu", "c4")
    n_gt = sum(len(ds[i]["boxes"]) for i in range(len(ds)))
    assert (found, missed, false) == (n_gt - 3, 3, 6)
    assert overfit_check.report_thresh("c4") == 0.25 and overfit_check.report_thresh("rcnn") == 0.5
    iou = overfit_check.box_iou(np.array([[0, 0, 2, 2.]]), np.array([[1, 1, 3, 3.], [0, 0, 2, 2]]))
    np.testing.assert_allclose(iou, [[1 / 7, 1.0]])
