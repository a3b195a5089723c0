"""The DC5 family (res5 dilated at stride 16, no neck, ``StandardROIHeads``
on ``res5``) against the JAX package, and the pieces the single-level
families share with R50-FPN: the solver's frozen stages and the overfit
tool's ``rcnn`` gate.

``configs/COCO-InstanceSegmentation/mask_rcnn_R_50_DC5_1x.yaml`` at the
narrow widths of ``test_torch_c4.py`` (whose helpers and tolerances this
file uses), 2 x 128 x 160 images, ``MASK_ON`` True and False. The DC5 trunk
is also held against the numpy oracle of ``tests/test_trunk_oracle.py``
(its own gates).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import GeneralizedRCNN
from test_torch_c4 import (
    B,
    DC5_YAML,
    DC5_YAMLS,
    FPN_YAML,
    G,
    H,
    OVERFIT_NARROW,
    REPO,
    W,
    check_detections,
    check_gradients,
    check_losses,
    check_masks,
    check_overfit_cfg,
    check_proposals,
    check_trainable_mask,
    check_update,
    check_yaml_shapes,
    predict_pair,
    repo_configs,
    run_overfit_check,
    train_cfgs,
    train_pair,
    yaml_cfgs,
)
from test_torch_slice import count_fused_calls, fused_custom_vjp_calls, fused_switch
from test_torch_train import jax_proposals
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)


# -- serving ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=[True, False], ids=["mask", "faster"])
def dc5(request):
    return predict_pair(*yaml_cfgs(DC5_YAML, **{"MODEL.MASK_ON": request.param}))


def test_dc5_model_is_one_level_on_res5(dc5):
    """No neck (the trunk is ``backbone``, res5 at stride 16), the RPN and the
    ROI heads on ``res5``'s 256 (narrow 2048) channels, FC1 on 7 x 7 x 256."""
    m = dc5["tmodel"]
    assert m.trunk is m.backbone
    first = m.backbone.res5[0]
    assert first.conv2.dilation == (2, 2)
    assert first.conv1.stride == first.shortcut.stride == (1, 1)
    assert m.roi_heads.box_pooler.strides == [16]
    assert m.roi_heads.box_head.fc1.weight.shape[1] == 7 * 7 * 256
    assert m.proposal_generator.rpn_head.conv.weight.shape[1] == 256
    with torch.no_grad():
        feats = m.features(dc5["tbatch"]["image"])
    assert list(feats) == ["res5"] and tuple(feats["res5"].shape[2:]) == (H // 16, W // 16)


def test_dc5_detections_match_jax(dc5):
    check_detections(dc5)


def test_dc5_masks_match_jax(dc5):
    """Masks from the 4-conv head on 14x14 pooled res5 features (28x28)."""
    check_masks(dc5, 28)


def test_dc5_proposals_match_jax(dc5):
    check_proposals(dc5)


@pytest.mark.parametrize("mode", ["predict", "losses"])
def test_dc5_fused_tails_match_jax(mode):
    """With the switch on, all 16 of R50's tails (dilated res5's included)
    take the fused tail, per ``predict`` and per step, in both packages."""
    with fused_switch(True), pytest.MonkeyPatch.context() as mp:
        jcfg, tcfg = train_cfgs(DC5_YAML)
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
        assert fused_custom_vjp_calls(jaxpr) == len(calls) == 16


def test_dc5_trunk_passes_the_numpy_oracle():
    """``tests/test_trunk_oracle.py``'s DC5 oracle (R50 FrozenBN with its
    statistics perturbed by up to 10%, res5 at dilation 2 and stride 1, the
    RPN head on it), in float64 numpy, against the port's res5 and RPN
    logits, with the oracle's RMS gate."""
    from test_torch_gn import port_cfg_from, port_features, port_model
    from tests.test_end_to_end import tiny_rcnn_cfg
    from tests.test_trunk_oracle import (
        _fbn_conv,
        _rms_check,
        np_bottleneck,
        np_maxpool_3x3_s2,
        np_rpn_head,
    )

    with repo_configs():
        cfg = tiny_rcnn_cfg()
    cfg.merge_from_file(f"{REPO}/configs/Base-RCNN-DilatedC5.yaml")
    cfg.MODEL.MASK_ON = False
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.RESNETS.NORM = "FrozenBN"
    cfg.MODEL.NECK.NAME = ""
    cfg.MODEL.ANCHOR_GENERATOR.SIZES = [[32, 64, 128, 256, 512]]
    cfg.MODEL.RPN.POST_NMS_TOPK_TEST = 64
    rng = np.random.default_rng(9)
    img = rng.uniform(0, 255, (64, 128, 3)).astype(np.float32)
    batch = {"image": jnp.asarray(img[None]), "image_size": jnp.asarray([[64, 128]], jnp.int32)}
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(4), batch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["frozen"] = jax.tree_util.tree_map(
        lambda x: (1.0 + rng.uniform(-0.1, 0.1, x.shape)).astype(np.float32),
        variables["frozen"])
    feats, logits, _ = port_features(port_model(port_cfg_from(cfg), variables), img[None])

    params, fz = variables["params"], variables["frozen"]
    x = (np.asarray(img, np.float64) - np.asarray(cfg.MODEL.PIXEL_MEAN, np.float64)) / np.asarray(
        cfg.MODEL.PIXEL_STD, np.float64)
    if cfg.MODEL.INPUT_FORMAT == "BGR":
        x = x[..., ::-1]
    bb, bfz = params["backbone"], fz["backbone"]
    x = np_maxpool_3x3_s2(_fbn_conv(x, bb["stem"]["conv1"], bfz["stem"]["conv1"], 2, relu=True))
    for idx, (name, nblocks) in enumerate([("res2", 3), ("res3", 4), ("res4", 6), ("res5", 3)]):
        dil = 2 if name == "res5" else 1
        first_stride = 2 if idx > 0 and dil == 1 else 1
        for b in range(nblocks):
            x = np_bottleneck(x, bb[name][str(b)], bfz[name][str(b)],
                              stride=(first_stride if b == 0 else 1), has_shortcut=(b == 0),
                              dilation=dil)
    assert feats["res5"].shape[1:3] == x.shape[:2] == (4, 8)  # stride 16, not 32
    _rms_check(feats["res5"][0], x, "dc5 res5")
    want_logits, _ = np_rpn_head([x], params["rpn_head"])
    _rms_check(logits[0][0], want_logits[0], "dc5 rpn logits")


# -- training --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dc5_train():
    return train_pair(*train_cfgs(DC5_YAML))


def test_dc5_train_losses_match_jax(dc5_train):
    check_losses(dc5_train)


def test_dc5_train_gradients_match_jax(dc5_train):
    check_gradients(dc5_train)
    assert np.abs(dc5_train["t_grads"]["backbone.res5.0.conv2.weight"]).max() > 0


def test_dc5_train_step_matches_jax_update(dc5_train):
    check_update(dc5_train)


def test_dc5_train_pools_box_and_mask_sets_in_one_op(dc5_train, monkeypatch):
    """DC5 takes the FPN path's fused multi-pool: one op for the box set and
    the first ``mask_slots`` slots' mask set."""
    from detectron2_tensorflow_tpu_torch.models import poolers

    calls = []
    real = poolers.RoiPatchPoolMulti.apply
    monkeypatch.setattr(poolers.RoiPatchPoolMulti, "apply",
                        lambda *a: calls.append(len(a) - 1) or real(*a))
    with torch.no_grad(), jax_proposals(dc5_train["tmodel"], dc5_train["j_raw"]):
        dc5_train["tmodel"].losses(dc5_train["tbatch"], noise=dc5_train["noise"])
    assert calls == [6]  # two ROI sets: (starts, wy, wx) each


def test_faster_dc5_trains_without_a_mask_head():
    """``MASK_ON`` False: no mask head and no ``loss_mask``; the box set is
    pooled alone."""
    _, tcfg = train_cfgs(DC5_YAML)
    tcfg.MODEL.MASK_ON = False
    model = build_model(tcfg, device="cpu", training=True)
    assert not hasattr(model.roi_heads, "mask_head")
    state = create_train_state(tcfg, model, torch.Generator().manual_seed(0))
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(tcfg, H, W).items()}
    metrics = build_train_step(tcfg, state)(batch)
    assert set(metrics) == {"total_loss", "loss_rpn_cls", "loss_rpn_loc", "loss_cls",
                            "loss_box_reg"}
    assert all(np.isfinite(float(v)) for v in metrics.values())
    assert B == 2 and G == 5


# -- the solver and the config files ------------------------------------------------------

@pytest.mark.parametrize("freeze_at", [2, 5])
@pytest.mark.parametrize("path", [DC5_YAML, FPN_YAML], ids=["dc5", "fpn"])
def test_trainable_parameters_match_jax_mask(path, freeze_at):
    """On a neck-less trunk (``backbone.*``) and under the FPN
    (``backbone.bottom_up.*``) alike."""
    want = check_trainable_mask(path, freeze_at)
    trunk = "backbone." if path == DC5_YAML else "backbone.bottom_up."
    assert not any(n.startswith(trunk + "res2.") for n in want)
    assert any(n.startswith(trunk + "res5.") for n in want) == (freeze_at < 5)


@pytest.mark.parametrize("path", DC5_YAMLS)
def test_dc5_yaml_builds_the_jax_tree(path):
    """Each DC5 YAML of ``COCO-Detection/`` and ``COCO-InstanceSegmentation/``
    builds (narrow) with the JAX model's tensors."""
    assert len(DC5_YAMLS) == 6
    check_yaml_shapes(path)


def test_dilation_keeps_res5_at_stride_16():
    _, tcfg = yaml_cfgs(DC5_YAML)
    with torch.device("meta"):
        model = GeneralizedRCNN(tcfg)
    assert [b.conv2.dilation for b in model.backbone.res5] == [(2, 2)] * 3
    assert [b.conv2.padding for b in model.backbone.res5] == [(2, 2)] * 3


# -- the overfit tool --------------------------------------------------------------------

def test_overfit_cfg_matches_the_jax_tool_rcnn():
    check_overfit_cfg("rcnn")


def test_overfit_check_rcnn_runs_on_the_cpu(capsys):
    """``tools.overfit_check --arch rcnn --device cpu`` at narrow widths."""
    out = run_overfit_check("rcnn", [*OVERFIT_NARROW, "MODEL.NECK.OUT_CHANNELS", "32",
                                     "MODEL.ROI_BOX_HEAD.FC_DIM", "64"], capsys)
    assert out["arch"] == "rcnn" and out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert {"bbox_ap", "bbox_ap50", "segm_ap", "segm_ap50"} <= set(out)
