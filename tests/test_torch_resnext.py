"""ResNeXt's grouped 3x3 and ``STRIDE_IN_1X1 False`` (the stride in the
3x3, as the X-101-32x8d, GN and SyncBN YAMLs set it): the port against the
numpy oracle of ``tests/test_trunk_oracle.py`` and against the JAX package.

The oracle: the JAX test's R50 trunk with 4 groups of 16 channels and
FrozenBN statistics perturbed by up to 10%, in float64 numpy, against the
port's p2-p5 with the oracle's RMS gate, with the stride in the 1x1 and in
the 3x3. The parity cases: ``mask_rcnn_R_50_FPN_1x.yaml`` at narrow widths
with ``NUM_GROUPS 4`` (8 channels a group in res2) and ``STRIDE_IN_1X1 False``,
float32, 2 x 128 x 160 images, from the same tamed JAX weights:
detections as ``test_torch_c4.py`` holds them (integers equal, float32
1e-4), one train step's losses 1e-5 relative (the mask loss 3e-4),
gradients and updates 1e-4 of each tensor's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import build_train_step, create_train_state
from detectron2_tensorflow_tpu_torch.models import build_model
from test_torch_c4 import (
    FPN_YAML,
    check_detections,
    check_losses,
    predict_pair,
    repo_configs,
    train_pair,
    yaml_cfgs,
)
from test_torch_train import GRAD_TOL, LOSS_RTOL, MASK_LOSS_RTOL, assert_grad_close
from test_torch_train import assert_update_close, jax_proposals, jax_updated_params
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

GROUPED = {"MODEL.RESNETS.NUM_GROUPS": 4, "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
           "MODEL.RESNETS.STRIDE_IN_1X1": False, "MODEL.NECK.OUT_CHANNELS": 32}


@pytest.mark.parametrize("stride_in_1x1", [True, False])
def test_port_resnext_grouped_trunk_passes_the_numpy_oracle(stride_in_1x1):
    """``test_resnext_grouped_trunk_matches_numpy_oracle`` with the port's
    trunk and FPN in the JAX model's place: the grouped 3x3 blocks its output
    channels by group, each reading its own input slice."""
    from test_torch_gn import port_cfg_from, port_features, port_model
    from tests.test_end_to_end import tiny_rcnn_cfg
    from tests.test_trunk_oracle import (
        _fbn_conv,
        _rms_check,
        np_bottleneck,
        np_fpn,
        np_maxpool_3x3_s2,
    )

    with repo_configs():
        cfg = tiny_rcnn_cfg()
    cfg.MODEL.MASK_ON = False
    cfg.MODEL.RESNETS.DEPTH = 50
    cfg.MODEL.RESNETS.NORM = "FrozenBN"
    cfg.MODEL.RESNETS.NUM_GROUPS = 4
    cfg.MODEL.RESNETS.WIDTH_PER_GROUP = 16
    cfg.MODEL.RESNETS.STRIDE_IN_1X1 = stride_in_1x1
    rng = np.random.default_rng(17)
    img = rng.uniform(0, 255, (64, 128, 3)).astype(np.float32)
    batch = {"image": jnp.asarray(img[None]), "image_size": jnp.asarray([[64, 128]], jnp.int32)}
    with jax.default_matmul_precision("highest"):
        variables = jax.jit(jax_build_model(cfg).init)(jax.random.PRNGKey(8), batch)
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables["frozen"] = jax.tree_util.tree_map(
        lambda x: (1.0 + rng.uniform(-0.1, 0.1, x.shape)).astype(np.float32),
        variables["frozen"])
    model = port_model(port_cfg_from(cfg), variables)
    conv2 = model.backbone.bottom_up.res3[0].conv2
    assert conv2.groups == 4 and conv2.stride == ((1, 1) if stride_in_1x1 else (2, 2))
    feats, _, _ = port_features(model, img[None])

    params, fz = variables["params"], variables["frozen"]
    x = (np.asarray(img, np.float64) - np.asarray(cfg.MODEL.PIXEL_MEAN, np.float64)) / np.asarray(
        cfg.MODEL.PIXEL_STD, np.float64)
    if cfg.MODEL.INPUT_FORMAT == "BGR":
        x = x[..., ::-1]
    bb, bfz = params["backbone"], fz["backbone"]
    x = np_maxpool_3x3_s2(_fbn_conv(x, bb["stem"]["conv1"], bfz["stem"]["conv1"], 2, relu=True))
    planes = {}
    for idx, (name, nblocks) in enumerate([("res2", 3), ("res3", 4), ("res4", 6), ("res5", 3)]):
        for b in range(nblocks):
            x = np_bottleneck(x, bb[name][str(b)], bfz[name][str(b)],
                              stride=(2 if idx > 0 and b == 0 else 1), has_shortcut=(b == 0),
                              stride_in_1x1=stride_in_1x1, groups=4)
        planes[name] = x
    want = np_fpn(planes, params["neck"])
    for f in ("p2", "p3", "p4", "p5"):
        _rms_check(feats[f][0], want[f], f"port resnext {f}")


@pytest.fixture(scope="module")
def grouped_predict():
    return predict_pair(*yaml_cfgs(FPN_YAML, **GROUPED))


def test_grouped_model_predict_matches_jax(grouped_predict):
    model = grouped_predict["tmodel"]
    conv2 = model.backbone.bottom_up.res4[0].conv2
    assert conv2.groups == 4 and conv2.stride == (2, 2)
    assert model.backbone.bottom_up.res4[0].conv1.stride == (1, 1)
    check_detections(grouped_predict)
    np.testing.assert_allclose(grouped_predict["tout"].pred_masks.numpy(),
                               grouped_predict["jout"].pred_masks, rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def grouped_step():
    return train_pair(*yaml_cfgs(FPN_YAML, **GROUPED, **{"INPUT.MAX_GT_INSTANCES": 5,
                                                       "SOLVER.IMS_PER_BATCH": 2}))


def test_grouped_train_step_losses_match_jax(grouped_step):
    check_losses(grouped_step)


def test_grouped_train_step_gradients_match_jax(grouped_step):
    """Every trainable gradient, the grouped 3x3s' included; the frozen stem
    and res2 have none in the port and a zero one in JAX."""
    want = convert_variables({"params": grouped_step["j_grads"]})
    trainable = tsolver.trainable_parameters(grouped_step["tmodel"], 2)
    assert set(grouped_step["t_grads"]) == set(trainable)
    assert grouped_step["t_grads"]["backbone.bottom_up.res3.0.conv2.weight"].shape[1] == 16
    for name, w in want.items():
        if name in trainable:
            assert_grad_close(grouped_step["t_grads"][name], w.numpy(), name)
        else:
            assert name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")), name
            assert not w.numpy().any(), name


def test_grouped_train_step_update_matches_optax(grouped_step):
    run = grouped_step
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    start = convert_variables(run["variables"])
    model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    state = create_train_state(tcfg, model, torch.Generator().manual_seed(0))
    with jax_proposals(model, run["j_raw"]):
        metrics = build_train_step(tcfg, state)(run["tbatch"], noise=run["noise"])
    np.testing.assert_allclose(float(metrics["total_loss"]), run["j_total"], rtol=LOSS_RTOL,
                               atol=MASK_LOSS_RTOL * run["j_losses"]["loss_mask"])
    want = convert_variables({"params": jax_updated_params(jcfg, run["variables"]["params"],
                                                           run["j_grads"])})
    for name, p in model.named_parameters():
        assert_update_close(p.detach().numpy(), want[name].numpy(), start[name].numpy(),
                            GRAD_TOL, name)
