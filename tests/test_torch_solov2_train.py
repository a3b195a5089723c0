"""SOLOv2 training against the JAX package: the losses, gradients and one
step's update of a narrow model, the trainable mask, the deformable towers'
``predict``, and the overfit tool's recipe.

The narrow model of ``test_torch_solov2.py`` (``solo_cfgs``: the SOLOv2 YAML,
R50 depth at stem 16, res2 32, FPN 32, 4 classes, grids 12/10/8/6/4,
float32), its head's convs 128 wide in training (``TRAIN_WIDTHS``), on
``make_train_batch``'s 2 x 128 x 160 batch with 5 GT (56 x 56 mini-masks),
from the same weights: ``spread``'s classifier but the JAX kernel
predictor (mask logits of order 10 make the sigmoid's slope, and every
gradient behind it, as sensitive as ``z (1 - 2p)`` to the packages' 1e-5
forward rounding), every GN at scale 0.3 and bias 1
(``test_torch_norms_syncbn.tie_free``: each head GN feeds a ReLU, and an
activation that one package rounds to the other side of 0 moves a gradient
slice; rounding, not a fault). The positive cap's uniform draws are the JAX
``loss_fn``'s own (``jax_solo_noise`` of its key), handed to the port as
``noise["solo"]``. Tolerances are the train tests' standing ones: losses
1e-5 relative, gradients and one step's updates 1e-4 of each tensor's
largest magnitude (2.3e-5 at most measured).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu import solver as jsolver
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.models import SingleStageDetector, build_model
from detectron2_tensorflow_tpu_torch.models.single_stage.solov2 import SOLOv2
from detectron2_tensorflow_tpu_torch.tools import overfit_check
from test_torch_c4 import (
    B,
    G,
    H,
    LOSS_RTOL,
    W,
    _tagged,
    check_overfit_cfg,
    images,
    jax_init,
    jax_param_shapes,
    run_overfit_check,
)
from test_torch_solov2 import check_solo_detections, jax_solo_noise, solo_cfgs, spread
from test_torch_norms_syncbn import tie_free
from test_torch_train import GRAD_TOL, assert_grad_close, assert_update_close, jax_updated_params
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

STEP_KEY = 1
# The head's GN layers with 4 channels per group: at 32 channels a GN is a
# per-channel norm, whose mean subtraction leaves each gradient behind it a
# remainder of large terms (a mask chain's last GN bias: 1.3e-4 of its
# largest gradient apart, at 2.3e-5 with these widths).
TRAIN_WIDTHS = {"MODEL.SOLO.MASK_KERNEL_CONVS_DIM": 128, "MODEL.SOLO.MASK_FEATURE_CONVS_DIM": 128,
                "MODEL.SOLO.MASK_FEATURE_OUT_DIMS": 128}


@pytest.fixture(scope="module")
def solo_train():
    """One training step of both packages from the same weights, batch and
    positive-cap noise: losses, gradients, and the port's step's update."""
    jcfg, tcfg = solo_cfgs(**{"INPUT.MAX_GT_INSTANCES": G, "SOLVER.IMS_PER_BATCH": B,
                              **TRAIN_WIDTHS})
    nb = make_train_batch(tcfg, H, W)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    jmodel = jax_build_model(jcfg)
    variables = tie_free(spread(jax_init(jcfg, 1, jbatch), kernel=1.0))
    rng = jax.random.PRNGKey(STEP_KEY)

    def total(p):
        t, (losses, _) = jmodel.loss_fn({**variables, "params": p}, jbatch, rng, {})
        return t, losses

    (j_total, j_losses), j_grads = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.value_and_grad(total, has_aux=True))(variables["params"]))
    start = convert_variables(variables)
    tmodel = build_model(tcfg, device="cpu", state_dict=start, training=True)
    noise = {"solo": jax_solo_noise(rng, B, tmodel.solov2.num_cells())}
    t_losses = tmodel.losses(tbatch, noise=noise)
    sum(t_losses.values()).backward()
    step_model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    state = create_train_state(tcfg, step_model, torch.Generator().manual_seed(0))
    metrics = build_train_step(tcfg, state)(tbatch, noise=noise)
    return dict(
        jcfg=jcfg, tcfg=tcfg, variables=variables, start=start, j_total=float(j_total),
        j_losses={k: float(v) for k, v in j_losses.items()}, j_grads=j_grads, tmodel=tmodel,
        t_losses={k: float(v.detach()) for k, v in t_losses.items()}, metrics=metrics,
        t_grads={n: p.grad.numpy().copy() for n, p in tmodel.named_parameters()
                 if p.grad is not None},
        after_one={n: p.detach().clone() for n, p in step_model.named_parameters()})


def test_solov2_train_losses_match_jax(solo_train):
    got, want = solo_train["t_losses"], solo_train["j_losses"]
    assert set(got) == set(want) == {"loss_ins", "loss_cate"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(solo_train["metrics"]["total_loss"]), solo_train["j_total"],
                               rtol=LOSS_RTOL)
    assert got["loss_ins"] > 0 and got["loss_cate"] > 0


def test_solov2_train_gradients_match_jax(solo_train):
    """Every trainable parameter's gradient (the head's towers, predictors
    and mask branch, the FPN, the trunk above res2) against ``jax.grad``;
    the frozen stem and res2 have none in the port and a zero one in JAX."""
    want = convert_variables({"params": solo_train["j_grads"]})
    trainable = tsolver.trainable_parameters(solo_train["tmodel"], 2)
    assert set(solo_train["t_grads"]) == set(trainable)
    assert {"head.cate_pred.bias", "head.kernel_pred.weight", "head.mask_p5_2.norm.weight",
            "head.mask_pred.weight"} <= set(trainable)
    for name, w in want.items():
        if name in trainable:
            assert_grad_close(solo_train["t_grads"][name], w.numpy(), name)
        else:
            assert name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")), name
            assert not w.numpy().any(), name


def test_solov2_train_step_matches_jax_update(solo_train):
    """``build_train_step``'s update against the JAX gradients through the
    optax chain."""
    want = convert_variables({"params": jax_updated_params(
        solo_train["jcfg"], solo_train["variables"]["params"], solo_train["j_grads"])})
    start = solo_train["start"]
    for name, p in solo_train["after_one"].items():
        assert_update_close(p.numpy(), want[name].numpy(), start[name].numpy(), GRAD_TOL, name)


def test_solov2_step_draws_from_the_generator():
    """Without handed-in noise the step draws the positive cap from the
    train state's generator: the same seed gives the same losses."""
    _, tcfg = solo_cfgs(**{"INPUT.MAX_GT_INSTANCES": G, "SOLVER.IMS_PER_BATCH": B})
    tbatch = {k: torch.from_numpy(v) for k, v in make_train_batch(tcfg, H, W).items()}
    model = build_model(tcfg, device="cpu", training=True)
    runs = [model.losses(tbatch, torch.Generator().manual_seed(3)) for _ in range(2)]
    assert ({k: float(v.detach()) for k, v in runs[0].items()}
            == {k: float(v.detach()) for k, v in runs[1].items()})


@pytest.mark.parametrize("freeze_at", [2, 5])
def test_solov2_trainable_parameters_match_jax_mask(freeze_at):
    jcfg, tcfg = solo_cfgs(**{"MODEL.BACKBONE.FREEZE_AT": freeze_at})
    params = jax_param_shapes(jcfg)["params"]
    names = list(convert_variables({"params": _tagged(params)}).items())
    by_tag = {int(v.reshape(-1)[0]): k for k, v in names}
    mask = jax.tree_util.tree_leaves(jsolver.trainable_mask(params, freeze_at))
    want = {by_tag[i] for i, m in enumerate(mask) if m}
    with torch.device("meta"):
        model = SingleStageDetector(tcfg)
    assert set(tsolver.trainable_parameters(model, freeze_at)) == want
    assert len(want) < len(mask) and any(n.startswith("head.mask_") for n in want)


def test_deformable_towers_predict_matches_jax():
    """``MODEL.SOLO.USE_DEFORM_CONV`` (v2, modulated): the whole model's
    ``predict`` slot by slot, with offsets and modulation away from their
    zero start."""
    jcfg, tcfg = solo_cfgs(**{"MODEL.SOLO.USE_DEFORM_CONV": True,
                              "MODEL.SOLO.DEFORM_MODULATED": True,
                              "MODEL.SOLO.SCORE_THRESH_TEST": 0.05,
                              "MODEL.SOLO.UPDATE_SCORE_THRESH_TEST": 0.02})
    batch, tbatch = images()
    variables = spread(jax_init(jcfg, 0, batch))
    rng = np.random.default_rng(5)
    for mod in variables["params"]["head"].values():
        off = mod.get("conv", {}).get("conv_offset")
        if off is not None:
            off["bias"][:] = rng.uniform(-1.5, 1.5, off["bias"].shape)
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jax_build_model(jcfg).predict)(
        variables, batch))
    sd = convert_variables(variables)
    assert "head.kernel_tower_0.conv_offset.weight" in sd and "head.mask_p5_2.norm.bias" in sd
    tmodel = build_model(tcfg, device="cpu", state_dict=sd)
    got = {k: v.numpy() for k, v in tmodel.predict(tbatch).get_fields().items()}
    check_solo_detections(got, jout.get_fields())


# -- the overfit tool ---------------------------------------------------------------------

def test_overfit_cfg_matches_the_jax_tool_solov2():
    """The port's recipe is the JAX tool's, key for key: the small
    configuration's ``TRANSFORM`` (mini-masks on), grids 24/20/16/12/8,
    ``dice+bce``, no anchor override; and its inputs are the 194x306 set."""
    check_overfit_cfg("solov2")
    cfg = overfit_check.overfit_cfg("solov2")
    assert cfg.TRANSFORM.RESIZE.USE_MINI_MASKS and cfg.MODEL.SOLO.INS_LOSS_TYPE == "dice+bce"
    ds = overfit_check.overfit_inputs(cfg, "solov2")
    assert ds[0]["image"].shape == (194, 306, 3) and ds[0].get("sem_seg") is None
    assert tuple(cfg.INPUT.PAD_BUCKETS[0]) == (128, 256)


def test_overfit_check_solov2_runs_on_the_cpu(capsys):
    """``tools.overfit_check --arch solov2 --device cpu`` at narrow widths,
    one step: the JSON line carries the bbox and segm APs (SOLOv2's masks
    through the evaluator's full-frame route)."""
    out = run_overfit_check("solov2", [
        "MODEL.RESNETS.STEM_OUT_CHANNELS", "32", "MODEL.RESNETS.RES2_OUT_CHANNELS", "128",
        "MODEL.NECK.OUT_CHANNELS", "32", "MODEL.SOLO.MASK_KERNEL_CONVS_DIM", "32",
        "MODEL.SOLO.MASK_KERNEL_NUM_CONVS", "1", "MODEL.SOLO.MASK_FEATURE_CONVS_DIM", "32",
        "MODEL.SOLO.MASK_FEATURE_OUT_DIMS", "32"], capsys, steps=1)
    assert out["arch"] == "solov2" and out["steps"] == 1
    assert {"bbox_ap", "bbox_ap50", "segm_ap", "segm_ap50"} <= set(out)
    assert np.isfinite(out["final_loss"])


def test_solov2_reads_no_dead_key():
    """``SINGLE_STAGE_HEAD.SCORE_THRESH_TEST`` (the JAX recipe sets it) and
    ``MODEL.SOLO.NMS_CLS_AGNOSTIC`` are read by neither package's ``SOLOv2``:
    the port's holds the same values whatever they are."""
    _, a = solo_cfgs()
    _, b = solo_cfgs(**{"MODEL.SINGLE_STAGE_HEAD.SCORE_THRESH_TEST": 0.9,
                        "MODEL.SOLO.NMS_CLS_AGNOSTIC": True})
    assert vars(SOLOv2(a)) == vars(SOLOv2(b))
