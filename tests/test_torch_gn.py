"""ResNet-18/34 basic blocks, GN in the trunk and the FPN, the JAX init
recipe, the decay groups and the trainable mask: the port against the JAX
package and against the numpy oracles of ``tests/test_trunk_oracle.py`` and
``tests/test_pipeline_oracle.py``.

Configurations: ``configs/synthetic/overfit_mask_rcnn_R_18.yaml`` (R18, GN
in the trunk and the FPN, ``FREEZE_AT 0``) at narrow widths that GN's 32
groups divide, float32 unless stated, on 2 x 128 x 160 images; the oracle
tests build the JAX package's ``tiny_rcnn_cfg`` (R18 with GN in the trunk)
from the repo's YAML. JAX weights reach the port through ``convert.py``.

Tolerances. float32 features and RPN outputs: 1e-4 (both sides sum float32
products in other orders; GN's variance is ``E[x^2] - E[x]^2`` in the JAX
package, a two-pass sum in PyTorch). bf16 (convs in bf16, GN statistics in
float32 on both sides): each package's bf16 features sit 2-4% (relative
RMS) from its own float32 ones, as bf16 rounding compounds through ~20
layers; port against JAX measured 3.0-4.1% RMS and at most 4.9% of a
tensor's largest value pointwise, so bf16 is held to BF16_RMS = 6% and
BF16_MAX = 10% of the largest value. The train
step: the losses, gradients and updates to ``tests/test_torch_train.py``'s
tolerances. The numpy oracles: their own tolerances.
"""

import contextlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu import solver as jsolver
from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.backbones import resnet as jresnet
from detectron2_tensorflow_tpu.models.layers import GroupNorm as JaxGroupNorm
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts, _RCNNDrivers
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import build_train_step, create_train_state
from detectron2_tensorflow_tpu_torch.engine import make_train_batch
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.backbones import resnet as tresnet
from detectron2_tensorflow_tpu_torch.models.layers import GroupNorm
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import GeneralizedRCNN, init_weights
from test_torch_config import _set, jax_flatten
from test_torch_slice import fused_switch
from test_torch_train import (
    GRAD_TOL,
    LOSS_KEYS,
    LOSS_RTOL,
    MASK_LOSS_RTOL,
    _port_logits,
    assert_grad_close,
    assert_update_close,
    fixed_jax_proposals,
    jax_noise,
    jax_pieces,
    jax_proposals,
)
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

R18_YAML = "configs/synthetic/overfit_mask_rcnn_R_18.yaml"
R50_YAML = "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml"
# Widths that GN's 32 groups divide (a basic-block stage is a quarter of
# RES2_OUT_CHANNELS wide).
GN_NARROW = {
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 32,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 128,
    "MODEL.NECK.OUT_CHANNELS": 32,
    "MODEL.ROI_BOX_HEAD.FC_DIM": 64,
    "MODEL.ROI_MASK_HEAD.CONV_DIM": 32,
    "MODEL.DTYPE": "float32",
}
B, H, W = 2, 128, 160
SIZES = np.array([[128, 160], [112, 150]], np.int32)
TOL = 1e-4
BF16_RMS, BF16_MAX = 0.06, 0.1
INIT_KEY = 2


def yaml_cfgs(path=R18_YAML, **overrides):
    """(JAX cfg, port cfg) from a repo YAML, the narrow GN widths and
    ``overrides``."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(path)
        for key, value in {**GN_NARROW, "SOLVER.IMS_PER_BATCH": B, **overrides}.items():
            _set(cfg, key, value)
    return jcfg, tcfg


def port_cfg_from(jcfg):
    """The port's config with every value of the JAX config ``jcfg``."""
    tcfg = get_cfg()
    for key, value in jax_flatten(jcfg).items():
        if key != "LOGS.COMPILATION_CACHE_DIR":
            _set(tcfg, key, value)
    return tcfg


def _batch(seed=0):
    img = np.random.default_rng(seed).uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    return img, SIZES


def jax_features(jcfg, variables, img, sizes):
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    batch = {"image": jnp.asarray(img), "image_size": jnp.asarray(sizes)}
    feats, logits, deltas = jax.jit(lambda v, b: drv.features_and_rpn(v, b, False))(
        variables, batch)
    return jax.tree_util.tree_map(np.asarray, (feats, logits, deltas))


def port_features(model, img):
    with torch.no_grad():
        feats = model.features(torch.from_numpy(img))
        rpn = model.proposal_generator
        logits, deltas = rpn.rpn_head([feats[f] for f in rpn.in_features])
    nhwc = {k: v.float().permute(0, 2, 3, 1).numpy() for k, v in feats.items()}
    return nhwc, [l.float().numpy() for l in logits], [d.float().numpy() for d in deltas]


@pytest.fixture(scope="module")
def r18():
    """The R18-GN model of both packages at narrow widths, the port's from
    the JAX weights."""
    jcfg, tcfg = yaml_cfgs()
    img, sizes = _batch()
    batch = {"image": jnp.asarray(img), "image_size": jnp.asarray(sizes)}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(INIT_KEY), batch))
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, img=img, sizes=sizes)


# -- GN ------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 64, 9, 13), (1, 256, 4, 5), (3, 32, 2, 3)])
def test_group_norm_matches_jax_float32(shape):
    rng = np.random.default_rng(sum(shape))
    x = (rng.standard_normal(shape) * 3 + 1).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, shape[1]).astype(np.float32)
    bias = rng.standard_normal(shape[1]).astype(np.float32)
    gn = GroupNorm(shape[1])
    with torch.no_grad():
        gn.weight.copy_(torch.from_numpy(scale))
        gn.bias.copy_(torch.from_numpy(bias))
        got = gn(torch.from_numpy(x)).numpy()
    params = {"params": {"GroupNorm_0": {"scale": scale, "bias": bias}}}
    want = np.asarray(JaxGroupNorm(shape[1]).apply(params, jnp.asarray(x.transpose(0, 2, 3, 1))))
    np.testing.assert_allclose(got, want.transpose(0, 3, 1, 2), rtol=1e-5, atol=1e-5)


def test_group_norm_bf16_keeps_float32_statistics():
    """bf16 in, bf16 out, the statistics and affine in float32 on both
    sides: the outputs differ by at most one bf16 ulp."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((2, 64, 8, 8)) * 4 + 2).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    gn = GroupNorm(64)
    got = gn(xb)
    assert got.dtype == torch.bfloat16
    params = {"params": {"GroupNorm_0": {"scale": np.ones(64, np.float32),
                                         "bias": np.zeros(64, np.float32)}}}
    want = JaxGroupNorm(64, dtype=jnp.bfloat16).apply(
        params, jnp.asarray(xb.float().numpy().transpose(0, 2, 3, 1), jnp.bfloat16))
    assert want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32)).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=2.0 ** -8, atol=1e-6)


# -- R18 with GN, against the JAX package ------------------------------------------

def test_r18_gn_converted_weights_load_and_name_gn_as_norm(r18):
    sd = convert_variables(r18["variables"])
    model = build_model(r18["tcfg"], device="cpu", state_dict=sd)
    assert set(sd) == set(model.state_dict())
    gn = [n for n, m in model.named_modules() if isinstance(m, GroupNorm)]
    assert "backbone.bottom_up.res2.0.conv1.norm" in gn
    assert "backbone.fpn_lateral2.norm" in gn and "backbone.fpn_output5.norm" in gn
    assert all(n.endswith(".norm") for n in gn)
    # R18: stem + 8 blocks of two convs + 4 shortcuts; FPN: 4 laterals + 4 outputs.
    assert len(gn) == 1 + 16 + 4 + 8
    assert model.backbone.fpn_lateral2.bias is None  # a GN conv has no bias


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_r18_gn_trunk_and_fpn_match_jax(r18, dtype):
    jcfg, tcfg = yaml_cfgs(**{"MODEL.DTYPE": dtype})
    model = build_model(tcfg, device="cpu", state_dict=convert_variables(r18["variables"]))
    feats, logits, deltas = port_features(model, r18["img"])
    j_feats, j_logits, j_deltas = jax_features(jcfg, r18["variables"], r18["img"], r18["sizes"])
    pairs = [(feats[k], np.asarray(j_feats[k], np.float32), k) for k in feats]
    pairs += [(a, np.asarray(b, np.float32), f"logits {i}") for i, (a, b) in
              enumerate(zip(logits, j_logits))]
    pairs += [(a, np.asarray(b, np.float32), f"deltas {i}") for i, (a, b) in
              enumerate(zip(deltas, j_deltas))]
    assert set(feats) == {"p2", "p3", "p4", "p5", "p6"}
    for got, want, name in pairs:
        assert got.shape == want.shape, name
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)
        else:
            rms = np.sqrt(np.mean((got - want) ** 2) / np.mean(want ** 2))
            assert rms <= BF16_RMS, (name, rms)
            np.testing.assert_allclose(got, want, rtol=0, atol=BF16_MAX * np.abs(want).max(),
                                       err_msg=name)


def test_r18_gn_predict_matches_jax(r18):
    """The serving path end to end: the same detections slot by slot."""
    jcfg, tcfg = r18["jcfg"], r18["tcfg"]
    jm = jax_build_model(jcfg)
    batch = {"image": jnp.asarray(r18["img"]), "image_size": jnp.asarray(r18["sizes"])}
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jm.predict)(r18["variables"], batch))
    model = build_model(tcfg, device="cpu", state_dict=convert_variables(r18["variables"]))
    got = model.predict({"image": torch.from_numpy(r18["img"]),
                         "image_size": torch.from_numpy(r18["sizes"])})
    valid = got.is_valid.numpy()
    np.testing.assert_array_equal(valid, want.is_valid)
    np.testing.assert_array_equal(got.pred_classes.numpy()[valid], want.pred_classes[valid])
    np.testing.assert_allclose(got.scores.numpy()[valid], want.scores[valid], rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.boxes.numpy()[valid], want.boxes[valid], rtol=TOL, atol=1e-3)
    np.testing.assert_allclose(got.pred_masks.numpy()[valid], want.pred_masks[valid],
                               rtol=TOL, atol=TOL)


# -- one R18-GN train step against the JAX loss_fn ------------------------------------

@pytest.fixture(scope="module")
def step(r18):
    return run_r18_step(r18)


# The JAX pooler averages a box's level down 2x (or 4x) where the box
# overflows its extent tier, accumulating in bf16 (0.6% relative; ROADMAP,
# "Behaviour of the reference that the port keeps"); the port averages in
# float32. The YAML's 256-pixel maximum makes the patch small enough for this
# batch's larger boxes to overflow, so the step is compared under the
# 1333-pixel plan, where none does.
STEP_OPTS = {"TRANSFORM.RESIZE.MAX_SIZE_TRAIN": 1333, "TRANSFORM.RESIZE.MAX_SIZE_TEST": 1333}


def run_r18_step(r18):
    """One train step of both packages from the same weights, noise and
    proposals: losses, gradients, start and updated parameters."""
    jcfg, tcfg = yaml_cfgs(**STEP_OPTS)
    nb = make_train_batch(tcfg, H, W)
    m = tcfg.TRANSFORM.RESIZE.MINI_MASK_SIZE  # the YAML's 28, as the loader makes them
    nb["gt_masks"] = np.random.default_rng(1).uniform(0, 1, nb["gt_masks"].shape[:2] + (m, m)
                                                      ).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    variables = r18["variables"]
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    step_rng = jax.random.PRNGKey(1)
    rng_rpn, rng_roi = jax.random.split(step_rng)

    def total_loss(params):
        total, (loss_dict, _) = drv.loss_fn({**variables, "params": params}, jbatch, step_rng, {})
        return total, loss_dict

    _, j_raw, j_props, _ = jax_pieces(drv, variables, jbatch, step_rng)
    with fixed_jax_proposals(drv, j_raw):
        (_, j_losses), j_grads = jax.jit(jax.value_and_grad(total_loss, has_aux=True))(
            variables["params"])
        tx = jsolver.build_optimizer(jcfg, variables["params"])
        updates, _ = tx.update(j_grads, tx.init(variables["params"]), variables["params"])
    j_new = {k: v.numpy() for k, v in convert_variables({**variables, "params": jax.tree_util.tree_map(
        lambda p, u: np.asarray(p + u), variables["params"], updates)}).items()}

    model = build_model(tcfg, device="cpu", state_dict=convert_variables(variables),
                        training=True)
    n_anchors = sum(int(np.prod(x.shape[1:3])) * 3 for x in _port_logits(model, tbatch))
    noise = {"rpn": jax_noise(rng_rpn, B, n_anchors),
             "roi": jax_noise(rng_roi, B, j_props.is_valid.shape[1])}
    start = {k: v.detach().clone().numpy() for k, v in model.state_dict().items()}
    state = create_train_state(tcfg, model, torch.Generator().manual_seed(0))
    with jax_proposals(model, j_raw):
        metrics = build_train_step(tcfg, state)(tbatch, noise=noise)
    t_grads = {n: p.grad.numpy().copy() for n, p in model.named_parameters()
               if p.grad is not None}
    j_grads = {k: v.numpy() for k, v in convert_variables({**variables, "params": jax.tree_util.tree_map(
        np.asarray, j_grads)}).items()}
    return dict(j_losses={k: float(v) for k, v in j_losses.items()},
                t_losses={k: float(v) for k, v in metrics.items()}, j_grads=j_grads,
                t_grads=t_grads, j_new=j_new, start=start,
                t_new={k: v.numpy() for k, v in model.state_dict().items()})


def test_r18_gn_train_step_losses_match_jax(step):
    for k in LOSS_KEYS:
        rtol = MASK_LOSS_RTOL if k == "loss_mask" else LOSS_RTOL
        np.testing.assert_allclose(step["t_losses"][k], step["j_losses"][k], rtol=rtol,
                                   err_msg=k)


# The mask head's convs are followed by ReLUs, and its input (ROIs pooled from
# the GN-normalized FPN) carries the two packages' float32 noise, ~1e-5 of
# its scale. On these batches a few of the head's 8e5 pre-activations lie
# within that noise of 0 (measured: 3, all under 1.2e-5 in magnitude; every
# init key from 1 to 8 has some), and each one that takes the other side of
# the ReLU moves the head's gradients by up to 0.8% of their largest value.
# So the full step holds every other parameter to GRAD_TOL, and the mask
# head is held to GRAD_TOL on identical inputs and upstream gradients
# (``test_r18_gn_mask_head_gradients_match_jax``).
MASK_HEAD = "roi_heads.mask_head."


def test_r18_gn_train_step_gradients_and_update_match_jax(step):
    grads = step["t_grads"]
    names = [n for n in step["j_grads"] if n in grads]
    assert any(".norm.weight" in n for n in names) and len(names) == len(grads)
    for name in names:
        if name.startswith(MASK_HEAD) or np.abs(step["j_grads"][name]).max() == 0:
            continue
        assert_grad_close(grads[name], step["j_grads"][name], name)
    stem = "backbone.bottom_up.stem."
    for name, want in step["j_new"].items():
        if name.startswith(stem):
            # At FREEZE_AT 0 the stem has a gradient, and the JAX package's
            # ``optax.masked`` passes a masked-out leaf's update through
            # unchanged: its stem moves by +gradient (learning rate 1, uphill).
            # The port leaves the masked stem as it is (ROADMAP Queue 3).
            np.testing.assert_array_equal(step["t_new"][name], step["start"][name])
            np.testing.assert_allclose(want, step["start"][name] + step["j_grads"][name],
                                       rtol=1e-6, atol=1e-7, err_msg=name)
        elif not name.startswith(MASK_HEAD):
            assert_update_close(step["t_new"][name], want, step["start"][name], GRAD_TOL, name)


def test_r18_gn_mask_head_gradients_match_jax(r18):
    """The mask head's parameter gradients of both packages on the same
    pooled ROI features and the same upstream gradient."""
    jcfg, tcfg, variables = r18["jcfg"], r18["tcfg"], r18["variables"]
    model = build_model(tcfg, device="cpu", state_dict=convert_variables(variables),
                        training=True)
    rng = np.random.default_rng(9)
    x = rng.standard_normal((12, 14, 14, GN_NARROW["MODEL.ROI_MASK_HEAD.CONV_DIM"])
                            ).astype(np.float32)
    logits = model.roi_heads.mask_head(torch.from_numpy(x))
    g = rng.standard_normal(tuple(logits.shape)).astype(np.float32)
    (logits * torch.from_numpy(g)).sum().backward()
    module = _build_rcnn_parts(jcfg)[0]

    def f(params):
        out = module.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                           method="mask")
        return jnp.sum(out * jnp.asarray(g))

    want = convert_variables({"params": jax.tree_util.tree_map(
        np.asarray, jax.grad(f)(variables["params"]))})
    for name, p in model.roi_heads.mask_head.named_parameters():
        assert_grad_close(p.grad.numpy(), want[MASK_HEAD + name].numpy(), name)


# -- solver groups and the trainable mask ----------------------------------------------

def _tagged(params):
    """Each leaf replaced by a constant array holding its index."""
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tagged = [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)]
    return jax.tree_util.tree_unflatten(treedef, tagged), len(leaves)


def test_decay_groups_and_trainable_mask_match_jax(r18):
    """Every parameter of the R18-GN model lands in the JAX package's decay
    group (GN's affine in ``norm``), and the trainable set is the JAX mask
    at FREEZE_AT 0: everything but the stem."""
    params = r18["variables"]["params"]
    tagged, n = _tagged(params)
    by_tag = {int(v.reshape(-1)[0]): k for k, v in convert_variables({"params": tagged}).items()}
    assert len(by_tag) == n
    model = build_model(r18["tcfg"], device="cpu",
                        state_dict=convert_variables(r18["variables"]), training=True)
    for group in ("weight", "bias", "norm"):
        mask = jax.tree_util.tree_leaves(jsolver._group_mask(params, group))
        want = {by_tag[i] for i, m in enumerate(mask) if m}
        got = {name for name, _ in model.named_parameters() if tsolver.param_group(name) == group}
        assert got == want, group
    assert any(".norm." in n for n in want)
    mask = jax.tree_util.tree_leaves(jsolver.trainable_mask(params, 0))
    want = {by_tag[i] for i, m in enumerate(mask) if m}
    assert set(tsolver.trainable_parameters(model, 0)) == want
    assert not any(n.startswith("backbone.bottom_up.stem.") for n in want)


# -- the trunk table, the fused tail and what still raises ----------------------------------

def test_blocks_per_stage_matches_jax():
    assert tresnet.BLOCKS_PER_STAGE == jresnet.BLOCKS_PER_STAGE


@pytest.mark.parametrize("depth,norm", [(18, "FrozenBN"), (34, "GN"), (50, "GN"), (101, "GN")])
def test_trunks_load_converted_jax_weights(depth, norm):
    """The port's modules for each depth and norm are named as the JAX
    tree converts: a strict load of the converted weights."""
    jcfg, tcfg = yaml_cfgs(**{"MODEL.RESNETS.DEPTH": depth, "MODEL.RESNETS.NORM": norm,
                              "MODEL.NECK.NORM": "", "MODEL.RESNETS.WIDTH_PER_GROUP": 32,
                              "MODEL.RESNETS.RES2_OUT_CHANNELS": 128 if depth < 50 else 256})
    img, sizes = _batch()
    batch = {"image": jnp.asarray(img[:1, :64, :64]), "image_size": jnp.asarray(sizes[:1] // 2)}
    shapes = jax.eval_shape(jax_build_model(jcfg).init, jax.random.PRNGKey(0), batch)
    variables = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    sd = convert_variables(variables)
    with torch.device("meta"):
        model = GeneralizedRCNN(tcfg)
    want = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want


@pytest.mark.parametrize("depth,norm,tails", [(18, "GN", 0), (18, "FrozenBN", 0), (50, "GN", 0),
                                              (50, "FrozenBN", 16)])
def test_fused_tails_only_on_frozen_bn_bottlenecks(depth, norm, tails):
    """With the switch on, only FrozenBN bottleneck tails take the fused
    kernel, as the JAX package's ``fused_epilogue_supported`` allows."""
    _, tcfg = yaml_cfgs(**{"MODEL.RESNETS.DEPTH": depth, "MODEL.RESNETS.NORM": norm,
                           "MODEL.RESNETS.RES2_OUT_CHANNELS": 128 if depth < 50 else 256})
    with fused_switch(True), torch.device("meta"):
        model = GeneralizedRCNN(tcfg)
    assert sum(bool(getattr(m, "fuse_residual", False)) for m in model.modules()) == tails


@pytest.mark.parametrize("key,value,match", [
    ("MODEL.NECK.TOP_BLOCK_TYPE", "", "MAXPOOL or P6P7"),
    ("MODEL.RESNETS.NORM", "naiveSyncBN", "NORM 'naiveSyncBN'"),
    ("MODEL.RESNETS.NORM", "LN", "NORM 'LN'"),
    ("MODEL.NECK.NORM", "LN", "NECK.NORM 'LN'"),
    # R18's basic blocks take no deformable conv (Detectron2 refuses them too).
    ("MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True], "DEFORM"),
    ("MODEL.RESNETS.STEM_SPACE_TO_DEPTH", True, "STEM_SPACE_TO_DEPTH"),
    # REMAT is ported: R18's basic blocks recompute too (FREEZE_AT 0: every stage).
    pytest.param("MODEL.RESNETS.REMAT", True, None, id="MODEL.RESNETS.REMAT-True-REMAT"),
])
def test_unported_trunk_keys_raise(key, value, match):
    _, tcfg = yaml_cfgs(**{key: value})
    if match is None:
        from detectron2_tensorflow_tpu_torch.models.backbones.resnet import RematStage

        with torch.device("meta"):
            trunk = GeneralizedRCNN(tcfg).backbone.bottom_up
        assert all(isinstance(getattr(trunk, s), RematStage) for s in trunk.stage_names)
        return
    with pytest.raises(NotImplementedError, match=match), torch.device("meta"):
        GeneralizedRCNN(tcfg)


def test_jax_init_recipe_matches_the_jax_initializers():
    """``init_weights(..., "jax")`` draws from the JAX package's
    distributions: per layer the same variance, bound and mean (checked on
    the moments of each tensor)."""
    jcfg, tcfg = yaml_cfgs(**{"MODEL.ROI_BOX_HEAD.FC_DIM": 256})
    img, sizes = _batch()
    batch = {"image": jnp.asarray(img), "image_size": jnp.asarray(sizes)}
    want = {k: v.numpy() for k, v in convert_variables(jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0), batch))).items()}
    model = GeneralizedRCNN(tcfg)
    init_weights(model, torch.Generator().manual_seed(0), "jax")
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    for name, w in want.items():
        g = got[name]
        if np.all(w == w.reshape(-1)[0]):  # zeros and ones: biases, GN
            np.testing.assert_array_equal(g, w, err_msg=name)
            continue
        # Same spread (within three times the sampling error of both
        # draws), same bound (2 standard deviations for the truncated
        # normals, the uniform's limit for the FCs; the small normals are not
        # truncated).
        assert abs(g.std() / w.std() - 1) < 0.02 + 3 / np.sqrt(w.size), (name, g.std(), w.std())
        assert abs(g.mean()) < 4 * w.std() / np.sqrt(w.size), name
        if not any(k in name for k in ("rpn_head", "box_predictor", "mask_head.predictor")):
            assert np.abs(g).max() <= np.abs(w).max() * 1.01 + 1e-7, name


# -- the numpy oracles ----------------------------------------------------------------

def oracle_cfg():
    """The JAX package's ``tests/test_end_to_end.tiny_rcnn_cfg``, built from
    the repo's copy of its YAML."""
    from tests.test_data import small_cfg

    cfg = small_cfg()
    cfg.merge_from_file(R50_YAML)
    for key, value in {
        "TRANSFORM.RESIZE.MIN_SIZE_TRAIN": (64,), "TRANSFORM.RESIZE.MAX_SIZE_TRAIN": 128,
        "TRANSFORM.RESIZE.MIN_SIZE_TEST": 64, "TRANSFORM.RESIZE.MAX_SIZE_TEST": 128,
        "TRANSFORM.RESIZE.MINI_MASK_SIZE": 28, "INPUT.PAD_BUCKETS": ((64, 128), (128, 64)),
        "INPUT.MAX_GT_INSTANCES": 8, "SOLVER.IMS_PER_BATCH": 2, "MODEL.RESNETS.DEPTH": 18,
        "MODEL.ROI_HEADS.NUM_CLASSES": 3, "MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200,
        "MODEL.RPN.POST_NMS_TOPK_TRAIN": 100, "MODEL.RPN.PRE_NMS_TOPK_TEST": 200,
        "MODEL.RPN.POST_NMS_TOPK_TEST": 100, "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 32,
        "TEST.DETECTIONS_PER_IMAGE": 8, "SOLVER.BASE_LR": 0.002, "SOLVER.WARMUP_ITERS": 10,
        "SOLVER.AUTO_SCALE_LR_SCHEDULE": False, "MODEL.BACKBONE.FREEZE_AT": 0,
        "MODEL.RESNETS.NORM": "GN",
    }.items():
        _set(cfg, key, value)
    return cfg


def port_model(tcfg, variables):
    """The port's model on the CPU with the JAX weights (with a mask head
    when ``MASK_ON``, as the JAX model has)."""
    sd = convert_variables(jax.tree_util.tree_map(np.asarray, variables))
    return build_model(tcfg, device="cpu", state_dict=sd)


class PortModel:
    """Stands in for the JAX model in an oracle test: ``init`` is the JAX
    model's, ``predict`` runs the port (on the CPU) on the converted
    weights."""

    def __init__(self, jcfg):
        self.jcfg = jcfg
        self.jax_model = jax_build_model(jcfg)
        self.module = self.jax_model.module  # an oracle applies the JAX heads itself

    def init(self, rng, batch):
        return jax.jit(self.jax_model.init)(rng, batch)

    def predict(self, variables, batch):
        model = port_model(port_cfg_from(self.jcfg), variables)
        out = model.predict({"image": torch.from_numpy(np.array(batch["image"])),
                             "image_size": torch.from_numpy(np.array(batch["image_size"]))})
        return types.SimpleNamespace(**{k: v.numpy() for k, v in out.get_fields().items()})


class _JaxWithPortPredict(types.ModuleType):
    """``jax`` for an oracle test module, whose ``jit`` leaves the port's
    ``predict`` unjitted (it runs PyTorch on numpy arrays)."""

    def __init__(self):
        super().__init__("jax")

    def __getattr__(self, name):
        return getattr(jax, name)

    @staticmethod
    def jit(fn, **kwargs):
        if isinstance(getattr(fn, "__self__", None), PortModel):
            return fn
        return jax.jit(fn, **kwargs)


@contextlib.contextmanager
def port_in(module):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, "tiny_rcnn_cfg", oracle_cfg)
        mp.setattr(module, "build_model", PortModel)
        mp.setattr(module, "jax", _JaxWithPortPredict())
        yield


def test_port_passes_the_pipeline_oracle():
    """``tests/test_pipeline_oracle.py``'s full inference oracle (proposal
    selection, level assignment, ROIAlign, class-aware NMS, masks, all in
    sequential numpy on the JAX features) holds the port's ``predict``."""
    from tests import test_pipeline_oracle as oracle

    with port_in(oracle):
        oracle.test_full_inference_pipeline_matches_numpy_oracle()


def test_port_passes_the_r18_gn_image_to_detections_oracle():
    """``tests/test_trunk_oracle.py``'s image-to-detections oracle: R18-GN
    trunk, FPN and RPN head in float64 numpy from the image and the weights,
    then proposals, pooling and NMS; the port's ``predict`` must give its
    detections."""
    from tests import test_trunk_oracle as oracle

    with port_in(oracle):
        oracle.test_image_to_detections_matches_numpy_trunk_oracle()


def test_port_r18_gn_trunk_matches_the_numpy_oracle():
    """The port's own trunk, FPN and RPN logits against the float64 numpy
    transcription (``np_resnet18``, ``np_fpn``, ``np_rpn_head``)."""
    from tests.test_trunk_oracle import np_fpn, np_resnet18, np_rpn_head

    jcfg = oracle_cfg()
    jcfg.MODEL.MASK_ON = True
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 255, (1, 64, 128, 3)).astype(np.float32)
    batch = {"image": jnp.asarray(img), "image_size": jnp.asarray([[64, 128]], jnp.int32)}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(11), batch))
    model = build_model(port_cfg_from(jcfg), device="cpu",
                        state_dict=convert_variables(variables))
    feats, logits, _ = port_features(model, img)
    params = variables["params"]
    x = (img[0].astype(np.float64) - np.asarray(jcfg.MODEL.PIXEL_MEAN)) / np.asarray(
        jcfg.MODEL.PIXEL_STD)
    if jcfg.MODEL.INPUT_FORMAT == "BGR":
        x = x[..., ::-1]
    planes = np_fpn(np_resnet18(x, params["backbone"]), params["neck"])
    fnames = ["p2", "p3", "p4", "p5", "p6"]
    want_logits, _ = np_rpn_head([planes[f] for f in fnames], params["rpn_head"])
    for f in fnames:
        np.testing.assert_allclose(feats[f][0], planes[f], rtol=2e-4, atol=2e-4, err_msg=f)
    for lv, f in enumerate(fnames):
        np.testing.assert_allclose(logits[lv][0], want_logits[lv], rtol=2e-4, atol=2e-4,
                                   err_msg=f"rpn logits {f}")


def test_port_r50_frozen_bn_trunk_matches_the_numpy_oracle():
    """``tests/test_trunk_oracle.py``'s R50 FrozenBN oracle (frozen
    statistics perturbed by up to 10%) against the port's trunk, FPN and
    RPN logits, with its RMS and pointwise gates."""
    from tests.test_trunk_oracle import np_bottleneck, np_fpn, np_maxpool_3x3_s2, np_rpn_head
    from tests.test_trunk_oracle import _fbn_conv

    jcfg = oracle_cfg()
    jcfg.MODEL.MASK_ON = False
    jcfg.MODEL.RESNETS.DEPTH = 50
    jcfg.MODEL.RESNETS.NORM = "FrozenBN"
    jcfg.MODEL.BACKBONE.FREEZE_AT = 2
    rng = np.random.default_rng(5)
    img = rng.uniform(0, 255, (1, 64, 128, 3)).astype(np.float32)
    batch = {"image": jnp.asarray(img), "image_size": jnp.asarray([[64, 128]], jnp.int32)}
    variables = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(2), batch))
    variables["frozen"] = jax.tree_util.tree_map(
        lambda x: (1.0 + rng.uniform(-0.1, 0.1, x.shape)).astype(np.float32),
        variables["frozen"])
    feats, logits, _ = port_features(port_model(port_cfg_from(jcfg), variables), img)

    params, fz = variables["params"], variables["frozen"]
    x = (img[0].astype(np.float64) - np.asarray(jcfg.MODEL.PIXEL_MEAN)) / np.asarray(
        jcfg.MODEL.PIXEL_STD)
    if jcfg.MODEL.INPUT_FORMAT == "BGR":
        x = x[..., ::-1]
    bb, bfz = params["backbone"], fz["backbone"]
    x = np_maxpool_3x3_s2(_fbn_conv(x, bb["stem"]["conv1"], bfz["stem"]["conv1"], 2, relu=True))
    res = {}
    for idx, (name, nblocks) in enumerate([("res2", 3), ("res3", 4), ("res4", 6), ("res5", 3)]):
        for b in range(nblocks):
            x = np_bottleneck(x, bb[name][str(b)], bfz[name][str(b)],
                              stride=(2 if idx > 0 and b == 0 else 1), has_shortcut=(b == 0))
        res[name] = x
    planes = np_fpn(res, params["neck"])
    fnames = ["p2", "p3", "p4", "p5", "p6"]
    want_logits, _ = np_rpn_head([planes[f] for f in fnames], params["rpn_head"])

    def check(got, want, what):  # the oracle test's own gates
        got = np.asarray(got, np.float64)
        rms = np.sqrt(np.mean((got - want) ** 2)) / (np.sqrt(np.mean(want ** 2)) + 1e-9)
        assert rms < 3e-4, (what, rms)
        np.testing.assert_allclose(got, want, rtol=5e-2, atol=0.15, err_msg=what)

    for f in fnames:
        check(feats[f][0], planes[f], f"trunk feature {f}")
    for lv, f in enumerate(fnames):
        check(logits[lv][0], want_logits[lv], f"rpn logits {f}")
