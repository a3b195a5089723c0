"""Deformable convs in the ResNet trunk (``DEFORM_ON_PER_STAGE``): serving,
the weights (the JAX tree, the Detectron2 converter, the init recipes, a
checkpoint with ``REMAT``) and what raises, the port against the JAX
package on the CPU (the train step: ``test_torch_dconv_train.py``).

Models: ``Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml`` at
``test_torch_c4.py``'s narrow widths (float32, 2 x 128 x 160 images), and a
ResNeXt variant with 2 groups, v2 (modulated) and 2 deformable groups, whose
dense deformable kernel must match the JAX package's ``(3, 3, C, F)``. The
JAX model's ``conv_offset`` starts at zero; both packages get the same
random offset convs (``with_offsets``), so samples fall between pixels.
Tolerances are ``test_torch_c4.py``'s: detections integers equal and float32
1e-4, masks 1e-5.
"""

import contextlib

import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.convert.d2 import convert_d2_weights as jax_convert_d2
from detectron2_tensorflow_tpu_torch.convert import _port_shapes, convert_d2_weights
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import build_train_step, create_train_state
from detectron2_tensorflow_tpu_torch.engine import make_train_batch
from detectron2_tensorflow_tpu_torch.engine.checkpoint import CheckpointManager
from detectron2_tensorflow_tpu_torch.engine.train import checkpoint_payload, restore_train_state
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.deform_conv import DeformConv2d
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import GeneralizedRCNN, init_weights
from detectron2_tensorflow_tpu_torch.tools import overfit_check
import test_torch_c4 as c4
from test_torch_c4 import (
    check_detections,
    check_masks,
    check_trainable_mask,
    predict_pair,
    yaml_cfgs,
)
from test_torch_config import assert_same_tree
from test_torch_slice import fused_switch
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

DCONV_YAML = "configs/Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml"
DCONV_YAMLS = ["configs/Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml",
               "configs/Misc/mask_rcnn_R_50_FPN_3x_dconv_c3-c5.yaml",
               "configs/Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml",
               "configs/Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml"]
FPN = {"MODEL.NECK.OUT_CHANNELS": 32}
GROUPED = {"MODEL.RESNETS.NUM_GROUPS": 2, "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
           "MODEL.RESNETS.STRIDE_IN_1X1": False, "MODEL.RESNETS.DEFORM_MODULATED": True,
           "MODEL.RESNETS.DEFORM_NUM_GROUPS": 2, **FPN}
TRAIN = {"INPUT.MAX_GT_INSTANCES": c4.G, "SOLVER.IMS_PER_BATCH": c4.B, **FPN}
TRUNK = "backbone.bottom_up"


def with_offsets(variables, seed=5):
    """``variables`` with every deformable block's ``conv_offset`` random: a
    kernel of std 0.05 and a bias uniform in [-1.5, 1.5] (offsets of about a
    pixel, some samples off the map)."""
    rng = np.random.default_rng(seed)
    for stage in variables["params"]["backbone"].values():
        for block in stage.values() if isinstance(stage, dict) else ():
            off = block.get("conv2", {}).get("conv_offset") if isinstance(block, dict) else None
            if off is not None:
                off["kernel"] = (rng.standard_normal(off["kernel"].shape) * 0.05).astype(np.float32)
                off["bias"] = rng.uniform(-1.5, 1.5, off["bias"].shape).astype(np.float32)
    return variables


@contextlib.contextmanager
def real_offsets():
    """``test_torch_c4``'s pairs with ``with_offsets`` after its ``tame``."""
    tame = c4.tame
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(c4, "tame", lambda v: with_offsets(tame(v)))
        yield


def deform_blocks(model):
    return {n: m for n, m in model.named_modules() if isinstance(m, DeformConv2d)}


# -- serving ----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dconv():
    with real_offsets():
        return predict_pair(*yaml_cfgs(DCONV_YAML, **FPN))


def test_dconv_trunk_deforms_res3_to_res5(dconv):
    """Every bottleneck of res3-res5 has a deformable ``conv2`` (v1: 18 offset
    channels) with its FrozenBN as ``conv2.norm``; res2 keeps its conv."""
    trunk = dconv["tmodel"].backbone.bottom_up
    blocks = deform_blocks(trunk)
    assert len(blocks) == 4 + 6 + 3 and not any(n.startswith("res2.") for n in blocks)
    conv2 = trunk.res3[0].conv2
    assert trunk.res3[0].conv1.stride == (2, 2) and conv2.stride == 1  # STRIDE_IN_1X1
    assert conv2.conv_offset.weight.shape == (18, 16, 3, 3)
    assert conv2.weight.shape == (16, 16, 3, 3) and conv2.norm is not None
    assert float(conv2.conv_offset.bias.detach().abs().max()) > 0.5  # the real offsets arrived


def test_dconv_predict_matches_jax(dconv):
    check_detections(dconv)
    check_masks(dconv, 28)


@pytest.fixture(scope="module")
def grouped():
    with real_offsets():
        return predict_pair(*yaml_cfgs(DCONV_YAML, **GROUPED))


def test_resnext_dconv_kernel_is_dense_as_jax(grouped):
    """``NUM_GROUPS`` 2 splits the plain 3x3s (res2) but not the deformable
    ones: their kernels are ``[F, C, 3, 3]``, the JAX ``(3, 3, C, F)``; v2 with
    2 deformable groups has 2 x 27 offset channels."""
    trunk = grouped["tmodel"].backbone.bottom_up
    assert trunk.res2[0].conv2.groups == 2
    conv2 = trunk.res4[0].conv2
    assert conv2.weight.shape == (64, 64, 3, 3)
    assert conv2.conv_offset.weight.shape == (54, 64, 3, 3) and conv2.modulated
    assert conv2.stride == 2 and trunk.res4[0].conv1.stride == (1, 1)
    jk = grouped["variables"]["params"]["backbone"]["res4"]["0"]["conv2"]["kernel"]
    assert jk.shape == (3, 3, 64, 64)


def test_resnext_dconv_predict_matches_jax(grouped):
    check_detections(grouped)
    check_masks(grouped, 28)


# -- what raises -----------------------------------------------------------------------

@pytest.mark.parametrize("depth", [18, 34])
def test_basic_block_trunk_with_deform_raises(depth):
    """Detectron2 refuses a deformable R18/R34; the JAX package would build it
    without a deformable conv. The port refuses it by name."""
    _, tcfg = yaml_cfgs(DCONV_YAML, **FPN, **{"MODEL.RESNETS.DEPTH": depth,
                                               "MODEL.RESNETS.RES2_OUT_CHANNELS": 64})
    with pytest.raises(NotImplementedError, match="DEFORM_ON_PER_STAGE.*basic"), \
            torch.device("meta"):
        GeneralizedRCNN(tcfg)


# -- weights ----------------------------------------------------------------------------

@pytest.mark.parametrize("path", DCONV_YAMLS)
def test_dconv_yaml_builds_the_jax_tree(path):
    """Each dconv YAML builds (narrow; GN's 32 groups dividing the widths)
    with the JAX model's tensors, name for name and shape for shape:
    ``conv2.weight`` dense, ``conv2.conv_offset.*``, ``conv2.norm.*``."""
    gn = ({"MODEL.RESNETS.STEM_OUT_CHANNELS": 32, "MODEL.RESNETS.RES2_OUT_CHANNELS": 128,
           "MODEL.RESNETS.WIDTH_PER_GROUP": 32 if "R_101" in path else 1,
           "MODEL.ROI_BOX_HEAD.CONV_DIM": 32, "MODEL.ROI_MASK_HEAD.CONV_DIM": 32,
           "MODEL.SEM_SEG_HEAD.CONVS_DIM": 32} if "_gn" in path else {})
    jcfg, tcfg = yaml_cfgs(path, **FPN, **gn)
    want = {k: tuple(v.shape) for k, v in convert_variables(c4.jax_param_shapes(jcfg)).items()}
    got = _port_shapes(tcfg)
    assert got == want
    offsets = [k for k in got if k.endswith(".conv2.conv_offset.weight")]
    assert len(offsets) == {50: 13, 101: 30, 152: 47}[tcfg.MODEL.RESNETS.DEPTH]
    c = tcfg.MODEL.RESNETS.NUM_GROUPS * tcfg.MODEL.RESNETS.WIDTH_PER_GROUP * 2
    assert got[f"{TRUNK}.res3.0.conv2.weight"] == (c, c, 3, 3)


@pytest.mark.parametrize("freeze_at", [2, 3])
def test_dconv_trainable_parameters_match_jax_mask(freeze_at):
    want = check_trainable_mask(DCONV_YAML, freeze_at)
    assert (f"{TRUNK}.res3.0.conv2.conv_offset.weight" in want) == (freeze_at < 3)
    assert f"{TRUNK}.res4.0.conv2.conv_offset.bias" in want


def d2_state_dict(tcfg, seed=7):
    """A seeded Detectron2-named state dict of ``tcfg``'s model: the port's
    names with ``conv2.conv_offset`` as Detectron2's ``conv2_offset``."""
    rng = np.random.default_rng(seed)
    sd = {k.replace(".conv2.conv_offset.", ".conv2_offset."): rng.standard_normal(s).astype(
        np.float32) for k, s in _port_shapes(tcfg).items()}
    sd["pixel_mean"] = np.zeros(3, np.float32)
    sd["roi_heads.extra.weight"] = np.zeros(2, np.float32)
    return sd


def test_convert_d2_weights_dconv_matches_jax_converter():
    """A Detectron2 R50-dconv state dict (``conv2.weight``, ``conv2_offset.*``,
    ``conv2.norm.*`` FrozenBN buffers) through the port's converter equals
    the JAX converter's tree carried by ``convert_variables``."""
    jcfg, tcfg = yaml_cfgs(DCONV_YAML, **FPN)
    sd = d2_state_dict(tcfg)
    assert f"{TRUNK}.res3.0.conv2_offset.weight" in sd
    got, got_left = convert_d2_weights(dict(sd), tcfg)
    tree, want_left = jax_convert_d2(dict(sd), jcfg)
    want = convert_variables(tree)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert torch.equal(got[f"{TRUNK}.res3.0.conv2.conv_offset.bias"],
                       torch.from_numpy(sd[f"{TRUNK}.res3.0.conv2_offset.bias"]))
    assert got_left == want_left == ["roi_heads.extra.weight"]


def test_convert_d2_weights_refuses_a_grouped_deformable_kernel():
    """A Detectron2 ResNeXt-dconv checkpoint holds ``[F, C / groups, 3, 3]``
    deformable kernels: the port's dense kernel has no place for them, and
    the converter says so instead of reshaping."""
    _, tcfg = yaml_cfgs(DCONV_YAML, **GROUPED)
    sd = d2_state_dict(tcfg)
    name = f"{TRUNK}.res3.0.conv2.weight"
    sd[name] = sd[name][:, ::2]
    with pytest.raises(ValueError, match="res3.0.conv2.weight.*grouped"):
        convert_d2_weights(sd, tcfg)


def test_init_recipes_set_the_offset_convs():
    """The JAX recipe zeroes every offset conv (``DeformConv2D``'s
    initializer) and draws the deformable kernels as convs; the serving
    recipe gives the offset convs zero weights and unit-normal biases."""
    _, tcfg = yaml_cfgs(DCONV_YAML, **FPN)
    model = GeneralizedRCNN(tcfg)
    for recipe in ("jax", "serving"):
        init_weights(model, torch.Generator().manual_seed(0), recipe)
        for name, m in deform_blocks(model).items():
            assert not m.conv_offset.weight.any(), name
            assert (m.conv_offset.bias.abs().max() > 0.5) == (recipe == "serving"), name
            fan_out = m.weight.shape[0] * 9
            std = float(m.weight.detach().std())
            want = np.sqrt(2.0 / (fan_out if recipe == "jax" else m.weight[0].numel()))
            assert 0.7 * want < std < 1.3 * want, (name, std, want)


def test_fused_tails_stay_on_deformable_blocks():
    """With the switch on, each of R50-dconv's 16 bottleneck tails takes the
    fused kernel, the deformable blocks' too, as in the JAX package."""
    _, tcfg = yaml_cfgs(DCONV_YAML, **FPN)
    with fused_switch(True), torch.device("meta"):
        model = GeneralizedRCNN(tcfg)
    assert sum(bool(getattr(m, "fuse_residual", False)) for m in model.modules()) == 16


def test_checkpoint_round_trip_with_deform_and_remat(tmp_path):
    """A training state of the REMAT dconv model saved by ``CheckpointManager``
    and restored into a model from other weights: every tensor and the
    optimizer's momentum bit-equal, and the next step's losses equal."""
    _, tcfg = yaml_cfgs(DCONV_YAML, **TRAIN, **{"MODEL.RESNETS.REMAT": True})
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(tcfg, c4.H, c4.W).items()}

    def state_of(seed):
        model = build_model(tcfg, device="cpu", training=True,
                            generator=torch.Generator().manual_seed(seed))
        return create_train_state(tcfg, model, torch.Generator().manual_seed(seed))

    first = state_of(0)
    build_train_step(tcfg, first)(batch)
    mgr = CheckpointManager(str(tmp_path), 1, 2, 10)
    mgr.save(1, checkpoint_payload(first))
    second = state_of(1)
    restore_train_state(second, mgr.restore(1))
    a, b = first.model.state_dict(), second.model.state_dict()
    assert any(".conv2.conv_offset." in k for k in a)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    opt_a, opt_b = first.optimizer.sgd.state, second.optimizer.sgd.state
    for pa, pb in zip(first.model.parameters(), second.model.parameters()):
        if pa in opt_a:
            assert torch.equal(opt_a[pa]["momentum_buffer"], opt_b[pb]["momentum_buffer"])
    la = build_train_step(tcfg, first)(batch)
    lb = build_train_step(tcfg, second)(batch)
    for k in la:
        assert torch.equal(la[k], lb[k]), k


# -- the overfit gate's recipe ----------------------------------------------------------

def test_overfit_cfg_dconv_is_the_jax_recipe_on_r50():
    """``overfit_cfg("dconv")`` is the JAX tool's, key for key, but the trunk's
    depth: the JAX recipe's ResNet-18 would take no deformable conv there
    (basic blocks), so the port keeps the YAML's ResNet-50."""
    import sys

    sys.path.insert(0, c4.REPO)
    from tools import overfit_check as jax_overfit_check

    want = jax_overfit_check.overfit_cfg("dconv")
    assert want.MODEL.RESNETS.DEPTH == 18
    want.MODEL.RESNETS.DEPTH = 50
    got = overfit_check.overfit_cfg("dconv")
    assert_same_tree(want, got)
    assert got.MODEL.RESNETS.NORM == "GN" and any(got.MODEL.RESNETS.DEFORM_ON_PER_STAGE)


def test_overfit_check_dconv_reports_its_offset_convs(capsys):
    """``tools.overfit_check 1 --arch dconv`` at narrow widths on the CPU: the
    JSON line's APs and its 13 offset convs, every one moved from zero by
    the step."""
    narrow = c4.OVERFIT_NARROW + ["MODEL.RESNETS.WIDTH_PER_GROUP", "32"]
    out = c4.run_overfit_check("dconv", narrow, capsys, steps=1)
    assert out["arch"] == "dconv" and np.isfinite(out["bbox_ap"])
    assert out["conv_offsets"] == out["conv_offsets_moved"] == 13
