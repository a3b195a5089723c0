"""The train step of the deformable trunk and per-block rematerialization
(``REMAT``): the port against the JAX package on the CPU.

``test_torch_dconv.py``'s narrow ``mask_rcnn_R_50_FPN_1x_dconv_c3-c5`` with
random offset convs, one step from the same weights, batch, sampler noise
and (the JAX package's) proposals, at ``test_torch_c4.py``'s tolerances:
losses 1e-5 relative (the mask loss 3e-4), gradients and updates 1e-4 of
each tensor's largest magnitude. REMAT: the JAX ``nn.remat`` against the
port's ``torch.utils.checkpoint`` to those tolerances; the port with it on
against itself with it off bit for bit on the CPU, trainable BN's running
statistics included (updated once, in the forward pass).
"""

import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import make_train_batch
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.backbones.resnet import RematStage
from detectron2_tensorflow_tpu_torch.models.layers import BatchNorm2d
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import GeneralizedRCNN
import test_torch_c4 as c4
from test_torch_c4 import check_losses, check_update, train_pair, yaml_cfgs
from test_torch_dconv import DCONV_YAML, FPN, TRAIN, TRUNK, real_offsets
from test_torch_train import assert_grad_close, jax_proposals
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)


def check_fpn_gradients(run):
    """Every trainable gradient against ``jax.grad`` (``test_torch_c4``'s
    ``check_gradients`` under an FPN's trunk names); the frozen stem and res2
    have none in the port and a zero one in JAX."""
    want = convert_variables({"params": run["j_grads"]})
    trainable = tsolver.trainable_parameters(run["tmodel"], 2)
    assert set(run["t_grads"]) == set(trainable)
    for name, w in want.items():
        if name in trainable:
            assert_grad_close(run["t_grads"][name], w.numpy(), name)
        else:
            assert name.startswith((f"{TRUNK}.stem.", f"{TRUNK}.res2.")), name
            assert not w.numpy().any(), name


# -- the train step ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dconv_step():
    with real_offsets():
        return train_pair(*yaml_cfgs(DCONV_YAML, **TRAIN))


def test_dconv_train_losses_match_jax(dconv_step):
    check_losses(dconv_step)


def test_dconv_train_gradients_match_jax(dconv_step):
    """Every trainable gradient, each deformable kernel's and offset conv's
    among them (finite and nonzero)."""
    check_fpn_gradients(dconv_step)
    offsets = {n: g for n, g in dconv_step["t_grads"].items() if ".conv_offset." in n}
    assert len(offsets) == 2 * 13
    assert all(np.isfinite(g).all() and np.abs(g).max() > 0 for g in offsets.values())


def test_dconv_train_step_matches_jax_update(dconv_step):
    check_update(dconv_step)


@pytest.fixture(scope="module")
def remat_step():
    with real_offsets():
        return train_pair(*yaml_cfgs(DCONV_YAML, **TRAIN, **{"MODEL.RESNETS.REMAT": True}))


def test_remat_gradients_match_jax_remat(remat_step):
    """REMAT on both sides: the JAX ``nn.remat`` blocks and the port's
    checkpointed ones give the same losses and gradients."""
    assert isinstance(remat_step["tmodel"].backbone.bottom_up.res3, RematStage)
    check_losses(remat_step)
    check_fpn_gradients(remat_step)


def port_grads(tcfg, variables, tbatch, noise, j_raw):
    """The port's losses and gradients of one step from ``variables``."""
    model = build_model(tcfg, device="cpu", state_dict=convert_variables(variables),
                        training=True)
    with jax_proposals(model, j_raw):
        losses = model.losses(tbatch, noise=noise)
    sum(losses.values()).backward()
    return ({k: v.detach() for k, v in losses.items()},
            {n: p.grad for n, p in model.named_parameters() if p.grad is not None})


def test_remat_gradients_equal_no_remat_bit_for_bit(dconv_step):
    """The same weights, batch, noise and proposals with REMAT on and off: the
    recomputation repeats the forward exactly on the CPU."""
    run = dconv_step
    tcfg = run["tcfg"].clone()
    tcfg.MODEL.RESNETS.REMAT = True
    args = (run["variables"], run["tbatch"], run["noise"], run["j_raw"])
    on_l, on_g = port_grads(tcfg, *args)
    off_l, off_g = port_grads(run["tcfg"], *args)
    assert set(on_g) == set(off_g) and len(on_g) > 100
    for k in off_l:
        assert torch.equal(on_l[k], off_l[k]), k
    for n in off_g:
        assert torch.equal(on_g[n], off_g[n]), n


def test_remat_stages_follow_freeze_at():
    """Only the stages after ``FREEZE_AT`` recompute (the JAX rule); the
    parameter names do not change."""
    _, tcfg = yaml_cfgs(DCONV_YAML, **FPN, **{"MODEL.RESNETS.REMAT": True,
                                               "MODEL.BACKBONE.FREEZE_AT": 3})
    _, plain = yaml_cfgs(DCONV_YAML, **FPN)
    with torch.device("meta"):
        model, ref = GeneralizedRCNN(tcfg), GeneralizedRCNN(plain)
    trunk = model.backbone.bottom_up
    assert [isinstance(getattr(trunk, s), RematStage) for s in trunk.stage_names] == [
        False, False, True, True]
    assert list(model.state_dict()) == list(ref.state_dict())


def test_remat_bn_updates_running_statistics_once():
    """A trainable BN inside a recomputed block updates its running statistics
    in the forward pass only: after a step's backward they equal those of
    the same step without REMAT, and so do the gradients."""
    def run(remat):
        _, tcfg = yaml_cfgs(DCONV_YAML, **TRAIN, **{"MODEL.RESNETS.NORM": "BN",
                                                    "MODEL.RESNETS.REMAT": remat,
                                                    "MODEL.BACKBONE.FREEZE_AT": 0})
        model = build_model(tcfg, device="cpu", training=True,
                            generator=torch.Generator().manual_seed(3))
        batch = {k: torch.from_numpy(v) for k, v in make_train_batch(tcfg, c4.H, c4.W).items()}
        losses = model.losses(batch, generator=torch.Generator().manual_seed(4))
        sum(losses.values()).backward()
        stats = {f"{n}.{b}": t.clone() for n, m in model.named_modules()
                 if isinstance(m, BatchNorm2d) for b, t in m.named_buffers()}
        return stats, {n: p.grad for n, p in model.named_parameters() if p.grad is not None}

    on_stats, on_grads = run(True)
    off_stats, off_grads = run(False)
    assert any(".res3." in n for n in on_stats) and len(on_stats) > 50
    for n, t in off_stats.items():
        assert torch.equal(on_stats[n], t), n
        if n.endswith("running_var"):
            assert not torch.equal(t, torch.ones_like(t)), n  # moved, once
    for n, g in off_grads.items():
        assert torch.equal(on_grads[n], g), n
