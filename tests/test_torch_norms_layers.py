"""Trainable BN (and SyncBN, the same layer on one card), precise BN and the
conv+norm ROI heads: the port against the JAX package. This file holds the
layers, heads, blocks, precise BN and checkpoints, and the shared helpers;
``test_torch_norms_syncbn.py`` and ``test_torch_norms_gn.py`` hold the two
models' predict and train step (the files split so that each runs on its
own worker).

Configurations: ``configs/Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml`` and
``configs/Misc/mask_rcnn_R_50_FPN_3x_gn.yaml`` (R50 with ``STRIDE_IN_1X1
False``, BN or GN in the trunk, the FPN, the 4-conv box head and the mask
head) at ``NORM_NARROW`` widths (multiples of 32, which GN's groups divide),
float32, on 2 x 128 x 160 images. The same seeded numpy inputs and the same
weights (the JAX ones carried over by ``convert.py``) go through both
packages.

Tolerances. The BN layer: float32 outputs 1e-5 of the largest value, bf16
one bf16 ulp of each value plus that (each side rounds its float32 result
once); the running statistics 1e-6 relative (the same float32 sums in other
orders). Models: detections as ``test_torch_c4.py`` holds them (integers
equal, float32 1e-4); losses 1e-5 relative (the mask loss 3e-4);
gradients, one step's updates and the running statistics a step writes
1e-4 of each tensor's largest magnitude.

Which gradients the full step holds. Behind a normalized layer in training
mode a parameter's gradient is a small remainder of large terms (the norm's
backward takes the mean and the normalized input's component out of its
upstream gradient), so the ~1e-7 by which the two packages' activations
differ grows with every such layer it crosses. Measured on the narrow
steps: 1e-5 to 1.5e-4 of the largest value in the heads' normed convs, up
to 8e-4 in the FPN, and in the trunk more than the gradients' own size
(the port's own trunk gradients move that much when its images move by
1e-6 relative); the mask head's deconv, whose gradient sums the normed
convs' output against the mask loss's over 28 x 28 positions, cancels to
~2e-5 on the GN model and agrees to 5e-4 of that; and the RPN head's conv
reads the normalized FPN outputs, so some of its ReLU inputs sit within
the packages' float32 noise of 0 (on the GN model, init keys 1, 3, 4 and 5
each moved a slice of its gradient past the tolerance). So the full step
holds to 1e-4 the gradients and updates of the box head's FC and predictor
and the mask head's predictor (``HELD``), and every normed layer and the
deconv are held on their own,
on the same inputs and upstream gradient: the heads
(``test_normed_heads_match_jax``) and one BN and one GN bottleneck block
of the YAMLs' kind (``test_norm_bottleneck_block_matches_jax``). Precise BN: the JAX function
recovers each batch's moments as ``(new - 0.9 * old) / 0.1`` from float32
values, which cancels ~1e-6 of ``old`` away; the port reads them directly,
and both take ``E[x^2] - E[x]^2`` in float32, which cancels where a
channel's mean is large against its spread (measured: 1.7e-5 relative on a
stem-fed variance of 5e-7), so the two agree to ``PRECISE_RTOL`` = 5e-5 of
each statistic's largest magnitude.

The running statistics of a train step. The JAX ``StatsTape`` merges the
whole ``batch_stats`` collection that each ``train=True`` apply returns,
untouched layers included, so the last apply (the mask head's) writes the
old statistics of every other layer back: the JAX step moves only the mask
head's 8 of the SyncBN model's 138 statistics (measured; ROADMAP Queue 3,
found in the reference). The port moves each layer's own. The tests hold
them against each JAX apply's own updates (``per_apply_stats``).
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.engine.tta import precise_bn as jax_precise_bn
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.layers import BatchNorm as JaxBatchNorm
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts, _RCNNDrivers
from detectron2_tensorflow_tpu.models.roi_heads.heads import (
    FastRCNNConvFCHead as JaxBoxHead,
    MaskRCNNConvUpsampleHead as JaxMaskHead,
)
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import (
    CheckpointManager,
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.engine.tta import precise_bn
from detectron2_tensorflow_tpu_torch.engine.train import checkpoint_payload, restore_train_state
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.layers import BatchNorm2d, get_norm
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import GeneralizedRCNN
from detectron2_tensorflow_tpu_torch.models.roi_heads.heads import (
    FastRCNNConvFCHead,
    MaskRCNNConvUpsampleHead,
)
from test_torch_config import _set
from test_torch_slice import fused_switch
from test_torch_train import (
    GRAD_TOL,
    assert_grad_close,
)
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SYNCBN_YAML = "configs/Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml"
GN_YAML = "configs/Misc/mask_rcnn_R_50_FPN_3x_gn.yaml"
NORM_NARROW = {
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 32,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 128,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 32,
    "MODEL.NECK.OUT_CHANNELS": 32,
    "MODEL.ROI_BOX_HEAD.CONV_DIM": 32,
    "MODEL.ROI_BOX_HEAD.FC_DIM": 64,
    "MODEL.ROI_MASK_HEAD.CONV_DIM": 32,
    "MODEL.ROI_HEADS.NUM_CLASSES": 5,
    "MODEL.DTYPE": "float32",
}
B, H, W, G = 2, 128, 160, 5
SIZES = np.array([[128, 160], [112, 150]], np.int32)
RTOL, ATOL = 1e-4, 1e-4
PRECISE_RTOL = 5e-5
INIT_KEY = 2


def yaml_cfgs(path, **overrides):
    """(JAX cfg, port cfg): ``path``'s YAML at ``NORM_NARROW`` widths."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.merge_from_file(os.path.join(REPO, path))
        for key, value in {**NORM_NARROW, "INPUT.MAX_GT_INSTANCES": G,
                           "SOLVER.IMS_PER_BATCH": B, **overrides}.items():
            _set(cfg, key, value)
    return jcfg, tcfg


def tame_norm_variables(variables, seed=3):
    """numpy copy of the JAX variables with the stem's norm scale 1/640 and
    each bottleneck's last 0.2 (as ``tame_variables`` does to FrozenBN), and
    BN running statistics drawn away from (0, 1) so serving reads them."""
    v = jax.tree_util.tree_map(lambda x: np.array(np.asarray(x)), variables)
    trunk = v["params"]["backbone"]
    norm = next(iter(trunk["stem"]["conv1"]))  # BatchNorm_0 or GroupNorm_0
    trunk["stem"]["conv1"][norm][norm]["scale"][:] = 1.0 / 640
    for stage, blocks in trunk.items():
        if stage.startswith("res"):
            for block in blocks.values():
                block["conv3"][norm][norm]["scale"][:] = 0.2
    rng = np.random.default_rng(seed)

    def draw(path, x):
        leaf = path[-1].key
        if leaf == "mean":
            return (rng.normal(0, 0.05, x.shape)).astype(np.float32)
        return rng.uniform(0.8, 1.25, x.shape).astype(np.float32)

    if "batch_stats" in v:
        v["batch_stats"] = jax.tree_util.tree_map_with_path(draw, v["batch_stats"])
    return v


def images(seed=0):
    img = np.random.default_rng(seed).uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    return ({"image": jnp.asarray(img), "image_size": jnp.asarray(SIZES)},
            {"image": torch.from_numpy(img), "image_size": torch.from_numpy(SIZES)})


def port_stats(model):
    """The port's running statistics named as ``convert.py`` names the JAX
    ``batch_stats``."""
    return {k: v.numpy().copy() for k, v in model.state_dict().items() if ".running_" in k}


def jax_stats(variables, batch_stats=None):
    """The running statistics of JAX ``variables`` (or ``batch_stats`` in
    their place) under the port's names."""
    stats = variables["batch_stats"] if batch_stats is None else batch_stats
    sd = convert_variables({"params": variables["params"], "batch_stats": stats})
    return {k: v.numpy() for k, v in sd.items() if ".running_" in k}


def assert_close_to_max(got, want, tol, name):
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * float(np.abs(want).max()),
                               err_msg=name)


# -- the BN layer -----------------------------------------------------------------

def _bn_case(dtype, c=16):
    rng = np.random.default_rng(4)
    x = (rng.standard_normal((4, 6, 5, c)) * 3 + 1).astype(np.float32)
    params = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
              "bias": rng.normal(0, 0.3, c).astype(np.float32)}
    stats = {"mean": rng.normal(0, 1, c).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}
    jvars = {"params": {"BatchNorm_0": params}, "batch_stats": {"BatchNorm_0": stats}}
    bn = BatchNorm2d(c)
    bn.load_state_dict({"weight": torch.from_numpy(params["scale"]),
                        "bias": torch.from_numpy(params["bias"]),
                        "running_mean": torch.from_numpy(stats["mean"]),
                        "running_var": torch.from_numpy(stats["var"])})
    tx = torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2)
    return x, jvars, bn, tx


@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_batch_norm_matches_flax(dtype, train):
    """Outputs, and in training the biased batch variance, the 0.9 momentum
    and the running statistics, against the JAX ``BatchNorm`` (flax
    ``nn.BatchNorm``)."""
    x, jvars, bn, tx = _bn_case(dtype)
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    mod = JaxBatchNorm(16, dtype=jdtype)
    jx = jnp.asarray(x).astype(jdtype)
    if train:
        jout, upd = mod.apply(jvars, jx, train=True, mutable=["batch_stats"])
    else:
        jout, upd = mod.apply(jvars, jx, train=False), None
    bn.train(train)
    out = bn(tx)
    assert out.dtype == dtype
    got = out.float().permute(0, 2, 3, 1).detach().numpy()
    want = np.asarray(jout.astype(jnp.float32))
    slack = 1e-5 * np.abs(want).max()
    if dtype == torch.bfloat16:
        slack = slack + np.exp2(np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert (np.abs(got - want) <= slack).all()
    if not train:
        return
    xq = np.asarray(jx.astype(jnp.float32), np.float64)
    for leaf, buf, batch in (("mean", bn.running_mean, xq.mean(axis=(0, 1, 2))),
                             ("var", bn.running_var, xq.var(axis=(0, 1, 2)))):
        want = np.asarray(upd["batch_stats"]["BatchNorm_0"][leaf])
        np.testing.assert_allclose(buf.numpy(), want, rtol=1e-6, atol=1e-7, err_msg=leaf)
        old = jvars["batch_stats"]["BatchNorm_0"][leaf]
        np.testing.assert_allclose(buf.numpy(), 0.9 * old + 0.1 * batch, rtol=1e-6, err_msg=leaf)
    unbiased = 0.9 * jvars["batch_stats"]["BatchNorm_0"]["var"] + 0.1 * xq.var(
        axis=(0, 1, 2), ddof=1)
    assert not np.allclose(bn.running_var.numpy(), unbiased, rtol=1e-4)


def test_batch_norm_gradients_match_flax():
    """Gradients through the batch moments (input, scale, bias)."""
    x, jvars, bn, tx = _bn_case(torch.float32)
    g = np.random.default_rng(5).standard_normal(x.shape).astype(np.float32)
    mod = JaxBatchNorm(16)

    def f(params, xin):
        out, _ = mod.apply({**jvars, "params": params}, xin, train=True,
                           mutable=["batch_stats"])
        return jnp.sum(out * jnp.asarray(g))

    jg_params, jg_x = jax.grad(f, argnums=(0, 1))(jvars["params"], jnp.asarray(x))
    tx = tx.detach().requires_grad_(True)
    bn.train(True)
    (bn(tx) * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    assert_grad_close(tx.grad.permute(0, 2, 3, 1).numpy(), np.asarray(jg_x), "x")
    assert_grad_close(bn.weight.grad.numpy(), np.asarray(jg_params["BatchNorm_0"]["scale"]),
                      "scale")
    assert_grad_close(bn.bias.grad.numpy(), np.asarray(jg_params["BatchNorm_0"]["bias"]), "bias")


def test_sync_bn_is_bn():
    """SyncBN builds the BN layer (one card), and a SyncBN model equals the
    same model with BN, tensor for tensor."""
    assert type(get_norm("SyncBN", 8)) is type(get_norm("BN", 8)) is BatchNorm2d
    _, sync = yaml_cfgs(SYNCBN_YAML)
    _, plain = yaml_cfgs(SYNCBN_YAML, **{k: "BN" for k in (
        "MODEL.RESNETS.NORM", "MODEL.NECK.NORM", "MODEL.ROI_BOX_HEAD.NORM",
        "MODEL.ROI_MASK_HEAD.NORM")})
    a, b = GeneralizedRCNN(sync), GeneralizedRCNN(plain)
    b.load_state_dict(a.state_dict())
    batch = images()[1]
    torch.testing.assert_close(a.predict(batch).boxes, b.predict(batch).boxes, rtol=0, atol=0)
    assert sum(isinstance(m, BatchNorm2d) for m in a.modules()) > 60


# -- the conv+norm heads --------------------------------------------------------------

def _head_pair(kind, norm):
    rng = np.random.default_rng(6)
    if kind == "box":
        jmod = JaxBoxHead(num_conv=4, conv_dim=32, num_fc=1, fc_dim=64, norm=norm)
        port = FastRCNNConvFCHead(16, 7, 4, 32, 1, 64, norm)
        x = rng.standard_normal((10, 7, 7, 16)).astype(np.float32)
        prefix, top = "roi_heads.box_head.", "box_heads_0"
    else:
        jmod = JaxMaskHead(num_classes=5, num_conv=4, conv_dim=32, norm=norm)
        port = MaskRCNNConvUpsampleHead(16, 5, 4, 32, norm, False)
        x = rng.standard_normal((10, 14, 14, 16)).astype(np.float32)
        prefix, top = "roi_heads.mask_head.", "mask_head"
    x[-3:] = 0.0  # padded slots pool zeros, and enter BN's moments
    variables = jax.tree_util.tree_map(np.asarray, jmod.init(jax.random.PRNGKey(2),
                                                             jnp.asarray(x)))
    if "batch_stats" in variables:
        variables = dict(variables, batch_stats=jax.tree_util.tree_map(
            lambda s: (s + rng.uniform(0.1, 0.5, s.shape)).astype(np.float32),
            variables["batch_stats"]))
    tree = {col: {top: variables[col]} for col in variables}
    sd = {k[len(prefix):]: v for k, v in convert_variables(tree).items()}
    port.load_state_dict(sd)
    return jmod, port, variables, x, prefix, top


@pytest.mark.parametrize("norm", ["GN", "BN"])
@pytest.mark.parametrize("kind", ["box", "mask"])
def test_normed_heads_match_jax(kind, norm):
    """The conv+norm box head (4 convs, 1 FC) and the normed mask head:
    training outputs, parameter gradients and (BN) the running statistics
    over every slot, padded ones included; serving outputs."""
    jmod, port, variables, x, prefix, top = _head_pair(kind, norm)
    g = np.random.default_rng(7).standard_normal(
        jmod.apply(variables, jnp.asarray(x)).shape).astype(np.float32)
    mutable = ["batch_stats"] if norm == "BN" else []

    def f(params):
        out, upd = jmod.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                              mutable=mutable)
        return jnp.sum(out * jnp.asarray(g)), (out, upd)

    (_, (jout, upd)), jgrad = jax.value_and_grad(f, has_aux=True)(variables["params"])
    port.train(True)
    out = port(torch.from_numpy(x))
    (out * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), rtol=RTOL, atol=ATOL)
    want = convert_variables({"params": {top: jax.tree_util.tree_map(np.asarray, jgrad)}})
    for name, p in port.named_parameters():
        assert_grad_close(p.grad.numpy(), want[prefix + name].numpy(), name)
    if norm == "BN":
        got = {prefix + k: v for k, v in port_stats(port).items()}
        want_stats = jax_stats({"params": {top: variables["params"]}},
                               {top: upd["batch_stats"]})
        assert set(got) == set(want_stats) and len(got) == 8
        for name, w in want_stats.items():
            assert_close_to_max(got[name], w, GRAD_TOL, name)
        port.load_state_dict({k[len(prefix):]: v for k, v in convert_variables(
            {col: {top: variables[col]} for col in variables}).items()})
    port.train(False)
    with torch.no_grad():
        served = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(served, np.asarray(jmod.apply(variables, jnp.asarray(x))),
                               rtol=RTOL, atol=ATOL)


def test_normed_convs_have_no_bias():
    """A conv with a norm has no bias (JAX ``layers.py``: no norm => bias)."""
    head = FastRCNNConvFCHead(16, 7, 4, 32, 1, 64, "BN")
    assert head.conv1.bias is None and head.fc1.bias is not None
    assert {k for k in head.state_dict() if k.startswith("conv1.")} == {
        "conv1.weight", "conv1.norm.weight", "conv1.norm.bias", "conv1.norm.running_mean",
        "conv1.norm.running_var"}


# -- one bottleneck block, the trunks ----------------------------------------------------

@pytest.mark.parametrize("norm", ["BN", "GN"])
def test_norm_bottleneck_block_matches_jax(norm):
    """One bottleneck block as the YAMLs build res3's first (``STRIDE_IN_1X1
    False``: the stride in the 3x3; a projection shortcut) in training mode:
    output, parameter gradients under one upstream gradient and (BN) the
    running statistics, against the JAX block on the same input."""
    from detectron2_tensorflow_tpu.models.backbones.resnet import BottleneckBlock as JaxBlock
    from detectron2_tensorflow_tpu_torch.models.backbones.resnet import BottleneckBlock

    rng = np.random.default_rng(11)
    x = np.maximum(rng.standard_normal((2, 16, 20, 64)), 0).astype(np.float32)
    jblock = JaxBlock(out_channels=128, bottleneck_channels=32, stride=2, stride_in_1x1=False,
                      norm=norm, has_shortcut=True)
    variables = jax.tree_util.tree_map(np.asarray, jblock.init(jax.random.PRNGKey(3),
                                                               jnp.asarray(x)))
    g = rng.standard_normal((2, 8, 10, 128)).astype(np.float32)
    mutable = ["batch_stats"] if norm == "BN" else []

    def f(params):
        out, upd = jblock.apply({**variables, "params": params}, jnp.asarray(x), train=True,
                                mutable=mutable)
        return jnp.sum(out * jnp.asarray(g)), (out, upd)

    (_, (jout, upd)), jgrad = jax.value_and_grad(f, has_aux=True)(variables["params"])
    block = BottleneckBlock(64, 128, 32, 2, 1, False, norm, has_shortcut=True)
    prefix = "backbone.bottom_up.res3.0."
    trunk_tree = {col: {"res3": {"0": variables[col]}} for col in variables}
    tree = {col: {"backbone": t, "neck": {}} for col, t in trunk_tree.items()}
    block.load_state_dict({k[len(prefix):]: v for k, v in convert_variables(tree).items()})
    assert block.conv2.stride == (2, 2) and block.conv1.stride == (1, 1)
    block.train(True)
    out = block(torch.from_numpy(x).permute(0, 3, 1, 2))
    (out * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    np.testing.assert_allclose(out.detach().permute(0, 2, 3, 1).numpy(), np.asarray(jout),
                               rtol=RTOL, atol=ATOL)
    want = convert_variables({"params": {"backbone": {"res3": {"0": jax.tree_util.tree_map(
        np.asarray, jgrad)}}, "neck": {}}})
    for name, p in block.named_parameters():
        assert_grad_close(p.grad.numpy(), want[prefix + name].numpy(), name)
    if norm == "BN":
        got = port_stats(block)
        want_stats = jax_stats({"params": {"backbone": {"res3": {"0": variables["params"]}},
                                           "neck": {}}},
                               {"backbone": {"res3": {"0": upd["batch_stats"]}}})
        assert len(got) == 8
        for name, w in want_stats.items():
            assert_close_to_max(got[name[len(prefix):]], w, GRAD_TOL, name)


def test_norm_trunks_take_no_fused_tail():
    """Only FrozenBN 1x1 tails take the fused kernel: 0 on a BN or GN trunk
    with the switch on."""
    for path in (SYNCBN_YAML, GN_YAML):
        _, tcfg = yaml_cfgs(path)
        with fused_switch(True), torch.device("meta"):
            model = GeneralizedRCNN(tcfg)
        assert sum(bool(getattr(m, "fuse_residual", False)) for m in model.modules()) == 0


# -- precise BN -----------------------------------------------------------------------------

def test_precise_bn_recovers_true_moments():
    """The port of the JAX package's own check: precise BN writes the true
    batch-moment averages, not EMA-blended statistics; and both packages
    agree on them."""
    import flax.linen as nn

    class Net(nn.Module):
        @nn.compact
        def __call__(self, x, train=False):
            return nn.BatchNorm(use_running_average=not train, momentum=0.9)(x)

    mod = Net()
    variables = mod.init(jax.random.PRNGKey(0), jnp.zeros((4, 8, 8, 3)), train=True)
    variables = dict(variables, batch_stats=jax.tree_util.tree_map(
        lambda v: v + 100.0, variables["batch_stats"]))
    rng = np.random.default_rng(1)
    data = [rng.normal(5.0, 2.0, (4, 8, 8, 3)).astype(np.float32) for _ in range(4)]
    jout = jax_precise_bn(types.SimpleNamespace(module=mod), variables,
                          ({"image": jnp.asarray(d)} for d in data), num_iters=4)

    bn = BatchNorm2d(3).eval()
    with torch.no_grad():
        bn.running_mean += 100.0
        bn.running_var += 100.0
    model = types.SimpleNamespace(backbone=bn,
                                  features=lambda im: bn(im.permute(0, 3, 1, 2)))
    assert precise_bn(model, iter([{"image": d} for d in data] * 2), 4) == 4
    want_mean = np.mean([d.mean(axis=(0, 1, 2)) for d in data], axis=0)
    want_var = np.mean([d.var(axis=(0, 1, 2)) for d in data], axis=0)
    np.testing.assert_allclose(bn.running_mean.numpy(), want_mean, rtol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), want_var, rtol=1e-5)
    for leaf, buf in (("mean", bn.running_mean), ("var", bn.running_var)):
        want = np.asarray(jout["batch_stats"]["BatchNorm_0"][leaf])
        assert_close_to_max(buf.numpy(), want, 1e-4, leaf)  # JAX: (new - 0.9 old) / 0.1
    assert not bn.training  # the mode it had


def test_precise_bn_matches_jax_on_the_syncbn_model():
    """``precise_bn`` over 3 batches of the narrow SyncBN model: every trunk
    and FPN statistic against the JAX ``precise_bn`` given the same
    normalized images (the JAX function feeds ``compute_features`` raw
    pixels, which the port does not copy); the ROI heads' and every
    parameter stay as they were."""
    jcfg, tcfg = yaml_cfgs(SYNCBN_YAML)
    batch, _ = images()
    jmodel = jax_build_model(jcfg)
    variables = tame_norm_variables(jax.jit(jmodel.init)(jax.random.PRNGKey(1), batch))
    raw = [np.random.default_rng(10 + i).uniform(0, 255, (B, H, W, 3)).astype(np.float32)
           for i in range(3)]
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    prepped = [{"image": drv.prep({"image": jnp.asarray(r)})} for r in raw]
    jout = jax_precise_bn(jmodel, variables, iter(prepped), num_iters=3)
    want = jax_stats(jout)
    model = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert precise_bn(model, iter([{"image": r} for r in raw]), 3) == 3
    got = port_stats(model)
    moved = 0
    for name, w in want.items():
        if name.startswith("roi_heads."):
            np.testing.assert_array_equal(got[name], before[name].numpy(), err_msg=name)
            continue
        assert_close_to_max(got[name], w, PRECISE_RTOL, name)
        moved += int(not np.array_equal(got[name], before[name].numpy()))
    assert moved > 60
    for name, p in model.named_parameters():
        assert torch.equal(p, before[name]), name


# -- checkpoints ----------------------------------------------------------------------------

def test_bn_buffers_resume_bit_equal(tmp_path):
    """A checkpoint holds the BN buffers: a run resumed from step 1 equals the
    uninterrupted run bit for bit after step 2, buffers included."""
    _, tcfg = yaml_cfgs(SYNCBN_YAML, **{"MODEL.RESNETS.DEPTH": 18,
                                        "MODEL.RESNETS.RES2_OUT_CHANNELS": 128})
    nb = make_train_batch(tcfg, 64, 96)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    torch.use_deterministic_algorithms(True)
    try:
        def fresh():
            model = build_model(tcfg, device="cpu", training=True, init="jax",
                                generator=torch.Generator().manual_seed(0))
            return create_train_state(tcfg, model, torch.Generator().manual_seed(0))

        a = fresh()
        step_a = build_train_step(tcfg, a)
        step_a(batch)
        manager = CheckpointManager(str(tmp_path), save_interval_steps=1, max_to_keep=2,
                                    keep_period=1000)
        manager.save(1, checkpoint_payload(a))
        step_a(batch)
        b = fresh()
        restore_train_state(b, manager.restore(1))
        build_train_step(tcfg, b)(batch)
    finally:
        torch.use_deterministic_algorithms(False)
    sa, sb = a.model.state_dict(), b.model.state_dict()
    assert any(".running_var" in k for k in sa)
    for k in sa:
        assert torch.equal(sa[k], sb[k]), k
