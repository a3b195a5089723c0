"""YOLOv4 serving (``SingleStageDetector`` with the CSP-DarkNet53 trunk, the
SPP/PAN neck, ``YOLOV4Head``, its decode and class-agnostic NMS) against the
JAX package.

``configs/COCO-Detection/yolov4_D_53_PAN_1x.yaml`` at narrow widths
(``YOLO_NARROW``: stem 8, res2 16, neck 32, head 32, 4 classes, float32) on
2 x 128 x 160 images. The same seeded numpy inputs and weights (the JAX
ones carried over by ``convert.py``) go through both packages; on the CPU
the port's NMS takes its plain version. Every norm's statistics and affine
are perturbed (``perturb_norms``: the trunk's FrozenBN, the neck's and the
head's BN running statistics and scales), so that no norm is the identity,
and the predictors' objectness and class kernels are scaled x10
(``spread``) so that the scores spread over (0, 1) rather than sitting
within float32 rounding of each other at the top-k and NMS. Tolerances:
each trunk, neck and head map and each decoded field 1e-4 of its largest
magnitude; valid slots, classes and NMS keep masks equal; boxes and scores
1e-4 relative; the activations a few float32 ulps.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.anchors import YOLOAnchorGenerator as JaxYOLOAnchors
from detectron2_tensorflow_tpu.models.backbones.darknet import (
    build_darknet_backbone as jax_build_darknet,
)
from detectron2_tensorflow_tpu.models.layers import get_activation
from detectron2_tensorflow_tpu.models.meta_arch.common import preprocess_images as jax_prep
from detectron2_tensorflow_tpu.models.meta_arch.single_stage import _build_backbone_neck
from detectron2_tensorflow_tpu.models.single_stage.yolov4 import YOLOv4 as JaxYOLOv4
from detectron2_tensorflow_tpu.ops.nms import nms as jax_nms
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.convert import _port_shapes, convert_variables
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.anchors import YOLOAnchorGenerator
from detectron2_tensorflow_tpu_torch.models.backbones.darknet import DarkNet53, output_shapes
from detectron2_tensorflow_tpu_torch.models.layers import ACTIVATIONS, softplus
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import meta_architecture
from detectron2_tensorflow_tpu_torch.models.necks.yolov4 import YOLOV4Neck
from detectron2_tensorflow_tpu_torch.ops import fused_residual
from detectron2_tensorflow_tpu_torch.ops.nms import nms
from detectron2_tensorflow_tpu_torch.ops.topk import top_k
from test_torch_c4 import jax_param_shapes
from test_torch_config import _set
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YOLO_YAML = "configs/COCO-Detection/yolov4_D_53_PAN_1x.yaml"
YOLO_YAMLS = ("configs/Base-YOLO.yaml", YOLO_YAML)
YOLO_NARROW = {
    "MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES": 4,
    "MODEL.NECK.OUT_CHANNELS": 32,
    "MODEL.YOLOV4.CONV_DIMS": 32,
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 8,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 16,
    "MODEL.DTYPE": "float32",
}
B, H, W = 2, 128, 160
SIZES = np.array([[128, 160], [112, 150]], np.int32)
TOL = 1e-4


def yolo_cfgs(path=YOLO_YAML, **overrides):
    """(JAX cfg, port cfg): ``path``'s YAML at ``YOLO_NARROW`` widths."""
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    jcfg.merge_from_file(os.path.join(REPO, path))
    tcfg.merge_from_file(os.path.join(REPO, path))
    for key, value in {**YOLO_NARROW, **overrides}.items():
        _set(jcfg, key, value)
        _set(tcfg, key, value)
    return jcfg, tcfg


def yolo_images(seed=0):
    img = np.random.default_rng(seed).uniform(0, 255, (B, H, W, 3)).astype(np.float32)
    return ({"image": jnp.asarray(img), "image_size": jnp.asarray(SIZES)},
            {"image": torch.from_numpy(img), "image_size": torch.from_numpy(SIZES)})


def perturb_norms(variables, seed=0):
    """numpy copy of ``variables`` with every norm's tensors drawn anew: means
    N(0, 0.1), variances and scales U(0.5, 1.5), biases N(0, 0.1); a DarkNet
    block's last FrozenBN scale x0.2 (the port's serving rule), so that the
    residual stream stays of order one through the trunk."""
    rng = np.random.default_rng(seed)

    def draw(path, x):
        keys = [getattr(p, "key", str(p)) for p in path]
        x = np.array(x)
        if not any(k.endswith("BatchNorm_0") for k in keys):
            return x
        leaf = keys[-1]
        if leaf in ("var", "scale"):
            x = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        else:
            x = rng.normal(0.0, 0.1, x.shape).astype(np.float32)
        if leaf == "scale" and keys[0] == "frozen" and "block_" in keys[-4] and keys[-3] == "conv2":
            x *= 0.2
        return x

    return jax.tree_util.tree_map_with_path(draw, variables)


def spread(variables, factor=10.0):
    """The predictors' objectness and class kernels (field ``j >= 4`` of each
    anchor's ``5 + K``) x ``factor``."""
    for name, pred in variables["params"]["head"].items():
        if name.startswith("pred"):
            kernel = pred["conv"]["kernel"]
            fields = kernel.shape[-1] // 3
            cols = np.arange(kernel.shape[-1]) % fields >= 4
            kernel[..., cols] *= factor
    return variables


def assert_rel_close(got, want, tol=TOL, name=""):
    """Within ``tol`` of ``want``'s largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * max(np.abs(want).max(), 1e-30),
                               err_msg=name)


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(x).transpose(0, 3, 1, 2)))


def nhwc(x):
    return x.permute(0, 2, 3, 1).detach().numpy()


@pytest.fixture(scope="module")
def yolo():
    """Both packages' narrow YOLOv4 on one batch, from the same perturbed
    weights: the JAX trunk's, neck's and head's maps, decode and predict."""
    jcfg, tcfg = yolo_cfgs()
    batch, tbatch = yolo_images()
    jmodel = jax_build_model(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(0), batch)
    variables = spread(perturb_norms(variables))
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    images = jax_prep(batch["image"], jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD,
                      jcfg.MODEL.INPUT_FORMAT)
    module = jmodel.module
    feats = module.apply(variables, images, method=lambda m, x: m.backbone(x, train=False))
    pyramid = module.apply(variables, feats, method=lambda m, f: m.neck(f, train=False))
    maps = module.apply(variables, pyramid, method=lambda m, f: m.head(f, train=False))
    _, _, neck_shapes, _ = _build_backbone_neck(jcfg)
    jdriver = JaxYOLOv4(jcfg, neck_shapes)
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.predict)(variables, batch))
    return dict(jcfg=jcfg, tcfg=tcfg, batch=batch, tbatch=tbatch, variables=variables,
                tmodel=tmodel, images=np.asarray(images),
                feats={k: np.asarray(v) for k, v in feats.items()},
                pyramid={k: np.asarray(v) for k, v in pyramid.items()},
                maps=[np.asarray(m) for m in maps], jdriver=jdriver, jout=jout,
                tout=tmodel.predict(tbatch))


# -- the activations ----------------------------------------------------------------------

@pytest.mark.parametrize("name", ["mish", "leaky_relu", "relu"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_activations_match_the_jax_lambdas(name, dtype):
    """On normals spread over [-30, 30] and the points where the formulas
    switch: float32 within 4 ulps of each value (``tanh``, ``exp`` and
    ``log1p`` round their own way in each library: mish reads 2.9 ulps at
    most), bf16 within two bf16 ulps (2^-6) of each value. In bf16 the
    libraries round differently: XLA rounds each step of mish to bf16 and
    multiplies by 0.1 rounded to bf16, PyTorch's ``leaky_relu`` multiplies
    in float32 and rounds once (1.5 and 1 bf16 ulps at most)."""
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(0, 6, 4000), np.linspace(-30, 30, 601),
                        [0.0, -0.0, 20.0, -20.0, 1e-30, -1e-30]]).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(get_activation(name)(jnp.asarray(x, jdt)), np.float32)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    got = ACTIVATIONS[name](tx)
    assert got.dtype == tx.dtype
    got = got.float().numpy()
    ulp = 2.0 ** -23 * 4 if dtype == "float32" else 2.0 ** -6
    tol = ulp * np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def test_softplus_is_flax_logaddexp():
    """The port's ``softplus`` is flax's formula, ``logaddexp(x, 0)``, within
    an ulp of flax's values (each library's ``log1p`` and ``exp`` round their
    own way; 114 of these 8004 values differ); ``F.softplus`` returns ``x``
    above 20, which in float32 is flax's value there too, and within an ulp
    of it below (module docstring of ``models/layers.py``)."""
    x = np.concatenate([np.linspace(-40, 40, 8001), [20.0, 20.5, 88.0]]).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    got = softplus(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=2.0 ** -22, atol=0)
    torch_sp = torch.nn.functional.softplus(torch.from_numpy(x)).numpy()
    above = x > 20
    np.testing.assert_array_equal(torch_sp[above], want[above])
    np.testing.assert_array_equal(got[above], want[above])
    np.testing.assert_allclose(torch_sp, want, rtol=2.0 ** -22, atol=0)


# -- trunk, neck, head, anchors -----------------------------------------------------------

def test_model_is_darknet_under_the_yolov4_neck(yolo):
    """The trunk's and the neck's shapes are the JAX builders'."""
    tmodel = yolo["tmodel"]
    assert isinstance(tmodel.backbone, YOLOV4Neck) and isinstance(tmodel.trunk, DarkNet53)
    assert tmodel.trunk.stage_names == ["res1", "res2", "res3", "res4", "res5"]
    assert not tmodel.mask_on and tmodel.yolo
    _, jtrunk = jax_build_darknet(yolo["jcfg"])
    assert output_shapes(yolo["tcfg"]) == {k: (s.channels, s.stride) for k, s in jtrunk.items()}
    _, _, jneck, _ = _build_backbone_neck(yolo["jcfg"])
    assert tmodel.feature_shapes == {k: (s.channels, s.stride) for k, s in jneck.items()}
    assert tmodel.feature_shapes == {"p3": (32, 8), "p4": (64, 16), "p5": (128, 32)}


@pytest.mark.parametrize("level", ["res3", "res4", "res5"])
def test_trunk_matches_jax(yolo, level):
    """The trunk's outputs on the same preprocessed images, with every
    FrozenBN perturbed: 1e-4 of each map's largest magnitude."""
    with torch.no_grad():
        got = yolo["tmodel"].trunk(nchw(yolo["images"]))
    assert sorted(got) == ["res3", "res4", "res5"]
    assert_rel_close(nhwc(got[level]), yolo["feats"][level], name=level)


@pytest.mark.parametrize("level", ["p3", "p4", "p5"])
def test_neck_matches_jax(yolo, level):
    """SPP and PAN on the JAX trunk's features, BN on its (perturbed)
    running statistics: 1e-4 of each map's largest magnitude."""
    with torch.no_grad():
        got = yolo["tmodel"].backbone.pyramid({k: nchw(v) for k, v in yolo["feats"].items()})
    assert_rel_close(nhwc(got[level]), yolo["pyramid"][level], name=level)


def test_head_maps_match_jax(yolo):
    """The head's raw maps ``A * (5 + K)`` = 27 channels on the JAX neck's
    outputs, channel for channel."""
    with torch.no_grad():
        got = yolo["tmodel"].head([nchw(yolo["pyramid"][f]) for f in ("p3", "p4", "p5")])
    for level, (g, w) in enumerate(zip(got, yolo["maps"])):
        assert w.shape[-1] == 3 * (5 + 4)
        assert_rel_close(nhwc(g), w, name=f"level {level}")


def test_decode_matches_jax(yolo):
    """``decode`` of the same float32 maps: boxes, objectness and class
    logits over the 3 x (16 x 20 + 8 x 10 + 4 x 5) candidates in the JAX
    package's flat order."""
    jb, jc, jk = (np.asarray(x) for x in yolo["jdriver"].decode(
        [jnp.asarray(m) for m in yolo["maps"]]))
    tb, tc, tk = yolo["tmodel"].yolov4.decode([nchw(m) for m in yolo["maps"]])
    assert jb.shape == (B, 3 * (320 + 80 + 20), 4)
    for name, g, w in (("boxes", tb, jb), ("objectness", tc, jc), ("classes", tk, jk)):
        assert_rel_close(g.numpy(), w, name=name)
    np.testing.assert_array_equal(tc.numpy(), jc)  # a permute and reshapes, no arithmetic


@pytest.mark.parametrize("grids", [[(2, 2)], [(76, 76), (38, 38), (19, 19)], [(4, 5), (2, 3)]])
def test_yolo_anchor_generator_matches_jax(grids):
    """``(w, h)`` pixel shapes per level at the cells' centres, equal."""
    sizes = [[[12, 16], [19, 36], [40, 28]], [[36, 75], [76, 55], [72, 146]],
             [[142, 110], [192, 243], [459, 410]]][:len(grids)]
    strides = [8, 16, 32][:len(grids)]
    want = JaxYOLOAnchors(sizes, strides)
    got = YOLOAnchorGenerator(sizes, strides)
    assert got.num_anchors_per_location == want.num_anchors_per_location
    for g, w in zip(got.cell_anchors, want.cell_anchors):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got(grids), want(grids)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    first = got(grids)[0][0].tolist()
    assert first == [4.0 - 6.0, 4.0 - 8.0, 4.0 + 6.0, 4.0 + 8.0]


# -- predict ------------------------------------------------------------------------------

def test_predict_matches_jax_slot_by_slot(yolo):
    """Valid slots and classes equal, boxes and scores 1e-4 relative; empty
    slots score 0 with class -1."""
    jout, tout = yolo["jout"], yolo["tout"]
    valid = tout.is_valid.numpy()
    np.testing.assert_array_equal(valid, jout.is_valid)
    assert valid.sum() >= 100
    np.testing.assert_array_equal(tout.pred_classes.numpy(), jout.pred_classes)
    np.testing.assert_allclose(tout.boxes.numpy(), jout.boxes, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tout.scores.numpy(), jout.scores, rtol=TOL, atol=1e-6)
    assert tout.boxes.shape == (B, 100, 4)
    assert (tout.scores.numpy()[~valid] == 0).all() and (tout.pred_classes.numpy()[~valid] == -1).all()
    bx = tout.boxes.numpy()
    assert (bx >= 0).all() and (bx[..., 2] <= SIZES[:, None, 1]).all()
    assert (bx[..., 3] <= SIZES[:, None, 0]).all()


def test_nms_keeps_match_jax(yolo):
    """The class-agnostic NMS's keep mask over the JAX package's top 1000
    candidates (clipped, presorted, IoU 0.5, ``max_keep`` 100), equal up to
    the 100th survivor, past which neither package's ``nms_fixed`` reads it
    (the JAX sweep skips its later stages once 100 survive)."""
    jdriver = yolo["jdriver"]
    boxes, conf, cls = jdriver.decode([jnp.asarray(m) for m in yolo["maps"]])
    score = np.array(jnp.max(jax.nn.sigmoid(conf)[..., None] * jax.nn.sigmoid(cls), -1))
    top, idx = top_k(torch.from_numpy(score), 1000)
    cand = np.take_along_axis(np.asarray(boxes), idx.numpy()[..., None], 1)
    cand = np.clip(cand, 0, np.stack([SIZES[:, 1], SIZES[:, 0]] * 2, -1)[:, None])
    valid = top.numpy() > 0.05
    _, got, _ = nms(torch.from_numpy(cand), top, 0.5, torch.from_numpy(valid), max_keep=100,
                    presorted=True)
    for i in range(B):
        _, want, _ = jax_nms(jnp.asarray(cand[i]), jnp.asarray(top.numpy()[i]), 0.5,
                             jnp.asarray(valid[i]), max_keep=100, presorted=True)
        want = np.asarray(want)
        want = want & (np.cumsum(want) <= 100)
        np.testing.assert_array_equal(got[i].numpy(), want)
        assert int(want.sum()) == 100 and int(np.flatnonzero(want)[-1]) < 999


def test_fused_switch_fuses_no_darknet_tail(monkeypatch):
    """With ``D2TPU_ENABLE_FUSED_EPILOGUE`` set, a YOLOv4 model builds no
    fused tail: a DarkNet block ends in a 3x3 conv, its norm and mish."""
    monkeypatch.setenv(fused_residual.ENV_SWITCH, "1")
    _, tcfg = yolo_cfgs()
    with torch.device("meta"):
        model = meta_architecture(tcfg)(tcfg)
    assert sum(bool(getattr(m, "fuse_residual", False)) for m in model.modules()) == 0


# -- the YAMLs, the options the trunk does not read ---------------------------------------

@pytest.mark.parametrize("path", YOLO_YAMLS)
def test_yolo_yaml_builds_the_jax_tree(path):
    """Each YOLO YAML builds (narrow) with the JAX model's tensors, name for
    name and shape for shape: the trunk's FrozenBN buffers, the neck's and
    head's BN parameters and running statistics."""
    jcfg, tcfg = yolo_cfgs(path)
    want = {k: tuple(v.shape) for k, v in convert_variables(jax_param_shapes(jcfg)).items()}
    assert _port_shapes(tcfg) == want
    assert "backbone.spp_conv1.norm.running_var" in want
    assert "backbone.bottom_up.res5.block_4.conv2.norm.running_mean" in want
    assert "head.pred3.bias" in want


@pytest.mark.parametrize("opts,match", [
    (["MODEL.RESNETS.REMAT", True], "REMAT"),
    (["MODEL.RESNETS.DEFORM_ON_PER_STAGE", [False, True, True, True]], "DEFORM_ON_PER_STAGE"),
    (["MODEL.RESNETS.RES5_DILATION", 2], "RES5_DILATION"),
    (["MODEL.RESNETS.STEM_SPACE_TO_DEPTH", True], "STEM_SPACE_TO_DEPTH"),
    (["MODEL.RESNETS.NORM", "SpecialBN"], "SpecialBN"),
    (["MODEL.RESNETS.ACTIVATION", "gelu"], "gelu"),
])
def test_darknet_raises_on_what_it_does_not_read(opts, match):
    _, tcfg = yolo_cfgs(**{opts[0]: opts[1]})
    with pytest.raises(NotImplementedError, match=match), torch.device("meta"):
        meta_architecture(tcfg)(tcfg)


# -- the numpy oracles ------------------------------------------------------------------

def test_port_passes_the_yolov4_pipeline_oracle():
    """``tests/test_pipeline_oracle.py``'s YOLOv4 oracle (grid decode, the
    sigmoid product, the top 1000, clip, one class-agnostic greedy NMS, in
    numpy on the JAX head's maps; its config from this repo's YAML) holds
    the port's ``predict``."""
    from test_torch_c4 import repo_configs
    from test_torch_gn import port_in
    from tests import test_pipeline_oracle as oracle

    with repo_configs(), port_in(oracle):
        oracle.test_yolov4_inference_matches_numpy_oracle()


class PortDarkNet:
    """Stands in for the JAX DarkNet module in ``tests/test_trunk_oracle.py``:
    ``init`` is the JAX module's, ``apply`` runs the port's trunk (its
    config carried over, BN on the running statistics) on the converted
    variables, NHWC in and out."""

    def __init__(self, jcfg, jmodule):
        self.jcfg, self.jmodule = jcfg, jmodule

    def init(self, *args, **kwargs):
        return self.jmodule.init(*args, **kwargs)

    def apply(self, variables, x, train=False):
        from test_torch_gn import port_cfg_from

        from detectron2_tensorflow_tpu_torch.models.backbones.darknet import (
            build_darknet_backbone as build_port_darknet,
        )

        assert not train
        sd = convert_variables({k: {"backbone": jax.tree_util.tree_map(np.asarray, v)}
                                for k, v in variables.items()})
        trunk = build_port_darknet(port_cfg_from(self.jcfg)).eval()
        trunk.load_state_dict({k[len("backbone."):]: v for k, v in sd.items()})
        with torch.no_grad():
            out = trunk(nchw(x))
        return {k: nhwc(v) for k, v in out.items()}


def test_port_darknet_passes_the_numpy_trunk_oracle(monkeypatch):
    """``tests/test_trunk_oracle.py``'s CSP-DarkNet53 oracle (stem, five CSP
    stages of BN and mish on perturbed running statistics, in float64
    numpy from the weights) holds the port's trunk: the JAX constructor it
    imports is swapped for one whose module applies the port, and its
    ``jax.jit`` leaves that apply unjitted."""
    import types

    from detectron2_tensorflow_tpu.models.backbones import darknet as jax_darknet
    from tests import test_trunk_oracle as oracle

    def build(cfg, dtype=jnp.float32):
        module, shapes = jax_build_darknet(cfg, dtype=dtype)
        return PortDarkNet(cfg, module), shapes

    fake_jax = types.SimpleNamespace(**{k: getattr(jax, k) for k in dir(jax)
                                        if not k.startswith("__")})
    fake_jax.jit = lambda fn, **kwargs: fn
    monkeypatch.setattr(jax_darknet, "build_darknet_backbone", build)
    monkeypatch.setattr(oracle, "jax", fake_jax)
    oracle.test_csp_darknet_trunk_matches_numpy_oracle()
