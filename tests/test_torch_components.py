"""The port's building blocks against their JAX counterparts: box math,
box decoding, anchors, top-k (tie order included), preprocessing, the R50
trunk, the FPN and the mask head's deconv, with JAX weights carried over by
``convert.py``.

Elementwise float32 math uses the same operations in the same order as the
JAX package and is compared exactly; convolutions sum in another order (XLA
vs oneDNN), so trunk and FPN outputs are compared to 1e-4 relative.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.anchors import DefaultAnchorGenerator as JaxAnchors
from detectron2_tensorflow_tpu.models.box_regression import Box2BoxTransform as JaxB2B
from detectron2_tensorflow_tpu.models.layers import ConvTranspose2D as JaxDeconv
from detectron2_tensorflow_tpu.models.meta_arch.common import preprocess_images as jax_prep
from detectron2_tensorflow_tpu.ops import topk as jtopk
from detectron2_tensorflow_tpu.structures import boxes as jboxes
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.anchors import DefaultAnchorGenerator
from detectron2_tensorflow_tpu_torch.models.box_regression import Box2BoxTransform
from detectron2_tensorflow_tpu_torch.models.layers import ConvTranspose2d
from detectron2_tensorflow_tpu_torch.models.meta_arch.common import preprocess_images
from detectron2_tensorflow_tpu_torch.ops import topk
from detectron2_tensorflow_tpu_torch.structures import ImageList, Instances
from detectron2_tensorflow_tpu_torch.structures import boxes as tboxes
from test_torch_config import narrow_cfgs


def _boxes(rng, n, size=300.0):
    ctr = rng.uniform(0, size, (n, 2))
    wh = rng.uniform(-5, 80, (n, 2))  # a few degenerate boxes
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], 1).astype(np.float32)


def test_box_ops_match_jax_exactly():
    rng = np.random.default_rng(0)
    a, b = _boxes(rng, 50), _boxes(rng, 70)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    np.testing.assert_array_equal(tboxes.area(ta).numpy(), np.asarray(jboxes.area(a)))
    np.testing.assert_array_equal(tboxes.pairwise_iou(ta, tb).numpy(),
                                  np.asarray(jboxes.pairwise_iou(a, b)))
    size = np.array([[200, 250]], np.int32)
    np.testing.assert_array_equal(
        tboxes.clip(ta[None], torch.from_numpy(size)).numpy()[0],
        np.asarray(jboxes.clip(a, jnp.asarray(size[0]))))
    np.testing.assert_array_equal(tboxes.nonempty(ta).numpy(), np.asarray(jboxes.nonempty(a)))


@pytest.mark.parametrize("weights", [(1.0, 1.0, 1.0, 1.0), (10.0, 10.0, 5.0, 5.0)])
def test_box2box_matches_jax(weights):
    rng = np.random.default_rng(1)
    src = np.abs(_boxes(rng, 40)) + np.array([0, 0, 100, 100], np.float32)
    deltas = rng.normal(0, 3, (40, 12)).astype(np.float32)  # large dw hit the clamp
    j, t = JaxB2B(weights), Box2BoxTransform(weights)
    np.testing.assert_allclose(
        t.apply_deltas(torch.from_numpy(deltas), torch.from_numpy(src)).numpy(),
        np.asarray(j.apply_deltas(jnp.asarray(deltas), jnp.asarray(src))), rtol=1e-6)
    tgt = src + rng.normal(0, 5, src.shape).astype(np.float32)
    np.testing.assert_allclose(
        t.get_deltas(torch.from_numpy(src), torch.from_numpy(tgt)).numpy(),
        np.asarray(j.get_deltas(jnp.asarray(src), jnp.asarray(tgt))), rtol=1e-5, atol=1e-6)


def test_anchors_match_jax():
    sizes, ratios, strides = [[32], [64], [128], [256], [512]], [[0.5, 1.0, 2.0]], [4, 8, 16, 32, 64]
    grids = [(25, 34), (13, 17), (7, 9), (4, 5), (2, 3)]
    want = JaxAnchors(sizes, ratios, strides)(grids)
    got = DefaultAnchorGenerator(sizes, ratios, strides)(grids)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("k", [50, 600, 2000])
def test_spatial_top_k_matches_jax_with_ties(k):
    rng = np.random.default_rng(k)
    scores = rng.integers(0, 30, (2, 33, 41, 3)).astype(np.float32)  # many ties, odd dims
    tv, ti = topk.spatial_top_k(torch.from_numpy(scores), k)
    for i in range(2):
        jv, ji = jtopk.spatial_top_k(jnp.asarray(scores[i]), k)
        np.testing.assert_array_equal(ti[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))


@pytest.mark.parametrize("n,k", [(5000, 2000), (4003, 100), (64, 20)])
def test_flat_top_k_matches_jax_with_ties(n, k):
    rng = np.random.default_rng(n)
    scores = rng.integers(0, 40, (2, n)).astype(np.float32)
    tv, ti = topk.flat_top_k(torch.from_numpy(scores), k)
    for i in range(2):
        jv, ji = jtopk.flat_top_k(jnp.asarray(scores[i]), k)
        np.testing.assert_array_equal(ti[i].numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv[i].numpy(), np.asarray(jv))


def test_top_k_is_stable_like_lax():
    x = np.array([[3, 1, 3, 2, 3, 1]], np.float32)
    v, i = topk.top_k(torch.from_numpy(x), 4)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 4)
    np.testing.assert_array_equal(i.numpy(), np.asarray(ji))


def test_preprocess_matches_jax():
    rng = np.random.default_rng(2)
    img = rng.uniform(0, 255, (2, 8, 10, 3)).astype(np.float32)
    mean, std = [123.675, 116.28, 103.53], [58.4, 57.1, 57.4]
    for fmt in ("BGR", "RGB"):
        np.testing.assert_array_equal(
            preprocess_images(torch.from_numpy(img), mean, std, fmt).numpy(),
            np.asarray(jax_prep(jnp.asarray(img), mean, std, fmt)))


@pytest.fixture(scope="module")
def trunk_pair():
    jcfg, tcfg = narrow_cfgs()
    rng = np.random.default_rng(3)
    image = rng.uniform(0, 255, (2, 96, 128, 3)).astype(np.float32)
    batch = {"image": jnp.asarray(image), "image_size": jnp.asarray([[96, 128]] * 2)}
    jmodel = jax_build_model(jcfg)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(1), batch)
    variables = jax.tree_util.tree_map(np.array, variables)
    variables["frozen"]["backbone"]["stem"]["conv1"]["FrozenBatchNorm_0"]["scale"][:] = 0.05
    prep = jax_prep(batch["image"], jcfg.MODEL.PIXEL_MEAN, jcfg.MODEL.PIXEL_STD, "BGR")
    trunk = jmodel.module.apply(variables, prep, method=lambda m, x: m.backbone(x))
    pyramid = jmodel.module.apply(variables, prep, method="compute_features")
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    return image, trunk, pyramid, tmodel


def test_r50_trunk_matches_jax(trunk_pair):
    image, trunk, _, tmodel = trunk_pair
    x = preprocess_images(torch.from_numpy(image), tmodel.pixel_mean, tmodel.pixel_std, "BGR")
    with torch.no_grad():
        got = tmodel.backbone.bottom_up(x.permute(0, 3, 1, 2))
    assert list(got) == ["res2", "res3", "res4", "res5"]
    for name, v in got.items():
        want = np.asarray(trunk[name])
        scale = np.abs(want).max()
        np.testing.assert_allclose(v.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_fpn_matches_jax(trunk_pair):
    image, _, pyramid, tmodel = trunk_pair
    with torch.no_grad():
        got = tmodel.features(torch.from_numpy(image))
    assert list(got) == ["p2", "p3", "p4", "p5", "p6"]
    for name, v in got.items():
        want = np.asarray(pyramid[name])
        scale = np.abs(want).max()
        np.testing.assert_allclose(v.permute(0, 2, 3, 1).numpy(), want, rtol=1e-4,
                                   atol=1e-4 * scale, err_msg=name)


def test_deconv_conversion_matches_flax():
    """flax ConvTranspose (kernel applied as stored) vs ConvTranspose2d with
    the converted (flipped, [in, out, kh, kw]) kernel."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((3, 5, 6, 4)).astype(np.float32)
    mod = JaxDeconv(features=7)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x))
    variables = jax.tree_util.tree_map(
        lambda a: np.asarray(rng.standard_normal(a.shape), np.float32), variables)
    want = np.asarray(mod.apply(variables, jnp.asarray(x)))
    sd = convert_variables({"params": {"mask_head": {"deconv": variables["params"]}}})
    deconv = ConvTranspose2d(4, 7, kernel_size=2, stride=2)
    deconv.load_state_dict({k.split("deconv.")[1]: v for k, v in sd.items()})
    with torch.no_grad():
        got = deconv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_instances_and_image_list():
    inst = Instances(boxes=torch.zeros(2, 5, 4), is_valid=torch.tensor([[1, 1, 0, 0, 0]] * 2).bool())
    assert inst.num_valid().tolist() == [2, 2]
    assert "boxes" in inst and "scores" not in inst
    inst2 = inst.replace(scores=torch.ones(2, 5))
    assert set(inst2.get_fields()) == {"boxes", "is_valid", "scores"}
    g = Instances(a=torch.arange(4), is_valid=torch.ones(4, dtype=torch.bool)).gather(
        torch.tensor([3, 1]), valid=torch.tensor([True, False]))
    assert g.a.tolist() == [3, 1] and g.is_valid.tolist() == [True, False]
    il = ImageList.from_tensors([torch.ones(5, 7, 3), torch.ones(6, 4, 3)], size_divisibility=4)
    assert tuple(il.tensor.shape) == (2, 8, 8, 3) and il.image_sizes.tolist() == [[5, 7], [6, 4]]
    assert float(il.tensor[1, :, 4:].abs().sum()) == 0.0


def test_flax_dense_conversion_is_a_transpose():
    """fc layers: flax Dense ``x @ kernel`` equals torch ``linear`` with the
    converted weight (the box head flattens (h, w, c) on both sides)."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((5, 3, 3, 4)).astype(np.float32)
    dense = fnn.Dense(6)
    variables = dense.init(jax.random.PRNGKey(0), jnp.asarray(x.reshape(5, -1)))
    want = np.asarray(dense.apply(variables, jnp.asarray(x.reshape(5, -1))))
    sd = convert_variables({"params": {"box_heads_0": {"fc1": variables["params"]}}})
    w, b = sd["roi_heads.box_head.fc1.weight"], sd["roi_heads.box_head.fc1.bias"]
    got = torch.nn.functional.linear(torch.from_numpy(x).reshape(5, -1), w, b).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
