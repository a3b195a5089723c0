"""The port's pooler (storage, plan, plain ROI patch contraction) against the
JAX package: the Pallas ``roi_patch_interpolate`` in interpret mode and the
XLA ``pool_from_storage(use_pallas=False)``, float32.

Tolerance: the port and both JAX paths compute the same products; only the
summation order differs (float32 einsum/matmul orders), so pooled values
agree to 1e-5 absolute on O(1) features. The plan's integer parts (storage
rows, tx, tier class) must be equal, and skipped slots exact zeros.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.models import poolers as jp
from detectron2_tensorflow_tpu.ops.pallas.roi_patch import roi_patch_interpolate as pallas_roi
from detectron2_tensorflow_tpu_torch.models import poolers as tp

STRIDES = [4, 8, 16, 32]
ATOL = 1e-5


def _features(rng, b=2, h=64, w=96, c=16):
    return [rng.standard_normal((b, h // s * 4, w // s * 4, c)).astype(np.float32)
            for s in STRIDES]


def _boxes(rng, b, n, w=384, h=256):
    ctr = rng.uniform([20, 20], [w - 20, h - 20], (b, n, 2))
    size = np.exp(rng.uniform(np.log(4), np.log(300), (b, n, 1))) * rng.uniform(0.7, 1.4, (b, n, 2))
    boxes = np.concatenate([ctr - size / 2, ctr + size / 2], -1)
    return np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)


def _plans(feats, boxes, valid, out_size, max_image_size=1333):
    """(JAX storage/plan per image, stacked; port storage/plan, batched)."""
    p, tiers = jp.plan_patch(max_image_size, STRIDES[-1])
    assert tiers and tp.plan_patch(max_image_size, STRIDES[-1]) == p
    j_st, j_plan = [], []
    for i in range(boxes.shape[0]):
        st, meta = jp.build_storage([jnp.asarray(f[i]) for f in feats], STRIDES, p, tiers)
        j_st.append(st)
        j_plan.append(jp.plan_rois(meta, jnp.asarray(boxes[i]), out_size, 0, 224, 4,
                                   valid=None if valid is None else jnp.asarray(valid[i])))
    j_storage = jnp.stack(j_st)
    j_starts, j_wy, j_wx = (jnp.stack(x) for x in zip(*j_plan))
    t_storage, t_meta = tp.build_storage([torch.from_numpy(f) for f in feats], STRIDES, p)
    t_starts, t_wy, t_wx = tp.plan_rois(
        t_meta, torch.from_numpy(boxes), out_size, 0, 224, 4,
        valid=None if valid is None else torch.from_numpy(valid))
    return (j_storage, meta, j_starts, j_wy, j_wx), (t_storage, t_meta, t_starts, t_wy, t_wx)


@pytest.mark.parametrize("out_size", [7, 14])
def test_storage_and_plan_match_jax(out_size):
    rng = np.random.default_rng(out_size)
    feats = _features(rng)
    boxes = _boxes(rng, 2, 16)
    valid = rng.uniform(0, 1, (2, 16)) > 0.2
    (js, jmeta, jst, jwy, jwx), (ts, tmeta, tst, twy, twx) = _plans(feats, boxes, valid, out_size)
    assert tmeta.shapes == jmeta.shapes and tmeta.row_offsets == jmeta.row_offsets
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    np.testing.assert_allclose(twy.numpy(), np.asarray(jwy), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(twx.numpy(), np.asarray(jwx), rtol=1e-6, atol=1e-7)
    assert (tst[..., 2].numpy()[~valid] == tp.skip_tier_class(tmeta.patch_size)).all()


@pytest.mark.parametrize("out_size,n", [(7, 16), (14, 12)])
def test_plain_pool_matches_pallas_interpret(out_size, n):
    rng = np.random.default_rng(100 + out_size)
    feats = _features(rng)
    boxes = _boxes(rng, 2, n)
    valid = rng.uniform(0, 1, (2, n)) > 0.25
    (js, _, jst, jwy, jwx), (ts, _, tst, twy, twx) = _plans(feats, boxes, valid, out_size)
    want = np.asarray(pallas_roi(js, jst, jwy, jwx, interpret=True))
    got = tp.roi_patch_interpolate(ts, tst, twy, twx).numpy()
    assert got.shape == (2, n, out_size, out_size, 16)
    np.testing.assert_array_equal(got[~valid], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


@pytest.mark.parametrize("out_size", [7, 14])
def test_pool_from_storage_matches_xla_path(out_size):
    """The whole pool (plan + contraction) against the JAX XLA pooler, with
    invalid slots skipped to exact zeros on both sides."""
    rng = np.random.default_rng(200 + out_size)
    feats = _features(rng)
    boxes = _boxes(rng, 2, 16)
    valid = rng.uniform(0, 1, (2, 16)) > 0.3
    (js, jmeta, *_), (ts, tmeta, *_) = _plans(feats, boxes, None, out_size)
    want = np.asarray(jax.vmap(
        lambda st, b, v: jp.pool_from_storage(st, jmeta, b, out_size, 0, use_pallas=False, valid=v)
    )(js, jnp.asarray(boxes), jnp.asarray(valid)))
    got = tp.pool_from_storage(ts, tmeta, torch.from_numpy(boxes), out_size, 0,
                               valid=torch.from_numpy(valid)).numpy()
    np.testing.assert_array_equal(got[~valid], 0.0)
    np.testing.assert_array_equal(want[~valid], 0.0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


def test_oversize_boxes_route_to_the_averaged_alias():
    """Boxes too large for the patch at their level read the 2x/4x-averaged
    alias rows of the storage, exactly as the JAX plan routes them."""
    rng = np.random.default_rng(7)
    feats = _features(rng, h=128, w=192)
    boxes = np.array([[[0, 0, 760, 500], [10, 10, 700, 120], [5, 5, 40, 40]]] * 2, np.float32)
    (js, jmeta, jst, jwy, jwx), (ts, tmeta, tst, twy, twx) = _plans(feats, boxes, None, 7)
    np.testing.assert_array_equal(tst.numpy(), np.asarray(jst))
    alias_start = tmeta.row_offsets[len(STRIDES)]
    assert (tst[:, :2, 0].numpy() >= alias_start).all()
    got = tp.roi_patch_interpolate(ts, tst, twy, twx).numpy()
    want = np.asarray(pallas_roi(js, jst, jwy, jwx, interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL)


def test_assign_boxes_to_levels_matches_jax():
    rng = np.random.default_rng(9)
    boxes = _boxes(rng, 1, 200, w=1333, h=800)[0]
    want = np.asarray(jp.assign_boxes_to_levels(jnp.asarray(boxes), 2, 5))
    got = tp.assign_boxes_to_levels(torch.from_numpy(boxes), 2, 5).numpy()
    np.testing.assert_array_equal(got, want)


def test_avgpool_alias_matches_jax():
    rng = np.random.default_rng(4)
    f = rng.standard_normal((2, 13, 22, 8)).astype(np.float32)
    want = np.stack([np.asarray(jp._avgpool2x(jnp.asarray(x))) for x in f])
    got = tp._avgpool2x(torch.from_numpy(f)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_roi_patch_rejects_other_devices():
    st = torch.zeros((1, 40, 32, 4), device="meta")
    with pytest.raises(RuntimeError, match="no implementation"):
        tp.roi_patch_interpolate(st, torch.zeros((1, 1, 3), dtype=torch.int32, device="meta"),
                                 torch.zeros((1, 1, 7, 32), device="meta"),
                                 torch.zeros((1, 1, 7, 32), device="meta"))
