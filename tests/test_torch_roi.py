"""The port's pooler (storage, plan, plain ROI patch contraction and its
gradient) against the JAX package: the Pallas ``roi_patch_interpolate`` and
``roi_patch_backward`` in interpret mode, ``roi_patch_pool_multi`` and the
XLA ``pool_from_storage(use_pallas=False)``, float32.

Tolerance: the port and both JAX paths compute the same products; only the
summation order differs (float32 einsum/matmul orders), so pooled values
agree to 1e-5 absolute on O(1) features, and plane gradients, sums of up to
a few hundred such products per cell, to 1e-4. The plan's integer parts
(storage rows, tx, tier class) must be equal, and skipped slots exact zeros.
Interpret mode is slow, so the backward cases are tiny (P=16, C<=8, N<=16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.models import poolers as jp
from detectron2_tensorflow_tpu.ops.pallas.roi_patch import full_tier_class
from detectron2_tensorflow_tpu.ops.pallas.roi_patch import roi_patch_backward as pallas_bwd
from detectron2_tensorflow_tpu.ops.pallas.roi_patch import roi_patch_interpolate as pallas_roi
from detectron2_tensorflow_tpu.ops.pallas.roi_patch import roi_patch_pool_multi as pallas_multi
from detectron2_tensorflow_tpu_torch.models import poolers as tp

STRIDES = [4, 8, 16, 32]
ATOL = 1e-5
BWD_ATOL = 1e-4


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


def _bwd_case(rng, b, n, s, p=16, c=8, htot=48, wm=40, skip_frac=0.0, same_region=False):
    """Cotangents and a hand-made plan over a ``[b, htot, wm, c]`` plane."""
    g = rng.standard_normal((b, n, s, s, c)).astype(np.float32)
    wy = rng.uniform(0, 1, (b, n, s, p)).astype(np.float32)
    wx = rng.uniform(0, 1, (b, n, s, p)).astype(np.float32)
    if same_region:
        rows, txs = np.full((b, n), 8), np.full((b, n), 16)
    else:
        rows = rng.integers(0, htot - p + 1, (b, n))
        txs = rng.integers(0, (wm - p) // 8 + 1, (b, n)) * 8
    cls = np.where(rng.uniform(0, 1, (b, n)) < skip_frac, tp.skip_tier_class(p), full_tier_class(p))
    starts = np.stack([rows, txs, cls], -1).astype(np.int32)
    return g, starts, wy, wx, (b, htot, wm, c)


@pytest.mark.parametrize("case", ["random", "all_overlapping", "skipped_slots", "init"])
def test_backward_reference_matches_pallas_interpret(case):
    """The plain backward against the Pallas kernel: random regions, every
    ROI on one region (the kernel's hazard path), skipped slots, and
    accumulation into a given plane (``init``)."""
    rng = np.random.default_rng(len(case))
    g, starts, wy, wx, shape = _bwd_case(rng, 2, 9, 7, skip_frac=0.3 if case == "skipped_slots" else 0,
                                         same_region=case == "all_overlapping")
    init = rng.standard_normal(shape).astype(np.float32) if case == "init" else None
    want = np.asarray(pallas_bwd(jnp.asarray(g), jnp.asarray(starts), jnp.asarray(wy),
                                 jnp.asarray(wx), out_shape=shape, interpret=True,
                                 init=None if init is None else jnp.asarray(init)))
    t_init = None if init is None else torch.from_numpy(init.copy())
    got = tp.roi_patch_backward(torch.from_numpy(g), torch.from_numpy(starts),
                                torch.from_numpy(wy), torch.from_numpy(wx), shape, init=t_init)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    if t_init is not None:
        assert got.data_ptr() == t_init.data_ptr()  # accumulated in place
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=BWD_ATOL)
    if case == "skipped_slots":
        keep = starts[..., 2] != tp.skip_tier_class(16)
        g0 = np.where(keep[..., None, None, None], 0.0, g).astype(np.float32)
        zero = tp.roi_patch_backward_reference(torch.from_numpy(g0), torch.from_numpy(starts),
                                               torch.from_numpy(wy), torch.from_numpy(wx), shape)
        assert not zero.any()


def test_batched_backward_matches_single_image_interpret():
    """The batched plain backward, image by image, against the Pallas kernel
    on each image alone (unbatched inputs)."""
    rng = np.random.default_rng(9)
    g, starts, wy, wx, shape = _bwd_case(rng, 2, 6, 14)
    got = tp.roi_patch_backward_reference(torch.from_numpy(g), torch.from_numpy(starts),
                                          torch.from_numpy(wy), torch.from_numpy(wx), shape)
    for b in range(2):
        want = pallas_bwd(jnp.asarray(g[b]), jnp.asarray(starts[b]), jnp.asarray(wy[b]),
                          jnp.asarray(wx[b]), out_shape=shape[1:], interpret=True)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want), rtol=1e-5, atol=BWD_ATOL)


def test_autograd_function_matches_autograd_of_plain_forward():
    """``pool_from_storage``'s plane gradient (``RoiPatchPoolMulti`` with one
    ROI set, through ``roi_patch_backward``) against autograd through the
    plain forward."""
    rng = np.random.default_rng(31)
    feats = _features(rng, c=8)
    boxes = _boxes(rng, 2, 12)
    valid = rng.uniform(0, 1, (2, 12)) > 0.2
    _, (ts, tmeta, tst, twy, twx) = _plans(feats, boxes, valid, 7)
    cot = torch.from_numpy(rng.standard_normal((2, 12, 7, 7, 8)).astype(np.float32))
    grads = []
    for fn in (lambda st: tp.RoiPatchPoolMulti.apply(st, tst, twy, twx)[0],
               lambda st: tp.roi_patch_interpolate_reference(st, tst, twy, twx)):
        st = ts.clone().requires_grad_(True)
        (fn(st) * cot).sum().backward()
        grads.append(st.grad)
    assert grads[0].abs().sum() > 0
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(), rtol=1e-5, atol=1e-5)


def test_valid_skip_gradients_match_unskipped():
    """For a loss that masks invalid slots, as every consumer does, the
    storage gradient is the same with and without skipping them."""
    rng = np.random.default_rng(12)
    feats = _features(rng, c=8)
    boxes = torch.from_numpy(_boxes(rng, 2, 10))
    valid = torch.from_numpy(rng.uniform(0, 1, (2, 10)) > 0.5)
    _, (ts, tmeta, *_) = _plans(feats, boxes.numpy(), None, 7)
    grads = []
    for v in (None, valid):
        st = ts.clone().requires_grad_(True)
        o = tp.pool_from_storage(st, tmeta, boxes, 7, 0, valid=v)
        (torch.where(valid[..., None, None, None], o, torch.zeros_like(o)) ** 2).sum().backward()
        grads.append(st.grad.numpy())
    np.testing.assert_allclose(grads[1], grads[0], rtol=1e-5, atol=1e-5)


def test_pool_multi_fused_backward_matches_jax_interpret():
    """Box (7x7) and mask (14x14) sets on one storage plane: the fused op's
    outputs and its chained plane gradient against the JAX package's
    ``roi_patch_pool_multi`` in interpret mode, and against the sum of the
    two sets' independent gradients."""
    rng = np.random.default_rng(21)
    feats = _features(rng, c=8)
    boxes_a, boxes_b = _boxes(rng, 2, 8), _boxes(rng, 2, 5)
    valid_a = rng.uniform(0, 1, (2, 8)) > 0.25
    (js, _, jsa, jwya, jwxa), (ts, tmeta, tsa, twya, twxa) = _plans(feats, boxes_a, valid_a, 7)
    (_, _, jsb, jwyb, jwxb), (_, _, tsb, twyb, twxb) = _plans(feats, boxes_b, None, 14)
    ga = rng.standard_normal((2, 8, 7, 7, 8)).astype(np.float32)
    gb = rng.standard_normal((2, 5, 14, 14, 8)).astype(np.float32)

    outs, vjp = jax.vjp(lambda st: pallas_multi(st, ((jsa, jwya, jwxa), (jsb, jwyb, jwxb)), True), js)
    (want_grad,) = vjp((jnp.asarray(ga), jnp.asarray(gb)))

    st = ts.clone().requires_grad_(True)
    out_a, out_b = tp.RoiPatchPoolMulti.apply(st, tsa, twya, twxa, tsb, twyb, twxb)
    ((out_a * torch.from_numpy(ga)).sum() + (out_b * torch.from_numpy(gb)).sum()).backward()
    np.testing.assert_allclose(out_a.detach().numpy(), np.asarray(outs[0]), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(out_b.detach().numpy(), np.asarray(outs[1]), rtol=1e-5, atol=ATOL)
    np.testing.assert_allclose(st.grad.numpy(), np.asarray(want_grad), rtol=1e-5, atol=BWD_ATOL)

    separate = sum(
        tp.roi_patch_backward_reference(torch.from_numpy(g), s_, wy_, wx_, tuple(ts.shape))
        for g, (s_, wy_, wx_) in ((ga, (tsa, twya, twxa)), (gb, (tsb, twyb, twxb))))
    np.testing.assert_allclose(st.grad.numpy(), separate.numpy(), rtol=1e-5, atol=BWD_ATOL)


def _serving_plans(out_size, seed, n=160):
    """JAX and port plans at the 800x1344 serving shapes (p2-p5 of an
    800x1344 image, C=1), for detector-like boxes (12-600 px, aspect
    e^[-0.7, 0.7], a few of zero width), 10% of the slots skipped."""
    rng = np.random.default_rng(seed)
    feats = _features(rng, h=200, w=336, c=1)
    ctr = rng.uniform([0, 0], [1333, 800], (2, n, 2))
    size = np.exp(rng.uniform(np.log(12), np.log(600), (2, n, 1)))
    ar = np.exp(rng.uniform(-0.7, 0.7, (2, n, 1)))
    half = np.concatenate([size * ar, size / ar], -1) / 2
    half[:, :4, 0] = 0  # zero-area boxes: planned, all-zero weights
    boxes = np.clip(np.concatenate([ctr - half, ctr + half], -1), 0, [1333, 800, 1333, 800])
    valid = rng.uniform(0, 1, (2, n)) > 0.1
    return _plans(feats, boxes.astype(np.float32), valid, out_size)


def _support_np(w):
    """[lo, hi) of the nonzero positions of each slot's [S, P] weights, numpy."""
    nz = (np.asarray(w) != 0).any(axis=-2)
    p = nz.shape[-1]
    lo = np.where(nz.any(-1), nz.argmax(-1), 0)
    hi = np.where(nz.any(-1), p - nz[..., ::-1].argmax(-1), 0)
    return np.stack([lo, hi], -1)


def _outside(support, p):
    """``[..., P]`` True at the positions outside each slot's ``[lo, hi)``."""
    pos = np.arange(p)
    return (pos < support[..., :1]) | (pos >= support[..., 1:])


@pytest.mark.parametrize("out_size", [7, 14])
def test_hat_support_holds_every_nonzero_weight(out_size):
    """The port's ``hat_support`` equals the support of the JAX package's
    plan, and both plans' weights are exactly zero outside it."""
    (_, _, _, jwy, jwx), (_, tmeta, _, twy, twx) = _serving_plans(out_size, out_size)
    p = tmeta.patch_size
    for jw, tw in ((jwy, twy), (jwx, twx)):
        sup = tp.hat_support(tw).numpy()
        np.testing.assert_array_equal(sup, _support_np(jw))
        assert (sup[..., 1] > sup[..., 0]).any() and (sup[..., 1] == 0).any()
        out = _outside(sup, p)[..., None, :]
        for w in (np.asarray(jw), tw.numpy()):
            assert not np.where(out, w, 0).any()


@pytest.mark.parametrize("out_size", [7, 14])
def test_tier_class_bounds_the_support_in_production_plans(out_size):
    """In a plan's slots that are not skipped, the support lies inside the
    row and column tier window its tier class names (the window the TPU
    kernel reads); the span is what the kernels loop over."""
    _, (_, tmeta, tst, twy, twx) = _serving_plans(out_size, 30 + out_size)
    p = tmeta.patch_size
    rows = [r for r in tp.ROW_TIERS if r < p] + [p]
    cols = [c for c in tp.COL_TIERS if c < p] + [p]
    cls = tst[..., 2].numpy()
    keep = cls < tp.skip_tier_class(p)
    sy, sx = tp.hat_support(twy).numpy()[keep], tp.hat_support(twx).numpy()[keep]
    assert (sy[:, 1] <= np.array(rows)[cls[keep] // len(cols)]).all()
    assert (sx[:, 1] <= np.array(cols)[cls[keep] % len(cols)]).all()
    share = ((sy[:, 1] - sy[:, 0]) * (sx[:, 1] - sx[:, 0])).mean() / p ** 2
    assert 0 < share < 0.5


def _restricted_forward(storage, starts, wy, wx):
    """The plain forward, slot by slot, over each slot's support alone."""
    b, n, s, _ = wy.shape
    out = torch.zeros((b, n, s, s, storage.shape[-1]))
    sy, sx = tp.hat_support(wy), tp.hat_support(wx)
    for i in range(b):
        for j in range(n):
            if starts[i, j, 2] >= tp.skip_tier_class(wy.shape[-1]):
                continue
            (y0, y1), (x0, x1) = sy[i, j].tolist(), sx[i, j].tolist()
            row, tx = starts[i, j, 0].item(), starts[i, j, 1].item()
            patch = storage[i, row + y0: row + y1, tx + x0: tx + x1]  # [hy, hx, C]
            a = torch.einsum("op,pqc->oqc", wy[i, j, :, y0:y1], patch)
            out[i, j] = torch.einsum("uq,oqc->ouc", wx[i, j, :, x0:x1], a)
    return out


def _restricted_backward(g, starts, wy, wx, shape):
    """The plain backward, slot by slot, adding each slot's gradient over its
    support alone."""
    acc = torch.zeros(shape)
    sy, sx = tp.hat_support(wy), tp.hat_support(wx)
    for i in range(g.shape[0]):
        for j in range(g.shape[1]):
            if starts[i, j, 2] >= tp.skip_tier_class(wy.shape[-1]):
                continue
            (y0, y1), (x0, x1) = sy[i, j].tolist(), sx[i, j].tolist()
            row, tx = starts[i, j, 0].item(), starts[i, j, 1].item()
            t = torch.einsum("op,ouc->puc", wy[i, j, :, y0:y1], g[i, j])
            acc[i, row + y0: row + y1, tx + x0: tx + x1] += torch.einsum(
                "puc,uq->pqc", t, wx[i, j, :, x0:x1])
    return acc


@pytest.mark.parametrize("out_size", [7, 14])
def test_support_restricted_forward_equals_dense(out_size):
    _, (ts, tmeta, tst, twy, twx) = _serving_plans(out_size, 50 + out_size)
    want = tp.roi_patch_interpolate_reference(ts, tst, twy, twx)
    got = _restricted_forward(ts, tst, twy, twx)
    assert float(want.abs().max()) > 0
    assert float((got - want).abs().max()) <= 1e-6 * float(want.abs().max())


@pytest.mark.parametrize("out_size", [7, 14])
def test_support_restricted_backward_equals_dense(out_size):
    """The plane gradient over the supports alone against the dense plain
    backward, each cell to 1e-6 of the sum of its terms' magnitudes (the
    same plane made from |g|): the sums differ in order only."""
    rng = np.random.default_rng(70 + out_size)
    _, (ts, tmeta, tst, twy, twx) = _serving_plans(out_size, 70 + out_size)
    shape = tuple(ts.shape)
    g = torch.from_numpy(rng.standard_normal(tst.shape[:2] + (out_size, out_size, 1))
                         .astype(np.float32))
    want = tp.roi_patch_backward_reference(g, tst, twy, twx, shape)
    terms = tp.roi_patch_backward_reference(g.abs(), tst, twy, twx, shape)
    got = _restricted_backward(g, tst, twy, twx, shape)
    assert float(want.abs().max()) > 0
    assert bool(((got - want).abs() <= 1e-6 * terms).all())


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_avgpool_alias_gradient_matches_jax_custom_vjp(dtype):
    """Autograd of the port's 2x2 alias pool equals the JAX package's
    hand-written transpose (a 2x2 spread at weight 1/4; odd edges get none)."""
    rng = np.random.default_rng(6)
    f = rng.standard_normal((2, 13, 22, 4)).astype(np.float32)
    g = rng.standard_normal((2, 6, 11, 4)).astype(np.float32)
    tdtype = torch.float32 if dtype == jnp.float32 else torch.bfloat16
    x = torch.from_numpy(f).to(tdtype).requires_grad_(True)
    (tp._avgpool2x(x) * torch.from_numpy(g).to(tdtype)).sum().backward()
    for i in range(2):
        _, vjp = jax.vjp(jp._avgpool2x, jnp.asarray(f[i], dtype))
        (want,) = vjp(jnp.asarray(g[i], dtype))
        assert want.dtype == dtype
        np.testing.assert_array_equal(x.grad[i].float().numpy(), np.asarray(want, np.float32))
