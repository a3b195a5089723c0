"""The port's NMS (plain keep mask, ``nms_fixed``, ``class_aware_nms``,
``nms_fixed_levels``) against the JAX package's Pallas kernel in interpret
mode and its XLA sweep. Keep masks are compared exactly; against the JAX
package with ``max_keep``, on the prefix of ``max_keep`` survivors, which is
what every consumer reads (the Pallas kernel stops after the block that
reaches ``max_keep``, the port after that survivor).

``block_sweep_model`` is a numpy model of ``csrc/nms_keep.cu``, which cannot
run here: the upper-triangle mask of 64-bit words with the validity bit on
the diagonal, and the sweep settled one 64-row block at a time with the
``max_keep`` cut inside a block."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.ops import class_aware_nms as jax_class_aware_nms
from detectron2_tensorflow_tpu.ops import nms as jax_nms
from detectron2_tensorflow_tpu.ops import nms_fixed as jax_nms_fixed
from detectron2_tensorflow_tpu.ops.pallas.nms_keep import greedy_keep as pallas_keep
from detectron2_tensorflow_tpu_torch.ops.nms import (
    PAD_BOX,
    class_aware_nms,
    greedy_keep,
    greedy_keep_reference,
    nms,
    nms_fixed,
    nms_fixed_levels,
)
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)


@pytest.fixture(autouse=True)
def _xla_sweep(monkeypatch):
    """The JAX package's ``nms`` takes its XLA sweep (D2TPU_NMS_PALLAS=0)."""
    monkeypatch.setenv("D2TPU_NMS_PALLAS", "0")


def _boxes(rng, n, size=200.0, max_wh=60.0):
    ctr = rng.uniform(10, size - 10, (n, 2))
    wh = rng.uniform(2, max_wh, (n, 2))
    return np.concatenate([ctr - wh / 2, ctr + wh / 2], axis=1).astype(np.float32)


def _sorted_inputs(rng, n):
    boxes = _boxes(rng, n)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) > 0.15
    order = np.argsort(-np.where(valid, scores, -1e10), kind="stable")
    return boxes[order], valid[order]


@pytest.mark.parametrize("n,thr,mk", [(96, 0.5, None), (200, 0.3, None),
                                      (256, 0.7, None), (256, 0.5, 40)])
def test_plain_keep_matches_pallas_interpret(n, thr, mk):
    rng = np.random.default_rng(n + int(thr * 10))
    boxes, valid = _sorted_inputs(rng, n)
    want = np.asarray(pallas_keep(jnp.asarray(boxes), jnp.asarray(valid), thr,
                                  max_keep=mk, interpret=True))
    got = greedy_keep(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None],
                      thr, max_keep=mk)[0].numpy()
    if mk is None:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_array_equal(np.flatnonzero(got)[:mk], np.flatnonzero(want)[:mk])
        assert got.sum() == min(mk, want.sum())


@pytest.mark.parametrize("n,thr,mk", [(300, 0.5, None), (700, 0.6, None),
                                      (1000, 0.7, None), (2000, 0.5, 100)])
def test_nms_matches_xla_sweep(n, thr, mk):
    rng = np.random.default_rng(n)
    boxes = _boxes(rng, n, size=400.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) > 0.1
    jo, jk, _ = jax.jit(lambda b, s, v: jax_nms(b, s, thr, v, max_keep=mk))(boxes, scores, valid)
    to, tk, _ = nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], thr,
                    torch.from_numpy(valid)[None], max_keep=mk)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo))
    ref = np.asarray(jo)[np.asarray(jk)]
    got = to[0].numpy()[tk[0].numpy()]
    if mk is None:
        np.testing.assert_array_equal(tk[0].numpy(), np.asarray(jk))
    else:
        np.testing.assert_array_equal(got[:mk], ref[:mk])


def test_chained_overlaps_keep_every_other_box():
    """Each box overlaps only its neighbours, so the suppression chain spans
    the whole input: greedy keeps exactly the even positions."""
    n = 256
    x0 = 6.0 * np.arange(n, dtype=np.float32)
    boxes = np.stack([x0, np.zeros(n, np.float32), x0 + 10.0,
                      np.full(n, 10.0, np.float32)], axis=1)
    valid = np.ones(n, bool)
    want = np.asarray(pallas_keep(jnp.asarray(boxes), jnp.asarray(valid), 0.2, interpret=True))
    got = greedy_keep(torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None], 0.2)[0]
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), np.arange(n) % 2 == 0)


def test_batched_keep_equals_per_image():
    rng = np.random.default_rng(3)
    per = [_sorted_inputs(rng, 128) for _ in range(3)]
    boxes = torch.from_numpy(np.stack([b for b, _ in per]))
    valid = torch.from_numpy(np.stack([v for _, v in per]))
    batched = greedy_keep_reference(boxes, valid, 0.5)
    for i in range(3):
        np.testing.assert_array_equal(
            batched[i].numpy(), greedy_keep_reference(boxes[i:i + 1], valid[i:i + 1], 0.5)[0].numpy())


@pytest.mark.parametrize("presorted", [False, True])
def test_nms_fixed_matches_jax(presorted):
    rng = np.random.default_rng(11)
    n, k = 300, 40
    boxes = _boxes(rng, n, size=150.0)
    scores = rng.uniform(0, 1, n).astype(np.float32)
    valid = rng.uniform(0, 1, n) > 0.2
    if presorted:
        order = np.argsort(-np.where(valid, scores, -1e10), kind="stable")
        boxes, scores, valid = boxes[order], scores[order], valid[order]
    want = jax_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.5, k,
                         valid=jnp.asarray(valid), presorted=presorted)
    got = nms_fixed(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], 0.5, k,
                    valid=torch.from_numpy(valid)[None], presorted=presorted)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_nms_fixed_pads_when_fewer_candidates_than_outputs():
    rng = np.random.default_rng(5)
    boxes = _boxes(rng, 20)
    scores = rng.uniform(0, 1, 20).astype(np.float32)
    want = jax_nms_fixed(jnp.asarray(boxes), jnp.asarray(scores), 0.5, 32)
    got = nms_fixed(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None], 0.5, 32)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))


def test_class_aware_nms_matches_jax_with_class_offsets():
    """Box-head shape: score-sorted class-offset candidates, max_keep prefix."""
    rng = np.random.default_rng(2)
    n, k = 800, 100
    base = _boxes(rng, 120, size=600.0, max_wh=150.0)
    boxes = (base[rng.integers(0, 120, n)] + rng.normal(0, 4, (n, 4))).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, n).astype(np.float32))[::-1].copy()
    classes = rng.integers(0, 5, n)
    valid = scores > 0.1
    want = jax_class_aware_nms(jnp.asarray(boxes), jnp.asarray(scores), jnp.asarray(classes),
                               0.5, k, valid=jnp.asarray(valid), presorted=True)
    got = class_aware_nms(torch.from_numpy(boxes)[None], torch.from_numpy(scores)[None],
                          torch.from_numpy(classes)[None], 0.5, k,
                          valid=torch.from_numpy(valid)[None], presorted=True)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w))
    assert got[3].sum() == k  # enough survivors to fill every slot


def test_greedy_keep_rejects_other_devices():
    boxes = torch.zeros((1, 4, 4), device="meta")
    with pytest.raises(RuntimeError, match="no implementation"):
        greedy_keep(boxes, torch.ones((1, 4), dtype=torch.bool, device="meta"), 0.5)


def _iou_over(rows, cols, thr):
    """``[R, C]`` overlap flags in the kernel's float32 operations and order
    (numpy rounds every operation and never contracts one into an FMA)."""
    a, c = rows[:, None, :], cols[None, :, :]
    zero = np.float32(0)

    def area(b):
        return np.maximum(b[..., 2] - b[..., 0], zero) * np.maximum(b[..., 3] - b[..., 1], zero)

    iw = np.maximum(np.minimum(a[..., 2], c[..., 2]) - np.maximum(a[..., 0], c[..., 0]), zero)
    ih = np.maximum(np.minimum(a[..., 3], c[..., 3]) - np.maximum(a[..., 1], c[..., 1]), zero)
    inter = iw * ih
    uni = (area(a) + area(c)) - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        iou = np.where(uni > 0, inter / np.maximum(uni, np.float32(1e-8)), zero)
    return iou > np.float32(thr)


def block_sweep_model(boxes, valid, thr, max_keep=None):
    """The kernel's keep mask, step for step: the mask pass writes, for each
    row i and column block cb >= i's block, a 64-bit word whose bit k says
    box 64*cb + k (> i) overlaps box i; invalid rows write zero words, and
    on the diagonal a valid row sets its own bit. The sweep takes the row
    blocks in order: candidates are the diagonal words' own bits not yet
    removed; the candidates that overlap a later candidate are visited in
    order, each still present removing what it overlaps; the rest are kept,
    cut to the first ``max_keep`` survivors; then the kept rows' words of
    the later column blocks are ORed into ``removed``. Words below the
    diagonal do not exist, so reading one raises ``KeyError``."""
    n = len(boxes)
    blocks = -(-n // 64)
    cols = np.concatenate([boxes, np.full((blocks * 64 - n, 4), PAD_BOX, np.float32)])
    words = {}
    for rb in range(blocks):
        rows = np.arange(rb * 64, min(rb * 64 + 64, n))
        for cb in range(rb, blocks):
            over = _iou_over(cols[rows], cols[cb * 64:cb * 64 + 64], thr)
            if cb == rb:
                over &= np.arange(64)[None, :] > (rows - rb * 64)[:, None]
                over[np.arange(len(rows)), rows - rb * 64] = True
            over &= valid[rows][:, None]
            packed = np.packbits(over, axis=1, bitorder="little").view("<u8")[:, 0]
            words.update({(int(i), cb): int(w) for i, w in zip(rows, packed)})
    limit = n if max_keep is None else max_keep
    removed = [0] * blocks
    keep = np.zeros(n, bool)
    kept = 0
    for rb in range(blocks):
        diag = [words[rb * 64 + k, rb] if rb * 64 + k < n else 0 for k in range(64)]
        word = sum(d & (1 << k) for k, d in enumerate(diag)) & ~removed[rb]
        over = [diag[k] & word & ~(1 << k) if word >> k & 1 else 0 for k in range(64)]
        for k in range(64):  # the candidates that overlap a later one, in order
            if over[k] and word >> k & 1:
                word &= ~over[k]
        rows = [k for k in range(64) if word >> k & 1][:limit - kept]
        kept += len(rows)
        keep[[rb * 64 + k for k in rows]] = True
        if kept >= limit:
            break
        for k in rows:
            for cb in range(rb + 1, blocks):
                removed[cb] |= words[rb * 64 + k, cb]
    return keep


def _chained(n):
    x0 = 6.0 * np.arange(n, dtype=np.float32)
    boxes = np.stack([x0, np.zeros(n, np.float32), x0 + 10.0,
                      np.full(n, 10.0, np.float32)], axis=1)
    return boxes, np.ones(n, bool)


def _cut(survivors, cut):
    """``max_keep`` for a cut ``inside`` a block (between two survivors of
    the middle block that holds two), ``at`` a block boundary (after the
    middle block with survivors), or ``above`` the survivors."""
    blk = survivors // 64
    if cut == "above":
        return len(survivors) + 1
    if cut == "inside":
        pairs = np.flatnonzero(blk[1:] == blk[:-1]) + 1
        return int(pairs[len(pairs) // 2])
    ends = np.flatnonzero(np.diff(blk)) + 1
    return int(ends[len(ends) // 2]) if len(ends) else len(survivors)


@pytest.mark.parametrize("kind,n,cut", [
    ("random", n, cut) for n in (63, 64, 65, 130, 1000)
    for cut in (None, "inside", "at", "above")] + [
    ("chained", 256, cut) for cut in (None, "inside", "at")])
def test_block_sweep_model_matches_reference_and_pallas(kind, n, cut):
    """The kernel's algorithm (numpy model) against the plain keep mask and
    the Pallas kernel in interpret mode; the chained case's suppression chain
    crosses every block."""
    thr = 0.2 if kind == "chained" else 0.5
    if kind == "chained":
        boxes, valid = _chained(n)
    else:
        boxes, valid = _sorted_inputs(np.random.default_rng(n + 7), n)
    tb, tv = torch.from_numpy(boxes)[None], torch.from_numpy(valid)[None]
    survivors = np.flatnonzero(greedy_keep_reference(tb, tv, thr)[0].numpy())
    mk = None if cut is None else _cut(survivors, cut)
    got = block_sweep_model(boxes, valid, thr, mk)
    want = greedy_keep_reference(tb, tv, thr, max_keep=mk)[0].numpy()
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(pallas_keep(jnp.asarray(boxes), jnp.asarray(valid), thr,
                                    max_keep=mk, interpret=True))
    k = len(survivors) if mk is None else mk
    np.testing.assert_array_equal(np.flatnonzero(got), np.flatnonzero(pallas)[:k])
    if kind == "chained":
        np.testing.assert_array_equal(survivors, np.arange(0, n, 2))


def _level_candidates(rng, b, k):
    """One RPN level's score-sorted candidates on an 800x1333 image: jittered
    copies of a few objects, scores on a 0.01 grid (ties), 8% invalid."""
    ctr = rng.uniform([0, 0], [1333, 800], (b, 60, 2))
    size = np.exp(rng.uniform(np.log(16), np.log(400), (b, 60, 2)))
    pick = rng.integers(0, 60, (b, k))
    c = np.take_along_axis(ctr, pick[..., None], 1) + rng.normal(0, 5, (b, k, 2))
    s = np.take_along_axis(size, pick[..., None], 1) * rng.uniform(0.8, 1.2, (b, k, 2))
    boxes = np.clip(np.concatenate([c - s / 2, c + s / 2], -1), 0, [1333, 800, 1333, 800])
    scores = -np.sort(-np.round(rng.normal(0, 2, (b, k)), 2), axis=1)
    valid = rng.uniform(0, 1, (b, k)) > 0.08
    return (torch.from_numpy(boxes.astype(np.float32)), torch.from_numpy(scores.astype(np.float32)),
            torch.from_numpy(valid))


@pytest.mark.parametrize("pre_k,post_k", [(1000, 1000), (2000, 1000)], ids=["serving", "training"])
def test_nms_fixed_levels_equal_the_per_level_loop(pre_k, post_k):
    """The RPN's levels at 800x1344 (p2-p5 at the pre-NMS budget, p6's 13 x
    21 x 3 = 819), batch 2, stacked into one NMS batch: each level's boxes,
    scores and valid slots equal its own ``nms_fixed``."""
    rng = np.random.default_rng(pre_k)
    levels = [_level_candidates(rng, 2, k) for k in (pre_k,) * 4 + (819,)]
    got = nms_fixed_levels(levels, 0.7, post_k)
    assert [g[0].shape[1] for g in got] == [min(post_k, l[1].shape[1]) for l in levels]
    for (boxes, scores, valid), (g_boxes, g_scores, g_valid) in zip(levels, got):
        w_boxes, w_scores, _, w_valid = nms_fixed(boxes, scores, 0.7, min(post_k, boxes.shape[1]),
                                                  valid=valid, presorted=True)
        assert torch.equal(g_boxes, w_boxes)
        assert torch.equal(g_scores, w_scores)
        assert torch.equal(g_valid, w_valid)
        assert 0 < int(g_valid.sum()) < g_valid.numel()


@pytest.mark.parametrize("thr", [0.3, 0.5, 0.7, 0.05, 0.95, 0.123456])
def test_threshold_test_without_division_equals_divided_iou(thr):
    """The kernel's threshold test: RN(inter / u) > thr iff inter > mid * u
    in float64, mid the midpoint between thr and the next float32 up. Held
    against numpy's correctly rounded float32 division on random pairs and
    on quotients within a few ulps of the threshold."""
    rng = np.random.default_rng(int(thr * 1e6))
    t = np.float32(thr)
    mid = 0.5 * (np.float64(t) + np.float64(np.nextafter(t, np.float32(np.inf))))
    u = np.exp(rng.uniform(np.log(1e-8), np.log(1e7), 400_000)).astype(np.float32)
    near = (np.float64(t) * u).astype(np.float32)
    steps = rng.integers(-4, 5, u.size).astype(np.int32)
    near = (near.view(np.int32) + steps).view(np.float32)
    inter = np.concatenate([(u * rng.uniform(0, 1, u.size)).astype(np.float32), near])
    u = np.concatenate([u, u])
    divided = (inter / u) > t
    assert divided.any() and not divided.all()
    np.testing.assert_array_equal(inter.astype(np.float64) > mid * u.astype(np.float64), divided)
