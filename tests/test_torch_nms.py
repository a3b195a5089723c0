"""The port's NMS (plain keep mask, ``nms_fixed``, ``class_aware_nms``)
against the JAX package's Pallas kernel in interpret mode and its XLA sweep.
Keep masks are compared exactly; with ``max_keep``, on the prefix of
``max_keep`` survivors, which is what every consumer reads."""

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
    class_aware_nms,
    greedy_keep,
    greedy_keep_reference,
    nms,
    nms_fixed,
)


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
