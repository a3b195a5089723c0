"""Relation Networks' modules (``models/roi_heads/relation.py``) against the
JAX package's, piece by piece, and the paper's equations on the port.

Each piece gets the same seeded numpy inputs and the JAX module's weights
(flax ``Dense`` kernels carried across transposed): the sinusoid and
geometry embeddings (``dim_mat`` equal), ``ObjectRelationModule`` with and
without a validity mask (and the JAX geometry fed to both, since the
embedding multiplies its log features by 100 and so turns an ulp of box
drift into a visible change of the attention bias), ``RelationBoxHead``,
the duplicate-removal candidates (class-specific and class-agnostic, exact
score ties, invalid slots), ``DuplicateRemovalModule`` with one and five
threshold heads, and the learned NMS of the JAX driver
(``dup_removal_inference``, the ``mean`` and ``max`` rules and the padding
when there are fewer candidates than detection slots). Then the paper checks
of ``tests/test_relation_paper.py`` with that file's scalar numpy
transcriptions, the relation oracle of ``tests/test_pipeline_oracle.py`` on
the port's ``predict``, the YAML's narrow parameter tree against
``convert_variables``, the JAX init recipe's moments, and that the YAML
trains through ``build_model``, ``losses`` and ``tools.train``
(``test_torch_relation_train.py`` holds the training against JAX). Tolerances are stated at each
check with the worst case measured on this host.
"""

import math
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts, _RCNNDrivers
from detectron2_tensorflow_tpu.models.roi_heads import relation as jrel
from detectron2_tensorflow_tpu.structures import Instances as JaxInstances
from detectron2_tensorflow_tpu_torch.convert import _port_shapes, convert_variables
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.models.box_regression import Box2BoxTransform
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import (
    GeneralizedRCNN,
    init_weights,
)
from detectron2_tensorflow_tpu_torch.models.roi_heads import relation as trel
from detectron2_tensorflow_tpu_torch.structures import Instances
from detectron2_tensorflow_tpu_torch.tools import train as tools_train
from test_relation_paper import paper_position_embedding
from test_torch_c4 import jax_param_shapes, repo_configs, yaml_cfgs
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)
from test_torch_gn import PortModel, port_cfg_from, port_in, port_model

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RELATION_YAML = "configs/Misc/relation_rcnn_R_50_FPN_1x.yaml"
# Narrow relation widths: 4 groups of key dim 16, the rank embedding 32 (the
# geometry embedding keeps its 64: 4 features of 16).
RELATION_NARROW = {"MODEL.NECK.OUT_CHANNELS": 32,
                   "MODEL.ROI_BOX_RELATION_HEAD.NUM_GROUPS": 4,
                   "MODEL.ROI_BOX_RELATION_HEAD.NMS_NUM_GROUP": 4,
                   "MODEL.ROI_BOX_RELATION_HEAD.KEY_DIM": 16,
                   "MODEL.ROI_BOX_RELATION_HEAD.RANK_EMBEDDING_DIM": 32}
DUP_ON = {"MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_ON": True}
IOUS5 = (0.5, 0.6, 0.7, 0.8, 0.9)
# float32 tolerances, each above the worst case measured on this host.
EMB_ATOL = 1e-6  # the sinusoid of the same float32 input: measured 6e-8
# The geometry embedding: its argument 100 * log(...) stays below 1024 in
# magnitude, where a float32 ulp is 6.1e-5, and the two libraries' logs and
# the x100 round an ulp apart; two ulps. Measured 6.1e-5 on 5 x 2 x 200 boxes.
GEO_ATOL = 1.3e-4
MODULE_TOL = 1e-5  # the relation module on the same geometry: measured 7.6e-6
GEO_MODULE_TOL = 1e-4  # the relation modules, each package's geometry: measured 9.2e-6


def relation_cfgs(**overrides):
    """(JAX cfg, port cfg): the relation YAML at narrow widths (R50 depth,
    stem 16, res2 32, 8 per group, FPN 32, FC 64, 5 classes, float32)."""
    return yaml_cfgs(RELATION_YAML, **{**RELATION_NARROW, **overrides})


def boxes_np(rng, b, n, size=120.0):
    lo = rng.uniform(0, size, (b, n, 2))
    wh = rng.uniform(0.5, size / 2, (b, n, 2))  # some boxes narrower than the 1 px floor
    return np.concatenate([lo, lo + wh], -1).astype(np.float32)


def dense_state(params, prefix=""):
    """A flax ``Dense`` tree's leaves as the port's ``Linear`` state dict."""
    out = {}
    for name, sub in params.items():
        if "kernel" in sub:
            out[f"{prefix}{name}.weight"] = torch.from_numpy(np.asarray(sub["kernel"]).T.copy())
            out[f"{prefix}{name}.bias"] = torch.from_numpy(np.asarray(sub["bias"]).copy())
        else:
            out.update(dense_state(sub, f"{prefix}{name}."))
    return out


def port_module(module, params):
    """``module`` (float32, CPU) loaded with the JAX ``params``, strictly."""
    module.load_state_dict(dense_state(params))
    return module.eval()


def t(x):
    """A CPU tensor holding a copy of ``x`` (JAX arrays are read-only)."""
    return torch.from_numpy(np.array(x))


# -- embeddings ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [4, 16, 128])
def test_dim_mat_and_sinusoid_embedding_match_jax(dim):
    """``1000 ** (arange(half) / half)`` bit-equal (read back from the
    embedding of 1), then the embedding of raw ranks and of large features."""
    half = dim // 2
    one = trel.sinusoid_embedding(torch.ones(1, 1), dim)[0, :half]
    want_mat = np.asarray(1000.0 ** (jnp.arange(half, dtype=jnp.float32) / half))
    got_mat = 1000.0 ** (torch.arange(half, dtype=torch.float32) / half)
    np.testing.assert_array_equal(got_mat.numpy(), want_mat)
    np.testing.assert_allclose(one.numpy(), np.sin(1.0 / want_mat), atol=1e-6)
    x = np.random.default_rng(dim).uniform(-700, 700, (5, 3)).astype(np.float32)
    x[:, 0] = np.arange(5)  # raw ranks
    got = trel.sinusoid_embedding(t(x), dim).numpy()
    want = np.asarray(jrel.sinusoid_embedding(jnp.asarray(x), dim))
    assert got.shape == want.shape == (5, 3 * dim)
    np.testing.assert_allclose(got, want, atol=EMB_ATOL)


def test_geometry_embeddings_match_jax():
    """``[B, R, R, 64]`` from float32 boxes, coincident centres (the 1e-3
    floor) and sub-pixel boxes (the 1 px floor) included."""
    boxes = boxes_np(np.random.default_rng(1), 2, 9)
    boxes[0, 1] = boxes[0, 0] + 0.25  # the same centre as box 0
    got = trel.geometry_embeddings(t(boxes), 64).numpy()
    want = np.asarray(jrel.geometry_embeddings(jnp.asarray(boxes), 64))
    assert got.shape == want.shape == (2, 9, 9, 64)
    np.testing.assert_allclose(got, want, atol=GEO_ATOL)


# -- the paper's equations (tests/test_relation_paper.py, on the port) ---------------------

def test_port_geometry_embedding_matches_paper_eq5():
    """Eq. 5 per (m, n) pair in scalar numpy, embedded by the official
    recipe (x100, wavelength 1000 ** (k / 8))."""
    rng = np.random.default_rng(7)
    n = 5
    lo = rng.uniform(0, 200, (n, 2))
    wh = rng.uniform(2, 120, (n, 2))
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)
    got = trel.geometry_embeddings(t(boxes)[None], 64)[0].numpy()
    feats = np.zeros((n, n, 4), np.float64)
    for m in range(n):
        for k in range(n):
            xm, ym = (boxes[m, 0] + boxes[m, 2]) / 2, (boxes[m, 1] + boxes[m, 3]) / 2
            xk, yk = (boxes[k, 0] + boxes[k, 2]) / 2, (boxes[k, 1] + boxes[k, 3]) / 2
            wm, hm = max(boxes[m, 2] - boxes[m, 0], 1.0), max(boxes[m, 3] - boxes[m, 1], 1.0)
            wk, hk = max(boxes[k, 2] - boxes[k, 0], 1.0), max(boxes[k, 3] - boxes[k, 1], 1.0)
            feats[m, k] = (math.log(max(abs(xm - xk) / wm, 1e-3)),
                           math.log(max(abs(ym - yk) / hm, 1e-3)),
                           math.log(wk / wm), math.log(hk / hm))
    np.testing.assert_allclose(got, paper_position_embedding(100.0 * feats, 16), atol=2e-4)


def test_port_rank_embedding_matches_official_recipe():
    """The duplicate removal's rank embedding: the raw rank (no x100)."""
    ranks = np.arange(12, dtype=np.float64)[:, None]
    got = trel.sinusoid_embedding(torch.arange(12, dtype=torch.float32)[:, None], 128)
    np.testing.assert_allclose(got.numpy(), paper_position_embedding(ranks, 128), atol=2e-4)


def test_port_geometric_bias_is_paper_eq3_renormalization():
    """softmax(qk + log(wg)) == wg exp(qk) / sum_j wg_j exp(qk_j)."""
    rng = np.random.default_rng(3)
    qk = rng.standard_normal((4, 4))
    wg = np.maximum(rng.standard_normal((4, 4)), 1e-6)
    ours = trel.softmax(torch.from_numpy(qk + np.log(wg)), dim=1).numpy()
    paper = np.zeros_like(qk)
    for m in range(4):
        denom = sum(wg[m, k] * math.exp(qk[m, k]) for k in range(4))
        for k in range(4):
            paper[m, k] = wg[m, k] * math.exp(qk[m, k]) / denom
    np.testing.assert_allclose(ours, paper, atol=1e-6)


def test_port_attention_reduces_to_geometry_prior_at_constant_qk():
    """Zero query and key weights: the attention is the normalized geometric
    prior, so log(wg) enters the logits and the softmax runs over the keys."""
    rng = np.random.default_rng(11)
    n, d = 6, 32
    x = rng.standard_normal((1, n, d)).astype(np.float32)
    lo, wh = rng.uniform(0, 80, (n, 2)), rng.uniform(4, 60, (n, 2))
    boxes = np.concatenate([lo, lo + wh], -1).astype(np.float32)[None]
    torch.manual_seed(0)
    m = trel.ObjectRelationModule(d, num_groups=4, key_dim=8)
    with torch.no_grad():
        for lin in (m.query, m.key):
            lin.weight.zero_()
            lin.bias.zero_()
        geo = trel.geometry_embeddings(t(boxes), 64)
        out = m(t(x), geo)[0].numpy()
    p = {k: v.double().numpy() for k, v in m.state_dict().items()}
    wg = np.maximum(geo[0].double().numpy() @ p["geometry_weight.weight"].T
                    + p["geometry_weight.bias"], 1e-6)
    attn = wg / wg.sum(axis=1, keepdims=True)
    v = (x[0] @ p["value.weight"].T + p["value.bias"]).reshape(n, 4, d // 4)
    want = x[0] + np.einsum("ijg,jgc->igc", attn, v).reshape(n, d) @ p["output.weight"].T \
        + p["output.bias"]
    np.testing.assert_allclose(out, want, atol=1e-4)


# -- the relation modules -------------------------------------------------------------------

@pytest.fixture(scope="module")
def relation_module():
    """A JAX ``ObjectRelationModule`` (64 wide, 4 groups of 16) and its port."""
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 11, 64)).astype(np.float32)
    boxes = boxes_np(rng, 2, 11)
    jm = jrel.ObjectRelationModule(features=64, num_groups=4, key_dim=16)
    params = jm.init(jax.random.PRNGKey(3), jnp.asarray(x), jnp.asarray(boxes))["params"]
    tm = port_module(trel.ObjectRelationModule(64, 4, 16), params)
    return dict(x=x, boxes=boxes, jm=jm, params=params, tm=tm)


@pytest.mark.parametrize("masked", [False, True])
def test_object_relation_module_matches_jax(relation_module, masked):
    """With and without a validity mask (three invalid keys in image 0, every
    key invalid in image 1: uniform attention in both packages), on the JAX
    geometry and on each package's own."""
    r = relation_module
    valid = None
    if masked:
        valid = np.ones((2, 11), bool)
        valid[0, [2, 5, 9]] = False
        valid[1] = False
    jvalid = None if valid is None else jnp.asarray(valid)
    want = np.asarray(r["jm"].apply({"params": r["params"]}, jnp.asarray(r["x"]),
                                    jnp.asarray(r["boxes"]), jvalid))
    geo = np.asarray(jrel.geometry_embeddings(jnp.asarray(r["boxes"]), 64))
    tvalid = None if valid is None else t(valid)
    with torch.no_grad():
        same = r["tm"](t(r["x"]), t(geo), tvalid).numpy()
        own = r["tm"](t(r["x"]), trel.geometry_embeddings(t(r["boxes"]), 64), tvalid).numpy()
    np.testing.assert_allclose(same, want, rtol=MODULE_TOL, atol=MODULE_TOL)
    np.testing.assert_allclose(own, want, rtol=GEO_MODULE_TOL, atol=GEO_MODULE_TOL)


def test_object_relation_module_is_permutation_equivariant(relation_module):
    """``tests/test_breadth_components.py``'s property on the port: permuting
    the ROIs permutes the outputs."""
    r = relation_module
    perm = torch.tensor([3, 1, 5, 0, 2, 4, 10, 9, 8, 7, 6])
    x, boxes = t(r["x"]), t(r["boxes"])
    with torch.no_grad():
        out = r["tm"](x, trel.geometry_embeddings(boxes, 64))
        out_p = r["tm"](x[:, perm], trel.geometry_embeddings(boxes[:, perm], 64))
    np.testing.assert_allclose(out[:, perm].numpy(), out_p.numpy(), atol=1e-4)


def test_relation_box_head_matches_jax():
    """fc1 on the (h, w, c) flattened pooled ROIs, ReLU, relation1, fc2,
    ReLU, relation2: ``[B*R, FC]`` for 2 images of 13 ROIs, 7 x 7 x 8."""
    rng = np.random.default_rng(4)
    b, r, s, c = 2, 13, 7, 8
    pooled = rng.standard_normal((b * r, s, s, c)).astype(np.float32)
    boxes = boxes_np(rng, b, r)
    valid = np.ones((b, r), bool)
    valid[1, 10:] = False
    jh = jrel.RelationBoxHead(fc_dim=32, num_groups=4, key_dim=8)
    params = jh.init(jax.random.PRNGKey(5), jnp.asarray(pooled), jnp.asarray(boxes),
                     jnp.asarray(valid))["params"]
    want = np.asarray(jh.apply({"params": params}, jnp.asarray(pooled), jnp.asarray(boxes),
                               jnp.asarray(valid)))
    th = port_module(trel.RelationBoxHead(s * s * c, 32, 4, 8, 64), params)
    with torch.no_grad():
        got = th(t(pooled), t(boxes), t(valid)).numpy()
    assert got.shape == want.shape == (b * r, 32)
    np.testing.assert_allclose(got, want, rtol=GEO_MODULE_TOL, atol=GEO_MODULE_TOL)


@pytest.mark.parametrize("thresholds", [1, 5])
def test_duplicate_removal_module_matches_jax(thresholds):
    """The rank embedding, the two projections, the relation over 4 groups
    and ``thresholds`` keep logits, with invalid slots at the end."""
    rng = np.random.default_rng(6 + thresholds)
    b, r, d = 2, 17, 24
    app = rng.standard_normal((b, r, d)).astype(np.float32)
    scores = np.sort(rng.uniform(0, 1, (b, r)).astype(np.float32))[:, ::-1].copy()
    boxes = boxes_np(rng, b, r)
    valid = np.ones((b, r), bool)
    valid[0, 14:] = False
    jm = jrel.DuplicateRemovalModule(num_groups=4, key_dim=8, rank_dim=32,
                                     num_thresholds=thresholds)
    args = [jnp.asarray(a) for a in (app, scores, boxes, valid)]
    params = jm.init(jax.random.PRNGKey(7), *args)["params"]
    want = np.asarray(jm.apply({"params": params}, *args))
    tm = port_module(trel.DuplicateRemovalModule(d, 4, 8, 64, 32, thresholds), params)
    with torch.no_grad():
        got = tm(*[t(a) for a in (app, scores, boxes, valid)]).numpy()
    assert got.shape == want.shape == (b, r, thresholds)
    np.testing.assert_allclose(got, want, rtol=GEO_MODULE_TOL, atol=GEO_MODULE_TOL)


# -- candidates and the learned NMS ------------------------------------------------------

def candidate_inputs(rng, b, p, k, agnostic):
    """Class logits with exact ties (rows 3 and 4 are row 2's: equal scores;
    row 6 ties two classes), invalid slots, deltas and proposals."""
    logits = (rng.standard_normal((b, p, k + 1)) * 2).astype(np.float32)
    logits[:, 3] = logits[:, 4] = logits[:, 2]
    logits[:, 6, 1] = logits[:, 6, 3] = logits[:, 6].max() + 1.0
    deltas = (rng.standard_normal((b, p, 4 if agnostic else 4 * k)) * 0.3).astype(np.float32)
    boxes = boxes_np(rng, b, p, size=150.0)
    valid = np.ones((b, p), bool)
    valid[0, [1, 7]] = False
    valid[1, p - 5:] = False
    sizes = np.array([[150, 160], [120, 140]], np.int32)
    return logits, deltas, boxes, valid, sizes


@pytest.mark.parametrize("agnostic", [False, True])
def test_duplicate_removal_candidates_match_jax(agnostic):
    """Per proposal the first most likely class and its clipped box, then the
    stable top 12 of 20: scores, classes, boxes, validity and the gather
    index equal (the tied rows keep their proposal order)."""
    rng = np.random.default_rng(8)
    b, p, k = 2, 20, 4
    logits, deltas, boxes, valid, sizes = candidate_inputs(rng, b, p, k, agnostic)
    weights = (10.0, 10.0, 5.0, 5.0)
    from detectron2_tensorflow_tpu.models.box_regression import Box2BoxTransform as JaxB2B

    want = jrel.build_duplicate_removal_candidates(
        *[jnp.asarray(a) for a in (logits, deltas, boxes, valid, sizes)], JaxB2B(weights), k,
        agnostic, 12)
    got = trel.build_duplicate_removal_candidates(
        *[t(a) for a in (logits, deltas, boxes, valid, sizes)], Box2BoxTransform(weights), k,
        agnostic, 12)
    want = [np.asarray(w) for w in want]
    got = [g.numpy() for g in got]
    for name, g, w in zip(("scores", "classes", "boxes", "valid", "index"), got, want):
        assert g.shape == w.shape, name
        if name in ("scores", "boxes"):
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    idx = got[4][0].tolist()
    assert idx.index(2) < idx.index(3) < idx.index(4) or 2 not in idx  # ties in proposal order
    assert not got[3][0][np.isin(got[4][0], [1, 7])].any()  # invalid proposals stay invalid


@pytest.fixture(scope="module")
def learned_nms():
    """The JAX driver of a narrow relation model with the duplicate removal
    (five heads), its variables and the port's ROI heads with the same
    weights."""
    jcfg, tcfg = relation_cfgs(**DUP_ON, **{
        "MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_IOUS": IOUS5})
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    rng = np.random.default_rng(9)
    dm = jrel.DuplicateRemovalModule(num_groups=4, key_dim=16, rank_dim=32, num_thresholds=5)
    probe = [jnp.asarray(a) for a in (np.zeros((1, 3, 64), np.float32), np.ones((1, 3), np.float32),
                                      boxes_np(rng, 1, 3), np.ones((1, 3), bool))]
    params = {"duplicate_removal": dm.init(jax.random.PRNGKey(10), *probe)["params"]}
    sd = convert_variables({"params": params})
    return dict(jcfg=jcfg, tcfg=tcfg, drv=drv, variables={"params": params}, sd=sd)


def port_heads(tcfg, sd):
    heads = trel.RelationROIHeads(tcfg, [4, 8, 16, 32], 32)
    own = heads.duplicate_removal.state_dict()
    assert {f"roi_heads.duplicate_removal.{k}" for k in own} == set(sd)
    heads.duplicate_removal.load_state_dict(
        {k[len("roi_heads.duplicate_removal."):]: v for k, v in sd.items()})
    return heads.eval()


@pytest.mark.parametrize("combine,proposals,slots", [
    ("mean", 60, 10), ("max", 60, 10),
    ("mean", 9, 12),  # 9 candidates for 12 slots: the top-k is padded
])
def test_learned_nms_matches_jax(learned_nms, combine, proposals, slots):
    """``dup_removal_inference`` on the same class logits, deltas, proposals
    and appearance features: valid slots and classes equal, boxes 1e-5
    (measured 1.6e-6 px), scores 1e-5 relative (measured 1.5e-6); padded
    slots zero with class -1."""
    ln = learned_nms
    jcfg, tcfg = ln["jcfg"].clone(), ln["tcfg"].clone()
    for cfg in (jcfg, tcfg):
        cfg.defrost()
        cfg.MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_COMBINE = combine
        cfg.TEST.DETECTIONS_PER_IMAGE = slots
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.15
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    k = jcfg.MODEL.ROI_HEADS.NUM_CLASSES
    rng = np.random.default_rng(proposals)
    logits, deltas, boxes, valid, sizes = candidate_inputs(rng, 2, proposals, k, False)
    app = rng.standard_normal((2 * proposals, 64)).astype(np.float32)
    props = JaxInstances(proposal_boxes=jnp.asarray(boxes), is_valid=jnp.asarray(valid),
                         objectness_logits=jnp.zeros((2, proposals)))
    want = jax.jit(drv.dup_removal_inference)(
        ln["variables"], jnp.asarray(logits.reshape(-1, k + 1)),
        jnp.asarray(deltas.reshape(2 * proposals, -1)), props, jnp.asarray(app),
        jnp.asarray(sizes))
    heads = port_heads(tcfg, ln["sd"])
    with torch.no_grad():
        got = heads.dup_removal_inference(
            t(logits.reshape(-1, k + 1)), t(deltas.reshape(2 * proposals, -1)),
            Instances(proposal_boxes=t(boxes), is_valid=t(valid)), t(app), t(sizes))
    valid_got = got.is_valid.numpy()
    np.testing.assert_array_equal(valid_got, np.asarray(want.is_valid))
    assert valid_got.shape == (2, slots) and valid_got.sum() >= min(slots, proposals)
    if proposals < slots:  # the padded slots
        assert not valid_got[:, proposals:].any()
    np.testing.assert_array_equal(got.pred_classes.numpy(), np.asarray(want.pred_classes))
    np.testing.assert_allclose(got.boxes.numpy(), np.asarray(want.boxes), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.scores.numpy(), np.asarray(want.scores), rtol=1e-5, atol=1e-7)
    assert (got.pred_classes.numpy()[~valid_got] == -1).all()
    assert not got.boxes.numpy()[~valid_got].any()


def test_unknown_combine_raises_by_name():
    _, tcfg = relation_cfgs(**{"MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_COMBINE": "sum"})
    with pytest.raises(ValueError, match="DUPLICATE_REMOVAL_COMBINE"), torch.device("meta"):
        GeneralizedRCNN(tcfg)


# -- the oracle, the tree, the init ---------------------------------------------------------

class OracleProposalsPortModel(PortModel):
    """``test_torch_gn.PortModel`` serving from the oracle's own proposals:
    its ``np_rpn_proposals`` on the JAX features (as ``_rcnn_oracle_common``
    computes them) stand in for the port's RPN. The duplicate removal's keep
    logits move ~0.4% for 1e-5 px of candidate-box noise and ~11% for 1e-4 px
    (measured on the oracle's model), so the port's own RPN, whose boxes sit
    ~1e-4 px from the numpy ones, reorders near scores; the oracle holds the
    JAX package to its XLA proposals, within ~1e-5 px of them."""

    def predict(self, variables, batch):
        from tests import test_pipeline_oracle as oracle

        cfg, rpn = self.jcfg, self.jcfg.MODEL.RPN
        drv = _RCNNDrivers(cfg, *_build_rcnn_parts(cfg))
        _, logits, deltas = jax.device_get(jax.jit(
            lambda v, b: drv.features_and_rpn(v, b, False))(variables, batch))
        anchors = [np.asarray(a) for a in drv.rpn.anchor_generator(
            [(lg.shape[1], lg.shape[2]) for lg in logits])]
        hw = tuple(int(v) for v in np.asarray(batch["image_size"])[0])
        props = oracle.np_rpn_proposals(logits, deltas, anchors, hw, rpn.PRE_NMS_TOPK_TEST,
                                        rpn.POST_NMS_TOPK_TEST, rpn.NMS_THRESH)
        slots = rpn.POST_NMS_TOPK_TEST
        boxes = torch.zeros((1, slots, 4))
        boxes[0, :len(props)] = t(np.asarray(props, np.float32))
        fields = dict(proposal_boxes=boxes, objectness_logits=torch.zeros((1, slots)),
                      is_valid=torch.arange(slots)[None] < len(props))
        model = port_model(port_cfg_from(cfg), variables)
        model.proposal_generator.proposals = lambda *a, **k: Instances(**fields)
        out = model.predict({"image": t(np.array(batch["image"])),
                             "image_size": t(np.array(batch["image_size"]))})
        return types.SimpleNamespace(**{k: v.numpy() for k, v in out.get_fields().items()})


def test_relation_passes_the_pipeline_oracle():
    """``tests/test_pipeline_oracle.py``'s relation oracle (numpy proposals,
    pooling, softmax, decode, candidates, the keep logits of the JAX module
    on the oracle's candidates, score x mean sigmoid, plain top-k) holds the
    port's ``predict`` from the oracle's proposals, at the oracle's own
    tolerances (scores rtol 3e-2, boxes 0.05 px)."""
    from tests import test_pipeline_oracle as oracle

    with repo_configs(), port_in(oracle), pytest.MonkeyPatch.context() as mp:
        mp.setattr(oracle, "build_model", OracleProposalsPortModel)
        oracle.test_relation_duplicate_removal_matches_numpy_oracle()


@pytest.mark.parametrize("opts", [{}, DUP_ON, {**DUP_ON, "MODEL.MASK_ON": True}],
                         ids=["yaml", "dup_on", "dup_on_mask"])
def test_relation_yaml_builds_the_jax_tree(opts):
    """The YAML's narrow model has the JAX model's tensors, name for name and
    shape for shape: ``box_heads_0/{fc1, relation1, fc2, relation2}`` and
    ``duplicate_removal`` (``roi_heads.duplicate_removal``)."""
    jcfg, tcfg = relation_cfgs(**opts)
    want = {k: tuple(v.shape) for k, v in convert_variables(jax_param_shapes(jcfg)).items()}
    assert _port_shapes(tcfg) == want
    assert "roi_heads.box_head.relation2.geometry_weight.weight" in want
    assert ("roi_heads.duplicate_removal.logit.weight" in want) == bool(opts)
    if opts:  # the YAML's five IoU heads
        assert want["roi_heads.duplicate_removal.logit.weight"] == (5, 128)


def test_jax_init_recipe_draws_lecun_normal_for_the_relation_layers():
    """``init_weights(..., "jax")``: every relation layer (the box head's fc1
    and fc2, the attention, the duplicate removal) as flax ``nn.Dense``
    draws it, a truncated normal of variance 1 / fan_in, zero bias (the
    moments of each tensor against the JAX model's init); the predictor
    keeps its small normals."""
    jcfg, tcfg = relation_cfgs(**DUP_ON, **{"MODEL.ROI_BOX_HEAD.FC_DIM": 256})
    batch = {"image": jnp.zeros((1, 64, 64, 3)), "image_size": jnp.asarray([[64, 64]], jnp.int32)}
    from detectron2_tensorflow_tpu.models import build_model as jax_build_model

    variables = jax.jit(jax_build_model(jcfg).init)(jax.random.PRNGKey(0), batch)
    want = {k: v.numpy() for k, v in convert_variables(
        jax.tree_util.tree_map(np.asarray, variables)).items()}
    model = GeneralizedRCNN(tcfg)
    init_weights(model, torch.Generator().manual_seed(0), "jax")
    got = {k: v.detach().numpy() for k, v in model.state_dict().items()}
    assert set(got) == set(want)
    names = [n for n in want
             if n.startswith(("roi_heads.box_head.", "roi_heads.duplicate_removal."))]
    assert len(names) == 2 * 2 + 2 * 2 * 5 + 2 * 3 + 2 * 5
    for name in names:
        g, w = got[name], want[name]
        if name.endswith(".bias"):
            assert not g.any() and not w.any(), name
            continue
        fan_in = w.shape[1]
        for x in (g, w):  # variance 1 / fan_in, bound 2 / (0.8796 sqrt(fan_in))
            assert abs(x.std() * math.sqrt(fan_in) - 1) < 0.02 + 3 / math.sqrt(x.size), name
            assert np.abs(x).max() <= 2 / (0.87962566 * math.sqrt(fan_in)) * (1 + 1e-6), name
        assert abs(g.mean()) < 4 * w.std() / math.sqrt(w.size), name
    np.testing.assert_allclose(got["roi_heads.box_predictor.cls_score.weight"].std(), 0.01,
                               rtol=0.1)


# -- training -------------------------------------------------------------------------------

def test_relation_yaml_trains_through_build_model_losses_and_tools_train(tmp_path):
    """Relation Networks train (nothing raises any more): ``build_model(...,
    training=True)`` builds the YAML with the duplicate removal, ``losses``
    gives finite ``loss_cls``, ``loss_box_reg`` and ``loss_dup`` whose
    backward reaches the relation modules and the removal, and ``tools.train
    --config_file`` the relation YAML takes 2 steps on the CPU from synthetic
    COCO images at narrow widths, writing its checkpoint and its summary."""
    from detectron2_tensorflow_tpu_torch.engine import make_train_batch
    from detectron2_tensorflow_tpu_torch.tools import make_synthetic_coco

    few = {"MODEL.RPN.PRE_NMS_TOPK_TRAIN": 200, "MODEL.RPN.POST_NMS_TOPK_TRAIN": 100,
           "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE": 64}  # the CPU's NMS is slow
    _, tcfg = relation_cfgs(**DUP_ON, **few, **{"INPUT.MAX_GT_INSTANCES": 5})
    model = build_model(tcfg, device="cpu", training=True)
    assert model.training
    batch = {k: torch.from_numpy(v) for k, v in make_train_batch(tcfg, 128, 160).items()}
    losses = model.losses(batch, generator=torch.Generator().manual_seed(0))
    assert tuple(losses)[2:] == ("loss_cls", "loss_box_reg", "loss_dup")
    assert all(bool(torch.isfinite(v)) and float(v.detach()) > 0 for v in losses.values())
    sum(losses.values()).backward()
    for name in ("roi_heads.box_head.relation1.query.weight",
                 "roi_heads.duplicate_removal.logit.weight"):
        assert float(dict(model.named_parameters())[name].grad.abs().max()) > 0, name
    root = tmp_path / "coco"
    make_synthetic_coco.main([str(root), "2", "3"])
    small = {"TRANSFORM.RESIZE.MIN_SIZE_TRAIN": (128,), "TRANSFORM.RESIZE.MAX_SIZE_TRAIN": 160,
             "INPUT.PAD_BUCKETS": ((128, 160), (160, 128)), "SOLVER.IMS_PER_BATCH": 2,
             "INPUT.MAX_GT_INSTANCES": 8, "MODEL.ROI_HEADS.NUM_CLASSES": 3}
    opts = [str(x) for kv in {**RELATION_NARROW, **DUP_ON, **few, **small}.items() for x in kv]
    summary = tools_train.main(["--device", "cpu", "--max_iter", "2", "--config_file",
                                os.path.join(REPO, RELATION_YAML), "DATASETS.ROOT_DIR",
                                str(root), "LOGS.ROOT_DIR", str(tmp_path / "logs"), *opts])
    assert summary["steps"] == 2 and summary["step"] == 2
    assert "loss_dup" in summary["final_losses"]
    assert all(np.isfinite(v) for v in summary["final_losses"].values())
    assert summary["launches"] == {k: 0 for k in summary["launches"]}
    assert os.listdir(summary["checkpoint_dir"])
