"""YOLOv4 training against the JAX package: the aligned IoU family, the YOLO
matcher and its losses, one train step, the BN statistics, DarkNet's frozen
stages and the overfit tool's recipe.

The IoU family (``structures/boxes.py``) runs on seeded boxes plus the cases
where the clamps act: equal boxes (every max and min a tie, whose gradient
both packages split in halves), zero-size boxes (every non-responding slot
of ``tgt_boxes``), boxes below ``EPS`` wide and disjoint boxes; values 1e-6
and gradients 1e-5 of their largest magnitude. The matcher and the losses
run on seeded float32 head maps of a 64 x 128 input with the overfit
recipe's anchors (``YOLO_OVERFIT_ANCHORS``), whose 10-30 px boxes put
candidates on both sides of the background threshold, and on a hand-made
GT set: a crowd box, a padded slot, a box centred on a cell's edge, boxes
centred right of and left of the image (flat indices past the end and below
0, which the JAX scatter drops and wraps) and two boxes on one slot. The
JAX assignment is read from its ``per_image`` (``jax.vmap`` wrapped in the
JAX module's namespace for the call); it must be equal, slot for slot, the
losses 1e-5 relative, their gradients by the maps 1e-4 of their largest.

The step: the narrow model of ``test_torch_yolov4.py`` (``YOLO_NARROW``) at
192 x 256, the YAML's ``FREEZE_AT 2``, every BN affine at scale 0.5 and
bias +1 or -1, a seeded sign per channel (``kink_free``). Both are
rounding, not faults: at the JAX init (scale 1, bias 0) a leaky ReLU input
that one package rounds to the other side of 0 moves a gradient slice by
0.9 of it (5% of some gradients' largest magnitude); at scale 0.3 and bias 1
everywhere (``test_torch_norms_syncbn.tie_free``) every channel's mean
dwarfs its spread, and the BN's fast variance ``E[x^2] - E[x]^2`` (both
packages') loses ~500 times float32's precision (2.5e-4 apart). At
these weights a kink needs a 2 sigma activation and the next conv mixes
positive and negative means: 3e-5 apart at most. Gradients and one
step's update 1e-4 of each tensor's largest magnitude. A neck BN channel
whose output reaches the loss only through other BNs (in the leaky ReLUs'
linear part) has a zero bias gradient; each package's rounding of it (~1e-9)
is held below 1e-4 of the scale's largest gradient instead, and the bias's
other channels are held as every gradient is. DarkNet's freezing is
pinned: the port freezes what its forward detaches (the stem and ``res1``)
and trains ``res2``, the JAX optax chain over the same trainable parameters
(``FREEZE_AT 1``'s mask) gives every update the port makes; the JAX
solver's own ``FREEZE_AT 2`` mask climbs ``res2``'s gradient and decays
``res1`` (ROADMAP Queue 3).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu import solver as jsolver
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.meta_arch.single_stage import _build_backbone_neck
from detectron2_tensorflow_tpu.models.single_stage import yolov4 as jax_yolov4_module
from detectron2_tensorflow_tpu.structures import boxes as jboxes
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import build_train_step, create_train_state
from detectron2_tensorflow_tpu_torch.models import SingleStageDetector, build_model
from detectron2_tensorflow_tpu_torch.models.backbones.darknet import DarkNet53
from detectron2_tensorflow_tpu_torch.models.backbones.resnet import ResNet
from detectron2_tensorflow_tpu_torch.models.layers import BatchNorm2d
from detectron2_tensorflow_tpu_torch.models.single_stage.yolov4 import YOLOv4
from detectron2_tensorflow_tpu_torch.structures import boxes as tboxes
from detectron2_tensorflow_tpu_torch.tools.overfit_check import YOLO_OVERFIT_ANCHORS
from test_torch_c4 import LOSS_RTOL, _tagged, check_overfit_cfg, jax_param_shapes, run_overfit_check
from test_torch_train import GRAD_TOL, assert_grad_close, assert_update_close
from test_torch_yolov4 import yolo_cfgs
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

B, H, W, K = 2, 64, 128, 4
LOSS_KEYS = {"box_loss", "conf_loss", "cls_loss"}
FNS = ("matched_iou", "matched_giou", "matched_diou", "matched_ciou")


# -- the aligned IoU family ------------------------------------------------------------------

def box_pairs():
    """Seeded pairs plus the clamps' cases (module docstring), ``[N, 4]`` each."""
    rng = np.random.default_rng(0)
    lo = rng.uniform(0, 50, (48, 2))
    b1 = np.concatenate([lo, lo + rng.uniform(1, 30, (48, 2))], 1)
    lo2 = lo + rng.normal(0, 5, (48, 2))
    b2 = np.concatenate([lo2, lo2 + rng.uniform(1, 30, (48, 2))], 1)
    special1 = [[5, 5, 20, 30], [-5, -5, 5, 5], [0, 0, 10, 10], [0, 0, 5e-9, 5e-9],
                [2, 2, 9, 4], [3, 3, 3, 3], [0, 0, 10, 10], [10, 10, 20, 20]]
    special2 = [[5, 5, 20, 30], [0, 0, 0, 0], [30, 30, 30, 30], [0, 0, 4e-9, 7e-9],
                [40, 40, 50, 60], [0, 0, 8, 8], [0, 0, 10, 10.5], [10, 10, 20, 20]]
    return (np.concatenate([b1, special1]).astype(np.float32),
            np.concatenate([b2, special2]).astype(np.float32))


@pytest.mark.parametrize("fn", FNS)
def test_matched_iou_family_matches_jax(fn):
    """Values and the gradients of their sum by both boxes, finite
    everywhere (a zero-size target gives the JAX value, not NaN)."""
    b1, b2 = box_pairs()
    jfn = getattr(jboxes, fn)
    want = np.asarray(jfn(jnp.asarray(b1), jnp.asarray(b2)))
    jg1, jg2 = jax.grad(lambda x, y: jfn(x, y).sum(), argnums=(0, 1))(jnp.asarray(b1),
                                                                      jnp.asarray(b2))
    t1 = torch.from_numpy(b1).requires_grad_()
    t2 = torch.from_numpy(b2).requires_grad_()
    got = getattr(tboxes, fn)(t1, t2)
    got.sum().backward()
    assert np.isfinite(want).all() and np.isfinite(np.asarray(jg1)).all()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6, atol=1e-6)
    for g, w in ((t1.grad.numpy(), np.asarray(jg1)), (t2.grad.numpy(), np.asarray(jg2))):
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-5 * np.abs(w).max())
    # the equal boxes: both packages halve the ties' gradients, so those are
    # the JAX values (not clamp's, which passes all of it), up to rounding
    np.testing.assert_allclose(t1.grad.numpy()[48], np.asarray(jg1)[48], rtol=1e-5, atol=1e-7)


def test_ciou_alpha_is_a_constant_in_the_gradient():
    """CIoU's ``alpha`` is detached, as the JAX ``stop_gradient``: the port's
    gradient is JAX's and differs from the one with ``alpha`` live."""
    b1, b2 = box_pairs()
    t1 = torch.from_numpy(b1).requires_grad_()
    tboxes.matched_ciou(t1, torch.from_numpy(b2)).sum().backward()

    def live(x, y):
        iou = jboxes.matched_iou(x, y)
        w1, h1 = jnp.maximum(x[:, 2] - x[:, 0], 1e-8), jnp.maximum(x[:, 3] - x[:, 1], 1e-8)
        w2, h2 = jnp.maximum(y[:, 2] - y[:, 0], 1e-8), jnp.maximum(y[:, 3] - y[:, 1], 1e-8)
        v = (4.0 / jnp.pi ** 2) * (jnp.arctan(w2 / h2) - jnp.arctan(w1 / h1)) ** 2
        return (jboxes.matched_diou(x, y) - v / jnp.maximum(1.0 - iou + v, 1e-8) * v).sum()

    want = np.asarray(jax.grad(lambda x: jboxes.matched_ciou(x, jnp.asarray(b2)).sum())(
        jnp.asarray(b1)))
    with_alpha = np.asarray(jax.grad(live)(jnp.asarray(b1), jnp.asarray(b2)))
    np.testing.assert_allclose(t1.grad.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())
    assert np.abs(with_alpha - want).max() > 1e-3 * np.abs(want).max()


# -- the matcher and the losses -------------------------------------------------------------

def matcher_cfgs():
    return yolo_cfgs(**{"MODEL.ANCHOR_GENERATOR.SIZES": YOLO_OVERFIT_ANCHORS,
                        "INPUT.MAX_GT_INSTANCES": 8})


def hand_gt():
    """Two images of 8 GT slots (module docstring). Image 0: slots 2 and 3 are
    12 x 12 boxes centred in one stride-8 cell (the same anchor and slot),
    slot 4 is centred on the cell edge x = 32, slot 5 is crowd, slot 6 is
    centred at x = 130 (past the right edge: the flat index runs into the next
    row), slot 7 padded. Image 1: seeded 10-30 px boxes, its slot 0 a 4 x 8
    box centred at (-4, 4) (flat index -2, so the last candidate but one),
    its last two slots padded."""
    rng = np.random.default_rng(1)
    boxes = np.zeros((B, 8, 4), np.float32)
    lo = rng.uniform(0, 1, (B, 8, 2)) * [90, 30]
    boxes[..., :2] = lo
    boxes[..., 2:] = lo + rng.uniform(10, 30, (B, 8, 2))
    boxes[0, 2] = [10, 20, 22, 32]
    boxes[0, 3] = [11, 21, 23, 33]
    boxes[0, 4] = [26, 10, 38, 30]
    boxes[0, 6] = [122, 40, 138, 52]
    boxes[1, 0] = [-6, 0, -2, 8]
    classes = rng.integers(0, K, (B, 8)).astype(np.int32)
    valid = np.ones((B, 8), bool)
    valid[0, 7] = valid[1, 6:] = False
    crowd = np.zeros((B, 8), bool)
    crowd[0, 5] = True
    return {"gt_boxes": boxes, "gt_classes": classes, "gt_valid": valid, "gt_is_crowd": crowd}


def head_maps(jcfg, seed=2):
    """Seeded float32 maps, NHWC, for each level of a 64 x 128 input."""
    rng = np.random.default_rng(seed)
    a = 3 * (5 + K)
    return [rng.normal(0, 1, (B, H // s, W // s, a)).astype(np.float32) for s in (8, 16, 32)]


@pytest.fixture(scope="module")
def matcher():
    """Both packages' YOLOv4 on the same maps and GT: the assignment, the losses and
    their gradients by the maps."""
    jcfg, tcfg = matcher_cfgs()
    _, _, neck_shapes, _ = _build_backbone_neck(jcfg)
    jyolo = jax_yolov4_module.YOLOv4(jcfg, neck_shapes)
    tyolo = YOLOv4(tcfg, [8, 16, 32])
    maps, gt = head_maps(jcfg), hand_gt()
    jgt = {k: jnp.asarray(v) for k, v in gt.items()}
    recorded = []

    class RecordingJax:
        def __getattr__(self, name):
            return getattr(jax, name)

        @staticmethod
        def vmap(fn, *args, **kwargs):
            mapped = jax.vmap(fn, *args, **kwargs)
            if fn.__name__ != "per_image":
                return mapped
            return lambda *xs: recorded.append(mapped(*xs)) or recorded[-1]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_yolov4_module, "jax", RecordingJax())
        j_losses = jyolo.losses([jnp.asarray(m) for m in maps], jgt)
    j_grads = jax.grad(lambda ms: sum(jyolo.losses(ms, jgt).values()))(
        [jnp.asarray(m) for m in maps])
    tmaps = [torch.from_numpy(np.ascontiguousarray(m.transpose(0, 3, 1, 2))).requires_grad_()
             for m in maps]
    tgt = {k: torch.from_numpy(v) for k, v in gt.items()}
    t_losses = tyolo.losses(tmaps, tgt)
    sum(t_losses.values()).backward()
    with torch.no_grad():
        boxes, _, _ = tyolo.decode([m.detach() for m in tmaps])
        t_assign = tyolo.assign(boxes, tgt, [(H // s, W // s) for s in (8, 16, 32)])
    return dict(gt=gt, tyolo=tyolo, j_assign=[np.asarray(x) for x in recorded[0]],
                t_assign=[x.numpy() for x in t_assign],
                j_losses={k: float(v) for k, v in j_losses.items()},
                t_losses={k: float(v.detach()) for k, v in t_losses.items()},
                j_grads=[np.asarray(g) for g in j_grads],
                t_grads=[m.grad.permute(0, 2, 3, 1).numpy() for m in tmaps])


@pytest.mark.parametrize("field", ["respond", "bgd", "tgt_boxes", "tgt_cls"])
def test_assignment_equals_jax(matcher, field):
    i = ["respond", "bgd", "tgt_boxes", "tgt_cls"].index(field)
    got, want = matcher["t_assign"][i], matcher["j_assign"][i]
    assert got.shape == want.shape and got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)


def test_assignment_covers_the_hand_made_cases(matcher):
    """What the GT set is for: 11 of its 12 usable GT respond (the colliding
    pair shares one slot), the later of the colliding GT is the one XLA's
    CPU scatter keeps, the one centred left of the image wraps to the last
    candidate but one, and some candidates are background and some are
    not."""
    respond, bgd, tgt_boxes, _ = matcher["j_assign"]
    assert respond.sum(1).tolist() == [5.0, 6.0], respond.sum(1)
    gt = matcher["gt"]
    rows = np.flatnonzero((tgt_boxes[0] == gt["gt_boxes"][0, 3]).all(-1))
    assert len(rows) == 1 and not (tgt_boxes[0] == gt["gt_boxes"][0, 2]).all(-1).any()
    assert not (tgt_boxes[0] == gt["gt_boxes"][0, 5]).all(-1).any()  # crowd: no target
    assert not (tgt_boxes[0] == gt["gt_boxes"][0, 7]).all(-1).any()  # padded: no target
    wrapped = np.flatnonzero((tgt_boxes[1] == gt["gt_boxes"][1, 0]).all(-1))
    assert wrapped.tolist() == [respond.shape[1] - 2], wrapped
    assert 0 < bgd.sum() < bgd.size - respond.sum()
    assert not (bgd * respond).any()


def test_losses_match_jax(matcher):
    got, want = matcher["t_losses"], matcher["j_losses"]
    assert set(got) == set(want) == LOSS_KEYS
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
        assert want[k] > 0


@pytest.mark.parametrize("level", [0, 1, 2])
def test_loss_gradients_by_the_maps_match_jax(matcher, level):
    assert_grad_close(matcher["t_grads"][level], matcher["j_grads"][level], f"level {level}")


# -- one train step ---------------------------------------------------------------------------

STEP_H, STEP_W = 192, 256


def step_batch():
    rng = np.random.default_rng(3)
    gt = hand_gt()
    return {"image": rng.uniform(0, 255, (B, STEP_H, STEP_W, 3)).astype(np.float32),
            "image_size": np.array([[STEP_H, STEP_W], [120, 150]], np.int32), **gt}


def jax_updates(jcfg, params, grads):
    """The JAX optax chain's first updates (before they are added) of
    ``params`` for ``grads``, through one jitted function."""
    tx = jsolver.build_optimizer(jcfg, params)
    return jax.jit(lambda g, p: tx.update(g, tx.init(p), p)[0])(grads, params)


def kink_free(variables, seed=4):
    """The variables with every BN affine at scale 0.5 and bias +1 or -1 (a
    seeded sign per channel), so that neither package's rounding decides a
    gradient (module docstring)."""
    rng = np.random.default_rng(seed)
    v = jax.tree_util.tree_map(lambda x: np.array(np.asarray(x)), variables)

    def set_affine(path, x):
        keys = [getattr(k, "key", str(k)) for k in path]
        if not any("Norm_0" in k for k in keys):
            return x
        if keys[-1] == "scale":
            return np.full_like(x, 0.5)
        return rng.choice(np.array([-1.0, 1.0], np.float32), x.shape)

    v["params"] = jax.tree_util.tree_map_with_path(set_affine, v["params"])
    return v


def zero_bias_channels(grads):
    """``{name: mask}`` of the BN bias channels whose gradient is zero in exact
    arithmetic (module docstring): below 1e-6 of the scale's largest
    gradient, where a channel that reaches the loss otherwise reads 1e-4 or
    more."""
    zero = {}
    for n, g in grads.items():
        if n.endswith(".norm.bias"):
            mask = np.abs(g) <= 1e-6 * np.abs(grads[n[:-4] + "weight"]).max()
            if mask.any():
                zero[n] = mask
    return zero


@pytest.fixture(scope="module")
def yolo_step():
    """One step of both packages from the same tie-free weights and batch:
    losses, gradients, the BN statistics after the losses, the port's
    update and the JAX optax chain's under the YAML's mask and under the
    mask of what the port trains."""
    jcfg, tcfg = matcher_cfgs()
    for cfg in (jcfg, tcfg):
        cfg.SOLVER.IMS_PER_BATCH = B
    nb = step_batch()
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    jmodel = jax_build_model(jcfg)
    variables = kink_free(jax.jit(jmodel.init)(jax.random.PRNGKey(0), {
        k: jbatch[k] for k in ("image", "image_size")}))

    def total(p):
        t, (losses, state) = jmodel.loss_fn({**variables, "params": p}, jbatch,
                                            jax.random.PRNGKey(1), {})
        return t, (losses, state)

    (_, (j_losses, j_state)), j_grads = jax.tree_util.tree_map(
        np.asarray, jax.jit(jax.value_and_grad(total, has_aux=True))(variables["params"]))
    start = convert_variables(variables)
    tmodel = build_model(tcfg, device="cpu", state_dict=start, training=True)
    t_losses = tmodel.losses(tbatch)
    sum(t_losses.values()).backward()
    step_model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    state = create_train_state(tcfg, step_model, torch.Generator().manual_seed(0))
    build_train_step(tcfg, state)(tbatch)
    trains_jcfg = copy.deepcopy(jcfg)
    trains_jcfg.MODEL.BACKBONE.FREEZE_AT = 1  # the JAX mask of what the port trains
    updates = {key: {n: t.numpy() for n, t in convert_variables({"params": jax.tree_util.tree_map(
        np.asarray, jax_updates(c, variables["params"], j_grads))}).items()}
        for key, c in (("yaml", jcfg), ("port", trains_jcfg))}
    stats = convert_variables({"params": variables["params"],
                               "batch_stats": j_state["batch_stats_updates"]})
    bn = {f"{m}.{b}" for m, mod in tmodel.named_modules() if isinstance(mod, BatchNorm2d)
          for b in ("running_mean", "running_var")}
    return dict(
        start=start, j_losses={k: float(v) for k, v in j_losses.items()},
        t_losses={k: float(v.detach()) for k, v in t_losses.items()},
        j_grads={k: v.numpy() for k, v in convert_variables({"params": j_grads}).items()},
        t_grads={n: p.grad.numpy().copy() for n, p in tmodel.named_parameters()
                 if p.grad is not None},
        j_stats={k: v.numpy() for k, v in stats.items() if "running_" in k},
        t_stats={k: v.numpy() for k, v in tmodel.state_dict().items() if k in bn},
        after={n: p.detach().numpy().copy() for n, p in step_model.named_parameters()},
        updates=updates,
        trainable=set(tsolver.trainable_parameters(tmodel, 2)))


def test_step_losses_match_jax(yolo_step):
    got, want = yolo_step["t_losses"], yolo_step["j_losses"]
    assert set(got) == set(want) == LOSS_KEYS
    for k in LOSS_KEYS:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)


def test_step_gradients_match_jax(yolo_step):
    """Every trainable parameter's gradient (the head, the neck, DarkNet's
    res2-res5) against ``jax.grad``; the stem and res1, whose outputs both
    forwards detach, have none in the port and zeros in JAX."""
    want, got = yolo_step["j_grads"], yolo_step["t_grads"]
    assert set(got) == yolo_step["trainable"]
    zero = zero_bias_channels(want)
    assert zero and all(not n.startswith(("head.", "backbone.bottom_up.")) for n in zero), zero
    for name, w in want.items():
        if name not in got:
            assert name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res1."))
            assert not w.any(), name
            continue
        g = got[name]
        if name in zero:
            bound = GRAD_TOL * np.abs(want[name[:-4] + "weight"]).max()
            assert np.abs(g[zero[name]]).max() <= bound, name
            g, w = g[~zero[name]], w[~zero[name]]
            if not w.size:
                continue
        assert_grad_close(g, w, name)


def test_step_bn_statistics_match_the_jax_tape(yolo_step):
    """The neck's and the head's BN running statistics after one ``losses``
    call against the JAX ``StatsTape``'s: every one moved, 1e-5."""
    got, want = yolo_step["t_stats"], yolo_step["j_stats"]
    assert set(got) == set(want) and got
    start = yolo_step["start"]
    for name, w in want.items():
        np.testing.assert_allclose(got[name], w, rtol=1e-5, atol=1e-6, err_msg=name)
        assert not np.array_equal(w, start[name].numpy()), name


def test_step_update_matches_the_jax_chain_over_what_the_port_trains(yolo_step):
    """``build_train_step``'s update against the JAX optax chain (clip, decay,
    momentum, schedule) masked to the port's trainable parameters; the stem
    and res1 stay as they were (JAX's chain decays res1: pinned below)."""
    start, after, updates = yolo_step["start"], yolo_step["after"], yolo_step["updates"]["port"]
    for name, p in after.items():
        if name in yolo_step["trainable"]:
            s = start[name].numpy()
            assert_update_close(p, s + updates[name], s, GRAD_TOL, name)
        else:
            np.testing.assert_array_equal(p, start[name].numpy(), err_msg=name)


def test_jax_freeze_at_2_climbs_res2_and_decays_res1(yolo_step):
    """The JAX solver's own mask at the YAML's ``FREEZE_AT 2`` (ROADMAP Queue
    3): ``res2`` takes ``p + grad`` (``optax.masked`` passes the raw
    gradient), ``res1`` takes weight decay and momentum on its zero
    gradient, the stem stays; the port trains ``res2`` and leaves ``res1``."""
    start, grads, after = yolo_step["start"], yolo_step["j_grads"], yolo_step["after"]
    yaml, port = yolo_step["updates"]["yaml"], yolo_step["updates"]["port"]
    trunk = "backbone.bottom_up."
    res1 = [n for n in grads if n.startswith(trunk + "res1.")]
    res2 = [n for n in grads if n.startswith(trunk + "res2.")]
    assert res1 and res2
    for n in res2:  # the raw gradient, where the port's chain descends
        np.testing.assert_array_equal(yaml[n], grads[n], err_msg=n)
        assert n in yolo_step["trainable"] and port[n].any(), n
    for n in res1:  # weight decay and momentum on a zero gradient
        assert not grads[n].any() and port[n].any(), n
        np.testing.assert_array_equal(yaml[n], port[n], err_msg=n)
        np.testing.assert_array_equal(after[n], start[n].numpy(), err_msg=n)
    for n in (n for n in grads if n.startswith(trunk + "stem.")):
        assert not yaml[n].any() and not port[n].any(), n


# -- the frozen stages, the recipe ------------------------------------------------------------

@pytest.mark.parametrize("freeze_at", [0, 1, 2, 3, 5])
def test_darknet_freezes_what_its_forward_detaches(freeze_at):
    """``trainable_parameters`` leaves out the stem from ``FREEZE_AT 1`` on and
    res{i} from ``i + 1`` on, exactly the modules whose outputs the forward
    detaches; against the JAX ``trainable_mask`` (the stem and res2 ..
    res{F}, the ResNet's names) the two differ in res1 .. res{F - 1} against
    res{F} only (ROADMAP Queue 3)."""
    jcfg, tcfg = yolo_cfgs(**{"MODEL.BACKBONE.FREEZE_AT": freeze_at})
    params = jax_param_shapes(jcfg)["params"]
    names = list(convert_variables({"params": _tagged(params)}).items())
    by_tag = {int(v.reshape(-1)[0]): k for k, v in names}
    mask = jax.tree_util.tree_leaves(jsolver.trainable_mask(params, freeze_at))
    jax_trains = {by_tag[i] for i, m in enumerate(mask) if m}
    with torch.device("meta"):
        model = SingleStageDetector(tcfg)
    got = set(tsolver.trainable_parameters(model, freeze_at))
    frozen = (["stem"] if freeze_at >= 1 else []) + [f"res{i}" for i in range(1, freeze_at)]
    assert DarkNet53.frozen_modules(freeze_at) == frozen
    prefix = tuple(f"backbone.bottom_up.{m}." for m in frozen)
    assert got == {n for n, _ in model.named_parameters() if not n.startswith(prefix)}
    trunk = "backbone.bottom_up."
    jax_frozen = (trunk + "stem.",) + tuple(f"{trunk}res{i}." for i in range(2, freeze_at + 1))
    assert jax_trains == {n for n, _ in model.named_parameters() if not n.startswith(jax_frozen)}
    assert ResNet.frozen_modules(freeze_at) == ["stem"] + [f"res{i}" for i in
                                                           range(2, freeze_at + 1)]


def test_overfit_recipe_matches_the_jax_tool():
    """``overfit_cfg("yolov4")`` is the JAX tool's, key for key: 3 classes,
    the scaled 3 x 3 anchor ladder kept (no FPN ladder), R18-style GN,
    ``FREEZE_AT 0``, the small input's buckets."""
    check_overfit_cfg("yolov4")


def test_overfit_check_runs_yolov4(capsys):
    """``tools.overfit_check 1 --arch yolov4 --device cpu`` at narrow widths
    (a trainable-BN trunk: GN needs 32 channels a layer) prints its JSON."""
    out = run_overfit_check("yolov4", [
        "MODEL.RESNETS.NORM", "BN", "MODEL.RESNETS.STEM_OUT_CHANNELS", "8",
        "MODEL.RESNETS.RES2_OUT_CHANNELS", "16", "MODEL.NECK.OUT_CHANNELS", "16",
        "MODEL.YOLOV4.CONV_DIMS", "16"], capsys, steps=1)
    assert out["arch"] == "yolov4" and out["steps"] == 1 and np.isfinite(out["final_loss"])
    assert 0.0 <= out["bbox_ap50"] <= 100.0 and "segm_ap" not in out
