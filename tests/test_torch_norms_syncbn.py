"""The SyncBN Mask R-CNN (``configs/Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml``)
against the JAX package: the converted weights, ``predict``, the train
step's losses, gradients, running statistics and update, the norm decay
group, and serving on running statistics from a training model. The
tests, the ``pair`` / ``step`` fixtures and their tolerances are those of
``test_torch_norms_layers.py``'s docstring; ``test_torch_norms_gn.py`` runs
the same tests on the GN YAML.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu import solver as jsolver
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu.models.meta_arch.common import StatsTape
from detectron2_tensorflow_tpu.models.meta_arch.rcnn import _build_rcnn_parts, _RCNNDrivers
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.engine import (
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.models import build_model
from test_torch_train import (
    GRAD_TOL,
    LOSS_RTOL,
    MASK_LOSS_RTOL,
    assert_grad_close,
    assert_update_close,
    fixed_jax_proposals,
    jax_noise,
    jax_proposals,
    jax_updated_params,
)

from test_torch_norms_layers import (
    ATOL,
    B,
    G,
    GN_YAML,
    H,
    INIT_KEY,
    RTOL,
    SYNCBN_YAML,
    W,
    assert_close_to_max,
    images,
    jax_stats,
    port_stats,
    tame_norm_variables,
    yaml_cfgs,
)
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

# -- the SyncBN and GN models ------------------------------------------------------------

def make_pair(name):
    """Both packages' serving models of ``name``'s YAML (``syncbn`` or
    ``gn``), from the same tamed weights."""
    jcfg, tcfg = yaml_cfgs(SYNCBN_YAML if name == "syncbn" else GN_YAML)
    batch, tbatch = images()
    jmodel = jax_build_model(jcfg)
    variables = tame_norm_variables(jax.jit(jmodel.init)(jax.random.PRNGKey(INIT_KEY), batch))
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.predict)(variables, batch))
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    return dict(name=name, jcfg=jcfg, tcfg=tcfg, variables=variables, batch=batch,
                tbatch=tbatch, jout=jout, tmodel=tmodel, tout=tmodel.predict(tbatch))


@pytest.fixture(scope="module", params=["syncbn"])
def pair(request):
    return make_pair(request.param)


def test_norm_models_load_converted_weights_by_name(pair):
    """Every JAX variable, ``batch_stats`` included, has its port tensor, name
    for name (D2's ``...conv1.norm.running_mean``, ``box_head.conv1.norm``)."""
    sd = convert_variables(pair["variables"])
    want = pair["tmodel"].state_dict()
    assert set(sd) == set(want)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(want[k].shape), k
    if pair["name"] == "syncbn":
        assert "backbone.bottom_up.stem.conv1.norm.running_mean" in sd
        assert "roi_heads.box_head.conv4.norm.running_var" in sd
        assert "roi_heads.mask_head.mask_fcn4.norm.running_var" in sd
        for k, v in sd.items():
            if ".running_" in k or ".norm." in k:
                assert want[k].dtype == torch.float32, k  # BN stays float32 in serving


def test_norm_models_predict_matches_jax(pair):
    jout, tout = pair["jout"], pair["tout"]
    valid = tout.is_valid.numpy()
    np.testing.assert_array_equal(valid, jout.is_valid)
    assert valid.sum() >= 20
    np.testing.assert_array_equal(tout.pred_classes.numpy(), jout.pred_classes)
    np.testing.assert_allclose(tout.boxes.numpy(), jout.boxes, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tout.scores.numpy(), jout.scores, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(tout.pred_masks.numpy(), jout.pred_masks, rtol=RTOL, atol=1e-5)


def tie_free(variables):
    """The variables with every BN/GN affine at scale 0.3, bias 1 and the
    biases of the box head's FC and the mask head's deconv, which a ReLU
    follows, at 3, so that no ReLU input of the heads lies near 0.

    A normalized activation is ~N(0, 1), so at scale 1 and bias 0 many ReLU
    inputs sit within the two packages' float32 noise of 0, and each one
    that falls on the other side moves a gradient slice: measured, the
    port's own trunk gradients moved by up to 42% of their largest value
    when the images moved by 1e-6 relative, and the box and mask heads' by
    ~1%. With bias 1 at scale 0.3 a tie needs a -3.3 sigma activation
    (the ReLUs still run; their masks are nearly all ones). Ties are rounding, not a
    fault, as ROADMAP Queue 3 records for the ReLU inputs of the tests'
    JAX init."""
    v = jax.tree_util.tree_map(lambda x: np.array(np.asarray(x)), variables)

    def set_affine(path, x):
        keys = [getattr(k, "key", str(k)) for k in path]
        if any("Norm_0" in k for k in keys):
            return np.full_like(x, 0.3 if keys[-1] == "scale" else 1.0)
        if keys[-1] == "bias" and keys[:2] in (["mask_head", "deconv"], ["box_heads_0", "fc1"]):
            return np.full_like(x, 3.0)
        return x

    v["params"] = jax.tree_util.tree_map_with_path(set_affine, v["params"])
    return v


@contextlib.contextmanager
def per_apply_stats(into):
    """Record, in ``into``, each ``train=True`` apply's own statistics: the
    ``batch_stats`` subtrees of the modules that apply runs (the trunk and
    neck for ``compute_features``, the box head for ``box``, the mask head
    for ``mask``), which the JAX tape's merge would overwrite."""
    owners = {"compute_features": ("backbone", "neck"), "box": ("box_heads_0",),
              "mask": ("mask_head",)}
    real = StatsTape.apply

    def apply(self, module, variables, *args, **kwargs):
        if not self.track or not kwargs.get("train", False):
            return real(self, module, variables, *args, **kwargs)
        out, new = module.apply(variables, *args, mutable=["batch_stats"], **kwargs)
        for top in owners.get(kwargs.get("method"), ()):
            into[top] = new["batch_stats"][top]
        return out

    StatsTape.apply = apply
    try:
        yield
    finally:
        StatsTape.apply = real


@pytest.fixture(scope="module")
def step(pair):
    """One training step of both packages from the same weights, noise and
    (the JAX package's) proposals; with BN, the running statistics each
    writes."""
    jcfg, tcfg, variables = pair["jcfg"], pair["tcfg"], tie_free(pair["variables"])
    nb = make_train_batch(tcfg, H, W)
    nb["gt_masks"] = np.random.default_rng(1).uniform(0, 1, nb["gt_masks"].shape[:2] + (
        28, 28)).astype(np.float32)
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    drv = _RCNNDrivers(jcfg, *_build_rcnn_parts(jcfg))
    step_rng = jax.random.PRNGKey(1)
    rng_rpn, rng_roi = jax.random.split(step_rng)

    def raw_proposals(v, b):
        _, logits, deltas = drv.features_and_rpn(v, b, True)
        return drv.rpn.proposals(logits, deltas, b["image_size"], training=True)

    j_raw = jax.tree_util.tree_map(np.asarray, jax.jit(raw_proposals)(variables, jbatch))

    def total_loss(params):
        total, (loss_dict, aux) = drv.loss_fn({**variables, "params": params}, jbatch,
                                              step_rng, {})
        return total, (loss_dict, aux)

    with fixed_jax_proposals(drv, j_raw):
        (j_total, (j_losses, aux)), j_grads = jax.jit(
            jax.value_and_grad(total_loss, has_aux=True))(variables["params"])
        own = {}
        with per_apply_stats(own):
            drv.loss_fn(variables, jbatch, step_rng, {})
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables),
                         training=True)
    with torch.no_grad():
        feats = tmodel.features(tbatch["image"])
        rpn = tmodel.proposal_generator
        n_anchors = sum(l[0].numel() for l in rpn.rpn_head([feats[f] for f in rpn.in_features])[0])
    tmodel.load_state_dict(convert_variables(variables))  # the statistics that probe wrote
    noise = {"rpn": jax_noise(rng_rpn, B, n_anchors),
             "roi": jax_noise(rng_roi, B, j_raw.is_valid.shape[1] + G)}
    with jax_proposals(tmodel, j_raw):
        t_losses = tmodel.losses(tbatch, noise=noise)
    sum(t_losses.values()).backward()
    tape = aux.get("batch_stats_updates")
    return dict(pair, variables=variables, tbatch=tbatch, j_raw=j_raw, noise=noise, j_total=float(j_total),
                j_losses={k: float(v) for k, v in j_losses.items()},
                j_grads=jax.tree_util.tree_map(np.asarray, j_grads), tmodel=tmodel,
                t_losses={k: float(v.detach()) for k, v in t_losses.items()},
                t_grads={n: p.grad.numpy().copy() for n, p in tmodel.named_parameters()
                         if p.grad is not None},
                j_stats=None if tape is None else jax_stats(variables, own),
                j_tape=None if tape is None else jax_stats(variables, tape),
                t_stats=port_stats(tmodel))


def test_norm_models_train_step_losses_match_jax(step):
    got, want = step["t_losses"], step["j_losses"]
    assert set(got) == set(want) and len(got) == 5
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=MASK_LOSS_RTOL if k == "loss_mask"
                                   else LOSS_RTOL, err_msg=k)


# The parameters whose step gradients are held to GRAD_TOL (see the module
# docstring); the normed layers are held layer by layer.
HELD = ("roi_heads.box_head.fc", "roi_heads.box_predictor.", "roi_heads.mask_head.predictor.")


def test_norm_models_train_step_gradients_match_jax(step):
    want = convert_variables({"params": step["j_grads"]})
    trainable = tsolver.trainable_parameters(step["tmodel"], 2)
    assert set(step["t_grads"]) == set(trainable)
    held = [n for n in trainable if n.startswith(HELD)]
    assert len(held) == 8
    for name, w in want.items():
        if name in held:
            assert_grad_close(step["t_grads"][name], w.numpy(), name)
        elif name in trainable:
            assert np.isfinite(step["t_grads"][name]).all() and w.numpy().any(), name
        else:
            assert name.startswith(("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")), name
            assert not w.numpy().any(), name


def test_syncbn_train_step_moves_every_running_statistic_as_jax(step):
    """Every running statistic after the step's forward equals the one its
    JAX apply writes (the frozen stem's and res2's too: the reference
    freezes by ``stop_gradient``, never by FrozenBN), and every one moved;
    the JAX tape itself keeps only the mask head's (module docstring)."""
    if step["name"] != "syncbn":
        assert step["j_stats"] is None and not step["t_stats"]
        return
    start = jax_stats(step["variables"])
    assert set(step["j_stats"]) == set(step["t_stats"]) == set(start)
    assert "backbone.bottom_up.stem.conv1.norm.running_var" in start
    for name, want in step["j_stats"].items():
        assert_close_to_max(step["t_stats"][name], want, GRAD_TOL, name)
        assert (step["t_stats"][name] != start[name]).all(), name
    kept = {k for k, v in step["j_tape"].items() if not np.array_equal(v, start[k])}
    assert kept == {k for k in start if k.startswith("roi_heads.mask_head.")}
    for name in kept:  # the same apply, traced once under jit and once not
        assert_close_to_max(step["j_tape"][name], step["j_stats"][name], 1e-6, name)


def test_norm_models_train_step_update_matches_optax(step):
    jcfg, tcfg = step["jcfg"], step["tcfg"]
    start = convert_variables(step["variables"])
    model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    state = create_train_state(tcfg, model, torch.Generator().manual_seed(0))
    with jax_proposals(model, step["j_raw"]):
        metrics = build_train_step(tcfg, state)(step["tbatch"], noise=step["noise"])
    np.testing.assert_allclose(float(metrics["total_loss"]), step["j_total"], rtol=LOSS_RTOL,
                               atol=MASK_LOSS_RTOL * step["j_losses"]["loss_mask"])
    want = convert_variables({"params": jax_updated_params(jcfg, step["variables"]["params"],
                                                           step["j_grads"])})
    for name, p in model.named_parameters():
        if name.startswith(HELD):
            assert_update_close(p.detach().numpy(), want[name].numpy(), start[name].numpy(),
                                GRAD_TOL, name)


def test_bn_affine_is_in_the_norm_group_as_jax(pair):
    """Each parameter's decay group (``norm`` for BN's and GN's affine)
    equals the JAX ``_param_group``'s, leaf for leaf."""
    params = pair["variables"]["params"]
    leaves, treedef = jax.tree_util.tree_flatten(params)
    tagged = jax.tree_util.tree_unflatten(
        treedef, [np.full(np.shape(x), i, np.float32) for i, x in enumerate(leaves)])
    by_tag = {int(v.reshape(-1)[0]): k for k, v in convert_variables({"params": tagged}).items()}
    groups = [jsolver._param_group(path) for path, _ in
              jax.tree_util.tree_flatten_with_path(params)[0]]
    got = {by_tag[i]: g for i, g in enumerate(groups)}
    assert {n: tsolver.param_group(n) for n in got} == got
    assert sum(g == "norm" for g in got.values()) > 100


def test_predict_reads_running_statistics_in_a_training_model(pair):
    """A model built for training serves on its running statistics (JAX
    ``train=False``; GN has none) and stays in training mode."""
    model = build_model(pair["tcfg"], device="cpu",
                        state_dict=convert_variables(pair["variables"]), training=True)
    before = port_stats(model)
    out = model.predict(pair["tbatch"])
    np.testing.assert_array_equal(out.is_valid.numpy(), pair["jout"].is_valid)
    np.testing.assert_allclose(out.boxes.numpy(), pair["jout"].boxes, rtol=RTOL, atol=ATOL)
    assert all(m.training for m in model.modules())
    for k, v in port_stats(model).items():
        np.testing.assert_array_equal(v, before[k])
