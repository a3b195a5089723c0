"""Fast R-CNN (``MODEL.LOAD_PROPOSALS``: the ROI heads over precomputed
proposals, no RPN) against the JAX package, its CLIs with proposal files,
and the ``cls_agnostic`` overfit family.

Model: ``configs/COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml`` at the narrow
widths of ``test_torch_c4.py`` (R50 depth, stem 16, res2 32, 8 per group,
FPN 32), float32, on 2 x 128 x 160 images whose proposals follow the JAX
package's ``tests/test_fast_rcnn.py`` recipe (8 GT-jittered boxes per GT,
sigma 2 px, scores U(0, 10); ``engine.add_proposal_slots``), from the same
tamed JAX weights carried over by ``convert.py``. Tolerances are those of
``test_torch_c4.py``: integers equal, float32 1e-4; losses 1e-5 relative,
gradients and one step's updates 1e-4 of each tensor's largest magnitude.
"""

import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.data.coco import CocoDataset as JaxCocoDataset
from detectron2_tensorflow_tpu.models import build_model as jax_build_model
from detectron2_tensorflow_tpu_torch import solver as tsolver
from detectron2_tensorflow_tpu_torch.convert import convert_variables
from detectron2_tensorflow_tpu_torch.data import CocoDataset, write_proposal_file
from detectron2_tensorflow_tpu_torch.engine import (
    add_proposal_slots,
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.models import build_model
from detectron2_tensorflow_tpu_torch.tools import eval as tools_eval
from detectron2_tensorflow_tpu_torch.tools import make_synthetic_coco
from detectron2_tensorflow_tpu_torch.tools import train as tools_train
from test_torch_c4 import (
    B,
    H,
    LOSS_RTOL,
    SIZES,
    W,
    check_overfit_cfg,
    run_overfit_check,
    tame,
    yaml_cfgs,
)
from test_torch_train import GRAD_TOL, assert_grad_close, assert_update_close, jax_noise
from test_torch_train import jax_updated_params
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

FAST_YAML = "configs/COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml"
RTOL, ATOL = 1e-4, 1e-4
TOPK = 64  # PRECOMPUTED_PROPOSAL_TOPK_TRAIN and _TEST at this size


def fast_cfgs(**overrides):
    return yaml_cfgs(FAST_YAML, **{"MODEL.NECK.OUT_CHANNELS": 32,
                                   "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN": TOPK,
                                   "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST": TOPK,
                                   "INPUT.MAX_GT_INSTANCES": 5, "SOLVER.IMS_PER_BATCH": B,
                                   **overrides})


@pytest.fixture(scope="module")
def fast():
    """Both packages' Fast R-CNN from the same tamed weights, a training
    batch with proposal slots, and both ``predict`` outputs on its images and
    proposals (the serving budget's slots)."""
    jcfg, tcfg = fast_cfgs()
    nb = make_train_batch(tcfg, H, W)
    nb["image_size"] = SIZES
    train_nb = add_proposal_slots(tcfg, nb, training=True)
    serve_nb = add_proposal_slots(tcfg, nb, training=False, seed=1)
    keys = ("image", "image_size", "proposal_boxes", "proposal_scores", "proposal_valid")
    jbatch = {k: jnp.asarray(serve_nb[k]) for k in keys}
    tbatch = {k: torch.from_numpy(serve_nb[k]) for k in keys}
    jmodel = jax_build_model(jcfg)
    variables = tame(jax.jit(jmodel.init)(jax.random.PRNGKey(0), jbatch))
    jout = jax.tree_util.tree_map(np.asarray, jax.jit(jmodel.predict)(variables, jbatch))
    tmodel = build_model(tcfg, device="cpu", state_dict=convert_variables(variables))
    return dict(jcfg=jcfg, tcfg=tcfg, variables=variables, jmodel=jmodel, tmodel=tmodel,
                train_nb=train_nb, jout=jout, tout=tmodel.predict(tbatch))


def test_fast_rcnn_has_no_rpn_parameters(fast):
    names = set(fast["tmodel"].state_dict())
    assert not any(n.startswith("proposal_generator") for n in names)
    assert names == set(convert_variables(fast["variables"]))
    assert "rpn" not in str(jax.tree_util.tree_structure(fast["variables"])).lower()


def test_fast_rcnn_predict_matches_jax(fast):
    """Detections from the batch's proposals: valid slots, classes equal;
    boxes and scores to 1e-4."""
    jout, tout = fast["jout"], fast["tout"]
    valid = tout.is_valid.numpy()
    np.testing.assert_array_equal(valid, jout.is_valid)
    assert valid.sum() >= 20
    np.testing.assert_array_equal(tout.pred_classes.numpy(), jout.pred_classes)
    np.testing.assert_allclose(tout.boxes.numpy(), jout.boxes, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(tout.scores.numpy(), jout.scores, rtol=RTOL, atol=1e-6)
    assert "pred_masks" not in tout.get_fields()


@pytest.fixture(scope="module")
def step(fast):
    """One training step of both packages from the same weights, batch,
    proposals and ROI sampler noise: losses and gradients."""
    jcfg, tcfg, variables, jmodel = fast["jcfg"], fast["tcfg"], fast["variables"], fast["jmodel"]
    nb = fast["train_nb"]
    jbatch = {k: jnp.asarray(v) for k, v in nb.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in nb.items()}
    step_rng = jax.random.PRNGKey(1)
    _, rng_roi = jax.random.split(step_rng)

    def total_loss(params):
        total, (losses, _) = jmodel.loss_fn({**variables, "params": params}, jbatch, step_rng, {})
        return total, losses

    (j_total, j_losses), j_grads = jax.jit(jax.value_and_grad(total_loss, has_aux=True))(
        variables["params"])
    noise = {"roi": jax_noise(rng_roi, B, TOPK + nb["gt_boxes"].shape[1])}
    model = build_model(tcfg, device="cpu", state_dict=convert_variables(variables),
                        training=True)
    losses = model.losses(tbatch, noise=noise)
    sum(losses.values()).backward()
    return dict(fast, tbatch=tbatch, noise=noise, j_total=float(j_total),
                j_losses={k: float(v) for k, v in j_losses.items()},
                j_grads=jax.tree_util.tree_map(np.asarray, j_grads), model=model,
                t_losses={k: float(v.detach()) for k, v in losses.items()})


def test_fast_rcnn_losses_match_jax(step):
    """No RPN losses: ``loss_cls`` and ``loss_box_reg`` over the loaded
    proposals plus the GT."""
    got, want = step["t_losses"], step["j_losses"]
    assert set(got) == set(want) == {"loss_cls", "loss_box_reg"}
    for k in got:
        np.testing.assert_allclose(got[k], want[k], rtol=LOSS_RTOL, err_msg=k)
    assert got["loss_box_reg"] > 0


def test_fast_rcnn_gradients_match_jax(step):
    want = convert_variables({"params": step["j_grads"]})
    model = step["model"]
    trainable = tsolver.trainable_parameters(model, 2)
    for name, p in model.named_parameters():
        if name in trainable:
            assert_grad_close(p.grad.numpy(), want[name].numpy(), name)
        else:
            assert p.grad is None and not want[name].numpy().any(), name


def test_fast_rcnn_train_step_matches_optax(step):
    jcfg, tcfg = step["jcfg"], step["tcfg"]
    start = convert_variables(step["variables"])
    model = build_model(tcfg, device="cpu", state_dict=start, training=True)
    state = create_train_state(tcfg, model, torch.Generator().manual_seed(0))
    metrics = build_train_step(tcfg, state)(step["tbatch"], noise=step["noise"])
    np.testing.assert_allclose(float(metrics["total_loss"]), step["j_total"], rtol=LOSS_RTOL)
    want = convert_variables({"params": jax_updated_params(jcfg, step["variables"]["params"],
                                                           step["j_grads"])})
    for name, p in model.named_parameters():
        assert_update_close(p.detach().numpy(), want[name].numpy(), start[name].numpy(),
                            GRAD_TOL, name)


# -- proposal files and the CLIs -----------------------------------------------------------

NARROW_OPTS = ["MODEL.RESNETS.STEM_OUT_CHANNELS", "16", "MODEL.RESNETS.RES2_OUT_CHANNELS", "32",
               "MODEL.RESNETS.WIDTH_PER_GROUP", "8", "MODEL.NECK.OUT_CHANNELS", "32",
               "MODEL.ROI_BOX_HEAD.FC_DIM", "64", "MODEL.ROI_HEADS.NUM_CLASSES", "3",
               "MODEL.DTYPE", "float32", "SOLVER.IMS_PER_GPU", "2",
               "DATALOADER.NUM_READERS", "1", "INPUT.PAD_BUCKETS", "((256, 320), (320, 256))",
               "TRANSFORM.RESIZE.MIN_SIZE_TRAIN", "(240,)", "TRANSFORM.RESIZE.MAX_SIZE_TRAIN",
               "320", "TRANSFORM.RESIZE.MIN_SIZE_TEST", "240",
               "TRANSFORM.RESIZE.MAX_SIZE_TEST", "320",
               "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN", "100",
               "DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST", "100"]


@pytest.fixture(scope="module")
def coco_with_proposals(tmp_path_factory):
    root = tmp_path_factory.mktemp("fast_rcnn")
    make_synthetic_coco.main([str(root), "4", "2"])
    for split, seed in (("train", 0), ("val", 1)):
        assert write_proposal_file(str(root / f"{split}.json"),
                                   str(root / f"{split}_proposals.pkl"), seed) == (
            4 if split == "train" else 2)
    return root


def test_proposal_file_reads_as_the_jax_dataset_reads_it(coco_with_proposals):
    """``write_proposal_file`` writes Detectron2's pickle (ids, xyxy boxes,
    objectness logits): 8 proposals per annotated box, which both packages'
    ``CocoDataset.set_proposals`` attach to the same samples."""
    root = coco_with_proposals
    with open(root / "train_proposals.pkl", "rb") as f:
        data = pickle.load(f)
    anns = json.loads((root / "train.json").read_text())["annotations"]
    assert sum(len(b) for b in data["boxes"]) == 8 * len(anns)
    ours = CocoDataset(str(root / "train.json"), str(root / "train"), load_masks=False)
    theirs = JaxCocoDataset(str(root / "train.json"), str(root / "train"), load_masks=False)
    for ds in (ours, theirs):
        ds.set_proposals(str(root / "train_proposals.pkl"))
    for i in range(4):
        a, b = ours[i], theirs[i]
        np.testing.assert_array_equal(a["proposals"], b["proposals"])
        np.testing.assert_array_equal(a["proposal_scores"], b["proposal_scores"])


def test_train_and_eval_clis_read_proposal_files(coco_with_proposals, capsys):
    """``tools.train`` with ``DATASETS.PROPOSAL_FILES_TRAIN`` (the COCO JSON
    route; no RPN loss) and ``tools.eval`` with ``PROPOSAL_FILES_TEST``, on
    the CPU at narrow widths."""
    root = coco_with_proposals
    opts = ["--config_file", FAST_YAML, "DATASETS.ROOT_DIR", str(root),
            "LOGS.ROOT_DIR", str(root / "logs"), *NARROW_OPTS,
            "DATASETS.PROPOSAL_FILES_TRAIN", "('train_proposals.pkl',)",
            "DATASETS.PROPOSAL_FILES_TEST", "('val_proposals.pkl',)"]
    summary = tools_train.main(["--device", "cpu", "--max_iter", "2", *opts])
    assert summary["steps"] == 2
    assert set(summary["final_losses"]) == {"total_loss", "loss_cls", "loss_box_reg"}
    metrics = tools_eval.main(["--device", "cpu", *opts])
    assert {"bbox/AP", "bbox/AP50"} <= set(metrics)
    assert "bbox/AP: " in capsys.readouterr().out
    from detectron2_tensorflow_tpu_torch.config import get_cfg
    cfg = get_cfg()
    cfg.merge_from_file(FAST_YAML)
    cfg.merge_from_list(opts[2:])
    for build in (tools_train.build_train_dataset, tools_eval.build_eval_dataset):
        ds = build(cfg)
        assert isinstance(ds, CocoDataset) and ds[0]["proposals"].shape[1] == 4


def test_overfit_cfg_matches_the_jax_tool_cls_agnostic():
    check_overfit_cfg("cls_agnostic")


def test_overfit_check_cls_agnostic_runs_on_the_cpu(capsys):
    """``tools.overfit_check --arch cls_agnostic --device cpu`` at narrow
    widths: the one shared box regressor and one-channel mask head train two
    steps and evaluate."""
    from test_torch_c4 import OVERFIT_NARROW

    out = run_overfit_check("cls_agnostic", [*OVERFIT_NARROW, "MODEL.NECK.OUT_CHANNELS", "32",
                                             "MODEL.ROI_BOX_HEAD.FC_DIM", "64"], capsys)
    assert out["arch"] == "cls_agnostic" and out["steps"] == 2 and np.isfinite(out["final_loss"])
    assert {"bbox_ap", "bbox_ap50", "segm_ap", "segm_ap50"} <= set(out)
