"""The port's presets against the JAX package's ``bench_cfg()`` and
``bench_train.train_cfg()``, on the full default tree, and the narrow test
configuration the other ``test_torch_*`` files share."""

import numpy as np
import pytest
import torch

import bench
import bench_train
from detectron2_tensorflow_tpu_torch.config import bench_cfg as torch_bench_cfg
from detectron2_tensorflow_tpu_torch.config import train_cfg as torch_train_cfg

NARROW = {
    "MODEL.RESNETS.STEM_OUT_CHANNELS": 16,
    "MODEL.RESNETS.RES2_OUT_CHANNELS": 32,
    "MODEL.RESNETS.WIDTH_PER_GROUP": 8,
    "MODEL.NECK.OUT_CHANNELS": 32,
    "MODEL.ROI_BOX_HEAD.FC_DIM": 64,
    "MODEL.ROI_MASK_HEAD.CONV_DIM": 32,
    "MODEL.ROI_HEADS.NUM_CLASSES": 5,
    "MODEL.DTYPE": "float32",
}



@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's CPU ops on one thread in each test module that imports this
    fixture (autouse there too). The port's CPU tests run narrow models:
    under ``pytest -n`` every worker's thread pool would contend for the
    host's cores, which costs far more than one thread loses."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

def _set(cfg, path, value):
    *parents, leaf = path.split(".")
    node = cfg
    for p in parents:
        node = getattr(node, p)
    setattr(node, leaf, value)


def _get(cfg, path):
    node = cfg
    for p in path.split("."):
        node = getattr(node, p)
    return node


def narrow_cfgs(**overrides):
    """(JAX cfg, port cfg): R50 depth at narrow widths, 5 classes, float32."""
    jcfg, tcfg = bench.bench_cfg(), torch_bench_cfg()
    for path, value in {**NARROW, **overrides}.items():
        _set(jcfg, path, value)
        _set(tcfg, path, value)
    return jcfg, tcfg


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


def jax_flatten(cfg, prefix=""):
    """``{"MODEL.RPN.NMS_THRESH": value}`` for every leaf of a JAX tree."""
    out = {}
    for k, v in cfg.items():
        if isinstance(v, dict):
            out.update(jax_flatten(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


# The one default that differs: the JAX package's XLA cache directory, which
# the port has no use for (``config/defaults.py``).
PORT_ONLY_DEFAULTS = {"LOGS.COMPILATION_CACHE_DIR": ""}


def assert_same_tree(jcfg, tcfg):
    """The same keys, and equal values of the same types, leaf by leaf."""
    want = {**jax_flatten(jcfg), **PORT_ONLY_DEFAULTS}
    got = dict(tcfg.flatten())
    assert set(got) == set(want), set(got) ^ set(want)
    for path, value in want.items():
        assert got[path] == value and type(got[path]) is type(value), path


def test_config_matches_bench_cfg_key_by_key():
    jcfg, tcfg = bench.bench_cfg(), torch_bench_cfg()
    assert len(jax_flatten(jcfg)) > 300
    assert_same_tree(jcfg, tcfg)


TRAIN_KEYS = (
    "MODEL.BACKBONE.FREEZE_AT",
    "MODEL.RPN.BOUNDARY_THRESH", "MODEL.RPN.IOU_THRESHOLDS", "MODEL.RPN.IOU_LABELS",
    "MODEL.RPN.BATCH_SIZE_PER_IMAGE", "MODEL.RPN.POSITIVE_FRACTION",
    "MODEL.RPN.SMOOTH_L1_BETA", "MODEL.RPN.LOSS_WEIGHT",
    "MODEL.RPN.PRE_NMS_TOPK_TRAIN", "MODEL.RPN.POST_NMS_TOPK_TRAIN",
    "MODEL.RPN.PRE_NMS_TOPK_TEST", "MODEL.RPN.POST_NMS_TOPK_TEST",
    "MODEL.ROI_HEADS.IOU_THRESHOLDS", "MODEL.ROI_HEADS.IOU_LABELS",
    "MODEL.ROI_HEADS.BATCH_SIZE_PER_IMAGE", "MODEL.ROI_HEADS.POSITIVE_FRACTION",
    "MODEL.ROI_HEADS.PROPOSAL_APPEND_GT", "MODEL.ROI_BOX_HEAD.SMOOTH_L1_BETA",
    "INPUT.MAX_GT_INSTANCES",
    "SOLVER.LR_SCHEDULER_NAME", "SOLVER.IMS_PER_BATCH", "SOLVER.AUTO_SCALE_LR_SCHEDULE",
    "SOLVER.IMS_PER_BATCH_BASE", "SOLVER.MAX_ITER", "SOLVER.BASE_LR", "SOLVER.MOMENTUM",
    "SOLVER.WEIGHT_DECAY", "SOLVER.WEIGHT_DECAY_NORM", "SOLVER.WEIGHT_DECAY_BIAS",
    "SOLVER.BIAS_LR_FACTOR", "SOLVER.GAMMA", "SOLVER.STEPS", "SOLVER.WARMUP_FACTOR",
    "SOLVER.WARMUP_ITERS", "SOLVER.WARMUP_METHOD", "SOLVER.CLIP_GRADIENTS_BY_NORM",
)


@pytest.mark.parametrize("batch_size", [2, 8])
def test_train_config_matches_bench_train_key_by_key(batch_size):
    """Every key of the port's ``train_cfg`` (the training keys named one by
    one, so none can go missing) against ``bench_train.train_cfg()``."""
    jcfg, tcfg = bench_train.train_cfg(batch_size), torch_train_cfg(batch_size)
    leaves = dict(tcfg.flatten())
    assert set(TRAIN_KEYS) <= set(leaves)
    assert_same_tree(jcfg, tcfg)
    assert tcfg.SOLVER.IMS_PER_BATCH == batch_size
    assert (tcfg.MODEL.RPN.PRE_NMS_TOPK_TRAIN, tcfg.MODEL.RPN.POST_NMS_TOPK_TRAIN) == (2000, 1000)


def test_serving_config_keeps_its_values():
    """``bench_cfg()`` still holds the serving values ``train_cfg`` overrides."""
    cfg = torch_bench_cfg()
    assert cfg.MODEL.RPN.PRE_NMS_TOPK_TEST == 1000 and cfg.INPUT.MAX_GT_INSTANCES == 100
    assert cfg.SOLVER.AUTO_SCALE_LR_SCHEDULE


def test_narrow_overrides_apply_to_both():
    jcfg, tcfg = narrow_cfgs()
    for path, value in NARROW.items():
        assert _get(jcfg, path) == value and _get(tcfg, path) == value
    assert np.isclose(tcfg.MODEL.RPN.NMS_THRESH, 0.7)
