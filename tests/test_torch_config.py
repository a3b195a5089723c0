"""The port's config module against the JAX package's ``bench_cfg()``, and
the narrow test configuration the other ``test_torch_*`` files share."""

import numpy as np

import bench
from detectron2_tensorflow_tpu_torch.config import get_cfg as torch_get_cfg

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
    jcfg, tcfg = bench.bench_cfg(), torch_get_cfg()
    for path, value in {**NARROW, **overrides}.items():
        _set(jcfg, path, value)
        _set(tcfg, path, value)
    return jcfg, tcfg


def _norm(v):
    if isinstance(v, (list, tuple)):
        return [_norm(x) for x in v]
    return v


def test_config_matches_bench_cfg_key_by_key():
    jcfg, tcfg = bench.bench_cfg(), torch_get_cfg()
    leaves = dict(tcfg.flatten())
    assert len(leaves) > 50
    for path, value in leaves.items():
        assert _norm(_get(jcfg, path)) == _norm(value), path


def test_narrow_overrides_apply_to_both():
    jcfg, tcfg = narrow_cfgs()
    for path, value in NARROW.items():
        assert _get(jcfg, path) == value and _get(tcfg, path) == value
    assert np.isclose(tcfg.MODEL.RPN.NMS_THRESH, 0.7)
