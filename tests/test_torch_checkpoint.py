"""The port's checkpoints against the JAX package's: name-and-shape
overlays with the same warnings, the save-and-keep schedule of the Orbax
manager the JAX ``train()`` drives, Detectron2 checkpoints converted to the
same tensors, and ``PRETRAINS`` loading."""

import logging
import os
import pickle

import numpy as np
import pytest
import torch

from detectron2_tensorflow_tpu.convert.d2 import convert_d2_weights as jax_convert_d2
from detectron2_tensorflow_tpu.convert.d2 import load_state_dict as jax_load_state_dict
from detectron2_tensorflow_tpu.engine.checkpoint import overlay_compatible as jax_overlay
from detectron2_tensorflow_tpu_torch.convert import (
    convert_d2_weights,
    convert_variables,
    load_state_dict,
)
from detectron2_tensorflow_tpu_torch.engine.checkpoint import (
    CheckpointManager,
    latest_checkpoint,
    latest_step,
    load_pretrained,
    overlay_compatible,
    restore_variables,
)
from detectron2_tensorflow_tpu_torch.models import build_model
from test_torch_config import narrow_cfgs


def test_overlay_compatible_filters_by_name_and_shape(caplog):
    """``tests/test_train_resume.py``'s case, on the port's flat names: the
    same tensors kept, the same warnings as the JAX package's overlay."""
    state = {"conv.weight": torch.zeros(8, 4, 3, 3), "head.bias": torch.zeros(8)}
    restored = {"conv.weight": torch.ones(8, 4, 3, 3), "head.bias": torch.ones(5),
                "extra.w": torch.ones(2), "ghost_collection.x": torch.ones(1)}
    with caplog.at_level(logging.WARNING):
        out = overlay_compatible(state, restored)
    assert float(out["conv.weight"].sum()) == 8 * 4 * 3 * 3
    assert float(out["head.bias"].sum()) == 0 and "extra.w" not in out
    ours = {r.getMessage().split(" ", 3)[3] for r in caplog.records}  # after the name

    caplog.clear()
    with caplog.at_level(logging.WARNING):
        jax_overlay({"params": {"head": {"bias": np.zeros(8, np.float32)}}},
                    {"params": {"head": {"bias": np.ones(5, np.float32)},
                                "extra": {"w": np.ones(2, np.float32)}}})
    theirs = {r.getMessage().split(" ", 3)[3] for r in caplog.records}
    assert theirs == {"has shape (5,), model wants (8,) — skipped", "not in model — skipped"}
    assert theirs <= ours


def test_overlay_casts_to_the_model_tensor():
    state = {"w": torch.zeros(3, dtype=torch.bfloat16)}
    out = overlay_compatible(state, {"w": torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)})
    assert out["w"].dtype == torch.bfloat16 and out["w"].tolist() == [1.0, 2.0, 3.0]


def _orbax_steps(directory, interval, keep, period, runs):
    """The steps an Orbax manager holds after the JAX ``train()``'s calls
    for each ``max_iter`` in ``runs`` (each run resumes from the last)."""
    import orbax.checkpoint as ocp

    history = []
    for max_iter in runs:
        mgr = ocp.CheckpointManager(directory, options=ocp.CheckpointManagerOptions(
            save_interval_steps=interval, max_to_keep=keep, keep_period=period))
        start = mgr.latest_step() or 0
        for it in range(start, max_iter):
            mgr.save(it + 1, args=ocp.args.StandardSave({"x": np.zeros(1, np.float32)}))
        if max_iter > start and mgr.latest_step() != max_iter:
            mgr.save(max_iter, args=ocp.args.StandardSave({"x": np.zeros(1, np.float32)}),
                     force=True)
        mgr.wait_until_finished()
        history.append(sorted(mgr.all_steps()))
        mgr.close()
    return history


def _port_steps(directory, interval, keep, period, runs):
    history = []
    for max_iter in runs:
        mgr = CheckpointManager(directory, interval, keep, period)
        start = mgr.latest_step() or 0
        for it in range(start, max_iter):
            mgr.save(it + 1, {"step": it + 1})
        if max_iter > start and mgr.latest_step() != max_iter:
            mgr.save(max_iter, {"step": max_iter}, force=True)
        history.append(mgr.all_steps())
    return history


@pytest.mark.parametrize("interval,keep,period,runs", [
    (1, 10, 100, [2, 2, 4]),
    (2, 2, 6, [5, 13]),
    (3, 1, 4, [7, 8, 17]),
    (4, 3, 8, [3, 10, 10, 21]),
])
def test_checkpoint_schedule_matches_orbax(tmp_path, interval, keep, period, runs):
    want = _orbax_steps(str(tmp_path / "orbax"), interval, keep, period, runs)
    got = _port_steps(str(tmp_path / "port"), interval, keep, period, runs)
    assert got == want


def test_latest_checkpoint_and_restore(tmp_path):
    mgr = CheckpointManager(str(tmp_path), 1, 5, 10)
    assert latest_step(str(tmp_path)) is None and latest_checkpoint(str(tmp_path)) is None
    mgr.save(3, {"step": 3, "model": {"w": torch.arange(4.0)}})
    assert latest_step(str(tmp_path)) == 3
    assert latest_checkpoint(str(tmp_path)) == os.path.join(str(tmp_path), "3.pt")
    assert torch.equal(mgr.restore(3)["model"]["w"], torch.arange(4.0))
    assert torch.equal(restore_variables(latest_checkpoint(str(tmp_path)))["w"], torch.arange(4.0))


# -- Detectron2 checkpoints and PRETRAINS -------------------------------------

def _narrow():
    jcfg, tcfg = narrow_cfgs()
    return jcfg, tcfg, build_model(tcfg, device="cpu", training=True)


def write_d2_checkpoint(path, model, seed=0):
    """A Detectron2 checkpoint for ``model``'s configuration: random arrays
    under Detectron2's names (the port's), with the extras a real one has."""
    rng = np.random.default_rng(seed)
    sd = {k: rng.standard_normal(tuple(v.shape)).astype(np.float32)
          for k, v in model.state_dict().items()}
    for k in sd:
        if k.endswith("running_var"):
            sd[k] = np.abs(sd[k]) + 0.5
    sd["pixel_mean"] = np.zeros((3, 1, 1), np.float32)
    sd["proposal_generator.anchor_generator.cell_anchors.0"] = np.zeros((3, 4), np.float32)
    sd["backbone.bottom_up.stem.conv1.norm.num_batches_tracked"] = np.zeros((), np.int64)
    sd["roi_heads.keypoint_head.extra.weight"] = np.ones(2, np.float32)
    if path.endswith(".pkl"):
        with open(path, "wb") as f:
            pickle.dump({"model": sd, "__author__": "test"}, f)
    else:
        torch.save({"model": {k: torch.from_numpy(v) for k, v in sd.items()}}, path)
    return sd


@pytest.mark.parametrize("suffix", [".pkl", ".pth"])
def test_d2_checkpoint_converts_like_jax(tmp_path, suffix):
    """The port's converter against the JAX package's followed by the
    port's ``convert_variables``: the same tensors, bit for bit, and the same
    leftovers; fc1's columns go from (c, h, w) to (h, w, c)."""
    jcfg, tcfg, model = _narrow()
    path = str(tmp_path / f"model_final{suffix}")
    sd = write_d2_checkpoint(path, model)
    got, leftovers = convert_d2_weights(load_state_dict(path), tcfg)
    jconverted, jleftovers = jax_convert_d2(jax_load_state_dict(path), jcfg)
    want = convert_variables(jconverted)
    assert set(got) == set(want) == set(model.state_dict())
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert leftovers == jleftovers == ["roi_heads.keypoint_head.extra.weight"]
    fc1 = sd["roi_heads.box_head.fc1.weight"]
    c, s = tcfg.MODEL.NECK.OUT_CHANNELS, tcfg.MODEL.ROI_BOX_HEAD.POOLER_RESOLUTION
    assert got["roi_heads.box_head.fc1.weight"][0, 1].item() == fc1[0, s * s]  # (c=1, 0, 0)
    assert fc1.shape[1] == c * s * s


def test_d2_checkpoint_missing_a_tensor_raises(tmp_path):
    _, tcfg, model = _narrow()
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    del sd["roi_heads.mask_head.predictor.weight"]
    with pytest.raises(KeyError, match="lacks 1"):
        convert_d2_weights(sd, tcfg)


def test_load_pretrained_detectron2(tmp_path, caplog):
    _, tcfg, model = _narrow()
    path = str(tmp_path / "d2.pkl")
    write_d2_checkpoint(path, model, seed=1)
    tcfg.PRETRAINS.DETECTRON2 = path
    with caplog.at_level(logging.WARNING):
        assert load_pretrained(tcfg, model)
    assert "unconverted checkpoint keys" in caplog.text
    want, _ = convert_d2_weights(load_state_dict(path), tcfg)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_load_pretrained_only_backbone(tmp_path):
    _, tcfg, model = _narrow()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    path = str(tmp_path / "d2.pkl")
    write_d2_checkpoint(path, model, seed=2)
    tcfg.PRETRAINS.DETECTRON2 = path
    tcfg.PRETRAINS.ONLY_BACKBONE = True
    load_pretrained(tcfg, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]) != k.startswith("backbone.bottom_up."), k


def test_load_pretrained_weights_from_a_port_checkpoint(tmp_path):
    _, tcfg, model = _narrow()
    other = build_model(tcfg, device="cpu", training=True, generator=torch.Generator().manual_seed(7))
    CheckpointManager(str(tmp_path), 1, 1, 10).save(5, {"step": 5, "model": other.state_dict()})
    tcfg.PRETRAINS.ROOT = str(tmp_path)
    tcfg.PRETRAINS.WEIGHTS = "5.pt"
    assert load_pretrained(tcfg, model)
    for k, v in model.state_dict().items():
        assert torch.equal(v, other.state_dict()[k]), k


def test_load_pretrained_missing_file_trains_from_scratch(tmp_path, caplog):
    _, tcfg, model = _narrow()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg.PRETRAINS.DETECTRON2 = str(tmp_path / "absent.pkl")
    with caplog.at_level(logging.WARNING):
        assert not load_pretrained(tcfg, model)
    assert "not found" in caplog.text
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())


@pytest.mark.parametrize("key", ["BACKBONE", "MMDET", "DARKNET"])
def test_load_pretrained_other_converters_wait(key, caplog):
    """``BACKBONE``, ``MMDET`` and ``DARKNET`` each have their converters
    (``convert_{caffe2,torchvision}_backbone``, ``convert_solo_weights``,
    ``convert_darknet_weights``), so a missing file is skipped with the
    warning and the model keeps its weights, as the JAX package skips it
    (``tests/test_torch_pretrained.py``, ``tests/test_torch_solov2_eval.py``
    and ``tests/test_torch_yolov4_convert.py`` load present ones)."""
    _, tcfg, model = _narrow()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    tcfg.PRETRAINS[key] = "weights.bin"
    with caplog.at_level(logging.WARNING):
        assert not load_pretrained(tcfg, model)
    assert "weights.bin not found" in caplog.text
    assert all(torch.equal(v, before[k]) for k, v in model.state_dict().items())
