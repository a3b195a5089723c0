"""The port's CLIs on the CPU: ``tools.build_records`` -> ``tools.train``
(2 steps) -> a resumed ``tools.train`` -> ``tools.eval`` with
``--dump_results`` and ``TEST.EXPECTED_RESULTS``, and the workflow script,
on the R18-GN overfit config at narrow widths (float32, 2 images per step)
over a synthetic COCO directory of 4 train and 2 val images. What the port
does not have yet raises, naming its key.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from detectron2_tensorflow_tpu_torch.data import TFRecordDataset
from detectron2_tensorflow_tpu_torch.engine.checkpoint import all_steps
from detectron2_tensorflow_tpu_torch.tools import build_records as tools_build_records
from detectron2_tensorflow_tpu_torch.tools import eval as tools_eval
from detectron2_tensorflow_tpu_torch.tools import make_synthetic_coco
from detectron2_tensorflow_tpu_torch.tools import train as tools_train
from detectron2_tensorflow_tpu_torch.tools import workflow_check
from test_torch_config import one_torch_thread  # noqa: F401 (autouse)

REPO = Path(__file__).resolve().parents[1]
CFG = "configs/synthetic/overfit_mask_rcnn_R_18.yaml"
NARROW = ["MODEL.RESNETS.STEM_OUT_CHANNELS", "32", "MODEL.RESNETS.RES2_OUT_CHANNELS", "128",
          "MODEL.NECK.OUT_CHANNELS", "32", "MODEL.ROI_BOX_HEAD.FC_DIM", "64",
          "MODEL.ROI_MASK_HEAD.CONV_DIM", "32", "SOLVER.IMS_PER_GPU", "2",
          "DATALOADER.NUM_READERS", "1", "SOLVER.SHORT_TERM_SAVE_STEPS", "1",
          "SOLVER.SHORT_TERM_NUM_STEPS", "2"]
PASSING = "[['bbox', 'AP', 0.0, 100.0], ['segm', 'AP', 0.0, 100.0]]"
FAILING = "[['bbox', 'AP', 99.0, 0.5]]"


def _opts(root):
    return ["--config_file", CFG, "DATASETS.ROOT_DIR", str(root),
            "LOGS.ROOT_DIR", str(root / "logs"), *NARROW]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Records built, 2 steps trained, then resumed to 3."""
    root = tmp_path_factory.mktemp("cli")
    make_synthetic_coco.main([str(root), "4", "2"])
    tools_build_records.main([*_opts(root), "BUILD_RECORDS.TYPE", "coco_det",
                              "BUILD_RECORDS.TRAIN_NUM_SHARDS", "2",
                              "BUILD_RECORDS.VAL_NUM_SHARDS", "1"])
    first = tools_train.main(["--device", "cpu", "--max_iter", "2", *_opts(root)])
    after_first = all_steps(first["checkpoint_dir"])
    second = tools_train.main(["--device", "cpu", "--max_iter", "3", *_opts(root)])
    return dict(root=root, first=first, second=second, after_first=after_first)


def test_build_records_writes_shards_and_category_map(trained):
    root = trained["root"]
    assert sorted(p.name for p in root.glob("*.record-*")) == [
        "train.record-00000-of-00002", "train.record-00001-of-00002",
        "val.record-00000-of-00001"]
    cats = json.loads((root / "category_map.json").read_text())
    assert cats == {"thing_classes": ["square", "disk", "stripe"],
                    "contiguous_to_coco_id": {"0": 1, "1": 2, "2": 3}}
    ds = TFRecordDataset(str(root / "train.record-*"))
    assert len(ds) == 4 and ds[0]["image"].shape == (240, 320, 3)
    assert len(ds[0]["masks"]) == len(ds[0]["boxes"]) >= 1


def test_train_saves_then_resumes(trained):
    first, second = trained["first"], trained["second"]
    assert (first["start_step"], first["step"], first["steps"]) == (0, 2, 2)
    assert trained["after_first"] == [1, 2]
    assert (second["start_step"], second["step"], second["steps"]) == (2, 3, 1)
    assert all_steps(second["checkpoint_dir"]) == [2, 3]
    assert second["checkpoint_dir"] == str(trained["root"] / "logs" / "train")
    for s in (first, second):
        assert set(s["final_losses"]) == {"total_loss", "loss_rpn_cls", "loss_rpn_loc",
                                          "loss_cls", "loss_box_reg", "loss_mask"}
        # On the CPU every kernel takes its plain version: no launch counted.
        assert s["launches"] == {"nms_keep": 0, "roi_patch_fwd": 0, "roi_patch_bwd": 0,
                                 "fused_residual": 0}
        assert s["fused_tail_convs"] == 0


def test_eval_dumps_results_and_passes_expected_results(trained, tmp_path):
    root = trained["root"]
    out = tmp_path / "results.json"
    metrics = tools_eval.main(["--device", "cpu", "--dump_results", str(out), *_opts(root),
                               "TEST.EXPECTED_RESULTS", PASSING,
                               "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0"])
    assert {"bbox/AP", "bbox/AP50", "segm/AP", "segm/AP50"} <= set(metrics)
    records = json.loads(out.read_text())
    val = json.loads((root / "val.json").read_text())
    assert records and {r["category_id"] for r in records} <= {1, 2, 3}
    assert {r["image_id"] for r in records} <= {im["id"] for im in val["images"]}
    assert all(len(r["bbox"]) == 4 and isinstance(r["segmentation"]["counts"], str)
               for r in records)


def test_eval_fails_on_expected_results(trained):
    with pytest.raises(SystemExit, match="EXPECTED_RESULTS failed:\nbbox/AP: expected 99.0"):
        tools_eval.main(["--device", "cpu", *_opts(trained["root"]),
                         "TEST.EXPECTED_RESULTS", FAILING])


def test_eval_exit_code_on_failure(trained):
    proc = subprocess.run(
        [sys.executable, "-m", "detectron2_tensorflow_tpu_torch.tools.eval", "--device", "cpu",
         *_opts(trained["root"]), "TEST.EXPECTED_RESULTS", FAILING],
        cwd=REPO, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 1, proc.stderr[-2000:]
    assert "EXPECTED_RESULTS failed" in proc.stderr


def test_eval_watch_writes_each_new_step(trained):
    root = trained["root"]
    log = root / "logs" / "eval_metrics.jsonl"
    if log.exists():
        log.unlink()
    tools_eval.main(["--device", "cpu", "--watch", "1", "--watch_timeout", "0",
                     "--max_images", "1", *_opts(root)])
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert [x["step"] for x in lines] == [3] and "bbox/AP" in lines[0]


def test_eval_restores_a_checkpoint_file_or_warns_of_random_weights(trained, tmp_path, caplog):
    root = trained["root"]
    ckpt = os.path.join(trained["second"]["checkpoint_dir"], "2.pt")
    with caplog.at_level("INFO"):
        tools_eval.main(["--device", "cpu", "--checkpoint", ckpt, "--max_images", "1",
                         *_opts(root)])
    assert f"restoring {ckpt}" in caplog.text
    caplog.clear()
    with caplog.at_level("INFO"):
        tools_eval.main(["--device", "cpu", "--checkpoint", str(tmp_path), "--max_images", "1",
                         *_opts(root)])
    assert "evaluating random weights" in caplog.text


@pytest.mark.parametrize("tool,opts,match", [
    ("build_records", ["BUILD_RECORDS.TYPE", "coco_pano"], "BUILD_RECORDS.TYPE coco_pano"),
    ("train", ["MODEL.KEYPOINT_ON", "True", "AUGMENT.CROP.ENABLED", "True"], "AUGMENT.CROP.ENABLED"),
    ("eval", ["TEST.AUG.ENABLED", "True"], "TEST.AUG"),
    ("eval", ["EVAL.METRICS", "['panoptic_segmentation_metrics']"], "panoptic"),
])
def test_unported_options_raise_naming_the_key(trained, tool, opts, match):
    main = {"build_records": tools_build_records.main, "train": tools_train.main,
            "eval": tools_eval.main}[tool]
    device = [] if tool == "build_records" else ["--device", "cpu"]
    with pytest.raises(NotImplementedError, match=match):
        main([*device, *_opts(trained["root"]), *opts])


def test_workflow_check_runs_its_four_steps(tmp_path, capsys):
    """The workflow script's plumbing at a tiny size: one iteration and a
    gate any model passes (its own gate needs the card's 600 iterations)."""
    result = workflow_check.run_workflow(str(tmp_path / "wf"), device="cpu", opts=NARROW,
                                         max_iter=1, expected=PASSING, echo=False)
    assert result["train"]["steps"] == 1
    assert {"bbox/AP", "segm/AP"} <= set(result["metrics"])
    assert set(result["seconds"]) == {"synthetic", "build_records", "train", "eval"}
    assert "records ok: 16 examples" in capsys.readouterr().out


def test_workflow_check_gate_is_the_jax_workflows():
    script = (REPO / "tools" / "workflow_check.sh").read_text()
    assert workflow_check.EXPECTED in script
    assert f"CFG={workflow_check.CFG}" in script
