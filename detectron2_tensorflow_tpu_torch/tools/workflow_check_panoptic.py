"""The panoptic CLI workflow on synthetic data, gated on box AP, mIoU and PQ.

    python -m detectron2_tensorflow_tpu_torch.tools.workflow_check_panoptic [ROOT] [--device cpu]

The port's counterpart of the repo's ``tools/workflow_check_panoptic.sh``,
step for step, each step a subprocess running the port's CLIs from the repo
root:

  1. ``tools.make_synthetic_coco ROOT 16 8 --panoptic``;
  2. ``tools.build_records`` (``coco_pano``, 2 train shards, 1 val shard),
     then the train records are read back: 16 examples, each with a
     ``sem_seg`` map of 240x320 whose labels lie in {0, 1, 2} (things, floor,
     sky);
  3. ``tools.train`` on ``configs/synthetic/overfit_panoptic_R_18.yaml``
     (PanopticFPN R18-FPN with GN, from scratch, 600 iterations of 8 images
     at 192x256, from the panoptic records);
  4. ``tools.eval`` on the train split with ``TEST.EXPECTED_RESULTS``
     ``[['bbox', 'AP', 88.0, 10.0], ['sem_seg', 'mIoU', 92.0, 8.0],
     ['panoptic', 'PQ', 88.0, 12.0]]`` (the gate of the repo's script),
     whose failure exits non-zero: COCO bbox AP over the records' boxes,
     mIoU and PQ over the panoptic JSON.

ROOT (default ``synthetic_pano`` in the working directory) is emptied
first. Any failed step raises ``subprocess.CalledProcessError``; the last
line is ``PANOPTIC WORKFLOW CHECK PASSED``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import time
from typing import Dict, Optional, Sequence

import numpy as np

from ..data import TFRecordDataset
from .workflow_check import eval_metrics, run_step, train_summary

CFG = "configs/synthetic/overfit_panoptic_R_18.yaml"
EXPECTED = ("[['bbox', 'AP', 88.0, 10.0], ['sem_seg', 'mIoU', 92.0, 8.0], "
            "['panoptic', 'PQ', 88.0, 12.0]]")
GATED = ("bbox/AP", "sem_seg/mIoU", "panoptic/PQ")


def check_records(root: str) -> int:
    """Step 2's read-back of the train records; returns their count."""
    ds = TFRecordDataset(os.path.join(root, "train.record-*"))
    sem = ds[0].get("sem_seg")
    labels = set(np.unique(sem).tolist()) if sem is not None else None
    if len(ds) != 16 or sem is None or sem.shape != (240, 320) or not labels <= {0, 1, 2}:
        raise AssertionError(f"panoptic records read back: {len(ds)} examples, sem_seg "
                             f"{None if sem is None else sem.shape} with labels {labels}")
    return len(ds)


def run_workflow(root: str, device: str = "cuda", opts: Sequence[str] = (),
                 max_iter: Optional[int] = None, expected: str = EXPECTED,
                 env: Optional[Dict[str, str]] = None, echo: bool = True) -> dict:
    """Steps 1-4 into ``root``; ``opts`` are extra ``KEY VALUE`` overrides
    for every CLI, ``max_iter`` replaces the config's 600 iterations.
    Returns the train summary, the eval metrics and each step's seconds."""
    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    common = ["--config_file", CFG, "DATASETS.ROOT_DIR", root, "LOGS.ROOT_DIR",
              os.path.join(root, "logs"), *opts]
    dev = ["--device", device]
    seconds = {}

    t0 = time.perf_counter()
    run_step("make_synthetic_coco", [root, "16", "8", "--panoptic"], env, echo)
    seconds["synthetic"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    run_step("build_records", [*common, "BUILD_RECORDS.TYPE", "coco_pano",
                               "BUILD_RECORDS.TRAIN_NUM_SHARDS", "2",
                               "BUILD_RECORDS.VAL_NUM_SHARDS", "1"], env, echo)
    print(f"pano records ok: {check_records(root)} examples", flush=True)
    seconds["build_records"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    iters = [] if max_iter is None else ["--max_iter", str(max_iter)]
    train = train_summary(run_step("train", [*dev, *iters, *common], env, echo))
    seconds["train"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = run_step("eval", [*dev, *common, "DATASETS.VAL", "train",
                            "TEST.EXPECTED_RESULTS", expected], env, echo)
    seconds["eval"] = time.perf_counter() - t0
    return {"train": train, "metrics": eval_metrics(out), "seconds": seconds}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("root", nargs="?", default="synthetic_pano")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    result = run_workflow(args.root, args.device)
    print(json.dumps({k: result["metrics"][k] for k in GATED}))
    print("PANOPTIC WORKFLOW CHECK PASSED")


if __name__ == "__main__":
    main()
