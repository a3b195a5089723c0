"""The CLI workflow on synthetic data, gated on AP: the port learns.

    python -m detectron2_tensorflow_tpu_torch.tools.workflow_check [ROOT] [--device cpu]

The port's counterpart of steps 1-4 of the repo's ``tools/workflow_check.sh``
(step 5, export, waits for the export slice), each step a subprocess
running the port's CLIs from the repo root:

  1. ``tools.make_synthetic_coco ROOT 16 8``;
  2. ``tools.build_records`` (``coco_det``, 2 train shards, 1 val shard),
     then the train records are read back (16 examples of 240x320x3, each
     with a box);
  3. ``tools.train`` on ``configs/synthetic/overfit_mask_rcnn_R_18.yaml``
     (Mask R-CNN R18-FPN with GN, from scratch, 600 iterations of 8 images
     at 192x256);
  4. ``tools.eval`` on the train split with ``TEST.EXPECTED_RESULTS``
     ``[['bbox', 'AP', 88.0, 10.0], ['segm', 'AP', 84.0, 12.0]]``: the JAX
     package's own gate, whose failure exits non-zero.

ROOT (default ``synthetic_coco`` in the working directory) is emptied
first. Any failed step raises ``subprocess.CalledProcessError``; the last
line is ``WORKFLOW CHECK PASSED``.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Optional, Sequence

from ..data import TFRecordDataset

REPO = Path(__file__).resolve().parents[2]
CFG = "configs/synthetic/overfit_mask_rcnn_R_18.yaml"
EXPECTED = "[['bbox', 'AP', 88.0, 10.0], ['segm', 'AP', 84.0, 12.0]]"
_METRIC = re.compile(r"^(\w+/[\w@.\-]+): (\S+)$")


def run_step(tool: str, args: Sequence[str], env: Optional[Dict[str, str]] = None,
             echo: bool = True) -> str:
    """Run ``python -m detectron2_tensorflow_tpu_torch.tools.<tool> args``
    from the repo root; returns its output (stdout and stderr), echoed, and
    raises ``CalledProcessError`` when it fails."""
    cmd = [sys.executable, "-m", f"detectron2_tensorflow_tpu_torch.tools.{tool}", *args]
    proc = subprocess.run(cmd, cwd=REPO, env={**os.environ, **(env or {})},
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if echo or proc.returncode:
        print(proc.stdout, end="", flush=True)
    if proc.returncode:
        raise subprocess.CalledProcessError(proc.returncode, cmd, proc.stdout)
    return proc.stdout


def train_summary(output: str) -> dict:
    """The ``train summary {json}`` line of ``tools.train``'s output."""
    lines = [ln for ln in output.splitlines() if ln.startswith("train summary ")]
    if not lines:
        raise RuntimeError("tools.train printed no summary line")
    return json.loads(lines[-1][len("train summary "):])


def eval_metrics(output: str) -> Dict[str, float]:
    """The ``name: value`` metric lines of ``tools.eval``'s output."""
    return {m.group(1): float(m.group(2))
            for m in map(_METRIC.match, output.splitlines()) if m}


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
    run_step("make_synthetic_coco", [root, "16", "8"], env, echo)
    seconds["synthetic"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    run_step("build_records", [*common, "BUILD_RECORDS.TYPE", "coco_det",
                               "BUILD_RECORDS.TRAIN_NUM_SHARDS", "2",
                               "BUILD_RECORDS.VAL_NUM_SHARDS", "1"], env, echo)
    ds = TFRecordDataset(os.path.join(root, "train.record-*"))
    sample = ds[0]
    if len(ds) != 16 or sample["image"].shape != (240, 320, 3) or len(sample["boxes"]) < 1:
        raise AssertionError(f"records readback: {len(ds)} examples, image "
                             f"{sample['image'].shape}, {len(sample['boxes'])} boxes")
    print(f"records ok: {len(ds)} examples", flush=True)
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
    p.add_argument("root", nargs="?", default="synthetic_coco")
    p.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = p.parse_args(argv)
    result = run_workflow(args.root, args.device)
    print(json.dumps({k: result["metrics"][k] for k in ("bbox/AP", "segm/AP")}))
    print("WORKFLOW CHECK PASSED")


if __name__ == "__main__":
    main()
