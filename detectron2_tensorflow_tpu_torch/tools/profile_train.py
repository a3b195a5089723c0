"""Where the time of one training step goes on the card.

    python -m detectron2_tensorflow_tpu_torch.tools.profile_train [--config_file CFG] [batch ...]

Builds chip_smoke's training state (Mask R-CNN R50-FPN at ``train_cfg``:
bf16, float32 parameters, seeded random weights; with ``--config_file``,
that YAML's model in bf16 with ``batch`` images per step and at most 64 GT
instances per image, as ``train_cfg``), steps on a seeded
800x1344 ``make_train_batch`` of each given size (default 8), and prints:
images/s on the host clock around synchronized steps, the peak device
memory, and from ``torch.profiler`` the device time per step, the device's
idle share, the device time by category (as ``profile_predict``) and the top
kernels; for a model with a semantic head, the device ms of that head's
forward, ``sem_seg_loss`` and backward on the step's features, and for
SOLOv2 its head's forward, losses and backward. The full
profiler table goes to
``profile_train[_<config>]_b<batch>[_fused].txt`` beside
``profile_predict``'s (``D2TPU_ENABLE_FUSED_EPILOGUE=1``: the fused
bottleneck tail).
"""

from __future__ import annotations

import sys
import time
from pathlib import Path
from typing import Optional

import torch

from detectron2_tensorflow_tpu_torch import build_model, train_cfg
from detectron2_tensorflow_tpu_torch.engine import (
    add_proposal_slots,
    build_train_step,
    create_train_state,
    make_train_batch,
)
from detectron2_tensorflow_tpu_torch.tools import profile_predict


def training_cfg(batch: int, config_file: Optional[str] = None):
    """``train_cfg(batch)``, or ``config_file``'s model in bf16 with
    ``batch`` images per step, no LR auto-scaling and ``train_cfg``'s 64 GT
    slots per image."""
    if not config_file:
        return train_cfg(batch)
    cfg = profile_predict.yaml_cfg(config_file)
    cfg.SOLVER.IMS_PER_BATCH = batch
    cfg.SOLVER.AUTO_SCALE_LR_SCHEDULE = False
    cfg.INPUT.MAX_GT_INSTANCES = 64
    return cfg


def run(batch: int, out_dir: Path, config_file: Optional[str] = None) -> None:
    dev = torch.device("cuda", 0)
    cfg = training_cfg(batch, config_file)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(0),
                        training=True)
    state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(0))
    step = build_train_step(cfg, state)
    data = make_train_batch(cfg)
    if cfg.MODEL.LOAD_PROPOSALS:
        data = add_proposal_slots(cfg, data, training=True)
    data = {k: torch.from_numpy(v).to(dev) for k, v in data.items()}
    for _ in range(2):
        step(data)
    torch.cuda.synchronize()

    iters = 6
    t0 = time.perf_counter()
    for _ in range(iters):
        step(data)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / iters
    print(f"batch {batch}: {batch / wall:.2f} img/s, {wall * 1000:.2f} ms/step (host clock), "
          f"peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB")
    profile_predict.profile(lambda: step(data), 3, f"batch {batch}",
                            out_dir / f"profile_train{profile_predict.name_of(config_file)}"
                                      f"_b{batch}{profile_predict.suffix()}.txt")
    if hasattr(model, "sem_seg_head"):
        from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import semantic_logits
        from detectron2_tensorflow_tpu_torch.models.sem_seg import sem_seg_loss

        with torch.no_grad():
            feats = model.features(data["image"])
        feats = {k: v.detach().requires_grad_(True) for k, v in feats.items()}

        def head_step():
            loss = sem_seg_loss(semantic_logits(model, feats), data["gt_sem_seg"],
                                model.sem_seg_ignore, model.sem_seg_loss_weight)
            loss.backward()

        ms = profile_predict.device_time(head_step, 3)
        model.zero_grad(set_to_none=True)
        print(f"  sem_seg head forward + loss + backward: device {ms[0]:.3f} ms/step, wall "
              f"{ms[1]:.3f} ms")
    if hasattr(model, "solov2"):
        with torch.no_grad():
            feats = model.features(data["image"])
        feats = {k: v.detach().requires_grad_(True) for k, v in feats.items()}
        gen = torch.Generator(device=dev).manual_seed(0)

        def solo_step():
            cate, kernels, mask_feat = model.head(feats)
            losses = model.solov2.losses([c.float() for c in cate], [k.float() for k in kernels],
                                         mask_feat.float(), data,
                                         tuple(data["image"].shape[1:3]), gen)
            sum(losses.values()).backward()

        ms = profile_predict.device_time(solo_step, 3)
        model.zero_grad(set_to_none=True)
        print(f"  SOLOv2 head forward + losses + backward: device {ms[0]:.3f} ms/step, wall "
              f"{ms[1]:.3f} ms")


def main(argv) -> None:
    profile_predict.main(argv, run, default_batch=8)


if __name__ == "__main__":
    main(sys.argv[1:])
