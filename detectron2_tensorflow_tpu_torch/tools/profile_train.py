"""Where the time of one training step goes on the card.

    python -m detectron2_tensorflow_tpu_torch.tools.profile_train [--config_file CFG] [batch ...]
        [KEY VALUE ...]

Builds chip_smoke's training state (Mask R-CNN R50-FPN at ``train_cfg``:
bf16, float32 parameters, seeded random weights; with ``--config_file``,
that YAML's model in bf16 with ``batch`` images per step and at most 64 GT
instances per image, as ``train_cfg``), steps on a seeded
``make_train_batch`` of each given size (default 8) at the config's first
``INPUT.PAD_BUCKETS`` entry (800x1344, or 608x608 for
``configs/COCO-Detection/yolov4_D_53_PAN_1x.yaml``), and prints:
images/s on the host clock around synchronized steps, the peak device
memory, and from ``torch.profiler`` the device time per step, the device's
idle share, the device time by category (as ``profile_predict``) and the top
kernels; for a model with a semantic head, the device ms of that head's
forward, ``sem_seg_loss`` and backward on the step's features, for
SOLOv2 and YOLOv4 the head's forward, losses and backward, and for
Relation Networks (``configs/Misc/relation_rcnn_R_50_FPN_1x.yaml``) the
relation box head's forward and backward on the step's sampled ROIs and,
with the duplicate removal, ``loss_dup``'s. The full
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
from detectron2_tensorflow_tpu_torch.models.roi_heads.relation import RelationROIHeads
from detectron2_tensorflow_tpu_torch.models.rpn import add_ground_truth_to_proposals
from detectron2_tensorflow_tpu_torch.models.sampling import draw_noise
from detectron2_tensorflow_tpu_torch.tools import profile_predict


def training_cfg(batch: int, config_file: Optional[str] = None, opts=()):
    """``train_cfg(batch)``, or ``config_file``'s model (``opts`` over it) in bf16 with
    ``batch`` images per step, no LR auto-scaling and ``train_cfg``'s 64 GT
    slots per image."""
    if not config_file:
        return train_cfg(batch)
    cfg = profile_predict.yaml_cfg(config_file, opts)
    cfg.SOLVER.IMS_PER_BATCH = batch
    cfg.SOLVER.AUTO_SCALE_LR_SCHEDULE = False
    cfg.INPUT.MAX_GT_INSTANCES = 64
    return cfg


def run(batch: int, out_dir: Path, config_file: Optional[str] = None, opts=()) -> None:
    dev = torch.device("cuda", 0)
    cfg = training_cfg(batch, config_file, opts)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(0),
                        training=True)
    state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(0))
    step = build_train_step(cfg, state)
    data = make_train_batch(cfg, *profile_predict.serving_shape(cfg)[0])
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
    if hasattr(model, "yolov4"):
        profile_yolov4(model, data)
    if isinstance(getattr(model, "roi_heads", None), RelationROIHeads):
        t = relation_train_times(model, data)
        dup = (f"; loss_dup forward + backward (every sampled slot a candidate, "
               f"{len(model.roi_heads.dup_ious)} IoU heads): device {t['dup_ms']:.3f} ms/step"
               if "dup_ms" in t else "; no duplicate removal")
        print(f"  relation box head forward + backward ({t['rois'][0]} x {t['rois'][1]} sampled "
              f"ROIs): device {t['head_ms']:.3f} ms/step" + dup)


def relation_train_times(model, data) -> dict:
    """Device ms per step, on the step's sampled ROIs (the training
    proposals, the GT appended, one seeded draw of the sampler), of the
    relation box head's forward and backward (fc1, relation1, fc2,
    relation2 from the pooled ROIs) and, when the model has the duplicate
    removal, of ``loss_dup``'s (candidates, keep logits, targets, BCE) on
    the head's outputs."""
    heads, rpn = model.roi_heads, model.proposal_generator
    dev = data["image"].device
    with torch.no_grad():
        feats = model.features(data["image"])
        props = rpn.proposals(*rpn.rpn_head([feats[f] for f in rpn.in_features]),
                              data["image_size"], training=True)
        props = add_ground_truth_to_proposals(props, data)
        noise = draw_noise(torch.Generator(device=dev).manual_seed(0), props.is_valid.shape, dev)
        sampled = heads.label_and_sample_proposals(props, data, noise)
        pooled = heads.pool_box_features(sampled.boxes, heads.pooling_storage(feats),
                                         valid=sampled.valid)
    pooled.requires_grad_(True)

    def head_step():
        x = heads.box_head(pooled, sampled.boxes, sampled.valid)
        x.float().square().mean().backward()

    out = {"rois": tuple(sampled.boxes.shape[:2]),
           "head_ms": profile_predict.device_time(head_step, 3)[0]}
    if heads.duplicate_removal is not None:
        with torch.no_grad():
            outs = [x.detach() for x in heads.box_outputs(pooled, sampled.boxes, sampled.valid)]
        scores, deltas, app = [x.requires_grad_(True) for x in
                               (outs[0].float(), outs[1].float(), outs[2])]
        out["dup_ms"] = profile_predict.device_time(
            lambda: heads.dup_removal_loss(scores, deltas, app, sampled, data).backward(), 3)[0]
    model.zero_grad(set_to_none=True)
    return out


def profile_yolov4(model, data) -> None:
    """YOLOv4's head (the three 3x3 convs and predictors), its losses (decode,
    the matcher with its ``[B, G, R]`` CIoU, the three losses) and their
    backward to the features, on the step's features; then the losses alone
    on the head's maps."""
    drv = model.yolov4
    with torch.no_grad():
        feats = model.features(data["image"])
    levels = [feats[f].detach().requires_grad_(True) for f in drv.in_features]

    def yolo_step():
        maps = [p.float() for p in model.head(levels)]
        sum(drv.losses(maps, data).values()).backward()

    ms = profile_predict.device_time(yolo_step, 3)
    with torch.no_grad():
        maps = [p.float() for p in model.head(levels)]
    loss_ms = profile_predict.device_time(lambda: drv.losses(maps, data), 3)
    model.zero_grad(set_to_none=True)
    g = data["gt_boxes"].shape[1]
    cands = sum(m.shape[2] * m.shape[3] for m in maps) * drv.num_anchors
    print(f"  YOLOv4 head forward + losses + backward ({cands} candidates, {g} GT slots): "
          f"device {ms[0]:.3f} ms/step, wall {ms[1]:.3f} ms; losses alone (no gradient): "
          f"device {loss_ms[0]:.3f} ms, wall {loss_ms[1]:.3f} ms")


def main(argv) -> None:
    profile_predict.main(argv, run, default_batch=8)


if __name__ == "__main__":
    main(sys.argv[1:])
