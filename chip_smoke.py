"""GPU smoke run of the PyTorch/CUDA port (``detectron2_tensorflow_tpu_torch``).

    python3 chip_smoke.py

Needs one CUDA card and ``nvcc``; imports nothing of JAX. Phases, in order
(but 10 runs after 13), any failure exits non-zero:

  1. device: a CUDA card is required;
  2. build: the hand-written kernels (``csrc/*.cu``: ``nms_keep``;
     ``roi_patch_fwd`` with its ablation variants and ``roi_patch_bwd`` in
     one library; ``fused_residual``) are compiled for sm_90a, one nvcc per
     source, in parallel;
  3. kernels: each kernel is held against its plain PyTorch version on the
     card at the slices' shapes (inputs from a seeded numpy generator) and
     both are timed with CUDA events after warm-up, beside the least time
     the card could take (bound) and, for the fused bottleneck tail, the
     port's unfused tail as the PyTorch yardstick. The fused tail is held
     at R50's four tail shapes at batch 2 and 8, each on the persistent
     ``wgmma`` path, and its host cost per call is read on that path and on
     the ``mma.sync`` one. ``nms_keep``'s keep masks
     are bit-equal at serving's RPN (10 x 1000, and stacked with p6's 819
     rows padded to 1000), the box head (2 x 2000, ``max_keep`` 100) and
     training's stacked RPN (40 x 2000, ``max_keep`` 1000);
     The kernel checks of phases 9-16 at their shapes run next, in a phase
     of their own (``later_kernels``): from phase 8 on, the gates' processes
     share the card, which would distort the timings;
  4. variants: the ROI forward's seven ablations at the ROI tool's shapes
     with 2 images, each held against its plain version (``full`` bit-equal
     to ``roi_patch_interpolate``), then timed through the tool's own
     entry point (``tools/exp_roi_variants.main``);
  5. model: Mask R-CNN R50-FPN (``bench_cfg()``'s model, seeded random
     weights, ``SCORE_THRESH_TEST = 0`` so all 100 detection slots are real)
     is built twice through ``build_model(cfg)`` (on the card by default),
     with ``D2TPU_ENABLE_FUSED_EPILOGUE`` unset and set, and serves a seeded
     random 2 x 800 x 1344 bf16 batch through ``model.predict(batch)`` in
     turns (off, on, on, off, twice); the kernels' launch counts are read
     around that run (16 fused tails per ``predict`` with the switch on,
     all on the ``wgmma`` path, 0 off; 2 ``nms_keep`` launches per
     ``predict``); outputs are checked,
     and a narrow float32 model is held against the same model run on the
     CPU (where every kernel takes its plain version) on a small input,
     switch off and on;
  6. train: the same model at ``train_cfg(8)`` (bf16, float32 parameters,
     seeded random weights), switch off and on, takes 2 warm-up steps each
     and 8 x 3 timed steps in turns on a seeded 8 x 800 x 1344 batch
     through ``create_train_state`` + ``build_train_step``; the launch
     counts are read around the timed steps (16 fused tails per step with
     the switch on, all on the ``wgmma`` path, 1 ``nms_keep`` launch per
     step); losses must be finite,
     the frozen stem and res2 unchanged bit for bit, every trainable
     parameter changed; and a narrow
     float32 train step on 2 x 128 x 160 is held against the same step on
     the CPU (same weights, noise and proposals), switch off and on;
  7. loop: the user's path with the switch off. ``get_cfg()`` merges
     ``configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml`` and a
     few overrides (bf16, 8 images per step, a checkpoint every 2 steps,
     ``SCORE_THRESH_TEST`` 0) and ``finalize`` freezes it on the card: R50-FPN
     at full width, 80 classes, the YAML's 640-800 training scales, the
     800x1344 bucket. ``train()`` takes 4 steps from the loader over 16
     synthetic 480x640 images into a temporary checkpoint directory; a new
     model resumes there at step 4 (the restored state bit-equal to the
     saved one) and trains to step 6; ``run_evaluation`` evaluates 8 other
     images (COCO bbox and segm). Losses and metrics must be finite (an
     area range without GT gives NaN), each step must launch ``nms_keep``
     once and each ``predict`` twice. It prints the seconds per iteration
     and the host seconds of data loading per batch;
  8. workflow: the port's CLIs (``python -m
     detectron2_tensorflow_tpu_torch.tools.<name>``) as subprocesses in a
     temporary directory, with the switch off. (a) R50-FPN at full width
     from records: ``tools.make_synthetic_coco`` (16 train and 8 val
     images), ``tools.build_records`` (2 + 1 shards), ``tools.train`` on the
     loop phase's YAML and overrides to step 4 (checkpoints [2, 4]) and a
     second ``tools.train`` that resumes there to step 6 (checkpoints
     [4, 6]), each step launching one ``nms_keep``, two ``roi_patch_fwd``
     and two ``roi_patch_bwd`` (the train CLI reports its counts on its
     ``train summary`` line), then ``tools.eval`` over the val records with
     ``--dump_results`` (the JSON parses and names the dataset's category
     and image ids). (b) the overfit gate: ``tools/workflow_check.py`` on
     ``configs/synthetic/overfit_mask_rcnn_R_18.yaml`` (R18-FPN with GN,
     from scratch, 600 iterations of 8 x 192x256, with the switch set: no
     tail is fused), whose ``tools.eval`` on the train split must pass
     ``TEST.EXPECTED_RESULTS`` ``[['bbox', 'AP', 88.0, 10.0], ['segm', 'AP',
     84.0, 12.0]]``; it prints the APs, the final loss, the train seconds,
     the seconds per iteration and the loader's host seconds per batch.
     Beside (b) run the overfit gates of phases 9 to 17, sixteen
     ``tools.overfit_check`` subprocesses (the relation gate's one per
     seed), and phase 13's panoptic workflow
     (host-bound, as (b) is). (a) runs in the phase; (b) (on a thread), the
     gates and the panoptic workflow start at its end and run on beside
     phases 9-17, and the last phase, ``gates``, waits for them and checks
     them (this keeps the script inside its time limit);
  9. single_level: the C4 (``Res5ROIHeads``) and DC5 (dilated res5)
     families. Each kernel at their shapes against its plain version, timed
     beside its bound: ``nms_keep`` bit-equal on one RPN level of 2 x 6000
     (``max_keep`` 1000) and 8 x 12000 (``max_keep`` 2000);
     ``roi_patch_fwd`` on a one-level stride-16 plane at C = 1024, S = 14
     (2 x 1000, 2 x 100) and C = 2048, S = 7 (2 x 1000) and S = 14 (2 x
     100); ``roi_patch_bwd`` at C = 1024, S = 14 (8 x 512) and C = 2048,
     S = 7 (8 x 512) and S = 14 (8 x 128); ``fused_residual`` at M = 98000
     and 8400 (K 512, N 2048). Then ``mask_rcnn_R_50_{C4,DC5}_1x.yaml`` in
     bf16 (``SCORE_THRESH_TEST`` 0, seeded random weights) serve 2 x 800 x
     1344 through ``build_model(cfg)`` + ``model.predict`` with the switch
     off and on in turns (launches per ``predict`` asserted: 2 ``nms_keep``
     and 2 ``roi_patch_fwd`` each, 19 fused tails for C4 and 16 for DC5
     with the switch on; outputs checked; img/s, device ms per call and idle
     share printed); narrow float32 C4 and DC5 models and train steps are
     held against the CPU; each YAML trains 2 + 3 steps at 8 x 800 x 1344
     (per step C4 1 ``nms_keep``, 1 ``roi_patch_fwd``, 1 ``roi_patch_bwd``;
     DC5 1, 2, 2; losses finite, the frozen stem and res2 bit-equal, every
     trainable parameter moved, the C4 head's res5 included). Their overfit
     gates, ``tools.overfit_check 1200 --eval_at 600 --arch c4`` and
     ``600 --arch rcnn``, run in phase 8, each needing bbox AP50 >= 90 at
     its last step (and c4 at step 600 a bbox AP no more than 10 below the
     JAX package's on the same recipe and step count);
 10. two_stage: the rest of the two-stage FPN family. ``nms_keep``
     bit-equal on one RPN level of 2 x 6000 with ``max_keep`` 2000
     (``rpn_R_50_C4_1x``'s serving shape), timed beside its bound; the
     RPN-only ``ProposalNetwork`` of ``rpn_R_50_{FPN,C4}_1x.yaml`` serving 2 x
     800 x 1344 bf16 (2000 proposal slots per image, finite and clipped; 1
     ``nms_keep`` per ``predict``), training 3 steps at 8 x 800 x 1344 (no
     kernel: RPN losses only) and ``evaluate`` over 8 synthetic images
     (``box_proposals/AR@100``, ``AR@1000``); Fast R-CNN
     (``fast_rcnn_R_50_FPN_1x.yaml``) through the CLIs in a temporary
     directory: ``tools.make_synthetic_coco``, a Detectron2 proposal pickle
     per split (``data.write_proposal_file``), ``tools.train`` 2 steps at
     800 x 1344 with ``DATASETS.PROPOSAL_FILES_TRAIN`` (per step 0
     ``nms_keep``, 1 ``roi_patch_fwd``, 1 ``roi_patch_bwd``) and
     ``tools.eval`` with ``PROPOSAL_FILES_TEST``; the GN and SyncBN Mask
     R-CNN YAMLs (``Misc/mask_rcnn_R_50_FPN_3x_{gn,syncbn}.yaml``): GN
     serves (switch off and on, 0 fused tails either way) and both train 3
     steps at 8 x 800 x 1344 (per step 1 / 2 / 2 launches, per ``predict`` 2
     / 2), SyncBN's every BN buffer moved (the frozen stem's too), then
     ``precise_bn`` over 4 batches and a served ``predict``; peak memory
     of each training run. Narrow float32 models and train steps of the
     four configs are held against the CPU (the normed models' gradients
     where no normalized layer's backward separates them from the loss,
     on tie-free weights, as ``tests/test_torch_norms.py`` holds them
     against JAX). ``tools.overfit_check 600 --arch cls_agnostic`` runs
     with phase 9's two gates in phase 8, as a third subprocess at once
     (bbox AP50 >= 90);
 11. single_stage_cascade: RetinaNet and Cascade Mask R-CNN. ``nms_keep``
     bit-equal at RetinaNet's serving shape (2 x 5000 class-offset
     candidates, IoU 0.5, ``max_keep`` 100), timed beside its bound; narrow
     float32 RetinaNet and Cascade models and train steps held against the
     CPU; ``retinanet_R_50_FPN_1x.yaml`` and
     ``cascade_mask_rcnn_R_50_FPN_1x.yaml`` (bf16, ``SCORE_THRESH_TEST`` 0,
     seeded random weights) serve 2 x 800 x 1344 with the switch off and on
     (per ``predict`` RetinaNet 1 ``nms_keep`` and no pooling, the cascade 2
     ``nms_keep`` and 4 ``roi_patch_fwd``: three box stages and the masks;
     16 fused tails on, 0 off; 100 valid finite clipped detections per
     image) and train 3 steps at 8 x 800 x 1344 (per step RetinaNet no
     kernel, the cascade 1 / 4 / 4 ``nms_keep`` / ``roi_patch_fwd`` /
     ``roi_patch_bwd``; losses finite, the frozen stem and res2 bit-equal,
     every trainable parameter moved, RetinaNet's ``loss_normalizer``
     moved; device ms per step and peak memory). Their overfit gates,
     ``tools.overfit_check 600 --arch retinanet`` and ``--arch cascade``,
     run in phase 8 beside the others (bbox AP50 >= 90);
 12. keypoint: Keypoint R-CNN R50-FPN. ``nms_keep`` bit-equal at its
     training RPN (8 images x 5 levels of 2000, ``max_keep`` 1500, the
     YAML's ``POST_NMS_TOPK_TRAIN``); ``roi_patch_fwd`` on the keypoint
     pooler's fixed-ratio plan (sampling ratio 2, S = 14, C = 256) at 2 x
     100 and 8 x 128, bf16 and float32, and ``roi_patch_bwd`` on it at 8 x
     128, each timed beside its bound; a narrow float32 model and train
     step held against the CPU (``pred_keypoints`` x, y to 1e-3 px, scores
     to 1e-5, ``loss_keypoint`` and the gradients to the phase's standing
     tolerances); ``keypoint_rcnn_R_50_FPN_1x.yaml`` (bf16, seeded random
     weights) serving 2 x 800 x 1344 with the switch off and on (100 valid
     finite clipped detections per image, every keypoint finite and inside
     its box; per ``predict`` 2 ``nms_keep`` and 2 ``roi_patch_fwd``, 16
     fused tails on) and training 3 steps at 8 x 800 x 1344 with 64 GT of
     17 keypoints each (per step 1 ``nms_keep``, 2 ``roi_patch_fwd``, 2
     ``roi_patch_bwd``: box and keypoint ROIs in one fused pool; losses
     finite, ``loss_keypoint`` among them, the frozen stem and res2
     bit-equal, every trainable parameter moved but the keypoint deconv's
     bias, whose gradient is zero: a per-keypoint constant does not move a
     softmax over the positions); device ms per call, idle share, peak
     memory. Its overfit gate, ``tools.overfit_check 600 --arch keypoint``,
     runs in phase 8 beside the others: bbox AP50 >= 90, and a keypoint AP
     no more than 10 below the JAX package's on the same recipe;
 13. panoptic: PanopticFPN (``panoptic_fpn_R_50_1x.yaml``) and the
     SemanticSegmentor (``semantic_R_50_FPN_1x.yaml``). No kernel shape is
     new (PanopticFPN's instance branch is R50-FPN's). Narrow float32 models
     and train steps held against the CPU: ``sem_seg`` equal wherever the
     two largest logits lie more than 1e-5 apart, ``sem_seg_logits`` to
     1e-4 of their largest magnitude, ``loss_sem_seg`` to 1e-5 relative,
     every gradient (``sem_seg_head``'s too) to 1e-4 of its largest, and
     ``panoptic_fusion`` of the CPU's detections and map bit-equal on the
     card. Each YAML (bf16, ``SCORE_THRESH_TEST`` 0, seeded random weights)
     serves 2 x 800 x 1344 with the switch off and on (PanopticFPN per
     ``predict`` 2 ``nms_keep`` and 2 ``roi_patch_fwd``, the
     SemanticSegmentor none, 16 fused tails on for both; ``sem_seg [2, 800,
     1344]`` in ``[0, 54)``, padding zeroed by ``sem_seg_postprocess``);
     ``panoptic_fusion`` runs on PanopticFPN's output at the YAML's
     thresholds and with confidence 0, its segment table held against its
     map, with its wall and device ms. Each trains 3 steps at 8 x 800 x 1344
     with 64 GT and a ``gt_sem_seg`` with ignored pixels (per step 1 / 2 / 2
     and 0 / 0 / 0; losses finite, ``loss_sem_seg`` among them, the frozen
     stem and res2 bit-equal, every trainable parameter moved) with device
     ms, idle share and peak memory. Its gates run in phase 8 beside the
     others: ``tools.workflow_check_panoptic`` (the synthetic panoptic set,
     ``coco_pano`` records, PanopticFPN R18-GN 600 iterations, ``tools.eval``
     with ``TEST.EXPECTED_RESULTS`` bbox AP 88 ± 10, mIoU 92 ± 8, PQ 88 ±
     12; its exit code decides) and ``tools.overfit_check 600 --arch
     semantic`` (mIoU no more than 10 below the JAX tool's);
 14. dconv: deformable convolution, REMAT and TTA. ``DeformConv2d`` float32
     on the card against the CPU at R50's res3-res5 3x3 shapes (batch 2,
     800 x 1344) and a stride-2 v2 case with 2 deformable groups, real
     offsets (samples between pixels and off the map), 1e-4 of the largest
     output; the kernels at the slice's new shapes against their plain
     versions (``fused_residual`` at X152-32x8d's four K = N tails at batch
     2, ``nms_keep`` bit-equal at the TTA merge of 18 x 100 class-offset
     candidates, ``roi_patch_fwd`` on the 1280 x 2048 TTA plane and at
     ``predict_with_boxes``'s 800 x 1344); a narrow float32 R50-dconv
     model, train step and ``tta_predict`` on the card against the CPU;
     ``mask_rcnn_R_50_FPN_1x_dconv_c3-c5`` served 2 x 800 x 1344 (switch off
     and on; 2 / 2 launches per ``predict``, 16 tails on) and trained 3
     steps at 8 x 800 x 1344 (1 / 2 / 2; every ``conv_offset`` gradient
     finite and nonzero); ``cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv``
     served at batch 2 (switch on, 50 tails) and trained 1 step at batch 2
     with REMAT off and then on (REMAT's peak lower, the first step's
     losses equal) and at batch 8 with REMAT on; the panoptic
     ``panoptic_fpn_R_101_dconv_cascade_gn_3x`` served at batch 2 (the
     fusion timed) and trained 3 steps at batch 8; TTA of one 800 x 1333
     image under the default ``TEST.AUG`` (9 scales and flips: 37
     ``nms_keep`` and 37 ``roi_patch_fwd`` launches, 100 valid detections
     with masks), host and device ms. Its gate, ``tools.overfit_check 600
     --arch dconv`` (R50-GN, deformable c3-c5: bbox AP50 >= 90, every offset
     conv moved from zero), runs with the others;
 15. solov2: SOLOv2 R50-FPN. No kernel shape is new (its trunk's fused tails
     are R50-FPN's; it launches no NMS or pooling kernel). Narrow float32
     SOLOv2 models (plain and deformable v2 towers, head weights spread as
     the CPU tests spread them) held against the CPU: valid slots and
     classes equal (across score ties as ``tie_order`` matches them), each
     mask pixel equal but where the CPU's sigmoid lies within 1e-3 of the
     threshold (counted), scores to 1e-5 (plus a flipped slot's share);
     ``assign_level`` bit-equal on GT with argmin ties; a narrow train step
     (128-wide head, GN tie-free) with the same positive-cap draws, losses
     and gradients to the standing tolerances. ``solo_v2_R_50_FPN_1x.yaml``
     (bf16, seeded random weights, both score thresholds 0) serves 2 x 800
     x 1344 with the switch off and on (100 valid detections per image,
     bool whole-frame masks ``[2, 100, 200, 336]`` each non-empty, boxes
     their extents in the padded frame; per ``predict`` 0 / 0 ``nms_keep``
     / ``roi_patch_fwd``, 16 fused tails on) and trains 3 steps at 8 x 800 x
     1344 with 64 GT (no kernel launch; ``loss_ins``, ``loss_cate`` finite,
     the frozen stem and res2 bit-equal, every trainable parameter moved),
     with img/s, device ms, idle share and peak memory. Its gate,
     ``tools.overfit_check 600 --arch solov2`` (bbox AP50 >= 90, segm AP no
     more than 10 below the JAX tool's), runs with the others;
 16. yolov4: YOLOv4 serving and training. ``nms_keep`` bit-equal at its
     new shapes (checked early, with the later kernels): the class-agnostic
     top 1000 of 2 images (clustered boxes in 608 x 608, IoU 0.5,
     ``max_keep`` 100) and the overfit gate's evaluation, all 504 candidates
     of 8 images at 64 x 128 (``max_keep`` 8); the narrow float32 YOLOv4
     (CSP-DarkNet53 stem 16, res2 32, neck 32, head 32, 5 classes, the
     predictors' objectness and class rows x10) held against the CPU: valid
     slots and classes equal, boxes 1e-3, scores 1e-5; a narrow float32
     train step card against CPU (every BN at scale 0.5, bias +-1:
     ``kink_free``): ``box_loss``, ``conf_loss``, ``cls_loss`` 1e-4
     relative, every gradient 1e-4 of its largest, the BN bias channels
     whose gradient is zero in exact arithmetic held below 1e-4 of their
     scale's; a seeded darknet blob and manifest through ``load_pretrained``
     onto the card, every tensor bit-equal; ``yolov4_D_53_PAN_1x.yaml``
     (bf16, seeded random weights, ``YOLOV4.SCORE_THRESH_TEST`` 0) serving 2
     x 608 x 608 with the switch off and on (100 valid, finite, clipped
     detections per image, classes in [0, 80), scores in (0, 1]; per
     ``predict`` 1 / 0 ``nms_keep`` / ``roi_patch_fwd`` and 0 fused
     tails), with img/s, device ms, idle share and peak memory; then
     trained at 8 x 608 x 608 bf16 with 64 GT an image at the YAML's
     ``FREEZE_AT 2``, 2 warm-up and 3 timed steps (finite losses; the
     frozen stem and res1 bit-equal; every trainable parameter moved; every
     BN running statistic of the neck and the head moved; 0 / 0 / 0
     ``nms_keep`` / ``roi_patch_fwd`` / ``_bwd`` launches per step, 0 fused
     tails), with img/s, device ms per step, idle share and peak memory.
     Its gate, ``tools.overfit_check 600 --arch yolov4`` (bbox AP50 >= 90,
     bbox AP no more than 10 below the JAX tool's), runs with the others;
 17. relation: Relation Networks serving and training. No kernel shape is
     new (the RPN's NMS and the box pool and its backward are R50-FPN's; the
     relation head, the learned duplicate removal and ``loss_dup`` launch
     no kernel). The narrow float32 relation models
     (16 groups of key dim 64 over FC 64) held against the CPU: the YAML as
     it is (class-aware NMS), the duplicate removal with its five IoU heads
     combined by mean and by max, and ``MASK_ON`` on the removal's
     detections, each from the CPU model's proposals and duplicate-removal
     candidates, with the geometry weights off the clamp before ``log(wg)``
     (``geometry_kink_free``; valid slots and classes equal across score
     ties as ``tie_order`` matches them, boxes, scores and masks to the
     standing tolerances, the removal's scores to ``RELATION_TOL``'s 5e-5). ``relation_rcnn_R_50_FPN_1x.yaml`` (bf16, seeded random
     weights, ``SCORE_THRESH_TEST`` 0) serves 2 x 800 x 1344 as it is and
     with ``DUPLICATE_REMOVAL_ON``, the switch off and on in turns (100
     valid, finite, clipped detections per image, classes in [0, 80),
     scores in (0, 1]; per ``predict`` 2 / 1 ``nms_keep`` / ``roi_patch_fwd``
     as it is and 1 / 1 with the removal, 16 fused tails on), with img/s,
     device ms and idle share, the relation head's and the removal's device
     ms, and the peak memory of a predict at batch 2 and at batch 8. Narrow
     float32 train steps card against CPU, the switch off and on, as the
     YAML is, with the removal's five IoU heads, and with it and
     ``MASK_ON`` (``relation_train_prepare``: tie-free weights, the box
     head's geometry weights off the clamp, the classifier spread; both
     sides take the CPU's training proposals, each box moved by up to 3 px:
     ``relation_jitter``): the losses (``loss_dup`` among them) to 1e-4
     relative, the RPN head's, the classifier's and the mask head's
     gradients to 1e-4 of their largest, those of the relation box head,
     the neck and the trunk to 1e-3 and, with the removal, those to 5e-3
     and the box regressor's and the removal's to 2e-2 (its loss reaches the
     deltas through the geometry embedding of the decoded candidates). Then the
     YAML trains as it is and with the removal at 8 x 800 x 1344 bf16 with
     64 GT an image, the switch off and then on, 2
     warm-up and 3 timed steps (per step 1 / 1 / 1 ``nms_keep`` /
     ``roi_patch_fwd`` / ``roi_patch_bwd``, 16 fused tails on; losses
     finite, ``loss_dup`` with the removal; the frozen stem and res2
     bit-equal; every trainable parameter moved, the relation modules' and
     the removal's among them, but a key bias, whose gradient is zero), with
     img/s, device ms per step, idle share, peak memory and the relation
     head's and ``loss_dup``'s forward and backward device ms. Its gate,
     ``tools.overfit_check 800 --arch relation --eval_at 600 --seed S`` for
     S = 0 .. 5 (the removal on; over the six, the mean bbox AP at step 600
     no more than 10 below the JAX tool's on the same recipe and step count,
     and the mean bbox AP50 at step 800 at least 90), runs with the others;
 18. gates: waits for workflow (b), the panoptic workflow and the overfit
     gates started in phase 8, and checks them.

Each phase's seconds are printed on a line of their own; phase 14's parts
too (``dconv.narrow`` ...). A probe line then
says whether ``cv2``, ``PIL`` and ``torchvision`` import and whether ``g++``
finds ``jpeglib.h`` and links ``-ljpeg``. The last lines are the card's name
and power limit, a ``{"kernels": [...]}`` line, and ``{"ok": true, "device":
{...}}``.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np
import torch

from detectron2_tensorflow_tpu_torch import bench_cfg, kernels, train_cfg
from detectron2_tensorflow_tpu_torch.config import finalize, get_cfg
from detectron2_tensorflow_tpu_torch.convert import (
    emit_manifest,
    read_darknet_blob,
    write_darknet_weights,
)
from detectron2_tensorflow_tpu_torch.data import (
    SyntheticDataset,
    build_dataloader,
    write_proposal_file,
)
from detectron2_tensorflow_tpu_torch.engine import (
    add_proposal_slots,
    build_train_step,
    create_train_state,
    make_train_batch,
    evaluate,
    run_evaluation,
    train,
)
from detectron2_tensorflow_tpu_torch.engine.tta import precise_bn, tta_predict
from detectron2_tensorflow_tpu_torch.engine.checkpoint import all_steps, load_pretrained
from detectron2_tensorflow_tpu_torch.models import ProposalNetwork, build_model
from detectron2_tensorflow_tpu_torch.models.backbones.resnet import BLOCKS_PER_STAGE
from detectron2_tensorflow_tpu_torch.models.deform_conv import DeformConv2d
from detectron2_tensorflow_tpu_torch.models.layers import BatchNorm2d
from detectron2_tensorflow_tpu_torch.models.meta_arch.postprocess import (
    detector_postprocess,
    sem_seg_postprocess,
)
from detectron2_tensorflow_tpu_torch.models.meta_arch.rcnn import (
    SemanticSegmentor,
    panoptic_fusion,
    semantic_logits,
)
from detectron2_tensorflow_tpu_torch.models.poolers import (
    build_storage,
    hat_support,
    plan_patch,
    plan_rois,
    roi_patch_backward,
    roi_patch_backward_reference,
    roi_patch_interpolate,
    roi_patch_interpolate_reference,
    skip_tier_class,
)
from detectron2_tensorflow_tpu_torch.models.roi_heads import relation
from detectron2_tensorflow_tpu_torch.models.sampling import draw_noise
from detectron2_tensorflow_tpu_torch.models.single_stage.solov2 import SOLOv2
from detectron2_tensorflow_tpu_torch.ops import fused_residual
from detectron2_tensorflow_tpu_torch.ops.fused_residual import (
    fused_conv1x1_bn_add_relu,
    fused_conv1x1_bn_add_relu_reference,
)
from detectron2_tensorflow_tpu_torch.ops.nms import (
    PAD_BOX,
    greedy_keep,
    greedy_keep_reference,
)
from detectron2_tensorflow_tpu_torch.solver import trainable_parameters
from detectron2_tensorflow_tpu_torch.structures import Instances
from detectron2_tensorflow_tpu_torch.tools import (
    exp_roi_variants,
    profile_predict,
    profile_train,
    workflow_check,
    workflow_check_panoptic,
)
from detectron2_tensorflow_tpu_torch.tools.exp_roi_variants import (
    roi_patch_variant,
    roi_patch_variant_reference,
)

SEED = 0
NMS_SRC = "detectron2_tensorflow_tpu_torch/csrc/nms_keep.cu"
ROI_SRC = "detectron2_tensorflow_tpu_torch/csrc/roi_patch.cu"
FUSED_SRC = "detectron2_tensorflow_tpu_torch/csrc/fused_residual.cu"
ROOT = Path(__file__).resolve().parent
# Least time of a function on an H100 SXM (NVIDIA data sheet, at 700 W):
# the larger of its bytes over the HBM rate and its operations over the
# peak rate for the inputs' type (bf16 tensor cores; float32 outside them,
# as the float32 kernels must not round to TF32).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}
# About 20 float32 operations per IoU pair: two areas, the intersection
# (min, max, differences, clamps, product), the union and the division, and
# the comparison with the threshold.
NMS_OPS_PER_PAIR = 20
# ROI tolerances. float32: both sides sum the same products in another
# order, so |err| stays near 1e-6 on O(1) features; 1e-4 leaves margin.
# bfloat16: both round one float32 value once, so they differ by at most
# one bf16 ulp of the output's magnitude, 2^-7 relative to its maximum.
ROI_TOL_F32 = 1e-4
ROI_TOL_BF16_REL = 2.0 ** -7
# ROI backward: both sides sum the same float32 products (g widened exactly)
# in other orders, the kernel's cross-ROI sums in atomic order. A float32 sum
# of n terms errs by at most about n * 2^-24 of the sum of their magnitudes,
# and a plane cell sums 2S products per ROI over the ROIs that cover it
# (up to ~100 with clustered boxes): each cell is held to 1e-5 of the sum of
# the magnitudes of its terms, the same plane made from |g|.
ROI_BWD_TOL = 1e-5
# Narrow float32 train step, card against CPU (TF32 off), same weights,
# proposals and sampler noise: losses to 1e-4 relative; gradients to 1e-4 of
# each tensor's largest magnitude, elementwise and in norm. The same float32
# sums in other orders (cuDNN against oneDNN, the backward kernel's atomics)
# read 3.11e-05 at worst on an H100; tests/test_torch_train.py holds the CPU
# against the JAX package to the same 1e-4.
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 1e-4
# Fused bottleneck tail, kernel against plain version on the card: both sum
# the same float32 products in other orders and round once. float32: 1e-5 of
# the largest value. bf16: one bf16 ulp of each value, plus that float32
# tolerance where the sum cancels near zero (a float32 difference there is
# larger than the ulp of the tiny result): within_tolerance.
FUSED_TOL_F32 = 1e-5
# The bottleneck tails of R50 at 800 x 1344: (stage, K, N, H, W).
R50_TAILS = (("res2", 64, 256, 200, 336), ("res3", 128, 512, 100, 168),
             ("res4", 256, 1024, 50, 84), ("res5", 512, 2048, 25, 42))
FUSED_TAILS = 16  # R50's bottleneck blocks, each with one fused tail
# nms_keep launches: per predict the RPN's five levels in one, the box
# head's class-aware NMS in another; per train step the RPN's alone.
NMS_PER_PREDICT = 2
NMS_PER_STEP = 1


def tpu_kernel(pattern: str, line: int) -> str:
    """Repo-relative ``file:line`` of the TPU kernel in the one file of the
    checkout matching ``pattern`` (a glob from the repo root, for example
    ``*/ops/pallas/nms_keep.py`` or ``tools/exp_roi_variants.py``)."""
    (path,) = ROOT.glob(pattern)
    return f"{path.relative_to(ROOT).as_posix()}:{line}"


def bound(nbytes: float, ops: float, dtype: torch.dtype):
    """``(bound_ms, bound_by)``: the least time for ``nbytes`` of device
    memory traffic and ``ops`` operations on ``dtype`` inputs."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


@contextlib.contextmanager
def fused_switch(on: bool):
    """``D2TPU_ENABLE_FUSED_EPILOGUE`` set to 1 (or unset) for the block; the
    port reads it when a model is built."""
    old = os.environ.get(fused_residual.ENV_SWITCH)
    if on:
        os.environ[fused_residual.ENV_SWITCH] = "1"
    else:
        os.environ.pop(fused_residual.ENV_SWITCH, None)
    try:
        yield
    finally:
        if old is None:
            os.environ.pop(fused_residual.ENV_SWITCH, None)
        else:
            os.environ[fused_residual.ENV_SWITCH] = old


def bottleneck_tails(cfg) -> int:
    """Fused tails per trunk forward with the switch on: one per bottleneck
    block of a FrozenBN ResNet (16 on R50, 50 on X152), none otherwise (a
    DarkNet53 block ends in a 3x3 conv, its norm and mish)."""
    r = cfg.MODEL.RESNETS
    if cfg.MODEL.BACKBONE.NAME != "ResNet" or r.NORM != "FrozenBN" or r.DEPTH < 50:
        return 0
    return sum(BLOCKS_PER_STAGE[r.DEPTH])


def fused_tails(model) -> int:
    """Convs of ``model`` built to take the fused tail."""
    return sum(bool(getattr(m, "fuse_residual", False)) for m in model.modules())


COUNTERS = {"nms_keep": greedy_keep, "roi_patch_fwd": roi_patch_interpolate,
            "roi_patch_bwd": roi_patch_backward, "fused_residual": fused_conv1x1_bn_add_relu,
            "roi_patch_variants": roi_patch_variant}


def zero_launches() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0
    fused_conv1x1_bn_add_relu.launches_by_path.update(
        dict.fromkeys(fused_conv1x1_bn_add_relu.launches_by_path, 0))


def read_launches() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def log(msg: str) -> None:
    print(msg, flush=True)


START = time.perf_counter()


@contextlib.contextmanager
def phase_seconds(name: str):
    """Log the block's wall seconds on a line of its own."""
    t0 = time.perf_counter()
    yield
    log(f"seconds    {name} {time.perf_counter() - t0:.1f}")


# Cycles per second of torch.cuda._sleep's spin loop: the H100's top SM clock
# (1.98 GHz). A slower clock only makes the hold below longer.
SPIN_CYCLES_PER_S = 1.98e9


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device milliseconds of ``fn()`` over ``reps`` calls, after warm-up.

    A spin kernel holds the stream while the host enqueues the calls, so
    the events time the calls' device work back to back, not the host's
    launch cost between them (which exceeds a small kernel's run time).
    If the hold ended before the last call was enqueued (a call that
    synchronizes, as a plain version may), it is retried longer, and after
    three tries the time is taken as it comes, host gaps included.
    """
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    hold = 2 * (time.perf_counter() - t0) * reps + 1e-3  # an upper bound of the enqueue time
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for attempt in range(4):
        if attempt < 3:
            torch.cuda._sleep(int(hold * SPIN_CYCLES_PER_S))
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        late = start.query()  # the hold was over before the calls were all enqueued
        torch.cuda.synchronize()
        if not late:
            break
        hold *= 4
    return start.elapsed_time(end) / reps


# -- inputs -----------------------------------------------------------------

def card_normal(rng, shape, dev, dtype=torch.float32):
    """Standard normals of ``shape`` in ``dtype``, drawn on the card by a torch
    generator that ``rng`` seeds: numpy's host draw of the larger planes and
    cotangents (up to 8e8 values) took most of a minute."""
    gen = torch.Generator(device=dev).manual_seed(int(rng.integers(2**31)))
    return torch.randn(shape, generator=gen, device=dev).to(dtype)


def clustered_boxes(rng, b, n, h=800.0, w=1333.0, objects=150):
    """Score-sorted candidate boxes as a detector emits them: jittered copies
    of a few objects (so NMS really suppresses), clipped to the image."""
    ctr = rng.uniform([0, 0], [w, h], (b, objects, 2))
    size = np.exp(rng.uniform(np.log(12), np.log(600), (b, objects, 1)))
    ar = np.exp(rng.uniform(-0.7, 0.7, (b, objects, 1)))
    wh = np.concatenate([size * ar, size / ar], -1)
    pick = rng.integers(0, objects, (b, n))
    c = np.take_along_axis(ctr, pick[..., None], 1) + rng.normal(0, 6, (b, n, 2))
    s = np.take_along_axis(wh, pick[..., None], 1) * rng.uniform(0.85, 1.15, (b, n, 2))
    boxes = np.concatenate([c - s / 2, c + s / 2], -1)
    boxes = np.clip(boxes, 0, [w, h, w, h]).astype(np.float32)
    valid = rng.uniform(0, 1, (b, n)) > 0.05
    return boxes, valid


def class_offset(boxes, classes):
    """``ops/nms.class_aware_nms``'s shift, in its float32 order."""
    finite = np.where(np.isfinite(boxes), boxes, 0).max(axis=(1, 2)).astype(np.float32)
    max_coord = finite + np.float32(1.0)
    off = classes.astype(np.float32) * max_coord[:, None]
    return (boxes + off[..., None]).astype(np.float32)


# -- phase 3: kernels -------------------------------------------------------

def stacked_levels(rng, images, n, last=819):
    """The RPN's stacked candidates: per image four levels of ``n`` boxes and
    p6's ``last`` (13 x 21 x 3 at 800x1344) padded to ``n`` with invalid rows
    holding the far-away box, as ``ops.nms.nms_fixed_levels`` pads them."""
    boxes, valid = clustered_boxes(rng, images * 5, n)
    p6 = np.arange(images) * 5 + 4
    boxes[p6, last:] = PAD_BOX
    valid[p6, last:] = False
    return boxes, valid


def nms_pairs(valid, keep, max_keep):
    """IoU pairs of valid boxes the greedy needs per batch row: all of them,
    or with ``max_keep`` those up to the row of the last survivor kept."""
    total = 0.0
    for v, k in zip(valid, keep):
        rows = np.flatnonzero(k)
        end = len(v) if max_keep is None or len(rows) < max_keep else rows[max_keep - 1] + 1
        m = float(v[:end].sum())
        total += m * (m - 1) / 2
    return total


def check_nms(rng, dev):
    """``nms_keep`` bit-equal to its plain version at the main path's shapes:
    serving's RPN (2 images x 5 levels of 1000, unpadded as in PR 5's check
    and stacked with p6 padded), the box head (class-offset candidates,
    ``max_keep`` 100) and training's RPN (8 images x 5 levels of 2000,
    ``max_keep`` 1000); each timed beside its bound and the plain version."""
    cases = []
    b, v = clustered_boxes(rng, 10, 1000)  # RPN: 2 images x 5 levels
    cases.append(("rpn 2x5 levels N=1000 iou=0.7", b, v, 0.7, None))
    b, v = stacked_levels(rng, 2, 1000)
    cases.append(("rpn stacked 2x(4x1000 + 819 padded) iou=0.7", b, v, 0.7, None))
    b, v = clustered_boxes(rng, 2, 2000)  # box head: class-offset candidates
    cls = rng.integers(0, 80, (2, 2000))
    cases.append(("box head B=2 N=2000 iou=0.5 max_keep=100", class_offset(b, cls), v, 0.5, 100))
    b, v = stacked_levels(rng, 8, 2000)
    cases.append(("train rpn stacked 8x(4x2000 + 819 padded) iou=0.7 max_keep=1000",
                  b, v, 0.7, 1000))
    return [nms_case(dev, *case) for case in cases]


def nms_case(dev, name, boxes, valid, thr, mk, plain=greedy_keep_reference, reps=50,
             tag="nms_keep  "):
    """One ``nms_keep`` case: bit-equal to ``plain``, both timed, the bound."""
    tb = torch.from_numpy(boxes).to(dev)
    tv = torch.from_numpy(valid).to(dev)
    got = greedy_keep(tb, tv, thr, max_keep=mk)
    want = plain(tb, tv, thr, mk)
    torch.cuda.synchronize()
    got, want = got.cpu().numpy(), want.cpu().numpy()
    if not np.array_equal(got, want):
        raise AssertionError(f"nms_keep {name}: keep mask differs from the plain version")
    err = int(np.abs(got.astype(np.int8) - want.astype(np.int8)).max())
    ms = cuda_ms(lambda: greedy_keep(tb, tv, thr, max_keep=mk), reps=reps)
    plain_ms = cuda_ms(lambda: plain(tb, tv, thr, mk), reps=3, warmup=1)
    # Boxes and valid flags in, the keep mask out; the IoU of every pair
    # of valid boxes the greedy reaches.
    bound_ms, bound_by = bound(boxes.nbytes + 2 * valid.size,
                               NMS_OPS_PER_PAIR * nms_pairs(valid, want, mk), torch.float32)
    log(f"{tag} {name}: kept {int(got.sum())}, keep mask equal, kernel {ms:.4f} ms, "
        f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"case": name, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def roi_inputs(rng, dev, dtype, n, s, valid_frac=0.9, objects=None, b=2, ratio=0,
               size=(800, 1344)):
    """A real storage plane (p2-p5 of ``b`` images of ``size``, 800x1344 by
    default, C=256, with the extent-tier aliases, the patch of the models'
    1333-px images) and a plan for ``n`` random boxes per image spread over
    the image, jittered copies of ``objects`` objects (default ``n // 4``),
    at sampling ratio ``ratio`` (0: D2's adaptive rule)."""
    c, (h, w) = 256, size
    feats = [card_normal(rng, (b, h // st, w // st, c), dev, dtype) for st in (4, 8, 16, 32)]
    storage, meta = build_storage(feats, [4, 8, 16, 32], plan_patch(1333, 32))
    boxes, _ = clustered_boxes(rng, b, n, h=h, w=w - 11, objects=objects or max(n // 4, 8))
    valid = torch.from_numpy(rng.uniform(0, 1, (b, n)) < valid_frac).to(dev)
    starts, wy, wx = plan_rois(meta, torch.from_numpy(boxes).to(dev), s, ratio, 224, 4,
                               valid=valid)
    return storage.contiguous(), starts.contiguous(), wy.contiguous(), wx.contiguous(), valid


def covered_cells(starts, wy, wx, htot: int, wm: int) -> int:
    """Plane cells ``(b, row, col)`` in the hat support of some slot that is
    not skipped: what a ROI kernel must read (or, backward, add into)."""
    b, n, _, p = wy.shape
    ar = torch.arange(p, device=starts.device)
    sy, sx = hat_support(wy), hat_support(wx)
    in_y = (ar >= sy[..., :1]) & (ar < sy[..., 1:])  # [B, N, P]
    in_x = (ar >= sx[..., :1]) & (ar < sx[..., 1:])
    rows = starts[..., 0, None].long() + ar
    cols = starts[..., 1, None].long() + ar
    in_y &= (rows >= 0) & (rows < htot)
    in_x &= (cols >= 0) & (cols < wm)
    keep = ((starts[..., 2] < skip_tier_class(p))[..., None, None]
            & in_y[..., :, None] & in_x[..., None, :])
    bidx = torch.arange(b, device=starts.device)[:, None, None, None].expand(b, n, p, p)
    mask = torch.zeros((b, htot, wm), dtype=torch.bool, device=starts.device)
    mask[bidx[keep], rows[..., :, None].expand(b, n, p, p)[keep],
         cols[..., None, :].expand(b, n, p, p)[keep]] = True
    return int(mask.sum())


def support_spans(starts, wy, wx):
    """Row and column spans ``(hy, hx)`` of the hat support of each slot that
    is not skipped (``[active]`` int64 each)."""
    active = starts[..., 2] < skip_tier_class(wy.shape[-1])
    sy, sx = hat_support(wy)[active], hat_support(wx)[active]
    return sy[:, 1] - sy[:, 0], sx[:, 1] - sx[:, 0]


def support_share(starts, wy, wx) -> float:
    """Mean share of the P x P patch inside the hat support, over the slots
    that are not skipped."""
    hy, hx = support_spans(starts, wy, wx)
    return float((hy * hx).double().mean()) / wy.shape[-1] ** 2


def roi_bound(storage_shape, dtype, starts, wy, wx, backward: bool):
    """Bound of one ROI patch pass: the plane cells in the union of the hat
    supports read (forward, in the plane's dtype) or read and written
    (backward, into a float32 plane given as ``init``), the plan, the
    ``[B, N, S, S, C]`` result (or cotangent) once; the two contractions
    over each slot's support (forward ``S*hy*hx + S*S*hx`` products per
    channel, backward ``S*S*hy + S*hy*hx``), at the rate of the plane's (or
    cotangent's) dtype."""
    b, htot, wm, c = storage_shape
    n, s, p = wy.shape[1:]
    esize = torch.empty((), dtype=dtype).element_size()
    cells = covered_cells(starts, wy, wx, htot, wm) * c
    plane_bytes = cells * (8 if backward else esize)
    plan_bytes = b * n * (3 * 4 + 2 * s * p * 4)
    io_bytes = b * n * s * s * c * esize
    hy, hx = (t.double() for t in support_spans(starts, wy, wx))
    per_slot = s * s * hy + s * hy * hx if backward else s * hy * hx + s * s * hx
    ops = 2 * c * float(per_slot.sum())
    return bound(plane_bytes + plan_bytes + io_bytes, ops, dtype)


def check_roi(rng, dev):
    results = []
    for label, n, s in (("box N=1000 S=7", 1000, 7), ("mask N=100 S=14", 100, 14)):
        for dtype in (torch.bfloat16, torch.float32):
            results.append(roi_fwd_case(label, *roi_inputs(rng, dev, dtype, n, s)))
    return results


def roi_fwd_case(label, storage, starts, wy, wx, valid, tag="roi_patch "):
    """One ``roi_patch_fwd`` case: skipped slots exact zeros, within the ROI
    tolerance of the plain version, both timed, the bound."""
    dtype = storage.dtype
    got = roi_patch_interpolate(storage, starts, wy, wx)
    want = roi_patch_interpolate_reference(storage, starts, wy, wx)
    torch.cuda.synchronize()
    skipped = ~valid
    if bool((got[skipped] != 0).any()):
        raise AssertionError(f"roi_patch {label}: skip-sentinel slots are not exact zeros")
    err = float((got.float() - want.float()).abs().max())
    scale = float(want.float().abs().max())
    tol = ROI_TOL_F32 if dtype == torch.float32 else ROI_TOL_BF16_REL * max(1.0, scale)
    if not err <= tol:
        raise AssertionError(f"roi_patch {label} {dtype}: max |err| {err} > {tol}")
    ms = cuda_ms(lambda: roi_patch_interpolate(storage, starts, wy, wx), reps=20)
    plain_ms = cuda_ms(lambda: roi_patch_interpolate_reference(storage, starts, wy, wx),
                       reps=3, warmup=1)
    bound_ms, bound_by = roi_bound(storage.shape, dtype, starts, wy, wx, backward=False)
    name = f"{label} {str(dtype).replace('torch.', '')}"
    log(f"{tag} {name}: max|err| {err:.3g} (tol {tol:.3g}, max|out| {scale:.3g}), "
        f"skipped {int(skipped.sum())}, support {support_share(starts, wy, wx):.1%} of "
        f"the patch, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"case": name, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def spread_starts(starts, p: int, htot: int, wm: int, seed: int):
    """``starts`` with every slot's origin moved to a uniform random row and
    8-aligned column of the plane: the same supports (the same work), with
    little overlap between ROIs."""
    gen = torch.Generator(device=starts.device).manual_seed(seed)
    b, n = starts.shape[:2]
    spread = starts.clone()
    spread[..., 0] = torch.randint(0, htot - p + 1, (b, n), generator=gen, device=starts.device)
    spread[..., 1] = torch.randint(0, (wm - p) // 8 + 1, (b, n), generator=gen,
                                   device=starts.device) * 8
    return spread


def check_roi_bwd(rng, dev):
    """``roi_patch_bwd`` against ``roi_patch_backward_reference`` at the train
    step's box and mask sets, clustered heavily overlapping boxes, 10% of the
    slots skipped, bf16 and float32 cotangents, and box chained into mask
    through ``init``. The atomics' contention: the bf16 sets timed again
    with their ROIs spread over the plane (the same supports)."""
    results = []
    planes = {}
    for label, n, s in (("box B=2 N=512 S=7", 512, 7), ("mask B=2 N=128 S=14", 128, 14)):
        storage, starts, wy, wx, valid = roi_inputs(rng, dev, torch.bfloat16, n, s, objects=12)
        shape = tuple(storage.shape)
        for dtype in (torch.bfloat16, torch.float32):
            g = card_normal(rng, (2, n, s, s, 256), dev, dtype)
            results.append(roi_bwd_case(label, g, starts, wy, wx, valid, shape))
            only_skipped = torch.where((~valid)[..., None, None, None], g, torch.zeros_like(g))
            if bool(roi_patch_backward(only_skipped, starts, wy, wx, shape).any()):
                raise AssertionError(f"roi_patch_bwd {label}: skipped slots added to the plane")
            planes[label, dtype] = (g, starts, wy, wx, shape)
        g = planes[label, torch.bfloat16][0]
        spread = spread_starts(starts, wy.shape[-1], shape[1], shape[2], SEED + n)
        acc = torch.zeros(shape, device=dev)
        spread_ms = cuda_ms(lambda: roi_patch_backward(g, spread, wy, wx, shape, init=acc), reps=20)
        ms = results[-2]["ms"]
        log(f"roi_bwd    {label} bf16 contention: clustered on 12 objects {ms:.4f} ms, the same "
            f"ROIs spread over the plane {spread_ms:.4f} ms, clustered / spread {ms / spread_ms:.2f}")
    # Chained: the box set's gradient into a fresh plane, then the mask set's
    # added into it, in the order the fused pool's backward takes them.
    gb, sb, wyb, wxb, shape = planes["box B=2 N=512 S=7", torch.bfloat16]
    gm, sm, wym, wxm, _ = planes["mask B=2 N=128 S=14", torch.bfloat16]
    got = roi_patch_backward(gm, sm, wym, wxm, shape, init=roi_patch_backward(gb, sb, wyb, wxb, shape))
    want = roi_patch_backward_reference(gm, sm, wym, wxm, shape,
                                        init=roi_patch_backward_reference(gb, sb, wyb, wxb, shape))
    terms = roi_patch_backward_reference(gm.abs(), sm, wym, wxm, shape,
                                         init=roi_patch_backward_reference(gb.abs(), sb, wyb, wxb, shape))
    err = float((got - want).abs().max())
    if not float(((got - want).abs() - ROI_BWD_TOL * terms).max()) <= 0:
        raise AssertionError("roi_patch_bwd chained box -> mask: error exceeds the bound")
    log(f"roi_bwd    chained box -> mask through init (bf16): max|err| {err:.3g}")
    results.append({"case": "chained", "err": err})
    return results


def roi_bwd_case(label, g, starts, wy, wx, valid, shape, tag="roi_bwd   "):
    """One ``roi_patch_bwd`` case: each plane cell within ``ROI_BWD_TOL`` of
    the sum of its terms' magnitudes of the plain version, both timed
    (accumulating into a plane through ``init``), the bound."""
    got = roi_patch_backward(g, starts, wy, wx, shape)
    want = roi_patch_backward_reference(g, starts, wy, wx, shape)
    terms = roi_patch_backward_reference(g.abs(), starts, wy, wx, shape)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    excess = float(((got - want).abs() - ROI_BWD_TOL * terms).max())
    name = f"{label} {str(g.dtype).replace('torch.', '')}"
    if not excess <= 0:
        raise AssertionError(f"roi_patch_bwd {name}: error exceeds {ROI_BWD_TOL} x sum|terms| "
                             f"by {excess}")
    stats = (f"max|err| {err:.3g} (max|want| {float(want.abs().max()):.3g}, max sum|terms| "
             f"{float(terms.max()):.3g})")
    del got, want, terms
    acc, acc_ref = torch.zeros(shape, device=g.device), torch.zeros(shape, device=g.device)
    ms = cuda_ms(lambda: roi_patch_backward(g, starts, wy, wx, shape, init=acc), reps=20)
    plain_ms = cuda_ms(lambda: roi_patch_backward_reference(g, starts, wy, wx, shape,
                                                            init=acc_ref), reps=3, warmup=1)
    bound_ms, bound_by = roi_bound(shape, g.dtype, starts, wy, wx, backward=True)
    log(f"{tag} {name}: {stats}, skipped {int((~valid).sum())}, support "
        f"{support_share(starts, wy, wx):.1%} of the patch, kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"case": name, "err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def tail_inputs(rng, dev, dtype, b, h, w, k, n):
    """A bottleneck tail's operands in the port's layouts: ``x`` ``[B, K, H,
    W]`` and ``shortcut`` channels_last, the weight ``[N, K, 1, 1]``, the
    folded FrozenBN affine float32 ``[N]``."""
    x = torch.relu(card_normal(rng, (b, h, w, k), dev)).to(dtype)
    weight = torch.from_numpy((rng.standard_normal((n, k, 1, 1)) / np.sqrt(k)).astype(np.float32))
    scale = torch.from_numpy(rng.uniform(0.1, 0.5, n).astype(np.float32))
    shift = torch.from_numpy(rng.normal(0, 0.1, n).astype(np.float32))
    sc = card_normal(rng, (b, h, w, n), dev, dtype)
    return (x.permute(0, 3, 1, 2), weight.to(dev, dtype), scale.to(dev), shift.to(dev),
            sc.permute(0, 3, 1, 2))


def tail_bytes(m: int, k: int, n: int, esize: int) -> int:
    """Bytes a tail must move: x, the weight and the shortcut in, the output
    out, each once, and scale and shift (float32)."""
    return (m * k + n * k + 2 * m * n) * esize + 2 * n * 4


def within_tolerance(got: torch.Tensor, want: torch.Tensor) -> bool:
    """bf16 ``got`` within one ulp of each value plus ``FUSED_TOL_F32`` of the largest."""
    got, want = got.float(), want.float()
    mag = torch.maximum(got.abs(), want.abs()).clamp_min(torch.finfo(torch.float32).tiny)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return bool(((got - want).abs() <= ulp + FUSED_TOL_F32 * float(want.abs().max())).all())


def unfused_tail(x, weight, scale, shift, sc):
    """The port's unfused tail (``Conv2d`` with FrozenBN, then add and ReLU):
    cuDNN's 1x1 conv, the affine in the activation dtype, the add, the ReLU."""
    view = (1, -1, 1, 1)
    y = torch.nn.functional.conv2d(x, weight)
    y = y * scale.to(y.dtype).view(view) + shift.to(y.dtype).view(view)
    return torch.relu(y + sc)


def check_fused(rng, dev):
    """``fused_residual`` against its plain version at R50's four tail shapes
    (800 x 1344, bf16) at batch 2 and 8, where each must take the Hopper
    (``wgmma``) path, at a ragged shape (M = 63 rows, K = 8, N = 32) in bf16
    and float32, and at res4's shape in float32; timed beside the plain
    version, the bound and the port's unfused tail. Then the host cost of a
    call on each bf16 path (the Hopper path encodes four TMA maps a call)."""
    cases = [(f"{st} b{b} M={b * h * w} K={k} N={n}", torch.bfloat16, (b, h, w, k, n))
             for b in (2, 8) for st, k, n, h, w in R50_TAILS]
    cases += [("ragged M=63 K=8 N=32", torch.bfloat16, (1, 7, 9, 8, 32)),
              ("ragged M=63 K=8 N=32", torch.float32, (1, 7, 9, 8, 32)),
              ("res4 M=8400 K=256 N=1024", torch.float32, (2, 50, 84, 256, 1024))]
    results = [fused_case(rng, dev, label, dtype, dims,
                          wgmma=label.startswith("res") and dtype == torch.bfloat16)
               for label, dtype, dims in cases]
    log(f"fused_res  host cost per call at res4 b2 (host clock, 200 calls): "
        f"{host_cost_us(rng, dev)}")
    return results


def fused_case(rng, dev, label, dtype, dims, wgmma: bool, tag="fused_res "):
    """One ``fused_residual`` case on ``tail_inputs`` of ``dims`` (B, H, W,
    K, N): on the ``wgmma`` path where asked, a channels_last output within
    tolerance of the plain version, timed beside it, the unfused tail and
    the bound."""
    b, h, w, k, n = dims
    args = tail_inputs(rng, dev, dtype, b, h, w, k, n)
    before = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"]
    got = fused_conv1x1_bn_add_relu(*args)
    if wgmma and fused_conv1x1_bn_add_relu.launches_by_path["wgmma"] != before + 1:
        raise AssertionError(f"fused_residual {label}: did not take the wgmma path")
    want = fused_conv1x1_bn_add_relu_reference(*args)
    torch.cuda.synchronize()
    if got.shape != (b, n, h, w) or not got.is_contiguous(memory_format=torch.channels_last):
        raise AssertionError(f"fused_residual {label}: output {tuple(got.shape)} not "
                             "channels_last [B, N, H, W]")
    gotf, wantf = got.float(), want.float()
    err = (gotf - wantf).abs()
    if dtype == torch.float32:
        ok = float(err.max()) <= FUSED_TOL_F32 * float(wantf.abs().max())
    else:
        ok = within_tolerance(got, want)
    name = f"{label} {str(dtype).replace('torch.', '')}"
    if not ok:
        raise AssertionError(f"fused_residual {name}: max |err| {float(err.max())} beyond "
                             "the tolerance")
    ms = cuda_ms(lambda: fused_conv1x1_bn_add_relu(*args), reps=20)
    plain_ms = cuda_ms(lambda: fused_conv1x1_bn_add_relu_reference(*args), reps=3, warmup=1)
    library_ms = cuda_ms(lambda: unfused_tail(*args), reps=20)
    m, esize = b * h * w, got.element_size()
    bound_ms, bound_by = bound(tail_bytes(m, k, n, esize), 2.0 * m * n * k, dtype)
    log(f"{tag} {name}: max|err| {float(err.max()):.3g} (max|out| "
        f"{float(wantf.abs().max()):.3g}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, "
        f"unfused tail {library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
        f"{bound_ms / ms:.0%} of bound")
    return {"case": name, "err": float(err.max()), "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def host_cost_us(rng, dev) -> str:
    """Host microseconds per wrapper call at res4's batch-2 shape on the
    ``wgmma`` path and on the ``mma`` path (x at a 2-byte storage offset):
    the difference is mostly the four TMA maps the Hopper path encodes."""
    _, k, n, h, w = R50_TAILS[2]
    args = tail_inputs(rng, dev, torch.bfloat16, 2, h, w, k, n)
    buf = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16, device=dev)
    shifted = buf[1:].view(2, h, w, k).permute(0, 3, 1, 2)
    shifted.copy_(args[0])
    per_path = {}
    for path, xs in (("wgmma", args[0]), ("mma", shifted)):
        before = fused_conv1x1_bn_add_relu.launches_by_path[path]
        for _ in range(20):
            fused_conv1x1_bn_add_relu(xs, *args[1:])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fused_conv1x1_bn_add_relu(xs, *args[1:])
        per_path[path] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
        if fused_conv1x1_bn_add_relu.launches_by_path[path] != before + 220:
            raise AssertionError(f"host cost: the {path} case took another path")
    return (f"wgmma {per_path['wgmma']:.1f} us, mma {per_path['mma']:.1f} us, difference x "
            f"{FUSED_TAILS} tails {(per_path['wgmma'] - per_path['mma']) * FUSED_TAILS / 1e3:.3f} "
            "ms per predict")


def check_variants(dev):
    """The ROI forward's seven ablations at the ROI tool's shapes with 2
    images (its seeded inputs), each against its plain version: the ones
    that only move values equal, the others within the ROI tolerances;
    ``full`` bit-equal to the production kernel ``roi_patch_interpolate``."""
    plane, starts, wy, wx = exp_roi_variants.make_inputs(
        2, dev, torch.Generator(device=dev).manual_seed(SEED))
    errs = {}
    for variant in exp_roi_variants.VARIANTS:
        got = roi_patch_variant(plane, starts, wy, wx, variant)
        want = roi_patch_variant_reference(plane, starts, wy, wx, variant)
        torch.cuda.synchronize()
        errs[variant] = float((got.float() - want.float()).abs().max())
        tol = 0.0 if variant in ("nodma", "onedma", "nodot") else (
            ROI_TOL_BF16_REL * max(1.0, float(want.float().abs().max())))
        if not errs[variant] <= tol:
            raise AssertionError(f"roi variant {variant}: max |err| {errs[variant]} > {tol}")
        if variant == "full" and not torch.equal(got, roi_patch_interpolate(plane, starts, wy, wx)):
            raise AssertionError("roi variant full differs from roi_patch_interpolate")
    plain_ms = cuda_ms(lambda: roi_patch_variant_reference(plane, starts, wy, wx, "full"),
                       reps=3, warmup=1)
    bound_ms, bound_by = roi_bound(plane.shape, plane.dtype, starts, wy, wx, backward=False)
    log("variants   2 images x 1000 ROIs, P=32 C=256 S=14 bf16, max|err| against plain: "
        + ", ".join(f"{v} {e:.3g}" for v, e in errs.items())
        + f"; full bit-equal to roi_patch_interpolate; plain full {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by})")
    return {"err": max(errs.values()), "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def run_variants_tool():
    """The variants tool's entry point at 2 images (the same seeded inputs
    as ``check_variants``), launch counts read around it."""
    zero_launches()
    times = exp_roi_variants.main(["2"])
    launches = read_launches()
    if launches["roi_patch_variants"] == 0:
        raise AssertionError("the variants tool never launched roi_patch_variants")
    return times, launches["roi_patch_variants"]


# -- phase 4: model ---------------------------------------------------------

NARROW = {"STEM_OUT_CHANNELS": 16, "RES2_OUT_CHANNELS": 32, "WIDTH_PER_GROUP": 8}


def narrow_cfg():
    cfg = bench_cfg()
    for k, v in NARROW.items():
        cfg.MODEL.RESNETS[k] = v
    cfg.MODEL.NECK.OUT_CHANNELS = 32
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 32
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.DTYPE = "float32"
    return cfg


def check_small_against_cpu(rng, dev, fused: bool, cfg=None, label="model     ",
                            prepare=None, same_proposals=False, tol=None):
    """Narrow float32 model (``narrow_cfg()`` unless ``cfg``) on a 2 x 128 x
    160 input: the card's output (kernels) against the CPU's (plain
    versions), same weights (``prepare(model)`` adjusts the CPU model's
    first), with the fused tail switched off or on for both. A
    ``LOAD_PROPOSALS`` model reads proposals around random boxes
    (``engine.add_proposal_slots``); with ``same_proposals`` the card's
    model serves from the CPU model's RPN proposals (``given_proposals``)
    and, with a duplicate removal, from its candidates (``cpu_candidates``:
    the removal's rank embedding follows the candidates' class-score order,
    and at random weights hundreds of class scores sit within rounding of
    each other, so two that trade places on the card trade their keep
    scores, by up to 0.11 over 30 inputs on an H100 80GB HBM3 at 700 W).
    ``tol``: :func:`hold_detections`' tolerances (``SMALL_TOL``)."""
    cfg = cfg or narrow_cfg()
    with fused_switch(fused):
        cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
        if prepare is not None:
            prepare(cpu_model)
        gpu_model = build_model(cfg, device=dev, state_dict=cpu_model.state_dict())
    if fused_tails(gpu_model) != (FUSED_TAILS if fused else 0):
        raise AssertionError(f"narrow model built with {fused_tails(gpu_model)} fused tails")
    image = rng.uniform(0, 255, (2, 128, 160, 3)).astype(np.float32)
    sizes = np.array([[128, 160], [112, 150]], np.int32)
    batch = {"image": torch.from_numpy(image), "image_size": torch.from_numpy(sizes)}
    if cfg.MODEL.LOAD_PROPOSALS:
        batch.update(small_proposals(cfg, sizes))
    with cpu_candidates(same_proposals, dev) as replay:
        want = cpu_model.predict(batch)
    proposals = None
    if same_proposals:
        with torch.inference_mode():
            feats = cpu_model.features(batch["image"])
            rpn = cpu_model.proposal_generator
            found = rpn.proposals(*rpn.rpn_head([feats[f] for f in rpn.in_features]),
                                  batch["image_size"])
        proposals = Instances(**{k: v.to(dev) for k, v in found.get_fields().items()})
    with given_proposals(gpu_model, proposals), replay():
        got = gpu_model.predict({k: v.to(dev) for k, v in batch.items()})
    got = {k: v.cpu() for k, v in got.get_fields().items()}
    if not torch.equal(got["is_valid"], want.is_valid):
        raise AssertionError("small input: valid slots differ between the card and the CPU")
    sem = check_sem_seg_small(cpu_model, batch, got, want.get_fields()) if "sem_seg" in got else ""
    if isinstance(cpu_model, SemanticSegmentor):
        log(f"{label} small f32 input, fused tail {'on' if fused else 'off'}, card vs CPU{sem}")
        return
    errs, swapped = hold_detections(got, want.get_fields(), tol)
    if "sem_seg" in got:
        sem += check_fusion_small(cfg, dev, want)
    log(f"{label} small f32 input, fused tail {'on' if fused else 'off'}, card vs CPU: "
        f"valid={int(want.is_valid.sum())} slots equal, classes equal, {swapped} slots "
        f"matched across a score tie, max|err| "
        + ", ".join(f"{k} {v:.3g}" for k, v in errs.items()) + sem)


@contextlib.contextmanager
def cpu_candidates(on: bool, dev):
    """Record the duplicate-removal candidates that the models' calls in the
    block build (``relation.build_duplicate_removal_candidates``); yields a
    context in which the same calls get those candidates, on ``dev``,
    instead. ``on`` False: neither."""
    built = []
    if not on:
        yield contextlib.nullcontext
        return
    real = relation.build_duplicate_removal_candidates

    def record(*args, **kwargs):
        built.append(real(*args, **kwargs))
        return built[-1]

    @contextlib.contextmanager
    def replay():
        calls = iter(built)
        relation.build_duplicate_removal_candidates = lambda *a, **k: tuple(
            t.to(dev) for t in next(calls))
        try:
            yield
        finally:
            relation.build_duplicate_removal_candidates = real

    relation.build_duplicate_removal_candidates = record
    try:
        yield replay
    finally:
        relation.build_duplicate_removal_candidates = real


def hold_detections(got, want, tolerances=None):
    """The card's detections ``got`` against the CPU's ``want`` (field dicts on
    the CPU): classes equal, each slot (or its partner across a score tie,
    :func:`tie_order`) within ``tolerances`` (``SMALL_TOL``), keypoints within
    ``KEYPOINT_TOL``. Returns the largest errors and the swapped slots."""
    tolerances = tolerances or SMALL_TOL
    order = tie_order(got, want, tolerances)
    classes = torch.gather(got["pred_classes"], 1, order)
    if not torch.equal(classes, want["pred_classes"]):
        i, j = (int(v) for v in torch.nonzero(classes != want["pred_classes"])[0])
        raise AssertionError(f"small input: classes differ between the card and the CPU, first "
                             f"at image {i} slot {j}: {int(classes[i, j])} (score "
                             f"{float(got['scores'][i, order[i, j]]):.9g}) against "
                             f"{int(want['pred_classes'][i, j])} "
                             f"({float(want['scores'][i, j]):.9g})")
    errs = {}
    for k, tol in tolerances.items():
        if k not in got:
            continue
        slots = order.reshape(order.shape + (1,) * (got[k].dim() - 2)).expand_as(got[k])
        errs[k] = float((torch.gather(got[k], 1, slots) - want[k]).abs().max())
        if not errs[k] <= tol:
            raise AssertionError(f"small input: {k} max |err| {errs[k]} > {tol}")
    if "pred_keypoints" in got:  # x, y and score held apart
        slots = order[..., None, None].expand_as(got["pred_keypoints"])
        diff = (torch.gather(got["pred_keypoints"], 1, slots) - want["pred_keypoints"]).abs()
        errs["keypoints xy"] = float(diff[..., :2].max())
        errs["keypoint scores"] = float(diff[..., 2].max())
        for k, tol in zip(("keypoints xy", "keypoint scores"), KEYPOINT_TOL):
            if not errs[k] <= tol:
                raise AssertionError(f"small input: {k} max |err| {errs[k]} > {tol}")
    return errs, int((order != torch.arange(order.shape[1])).sum())


def check_sem_seg_small(cpu_model, batch, got, want) -> str:
    """A narrow model's ``sem_seg``, card against CPU: equal wherever the CPU's
    two largest logits lie more than SEM_TIE apart; a SemanticSegmentor's
    ``sem_seg_logits`` within SEM_LOGIT_TOL of their largest magnitude.
    Returns the log's words."""
    if "sem_seg_logits" in want:
        logits = want["sem_seg_logits"].permute(0, 3, 1, 2)
        err = float((got["sem_seg_logits"] - want["sem_seg_logits"]).abs().max())
        scale = float(want["sem_seg_logits"].abs().max())
        if not err <= SEM_LOGIT_TOL * scale:
            raise AssertionError(f"small input: sem_seg_logits max |err| {err} > "
                                 f"{SEM_LOGIT_TOL} of {scale}")
        words = f", sem_seg_logits max|err| {err:.3g} (of {scale:.3g})"
    else:
        with torch.inference_mode():
            logits = semantic_logits(cpu_model, cpu_model.features(batch["image"]))
        words = ""
    top2 = torch.topk(logits, 2, dim=1).values
    clear = top2[:, 0] - top2[:, 1] > SEM_TIE
    differ = int(((got["sem_seg"] != want["sem_seg"]) & clear).sum())
    if differ:
        raise AssertionError(f"small input: sem_seg differs at {differ} pixels clear of a tie")
    return (words + f", sem_seg equal at all {int(clear.sum())} pixels clear of a tie "
            f"({float(clear.float().mean()):.4f} of them)")


def check_fusion_small(cfg, dev, want) -> str:
    """``panoptic_fusion`` of the CPU's detections and map on the card and on
    the CPU, bit-equal maps and tables; thresholds lowered (confidence 0,
    stuff area 64) so that segments of both kinds form."""
    fcfg = cfg.clone()
    fcfg.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = 0.0
    fcfg.MODEL.PANOPTIC_FPN.COMBINE.STUFF_AREA_LIMIT = 64
    fields = want.get_fields()
    cpu_map, cpu_info = panoptic_fusion(fcfg, Instances(**fields))
    gpu_map, gpu_info = panoptic_fusion(fcfg, Instances(**{k: v.to(dev) for k, v in
                                                            fields.items()}))
    if not torch.equal(gpu_map.cpu(), cpu_map) or not all(
            torch.equal(gpu_info[k].cpu(), v) for k, v in cpu_info.items()):
        raise AssertionError("small input: panoptic_fusion differs between the card and the CPU")
    valid, thing = cpu_info["valid"], cpu_info["is_thing"]
    if not bool((valid & thing).any()) or not bool((valid & ~thing).any()):
        raise AssertionError(f"small input: the fusion formed {int((valid & thing).sum())} thing "
                             f"and {int((valid & ~thing).sum())} stuff segments")
    return (f"; panoptic_fusion bit-equal ({int((valid & thing).sum())} thing and "
            f"{int((valid & ~thing).sum())} stuff segments)")


# Narrow float32 model, card against CPU: boxes, scores and masks per slot;
# keypoints' x, y (px) and scores.
SMALL_TOL = {"boxes": 1e-3, "scores": 1e-5, "pred_masks": 1e-4}
KEYPOINT_TOL = (1e-3, 1e-5)
# The semantic head, card against CPU: sem_seg equal where the two largest
# logits lie further apart than SEM_TIE; a SemanticSegmentor's float32 logits
# within SEM_LOGIT_TOL of their largest magnitude; loss_sem_seg to
# SEM_LOSS_RTOL (a mean over every labelled pixel, summed in other orders).
SEM_TIE = 1e-5
SEM_LOGIT_TOL = 1e-4
SEM_LOSS_RTOL = 1e-5
# Gradients zero by construction, held below TRAIN_GRAD_TOL of the named
# sibling's largest gradient on both sides (relative to themselves they are
# float32 noise) and exempt from "every trainable parameter moved": the
# keypoint deconv's bias adds one constant to a keypoint's every position,
# which the softmax over the positions does not see.
ZERO_GRADS = {"roi_heads.keypoint_head.score_lowres.bias":
              "roi_heads.keypoint_head.score_lowres.weight"}
# A relation module's key bias adds one constant to all of a query's logits,
# which the softmax over the keys does not see either.
ZERO_GRADS.update({f"roi_heads.{m}.key.bias": f"roi_heads.{m}.key.weight" for m in (
    "box_head.relation1", "box_head.relation2", "duplicate_removal.relation")})


def small_proposals(cfg, sizes, seed=SEED):
    """Proposal slots for a 2 x 128 x 160 batch: ``add_proposal_slots`` of 5
    random boxes per image (serving's ``PRECOMPUTED_PROPOSAL_TOPK_TEST``)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, 90, (2, 5, 2))
    gt = np.concatenate([xy, xy + rng.uniform(10, 60, (2, 5, 2))], -1).astype(np.float32)
    slots = add_proposal_slots(cfg, {"gt_boxes": gt, "gt_valid": np.ones((2, 5), bool),
                                     "image_size": sizes}, training=False, seed=seed)
    return {k: torch.from_numpy(v) for k, v in slots.items() if k.startswith("proposal_")}


def tie_order(got, want, tolerances=None):
    """``[B, D]``: the card's slot that holds each CPU slot's detection: the
    same slot, or, where the boxes or classes differ, another slot whose CPU
    score lies within ``tolerances["scores"]`` (``SMALL_TOL``'s) of this
    one's and whose card box and class match. At random weights the scores of the detections
    sit ~1e-7 apart, as close as the card and the CPU round them, so two
    such detections (of one class or of two) may take their slots in the
    other order; every slot is still held to the tolerances, and the order
    stays a permutation."""
    b, n = want["scores"].shape
    order = torch.arange(n).repeat(b, 1)
    tolerances = tolerances or SMALL_TOL
    tol, stol = tolerances["boxes"], tolerances["scores"]

    def holds(i, k, j):  # the card's slot k holds the CPU's detection j
        return (got["pred_classes"][i, k] == want["pred_classes"][i, j]
                and float((got["boxes"][i, k] - want["boxes"][i, j]).abs().max()) <= tol)

    for i in range(b):
        for j in range(n):
            if holds(i, j, j):
                continue
            for k in range(n):
                close = abs(float(want["scores"][i, k] - want["scores"][i, j])) <= stol
                if close and holds(i, k, j):
                    order[i, j] = k
                    break
        if order[i].unique().numel() != n:
            raise AssertionError("small input: the card's detections are no reordering of the "
                                 "CPU's at score ties")
    return order


def check_outputs(cfg, out, batch, b, h, w, label, mask_size=28, phase="model     "):
    """100 valid finite detections per image, boxes clipped and, from a model
    with a mask head, probabilities in [0, 1] that ``detector_postprocess``
    pastes into the image."""
    f = out.get_fields()
    masks = "pred_masks" in f
    for k in ("boxes", "scores", "pred_masks")[:3 if masks else 2]:
        if not bool(torch.isfinite(f[k]).all()):
            raise AssertionError(f"{label}: non-finite {k}")
    if (tuple(f["boxes"].shape) != (b, 100, 4)
            or masks and tuple(f["pred_masks"].shape) != (b, 100, mask_size, mask_size)):
        raise AssertionError(f"{label}: unexpected shapes {out}")
    per_image = f["is_valid"].sum(1).tolist()
    if per_image != [100] * b:
        raise AssertionError(f"{label}: valid detections per image {per_image}, expected 100")
    bx = f["boxes"]
    if bool((bx < 0).any()) or bool((bx[..., 2] > 1333).any()) or bool((bx[..., 3] > 800).any()):
        raise AssertionError(f"{label}: boxes not clipped to the image size")
    pasted = ""
    if masks:
        m = f["pred_masks"]
        if not (float(m.min()) >= 0.0 and float(m.max()) <= 1.0):
            raise AssertionError(f"{label}: mask probabilities outside [0, 1]")
        p = detector_postprocess(cfg, out, batch).pred_masks
        if tuple(p.shape) != (b, 100, h, w) or p.dtype != torch.uint8:
            raise AssertionError(f"{label}: postprocess gave {tuple(p.shape)} {p.dtype}")
        pasted = f", pasted masks {tuple(p.shape)} with {int(p.sum())} pixels set"
    if "pred_keypoints" in f:
        kp = f["pred_keypoints"]
        k = cfg.MODEL.ROI_KEYPOINT_HEAD.NUM_KEYPOINTS
        if tuple(kp.shape) != (b, 100, k, 3) or not bool(torch.isfinite(kp).all()):
            raise AssertionError(f"{label}: keypoints {tuple(kp.shape)}, finite "
                                 f"{bool(torch.isfinite(kp).all())}")
        tol = 1e-3 * max(1.0, float(bx.abs().max()))
        inside = ((kp[..., 0] >= bx[..., None, 0] - tol) & (kp[..., 0] <= bx[..., None, 2] + tol)
                  & (kp[..., 1] >= bx[..., None, 1] - tol) & (kp[..., 1] <= bx[..., None, 3] + tol))
        if not bool(inside.all()):
            raise AssertionError(f"{label}: {int((~inside).sum())} keypoints outside their box")
        pasted += (f", {k} keypoints per detection, all finite and inside their box, scores in "
                   f"[{float(kp[..., 2].min()):.2e}, {float(kp[..., 2].max()):.2e}]")
    log(f"{phase} {label}: outputs finite, 100 valid detections per image, boxes clipped, "
        f"scores in [{float(f['scores'].min()):.4f}, {float(f['scores'].max()):.4f}], "
        f"{len(set(f['pred_classes'].flatten().tolist()))} classes{pasted}")


# Timing turns of the switch: off, on, on, off, twice.
TURNS = (False, True, True, False) * 2


def run_model(rng, dev):
    """Serve with the fused tail off and on, in turns; returns the serving
    run's launch counts and the median img/s of each setting."""
    cfg = bench_cfg()
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    models = {}
    for fused in (False, True):
        t0 = time.perf_counter()
        with fused_switch(fused):  # read when the model is built
            models[fused] = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
        if next(models[fused].parameters()).device.type != "cuda":
            raise AssertionError("build_model(cfg) did not build on the card")
        if fused_tails(models[fused]) != (FUSED_TAILS if fused else 0):
            raise AssertionError(f"model built with {fused_tails(models[fused])} fused tails")
        log(f"model      built Mask R-CNN R50-FPN bf16, fused tail {'on' if fused else 'off'}, "
            f"in {time.perf_counter() - t0:.2f} s")
    b, h, w = 2, 800, 1344
    image = torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)).to(dev)
    batch = {"image": image,
             "image_size": torch.tensor([[800, 1333]] * b, dtype=torch.int32, device=dev)}
    for model in models.values():
        for _ in range(2):  # warm-up: cuDNN algorithm choice, allocator
            model.predict(batch)
    torch.cuda.synchronize()

    # Host-bound at batch 2, so one short window is noisy: each setting's
    # median over its windows of five synchronized runs, in turns.
    iters = 5
    rates = {False: [], True: []}
    outs = {}
    zero_launches()
    for fused in TURNS:
        before = fused_conv1x1_bn_add_relu.launches
        before_wgmma = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"]
        t0 = time.perf_counter()
        for _ in range(iters):
            outs[fused] = models[fused].predict(batch)
        torch.cuda.synchronize()
        rates[fused].append(b * iters / (time.perf_counter() - t0))
        tails = fused_conv1x1_bn_add_relu.launches - before
        hopper = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"] - before_wgmma
        if tails != (FUSED_TAILS * iters if fused else 0) or hopper != tails:
            raise AssertionError(f"{tails} fused tails ({hopper} on the wgmma path) in "
                                 f"{iters} predicts with the switch {'on' if fused else 'off'}")
    launches = read_launches()
    img_s = {fused: float(np.median(r)) for fused, r in rates.items()}
    log(f"model      predict in turns {''.join('N' if f else 'F' for f in TURNS)} (F off, N on), "
        f"{iters} runs each, batch {b} at {h}x{w}: fused tail off {img_s[False]:.2f} img/s "
        f"median (windows {', '.join(f'{r:.2f}' for r in rates[False])}), on "
        f"{img_s[True]:.2f} img/s (windows {', '.join(f'{r:.2f}' for r in rates[True])}); "
        f"launches {launches}, {FUSED_TAILS} fused tails per predict with the switch on, all "
        f"on the wgmma path ({fused_conv1x1_bn_add_relu.launches_by_path})")
    for name in ("nms_keep", "roi_patch_fwd", "fused_residual"):
        if launches[name] == 0:
            raise AssertionError(f"the main path never launched {name}")
    if launches["nms_keep"] != NMS_PER_PREDICT * len(TURNS) * iters:
        raise AssertionError(f"{launches['nms_keep']} nms_keep launches in {len(TURNS) * iters} "
                             f"predicts, expected {NMS_PER_PREDICT} per predict")
    for fused, out in outs.items():
        check_outputs(cfg, out, batch, b, h, w, f"fused tail {'on' if fused else 'off'}")
    return launches, img_s


# -- phase 5: train ---------------------------------------------------------

FROZEN = ("backbone.bottom_up.stem.", "backbone.bottom_up.res2.")


def narrow_train_cfg():
    cfg = train_cfg(2)
    for k, v in NARROW.items():
        cfg.MODEL.RESNETS[k] = v
    cfg.MODEL.NECK.OUT_CHANNELS = 32
    cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
    cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 32
    cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
    cfg.MODEL.DTYPE = "float32"
    cfg.INPUT.MAX_GT_INSTANCES = 5
    return cfg


@contextlib.contextmanager
def given_proposals(model, proposals):
    """Make ``model``'s RPN return ``proposals`` (None: leave it): the
    card's and the CPU's convolutions round differently, and proposal scores
    closer than that may trade slots in the top-k, which reorders the
    sample."""
    if proposals is None:
        yield
        return
    model.proposal_generator.proposals = lambda *args, **kwargs: proposals
    try:
        yield
    finally:
        del model.proposal_generator.proposals


def tie_free(model) -> None:
    """Every norm's affine at scale 0.3, bias 1, and the biases of the box
    head's FC and the mask head's deconv at 3, so that no ReLU input lies
    near 0 (``tests/test_torch_norms.py`` ``tie_free``): a normalized
    activation is ~N(0, 1), and one that the card and the CPU round to
    other sides of 0 moves a gradient slice."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, (BatchNorm2d, torch.nn.GroupNorm)):
                mod.weight.fill_(0.3)
                mod.bias.fill_(1.0)
            elif name in ("roi_heads.box_head.fc1", "roi_heads.mask_head.deconv"):
                mod.bias.fill_(3.0)


def check_train_against_cpu(dev, fused: bool, cfg=None, label="train     ", held=None,
                            prepare=None, zero_bias=False, adjust_proposals=None,
                            grad_tol=None):
    """Narrow float32 train step (``narrow_train_cfg()`` unless ``cfg``) on a
    2 x 128 x 160 batch: losses and gradients on the card (kernels) against
    the CPU (plain versions), from the same weights, sampler noise and
    proposals (a ``LOAD_PROPOSALS`` model's from the batch; SOLOv2's
    positive-cap draws), with the fused tail switched off or on for both (a
    model without an RPN, ROI heads or SOLOv2 draws no noise). ``held``: the parameter-name prefixes whose gradients
    are held (the others must be finite), on tie-free weights
    (:func:`tie_free`), for models whose normalized layers make the rest
    ill-conditioned; None holds every gradient. ``prepare(model)`` adjusts
    the CPU model's weights first. ``zero_bias``: a BN bias channel whose
    CPU gradient is below 1e-6 of its scale's largest (zero in exact
    arithmetic: the channel reaches the loss only through other BNs) is
    held below TRAIN_GRAD_TOL of that on the card instead, its other
    channels as every gradient is. ``adjust_proposals(proposals)`` changes
    the CPU model's proposals before both sides take them;
    ``grad_tol(name)`` gives a parameter's gradient tolerance in place of
    TRAIN_GRAD_TOL."""
    cfg = cfg or narrow_train_cfg()
    with fused_switch(fused):
        cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED),
                                training=True)
        if held is not None:
            tie_free(cpu_model)
        if prepare is not None:
            prepare(cpu_model)
        gpu_model = build_model(cfg, device=dev, state_dict=cpu_model.state_dict(),
                                training=True)
    if fused_tails(gpu_model) != (FUSED_TAILS if fused else 0):
        raise AssertionError(f"narrow train model built with {fused_tails(gpu_model)} fused tails")
    nb = make_train_batch(cfg, 128, 160)
    if cfg.MODEL.LOAD_PROPOSALS:
        nb = add_proposal_slots(cfg, nb, training=True)
    batch = {k: torch.from_numpy(v) for k, v in nb.items()}
    gbatch = {k: v.to(dev) for k, v in batch.items()}
    gen = torch.Generator().manual_seed(SEED + 1)
    noise, proposals, gprops = {}, None, None
    if hasattr(cpu_model, "proposal_generator"):
        with torch.no_grad():
            feats = cpu_model.features(batch["image"])
            rpn = cpu_model.proposal_generator
            logits, deltas = rpn.rpn_head([feats[f] for f in rpn.in_features])
            proposals = rpn.proposals(logits, deltas, batch["image_size"], training=True)
        if adjust_proposals is not None:
            proposals = adjust_proposals(proposals)
        cpu_model.load_state_dict(gpu_model.state_dict())  # BN statistics the probe moved
        noise["rpn"] = draw_noise(gen, (2, sum(l[0].numel() for l in logits)), "cpu")
        gprops = type(proposals)(**{k: v.to(dev) for k, v in proposals.get_fields().items()})
    if hasattr(cpu_model, "roi_heads"):
        n_props = (cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if cpu_model.load_proposals
                   else proposals.is_valid.shape[1]) + nb["gt_boxes"].shape[1]
        noise["roi"] = draw_noise(gen, (2, n_props), "cpu")
    if hasattr(cpu_model, "solov2"):  # the positive cap's U(0, 0.5) draws
        noise["solo"] = torch.rand((2, cpu_model.solov2.num_cells()), generator=gen) * 0.5
    gnoise = {k: v.to(dev) if torch.is_tensor(v) else tuple(t.to(dev) for t in v)
              for k, v in noise.items()}

    def run(model, b, nz, props):
        with given_proposals(model, props):
            losses = model.losses(b, noise=nz)
        sum(losses.values()).backward()
        return ({k: float(v.detach()) for k, v in losses.items()},
                {n: p.grad.detach().cpu() for n, p in model.named_parameters() if p.grad is not None})

    want_l, want_g = run(cpu_model, batch, noise, proposals)
    got_l, got_g = run(gpu_model, gbatch, gnoise, gprops)
    for k, v in want_l.items():
        if not abs(got_l[k] - v) <= (SEM_LOSS_RTOL if k == "loss_sem_seg"
                                     else TRAIN_LOSS_RTOL) * abs(v):
            raise AssertionError(f"narrow train step: {k} {got_l[k]} on the card, {v} on the CPU")
    if set(got_g) != set(want_g) or set(got_g) != set(trainable_parameters(cpu_model, 2)):
        raise AssertionError("narrow train step: gradients of other parameters on the card")
    if held is not None:
        if not all(bool(torch.isfinite(g).all()) for g in got_g.values()):
            raise AssertionError("narrow train step: non-finite gradients on the card")
        want_g = {n: w for n, w in want_g.items() if n.startswith(held)}
    worst, worst_norm = (0.0, ""), (0.0, "")
    for n, sibling in ZERO_GRADS.items():
        if n in want_g:
            w = want_g.pop(n)
            scale = TRAIN_GRAD_TOL * float(want_g[sibling].abs().max())
            if not (float(w.abs().max()) <= scale and float(got_g[n].abs().max()) <= scale):
                raise AssertionError(f"narrow train step: the zero gradient of {n} is "
                                     f"{float(got_g[n].abs().max()):.3g} on the card, "
                                     f"{float(w.abs().max()):.3g} on the CPU (bound {scale:.3g})")
    zeros, looser = 0, {}
    for n, w in want_g.items():
        g = got_g[n]
        if zero_bias and n.endswith(".norm.bias"):
            scale = float(want_g[n[:-4] + "weight"].abs().max())
            zero = w.abs() <= 1e-6 * scale
            if bool(zero.any()):
                zeros += int(zero.sum())
                if not float(g[zero].abs().max()) <= TRAIN_GRAD_TOL * scale:
                    raise AssertionError(f"narrow train step: the zero gradient channels of {n} "
                                         f"read {float(g[zero].abs().max()):.3g} on the card "
                                         f"(bound {TRAIN_GRAD_TOL * scale:.3g})")
                g, w = g[~zero], w[~zero]
                if not w.numel():
                    continue
        diff = g - w
        rel = float(diff.abs().max()) / max(float(w.abs().max()), 1e-30)
        rel_norm = float(diff.norm()) / max(float(w.norm()), 1e-30)
        tol = TRAIN_GRAD_TOL if grad_tol is None else grad_tol(n)
        if tol == TRAIN_GRAD_TOL:
            worst, worst_norm = max(worst, (rel, n)), max(worst_norm, (rel_norm, n))
        else:
            looser[n] = max(rel, rel_norm)
        if rel > tol or rel_norm > tol:
            raise AssertionError(f"narrow train step: gradient of {n} differs by {rel:.3g} of "
                                 f"its largest magnitude, {rel_norm:.3g} in norm "
                                 f"(tolerance {tol})")
    log(f"{label} narrow f32 step, fused tail {'on' if fused else 'off'}, card vs CPU: "
        "losses " + ", ".join(
        f"{k} {got_l[k]:.6f}/{v:.6f}" for k, v in want_l.items())
        + f"; {len(want_g)} gradients held{'' if held is None else f' ({held})'}, worst "
          f"max|err| / max|grad| {worst[0]:.3g} ({worst[1]}),"
          f" worst |err| / |grad| {worst_norm[0]:.3g} ({worst_norm[1]})"
        + (f"; {zeros} BN bias channels with a zero gradient held below it" if zero_bias else "")
        + ("; at their own tolerances " + ", ".join(
            f"{n} {e:.3g} ({grad_tol(n)})" for n, e in looser.items()) if looser else ""))


def run_train(dev):
    """Train with the fused tail off and on, in turns; returns the timed
    steps' launch counts and the median img/s of each setting."""
    cfg = train_cfg(8)
    b, h, w = 8, 800, 1344
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(cfg, h, w).items()}
    runs = {}
    for fused in (False, True):
        t0 = time.perf_counter()
        with fused_switch(fused):  # read when the model is built
            model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED),
                                training=True)
        if fused_tails(model) != (FUSED_TAILS if fused else 0):
            raise AssertionError(f"train model built with {fused_tails(model)} fused tails")
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(SEED))
        step = build_train_step(cfg, state)
        log(f"train      built Mask R-CNN R50-FPN train state (bf16, float32 params), fused tail "
            f"{'on' if fused else 'off'}, in {time.perf_counter() - t0:.2f} s")
        metrics = [step(batch) for _ in range(2)]  # warm-up: cuDNN algorithms, allocator
        runs[fused] = (model, start, step, metrics)
    torch.cuda.synchronize()

    iters = 3
    rates = {False: [], True: []}
    zero_launches()
    for fused in TURNS:
        _, _, step, metrics = runs[fused]
        before = fused_conv1x1_bn_add_relu.launches
        before_wgmma = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"]
        t0 = time.perf_counter()
        for _ in range(iters):
            metrics.append(step(batch))
        torch.cuda.synchronize()
        rates[fused].append(b * iters / (time.perf_counter() - t0))
        tails = fused_conv1x1_bn_add_relu.launches - before
        hopper = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"] - before_wgmma
        if tails != (FUSED_TAILS * iters if fused else 0) or hopper != tails:
            raise AssertionError(f"{tails} fused tails ({hopper} on the wgmma path) in "
                                 f"{iters} steps with the switch {'on' if fused else 'off'}")
    launches = read_launches()
    img_s = {fused: float(np.median(r)) for fused, r in rates.items()}
    log(f"train      steps in turns {''.join('N' if f else 'F' for f in TURNS)} (F off, N on), "
        f"{iters} each, batch {b} at {h}x{w}: fused tail off {img_s[False]:.2f} img/s median "
        f"(windows {', '.join(f'{r:.2f}' for r in rates[False])}), on {img_s[True]:.2f} img/s "
        f"(windows {', '.join(f'{r:.2f}' for r in rates[True])}); launches {launches}, "
        f"{FUSED_TAILS} fused tails per step with the switch on, all on the wgmma path "
        f"({fused_conv1x1_bn_add_relu.launches_by_path}); peak memory "
        f"{torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB")
    for name in ("nms_keep", "roi_patch_fwd", "roi_patch_bwd", "fused_residual"):
        if launches[name] == 0:
            raise AssertionError(f"the train step never launched {name}")
    if launches["nms_keep"] != NMS_PER_STEP * len(TURNS) * iters:
        raise AssertionError(f"{launches['nms_keep']} nms_keep launches in {len(TURNS) * iters} "
                             f"steps, expected {NMS_PER_STEP} per step")

    for fused, (model, start, _, metrics) in runs.items():
        label = f"fused tail {'on' if fused else 'off'}"
        values = [{k: float(v) for k, v in m.items()} for m in metrics]
        if not all(np.isfinite(v) for m in values for v in m.values()):
            raise AssertionError(f"{label}: non-finite losses: {values}")
        trainable = trainable_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
        frozen = [n for n, _ in model.named_parameters() if n not in trainable]
        if not frozen or any(not n.startswith(FROZEN) for n in frozen):
            raise AssertionError(f"{label}: unexpected frozen parameters {frozen}")
        params = dict(model.named_parameters())
        changed_frozen = [n for n in frozen if not torch.equal(params[n], start[n])]
        unchanged = [n for n, p in trainable.items() if torch.equal(p.detach(), start[n])]
        if changed_frozen or unchanged:
            raise AssertionError(f"{label}: frozen parameters changed: {changed_frozen}; "
                                 f"trainable parameters unchanged: {unchanged}")
        log(f"train      {label}: losses finite over {len(values)} steps; first "
            + ", ".join(f"{k} {v:.4f}" for k, v in values[0].items())
            + f"; last total_loss {values[-1]['total_loss']:.4f}; {len(frozen)} frozen "
              f"parameters bit-equal, all {len(trainable)} trainable parameters changed")
    return launches, img_s


# -- phase 7: loop -----------------------------------------------------------

LOOP_YAML = "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_FPN_1x.yaml"
LOOP_OPTS = ["MODEL.DTYPE", "bfloat16", "SOLVER.IMS_PER_GPU", "8",
             "SOLVER.SHORT_TERM_SAVE_STEPS", "2", "SOLVER.SHORT_TERM_NUM_STEPS", "4",
             "MODEL.ROI_HEADS.SCORE_THRESH_TEST", "0.0"]
LOOP_STEPS, LOOP_RESUMED_STEPS = 4, 6


class TimedBatches:
    """An iterator over ``batches`` that adds up the host seconds spent in
    each ``next`` (loading, transforming and padding a batch)."""

    def __init__(self, batches):
        self.batches, self.seconds = batches, []

    def __iter__(self):
        return self

    def __next__(self):
        t0 = time.perf_counter()
        batch = next(self.batches)
        self.seconds.append(time.perf_counter() - t0)
        return batch


def loop_snapshot(state) -> dict:
    """What a resume restores: parameters and buffers, the SGD momentum
    buffers, the optimizer count, the generator and the step (on the CPU)."""
    opt = state.optimizer.sgd
    return {"model": {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()},
            "momentum": [opt.state[p]["momentum_buffer"].cpu().clone()
                         for g in opt.param_groups for p in g["params"]],
            "count": state.optimizer.count, "step": state.step,
            "generator": state.generator.get_state().clone()}


def snapshots_equal(a: dict, b: dict) -> bool:
    return (a["count"] == b["count"] and a["step"] == b["step"]
            and torch.equal(a["generator"], b["generator"])
            and a["model"].keys() == b["model"].keys()
            and all(torch.equal(v, b["model"][k]) for k, v in a["model"].items())
            and len(a["momentum"]) == len(b["momentum"]) > 0
            and all(torch.equal(x, y) for x, y in zip(a["momentum"], b["momentum"])))


def loop_cfg():
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / LOOP_YAML))
    cfg.merge_from_list(LOOP_OPTS)
    return finalize(cfg)  # on the card: one device


def check_loop_train(state, steps: int, name: str) -> dict:
    """Losses finite and the launches of ``steps`` steps: one ``nms_keep``
    each, and the same positive number of ROI forwards and backwards each."""
    launches = read_launches()
    losses = [v for _, metrics, _ in state.history for v in metrics.values()]
    if len(state.history) != steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"loop {name}: losses {state.history}")
    if launches["nms_keep"] != NMS_PER_STEP * steps:
        raise AssertionError(f"loop {name}: {launches['nms_keep']} nms_keep launches in "
                             f"{steps} steps, expected {NMS_PER_STEP} per step")
    for k in ("roi_patch_fwd", "roi_patch_bwd"):
        if launches[k] == 0 or launches[k] % steps:
            raise AssertionError(f"loop {name}: {launches[k]} {k} launches in {steps} steps")
    if launches["fused_residual"]:
        raise AssertionError(f"loop {name}: fused tail launched with the switch off")
    return launches


def check_metrics(metrics: dict, ds) -> None:
    """Every bbox and segm metric is finite, except an area range's, which
    is NaN exactly where no GT of the dataset falls in that range."""
    boxes = np.concatenate([ds[i]["boxes"] for i in range(len(ds))])
    areas = {"bbox": (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1]),
             "segm": np.concatenate([ds[i]["masks"].sum((1, 2)) for i in range(len(ds))])}
    ranges = {"s": (0, 32 ** 2), "m": (32 ** 2, 96 ** 2), "l": (96 ** 2, 1e10)}
    for kind in ("bbox", "segm"):
        keys = [k for k in metrics if k.startswith(kind + "/")]
        if len(keys) < 12:
            raise AssertionError(f"loop eval: {kind} metrics {keys}")
        for key in keys:
            name = key.split("/")[1]
            value = metrics[key]
            rng = ranges.get(name[-1]) if name[:2] in ("AP", "AR") and len(name) == 3 else None
            empty = rng is not None and not ((areas[kind] >= rng[0]) & (areas[kind] <= rng[1])).any()
            if not (math.isnan(value) if empty else math.isfinite(value)):
                raise AssertionError(f"loop eval: {key} = {value}")


def run_loop():
    """The user's path: the YAML config, the loader, ``train()`` with
    checkpoints, a resume from them, and ``run_evaluation``."""
    t0 = time.perf_counter()
    cfg = loop_cfg()
    train_ds = SyntheticDataset(n=16, h=480, w=640, num_classes=80, box_range=(40, 200))
    val_ds = SyntheticDataset(n=8, h=480, w=640, num_classes=80, box_range=(40, 200),
                              first_id=16)
    model = build_model(cfg, training=True, generator=torch.Generator().manual_seed(SEED))
    if fused_tails(model):
        raise AssertionError("loop model built with fused tails")
    log(f"loop       {LOOP_YAML} + {LOOP_OPTS}, finalized on the card: R{cfg.MODEL.RESNETS.DEPTH}"
        f"-FPN, {cfg.MODEL.ROI_HEADS.NUM_CLASSES} classes, {cfg.MODEL.DTYPE}, "
        f"MIN_SIZE_TRAIN {tuple(cfg.TRANSFORM.RESIZE.MIN_SIZE_TRAIN)}, buckets "
        f"{tuple(map(tuple, cfg.INPUT.PAD_BUCKETS))}, batch {cfg.SOLVER.IMS_PER_BATCH}; "
        f"data 16 train + 8 val images of 480x640; model built in "
        f"{time.perf_counter() - t0:.2f} s")

    loader = build_dataloader(cfg, train_ds, training=True, seed=SEED)
    t0 = time.perf_counter()
    for _ in range(LOOP_STEPS):
        next(loader)
    loader.close()
    log(f"loop       the loader alone: {(time.perf_counter() - t0) / LOOP_STEPS:.3f} host s per "
        f"batch of {cfg.SOLVER.IMS_PER_BATCH} ({cfg.DATALOADER.NUM_READERS} reader threads)")

    with tempfile.TemporaryDirectory() as ckpt:
        batches = TimedBatches(build_dataloader(cfg, train_ds, training=True, seed=SEED))
        zero_launches()
        t0 = time.perf_counter()
        state = train(cfg, model, batches, max_iter=LOOP_STEPS, checkpoint_dir=ckpt, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = check_loop_train(state, LOOP_STEPS, "train")
        saved = loop_snapshot(state)
        files = all_steps(ckpt)
        if state.step != LOOP_STEPS or files != [2, 4]:
            raise AssertionError(f"loop: step {state.step}, checkpoints {files}")
        times = [dt for _, _, dt in state.history]
        log(f"loop       train() {LOOP_STEPS} steps in {wall:.2f} s, seconds per iteration "
            f"{', '.join(f'{t:.3f}' for t in times)} (the checkpoints of steps 1 and 2 are "
            f"written in iterations 2 and 3); host seconds waiting for each batch "
            f"{', '.join(f'{t:.3f}' for t in batches.seconds)}; losses at step 1 "
            + ", ".join(f"{k} {v:.4f}" for k, v in state.history[0][1].items())
            + f", step {LOOP_STEPS} total_loss {state.history[-1][1]['total_loss']:.4f}; "
              f"checkpoints {files}; launches {launches}")
        del state, model

        resumed_model = build_model(cfg, training=True,
                                    generator=torch.Generator().manual_seed(SEED + 1))
        batches = TimedBatches(build_dataloader(cfg, train_ds, training=True, seed=SEED + 1))
        restored = train(cfg, resumed_model, batches, max_iter=LOOP_STEPS, checkpoint_dir=ckpt)
        if restored.history or not snapshots_equal(loop_snapshot(restored), saved):
            raise AssertionError("loop: the state restored at step 4 differs from the saved one")
        zero_launches()
        t0 = time.perf_counter()
        final = train(cfg, resumed_model, batches, max_iter=LOOP_RESUMED_STEPS,
                      checkpoint_dir=ckpt, log_every=1)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = LOOP_RESUMED_STEPS - LOOP_STEPS
        launches = check_loop_train(final, steps, "resume")
        files = all_steps(ckpt)
        if final.step != LOOP_RESUMED_STEPS or files != [4, 6] or final.history[0][0] != 5:
            raise AssertionError(f"loop resume: step {final.step}, history "
                                 f"{[h[0] for h in final.history]}, checkpoints {files}")
        log(f"loop       resumed at step {LOOP_STEPS}: restored state bit-equal to the saved one "
            f"(parameters, buffers, momentum, count, generator); steps "
            f"{LOOP_STEPS + 1}-{LOOP_RESUMED_STEPS} in {wall:.2f} s, seconds per iteration "
            f"{', '.join(f'{dt:.3f}' for _, _, dt in final.history)} (no checkpoint written "
            f"in either), host seconds waiting for each batch {', '.join(f'{t:.3f}' for t in batches.seconds)}"
            f"; losses finite; checkpoints {files}; launches {launches}")

    zero_launches()
    t0 = time.perf_counter()
    batches = list(build_dataloader(cfg, val_ds, training=False))
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metrics = run_evaluation(cfg, final.model, val_ds, batches)
    eval_s = time.perf_counter() - t0
    launches = read_launches()
    if launches["nms_keep"] != NMS_PER_PREDICT * len(batches):
        raise AssertionError(f"loop eval: {launches['nms_keep']} nms_keep launches in "
                             f"{len(batches)} predict calls")
    check_metrics(metrics, val_ds)
    log(f"loop       run_evaluation over {len(val_ds)} images in {len(batches)} batch(es): "
        f"{eval_s:.2f} s (loading {load_s:.2f} s); {NMS_PER_PREDICT} nms_keep launches per "
        f"predict; launches {launches}")
    for kind in ("bbox", "segm"):
        log(f"loop       {kind} " + json.dumps(
            {k.split("/")[1]: v for k, v in metrics.items() if k.startswith(kind + "/")}))


# -- phase 8: workflow -------------------------------------------------------

# (a) R50-FPN at full width through the CLIs, from records; the loop phase's
# YAML and overrides. (b) the R18-GN overfit workflow and its AP gate.
WORKFLOW_OPTS = LOOP_OPTS[:-2]  # the evaluation keeps the YAML's score threshold
WORKFLOW_STEPS, WORKFLOW_RESUMED_STEPS = 4, 6
WORKFLOW_ROI_PER_STEP = 2  # box and mask ROIs, pooled forward and backward


def check_cli_train(summary: dict, start: int, stop: int, name: str) -> None:
    """A ``tools.train`` run from ``start`` to ``stop``: per step one
    ``nms_keep``, two ``roi_patch_fwd`` and two ``roi_patch_bwd`` launches,
    no fused tail; losses finite."""
    steps = stop - start
    launches = summary["launches"]
    want = {"nms_keep": NMS_PER_STEP * steps, "roi_patch_fwd": WORKFLOW_ROI_PER_STEP * steps,
            "roi_patch_bwd": WORKFLOW_ROI_PER_STEP * steps, "fused_residual": 0}
    losses = summary["final_losses"] or {}
    if (summary["start_step"], summary["step"]) != (start, stop) or launches != want \
            or not losses or not all(math.isfinite(v) for v in losses.values()):
        raise AssertionError(f"workflow {name}: {summary}, expected launches {want}")


def check_results_file(path: str, ds) -> int:
    """The ``--dump_results`` JSON parses, and its records name the
    dataset's category ids and image ids."""
    with open(path) as f:
        records = json.load(f)
    cat_ids = set(ds.contiguous_to_cat_id.values())
    image_ids = {ds.image_id(i) for i in range(len(ds))}
    if not records or any(r["category_id"] not in cat_ids or r["image_id"] not in image_ids
                          or len(r["bbox"]) != 4 or "counts" not in r["segmentation"]
                          for r in records):
        raise AssertionError(f"workflow: results file {path}: {records[:3]}")
    return len(records)


def loader_seconds(root: str, batches: int = 12):
    """Host seconds per batch of the overfit config's loader over its train
    records (CRC check, JPEG and PNG decode, resize, mini-masks), and the
    seconds per record of the CRC alone and of the JPEG decode alone."""
    from detectron2_tensorflow_tpu_torch.data import TFRecordDataset, image_io, tfrecord_codec

    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / workflow_check.CFG))
    cfg.merge_from_list(["DATASETS.ROOT_DIR", root])
    finalize(cfg)
    ds = TFRecordDataset(os.path.join(root, "train.record-*"))
    loader = build_dataloader(cfg, ds, training=True, seed=SEED)
    next(loader)
    t0 = time.perf_counter()
    for _ in range(batches):
        next(loader)
    per_batch = (time.perf_counter() - t0) / batches
    loader.close()
    payloads = [tfrecord_codec.read_record_at(ds.files[fi], off, n) for fi, off, n in ds._index]
    t0 = time.perf_counter()
    for data in payloads:
        tfrecord_codec.crc32c(data)
    crc = (time.perf_counter() - t0) / len(payloads)
    jpegs = [tfrecord_codec.decode_example(d)["image/encoded"][1][0] for d in payloads]
    t0 = time.perf_counter()
    for data in jpegs:
        image_io.decode_image(data)
    decode = (time.perf_counter() - t0) / len(jpegs)
    return per_batch, crc, decode, cfg.SOLVER.IMS_PER_BATCH, cfg.DATALOADER.NUM_READERS


def run_workflow():
    """The CLIs as subprocesses in a temporary directory: (a) R50-FPN bf16 at
    800x1344 from records (train 4 steps, resume to 6, evaluate with
    ``--dump_results``), run here; then (b) the R18-GN overfit workflow (on
    a thread: its CLIs are subprocesses) with the overfit gates of phases
    9-14 and the panoptic workflow beside it, all host-bound, started and
    left running while the later phases use the card; :func:`finish_workflow`
    waits for them. Returns what it needs."""
    run_step = workflow_check.run_step
    tmp = tempfile.mkdtemp(prefix="chip_smoke_workflow_")
    root = os.path.join(tmp, "r50")
    common = ["--config_file", LOOP_YAML, "DATASETS.ROOT_DIR", root,
              "LOGS.ROOT_DIR", os.path.join(root, "logs"), *WORKFLOW_OPTS]
    t0 = time.perf_counter()
    run_step("make_synthetic_coco", [root, "16", "8"], echo=False)
    run_step("build_records", [*common, "BUILD_RECORDS.TYPE", "coco_inst",
                               "BUILD_RECORDS.TRAIN_NUM_SHARDS", "2",
                               "BUILD_RECORDS.VAL_NUM_SHARDS", "1"], echo=False)
    log(f"workflow   (a) {LOOP_YAML} + {WORKFLOW_OPTS}: 16 train + 8 val synthetic images "
        f"as records (2 + 1 shards) in {time.perf_counter() - t0:.2f} s")
    out = run_step("train", ["--max_iter", str(WORKFLOW_STEPS), *common], echo=False)
    first = workflow_check.train_summary(out)
    check_cli_train(first, 0, WORKFLOW_STEPS, "(a) train")
    ckpt = first["checkpoint_dir"]
    if all_steps(ckpt) != [2, 4]:
        raise AssertionError(f"workflow (a): checkpoints {all_steps(ckpt)}")
    out = run_step("train", ["--max_iter", str(WORKFLOW_RESUMED_STEPS), *common], echo=False)
    resumed = workflow_check.train_summary(out)
    resume_lines = [ln for ln in out.splitlines() if "resumed from checkpoint step" in ln]
    check_cli_train(resumed, WORKFLOW_STEPS, WORKFLOW_RESUMED_STEPS, "(a) resume")
    if not resume_lines or all_steps(ckpt) != [4, 6]:
        raise AssertionError(f"workflow (a) resume: {resume_lines}, checkpoints "
                             f"{all_steps(ckpt)}")
    for name, s in (("train", first), ("resume", resumed)):
        log(f"workflow   (a) tools.train {name}: steps {s['start_step']}-{s['step']} in "
            f"{s['seconds']:.2f} s ({s['seconds_per_iteration']:.3f} s per iteration, "
            f"checkpoint writes and the first step's set-up included), losses "
            + ", ".join(f"{k} {v:.4f}" for k, v in s["final_losses"].items())
            + f"; launches {s['launches']}")
    log(f"workflow   (a) {resume_lines[0].split(':')[-1].strip()}; checkpoints on disk "
        f"{all_steps(ckpt)}")
    results = os.path.join(root, "results.json")
    t0 = time.perf_counter()
    out = run_step("eval", ["--dump_results", results, *common], echo=False)
    metrics = workflow_check.eval_metrics(out)
    from detectron2_tensorflow_tpu_torch.data import TFRecordDataset

    n = check_results_file(results, TFRecordDataset(os.path.join(root, "val.record-*")))
    if len(metrics) < 24 or not all(math.isfinite(v) or math.isnan(v)
                                    for v in metrics.values()):
        raise AssertionError(f"workflow (a) eval: {metrics}")
    log(f"workflow   (a) tools.eval from the val records in {time.perf_counter() - t0:.2f} s "
        f"(process included): {n} results with the dataset's category ids; bbox AP "
        f"{metrics['bbox/AP']:.3f}, segm AP {metrics['segm/AP']:.3f} (random weights, "
        f"6 steps)")
    shutil.rmtree(root)

    gates = start_overfit_gates(os.path.join(tmp, "pano"))  # host-bound, beside (b)
    r18 = {"root": os.path.join(tmp, "r18")}

    def workflow_b():
        try:  # the switch set for (b)'s CLIs whatever the card's phases set meanwhile
            r18["result"] = workflow_check.run_workflow(
                r18["root"], env={fused_residual.ENV_SWITCH: "1"}, echo=False)
        except BaseException as e:  # noqa: BLE001 - re-raised by finish_workflow
            r18["error"] = e

    thread = threading.Thread(target=workflow_b, daemon=True)
    thread.start()
    return {"tmp": tmp, "gates": gates, "thread": thread, "r18": r18}


def finish_workflow(pending):
    """Wait for workflow (b) (a GN trunk: no tail fused with the switch set;
    its AP gate decides), the panoptic workflow and the overfit gates that
    :func:`run_workflow` left running; log them. Returns the gates' results."""
    pending["thread"].join(timeout=1200)
    r18 = pending["r18"]
    if "error" in r18:
        raise r18["error"]
    if "result" not in r18:
        raise AssertionError("workflow (b) did not finish")
    result = r18["result"]
    train_s, m = result["train"], result["metrics"]
    if train_s["launches"]["fused_residual"] or train_s["fused_tail_convs"]:
        raise AssertionError(f"workflow (b): fused tails on a GN trunk: {train_s}")
    per_batch, crc, decode, batch, readers = loader_seconds(r18["root"])
    gates = pending["gates"]
    finish_panoptic_workflow(gates.pop("panoptic"))
    shutil.rmtree(pending["tmp"], ignore_errors=True)
    log(f"workflow   (b) {workflow_check.CFG}: Mask R-CNN R18-FPN GN, from scratch, "
        f"{train_s['steps']} iterations of 8 x 192x256 float32, then tools.eval on the train "
        f"split with TEST.EXPECTED_RESULTS {workflow_check.EXPECTED}: passed")
    for key in ("bbox/AP", "bbox/AP50", "segm/AP", "segm/AP50"):
        log(f"workflow   (b) {key} {m[key]:.3f}")
    log(f"workflow   (b) final loss " + ", ".join(
        f"{k} {v:.4f}" for k, v in train_s["final_losses"].items()))
    log(f"workflow   (b) train seconds {train_s['seconds']:.2f} (the tools.train process "
        f"{result['seconds']['train']:.2f} s)")
    log(f"workflow   (b) seconds per iteration {train_s['seconds_per_iteration']:.4f}")
    log(f"workflow   (b) loader host seconds per batch of {batch} {per_batch:.4f} "
        f"({readers} reader threads; per record: CRC {crc * 1e3:.3f} ms, JPEG decode "
        f"{decode * 1e3:.3f} ms)")
    log(f"workflow   (b) fused tails {train_s['launches']['fused_residual']} launched, "
        f"{train_s['fused_tail_convs']} convs built for them, with "
        f"{fused_residual.ENV_SWITCH} set; launches {train_s['launches']}")
    log(f"workflow   (b) step seconds " + ", ".join(
        f"{k} {v:.2f}" for k, v in result["seconds"].items()))
    return finish_overfit_gates(gates)


# -- phase 9: single_level -----------------------------------------------------

C4_YAML = "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_C4_1x.yaml"
DC5_YAML = "configs/COCO-InstanceSegmentation/mask_rcnn_R_50_DC5_1x.yaml"
# Per predict / per train step of the single-level models: launches of each
# kernel, fused tails with the switch on, and the mask size. C4 runs the
# res5 head on the proposals and again on the detections (box pooler both
# times); DC5 pools box and mask sets as the FPN path does. In training C4
# pools the box set alone (its mask head reads the res5 features).
SINGLE_LEVEL = {
    "c4": {"yaml": C4_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 2},
           "step": {"nms_keep": 1, "roi_patch_fwd": 1, "roi_patch_bwd": 1},
           "tails": 13 + 3 + 3, "mask_size": 14},
    "dc5": {"yaml": DC5_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 2},
            "step": {"nms_keep": 1, "roi_patch_fwd": 2, "roi_patch_bwd": 2},
            "tails": 16, "mask_size": 28},
}
SINGLE_TURNS = (False, True, True, False)
# The overfit gate: bbox AP50 at least 90 for every family at its last step,
# and for c4 at step 600 a bbox AP no more than 10 points below the JAX
# package's on the same recipe (its tools/overfit_check.py 600 --arch c4 on
# the CPU: bbox AP 54.58, AP50 64.75; PERF.md). Above it is no failure: the
# port's c4 bbox AP spread 11 points over four runs, all 11-22 above that one
# reference run. c4 trains 1200 steps for its AP50: at 600 a confident false
# box still outranks true positives in some card runs (AP50 88.78 once in 17
# runs, 94.47-100 otherwise), at 1200 the true positives score higher (AP50
# 100 in 8 runs of 8; PERF.md section 6).
OVERFIT_AP50 = 90.0
OVERFIT_JAX_C4_BBOX_AP = 54.58
# The keypoint gate's keypoint AP is held one-sided the same way against the
# JAX tool's (tools/overfit_check.py 600 --arch keypoint on the CPU: bbox AP
# 94.32, AP50 100.0, keypoint AP 84.87; PERF.md section 6).
OVERFIT_JAX_KEYPOINT_AP = 84.87
# The semantic gate's mIoU the same way (tools/overfit_check.py 600 --arch
# semantic on the CPU: mIoU 69.24, mACC 76.87; PERF.md section 6).
OVERFIT_JAX_SEMANTIC_MIOU = 69.24
# The solov2 gate's segm AP the same way (tools/overfit_check.py 600 --arch
# solov2 on the CPU: bbox AP 74.38, AP50 100.0, segm AP 70.65; PERF.md
# section 6).
OVERFIT_JAX_SOLOV2_SEGM_AP = 70.65
# The yolov4 gate's bbox AP the same way (tools/overfit_check.py 600 --arch
# yolov4 on the CPU: bbox AP 79.37, AP50 100.0; PERF.md section 6).
OVERFIT_JAX_YOLOV4_BBOX_AP = 79.37
# The relation gate's bbox AP at step 600 the same way, as a mean over its
# seeds (OVERFIT_SEEDS; tools/overfit_check.py 600 --arch relation on the CPU,
# the learned duplicate removal on: bbox AP 69.86, AP50 91.76; PERF.md
# section 6).
OVERFIT_JAX_RELATION_BBOX_AP = 69.86
OVERFIT_JAX_STEPS = 600
OVERFIT_AP_BELOW = 10.0


def single_level_cfg(name: str, narrow: bool = False, batch: int = 0):
    """``name``'s YAML: bf16 at full width (``SCORE_THRESH_TEST`` 0), or the
    narrow float32 model of the card-against-CPU checks; ``batch`` > 0 makes
    it a training config of ``batch`` images and 64 GT slots (5 narrow)."""
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / SINGLE_LEVEL[name]["yaml"]))
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    if narrow:
        for k, v in NARROW.items():
            cfg.MODEL.RESNETS[k] = v
        cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
        cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 32
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
        cfg.MODEL.DTYPE = "float32"
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
    if batch:
        cfg.SOLVER.IMS_PER_BATCH = batch
        cfg.SOLVER.AUTO_SCALE_LR_SCHEDULE = False
        cfg.INPUT.MAX_GT_INSTANCES = 5 if narrow else 64
    return cfg


def greedy_keep_reference_rows(boxes, valid, thr, max_keep):
    """The plain keep mask one batch row at a time (a row's N x N IoU at
    N = 12000 is 0.58 GB; eight at once would not leave the card room)."""
    return torch.cat([greedy_keep_reference(boxes[i: i + 1], valid[i: i + 1], thr, max_keep)
                      for i in range(boxes.shape[0])])


def check_single_level_nms(rng, dev):
    """``nms_keep`` bit-equal at the single-level RPN's shapes: serving's 2
    images x one level of 6000 (``max_keep`` 1000), training's 8 x 12000
    (``max_keep`` 2000)."""
    results = []
    for name, b, n, mk in (("rpn one level 2x6000 iou=0.7 max_keep=1000", 2, 6000, 1000),
                           ("train rpn one level 8x12000 iou=0.7 max_keep=2000", 8, 12000, 2000)):
        boxes, valid = clustered_boxes(rng, b, n, objects=600)
        results.append(nms_case(dev, name, boxes, valid, 0.7, mk, plain=greedy_keep_reference_rows,
                                reps=20, tag="single     nms_keep"))
    return results


def single_level_plane(rng, dev, b: int, c: int):
    """The C4/DC5 storage: one level at stride 16 of an 800x1344 image (50 x
    84, ``c`` channels: res4's 1024 or dilated res5's 2048) with its 2x and
    4x extent-tier aliases."""
    feat = card_normal(rng, (b, 50, 84, c), dev, torch.bfloat16)
    return build_storage([feat], [16], plan_patch(1333, 16))


def single_level_plan(rng, dev, meta, b, n, s, objects):
    """``(starts, wy, wx, valid)`` for ``n`` boxes per image, jittered copies
    of ``objects`` objects, 10% of the slots skipped."""
    boxes, _ = clustered_boxes(rng, b, n, objects=objects)
    valid = torch.from_numpy(rng.uniform(0, 1, (b, n)) < 0.9).to(dev)
    starts, wy, wx = plan_rois(meta, torch.from_numpy(boxes).to(dev), s, 0, 224, 4, valid=valid)
    return starts.contiguous(), wy.contiguous(), wx.contiguous(), valid


def check_single_level_roi(rng, dev):
    """``roi_patch_fwd`` at the single-level sets (bf16): C4's res4 plane
    (C = 1024) at S = 14 for 2 x 1000 proposals and 2 x 100 detections,
    DC5's res5 plane (C = 2048) at S = 7 for 2 x 1000 and S = 14 for 2 x 100."""
    results = []
    for c, label, n, s in ((1024, "c4 box C=1024 S=14 2x1000", 1000, 14),
                           (1024, "c4 detections C=1024 S=14 2x100", 100, 14),
                           (2048, "dc5 box C=2048 S=7 2x1000", 1000, 7),
                           (2048, "dc5 mask C=2048 S=14 2x100", 100, 14)):
        storage, meta = single_level_plane(rng, dev, 2, c)
        plan = single_level_plan(rng, dev, meta, 2, n, s, max(n // 4, 8))
        results.append(roi_fwd_case(label, storage.contiguous(), *plan,
                                    tag="single     roi_patch"))
    return results


def check_single_level_roi_bwd(rng, dev):
    """``roi_patch_bwd`` at the single-level training sets (bf16 cotangents,
    batch 8, boxes clustered on 12 objects): C4 C = 1024, S = 14, 8 x 512;
    DC5 C = 2048, S = 7, 8 x 512 and S = 14, 8 x 128."""
    results = []
    for c, label, n, s in ((1024, "c4 box C=1024 S=14 8x512", 512, 14),
                           (2048, "dc5 box C=2048 S=7 8x512", 512, 7),
                           (2048, "dc5 mask C=2048 S=14 8x128", 128, 14)):
        storage, meta = single_level_plane(rng, dev, 8, c)
        shape = tuple(storage.shape)
        del storage
        starts, wy, wx, valid = single_level_plan(rng, dev, meta, 8, n, s, 12)
        g = card_normal(rng, (8, n, s, s, c), dev, torch.bfloat16)
        results.append(roi_bwd_case(label, g, starts, wy, wx, valid, shape,
                                    tag="single     roi_bwd"))
        del g
        torch.cuda.empty_cache()
    return results


def check_single_level_fused(rng, dev):
    """``fused_residual`` at the single-level tails (bf16, each on the
    ``wgmma`` path): the C4 head's res5 tails at M = 2 x 1000 x 49 = 98000
    (K 512, N 2048) and DC5's dilated res5 at M = 2 x 50 x 84 = 8400."""
    return [fused_case(rng, dev, label, torch.bfloat16, dims, wgmma=True,
                       tag="single     fused_res")
            for label, dims in (("c4 head res5 M=98000 K=512 N=2048", (2000, 7, 7, 512, 2048)),
                                ("dc5 res5 M=8400 K=512 N=2048", (2, 50, 84, 512, 2048)))]


def serve_single_level(rng, dev, name: str):
    """``name``'s YAML (bf16, seeded random weights) serving 2 x 800 x 1344
    with the fused tail off and on in turns: the launches of each kernel per
    ``predict`` asserted, the outputs checked; img/s, and device ms per call
    and idle share under the profiler. Returns the serving run's launches."""
    spec = SINGLE_LEVEL[name]
    cfg = single_level_cfg(name)
    models = {}
    for fused in (False, True):
        with fused_switch(fused):
            models[fused] = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    b, h, w = 2, 800, 1344
    image = torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)).to(dev)
    batch = {"image": image,
             "image_size": torch.tensor([[800, 1333]] * b, dtype=torch.int32, device=dev)}
    for model in models.values():
        for _ in range(2):
            model.predict(batch)
    torch.cuda.synchronize()
    iters = 3
    rates = {False: [], True: []}
    outs = {}
    zero_launches()
    for fused in SINGLE_TURNS:
        before = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"]
        tails_before = fused_conv1x1_bn_add_relu.launches
        t0 = time.perf_counter()
        for _ in range(iters):
            outs[fused] = models[fused].predict(batch)
        torch.cuda.synchronize()
        rates[fused].append(b * iters / (time.perf_counter() - t0))
        tails = fused_conv1x1_bn_add_relu.launches - tails_before
        hopper = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"] - before
        if tails != (spec["tails"] * iters if fused else 0) or hopper != tails:
            raise AssertionError(f"{name}: {tails} fused tails ({hopper} on the wgmma path) in "
                                 f"{iters} predicts with the switch {'on' if fused else 'off'}")
    launches = read_launches()
    calls = len(SINGLE_TURNS) * iters
    for kernel, per in spec["predict"].items():
        if launches[kernel] != per * calls:
            raise AssertionError(f"{name}: {launches[kernel]} {kernel} launches in {calls} "
                                 f"predicts, expected {per} per predict")
    for fused, out in outs.items():
        check_outputs(cfg, out, batch, b, h, w, f"{name} fused tail {'on' if fused else 'off'}",
                      mask_size=spec["mask_size"], phase="single    ")
    timing = {}
    for fused in (False, True):
        device_ms, wall_ms, idle, _ = profile_predict.device_time(
            lambda: models[fused].predict(batch), 3, host_ops=False)
        timing[fused] = (device_ms, idle)
    log(f"single     {name} predict {''.join('N' if f else 'F' for f in SINGLE_TURNS)}, "
        f"{iters} runs each, batch {b} at {h}x{w} bf16: off {np.median(rates[False]):.2f} img/s "
        f"(windows {', '.join(f'{r:.2f}' for r in rates[False])}), on "
        f"{np.median(rates[True]):.2f} img/s (windows "
        f"{', '.join(f'{r:.2f}' for r in rates[True])}); device ms per predict under the "
        f"profiler off {timing[False][0]:.2f} (idle share {timing[False][1]:.3f}), on "
        f"{timing[True][0]:.2f} (idle share {timing[True][1]:.3f}); launches {launches}, "
        f"{spec['tails']} fused tails per predict with the switch on")
    del models
    torch.cuda.empty_cache()
    return launches


def train_single_level(dev, name: str):
    """``name``'s YAML (bf16, float32 parameters, seeded random weights,
    switch off) on a seeded 8 x 800 x 1344 batch: 2 warm-up steps and 3 timed
    ones; launches per step asserted, losses finite, the frozen stem and
    res2 bit-equal, every trainable parameter moved (the C4 head's res5
    too). Returns the timed steps' launches."""
    spec = SINGLE_LEVEL[name]
    cfg = single_level_cfg(name, batch=8)
    b, h, w = 8, 800, 1344
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(cfg, h, w).items()}
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED),
                        training=True)
    start = {n: p.detach().clone() for n, p in model.named_parameters()}
    state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(SEED))
    step = build_train_step(cfg, state)
    metrics = [step(batch) for _ in range(2)]
    torch.cuda.synchronize()
    iters = 3
    zero_launches()
    t0 = time.perf_counter()
    for _ in range(iters):
        metrics.append(step(batch))
    torch.cuda.synchronize()
    img_s = b * iters / (time.perf_counter() - t0)
    launches = read_launches()
    for kernel, per in spec["step"].items():
        if launches[kernel] != per * iters:
            raise AssertionError(f"{name}: {launches[kernel]} {kernel} launches in {iters} "
                                 f"steps, expected {per} per step")
    if launches["fused_residual"]:
        raise AssertionError(f"{name}: fused tails with the switch off")
    device_ms, _, idle, _ = profile_predict.device_time(lambda: step(batch), 2, host_ops=False)
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"{name}: non-finite losses: {values}")
    trainable = trainable_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
    frozen = [n for n, _ in model.named_parameters() if n not in trainable]
    params = dict(model.named_parameters())
    if not frozen or any(not n.startswith(("backbone.stem.", "backbone.res2.")) for n in frozen):
        raise AssertionError(f"{name}: unexpected frozen parameters {frozen}")
    changed_frozen = [n for n in frozen if not torch.equal(params[n], start[n])]
    unchanged = [n for n, p in trainable.items() if torch.equal(p.detach(), start[n])]
    head = [n for n in trainable if n.startswith("roi_heads.res5.")]
    if changed_frozen or unchanged or (name == "c4") != bool(head):
        raise AssertionError(f"{name}: frozen parameters changed: {changed_frozen}; trainable "
                             f"unchanged: {unchanged}; head res5 parameters {len(head)}")
    log(f"single     {name} train {iters} steps of batch {b} at {h}x{w} bf16: {img_s:.2f} img/s "
        f"(host clock), device ms per step under the profiler {device_ms:.2f} (idle share "
        f"{idle:.3f}), peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.1f} GiB; "
        f"launches {launches}; first " + ", ".join(f"{k} {v:.4f}" for k, v in values[0].items())
        + f"; last total_loss {values[-1]['total_loss']:.4f}; {len(frozen)} frozen parameters "
          f"bit-equal, all {len(trainable)} trainable parameters changed ({len(head)} of the "
          f"head's res5)")
    del model, state, step
    torch.cuda.empty_cache()
    return launches


OVERFIT_STEPS = {"c4": 1200, "rcnn": 600, "cls_agnostic": 600, "retinanet": 600, "cascade": 600,
                 "keypoint": 600, "semantic": 600, "dconv": 600, "solov2": 600, "yolov4": 600,
                 "relation": 800}
# Each gate runs once per seed here (0 where none is listed), and every check
# reads the mean over its runs. The relation gate (the learned duplicate
# removal on) needs several: a run lags in some draws, missing whole objects
# (tools.overfit_check on an H100 80GB HBM3 at 700 W, PERF.md section 6: at
# 600 steps seed 0 read bbox AP 23.49-75.91 over 20 runs, 11 below the
# bound). The mean over seeds 0-3 read 59.35-80.23 at 600 in five runs, one
# below; over seeds 0-5 72.44-77.01, AP50 93.33-97.39, in three. So six
# seeds, and 800 steps for the AP50 (94.65-99.15 over seeds 0-3 at 1200),
# the AP held at 600 as c4's.
OVERFIT_SEEDS = {"relation": (0, 1, 2, 3, 4, 5)}


def yield_cpu() -> None:
    """In a gate's child process: a lower CPU priority (nice 10, this
    script's own processes only), so that the phases running meanwhile keep
    their core."""
    os.nice(10)


# The gate subprocesses started; any still running when the script exits is
# killed (a failing phase does not wait for them).
CHILDREN = []


def start_overfit_gates(pano_root: str):
    """Start ``tools.overfit_check`` on c4 (1200 steps, evaluated at 600 as
    well), rcnn, (phase 10's family) cls_agnostic, (phase 11's) retinanet
    and cascade, (phase 12's) keypoint, (phase 13's) semantic, (phase 14's)
    dconv, (phase 15's) solov2 and (phase 16's) yolov4 (600 each) and
    (phase 17's) relation (800, evaluated at 600 as well), each once per
    seed of OVERFIT_SEEDS, and ``tools.workflow_check_panoptic`` into
    ``pano_root``, as subprocesses at once (each is host-bound, and yields
    its CPU to this process); :func:`finish_overfit_gates` reads them."""
    procs = {"panoptic": subprocess.Popen(
        [sys.executable, "-m", "detectron2_tensorflow_tpu_torch.tools.workflow_check_panoptic",
         pano_root], cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        preexec_fn=yield_cpu)}
    for arch, steps in OVERFIT_STEPS.items():
        for seed in OVERFIT_SEEDS.get(arch, (0,)):
            cmd = [sys.executable, "-m", "detectron2_tensorflow_tpu_torch.tools.overfit_check",
                   str(steps), "--arch", arch, "--seed", str(seed)]
            if steps > OVERFIT_JAX_STEPS:
                cmd += ["--eval_at", str(OVERFIT_JAX_STEPS)]
            procs[arch, seed] = subprocess.Popen(cmd, cwd=ROOT, stdout=subprocess.PIPE,
                                                 stderr=subprocess.PIPE, text=True,
                                                 preexec_fn=yield_cpu)
    CHILDREN.extend(procs.values())
    return procs


def finish_overfit_gates(procs):
    """Wait for the gates and log each JSON line. Each family's check reads
    the mean over its seeds (OVERFIT_SEEDS): bbox AP50 >= 90 at the last
    step; c4's and relation's bbox AP at step 600, keypoint's keypoint
    AP, semantic's mIoU, solov2's segm AP and yolov4's bbox AP each no more
    than 10 below the JAX package's. Returns each family's means. The
    panoptic workflow is read apart (``finish_panoptic_workflow``)."""
    lines = {}
    for (arch, seed), proc in procs.items():
        t0 = time.perf_counter()
        tag = f"{arch} --seed {seed}" if seed else arch
        out, err = proc.communicate(timeout=900)
        if proc.returncode:
            raise AssertionError(f"overfit_check --arch {tag} exited {proc.returncode}: "
                                 f"{err[-2000:]}")
        runs = [json.loads(ln) for ln in out.strip().splitlines() if ln.startswith("{")]
        lines.setdefault(arch, []).append({r["steps"]: r for r in runs})
        found, listed = [], []  # each evaluation's summary and the misses and false boxes before it
        for ln in err.splitlines():
            if ln.startswith(("MISS", "FALSE")):
                listed.append(ln)
            elif ln.startswith("instances found"):
                found.append((ln, listed))
                listed = []
        if arch == "semantic":  # no instances to list
            log(f"gates      overfit_check {OVERFIT_STEPS[arch]} --arch semantic: "
                f"{json.dumps(runs[-1])} (waited {time.perf_counter() - t0:.1f} s)")
        for r, (f, listed) in zip(runs, found[-len(runs):]):
            log(f"gates      overfit_check {r['steps']} --arch {tag}: {json.dumps(r)}; {f} "
                f"(waited {time.perf_counter() - t0:.1f} s)")
            for ln in listed:
                log(f"gates        {ln}")
    mean = {arch: {steps: {k: float(np.mean([run[steps][k] for run in runs]))
                           if isinstance(v, (int, float)) else v
                           for k, v in runs[-1][steps].items() if k != "seed"}
                   for steps in runs[-1]}
            for arch, runs in lines.items()}
    for arch, seeds in OVERFIT_SEEDS.items():
        log(f"gates      {arch} over seeds {seeds}, the mean: " + "; ".join(
            f"at step {steps} bbox AP {m['bbox_ap']:.2f}, AP50 {m['bbox_ap50']:.2f}"
            for steps, m in sorted(mean[arch].items())))
    sem = mean.pop("semantic")[OVERFIT_STEPS["semantic"]]
    if not sem["miou"] >= OVERFIT_JAX_SEMANTIC_MIOU - OVERFIT_AP_BELOW:
        raise AssertionError(f"overfit --arch semantic: mIoU {sem['miou']} more than "
                             f"{OVERFIT_AP_BELOW} below the JAX package's "
                             f"{OVERFIT_JAX_SEMANTIC_MIOU}")
    last = {arch: m[OVERFIT_STEPS[arch]] for arch, m in mean.items()}
    for arch, m in last.items():
        if not m["bbox_ap50"] >= OVERFIT_AP50:
            raise AssertionError(f"overfit --arch {arch}: bbox AP50 {m['bbox_ap50']} < "
                                 f"{OVERFIT_AP50} at step {OVERFIT_STEPS[arch]}")
    held = {"c4": (OVERFIT_JAX_STEPS, "bbox_ap", OVERFIT_JAX_C4_BBOX_AP),
            "relation": (OVERFIT_JAX_STEPS, "bbox_ap", OVERFIT_JAX_RELATION_BBOX_AP),
            "keypoint": (OVERFIT_STEPS["keypoint"], "keypoints_ap", OVERFIT_JAX_KEYPOINT_AP),
            "solov2": (OVERFIT_STEPS["solov2"], "segm_ap", OVERFIT_JAX_SOLOV2_SEGM_AP),
            "yolov4": (OVERFIT_STEPS["yolov4"], "bbox_ap", OVERFIT_JAX_YOLOV4_BBOX_AP)}
    for arch, (steps, key, jax_value) in held.items():
        got = mean[arch][steps].get(key, -1.0)
        if not got >= jax_value - OVERFIT_AP_BELOW:
            raise AssertionError(f"overfit --arch {arch}: {key} {got} at step {steps} more "
                                 f"than {OVERFIT_AP_BELOW} below the JAX package's {jax_value}")
    dc = last["dconv"]  # the deformable convs learned: every offset conv left its zero
    if not 0 < dc.get("conv_offsets_moved", 0) == dc.get("conv_offsets"):
        raise AssertionError(f"overfit --arch dconv: {dc.get('conv_offsets_moved')} of "
                             f"{dc.get('conv_offsets')} offset convs moved from zero")
    return {**last, "semantic": sem}


def finish_panoptic_workflow(proc) -> None:
    """Wait for ``tools.workflow_check_panoptic``: it must exit 0 (its
    ``tools.eval`` passed ``TEST.EXPECTED_RESULTS``); its metrics, final
    losses, launches and step seconds are logged."""
    t0 = time.perf_counter()
    out, _ = proc.communicate(timeout=900)
    if proc.returncode or "PANOPTIC WORKFLOW CHECK PASSED" not in out:
        raise AssertionError(f"workflow_check_panoptic exited {proc.returncode}: {out[-3000:]}")
    summary = workflow_check.train_summary(out)
    metrics = workflow_check.eval_metrics(out)
    log(f"gates      workflow_check_panoptic {workflow_check_panoptic.CFG}: PanopticFPN R18-FPN "
        f"GN, from scratch, {summary['steps']} iterations of 8 x 192x256 float32 from coco_pano "
        f"records, then tools.eval on the train split with TEST.EXPECTED_RESULTS "
        f"{workflow_check_panoptic.EXPECTED}: passed (waited {time.perf_counter() - t0:.1f} s)")
    log("gates      workflow_check_panoptic " + ", ".join(
        f"{k} {metrics[k]:.3f}" for k in ("bbox/AP", "bbox/AP50", "sem_seg/mIoU", "sem_seg/mACC",
                                           "panoptic/PQ", "panoptic/PQ_th", "panoptic/PQ_st")))
    log(f"gates      workflow_check_panoptic train seconds {summary['seconds']:.2f} "
        f"({summary['seconds_per_iteration']:.4f} s per iteration), final loss " + ", ".join(
            f"{k} {v:.4f}" for k, v in summary["final_losses"].items())
        + f"; launches {summary['launches']}")


def single_level_lines(single):
    """The ``kernels`` line's entries of phase 9's shapes, each named
    ``<kernel>@<case>``; ``launches`` counts the kernel in the single-level
    run that has the shape (C4's or DC5's serving, or their training)."""
    s, t = single["serving"], single["training"]
    nms_src = tpu_kernel("*/ops/pallas/nms_keep.py", 161)
    fwd_src = tpu_kernel("*/ops/pallas/roi_patch.py", 667)
    bwd_src = tpu_kernel("*/ops/pallas/roi_patch.py", 440)
    fused_src = tpu_kernel("*/ops/pallas/fused_residual.py", 118)
    rows = [("nms_keep", NMS_SRC, nms_src, s["c4"]["nms_keep"] + s["dc5"]["nms_keep"], r)
            for r in single["nms"][:1]]
    rows += [("nms_keep", NMS_SRC, nms_src, t["c4"]["nms_keep"] + t["dc5"]["nms_keep"], r)
             for r in single["nms"][1:]]
    launches = [s["c4"]["roi_patch_fwd"]] * 2 + [s["dc5"]["roi_patch_fwd"]] * 2
    rows += [("roi_patch_fwd", ROI_SRC, fwd_src, n, r) for n, r in zip(launches, single["roi"])]
    launches = [t["c4"]["roi_patch_bwd"]] + [t["dc5"]["roi_patch_bwd"]] * 2
    rows += [("roi_patch_bwd", ROI_SRC, bwd_src, n, r) for n, r in zip(launches, single["bwd"])]
    rows += [("fused_residual", FUSED_SRC, fused_src, s[name]["fused_residual"], r)
             for name, r in zip(("c4", "dc5"), single["fused"])]
    return [kernel_line(f"{kernel}@{r['case'].replace(' ', '_')}", src, replaces, n, r, r["err"])
            for kernel, src, replaces, n, r in rows]


def check_single_level_kernels(rng, dev):
    """Phase 9's kernel shapes (run with the other later phases' kernel
    checks, :func:`check_later_kernels`)."""
    out = {"nms": check_single_level_nms(rng, dev), "roi": check_single_level_roi(rng, dev),
           "bwd": check_single_level_roi_bwd(rng, dev),
           "fused": check_single_level_fused(rng, dev)}
    torch.cuda.empty_cache()
    return out


def run_single_level(rng, dev, kernels_):
    """Phase 9: the C4 and DC5 families on the single-level kernels' shapes
    (``kernels_``, checked earlier), served and trained at full width, held
    against the CPU at narrow width (their overfit gates run beside it).
    Returns the kernel results and launch counts."""
    for name in SINGLE_LEVEL:
        for on in (False, True):
            check_small_against_cpu(rng, dev, on, single_level_cfg(name, narrow=True),
                                    label=f"single     {name}")
        check_train_against_cpu(dev, False, single_level_cfg(name, narrow=True, batch=2),
                                label=f"single     {name}")
    serving = {name: serve_single_level(rng, dev, name) for name in SINGLE_LEVEL}
    training = {name: train_single_level(dev, name) for name in SINGLE_LEVEL}
    return {**kernels_, "serving": serving, "training": training}

# -- phase 10: two_stage --------------------------------------------------------

RPN_FPN_YAML = "configs/COCO-Detection/rpn_R_50_FPN_1x.yaml"
RPN_C4_YAML = "configs/COCO-Detection/rpn_R_50_C4_1x.yaml"
FAST_YAML = "configs/COCO-Detection/fast_rcnn_R_50_FPN_1x.yaml"
GN_YAML = "configs/Misc/mask_rcnn_R_50_FPN_3x_gn.yaml"
SYNCBN_YAML = "configs/Misc/mask_rcnn_R_50_FPN_3x_syncbn.yaml"
# Launches of each kernel per predict and per train step (the JAX trace's
# counts): the ProposalNetwork's one RPN NMS and no pooling, and no kernel in
# its step (RPN losses only); Fast R-CNN's box head NMS and box pooling; the
# GN and SyncBN Mask R-CNNs as R50-FPN's.
TWO_STAGE = {
    "rpn_fpn": {"yaml": RPN_FPN_YAML, "predict": {"nms_keep": 1, "roi_patch_fwd": 0},
                "step": {"nms_keep": 0, "roi_patch_fwd": 0, "roi_patch_bwd": 0}},
    "rpn_c4": {"yaml": RPN_C4_YAML, "predict": {"nms_keep": 1, "roi_patch_fwd": 0},
               "step": {"nms_keep": 0, "roi_patch_fwd": 0, "roi_patch_bwd": 0}},
    "fast_rcnn": {"yaml": FAST_YAML, "predict": {"nms_keep": 1, "roi_patch_fwd": 1},
                  "step": {"nms_keep": 0, "roi_patch_fwd": 1, "roi_patch_bwd": 1}},
    "gn": {"yaml": GN_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 2},
           "step": {"nms_keep": 1, "roi_patch_fwd": 2, "roi_patch_bwd": 2}},
    "syncbn": {"yaml": SYNCBN_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 2},
               "step": {"nms_keep": 1, "roi_patch_fwd": 2, "roi_patch_bwd": 2}},
}
# Narrow widths of the normed models: multiples of 32, which GN's groups divide.
NORM_NARROW = {"STEM_OUT_CHANNELS": 32, "RES2_OUT_CHANNELS": 128, "WIDTH_PER_GROUP": 32}
# The normed models' gradients held card against CPU: those no normalized
# layer's backward separates from the loss (tests/test_torch_norms.py HELD).
NORMED_HELD = ("roi_heads.box_head.fc", "roi_heads.box_predictor.",
               "roi_heads.mask_head.predictor.")
TWO_STAGE_STEPS = 3
PRECISE_BN_BATCHES = 4


def two_stage_cfg(name: str, narrow: bool = False, batch: int = 0):
    """``name``'s YAML (phase 10's or a later one's) as ``single_level_cfg``
    shapes it: bf16 at full width (``SCORE_THRESH_TEST`` 0, the ROI heads',
    RetinaNet's, SOLOv2's, with SOLOv2's ``UPDATE_SCORE_THRESH_TEST``, and
    YOLOv4's) or narrow float32, ``batch`` > 0 for training."""
    cfg = get_cfg()
    cfg.merge_from_file(str(ROOT / SPECS[name]["yaml"]))
    cfg.merge_from_list(list(SPECS[name].get("opts", ())))
    cfg.MODEL.DTYPE = "bfloat16"
    cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.RETINANET.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.SOLO.SCORE_THRESH_TEST = 0.0
    cfg.MODEL.SOLO.UPDATE_SCORE_THRESH_TEST = 0.0
    cfg.MODEL.YOLOV4.SCORE_THRESH_TEST = 0.0
    if narrow:
        for k, v in (NORM_NARROW if name in ("gn", "syncbn") else NARROW).items():
            cfg.MODEL.RESNETS[k] = v
        cfg.MODEL.NECK.OUT_CHANNELS = 32
        cfg.MODEL.ROI_BOX_HEAD.CONV_DIM = 32
        cfg.MODEL.ROI_BOX_HEAD.FC_DIM = 64
        cfg.MODEL.ROI_MASK_HEAD.CONV_DIM = 32
        cfg.MODEL.ROI_KEYPOINT_HEAD.CONV_DIMS = (32,) * 8
        cfg.MODEL.SEM_SEG_HEAD.CONVS_DIM = 32
        cfg.MODEL.YOLOV4.CONV_DIMS = 32
        cfg.MODEL.ROI_HEADS.NUM_CLASSES = 5
        cfg.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES = 5
        cfg.MODEL.DTYPE = "float32"
        cfg.MODEL.ROI_HEADS.SCORE_THRESH_TEST = 0.05
        cfg.MODEL.RETINANET.SCORE_THRESH_TEST = 0.05
        cfg.MODEL.YOLOV4.SCORE_THRESH_TEST = 0.05
        cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN = 64
        cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST = 64
    if batch:
        cfg.SOLVER.IMS_PER_BATCH = batch
        cfg.SOLVER.AUTO_SCALE_LR_SCHEDULE = False
        cfg.INPUT.MAX_GT_INSTANCES = 5 if narrow else 64
    return cfg


def check_new_nms_shape(rng, dev):
    """``nms_keep`` bit-equal at ``rpn_R_50_C4_1x``'s serving shape: 2
    images x one level of 6000 candidates, ``max_keep`` 2000."""
    boxes, valid = clustered_boxes(rng, 2, 6000, objects=600)
    return nms_case(dev, "rpn one level 2x6000 iou=0.7 max_keep=2000", boxes, valid, 0.7, 2000,
                    plain=greedy_keep_reference_rows, reps=20, tag="two_stage  nms_keep")


def check_proposals_small(rng, dev, cfg, label):
    """A narrow float32 ProposalNetwork on a 2 x 128 x 160 input, card
    against CPU, as sets (proposals whose logits lie within rounding trade
    top-k slots): equal valid counts, every valid proposal of each side
    within ``SMALL_TOL`` (boxes, scores) of one of the other's."""
    cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu_model = build_model(cfg, device=dev, state_dict=cpu_model.state_dict())
    image = rng.uniform(0, 255, (2, 128, 160, 3)).astype(np.float32)
    batch = {"image": torch.from_numpy(image),
             "image_size": torch.from_numpy(np.array([[128, 160], [112, 150]], np.int32))}
    want = cpu_model.predict(batch).get_fields()
    got = {k: v.cpu() for k, v in gpu_model.predict(
        {k: v.to(dev) for k, v in batch.items()}).get_fields().items()}
    worst = 0.0
    for i in range(2):
        if int(got["is_valid"][i].sum()) != int(want["is_valid"][i].sum()):
            raise AssertionError(f"{label}: valid proposals differ between the card and the CPU")
        for a, b in ((got, want), (want, got)):
            va, vb = a["is_valid"][i], b["is_valid"][i]
            dist = (a["boxes"][i][va][:, None] - b["boxes"][i][vb][None]).abs().amax(-1)
            close = (a["scores"][i][va][:, None] - b["scores"][i][vb][None]).abs() \
                <= SMALL_TOL["scores"]
            best = torch.where(close, dist, torch.full_like(dist, float("inf"))).amin(1)
            worst = max(worst, float(best.max()))
            if not worst <= SMALL_TOL["boxes"]:
                raise AssertionError(f"{label}: a proposal has no counterpart within "
                                     f"{SMALL_TOL['boxes']} ({worst})")
    log(f"{label} small f32 input, card vs CPU: {int(want['is_valid'].sum())} valid proposals, "
        f"the same sets, worst box distance to the counterpart {worst:.3g}")


def check_two_stage_small(rng, dev):
    """Narrow float32 models and train steps of the four configs, card against CPU."""
    for name in ("rpn_fpn", "rpn_c4"):
        check_proposals_small(rng, dev, two_stage_cfg(name, narrow=True), f"two_stage  {name}")
        check_train_against_cpu(dev, False, two_stage_cfg(name, narrow=True, batch=2),
                                label=f"two_stage  {name}")
    for name in ("fast_rcnn", "gn", "syncbn"):
        check_small_against_cpu(rng, dev, False, two_stage_cfg(name, narrow=True),
                                label=f"two_stage  {name}")
        check_train_against_cpu(dev, False, two_stage_cfg(name, narrow=True, batch=2),
                                label=f"two_stage  {name}",
                                held=NORMED_HELD if name in ("gn", "syncbn") else None)


def serving_batch(rng, dev, b=2, h=800, w=1344, content=(800, 1333)):
    """``b`` random images in an ``h`` x ``w`` bucket, each ``content`` (h, w)
    of it an image's."""
    image = torch.from_numpy(rng.uniform(0, 255, (b, h, w, 3)).astype(np.float32)).to(dev)
    return {"image": image,
            "image_size": torch.tensor([list(content)] * b, dtype=torch.int32, device=dev)}


def check_proposal_outputs(cfg, out, b: int, label: str) -> str:
    """A ProposalNetwork's ``predict``: ``POST_NMS_TOPK_TEST`` slots per image,
    finite, clipped boxes, class 0; returns the valid counts."""
    f = out.get_fields()
    k = cfg.MODEL.RPN.POST_NMS_TOPK_TEST
    if tuple(f["boxes"].shape) != (b, k, 4) or tuple(f["scores"].shape) != (b, k):
        raise AssertionError(f"{label}: proposal slots {tuple(f['boxes'].shape)}, expected "
                             f"({b}, {k}, 4)")
    if not (bool(torch.isfinite(f["boxes"]).all()) and bool(torch.isfinite(f["scores"]).all())):
        raise AssertionError(f"{label}: non-finite proposals")
    bx = f["boxes"]
    if bool((bx < 0).any()) or bool((bx[..., 2] > 1333).any()) or bool((bx[..., 3] > 800).any()):
        raise AssertionError(f"{label}: proposals not clipped to the image")
    if bool((f["pred_classes"] != 0).any()) or not bool(f["is_valid"].any(1).all()):
        raise AssertionError(f"{label}: classes other than 0, or an image without proposals")
    return str(f["is_valid"].sum(1).tolist())


def serve_two_stage(rng, dev, name: str, turns=(False,), tag="two_stage ", check=None,
                    weights=None, probe_model=None):
    """``name``'s YAML (bf16, seeded random weights; ``SPECS[name]["opts"]``
    over it) serving 2 images at its
    first pad bucket (800 x 1344; YOLOv4's 608 x 608, ``profile_predict.serving_shape``),
    with the fused tail off and on in ``turns``: launches per ``predict``
    asserted (no fused tail but on FrozenBN trunks), outputs checked (by
    ``check(cfg, out, batch, label)`` when given), img/s and device ms per
    call with the idle share; ``probe_model(model, batch)`` then looks
    further into the first turn's model. ``weights``: a state dict in place
    of the seeded draw. Returns the launches."""
    spec = SPECS[name]
    cfg = two_stage_cfg(name)
    models = {}
    for fused in set(turns):
        with fused_switch(fused):
            models[fused] = build_model(cfg, generator=torch.Generator().manual_seed(SEED),
                                        state_dict=weights)
    b = 2
    (h, w), content = profile_predict.serving_shape(cfg)
    batch = serving_batch(rng, dev, b, h, w, content)
    for model in models.values():
        model.predict(batch)
    torch.cuda.synchronize()
    iters = 3
    rates = {f: [] for f in models}
    outs = {}
    zero_launches()
    for fused in turns:
        tails_before = fused_conv1x1_bn_add_relu.launches
        t0 = time.perf_counter()
        for _ in range(iters):
            outs[fused] = models[fused].predict(batch)
        torch.cuda.synchronize()
        rates[fused].append(b * iters / (time.perf_counter() - t0))
        tails = fused_conv1x1_bn_add_relu.launches - tails_before
        want_tails = bottleneck_tails(cfg) * iters if fused else 0
        if tails != want_tails:
            raise AssertionError(f"{name}: {tails} fused tails in {iters} predicts with the "
                                 f"switch {'on' if fused else 'off'}, expected {want_tails}")
    launches = read_launches()
    calls = len(turns) * iters
    for kernel, per in spec["predict"].items():
        if launches[kernel] != per * calls:
            raise AssertionError(f"{name}: {launches[kernel]} {kernel} launches in {calls} "
                                 f"predicts, expected {per} per predict")
    for fused, out in outs.items():
        label = f"{name} fused tail {'on' if fused else 'off'}"
        if isinstance(models[fused], ProposalNetwork):
            valid = check_proposal_outputs(cfg, out, b, label)
            log(f"{tag} {label}: {cfg.MODEL.RPN.POST_NMS_TOPK_TEST} proposal slots per "
                f"image, finite, clipped, class 0, valid per image {valid}")
        elif check is not None:
            check(cfg, out, batch, label)
        else:
            check_outputs(cfg, out, batch, b, h, w, label, phase=tag)
    timing = {f: profile_predict.device_time(lambda: models[f].predict(batch), 3,
                                             host_ops=False) for f in models}
    log(f"{tag} {name} predict, {iters} runs a turn ({''.join('N' if f else 'F' for f in turns)}), "
        f"batch {b} at {h}x{w} bf16: " + "; ".join(
            f"switch {'on' if f else 'off'} {np.median(rates[f]):.2f} img/s, device ms per "
            f"predict {timing[f][0]:.2f} (idle share {timing[f][2]:.3f})" for f in models)
        + f"; launches {launches}")
    if probe_model is not None:
        probe_model(models[turns[0]], batch)
    del models
    torch.cuda.empty_cache()
    return launches


def below_resolution(state, trainable, unchanged):
    """Of the ``unchanged`` trainable parameters, those whose last update was
    below float32's resolution with a nonzero momentum: at the warm-up's
    first learning rates a norm's scale of 1 takes updates of ~1e-8 against
    a spacing of 6e-8."""
    lr = state.optimizer.schedule(state.optimizer.count - 1)
    buffers = state.optimizer.sgd.state
    out = []
    for n in unchanged:
        step = float(buffers[trainable[n]]["momentum_buffer"].abs().max())
        if 0 < step and lr * step < (0.5 * torch.finfo(torch.float32).eps
                                     * float(trainable[n].detach().abs().max())):
            out.append(n)
    return out


def train_two_stage(rng, dev, name: str, tag="two_stage ", profile=False,
                    check_model=None):
    """``name``'s YAML (bf16, float32 parameters, seeded random weights) on a
    seeded 8 x 800 x 1344 batch: TWO_STAGE_STEPS steps, launches per step
    asserted, losses finite, the frozen stem and res2 parameters bit-equal,
    every trainable parameter moved; with BN every running statistic moved
    (the frozen stem's too), then ``precise_bn`` over PRECISE_BN_BATCHES
    batches and a served ``predict``; a RetinaNet's ``loss_normalizer``
    moved; with ``profile``, one more step under the profiler (device ms,
    idle share); ``check_model(model)`` checks the trained model last. Returns the
    steps' launches and the model's peak memory."""
    spec = SPECS[name]
    cfg = two_stage_cfg(name, batch=8)
    b = 8
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(cfg, 800, 1344).items()}
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED),
                        training=True)
    start = {n: p.detach().clone() for n, p in model.state_dict().items()}
    state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(SEED))
    step = build_train_step(cfg, state)
    zero_launches()
    t0 = time.perf_counter()
    metrics = [step(batch) for _ in range(TWO_STAGE_STEPS)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_launches()
    for kernel, per in spec["step"].items():
        if launches[kernel] != per * TWO_STAGE_STEPS:
            raise AssertionError(f"{name}: {launches[kernel]} {kernel} launches in "
                                 f"{TWO_STAGE_STEPS} steps, expected {per} per step")
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    if not all(np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"{name}: non-finite losses: {values}")
    if cfg.MODEL.META_ARCHITECTURE in PANOPTIC_ARCHS and (
            "loss_sem_seg" not in values[0] or not bool((batch["gt_sem_seg"] == -1).any())):
        raise AssertionError(f"{name}: no loss_sem_seg, or no ignored pixel in the GT")
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    trainable = trainable_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
    params = dict(model.named_parameters())
    frozen = [n for n in params if n not in trainable]
    changed_frozen = [n for n in frozen if not torch.equal(params[n], start[n])]
    unchanged = [n for n, p in trainable.items() if torch.equal(p.detach(), start[n])]
    rounded = below_resolution(state, trainable, unchanged)
    unchanged = [n for n in unchanged if n not in rounded and n not in ZERO_GRADS]
    if changed_frozen or unchanged or not frozen:
        raise AssertionError(f"{name}: frozen parameters changed: {changed_frozen}; trainable "
                             f"unchanged: {unchanged}")
    stats = {f"{m}.{b}": t for m, mod in model.named_modules() if isinstance(mod, BatchNorm2d)
             for b, t in mod.named_buffers()}
    still = [n for n, t in stats.items() if torch.equal(t, start[n])]
    if still or (name == "syncbn") != bool(stats):
        raise AssertionError(f"{name}: running statistics that did not move: {still}")
    normalizer = ""
    if "loss_normalizer" in start:
        norm = model.loss_normalizer
        if torch.equal(norm, start["loss_normalizer"]) or not bool(torch.isfinite(norm)):
            raise AssertionError(f"{name}: loss_normalizer {float(norm)} did not move")
        normalizer = (f", loss_normalizer {float(start['loss_normalizer']):.1f} -> "
                      f"{float(norm):.1f}")
    profiled = ""
    if profile:
        device_ms, _, idle, _ = profile_predict.device_time(lambda: step(batch), 1,
                                                            host_ops=False)
        profiled = f"; then device ms per step under the profiler {device_ms:.2f}, idle {idle:.3f}"
    log(f"{tag} {name} train {TWO_STAGE_STEPS} steps of batch {b} at 800x1344 bf16 in "
        f"{wall:.2f} s (the first step's set-up included{profiled}), peak memory {peak:.1f} GiB; "
        f"launches "
        f"{launches}; first " + ", ".join(f"{k} {v:.4f}" for k, v in values[0].items())
        + f"; last total_loss {values[-1]['total_loss']:.4f}; {len(frozen)} frozen parameters "
          f"bit-equal, all {len(trainable)} trainable parameters changed (or, {len(rounded)} "
          f"of them, took updates below float32's resolution at the warm-up's learning rate)"
        + (f", all {len(stats)} BN running statistics moved (the frozen stem's "
           f"{sum('stem.' in n for n in stats)} too)" if stats else "") + normalizer)
    if name == "syncbn":
        t0 = time.perf_counter()
        batches = [{"image": batch["image"][i:i + 2]} for i in range(0, 2 * PRECISE_BN_BATCHES, 2)]
        before = {n: t.clone() for n, t in stats.items()}
        used = precise_bn(model, batches, PRECISE_BN_BATCHES)
        torch.cuda.synchronize()
        after = stats
        moved = [n for n in after if not torch.equal(after[n], before[n])]
        heads = [n for n in moved if n.startswith("roi_heads.")]
        if used != PRECISE_BN_BATCHES or heads or len(moved) != sum(
                n.startswith("backbone.") for n in after):
            raise AssertionError(f"syncbn precise_bn: {used} batches, moved {len(moved)}, "
                                 f"heads {heads}")
        serve = serving_batch(rng, dev)
        out = model.predict(serve)
        check_outputs(cfg, out, serve, 2, 800, 1344, "syncbn after precise_bn",
                      phase="two_stage ")
        log(f"two_stage  syncbn precise_bn over {used} batches of 2 x 800x1344 in "
            f"{time.perf_counter() - t0:.2f} s: {len(moved)} trunk and FPN statistics "
            f"re-estimated, the ROI heads' kept; then a served predict (training model, "
            f"norms on their statistics)")
    if check_model is not None:
        check_model(model)
    del model, state, step
    torch.cuda.empty_cache()
    return launches, peak


def evaluate_proposals(dev, name: str):
    """``evaluate`` of ``name``'s ProposalNetwork (bf16, random weights) over
    8 synthetic 480x640 images: ``box_proposals/AR@100`` and ``AR@1000`` in
    [0, 100] (percent, as the JAX evaluator reports them)."""
    cfg = two_stage_cfg(name)
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    ds = SyntheticDataset(n=8, h=480, w=640, num_classes=3, box_range=(40, 200), first_id=100)
    t0 = time.perf_counter()
    metrics = evaluate(cfg, model, ds, build_dataloader(cfg, ds, training=False, batch_size=2))
    if set(metrics) != {"box_proposals/AR@100", "box_proposals/AR@1000"} or not all(
            0.0 <= v <= 100.0 for v in metrics.values()):
        raise AssertionError(f"{name} evaluate: {metrics}")
    log(f"two_stage  {name} evaluate over 8 synthetic images in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{k} {v:.3f}" for k, v in metrics.items()) + " (random weights)")


FAST_STEPS = 2
FAST_OPTS = ["MODEL.DTYPE", "bfloat16", "SOLVER.IMS_PER_GPU", "8",
             "SOLVER.SHORT_TERM_SAVE_STEPS", "2", "SOLVER.SHORT_TERM_NUM_STEPS", "4",
             "DATASETS.PROPOSAL_FILES_TRAIN", "('train_proposals.pkl',)",
             "DATASETS.PROPOSAL_FILES_TEST", "('val_proposals.pkl',)"]


def run_fast_rcnn_clis():
    """Fast R-CNN through the CLIs as subprocesses in a temporary directory:
    synthetic COCO (8 train, 4 val), a proposal pickle per split by the JAX
    test's recipe, ``tools.train`` FAST_STEPS steps at the YAML's 800x1344 bucket
    (launches from its summary line), ``tools.eval`` with the val
    proposals. Returns the train summary."""
    run_step = workflow_check.run_step
    spec = TWO_STAGE["fast_rcnn"]
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "fast_rcnn")
        common = ["--config_file", FAST_YAML, "DATASETS.ROOT_DIR", root,
                  "LOGS.ROOT_DIR", os.path.join(root, "logs"), *FAST_OPTS]
        t0 = time.perf_counter()
        run_step("make_synthetic_coco", [root, "8", "4"], echo=False)
        counts = [write_proposal_file(os.path.join(root, f"{split}.json"),
                                      os.path.join(root, f"{split}_proposals.pkl"), seed)
                  for split, seed in (("train", SEED), ("val", SEED + 1))]
        log(f"two_stage  fast_rcnn: 8 train + 4 val synthetic images and their proposal "
            f"pickles ({counts} images; 8 GT-jittered boxes per GT, sigma 2 px, scores "
            f"U(0, 10)) in {time.perf_counter() - t0:.2f} s")
        out = run_step("train", ["--max_iter", str(FAST_STEPS), *common], echo=False)
        summary = workflow_check.train_summary(out)
        want = {k: per * FAST_STEPS for k, per in spec["step"].items()}
        want["fused_residual"] = 0
        losses = summary["final_losses"] or {}
        if (summary["steps"] != FAST_STEPS or summary["launches"] != want
                or set(losses) != {"total_loss", "loss_cls", "loss_box_reg"}
                or not all(math.isfinite(v) for v in losses.values())):
            raise AssertionError(f"fast_rcnn tools.train: {summary}, expected launches {want}")
        log(f"two_stage  fast_rcnn tools.train {FAST_STEPS} steps of 8 at 800x1344 bf16 with "
            f"DATASETS.PROPOSAL_FILES_TRAIN in {summary['seconds']:.2f} s "
            f"({summary['seconds_per_iteration']:.3f} s per iteration, set-up and checkpoint "
            f"writes included), losses " + ", ".join(f"{k} {v:.4f}" for k, v in losses.items())
            + f"; launches {summary['launches']}")
        t0 = time.perf_counter()
        out = run_step("eval", common, echo=False)
        metrics = workflow_check.eval_metrics(out)
        if "bbox/AP" not in metrics or not all(math.isfinite(v) or math.isnan(v)
                                               for v in metrics.values()):
            raise AssertionError(f"fast_rcnn tools.eval: {metrics}")
        log(f"two_stage  fast_rcnn tools.eval with DATASETS.PROPOSAL_FILES_TEST in "
            f"{time.perf_counter() - t0:.2f} s (process included): bbox AP "
            f"{metrics['bbox/AP']:.3f}, AP50 {metrics['bbox/AP50']:.3f} (random weights, "
            f"{FAST_STEPS} steps)")
    return summary


def run_two_stage(rng, dev, nms):
    """Phase 10: the RPN-only, Fast R-CNN, GN and SyncBN models at full
    width (``nms``: the new NMS shape's result, checked earlier). Returns it
    and the launches that read it."""
    check_two_stage_small(rng, dev)
    serving, training, peaks = {}, {}, {}
    for name in ("rpn_fpn", "rpn_c4"):
        serving[name] = serve_two_stage(rng, dev, name)
        training[name], peaks[name] = train_two_stage(rng, dev, name)
        evaluate_proposals(dev, name)
    fast = run_fast_rcnn_clis()
    serving["gn"] = serve_two_stage(rng, dev, "gn", turns=(False, True))
    for name in ("gn", "syncbn"):
        training[name], peaks[name] = train_two_stage(rng, dev, name)
    log("two_stage  peak memory of the training runs (GiB): "
        + ", ".join(f"{k} {v:.1f}" for k, v in peaks.items()))
    return {"nms": nms, "serving": serving, "training": training, "fast": fast}


# -- phase 11: single_stage_cascade ------------------------------------------------

RETINA_YAML = "configs/COCO-Detection/retinanet_R_50_FPN_1x.yaml"
CASCADE_YAML = "configs/Misc/cascade_mask_rcnn_R_50_FPN_1x.yaml"
# Launches of each kernel per predict and per train step (the JAX trace's
# counts): RetinaNet's one class-aware NMS over its five levels' candidates
# and no pooling, no kernel in its step (dense assignment, no NMS); the
# cascade's RPN and final NMS, and three box pools plus the mask pool, each
# its own forward and, in training, backward (the JAX cascade fuses no pools).
SINGLE_STAGE_CASCADE = {
    "retinanet": {"yaml": RETINA_YAML, "predict": {"nms_keep": 1, "roi_patch_fwd": 0},
                  "step": {"nms_keep": 0, "roi_patch_fwd": 0, "roi_patch_bwd": 0}},
    "cascade": {"yaml": CASCADE_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 4},
                "step": {"nms_keep": 1, "roi_patch_fwd": 4, "roi_patch_bwd": 4}},
}
KEYPOINT_YAML = "configs/COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml"
# Keypoint R-CNN: the RPN's and the box head's NMS and two pools per predict
# (the proposals, the detections at the keypoint pooler's 14 x 14); per step
# the RPN's NMS and one fused pool of the box and keypoint ROIs.
KEYPOINT = {"keypoint": {"yaml": KEYPOINT_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 2},
                         "step": {"nms_keep": 1, "roi_patch_fwd": 2, "roi_patch_bwd": 2}}}
PANOPTIC_YAML = "configs/COCO-PanopticSegmentation/panoptic_fpn_R_50_1x.yaml"
SEMANTIC_YAML = "configs/COCO-SemanticSegmentation/semantic_R_50_FPN_1x.yaml"
# PanopticFPN: Mask R-CNN R50-FPN's launches (the RPN's and the box head's
# NMS, the box and mask pools per predict; per step the RPN's NMS and one
# fused pool of the box and mask ROIs); the SemanticSegmentor launches none.
PANOPTIC = {
    "panoptic": {"yaml": PANOPTIC_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 2},
                 "step": {"nms_keep": 1, "roi_patch_fwd": 2, "roi_patch_bwd": 2}},
    "semantic": {"yaml": SEMANTIC_YAML, "predict": {"nms_keep": 0, "roi_patch_fwd": 0},
                 "step": {"nms_keep": 0, "roi_patch_fwd": 0, "roi_patch_bwd": 0}},
}
SPECS = {**TWO_STAGE, **SINGLE_STAGE_CASCADE, **KEYPOINT, **PANOPTIC}
PANOPTIC_ARCHS = ("PanopticFPN", "SemanticSegmentor")
SSC = "ssc       "  # the phase's log tag


def check_retinanet_nms(rng, dev):
    """``nms_keep`` bit-equal at RetinaNet's serving shape: per image 5 levels
    x 1000 candidates shifted by ``class * (max coordinate + 1)`` over 80
    classes (up to ~1.06e5), IoU 0.5, ``max_keep`` 100."""
    boxes, valid = clustered_boxes(rng, 2, 5000, objects=300)
    boxes = class_offset(boxes, rng.integers(0, 80, (2, 5000)))
    return nms_case(dev, "retinanet class-offset 2x5000 iou=0.5 max_keep=100", boxes, valid,
                    0.5, 100, plain=greedy_keep_reference_rows, reps=20, tag=f"{SSC} nms_keep")


def spread_scores(model) -> None:
    """RetinaNet's classifier weights x100: the narrow model's logits then
    spread over several units, so that no two candidates at a level's top-k
    boundary sit closer than the card and the CPU round them."""
    with torch.no_grad():
        model.head.cls_score.weight.mul_(100.0)


def run_single_stage_cascade(rng, dev, nms):
    """Phase 11: RetinaNet and Cascade Mask R-CNN. The new ``nms_keep`` shape
    (``nms``, checked earlier); narrow float32 models and train steps card
    against CPU; each YAML served 2 x 800 x 1344 bf16 (switch off and on)
    and trained 3 steps at 8 x 800 x 1344, launches asserted. Returns the NMS
    result and the runs' launches."""
    for name, prepare in (("retinanet", spread_scores), ("cascade", None)):
        check_small_against_cpu(rng, dev, False, two_stage_cfg(name, narrow=True),
                                label=f"{SSC} {name}", prepare=prepare)
        check_train_against_cpu(dev, False, two_stage_cfg(name, narrow=True, batch=2),
                                label=f"{SSC} {name}")
    serving, training = {}, {}
    for name in SINGLE_STAGE_CASCADE:
        serving[name] = serve_two_stage(rng, dev, name, turns=(False, True), tag=SSC)
        training[name] = train_two_stage(rng, dev, name, tag=SSC, profile=True)
    return {"nms": nms, "serving": serving, "training": training}


# -- phase 12: keypoint ---------------------------------------------------------------

KP = "keypoint  "  # the phase's log tag


def check_keypoint_kernels(rng, dev):
    """The kernels at Keypoint R-CNN's new shapes: ``nms_keep`` bit-equal at
    its training RPN (8 images x 4 levels of 2000 and p6's 819 padded,
    ``max_keep`` 1500); ``roi_patch_fwd`` on the keypoint pooler's plan
    (sampling ratio 2, S = 14, C = 256) at serving's 2 x 100 and training's
    8 x 128, bf16 and float32; ``roi_patch_bwd`` on it at 8 x 128 (bf16 and
    float32 cotangents, boxes clustered on 12 objects)."""
    b, v = stacked_levels(rng, 8, 2000)
    nms = nms_case(dev, "train rpn stacked 8x(4x2000 + 819 padded) iou=0.7 max_keep=1500",
                   b, v, 0.7, 1500, reps=20, tag=f"{KP} nms_keep")
    fwd = []
    for images, n in ((2, 100), (8, 128)):
        for dtype in (torch.bfloat16, torch.float32):
            fwd.append(roi_fwd_case(f"keypoint ratio=2 S=14 {images}x{n}",
                                    *roi_inputs(rng, dev, dtype, n, 14, b=images, ratio=2),
                                    tag=f"{KP} roi_patch"))
    torch.cuda.empty_cache()
    storage, starts, wy, wx, valid = roi_inputs(rng, dev, torch.bfloat16, 128, 14, objects=12,
                                                b=8, ratio=2)
    shape = tuple(storage.shape)
    del storage
    bwd = []
    for dtype in (torch.bfloat16, torch.float32):
        g = card_normal(rng, (8, 128, 14, 14, 256), dev, dtype)
        bwd.append(roi_bwd_case("keypoint ratio=2 S=14 8x128", g, starts, wy, wx, valid, shape,
                                tag=f"{KP} roi_bwd  "))
    torch.cuda.empty_cache()
    return {"nms": nms, "fwd": fwd, "bwd": bwd}


def run_keypoint(rng, dev, kernels_):
    """Phase 12: Keypoint R-CNN R50-FPN. The kernels at its new shapes
    (``kernels_``, checked earlier); a narrow float32 model and train step
    card against CPU; the YAML served 2 x 800 x 1344 bf16 (switch off and
    on) and trained 3 steps at 8 x 800 x 1344, launches asserted. Returns
    the kernel results and the runs' launches."""
    check_small_against_cpu(rng, dev, False, two_stage_cfg("keypoint", narrow=True),
                            label=f"{KP} keypoint")
    check_train_against_cpu(dev, False, two_stage_cfg("keypoint", narrow=True, batch=2),
                            label=f"{KP} keypoint")
    serving = serve_two_stage(rng, dev, "keypoint", turns=(False, True), tag=KP)
    training, peak = train_two_stage(rng, dev, "keypoint", tag=KP, profile=True)
    return {**kernels_, "serving": serving, "training": training, "peak": peak}


def keypoint_lines(kp):
    """The ``kernels`` line's entries of phase 12's shapes (``<kernel>@keypoint_<case>``,
    ``keypoint`` once);
    ``launches`` counts the kernel in the Keypoint R-CNN run that has the
    shape (its training for the RPN's NMS, the 8 x 128 pools and the
    backward, its serving for the 2 x 100 pools)."""
    s, t = kp["serving"], kp["training"]
    rows = [("nms_keep", NMS_SRC, tpu_kernel("*/ops/pallas/nms_keep.py", 161), t["nms_keep"],
             kp["nms"])]
    rows += [("roi_patch_fwd", ROI_SRC, tpu_kernel("*/ops/pallas/roi_patch.py", 667),
              t["roi_patch_fwd"] if "8x128" in r["case"] else s["roi_patch_fwd"], r)
             for r in kp["fwd"]]
    rows += [("roi_patch_bwd", ROI_SRC, tpu_kernel("*/ops/pallas/roi_patch.py", 440),
              t["roi_patch_bwd"], r) for r in kp["bwd"]]
    return [kernel_line(f"{kernel}@{case_label('keypoint', r['case'])}", src, replaces, n, r,
                        r["err"]) for kernel, src, replaces, n, r in rows]


def case_label(phase: str, case: str) -> str:
    """``<phase>_<case>`` with spaces as underscores, the phase's name said
    once when the case already begins with it."""
    case = case.replace(" ", "_")
    return case if case.startswith(phase) else f"{phase}_{case}"


# -- phase 13: panoptic ---------------------------------------------------------------

PAN = "panoptic  "  # the phase's log tag
FUSION_RUNS = 3


def check_semantic_map(cfg, sem, batch) -> str:
    """A served ``sem_seg``: ``[2, 800, 1344]`` int64 labels in ``[0,
    NUM_CLASSES)``; ``sem_seg_postprocess`` keeps the image and zeroes the
    padding right of its 1333 columns. Returns the log's words."""
    k = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    if tuple(sem.shape) != (2, 800, 1344) or sem.dtype != torch.int64:
        raise AssertionError(f"sem_seg {tuple(sem.shape)} {sem.dtype}")
    lo, hi = int(sem.min()), int(sem.max())
    if lo < 0 or hi >= k:
        raise AssertionError(f"sem_seg labels in [{lo}, {hi}], outside [0, {k})")
    post = sem_seg_postprocess(cfg, sem, batch)
    if bool(post[:, :, 1333:].any()) or not torch.equal(post[:, :, :1333], sem[:, :, :1333]):
        raise AssertionError("sem_seg_postprocess did not zero the padding alone")
    return (f"sem_seg {tuple(sem.shape)} int64 in [{lo}, {hi}] of {k} classes "
            f"({len(torch.unique(sem))} used), postprocess zeroes the padding")


def check_fusion_table(pan, info) -> None:
    """The segment table matches the map: each image's nonzero ids are its
    valid segments, numbered from 1 without a gap."""
    for i in range(pan.shape[0]):
        ids = set(torch.unique(pan[i]).tolist()) - {0}
        valid = set(torch.nonzero(info["valid"][i]).flatten().tolist())
        if ids != valid or valid != set(range(1, len(valid) + 1)):
            raise AssertionError(f"fusion image {i}: map ids {sorted(ids)[:8]}..., valid segments "
                                 f"{sorted(valid)[:8]}...")


def check_panoptic_serving(cfg, out, batch, label) -> None:
    """``serve_two_stage``'s check of a PanopticFPN output: ``check_outputs``,
    the semantic map, then ``panoptic_fusion`` on it at the YAML's thresholds
    and with confidence 0 (every detection a candidate), each with its
    segment table held against its map and timed: wall ms per call around
    synchronized runs, device ms and idle share under the profiler."""
    check_outputs(cfg, out, batch, 2, 800, 1344, label, phase=PAN)
    words = check_semantic_map(cfg, out.sem_seg, batch)
    for conf in (cfg.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH, 0.0):
        fcfg = cfg.clone()
        fcfg.MODEL.PANOPTIC_FPN.COMBINE.INSTANCES_CONFIDENCE_THRESH = conf
        pan, info = panoptic_fusion(fcfg, out)
        check_fusion_table(pan, info)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(FUSION_RUNS):
            panoptic_fusion(fcfg, out)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / FUSION_RUNS * 1e3
        device_ms, _, idle, _ = profile_predict.device_time(lambda: panoptic_fusion(fcfg, out),
                                                            FUSION_RUNS, host_ops=False)
        valid, thing = info["valid"], info["is_thing"]
        words += (f"; panoptic_fusion at confidence {conf}: {int((valid & thing).sum())} thing "
                  f"and {int((valid & ~thing).sum())} stuff segments, table matches the map, "
                  f"wall {wall:.2f} ms per call, device {device_ms:.3f} ms (idle share "
                  f"{idle:.3f})")
    log(f"{PAN} {label}: {words}")


def check_semantic_serving(cfg, out, batch, label) -> None:
    """A served SemanticSegmentor: the semantic map, finite float32
    ``sem_seg_logits [2, 800, 1344, K]`` whose first maximum it is, and
    ``is_valid [2, 1]``."""
    words = check_semantic_map(cfg, out.sem_seg, batch)
    logits = out.sem_seg_logits
    k = cfg.MODEL.SEM_SEG_HEAD.NUM_CLASSES
    if (tuple(logits.shape) != (2, 800, 1344, k) or logits.dtype != torch.float32
            or not bool(torch.isfinite(logits).all())):
        raise AssertionError(f"sem_seg_logits {tuple(logits.shape)} {logits.dtype}")
    if not torch.equal(logits.argmax(-1), out.sem_seg) or tuple(out.is_valid.shape) != (2, 1):
        raise AssertionError("sem_seg is not the logits' argmax, or is_valid is not [2, 1]")
    log(f"{PAN} {label}: {words}; sem_seg_logits {tuple(logits.shape)} float32 finite, "
        f"sem_seg their argmax, is_valid {tuple(out.is_valid.shape)}")


def run_panoptic(rng, dev):
    """Phase 13: PanopticFPN and the SemanticSegmentor. Narrow float32 models
    and train steps card against CPU (the semantic outputs, the fusion of the
    same detections and map bit-equal); each YAML served 2 x 800 x 1344 bf16
    (switch off and on; PanopticFPN's output fused and timed) and trained 3
    steps at 8 x 800 x 1344 with ignored pixels in ``gt_sem_seg``, launches
    asserted."""
    for name in PANOPTIC:
        check_small_against_cpu(rng, dev, False, two_stage_cfg(name, narrow=True),
                                label=f"{PAN} {name}")
        check_train_against_cpu(dev, False, two_stage_cfg(name, narrow=True, batch=2),
                                label=f"{PAN} {name}")
    serve_two_stage(rng, dev, "panoptic", turns=(False, True), tag=PAN,
                    check=check_panoptic_serving)
    serve_two_stage(rng, dev, "semantic", turns=(False, True), tag=PAN,
                    check=check_semantic_serving)
    for name in PANOPTIC:
        train_two_stage(rng, dev, name, tag=PAN, profile=True)


# -- phase 14: dconv ------------------------------------------------------------------

DC = "dconv     "  # the phase's log tag
DCONV_R50_YAML = "configs/Misc/mask_rcnn_R_50_FPN_1x_dconv_c3-c5.yaml"
DCONV_X152_YAML = "configs/Misc/cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv.yaml"
DCONV_PANOPTIC_YAML = "configs/Misc/panoptic_fpn_R_101_dconv_cascade_gn_3x.yaml"
# Launches per predict and per step: R50-dconv's as R50-FPN's; the X152
# cascade's and the panoptic R101 cascade's as the cascade's (three box
# pools and the mask pool, each its own, forward and, in training, backward).
DCONV = {
    "dconv_r50": {"yaml": DCONV_R50_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 2},
                  "step": {"nms_keep": 1, "roi_patch_fwd": 2, "roi_patch_bwd": 2}},
    "dconv_x152": {"yaml": DCONV_X152_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 4},
                   "step": {"nms_keep": 1, "roi_patch_fwd": 4, "roi_patch_bwd": 4}},
    "dconv_panoptic": {"yaml": DCONV_PANOPTIC_YAML,
                       "predict": {"nms_keep": 2, "roi_patch_fwd": 4},
                       "step": {"nms_keep": 1, "roi_patch_fwd": 4, "roi_patch_bwd": 4}},
}
SPECS.update(DCONV)
# DeformConv2d on the card against the CPU (float32): R50's res3-res5 3x3s at
# batch 2 (800 x 1344), v1, and X152's first res3 block (stride 2, v2 with 2
# deformable groups, at a narrower 128 channels); within DEFORM_TOL of the
# output's largest magnitude (the card-against-CPU bound of the masks).
DEFORM_CASES = (("res3", 128, 100, 168, 1, False, 1), ("res4", 256, 50, 84, 1, False, 1),
                ("res5", 512, 25, 42, 1, False, 1), ("res3 stride 2 v2 dg=2", 128, 200, 336, 2,
                                                     True, 2))
DEFORM_TOL = 1e-4
# X152's four bottleneck tails (K = N, the 32x8d widths) at batch 2, 800 x 1344.
X152_TAILS = (("res2", 256, 200, 336), ("res3", 512, 100, 168), ("res4", 1024, 50, 84),
              ("res5", 2048, 25, 42))
X152_STEPS = 1
# The narrow TTA held card against CPU: three small scales and their flips.
TTA_SMALL = {"MIN_SIZES": (96, 128, 160), "MAX_SIZE": 400}


def check_deform_conv(rng, dev):
    """``DeformConv2d`` (float32) at each of DEFORM_CASES on the card against
    the CPU, same weights and input: a random offset conv (kernel std 0.05,
    bias uniform in [-3, 3]) so that samples fall between pixels and off
    the map; then its device ms per call in bf16 at that shape."""
    for label, c, h, w, stride, modulated, dg in DEFORM_CASES:
        layer = DeformConv2d(c, c, 3, stride=stride, deform_groups=dg, modulated=modulated)
        with torch.no_grad():
            layer.conv_offset.weight.copy_(torch.from_numpy(
                rng.normal(0, 0.05, tuple(layer.conv_offset.weight.shape)).astype(np.float32)))
            layer.conv_offset.bias.copy_(torch.from_numpy(
                rng.uniform(-3, 3, tuple(layer.conv_offset.bias.shape)).astype(np.float32)))
        x = torch.from_numpy(rng.standard_normal((2, h, w, c)).astype(np.float32)).permute(
            0, 3, 1, 2)
        with torch.no_grad():
            want = layer(x)
            card = layer.to(dev)
            xd = x.to(dev).contiguous(memory_format=torch.channels_last)
            got = card(xd).cpu()
            field = card.offset_field(xd)
        err = float((got - want).abs().max())
        scale = float(want.abs().max())
        if not err <= DEFORM_TOL * scale:
            raise AssertionError(f"DeformConv2d {label}: max |err| {err} > {DEFORM_TOL} of "
                                 f"{scale}")
        off = field[:, :18 * dg].float()
        between = float(((off - off.round()).abs() > 0.05).float().mean())
        card = card.to(torch.bfloat16)
        xb = xd.to(torch.bfloat16)
        with torch.no_grad():
            ms = cuda_ms(lambda: card(xb), reps=10)
        log(f"{DC} DeformConv2d {label} C={c} {h}x{w} batch 2 f32 card vs CPU: max|err| "
            f"{err:.3g} (of {scale:.3g}), {between:.1%} of the offsets between pixels; bf16 "
            f"{ms:.3f} ms per call on the card")


def check_dconv_kernels(rng, dev):
    """The kernels at the slice's new shapes against their plain versions,
    timed beside their bounds: ``fused_residual`` at X152's four tails at
    batch 2 (``wgmma`` path); ``nms_keep`` bit-equal at the TTA merge (one
    image, 18 x 100 class-offset candidates over 80 classes, IoU 0.5,
    ``max_keep`` 100); ``roi_patch_fwd`` on the largest TTA plane (one 1280 x
    2048 image, the box pool's 1000 at S = 7) and at the input's own size
    (the mask pool of ``predict_with_boxes``, 100 at S = 14), bf16."""
    fused = [fused_case(rng, dev, f"x152 {st} b2 M={2 * h * w} K={k} N={k}", torch.bfloat16,
                        (2, h, w, k, k), wgmma=True, tag=f"{DC} fused_res")
             for st, k, h, w in X152_TAILS]
    torch.cuda.empty_cache()
    boxes, valid = clustered_boxes(rng, 1, 1800, objects=120)
    boxes = class_offset(boxes, rng.integers(0, 80, (1, 1800)))
    nms = nms_case(dev, "tta merge 1x(18x100) class-offset iou=0.5 max_keep=100", boxes, valid,
                   0.5, 100, plain=greedy_keep_reference_rows, reps=20, tag=f"{DC} nms_keep")
    roi = [roi_fwd_case("tta plane 1280x2048 box N=1000 S=7",
                        *roi_inputs(rng, dev, torch.bfloat16, 1000, 7, b=1, size=(1280, 2048)),
                        tag=f"{DC} roi_patch"),
           roi_fwd_case("predict_with_boxes 800x1344 mask N=100 S=14",
                        *roi_inputs(rng, dev, torch.bfloat16, 100, 14, b=1),
                        tag=f"{DC} roi_patch")]
    torch.cuda.empty_cache()
    return {"fused": fused, "nms": nms, "roi": roi}


def offset_gradients(model) -> None:
    """Every ``conv_offset`` of ``model`` has a finite, nonzero gradient (the
    last step's)."""
    grads = {n: p.grad for n, p in model.named_parameters() if ".conv_offset." in n}
    bad = [n for n, g in grads.items()
           if g is None or not bool(torch.isfinite(g).all()) or not bool(g.abs().max() > 0)]
    if bad or not grads:
        raise AssertionError(f"conv_offset gradients not finite and nonzero: {bad[:6]}")
    log(f"{DC} all {len(grads)} conv_offset gradients finite and nonzero (largest "
        f"{max(float(g.abs().max()) for g in grads.values()):.3g})")


def train_x152_remat(dev):
    """``cascade_mask_rcnn_X_152_32x8d_FPN_IN5k_gn_dconv`` (bf16) trained
    X152_STEPS steps at batch 2 with REMAT off, then on, from the same
    weights and batch: both peaks, REMAT's lower, the first step's losses
    equal; then at batch 8 with REMAT on, which must fit. Launches per step
    asserted. Returns the runs and the seeded weights (on the CPU)."""
    runs, weights = {}, None
    for remat, b in ((False, 2), (True, 2), (True, 8)):
        cfg = two_stage_cfg("dconv_x152", batch=b)
        cfg.MODEL.RESNETS.REMAT = remat
        batch = {k: torch.from_numpy(v).to(dev)
                 for k, v in make_train_batch(cfg, 800, 1344).items()}
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        # The first run's seeded weights for every run (drawing X152's 640M anew costs ~10 s).
        model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED),
                            state_dict=weights, training=True)
        if weights is None:
            weights = {k: v.cpu() for k, v in model.state_dict().items()}
        state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(SEED))
        step = build_train_step(cfg, state)
        zero_launches()
        t0 = time.perf_counter()
        values = [{k: float(v) for k, v in step(batch).items()} for _ in range(X152_STEPS)]
        wall = time.perf_counter() - t0
        launches = read_launches()
        for kernel, per in DCONV["dconv_x152"]["step"].items():
            if launches[kernel] != per * X152_STEPS:
                raise AssertionError(f"x152 remat={remat} b{b}: {launches[kernel]} {kernel} "
                                     f"launches in {X152_STEPS} steps, expected {per} per step")
        if not all(np.isfinite(v) for m in values for v in m.values()):
            raise AssertionError(f"x152 remat={remat} b{b}: non-finite losses {values}")
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        runs[(remat, b)] = {"peak": peak, "first": values[0], "wall": wall}
        log(f"{DC} dconv_x152 train REMAT {'on' if remat else 'off'}, {X152_STEPS} steps of batch "
            f"{b} at 800x1344 bf16 in {wall:.2f} s (the first's set-up included), peak memory "
            f"{peak:.2f} GiB; launches {launches}; first " + ", ".join(
                f"{k} {v:.5f}" for k, v in values[0].items()))
        del model, state, step, batch
    torch.cuda.empty_cache()
    off, on = runs[(False, 2)], runs[(True, 2)]
    if not on["peak"] < off["peak"]:
        raise AssertionError(f"x152: REMAT's peak {on['peak']:.2f} GiB is not below "
                             f"{off['peak']:.2f} GiB")
    worst = max(abs(on["first"][k] - v) / max(abs(v), 1e-12) for k, v in off["first"].items())
    if not worst <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"x152: REMAT changed the first step's losses by {worst:.3g}")
    log(f"{DC} dconv_x152 REMAT at batch 2: peak {off['peak']:.2f} -> {on['peak']:.2f} GiB, first "
        f"step's losses equal within {worst:.3g} relative; batch 8 with REMAT fits in "
        f"{runs[(True, 8)]['peak']:.2f} GiB")
    return runs, weights


def check_tta_small(rng, dev):
    """``tta_predict`` of the narrow float32 R50-dconv (TTA_SMALL's scales and
    flips, one 120 x 150 image in a 128 x 160 batch) on the card against the
    CPU, same weights: the merged slots held as ``check_small_against_cpu``
    holds detections (valid equal, ties matched, boxes, scores, masks)."""
    cfg = two_stage_cfg("dconv_r50", narrow=True)
    cfg.TEST.AUG.ENABLED = True
    cfg.TEST.AUG.MIN_SIZES, cfg.TEST.AUG.MAX_SIZE = TTA_SMALL["MIN_SIZES"], TTA_SMALL["MAX_SIZE"]
    cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    gpu_model = build_model(cfg, device=dev, state_dict=cpu_model.state_dict())
    image = np.zeros((1, 128, 160, 3), np.float32)
    image[0, :120, :150] = rng.uniform(0, 255, (120, 150, 3))
    batch = {"image": image, "image_size": np.array([[120, 150]], np.int32)}
    want = tta_predict(cfg, cpu_model, batch).get_fields()
    got = {k: v.cpu() for k, v in tta_predict(cfg, gpu_model, batch).get_fields().items()}
    if not torch.equal(got["is_valid"], want["is_valid"]):
        raise AssertionError("narrow tta_predict: valid slots differ between the card and the CPU")
    errs, swapped = hold_detections(got, want)
    log(f"{DC} narrow f32 tta_predict ({len(TTA_SMALL['MIN_SIZES'])} scales and flips), card vs "
        f"CPU: valid={int(want['is_valid'].sum())} slots equal, classes equal, {swapped} slots "
        f"matched across a score tie, max|err| " + ", ".join(f"{k} {v:.3g}"
                                                             for k, v in errs.items()))


def run_tta(rng, dev):
    """One 800 x 1333 image (in an 800 x 1344 batch) through ``tta_predict`` of
    ``mask_rcnn_R_50_FPN_1x_dconv_c3-c5`` (bf16, ``SCORE_THRESH_TEST`` 0) under
    the default ``TEST.AUG``: 9 scales and their flips in a 1280 x 2048
    bucket, merged, masks at the merged boxes. 100 valid finite clipped
    detections with masks; launches (2 per predict, and the merge's and
    ``predict_with_boxes``'s); host ms and device ms per image. Returns the
    launches."""
    cfg = two_stage_cfg("dconv_r50")
    cfg.TEST.AUG.ENABLED = True
    aug = cfg.TEST.AUG
    runs = len(aug.MIN_SIZES) * (2 if aug.FLIP else 1)
    model = build_model(cfg, generator=torch.Generator().manual_seed(SEED))
    batch = serving_batch(rng, dev, b=1)
    tta_predict(cfg, model, batch)  # warm-up: cuDNN's choices at the bucket's size
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    out = tta_predict(cfg, model, batch)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    want = {"nms_keep": 2 * runs + 1, "roi_patch_fwd": 2 * runs + 1}
    for kernel, n in want.items():
        if launches[kernel] != n:
            raise AssertionError(f"tta: {launches[kernel]} {kernel} launches, expected {n}")
    check_outputs(cfg, out, batch, 1, 800, 1344, "dconv_r50 tta", phase=DC)
    device_ms, wall_ms, idle, _ = profile_predict.device_time(
        lambda: tta_predict(cfg, model, batch), 1, host_ops=False)
    log(f"{DC} dconv_r50 tta_predict, {len(aug.MIN_SIZES)} scales {tuple(aug.MIN_SIZES)} and "
        f"flips in one 1280x2048 bucket, one 800x1333 image: host {host_ms:.1f} ms per image, "
        f"device {device_ms:.2f} ms (wall under the profiler {wall_ms:.1f} ms, idle share "
        f"{idle:.3f}); launches {launches}")
    del model
    torch.cuda.empty_cache()
    return launches


def check_later_kernels(rng, dev):
    """The kernel checks of phases 9-16 at their shapes, before phase 8
    starts the host-bound gates, whose processes would share the card with
    the timings."""
    return {"single_level": check_single_level_kernels(rng, dev),
            "two_stage": check_new_nms_shape(rng, dev),
            "single_stage_cascade": check_retinanet_nms(rng, dev),
            "keypoint": check_keypoint_kernels(rng, dev),
            "dconv": check_dconv_kernels(rng, dev), "deform": check_deform_conv(rng, dev),
            "yolov4": check_yolov4_nms(rng, dev)}


def run_dconv(rng, dev, kernels_):
    """Phase 14: deformable convolution, REMAT and TTA. ``DeformConv2d`` card
    against CPU and the kernels at the new shapes (``kernels_``, checked
    earlier); a narrow float32 R50-dconv
    model, train step and TTA card against CPU; ``mask_rcnn_R_50_FPN_1x_dconv_c3-c5``
    served 2 x 800 x 1344 (switch off and on) and trained at 8 x 800 x 1344
    (every offset conv's gradient finite and nonzero); the X152-dconv
    cascade served at batch 2 (switch on: its 50 tails fused) and trained
    with REMAT off and on; the panoptic R101-dconv cascade served at batch 2 and trained at
    batch 8; TTA at full width. Returns the kernel results and launches."""
    with phase_seconds("dconv.narrow"):
        check_small_against_cpu(rng, dev, False, two_stage_cfg("dconv_r50", narrow=True),
                                label=f"{DC} dconv_r50")
        check_train_against_cpu(dev, False, two_stage_cfg("dconv_r50", narrow=True, batch=2),
                                label=f"{DC} dconv_r50")
        check_tta_small(rng, dev)
    with phase_seconds("dconv.r50"):
        serving = {"dconv_r50": serve_two_stage(rng, dev, "dconv_r50", turns=(False, True),
                                                tag=DC)}
        train_two_stage(rng, dev, "dconv_r50", tag=DC, profile=True, check_model=offset_gradients)
    with phase_seconds("dconv.x152"):
        x152, weights = train_x152_remat(dev)
        serving["dconv_x152"] = serve_two_stage(rng, dev, "dconv_x152", turns=(True,), tag=DC,
                                                weights=weights)
    with phase_seconds("dconv.panoptic"):
        serve_two_stage(rng, dev, "dconv_panoptic", turns=(False,), tag=DC,
                        check=check_panoptic_serving)
        train_two_stage(rng, dev, "dconv_panoptic", tag=DC, profile=True,
                        check_model=offset_gradients)
    with phase_seconds("dconv.tta"):
        tta = run_tta(rng, dev)
    return {**kernels_, "serving": serving, "x152": x152, "tta": tta}


def dconv_lines(dc):
    """The ``kernels`` line's entries of phase 14's shapes
    (``<kernel>@dconv_<case>``): the X152 tails with the X152 serving run's
    fused launches (switch on), the merge's NMS and the ROI planes with the
    TTA run's launches."""
    tails = dc["serving"]["dconv_x152"]["fused_residual"]
    fused_src = tpu_kernel("*/ops/pallas/fused_residual.py", 118)
    rows = [("fused_residual", FUSED_SRC, fused_src, tails, r) for r in dc["fused"]]
    rows.append(("nms_keep", NMS_SRC, tpu_kernel("*/ops/pallas/nms_keep.py", 161),
                 dc["tta"]["nms_keep"], dc["nms"]))
    rows += [("roi_patch_fwd", ROI_SRC, tpu_kernel("*/ops/pallas/roi_patch.py", 667),
              dc["tta"]["roi_patch_fwd"], r) for r in dc["roi"]]
    return [kernel_line(f"{kernel}@{case_label('dconv', r['case'])}", src, replaces, n, r,
                        r["err"]) for kernel, src, replaces, n, r in rows]


# -- phase 15: solov2 -------------------------------------------------------------------

SOLO = "solov2    "  # the phase's log tag
SOLO_YAML = "configs/COCO-InstanceSegmentation/solo_v2_R_50_FPN_1x.yaml"
# SOLOv2 launches no NMS or pooling kernel: its point NMS, dynamic conv and
# matrix NMS are products and elementwise work (XLA in the JAX package); the
# trunk's fused tails are R50-FPN's (16 per predict with the switch on).
SPECS["solov2"] = {"yaml": SOLO_YAML, "predict": {"nms_keep": 0, "roi_patch_fwd": 0},
                   "step": {"nms_keep": 0, "roi_patch_fwd": 0, "roi_patch_bwd": 0}}
# The narrow head on a 2 x 128 x 160 input: two 64-wide convs a tower (128
# wide in the train step, where a GN of 32 channels, one a group, would leave
# every gradient behind it a remainder of large terms), grids of the small
# input, 50 candidates, 20 detection slots.
SOLO_NARROW = {"MASK_KERNEL_CONVS_DIM": 64, "MASK_KERNEL_NUM_CONVS": 2,
               "MASK_FEATURE_CONVS_DIM": 32, "MASK_FEATURE_OUT_DIMS": 32,
               "NUM_GRIDS": [12, 10, 8, 6, 4], "TOPK_CANDIDATES_TEST": 50,
               "SCORE_THRESH_TEST": 0.05, "UPDATE_SCORE_THRESH_TEST": 0.02}
SOLO_TRAIN_WIDTH = 128
# A mask pixel of the narrow model may differ card against CPU only where the
# CPU's sigmoid lies within MASK_FLIP_TOL of MASK_THRESH_TEST (a logit within
# ~4e-3 of 0: the two sides' float32 head outputs differ by ~1e-5 of their
# largest, logits of order 10). Such a slot's score may move by its flips'
# share of the mask's area (maskness), its box by one stride-4 cell.
MASK_FLIP_TOL = 1e-3


def solo_cfg(narrow: bool = False, batch: int = 0, deform: bool = False):
    """The SOLOv2 YAML as ``two_stage_cfg`` shapes it (bf16 at full width,
    every detection slot real), or narrow float32 with SOLO_NARROW's head."""
    cfg = two_stage_cfg("solov2", narrow, batch)
    s = cfg.MODEL.SOLO
    s.USE_DEFORM_CONV = s.DEFORM_MODULATED = deform
    if narrow:
        for k, v in SOLO_NARROW.items():
            s[k] = v
        cfg.TEST.DETECTIONS_PER_IMAGE = 20
        if batch:
            s.MASK_KERNEL_CONVS_DIM = s.MASK_FEATURE_CONVS_DIM = SOLO_TRAIN_WIDTH
            s.MASK_FEATURE_OUT_DIMS = SOLO_TRAIN_WIDTH
    return cfg


def spread_solo(model) -> None:
    """The narrow head's classifier x30 and kernel predictor x10, as the CPU
    tests spread them: scores spread over (0, 1) and mask logits of order 10,
    so that few candidates tie at the top-k and few pixels at the threshold."""
    with torch.no_grad():
        model.head.cate_pred.weight.mul_(30.0)
        model.head.kernel_pred.weight.mul_(10.0)


def check_solo_small_against_cpu(rng, dev, deform: bool = False) -> None:
    """The narrow float32 SOLOv2 (spread; ``deform``: its towers deformable,
    v2) on 2 x 128 x 160, the card against the CPU from the same weights:
    valid slots and classes equal (matched across score ties by
    ``tie_order``), masks equal but at pixels whose CPU sigmoid lies within
    MASK_FLIP_TOL of the threshold (counted), scores within SMALL_TOL plus a
    flipped slot's maskness share, boxes equal (one cell where flips)."""
    cfg = solo_cfg(narrow=True, deform=deform)
    cpu_model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED))
    spread_solo(cpu_model)
    gpu_model = build_model(cfg, device=dev, state_dict=cpu_model.state_dict())
    image = rng.uniform(0, 255, (2, 128, 160, 3)).astype(np.float32)
    sizes = np.array([[128, 160], [112, 150]], np.int32)
    batch = {"image": torch.from_numpy(image), "image_size": torch.from_numpy(sizes)}
    want = cpu_model.predict(batch).get_fields()
    got = gpu_model.predict({k: v.to(dev) for k, v in batch.items()})
    got = {k: v.cpu() for k, v in got.get_fields().items()}
    if not torch.equal(got["is_valid"], want["is_valid"]) or not bool(want["is_valid"].any()):
        raise AssertionError("narrow SOLOv2: valid slots differ between the card and the CPU, "
                             "or none is valid")
    order = tie_order(got, want)
    classes = torch.gather(got["pred_classes"], 1, order)
    if not torch.equal(classes, want["pred_classes"]):
        raise AssertionError("narrow SOLOv2: classes differ between the card and the CPU")
    cands = []  # the CPU's candidates, computed at the first flip

    def candidates():
        if not cands:
            with torch.inference_mode():
                cands.extend(cpu_model.solov2.candidates(*cpu_model._head_outputs(
                    batch["image"]))[1:])
        return cands

    thresh = cfg.MODEL.SOLO.MASK_THRESH_TEST
    flips = score_err = 0.0
    flipped_slots = 0
    for i, j in torch.nonzero(want["is_valid"]).tolist():
        k = int(order[i, j])
        gm, wm = got["pred_masks"][i, k], want["pred_masks"][i, j]
        differ = gm != wm
        n = int(differ.sum())
        tol_s, tol_b = SMALL_TOL["scores"], SMALL_TOL["boxes"]
        if n:
            cand_cls, cand_pred = candidates()
            match = torch.nonzero((cand_cls[i] == want["pred_classes"][i, j])
                                  & ((cand_pred[i] > thresh) == wm.reshape(-1)).all(-1))
            sig = cand_pred[i, int(match[0, 0])].reshape(wm.shape)
            near = (sig[differ] - thresh).abs()
            if not bool((near <= MASK_FLIP_TOL).all()):
                raise AssertionError(f"narrow SOLOv2: image {i} slot {j}: {n} mask pixels "
                                     f"differ, {float(near.max()):.3g} from the threshold")
            flips += n
            flipped_slots += 1
            tol_s += float(want["scores"][i, j]) * n / max(int(wm.sum()), 1)
            tol_b = 4.0
        err_s = abs(float(got["scores"][i, k] - want["scores"][i, j]))
        err_b = float((got["boxes"][i, k] - want["boxes"][i, j]).abs().max())
        if not (err_s <= tol_s and err_b <= tol_b):
            raise AssertionError(f"narrow SOLOv2: image {i} slot {j}: score |err| {err_s:.3g} "
                                 f"(tolerance {tol_s:.3g}), box |err| {err_b:.3g} ({tol_b})")
        score_err = max(score_err, err_s)
    swapped = int((order != torch.arange(order.shape[1])).sum())
    log(f"{SOLO} narrow f32{' deformable (v2) towers' if deform else ''}, card vs CPU: "
        f"valid={int(want['is_valid'].sum())} slots equal, classes equal, {swapped} slots "
        f"matched across a score tie, {int(flips)} mask pixels flipped (in {flipped_slots} "
        f"slots) within {MASK_FLIP_TOL} of the threshold, scores max|err| {score_err:.3g}")


def check_solo_assignment(dev) -> None:
    """``SOLOv2.assign_level`` on the card against the CPU, every level, on
    GT with argmin ties (repeated boxes): the first claimant wins on both."""
    drv = SOLOv2(solo_cfg(narrow=True, batch=2))
    rng = np.random.default_rng(SEED)
    xy = rng.uniform(0, 80, (2, 6, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(6, 80, (2, 6, 2))], -1).astype(np.float32)
    boxes[:, 3:5] = boxes[:, 1:2]
    gt = {"gt_boxes": boxes, "gt_classes": rng.integers(0, 5, (2, 6)).astype(np.int32),
          "gt_valid": np.ones((2, 6), bool),
          "gt_masks": rng.uniform(0, 1, (2, 6, 28, 28)).astype(np.float32)}
    cpu = {k: torch.from_numpy(v) for k, v in gt.items()}
    gpu = {k: v.to(dev) for k, v in cpu.items()}
    positives = 0
    for (lo, hi), grid in zip(drv.scale_ranges, drv.num_grids):
        want = drv.assign_level(cpu, grid, lo, hi, (128, 160))
        got = drv.assign_level(gpu, grid, lo, hi, (128, 160))
        if not all(torch.equal(g.cpu(), w) for g, w in zip(got, want)):
            raise AssertionError(f"SOLOv2 assignment at grid {grid} differs on the card")
        positives += int(want[2].sum())
    log(f"{SOLO} assign_level bit-equal card vs CPU on {len(drv.num_grids)} levels with argmin "
        f"ties ({positives} positive cells)")


def check_solo_serving(cfg, out, batch, label) -> None:
    """A served SOLOv2 batch: 100 valid slots per image, finite scores and
    boxes inside the padded frame, classes of the 80, bool whole-frame masks
    ``[2, 100, 200, 336]`` each non-empty and each box its mask's extent;
    ``detector_postprocess`` resizes them to the 800 x 1344 canvas."""
    f = out.get_fields()
    b = f["boxes"].shape[0]
    m = f["pred_masks"]
    if tuple(m.shape) != (b, 100, 200, 336) or m.dtype != torch.bool:
        raise AssertionError(f"{label}: masks {tuple(m.shape)} {m.dtype}")
    if f["is_valid"].sum(1).tolist() != [100] * b:
        raise AssertionError(f"{label}: valid per image {f['is_valid'].sum(1).tolist()}")
    if not (bool(torch.isfinite(f["scores"]).all()) and bool(torch.isfinite(f["boxes"]).all())):
        raise AssertionError(f"{label}: non-finite scores or boxes")
    bx = f["boxes"]
    if (bool((bx < 0).any()) or bool((bx[..., 2] > 1344).any())
            or bool((bx[..., 3] > 800).any()) or bool((bx[..., 2:] <= bx[..., :2]).any())):
        raise AssertionError(f"{label}: boxes outside the padded frame or empty")
    area = m.sum((2, 3))
    if not bool((area > 0).all()):
        raise AssertionError(f"{label}: {int((area == 0).sum())} empty masks")
    cls = f["pred_classes"]
    if bool((cls < 0).any()) or bool((cls >= cfg.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES).any()):
        raise AssertionError(f"{label}: classes out of range")
    p = detector_postprocess(cfg, out, batch).pred_masks
    if tuple(p.shape) != (b, 100, 800, 1344) or p.dtype != torch.uint8:
        raise AssertionError(f"{label}: postprocess gave {tuple(p.shape)} {p.dtype}")
    log(f"{SOLO} {label}: 100 valid detections per image, masks {tuple(m.shape)} bool, "
        f"{int(area.min())}-{int(area.max())} cells each, boxes their extents in the padded "
        f"frame, scores in [{float(f['scores'].min()):.4f}, {float(f['scores'].max()):.4f}], "
        f"{len(set(cls.flatten().tolist()))} classes; conventional masks {tuple(p.shape)} with "
        f"{int(p.sum())} pixels set")


def run_solov2(rng, dev):
    """Phase 15: SOLOv2 R50-FPN. Narrow float32 models (plain and deformable
    towers) and a train step card against CPU, the assignment's ties; the
    YAML served 2 x 800 x 1344 bf16 (switch off and on) and trained 3 steps
    at 8 x 800 x 1344 with 64 GT, launches asserted (no kernel but the fused
    tails). Returns the runs' launches."""
    with phase_seconds("solov2.narrow"):
        check_solo_small_against_cpu(rng, dev)
        check_solo_small_against_cpu(rng, dev, deform=True)
        check_solo_assignment(dev)
        check_train_against_cpu(dev, False, solo_cfg(narrow=True, batch=2), label=SOLO,
                                prepare=tie_free)
    with phase_seconds("solov2.full"):
        serving = serve_two_stage(rng, dev, "solov2", turns=(False, True), tag=SOLO,
                                  check=check_solo_serving)
        training, peak = train_two_stage(rng, dev, "solov2", tag=SOLO, profile=True)
    return {"serving": serving, "training": training, "peak": peak}


# -- phase 16: yolov4 -------------------------------------------------------------------

YOLO = "yolov4    "  # the phase's log tag
YOLO_YAML = "configs/COCO-Detection/yolov4_D_53_PAN_1x.yaml"
# YOLOv4 serving: one class-agnostic NMS over the top 1000 of the three levels'
# candidates per predict, no pooling; its training step (the YOLO matcher and
# dense losses) launches no kernel.
SPECS["yolov4"] = {"yaml": YOLO_YAML, "predict": {"nms_keep": 1, "roi_patch_fwd": 0},
                   "step": {"nms_keep": 0, "roi_patch_fwd": 0, "roi_patch_bwd": 0}}
YOLO_SIZE = 608  # Base-YOLO's pad bucket (608, 608)
YOLO_TRAIN_STEPS = (2, 3)  # warm-up, timed
# The overfit gate's evaluation: all 504 candidates of the 64 x 128 bucket
# (3 anchors on 8 x 16, 4 x 8 and 2 x 4 cells) in one class-agnostic NMS per
# image, 8 images a batch, TEST.DETECTIONS_PER_IMAGE 8.
YOLO_GATE_NMS = (8, 504, 8)
# The narrow predictors' objectness and class rows x10: the scores spread over
# (0, 1) rather than within float32 rounding of each other (the CPU tests'
# ``spread``).
YOLO_SPREAD = 10.0


def check_yolov4_nms(rng, dev):
    """``nms_keep`` bit-equal at YOLOv4's serving shape (per image the top
    1000 candidates, class-agnostic, score-sorted, clipped to 608 x 608,
    IoU 0.5, ``max_keep`` 100) and at its overfit gate's evaluation
    (``YOLO_GATE_NMS``: 8 images of all 504 candidates clipped to 64 x 128,
    IoU 0.5, ``max_keep`` 8). Returns the two results."""
    boxes, valid = clustered_boxes(rng, 2, 1000, h=float(YOLO_SIZE), w=float(YOLO_SIZE),
                                   objects=100)
    serving = nms_case(dev, "yolov4 class-agnostic 2x1000 iou=0.5 max_keep=100", boxes, valid,
                       0.5, 100, plain=greedy_keep_reference_rows, reps=50,
                       tag=f"{YOLO} nms_keep")
    b, n, keep = YOLO_GATE_NMS
    # Its own draws, so that the later phases' inputs stay as they were.
    boxes, valid = clustered_boxes(np.random.default_rng(SEED + 16), b, n, h=64.0, w=128.0,
                                   objects=3)
    gate = nms_case(dev, f"yolov4 overfit eval {b}x{n} iou=0.5 max_keep={keep}", boxes, valid,
                    0.5, keep, plain=greedy_keep_reference_rows, reps=50,
                    tag=f"{YOLO} nms_keep")
    return {"serving": serving, "gate": gate}


def spread_yolo(model) -> None:
    """Each predictor's objectness and class rows (field ``j >= 4`` of each
    anchor's ``5 + K``) x YOLO_SPREAD."""
    with torch.no_grad():
        for i in range(1, 4):
            w = getattr(model.head, f"pred{i}").weight
            fields = w.shape[0] // model.yolov4.num_anchors
            w[torch.arange(w.shape[0]) % fields >= 4] *= YOLO_SPREAD


def check_yolo_serving(cfg, out, batch, label) -> None:
    """A served YOLOv4 batch: 100 valid slots per image, finite boxes clipped
    to the 608 x 608 image and not empty, classes of the 80, scores in (0, 1]
    (sigmoid products), no masks."""
    f = out.get_fields()
    b = f["boxes"].shape[0]
    if "pred_masks" in f or tuple(f["boxes"].shape) != (b, 100, 4):
        raise AssertionError(f"{label}: fields {sorted(f)}, boxes {tuple(f['boxes'].shape)}")
    if f["is_valid"].sum(1).tolist() != [100] * b:
        raise AssertionError(f"{label}: valid per image {f['is_valid'].sum(1).tolist()}")
    if not (bool(torch.isfinite(f["scores"]).all()) and bool(torch.isfinite(f["boxes"]).all())):
        raise AssertionError(f"{label}: non-finite scores or boxes")
    bx, size = f["boxes"], batch["image_size"][:, None]
    if (bool((bx < 0).any()) or bool((bx[..., 2] > size[..., 1]).any())
            or bool((bx[..., 3] > size[..., 0]).any()) or bool((bx[..., 2:] < bx[..., :2]).any())):
        raise AssertionError(f"{label}: boxes not clipped to the image")
    cls, s = f["pred_classes"], f["scores"]
    if bool((cls < 0).any()) or bool((cls >= cfg.MODEL.SINGLE_STAGE_HEAD.NUM_CLASSES).any()):
        raise AssertionError(f"{label}: classes out of range")
    if not (float(s.min()) > 0.0 and float(s.max()) <= 1.0):
        raise AssertionError(f"{label}: scores outside (0, 1]")
    log(f"{YOLO} {label}: 100 valid detections per image, finite, boxes clipped to "
        f"{YOLO_SIZE}x{YOLO_SIZE}, scores in [{float(s.min()):.4f}, {float(s.max()):.4f}], "
        f"{len(set(cls.flatten().tolist()))} classes")


def kink_free(model) -> None:
    """Every BN affine at scale 0.5 and bias +1 or -1 (a seeded sign per
    channel; ``tests/test_torch_yolov4_train.py`` ``kink_free``): no leaky
    ReLU input lies within rounding of its kink, and no BN input's mean
    dwarfs its spread (the fast variance keeps its precision), so the
    card's and the CPU's rounding decide no gradient."""
    gen = torch.Generator().manual_seed(SEED + 4)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, BatchNorm2d):
                mod.weight.fill_(0.5)
                signs = torch.randint(0, 2, mod.bias.shape, generator=gen) * 2.0 - 1.0
                mod.bias.copy_(signs)


def train_yolov4(dev):
    """``yolov4_D_53_PAN_1x.yaml`` (bf16, float32 parameters, seeded random
    weights, the YAML's ``FREEZE_AT 2``, switch off) on a seeded 8 x 608 x
    608 batch with 64 GT an image: YOLO_TRAIN_STEPS warm-up and timed
    steps; launches per step asserted (none), losses finite, the frozen stem
    and res1 bit-equal, every trainable parameter moved (or, at the
    warm-up's learning rate, took an update below float32's resolution with
    a nonzero momentum), every BN running statistic of the neck and the
    head moved. Logs img/s, the device ms per step and idle share under the
    profiler and the peak memory. Returns the timed steps' launches."""
    cfg = two_stage_cfg("yolov4", batch=8)
    b = 8
    batch = {k: torch.from_numpy(v).to(dev)
             for k, v in make_train_batch(cfg, YOLO_SIZE, YOLO_SIZE).items()}
    torch.cuda.reset_peak_memory_stats(dev)
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED),
                        training=True, init="jax")
    start = {n: t.detach().clone() for n, t in model.state_dict().items()}
    state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(SEED))
    step = build_train_step(cfg, state)
    warm, timed = YOLO_TRAIN_STEPS
    metrics = [step(batch) for _ in range(warm)]
    torch.cuda.synchronize()
    zero_launches()
    t0 = time.perf_counter()
    for _ in range(timed):
        metrics.append(step(batch))
    torch.cuda.synchronize()
    img_s = b * timed / (time.perf_counter() - t0)
    launches = read_launches()
    for kernel, per in SPECS["yolov4"]["step"].items():
        if launches[kernel] != per * timed:
            raise AssertionError(f"yolov4: {launches[kernel]} {kernel} launches in {timed} "
                                 f"steps, expected {per} per step")
    if launches["fused_residual"] or fused_tails(model):
        raise AssertionError("yolov4: fused tails in training")
    device_ms, _, idle, _ = profile_predict.device_time(lambda: step(batch), 2, host_ops=False)
    peak = torch.cuda.max_memory_allocated(dev) / 2**30
    values = [{k: float(v) for k, v in m.items()} for m in metrics]
    if set(values[0]) != {"total_loss", "box_loss", "conf_loss", "cls_loss"} or not all(
            np.isfinite(v) for m in values for v in m.values()):
        raise AssertionError(f"yolov4: losses {values}")
    trainable = trainable_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
    params = dict(model.named_parameters())
    frozen = [n for n in params if n not in trainable]
    if not frozen or any(not n.startswith(("backbone.bottom_up.stem.",
                                           "backbone.bottom_up.res1.")) for n in frozen):
        raise AssertionError(f"yolov4: unexpected frozen parameters {frozen}")
    changed_frozen = [n for n in frozen if not torch.equal(params[n], start[n])]
    unchanged = [n for n, p in trainable.items() if torch.equal(p.detach(), start[n])]
    rounded = below_resolution(state, trainable, unchanged)
    unchanged = [n for n in unchanged if n not in rounded]
    if changed_frozen or unchanged:
        raise AssertionError(f"yolov4: frozen parameters changed: {changed_frozen}; trainable "
                             f"unchanged: {unchanged}")
    stats = {f"{m}.{k}": t for m, mod in model.named_modules() if isinstance(mod, BatchNorm2d)
             for k, t in mod.named_buffers()}
    still = [n for n, t in stats.items() if torch.equal(t, start[n])]
    if still or not stats or any(n.startswith("backbone.bottom_up.") for n in stats):
        raise AssertionError(f"yolov4: BN statistics that did not move: {still}")
    log(f"{YOLO} train {warm} + {timed} steps of batch {b} at {YOLO_SIZE}x{YOLO_SIZE} bf16 "
        f"(64 GT an image, FREEZE_AT {cfg.MODEL.BACKBONE.FREEZE_AT}): {img_s:.2f} img/s (host "
        f"clock, timed steps), device ms per step under the profiler {device_ms:.2f} (idle share "
        f"{idle:.3f}), peak memory {peak:.2f} GiB; launches {launches}; first "
        + ", ".join(f"{k} {v:.4f}" for k, v in values[0].items())
        + f"; last total_loss {values[-1]['total_loss']:.4f}; {len(frozen)} frozen parameters "
          f"(stem, res1) bit-equal, all {len(trainable)} trainable parameters changed (or, "
          f"{len(rounded)} of them, took updates below float32's resolution at the warm-up's "
          f"learning rate), all {len(stats)} BN running statistics of the neck and the head "
          f"moved")
    del model, state, step
    torch.cuda.empty_cache()
    return launches


def check_darknet_load(dev) -> None:
    """``PRETRAINS.DARKNET`` on the card's machine: the narrow float32 model's
    seeded CPU weights written as a darknet blob and manifest into a temp
    dir (``convert.write_darknet_weights``) load through ``load_pretrained``
    into a model on the card, every tensor bit-equal."""
    cfg = two_stage_cfg("yolov4", narrow=True)
    source = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(SEED + 1))
    model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED))
    manifest = emit_manifest(source)
    with tempfile.TemporaryDirectory() as tmp:
        os.makedirs(os.path.join(tmp, "darknet"))
        path = os.path.join(tmp, cfg.PRETRAINS.DARKNET)
        write_darknet_weights(path, source.state_dict(), manifest)
        cfg.PRETRAINS.ROOT = tmp
        if not load_pretrained(cfg, model):
            raise AssertionError("darknet: load_pretrained loaded nothing")
        blob = read_darknet_blob(path)
    want = source.state_dict()
    got = model.state_dict()
    differ = [k for k, v in got.items() if not torch.equal(v.cpu(), want[k])]
    if differ or sorted(got) != sorted(want):
        raise AssertionError(f"darknet: {len(differ)} tensors differ from the blob's, first "
                             f"{differ[:3]}")
    log(f"{YOLO} darknet blob ({len(manifest['nodes'])} nodes, {blob.size} floats) and "
        f"manifest through load_pretrained onto the card: all {len(got)} tensors bit-equal")


def run_yolov4(rng, dev, nms):
    """Phase 16: YOLOv4 serving and training. The new ``nms_keep`` shapes
    (``nms``, checked earlier); the narrow float32 model and train step
    card against CPU; the darknet blob loaded on the card;
    ``yolov4_D_53_PAN_1x.yaml`` served 2 x 608 x 608 bf16 (switch off and
    on: 1 / 0 ``nms_keep`` / ``roi_patch_fwd`` per ``predict``, 0 fused
    tails), with img/s, device ms, idle share and peak memory, then trained
    at 8 x 608 x 608 (:func:`train_yolov4`). Returns the NMS results and
    the serving and training runs' launches."""
    with phase_seconds("yolov4.narrow"):
        check_small_against_cpu(rng, dev, False, two_stage_cfg("yolov4", narrow=True),
                                label=f"{YOLO} narrow", prepare=spread_yolo)
        check_train_against_cpu(dev, False, two_stage_cfg("yolov4", narrow=True, batch=2),
                                label=YOLO, prepare=kink_free, zero_bias=True)
        check_darknet_load(dev)
    with phase_seconds("yolov4.full"):
        torch.cuda.reset_peak_memory_stats(dev)
        serving = serve_two_stage(rng, dev, "yolov4", turns=(False, True), tag=YOLO,
                                  check=check_yolo_serving)
        log(f"{YOLO} serving peak memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB "
            "(both models, batch 2 at 608x608 bf16)")
    with phase_seconds("yolov4.train"):
        training = train_yolov4(dev)
    return {"nms": nms, "serving": serving, "training": training}


# -- phase 17: relation ------------------------------------------------------------------

REL = "relation  "  # the phase's log tag
RELATION_YAML = "configs/Misc/relation_rcnn_R_50_FPN_1x.yaml"
DUP_ON = ("MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_ON", "True")
# Relation Networks serving: the RPN's NMS and one box pool per predict, plus
# the box head's class-aware NMS as the YAML is; with the learned duplicate
# removal (five IoU heads, the YAML's) that NMS is gone (attention, sigmoids
# and a top-k, no kernel). The relation head itself launches no kernel.
SPECS["relation"] = {"yaml": RELATION_YAML, "predict": {"nms_keep": 2, "roi_patch_fwd": 1}}
SPECS["relation_dup"] = {"yaml": RELATION_YAML, "opts": DUP_ON,
                         "predict": {"nms_keep": 1, "roi_patch_fwd": 1}}
# The narrow float32 models held card against CPU, each from the CPU model's
# proposals and candidates (``same_proposals``) and with ``geometry_kink_free``
# weights: the
# YAML as it is, the removal combining its heads by mean and by max, and the
# mask head on the removal's detections.
RELATION_SMALL = {
    "nms": (),
    "dup_mean": DUP_ON,
    "dup_max": DUP_ON + ("MODEL.ROI_BOX_RELATION_HEAD.DUPLICATE_REMOVAL_COMBINE", "max"),
    "dup_mask": DUP_ON + ("MODEL.MASK_ON", "True"),
}
RELATION_PEAK_BATCH = 8
# The duplicate removal's scores, and the window in which ``tie_order``
# matches two slots across a score tie: from the same proposals, candidates
# and weights the removal's mean of five unsaturated sigmoids still carries
# the geometry's rounding, card against CPU, up to 1.76e-5 over 30 inputs
# (measured on an H100 80GB HBM3 at 700 W; the max rule 0, the box head
# alone 1.07e-6 within SMALL_TOL).
RELATION_TOL = {**SMALL_TOL, "scores": 5e-5}
# ``geometry_kink_free``: each relation module's geometry weight scaled by
# this, its bias set to 1.
GEOMETRY_WEIGHT_SCALE = 0.1


def geometry_kink_free(model, prefix: str = "") -> None:
    """Each relation module's ``geometry_weight`` x GEOMETRY_WEIGHT_SCALE with
    bias 1, so that its output wg (~1 +- 0.1) stays far from the 1e-6 clamp
    before ``log(wg)``. At random weights wg is ~N(0, 1), and log(wg) near
    the clamp turns the ulp by which the card's and the CPU's boxes differ
    into another attention: the box head's scores moved by up to 4.6e-5
    over 20 inputs, 2.2e-6 with these weights (measured on an H100 80GB HBM3
    at 700 W), as ``kink_free`` keeps BN outputs off the leaky ReLU's kink.
    ``prefix``: only the relation modules under it."""
    with torch.no_grad():
        for name, mod in model.named_modules():
            if name.startswith(prefix) and name.endswith(".geometry_weight"):
                mod.weight.mul_(GEOMETRY_WEIGHT_SCALE)
                mod.bias.fill_(1.0)


def check_relation_serving(cfg, out, batch, label) -> None:
    """``check_outputs`` (100 valid, finite detections per image, boxes
    clipped to the image), then classes of the 80 and scores in (0, 1]."""
    check_outputs(cfg, out, batch, 2, 800, 1344, label, phase=REL)
    cls, s = out.pred_classes, out.scores
    if bool((cls < 0).any()) or bool((cls >= cfg.MODEL.ROI_HEADS.NUM_CLASSES).any()):
        raise AssertionError(f"{label}: classes out of range")
    if not (float(s.min()) > 0.0 and float(s.max()) <= 1.0):
        raise AssertionError(f"{label}: scores outside (0, 1]")


def peak_gib(model, batch) -> float:
    """Peak device memory of one ``predict`` of ``batch`` (weights included)."""
    dev = batch["image"].device
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    model.predict(batch)
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated(dev) / 2**30


def relation_probe(model, batch) -> None:
    """Log the relation head's and the duplicate removal's device ms on the
    served proposals (``profile_predict.relation_times``), one predict's peak
    memory, then at batch RELATION_PEAK_BATCH (the first image repeated)
    the peak memory and device ms."""
    t = profile_predict.relation_times(model, batch)
    removal = (f", duplicate removal {t['removal_ms']:.3f} ms" if "removal_ms" in t
               else ", no duplicate removal")
    log(f"{REL} relation box head on {t['rois'][0]} x {t['rois'][1]} ROIs: device "
        f"{t['head_ms']:.3f} ms a call (geometry embedding alone {t['geometry_ms']:.3f} ms)"
        + removal + f"; peak memory of a predict {peak_gib(model, batch):.2f} GiB (one model)")
    b = RELATION_PEAK_BATCH
    big = {k: v[:1].expand((b,) + v.shape[1:]).contiguous() for k, v in batch.items()}
    peak = peak_gib(model, big)
    device_ms, _, idle, _ = profile_predict.device_time(lambda: model.predict(big), 2,
                                                        host_ops=False)
    log(f"{REL} predict at batch {b}: peak memory {peak:.2f} GiB (one model), device ms "
        f"{device_ms:.2f} (idle share {idle:.3f})")


# Relation Networks training: per step the RPN's NMS, one box pool and its
# backward (no mask head in the YAML); the relation head, the duplicate
# removal's candidates, targets and loss_dup launch no kernel.
SPECS["relation"]["step"] = {"nms_keep": 1, "roi_patch_fwd": 1, "roi_patch_bwd": 1}
SPECS["relation_dup"]["step"] = SPECS["relation"]["step"]
# The narrow float32 train steps held card against CPU: the YAML as it is,
# the removal with its five IoU heads, and the removal with MASK_ON.
RELATION_TRAIN_SMALL = {
    "yaml": (),
    "dup": DUP_ON,
    "dup_mask": DUP_ON + ("MODEL.MASK_ON", "True"),
}
# The CPU's training proposals moved by up to this many px per coordinate
# (seeded) before both sides take them: at random weights the RPN returns its
# anchors, three about each centre, and the removal's candidates would come
# in triples whose centres lie within ~0.01 px, where the geometry's
# 100 * log(|dc| / w) has a slope of ~1e4 per px (tests/test_torch_relation_train.py).
RELATION_JITTER = 3.0
# ``relation_train_prepare``: the classifier's kernel x this, so that no two
# candidates' class scores lie within rounding (their order is the rank
# embedding's input).
RELATION_CLS_SPREAD = 30.0
# Gradients card against CPU, as a fraction of each one's largest magnitude
# (measured on an H100 80GB HBM3 at 700 W, the same in four runs). Without
# the removal, the relation box head (its modules and FCs), the neck and the
# trunk to 1e-3: the softmax over 512 ROIs and the geometry the two sides'
# logs and sines round apart (measured 1.9e-4, the box head's geometry
# weights; the trunk 1.2e-4). With the duplicate removal its loss reaches
# the deltas through the geometry embedding of the decoded candidates, whose
# slope 100 / |dc| turns the sides' ~1e-6 relative difference in the deltas
# into ~1e-3 of the gradients behind them: the removal's own and the box
# regressor's to 2e-2 (measured 5.8e-3, the removal's query weights; 2.5e-3,
# the regressor; the CPU test holds the port against the JAX package, where
# the candidates differ by ulps, to 1e-2), the box head, the neck and the
# trunk to 5e-3 (measured 2.3e-3, the box head's relation modules; the
# trunk 1.2e-3, the neck 6.4e-4, the box head's FCs 5.5e-4). The RPN head,
# the classifier and the mask head keep TRAIN_GRAD_TOL.
RELATION_GRAD_TOL = 1e-3
RELATION_BEHIND_REMOVAL_GRAD_TOL = 5e-3
RELATION_REMOVAL_GRAD_TOL = 2e-2
RELATION_TRAIN_STEPS = (2, 3)  # warm-up, timed


def relation_jitter(proposals):
    """``proposals`` (the CPU's, 2 x 128 x 160) with each box moved by up to
    RELATION_JITTER px per coordinate, clipped to 128 x 160, at least 1 px."""
    gen = torch.Generator().manual_seed(SEED)
    boxes = proposals.proposal_boxes + (
        torch.rand(proposals.proposal_boxes.shape, generator=gen) * 2 - 1) * RELATION_JITTER
    hi = torch.tensor([160.0, 128.0, 160.0, 128.0])
    boxes = torch.minimum(torch.clamp(boxes, min=0.0), hi)
    boxes[..., 2:] = torch.maximum(boxes[..., 2:], boxes[..., :2] + 1)
    return proposals.replace(proposal_boxes=boxes)


def relation_train_prepare(model) -> None:
    """``tie_free``, the box head's geometry weights off the clamp
    (``geometry_kink_free``; the removal's stay as drawn: lifted, its
    attention turns near-uniform and its gradients cancel), the classifier
    spread by RELATION_CLS_SPREAD."""
    tie_free(model)
    geometry_kink_free(model, "roi_heads.box_head.")
    with torch.no_grad():
        model.roi_heads.box_predictor.cls_score.weight.mul_(RELATION_CLS_SPREAD)


def relation_grad_tol(removal: bool):
    """A narrow relation model's gradient tolerance by parameter name."""
    below = ("backbone.", "roi_heads.box_head.")
    own = ("roi_heads.box_predictor.bbox_pred.", "roi_heads.duplicate_removal.")

    def tol(name: str) -> float:
        if removal and name.startswith(own):
            return RELATION_REMOVAL_GRAD_TOL
        if name.startswith(below):
            return RELATION_BEHIND_REMOVAL_GRAD_TOL if removal else RELATION_GRAD_TOL
        return TRAIN_GRAD_TOL
    return tol


def train_relation(dev, name: str):
    """``name``'s YAML (bf16, float32 parameters, seeded random weights) on a
    seeded 8 x 800 x 1344 batch with 64 GT an image, the switch off and then
    on: RELATION_TRAIN_STEPS warm-up and timed steps, launches per step
    asserted (16 fused tails with the switch on, all on the ``wgmma``
    path), losses finite, the frozen stem and res2 bit-equal, every
    trainable parameter moved (the relation modules' and the removal's
    listed; a key bias, whose gradient is zero, may stay), with img/s,
    device ms per step, idle share and peak memory; then, switch off, the
    relation head's forward and backward and ``loss_dup``'s device ms
    (``profile_train.relation_train_times``). Returns the timed steps'
    launches."""
    spec = SPECS[name]
    cfg = two_stage_cfg(name, batch=8)
    b, (warm, iters) = 8, RELATION_TRAIN_STEPS
    batch = {k: torch.from_numpy(v).to(dev) for k, v in make_train_batch(cfg, 800, 1344).items()}
    total = {}
    for fused in (False, True):
        torch.cuda.reset_peak_memory_stats(dev)
        with fused_switch(fused):
            model = build_model(cfg, device=dev, generator=torch.Generator().manual_seed(SEED),
                                training=True)
        start = {n: p.detach().clone() for n, p in model.named_parameters()}
        state = create_train_state(cfg, model, torch.Generator(device=dev).manual_seed(SEED))
        step = build_train_step(cfg, state)
        metrics = [step(batch) for _ in range(warm)]
        torch.cuda.synchronize()
        zero_launches()
        wgmma = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"]
        t0 = time.perf_counter()
        metrics += [step(batch) for _ in range(iters)]
        torch.cuda.synchronize()
        img_s = b * iters / (time.perf_counter() - t0)
        launches = read_launches()
        want = {**spec["step"], "fused_residual": FUSED_TAILS if fused else 0}
        wgmma = fused_conv1x1_bn_add_relu.launches_by_path["wgmma"] - wgmma
        if any(launches[k] != per * iters for k, per in want.items()) or (
                wgmma != launches["fused_residual"]):
            raise AssertionError(f"{name}: launches {launches} ({wgmma} tails on the wgmma path) "
                                 f"in {iters} steps, expected {want} per step")
        total = {k: total.get(k, 0) + v for k, v in launches.items()}
        device_ms, _, idle, _ = profile_predict.device_time(lambda: step(batch), 2,
                                                            host_ops=False)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30
        values = [{k: float(v) for k, v in m.items()} for m in metrics]
        if not all(np.isfinite(v) for m in values for v in m.values()) or (
                ("loss_dup" in values[0]) != (name == "relation_dup")):
            raise AssertionError(f"{name}: losses {values}")
        trainable = trainable_parameters(model, cfg.MODEL.BACKBONE.FREEZE_AT)
        params = dict(model.named_parameters())
        frozen = [n for n in params if n not in trainable]
        changed_frozen = [n for n in frozen if not torch.equal(params[n], start[n])]
        unchanged = [n for n, p in trainable.items() if torch.equal(p.detach(), start[n])]
        kept = [n for n in unchanged if n in ZERO_GRADS]
        relation_moved = [n for n in trainable if n.startswith((
            "roi_heads.box_head.relation", "roi_heads.duplicate_removal.")) and n not in kept]
        if changed_frozen or set(unchanged) - set(kept) or not frozen or any(
                not n.startswith(FROZEN) for n in frozen):
            raise AssertionError(f"{name}: frozen parameters changed: {changed_frozen}; "
                                 f"trainable unchanged: {unchanged}")
        log(f"{REL} {name} train, fused tail {'on' if fused else 'off'}, {warm} + {iters} steps "
            f"of batch {b} at 800x1344 bf16: {img_s:.2f} img/s (host clock), device ms per step "
            f"{device_ms:.2f} (idle share {idle:.3f}), peak memory {peak:.2f} GiB; launches "
            f"{launches}; first " + ", ".join(f"{k} {v:.4f}" for k, v in values[0].items())
            + f"; last total_loss {values[-1]['total_loss']:.4f}; {len(frozen)} frozen "
              f"parameters bit-equal, {len(trainable) - len(kept)} of {len(trainable)} "
              f"trainable parameters changed ({len(relation_moved)} of the relation modules "
              f"and the removal), {len(kept)} key biases (zero gradient) kept")
        if not fused:
            t = profile_train.relation_train_times(model, batch)
            dup = (f", loss_dup forward + backward {t['dup_ms']:.3f} ms" if "dup_ms" in t
                   else "")
            log(f"{REL} {name} on {t['rois'][0]} x {t['rois'][1]} sampled ROIs: relation box "
                f"head forward + backward device {t['head_ms']:.3f} ms" + dup)
        del model, state, step
        torch.cuda.empty_cache()
    return total


def run_relation(rng, dev):
    """Phase 17: Relation Networks serving and training. The narrow float32
    relation models (RELATION_SMALL) on the card against the CPU;
    ``relation_rcnn_R_50_FPN_1x.yaml`` (bf16, seeded random weights,
    ``SCORE_THRESH_TEST`` 0) serving 2 x 800 x 1344 as it is and with
    ``DUPLICATE_REMOVAL_ON``, each with the switch off and on in turns
    (launches per ``predict`` asserted, 16 fused tails on), with img/s,
    device ms, idle share, the relation head's and the removal's device ms
    and the peak memory at batch 2 and 8 (``relation_probe``). Then the
    narrow float32 train steps (RELATION_TRAIN_SMALL, switch off and on)
    against the CPU from the CPU's jittered proposals, and the YAML trained
    at 8 x 800 x 1344 as it is and with the removal (``train_relation``).
    Returns the serving and training runs' launches."""
    with phase_seconds("relation.narrow"):
        for name, opts in RELATION_SMALL.items():
            cfg = two_stage_cfg("relation", narrow=True)
            cfg.merge_from_list(list(opts))
            check_small_against_cpu(rng, dev, False, cfg, label=f"{REL} narrow {name}",
                                    prepare=geometry_kink_free, same_proposals=True,
                                    tol=RELATION_TOL if opts else None)
    serving = {}
    with phase_seconds("relation.full"):
        for name in ("relation", "relation_dup"):
            serving[name] = serve_two_stage(rng, dev, name, turns=(False, True), tag=REL,
                                            check=check_relation_serving,
                                            probe_model=relation_probe)
    with phase_seconds("relation.narrow_train"):
        for name, opts in RELATION_TRAIN_SMALL.items():
            cfg = two_stage_cfg("relation", narrow=True, batch=2)
            cfg.merge_from_list(list(opts))
            for fused in (False, True):
                check_train_against_cpu(dev, fused, cfg, label=f"{REL} narrow {name}",
                                        prepare=relation_train_prepare,
                                        adjust_proposals=relation_jitter,
                                        grad_tol=relation_grad_tol(bool(opts)))
    with phase_seconds("relation.train"):
        training = {name: train_relation(dev, name) for name in ("relation", "relation_dup")}
    return {"serving": serving, "training": training}


def probe():
    """What the card's machine offers a JPEG route (decides nothing here).
    Each module is imported in a child interpreter, so this one imports none."""
    found = {}
    for module in ("cv2", "PIL", "torchvision"):
        child = subprocess.run([sys.executable, "-c", f"import {module}"],
                               capture_output=True, text=True, timeout=120)
        found[module] = "yes" if child.returncode == 0 else "no"
    gxx = shutil.which("g++")
    found["g++"] = gxx or "no"
    if gxx:
        with tempfile.TemporaryDirectory() as tmp:
            src = Path(tmp) / "probe.c"
            src.write_text("#include <stdio.h>\n#include <jpeglib.h>\n"
                           "int main(void) { struct jpeg_error_mgr e; jpeg_std_error(&e); "
                           "return 0; }\n")
            header = subprocess.run([gxx, "-x", "c", "-c", str(src), "-o", f"{tmp}/probe.o"],
                                    capture_output=True, text=True)
            found["jpeglib.h"] = "yes" if header.returncode == 0 else "no"
            if header.returncode == 0:
                link = subprocess.run([gxx, f"{tmp}/probe.o", "-ljpeg", "-o", f"{tmp}/probe"],
                                      capture_output=True, text=True)
                found["libjpeg"] = "yes" if link.returncode == 0 else "no"
            else:
                found["libjpeg"] = "not tried"
    log("probe      " + ", ".join(f"{k} {v}" for k, v in found.items()))


def kernel_line(name, src, replaces, launches, result, err):
    return {"name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": launches, "max_abs_err": float(err), "ms": result["ms"],
            "plain_ms": result["plain_ms"], "bound_ms": result["bound_ms"],
            "bound_by": result["bound_by"], "library_ms": result.get("library_ms")}


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    dev = torch.device("cuda", 0)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f"device     {torch.cuda.get_device_name(0)}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    with phase_seconds("build"):
        paths = kernels.build_all()
        log(f"build      {sorted(p.name for p in paths.values())}")

    rng = np.random.default_rng(SEED)
    with phase_seconds("kernels"):
        nms = check_nms(rng, dev)
        roi = check_roi(rng, dev)
        bwd = check_roi_bwd(rng, dev)
        fused = check_fused(rng, dev)
    with phase_seconds("later_kernels"):
        later = check_later_kernels(rng, dev)
    with phase_seconds("variants"):
        variants = check_variants(dev)
        variant_times, variant_launches = run_variants_tool()
        variants["ms"] = variant_times["full"]
    with phase_seconds("model"):
        for on in (False, True):
            check_small_against_cpu(rng, dev, on)
        launches, _ = run_model(rng, dev)
    with phase_seconds("train"):
        for on in (False, True):
            check_train_against_cpu(dev, on)
        train_launches, _ = run_train(dev)
    with phase_seconds("loop"), fused_switch(False):
        run_loop()
    with phase_seconds("workflow"), fused_switch(False):
        pending = run_workflow()  # (b) and the gates go on beside the later phases
    with phase_seconds("single_level"):
        single = run_single_level(rng, dev, later["single_level"])
    # Phase 10 after 11-13: its Fast R-CNN CLIs start processes, which the
    # gates' processes (done by then) would slow.
    with phase_seconds("single_stage_cascade"), fused_switch(False):
        ssc = run_single_stage_cascade(rng, dev, later["single_stage_cascade"])
    with phase_seconds("keypoint"), fused_switch(False):
        kp = run_keypoint(rng, dev, later["keypoint"])
    with phase_seconds("panoptic"), fused_switch(False):
        run_panoptic(rng, dev)
    with phase_seconds("two_stage"), fused_switch(False):
        two = run_two_stage(rng, dev, later["two_stage"])
    with phase_seconds("dconv"), fused_switch(False):
        dc = run_dconv(rng, dev, later["dconv"])
    with phase_seconds("solov2"), fused_switch(False):
        run_solov2(rng, dev)
    with phase_seconds("yolov4"), fused_switch(False):
        yolo = run_yolov4(rng, dev, later["yolov4"])
    with phase_seconds("relation"), fused_switch(False):
        run_relation(rng, dev)
    with phase_seconds("gates"):
        gates = finish_workflow(pending)
    probe()
    log(f"seconds    total {time.perf_counter() - START:.1f}")

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(smi, flush=True)
    print(json.dumps({"kernels": [  # nms_keep at the RPN's stacked levels, the main path's input
        kernel_line("nms_keep", NMS_SRC, tpu_kernel("*/ops/pallas/nms_keep.py", 161),
                    launches["nms_keep"], nms[1], max(r["err"] for r in nms)),
        kernel_line("roi_patch_fwd", ROI_SRC, tpu_kernel("*/ops/pallas/roi_patch.py", 667),
                    launches["roi_patch_fwd"], roi[0], max(r["err"] for r in roi)),
        kernel_line("roi_patch_bwd", ROI_SRC, tpu_kernel("*/ops/pallas/roi_patch.py", 440),
                    train_launches["roi_patch_bwd"], bwd[0], max(r["err"] for r in bwd)),
        kernel_line("fused_residual", FUSED_SRC, tpu_kernel("*/ops/pallas/fused_residual.py", 118),
                    launches["fused_residual"], fused[0], max(r["err"] for r in fused)),
        kernel_line("roi_patch_variants", ROI_SRC, tpu_kernel("tools/exp_roi_variants.py", 27),
                    variant_launches, variants, variants["err"]),
        *single_level_lines(single),
        kernel_line("nms_keep@two_stage_" + two["nms"]["case"].replace(" ", "_"), NMS_SRC,
                    tpu_kernel("*/ops/pallas/nms_keep.py", 161),
                    two["serving"]["rpn_c4"]["nms_keep"], two["nms"], two["nms"]["err"]),
        kernel_line("nms_keep@single_stage_cascade_" + ssc["nms"]["case"].replace(" ", "_"),
                    NMS_SRC, tpu_kernel("*/ops/pallas/nms_keep.py", 161),
                    ssc["serving"]["retinanet"]["nms_keep"], ssc["nms"], ssc["nms"]["err"]),
        *keypoint_lines(kp),
        *dconv_lines(dc),
        kernel_line("nms_keep@" + case_label("yolov4", yolo["nms"]["serving"]["case"]), NMS_SRC,
                    tpu_kernel("*/ops/pallas/nms_keep.py", 161), yolo["serving"]["nms_keep"],
                    yolo["nms"]["serving"], yolo["nms"]["serving"]["err"]),
        # launches: the yolov4 gate's run (its evaluations: a batch of 8 and 8 of 1)
        kernel_line("nms_keep@" + case_label("yolov4", yolo["nms"]["gate"]["case"]), NMS_SRC,
                    tpu_kernel("*/ops/pallas/nms_keep.py", 161),
                    gates["yolov4"]["launches"]["nms_keep"], yolo["nms"]["gate"],
                    yolo["nms"]["gate"]["err"]),
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    try:
        main()
    finally:
        for child in CHILDREN:
            if child.poll() is None:
                child.kill()
    sys.exit(0)
