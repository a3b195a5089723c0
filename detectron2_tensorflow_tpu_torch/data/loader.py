"""Batched, bucketed, fixed-shape data loading.

Port of ``pick_bucket``, ``pad_sample_to_batch_arrays`` and
``build_dataloader`` of the JAX package's ``data/loader.py``:

* images are padded to the smallest of ``cfg.INPUT.PAD_BUCKETS`` that fits,
  so the model sees a small static set of shapes, and samples are batched
  per bucket;
* GT is padded to ``cfg.INPUT.MAX_GT_INSTANCES`` with validity masks
  (keypoints too: ``gt_keypoints [G, K, 3]``, zero in the padded slots);
  masks become ``MINI_MASK_SIZE`` mini-masks ``gt_masks``, and a sample
  with masks under ``TRANSFORM.RESIZE.USE_MINI_MASKS False`` raises (the
  JAX loader fails there on a broadcast); a semantic map becomes
  ``gt_sem_seg [bh, bw]`` int32, -1 in the padding;
* precomputed proposals (``MODEL.LOAD_PROPOSALS``) fill fixed top-k slots
  ``proposal_boxes [K, 4]``, ``proposal_scores [K]`` and
  ``proposal_valid [K]``, best score first (a stable sort), empty slots
  scored -1e10, with ``K`` = ``DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN``
  or ``_TEST``;
* ``DATALOADER.NUM_READERS`` threads transform samples in order, each with
  its own seed, and a thread keeps ``NUM_PREFETCH_BATCHES`` batches ready;
* evaluation takes every ``SAMPLE_1_OF_N``-th image once and pads the last
  batch of each bucket with copies whose ``image_id`` is -1.

The JAX package's native (C++ JPEG) loaders wait for the file datasets.
Unlike the JAX loader, an error in a reader is raised to the consumer
instead of ending the stream.
"""

from __future__ import annotations

import collections
import concurrent.futures as cf
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from . import transforms


def pick_bucket(h: int, w: int, buckets: Sequence[tuple]) -> tuple:
    """Smallest bucket that fits (h, w); falls back to the largest."""
    best = None
    for bh, bw in buckets:
        if h <= bh and w <= bw:
            area = bh * bw
            if best is None or area < best[0]:
                best = (area, (bh, bw))
    if best is not None:
        return best[1]
    return max(buckets, key=lambda b: b[0] * b[1])


def pad_sample_to_batch_arrays(sample: Dict, bucket, max_gt: int, mini_mask: int) -> Dict:
    """One transformed sample -> fixed-shape numpy arrays."""
    bh, bw = bucket
    img = sample["image"]
    h, w = img.shape[:2]
    image = np.zeros((bh, bw, 3), np.float32)
    image[:h, :w] = img

    n = len(sample["boxes"])
    keep = min(n, max_gt)
    gt_boxes = np.zeros((max_gt, 4), np.float32)
    gt_classes = np.zeros((max_gt,), np.int32)
    gt_valid = np.zeros((max_gt,), bool)
    gt_is_crowd = np.zeros((max_gt,), bool)
    gt_boxes[:keep] = sample["boxes"][:keep]
    gt_classes[:keep] = sample["classes"][:keep]
    gt_valid[:keep] = True
    gt_is_crowd[:keep] = sample["is_crowd"][:keep]

    out = {
        "image_size": np.array([h, w], np.int32),
        "original_size": np.asarray(sample.get("original_size", (h, w)), np.int32),
        "image_id": np.asarray(sample.get("image_id", 0), np.int64),
        "gt_boxes": gt_boxes,
        "gt_classes": gt_classes,
        "gt_valid": gt_valid,
        "gt_is_crowd": gt_is_crowd,
        "image": image,
    }
    if sample.get("masks") is not None:
        gt_masks = np.zeros((max_gt, mini_mask, mini_mask), np.float32)
        gt_masks[:keep] = sample["masks"][:keep]
        out["gt_masks"] = gt_masks
    if sample.get("keypoints") is not None:
        gt_kp = np.zeros((max_gt, sample["keypoints"].shape[1], 3), np.float32)
        gt_kp[:keep] = sample["keypoints"][:keep]
        out["gt_keypoints"] = gt_kp
    if sample.get("sem_seg") is not None:
        sem = np.full((bh, bw), -1, np.int32)
        sem[:h, :w] = sample["sem_seg"]
        out["gt_sem_seg"] = sem
    if sample.get("proposals") is not None:
        out.update(proposal_slots(sample["proposals"], sample.get("proposal_scores"),
                                  int(sample.get("proposal_topk", 1000))))
    return out


def proposal_slots(proposals, scores, topk: int) -> Dict[str, np.ndarray]:
    """The ``topk`` best-scored proposals in fixed slots (the JAX loader's
    rule): a stable sort by descending score, empty slots zero boxes scored
    -1e10 and invalid. Missing scores are zeros."""
    props = np.asarray(proposals, np.float32).reshape(-1, 4)
    scores = np.asarray(scores if scores is not None else np.zeros(len(props)), np.float32)
    order = np.argsort(-scores, kind="stable")[:topk]
    boxes = np.zeros((topk, 4), np.float32)
    slot_scores = np.full((topk,), -1e10, np.float32)
    valid = np.zeros((topk,), bool)
    boxes[:len(order)] = props[order]
    slot_scores[:len(order)] = scores[order]
    valid[:len(order)] = True
    return {"proposal_boxes": boxes, "proposal_scores": slot_scores, "proposal_valid": valid}


def _stack(batch: List[Dict]) -> Dict[str, np.ndarray]:
    return {k: np.stack([b[k] for b in batch]) for k in batch[0]}


def build_dataloader(
    cfg,
    dataset,
    training: bool,
    batch_size: Optional[int] = None,
    seed: int = 0,
    num_prefetch: Optional[int] = None,
) -> Iterator[Dict[str, np.ndarray]]:
    """Yield fixed-shape batch dicts of numpy arrays forever (training) or
    for one epoch (evaluation).

    ``dataset``: indexable, returning transform-ready sample dicts (for
    example :class:`.synthetic.SyntheticDataset`). Batches group samples by
    pad bucket.
    """
    batch_size = batch_size or cfg.SOLVER.IMS_PER_BATCH
    buckets = [tuple(b) for b in cfg.INPUT.PAD_BUCKETS]
    max_gt = cfg.INPUT.MAX_GT_INSTANCES
    mini = cfg.TRANSFORM.RESIZE.MINI_MASK_SIZE
    use_mini_masks = cfg.TRANSFORM.RESIZE.USE_MINI_MASKS
    rng = np.random.default_rng(seed)
    num_readers = max(1, cfg.DATALOADER.NUM_READERS)
    proposal_topk = (cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TRAIN if training
                     else cfg.DATASETS.PRECOMPUTED_PROPOSAL_TOPK_TEST)

    def index_stream():
        while True:
            order = np.arange(len(dataset))
            if training and cfg.DATALOADER.SHUFFLE:
                rng.shuffle(order)
            if not training and cfg.DATALOADER.SAMPLE_1_OF_N > 1:
                order = order[:: cfg.DATALOADER.SAMPLE_1_OF_N]
            yield from (int(i) for i in order)
            if not training:
                return

    def load_one(args):
        i, seed_i = args
        raw = dataset[i]
        orig_size = raw["image"].shape[:2]
        # A per-sample generator keeps augmentation deterministic across readers.
        s, _ = transforms.run(cfg, raw, training, np.random.default_rng(seed_i))
        s["original_size"] = orig_size
        if s.get("proposals") is not None:
            s["proposal_topk"] = proposal_topk
        return s

    def sample_stream():
        seeds = np.random.default_rng(seed).integers(0, 2**31, size=1 << 20)
        tagged = ((i, int(seeds[k % len(seeds)])) for k, i in enumerate(index_stream()))
        if num_readers == 1:
            for args in tagged:
                yield load_one(args)
            return
        # A bounded window of futures: pool.map would drain the endless stream.
        with cf.ThreadPoolExecutor(num_readers) as pool:
            inflight = collections.deque()
            for args in tagged:
                inflight.append(pool.submit(load_one, args))
                if len(inflight) >= 2 * num_readers:
                    yield inflight.popleft().result()
            while inflight:
                yield inflight.popleft().result()

    def batch_stream():
        pools: Dict[tuple, List[Dict]] = {}
        for s in sample_stream():
            if s.get("masks") is not None and not use_mini_masks:
                raise ValueError(
                    "TRANSFORM.RESIZE.USE_MINI_MASKS is False, but the loader collates masks "
                    f"as {mini}x{mini} mini-masks (gt_masks), the only targets the mask losses "
                    "read (the JAX loader fails here on a broadcast): set "
                    "TRANSFORM.RESIZE.USE_MINI_MASKS True")
            h, w = s["image"].shape[:2]
            bucket = pick_bucket(h, w, buckets)
            pools.setdefault(bucket, []).append(pad_sample_to_batch_arrays(s, bucket, max_gt, mini))
            if len(pools[bucket]) == batch_size:
                yield _stack(pools.pop(bucket))
        if not training:
            # Pad each remainder with copies of its last sample, marked by an
            # image_id of -1, so that the batch shape stays static.
            for batch in pools.values():
                while len(batch) < batch_size:
                    pad = dict(batch[-1])
                    pad["image_id"] = np.asarray(-1, np.int64)
                    batch.append(pad)
                yield _stack(batch)

    n_prefetch = num_prefetch if num_prefetch is not None else max(
        1, cfg.DATALOADER.NUM_PREFETCH_BATCHES)
    q: queue.Queue = queue.Queue(maxsize=n_prefetch)
    done = object()
    stop = threading.Event()

    def worker():
        try:
            for b in batch_stream():
                if stop.is_set():
                    return
                q.put(b)
            q.put(done)
        except Exception as e:  # noqa: BLE001 — raised again in the consumer
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, Exception):
                raise item
            yield item
    finally:
        stop.set()
        while not q.empty():  # unblock a worker waiting to put
            q.get_nowait()
