"""Build sharded TFRecords from a COCO-format dataset.

    python -m detectron2_tensorflow_tpu_torch.tools.build_records --config_file CFG [KEY VALUE ...]

The port's counterpart of the repo's ``build_records.py``: for the splits
``DATASETS.TRAIN`` and ``DATASETS.VAL`` under ``BUILD_RECORDS.ROOT_DIR``
(else ``DATASETS.ROOT_DIR``), ``<split>.json`` + ``<split>/`` become
``<DATASETS.ROOT_DIR>/<split>.record-*`` (``BUILD_RECORDS.TRAIN_NUM_SHARDS``
and ``VAL_NUM_SHARDS`` shards), and ``category_map.json`` records the class
names and the dataset's category ids. ``BUILD_RECORDS.TYPE`` ``coco_det``
(masks only with ``INCLUDE_MASKS``), ``coco_inst`` and ``coco_pano``: the
COCO-panoptic layout ``<split>_panoptic.json`` + ``<split>_panoptic/`` id
maps + ``<split>/`` images (``data.CocoPanopticDataset``), whose records
carry the thing instances with masks and the semantic map
(``image/sem_seg``), and whose ``category_map.json`` names the thing and
stuff classes. A split without its JSON is skipped with a warning.
"""

from __future__ import annotations

import argparse
import json
import logging
import os

from ..config import get_cfg
from ..data import CocoDataset, CocoPanopticDataset, build_records


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config_file", required=True)
    p.add_argument("opts", nargs=argparse.REMAINDER, help="KEY VALUE overrides")
    return p.parse_args(argv)


def main(argv=None):
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    cfg = get_cfg()
    cfg.merge_from_file(args.config_file)
    if args.opts:
        cfg.merge_from_list(args.opts)
    kind = cfg.BUILD_RECORDS.TYPE
    if kind not in ("coco_det", "coco_inst", "coco_pano"):
        raise ValueError(f"unknown BUILD_RECORDS.TYPE '{kind}'")

    root = cfg.BUILD_RECORDS.ROOT_DIR or cfg.DATASETS.ROOT_DIR
    load_masks = kind != "coco_det" or cfg.BUILD_RECORDS.INCLUDE_MASKS
    panoptic = kind == "coco_pano"
    for split, shards in ((cfg.DATASETS.TRAIN, cfg.BUILD_RECORDS.TRAIN_NUM_SHARDS),
                          (cfg.DATASETS.VAL, cfg.BUILD_RECORDS.VAL_NUM_SHARDS)):
        ann = os.path.join(root, split + ("_panoptic.json" if panoptic else ".json"))
        if not os.path.isfile(ann):
            logging.warning("skipping %s (no %s)", split, ann)
            continue
        if panoptic:
            ds = CocoPanopticDataset(ann, os.path.join(root, split + "_panoptic"),
                                     os.path.join(root, split))
            cat_map = {"thing_classes": ds.thing_classes, "stuff_classes": ds.stuff_classes}
        else:
            ds = CocoDataset(ann, os.path.join(root, split), load_masks=load_masks)
            cat_map = {"thing_classes": ds.class_names,
                       "contiguous_to_coco_id": ds.contiguous_to_cat_id}
        paths = build_records(ds, os.path.join(cfg.DATASETS.ROOT_DIR, f"{split}.record"), shards)
        logging.info("wrote %d shards for %s", len(paths), split)
        with open(os.path.join(cfg.DATASETS.ROOT_DIR, cfg.DATASETS.CATEGORY_MAP_NAME), "w") as fp:
            json.dump(cat_map, fp)


if __name__ == "__main__":
    main()
