"""Sharded TFRecords of ``tf.train.Example``: building them from a COCO
dataset and reading them back.

Port of the JAX package's ``data/records.py`` over the port's own codec
(``tfrecord_codec``) and PIL (``image_io``): the same field names, the same
sharding (``<pattern>-00000-of-00016``, example ``i`` in shard ``i % n``),
the source JPEG bytes copied verbatim, masks as 8-bit PNGs, and a semantic
label map (``BUILD_RECORDS.TYPE coco_pano``) as ``image/sem_seg``, the RGB
id-map PNG of ``data.panoptic.id_to_rgb`` with the ignore label -1 stored
as 256^3 - 1. Either package reads the shards the other writes: the PNG
bytes differ from ``cv2``'s, the maps they decode to do not. Reading is
lazy: each shard is indexed once, and a sample's record is read, its CRC
checked and decoded on demand.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List

import numpy as np

from . import image_io
from . import tfrecord_codec as codec
from .panoptic import decode_label_map, encode_label_map


def create_example(sample: Dict, image_bytes: bytes) -> bytes:
    """Sample dict (+ its encoded image) -> a serialized ``tf.train.Example``
    with the reference's ``TfExampleFields`` names."""
    boxes = np.asarray(sample["boxes"], np.float32).reshape(-1, 4)
    h, w = sample["height"], sample["width"]
    feature = {
        "image/encoded": codec.bytes_feature([image_bytes]),
        "image/format": codec.bytes_feature([b"jpeg"]),
        "image/height": codec.int64_feature([h]),
        "image/width": codec.int64_feature([w]),
        "image/source_id": codec.bytes_feature([str(sample["image_id"]).encode()]),
        "image/object/bbox/xmin": codec.float_feature(boxes[:, 0] / w),
        "image/object/bbox/ymin": codec.float_feature(boxes[:, 1] / h),
        "image/object/bbox/xmax": codec.float_feature(boxes[:, 2] / w),
        "image/object/bbox/ymax": codec.float_feature(boxes[:, 3] / h),
        "image/object/class/label": codec.int64_feature(sample["classes"]),
        "image/object/is_crowd": codec.int64_feature(np.asarray(sample["is_crowd"], np.int64)),
    }
    if sample.get("areas") is not None and len(sample["areas"]):
        feature["image/object/area"] = codec.float_feature(sample["areas"])
    if sample.get("masks") is not None and len(sample["masks"]):
        feature["image/object/mask"] = codec.bytes_feature(
            [image_io.encode_png(np.asarray(m).astype(np.uint8)) for m in sample["masks"]])
    if sample.get("sem_seg") is not None:
        feature["image/sem_seg"] = codec.bytes_feature([encode_label_map(sample["sem_seg"])])
    return codec.encode_example(feature)


def build_records(dataset, output_pattern: str, num_shards: int = 16) -> List[str]:
    """Write a ``CocoDataset``-like dataset into ``num_shards`` TFRecord
    shards named ``<output_pattern>-00000-of-00016``; returns their paths.
    A sample whose ``image_path`` is a JPEG file keeps that file's bytes;
    any other image is encoded as JPEG."""
    paths = [f"{output_pattern}-{i:05d}-of-{num_shards:05d}" for i in range(num_shards)]
    os.makedirs(os.path.dirname(output_pattern) or ".", exist_ok=True)
    writers = [open(p, "wb") for p in paths]
    try:
        for idx in range(len(dataset)):
            s = dataset[idx]
            img = s["image"]
            path = dataset.image_path(idx) if hasattr(dataset, "image_path") else None
            if path and path.lower().endswith((".jpg", ".jpeg")):
                with open(path, "rb") as fh:
                    data = fh.read()
            else:
                data = image_io.encode_jpeg(img)
            ex = create_example(
                {
                    "image_id": s.get("image_id", idx),
                    "height": img.shape[0],
                    "width": img.shape[1],
                    "boxes": s["boxes"],
                    "classes": s["classes"],
                    "is_crowd": s["is_crowd"],
                    "areas": s.get("areas"),
                    "masks": s.get("masks"),
                    "sem_seg": s.get("sem_seg"),
                },
                data,
            )
            codec.write_record(writers[idx % num_shards], ex)
    finally:
        for w in writers:
            w.close()
    return paths


class TFRecordDataset:
    """Indexable view over sharded TFRecords producing numpy sample dicts.

    Shards are indexed at construction (payload offsets only); each
    ``__getitem__`` reads one record, checks its CRC and decodes it. The
    class names (``class_names``) and, when ``build_records`` wrote them,
    the dataset's category ids (``contiguous_to_cat_id``, which a results
    file needs) come from the ``category_map.json`` beside the shards.
    """

    def __init__(self, file_pattern: str, load_masks: bool = True):
        self.files = sorted(glob.glob(file_pattern))
        assert self.files, f"no records match {file_pattern}"
        self.load_masks = load_masks
        self.class_names = None
        cat_path = os.path.join(os.path.dirname(self.files[0]), "category_map.json")
        if os.path.exists(cat_path):
            with open(cat_path) as fp:
                cats = json.load(fp)
            self.class_names = cats.get("thing_classes")
            if "contiguous_to_coco_id" in cats:
                self.contiguous_to_cat_id = {
                    int(k): int(v) for k, v in cats["contiguous_to_coco_id"].items()}
        self._index: List[tuple] = []  # (file_idx, offset, length)
        for fi, f in enumerate(self.files):
            for off, length in codec.index_records(f):
                self._index.append((fi, off, length))

    def __len__(self) -> int:
        return len(self._index)

    @staticmethod
    def _feature(f, name, kind, default):
        if name not in f:
            return default
        k, v = f[name]
        assert k == kind, (name, k, kind)
        return v

    def _example(self, idx: int) -> Dict:
        fi, off, length = self._index[idx]
        return codec.decode_example(
            codec.read_record_at(self.files[fi], off, length, verify=True))

    def __getitem__(self, idx: int) -> Dict:
        f = self._example(idx)
        img = image_io.decode_image(self._feature(f, "image/encoded", "bytes", [b""])[0])
        h, w = img.shape[:2]
        empty_f = np.zeros(0, np.float32)
        xmin = self._feature(f, "image/object/bbox/xmin", "float", empty_f) * w
        ymin = self._feature(f, "image/object/bbox/ymin", "float", empty_f) * h
        xmax = self._feature(f, "image/object/bbox/xmax", "float", empty_f) * w
        ymax = self._feature(f, "image/object/bbox/ymax", "float", empty_f) * h
        boxes = (np.stack([xmin, ymin, xmax, ymax], axis=1).astype(np.float32)
                 if len(xmin) else np.zeros((0, 4), np.float32))
        empty_i = np.zeros(0, np.int64)
        sample = {
            "image": img,
            "image_id": int(self._feature(f, "image/source_id", "bytes", [b"0"])[0]),
            "boxes": boxes,
            "classes": np.asarray(
                self._feature(f, "image/object/class/label", "int64", empty_i), np.int32),
            "is_crowd": np.asarray(
                self._feature(f, "image/object/is_crowd", "int64", empty_i), bool),
        }
        areas = self._feature(f, "image/object/area", "float", empty_f)
        if len(areas):
            sample["areas"] = np.asarray(areas, np.float32)
        if self.load_masks:
            masks = [image_io.decode_gray(m)
                     for m in self._feature(f, "image/object/mask", "bytes", [])]
            sample["masks"] = (np.stack(masks).astype(np.float32) if masks
                               else np.zeros((0, h, w), np.float32))
        sem = self._feature(f, "image/sem_seg", "bytes", [])
        if len(sem):
            sample["sem_seg"] = decode_label_map(sem[0])
        return sample

    def image_id(self, idx: int) -> int:
        """Sample ``idx``'s id, without decoding its image."""
        return int(self._feature(self._example(idx), "image/source_id", "bytes", [b"0"])[0])
