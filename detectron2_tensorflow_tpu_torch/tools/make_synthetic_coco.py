"""Write a small synthetic COCO-format dataset to disk.

    python -m detectron2_tensorflow_tpu_torch.tools.make_synthetic_coco ROOT [N_TRAIN] [N_VAL]
        [--panoptic]

The port's copy of the repo's ``tools/make_synthetic_coco.py``: for the
splits ``train`` (seed 0) and ``val`` (seed 100), ``<ROOT>/<split>/*.jpg``,
``<ROOT>/<split>.json`` (COCO annotations with polygon segmentations) and
``<ROOT>/category_map.json``. Each 240x320 image is flat noise with 1-3
solid shapes whose class is their colour (square, disk, stripe). With
``--panoptic`` the COCO-panoptic layout instead: ``<split>_panoptic.json``
and ``<split>_panoptic/*.png`` id maps beside the images, a sky band
(stuff ``sky``, id 11) over the floor (stuff ``floor``, id 10), each
shape a thing segment of the pixels its drawing changed, and a
``category_map.json`` with the stuff classes ("things" first). The random
draws and the drawing are the original's (``data.polygon.fill_ellipse`` is
``cv2.ellipse``'s fill), so the annotations and the decoded id maps equal
its own; the JPEGs are written by PIL at quality 95, so the images equal
its images up to the encoders' rounding.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..data import image_io
from ..data.panoptic import id_to_rgb
from ..data.polygon import fill_ellipse

CLASSES = ("square", "disk", "stripe")
COLORS = ((230, 60, 60), (60, 230, 60), (60, 60, 230))
H, W = 240, 320


def _fill_rect(img, x0, y0, x1, y1, color):
    """Solid rectangle with both corners included, as ``cv2.rectangle(...,
    -1)`` draws it."""
    img[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1] = color


def draw_instance(rng, img, cls):
    """Draw one instance; returns (bbox xywh, polygon, area)."""
    bw = int(rng.integers(40, 90))
    bh = int(rng.integers(40, 90))
    x0 = int(rng.integers(0, W - bw))
    y0 = int(rng.integers(0, H - bh))
    color = COLORS[cls]
    if cls == 0:  # square
        _fill_rect(img, x0, y0, x0 + bw, y0 + bh, color)
        poly = [x0, y0, x0 + bw, y0, x0 + bw, y0 + bh, x0, y0 + bh]
        area = bw * bh
    elif cls == 1:  # disk
        cx, cy = x0 + bw // 2, y0 + bh // 2
        fill_ellipse(img, (cx, cy), (bw // 2, bh // 2), color)
        poly = []
        for t in np.linspace(0, 2 * np.pi, 16, endpoint=False):
            poly += [cx + bw / 2 * np.cos(t), cy + bh / 2 * np.sin(t)]
        area = np.pi * (bw / 2) * (bh / 2)
    else:  # stripe (thin rectangle)
        bh2 = max(12, bh // 3)
        _fill_rect(img, x0, y0, x0 + bw, y0 + bh2, color)
        poly = [x0, y0, x0 + bw, y0, x0 + bw, y0 + bh2, x0, y0 + bh2]
        bh = bh2
        area = bw * bh
    return [x0, y0, bw, bh], [float(v) for v in poly], float(area)


def make_split(root, split, n, seed):
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, split)
    os.makedirs(img_dir, exist_ok=True)
    images, annotations = [], []
    ann_id = 1
    for i in range(n):
        img = rng.integers(90, 130, (H, W, 3), np.uint8).copy()
        k = int(rng.integers(1, 4))
        for _ in range(k):
            cls = int(rng.integers(0, len(CLASSES)))
            bbox, poly, area = draw_instance(rng, img, cls)
            annotations.append({
                "id": ann_id,
                "image_id": i + 1,
                "category_id": cls + 1,
                "bbox": bbox,
                "area": area,
                "segmentation": [poly],
                "iscrowd": 0,
            })
            ann_id += 1
        name = f"{i:06d}.jpg"
        with open(os.path.join(img_dir, name), "wb") as f:
            f.write(image_io.encode_jpeg(img))
        images.append({"id": i + 1, "file_name": name, "height": H, "width": W})

    coco = {
        "images": images,
        "annotations": annotations,
        "categories": [{"id": c + 1, "name": n_} for c, n_ in enumerate(CLASSES)],
    }
    with open(os.path.join(root, split + ".json"), "w") as f:
        json.dump(coco, f)
    return len(images), len(annotations)


STUFF = ("floor", "sky")  # category ids 10, 11; panoptic splits only


def make_panoptic_split(root, split, n, seed):
    """The COCO-panoptic layout of one split (module docstring); returns the
    image count."""
    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, split)
    pan_dir = os.path.join(root, split + "_panoptic")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(pan_dir, exist_ok=True)
    images, annotations = [], []
    for i in range(n):
        img = rng.integers(90, 130, (H, W, 3), np.uint8).copy()
        sky_h = int(rng.integers(30, 70))
        img[:sky_h] = (200, 210, 235)
        seg = np.ones((H, W), np.int64)  # floor
        seg[:sky_h] = 2  # sky
        segments = [{"id": 1, "category_id": 10, "iscrowd": 0, "area": int((seg == 1).sum())},
                    {"id": 2, "category_id": 11, "iscrowd": 0, "area": int((seg == 2).sum())}]
        for j in range(int(rng.integers(1, 4))):
            cls = int(rng.integers(0, len(CLASSES)))
            before = img.copy()
            draw_instance(rng, img, cls)
            # The segment is the pixels this draw changed (an earlier shape of
            # the same colour keeps its own).
            region = (img != before).any(axis=2)
            seg[region] = 10 + j
            segments.append({"id": 10 + j, "category_id": cls + 1, "iscrowd": 0,
                             "area": int(region.sum())})
        segments[0]["area"] = int((seg == 1).sum())  # the stuff under the things
        segments[1]["area"] = int((seg == 2).sum())
        name = f"{i:06d}"
        with open(os.path.join(img_dir, name + ".jpg"), "wb") as f:
            f.write(image_io.encode_jpeg(img))
        with open(os.path.join(pan_dir, name + ".png"), "wb") as f:
            f.write(image_io.encode_png_rgb(id_to_rgb(seg)))
        images.append({"id": i + 1, "file_name": name + ".jpg", "height": H, "width": W})
        annotations.append({"image_id": i + 1, "file_name": name + ".png",
                            "segments_info": segments})
    pano = {
        "images": images,
        "annotations": annotations,
        "categories": ([{"id": c + 1, "name": n_, "isthing": 1} for c, n_ in enumerate(CLASSES)]
                       + [{"id": 10 + c, "name": n_, "isthing": 0}
                          for c, n_ in enumerate(STUFF)]),
    }
    with open(os.path.join(root, split + "_panoptic.json"), "w") as f:
        json.dump(pano, f)
    return len(images)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    panoptic = "--panoptic" in argv
    argv = [a for a in argv if a != "--panoptic"]
    root = argv[0] if argv else "synthetic_coco"
    n_train = int(argv[1]) if len(argv) > 1 else 16
    n_val = int(argv[2]) if len(argv) > 2 else 8
    os.makedirs(root, exist_ok=True)
    if panoptic:
        ni = make_panoptic_split(root, "train", n_train, seed=0)
        vi = make_panoptic_split(root, "val", n_val, seed=100)
        with open(os.path.join(root, "category_map.json"), "w") as f:
            json.dump({"thing_classes": list(CLASSES), "stuff_classes": ["things"] + list(STUFF)},
                      f)
        print(json.dumps({"root": root, "panoptic": True, "train": ni, "val": vi}))
        return
    ni, na = make_split(root, "train", n_train, seed=0)
    vi, va = make_split(root, "val", n_val, seed=100)
    with open(os.path.join(root, "category_map.json"), "w") as f:
        json.dump({"thing_classes": list(CLASSES)}, f)
    print(json.dumps({"root": root, "train": [ni, na], "val": [vi, va]}))


if __name__ == "__main__":
    main()
