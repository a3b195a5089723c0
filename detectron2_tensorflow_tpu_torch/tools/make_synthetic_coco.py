"""Write a small synthetic COCO-format dataset to disk.

    python -m detectron2_tensorflow_tpu_torch.tools.make_synthetic_coco ROOT [N_TRAIN] [N_VAL]

The port's copy of the repo's ``tools/make_synthetic_coco.py`` (the
detection layout): ``<ROOT>/<split>/*.jpg``, ``<ROOT>/<split>.json`` (COCO
annotations with polygon segmentations) and ``<ROOT>/category_map.json``,
for the splits ``train`` (seed 0) and ``val`` (seed 100). Each 240x320
image is flat noise with 1-3 solid shapes whose class is their colour
(square, disk, stripe). The random draws are the original's, so the
annotations equal its annotations; the shapes are drawn with numpy (a disk
is the set of pixel centres inside its ellipse, where ``cv2.ellipse`` fills
its polygon approximation) and the JPEGs written by PIL at quality 95. The
panoptic layout (``--panoptic``) waits for the panoptic family.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

from ..data import image_io

CLASSES = ("square", "disk", "stripe")
COLORS = ((230, 60, 60), (60, 230, 60), (60, 60, 230))
H, W = 240, 320


def _fill_rect(img, x0, y0, x1, y1, color):
    """Solid rectangle with both corners included, as ``cv2.rectangle(...,
    -1)`` draws it."""
    img[max(y0, 0):y1 + 1, max(x0, 0):x1 + 1] = color


def _fill_ellipse(img, cx, cy, ax, ay, color):
    ys, xs = np.mgrid[0:img.shape[0], 0:img.shape[1]]
    inside = ((xs - cx) / max(ax, 1e-9)) ** 2 + ((ys - cy) / max(ay, 1e-9)) ** 2 <= 1.0
    img[inside] = color


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
        _fill_ellipse(img, cx, cy, bw // 2, bh // 2, color)
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


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if "--panoptic" in argv:
        raise NotImplementedError("the panoptic layout (--panoptic) waits for the panoptic family")
    root = argv[0] if argv else "synthetic_coco"
    n_train = int(argv[1]) if len(argv) > 1 else 16
    n_val = int(argv[2]) if len(argv) > 2 else 8
    os.makedirs(root, exist_ok=True)
    ni, na = make_split(root, "train", n_train, seed=0)
    vi, va = make_split(root, "val", n_val, seed=100)
    with open(os.path.join(root, "category_map.json"), "w") as f:
        json.dump({"thing_classes": list(CLASSES)}, f)
    print(json.dumps({"root": root, "train": [ni, na], "val": [vi, va]}))


if __name__ == "__main__":
    main()
