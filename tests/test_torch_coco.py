"""COCO-format data of the port against the JAX package's: image decoding
(PIL against ``cv2``), polygon filling (``polygon.fill_poly`` against
``cv2.fillPoly``), ``CocoDataset``, the CLIs' choice of dataset format, the
loader over records and the synthetic-COCO tool.

Images must be bit-equal and masks equal. ``fill_poly`` equals
``cv2.fillPoly`` pixel for pixel for every polygon whose vertices lie in the
image (rectangles, the synthetic set's 16-vertex ellipses, random convex,
concave and self-intersecting polygons). Where a vertex lies outside the
image, OpenCV (5.0 here) clips the edge lines by rules the port does not
reproduce; those polygons are held to the largest difference found on the
seeded sets below, pinned: 21 pixels for vertices rounded from [0, W] x
[0, H] (COCO polygons reach x = W after rounding), 54 for vertices up to 15
pixels beyond the image.
"""

import io
import json
import os
import subprocess
import sys
from pathlib import Path

import cv2
import numpy as np
import pytest
from PIL import Image

import eval as jax_eval
import train as jax_train
from detectron2_tensorflow_tpu.config import get_cfg as jax_get_cfg
from detectron2_tensorflow_tpu.data import CocoDataset as JaxCocoDataset
from detectron2_tensorflow_tpu.data import build_dataloader as jax_build_dataloader
from detectron2_tensorflow_tpu.data import coco as jcoco
from detectron2_tensorflow_tpu.data import records as jrecords
from detectron2_tensorflow_tpu.evaluation import rle as jrle
from detectron2_tensorflow_tpu_torch.config import get_cfg
from detectron2_tensorflow_tpu_torch.data import (
    CocoDataset,
    TFRecordDataset,
    build_dataloader,
    build_records,
    image_io,
)
from detectron2_tensorflow_tpu_torch.data import coco as tcoco
from detectron2_tensorflow_tpu_torch.data.polygon import fill_poly
from detectron2_tensorflow_tpu_torch.tools import eval as tools_eval
from detectron2_tensorflow_tpu_torch.tools import make_synthetic_coco
from detectron2_tensorflow_tpu_torch.tools import train as tools_train
from test_torch_data import assert_batches_match

REPO = Path(__file__).resolve().parents[1]
# The largest count of pixels where fill_poly and cv2.fillPoly differ on the
# seeded sets of polygons with vertices outside the image (module docstring).
PINNED_EDGE_DIFF = {"to_the_edge": 21, "beyond": 54}


@pytest.fixture(scope="module")
def jax_coco(tmp_path_factory):
    """A synthetic COCO directory written by the JAX package's tool."""
    root = tmp_path_factory.mktemp("coco")
    subprocess.run([sys.executable, "tools/make_synthetic_coco.py", str(root), "6", "3"],
                   cwd=REPO, check=True, capture_output=True)
    return root


# -- images -------------------------------------------------------------------

def _image(seed=0, h=61, w=83):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, (h, w, 3), np.uint8)
    img[10:30, 5:50] = (200, 30, 40)
    return img


def _cv2_color(data):
    return cv2.imdecode(np.frombuffer(data, np.uint8), cv2.IMREAD_COLOR)[..., ::-1]


@pytest.mark.parametrize("quality", [75, 95, 100])
def test_jpeg_decodes_bit_equal_to_cv2(quality):
    ok, buf = cv2.imencode(".jpg", _image()[..., ::-1], [cv2.IMWRITE_JPEG_QUALITY, quality])
    np.testing.assert_array_equal(image_io.decode_image(buf.tobytes()), _cv2_color(buf.tobytes()))


def test_grayscale_jpeg_becomes_three_equal_channels():
    ok, buf = cv2.imencode(".jpg", _image()[..., 0])
    got = image_io.decode_image(buf.tobytes())
    assert got.shape == (61, 83, 3)
    np.testing.assert_array_equal(got, _cv2_color(buf.tobytes()))


def test_cmyk_jpeg_follows_cv2():
    buf = io.BytesIO()
    Image.fromarray(_image()).convert("CMYK").save(buf, "JPEG", quality=95)
    np.testing.assert_array_equal(image_io.decode_image(buf.getvalue()),
                                  _cv2_color(buf.getvalue()))


@pytest.mark.parametrize("orientation", [1, 3, 6, 8])
def test_exif_orientation_applied_as_cv2_does(tmp_path, orientation):
    pil = Image.fromarray(_image())
    exif = pil.getexif()
    exif[0x0112] = orientation
    path = tmp_path / "o.jpg"
    pil.save(path, "JPEG", quality=95, exif=exif.tobytes())
    data = path.read_bytes()
    np.testing.assert_array_equal(image_io.decode_image(data), _cv2_color(data))
    np.testing.assert_array_equal(image_io.load_image_rgb(str(path)),
                                  jcoco.load_image_rgb(str(path)))


@pytest.mark.parametrize("mode", ["RGBA", "P", "L"])
def test_png_decodes_as_cv2(mode):
    buf = io.BytesIO()
    Image.fromarray(_image()).convert(mode).save(buf, "PNG")
    np.testing.assert_array_equal(image_io.decode_image(buf.getvalue()),
                                  _cv2_color(buf.getvalue()))


def test_png_masks_round_trip_through_both_codecs():
    mask = (np.random.default_rng(1).uniform(size=(40, 52)) > 0.5).astype(np.uint8)
    ours = image_io.encode_png(mask)
    np.testing.assert_array_equal(
        cv2.imdecode(np.frombuffer(ours, np.uint8), cv2.IMREAD_GRAYSCALE), mask)
    np.testing.assert_array_equal(image_io.decode_gray(jrecords._png_encode(mask)), mask)


def test_encode_jpeg_decodes_close_to_the_source():
    """Quality 95 on a smooth image: within a few levels of the source, as
    cv2.imencode's default is."""
    y, x = np.mgrid[0:64, 0:96]
    img = np.stack([x * 2, y * 3, (x + y)], -1).astype(np.uint8)
    got = _cv2_color(image_io.encode_jpeg(img)).astype(int)
    ok, buf = cv2.imencode(".jpg", img[..., ::-1])
    theirs = _cv2_color(buf.tobytes()).astype(int)
    assert np.abs(got - img).mean() < 1.5 and np.abs(theirs - img).mean() < 1.5


# -- polygons -----------------------------------------------------------------

def _cv2_fill(h, w, pts):
    mask = np.zeros((h, w), np.uint8)
    cv2.fillPoly(mask, [np.asarray(pts, np.int32)], 1)
    return mask


def _port_fill(h, w, pts):
    mask = np.zeros((h, w), np.uint8)
    fill_poly(mask, pts, 1)
    return mask


def _polygons(kind, seed, count=1000):
    rng = np.random.default_rng(seed)
    for _ in range(count):
        h, w = (int(v) for v in rng.integers(5, 80, 2))
        n = int(rng.integers(3, 16))
        if kind == "inside":  # convex, concave and self-intersecting alike
            pts = np.stack([rng.integers(0, w, n), rng.integers(0, h, n)], 1)
        elif kind == "star":
            ang = np.sort(rng.uniform(0, 2 * np.pi, n))
            r = rng.uniform(1, min(h, w) / 2, n)
            pts = np.stack([np.clip(np.round(w / 2 + r * np.cos(ang)), 0, w - 1),
                            np.clip(np.round(h / 2 + r * np.sin(ang)), 0, h - 1)], 1)
        elif kind == "to_the_edge":
            pts = np.round(np.stack([rng.uniform(0, w, n), rng.uniform(0, h, n)], 1))
        else:  # beyond
            pts = np.stack([rng.integers(-15, w + 15, n), rng.integers(-15, h + 15, n)], 1)
        yield h, w, pts.astype(np.int64)


@pytest.mark.parametrize("kind,seed", [("inside", 0), ("inside", 1), ("star", 2)])
def test_fill_poly_equals_cv2_inside_the_image(kind, seed):
    for h, w, pts in _polygons(kind, seed):
        np.testing.assert_array_equal(_port_fill(h, w, pts), _cv2_fill(h, w, pts),
                                      err_msg=f"{h}x{w} {pts.tolist()}")


@pytest.mark.parametrize("kind", sorted(PINNED_EDGE_DIFF))
def test_fill_poly_outside_the_image_pinned(kind):
    worst = max(int((_port_fill(h, w, p) != _cv2_fill(h, w, p)).sum())
                for h, w, p in _polygons(kind, 0))
    assert worst == PINNED_EDGE_DIFF[kind]


def test_fill_poly_equals_cv2_on_synthetic_shapes():
    """Every polygon the synthetic tool writes, rasterized as both packages'
    segmentation_to_mask does it."""
    rng = np.random.default_rng(4)
    for _ in range(300):
        img = np.zeros((240, 320, 3), np.uint8)
        cls = int(rng.integers(0, 3))
        _, poly, _ = make_synthetic_coco.draw_instance(rng, img, cls)
        np.testing.assert_array_equal(tcoco.segmentation_to_mask([poly], 240, 320),
                                      jcoco.segmentation_to_mask([poly], 240, 320))


# -- CocoDataset --------------------------------------------------------------

def _assert_sample_equal(a, b, image=True):
    if image:
        np.testing.assert_array_equal(a["image"], b["image"])
    assert a["image_id"] == b["image_id"]
    assert a.keys() == b.keys()
    for k in a:
        if k in ("image", "image_id"):
            continue
        if isinstance(a[k], tuple):
            assert a[k] == b[k], k
            continue
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


def test_coco_dataset_matches_jax_on_synthetic_coco(jax_coco):
    args = (str(jax_coco / "train.json"), str(jax_coco / "train"))
    ours, theirs = CocoDataset(*args), JaxCocoDataset(*args)
    assert len(ours) == len(theirs) == 6
    assert ours.class_names == theirs.class_names
    assert ours.contiguous_to_cat_id == theirs.contiguous_to_cat_id
    for i in range(len(ours)):
        _assert_sample_equal(ours[i], theirs[i])
        _assert_sample_equal(ours.sample_gt(i), theirs.sample_gt(i), image=False)
        assert ours.image_path(i) == theirs.image_path(i)
        assert ours.image_id(i) == theirs.image_id(i)


def _handwritten_coco(tmp_path):
    """Three images: polygons, RLE (uncompressed counts and the compressed
    string), a crowd region, a box of zero width (dropped), keypoints, and
    non-contiguous category ids; a fourth image without annotations."""
    root = tmp_path / "hand"
    (root / "img").mkdir(parents=True)
    rng = np.random.default_rng(7)
    h, w = 50, 70
    images = []
    for i in range(4):
        cv2.imwrite(str(root / "img" / f"{i}.jpg"), rng.integers(0, 256, (h, w, 3), np.uint8))
        images.append({"id": 10 + i, "file_name": f"{i}.jpg", "height": h, "width": w})
    blob = np.zeros((h, w), np.uint8)
    blob[5:30, 10:40] = 1
    blob[12:20, 18:25] = 0
    enc = jrle.encode(blob)
    compressed = {"size": [h, w], "counts": enc["counts"].decode("ascii")}
    uncompressed = {"size": [h, w], "counts": [int(c) for c in jrle.encode_counts(blob)]}
    anns = [
        {"id": 1, "image_id": 10, "category_id": 7, "bbox": [3, 4, 20, 15], "area": 250.0,
         "segmentation": [[3, 4, 23, 4, 23, 19, 3, 19], [30, 30, 40, 45, 25, 44]], "iscrowd": 0},
        {"id": 2, "image_id": 10, "category_id": 3, "bbox": [10, 5, 30, 25],
         "segmentation": compressed, "iscrowd": 1},
        {"id": 3, "image_id": 11, "category_id": 9, "bbox": [10, 5, 30, 25], "area": 600.0,
         "segmentation": uncompressed, "iscrowd": 0,
         "keypoints": [12, 8, 2, 30, 20, 1, 0, 0, 0]},
        {"id": 4, "image_id": 11, "category_id": 3, "bbox": [5, 5, 0, 9], "area": 0.0,
         "segmentation": [[5, 5, 5, 14, 6, 14]], "iscrowd": 0},
        {"id": 5, "image_id": 12, "category_id": 7, "bbox": [1, 1, 60, 40], "area": 1.0,
         "segmentation": [], "iscrowd": 0},
    ]
    cats = [{"id": c, "name": f"c{c}"} for c in (9, 3, 7)]
    (root / "ann.json").write_text(json.dumps(
        {"images": images, "annotations": anns, "categories": cats}))
    return str(root / "ann.json"), str(root / "img"), blob


@pytest.mark.parametrize("filter_empty", [True, False])
def test_coco_dataset_matches_jax_on_rle_crowd_and_keypoints(tmp_path, filter_empty):
    ann, img, blob = _handwritten_coco(tmp_path)
    ours = CocoDataset(ann, img, filter_empty=filter_empty)
    theirs = JaxCocoDataset(ann, img, filter_empty=filter_empty)
    assert len(ours) == len(theirs) == (3 if filter_empty else 4)
    assert ours.cat_id_to_contiguous == theirs.cat_id_to_contiguous == {3: 0, 7: 1, 9: 2}
    for i in range(len(ours)):
        _assert_sample_equal(ours[i], theirs[i])
        _assert_sample_equal(ours.sample_gt(i), theirs.sample_gt(i), image=False)
    s = ours[0]
    np.testing.assert_array_equal(s["masks"][1], blob)  # compressed RLE
    np.testing.assert_array_equal(ours[1]["masks"][0], blob)  # uncompressed counts
    assert s["is_crowd"].tolist() == [False, True]
    assert "keypoints" in ours[1]


def test_decode_rle_matches_jax():
    rng = np.random.default_rng(2)
    for h, w in ((1, 1), (7, 3), (33, 64)):
        m = (rng.uniform(size=(h, w)) > 0.6).astype(np.uint8)
        enc = jrle.encode(m)
        for counts in (enc["counts"].decode("ascii"), list(jrle.encode_counts(m))):
            got = tcoco.decode_rle({"counts": counts}, h, w)
            np.testing.assert_array_equal(got, jcoco.decode_rle({"counts": counts}, h, w))
            np.testing.assert_array_equal(got, m)


# -- the CLIs' dataset choice ---------------------------------------------------

def _format_root(tmp_path, shards=True):
    root = tmp_path / "fmt"
    make_synthetic_coco.make_split(str(root), "train", 4, seed=0)
    make_synthetic_coco.make_split(str(root), "val", 2, seed=100)
    if shards:
        for split in ("train", "val"):
            build_records(CocoDataset(str(root / f"{split}.json"), str(root / split)),
                          str(root / f"{split}.record"), 2)
    return str(root)


def _fmt_cfgs(root, fmt, **extra):
    jcfg, tcfg = jax_get_cfg(), get_cfg()
    for cfg in (jcfg, tcfg):
        cfg.DATASETS.ROOT_DIR = root
        cfg.DATASETS.TRAIN_FORMAT = fmt
        for k, v in extra.items():
            node = cfg
            *parents, leaf = k.split(".")
            for p in parents:
                node = node[p]
            node[leaf] = v
    return jcfg, tcfg


def _kind(ds):
    return "records" if type(ds).__name__ == "TFRecordDataset" else "coco_json"


@pytest.mark.parametrize("fmt", ["auto", "records", "coco_json"])
@pytest.mark.parametrize("shards", [True, False])
def test_dataset_format_choice_matches_jax(tmp_path, fmt, shards):
    root = _format_root(tmp_path, shards)
    jcfg, tcfg = _fmt_cfgs(root, fmt)
    if fmt == "records" and not shards:
        for build in (jax_train.build_train_dataset, tools_train.build_train_dataset,
                      jax_eval.build_eval_dataset, tools_eval.build_eval_dataset):
            with pytest.raises(AssertionError, match="no records"):
                build(jcfg if build.__module__ in ("train", "eval") else tcfg)
        return
    assert _kind(tools_train.build_train_dataset(tcfg)) == _kind(
        jax_train.build_train_dataset(jcfg))
    assert _kind(tools_eval.build_eval_dataset(tcfg)) == _kind(jax_eval.build_eval_dataset(jcfg))
    assert _kind(tools_train.build_train_dataset(tcfg)) == (
        "records" if fmt == "records" or (fmt == "auto" and shards) else "coco_json")


@pytest.mark.parametrize("key,value,match", [
    ("AUGMENT.CROP.ENABLED", True, "AUGMENT.CROP.ENABLED"),
    ("MODEL.META_ARCHITECTURE", "SemanticSegmentor", "coco_pano"),
    ("MODEL.META_ARCHITECTURE", "PanopticFPN", "coco_pano"),
])
def test_unported_families_raise_naming_the_key(tmp_path, key, value, match):
    root = _format_root(tmp_path)
    _, tcfg = _fmt_cfgs(root, "auto", **{key: value})
    for build in (tools_train.build_train_dataset, tools_eval.build_eval_dataset):
        with pytest.raises(NotImplementedError, match=match):
            build(tcfg)


def test_loader_batches_from_records_match_jax(tmp_path):
    """Training batches from the same shards, the JAX package's
    build_dataloader over its TFRecordDataset, the port's over its own."""
    from test_torch_data import small_cfgs

    root = _format_root(tmp_path)
    jcfg, tcfg = small_cfgs(**{"DATALOADER.NUM_READERS": 2, "DATALOADER.NATIVE_TRAIN_IO": False,
                               "INPUT.PAD_BUCKETS": ((96, 128), (128, 96))})
    pattern = os.path.join(root, "train.record-*")
    ours = build_dataloader(tcfg, TFRecordDataset(pattern), training=True, seed=0)
    theirs = jax_build_dataloader(jcfg, jrecords.TFRecordDataset(pattern), training=True, seed=0)
    for _ in range(4):
        assert_batches_match(next(ours), next(theirs))
    ours.close()
    got = list(build_dataloader(tcfg, TFRecordDataset(pattern), training=False))
    want = list(jax_build_dataloader(jcfg, jrecords.TFRecordDataset(pattern), training=False))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert_batches_match(g, w)


# -- the synthetic-COCO tool ------------------------------------------------------

def test_synthetic_tool_matches_the_jax_tool(jax_coco, tmp_path):
    """Equal annotations; images equal but inside the disks, where the port
    fills the ellipse's pixel centres and cv2 its polygon approximation."""
    root = tmp_path / "ours"
    make_synthetic_coco.main([str(root), "6", "3"])
    for split in ("train", "val"):
        ours = json.loads((root / f"{split}.json").read_text())
        assert ours == json.loads((jax_coco / f"{split}.json").read_text())
    assert json.loads((root / "category_map.json").read_text()) == json.loads(
        (jax_coco / "category_map.json").read_text())
    ann = json.loads((root / "train.json").read_text())
    for info in ann["images"]:
        a = cv2.imread(str(root / "train" / info["file_name"])).astype(int)
        b = cv2.imread(str(jax_coco / "train" / info["file_name"])).astype(int)
        differ = np.abs(a - b).max(axis=2) > 8
        disks = np.zeros(differ.shape, bool)
        for x in ann["annotations"]:
            if x["image_id"] == info["id"] and x["category_id"] == 2:
                # JPEG spreads a change over its 16x16 blocks (4:2:0 chroma).
                bx, by, bw, bh = x["bbox"]
                disks[by // 16 * 16:(by + bh) // 16 * 16 + 16,
                      bx // 16 * 16:(bx + bw) // 16 * 16 + 16] = True
        assert not (differ & ~disks).any()
        assert differ.sum() <= 0.02 * differ.size


def test_synthetic_tool_refuses_the_panoptic_layout(tmp_path):
    with pytest.raises(NotImplementedError, match="panoptic"):
        make_synthetic_coco.main([str(tmp_path), "2", "1", "--panoptic"])
