"""TFRecord framing, the CRC and the ``tf.train.Example`` codec of the port
against the JAX package's, and shards written by either package read by
both.

The CRC runs in C (``csrc/crc32c.cpp``, built by ``g++``); its plain
version is the Python loop, and both equal the JAX package's CRC and the
CRC-32C check value. Shards are built from a synthetic COCO directory made
by the JAX package's own tool (``tools/make_synthetic_coco.py``, 6 train
images); decoded samples must be equal field for field: images bit for bit
(PIL and cv2 decode the same JPEG alike), boxes, classes, crowd flags and
areas exactly, masks exactly (lossless PNG).
"""

import os
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from detectron2_tensorflow_tpu.data import CocoDataset as JaxCocoDataset
from detectron2_tensorflow_tpu.data import records as jrecords
from detectron2_tensorflow_tpu.data import tfrecord_codec as jcodec
from detectron2_tensorflow_tpu_torch import kernels
from detectron2_tensorflow_tpu_torch.data import CocoDataset, TFRecordDataset, build_records
from detectron2_tensorflow_tpu_torch.data import records as trecords
from detectron2_tensorflow_tpu_torch.data import tfrecord_codec as tcodec

REPO = Path(__file__).resolve().parents[1]
SIZES = [0, 1, 3, 8, 63, 1000, 4097, 160_000]


@pytest.fixture(scope="module")
def jax_coco(tmp_path_factory):
    """A synthetic COCO directory written by the JAX package's tool."""
    root = tmp_path_factory.mktemp("coco")
    subprocess.run([sys.executable, "tools/make_synthetic_coco.py", str(root), "6", "3"],
                   cwd=REPO, check=True, capture_output=True)
    return root


def _payload(n, seed=0):
    return np.random.default_rng(seed + n).integers(0, 256, n, np.uint8).tobytes()


def test_crc32c_known_answer():
    """The CRC-32C check value (RFC 3720, B.4) and the empty input."""
    assert tcodec.crc32c(b"123456789") == 0xE3069283
    assert tcodec.crc32c_reference(b"123456789") == 0xE3069283
    assert tcodec.crc32c(b"") == 0


@pytest.mark.parametrize("n", SIZES)
def test_crc_c_loop_matches_python_loop_and_jax(n):
    data = _payload(n)
    got = tcodec.crc32c(data)
    assert got == tcodec.crc32c_reference(data) == jcodec.crc32c(data)
    assert tcodec._masked_crc(data) == jcodec._masked_crc(data)
    assert tcodec.crc32c(bytearray(data)) == got  # any bytes-like input


def test_crc_build_without_gxx_raises(monkeypatch, tmp_path):
    """No compiler, no CRC: the build raises instead of falling back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(kernels, "_host_libs", {})
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ not found"):
        tcodec.crc32c(b"abc")


def _features(seed):
    rng = np.random.default_rng(seed)
    return {
        "image/encoded": ("bytes", [_payload(int(rng.integers(0, 3000)), seed)]),
        "image/object/mask": ("bytes", [b"", b"\x00\x01", _payload(77, seed)]),
        "image/object/bbox/xmin": ("float", rng.uniform(-2, 2, 5).astype(np.float32)),
        "image/object/area": ("float", np.zeros(0, np.float32)),
        "image/object/class/label": ("int64", rng.integers(-2**40, 2**40, 6)),
        "image/height": ("int64", np.array([-1, 0, 2**63 - 1, -2**63], np.int64)),
    }


def _assert_features_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        assert a[k][0] == b[k][0], k
        if a[k][0] == "bytes":
            assert a[k][1] == b[k][1], k
        else:
            np.testing.assert_array_equal(a[k][1], b[k][1], err_msg=k)
            assert np.asarray(a[k][1]).dtype == np.asarray(b[k][1]).dtype, k


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_example_round_trip_both_directions(seed):
    feats = _features(seed)
    ours = tcodec.encode_example(feats)
    assert ours == jcodec.encode_example(feats)
    _assert_features_equal(jcodec.decode_example(ours), feats)
    _assert_features_equal(tcodec.decode_example(jcodec.encode_example(feats)), feats)


def test_decoder_reads_unpacked_scalars():
    """A writer may emit repeated scalars unpacked; both decoders read them."""
    floats = b"".join(b"\x0d" + struct.pack("<f", v) for v in (1.5, -2.0))
    ints = b"".join(b"\x08" + jcodec._varint(v) for v in (3, 300))
    feat_f = jcodec._ld(2, floats)
    feat_i = jcodec._ld(3, ints)
    entries = b"".join(jcodec._ld(1, jcodec._ld(1, name) + jcodec._ld(2, f))
                       for name, f in ((b"f", feat_f), (b"i", feat_i)))
    data = jcodec._ld(1, entries)
    got = tcodec.decode_example(data)
    _assert_features_equal(got, jcodec.decode_example(data))
    np.testing.assert_array_equal(got["f"][1], [1.5, -2.0])
    np.testing.assert_array_equal(got["i"][1], [3, 300])


@pytest.mark.parametrize("writer,reader", [("port", "jax"), ("jax", "port")])
def test_framing_round_trip(tmp_path, writer, reader):
    payloads = [_payload(n, 3) for n in SIZES]
    path = tmp_path / "shard"
    with open(path, "wb") as fh:
        for p in payloads:
            (tcodec if writer == "port" else jcodec).write_record(fh, p)
    codec = tcodec if reader == "port" else jcodec
    assert list(codec.read_records(str(path))) == payloads
    assert tcodec.index_records(str(path)) == jcodec.index_records(str(path))


def test_corrupted_record_raises(tmp_path):
    path = tmp_path / "shard"
    with open(path, "wb") as fh:
        tcodec.write_record(fh, b"hello records")
    data = bytearray(path.read_bytes())
    data[14] ^= 0x01  # a payload byte
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="crc mismatch"):
        list(tcodec.read_records(str(path)))
    with pytest.raises(ValueError, match="crc mismatch"):
        list(jcodec.read_records(str(path)))


def _assert_samples_equal(a, b, masks=True):
    np.testing.assert_array_equal(a["image"], b["image"])
    assert a["image"].dtype == b["image"].dtype == np.uint8
    assert int(a["image_id"]) == int(b["image_id"])
    for k in ("boxes", "classes", "is_crowd", "areas"):
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    if masks:
        np.testing.assert_array_equal(a["masks"], b["masks"])
        assert a["masks"].dtype == b["masks"].dtype


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_written_by_either_package_read_equal_in_both(jax_coco, tmp_path, writer):
    ann, imgs = str(jax_coco / "train.json"), str(jax_coco / "train")
    if writer == "port":
        paths = build_records(CocoDataset(ann, imgs), str(tmp_path / "train.record"), 2)
    else:
        paths = jrecords.build_records(JaxCocoDataset(ann, imgs), str(tmp_path / "train.record"),
                                       2)
    assert [os.path.basename(p) for p in paths] == [
        "train.record-00000-of-00002", "train.record-00001-of-00002"]
    ours = TFRecordDataset(str(tmp_path / "train.record-*"))
    theirs = jrecords.TFRecordDataset(str(tmp_path / "train.record-*"))
    source = JaxCocoDataset(ann, imgs)
    assert len(ours) == len(theirs) == len(source) == 6
    ids = [source.image_id(i) for i in range(6)]
    assert sorted(ours.image_id(i) for i in range(6)) == sorted(ids)
    for i in range(6):
        _assert_samples_equal(ours[i], theirs[i])
        assert ours.image_id(i) == theirs.image_id(i)
        # Shard i % 2 holds example i: record order follows the shards.
        j = ids.index(ours.image_id(i))
        want = source[j]
        _assert_samples_equal(ours[i], {**want, "masks": want["masks"]})
    no_masks = TFRecordDataset(str(tmp_path / "train.record-*"), load_masks=False)
    assert "masks" not in no_masks[0]


def test_build_records_copies_jpeg_bytes(jax_coco, tmp_path):
    ds = CocoDataset(str(jax_coco / "train.json"), str(jax_coco / "train"))
    build_records(ds, str(tmp_path / "t.record"), 1)
    rec = next(tcodec.read_records(str(tmp_path / "t.record-00000-of-00001")))
    encoded = tcodec.decode_example(rec)["image/encoded"][1][0]
    assert encoded == Path(ds.image_path(0)).read_bytes()


def test_category_map_gives_class_names_and_category_ids(jax_coco, tmp_path):
    ds = CocoDataset(str(jax_coco / "train.json"), str(jax_coco / "train"))
    build_records(ds, str(tmp_path / "train.record"), 1)
    (tmp_path / "category_map.json").write_text(
        '{"thing_classes": ["a", "b", "c"], "contiguous_to_coco_id": {"0": 4, "1": 7, "2": 9}}')
    rd = TFRecordDataset(str(tmp_path / "train.record-*"))
    assert rd.class_names == ["a", "b", "c"]
    assert rd.contiguous_to_cat_id == {0: 4, 1: 7, 2: 9}
    assert rd.class_names == jrecords.TFRecordDataset(str(tmp_path / "train.record-*")).class_names


def test_semantic_records_raise_naming_coco_pano(tmp_path):
    """``image/sem_seg`` (``BUILD_RECORDS.TYPE coco_pano``) crosses the
    packages both ways: a label map with ignored pixels (-1, stored as
    256^3 - 1) and labels above 255 written by either is read back equal by
    both."""
    import cv2

    sem = np.random.default_rng(2).integers(-1, 300, (6, 7)).astype(np.int32)
    sample = {"image_id": 1, "height": 6, "width": 7, "boxes": np.zeros((0, 4)),
              "classes": [], "is_crowd": [], "sem_seg": sem}
    jpeg = cv2.imencode(".jpg", np.zeros((6, 7, 3), np.uint8))[1].tobytes()
    for writer in (trecords, jrecords):
        path = tmp_path / f"{writer.__name__.split('.')[0]}.record-00000-of-00001"
        with open(path, "wb") as fh:
            jcodec.write_record(fh, writer.create_example(sample, jpeg))
        for reader in (TFRecordDataset, jrecords.TFRecordDataset):
            got = reader(str(path))[0]["sem_seg"]
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, sem)