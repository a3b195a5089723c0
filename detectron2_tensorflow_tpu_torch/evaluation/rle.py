"""COCO run-length encoding: encode / decode / area / IoU, in numpy.

Port of the numpy path of the JAX package's ``evaluation/rle.py``; its
C++ core (``native/rle.cpp``) waits with the native loaders. RLE dicts
follow the COCO interchange format: ``{"size": [h, w], "counts": bytes}``
with column-major alternating runs starting at 0, the counts compressed to
the 5-bit-group delta string that pycocotools reads.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np


def _i64(a):
    return np.ascontiguousarray(a, np.int64)


def encode_counts(mask: np.ndarray) -> np.ndarray:
    """Binary ``[H, W]`` mask -> run lengths (column-major, zeros first)."""
    flat = np.asarray(mask, np.uint8).T.reshape(-1)
    if flat.size == 0:
        return np.zeros(0, np.int64)
    change = np.nonzero(np.diff(flat))[0] + 1
    bounds = np.concatenate([[0], change, [flat.size]])
    counts = np.diff(bounds)
    if flat[0] == 1:  # runs start with a (possibly empty) zero run
        counts = np.concatenate([[0], counts])
    return counts.astype(np.int64)


def decode_counts(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    """Run lengths -> uint8 ``[h, w]`` mask."""
    flat = np.zeros(h * w, np.uint8)
    pos = 0
    val = 0
    for c in _i64(counts):
        if val:
            flat[pos: pos + int(c)] = 1
        pos += int(c)
        val ^= 1
    return flat.reshape(w, h).T


def compress(counts: np.ndarray) -> bytes:
    """Run lengths -> the COCO compressed string."""
    out = bytearray()
    counts = [int(c) for c in counts]
    for i, c in enumerate(counts):
        x = c - counts[i - 2] if i > 2 else c
        more = True
        while more:
            piece = x & 0x1F
            x >>= 5
            more = (x != -1) if (piece & 0x10) else (x != 0)
            if more:
                piece |= 0x20
            out.append(piece + 48)
    return bytes(out)


def decompress(data: bytes) -> np.ndarray:
    """The COCO compressed string -> run lengths."""
    counts: List[int] = []
    p = 0
    while p < len(data):
        x = 0
        k = 0
        more = True
        while more:
            c = data[p] - 48
            p += 1
            x |= (c & 0x1F) << (5 * k)
            more = bool(c & 0x20)
            k += 1
            if not more and (c & 0x10):
                x |= -1 << (5 * k)
        if len(counts) > 2:
            x += counts[-2]
        counts.append(x)
    return np.asarray(counts, np.int64)


def _counts(rle: Dict) -> np.ndarray:
    counts = rle["counts"]
    if isinstance(counts, (bytes, str)):
        return decompress(counts.encode() if isinstance(counts, str) else counts)
    return _i64(counts)


def encode(mask: np.ndarray) -> Dict:
    """Binary ``[H, W]`` mask -> COCO compressed RLE dict."""
    h, w = mask.shape
    return {"size": [int(h), int(w)], "counts": compress(encode_counts(mask))}


def decode(rle: Dict) -> np.ndarray:
    h, w = rle["size"]
    return decode_counts(_counts(rle), h, w)


def area(rle: Dict) -> int:
    return int(_counts(rle)[1::2].sum())


def iou(dt: Sequence[Dict], gt: Sequence[Dict],
        iscrowd: Optional[Sequence[bool]] = None) -> np.ndarray:
    """``[D, G]`` mask IoU of RLE dicts (pycocotools ``maskUtils.iou``);
    crowd GT uses intersection over the detection's area."""
    iscrowd = np.zeros(len(gt), bool) if iscrowd is None else np.asarray(iscrowd, bool)
    dms = [decode(r).astype(bool) for r in dt]
    gms = [decode(r).astype(bool) for r in gt]
    out = np.zeros((len(dt), len(gt)), np.float64)
    for i, dm in enumerate(dms):
        for j, gm in enumerate(gms):
            inter = float(np.logical_and(dm, gm).sum())
            uni = float(dm.sum()) if iscrowd[j] else float(np.logical_or(dm, gm).sum())
            out[i, j] = inter / uni if uni > 0 else 0.0
    return out
