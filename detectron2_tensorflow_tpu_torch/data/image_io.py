"""Image decoding and encoding through PIL.

The JAX package reads and writes images with ``cv2`` (``cv2.imread``,
``cv2.imdecode``, ``cv2.imencode``); the GPU machine has PIL, so the port
goes through PIL, imported here and nowhere else (a soft dependency, as
``cv2`` is for the JAX package). What the port's callers see equals what
``cv2`` gives the JAX package's:

* :func:`decode_image` / :func:`load_image_rgb`: ``[H, W, 3]`` uint8 RGB,
  as ``cv2.imdecode`` / ``cv2.imread`` with ``IMREAD_COLOR`` followed by
  ``BGR2RGB``. Both apply a JPEG's EXIF orientation (``cv2`` does, in
  ``imdecode`` too); grayscale becomes three equal channels; CMYK becomes RGB
  by ``cv2``'s integer rule (``k - (255 - c) * k / 256`` on the decoder's
  raw values, which PIL hands out inverted for Adobe files). PIL and
  ``cv2`` decode a JPEG bit for bit alike (both run libjpeg's integer IDCT
  and upsampling; ``tests/test_torch_coco.py`` holds them equal).
* :func:`decode_gray`: ``[H, W]`` uint8, as ``IMREAD_GRAYSCALE`` reads the
  8-bit (or 1-bit) PNG masks of the records.
* :func:`encode_jpeg` writes at ``cv2``'s default quality 95,
  :func:`encode_png` a lossless grayscale PNG and :func:`encode_png_rgb` a
  lossless RGB one (the panoptic id maps, which :func:`decode_image` reads
  back); the bytes differ from ``cv2``'s, what they decode to does not
  (PNG) or by the encoder's rounding (JPEG).

A missing PIL raises ``ImportError`` at the first call.
"""

from __future__ import annotations

import io

import numpy as np

JPEG_QUALITY = 95  # cv2.imwrite's default


def _pil():
    from PIL import Image, ImageOps

    return Image, ImageOps


def _to_rgb(img) -> np.ndarray:
    if img.mode == "RGB":
        return np.asarray(img)
    if img.mode == "CMYK":
        raw = np.asarray(img).astype(np.int32)
        if "adobe" in img.info:  # PIL inverts Adobe CMYK; cv2 sees the raw values
            raw = 255 - raw
        k = raw[..., 3:4]
        return (k - (((255 - raw[..., :3]) * k) >> 8)).astype(np.uint8)
    if img.mode in ("L", "1", "P", "RGBA", "LA"):
        return np.asarray(img.convert("RGB"))
    raise NotImplementedError(f"decoding images of PIL mode {img.mode!r} is not ported")


def _open(data: bytes):
    Image, ImageOps = _pil()
    img = Image.open(io.BytesIO(data))
    img.load()
    return ImageOps.exif_transpose(img)


def decode_image(data: bytes) -> np.ndarray:
    """Encoded image bytes -> ``[H, W, 3]`` uint8 RGB (``cv2.imdecode`` with
    ``IMREAD_COLOR``, then ``BGR2RGB``)."""
    return np.ascontiguousarray(_to_rgb(_open(data)))


def load_image_rgb(path: str) -> np.ndarray:
    """The image file at ``path`` as ``[H, W, 3]`` uint8 RGB (``cv2.imread``
    with ``IMREAD_COLOR``, then ``BGR2RGB``)."""
    with open(path, "rb") as f:
        return decode_image(f.read())


def image_size(path: str) -> tuple:
    """``(height, width)`` from the image file's header, without decoding it
    (and without the EXIF orientation, as a JPEG header gives them)."""
    Image, _ = _pil()
    with Image.open(path) as img:
        w, h = img.size
    return h, w


def decode_gray(data: bytes) -> np.ndarray:
    """An 8-bit or 1-bit grayscale image (a PNG mask) -> ``[H, W]`` uint8."""
    Image, _ = _pil()
    img = Image.open(io.BytesIO(data))
    if img.mode == "1":
        img = img.convert("L")
    if img.mode != "L":
        raise NotImplementedError(f"grayscale decoding of PIL mode {img.mode!r} is not ported")
    return np.array(img)


def encode_jpeg(rgb: np.ndarray, quality: int = JPEG_QUALITY) -> bytes:
    """``[H, W, 3]`` uint8 RGB -> JPEG bytes."""
    Image, _ = _pil()
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb, np.uint8), "RGB").save(buf, "JPEG",
                                                                     quality=quality)
    return buf.getvalue()


def encode_png(gray: np.ndarray) -> bytes:
    """``[H, W]`` uint8 -> 8-bit grayscale PNG bytes."""
    Image, _ = _pil()
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(gray, np.uint8), "L").save(buf, "PNG")
    return buf.getvalue()


def encode_png_rgb(rgb: np.ndarray) -> bytes:
    """``[H, W, 3]`` uint8 RGB -> 8-bit RGB PNG bytes (``cv2.imencode`` of the
    BGR image writes the same pixels)."""
    Image, _ = _pil()
    buf = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgb, np.uint8), "RGB").save(buf, "PNG")
    return buf.getvalue()
