"""24-bit BMP codec, the port's copy of ``ffcnn_tpu/imageio/bmp.py``:
``bmp_decode``/``bmp_load``, the writer ``bmp_save`` and the demo's drawing
helpers ``setpixel``/``getpixel``/``draw_rectangle`` (bmpfile.c:121-156).
``bmp_load`` and ``bmp_save`` run the port's native codec
(``ffcnn_tpu_torch/native/bmp_codec.c``, built at first use by
``native.py``), as the JAX package's do where its extension is built;
``bmp_load_plain`` and ``bmp_save_plain`` are their numpy versions, which
read and write the same bytes.  ``bmp_decode`` (the server's uploads) and
the drawing helpers are numpy, as in the JAX package.

The reference reads a packed 54-byte header and then pixel rows bottom-up with
4-byte-aligned strides (bmpfile.c:42-69), yielding a top-down BGR buffer in
memory; it ignores bfOffBits and assumes 24-bit uncompressed.
"""

from __future__ import annotations

import os
import struct

import numpy as np

from . import native

_HEADER_FMT = "<HIHHIIiiHHIIIIII"  # BITMAPFILEHEADER + BITMAPINFOHEADER packed
_HEADER_BYTES = 54


def _align4(x: int) -> int:
    return (x + 3) & ~3


def bmp_decode(raw: bytes) -> np.ndarray:
    """Decode in-memory 24-bit BMP bytes to a top-down (H, W, 3) uint8 BGR
    array (reference semantics: 54-byte header, bottom-up rows,
    ALIGN(w*3,4) stride, bfOffBits ignored, bmpfile.c:42-69)."""
    if len(raw) < _HEADER_BYTES:
        raise ValueError(f"truncated BMP header ({len(raw)} bytes)")
    fields = struct.unpack_from(_HEADER_FMT, raw, 0)
    magic, width, height, bitcount = fields[0], fields[6], fields[7], fields[9]
    if magic != 0x4D42:
        raise ValueError("not a BMP file")
    if bitcount != 24:
        raise ValueError(f"only 24-bit BMPs supported (got {bitcount})")
    if not (0 < width <= 1 << 15 and 0 < abs(height) <= 1 << 15):
        raise ValueError(f"unreasonable BMP dims {width}x{height}")
    flip = height > 0          # positive height = bottom-up rows (the norm)
    height = abs(height)
    stride = _align4(width * 3)
    data = np.frombuffer(raw, np.uint8, count=stride * height,
                         offset=_HEADER_BYTES)
    rows = data.reshape(height, stride)[:, : width * 3]
    img = rows.reshape(height, width, 3)
    return img[::-1].copy() if flip else img.copy()


def bmp_load(path: str) -> np.ndarray:
    """Load a 24-bit BMP as a top-down (H, W, 3) uint8 BGR array (the
    native codec; a writable view of the buffer it fills)."""
    ba, h, w = native.codec().bmp_load(os.fspath(path))
    return np.frombuffer(ba, np.uint8).reshape(h, w, 3)


def bmp_load_plain(path: str) -> np.ndarray:
    """``bmp_load``'s numpy version."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return bmp_decode(raw)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None


def bmp_save(path: str, img: np.ndarray) -> None:
    """Save a top-down (H, W, 3) uint8 BGR array as a bottom-up 24-bit BMP
    (the native codec)."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected an (H, W, 3) image, got {img.shape}")
    native.codec().bmp_save(os.fspath(path), img, *img.shape[:2])


def bmp_save_plain(path: str, img: np.ndarray) -> None:
    """``bmp_save``'s numpy version."""
    h, w = img.shape[:2]
    stride = _align4(w * 3)
    rows = np.zeros((h, stride), np.uint8)
    rows[:, : w * 3] = img.reshape(h, w * 3)
    header = struct.pack(
        _HEADER_FMT,
        0x4D42, _HEADER_BYTES + stride * h, 0, 0, _HEADER_BYTES,
        40, w, h, 1, 24, 0, stride * h, 0, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(header)
        f.write(rows[::-1].tobytes())


def setpixel(img: np.ndarray, x: int, y: int, r: int, g: int, b: int) -> None:
    """bmp_setpixel (bmpfile.c:121-131): write one RGB pixel into the BGR
    buffer, silently dropped when out of bounds, color clamped to [0, 255].
    Mutates *img* in place."""
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        img[y, x] = tuple(min(255, max(0, v)) for v in (b, g, r))


def getpixel(img: np.ndarray, x: int, y: int):
    """bmp_getpixel (bmpfile.c:133-143): read one pixel.  Returns the bytes
    at offsets +0/+1/+2 under the reference's (r, g, b) OUT-parameter names,
    which in the BGR buffer are (blue, green, red); the quirk is reproduced
    as written.  Out-of-bounds reads return (0, 0, 0)."""
    h, w = img.shape[:2]
    if 0 <= x < w and 0 <= y < h:
        bgr = img[y, x]
        return int(bgr[0]), int(bgr[1]), int(bgr[2])
    return 0, 0, 0


def draw_rectangle(img: np.ndarray, x1: int, y1: int, x2: int, y2: int,
                   r: int, g: int, b: int) -> None:
    """Outline rectangle, clipped per pixel like bmp_rectangle
    (bmpfile.c:145-156).  Mutates *img* (BGR) in place."""
    h, w = img.shape[:2]
    color = np.array([b, g, r], np.uint8)
    xs = np.arange(min(x1, x2), max(x1, x2) + 1)
    xs = xs[(xs >= 0) & (xs < w)]
    ys = np.arange(min(y1, y2), max(y1, y2) + 1)
    ys = ys[(ys >= 0) & (ys < h)]
    for y in (y1, y2):
        if 0 <= y < h:
            img[y, xs] = color
    for x in (x1, x2):
        if 0 <= x < w:
            img[ys, x] = color
