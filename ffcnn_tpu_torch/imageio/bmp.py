"""24-bit BMP reader, the port's copy of ``ffcnn_tpu/imageio/bmp.py``
(``bmp_decode``/``bmp_load``; the JAX package's native codec and the writer
and drawing helpers are not needed by the port).

The reference reads a packed 54-byte header and then pixel rows bottom-up with
4-byte-aligned strides (bmpfile.c:42-69), yielding a top-down BGR buffer in
memory; it ignores bfOffBits and assumes 24-bit uncompressed.
"""

from __future__ import annotations

import struct

import numpy as np

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
    """Load a 24-bit BMP as a top-down (H, W, 3) uint8 BGR array."""
    with open(path, "rb") as f:
        raw = f.read()
    try:
        return bmp_decode(raw)
    except ValueError as e:
        raise ValueError(f"{path}: {e}") from None
