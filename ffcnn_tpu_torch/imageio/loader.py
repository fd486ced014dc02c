"""Batch image loader, the port's copy of ``ffcnn_tpu/imageio/loader.py``:
an (N, H, W, 3) uint8 BGR batch from a list of BMP paths, decoded by a
thread pool over the port's own ``bmp_load`` (file reads and numpy copies
release the interpreter lock, so the threads overlap them).

The JAX package decodes through its native pthread codec
(``native/bmp_codec.c``, built as the JAX package's extension) where it is
built; the port does not load that extension.  Building the codec for the
port is a later item of ROADMAP.md.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Sequence

import numpy as np

from .bmp import bmp_load


def load_batch(paths: Sequence[str], threads: int = 0) -> np.ndarray:
    """Load same-sized 24-bit BMPs into one (N, H, W, 3) uint8 BGR array
    (``threads`` 0: one a core, at most 32)."""
    paths = list(paths)
    if not paths:
        raise ValueError("empty path list")
    threads = threads or min(32, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        imgs = list(ex.map(bmp_load, paths))
    first = imgs[0].shape
    for p, im in zip(paths, imgs):
        if im.shape != first:
            raise IOError(f"batch load failed at {p!r} "
                          f"(dims must match {first[1]}x{first[0]})")
    return np.stack(imgs)
