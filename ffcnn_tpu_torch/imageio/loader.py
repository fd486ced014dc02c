"""Batch image loader, the port's copy of ``ffcnn_tpu/imageio/loader.py``:
an (N, H, W, 3) uint8 BGR batch from a list of BMP paths.

``load_batch`` runs the native codec's pthread fan-out
(``ffcnn_tpu_torch/native/bmp_codec.c``, built at first use by
``native.py``): one thread a core up to 64, each decoding whole files
straight into one buffer, the interpreter lock released meanwhile, as the
JAX package's loader does where its extension is built.
``load_batch_plain`` is its numpy version, a thread pool over
``bmp_load_plain`` and an ``np.stack``.
"""

from __future__ import annotations

import concurrent.futures
import os
from typing import Sequence

import numpy as np

from . import native
from .bmp import bmp_load_plain


def load_batch(paths: Sequence[str], threads: int = 0) -> np.ndarray:
    """Load same-sized 24-bit BMPs into one (N, H, W, 3) uint8 BGR array
    (``threads`` 0: one a core, at most 64)."""
    paths = [os.fspath(p) for p in paths]
    ba, n, h, w = native.codec().load_batch(paths, threads)
    return np.frombuffer(ba, np.uint8).reshape(n, h, w, 3)


def load_batch_plain(paths: Sequence[str], threads: int = 0) -> np.ndarray:
    """``load_batch``'s numpy version (``threads`` 0: one a core, at most
    32)."""
    paths = [os.fspath(p) for p in paths]
    if not paths:
        raise ValueError("empty path list")
    threads = threads or min(32, os.cpu_count() or 1)
    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        imgs = list(ex.map(bmp_load_plain, paths))
    first = imgs[0].shape
    for p, im in zip(paths, imgs):
        if im.shape != first:
            raise IOError(f"batch load failed at {p!r} "
                          f"(dims must match {first[1]}x{first[0]})")
    return np.stack(imgs)
