"""Folded-parameter cache, the port's copy of ``ffcnn_tpu/darknet/cache.py``.

The ``.weights`` file is the checkpoint format and stays the canonical
ingest.  Loading folds BatchNorm (ffcnn.c:229-232) and repacks weights to
HWIO; this module stores the folded params as an ``.npz`` keyed by a
content hash of the cfg+weights pair, so a reload is one read with no
parsing or folding.  The key and the file format are the JAX package's, so
either package reads an entry the other wrote.  Besides a path, the weights
may be the file's bytes, as ``Net.load`` takes them.
"""

from __future__ import annotations

import hashlib
import os
import tempfile
import zipfile
from typing import Dict, Tuple

import numpy as np

from .ir import NetIR
from .weights import FoldedConvParams, load_weights

_VERSION = 1


def _content(path_or_bytes) -> bytes:
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return bytes(path_or_bytes)
    with open(path_or_bytes, "rb") as f:
        return f.read()


def cache_key(cfg_path: str, weights) -> str:
    """Content hash of the cfg+weights pair.  Folded params do not depend
    on the input size, so one entry serves every size."""
    h = hashlib.sha256()
    for p in (cfg_path, weights):
        h.update(_content(p))
    h.update(f"v{_VERSION}".encode())
    return h.hexdigest()[:24]


def save_params(path: str, params: Dict[int, FoldedConvParams]) -> None:
    arrays = {}
    for li, p in params.items():
        arrays[f"w{li}"] = p.weights
        arrays[f"s{li}"] = p.scale
        arrays[f"b{li}"] = p.bias
    # a temp file of its own per writer: workers sharing a cache_dir must
    # not clobber each other's file before the atomic publish
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               prefix=os.path.basename(path) + ".")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_params(path: str) -> Dict[int, FoldedConvParams]:
    data = np.load(path)
    out: Dict[int, FoldedConvParams] = {}
    for name in data.files:
        if not name.startswith("w"):
            continue
        li = int(name[1:])
        out[li] = FoldedConvParams(weights=data[f"w{li}"],
                                   scale=data[f"s{li}"],
                                   bias=data[f"b{li}"])
    return out


def load_or_build(ir: NetIR, cfg_path: str, weights, cache_dir: str,
                  ) -> Tuple[Dict[int, FoldedConvParams], bool]:
    """Return (params, was_cached).  Builds and fills the cache on a miss;
    a corrupt entry is rebuilt."""
    os.makedirs(cache_dir, exist_ok=True)
    key = cache_key(cfg_path, weights)
    path = os.path.join(cache_dir, f"ffcnn-params-{key}.npz")
    if os.path.exists(path):
        try:
            return load_params(path), True
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile):
            try:                        # a concurrent worker may have
                os.unlink(path)         # replaced or removed it already
            except OSError:
                pass
    params, _ = load_weights(ir, weights)
    save_params(path, params)
    return params, False
