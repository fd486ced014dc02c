"""Build and load the port's CUDA kernels: ``nvcc`` compiles each source in
``ffcnn_tpu_torch/csrc/`` into a shared library with a plain C interface,
loaded with ``ctypes``.

The build runs at first use, never at import, into ``ffcnn_tpu_torch/_build/``
(listed in ``.gitignore``).  The library name carries a hash of the source
and the flags, so an edited source builds anew and a stale library is never
loaded.  Set ``CUDA_HOME`` to pick the toolkit (default ``/usr/local/cuda``,
then ``nvcc`` on ``PATH``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Tuple

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# Hopper only: `sm_90a` keeps wgmma/setmaxnreg open to later kernels.
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _library_path(name: str, flags: Tuple[str, ...]) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + repr((_ARCH, _BASE_FLAGS, flags)).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


@functools.cache
def load_library(name: str, flags: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it.  Raises on a missing
    card, a missing compiler or a failed build; nothing falls back."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel {name!r} needs a CUDA device")
    out = _library_path(name, flags)
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *_ARCH, *_BASE_FLAGS, *flags,
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
        os.replace(tmp, out)             # atomic: a racing build is harmless
    return ctypes.CDLL(str(out))


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream
