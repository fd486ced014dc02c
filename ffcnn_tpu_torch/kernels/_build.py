"""Build and load the port's CUDA kernels: ``nvcc`` compiles each source in
``ffcnn_tpu_torch/csrc/`` into a shared library with a plain C interface,
loaded with ``ctypes``.

The build runs at first use, never at import, into ``ffcnn_tpu_torch/_build/``
(listed in ``.gitignore``).  The library name carries a hash of the source,
the shared headers (``csrc/*.cuh``) and the flags, so an edited source builds
anew and a stale library is never loaded.  ``build_all`` starts one ``nvcc``
per source, all at once.  Set ``CUDA_HOME`` to pick the toolkit (default
``/usr/local/cuda``, then ``nvcc`` on ``PATH``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, List

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# Hopper only: `sm_90a` keeps wgmma/setmaxnreg open to later kernels.
_ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
_BASE_FLAGS = ("-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
# Extra flags per source.  nms: the keep mask must equal the plain version
# bit for bit, so no FMA contraction.
FLAGS = {"nms": ("-fmad=false",)}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _library_path(name: str) -> Path:
    key = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        key.update(header.read_bytes())
    key.update(repr((_ARCH, _BASE_FLAGS, FLAGS.get(name, ()))).encode())
    return BUILD_DIR / f"{name}-{key.hexdigest()[:16]}.so"


def source_hash() -> str:
    """One hash of every kernel source, header and flag set: what an
    artifact's sidecar records of the kernels it was exported with."""
    key = hashlib.sha256()
    for name in sources():
        key.update(_library_path(name).name.encode())
    return key.hexdigest()[:16]


def sources() -> List[str]:
    """Every kernel source's name (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def build_all(names: Iterable[str] = ()) -> None:
    """Compile the named sources (default: all) that are not built yet,
    one ``nvcc`` each, all started together.  Raises on a failed build."""
    jobs = []
    for name in list(names) or sources():
        out = _library_path(name)
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        log = open(out.with_suffix(f".{os.getpid()}.log"), "w+")
        cmd = [nvcc_path(), *_ARCH, *_BASE_FLAGS, *FLAGS.get(name, ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, log,
                     subprocess.Popen(cmd, stdout=log, stderr=log)))
    failed = []
    for name, out, tmp, log, proc in jobs:
        with log:
            if proc.wait() != 0:
                log.seek(0)
                failed.append(f"nvcc failed for {name}.cu:\n{log.read()}")
            else:
                os.replace(tmp, out)     # atomic: a racing build is harmless
        os.unlink(log.name)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it.  Raises on a missing
    card, a missing compiler or a failed build; nothing falls back."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"kernel {name!r} needs a CUDA device")
    build_all([name])
    return ctypes.CDLL(str(_library_path(name)))


@functools.cache
def sm_count(device: torch.device) -> int:
    """The SMs of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def stream_ptr() -> int:
    return torch.cuda.current_stream().cuda_stream
