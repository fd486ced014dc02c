"""Build and load the port's BMP codec, ``ffcnn_tpu_torch/native/bmp_codec.c``
(a CPython extension in the plain C API: ``bmp_load``, ``bmp_save``, the
pthread batch loader ``load_batch`` and ``draw_rectangle``).

The build runs at first use, never at import: ``gcc`` (or ``CC``) with the
JAX package's flags (``-O2 -Wall -shared -fPIC``, the interpreter's headers,
``-lpthread``) into ``ffcnn_tpu_torch/_build/`` (listed in ``.gitignore``).
The library's name carries a hash of the source, the flags and the
interpreter's extension suffix, so an edited source builds anew and a stale
library is never loaded.  The compiler writes a temporary file that is then
renamed, so processes and threads that build at once all load a whole
library.  A failed build raises with the compiler's output: nothing falls
back to the numpy versions.
"""

from __future__ import annotations

import functools
import hashlib
import importlib.util
import os
import subprocess
import sys
import sysconfig
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
SOURCE = PKG / "native" / "bmp_codec.c"
BUILD_DIR = PKG / "_build"
# The extension's init symbol is PyInit__ffcnn_native: CPython finds it by
# the last part of the module name.
MODULE = "ffcnn_tpu_torch.imageio._ffcnn_native"
_FLAGS = ("-O2", "-Wall", "-shared", "-fPIC")
_LOCK = threading.Lock()


def _flags() -> tuple:
    return _FLAGS + (f"-I{sysconfig.get_path('include')}",)


def _suffix() -> str:
    return sysconfig.get_config_var("EXT_SUFFIX") or ".so"


def library_path() -> Path:
    """Where the codec built from the current source lives."""
    key = hashlib.sha256(SOURCE.read_bytes())
    key.update(repr((_flags(), "-lpthread", _suffix())).encode())
    return BUILD_DIR / f"bmp_codec-{key.hexdigest()[:16]}{_suffix()}"


def build() -> Path:
    """Compile the codec unless it is built; return the library's path.
    Raises ``RuntimeError`` with the compiler's output on a failed build."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.{threading.get_ident()}"
                        ".tmp")
    cmd = [os.environ.get("CC", "gcc"), *_flags(), str(SOURCE), "-o",
           str(tmp), "-lpthread"]
    try:
        res = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        raise RuntimeError(f"cannot build the BMP codec ({' '.join(cmd)}): "
                           f"{e}") from None
    if res.returncode != 0 or not tmp.exists():
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building the BMP codec failed (exit "
                           f"{res.returncode}): {' '.join(cmd)}\n"
                           f"{res.stderr}{res.stdout}")
    os.replace(tmp, out)         # atomic: a racing build is harmless
    return out


@functools.cache
def _load():
    path = build()
    spec = importlib.util.spec_from_file_location(MODULE, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    sys.modules[MODULE] = module
    return module


def codec():
    """The codec's extension module, built and loaded at its first use."""
    with _LOCK:
        return _load()
