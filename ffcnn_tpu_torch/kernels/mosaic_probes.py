"""The two Pallas probes of the backend-bug sweep (P4, P5) as kernels: a
strided row copy of bfloat16 rows, and three dynamic-slice-and-concat steps
on a loop-carried float32 array.  Holds the CUDA kernels' wrappers and
their plain PyTorch versions.

Replaces the ``pallas_call``s of ``tools/retest_backend_bugs.py``'s probes
``MOSAIC_STRIDED_16`` (P4) and ``MOSAIC_DYNSLICE_CARRY`` (P5), which no
package path runs: the port of the sweep's two Pallas probes,
``ffcnn_tpu_torch/retest_backend_bugs.py``, drives them.  Both are copies,
so kernel and plain version agree bit for bit.  P5's kernel copies each
output row from the input row that ``dynslice_rows`` names: its steps
composed into one row map, computed by each thread.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

_MAX_SEG = 2**30 - 1   # csrc/mosaic_probes.cu: 2*seg rows within an int
_MAX_COLS = 2**31 - 1


def strided_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """``x[::2]``: every other row, from the first."""
    return x[::2].clone()


def strided_rows(x: torch.Tensor) -> torch.Tensor:
    """P4: ``x[::2]`` of a 2-D bfloat16 x, (R, C) -> (ceil(R/2), C).

    CPU tensors take ``strided_rows_plain``; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return strided_rows_plain(x)
    if (x.device.type != "cuda" or x.dim() != 2 or x.dtype != torch.bfloat16
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous 2-D bfloat16 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    rows, cols = x.shape
    y = torch.empty(((rows + 1) // 2, cols), dtype=x.dtype, device=x.device)
    lib = build()
    err = lib.ffcnn_strided_rows(x.data_ptr(), y.data_ptr(), rows, cols,
                                 _build.stream_ptr())
    strided_rows.launches += 1
    if err:
        raise RuntimeError("strided_rows launch failed: "
                           + lib.ffcnn_probes_error_string(err).decode())
    return y


strided_rows.launches = 0


def _segment(x: torch.Tensor) -> int:
    if x.dim() != 2 or x.shape[0] % 2 or x.shape[0] == 0:
        raise ValueError(f"x must be (2*seg, C), got {tuple(x.shape)}")
    return x.shape[0] // 2


def dynslice_carry_plain(x: torch.Tensor, steps: int = 3) -> torch.Tensor:
    """``fori_loop(0, steps)`` over ``acc = concat(acc[i:i+seg],
    acc[i:i+seg])`` from x (2*seg, C), the start clamped to seg as
    ``lax.dynamic_slice`` clamps it."""
    seg = _segment(x)
    acc = x.clone()
    for i in range(steps):
        part = acc[min(i, seg):min(i, seg) + seg]
        acc = torch.cat([part, part])
    return acc


def src_row(r: int, seg: int, steps: int) -> int:
    """The input row that output row ``r`` of P5 copies, as each thread of
    the kernel computes it: the steps walked backwards from ``r`` (output
    row r after step i is row min(i, seg) + r % seg of the carry before
    it), the steps past seg folded into one (they all start at seg, and
    that map is idempotent)."""
    if steps > seg:
        r = seg + r % seg
    for i in range(min(steps, seg) - 1, -1, -1):
        r = i + r % seg
    return r


def dynslice_rows(seg: int, steps: int = 3,
                  device="cpu") -> torch.Tensor:
    """P5's row map, (2*seg,) int64: ``x.index_select(0, rows)`` is
    ``dynslice_carry(x, steps)`` (the library call P5 is timed beside)."""
    return torch.tensor([src_row(r, seg, steps) for r in range(2 * seg)],
                        dtype=torch.int64, device=device)


def dynslice_carry(x: torch.Tensor, steps: int = 3) -> torch.Tensor:
    """P5 on a float32 x (2*seg, C): one copy, each output row from the
    input row of ``src_row``.

    CPU tensors take ``dynslice_carry_plain``; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return dynslice_carry_plain(x, steps)
    seg = _segment(x)
    if (x.device.type != "cuda" or x.dtype != torch.float32
            or not x.is_contiguous() or seg > _MAX_SEG
            or x.shape[1] > _MAX_COLS or steps < 0):
        raise ValueError(f"x must be a contiguous float32 CUDA tensor of at "
                         f"most {2 * _MAX_SEG} rows and {_MAX_COLS} columns "
                         f"and steps >= 0, got {x.dtype} {tuple(x.shape)} "
                         f"on {x.device}, steps {steps}")
    y = torch.empty_like(x)
    lib = build()
    err = lib.ffcnn_dynslice_carry(x.data_ptr(), y.data_ptr(), seg,
                                   x.shape[1], min(steps, seg + 1),
                                   _build.stream_ptr())
    dynslice_carry.launches += 1
    if err:
        raise RuntimeError("dynslice_carry launch failed: "
                           + lib.ffcnn_probes_error_string(err).decode())
    return y


dynslice_carry.launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernels' library."""
    lib = _build.load_library("mosaic_probes")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ffcnn_strided_rows.argtypes = [p, p, i, i, p]
    lib.ffcnn_strided_rows.restype = i
    lib.ffcnn_dynslice_carry.argtypes = [p, p, i, i, i, p]
    lib.ffcnn_dynslice_carry.restype = i
    lib.ffcnn_probes_error_string.argtypes = [i]
    lib.ffcnn_probes_error_string.restype = ctypes.c_char_p
    return lib
