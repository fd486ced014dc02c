"""The two Pallas probes of the backend-bug sweep (P4, P5) as kernels: a
strided row copy of bfloat16 rows, and three dynamic-slice-and-concat steps
on a loop-carried float32 array.  Holds the CUDA kernels' wrappers and
their plain PyTorch versions.

Replaces the ``pallas_call``s of ``tools/retest_backend_bugs.py``'s probes
``MOSAIC_STRIDED_16`` (P4) and ``MOSAIC_DYNSLICE_CARRY`` (P5), which no
package path runs: the port of the sweep's two Pallas probes,
``ffcnn_tpu_torch/retest_backend_bugs.py``, drives them.  Both are copies,
so kernel and plain version agree bit for bit.  P4's kernel moves one
16-byte run (8 columns) a thread where it can, else one element;
``strided_plan`` mirrors its choice of width, block and grid, and the
wrapper keeps the launch the kernel reports (``strided_rows.plan``).  P5's
kernel copies each output row from the input row that ``dynslice_rows``
names: its steps composed into one row map, computed by each thread.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Tuple

import torch

from . import _build

_MAX_SEG = 2**30 - 1   # csrc/mosaic_probes.cu: 2*seg rows within an int
_MAX_COLS = 2**31 - 1
# csrc/mosaic_probes.cu: P4's threads a CTA, and the threads an SM keeps
# resident (its grid's cap)
THREADS, RESIDENT = 128, 2048


class StridedPlan(NamedTuple):
    """One P4 launch: the columns a thread moves (8: a 16-byte run; 1: one
    element), the block's (x: runs of a row, y: rows) and the grid's (x, y);
    a grid of (0, 0) launches nothing."""
    vec: int
    block: Tuple[int, int]
    grid: Tuple[int, int]


def strided_plan(rows: int, cols: int, x_ptr: int, y_ptr: int,
                 sms: int) -> StridedPlan:
    """The launch ``ffcnn_strided_rows`` makes for an (rows, cols) bf16 x at
    address ``x_ptr`` into y at ``y_ptr`` on a card of ``sms`` SMs: 16-byte
    runs where cols is a multiple of 8 and both addresses 16-byte aligned,
    else 2-byte elements; a block of THREADS as (runs, rows), its x the
    least power of two that covers a row's runs (at most THREADS); a grid
    over the runs and the bands of rows, its y capped at what the card
    keeps resident (the CTAs then stride over the bands)."""
    vec = 8 if cols % 8 == 0 and x_ptr % 16 == 0 and y_ptr % 16 == 0 else 1
    runs, rows_out = cols // vec, -(-rows // 2)
    bx = 1
    while bx < runs and bx < THREADS:
        bx *= 2
    by = THREADS // bx
    gx, bands = -(-runs // bx), -(-rows_out // by)
    gy = 0
    if gx and bands:
        gy = min(bands, max(1, sms * (RESIDENT // THREADS) // gx))
    return StridedPlan(vec, (bx, by), (gx if gy else 0, gy))


def strided_rows_plain(x: torch.Tensor) -> torch.Tensor:
    """``x[::2]``: every other row, from the first."""
    return x[::2].clone()


def strided_rows(x: torch.Tensor) -> torch.Tensor:
    """P4: ``x[::2]`` of a 2-D bfloat16 x, (R, C) -> (ceil(R/2), C).

    CPU tensors take ``strided_rows_plain``; CUDA tensors launch the kernel
    (none for an empty output), whose launch (``StridedPlan``) is kept in
    ``strided_rows.plan``."""
    if x.device.type == "cpu":
        return strided_rows_plain(x)
    if (x.device.type != "cuda" or x.dim() != 2 or x.dtype != torch.bfloat16
            or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous 2-D bfloat16 CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    rows, cols = x.shape
    y = torch.empty(((rows + 1) // 2, cols), dtype=x.dtype, device=x.device)
    lib = build()
    plan = (ctypes.c_int * 5)()
    err = lib.ffcnn_strided_rows(x.data_ptr(), y.data_ptr(), rows, cols,
                                 _build.sm_count(x.device), plan,
                                 _build.stream_ptr())
    if err:
        raise RuntimeError("strided_rows launch failed: "
                           + lib.ffcnn_probes_error_string(err).decode())
    strided_rows.plan = StridedPlan(plan[0], (plan[1], plan[2]),
                                    (plan[3], plan[4]))
    if plan[4]:
        strided_rows.launches += 1
    return y


strided_rows.launches = 0
strided_rows.plan = None


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
    lib.ffcnn_strided_rows.argtypes = [p, p, i, i, i, ctypes.POINTER(i), p]
    lib.ffcnn_strided_rows.restype = i
    lib.ffcnn_dynslice_carry.argtypes = [p, p, i, i, i, p]
    lib.ffcnn_dynslice_carry.restype = i
    lib.ffcnn_probes_error_string.argtypes = [i]
    lib.ffcnn_probes_error_string.restype = ctypes.c_char_p
    return lib
