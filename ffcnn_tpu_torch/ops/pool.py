"""Pooling with the reference's centered-window semantics, the PyTorch port
of ``ffcnn_tpu/ops/pool.py``.

Window i sits at ``i*stride - (fs-1)//2`` and is clamped to the tensor
(ffcnn.c:337-372); avgpool divides by the full ``fs*fs`` even for clipped
border windows (ffcnn.c:351); output dims are ``floor(dim/stride)``.  The
padding is asymmetric (lo != hi), which ``F.max_pool2d``'s symmetric
``padding`` cannot express, so the tensor is padded explicitly: -inf for
max, zeros plus the constant ``1/(fs*fs)`` factor for avg.  Surplus trailing
windows are sliced off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .activations import in_dtype


def _padding(size: int, fs: int, stride: int):
    """Low/high padding so window i sits at ``i*stride - (fs-1)//2`` and the
    last kept window (index size//stride - 1) fits."""
    osize = size // stride
    lo = (fs - 1) // 2
    hi = max(0, (osize - 1) * stride - lo + fs - size)
    return lo, hi, osize


def _padded_nchw(x: torch.Tensor, fs: int, stride: int, value: float):
    _, h, w, _ = x.shape
    ylo, yhi, oh = _padding(h, fs, stride)
    xlo, xhi, ow = _padding(w, fs, stride)
    xp = F.pad(x.permute(0, 3, 1, 2), (xlo, xhi, ylo, yhi), value=value)
    return xp, oh, ow


def maxpool2d(x: torch.Tensor, fs: int, stride: int) -> torch.Tensor:
    """(N, H, W, C) centered max pool; int8 codes (an int8 plan's blobs)
    pool through bfloat16, which holds every code exactly."""
    if x.dtype == torch.int8:
        return maxpool2d(x.to(torch.bfloat16), fs, stride).to(torch.int8)
    xp, oh, ow = _padded_nchw(x, fs, stride, float("-inf"))
    y = F.max_pool2d(xp, fs, stride)
    return y[:, :, :oh, :ow].permute(0, 2, 3, 1).contiguous()


def avgpool2d(x: torch.Tensor, fs: int, stride: int) -> torch.Tensor:
    """(N, H, W, C) centered avg pool with the constant fs*fs divisor."""
    xp, oh, ow = _padded_nchw(x, fs, stride, 0.0)
    s = F.avg_pool2d(xp, fs, stride, divisor_override=1)   # window sums
    y = s * in_dtype(1.0 / (fs * fs), s.dtype)
    return y[:, :, :oh, :ow].permute(0, 2, 3, 1).contiguous()


def upsample_nearest(x: torch.Tensor, stride: int) -> torch.Tensor:
    """Nearest-neighbor upsample x stride (ffcnn.c:396-410):
    out[y, x] = in[y//s, x//s]."""
    return x.repeat_interleave(stride, dim=1).repeat_interleave(stride, dim=2)
