"""The int8 convolution of an int8 plan: ``csrc/conv_int8.cu``'s wrapper
(``conv_int8``), its plain PyTorch version (``conv_int8_plain``) and the
parameters both take (``Int8Conv``, made once by ``prepare``).

It replaces the XLA convolution with int8 operands in
``ffcnn_tpu/ops/conv.py::conv2d_int8``: int8 NHWC activations times int8
HWIO weights, int32 accumulation, then ``act(acc * eff + bias)`` in float32
with ``eff = w_scale * x_scale``, stored in the float dtype or requantized
to int8 codes at ``inv = 1 / out_scale`` (a scalar or one a filter).

``prepare`` reproduces the JAX function's host arithmetic: ``eff`` is the
float32 product of ``w_scale`` and ``float32(x_scale)``, ``inv`` the
float32 quotient ``float32(1) / float32(out_scale)`` (JAX divides
``1.0 / np.asarray(out_scale, np.float32)``, a float32 division under
numpy 2).  It also packs the weights for the kernel (a dense conv's as
(F, Kp), K = k*k*C in (ky, kx, c) order padded with zeros to a multiple
of 32; a depthwise conv's of C a multiple of 4 as (k, k, F); another
grouped conv's as (F, k, k, C/groups)) and puts every tensor on the
weights' device, so a forward makes none.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.activations import activate
from . import _build


@dataclasses.dataclass(frozen=True)
class Int8Conv:
    """One int8 conv's parameters, on one device."""
    wq: torch.Tensor             # (fs, fs, C/groups, F) int8, HWIO
    wp: torch.Tensor             # the kernel's packing (module docstring)
    eff: torch.Tensor            # (F,) float32, w_scale * x_scale
    bias: torch.Tensor           # (F,) float32
    inv: Optional[torch.Tensor]  # (F,) or (1,) float32; None: float out
    stride: int
    pad: int
    groups: int
    act: int
    kp: int                      # K padded to 32 (dense), else 0

    @property
    def fs(self) -> int:
        return self.wq.shape[0]

    @property
    def filters(self) -> int:
        return self.wq.shape[3]


def _f32(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().numpy()
    return np.asarray(v, np.float32)


def pack_weights(wq: torch.Tensor, groups: int):
    """(the kernel's packing of HWIO int8 ``wq``, padded K or 0)."""
    fs, _, icg, fn = wq.shape
    if groups == 1:
        k = fs * fs * icg
        kp = -(-k // 32) * 32
        wp = torch.zeros((fn, kp), dtype=torch.int8, device=wq.device)
        wp[:, :k] = wq.permute(3, 0, 1, 2).reshape(fn, k)
        return wp, kp
    if icg == 1 and fn == groups and fn % 4 == 0:   # the char4 path
        return wq.reshape(fs, fs, fn).contiguous(), 0
    return wq.permute(3, 0, 1, 2).contiguous(), 0


def prepare(wq: torch.Tensor, x_scale, w_scale, bias, *, stride: int,
            pad: int, groups: int, act: int, out_scale=None) -> Int8Conv:
    """An ``Int8Conv`` on ``wq``'s device (see the module docstring for the
    host arithmetic)."""
    dev = wq.device
    eff = _f32(w_scale) * np.float32(x_scale)
    inv = None
    if out_scale is not None:
        inv = np.float32(1.0) / np.asarray(out_scale, np.float32)
        inv = torch.from_numpy(np.atleast_1d(inv).astype(np.float32)
                               ).to(dev)
    wp, kp = pack_weights(wq, groups)
    return Int8Conv(wq=wq, wp=wp, eff=torch.from_numpy(eff).to(dev),
                    bias=torch.from_numpy(_f32(bias)).to(dev), inv=inv,
                    stride=stride, pad=pad, groups=groups, act=act, kp=kp)


def conv_int8_plain(xq: torch.Tensor, cp: Int8Conv,
                    float_dtype=torch.bfloat16, raw: bool = False
                    ) -> torch.Tensor:
    """The conv in plain PyTorch, NHWC int8 (N, H, W, C) -> (N, OH, OW, F):
    the int32 accumulators (``raw``), else act(acc * eff + bias) in float32
    (a product, then a sum, each rounded) stored as ``float_dtype`` or, where
    ``cp.inv`` is set, as int8 codes clip(round(y * inv), -127, 127), round
    half to even.  The conv runs in float64, whose products and sums of int8
    codes are exact integers (float32 would round sums past 2^24, 127^2 * K
    for K above about 1,040)."""
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   cp.wq.permute(3, 2, 0, 1).double(), stride=cp.stride,
                   padding=cp.pad, groups=cp.groups)
    acc = acc.permute(0, 2, 3, 1).round().to(torch.int32).contiguous()
    if raw:
        return acc
    y = activate(acc.float() * cp.eff + cp.bias, cp.act)
    if cp.inv is None:
        return y.to(float_dtype)
    return torch.clamp(torch.round(y * cp.inv), -127, 127).to(torch.int8)


_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}


def conv_int8(xq: torch.Tensor, cp: Int8Conv, float_dtype=torch.bfloat16,
              raw: bool = False) -> torch.Tensor:
    """The int8 conv, NHWC int8 (N, H, W, C) -> (N, OH, OW, F) in
    ``float_dtype`` (float32 or bfloat16), int8 codes where ``cp.inv`` is
    set, or with ``raw`` the int32 accumulators.

    CPU tensors take ``conv_int8_plain``; CUDA tensors launch the kernel."""
    if xq.device.type == "cpu":
        return conv_int8_plain(xq, cp, float_dtype, raw)
    n, h, w, c = xq.shape
    if (xq.device.type != "cuda" or xq.dtype != torch.int8
            or not xq.is_contiguous() or c != cp.wq.shape[2] * cp.groups
            or cp.wp.device != xq.device):
        raise ValueError(f"xq must be a contiguous int8 NHWC CUDA tensor of "
                         f"{cp.wq.shape[2] * cp.groups} channels beside the "
                         f"weights, got {xq.dtype} {tuple(xq.shape)} on "
                         f"{xq.device}")
    out = torch.int32 if raw else (torch.int8 if cp.inv is not None
                                   else float_dtype)
    if out not in _KINDS:
        raise ValueError(f"float_dtype must be float32 or bfloat16, got "
                         f"{float_dtype}")
    oh, ow = ((v + 2 * cp.pad - cp.fs) // cp.stride + 1 for v in (h, w))
    y = torch.empty((n, oh, ow, cp.filters), dtype=out, device=xq.device)
    inv = cp.inv
    lib = build()
    err = lib.ffcnn_conv_int8(
        xq.data_ptr(), cp.wp.data_ptr(), cp.eff.data_ptr(),
        cp.bias.data_ptr(), None if inv is None else inv.data_ptr(),
        int(inv is not None and inv.numel() > 1), y.data_ptr(), _KINDS[out],
        n, h, w, c, cp.filters, cp.fs, cp.stride, cp.pad, cp.groups, oh, ow,
        cp.kp, cp.act, _build.stream_ptr())
    conv_int8.launches += 1
    if err:
        raise RuntimeError("int8 conv launch failed: "
                           + lib.ffcnn_conv_int8_error_string(err).decode())
    return y


conv_int8.launches = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the int8 conv's library."""
    lib = _build.load_library("conv_int8")
    lib.ffcnn_conv_int8.argtypes = ([_PTR] * 5 + [_INT, _PTR] + [_INT] * 14
                                    + [_PTR])
    lib.ffcnn_conv_int8.restype = _INT
    lib.ffcnn_conv_int8_error_string.argtypes = [_INT]
    lib.ffcnn_conv_int8_error_string.restype = ctypes.c_char_p
    return lib
