"""The int8 convolution of an int8 plan: ``csrc/conv_int8.cu``'s wrapper
(``conv_int8``, the op ``ffcnn::conv_int8``), its plain PyTorch versions
(``conv_int8_plain``, ``conv0_int8_plain``) and the parameters they take
(``Int8Conv``, made once by ``prepare`` or ``prepare_conv0``).

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

The uint8 mode is conv-1 straight off the raw pixels
(``FFCNN_CONV0_INT8=1``), the port of
``ffcnn_tpu/ops/conv.py::conv0_int8_from_u8``: ``prepare_conv0`` quantizes
the folded float32 weights per filter (``wscale = wmax / 127``, round half
to even), and makes ``eff = wscale * scale`` and JAX's correction of its
shift ``m128 = 128 * conv(ones, wq)`` for one input geometry.  The plain
version computes JAX's formula: the pixels shifted to codes (``x ^
0x80``), their int32 accumulators, then ``(acc + m128) * eff + bias``.
The card needs no shift: its ``u8`` path multiplies the raw pixels as the
unsigned operand of the integer tensor cores (``u8 x s8``), a tap outside
the image a zero byte, and ``acc + m128`` is that sum exactly (integers
below 2^24), so the two agree bit for bit.  ``m128`` stays the mark of the
geometry an ``Int8Conv`` was made for; the kernel never reads it.

CPU tensors take the plain version; CUDA tensors launch the kernel or
raise.  The kernel routes each call by its shape, dtype and alignment to
one of its paths (``ROUTES``; ``csrc/conv_int8.cu``'s note): ``gemm``
(dense, int8 codes in, C a multiple of 16), ``dw`` (depthwise 3x3 and 5x5
at stride 1 and 2, C a multiple of 16), ``u8`` (the uint8 mode, any
shape), and the first version's ``dense`` (int8 codes, C not a multiple of
16), ``dw4`` and ``grouped``.  ``route`` names the path a call takes (the
tiles and shared memory are the kernel's own choice);
``conv_int8.routes`` counts the launches of each path.
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
from . import _build, _library


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
    # the uint8 mode's (OH * OW, F) float32 128 * conv(ones, wq), for one
    # input geometry (the plain version's term; the kernel reads none);
    # None for int8 codes in
    m128: Optional[torch.Tensor] = None

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
    # contiguous: an exported program saves its constants whole
    return Int8Conv(wq=wq.contiguous(), wp=wp,
                    eff=torch.from_numpy(eff).to(dev),
                    bias=torch.from_numpy(_f32(bias)).to(dev), inv=inv,
                    stride=stride, pad=pad, groups=groups, act=act, kp=kp)


def prepare_conv0(weights: torch.Tensor, scale, bias, *, h: int, w: int,
                  stride: int, pad: int, act: int) -> Int8Conv:
    """The uint8 mode's ``Int8Conv`` for a dense conv on (h, w) pixels of
    ``weights`` (float32 HWIO (fs, fs, C, F), the input transform folded
    in), as ``conv0_int8_from_u8`` quantizes them: per-filter ``wscale =
    wmax / 127`` (1 for an all-zero filter), ``wq = round(w / wscale)``,
    ``eff = wscale * scale`` in float32; ``m128`` counts each output
    pixel's in-bounds taps, weighted by ``wq``, times 128."""
    wf = torch.as_tensor(weights).float().contiguous()
    dev = wf.device
    wmax = wf.abs().amax(dim=(0, 1, 2))
    wscale = torch.where(wmax > 0, wmax / 127.0, torch.ones_like(wmax))
    wq = torch.round(wf / wscale).to(torch.int8)
    ones = torch.ones((1, wf.shape[2], h, w), dtype=torch.float64,
                      device=dev)
    m = F.conv2d(ones, wq.permute(3, 2, 0, 1).double(), stride=stride,
                 padding=pad)
    fn = wq.shape[3]
    m128 = (128.0 * m).permute(0, 2, 3, 1).reshape(-1, fn).float()
    wp, kp = pack_weights(wq, 1)
    eff = wscale * torch.as_tensor(scale, dtype=torch.float32, device=dev)
    return Int8Conv(wq=wq, wp=wp, eff=eff.contiguous(),
                    bias=torch.as_tensor(bias, dtype=torch.float32,
                                         device=dev).contiguous(),
                    inv=None, stride=stride, pad=pad, groups=1, act=act,
                    kp=kp, m128=m128.contiguous())


# csrc/conv_int8.cu's paths, in the order of its Route
ROUTES = ("dense", "gemm", "dw", "dw4", "grouped", "u8")


def route(c: int, f: int, k: int, stride: int, groups: int,
          x_u8: bool = False, aligned: bool = True) -> str:
    """The path the kernel takes (``route_of``); ``aligned``: x, the
    packed weights and the output 16-byte aligned, as every tensor torch
    allocates, and fewer than 2^31 input and output pixels.  Every uint8
    call (``x_u8``) takes ``u8``, aligned or not."""
    if x_u8:
        return "u8"
    if groups == 1:
        return "gemm" if c % 16 == 0 and aligned else "dense"
    if c == groups == f:
        if c % 16 == 0 and k in (3, 5) and stride in (1, 2) and aligned:
            return "dw"
        if c % 4 == 0:
            return "dw4"
    return "grouped"


def _shift(x_u8: torch.Tensor) -> torch.Tensor:
    """uint8 pixels -> int8 codes x - 128, as ``x ^ 0x80`` reinterpreted."""
    return torch.bitwise_xor(x_u8, 0x80).view(torch.int8)


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
    if xq.dtype == torch.uint8:
        return conv0_int8_plain(xq, cp, float_dtype, raw)
    acc = F.conv2d(xq.permute(0, 3, 1, 2).double(),
                   cp.wq.permute(3, 2, 0, 1).double(), stride=cp.stride,
                   padding=cp.pad, groups=cp.groups)
    acc = acc.permute(0, 2, 3, 1).round().to(torch.int32).contiguous()
    if raw:
        return acc
    return _epilogue(acc.float(), cp, float_dtype)


def _epilogue(acc: torch.Tensor, cp: Int8Conv, float_dtype):
    y = activate(acc * cp.eff + cp.bias, cp.act)
    if cp.inv is None:
        return y.to(float_dtype)
    return torch.clamp(torch.round(y * cp.inv), -127, 127).to(torch.int8)


def _check_geometry(m128, oh: int, ow: int, fn: int) -> None:
    """Refuse a uint8-mode call on an ``Int8Conv`` made for another input
    geometry (or not by ``prepare_conv0``), the same on the CPU and the
    card."""
    if m128 is None:
        raise ValueError("uint8 pixels need the uint8 mode's m128 "
                         "(prepare_conv0)")
    if tuple(m128.shape) != (oh * ow, fn):
        raise ValueError(f"m128 {tuple(m128.shape)} was made for another "
                         f"geometry than this ({oh}x{ow} outputs, {fn} "
                         f"filters)")


def conv0_int8_plain(x_u8: torch.Tensor, cp: Int8Conv,
                     float_dtype=torch.bfloat16, raw: bool = False
                     ) -> torch.Tensor:
    """The uint8 mode in plain PyTorch, JAX's formula, uint8 NHWC (N, H, W,
    C) -> (N, OH, OW, F): the int32 accumulators of the shifted codes
    (``raw``, as ``conv_int8_plain`` accumulates them), else ``act((acc +
    m128) * eff + bias)`` in float32, each step rounded, stored as
    ``float_dtype`` (or int8 codes where ``cp.inv`` is set)."""
    oh, ow = _out_hw(x_u8, cp.wq, cp.stride, cp.pad)
    _check_geometry(cp.m128, oh, ow, cp.filters)
    acc = conv_int8_plain(_shift(x_u8), dataclasses.replace(cp, m128=None),
                          raw=True)
    if raw:
        return acc
    return _epilogue(acc.float() + cp.m128.view(oh, ow, cp.filters), cp,
                     float_dtype)


_KINDS = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2, torch.int32: 3}


def _out_dtype(float_dtype, inv, raw):
    return torch.int32 if raw else (torch.int8 if inv is not None
                                    else float_dtype)


def _out_hw(x, wq, stride, pad):
    fs = wq.shape[0]
    return tuple((v + 2 * pad - fs) // stride + 1 for v in x.shape[1:3])


def _rebuild(wq, wp, eff, bias, inv, m128, stride, pad, groups, act, kp):
    return Int8Conv(wq=wq, wp=wp, eff=eff, bias=bias, inv=inv,
                    stride=stride, pad=pad, groups=groups, act=act, kp=kp,
                    m128=m128)


def _conv_cpu(x, wq, wp, eff, bias, inv, m128, stride, pad, groups, act, kp,
              float_dtype, raw):
    return conv_int8_plain(x, _rebuild(wq, wp, eff, bias, inv, m128, stride,
                                       pad, groups, act, kp),
                           float_dtype, raw)


def _conv_fake(x, wq, wp, eff, bias, inv, m128, stride, pad, groups, act,
               kp, float_dtype, raw):
    oh, ow = _out_hw(x, wq, stride, pad)
    return x.new_empty((x.shape[0], oh, ow, wq.shape[3]),
                       dtype=_out_dtype(float_dtype, inv, raw))


def _conv_cuda(xq, wq, wp, eff, bias, inv, m128, stride, pad, groups, act,
               kp, float_dtype, raw):
    n, h, w, c = xq.shape
    u8 = xq.dtype == torch.uint8
    fn = wq.shape[3]
    if (xq.device.type != "cuda" or xq.dtype not in (torch.int8, torch.uint8)
            or not xq.is_contiguous() or c != wq.shape[2] * groups
            or wp.device != xq.device):
        raise ValueError(f"xq must be a contiguous int8 (or uint8) NHWC CUDA "
                         f"tensor of {wq.shape[2] * groups} channels beside "
                         f"the weights, got {xq.dtype} {tuple(xq.shape)} on "
                         f"{xq.device}")
    out = _out_dtype(float_dtype, inv, raw)
    if out not in _KINDS:
        raise ValueError(f"float_dtype must be float32 or bfloat16, got "
                         f"{float_dtype}")
    oh, ow = _out_hw(xq, wq, stride, pad)
    if u8:      # the kernel reads no m128; it marks the geometry
        _check_geometry(m128, oh, ow, fn)
    y = torch.empty((n, oh, ow, fn), dtype=out, device=xq.device)
    lib = build()
    path = ctypes.c_int(-1)
    err = lib.ffcnn_conv_int8(
        xq.data_ptr(), wp.data_ptr(), eff.data_ptr(), bias.data_ptr(),
        None if inv is None else inv.data_ptr(),
        int(inv is not None and inv.numel() > 1), int(u8), y.data_ptr(),
        _KINDS[out],
        n, h, w, c, fn, wq.shape[0], stride, pad, groups, oh, ow, kp, act,
        _build.stream_ptr(), ctypes.byref(path))
    conv_int8.launches += 1
    if path.value >= 0:
        conv_int8.routes[ROUTES[path.value]] += 1
    if err:
        raise RuntimeError("int8 conv launch failed: "
                           + lib.ffcnn_conv_int8_error_string(err).decode())
    return y


CONV_INT8_OP = _library.define(
    "conv_int8(Tensor x, Tensor wq, Tensor wp, Tensor eff, Tensor bias, "
    "Tensor? inv, Tensor? m128, int stride, int pad, int groups, int act, "
    "int kp, ScalarType float_dtype, bool raw) -> Tensor",
    cpu=_conv_cpu, cuda=_conv_cuda, fake=_conv_fake)


def conv_int8(xq: torch.Tensor, cp: Int8Conv, float_dtype=torch.bfloat16,
              raw: bool = False) -> torch.Tensor:
    """The int8 conv (``ffcnn::conv_int8``), NHWC int8 (N, H, W, C) -> (N,
    OH, OW, F) in ``float_dtype`` (float32 or bfloat16), int8 codes where
    ``cp.inv`` is set, or with ``raw`` the int32 accumulators.  uint8
    ``xq`` with an ``Int8Conv`` of ``prepare_conv0`` is the uint8 mode (the
    kernel's ``u8`` path; ``raw`` gives JAX's accumulators of the shifted
    codes there too).

    CPU tensors take ``conv_int8_plain``; CUDA tensors launch the kernel."""
    return CONV_INT8_OP(xq, cp.wq, cp.wp, cp.eff, cp.bias, cp.inv, cp.m128,
                        cp.stride, cp.pad, cp.groups, cp.act, cp.kp,
                        float_dtype, raw)


conv_int8.launches = 0
conv_int8.routes = dict.fromkeys(ROUTES, 0)   # launches a path

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the int8 conv's library."""
    lib = _build.load_library("conv_int8")
    lib.ffcnn_conv_int8.argtypes = ([_PTR] * 5 + [_INT, _INT, _PTR]
                                    + [_INT] * 14 + [_PTR,
                                                     ctypes.POINTER(_INT)])
    lib.ffcnn_conv_int8.restype = _INT
    lib.ffcnn_conv_int8_error_string.argtypes = [_INT]
    lib.ffcnn_conv_int8_error_string.restype = ctypes.c_char_p
    return lib
