"""Fused convolution ``act(conv(x, w) * scale + bias)`` on NHWC tensors, the
PyTorch port of ``ffcnn_tpu/ops/conv.py::conv2d_fused``, and the int8 conv
of an int8 plan (``conv2d_int8``, ``conv2d_int8_plain``) and of conv-1
straight off the uint8 pixels (``conv0_int8_from_u8``); the kernel and its
prepared parameters are in ``kernels/conv_int8.py``.

The JAX package leaves this conv to XLA; here it goes to ``F.conv2d``
(cuDNN on the card).  Darknet's group-major filter order is the order
``groups`` expects, so a grouped conv needs no reshuffle.

Precision: the conv accumulates in float32 and the epilogue runs in
float32 before one cast back to the input dtype.  ``F.conv2d`` on bf16
tensors would round its output to bf16 before the epilogue, so a bf16
input is upcast first; its products are exact in float32 (and in TF32,
whose 10-bit mantissa holds bf16's 7), so the result is the float32
accumulation the JAX package asks of the MXU.  Float32 inputs compute at
whatever precision the caller set for cuDNN: parity mode turns TF32 off
(``net.Net``), mirroring ``Precision.HIGHEST``.

``conv2d_f32`` is a conv that the float32 knobs force (``FFCNN_HEAD_F32``,
``FFCNN_F32_STAGES``): ``conv2d_fused`` in float32 as one ``ffcnn::`` op,
whose CUDA implementation turns cuDNN's TF32 off around the call.  The
precision is then part of the op, so a ``torch.export`` program (which
records no process-wide switch) keeps it.  It launches no kernel of the
port: the JAX package leaves this conv to XLA.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels import _library
from .activations import activate


def conv2d_fused(x: torch.Tensor, weights: torch.Tensor, scale: torch.Tensor,
                 bias: torch.Tensor, *, stride: int, pad: int, groups: int,
                 act: int) -> torch.Tensor:
    """act(conv(x, w) * scale + bias), NHWC in and out.

    * ``x``: (N, H, W, C) float
    * ``weights``: (fn, C/groups, fs, fs) OIHW float32 (``params_from_numpy``
      converts the darknet HWIO layout once at load)
    * ``scale``/``bias``: (fn,) float32 folded-BN epilogue
    """
    w = weights.to(x.dtype)        # the JAX conv casts weights to x's dtype
    xc = x.permute(0, 3, 1, 2)     # NCHW view, channels-last memory
    if x.dtype != torch.float32:
        xc, w = xc.float(), w.float()
    y = F.conv2d(xc, w, stride=stride, padding=pad, groups=groups)
    y = y.permute(0, 2, 3, 1)      # back to NHWC, no copy
    y = y * scale.float() + bias.float()
    return activate(y, act).to(x.dtype).contiguous()


def _out_shape(x, weights, stride, pad):
    n, h, w, _ = x.shape
    fn, _, fs, _ = weights.shape
    return (n, (h + 2 * pad - fs) // stride + 1,
            (w + 2 * pad - fs) // stride + 1, fn)


def _conv2d_f32_cpu(x, weights, scale, bias, stride, pad, groups, act):
    return conv2d_fused(x, weights, scale, bias, stride=stride, pad=pad,
                        groups=groups, act=act)


def _conv2d_f32_cuda(x, weights, scale, bias, stride, pad, groups, act):
    old = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        return _conv2d_f32_cpu(x, weights, scale, bias, stride, pad, groups,
                               act)
    finally:
        torch.backends.cudnn.allow_tf32 = old


CONV2D_F32_OP = _library.define(
    "conv2d_f32(Tensor x, Tensor weights, Tensor scale, Tensor bias, "
    "int stride, int pad, int groups, int act) -> Tensor",
    cpu=_conv2d_f32_cpu, cuda=_conv2d_f32_cuda,
    fake=lambda x, w, s, b, stride, pad, groups, act: x.new_empty(
        _out_shape(x, w, stride, pad), dtype=torch.float32))


def conv2d_f32(x: torch.Tensor, weights: torch.Tensor, scale: torch.Tensor,
               bias: torch.Tensor, *, stride: int, pad: int, groups: int,
               act: int) -> torch.Tensor:
    """``conv2d_fused`` on a float32 ``x`` at full float32 precision,
    through ``ffcnn::conv2d_f32``: on the card cuDNN's TF32 is off for the
    call, whatever the caller set; on the CPU it is ``conv2d_fused``."""
    if x.dtype != torch.float32:
        raise ValueError(f"conv2d_f32 takes a float32 x, got {x.dtype}")
    return CONV2D_F32_OP(x, weights, scale, bias, int(stride), int(pad),
                         int(groups), int(act))


def conv0_int8_from_u8(x_u8: torch.Tensor, weights, scale, bias, *,
                       stride: int, pad: int, act: int,
                       float_dtype=torch.bfloat16) -> torch.Tensor:
    """``ffcnn_tpu/ops/conv.py::conv0_int8_from_u8``: a dense first conv on
    raw uint8 NHWC pixels through the int8 conv's uint8 mode.  ``weights``
    are the input-folded float32 HWIO weights (fs, fs, 3, F), as JAX takes
    them, quantized per filter here (``kernels.conv_int8.prepare_conv0``).
    JAX shifts the pixels to codes x - 128 and undoes the shift exactly in
    the epilogue, ``(acc + 128 M) * (wscale * scale) + bias``, M counting
    each output pixel's in-bounds taps; the plain version (a CPU tensor)
    computes that formula.  On the card the kernel's ``u8`` path takes the
    raw pixels as the unsigned operand of the integer tensor cores, with
    no shift: its sum is ``acc + 128 M`` exactly, so the outputs agree bit
    for bit.  Prepares the parameters on each call: a ``Net`` prepares
    them once and calls ``kernels.conv_int8.conv_int8``."""
    from ..kernels.conv_int8 import conv_int8, prepare_conv0
    w = torch.as_tensor(weights).to(x_u8.device)
    cp = prepare_conv0(w, torch.as_tensor(scale).to(x_u8.device),
                       torch.as_tensor(bias).to(x_u8.device),
                       h=x_u8.shape[1], w=x_u8.shape[2], stride=stride,
                       pad=pad, act=act)
    return conv_int8(x_u8, cp, float_dtype)


def _int8_params(xq, wq, x_scale, w_scale, bias, stride, pad, groups, act,
                 out_scale):
    from ..kernels.conv_int8 import prepare
    wq = torch.as_tensor(wq).to(xq.device)
    return prepare(wq, x_scale, w_scale, bias, stride=stride, pad=pad,
                   groups=groups, act=act, out_scale=out_scale)


def conv2d_int8_plain(xq: torch.Tensor, wq, x_scale, w_scale, bias, *,
                      stride: int, pad: int, groups: int, act: int,
                      out_scale=None, float_dtype=torch.bfloat16
                      ) -> torch.Tensor:
    """``ffcnn_tpu/ops/conv.py::conv2d_int8`` in plain PyTorch: int8 NHWC
    ``xq`` at per-tensor ``x_scale`` (per-channel plans fold the input's
    scales into ``wq`` and pass 1), int8 HWIO ``wq`` at per-filter
    ``w_scale``; exact int32 accumulation, then ``act(acc * (w_scale *
    x_scale) + bias)`` in float32, stored as ``float_dtype`` or, with
    ``out_scale`` (a scalar or one a filter), requantized to int8."""
    from ..kernels.conv_int8 import conv_int8_plain
    return conv_int8_plain(xq, _int8_params(
        xq, wq, x_scale, w_scale, bias, stride, pad, groups, act, out_scale),
        float_dtype)


def conv2d_int8(xq: torch.Tensor, wq, x_scale, w_scale, bias, *,
                stride: int, pad: int, groups: int, act: int, out_scale=None,
                float_dtype=torch.bfloat16) -> torch.Tensor:
    """``conv2d_int8_plain``'s function through the int8 conv kernel
    (``kernels/conv_int8.py``, ``csrc/conv_int8.cu``) for a CUDA ``xq``; a
    CPU ``xq`` takes the plain version.  Prepares the parameters on each
    call: the graph prepares them once (``kernels.conv_int8.prepare``) and
    calls ``kernels.conv_int8.conv_int8``."""
    from ..kernels.conv_int8 import conv_int8
    return conv_int8(xq, _int8_params(
        xq, wq, x_scale, w_scale, bias, stride, pad, groups, act, out_scale),
        float_dtype)
