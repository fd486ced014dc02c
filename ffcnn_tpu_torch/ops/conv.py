"""Fused convolution ``act(conv(x, w) * scale + bias)`` on NHWC tensors, the
PyTorch port of ``ffcnn_tpu/ops/conv.py::conv2d_fused``.

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
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

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
