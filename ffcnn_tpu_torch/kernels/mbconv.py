"""The NHWC inverted-residual block (K8): pw-expand -> dw3x3 (stride 1 or 2)
-> pw-project (+ an external residual).  Holds the CUDA kernel's wrapper and
its plain PyTorch version.

Replaces ``ffcnn_tpu/kernels/block_pallas.py::_block_kernel`` (launched by
``fused_mbconv``), which no ``Net`` path runs: the block A/B bench
(``ffcnn_tpu_torch/bench_block.py``, the port of ``tools/bench_block.py``)
drives it.  It is not K1 in another layout; its numerics are its own:

* the weights stay float32 and the products run in float32 on the input's
  values;
* the expand output ``h1`` is rounded to the input dtype before the
  depthwise stage (the TPU kernel keeps it in a scratch of ``x.dtype``), and
  the depthwise output ``d`` is rounded too;
* the depthwise activation is always leaky; ``act_mid`` and ``act_out``
  pick leaky (True) or linear (False);
* ``res`` is an external tensor added after ``act_out`` with no activation
  (``residual=True`` without ``res`` adds zeros, as the JAX wrapper does);
* at stride 2, H and W must be even: the JAX kernel fails on odd sizes, and
  here both versions raise ``ValueError``.

The CUDA kernel (``csrc/mbconv.cu``) is the tensor-core block body of
``csrc/block_round_mma.cuh`` under its K8 policy, on ``pick_tile``'s tiles:
both products in split TF32 (``mma.sync``, about 2^-21 of each product),
rounded where this plain version rounds.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .block_fused import pick_tile

_DTYPES = (torch.float32, torch.bfloat16)


def _leaky(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x > 0, x, x * 0.1)


def _out_size(h: int, w: int, stride: int):
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if stride == 2 and (h % 2 or w % 2):
        raise ValueError(f"a stride-2 block needs even H and W, got {h}x{w}")
    return h // stride, w // stride


def _mbconv_f32(x, w1, s1, b1, wd, sd, bd, w2, s2, b2, res, stride,
                residual, act_mid, act_out, matmul=torch.matmul
                ) -> torch.Tensor:
    """K8's block with its rounding points, float32 before the final
    rounding to x's dtype; ``matmul`` computes the two pointwise products
    (the tests pass the kernel's product scheme)."""
    n, h, w, _ = x.shape
    oh, ow = _out_size(h, w, stride)
    h1 = matmul(x.float(), w1.float()) * s1 + b1
    h1 = (_leaky(h1) if act_mid else h1).to(x.dtype).float()
    # the zero padding applies to the rounded expand output
    hp = F.pad(h1, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, oh, ow, h1.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + hp[:, dy:dy + stride * oh:stride,
                           dx:dx + stride * ow:stride] * wd[dy, dx].float()
    d = _leaky(acc * sd + bd).to(x.dtype).float()
    y = matmul(d, w2.float()) * s2 + b2
    if act_out:
        y = _leaky(y)
    if residual and res is not None:
        y = y + res.float()
    return y


def fused_mbconv_plain(x, w1, s1, b1, wd, sd, bd, w2, s2, b2,
                       res: Optional[torch.Tensor] = None, *,
                       stride: int = 1, residual: bool = False,
                       act_mid: bool = True, act_out: bool = False
                       ) -> torch.Tensor:
    """K8 in plain PyTorch, with the TPU kernel's rounding points: x (N, H,
    W, Cin), w1 (Cin, Cmid), wd (3, 3, Cmid), w2 (Cmid, Cout), per-stage
    scale and bias; returns (N, H/stride, W/stride, Cout) in x's dtype."""
    return _mbconv_f32(x, w1, s1, b1, wd, sd, bd, w2, s2, b2, res, stride,
                       residual, act_mid, act_out).to(x.dtype)


def fused_mbconv(x, w1, s1, b1, wd, sd, bd, w2, s2, b2,
                 res: Optional[torch.Tensor] = None, *, stride: int = 1,
                 residual: bool = False, act_mid: bool = True,
                 act_out: bool = False) -> torch.Tensor:
    """One K8 block, the shapes and arguments of the JAX ``fused_mbconv``.

    CPU tensors take ``fused_mbconv_plain``; CUDA tensors launch the
    kernel (float32 weights, ``res`` in x's dtype)."""
    if x.device.type == "cpu":
        return fused_mbconv_plain(x, w1, s1, b1, wd, sd, bd, w2, s2, b2, res,
                                  stride=stride, residual=residual,
                                  act_mid=act_mid, act_out=act_out)
    if (x.device.type != "cuda" or x.dim() != 4 or not x.is_contiguous()
            or x.dtype not in _DTYPES):
        raise ValueError(f"x must be a contiguous NHWC float32/bfloat16 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    n, h, w, cin = x.shape
    oh, ow = _out_size(h, w, stride)
    cmid, cout = w1.shape[1], w2.shape[1]
    shapes = {"w1": (w1, (cin, cmid)), "s1": (s1, (cmid,)),
              "b1": (b1, (cmid,)), "wd": (wd, (3, 3, cmid)),
              "sd": (sd, (cmid,)), "bd": (bd, (cmid,)),
              "w2": (w2, (cmid, cout)), "s2": (s2, (cout,)),
              "b2": (b2, (cout,))}
    for name, (t, shape) in shapes.items():
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    add = residual and res is not None
    if add and (res.device != x.device or res.dtype != x.dtype
                or tuple(res.shape) != (n, oh, ow, cout)
                or not res.is_contiguous()):
        raise ValueError(f"res must be a contiguous {x.dtype} "
                         f"{(n, oh, ow, cout)} tensor on {x.device}, got "
                         f"{res.dtype} {tuple(res.shape)} on {res.device}")
    th, tw = pick_tile(oh, ow, stride)
    y = torch.empty((n, oh, ow, cout), dtype=x.dtype, device=x.device)
    lib = build()
    err = lib.ffcnn_mbconv(
        x.data_ptr(), res.data_ptr() if add else None, y.data_ptr(),
        int(x.dtype == torch.bfloat16), w1.data_ptr(), s1.data_ptr(),
        b1.data_ptr(), wd.data_ptr(), sd.data_ptr(), bd.data_ptr(),
        w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), n, h, w, cin, cmid,
        cout, stride, int(bool(act_mid)), int(bool(act_out)), th, tw,
        _build.stream_ptr())
    fused_mbconv.launches += 1
    if err:
        raise RuntimeError("K8 block launch failed: "
                           + lib.ffcnn_mbconv_error_string(err).decode())
    return y


fused_mbconv.launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load K8's library."""
    lib = _build.load_library("mbconv")
    lib.ffcnn_mbconv.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                                 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 11
                                 + [ctypes.c_void_p])
    lib.ffcnn_mbconv.restype = ctypes.c_int
    lib.ffcnn_mbconv_error_string.argtypes = [ctypes.c_int]
    lib.ffcnn_mbconv_error_string.restype = ctypes.c_char_p
    return lib
