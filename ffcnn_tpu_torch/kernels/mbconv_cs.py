"""The channels-first inverted-residual block (K9): activations as (C, S)
with S = N*H*W, pw-expand -> dw3x3 stride 1 -> pw-project (+ an external
residual).  Holds the CUDA kernel's wrapper, its plain PyTorch version and
the layout helpers.

Replaces ``ffcnn_tpu/kernels/csblock_pallas.py::_cs_kernel`` (launched by
``fused_mbconv_cs``), which no ``Net`` path runs: the block A/B bench
(``ffcnn_tpu_torch/bench_block.py``) drives it.  Its numerics are its own:

* the wrapper rounds ``w1`` and ``w2`` to the input dtype; the depthwise
  taps and every scale and bias stay float32;
* the expand output stays float32 through the depthwise stage (the TPU's
  lane rotates are 32-bit only); the depthwise output ``d`` is rounded to
  the input dtype;
* ``act_mid``, ``act_dw`` and ``act_out`` take the TPU kernel's codes,
  ``LEAKY`` (1) or ``LINEAR`` (0; any other code is linear too);
* ``res_cs`` is an external (Cout, S) tensor added after ``act_out``.

The CUDA kernel (``csrc/mbconv_cs.cu``) is the tensor-core block body of
``csrc/block_round_mma.cuh`` (K8's) under its channels-first policy, on
``pick_tile``'s tiles, rounded where this plain version rounds: in bf16
both products are one ``mma.sync`` m16n8k16 bf16 pass (every operand a
bf16 value: exact products, float32 sums), in float32 3xTF32 (about 2^-21
of each product).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..darknet.ir import Activation
from . import _build
from .block_fused import pick_tile

LEAKY = 1   # the TPU kernel's activation codes (csblock_pallas._LEAKY)
LINEAR = 0
_DTYPES = (torch.float32, torch.bfloat16)


def _act(x: torch.Tensor, code: int) -> torch.Tensor:
    return torch.where(x > 0, x, x * 0.1) if code == LEAKY else x


def nhwc_to_cs(x: torch.Tensor) -> torch.Tensor:
    """(N, H, W, C) -> (C, N*H*W), contiguous."""
    n, h, w, c = x.shape
    return x.reshape(n * h * w, c).t().contiguous()


def cs_to_nhwc(x_cs: torch.Tensor, n: int, h: int, w: int) -> torch.Tensor:
    """(C, N*H*W) -> (N, H, W, C), contiguous."""
    return x_cs.t().reshape(n, h, w, x_cs.shape[0]).contiguous()


def _images(s: int, h: int, w: int) -> int:
    if h < 1 or w < 1 or s % (h * w):
        raise ValueError(f"S = {s} is not a whole number of {h}x{w} images")
    return s // (h * w)


def _mbconv_cs_f32(x_cs, w1, s1, b1, wd, sd, bd, w2, s2, b2, res_cs, H, W,
                   act_mid, act_dw, act_out, matmul=torch.matmul
                   ) -> torch.Tensor:
    """K9's block with its rounding points, float32 before the final
    rounding to x_cs's dtype; ``matmul`` computes the two pointwise
    products (the tests pass the kernel's product scheme)."""
    cin, s = x_cs.shape
    n = _images(s, H, W)
    dt = x_cs.dtype
    mid = matmul(w1.to(dt).float(), x_cs.float())
    mid = _act(mid * s1.float()[:, None] + b1.float()[:, None], act_mid)
    # the depthwise stage on the (Cmid, N, H, W) view of the float32 mid
    m4 = torch.nn.functional.pad(mid.reshape(-1, n, H, W), (1, 1, 1, 1))
    acc = torch.zeros((mid.shape[0], n, H, W), dtype=torch.float32,
                      device=x_cs.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + m4[:, :, dy:dy + H, dx:dx + W] \
                * wd[dy, dx].float()[:, None, None, None]
    d = acc.reshape(-1, s) * sd.float()[:, None] + bd.float()[:, None]
    d = _act(d, act_dw).to(dt).float()
    y = matmul(w2.to(dt).float(), d)
    y = _act(y * s2.float()[:, None] + b2.float()[:, None], act_out)
    if res_cs is not None:
        y = y + res_cs.float()
    return y


def fused_mbconv_cs_plain(x_cs, w1, s1, b1, wd, sd, bd, w2, s2, b2,
                          res_cs: Optional[torch.Tensor] = None, *, H: int,
                          W: int, act_mid: int = LEAKY, act_dw: int = LEAKY,
                          act_out: int = LINEAR) -> torch.Tensor:
    """K9 in plain PyTorch, with the TPU kernel's rounding points: x_cs
    (Cin, S), w1 (Cmid, Cin), wd (3, 3, Cmid), w2 (Cout, Cmid), per-stage
    scale and bias (C,); returns (Cout, S) in x_cs's dtype."""
    return _mbconv_cs_f32(x_cs, w1, s1, b1, wd, sd, bd, w2, s2, b2, res_cs,
                          H, W, act_mid, act_dw, act_out).to(x_cs.dtype)


def _act_id(code: int) -> int:
    """A TPU kernel activation code as the CUDA kernels' activation id."""
    return int(Activation.LEAKY) if code == LEAKY else int(Activation.LINEAR)


def fused_mbconv_cs(x_cs, w1, s1, b1, wd, sd, bd, w2, s2, b2,
                    res_cs: Optional[torch.Tensor] = None, *, H: int, W: int,
                    act_mid: int = LEAKY, act_dw: int = LEAKY,
                    act_out: int = LINEAR) -> torch.Tensor:
    """One K9 block, the shapes and arguments of the JAX
    ``fused_mbconv_cs``.

    CPU tensors take ``fused_mbconv_cs_plain``; CUDA tensors launch the
    kernel.  As the JAX wrapper does, ``w1`` and ``w2`` are cast to x's
    dtype and the rest to float32 (no copy where they already are)."""
    kw = dict(H=H, W=W, act_mid=act_mid, act_dw=act_dw, act_out=act_out)
    if x_cs.device.type == "cpu":
        return fused_mbconv_cs_plain(x_cs, w1, s1, b1, wd, sd, bd, w2, s2,
                                     b2, res_cs, **kw)
    if (x_cs.device.type != "cuda" or x_cs.dim() != 2
            or not x_cs.is_contiguous() or x_cs.dtype not in _DTYPES):
        raise ValueError(f"x_cs must be a contiguous (C, S) float32/bfloat16 "
                         f"CUDA tensor, got {x_cs.dtype} "
                         f"{tuple(x_cs.shape)} on {x_cs.device}")
    cin, s = x_cs.shape
    n = _images(s, H, W)
    cmid, cout = w1.shape[0], w2.shape[0]
    dt = x_cs.dtype
    w1, w2 = w1.to(dt).contiguous(), w2.to(dt).contiguous()
    s1, b1, wd, sd, bd, s2, b2 = (t.float().contiguous()
                                  for t in (s1, b1, wd, sd, bd, s2, b2))
    shapes = {"w1": (w1, (cmid, cin)), "s1": (s1, (cmid,)),
              "b1": (b1, (cmid,)), "wd": (wd, (3, 3, cmid)),
              "sd": (sd, (cmid,)), "bd": (bd, (cmid,)),
              "w2": (w2, (cout, cmid)), "s2": (s2, (cout,)),
              "b2": (b2, (cout,))}
    for name, (t, shape) in shapes.items():
        if t.device != x_cs.device or tuple(t.shape) != shape:
            raise ValueError(f"{name} must be {shape} on {x_cs.device}, got "
                             f"{tuple(t.shape)} on {t.device}")
    if res_cs is not None and (
            res_cs.device != x_cs.device or res_cs.dtype != dt
            or tuple(res_cs.shape) != (cout, s)
            or not res_cs.is_contiguous()):
        raise ValueError(f"res_cs must be a contiguous {dt} {(cout, s)} "
                         f"tensor on {x_cs.device}, got {res_cs.dtype} "
                         f"{tuple(res_cs.shape)} on {res_cs.device}")
    th, tw = pick_tile(H, W, 1)
    y = torch.empty((cout, s), dtype=dt, device=x_cs.device)
    lib = build()
    err = lib.ffcnn_mbconv_cs(
        x_cs.data_ptr(), None if res_cs is None else res_cs.data_ptr(),
        y.data_ptr(), int(dt == torch.bfloat16), w1.data_ptr(),
        s1.data_ptr(), b1.data_ptr(), wd.data_ptr(), sd.data_ptr(),
        bd.data_ptr(), w2.data_ptr(), s2.data_ptr(), b2.data_ptr(), n, H, W,
        cin, cmid, cout, _act_id(act_mid), _act_id(act_dw),
        _act_id(act_out), th, tw, _build.stream_ptr())
    fused_mbconv_cs.launches += 1
    if err:
        raise RuntimeError("K9 block launch failed: "
                           + lib.ffcnn_mbconv_cs_error_string(err).decode())
    return y


fused_mbconv_cs.launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load K9's library."""
    lib = _build.load_library("mbconv_cs")
    lib.ffcnn_mbconv_cs.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int]
                                    + [ctypes.c_void_p] * 9
                                    + [ctypes.c_int] * 11 + [ctypes.c_void_p])
    lib.ffcnn_mbconv_cs.restype = ctypes.c_int
    lib.ffcnn_mbconv_cs_error_string.argtypes = [ctypes.c_int]
    lib.ffcnn_mbconv_cs_error_string.restype = ctypes.c_char_p
    return lib
