"""The uint8 stem (K6): conv-1 (3x3, stride 2, pad 1) straight off the raw
BGR bytes, with the input transform folded into its float32 weights.  Holds
the CUDA kernel's wrapper and its plain PyTorch version.

Replaces ``ffcnn_tpu/kernels/conv0_fused.py::_make_kernel`` (launched by
``conv0_cs``).  The JAX kernel emits the fused (H, C, W*N) layout for the
region run that starts at layer 1; the port has no such layout, so the
output is NHWC and goes to that run as it is (``graph/build.py``).  The
TPU's VMEM limit (``_pick_rows`` returning 0, then the XLA stem) has no
counterpart: the kernel takes every even size.

Weight precision follows the JAX kernel, not the default stem: the folded
weights stay float32 (the default stem rounds them to the blob dtype).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..darknet.ir import LayerType, NetIR
from ..ops.activations import activate
from . import _build


@dataclasses.dataclass(frozen=True)
class Conv0Params:
    """The stem in the kernel's float32 layouts."""
    wm: torch.Tensor      # (27, F) taps in HWIO order (dy, dx, channel)
    scale: torch.Tensor   # (F,)
    bias: torch.Tensor
    act: int


def conv0_params(ir: NetIR, params) -> Conv0Params:
    """Layer 0 of a port params dict (OIHW weights, usually the folded ones
    of ``graph.build.fold_input_transform``) in the kernel's layouts."""
    l0, p = ir.layers[0], params[0]
    if (l0.type != LayerType.CONV or l0.groups != 1 or l0.fs != 3
            or l0.stride != 2 or l0.pad != 1):
        raise ValueError("the stem kernel takes a dense 3x3/s2/pad-1 conv")
    w = p["weights"].float()                          # (F, C, 3, 3)
    return Conv0Params(
        wm=w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous(),
        scale=p["scale"].float().contiguous(),
        bias=p["bias"].float().contiguous(), act=l0.activation)


def conv0_plain(x: torch.Tensor, cp: Conv0Params,
                out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The stem in plain PyTorch, float32 inside: uint8 NHWC (N, H, W, C)
    -> (N, H/2, W/2, F) in ``out_dtype``.  The 27 taps are gathered in
    HWIO order and contracted with ``cp.wm`` in one float32 matmul, as
    ``_make_kernel`` does."""
    n, h, w, _ = x.shape
    ho, wo = h // 2, w // 2
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    im = torch.cat([xp[:, dy:dy + 2 * ho:2, dx:dx + 2 * wo:2]
                    for dy in range(3) for dx in range(3)], dim=-1)
    y = torch.matmul(im, cp.wm) * cp.scale + cp.bias
    return activate(y, cp.act).to(out_dtype)


def conv0_cs(x: torch.Tensor, cp: Conv0Params,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 NHWC (N, H, W, 3), even H and W -> NHWC (N, H/2, W/2, F) in
    ``out_dtype`` (float32 or bfloat16).

    CPU tensors take ``conv0_plain``; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return conv0_plain(x, cp, out_dtype)
    if (x.device.type != "cuda" or x.dtype != torch.uint8 or x.dim() != 4
            or x.shape[-1] != 3 or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous uint8 (N, H, W, 3) CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    n, h, w, _ = x.shape
    f = cp.wm.shape[1]
    if h % 2 or w % 2:
        raise ValueError(f"the stem needs even H and W, got {h}x{w}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    for name, shape in (("wm", (27, f)), ("scale", (f,)), ("bias", (f,))):
        t = getattr(cp, name)
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    y = torch.empty((n, h // 2, w // 2, f), dtype=out_dtype, device=x.device)
    lib = build()
    err = lib.ffcnn_conv0(x.data_ptr(), y.data_ptr(),
                          int(out_dtype == torch.bfloat16), cp.wm.data_ptr(),
                          cp.scale.data_ptr(), cp.bias.data_ptr(), n, h, w, f,
                          cp.act, _build.stream_ptr())
    conv0_cs.launches += 1
    if err:
        raise RuntimeError("stem launch failed: "
                           + lib.ffcnn_conv0_error_string(err).decode())
    return y


conv0_cs.launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library."""
    lib = _build.load_library("conv0_fused")
    lib.ffcnn_conv0.argtypes = ([ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int] + [ctypes.c_void_p] * 3
                                + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.ffcnn_conv0.restype = ctypes.c_int
    lib.ffcnn_conv0_error_string.argtypes = [ctypes.c_int]
    lib.ffcnn_conv0_error_string.restype = ctypes.c_char_p
    return lib
