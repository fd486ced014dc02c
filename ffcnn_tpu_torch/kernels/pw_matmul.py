"""The dense 1x1 product of the pointwise-conv micro-bench (P1 and P2):
``y = x @ w``, x (M, K) and w (K, N) bfloat16, float32 sums, y float32.
Holds the CUDA kernel's wrapper and its plain PyTorch version.

Replaces the two ``pallas_call``s of ``tools/bench_pw_kernels.py``, which no
package path runs: ``kb`` (P1, ``(S, Cin) @ (Cin, Cout)``) and ``kc`` (P2,
the same product on K-packed rows against a block-diagonal weight).  One
kernel serves both, and it computes the dense product it is given, zeros
included: exploiting the block-diagonal structure would be another
function.  ``ffcnn_tpu_torch/bench_pw_kernels.py`` (the port of the tool)
drives it.

bf16 products are exact in float32, so the kernel and the plain version
differ only in the order of their sums.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from . import _build


def pw_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x.float() @ w.float()``: float32 (M, N).  On the card the caller
    turns TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``, the
    default) so the sums are float32."""
    return x.float() @ w.float()


def pw_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) with float32 sums, float32 (M, N) out.

    CPU tensors take ``pw_matmul_plain``; CUDA tensors launch the kernel,
    which takes contiguous bfloat16 x and w, K a multiple of 8."""
    if x.device.type == "cpu":
        return pw_matmul_plain(x, w)
    for name, t in (("x", x), ("w", w)):
        if (t.device.type != "cuda" or t.device != x.device or t.dim() != 2
                or t.dtype != torch.bfloat16 or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous 2-D bfloat16 CUDA "
                             f"tensor beside x, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    m, k = x.shape
    if w.shape[0] != k or k % 8 or x.data_ptr() % 16:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}: the "
                         f"kernel takes matching K, a multiple of 8, and a "
                         f"16-byte aligned x")
    y = torch.empty((m, w.shape[1]), dtype=torch.float32, device=x.device)
    lib = build()
    err = lib.ffcnn_pw_matmul(x.data_ptr(), w.data_ptr(), y.data_ptr(), m, k,
                              w.shape[1], _build.stream_ptr())
    pw_matmul.launches += 1
    if err:
        raise RuntimeError("pw_matmul launch failed: "
                           + lib.ffcnn_pw_error_string(err).decode())
    return y


pw_matmul.launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library."""
    lib = _build.load_library("pw_matmul")
    lib.ffcnn_pw_matmul.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 3
                                    + [ctypes.c_void_p])
    lib.ffcnn_pw_matmul.restype = ctypes.c_int
    lib.ffcnn_pw_error_string.argtypes = [ctypes.c_int]
    lib.ffcnn_pw_error_string.restype = ctypes.c_char_p
    return lib
