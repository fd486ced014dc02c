"""The dense 1x1 product of the pointwise-conv micro-bench (P1 and P2):
``y = x @ w``, x (M, K) and w (K, N) bfloat16, float32 sums, y float32.
Holds the CUDA kernel's wrapper, its launch plan and its plain PyTorch
version.

Replaces the two ``pallas_call``s of ``tools/bench_pw_kernels.py``, which no
package path runs: ``kb`` (P1, ``(S, 8) @ (8, 32)``) and ``kc`` (P2, the
same product on K-packed rows, ``(S/16, 128) @ (128, 512)``, against a
block-diagonal weight).  The kernel (``csrc/pw_matmul.cu``) is compiled for
exactly those two (K, N) and streams any M through persistent CTAs; it
computes the dense product it is given, zeros included: exploiting the
block-diagonal structure would be another function.
``ffcnn_tpu_torch/bench_pw_kernels.py`` (the port of the tool) drives it.

bf16 products are exact in float32, so the kernel and the plain version
differ only in the order of their sums.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import List

import torch

from . import _build

# As ``Shape<K, N>`` in csrc/pw_matmul.cu: (K, N) ->
# (instance, rows a tile, ring stages, bytes of an x row in the ring,
# weight bytes in shared memory, output staging bytes, CTAs an SM).
SHAPES = {(8, 32): ("P1", 128, 4, 16, 0, 0, 3),
          (128, 512): ("P2", 32, 4, 256 + 16, 128 * 512 * 2, 2 * 16 * 512 * 4,
                        1)}
CONSUMER_WARPS = 8
THREADS = 32 * (CONSUMER_WARPS + 1)     # and one producer warp
BAR_BYTES = 128                         # the ring's mbarriers
SMEM_LIMIT = 232448                     # dynamic shared memory a CTA, H100


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch: the compiled instance, rows a tile, persistent CTAs,
    threads and dynamic shared memory a CTA, CTAs an SM."""
    variant: str
    rows: int
    ctas: int
    threads: int
    smem: int
    per_sm: int

    def tiles(self, m: int) -> List[range]:
        """Every CTA's row tiles, in its order: CTA c takes tiles c,
        c + ctas, ...; tile i covers rows [i * rows, min((i + 1) * rows,
        m))."""
        return [range(c, -(-m // self.rows), self.ctas)
                for c in range(self.ctas)]


def plan(m: int, k: int, n: int, sms: int) -> Plan:
    """The launch of an (m, k) @ (k, n) product on a card of ``sms`` SMs:
    as many CTAs as row tiles, at most ``per_sm`` an SM.  Raises
    ``ValueError`` for a (k, n) the kernel is not compiled for."""
    if (k, n) not in SHAPES:
        raise ValueError(f"pw_matmul is compiled for (K, N) in "
                         f"{sorted(SHAPES)}, got ({k}, {n})")
    variant, rows, stages, pitch, w_bytes, stg_bytes, per_sm = SHAPES[(k, n)]
    smem = BAR_BYTES + w_bytes + stages * rows * pitch + stg_bytes
    return Plan(variant, rows, min(-(-m // rows), sms * per_sm), THREADS,
                smem, per_sm)


def pw_matmul_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x.float() @ w.float()``: float32 (M, N).  On the card the caller
    turns TF32 off (``torch.backends.cuda.matmul.allow_tf32 = False``, the
    default) so the sums are float32."""
    return x.float() @ w.float()


def pw_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (M, K) @ w (K, N) with float32 sums, float32 (M, N) out.

    CPU tensors take ``pw_matmul_plain``; CUDA tensors launch the kernel,
    which takes contiguous, 16-byte aligned bfloat16 x and w and (K, N)
    (8, 32) or (128, 512), and raises ``ValueError`` on anything else."""
    if x.device.type == "cpu":
        return pw_matmul_plain(x, w)
    for name, t in (("x", x), ("w", w)):
        if (t.device.type != "cuda" or t.device != x.device or t.dim() != 2
                or t.dtype != torch.bfloat16 or not t.is_contiguous()):
            raise ValueError(f"{name} must be a contiguous 2-D bfloat16 CUDA "
                             f"tensor beside x, got {t.dtype} "
                             f"{tuple(t.shape)} on {t.device}")
    (m, k), n = x.shape, w.shape[1]
    if w.shape[0] != k or x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError(f"x {tuple(x.shape)} @ w {tuple(w.shape)}: the "
                         f"kernel takes matching K and 16-byte aligned "
                         f"operands")
    p = plan(m, k, n, _build.sm_count(x.device))
    y = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if p.ctas:
        lib = build()
        pw_matmul.launches += 1
        err = lib.ffcnn_pw_matmul(x.data_ptr(), w.data_ptr(), y.data_ptr(),
                                  m, k, n, p.ctas, _build.stream_ptr())
        if err:
            raise RuntimeError("pw_matmul launch failed: "
                               + lib.ffcnn_pw_error_string(err).decode())
    return y


pw_matmul.launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library."""
    lib = _build.load_library("pw_matmul")
    lib.ffcnn_pw_matmul.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                                    + [ctypes.c_void_p])
    lib.ffcnn_pw_matmul.restype = ctypes.c_int
    lib.ffcnn_pw_error_string.argtypes = [ctypes.c_int]
    lib.ffcnn_pw_error_string.restype = ctypes.c_char_p
    return lib
