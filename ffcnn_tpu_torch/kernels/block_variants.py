"""K1's stride-1 block cut into the variants of the small-C bisection (P3):
the tile streamed alone, the taps alone in three precisions, the two
pointwise products alone, the whole block, and the whole block with bf16
operands.  Holds the CUDA kernel's wrapper, its plain PyTorch version and
the tool's step on its (H, C, W*N) layout.

Replaces ``tools/bisect_smallc.py::make_variant_kernel`` (launched by
``variant_step``), which no package path runs: the port of the tool,
``ffcnn_tpu_torch/bisect_smallc.py``, drives it.  The kernel works in NHWC
like K1, so the split it reports is the split of the port's K1; the step
converts the tool's layout before and after (the tool's ``tpose`` row).

The semantics are the tool's, with P = C and fixed activations (leaky
expand, leaky depthwise, linear project, linear residual), for float32 or
bfloat16 storage T:

* ``copy``: the identity, bit for bit.
* ``dwonly``: ``T(leaky(sum of the 3x3 taps of the zero-padded rows times
  kdw[dy, dx][:C])))``, no scale or bias, float32 sums.
* ``dwmixed``: the same values (bf16 rows times float32 taps promote to
  float32); the kernel stages the rows in T.
* ``dwbf16``: the taps rounded to bf16.  With bf16 storage every product
  and every sum rounds to bf16 and the leaky slope is bf16(0.1), as JAX
  computes ``acc + rows * k`` in bf16; with float32 storage the sums are
  float32 (JAX promotes them).
* ``pwonly``: ``T((leaky(x @ w1 * s1 + b1) @ w2) * s3 + b3 + x)``: no
  halo, no taps.
* ``full``: K1 itself (its template and C-entry body); the expand is
  zeroed outside the image after its epilogue (pw of a zero pixel is
  leaky(b1), not 0).
* ``fullbf16``: ``full`` with w1 and w2 rounded to bf16, the expand rounded
  to bf16 after the zeroing, and the depthwise output rounded to bf16
  before the projection.

On the card (``csrc/block_variants.cu``) ``pwonly`` and ``fullbf16`` run the
tensor-core block body of ``csrc/block_round_mma.cuh`` on ``pick_tile``'s
tiles, and the tap modes a kernel of their own on bands of whole rows
(``tap_band``): C a multiple of 8, the band and its halo rows staged in
shared memory (``tap_smem``).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
from typing import Callable, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from ..darknet.ir import Activation
from . import _build
from .block_fused import BlockParams, pick_tile

MODES = ("copy", "dwonly", "dwmixed", "dwbf16", "pwonly", "full",
         "fullbf16")
TAP_MODES = MODES[:4]          # the tool picks their rows on C, not E
_DTYPES = (torch.float32, torch.bfloat16)
_SLOPE_BF16 = 0.10009765625    # bf16(0.1): JAX's leaky slope on bf16 values
_MAX_C = 128                   # one output-channel group (csrc kOG)
MAX_SMEM = 232448              # a CTA's shared memory on sm_90 (csrc kMaxSmem)
# The tap modes' staged rows a CTA aims at: three CTAs share an SM, so
# two CTAs' rows are on their way while one computes.
TAP_BAND_BYTES = 64 * 1024


@dataclasses.dataclass(frozen=True)
class VariantParams:
    """The tool's nine parameters in the kernel's layout, float32 and
    contiguous: w1 (C, E), s1/b1 (E,), kdw (E, 9) as K1's (``BlockParams``),
    s2/b2 (E,), w2 (E, C), s3/b3 (C,)."""
    w1: torch.Tensor
    s1: torch.Tensor
    b1: torch.Tensor
    kdw: torch.Tensor
    s2: torch.Tensor
    b2: torch.Tensor
    w2: torch.Tensor
    s3: torch.Tensor
    b3: torch.Tensor


def variant_params(params9: Sequence[torch.Tensor]) -> VariantParams:
    """From the tool's shapes: w1 (E, C), s1/b1 (E, 1), kdw (3, 3, E), s2/b2
    (E, 1), w2 (C, E), s3/b3 (C, 1)."""
    w1, s1, b1, kdw, s2, b2, w2, s3, b3 = (t.float() for t in params9)
    vec = lambda t: t.reshape(-1).contiguous()
    return VariantParams(w1.t().contiguous(), vec(s1), vec(b1),
                         kdw.reshape(9, -1).t().contiguous(), vec(s2), vec(b2),
                         w2.t().contiguous(), vec(s3), vec(b3))


def k1_params(vp: VariantParams) -> BlockParams:
    """The variants' block as K1's parameters (leaky expand, leaky
    depthwise, linear project, linear residual): what ``full`` launches
    K1's template with."""
    return BlockParams(**{f.name: getattr(vp, f.name)
                          for f in dataclasses.fields(vp)},
                       acts=(Activation.LEAKY, Activation.LEAKY,
                             Activation.LINEAR),
                       residual=True, res_act=Activation.LINEAR)


def _leaky(x: torch.Tensor, slope: float = 0.1) -> torch.Tensor:
    return torch.where(x > 0, x, x * slope)


def _taps(xp: torch.Tensor, k: torch.Tensor, h: int, w: int,
          dtype: torch.dtype) -> torch.Tensor:
    """The 3x3 taps of the padded (N, h+2, w+2, C) rows, summed in
    ``dtype`` in the tool's order (dy, then dx)."""
    acc = torch.zeros((xp.shape[0], h, w, xp.shape[3]), dtype=dtype,
                      device=xp.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, dy:dy + h, dx:dx + w] * k[dy, dx]
    return acc


def _pad(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 1, 1, 1))


def _block_f32(mode: str, x: torch.Tensor, vp: VariantParams,
               matmul=torch.matmul) -> torch.Tensor:
    """pwonly, full or fullbf16 with their rounding points, float32 before
    the final rounding to x's dtype; ``matmul`` computes the two pointwise
    products (the tests pass the kernel's product scheme)."""
    h, w = x.shape[1:3]
    kdw = vp.kdw.t().reshape(3, 3, -1)      # the tool's (3, 3, E)
    bf = mode == "fullbf16"

    def rnd(t):
        return t.to(torch.bfloat16).float() if bf else t
    xf = x.float()
    d = _leaky(matmul(xf, rnd(vp.w1)) * vp.s1 + vp.b1)
    if mode != "pwonly":
        acc = _taps(_pad(rnd(d)), kdw, h, w, torch.float32)
        d = rnd(_leaky(acc * vp.s2 + vp.b2))
    return matmul(d, rnd(vp.w2)) * vp.s3 + vp.b3 + xf


def variant_plain(mode: str, x: torch.Tensor,
                  vp: VariantParams) -> torch.Tensor:
    """One variant in plain PyTorch: NHWC (N, H, W, C) -> (N, H, W, C) in
    x's dtype."""
    _check_mode(mode)
    n, h, w, c = x.shape
    if mode == "copy":
        return x.clone()
    if mode in TAP_MODES:
        k = vp.kdw.t().reshape(3, 3, -1)[..., :c]
        if mode == "dwbf16":
            k, rows = k.to(torch.bfloat16), x
        else:
            rows = x.float()
        acc = _taps(_pad(rows), k, h, w, rows.dtype)
        slope = _SLOPE_BF16 if acc.dtype == torch.bfloat16 else 0.1
        return _leaky(acc, slope).to(x.dtype)
    return _block_f32(mode, x, vp).to(x.dtype)


def tap_smem(rows: int, w: int, c: int, itemsize: int, mode: str) -> int:
    """Bytes of shared memory a tap-mode CTA takes for a band of ``rows``
    output rows of width ``w`` (csrc/block_variants.cu ``tap_smem``): the
    rows and (but for copy) their two halo rows in the storage type, and
    for dwonly with bf16 storage the same rows again as float32."""
    halo = 0 if mode == "copy" else 2
    extra = 4 if mode == "dwonly" and itemsize == 2 else 0
    return (rows + halo) * w * c * (itemsize + extra)


def tap_band(h: int, w: int, c: int, itemsize: int, mode: str) -> int:
    """The output rows a tap-mode CTA owns: as many whole rows as fit
    ``TAP_BAND_BYTES`` of staged rows (at least one), spread evenly over
    the image's bands.  Raises ``ValueError`` where one row and its halo do
    not fit a CTA's shared memory.  The kernel's tile is (band, w)."""
    halo = tap_smem(0, w, c, itemsize, mode)
    row = tap_smem(1, w, c, itemsize, mode) - halo
    if halo + row > MAX_SMEM:
        raise ValueError(f"a row of {w} pixels x {c} channels does not fit "
                         f"a CTA's shared memory in mode {mode}")
    h = max(h, 1)
    most = min(h, max(1, (TAP_BAND_BYTES - halo) // row))
    bands = -(-h // most)
    return -(-h // bands)


def block_variant(mode: str, x: torch.Tensor, vp: VariantParams,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One variant, NHWC (N, H, W, C) -> (N, H, W, C) in x's dtype, into
    ``out`` where given (it must not be x: the kernel reads x's halo).

    CPU tensors take ``variant_plain``; CUDA tensors launch the kernel."""
    _check_mode(mode)
    if x.device.type == "cpu":
        y = variant_plain(mode, x, vp)
        return y if out is None else out.copy_(y)
    _check(mode, x, vp, out)
    n, h, w, c = x.shape
    th, tw = tile_of(mode, h, w, c, vp.w1.shape[1], x.element_size())
    y = torch.empty_like(x) if out is None else out
    lib = build()
    err = lib.ffcnn_block_variant(
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
        MODES.index(mode), *(getattr(vp, f.name).data_ptr()
                             for f in dataclasses.fields(vp)),
        n, h, w, c, vp.w1.shape[1], th, tw, _build.stream_ptr())
    block_variant.launches += 1
    if err:
        raise RuntimeError("block variant launch failed: "
                           + lib.ffcnn_variant_error_string(err).decode())
    return y


block_variant.launches = 0


def tile_of(mode: str, h: int, w: int, c: int, e: int,
            itemsize: int) -> Tuple[int, int]:
    """The (th, tw) the kernel takes for ``mode`` on an (h, w, c) map with
    E = ``e``: ``pick_tile``'s output tile for pwonly, full and fullbf16;
    (``tap_band``, w), a band of whole rows, for the tap modes.  Raises
    ``ValueError`` for what the kernel cannot take: C > 128, and in a tap
    mode C > E (its taps are kdw[:C]), C not a multiple of 8 (it works in
    8-channel vectors of 16 or 32 bytes) or a row beyond shared memory."""
    if c > _MAX_C or (mode in TAP_MODES and (c > e or c % 8)):
        raise ValueError(f"C {c}, E {e}: the kernel takes C <= {_MAX_C}, "
                         f"and C <= E, C a multiple of 8 for the tap modes")
    if mode in TAP_MODES:
        return tap_band(h, w, c, itemsize, mode), w
    return pick_tile(h, w)


def _check_mode(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")


def _check(mode: str, x: torch.Tensor, vp: VariantParams,
           out: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take."""
    if (x.device.type != "cuda" or x.dim() != 4 or not x.is_contiguous()
            or x.dtype not in _DTYPES):
        raise ValueError(f"x must be a contiguous NHWC float32/bfloat16 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    c, e = x.shape[3], vp.w1.shape[1]
    shapes = dict(w1=(c, e), s1=(e,), b1=(e,), kdw=(e, 9), s2=(e,),
                  b2=(e,), w2=(e, c), s3=(c,), b3=(c,))
    for name, shape in shapes.items():
        t = getattr(vp, name)
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if out is not None and (out.shape != x.shape or out.dtype != x.dtype
                            or out.device != x.device
                            or not out.is_contiguous()
                            or out.data_ptr() == x.data_ptr()):
        raise ValueError("out must be a contiguous tensor like x, not x")


def cs_to_nhwc(x: torch.Tensor, n: int) -> torch.Tensor:
    """The tool's (H, C, W*N) layout, S = w*N + n, to NHWC (N, H, W, C)."""
    hh, c, s = x.shape
    return x.reshape(hh, c, s // n, n).permute(3, 0, 2, 1).contiguous()


def nhwc_to_cs(x: torch.Tensor) -> torch.Tensor:
    """NHWC (N, H, W, C) to the tool's (H, C, W*N) layout."""
    n, hh, w, c = x.shape
    return x.permute(1, 3, 2, 0).reshape(hh, c, w * n).contiguous()


def variant_step(mode: str, hh: int, width: int, n: int, c: int, e: int,
                 params9: Sequence[torch.Tensor], dtype: torch.dtype
                 ) -> Callable[[torch.Tensor], torch.Tensor]:
    """The tool's ``variant_step``: a step (H, C, W*N) -> (H, C, W*N) of
    ``dtype``, through NHWC and back, with the tool's nine parameters."""
    _check_mode(mode)
    vp = variant_params(params9)
    if tuple(vp.w1.shape) != (c, e):
        raise ValueError(f"w1 is {tuple(params9[0].shape)}, not (E, C) = "
                         f"{(e, c)}")

    def step(x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != (hh, c, width * n) or x.dtype != dtype:
            raise ValueError(f"the step takes {dtype} {(hh, c, width * n)}, "
                             f"got {x.dtype} {tuple(x.shape)}")
        return nhwc_to_cs(block_variant(mode, cs_to_nhwc(x, n), vp))
    return step


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library."""
    lib = _build.load_library("block_variants")
    lib.ffcnn_block_variant.argtypes = ([ctypes.c_void_p] * 2
                                        + [ctypes.c_int] * 2
                                        + [ctypes.c_void_p] * 9
                                        + [ctypes.c_int] * 7
                                        + [ctypes.c_void_p])
    lib.ffcnn_block_variant.restype = ctypes.c_int
    lib.ffcnn_variant_error_string.argtypes = [ctypes.c_int]
    lib.ffcnn_variant_error_string.restype = ctypes.c_char_p
    return lib
