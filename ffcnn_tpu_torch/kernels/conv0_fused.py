"""The uint8 stem (K6): conv-1 (3x3, stride 2, pad 1) straight off the raw
BGR bytes, with the input transform folded into its float32 weights.  Holds
the CUDA kernel's wrapper, its launch plan and its plain PyTorch version.

Replaces ``ffcnn_tpu/kernels/conv0_fused.py::_make_kernel`` (launched by
``conv0_cs``).  The JAX kernel emits the fused (H, C, W*N) layout for the
region run that starts at layer 1; the port has no such layout, so the
output is NHWC and goes to that run as it is (``graph/build.py``).  The
TPU's VMEM limit (``_pick_rows`` returning 0, then the XLA stem) has no
counterpart: the kernel takes every even size.

Weight precision follows the JAX kernel, not the default stem: the folded
weights stay float32 (the default stem rounds them to the blob dtype).  The
kernel (``csrc/conv0_fused.cu``) multiplies on the tensor cores in TF32:
the pixels are exact there, and the weights go in as two TF32 parts
(``tf32_parts``), so the products keep about 2^-22 of each weight.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ..darknet.ir import LayerType, NetIR
from ..ops.activations import activate
from . import _build, _library

# The kernel's compiled instances, (F, activation); any other pair takes
# the generic instance (masked n8 tiles, the activation read at run time).
# The repo's stride-2 stems: ffcnn-micro F 8, yolo-fastest-xl F 16,
# yolov4-tiny F 32, all leaky.
INSTANCES = ((8, 2), (16, 2), (32, 2))
MAX_F = 256
THREADS = 128                       # a CTA: 4 warps
BAND_ROWS = (4, 2, 1)               # output rows a band, the first that
MAX_COLS = 512                      # gives two bands an SM; columns a band
CTAS_PER_SM = 4                     # persistent CTAs, each two band buffers
MAX_SMEM = 232448


@dataclasses.dataclass(frozen=True)
class Conv0Params:
    """The stem in the kernel's float32 layouts."""
    wm: torch.Tensor      # (27, F) taps in HWIO order (dy, dx, channel)
    scale: torch.Tensor   # (F,)
    bias: torch.Tensor
    act: int
    whi: torch.Tensor     # (32, 8 * ceil(F / 8)) wm's TF32 parts, zero-
    wlo: torch.Tensor     # padded: wm ~= whi + wlo to 2^-22 of each weight


def _tf32(v: torch.Tensor) -> torch.Tensor:
    """float32 -> the nearest TF32 value, ties away from zero, by integer
    rounding of the bits (``tf32_mma.cuh``'s ``tf32_int``)."""
    bits = v.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    bits = torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits)
    return bits.to(torch.int32).view(torch.float32)


def tf32_parts(wm: torch.Tensor):
    """(27, F) float32 -> its TF32 parts (big, small), each padded with
    zeros to (32, 8 * ceil(F / 8)): ``split_t<true>`` done once."""
    f = wm.shape[1]
    pad = torch.zeros((32, -(-f // 8) * 8), dtype=torch.float32,
                      device=wm.device)
    pad[:wm.shape[0], :f] = wm
    hi = _tf32(pad)
    return hi, _tf32(pad - hi)


def conv0_params_from(w: torch.Tensor, scale: torch.Tensor,
                      bias: torch.Tensor, act: int) -> Conv0Params:
    """A 3x3 conv's OIHW weights (F, 3, 3, 3), scale and bias (F,) in the
    kernel's layouts."""
    w = w.float()
    if tuple(w.shape[1:]) != (3, 3, 3) or not 1 <= w.shape[0] <= MAX_F:
        raise ValueError(f"the stem kernel takes (F <= {MAX_F}, 3, 3, 3) "
                         f"weights, got {tuple(w.shape)}")
    wm = w.permute(2, 3, 1, 0).reshape(-1, w.shape[0]).contiguous()
    whi, wlo = tf32_parts(wm)
    return Conv0Params(wm=wm, scale=scale.float().contiguous(),
                       bias=bias.float().contiguous(), act=act, whi=whi,
                       wlo=wlo)


def conv0_params(ir: NetIR, params) -> Conv0Params:
    """Layer 0 of a port params dict (OIHW weights, usually the folded ones
    of ``graph.build.fold_input_transform``) in the kernel's layouts."""
    l0, p = ir.layers[0], params[0]
    if (l0.type != LayerType.CONV or l0.groups != 1 or l0.fs != 3
            or l0.stride != 2 or l0.pad != 1):
        raise ValueError("the stem kernel takes a dense 3x3/s2/pad-1 conv")
    return conv0_params_from(p["weights"], p["scale"], p["bias"],
                             l0.activation)


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of the kernel, as the wrapper passes it."""
    inst_f: int       # the compiled F, 0 for the generic instance
    inst_act: int     # the compiled activation, -1 for the generic one
    rows: int         # output rows a band
    cols: int         # output columns a band (a multiple of 8)
    ld: int           # bytes a staged input row (64 mod 128)
    aligned: bool     # rows by 16-byte cp.async, else by shifted words
    smem: int         # dynamic shared memory a CTA
    bands: int        # n x bands down x bands across
    grid: int         # persistent CTAs, each taking every grid-th band


def plan(n: int, h: int, w: int, f: int, act: int, out_bytes: int,
         sms: int, x_aligned: bool = True) -> Plan:
    """The launch ``conv0_cs`` makes for uint8 (n, h, w, 3) input (16-byte
    aligned if ``x_aligned``) and an (n, h/2, w/2, f) output of
    ``out_bytes`` an element on a card of ``sms`` SMs.

    A CTA stages a band's 2 rows + 1 input rows, bytes [6 c0 - 16,
    6 (c0 + cols)) of each (the first 16 hold column 2 c0 - 1, zero at the
    image's left edge), at a stride of 64 mod 128 bytes so that the two
    rows one tap-gather instruction reads fall in different banks, into
    one of its two buffers."""
    ho, wo = h // 2, w // 2
    inst = (f, act) if (f, act) in INSTANCES else (0, -1)
    cols = min(-(-max(wo, 1) // 8) * 8, MAX_COLS)
    ld = -(-(16 + 6 * cols - 64) // 128) * 128 + 64
    bands_w = -(-wo // cols)
    for rows in BAND_ROWS:
        bands = n * -(-ho // rows) * bands_w
        if bands >= 2 * sms:
            break
    out = THREADS // 32 * 16 * (inst[0] * out_bytes + 16) if inst[0] else 0
    return Plan(inst_f=inst[0], inst_act=inst[1], rows=rows, cols=cols,
                ld=ld, aligned=x_aligned and (3 * w) % 16 == 0,
                smem=2 * (2 * rows + 1) * ld + out, bands=bands,
                grid=min(bands, CTAS_PER_SM * sms))


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


def _conv0_cuda(x, wm, whi, wlo, scale, bias, act, out_dtype):
    if (x.device.type != "cuda" or x.dtype != torch.uint8 or x.dim() != 4
            or x.shape[-1] != 3 or not x.is_contiguous()):
        raise ValueError(f"x must be a contiguous uint8 (N, H, W, 3) CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    n, h, w, _ = x.shape
    f = wm.shape[1]
    if h % 2 or w % 2:
        raise ValueError(f"the stem needs even H and W, got {h}x{w}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    fp = whi.shape[1]
    for name, t, shape in (("whi", whi, (32, fp)), ("wlo", wlo, (32, fp)),
                           ("scale", scale, (f,)), ("bias", bias, (f,))):
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if fp != -(-f // 8) * 8 or f > MAX_F:
        raise ValueError(f"the stem kernel takes F <= {MAX_F} with TF32 "
                         f"parts of width 8 * ceil(F / 8), got F {f}, {fp}")
    y = torch.empty((n, h // 2, w // 2, f), dtype=out_dtype, device=x.device)
    if y.numel() == 0:
        return y
    pl = plan(n, h, w, f, act, y.element_size(),
              _build.sm_count(x.device), x.data_ptr() % 16 == 0)
    lib = build()
    err = lib.ffcnn_conv0(x.data_ptr(), y.data_ptr(),
                          int(out_dtype == torch.bfloat16), whi.data_ptr(),
                          wlo.data_ptr(), scale.data_ptr(), bias.data_ptr(),
                          n, h, w, f, act, pl.inst_f, pl.inst_act, pl.rows,
                          pl.cols, pl.ld, int(pl.aligned), pl.grid,
                          _build.stream_ptr())
    conv0_cs.launches += 1
    if err:
        raise RuntimeError("stem launch failed: "
                           + lib.ffcnn_conv0_error_string(err).decode())
    return y


def _conv0_cpu(x, wm, whi, wlo, scale, bias, act, out_dtype):
    return conv0_plain(x, Conv0Params(wm=wm, scale=scale, bias=bias,
                                      act=act, whi=whi, wlo=wlo), out_dtype)


def _conv0_fake(x, wm, whi, wlo, scale, bias, act, out_dtype):
    n, h, w, _ = x.shape
    return x.new_empty((n, h // 2, w // 2, wm.shape[1]), dtype=out_dtype)


CONV0_OP = _library.define(
    "conv0_cs(Tensor x, Tensor wm, Tensor whi, Tensor wlo, Tensor scale, "
    "Tensor bias, int act, ScalarType out_dtype) -> Tensor",
    cpu=_conv0_cpu, cuda=_conv0_cuda, fake=_conv0_fake)


def conv0_cs(x: torch.Tensor, cp: Conv0Params,
             out_dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """uint8 NHWC (N, H, W, 3), even H and W -> NHWC (N, H/2, W/2, F) in
    ``out_dtype`` (float32 or bfloat16), through ``ffcnn::conv0_cs``.

    CPU tensors take ``conv0_plain``; CUDA tensors launch the kernel."""
    return CONV0_OP(x, cp.wm, cp.whi, cp.wlo, cp.scale, cp.bias, cp.act,
                    out_dtype)


conv0_cs.launches = 0


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load the kernel's library."""
    lib = _build.load_library("conv0_fused")
    lib.ffcnn_conv0.argtypes = ([ctypes.c_void_p, ctypes.c_void_p,
                                 ctypes.c_int] + [ctypes.c_void_p] * 4
                                + [ctypes.c_int] * 12 + [ctypes.c_void_p])
    lib.ffcnn_conv0.restype = ctypes.c_int
    lib.ffcnn_conv0_error_string.argtypes = [ctypes.c_int]
    lib.ffcnn_conv0_error_string.restype = ctypes.c_char_p
    return lib
