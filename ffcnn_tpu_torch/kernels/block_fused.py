"""Fused inverted-residual blocks: pw-expand -> dw3x3 -> pw-project
(+ residual) in one launch per block, the expand tensor never in device
memory.  Holds the planner (pure IR code), the CUDA kernels' wrappers and
their plain PyTorch versions.

Two kernels, one template (``csrc/block_fused.cuh``):

* K1 (``fused_block``, ``csrc/block_fused.cu``) replaces
  ``ffcnn_tpu/kernels/block_fused.py::_make_kernel``, the stride-1 block
  launched once per block by ``_cs_block``.
* K3 (``fused_down_block``, ``csrc/block_down.cu``) replaces
  ``_make_down_kernel``, the stride-2 stage-transition block launched by
  ``_cs_down_block``: H and W halve, no residual.

The expand tensor is E/C times the block's input (3-6x on yolo-fastest-xl),
so materialising it dominates the block's device-memory traffic; the
kernels keep it in shared memory instead.  A CTA owns a tile of output
pixels of one image and walks E in chunks: it expands the tile's input halo
into shared memory, applies the depthwise 3x3 and adds the chunk's share of
the projection to float32 accumulators in registers.  Expand and project are
float32 FMAs on the CUDA cores; moving them onto the tensor cores is later
work.

The TPU gates ``BATCH_QUANTUM`` and ``runs_usable`` do not apply here: on
the card fast mode takes the kernels at every batch size.
"""

from __future__ import annotations

import ctypes
import functools
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ffcnn_tpu.darknet.ir import LayerType, NetIR
from ffcnn_tpu.tuning import get_flag

from ..ops.activations import activate
from . import _build

# Input-channel gate of the JAX package, kept so both packages plan the same
# runs.  It is a TPU crossover; the card's has not been measured.
MIN_CHANNELS = 24


@dataclasses.dataclass(frozen=True)
class FusedBlock:
    """One fusable [pw 1x1, dw 3x3 s1|s2, pw 1x1 (, dropout, shortcut)] run.
    ``start``: index of the expand conv; ``end``: last fused layer;
    ``residual``: add the block input; ``down``: the dw is stride 2."""
    start: int
    end: int
    residual: bool
    res_act: int
    down: bool = False


@dataclasses.dataclass(frozen=True)
class FusedRun:
    """Consecutive FusedBlocks sharing one layout round-trip."""
    start: int
    end: int
    blocks: Tuple[FusedBlock, ...]


def find_fused_blocks(ir: NetIR) -> Dict[int, FusedBlock]:
    """Locate fusable triples whose intermediate blobs have no consumers
    outside the block (``ffcnn_tpu/kernels/block_fused.py:74``)."""
    layers = ir.layers
    referenced = set()
    for l in layers:
        if l.type in (LayerType.ROUTE, LayerType.SHORTCUT):
            referenced.update(d + 1 for d in l.depends)

    out: Dict[int, FusedBlock] = {}
    li = 0
    while li + 2 < len(layers):
        a, b, c = layers[li], layers[li + 1], layers[li + 2]
        ok = (a.type == LayerType.CONV and a.fs == 1 and a.stride == 1
              and a.groups == 1
              and b.type == LayerType.CONV and b.fs == 3
              and b.stride in (1, 2)
              and b.groups == a.fn and b.fn == a.fn and b.pad == 1
              and c.type == LayerType.CONV and c.fs == 1 and c.stride == 1
              and c.groups == 1)
        if not ok:
            li += 1
            continue
        if b.stride == 2:
            if (ir.blobs[li].w % 2 == 0 and ir.blobs[li].h % 2 == 0
                    and not referenced & {li + 1, li + 2}):
                out[li] = FusedBlock(start=li, end=li + 2, residual=False,
                                     res_act=0, down=True)
                li += 3
            else:
                li += 1
            continue
        if (li + 4 < len(layers)
                and layers[li + 3].type == LayerType.DROPOUT
                and layers[li + 4].type == LayerType.SHORTCUT
                and layers[li + 4].depends[0] + 1 == li
                and ir.blobs[li].c == c.fn
                and not referenced & {li + 1, li + 2, li + 3, li + 4}):
            out[li] = FusedBlock(start=li, end=li + 4, residual=True,
                                 res_act=layers[li + 4].activation)
            li += 5
            continue
        if not referenced & {li + 1, li + 2}:
            out[li] = FusedBlock(start=li, end=li + 2, residual=False,
                                 res_act=0)
            li += 3
            continue
        li += 1
    return out


def plan_runs(ir: NetIR, min_channels: Optional[int] = None,
              allow_down: Optional[bool] = None) -> List[FusedRun]:
    """Group the blocks whose input has >= ``min_channels`` channels into
    maximal runs.  Two adjacent blocks chain when the blob between them is
    read only inside the second block (its own residual).  Stride-2 blocks
    join only with ``allow_down``, so that runs span whole backbone regions.

    Unset arguments resolve as the JAX package's ``plan_runs`` does:
    ``FFCNN_FUSED_MINC`` (default ``MIN_CHANNELS``) and ``FFCNN_FUSED_DOWN``
    (default off), through ``ffcnn_tpu.tuning.get_flag``."""
    if min_channels is None:
        min_channels = int(get_flag("FFCNN_FUSED_MINC", str(MIN_CHANNELS)))
    if allow_down is None:
        allow_down = get_flag("FFCNN_FUSED_DOWN", "0") == "1"
    blocks = find_fused_blocks(ir)
    eligible = [b for _, b in sorted(blocks.items())
                if ir.blobs[b.start].c >= min_channels
                and (allow_down or not b.down)]
    ref_layers: Dict[int, List[int]] = {}
    for li, l in enumerate(ir.layers):
        if l.type in (LayerType.ROUTE, LayerType.SHORTCUT):
            for d in l.depends:
                ref_layers.setdefault(d + 1, []).append(li)

    def chainable(prev: FusedBlock, nxt: FusedBlock) -> bool:
        if prev.end + 1 != nxt.start:
            return False
        return all(nxt.start <= li <= nxt.end
                   for li in ref_layers.get(nxt.start, []))

    runs: List[FusedRun] = []
    cur: List[FusedBlock] = []
    for b in eligible:
        if cur and chainable(cur[-1], b):
            cur.append(b)
        else:
            if cur:
                runs.append(FusedRun(cur[0].start, cur[-1].end, tuple(cur)))
            cur = [b]
    if cur:
        runs.append(FusedRun(cur[0].start, cur[-1].end, tuple(cur)))
    return runs


@dataclasses.dataclass(frozen=True)
class BlockParams:
    """One block's parameters in the kernel's float32 layouts."""
    w1: torch.Tensor      # (C, E)  expand
    s1: torch.Tensor      # (E,)
    b1: torch.Tensor
    kdw: torch.Tensor     # (E, 9)  depthwise taps, row-major (dy, dx)
    s2: torch.Tensor
    b2: torch.Tensor
    w2: torch.Tensor      # (E, P)  project
    s3: torch.Tensor      # (P,)
    b3: torch.Tensor
    acts: Tuple[int, int, int]
    residual: bool
    res_act: int


def block_params(ir: NetIR, params, b: FusedBlock) -> BlockParams:
    """Gather block ``b``'s three convs from a port params dict (OIHW
    weights, ``graph.build.params_from_numpy``)."""
    def get(li):
        p = params[li]
        return (p["weights"].float(), p["scale"].float().contiguous(),
                p["bias"].float().contiguous())
    w1, s1, b1 = get(b.start)
    kdw, s2, b2 = get(b.start + 1)
    w2, s3, b3 = get(b.start + 2)
    e, c = w1.shape[:2]
    return BlockParams(
        w1=w1.reshape(e, c).t().contiguous(), s1=s1, b1=b1,
        kdw=kdw.reshape(e, 9).contiguous(), s2=s2, b2=b2,
        w2=w2.reshape(w2.shape[0], e).t().contiguous(), s3=s3, b3=b3,
        acts=tuple(ir.layers[b.start + i].activation for i in range(3)),
        residual=b.residual, res_act=b.res_act)


def _block_f32(x: torch.Tensor, bp: BlockParams, stride: int
               ) -> torch.Tensor:
    """The block in plain PyTorch, float32 inside, NHWC in and out."""
    xf = x.float()
    n, h, w, _ = x.shape
    ho, wo = h // stride, w // stride
    a = activate(torch.matmul(xf, bp.w1) * bp.s1 + bp.b1, bp.acts[0])
    # the dw zero padding applies to the expand OUTPUT (pw of a zero row is
    # act(b1), not 0)
    a = torch.nn.functional.pad(a, (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((n, ho, wo, a.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for dy in range(3):
        for dx in range(3):
            # output row r reads padded rows stride*r + dy, i.e. input rows
            # stride*r - 1 .. stride*r + 1 (likewise columns)
            acc = acc + (a[:, dy:dy + stride * ho:stride,
                           dx:dx + stride * wo:stride]
                         * bp.kdw[:, dy * 3 + dx])
    h2 = activate(acc * bp.s2 + bp.b2, bp.acts[1])
    y = activate(torch.matmul(h2, bp.w2) * bp.s3 + bp.b3, bp.acts[2])
    if bp.residual:
        y = activate(y + xf, bp.res_act)
    return y.to(x.dtype)


def block_plain(x: torch.Tensor, bp: BlockParams) -> torch.Tensor:
    """The stride-1 block in plain PyTorch, float32 inside, NHWC in and
    out: what ``_make_kernel`` computes."""
    return _block_f32(x, bp, 1)


def block_down_plain(x: torch.Tensor, bp: BlockParams) -> torch.Tensor:
    """The stride-2 block in plain PyTorch, float32 inside, NHWC (N, H, W,
    C) -> (N, H/2, W/2, P) for even H and W: what ``_make_down_kernel``
    computes (no residual)."""
    if bp.residual:
        raise ValueError("a stride-2 block has no residual")
    return _block_f32(x, bp, 2)


# Output tiles the kernels accept (csrc/block_fused.cuh kMaxPix,
# max_halo<S>): at most 64 output pixels, and an input halo of at most 104
# pixels at stride 1, 160 at stride 2.
_TILE_MAX_PIX = 64
_TILE_MAX_HALO = {1: 104, 2: 160}


@functools.cache
def pick_tile(h: int, w: int, stride: int = 1) -> Tuple[int, int]:
    """The (TH, TW) tile of an (h, w) OUTPUT map that expands the fewest
    halo pixels over the map (ties go to the larger tile).  A tile's halo
    is (stride*TH + 3 - stride) x (stride*TW + 3 - stride) input pixels.
    Cached: every launch asks."""
    best = None
    for th in range(1, min(h, _TILE_MAX_PIX) + 1):
        for tw in range(1, min(w, _TILE_MAX_PIX // th) + 1):
            halo = ((stride * th + 3 - stride)
                    * (stride * tw + 3 - stride))
            if halo > _TILE_MAX_HALO[stride]:
                continue
            cost = -(-h // th) * -(-w // tw) * halo
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    return best[1]


def _check(x: torch.Tensor, bp: BlockParams) -> None:
    """Raise on what the kernels do not take."""
    c = x.shape[-1]
    e, p = bp.w1.shape[1], bp.w2.shape[1]
    if x.device.type != "cuda" or x.dim() != 4 or not x.is_contiguous() \
            or x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"x must be a contiguous NHWC float32/bfloat16 CUDA "
                         f"tensor, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")
    shapes = {"w1": (c, e), "s1": (e,), "b1": (e,), "kdw": (e, 9),
              "s2": (e,), "b2": (e,), "w2": (e, p), "s3": (p,), "b3": (p,)}
    for name, shape in shapes.items():
        t = getattr(bp, name)
        if (t.device != x.device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{x.device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")


def _params_ptrs(bp: BlockParams):
    return (bp.w1.data_ptr(), bp.s1.data_ptr(), bp.b1.data_ptr(),
            bp.kdw.data_ptr(), bp.s2.data_ptr(), bp.b2.data_ptr(),
            bp.w2.data_ptr(), bp.s3.data_ptr(), bp.b3.data_ptr())


def fused_block(x: torch.Tensor, bp: BlockParams) -> torch.Tensor:
    """One stride-1 block (K1), NHWC (N, H, W, C) -> (N, H, W, P) in x's
    dtype.

    CPU tensors take ``block_plain``; CUDA tensors launch the kernel."""
    if x.device.type == "cpu":
        return block_plain(x, bp)
    _check(x, bp)
    n, h, w, c = x.shape
    e, p = bp.w1.shape[1], bp.w2.shape[1]
    if bp.residual and p != c:
        raise ValueError(f"residual block needs P == C, got {p} != {c}")
    th, tw = pick_tile(h, w)
    y = torch.empty((n, h, w, p), dtype=x.dtype, device=x.device)
    lib = build()
    err = lib.ffcnn_block_s1(
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
        *_params_ptrs(bp), n, h, w, c, e, p, *bp.acts, int(bp.residual),
        bp.res_act, th, tw, _build.stream_ptr())
    fused_block.launches += 1
    if err:
        raise RuntimeError("fused block launch failed: "
                           + lib.ffcnn_block_error_string(err).decode())
    return y


fused_block.launches = 0


def fused_down_block(x: torch.Tensor, bp: BlockParams) -> torch.Tensor:
    """One stride-2 block (K3), NHWC (N, H, W, C) -> (N, H/2, W/2, P) in
    x's dtype; H and W must be even.

    CPU tensors take ``block_down_plain``; CUDA tensors launch the
    kernel."""
    if x.device.type == "cpu":
        return block_down_plain(x, bp)
    _check(x, bp)
    n, h, w, c = x.shape
    e, p = bp.w1.shape[1], bp.w2.shape[1]
    if h % 2 or w % 2 or bp.residual:
        raise ValueError(f"a stride-2 block needs even H and W and no "
                         f"residual, got {h}x{w}, residual={bp.residual}")
    th, tw = pick_tile(h // 2, w // 2, 2)
    y = torch.empty((n, h // 2, w // 2, p), dtype=x.dtype, device=x.device)
    lib = build_down()
    err = lib.ffcnn_block_s2(
        x.data_ptr(), y.data_ptr(), int(x.dtype == torch.bfloat16),
        *_params_ptrs(bp), n, h, w, c, e, p, *bp.acts, th, tw,
        _build.stream_ptr())
    fused_down_block.launches += 1
    if err:
        raise RuntimeError("fused stride-2 block launch failed: "
                           + lib.ffcnn_down_error_string(err).decode())
    return y


fused_down_block.launches = 0

_PTR, _INT = ctypes.c_void_p, ctypes.c_int


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load K1's library."""
    lib = _build.load_library("block_fused")
    lib.ffcnn_block_s1.argtypes = ([_PTR, _PTR, _INT] + [_PTR] * 9
                                   + [_INT] * 13 + [_PTR])
    lib.ffcnn_block_s1.restype = _INT
    lib.ffcnn_block_error_string.argtypes = [_INT]
    lib.ffcnn_block_error_string.restype = ctypes.c_char_p
    return lib


@functools.cache
def build_down() -> ctypes.CDLL:
    """Build (if needed) and load K3's library."""
    lib = _build.load_library("block_down")
    lib.ffcnn_block_s2.argtypes = ([_PTR, _PTR, _INT] + [_PTR] * 9
                                   + [_INT] * 11 + [_PTR])
    lib.ffcnn_block_s2.restype = _INT
    lib.ffcnn_down_error_string.argtypes = [_INT]
    lib.ffcnn_down_error_string.restype = ctypes.c_char_p
    return lib


def apply_run(x: torch.Tensor, run: FusedRun,
              bps: List[BlockParams]) -> torch.Tensor:
    """Run a chain of fused blocks on an NHWC blob: one launch per block
    (K1 for stride 1, K3 for stride 2), each block boundary stored in x's
    dtype (the JAX package's default boundary storage).  ``bps``: the run's
    ``block_params``, one per block, prepared once (the JAX
    ``apply_run(x, ir, params, run)`` gathers them inside its trace;
    eagerly that would cost copies every forward)."""
    if len(bps) != len(run.blocks):
        raise ValueError(f"{len(bps)} block params for {len(run.blocks)} "
                         f"blocks")
    for b, bp in zip(run.blocks, bps):
        x = fused_down_block(x, bp) if b.down else fused_block(x, bp)
    return x
