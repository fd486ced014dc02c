"""Fused inverted-residual blocks: pw-expand -> dw3x3 -> pw-project
(+ residual), the expand tensor never in device memory.  Holds the planner
(pure IR code), the CUDA kernels' wrappers and their plain PyTorch versions.

Four kernels, all on one tensor-core product code (``csrc/tf32_mma.cuh``):
K1 and K3 are one template (``csrc/block_mma.cuh``), K4 and K5 chain blocks
in ``csrc/block_chain.cuh``:

* K1 (``fused_block``, ``csrc/block_fused.cu``) replaces
  ``ffcnn_tpu/kernels/block_fused.py::_make_kernel``, the stride-1 block
  launched once per block by ``_cs_block``.
* K3 (``fused_down_block``, ``csrc/block_down.cu``) replaces
  ``_make_down_kernel``, the stride-2 stage-transition block launched by
  ``_cs_down_block``: H and W halve, no residual.
* K4 (``fused_cascade``, ``csrc/block_cascade.cu``) replaces
  ``_make_cascade_kernel`` (``_cs_cascade``): a group of consecutive
  stride-1 blocks in one launch (``FFCNN_FUSED_CASCADE=k``, groups from
  ``cascade_groups``), the boundaries inside the group kept on chip in
  float32.
* K5 (``fused_mega``, ``csrc/block_mega.cu``) replaces ``_make_mega_kernel``
  (``_apply_run_mega``): a whole run of stride-1 blocks in one launch
  (``FFCNN_FUSED_MEGA``, where ``mega_fits``), each image's map resident on
  chip in float32, split over a cluster of two CTAs while the batch leaves
  SMs idle (``mega_cluster``).

The expand tensor is E/C times the block's input (3-6x on yolo-fastest-xl),
so materialising it dominates the block's device-memory traffic; the
kernels keep it in shared memory instead.  A CTA owns a tile of output
pixels of one image and walks E in chunks of 32: it expands the tile's
input halo into shared memory, applies the depthwise 3x3 and adds the
chunk's share of the projection to float32 accumulators (K1 and K3 keep
them in registers, K4 and K5 in the window's float32 output map).  The
expand and the project run on the tensor cores in 3xTF32 (each float32
operand split into a TF32 big and small part, the small*small product
dropped: about 2^-21 of each product, within the float32 tolerance one TF32
pass misses), the depthwise taps in float32 on the CUDA cores, the next
chunk's weights arrive by ``cp.async`` while this one computes, and the
activations of the combinations that ``plan_runs`` yields on
``models/*.cfg`` are fixed at compile time.

In an int8 plan (``quant``, ``run_blocks``) K1, K3 and K4 take int8 codes
in and out where a boundary between launches is int8: the input is
dequantized on load (code * ``in_scale``) and the output requantized at
the store (clip(rint(y * 1/``out_scale``), -127, 127)), as the TPU
kernels' ``in_scale``/``out_scale`` do; the math inside stays float32.

Departures from the JAX package, neither of which changes a plan:

* Its TPU gates ``BATCH_QUANTUM``, ``runs_usable`` and the mega route's
  ``n % MEGA_NB == 0`` do not apply: on the card fast mode takes the
  kernels at every batch size.
* ``_pick_rows_cascade`` falls back to per-block launches where a group's
  rows do not fit VMEM or divide the map; here every cascade group runs as
  one K4 launch, because the tile search (``pick_cascade_tile``) bounds the
  shared memory instead, with tiles cut at the map's edge.  So a group the
  JAX package splits at such a geometry keeps its boundaries in float32
  here.
"""

from __future__ import annotations

import ctypes
import functools
import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from ..darknet.ir import LayerType, NetIR
from ..ops.activations import activate
from ..tuning import get_flag
from . import _build, _library

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
    (default off), through ``tuning.get_flag``."""
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


def _dequant(x: torch.Tensor, in_scale: Optional[float]) -> torch.Tensor:
    """x as float32; int8 codes times ``in_scale`` (rounded to float32, as
    the TPU kernels' ``load`` multiplies by it)."""
    xf = x.float()
    return xf if in_scale is None else xf * in_scale


def _finish(y: torch.Tensor, out_dtype, out_scale: Optional[float]):
    """y in ``out_dtype``, or with ``out_scale`` int8 codes clip(round(y *
    inv), -127, 127) with inv = float32(1 / out_scale) (``_quantize(out,
    1.0 / out_scale)`` of the TPU kernels)."""
    if out_scale is None:
        return y.to(out_dtype)
    return torch.clamp(torch.round(y * (1.0 / out_scale)), -127,
                       127).to(torch.int8)


def _block_f32(x: torch.Tensor, bp: BlockParams, stride: int,
               matmul=torch.matmul, in_scale: Optional[float] = None
               ) -> torch.Tensor:
    """The block in plain PyTorch, float32 inside and out, NHWC; ``matmul``
    computes the two pointwise products; int8 ``x`` is dequantized by
    ``in_scale`` (the residual adds the dequantized input)."""
    xf = _dequant(x, in_scale)
    n, h, w, _ = x.shape
    ho, wo = h // stride, w // stride
    a = activate(matmul(xf, bp.w1) * bp.s1 + bp.b1, bp.acts[0])
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
    y = activate(matmul(h2, bp.w2) * bp.s3 + bp.b3, bp.acts[2])
    if bp.residual:
        y = activate(y + xf, bp.res_act)
    return y


def block_plain(x: torch.Tensor, bp: BlockParams,
                out_dtype: Optional[torch.dtype] = None,
                in_scale: Optional[float] = None,
                out_scale: Optional[float] = None) -> torch.Tensor:
    """The stride-1 block in plain PyTorch, float32 inside, NHWC in and
    out (in ``out_dtype``, default x's): what ``_make_kernel`` computes.
    int8 boundaries: ``in_scale`` dequantizes int8 ``x``, ``out_scale``
    requantizes the output to int8 codes."""
    return _finish(_block_f32(x, bp, 1, in_scale=in_scale),
                   out_dtype or x.dtype, out_scale)


def block_down_plain(x: torch.Tensor, bp: BlockParams,
                     out_dtype: Optional[torch.dtype] = None,
                     in_scale: Optional[float] = None,
                     out_scale: Optional[float] = None) -> torch.Tensor:
    """The stride-2 block in plain PyTorch, float32 inside, NHWC (N, H, W,
    C) -> (N, H/2, W/2, P) for even H and W, in ``out_dtype`` (default
    x's): what ``_make_down_kernel`` computes (no residual); int8
    boundaries as ``block_plain``'s."""
    if bp.residual:
        raise ValueError("a stride-2 block has no residual")
    return _finish(_block_f32(x, bp, 2, in_scale=in_scale),
                   out_dtype or x.dtype, out_scale)


def chain_plain(x: torch.Tensor, bps: List[BlockParams],
                out_dtype: Optional[torch.dtype] = None,
                matmul=torch.matmul, in_scale: Optional[float] = None,
                out_scale: Optional[float] = None) -> torch.Tensor:
    """Stride-1 blocks chained in plain PyTorch, NHWC: float32 between the
    blocks, never rounded, and one cast at the end (to ``out_dtype``,
    default x's).  What ``_make_cascade_kernel`` computes for a group and
    ``_make_mega_kernel`` for a run: the plain version of K4 and of K5.
    ``matmul`` computes the pointwise products (as in ``_block_f32``);
    int8 boundaries at the chain's ends as ``block_plain``'s."""
    y = _dequant(x, in_scale)
    for bp in bps:
        y = _block_f32(y, bp, 1, matmul)
    return _finish(y, out_dtype or x.dtype, out_scale)


# ----------------------------------------------------------------- routing
def cascade_groups(run: FusedRun, k: int) -> List[List[FusedBlock]]:
    """The run's blocks in launch groups, as ``run_blocks_cs`` groups them
    for ``FFCNN_FUSED_CASCADE=k``: a stride-1 block joins the current group
    unless that group is full (k blocks) or ends in a stride-2 block; a
    stride-2 block is a group of its own.  ``k`` < 2: one block a group."""
    groups: List[List[FusedBlock]] = []
    for b in run.blocks:
        if (k > 1 and not b.down and groups and len(groups[-1]) < k
                and not groups[-1][-1].down):
            groups[-1].append(b)
        else:
            groups.append([b])
    return groups


# The JAX mega route's VMEM gate (``_mega_fits``), kept so both packages
# route the same runs: images per chunk and its float32 budget.
MEGA_NB = 128
_MEGA_VMEM_BUDGET = 72 << 20


def mega_fits(ir: NetIR, run: FusedRun) -> bool:
    """``ffcnn_tpu/kernels/block_fused.py::_mega_fits`` as IR math: two
    E-wide float32 stages of a 128-image chunk of the run's map, plus its
    input and output, within the TPU budget."""
    hh, ww = ir.blobs[run.start].h, ir.blobs[run.start].w
    emax = max(ir.layers[b.start].fn for b in run.blocks)
    s = ww * MEGA_NB
    need = 2 * hh * emax * (s + 2 * MEGA_NB) * 4
    need += 2 * hh * max(ir.blobs[run.blocks[0].start].c,
                         ir.blobs[run.end + 1].c) * s * 4
    return need <= _MEGA_VMEM_BUDGET


# Output tiles K1 and K3 accept (csrc/block_fused.cuh kMaxPix,
# max_halo<S>): at most 64 output pixels, and an input halo of at most 104
# pixels at stride 1, 160 at stride 2.
_TILE_MAX_PIX = 64
_TILE_MAX_HALO = {1: 104, 2: 160}
# A CTA's shared memory on sm_90 (csrc/block_fused.cuh kMaxSmem), and the
# blocks a chained launch takes (csrc/block_chain.cuh kMaxChain).
MAX_SMEM = 232448
MAX_CHAIN = 16


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


# A chain's widths, (c, e, p) per block: what the chained kernels' shared
# memory and the tile searches depend on.
Widths = Tuple[Tuple[int, int, int], ...]


def _widths(bps: List[BlockParams]) -> Widths:
    return tuple((bp.w1.shape[0], bp.w1.shape[1], bp.w2.shape[1])
                 for bp in bps)


# The chained kernels' shared-memory layout (csrc/block_chain.cuh, on the
# constants of csrc/tf32_mma.cuh): 32-channel chunks, the expanded halo at
# a row stride of 40 floats, the depthwise output at ld_a(32), and each
# chunk buffer's vectors s1 b1 s2 b2 kdw in 13 x 32 floats.
_CHUNK = 32


def _ld_a(k: int) -> int:
    return (k + 3) // 8 * 8 + 4


def _ld_b(n: int) -> int:
    return (n + 7) // 16 * 16 + 8


def _pad8(c: int) -> int:
    return -(-c // 8) * 8


def _round16(v: int) -> int:
    return -(-v // 16) * 16


def _map_ld(c: int) -> int:
    """Row stride of a map of c channels (block_chain.cuh ``map_ld``)."""
    return _ld_a(_pad8(c))


def _chain_floats(widths: Widths, oh: int, ow: int) -> int:
    """The layout's terms besides the maps, for a largest window of oh x ow
    output pixels: the expanded halo, the depthwise output, the pixel table
    and the two chunk buffers (``window_smem`` and ``chunk_floats`` in
    block_chain.cuh)."""
    npix16 = _round16(oh * ow)
    buf = max(_pad8(c) * _ld_b(_CHUNK) + _CHUNK * _ld_b(_pad8(p))
              + 13 * _CHUNK for c, _, p in widths)
    return ((oh + 2) * (ow + 2) * (_CHUNK + 8) + npix16 * _ld_a(_CHUNK)
            + npix16 + 2 * buf)


def cascade_smem(widths: Widths, th: int, tw: int) -> int:
    """Bytes of shared memory K4 needs at output tile (th, tw), as
    ``cascade_smem`` in ``csrc/block_chain.cuh`` lays it out: block
    j reads a map of (th + 2(k-j)) x (tw + 2(k-j)) pixels from one of two
    float32 maps and writes one pixel ring smaller into the other."""
    k = len(widths)
    chans = [widths[0][0]] + [p for _, _, p in widths]
    maps = [0, 0]
    for j in range(k + 1):
        r = k - j
        maps[j % 2] = max(maps[j % 2],
                          (th + 2 * r) * (tw + 2 * r) * _map_ld(chans[j]))
    return 4 * (sum(maps) + _chain_floats(widths, th + 2 * k - 2,
                                          tw + 2 * k - 2))


def mega_cluster(h: int, n: int, sms: int) -> int:
    """CTAs K5 gives each of n images of h rows on a card of ``sms`` SMs,
    1 or 2.  A CTA of K5 has an SM to itself, so while 2n <= sms a cluster
    of two puts SMs to work that one CTA an image leaves idle, for half the
    work a CTA; past that it takes more waves for the same work and adds a
    boundary row of expand to each half, whole 16-row slabs and a cluster
    barrier a block.  ``chip_smoke.py`` phase 6 times both sizes on xl's
    run 84-108 at batch 64, 66, 67, 128 and 256 (PERF.md §6)."""
    return 2 if h >= 2 and 2 * n <= sms else 1


def mega_smem(widths: Widths, h: int, w: int, th: int, tw: int,
              cluster: int = 1) -> int:
    """Bytes of shared memory a CTA of K5 needs for an (h, w) map at output
    tile (th, tw) with ``cluster`` CTAs an image, as ``mega_smem`` in
    ``csrc/block_chain.cuh`` lays it out: its ceil(h / cluster) rows with a
    halo row above and below and a one-pixel border at the sides, twice, at
    the chain's widest stride, and one tile's buffers."""
    rows = -(-h // cluster)
    ld = max(max(_map_ld(c) for c, _, _ in widths), _map_ld(widths[-1][2]))
    return 4 * (2 * (rows + 2) * (w + 2) * ld + _chain_floats(widths, th, tw))


def _cut_tiles(h: int, w: int, th: int, tw: int):
    """(rows, cols, count) of the tiles of an (h, w) map at (th, tw), cut
    at the map's bottom and right edges."""
    for rows, nr in ((th, h // th), (h % th, int(h % th > 0))):
        for cols, nc in ((tw, w // tw), (w % tw, int(w % tw > 0))):
            if nr and nc:
                yield rows, cols, nr * nc


# A depthwise tap on the CUDA cores against one multiply-add of a pointwise
# product on the tensor cores (3xTF32, with its splits and fragment loads):
# about twice the clock cycles, by the phase shares that a clock-counter
# build of K4 measured on xl's seven groups (PERF.md §6).
_TAP_WEIGHT = 2


def _cascade_cost(widths: Widths, th: int, tw: int) -> int:
    """The work of one (th, tw) tile of K4 in tensor-core multiply-adds,
    E in whole chunks of 32: each block expands its input map and projects
    its output map on the tensor cores, in whole 16-row slabs and n8 tiles
    (C and P padded to 8), and runs the 9 taps of each output pixel and
    channel on the CUDA cores (``_TAP_WEIGHT`` each)."""
    k, cost = len(widths), 0
    for j, (c, e, p) in enumerate(widths):
        r = k - j
        nin = (th + 2 * r) * (tw + 2 * r)
        nout = (th + 2 * r - 2) * (tw + 2 * r - 2)
        cost += -(-e // 32) * 32 * (_round16(nin) * _pad8(c)
                                    + _round16(nout) * _pad8(p)
                                    + _TAP_WEIGHT * 9 * nout)
    return cost


# K4's CTA is 512 threads at up to 128 registers each, the whole register
# file of an SM, so one CTA has an SM and the tile search needs no occupancy
# model: at these tiles xl's seven groups ran faster than with 256-thread
# CTAs, two an SM at half the shared memory (PERF.md §6).
@functools.cache
def pick_cascade_tile(h: int, w: int, widths: Widths
                      ) -> Optional[Tuple[int, int]]:
    """K4's (TH, TW) output tile for a group on an (h, w) map: the least
    work over the map, halo recompute included (``_cascade_cost``), within
    a CTA's shared memory; ties go to the larger tile.  None if no tile
    fits.  Cached: every launch asks."""
    best = None
    for th in range(1, h + 1):
        for tw in range(1, w + 1):
            if cascade_smem(widths, th, tw) > MAX_SMEM:
                break                   # grows with tw
            cost = sum(n * _cascade_cost(widths, r, c)
                       for r, c, n in _cut_tiles(h, w, th, tw))
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    return None if best is None else best[1]


@functools.cache
def pick_mega_tile(h: int, w: int, widths: Widths, cluster: int = 1
                   ) -> Optional[Tuple[int, int]]:
    """K5's (TH, TW) output tile, walked over the ceil(h / cluster) rows of
    the (h, w) map that a CTA keeps resident: the fewest halo pixels
    expanded over those rows within a CTA's shared memory (all of them
    where they fit); ties go to the larger tile.  None if the two maps
    alone do not fit.  Cached: every launch asks."""
    rows, best = -(-h // cluster), None
    for th in range(1, rows + 1):
        for tw in range(1, w + 1):
            if mega_smem(widths, h, w, th, tw, cluster) > MAX_SMEM:
                break
            cost = sum(n * (r + 2) * (c + 2)
                       for r, c, n in _cut_tiles(rows, w, th, tw))
            key = (cost, -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    return None if best is None else best[1]


def check_chain_fits(h: int, w: int, bps: List[BlockParams],
                     mega: bool = False, cluster: int = 1) -> Tuple[int, int]:
    """The tile K4 (or, with ``mega``, K5 at ``cluster`` CTAs an image)
    takes for the chain on an (h, w) map; raise if the chain cannot run on
    the card (``Net`` asks for every group and mega run when it is built on
    the card)."""
    widths = _widths(bps)
    if len(bps) > MAX_CHAIN:
        raise ValueError(f"a chain of {len(bps)} blocks; the kernels take "
                         f"at most {MAX_CHAIN}")
    tile = (pick_mega_tile(h, w, widths, cluster) if mega
            else pick_cascade_tile(h, w, widths))
    if tile is None:
        need = mega_smem(widths, h, w, 1, 1, cluster) if mega else \
            cascade_smem(widths, 1, 1)
        raise ValueError(f"the {'mega' if mega else 'cascade'} chain "
                         f"{widths} on a {h}x{w} map needs {need} bytes of "
                         f"shared memory at its smallest tile, more than "
                         f"the {MAX_SMEM} a CTA has on sm_90")
    return tile


# ---------------------------------------------------------------- wrappers
_DTYPES = (torch.float32, torch.bfloat16)
# the kernels' storage kinds: float32, bfloat16, int8 codes
_KIND = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}


def _check_x(x: torch.Tensor, in_scale: Optional[float] = None) -> None:
    want, kind = ((torch.int8,), "int8") if in_scale is not None else \
        (_DTYPES, "float32/bfloat16")
    if x.device.type != "cuda" or x.dim() != 4 or not x.is_contiguous() \
            or x.dtype not in want:
        raise ValueError(f"x must be a contiguous NHWC {kind} CUDA tensor, "
                         f"got {x.dtype} {tuple(x.shape)} on {x.device}")


def _check_params(bp: BlockParams, c: int, device) -> None:
    e, p = bp.w1.shape[1], bp.w2.shape[1]
    shapes = {"w1": (c, e), "s1": (e,), "b1": (e,), "kdw": (e, 9),
              "s2": (e,), "b2": (e,), "w2": (e, p), "s3": (p,), "b3": (p,)}
    for name, shape in shapes.items():
        t = getattr(bp, name)
        if (t.device != device or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous float32 {shape} on "
                             f"{device}, got {t.dtype} {tuple(t.shape)} "
                             f"on {t.device}")
    if bp.residual and p != c:
        raise ValueError(f"residual block needs P == C, got {p} != {c}")


def _check(x: torch.Tensor, bps: List[BlockParams], out_dtype,
           in_scale: Optional[float] = None) -> None:
    """Raise on what the kernels do not take: a chain's widths must link
    up, each block's params must lie beside x; int8 x only with an
    ``in_scale``."""
    _check_x(x, in_scale)
    if out_dtype not in _DTYPES:
        raise ValueError(f"out_dtype must be float32 or bfloat16, got "
                         f"{out_dtype}")
    c = x.shape[-1]
    for bp in bps:
        _check_params(bp, c, x.device)
        c = bp.w2.shape[1]


def _params_ptrs(bp: BlockParams):
    return (bp.w1.data_ptr(), bp.s1.data_ptr(), bp.b1.data_ptr(),
            bp.kdw.data_ptr(), bp.s2.data_ptr(), bp.b2.data_ptr(),
            bp.w2.data_ptr(), bp.s3.data_ptr(), bp.b3.data_ptr())


def _is_bf16(dtype) -> int:
    return int(dtype == torch.bfloat16)


def _boundaries(x, out_dtype, in_scale, out_scale):
    """(x's kind, y's dtype and kind, in_scale, out_inv) for a launch: int8
    codes at a scale where one is given (out_inv = 1 / out_scale, the
    kernel rounds it to float32)."""
    od = torch.int8 if out_scale is not None else out_dtype
    return (_KIND[x.dtype], od, _KIND[od],
            1.0 if in_scale is None else in_scale,
            1.0 if out_scale is None else 1.0 / out_scale)


# ----------------------------------------------------- the ffcnn:: ops
# A block's params cross an op's schema as a list of its nine tensors and
# its activations as ints; the implementations rebuild the BlockParams.
_PARAM_NAMES = ("w1", "s1", "b1", "kdw", "s2", "b2", "w2", "s3", "b3")


def _tensors(bps: List[BlockParams]) -> List[torch.Tensor]:
    return [getattr(bp, nm) for bp in bps for nm in _PARAM_NAMES]


def _meta(bps: List[BlockParams]) -> List[int]:
    """5 ints a block: act1 act2 act3 residual res_act."""
    return [v for bp in bps for v in (*bp.acts, int(bp.residual),
                                      bp.res_act)]


def _rebuild(ts: List[torch.Tensor], meta: List[int]) -> List[BlockParams]:
    return [BlockParams(**dict(zip(_PARAM_NAMES, ts[9 * i:9 * i + 9])),
                        acts=tuple(meta[5 * i:5 * i + 3]),
                        residual=bool(meta[5 * i + 3]),
                        res_act=meta[5 * i + 4])
            for i in range(len(meta) // 5)]


def _out_dtype(out_dtype, out_scale):
    return torch.int8 if out_scale is not None else out_dtype


def _fake(x, params, meta, out_dtype=None, in_scale=None, out_scale=None,
          stride=1):
    """Any block op's output: (N, H/stride, W/stride, P of the last
    block), contiguous."""
    n, h, w, _ = x.shape
    return x.new_empty((n, h // stride, w // stride, params[-3].shape[1]),
                       dtype=_out_dtype(out_dtype or x.dtype, out_scale))


def _block_cpu(x, params, meta, out_dtype, in_scale, out_scale):
    return block_plain(x, _rebuild(params, meta)[0], out_dtype, in_scale,
                       out_scale)


def _block_cuda(x, params, meta, out_dtype, in_scale, out_scale):
    bp = _rebuild(params, meta)[0]
    _check(x, [bp], out_dtype, in_scale)
    n, h, w, c = x.shape
    e, p = bp.w1.shape[1], bp.w2.shape[1]
    th, tw = pick_tile(h, w)
    ik, od, ok, si, so = _boundaries(x, out_dtype, in_scale, out_scale)
    y = torch.empty((n, h, w, p), dtype=od, device=x.device)
    lib = build()
    err = lib.ffcnn_block_s1(
        x.data_ptr(), y.data_ptr(), ik, ok,
        *_params_ptrs(bp), n, h, w, c, e, p, *bp.acts, int(bp.residual),
        bp.res_act, th, tw, si, so, _build.stream_ptr())
    fused_block.launches += 1
    if err:
        raise RuntimeError("fused block launch failed: "
                           + lib.ffcnn_block_error_string(err).decode())
    return y


_BLOCK_SCHEMA = ("(Tensor x, Tensor[] params, int[] meta, ScalarType "
                 "out_dtype, float? in_scale, float? out_scale) -> Tensor")
FUSED_BLOCK_OP = _library.define("fused_block" + _BLOCK_SCHEMA,
                                 cpu=_block_cpu, cuda=_block_cuda, fake=_fake)


def fused_block(x: torch.Tensor, bp: BlockParams,
                out_dtype: Optional[torch.dtype] = None,
                in_scale: Optional[float] = None,
                out_scale: Optional[float] = None) -> torch.Tensor:
    """One stride-1 block (K1, ``ffcnn::fused_block``), NHWC (N, H, W, C)
    -> (N, H, W, P) in ``out_dtype`` (default x's, float32 or bfloat16).
    int8 boundaries of an int8 plan: ``in_scale`` takes int8 codes in
    (dequantized on load), ``out_scale`` stores int8 codes (requantized at
    the store).

    CPU tensors take ``block_plain``; CUDA tensors launch the kernel."""
    return FUSED_BLOCK_OP(x, _tensors([bp]), _meta([bp]),
                          out_dtype or x.dtype, in_scale, out_scale)


fused_block.launches = 0


def _down_cpu(x, params, meta, out_dtype, in_scale, out_scale):
    return block_down_plain(x, _rebuild(params, meta)[0], out_dtype,
                            in_scale, out_scale)


def _down_cuda(x, params, meta, out_dtype, in_scale, out_scale):
    bp = _rebuild(params, meta)[0]
    _check(x, [bp], out_dtype, in_scale)
    n, h, w, c = x.shape
    e, p = bp.w1.shape[1], bp.w2.shape[1]
    if h % 2 or w % 2 or bp.residual:
        raise ValueError(f"a stride-2 block needs even H and W and no "
                         f"residual, got {h}x{w}, residual={bp.residual}")
    th, tw = pick_tile(h // 2, w // 2, 2)
    ik, od, ok, si, so = _boundaries(x, out_dtype, in_scale, out_scale)
    y = torch.empty((n, h // 2, w // 2, p), dtype=od, device=x.device)
    lib = build_down()
    err = lib.ffcnn_block_s2(
        x.data_ptr(), y.data_ptr(), ik, ok,
        *_params_ptrs(bp), n, h, w, c, e, p, *bp.acts, th, tw, si, so,
        _build.stream_ptr())
    fused_down_block.launches += 1
    if err:
        raise RuntimeError("fused stride-2 block launch failed: "
                           + lib.ffcnn_down_error_string(err).decode())
    return y


FUSED_DOWN_BLOCK_OP = _library.define(
    "fused_down_block" + _BLOCK_SCHEMA, cpu=_down_cpu, cuda=_down_cuda,
    fake=lambda *a: _fake(*a, stride=2))


def fused_down_block(x: torch.Tensor, bp: BlockParams,
                     out_dtype: Optional[torch.dtype] = None,
                     in_scale: Optional[float] = None,
                     out_scale: Optional[float] = None) -> torch.Tensor:
    """One stride-2 block (K3, ``ffcnn::fused_down_block``), NHWC (N, H, W,
    C) -> (N, H/2, W/2, P) in ``out_dtype`` (default x's); H and W must be
    even.  int8 boundaries as ``fused_block``'s.

    CPU tensors take ``block_down_plain``; CUDA tensors launch the
    kernel."""
    return FUSED_DOWN_BLOCK_OP(x, _tensors([bp]), _meta([bp]),
                               out_dtype or x.dtype, in_scale, out_scale)


fused_down_block.launches = 0


def _chain_args(bps: List[BlockParams]):
    """The chained kernels' description of the blocks: 8 ints a block (c e
    p act1 act2 act3 residual res_act) and 9 weight pointers a block."""
    meta, ptrs = [], []
    for (c, e, p), bp in zip(_widths(bps), bps):
        meta += [c, e, p, *bp.acts, int(bp.residual), bp.res_act]
        ptrs += _params_ptrs(bp)
    return ((ctypes.c_int * len(meta))(*meta),
            (ctypes.c_void_p * len(ptrs))(*ptrs))


def launch_cascade(x: torch.Tensor, bps: List[BlockParams], out_dtype,
                   tile: Tuple[int, int], in_scale: Optional[float] = None,
                   out_scale: Optional[float] = None) -> torch.Tensor:
    """One K4 launch at output tile ``tile`` on a checked CUDA tensor (the
    body of ``fused_cascade``'s op, which counts it; the smoke test also
    times other tiles with it)."""
    n, h, w, _ = x.shape
    ik, od, ok, si, so = _boundaries(x, out_dtype, in_scale, out_scale)
    y = torch.empty((n, h, w, bps[-1].w2.shape[1]), dtype=od,
                    device=x.device)
    lib = build_cascade()
    err = lib.ffcnn_cascade(
        x.data_ptr(), y.data_ptr(), ik, ok, n, h, w, len(bps),
        *_chain_args(bps), *tile, si, so, _build.stream_ptr())
    if err:
        raise RuntimeError("cascade launch failed: "
                           + lib.ffcnn_cascade_error_string(err).decode())
    return y


def _cascade_cpu(x, params, meta, out_dtype, in_scale, out_scale):
    return chain_plain(x, _rebuild(params, meta), out_dtype,
                       in_scale=in_scale, out_scale=out_scale)


def _cascade_cuda(x, params, meta, out_dtype, in_scale, out_scale):
    bps = _rebuild(params, meta)
    _check(x, bps, out_dtype, in_scale)
    _, h, w, _ = x.shape
    tile = check_chain_fits(h, w, bps)
    y = launch_cascade(x, bps, out_dtype, tile, in_scale, out_scale)
    fused_cascade.launches += 1
    return y


FUSED_CASCADE_OP = _library.define("fused_cascade" + _BLOCK_SCHEMA,
                                   cpu=_cascade_cpu, cuda=_cascade_cuda,
                                   fake=_fake)


def fused_cascade(x: torch.Tensor, bps: List[BlockParams],
                  out_dtype: Optional[torch.dtype] = None,
                  in_scale: Optional[float] = None,
                  out_scale: Optional[float] = None) -> torch.Tensor:
    """A group of stride-1 blocks in one launch (K4,
    ``ffcnn::fused_cascade``), NHWC (N, H, W, C) -> (N, H, W, P of the last
    block) in ``out_dtype`` (default x's); the boundaries inside the group
    stay float32; int8 boundaries at the group's ends as ``fused_block``'s.

    CPU tensors take ``chain_plain``; CUDA tensors launch the kernel."""
    return FUSED_CASCADE_OP(x, _tensors(bps), _meta(bps),
                            out_dtype or x.dtype, in_scale, out_scale)


fused_cascade.launches = 0


def launch_mega(x: torch.Tensor, bps: List[BlockParams],
                cluster: int) -> torch.Tensor:
    """One K5 launch at ``cluster`` CTAs an image on a checked CUDA tensor
    (the body of ``fused_mega``'s op, which counts it; the smoke test also
    times the other cluster size with it)."""
    n, h, w, _ = x.shape
    th, tw = check_chain_fits(h, w, bps, mega=True, cluster=cluster)
    y = torch.empty((n, h, w, bps[-1].w2.shape[1]), dtype=x.dtype,
                    device=x.device)
    lib = build_mega()
    err = lib.ffcnn_mega(x.data_ptr(), y.data_ptr(), _is_bf16(x.dtype), n,
                         h, w, len(bps), *_chain_args(bps), th, tw, cluster,
                         _build.stream_ptr())
    if err:
        raise RuntimeError("mega run launch failed: "
                           + lib.ffcnn_mega_error_string(err).decode())
    return y


def _mega_cuda(x, params, meta):
    bps = _rebuild(params, meta)
    _check(x, bps, x.dtype)
    # the cluster follows the batch: the fake output does not depend on it
    y = launch_mega(x, bps, mega_cluster(x.shape[1], x.shape[0],
                                         _build.sm_count(x.device)))
    fused_mega.launches += 1
    return y


FUSED_MEGA_OP = _library.define(
    "fused_mega(Tensor x, Tensor[] params, int[] meta) -> Tensor",
    cpu=lambda x, params, meta: chain_plain(x, _rebuild(params, meta)),
    cuda=_mega_cuda, fake=_fake)


def fused_mega(x: torch.Tensor, bps: List[BlockParams]) -> torch.Tensor:
    """A whole run of stride-1 blocks in one launch (K5,
    ``ffcnn::fused_mega``), NHWC (N, H, W, C) -> (N, H, W, P of the last
    block) in x's dtype; every boundary stays float32.

    CPU tensors take ``chain_plain``; CUDA tensors launch the kernel."""
    return FUSED_MEGA_OP(x, _tensors(bps), _meta(bps))


fused_mega.launches = 0

_PTR, _INT, _FLOAT = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _load(name: str, entry: str, argtypes, errors: str) -> ctypes.CDLL:
    lib = _build.load_library(name)
    getattr(lib, entry).argtypes = argtypes
    getattr(lib, entry).restype = _INT
    getattr(lib, errors).argtypes = [_INT]
    getattr(lib, errors).restype = ctypes.c_char_p
    return lib


@functools.cache
def build() -> ctypes.CDLL:
    """Build (if needed) and load K1's library."""
    return _load("block_fused", "ffcnn_block_s1",
                 [_PTR, _PTR, _INT, _INT] + [_PTR] * 9 + [_INT] * 13
                 + [_FLOAT, _FLOAT, _PTR], "ffcnn_block_error_string")


@functools.cache
def build_down() -> ctypes.CDLL:
    """Build (if needed) and load K3's library."""
    return _load("block_down", "ffcnn_block_s2",
                 [_PTR, _PTR, _INT, _INT] + [_PTR] * 9 + [_INT] * 11
                 + [_FLOAT, _FLOAT, _PTR], "ffcnn_down_error_string")


# The C signatures of K4's and K5's entries (bench_chain.py loads other
# builds of the same sources with them).
CASCADE_ARGTYPES = ([_PTR, _PTR] + [_INT] * 6
                    + [ctypes.POINTER(_INT), ctypes.POINTER(_PTR)]
                    + [_INT, _INT, _FLOAT, _FLOAT, _PTR])
MEGA_ARGTYPES = ([_PTR, _PTR] + [_INT] * 5
                 + [ctypes.POINTER(_INT), ctypes.POINTER(_PTR)]
                 + [_INT, _INT, _INT, _PTR])


@functools.cache
def build_cascade() -> ctypes.CDLL:
    """Build (if needed) and load K4's library."""
    return _load("block_cascade", "ffcnn_cascade", CASCADE_ARGTYPES,
                 "ffcnn_cascade_error_string")


@functools.cache
def build_mega() -> ctypes.CDLL:
    """Build (if needed) and load K5's library."""
    return _load("block_mega", "ffcnn_mega", MEGA_ARGTYPES,
                 "ffcnn_mega_error_string")


# ------------------------------------------------------------ entry points
def run_blocks(x: torch.Tensor, run: FusedRun, bps: List[BlockParams],
               groups: Optional[List[List[FusedBlock]]] = None,
               mid_dtype: Optional[torch.dtype] = None,
               quant=None) -> torch.Tensor:
    """A run's blocks group by group, as ``run_blocks_cs`` runs them: a
    group of several blocks is one K4 launch, a single block one K1 (stride
    1) or K3 (stride 2) launch.  ``groups``: ``cascade_groups(run, k)``
    (default one block a group).  The boundaries between groups are stored
    in ``mid_dtype`` (default x's; float32 with ``FFCNN_FUSED_STORE=f32``),
    the run's output in x's dtype.  ``bps``: the run's ``block_params``,
    one per block, prepared once.

    ``quant``: an int8 plan (``quant.QuantPlan``).  A boundary between
    groups that the plan marks int8 is stored as int8 codes at its scale
    (requantized by the group before it, dequantized by the one after), as
    ``run_blocks_cs`` does; per-channel plans have no scalar scale and keep
    their boundaries in float.  The run's input and output stay float."""
    if len(bps) != len(run.blocks):
        raise ValueError(f"{len(bps)} block params for {len(run.blocks)} "
                         f"blocks")
    if groups is None:
        groups = cascade_groups(run, 0)
    if [b for g in groups for b in g] != list(run.blocks):
        raise ValueError(f"groups {groups} do not partition run {run}")
    final, i, in_scale = x.dtype, 0, None
    for gi, g in enumerate(groups):
        last = gi == len(groups) - 1
        od = final if last else (mid_dtype or final)
        out_scale = None
        if not last and quant is not None \
                and quant.blob_is_int8(g[-1].end + 1):
            out_scale = quant.scalar_scale(g[-1].end + 1)
        gbps, i = bps[i:i + len(g)], i + len(g)
        if len(g) > 1:
            x = fused_cascade(x, gbps, od, in_scale, out_scale)
        elif g[0].down:
            x = fused_down_block(x, gbps[0], od, in_scale, out_scale)
        else:
            x = fused_block(x, gbps[0], od, in_scale, out_scale)
        in_scale = out_scale
    return x


def apply_run(x: torch.Tensor, run: FusedRun, bps: List[BlockParams], *,
              groups: Optional[List[List[FusedBlock]]] = None,
              mega: bool = False,
              mid_dtype: Optional[torch.dtype] = None,
              quant=None) -> torch.Tensor:
    """Run a chain of fused blocks on an NHWC blob.  ``mega``: the whole run
    in one K5 launch (every block stride 1; the caller routes the runs
    where the mega flag is set and ``mega_fits`` holds, as the JAX
    ``apply_run`` does; never with an int8 plan, which the JAX route
    refuses); else ``run_blocks`` with ``groups``, ``mid_dtype`` and
    ``quant``.  ``bps``: the run's ``block_params``, one per block,
    prepared once (the JAX ``apply_run(x, ir, params, run)`` gathers them
    inside its trace; eagerly that would cost copies every forward)."""
    if not mega:
        return run_blocks(x, run, bps, groups, mid_dtype, quant)
    if quant is not None:
        raise ValueError("the mega route takes no int8 plan")
    if len(bps) != len(run.blocks) or any(b.down for b in run.blocks):
        raise ValueError(f"the mega route takes one params per block and "
                         f"stride-1 blocks only, got {len(bps)} params for "
                         f"run {run}")
    return fused_mega(x, bps)
